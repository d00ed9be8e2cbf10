"""Host data-plane transport, a copy of
``surreal_tpu/distributed/shm_transport.py`` (jax-free): zero-copy
shared-memory slabs + the control-frame codec, with the original pickle
wire format retained as the negotiated fallback (thread-mode tests,
remote workers). The frames are byte-equal to the reference's; they
travel over ``distributed/sockets.py`` in place of zmq.

Why this module exists (the reference's host path, pickle only, ran at
288 env steps/s on its TPU host): on the steady-state SEED path every env step used to pay a full
pickle of the obs/reward/done dict, a TCP round trip carrying those bytes,
and a pickle of the action batch coming back. The observation is the
double-buffered-acting one from Stooke & Abbeel (1803.02811) plus the
in-network experience-path argument (2110.13506): the bytes are all local,
so the wire only needs to carry *control* — "slot k of my slab is ready".

Shape of the protocol:

- **Hello handshake** — a worker that wants shared memory sends one
  ``HELLO`` control frame describing its geometry (per-slot env widths,
  obs/action shape+dtype). The server creates ONE shared-memory slab for
  that worker (all slots, all fields, fixed offsets), replies ``HELLO_OK``
  with the segment name + layout, and the worker attaches. A denied hello
  (server configured ``transport='pickle'``, or segment creation failed)
  gets ``HELLO_NO`` and the worker falls back to pickle. Transport is
  per-worker and invisible to the trainer.
- **Steady state** — the worker writes obs (and reward/done/truncated/
  terminal_obs after the first step) into its slot region and sends a
  tiny fixed-format ``STEP`` frame (slot index, flags, latency/occupancy
  gauges, episode-stat floats). The server reads the slab directly into
  its preallocated scratch batch, runs the forward, writes the action
  slice straight into the slot's action region, and replies with a
  ``STEP_REPLY`` frame. Zero ndarray bytes cross the serializer.
- **Ownership** — the SERVER owns every segment: it creates at hello,
  reuses it when a respawned worker re-negotiates with the same geometry
  (ROUTER_HANDOVER identity reuse), recreates on geometry change, and
  unlinks everything at close. A SIGKILLed worker therefore cannot leak
  ``/dev/shm``: its segment stays owned by the live server. Workers
  attach read-write but never unlink (and unregister from Python's
  resource tracker, which would otherwise unlink server-owned segments
  when a spawned worker exits — the well-known pre-3.13 double-track bug).

Synchronization is the request/reply exchange itself: a slot's region is
written only by the worker between reply and next send, and only read by
the server between receiving ``STEP`` and sending ``STEP_REPLY``. The
socket's in-order frame delivery provides the cross-process
happens-before.

``pickle.dumps``/``pickle.loads`` of ndarray payloads are allowed ONLY in
this module (the fallback codec).
"""

from __future__ import annotations

import json
import os
import pickle
import secrets
import struct
from multiprocessing import shared_memory
from typing import Any, Sequence

import numpy as np

from surreal_tpu_torch.utils import faults

# Control frames are single wire frames prefixed with MAGIC; pickled dicts
# (protocol 5 starts b"\x80\x05") can never collide with it, so one
# payload sniff routes both transports through the same server loop.
MAGIC = b"\xa5DP1"
HELLO = 1
HELLO_OK = 2
HELLO_NO = 3
STEP = 4
STEP_REPLY = 5

# STEP flags
F_HAS_REWARD = 1    # transition outcome rides in the slab (not an obs-only hello)
F_FINAL = 2         # worker is exiting: record, don't reply
F_HAS_GAUGES = 4    # latency/occupancy floats are meaningful (not first step)
F_HAS_TERMINAL = 8  # an episode ended: the terminal_obs region is meaningful
                    # (unset on the vast majority of steps — skipping the
                    # obs-sized terminal copy halves steady-state slab writes)

# STEP header after MAGIC+kind: slot, flags, act_latency_ms,
# pipeline_occupancy, span (worker step counter — the compact span id the
# cross-process trace timeline stitches on), t_send (unix seconds at the
# worker's send — same-host clocks, so the server's recv minus this is
# the frame-in-flight hop), n_episodes; then n_episodes x (return,
# length) f32.
_STEP_HDR = struct.Struct("<BBffIdH")
_EP_PAIR = struct.Struct("<ff")
_ALIGN = 64  # slab field alignment (cache line)


class SlabSpec:
    """Deterministic layout of one worker's slab: per slot, the six data-
    plane fields at fixed 64-byte-aligned offsets.

    ``slot_envs`` is the per-slot env width list — two entries for a
    pipelined worker, one otherwise. Widths may differ (odd splits);
    every offset is carried in the hello reply so both sides share one
    authoritative layout.
    """

    FIELDS = ("obs", "reward", "done", "truncated", "terminal_obs", "action")

    def __init__(
        self,
        slot_envs: Sequence[int],
        obs_shape: Sequence[int],
        obs_dtype: Any,
        action_shape: Sequence[int],
        action_dtype: Any,
    ):
        self.slot_envs = [int(n) for n in slot_envs]
        self.obs_shape = tuple(int(d) for d in obs_shape)
        self.obs_dtype = np.dtype(obs_dtype)
        self.action_shape = tuple(int(d) for d in action_shape)
        self.action_dtype = np.dtype(action_dtype)
        self._layout: list[dict[str, tuple[int, tuple[int, ...], np.dtype]]] = []
        off = 0
        for n in self.slot_envs:
            fields = {}
            for name in self.FIELDS:
                shape, dtype = self._field(name, n)
                nbytes = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
                fields[name] = (off, shape, dtype)
                off += (nbytes + _ALIGN - 1) // _ALIGN * _ALIGN
            self._layout.append(fields)
        self.nbytes = max(off, 1)

    def _field(self, name: str, n: int) -> tuple[tuple[int, ...], np.dtype]:
        if name in ("obs", "terminal_obs"):
            return (n, *self.obs_shape), self.obs_dtype
        if name == "action":
            return (n, *self.action_shape), self.action_dtype
        if name == "reward":
            return (n,), np.dtype(np.float32)
        return (n,), np.dtype(bool)  # done / truncated

    def views(self, buf) -> list[dict[str, np.ndarray]]:
        """Per-slot dict of ndarray views over the slab buffer."""
        out = []
        for fields in self._layout:
            out.append(
                {
                    name: np.ndarray(shape, dtype, buffer=buf, offset=off)
                    for name, (off, shape, dtype) in fields.items()
                }
            )
        return out

    def matches(self, other: "SlabSpec") -> bool:
        return (
            self.slot_envs == other.slot_envs
            and self.obs_shape == other.obs_shape
            and self.obs_dtype == other.obs_dtype
            and self.action_shape == other.action_shape
            and self.action_dtype == other.action_dtype
        )

    def to_json(self) -> dict:
        return {
            "slot_envs": self.slot_envs,
            "obs_shape": list(self.obs_shape),
            "obs_dtype": self.obs_dtype.str,
            "action_shape": list(self.action_shape),
            "action_dtype": self.action_dtype.str,
        }

    @classmethod
    def from_json(cls, d: dict) -> "SlabSpec":
        return cls(
            d["slot_envs"], d["obs_shape"], d["obs_dtype"],
            d["action_shape"], d["action_dtype"],
        )


# -- frame codec --------------------------------------------------------------

def encode_hello(spec: SlabSpec, trace: str | None = None) -> bytes:
    # trace: the run-scoped trace id the worker inherited via spawn
    # kwargs — the server records it per identity so diag can prove
    # which run's fleet a frame belongs to
    return MAGIC + bytes([HELLO]) + json.dumps(
        dict(spec.to_json(), pid=os.getpid(), trace=trace)
    ).encode()


def encode_hello_reply(name: str | None, spec: SlabSpec | None,
                       reason: str = "") -> bytes:
    if name is None:
        return MAGIC + bytes([HELLO_NO]) + json.dumps({"reason": reason}).encode()
    # the server pid lets a same-process attacher (thread-mode worker)
    # keep the shared resource-tracker registration intact
    return MAGIC + bytes([HELLO_OK]) + json.dumps(
        {"name": name, "spec": spec.to_json(), "pid": os.getpid()}
    ).encode()


def encode_step(slot: int, flags: int, act_latency_ms: float,
                occupancy: float, span: int = 0, t_send: float = 0.0,
                ep_returns=(), ep_lengths=()) -> bytes:
    n = len(ep_returns)
    parts = [
        MAGIC, bytes([STEP]),
        _STEP_HDR.pack(
            slot, flags, float(act_latency_ms), float(occupancy),
            int(span) & 0xFFFFFFFF, float(t_send), n,
        ),
    ]
    for r, l in zip(ep_returns, ep_lengths):
        parts.append(_EP_PAIR.pack(float(r), float(l)))
    return b"".join(parts)


def encode_step_reply(slot: int) -> bytes:
    return MAGIC + bytes([STEP_REPLY, slot])


def decode_payload(payload: bytes) -> tuple[str, Any]:
    """Route one worker->server (or server->worker) frame.

    Returns (kind, obj) with kind in {'hello', 'hello_ok', 'hello_no',
    'step', 'step_reply', 'msg'} — 'msg' is the pickle-fallback dict
    (deserialized HERE, the one place the data plane may unpickle)."""
    if payload[:4] == MAGIC:
        kind = payload[4]
        body = payload[5:]
        if kind == HELLO:
            return "hello", json.loads(body.decode())
        if kind == HELLO_OK:
            return "hello_ok", json.loads(body.decode())
        if kind == HELLO_NO:
            return "hello_no", json.loads(body.decode())
        if kind == STEP_REPLY:
            return "step_reply", body[0]
        if kind == STEP:
            slot, flags, lat, occ, span, t_send, n = _STEP_HDR.unpack_from(
                body, 0
            )
            eps = [
                _EP_PAIR.unpack_from(body, _STEP_HDR.size + i * _EP_PAIR.size)
                for i in range(n)
            ]
            return "step", {
                "slot": slot, "flags": flags, "act_latency_ms": lat,
                "pipeline_occupancy": occ, "span": span, "t_send": t_send,
                "episode_returns": [e[0] for e in eps],
                "episode_lengths": [e[1] for e in eps],
            }
        raise ValueError(f"unknown control frame kind {kind}")
    return "msg", pickle.loads(payload)


def encode_pickle_msg(msg: dict) -> bytes:
    """Fallback-transport request: the original pickled step dict."""
    return pickle.dumps(msg, protocol=5)


def encode_pickle_reply(slot: int, actions: np.ndarray) -> bytes:
    """Fallback-transport reply: (slot, actions) — slot-tagged so pickle
    workers can pipeline exactly like shm workers."""
    return pickle.dumps((int(slot), actions), protocol=5)


def decode_pickle_reply(payload: bytes) -> tuple[int, np.ndarray]:
    slot, actions = pickle.loads(payload)
    return int(slot), actions


# -- slabs --------------------------------------------------------------------

# the port's segments: /dev/shm/surreal_pt_<tag>_<server pid>_<token> (the
# reference's are surreal_dp_*, so neither package's leak checks see the
# other's live slabs)
SLAB_PREFIX = "surreal_pt_"


def create_slab(spec: SlabSpec, tag: str = "") -> shared_memory.SharedMemory:
    """Server-side: create a uniquely-named segment sized for ``spec``."""
    for _ in range(8):
        name = f"{SLAB_PREFIX}{tag}_{os.getpid()}_{secrets.token_hex(4)}"
        try:
            return shared_memory.SharedMemory(
                create=True, size=spec.nbytes, name=name
            )
        except FileExistsError:  # pragma: no cover - token collision
            continue
    raise RuntimeError("could not allocate a uniquely-named shm segment")


def attach_slab(name: str, owner_pid: int | None = None) -> shared_memory.SharedMemory:
    """Worker-side attach. The worker never owns the segment, so it must
    not be registered with this process's resource tracker: on Python
    < 3.13 attaching registers unconditionally, and a spawned worker's
    exit would then unlink the server's live segment out from under the
    rest of the fleet. A SAME-process attach (thread-mode worker) keeps
    the registration: it is one set entry shared with the creator, and
    removing it here would make the server's own unlink double-unregister."""
    shm = shared_memory.SharedMemory(name=name)
    if owner_pid == os.getpid():
        return shm
    try:
        from multiprocessing import resource_tracker

        resource_tracker.unregister(shm._name, "shared_memory")
    except (ImportError, AttributeError, KeyError, OSError):
        # tracker API moved / registration absent on this interpreter:
        # worst case is the pre-3.13 double-track unlink this guard
        # papers over — named narrowly so real failures still surface
        pass
    return shm


def local_address(address: str) -> bool:
    """Shared memory only ever makes sense against a same-host server."""
    return address.startswith(("ipc://", "inproc://")) or (
        "127.0.0.1" in address or "localhost" in address
    )


# -- worker-side transports ---------------------------------------------------

class PickleWorkerTransport:
    """The original wire format behind the new per-slot interface."""

    mode = "pickle"

    def __init__(self, sock):
        self._sock = sock

    def send(self, slot: int, msg: dict, final: bool = False,
             noblock: bool = False) -> None:
        out = dict(msg, slot=int(slot))
        if final:
            out["final"] = True
        f = faults.fire("transport.send")
        if f is not None:
            if f["kind"] == "drop_frame":
                return  # swallowed on the wire; the silence budget recovers
            if f["kind"] == "delay_frame":
                faults.sleep_ms(f)
            elif f["kind"] == "corrupt_slab" and "obs" in out:
                # pickle analogue of a corrupt slab slot: poison the
                # payload copy (not the env's own buffer)
                out["obs"] = faults.corrupt_array(np.array(out["obs"]))
        self._sock.send(encode_pickle_msg(out), noblock=noblock)

    def decode_reply(self, payload: bytes) -> tuple[int, np.ndarray]:
        return decode_pickle_reply(payload)

    def close(self) -> None:
        pass


class ShmWorkerTransport:
    """Writes step data into the negotiated slab; wire carries only
    control frames."""

    mode = "shm"
    _GAUGE_KEYS = ("act_latency_ms", "pipeline_occupancy")

    def __init__(self, sock, shm, spec: SlabSpec):
        self._sock = sock
        self._shm = shm
        self._views = spec.views(shm.buf)

    def send(self, slot: int, msg: dict, final: bool = False,
             noblock: bool = False) -> None:
        v = self._views[slot]
        v["obs"][...] = msg["obs"]
        flags = 0
        if "reward" in msg:
            flags |= F_HAS_REWARD
            v["reward"][...] = msg["reward"]
            v["done"][...] = msg["done"]
            v["truncated"][...] = msg["truncated"]
            if "terminal_obs" in msg:
                flags |= F_HAS_TERMINAL
                v["terminal_obs"][...] = msg["terminal_obs"]
        if final:
            flags |= F_FINAL
        lat = msg.get("act_latency_ms")
        if lat is not None:
            flags |= F_HAS_GAUGES
        f = faults.fire("transport.send")
        if f is not None:
            if f["kind"] == "drop_frame":
                return  # slab written, control frame swallowed
            if f["kind"] == "delay_frame":
                faults.sleep_ms(f)
            elif f["kind"] == "corrupt_slab":
                faults.corrupt_array(v["obs"])  # in place: it IS the slab
        frame = encode_step(
            slot, flags, lat or 0.0, msg.get("pipeline_occupancy", 0.0),
            msg.get("span", 0), msg.get("t_send", 0.0),
            msg.get("episode_returns", ()), msg.get("episode_lengths", ()),
        )
        self._sock.send(frame, noblock=noblock)

    def decode_reply(self, payload: bytes) -> tuple[int, np.ndarray]:
        kind, slot = decode_payload(payload)
        if kind != "step_reply":
            raise ValueError(f"expected STEP_REPLY, got {kind}")
        # copy: the view stays valid until our next send for this slot,
        # but the env adapters may hold action references across steps
        return slot, np.array(self._views[slot]["action"])

    def close(self) -> None:
        # close the mapping only — the SERVER owns and unlinks the segment
        self._shm.close()


def negotiate_worker_transport(
    sock,
    mode: str,
    slot_envs: Sequence[int],
    specs,
    address: str,
    stop_event=None,
    timeout_s: float = 60.0,
    trace: str | None = None,
):
    """Run the hello handshake and return the negotiated transport, or
    None when ``stop_event`` fires mid-handshake.

    ``mode``: 'pickle' skips the handshake; 'shm' requires a grant (raises
    on denial); 'auto' asks when the server is local and falls back to
    pickle on denial or attach failure. ``trace`` is the run-scoped trace
    id the hello carries (pickle-mode workers stamp it on their priming
    message instead — env_worker.py)."""
    import time as _time

    if mode not in ("auto", "shm", "pickle"):
        raise ValueError(f"transport {mode!r} not in auto|shm|pickle")
    if mode == "pickle" or (mode == "auto" and not local_address(address)):
        return PickleWorkerTransport(sock)
    spec = SlabSpec(
        slot_envs, specs.obs.shape, specs.obs.dtype,
        specs.action.shape, specs.action.dtype,
    )
    sock.send(encode_hello(spec, trace=trace))
    deadline = _time.monotonic() + timeout_s
    while not sock.poll(100):
        if stop_event is not None and stop_event.is_set():
            return None
        if _time.monotonic() >= deadline:
            raise TimeoutError("inference server silent during shm handshake")
    kind, obj = decode_payload(sock.recv())
    if kind == "hello_ok":
        try:
            shm = attach_slab(obj["name"], owner_pid=obj.get("pid"))
            return ShmWorkerTransport(sock, shm, SlabSpec.from_json(obj["spec"]))
        # OSError covers the whole attach failure family (FileNotFound,
        # Permission on hardened /dev/shm, ENOMEM from mmap) — in 'auto'
        # mode every one of them must degrade to pickle, not kill the
        # worker into a supervisor respawn loop
        except (OSError, ValueError) as e:
            if mode == "shm":
                raise RuntimeError(f"shm slab attach failed: {e}") from e
            return PickleWorkerTransport(sock)
    if kind == "hello_no":
        if mode == "shm":
            raise RuntimeError(
                f"server denied shm transport: {obj.get('reason', '')!r}"
            )
        return PickleWorkerTransport(sock)
    raise ValueError(f"unexpected handshake reply kind {kind!r}")
