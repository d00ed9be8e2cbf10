"""The session gateway's wire codec and the tenant-side ``GatewaySession``
client, the port of ``surreal_tpu/gateway/protocol.py``.

Every payload is the reference's, byte for byte: the hello handshake is a
session attach (id, lease, resume token), act requests and replies are
length-framed structs, and every frame, the negotiated pickle fallback
included, starts with ``MAGIC``. The fallback wraps its pickled dict in a
**PMSG** envelope that carries the session id in the clear, so the server
checks that the session negotiated ``transport='pickle'`` BEFORE anything
is unpickled: a tenant-facing socket must never ``pickle.loads`` bytes it
has not tied to a session that asked for them. ``pickle`` is imported in
this module only (``tests/test_torch_hygiene.py`` holds the other
``gateway/`` modules to it), and :func:`decode_pickle_body` is the only
place it loads, called by the server after its session and transport
gate.

Frames (one message each after the DEALER identity):

- **GHELLO** (JSON): tenant, optional session id and resume token (a
  re-attach after client churn), the obs geometry (shape and dtype,
  negotiated once so ACT frames carry raw bytes), transport, an optional
  version pin, a trace id and the capability list;
- **GHELLO_OK / GHELLO_NO** (JSON): the granted session id, lease and
  resume token, or the counted rejection's reason;
- **ACT**: a struct header (session id, seq, span, flags, t_send) and the
  raw obs bytes. ``seq`` makes the client's bounded resend idempotent
  enough: a reply lost on the wire is served again. ``t_send`` is stamped
  only when both ends share a clock (a local address), else 0, and the
  server then records no transit sample;
- **ACT_OK**: a struct header (seq, served param version, flags, meta
  length, t_send), the action's JSON meta and its raw bytes. The served
  version rides every reply, so an abandoned pin shows (``F_UNPINNED``);
- **ACT_ERR** (JSON): seq and reason: throttle evictions and dead sessions
  get replies, not silence;
- **DETACH / DETACH_OK** (JSON);
- **JOURNAL** (JSON): one session-table mutation (``gateway/table.py``);
- **PMSG**: the session id (fixed width) and the pickled act dict of the
  negotiated fallback.

The client runs on the port's ``distributed/sockets.py`` DEALER, not on
zmq: the port's socket framing is its own (a little-endian u32 length
before each message, the identity first), so a zmq client cannot attach
to the port's gateway, nor this client to the reference's. Its DEALER
reconnects, so a gateway whose serve thread is respawned at its fixed
address is reached again without help. Any frame renews the session's
lease (``gateway/admission.py`` reaps the idle).
"""

from __future__ import annotations

import json
import pickle
import struct
import time
import uuid
from typing import Any

import numpy as np

from surreal_tpu_torch.distributed import sockets
from surreal_tpu_torch.distributed.shm_transport import local_address

MAGIC = b"\xa5GW1"
GHELLO = 1
GHELLO_OK = 2
GHELLO_NO = 3
ACT = 4
ACT_OK = 5
ACT_ERR = 6
DETACH = 7
DETACH_OK = 8
JOURNAL = 9
PMSG = 10

# session ids are fixed-width (a uuid4 hex prefix), so the ACT header is a
# fixed struct with no length fields on the hot path
SID_BYTES = 16

_ACT_HDR = struct.Struct(f"<{SID_BYTES}sIIBd")  # sid, seq, span, flags, t_send
_ACTOK_HDR = struct.Struct("<IQBHd")  # seq, version, flags, meta_len, t_send

# ACT_OK flags
F_CACHED = 1    # served from the (version, obs digest) act cache
F_UNPINNED = 2  # the session's pin was abandoned (catch-up) in this reply


def new_session_id() -> str:
    return uuid.uuid4().hex[:SID_BYTES]


def new_resume_token() -> str:
    """The re-attach credential granted with a session id: the id routes,
    the token authenticates."""
    return uuid.uuid4().hex


def encode_hello(tenant: str, *, session: str | None = None, token: str | None = None, obs_shape=(),
                 obs_dtype: str = "<f4", transport: str = "tcp", pin_version: int | None = None,
                 trace: str | None = None, caps: tuple[str, ...] = ()) -> bytes:
    # ``caps``: optional features ("trace" span exemplars) as a list the
    # server reads with ``.get``, so a peer without it negotiates nothing
    return MAGIC + bytes([GHELLO]) + json.dumps({
        "tenant": str(tenant),
        "session": session,
        "token": token,
        "obs_shape": [int(d) for d in obs_shape],
        "obs_dtype": str(obs_dtype),
        "transport": transport,
        "pin_version": pin_version,
        "trace": trace,
        "caps": sorted(caps),
    }).encode()


def encode_hello_ok(session: str, lease_s: float, transport: str, replica: int, pinned_version: int | None = None,
                    token: str | None = None) -> bytes:
    return MAGIC + bytes([GHELLO_OK]) + json.dumps({
        "session": session,
        "token": token,
        "lease_s": float(lease_s),
        "transport": transport,
        "replica": int(replica),
        "pinned_version": pinned_version,
    }).encode()


def encode_hello_no(reason: str) -> bytes:
    return MAGIC + bytes([GHELLO_NO]) + json.dumps({"reason": reason}).encode()


def encode_act(session: str, seq: int, obs: np.ndarray, span: int = 0, t_send: float = 0.0) -> bytes:
    sid = session.encode()
    if len(sid) != SID_BYTES:
        raise ValueError(f"session id must be {SID_BYTES} bytes, got {sid!r}")
    return (
        MAGIC + bytes([ACT])
        + _ACT_HDR.pack(sid, seq & 0xFFFFFFFF, span & 0xFFFFFFFF, 0, t_send)
        + np.ascontiguousarray(obs).tobytes()
    )


def encode_act_ok(seq: int, version: int, actions: np.ndarray, flags: int = 0, t_send: float = 0.0) -> bytes:
    arr = np.ascontiguousarray(actions)
    meta = json.dumps({"shape": list(arr.shape), "dtype": arr.dtype.str}).encode()
    return (
        MAGIC + bytes([ACT_OK])
        + _ACTOK_HDR.pack(seq & 0xFFFFFFFF, int(version), flags, len(meta), t_send)
        + meta
        + arr.tobytes()
    )


def encode_act_err(seq: int, reason: str, session: str = "") -> bytes:
    return MAGIC + bytes([ACT_ERR]) + json.dumps({"seq": int(seq), "reason": reason, "session": session}).encode()


def encode_detach(session: str) -> bytes:
    return MAGIC + bytes([DETACH]) + json.dumps({"session": session}).encode()


def encode_detach_ok(session: str, acts: int) -> bytes:
    return MAGIC + bytes([DETACH_OK]) + json.dumps({"session": session, "acts": int(acts)}).encode()


def encode_journal(op: dict) -> bytes:
    """One session-table mutation as a wire frame: the incremental
    checkpoint any transport that moves bytes can carry."""
    return MAGIC + bytes([JOURNAL]) + json.dumps(op).encode()


_JSON_KINDS = {
    GHELLO: "hello", GHELLO_OK: "hello_ok", GHELLO_NO: "hello_no", DETACH: "detach",
    DETACH_OK: "detach_ok", ACT_ERR: "act_err", JOURNAL: "journal",
}


def decode_payload(payload: bytes) -> tuple[str, Any]:
    """One gateway frame -> (kind, obj): the parsed JSON of a control
    frame, a header dict with a ``body`` memoryview for ACT and ACT_OK, or
    the STILL-PICKLED envelope of a PMSG (decoding never deserializes
    tenant bytes; the caller gates :func:`decode_pickle_body` on the
    session's transport). A payload without ``MAGIC`` raises
    ``ValueError``."""
    if payload[:4] != MAGIC:
        raise ValueError("not a gateway frame (no MAGIC prefix)")
    kind = payload[4]
    body = memoryview(payload)[5:]
    if kind in _JSON_KINDS:
        return _JSON_KINDS[kind], json.loads(bytes(body).decode())
    if kind == ACT:
        sid, seq, span, flags, t_send = _ACT_HDR.unpack_from(body, 0)
        return "act", {
            "session": sid.decode(), "seq": seq, "span": span, "flags": flags, "t_send": t_send,
            "body": body[_ACT_HDR.size:],
        }
    if kind == ACT_OK:
        seq, version, flags, meta_len, t_send = _ACTOK_HDR.unpack_from(body, 0)
        off = _ACTOK_HDR.size
        meta = json.loads(bytes(body[off:off + meta_len]).decode())
        return "act_ok", {
            "seq": seq, "version": version, "flags": flags, "t_send": t_send, "meta": meta,
            "body": body[off + meta_len:],
        }
    if kind == PMSG:
        if len(body) < SID_BYTES:
            raise ValueError("PMSG frame shorter than a session id")
        return "pmsg", {"session": bytes(body[:SID_BYTES]).decode(), "body": body[SID_BYTES:]}
    raise ValueError(f"unknown gateway frame kind {kind}")


def encode_pickle_act(session: str, msg: dict) -> bytes:
    """The fallback transport's act request: the session id in the clear
    ahead of the pickled dict, so the server can refuse to unpickle for a
    session that did not negotiate it."""
    sid = session.encode()
    if len(sid) != SID_BYTES:
        raise ValueError(f"session id must be {SID_BYTES} bytes, got {sid!r}")
    return MAGIC + bytes([PMSG]) + sid + pickle.dumps(msg, protocol=5)


def decode_pickle_body(body) -> Any:
    """Deserialize a PMSG envelope's dict: the one place the gateway
    unpickles, legal only AFTER the server has checked that the envelope's
    session exists and negotiated ``transport='pickle'``."""
    return pickle.loads(bytes(body))


def decode_act_ok(obj: dict) -> tuple[np.ndarray, dict]:
    """An ACT_OK header dict -> (actions, info), copied out of the frame."""
    meta = obj["meta"]
    actions = np.frombuffer(obj["body"], np.dtype(meta["dtype"])).reshape(meta["shape"]).copy()
    return actions, {
        "param_version": int(obj["version"]),
        "cached": bool(obj["flags"] & F_CACHED),
        "unpinned": bool(obj["flags"] & F_UNPINNED),
    }


class GatewayError(RuntimeError):
    """A counted gateway rejection (admission, eviction, dead session)."""


class GatewaySession:
    """The tenant's session handle: attach at construction, ``act`` per
    observation, ``detach`` or ``close`` when done.

    ``act`` sends one frame and waits for ITS seq; a reply lost on the wire
    (the ``gateway.session`` ``drop_frame`` fault, a migrating replica) is
    covered by a bounded resend of the same session and seq, and a stale
    reply of an earlier attempt is drained by its seq. Exhausted retries
    raise ``TimeoutError``; admission rejections raise
    :class:`GatewayError` with the counted reason."""

    def __init__(self, address: str, tenant: str = "default", *, session: str | None = None,
                 token: str | None = None, obs_shape=(), obs_dtype: str = "<f4", transport: str = "tcp",
                 pin_version: int | None = None, trace: str | None = None, timeout_s: float = 5.0,
                 retries: int = 3, caps: tuple[str, ...] = ("trace",)):
        if transport not in ("tcp", "pickle"):
            raise ValueError(f"transport {transport!r} not in tcp|pickle")
        self.tenant = str(tenant)
        self.transport = transport
        self.obs_shape = tuple(int(d) for d in obs_shape)
        self.obs_dtype = np.dtype(obs_dtype)
        self.timeout_s = float(timeout_s)
        self.retries = max(1, int(retries))
        self.resends = 0
        self.acts = 0
        self._seq = 0
        # a zmq DEALER's identity is random; this one names the client
        self._sock = sockets.Dealer(f"gw-{uuid.uuid4().hex}".encode(), self.timeout_s, reconnect=True)
        self._sock.connect(address)
        self._address = address
        # t_send only means something when both ends share a clock
        self._stamp_clock = local_address(address)
        self._span = 0
        self.session: str | None = None
        # the resume credential from GHELLO_OK: pass it (with the session
        # id) to a new GatewaySession to re-attach after churn
        self.token: str | None = token
        self.lease_s: float | None = None
        self.replica: int | None = None
        self.pinned_version: int | None = None
        self.caps = tuple(caps)
        try:
            self._attach(session, token, pin_version, trace)
        except BaseException:
            self._sock.close()
            raise

    def _recv(self, timeout_s: float) -> tuple[str, Any] | None:
        if not self._sock.poll(timeout_s * 1e3):
            return None
        return decode_payload(self._sock.recv())

    def _attach(self, session: str | None, token: str | None, pin_version: int | None, trace: str | None) -> None:
        hello = encode_hello(
            self.tenant, session=session, token=token, obs_shape=self.obs_shape, obs_dtype=self.obs_dtype.str,
            transport=self.transport, pin_version=pin_version, trace=trace, caps=self.caps,
        )
        for _ in range(self.retries):
            self._sock.send(hello)
            got = self._recv(self.timeout_s)
            if got is None:
                continue
            kind, obj = got
            if kind == "hello_no":
                raise GatewayError(obj["reason"])
            if kind == "hello_ok":
                self.session = obj["session"]
                self.token = obj.get("token") or self.token
                self.lease_s = float(obj["lease_s"])
                self.replica = int(obj["replica"])
                self.pinned_version = obj.get("pinned_version")
                return
            # a stale act reply of a previous incarnation: drained
        raise TimeoutError(f"gateway attach timed out against {self._address}")

    def act(self, obs) -> tuple[np.ndarray, dict]:
        """One act round trip: ``(actions, info)``, info carrying the
        SERVED param version and the cached and unpinned flags."""
        if self.session is None:
            raise GatewayError("session is detached")
        obs = np.ascontiguousarray(obs, self.obs_dtype)
        self._seq += 1
        seq = self._seq
        self._span += 1
        t_send = time.time() if self._stamp_clock else 0.0
        if self.transport == "pickle":
            frame = encode_pickle_act(self.session, {
                "kind": "act", "seq": seq, "span": self._span, "obs": obs, "t_send": t_send,
            })
        else:
            frame = encode_act(self.session, seq, obs, span=self._span, t_send=t_send)
        per_try = self.timeout_s / self.retries
        for attempt in range(self.retries):
            if attempt:
                self.resends += 1
            self._sock.send(frame)
            deadline = time.monotonic() + per_try
            while True:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                got = self._recv(left)
                if got is None:
                    break
                kind, obj = got
                if kind == "act_ok" and obj["seq"] == seq:
                    self.acts += 1
                    return decode_act_ok(obj)
                if kind == "act_err" and obj["seq"] in (seq, 0):
                    raise GatewayError(obj["reason"])
                # anything else: a stale reply for an old seq, drained
        raise TimeoutError(f"act seq {seq} got no reply after {self.retries} sends")

    def detach(self) -> None:
        if self.session is None:
            return
        self._sock.send(encode_detach(self.session))
        deadline = time.monotonic() + self.timeout_s
        while time.monotonic() < deadline:
            got = self._recv(deadline - time.monotonic())
            if got is not None and got[0] == "detach_ok":
                break
        self.session = None

    def close(self) -> None:
        try:
            self.detach()
        except OSError:
            pass  # best effort: the lease reaper collects silent exits
        self._sock.close()
