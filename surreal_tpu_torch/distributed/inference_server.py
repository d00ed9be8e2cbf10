"""SEED-style batched inference server, the port of
``surreal_tpu/distributed/inference_server.py`` (``InferenceServer``) on
the standard-library sockets of ``distributed/sockets.py`` in place of
zmq, with the same frames, batching, chunk stitching, eviction, lineage
stamps, gauges and fault sites (``server.serve``, and ``fleet.replica``
for a replica of ``distributed/fleet.py``'s fleet). The ops-plane push
(``OpsPusher``, an ``ops_address``) belongs to a subsystem the port does
not have yet and raises.

The reference's design notes follow. (The north-star replacement for the
reference's actor pool: "the Agent actor pool collapses into a SEED-RL-
style batched inference server where env.step observations are shipped to
a single vmap'd policy.forward on-chip" — BASELINE.json; SURVEY.md §3.2).

Shape: env workers (CPU processes/threads, each stepping a vectorized env
slice, optionally split into two pipelined sub-slices) ship observation
batches via per-worker shared-memory slabs negotiated at a hello
handshake (shm_transport.py) — the wire then carries only tiny control frames
— or via the original pickle wire as the negotiated fallback. The server
micro-batches all pending requests into ONE policy forward by reading
worker slabs directly into a preallocated scratch batch (no per-serve
``np.concatenate``, no per-slice pickling), writes action slices straight
into each worker's action slab, and routes the control replies back.
Behavior-policy info (``action_info``) stays server-side and is stitched
with the rewards/dones arriving in that sub-slice's NEXT request,
accumulating time-major trajectory chunks for the learner — the
ExperienceSender role (SURVEY.md §2.1) without a separate replay hop.

Serialization on the steady-state path: none under shm; pickle protocol 5
under the fallback, decoded inside ``shm_transport`` (workers are trusted
local processes — this is an internal data plane, not an exposed
endpoint).
"""

from __future__ import annotations

import queue
import threading
import time
import zlib
from collections import deque
from typing import Callable

import numpy as np

from surreal_tpu_torch.distributed import shm_transport as dp
from surreal_tpu_torch.distributed.sockets import Again, Router
from surreal_tpu_torch.utils import faults


class _WorkerTrack:
    """Per-(worker, slot) trajectory assembly state."""

    __slots__ = ("pending", "steps", "ep", "step_idx")

    def __init__(self):
        self.pending: dict | None = None  # {obs, action, info} awaiting outcome
        self.steps: list[dict] = []
        # experience lineage: per-env episode / in-episode step
        # counters, stamped onto every transition at collection and
        # advanced on done boundaries — lazily sized to the slice width
        self.ep: np.ndarray | None = None
        self.step_idx: np.ndarray | None = None


class _WorkerState:
    """Per-identity transport state: negotiated slab + liveness stamp."""

    __slots__ = ("slab", "spec", "views", "last_seen", "occupancy",
                 "trace_id", "last_span")

    def __init__(self):
        self.slab = None                    # SharedMemory (server-owned)
        self.spec: dp.SlabSpec | None = None
        self.views: list[dict] = []
        self.last_seen = time.monotonic()
        self.occupancy: float | None = None  # worker-reported pipeline gauge
        self.trace_id: str | None = None     # inherited run trace (hello /
        #                                      pickle priming message)
        self.last_span = 0                   # newest span seq seen


# a worker silent this long no longer counts toward the auto-tuned
# min_batch (dead workers must not stall the coalescing window; the
# supervisor's respawn re-hello refreshes the stamp)
_LIVE_TTL_S = 30.0


class InferenceServer:
    """Runs the batching loop in a background thread.

    Args:
      act_fn: (obs [N, ...]) -> (actions [N, ...], info dict of [N, ...])
        numpy arrays — typically a closure over the current learner state;
        swap via :meth:`set_act_fn` as the learner publishes new params.
      unroll_length: trajectory chunk length T emitted to ``chunks``.
      min_batch / max_wait_ms: micro-batching knobs — run the forward once
        this many worker requests are pending, or after the wait expires.
      transport: 'auto' grants shm hellos; 'pickle' denies them (every
        worker then falls back to the pickle wire).
      auto_tune: retune ``min_batch`` to the live connected-worker count
        and ``max_wait_ms`` to a fraction of the serve-latency EWMA —
        a fleet that shrinks (worker death) or grows (respawn, elastic
        scaling) keeps coalescing into one forward per lockstep round
        without the trainer re-plumbing the knobs.
      version: the starting params version. The fleet respawns a crashed
        replica at the fleet's current version, so the transitions it
        tags do not read as acted by an ancient policy (staleness is
        ``server.version - chunk.param_version``: a respawn at 0 would
        have every chunk it assembles dropped).
      chunks: an externally owned output queue. The fleet hands every
        replica one queue, so the trainer's chunk wait stays one blocking
        get and eviction prefers the oldest chunk fleet-wide; None gives
        the server its own.
      ops_tier: the tier name of this server's causal spans (a fleet's
        replica slot keeps its name across respawns).
    """

    def __init__(
        self,
        act_fn: Callable,
        unroll_length: int = 32,
        min_batch: int = 1,
        max_wait_ms: float = 2.0,
        bind: str = "tcp://127.0.0.1:*",
        transport: str = "auto",
        auto_tune: bool = False,
        sanitize_obs: bool = True,
        trace_id: str | None = None,
        version: int = 0,
        chunks: "queue.Queue[dict] | None" = None,
        ops_address: str | None = None,
        ops_tier: str = "fleet.replica0",
        span_sink=None,
        trace_sample_n: int = 0,
        lineage: bool = True,
    ):
        if ops_address is not None:
            raise NotImplementedError(
                "InferenceServer(ops_address=...): the ops plane (session/opsplane.py) is not ported to "
                "PyTorch yet"
            )
        # the run-scoped trace id this server belongs to (SessionHooks
        # mints it; the SEED trainer forwards it) — lets worker_traces()
        # consumers cross-check a frame's fleet against THIS run
        self.trace_id = trace_id
        self._act_fn = act_fn
        self._act_lock = threading.Lock()
        self._version = int(version)  # params version; bumped by set_act_fn
        self._tier = str(ops_tier)
        self.unroll_length = unroll_length
        self.min_batch = min_batch
        self.max_wait_ms = max_wait_ms
        if transport not in ("auto", "pickle"):
            raise ValueError(f"transport {transport!r} not in auto|pickle")
        self.transport = transport
        self.auto_tune = bool(auto_tune)
        # robustness: a nonfinite obs payload (corrupt slab slot, insane
        # worker) is sanitized (np.nan_to_num copy) + counted instead of
        # poisoning the shared micro-batch — one NaN row would otherwise
        # contaminate the forward for EVERY coalesced worker and every
        # trajectory assembled from it. Cost: one np.isfinite scan per
        # request; disable via topology.sanitize_obs for maximal-throughput
        # trusted planes.
        self.sanitize_obs = bool(sanitize_obs)
        self.sanitized_requests = 0
        self.chunks: "queue.Queue[dict]" = chunks if chunks is not None else queue.Queue(maxsize=64)
        # data-plane observability (SURVEY.md §5.5: the reference's
        # tensorplex tracked replay/fetch-queue occupancy): queue-full
        # evictions cost real env steps — count chunks AND steps so the
        # trainer can keep its env-step budget honest. Plain ints bumped
        # only by the server thread; GIL-atomic reads from the trainer.
        self.evicted_chunks = 0
        self.evicted_steps = 0
        # serve latency + micro-batch width, EWMA over serves (telemetry
        # spine: the queue-depth/latency side-band). Written only by the
        # server thread; GIL-atomic float reads from the trainer.
        self._serve_ms_ewma: float | None = None
        self._serve_batch_ewma: float | None = None
        # per-hop latency sample windows for the cross-process timeline:
        # frame-in-flight (worker send stamp -> server recv,
        # same-host clocks) and per-serve-batch duration. Appended only by
        # the server thread; hop_stats() snapshots under the GIL.
        self._hop_transit: "deque[float]" = deque(maxlen=512)
        self._hop_serve: "deque[float]" = deque(maxlen=512)
        # wire accounting: control/payload bytes in+out and env steps
        # served — the bytes/step gauge is the zero-copy transport's
        # success metric (pickle ships the arrays; shm ships ~30 B frames)
        self._wire_bytes = 0
        self._served_steps = 0
        # causal trace exemplars: span_sink is the session's
        # shared Tracer (every replica is a thread of the session
        # process); trace_sample_n head-samples 1-in-N worker STEP spans
        # (0 = off). lineage gates the per-transition provenance stamp.
        # _pending_exemplar: the exemplar the NEXT completed chunk adopts
        # — set by a sampled worker step, popped when a chunk ships, so
        # the learner's dispatch span joins the same tree.
        self._span_sink = span_sink
        self.trace_sample_n = int(trace_sample_n)
        self.lineage = bool(lineage)
        self._pending_exemplar: dict | None = None

        # rolling completed-episode stats shipped by workers (SURVEY.md
        # §5.5); read via episode_stats(). Window matches the host
        # trainers' hooks.host_metrics (20 episodes) so 'episode/return'
        # means the same thing on every trainer.
        self._ep_returns: "deque[float]" = deque(maxlen=20)
        self._ep_lengths: "deque[float]" = deque(maxlen=20)
        # worker-reported act round-trip latency (ms), rolling window —
        # the env_worker side of the latency story rides in with each msg
        self._act_latencies: "deque[float]" = deque(maxlen=50)
        self._ep_lock = threading.Lock()

        # a respawned worker reuses its dead predecessor's identity: the
        # Router hands the identity over to the newest connection (a
        # SIGKILLed process never sent a disconnect)
        self._sock = Router(bind)
        self.address = self._sock.address
        self._tracks: dict[tuple[bytes, int], _WorkerTrack] = {}
        self._states: dict[bytes, _WorkerState] = {}
        # preallocated scratch batches keyed by (tail shape, dtype str),
        # grown geometrically — the per-serve concatenate replacement
        self._scratch: dict[tuple, np.ndarray] = {}
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def set_act_fn(self, act_fn: Callable) -> None:
        """Swap the policy (e.g. after a learner update). Atomic w.r.t.
        in-flight batches; bumps the params version that tags every
        transition acted from here on (SURVEY.md §7 hard-parts: async
        on-policy correctness needs a params-version tag per transition)."""
        with self._act_lock:
            self._act_fn = act_fn
            self._version += 1

    @property
    def version(self) -> int:
        """Current params version (== number of set_act_fn calls)."""
        with self._act_lock:
            return self._version

    def note_exemplar(self, exemplar: str, parent_span: int) -> None:
        """Adopt a foreign trace exemplar (``InferenceFleet.serve_act``):
        this server's next completed chunk carries it, so the learner's
        dispatch span lands in the same tree. Newest exemplar wins."""
        self._pending_exemplar = {"exemplar": str(exemplar), "parent": int(parent_span)}

    def address_for(self, worker_id: int) -> str:
        """The routing surface of ``InferenceFleet``: a single server
        routes every worker to itself."""
        return self.address

    @property
    def alive(self) -> bool:
        """Serve-thread liveness, the fleet supervisor's death signal (a
        crashed loop has released its socket already; ``close`` still
        releases the slabs)."""
        return self._thread.is_alive()

    # -- internals -----------------------------------------------------------
    def _loop(self) -> None:
        # a serve thread that dies from an exception (the kill_replica
        # injection included) releases its bound ROUTER socket all the
        # same, or the fleet's in-place respawn could not rebind the
        # address
        try:
            self._loop_body()
        finally:
            self._sock.close()

    def _loop_body(self) -> None:
        pending: list[tuple[bytes, dict]] = []
        deadline: float | None = None
        while not self._stop.is_set():
            f = faults.fire("fleet.replica")
            if f is not None:
                if f["kind"] == "kill_replica":
                    # die like a real crash: the loop unwinds (the socket
                    # is released), the workers time out and re-hello to
                    # the fleet's survivors, and the fleet respawns this
                    # replica in place
                    raise faults.FaultInjected("chaos: kill_replica")
                if f["kind"] == "delay":
                    faults.sleep_ms(f)
            timeout = 5.0
            if pending and deadline is not None:
                timeout = max(0.0, (deadline - time.monotonic()) * 1000)
            if self._sock.poll(timeout):
                while True:
                    try:
                        ident, payload = self._sock.recv_multipart()
                    except Again:
                        break
                    self._wire_bytes += len(payload)
                    kind, obj = dp.decode_payload(payload)
                    if kind == "hello":
                        self._handle_hello(ident, obj)
                        continue
                    if kind == "step":
                        msg = self._shm_step_to_msg(ident, obj)
                        if msg is None:
                            continue  # no negotiated slab for this identity
                    else:  # 'msg' — the pickle fallback dict
                        msg = obj
                        st = self._states.get(ident)
                        if st is None:
                            st = self._states[ident] = _WorkerState()
                        st.last_seen = time.monotonic()
                        # pickle transport has no hello: the priming
                        # message carries the inherited run trace id
                        if msg.get("trace"):
                            st.trace_id = msg["trace"]
                    self._note_hop(ident, msg)
                    if not pending:
                        deadline = time.monotonic() + self.max_wait_ms / 1000
                    pending.append((ident, msg))
            if self.auto_tune:
                self._retune()
            ready = len(pending) >= self.min_batch or (
                pending and deadline is not None and time.monotonic() >= deadline
            )
            if ready:
                self._serve_batch(pending)
                pending = []
                deadline = None

    def _retune(self) -> None:
        """Coalescing auto-tune: one forward per lockstep fleet round.

        ``min_batch`` tracks the recently-live worker count (each worker
        keeps ~1 request per sub-slice in flight, so a full round is at
        least one request per worker); ``max_wait_ms`` scales with the
        serve-latency EWMA — when a serve costs 40 ms, waiting 10 ms to
        coalesce stragglers is cheap; when it costs 2 ms, waiting is the
        bottleneck."""
        now = time.monotonic()
        live = sum(
            1 for st in self._states.values()
            if now - st.last_seen < _LIVE_TTL_S
        )
        self.min_batch = max(1, live)
        if self._serve_ms_ewma is not None:
            self.max_wait_ms = min(20.0, max(1.0, 0.25 * self._serve_ms_ewma))

    def _note_hop(self, ident: bytes, msg: dict) -> None:
        """Record the frame-in-flight hop + span bookkeeping for one
        request (server thread only). ``t_send`` is the worker's unix
        send stamp — same host, shared clock; negative skew clamps to 0."""
        t_send = msg.get("t_send")
        if isinstance(t_send, (int, float)) and t_send > 0:
            self._hop_transit.append(max(0.0, (time.time() - t_send) * 1e3))
        span = msg.get("span")
        if span:
            st = self._states.get(ident)
            if st is not None:
                st.last_span = int(span)

    def _handle_hello(self, ident: bytes, info: dict) -> None:
        """Negotiate (or re-negotiate) the shm slab for one identity.

        A respawned worker re-hellos under its dead predecessor's identity
        (ROUTER_HANDOVER): a matching geometry reuses the existing slab; a
        changed one unlinks and recreates. Either way the SERVER keeps
        ownership, so a SIGKILLed worker can never leak ``/dev/shm``."""
        st = self._states.setdefault(ident, _WorkerState())
        st.last_seen = time.monotonic()
        if info.get("trace"):
            st.trace_id = info["trace"]
        if self.transport == "pickle":
            self._send_to(ident, dp.encode_hello_reply(None, None, "transport=pickle"))
            return
        spec = dp.SlabSpec.from_json(info)
        if st.slab is not None and st.spec is not None and st.spec.matches(spec):
            self._send_to(ident, dp.encode_hello_reply(st.slab.name, st.spec))
            return
        self._release_slab(st)
        # geometry changed (or first hello): any half-built per-slot
        # chunks belong to the old geometry — drop them
        for key in [k for k in self._tracks if k[0] == ident]:
            del self._tracks[key]
        try:
            st.slab = dp.create_slab(spec, tag=ident.decode(errors="replace")[-12:])
        except OSError as e:
            self._send_to(ident, dp.encode_hello_reply(None, None, f"create failed: {e}"))
            return
        st.spec = spec
        st.views = spec.views(st.slab.buf)
        self._send_to(ident, dp.encode_hello_reply(st.slab.name, spec))

    def _shm_step_to_msg(self, ident: bytes, header: dict) -> dict | None:
        """Materialize one shm STEP frame into the message dict the record
        path consumes.

        Copy discipline: ``obs`` stays a slab VIEW here — it is consumed
        synchronously during ``_serve_batch`` (scratch gather / next_obs
        where / the forward's fast path) BEFORE the reply frame releases
        the worker to overwrite the slot, and ``_record`` copies it when
        installing pending state (the one place it outlives the serve).
        reward/done/truncated are copied now (tiny) because they are
        stored into trajectory steps as-is; terminal_obs stays a view
        (consumed by ``np.where`` inside the same serve)."""
        st = self._states.get(ident)
        if st is None or st.slab is None:
            return None  # stale frame from a pre-restart negotiation
        st.last_seen = time.monotonic()
        slot = int(header["slot"])
        if slot >= len(st.views):
            return None
        v = st.views[slot]
        msg: dict = {
            "obs": v["obs"], "slot": slot, "_shm": True,
            "span": header.get("span", 0), "t_send": header.get("t_send", 0.0),
        }
        if header["flags"] & dp.F_HAS_REWARD:
            msg["reward"] = np.array(v["reward"])
            msg["done"] = np.array(v["done"])
            msg["truncated"] = np.array(v["truncated"])
            if header["flags"] & dp.F_HAS_TERMINAL:
                msg["terminal_obs"] = v["terminal_obs"]
        if header["flags"] & dp.F_FINAL:
            msg["final"] = True
        if header["flags"] & dp.F_HAS_GAUGES:
            msg["act_latency_ms"] = header["act_latency_ms"]
            st.occupancy = float(header["pipeline_occupancy"])
        if header["episode_returns"]:
            msg["episode_returns"] = header["episode_returns"]
            msg["episode_lengths"] = header["episode_lengths"]
        return msg

    def _send_to(self, ident: bytes, payload: bytes) -> None:
        self._wire_bytes += len(payload)
        self._sock.send_multipart([ident, payload])

    def _reply(self, ident: bytes, msg: dict, actions: np.ndarray) -> None:
        """Route one action slice back: written straight into the worker's
        action slab (a control frame signals readiness) under shm, pickled
        under the fallback — decided per REQUEST, so a worker that fell
        back mid-negotiation still gets replies it can decode."""
        slot = int(msg.get("slot", 0))
        if msg.get("_shm"):
            st = self._states[ident]
            np.copyto(st.views[slot]["action"], actions, casting="same_kind")
            self._send_to(ident, dp.encode_step_reply(slot))
        else:
            self._send_to(ident, dp.encode_pickle_reply(slot, actions))

    def _gather(self, requests: list[tuple[bytes, dict]]) -> np.ndarray:
        """Assemble the micro-batch into the preallocated scratch buffer
        (slab/array slices copied in place — no per-serve concatenate).
        The scratch is reused across serves; every consumer (the forward,
        record-path copies) runs before the next serve touches it."""
        first = requests[0][1]["obs"]
        tail, dtype = first.shape[1:], first.dtype
        n = sum(r[1]["obs"].shape[0] for r in requests)
        if any(
            r[1]["obs"].shape[1:] != tail or r[1]["obs"].dtype != dtype
            for r in requests
        ):  # heterogeneous fleet — correctness fallback, not the steady state
            return np.concatenate([r[1]["obs"] for r in requests], axis=0)
        key = (tail, dtype.str)
        buf = self._scratch.get(key)
        if buf is None or buf.shape[0] < n:
            cap = 1 << max(n - 1, 1).bit_length()
            buf = np.empty((cap, *tail), dtype)
            self._scratch[key] = buf
        off = 0
        for _, msg in requests:
            o = msg["obs"]
            buf[off : off + o.shape[0]] = o
            off += o.shape[0]
        return buf[:n]

    def _serve_batch(self, requests: list[tuple[bytes, dict]]) -> None:
        # 'final' flushes come from exiting workers: stitch the transition
        # they carry, but don't spend a forward choosing actions nobody
        # will read or install pending state for a dead peer
        finals = [r for r in requests if r[1].get("final")]
        for ident, msg in finals:
            self._record(ident, msg, None, None, final=True)
        requests = [r for r in requests if not r[1].get("final")]
        if not requests:
            return
        f = faults.fire("server.serve")
        if f is not None and f["kind"] == "delay":
            faults.sleep_ms(f)  # a slow serve: drives worker silence budgets
        if self.sanitize_obs:
            for _, msg in requests:
                o = msg["obs"]
                if not np.isfinite(o).all():
                    # copy (never write a worker's slab view) + clamp
                    msg["obs"] = np.nan_to_num(
                        np.asarray(o, dtype=o.dtype), copy=True
                    )
                    self.sanitized_requests += 1
        t0 = time.monotonic()
        if len(requests) == 1:
            # fast path (the steady state at min_batch=1): a lone pending
            # request needs no gather into the scratch batch and no
            # re-slice back out — act on the worker's array directly
            # (still pre-reply, so a slab view is safe) and ship the
            # results whole. Record-identical to the batched path below
            # (slice 0:n of a 1-request batch IS the batch).
            obs = requests[0][1]["obs"]
        else:
            obs = self._gather(requests)
        with self._act_lock:
            actions, info = self._act_fn(obs)
            info = dict(info, param_version=np.full(len(obs), self._version, np.int32))
        actions = np.asarray(actions)
        info = {k: np.asarray(v) for k, v in info.items()}
        self._emit_step_spans(requests, (time.monotonic() - t0) * 1e3)
        if len(requests) == 1:
            ident, msg = requests[0]
            self._record(ident, msg, actions, info)
            self._reply(ident, msg, actions)
        else:
            offset = 0
            for ident, msg in requests:
                n = msg["obs"].shape[0]
                sl = slice(offset, offset + n)
                offset += n
                self._record(ident, msg, actions[sl], {k: v[sl] for k, v in info.items()})
                self._reply(ident, msg, actions[sl])
        self._served_steps += len(obs)
        ms = (time.monotonic() - t0) * 1e3
        self._hop_serve.append(ms)
        self._serve_ms_ewma = (
            ms if self._serve_ms_ewma is None
            else 0.1 * ms + 0.9 * self._serve_ms_ewma
        )
        b = float(len(obs))
        self._serve_batch_ewma = (
            b if self._serve_batch_ewma is None
            else 0.1 * b + 0.9 * self._serve_batch_ewma
        )

    def _emit_step_spans(self, requests, forward_ms: float) -> None:
        """Head-sampled worker-path causal spans: 1-in-N STEP
        frames (by the worker's own span seq — the FIRST step of every
        stream is always an exemplar) get a worker-tier root span (wire
        transit, same-host clocks) and a replica forward child; the
        exemplar is parked for the next completed chunk so the learner's
        dispatch span completes the tree. Runs BEFORE _record so a chunk
        finished by this very serve can already adopt it."""
        sink = self._span_sink
        if sink is None or self.trace_sample_n <= 0:
            return
        from surreal_tpu_torch.session.telemetry import head_sampled

        for ident, msg in requests:
            span_seq = int(msg.get("span") or 0)
            if not head_sampled(span_seq, self.trace_sample_n):
                continue
            wid = ident.decode(errors="replace")[-8:]
            root = sink.trace_context(f"{self._tier}:{wid}:s{span_seq}")
            t_send = msg.get("t_send")
            transit = (
                max(0.0, (time.time() - float(t_send)) * 1e3)
                if isinstance(t_send, (int, float)) and t_send > 0 else None
            )
            sink.emit_span(
                "worker.step", root, tier="worker", dur_ms=transit,
                worker=wid, step_span=span_seq,
            )
            child = root.child(sink.next_span_id())
            sink.emit_span(
                "replica.forward", child, tier=self._tier,
                dur_ms=forward_ms, version=self._version,
            )
            self._pending_exemplar = {
                "exemplar": root.exemplar, "parent": child.span_id
            }

    def episode_stats(self) -> dict[str, float] | None:
        """Rolling mean return/length over the last completed episodes
        across all workers, or None before any episode finishes."""
        with self._ep_lock:
            if not self._ep_returns:
                return None
            n = len(self._ep_returns)
            return {
                "episode/return": sum(self._ep_returns) / n,
                "episode/length": sum(self._ep_lengths) / n,
            }

    def _record(self, ident: bytes, msg: dict, actions, info, final: bool = False) -> None:
        if "episode_returns" in msg:
            with self._ep_lock:
                self._ep_returns.extend(float(r) for r in msg["episode_returns"])
                self._ep_lengths.extend(float(l) for l in msg["episode_lengths"])
        if "act_latency_ms" in msg:
            with self._ep_lock:
                self._act_latencies.append(float(msg["act_latency_ms"]))
        track = self._tracks.setdefault(
            (ident, int(msg.get("slot", 0))), _WorkerTrack()
        )
        if "reward" not in msg and track.steps:
            # obs-only hello on a slot that already has partial steps:
            # a respawned worker replacing a dead one. Its fresh episode
            # must not be spliced onto the dead worker's half-built chunk
            # (no done boundary would separate them, and GAE/V-trace would
            # bootstrap across the hidden reset) — drop the partial chunk.
            track.steps = []
        if track.pending is not None and "reward" in msg:
            prev = track.pending
            done = np.asarray(msg["done"])
            obs2 = np.asarray(msg["obs"])
            terminal_obs = np.asarray(msg.get("terminal_obs", obs2))
            done_b = done.reshape(done.shape + (1,) * (obs2.ndim - 1))
            truncated = np.asarray(msg.get("truncated", np.zeros_like(done)))
            step = {
                "obs": prev["obs"],
                "next_obs": np.where(done_b, terminal_obs, obs2),
                "action": prev["action"],
                "reward": np.asarray(msg["reward"]),
                "done": done,
                "terminated": done & ~truncated,
                "behavior_logp": prev["info"]["logp"],
                "behavior": {
                    k: v
                    for k, v in prev["info"].items()
                    if k in ("mean", "log_std", "logits")
                },
                # version of the params that CHOSE this action — the
                # staleness bookkeeping PPO-over-SEED needs to drop or
                # correct windows acted by long-dead policies
                "param_version": prev["info"]["param_version"],
            }
            if self.lineage:
                # experience lineage: (worker, episode, step)
                # provenance stamped AT COLLECTION — nested dict, so the
                # chunk stacker below and the wire's '/'-flattening carry
                # it as lineage/* columns with no special casing
                step["lineage"] = self._lineage_stamp(ident, track, done)
            track.steps.append(step)
        if final:
            track.pending = None  # worker is exiting; nothing more will come
        else:
            # np.array (unconditional copy), not asarray: under shm,
            # msg['obs'] is a slab view the worker overwrites as soon as
            # the reply lands — pending outlives the serve, so it must own
            # its memory (the pickle path pays one redundant small copy)
            track.pending = {
                "obs": np.array(msg["obs"]), "action": actions, "info": info
            }
        if len(track.steps) >= self.unroll_length:
            chunk = {
                k: (
                    {kk: np.stack([s[k][kk] for s in track.steps]) for kk in track.steps[0][k]}
                    if isinstance(track.steps[0][k], dict)
                    else np.stack([s[k] for s in track.steps])
                )
                for k in track.steps[0]
            }
            ex = self._pending_exemplar
            if ex is not None:
                # trace-exemplar handoff: chunk METADATA (like _t_ready),
                # popped host-side by the trainer before staging / the
                # relay before the wire — never a data column
                chunk["_exemplar"] = dict(ex)
                self._pending_exemplar = None
            # birth stamp for the queue-latency gauge; consumers pop it
            # (seed_trainer's _DataPlane.next_chunk) before training
            chunk["_t_ready"] = time.monotonic()
            track.steps = []
            while True:
                try:
                    self.chunks.put_nowait(chunk)
                    break
                except queue.Full:
                    # learner is behind: evict the OLDEST queued chunk so
                    # the freshest policy's data survives (dropping the new
                    # chunk instead would starve a lagging learner on
                    # ever-staler experience)
                    try:
                        old = self.chunks.get_nowait()
                        self.evicted_chunks += 1
                        self.evicted_steps += int(
                            old["reward"].shape[0] * old["reward"].shape[1]
                        )
                    except queue.Empty:
                        pass

    def _lineage_stamp(self, ident: bytes, track: _WorkerTrack,
                       done: np.ndarray) -> dict[str, np.ndarray]:
        """One transition's lineage columns for a slice of width B:
        worker uid (crc32 of the wire identity — stable across respawns
        under the identity handover), per-env episode number, per-env
        in-episode step. Counters advance AFTER stamping and reset on
        done boundaries (the stamp describes the step that was acted,
        not the one coming)."""
        d = np.asarray(done, bool).reshape(-1)
        b = d.shape[0]
        if track.ep is None or track.ep.shape[0] != b:
            track.ep = np.zeros(b, np.int32)
            track.step_idx = np.zeros(b, np.int32)
        stamp = {
            "worker": np.full(b, zlib.crc32(ident) & 0x7FFFFFFF, np.int32),
            "episode": track.ep.copy(),
            "step": track.step_idx.copy(),
        }
        track.step_idx = np.where(d, 0, track.step_idx + 1).astype(np.int32)
        track.ep = np.where(d, track.ep + 1, track.ep).astype(np.int32)
        return stamp

    def hop_stats(self) -> dict[str, dict]:
        """Per-hop latency percentiles for the cross-process timeline
        (worker step -> frame in flight -> serve batch); the SEED trainer
        merges its own queue-dwell and learn hops and emits the combined
        ``hops`` telemetry event."""
        from surreal_tpu_torch.session.telemetry import latency_percentiles

        out = {}
        p = latency_percentiles(list(self._hop_transit))
        if p is not None:
            out["worker_to_server_ms"] = p
        p = latency_percentiles(list(self._hop_serve))
        if p is not None:
            out["serve_batch_ms"] = p
        return out

    def worker_traces(self) -> dict[str, str | None]:
        """Trace id each connected worker reported (hello / pickle
        priming message), keyed by wire identity — the proof trace-id
        propagation reached a spawned worker, and diag's cross-check that
        frames belong to THIS run."""
        return {
            ident.decode(errors="replace"): st.trace_id
            for ident, st in list(self._states.items())
        }

    def transport_stats(self) -> dict[str, float]:
        """Negotiated-transport mix + the zero-copy success metrics:
        wire bytes per served env step and the fleet pipeline-occupancy
        gauge (fraction of worker wall time spent stepping envs rather
        than waiting on replies). Server-thread-written, GIL-atomic reads."""
        states = list(self._states.values())  # snapshot: trainer-thread
        # reads race the server thread's hello-time inserts
        shm = sum(1 for st in states if st.slab is not None)
        occ = [st.occupancy for st in states if st.occupancy is not None]
        out = {
            "shm_workers": float(shm),
            "pickle_workers": float(len(states) - shm),
            "wire_bytes_per_step": self._wire_bytes / max(self._served_steps, 1),
        }
        if occ:
            out["pipeline_occupancy"] = sum(occ) / len(occ)
        return out

    def queue_stats(self) -> dict[str, float]:
        """Chunk-queue occupancy, eviction counts, serve/act latency, and
        the data-plane transport gauges for the metrics stream (the
        tensorplex fetch-queue-occupancy role, plus the telemetry spine's
        latency side-band)."""
        out = {
            "server/queue_depth": float(self.chunks.qsize()),
            "server/evicted_chunks": float(self.evicted_chunks),
            "server/evicted_steps": float(self.evicted_steps),
            "server/sanitized_requests": float(self.sanitized_requests),
        }
        # the two EWMAs are assigned non-atomically by the server thread;
        # guard each on its own (a shared guard can race float(None))
        if self._serve_ms_ewma is not None:
            out["server/serve_ms"] = float(self._serve_ms_ewma)
        if self._serve_batch_ewma is not None:
            out["server/serve_batch"] = float(self._serve_batch_ewma)
        out.update(
            {f"server/{k}": v for k, v in self.transport_stats().items()}
        )
        with self._ep_lock:
            if self._act_latencies:
                out["server/act_latency_ms"] = sum(self._act_latencies) / len(
                    self._act_latencies
                )
        return out

    def _release_slab(self, st: _WorkerState) -> None:
        if st.slab is not None:
            try:
                st.slab.close()
                st.slab.unlink()
            except OSError:  # pragma: no cover - already gone
                pass
            st.slab = None
            st.spec = None
            st.views = []

    def _release_all_after_join(self) -> None:
        self._thread.join()
        for st in self._states.values():
            self._release_slab(st)

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        # unlink every server-owned segment AFTER the serve thread is down
        # (it holds live views); this is the no-/dev/shm-leak guarantee,
        # including for slabs whose workers were SIGKILLed mid-run
        if self._thread.is_alive():
            # serve thread wedged mid-serve (a slow first forward):
            # releasing now would unmap
            # views it still dereferences — SIGSEGV instead of shutdown.
            # Defer to a daemon that waits it out; if the process exits
            # first, the creator-side resource tracker still unlinks.
            threading.Thread(
                target=self._release_all_after_join, daemon=True
            ).start()
            return
        for st in self._states.values():
            self._release_slab(st)
