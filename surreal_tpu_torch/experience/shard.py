"""Replay shard server, the port of ``surreal_tpu/experience/shard.py``:
one thread or process owning a host-memory ring, served over the
experience wire.

The ring is a numpy mirror of ``replay/base.py``: the cursor-wraparound
insert (FIFO evict), the uniform draw and the prioritized draw in the
reference's float32 cumsum + searchsorted form.

Draws (the port's counterpart of the reference's JAX keys): a SAMPLE
frame carries one uint64 seed per drawn set, and the shard draws each
set on a CPU ``torch.Generator().manual_seed(seed)``:

- uniform: ``torch.randint(0, max(size, 1), (bs,), dtype=int32)``, the
  rule of ``replay/uniform.py::_draw_indices``, so a shard's sample is
  bit-equal to ``UniformReplay.sample`` on a CPU ring with the same rows
  and a generator seeded the same way (tested);
- prioritized: ``torch.rand(bs)`` float32 uniforms stratified over the
  cdf, as ``replay/prioritized.py`` draws them.

``sample_many`` also takes the draws themselves (``draws``: indices, or
uniforms), so the tests can inject the draws JAX makes from the
reference's keys: uniform rows are then bit-equal to the reference
shard's, and prioritized ones within the float32 cdf tolerance.

Consistency: sample requests carry a *watermark* (rows the requester
knows were routed here). The shard defers a sample until its ingestion
count reaches it (in-order ingestion per sender plus the deferral makes
strict-mode training records deterministic), bounded by
``watermark_timeout_s``, so a dead sender or a respawned, empty shard
degrades to sampling what exists instead of deadlocking the learner.

Faults (``utils/faults.py``): ``experience.shard`` fires once per loop
pass (``kill_shard`` raises FaultInjected and the plane respawns the
shard; ``delay`` sleeps); ``experience.sample`` fires per served sample
or pop (``delay_sample``). A SIGKILLed shard leaks nothing: slab cleanup
is client-owned (``wire.create_slab``), and the respawned shard binds the
same address, so its clients re-negotiate in place.

Spill tier (``cfg["spill"]``, the plane's ``replay.tiers.spill``): a
ring shard builds its ``experience/spill.py`` writer with the ring, on the
first spec a sender's hello carries, and appends every ingested insert to
its own ``shard{i}.log`` after the ring (a failing disk degrades the
writer, counted, never the ring). Its counters join the stats. The writer
is closed when the serve loop ends, and on SIGTERM in a process shard.

A shard is a host-memory service: it imports torch only for the CPU
generator and never touches the card (its stats report
``cuda_initialized``). The reference's ops-plane push is not ported.
"""

from __future__ import annotations

import signal
import threading
import time
from collections import deque
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from surreal_tpu_torch.distributed import sockets
from surreal_tpu_torch.experience import spill, wire
from surreal_tpu_torch.session.telemetry import latency_percentiles
from surreal_tpu_torch.utils import faults


def _raise_system_exit(signum, frame):
    raise SystemExit(128 + signum)


def seeds_from_bytes(buf: bytes, nkeys: int) -> list[int]:
    """The ``nkeys`` little-endian uint64 seeds of a SAMPLE frame."""
    return [int(s) for s in np.frombuffer(buf, "<u8", count=nkeys)]


def _generator(seed: int) -> torch.Generator:
    return torch.Generator().manual_seed(int(seed))


class HostRing:
    """Numpy mirror of ``replay/base.py``'s ring: the same cursor and size
    bookkeeping, the same wrap-around scatter, the same uniform draw."""

    def __init__(self, spec: wire.PlaneSpec, capacity: int):
        self.spec = spec
        self.capacity = int(capacity)
        self.storage = {name: np.zeros((self.capacity, *shape), dtype) for name, shape, dtype in spec.fields}
        self.cursor = 0
        self.size = 0

    def insert_positions(self, n: int) -> np.ndarray:
        return (self.cursor + np.arange(n, dtype=np.int64)) % self.capacity

    def insert(self, rows: Mapping[str, np.ndarray], n: int) -> np.ndarray:
        idx = self.insert_positions(n)
        for name, _, _ in self.spec.fields:
            # assignment casts to the storage dtype, as ring_insert does
            self.storage[name][idx] = rows[name][:n]
        self.cursor = int((self.cursor + n) % self.capacity)
        self.size = int(min(self.size + n, self.capacity))
        return idx

    def gather(self, idx: np.ndarray) -> dict[str, np.ndarray]:
        return {name: buf[idx] for name, buf in self.storage.items()}

    def draw_indices(self, seed: int, bs: int) -> np.ndarray:
        """The uniform draw of ``replay/uniform.py::_draw_indices`` on a
        CPU generator seeded with ``seed``."""
        return torch.randint(0, max(self.size, 1), (bs,), generator=_generator(seed), dtype=torch.int32).numpy()

    def sample_many(self, seeds: Sequence[int], bs: int, beta: float | None = None, draws=None):
        """Uniform with replacement, one index set per seed (or per row of
        ``draws`` [nkeys, bs], indices given): [(idx, rows, None)]."""
        if draws is None:
            draws = [self.draw_indices(s, bs) for s in seeds]
        out = []
        for d in draws:
            idx = np.asarray(d, np.int64)
            out.append((idx, self.gather(idx), None))
        return out

    def gauges(self) -> dict:
        return {"size": self.size, "fill": self.size / self.capacity, "capacity": self.capacity}


class HostPrioritized(HostRing):
    """Prioritized mirror (Schaul et al. 2016 in the repo's cumsum +
    searchsorted form), float32 throughout like the device
    implementation. numpy's and torch's (or XLA's) reduction orders make
    the cdf differ by ulps, so a draw within a few ulps of a cdf boundary
    can pick the neighbouring slot; the tests hold that rule."""

    def __init__(self, spec, capacity, alpha=0.6, beta0=0.4, eps=1e-6):
        super().__init__(spec, capacity)
        self.alpha = np.float32(alpha)
        self.beta0 = float(beta0)
        self.eps = np.float32(eps)
        self.priorities = np.zeros(self.capacity, np.float32)
        self.max_priority = np.float32(1.0)

    def insert(self, rows, n):
        idx = super().insert(rows, n)
        self.priorities[idx] = self.max_priority
        return idx

    def sample_many(self, seeds: Sequence[int], bs: int, beta: float | None = None, draws=None):
        """Stratified prioritized draws for every seed (or every row of
        ``draws`` [nkeys, bs], uniforms given) against the SAME priority
        state: an iteration's priority refresh lands as one batched frame
        after its learns."""
        beta = np.float32(self.beta0 if beta is None else beta)
        p = self.priorities ** self.alpha
        total = p.sum(dtype=np.float32)
        cdf = np.cumsum(p, dtype=np.float32)
        if draws is None:
            draws = [torch.rand(bs, generator=_generator(s), dtype=torch.float32).numpy() for s in seeds]
        out = []
        n_f = np.float32(max(self.size, 1))
        for u_row in draws:
            u = (np.arange(bs, dtype=np.float32) + np.asarray(u_row, np.float32)) / np.float32(bs) * total
            idx = np.clip(np.searchsorted(cdf, u), 0, self.capacity - 1).astype(np.int64)
            probs = p[idx] / max(float(total), 1e-12)
            weights = (n_f * np.maximum(probs, 1e-12)) ** (-beta)
            weights = (weights / max(float(weights.max()), 1e-12)).astype(np.float32)
            out.append((idx, self.gather(idx), weights))
        return out

    def update_priorities(self, idx: np.ndarray, prio: np.ndarray) -> None:
        prio = np.abs(prio.astype(np.float32)) + self.eps
        self.priorities[idx % self.capacity] = prio
        self.max_priority = np.float32(max(float(self.max_priority), float(prio.max())))

    def gauges(self) -> dict:
        return dict(super().gauges(), max_priority=float(self.max_priority))


class HostFifo:
    """Bounded FIFO chunk relay (the SEED arm): whole trajectory chunks in
    arrival order, the oldest evicted when the learner lags (the inference
    server's freshest-data-survives rule)."""

    def __init__(self, depth: int = 64):
        self.chunks: deque = deque()
        self.depth = int(depth)
        self.evicted = 0
        self.rows = 0

    def insert(self, spec: wire.PlaneSpec, rows: dict, n: int) -> None:
        if len(self.chunks) >= self.depth:
            _, _, old_n = self.chunks.popleft()
            self.evicted += 1
            self.rows -= old_n
        # copy: the decoded rows view a transient wire frame or slab slot
        self.chunks.append((spec, {k: np.array(v[:n]) for k, v in rows.items()}, n))
        self.rows += n

    def pop(self):
        if not self.chunks:
            return None
        spec, rows, n = self.chunks.popleft()
        self.rows -= n
        return spec, rows, n

    def gauges(self) -> dict:
        return {
            "size": self.rows, "fill": len(self.chunks) / self.depth,
            "queue_depth": len(self.chunks), "evicted_chunks": self.evicted,
        }


class _Peer:
    __slots__ = ("role", "transport", "spec", "slab", "views", "floor", "applied", "trace", "slot_rows", "slots",
                 "caps")

    def __init__(self):
        self.role = "sender"
        self.transport = "pickle"
        self.spec: wire.PlaneSpec | None = None
        self.slab = None
        self.views: list[dict] = []
        # exactly-once ingestion: ``floor`` is the highest seq at or below
        # which EVERYTHING applied; ``applied`` holds applied seqs above it.
        # A plain last-seq watermark would drop the resend of a frame whose
        # original was lost while a later frame already applied
        self.floor = 0
        self.applied: set[int] = set()
        self.trace = None
        self.slot_rows = 0
        self.slots = 0
        self.caps: set[str] = set()  # the hello's capability list (advisory)

    def seen(self, seq: int) -> bool:
        return seq <= self.floor or seq in self.applied

    def mark_applied(self, seq: int) -> None:
        self.applied.add(seq)
        while self.floor + 1 in self.applied:
            self.floor += 1
            self.applied.discard(self.floor)


def build_ring(cfg: Mapping[str, Any], spec: wire.PlaneSpec | None):
    kind = cfg.get("kind", "uniform")
    if kind == "fifo":
        return HostFifo(depth=int(cfg.get("fifo_depth", 64)))
    if spec is None:
        return None  # ring kinds allocate lazily at the first sender hello
    if kind == "prioritized":
        return HostPrioritized(
            spec, cfg["capacity"],
            alpha=cfg.get("priority_alpha", 0.6),
            beta0=cfg.get("priority_beta0", 0.4),
            eps=cfg.get("priority_eps", 1e-6),
        )
    if kind == "uniform":
        return HostRing(spec, cfg["capacity"])
    raise ValueError(f"shard kind {kind!r} not in uniform|prioritized|fifo")


def run_shard_server(
    cfg: dict,
    bind_address: str,
    shard_id: int,
    stop_event=None,
    fault_plan: list | None = None,
    trace_id: str | None = None,
    untrack_slabs: bool = False,
) -> int:
    """Serve one replay shard until ``stop_event`` (thread mode) or process
    death. Returns rows ingested.

    Runs unchanged as a thread or a spawned process; ``cfg`` is a plain
    dict (kind, capacity, the priority knobs, watermark_timeout_s,
    fifo_depth). ``untrack_slabs`` is set for PROCESS shards so the
    trainer-side plane owns every unlink (``wire.create_slab``'s rule).
    """
    if fault_plan:
        faults.configure(fault_plan)

    kind = cfg.get("kind", "uniform")
    watermark_timeout_s = float(cfg.get("watermark_timeout_s", 5.0))
    ring = build_ring(cfg, None) if kind == "fifo" else None
    # the spill tier's writer, built with the ring at the first spec; ring
    # kinds only (fifo chunks carry a spec each, a log holds one)
    spill_writer = None
    if stop_event is None and threading.current_thread() is threading.main_thread():
        # a process shard: SIGTERM (the plane's terminate) unwinds the
        # serve loop through the finally below, which closes the log
        signal.signal(signal.SIGTERM, _raise_system_exit)
    peers: dict[bytes, _Peer] = {}
    ingested_rows = 0
    stats = {
        "shard": int(shard_id), "kind": kind,
        "wire_bytes_in": 0, "wire_bytes_out": 0,
        "samples_served": 0, "prio_updates": 0, "decode_errors": 0,
        "watermark_timeouts": 0, "ingest_rows_per_s": 0.0,
    }
    transit_ms: list[float] = []  # rolling ingest-transit samples
    deferred: list[tuple[bytes, dict, float]] = []  # (ident, req, arrived)
    ingest_t0 = None
    sock = None

    def send_to(ident: bytes, payload: bytes) -> None:
        stats["wire_bytes_out"] += len(payload)
        sock.send_multipart([ident, payload])

    def grant(ident: bytes, info: dict) -> None:
        nonlocal ring, spill_writer
        peer = peers.setdefault(ident, _Peer())
        if peer.applied:
            # re-hello compaction: a sender re-helloes only after clearing
            # its inflight window and never reuses a seq, so everything at
            # or below the highest applied seq is settled
            peer.floor = max(peer.applied)
            peer.applied.clear()
        # the hello's seq_base covers a RESPAWNED shard, whose fresh peer
        # starts at floor 0 while the sender's seqs continue from ~N
        base = int(info.get("seq_base", 0))
        if base > peer.floor:
            peer.floor = base
        peer.role = info.get("role", "sender")
        peer.trace = info.get("trace")
        peer.caps = set(info.get("caps") or ())
        peer.slot_rows = int(info.get("slot_rows", 0))
        peer.slots = int(info.get("slots", 0))
        token = info.get("token")
        spec = wire.PlaneSpec.from_json(info["spec"]) if info.get("spec") else None
        peer.spec = spec
        if ring is None and spec is not None and kind != "fifo":
            ring = build_ring(cfg, spec)
        if spill_writer is None and spec is not None and kind != "fifo":
            spill_writer = spill.build_writer(cfg.get("spill"), spec, shard_id)
        requested = info.get("transport", "tcp")
        if requested == "pickle":
            peer.transport = "pickle"
            send_to(ident, wire.encode_hello_reply("pickle", ingested_rows=ingested_rows, token=token))
            return
        if requested == "shm" and spec is not None and peer.slot_rows > 0:
            # an old slab of this identity belongs to a superseded
            # negotiation: unlink it here (a grant the client abandoned may
            # never have been attached; unlink_slab tolerates both sides)
            if peer.slab is not None:
                peer.views = []
                wire.unlink_slab(peer.slab)
                peer.slab = None
            extras = wire.SAMPLE_EXTRAS if peer.role == "sampler" else ()
            layout = wire.PlaneSlab(spec, peer.slot_rows, max(peer.slots, 1), extras=extras)
            try:
                shm = wire.create_slab(layout, tag=f"s{shard_id}")
            except OSError as e:
                peer.transport = "tcp"
                send_to(ident, wire.encode_hello_reply(
                    "tcp", reason=f"shm create failed: {e}", ingested_rows=ingested_rows, token=token))
                return
            if untrack_slabs:
                wire.untrack_slab(shm)
            peer.slab = shm
            peer.views = layout.views(shm.buf)
            peer.transport = "shm"
            send_to(ident, wire.encode_hello_reply(
                "shm", name=shm.name, slab=layout, ingested_rows=ingested_rows, token=token))
            return
        peer.transport = "tcp"
        send_to(ident, wire.encode_hello_reply("tcp", ingested_rows=ingested_rows, token=token))

    def ingest(ident: bytes, peer: _Peer, req: dict) -> None:
        nonlocal ingested_rows, ingest_t0
        seq, n = int(req["seq"]), int(req["n"])
        if peer.seen(seq):
            # duplicate of an applied frame (a resend after a lost ack):
            # re-ack, never re-apply
            send_to(ident, wire.encode_insert_ok(seq, ingested_rows))
            return
        if peer.transport == "shm" and "body" in req and not len(req["body"]):
            rows = dict(peer.views[int(req["slot"])])
        elif req.get("rows") is not None:  # pickle fallback dict
            rows = wire.flatten_fields(req["rows"])
        else:
            rows = peer.spec.unpack(req["body"], n)
        if isinstance(ring, HostFifo):
            ring.insert(peer.spec, rows, n)
        else:
            ring.insert(rows, n)
        if spill_writer is not None:
            # after the ring: the ring is the availability tier, and a
            # failing disk degrades (counted) without stalling ingest; the
            # codec copies the rows, which may view a transient frame
            spill_writer.append(rows, n)
        peer.mark_applied(seq)
        ingested_rows += n
        now = time.monotonic()
        if ingest_t0 is None:
            ingest_t0 = now
        elif now > ingest_t0:
            stats["ingest_rows_per_s"] = ingested_rows / (now - ingest_t0)
        t_send = float(req.get("t_send", 0.0))
        if t_send > 0:
            transit_ms.append(max(0.0, (time.time() - t_send) * 1e3))
            del transit_ms[:-256]
        send_to(ident, wire.encode_insert_ok(seq, ingested_rows))

    def serve_sample(ident: bytes, peer: _Peer, req: dict) -> None:
        f = faults.fire("experience.sample")
        if f is not None and f["kind"] == "delay_sample":
            faults.sleep_ms(f)
        nk = max(1, int(req.get("nkeys", 1)))
        seeds = seeds_from_bytes(req["key"], nk)
        bs = int(req["bs"])
        results = ring.sample_many(seeds, bs, beta=req.get("beta"))
        stats["samples_served"] += nk
        seq, slot = int(req["seq"]), int(req["slot"])
        has_w = results[0][2] is not None  # (idx, rows, weights)
        flags = wire.F_HAS_WEIGHTS if has_w else 0
        if peer.transport == "shm" and peer.views:
            for u, (idx, batch, weights) in enumerate(results):
                v = peer.views[(slot + u) % len(peer.views)]
                for name in peer.spec.names():
                    v[name][:bs] = batch[name]
                v["_idx"][:bs] = idx.astype(np.uint32)
                if weights is not None:
                    v["_is_weights"][:bs] = weights
            send_to(ident, wire.encode_sample_ok(seq, bs, nk, slot, flags | wire.F_SHM))
        elif peer.transport == "pickle":
            send_to(ident, wire.encode_pickle_msg({
                "kind": "sample_ok", "seq": seq, "bs": bs, "nkeys": nk,
                "many": [{"idx": idx, "is_weights": w, "rows": batch} for idx, batch, w in results],
            }))
        else:
            body = wire.pack_sample_body(peer.spec, [(idx.astype(np.uint32), w, batch) for idx, batch, w in results])
            send_to(ident, wire.encode_sample_ok(seq, bs, nk, 0, flags, body))

    def serve_pop(ident: bytes, peer: _Peer, req: dict) -> None:
        f = faults.fire("experience.sample")
        if f is not None and f["kind"] == "delay_sample":
            faults.sleep_ms(f)
        item = ring.pop() if isinstance(ring, HostFifo) else None
        seq = int(req["seq"])
        if item is None:
            send_to(ident, wire.encode_pop_reply(seq, 0, None))
            return
        spec, rows, n = item
        stats["samples_served"] += 1
        if peer.transport == "pickle":
            send_to(ident, wire.encode_pickle_msg({
                "kind": "pop_ok", "seq": seq, "n": n, "spec": spec.to_json(), "rows": rows,
            }))
        else:
            send_to(ident, wire.encode_pop_reply(seq, n, spec, spec.pack(rows, n)))

    def stats_reply() -> dict:
        out = dict(stats)
        out["ingested_rows"] = ingested_rows
        out["sample_queue_depth"] = len(deferred)
        # the shard is a host service: this stays False for its whole life
        out["cuda_initialized"] = bool(torch.cuda.is_initialized())
        if ring is not None:
            out.update(ring.gauges())
        if spill_writer is not None:
            out.update(spill_writer.stats())
        p = latency_percentiles(transit_ms)
        if p is not None:
            out["ingest_transit_ms"] = p
        return out

    def handle(ident: bytes, payload: bytes) -> None:
        stats["wire_bytes_in"] += len(payload)
        try:
            kind_s, obj = wire.decode_payload(payload)
        except Exception:
            # a corrupt wire frame (the corrupt_wire_frame fault, or a
            # half-dead peer) is counted and dropped: the sender's resend
            # redelivers inserts; samples are re-requested
            stats["decode_errors"] += 1
            return
        if kind_s == "msg":  # pickle fallback: route by the dict's kind
            obj = dict(obj)
            kind_s = obj.get("kind", "?")
        if kind_s == "hello":
            grant(ident, obj)
            return
        # prio and stats need no per-peer transport state (priority frames
        # arrive on the sampler's main-thread channel)
        if kind_s == "prio":
            if isinstance(ring, HostPrioritized):
                ring.update_priorities(np.asarray(obj["idx"]), np.asarray(obj["prio"]))
                stats["prio_updates"] += int(obj["n"])
            return
        if kind_s == "stats":
            # telemetry traffic is not experience wire: counting it would
            # let the metrics cadence move the wire bytes/step gauge
            stats["wire_bytes_in"] -= len(payload)
            sock.send_multipart([ident, wire.encode_stats_reply(int(obj["seq"]), stats_reply())])
            return
        peer = peers.get(ident)
        if peer is None:
            return  # a stale frame from before a respawn; the peer re-helloes
        if kind_s == "insert":
            ingest(ident, peer, obj)
        elif kind_s == "sample":
            if ring is None or isinstance(ring, HostFifo):
                return  # ring samples need a ring (fifo peers use POP)
            if int(obj.get("watermark", 0)) > ingested_rows:
                deferred.append((ident, obj, time.monotonic()))
            else:
                serve_sample(ident, peer, obj)
        elif kind_s == "pop":
            serve_pop(ident, peer, obj)

    def flush_deferred() -> None:
        if not deferred:
            return
        now = time.monotonic()
        still: list = []
        for ident, req, arrived in deferred:
            timed_out = now - arrived >= watermark_timeout_s
            if int(req.get("watermark", 0)) <= ingested_rows or timed_out:
                if timed_out and int(req.get("watermark", 0)) > ingested_rows:
                    # sender died or the shard respawned empty: serve what
                    # exists rather than deadlock the learner
                    stats["watermark_timeouts"] += 1
                peer = peers.get(ident)
                if peer is not None:
                    serve_sample(ident, peer, req)
            else:
                still.append((ident, req, arrived))
        deferred[:] = still

    try:
        sock = sockets.Router(bind_address)
        while not (stop_event is not None and stop_event.is_set()):
            f = faults.fire("experience.shard")
            if f is not None:
                if f["kind"] == "kill_shard":
                    raise faults.FaultInjected(f"chaos: kill_shard (shard {shard_id})")
                if f["kind"] == "delay":
                    faults.sleep_ms(f)
            if sock.poll(100):
                while True:
                    try:
                        ident, payload = sock.recv_multipart()
                    except sockets.Again:
                        break
                    handle(ident, payload)
            flush_deferred()
        return ingested_rows
    finally:
        # crash path (kill_shard; a SIGKILL never gets here): release OUR
        # mappings only, the client owns the unlink. A graceful stop also
        # unlinks: a grant the client never attached has no other reaper,
        # and unlink_slab tolerates a segment already gone
        if spill_writer is not None:
            spill_writer.close()
        graceful = stop_event is not None and stop_event.is_set()
        for peer in peers.values():
            peer.views = []
            if peer.slab is not None:
                if graceful:
                    wire.unlink_slab(peer.slab)
                else:
                    try:
                        peer.slab.close()
                    except OSError:
                        pass
        if sock is not None:
            sock.close()
