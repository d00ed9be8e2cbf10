"""ShardedSampler and TieredSampler, the port of
``surreal_tpu/experience/sampler.py``: the learner-side fan-in of the
experience plane.

One DEALER link per shard; each training iteration's
``updates_per_iter`` batches are fetched from ALL shards (``batch_size /
num_shards`` rows each, concatenated in shard order) on the staging
thread of a ``learners/prefetch.py::Prefetcher``: while the learner
drains iteration k's updates, the sampler already fans in iteration
k+1's batches and pays their host->device copy, so the learner waits on
experience ingest only for the residue (``sample_wait_ms``).

Draw seeds (the port's counterpart of the reference's key chain, which
``split``s a JAX key per update, ``fold_in``s the shard id and ships the
key data): the sampler owns a CPU ``torch.Generator`` seeded with
``base_seed``; each update takes one seed, ``torch.randint(0, 2**63 - 1,
generator=...)``; shard ``s`` of an S-shard plane draws from
``fold_seed(seed, s)`` (a single shard from the update's seed itself, the
bit-equality contract with the in-process replay), and a dead shard's
share is refetched from a survivor with ``fold_seed(shard_seed,
0x5EED)``. ``fold_seed`` is splitmix64 of the seed offset by the folded
value. Each seed rides the SAMPLE frame as 8 little-endian bytes, and
the shard draws from ``torch.Generator().manual_seed(seed)``
(``experience/shard.py``). Every sample request carries the caller's
per-shard watermark, so under the strict off-policy loop the training
record is the same from run to run.

Resilience: sample requests are idempotent reads, so a silent shard costs
bounded, backed-off re-requests; an exhausted budget marks the shard dead
(revived under the sender's backoff) and its share is refetched from a
surviving shard, or, when none answers, from the first one the plane
respawns: batch composition degrades, availability does not.

Priority updates ride a DEDICATED main-thread socket (the sample socket
belongs to the prefetch thread) as ONE batched PRIO frame per shard per
iteration.

``TieredSampler`` fronts the warm fan-in with the device hot tier
(``replay/tiers.py::HotTier``): see its docstring.
"""

from __future__ import annotations

import queue
import time
from typing import Any, Sequence

import numpy as np
import torch

from surreal_tpu_torch.experience import wire
from surreal_tpu_torch.experience.link import ShardLinkBase, negotiate_link, shard_dealer

_MASK64 = (1 << 64) - 1
REFETCH_FOLD = 0x5EED  # the refetch seed's fold, the reference's fold_in(k, 0x5EED)


def fold_seed(seed: int, data: int) -> int:
    """A seed derived from ``seed`` and ``data`` (splitmix64 of
    ``seed + (data + 1) * golden``): the port's ``fold_in``."""
    z = (int(seed) + (int(data) + 1) * 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


def next_seeds(generator: torch.Generator, n: int) -> list[int]:
    """``n`` update seeds from the sampler's generator."""
    return torch.randint(0, 2**63 - 1, (n,), generator=generator, dtype=torch.int64).tolist()


def seed_bytes(seeds: Sequence[int]) -> bytes:
    """A SAMPLE frame's seed bytes: 8 little-endian bytes each."""
    return np.asarray([int(s) & _MASK64 for s in seeds], "<u8").tobytes()


def batch_to_device(batch: dict, spec: wire.PlaneSpec, device) -> dict:
    """A flat numpy batch as tensors on ``device``, one copy a leaf; the
    bfloat16 fields travel as their 16-bit words and are viewed back on
    the device."""
    out = {}
    for k, v in batch.items():
        if k in spec.bf16:
            out[k] = torch.from_numpy(np.ascontiguousarray(v).view(np.int16)).to(device, non_blocking=True).view(
                torch.bfloat16)
        else:
            out[k] = torch.from_numpy(np.ascontiguousarray(v)).to(device, non_blocking=True)
    return out


class _SampleLink(ShardLinkBase):
    """Sampler-side shard link: the shared base plus the reply-slot cursor
    and the lazy main-thread priority channel."""

    def __init__(self, address: str, shard_id: int, identity: str):
        super().__init__(address, shard_id, identity)
        self.prio_sock = None  # lazy: the main-thread priority channel
        self._prio_identity = f"{identity}-prio"
        self.slots = 1
        self.next_slot = 0

    def on_slab(self, layout: wire.PlaneSlab) -> None:
        self.slots = layout.slots

    def prio_channel(self):
        if self.prio_sock is None:
            self.prio_sock = shard_dealer(self.address, self._prio_identity)
        return self.prio_sock

    def close(self) -> None:
        super().close()  # client-owned slab cleanup and the sample socket
        if self.prio_sock is not None:
            self.prio_sock.close()


def partition_shards(num_shards: int, members: int) -> list[list[int]]:
    """Shard-major partition of ``num_shards`` shard indices into
    ``members`` disjoint, covering, contiguous subsets (the learner
    group's draining seam; earlier members absorb the remainder shards).
    Contiguity keeps a group's concatenated batch in global shard order."""
    if members < 1:
        raise ValueError(f"learner_group members={members} must be >= 1")
    if members > num_shards:
        raise ValueError(
            f"learner_group members={members} exceeds num_shards={num_shards}: a member with no shard "
            "subset would drain nothing (shrink the group or add shards)"
        )
    base, extra = divmod(num_shards, members)
    out, start = [], 0
    for m in range(members):
        n = base + (1 if m < extra else 0)
        out.append(list(range(start, start + n)))
        start += n
    return out


class ShardedSampler:
    def __init__(
        self,
        addresses: Sequence[str],
        spec: wire.PlaneSpec | None,
        batch_size: int,
        kind: str = "uniform",
        base_seed: int = 0,
        updates_per_iter: int = 1,
        transport: str = "auto",
        trace: str | None = None,
        prefetch: bool = True,
        retries: int = 2,
        backoff_s: float = 0.25,
        sample_timeout_s: float = 10.0,
        hello_timeout_s: float = 60.0,
        respawn_backoff_s: float = 0.5,
        respawn_backoff_cap_s: float = 30.0,
        device=None,
        stop_event=None,
    ):
        S = len(addresses)
        if kind != "fifo" and batch_size % S:
            raise ValueError(f"replay.batch_size={batch_size} must divide across {S} experience shards")
        self.spec = spec
        self.kind = kind
        self.prioritized = kind == "prioritized"
        self.batch_size = int(batch_size)
        self.bs_shard = self.batch_size // S if kind != "fifo" else 0
        self.updates_per_iter = max(1, int(updates_per_iter))
        self.mode = transport
        self.trace = trace
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.sample_timeout_s = float(sample_timeout_s)
        self.hello_timeout_s = float(hello_timeout_s)
        self._respawn_base = float(respawn_backoff_s)
        self._respawn_cap = float(respawn_backoff_cap_s)
        # set at plane shutdown: bounded waits on the prefetch thread bail
        # so it can be joined before the plane closes its sockets
        self._stop = stop_event
        # where the staging thread copies the batches (None: numpy batches)
        self.device = device
        self.links = [_SampleLink(a, s, f"xp-sampler-{s}") for s, a in enumerate(addresses)]
        self._gen = torch.Generator().manual_seed(int(base_seed))
        self._rr = 0  # fifo pop round-robin
        self.refetches = 0
        self.wire_bytes = 0
        self.prio_frames = 0
        # EWMA of get_iteration's wait: the "learner never waits" gauge
        self.sample_wait_ms = 0.0
        self._closed = False
        self._jobs: queue.Queue = queue.Queue()
        self._prefetch = None
        if prefetch:
            from surreal_tpu_torch.learners.prefetch import Prefetcher

            self._prefetch = Prefetcher(self._produce, name="xp-sample")

    # -- negotiation (sample channel; prefetch thread) -----------------------
    def _negotiate(self, link: _SampleLink, timeout_s: float) -> bool:
        """Hello handshake (``link.negotiate_link``) with 2 x
        updates_per_iter sample slots: the burst fan-out keeps K
        outstanding, and a retried straggler must land in a slot no
        in-flight duplicate serve can still write. The FIFO arm forces the
        raw tcp codec (chunk layouts are known to the shard only after its
        first insert; replies carry their spec in-frame)."""
        def send(payload: bytes) -> None:
            self.wire_bytes += len(payload)
            link.sock.send(payload)

        obj = negotiate_link(
            link, send,
            role="sampler", spec=self.spec, slot_rows=self.bs_shard,
            slots=2 * self.updates_per_iter, mode=self.mode,
            timeout_s=timeout_s, trace=self.trace, stop_event=self._stop,
            force_tcp=self.kind == "fifo",
        )
        if obj is None:
            return self._mark_dead(link)
        return True

    def _mark_dead(self, link: _SampleLink) -> bool:
        return link.schedule_backoff(self._respawn_base, self._respawn_cap)

    def _revive(self, link: _SampleLink) -> bool:
        if link.negotiated and not link.dead and not link.restarted():
            return True
        if not link.revive_due() and not link.restarted():
            return False  # a shard back at its address is revived at once, not after the backoff
        return self._negotiate(link, self.hello_timeout_s if not link.dead else 2.0)

    # -- one batch (prefetch thread) -----------------------------------------
    def _request(self, link: _SampleLink, seeds: Sequence[int], beta: float, watermark: int,
                 bs: int) -> tuple[int, int]:
        """Send ONE sample request carrying every seed in ``seeds`` (the
        sample_many discipline on the wire: the shard draws every index
        set and replies once)."""
        nk = len(seeds)
        link.seq += 1
        slot = link.next_slot
        link.next_slot = (link.next_slot + nk) % max(link.slots, 1)
        key_bytes = seed_bytes(seeds)
        t_send = time.time() if wire.local_address(link.address) else 0.0
        if link.transport == "pickle":
            payload = wire.encode_pickle_msg({
                "kind": "sample", "seq": link.seq, "bs": bs, "nkeys": nk,
                "watermark": int(watermark), "beta": float(beta),
                "slot": slot, "key": key_bytes, "t_send": t_send,
            })
        else:
            payload = wire.encode_sample(link.seq, bs, int(watermark), float(beta), slot, key_bytes, nkeys=nk,
                                         t_send=t_send)
        self.wire_bytes += len(payload)
        link.sock.send(payload)
        return link.seq, slot

    def _collect(self, link: _SampleLink, want_seq: int, deadline: float) -> dict | None:
        """Wait for one sample reply on ``link`` (older seqs from retries
        are drained and ignored)."""
        while time.monotonic() < deadline:
            if self._stop is not None and self._stop.is_set():
                return None
            if not link.sock.poll(100):
                continue
            kind, obj = wire.decode_payload(link.sock.recv())
            if kind == "msg":
                kind = obj.get("kind", "?")
            if kind == "sample_ok" and int(obj["seq"]) == want_seq:
                return obj
        return None

    def _decode(self, link: _SampleLink, obj: dict):
        """One sample reply -> [(idx, weights, rows)] per drawn set."""
        if "many" in obj:  # pickle fallback
            out = []
            for seg in obj["many"]:
                w = seg.get("is_weights")
                out.append((
                    np.asarray(seg["idx"], np.int64),
                    None if w is None else np.asarray(w, np.float32),
                    {k: np.asarray(v) for k, v in seg["rows"].items()},
                ))
            return out
        bs, nk = int(obj["bs"]), max(1, int(obj.get("nkeys", 1)))
        if obj.get("flags", 0) & wire.F_SHM:
            out = []
            base = int(obj["slot"])
            for u in range(nk):
                v = link.views[(base + u) % max(link.slots, 1)]
                rows = {name: np.array(v[name][:bs]) for name in self.spec.names()}
                idx = np.array(v["_idx"][:bs], np.int64)
                weights = np.array(v["_is_weights"][:bs]) if obj["flags"] & wire.F_HAS_WEIGHTS else None
                out.append((idx, weights, rows))
            return out
        segs = wire.unpack_sample_body(self.spec, obj["body"], bs, nk, bool(obj["flags"] & wire.F_HAS_WEIGHTS))
        # copy out of the transient frame
        return [
            (np.asarray(idx, np.int64).copy(), None if weights is None else np.array(weights),
             {k: np.array(v) for k, v in rows.items()})
            for idx, weights, rows in segs
        ]

    def _fetch_shard(self, link: _SampleLink, seeds, beta, watermark, bs):
        """Bounded-retry fetch of one shard's sub-batches (one request,
        ``len(seeds)`` drawn sets); None = dead."""
        if not self._revive(link):
            return None
        for attempt in range(self.retries + 1):
            seq, _slot = self._request(link, seeds, beta, watermark, bs)
            obj = self._collect(link, seq, time.monotonic() + self.sample_timeout_s)
            if obj is not None:
                return self._decode(link, obj)
            if self._stop is not None and self._stop.is_set():
                break
            if attempt < self.retries:
                time.sleep(self.backoff_s * 2.0 ** attempt)
        self._mark_dead(link)
        return None

    def shard_seeds(self, seeds: Sequence[int]) -> dict[int, list[int]]:
        """Each shard's seeds for the updates' ``seeds`` (a single shard
        draws from the update seeds themselves)."""
        S = len(self.links)
        return {s: [int(u) if S == 1 else fold_seed(u, s) for u in seeds] for s in range(S)}

    def fetch_batch(self, seed: int, beta: float, watermarks: Sequence[int]):
        """One fan-in batch for one update seed: (batch, info)."""
        return self._fetch_iteration([seed], beta, watermarks)[0]

    def _fetch_iteration(self, seeds, beta: float, watermarks):
        """Fan out one iteration's samples: ONE request per shard carries
        every update's seed, replies drain in arrival order, so the whole
        iteration costs about one round trip. A silent shard gets bounded
        re-requests (idempotent reads), then is marked dead and its share
        refetched from a survivor."""
        S = len(self.links)
        K = len(seeds)
        shard_seeds = self.shard_seeds(seeds)
        results: dict[int, list] = {}  # shard -> K decoded sets
        pending: dict[int, int] = {}   # shard -> awaited seq
        for s, link in enumerate(self.links):
            if not self._revive(link):
                continue
            seq, _slot = self._request(link, shard_seeds[s], beta, int(watermarks[s]) if watermarks else 0,
                                       self.bs_shard)
            pending[s] = seq
        for attempt in range(self.retries + 1):
            deadline = time.monotonic() + self.sample_timeout_s
            while pending and time.monotonic() < deadline:
                if self._stop is not None and self._stop.is_set():
                    # plane shutdown: bail so the prefetch thread joins
                    # before the sockets close (nobody consumes the result)
                    break
                progress = False
                for s in list(pending):
                    link = self.links[s]
                    while s in pending and link.sock.poll(0):
                        kind, obj = wire.decode_payload(link.sock.recv())
                        if kind == "msg":
                            kind = obj.get("kind", "?")
                        if kind == "sample_ok" and int(obj["seq"]) == pending[s]:
                            results[s] = self._decode(link, obj)
                            del pending[s]
                            progress = True
                if not progress and pending:
                    # nothing readable: block briefly on one pending link
                    self.links[next(iter(pending))].sock.poll(20)
            if not pending:
                break
            if self._stop is not None and self._stop.is_set():
                break
            if attempt < self.retries:
                for s in list(pending):
                    link = self.links[s]
                    if link.restarted() and not self._negotiate(link, 2.0):
                        continue  # still down: marked dead below, its share refetched
                    nseq, _ = self._request(link, shard_seeds[s], beta, int(watermarks[s]) if watermarks else 0,
                                            self.bs_shard)
                    pending[s] = nseq
                time.sleep(self.backoff_s * 2.0 ** attempt)
        for s in pending:
            self._mark_dead(self.links[s])
        give_up = time.monotonic() + self.hello_timeout_s
        while not results:
            # every shard is down at once (a fault plan kills every process
            # shard alike): wait, while the plane respawns them, for one to
            # come back at its address
            if (self._stop is not None and self._stop.is_set()) or time.monotonic() >= give_up:
                raise TimeoutError(
                    "every experience shard is unreachable; the plane supervisor should have respawned them"
                )
            time.sleep(0.25)
            for s, link in enumerate(self.links):
                if link.restarted():
                    got = self._fetch_shard(link, shard_seeds[s], beta, 0, self.bs_shard)
                    if got is not None:
                        results[s] = got
        alive = sorted(results)
        # batch segment -> the shard whose ring served it: a refetched
        # share carries the SURVIVOR's ring indices, so its priority
        # updates must go there
        srcs = {s: s for s in results}
        for s in range(S):
            if s in results:
                continue
            # degrade composition, not availability: a surviving shard
            # covers the dead shard's share under distinct seeds
            self.refetches += 1
            results[s], srcs[s] = self._refetch([fold_seed(u, REFETCH_FOLD) for u in shard_seeds[s]], beta, alive)
        out = []
        for u in range(K):
            parts = [(s, results[s][u]) for s in range(S)]
            batch = {name: np.concatenate([p[1][2][name] for p in parts], axis=0) for name in self.spec.names()}
            info: dict[str, Any] = {"shard_idx": {p[0]: p[1][0] for p in parts}, "shard_src": dict(srcs)}
            if self.prioritized:
                ws = [p[1][1] if p[1][1] is not None else np.ones(self.bs_shard, np.float32) for p in parts]
                batch["is_weights"] = np.concatenate(ws, axis=0)
            out.append((batch, info))
        return out

    def _refetch(self, seeds, beta: float, alive: list[int]):
        """A dead shard's share and the shard that served it: asked of the
        shards that answered this iteration first, then of any other back
        at its address. A survivor can die in its turn between its answer
        and the refetch (a fault plan that kills every shard at the same
        loop pass does so): then wait, while the plane respawns the
        shards, up to ``hello_timeout_s``."""
        order = [*alive, *(s for s in range(len(self.links)) if s not in alive)]
        give_up = None
        while True:
            for s in order:
                got = self._fetch_shard(self.links[s], seeds, beta, 0, self.bs_shard)
                if got is not None:
                    return got, s
            if give_up is None:
                give_up = time.monotonic() + self.hello_timeout_s
            if (self._stop is not None and self._stop.is_set()) or time.monotonic() >= give_up:
                raise TimeoutError("experience shard refetch failed")
            time.sleep(0.25)

    def _produce(self):
        """Prefetcher body: wait for the next iteration job, fetch all its
        update batches, and pay the host->device copy here: the learner
        thread only picks up finished device batches."""
        while True:
            try:
                job = self._jobs.get(timeout=0.2)
                break
            except queue.Empty:
                if self._closed:
                    return None
        if job is None:
            return None
        watermarks, beta, seeds = job
        if seeds is None:
            seeds = next_seeds(self._gen, self.updates_per_iter)  # the sampler owns the chain
        fetched = self._fetch_iteration(seeds, beta, watermarks)
        out = []
        for seed, (batch, info) in zip(seeds, fetched):
            if self.device is not None:
                batch = batch_to_device(batch, self.spec, self.device)
            out.append((wire.unflatten_fields(batch), seed, info))
        return out

    # -- iteration API (trainer thread) --------------------------------------
    def request_iteration(self, watermarks: Sequence[int], beta: float = 0.0, seeds=None) -> None:
        """``seeds`` (one per update) lets a tier wrapper own the seed chain:
        the warm fall-back then draws from the seeds a hot hit would have
        used. None keeps this sampler's own chain."""
        self._jobs.put((list(watermarks), float(beta), seeds))

    def get_iteration(self, on_wait=None):
        """The next requested iteration's [(batch, seed, info)].
        ``on_wait`` runs every quarter second while the prefetch thread is
        still fetching (the trainer passes its plane's ``supervise``, so a
        dead shard is respawned while the learner waits for it)."""
        t0 = time.perf_counter()
        if self._prefetch is None:
            item = self._produce()
        else:
            while True:
                try:
                    item = self._prefetch.get(timeout=0.25)
                    break
                except queue.Empty:
                    if on_wait is not None:
                        on_wait()
        wait_ms = (time.perf_counter() - t0) * 1e3
        self.sample_wait_ms = 0.2 * wait_ms + 0.8 * self.sample_wait_ms
        return item

    def update_priorities(self, infos: Sequence[dict], prios: Sequence[np.ndarray]) -> None:
        """Batched priority refresh: ONE PRIO frame per shard carrying every
        update's (local idx, |td|) pairs, fire-and-forget on the
        main-thread channel."""
        per_shard_idx: dict[int, list] = {}
        per_shard_prio: dict[int, list] = {}
        for info, prio in zip(infos, prios):
            prio = np.asarray(prio, np.float32)
            off = 0
            for s in sorted(info["shard_idx"]):
                idx = info["shard_idx"][s]
                # route to the shard that SERVED the segment
                dst = info.get("shard_src", {}).get(s, s)
                per_shard_idx.setdefault(dst, []).append(idx)
                per_shard_prio.setdefault(dst, []).append(prio[off:off + len(idx)])
                off += len(idx)
        for s, idx_list in per_shard_idx.items():
            link = self.links[s]
            if link.dead:
                continue
            frame = wire.encode_prio(0, np.concatenate(idx_list).astype(np.uint32), np.concatenate(per_shard_prio[s]))
            self.wire_bytes += len(frame)
            try:
                link.prio_channel().send(frame, noblock=True)
                self.prio_frames += 1
            except (TimeoutError, OSError):
                pass  # an advisory refresh; the next batch's frame follows

    # -- FIFO arm (SEED) -----------------------------------------------------
    def pop_chunk(self, timeout_s: float = 2.0):
        """Round-robin pop of one trajectory chunk, or None when every
        shard is empty within the budget. The reply carries its own spec
        (chunk layouts are not known at hello time)."""
        deadline = time.monotonic() + timeout_s
        S = len(self.links)
        while time.monotonic() < deadline:
            link = self.links[self._rr % S]
            self._rr += 1
            if not self._revive(link):
                continue
            link.seq += 1
            if link.transport == "pickle":
                payload = wire.encode_pickle_msg({"kind": "pop", "seq": link.seq, "slot": 0})
            else:
                payload = wire.encode_pop(link.seq)
            self.wire_bytes += len(payload)
            try:
                link.sock.send(payload, noblock=True)
            except (TimeoutError, OSError):
                self._mark_dead(link)
                continue
            obj = self._pop_collect(link, link.seq, deadline)
            if obj is None:
                continue
            n = int(obj["n"])
            if n == 0:
                time.sleep(0.02)  # all caught up; do not spin the wire
                continue
            if "rows" in obj:
                rows = {k: np.asarray(v) for k, v in obj["rows"].items()}
            else:
                rows = {k: np.array(v) for k, v in obj["spec"].unpack(obj["body"], n).items()}
            return wire.unflatten_fields(rows), n
        return None

    def _pop_collect(self, link, want_seq, deadline):
        stop = min(deadline, time.monotonic() + 0.5)
        while time.monotonic() < stop:
            if self._stop is not None and self._stop.is_set():
                return None
            if not link.sock.poll(50):
                continue
            kind, obj = wire.decode_payload(link.sock.recv())
            if kind == "msg":
                kind = obj.get("kind", "?")
            # accept STALE pop_ok replies too (seq < want): POP is not
            # idempotent, the shard popped the chunk when it replied, so
            # discarding a reply that missed an earlier collect window
            # would lose that trajectory
            if kind == "pop_ok" and int(obj["seq"]) <= want_seq:
                if obj.get("spec") is not None and not isinstance(obj["spec"], wire.PlaneSpec):
                    obj["spec"] = wire.PlaneSpec.from_json(obj["spec"])
                return obj
        return None

    def gauges(self) -> dict[str, float]:
        return {
            "sample_wait_ms": float(self.sample_wait_ms),
            "refetches": float(self.refetches),
            "wire_bytes_out": float(self.wire_bytes),
            "prio_frames": float(self.prio_frames),
            "dead_links": float(sum(1 for link in self.links if link.dead)),
        }

    def close(self) -> None:
        self._closed = True
        self._jobs.put(None)
        if self._prefetch is not None:
            self._prefetch.close()
        for link in self.links:
            link.close()


class TieredSampler:
    """The hot tier in front of the shard fan-in.

    Wraps the warm :class:`ShardedSampler` with a device-resident
    ``replay/tiers.py::HotTier``: while the hot ring holds enough rows
    (``ready()``), an iteration's uniform batches are drawn ON THE CARD at
    *request* time (the draw and the replay gather kernel are enqueued and
    overlap the learner), so ``get_iteration`` returns batches already on
    the card. A miss (the hot ring still filling) falls back to the shard
    fan-in with the SAME seeds, counted in ``hot_misses``, never silent.

    This wrapper owns the seed chain the warm sampler otherwise owns (one
    seed per update, handed down through ``request_iteration(seeds=)``),
    so hot hits and warm misses consume the sequence the tiers-off path
    would.

    Uniform only: prioritized draws need the shards' live priority state,
    which a device snapshot cannot see, so the constructor refuses.
    """

    def __init__(self, warm: ShardedSampler, hot):
        if warm.prioritized:
            raise ValueError(
                "replay.tiers.hot requires uniform replay: prioritized draws depend on the shards' live priority state"
            )
        if warm.kind == "fifo":
            raise ValueError("replay.tiers.hot does not apply to the fifo arm")
        from collections import deque

        self._warm = warm
        self.hot = hot
        # adopt the warm sampler's chain (it never draws again: every
        # request hands seeds down)
        self._gen = warm._gen
        self.updates_per_iter = warm.updates_per_iter
        self.batch_size = warm.batch_size
        self.prioritized = False
        self.kind = warm.kind
        # per pending iteration: ("hot", [(device batch, seed), ...]) or
        # ("warm", None), first in first out with request/get
        self._route: deque = deque()
        self.hot_hits = 0
        self.hot_misses = 0
        self.sample_wait_ms = 0.0

    def append(self, rows) -> None:
        """Feed the hot ring a flat [n, ...] batch on the card (the
        collector's folded transitions, before any host hop)."""
        self.hot.append(rows)

    def request_iteration(self, watermarks: Sequence[int], beta: float = 0.0) -> None:
        seeds = next_seeds(self._gen, self.updates_per_iter)
        if self.hot.ready():
            # enqueue the draws now: device work that overlaps the learner
            staged = [(self.hot.sample(s), s) for s in seeds]
            self._route.append(("hot", staged))
            self.hot_hits += self.updates_per_iter
        else:
            self.hot_misses += self.updates_per_iter
            self._warm.request_iteration(watermarks, beta, seeds=seeds)
            self._route.append(("warm", None))

    def get_iteration(self, on_wait=None):
        t0 = time.perf_counter()
        if not self._route:
            return None
        src, staged = self._route.popleft()
        if src == "hot":
            out = [(wire.unflatten_fields(batch), seed, {"tier": "hot"}) for batch, seed in staged]
        else:
            out = self._warm.get_iteration(on_wait)
        wait_ms = (time.perf_counter() - t0) * 1e3
        self.sample_wait_ms = 0.2 * wait_ms + 0.8 * self.sample_wait_ms
        return out

    def update_priorities(self, infos, prios) -> None:
        self._warm.update_priorities(infos, prios)

    def gauges(self) -> dict[str, float]:
        g = self._warm.gauges()
        g["sample_wait_ms"] = float(self.sample_wait_ms)
        g["hot_hits"] = float(self.hot_hits)
        g["hot_misses"] = float(self.hot_misses)
        return g

    def close(self) -> None:
        self._warm.close()
