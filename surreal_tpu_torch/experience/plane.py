"""ExperiencePlane, the port of ``surreal_tpu/experience/plane.py``:
lifecycle and supervision of the sharded experience plane. It spawns the
shard servers (threads, or ``spawn``-context OS processes; both run
``shard.run_shard_server``), builds the sender and sampler pair, respawns
dead shards under the SEED supervisor's backoff schedule
(``utils/respawn.py::RespawnSchedule``), and aggregates the
``experience/*`` gauges and the ``experience_plane`` telemetry event that
``diag``'s "Experience plane" section renders.

Shard addresses are fixed at construction (the parent allocates the
ports), so a respawned shard binds the SAME endpoint and every client's
reconnecting DEALER reaches it and re-negotiates in place.

Process shards never touch the card: they import torch for a CPU
generator only (their stats report ``cuda_initialized``), and the plane
forwards the fault plan on the first spawn of each index only (a
respawned shard restarts its call counters at zero and would re-fire a
one-shot kill forever).

The plane owns the spill tier's sub-config (``replay.tiers.spill``,
forwarded to every shard, respawns included) and sums the shards' spill
counters into the ``tier/spill_*`` gauges. Not ported yet, and refused
naming the key: the ops plane's per-shard push (``ops_address``).
"""

from __future__ import annotations

import threading
import time
from typing import Any, Mapping

import numpy as np

from surreal_tpu_torch.experience import wire
from surreal_tpu_torch.experience.link import shard_dealer
from surreal_tpu_torch.experience.sampler import ShardedSampler
from surreal_tpu_torch.experience.sender import ExperienceSender
from surreal_tpu_torch.experience.shard import run_shard_server
from surreal_tpu_torch.distributed import sockets
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.net import alloc_address
from surreal_tpu_torch.utils.respawn import RespawnSchedule


class ExperiencePlane:
    # a respawn that survives this long clears its shard's failure streak
    _HEALTHY_S = 10.0

    def __init__(
        self,
        *,
        kind: str = "uniform",
        example: Mapping[str, Any] | None = None,
        capacity: int = 100_000,
        batch_size: int = 256,
        updates_per_iter: int = 1,
        num_slots: int = 1,
        max_insert_rows: int = 1024,
        priority_alpha: float = 0.6,
        priority_beta0: float = 0.4,
        priority_eps: float = 1e-6,
        cfg: Mapping[str, Any] | None = None,
        base_seed: int = 0,
        trace_id: str | None = None,
        prefetch: bool = True,
        device=None,
        ops_address: str | None = None,
        tiers: Mapping[str, Any] | None = None,
    ):
        if ops_address is not None:
            raise NotImplementedError(
                "ops_address: the ops plane (per-shard gauge pushes to the run aggregator) is not ported to "
                "PyTorch yet"
            )
        cfg = dict(cfg or {})
        self.kind = kind
        self.num_shards = max(1, int(cfg.get("num_shards", 2)))
        self.shard_mode = cfg.get("shard_mode", "thread")
        if self.shard_mode not in ("thread", "process"):
            raise ValueError(f"experience_plane.shard_mode {self.shard_mode!r} not in thread|process")
        self.transport = cfg.get("transport", "auto")
        self.trace_id = trace_id
        self._backoff_base = float(cfg.get("respawn_backoff_s", 0.5))
        self._backoff_cap = float(cfg.get("respawn_backoff_cap_s", 30.0))
        S = self.num_shards
        if kind != "fifo":
            for field, value in (("capacity", capacity), ("batch_size", batch_size)):
                if int(value) % S:
                    raise ValueError(
                        f"replay.{field}={value} must be divisible by experience_plane.num_shards={S} (each "
                        "shard holds an equal share)"
                    )
        self._shard_cfg = {
            "kind": kind if kind != "remote" else "uniform",
            "capacity": int(capacity) // S if kind != "fifo" else 0,
            "priority_alpha": float(priority_alpha),
            "priority_beta0": float(priority_beta0),
            "priority_eps": float(priority_eps),
            "watermark_timeout_s": float(cfg.get("watermark_timeout_s", 5.0)),
            "fifo_depth": int(cfg.get("fifo_depth", 64)),
        }
        spill_cfg = dict((tiers or {}).get("spill") or {})
        if spill_cfg.get("enabled"):
            self._shard_cfg["spill"] = spill_cfg
        self.addresses = [alloc_address() for _ in range(S)]
        self._stop = threading.Event()
        self._fault_plan_sent: set[int] = set()
        self.respawns = 0
        self.respawn_backoff_s = 0.0
        # immediate first respawn, base * 2^k capped, healthy-streak reset
        self._sched = RespawnSchedule(S, self._backoff_base, self._backoff_cap, healthy_s=self._HEALTHY_S)
        self._supervise_lock = threading.Lock()
        self.shards = [self._spawn_shard(i) for i in range(S)]
        self._stats_socks: list = [None] * S
        self._stats_cache: list[dict] = [{} for _ in range(S)]
        self._stats_seq = 0
        self.sender = None
        self.sampler = None
        try:
            spec = wire.PlaneSpec.from_example(example) if example is not None else None
            self.spec = spec
            self.sender = ExperienceSender(
                self.addresses, spec,
                num_slots=int(num_slots),
                slot_rows=int(max_insert_rows),
                transport=self.transport,
                insert_slots=int(cfg.get("insert_slots", 4)),
                trace=trace_id,
                ack_timeout_s=float(cfg.get("ack_timeout_s", 5.0)),
                respawn_backoff_s=self._backoff_base,
                respawn_backoff_cap_s=self._backoff_cap,
                stop_event=self._stop,
            )
            self.sampler = ShardedSampler(
                self.addresses, spec,
                batch_size=int(batch_size), base_seed=int(base_seed),
                kind=kind,
                updates_per_iter=int(updates_per_iter),
                transport=self.transport,
                trace=trace_id,
                prefetch=prefetch and kind != "fifo",
                sample_timeout_s=float(cfg.get("sample_timeout_s", 10.0)),
                respawn_backoff_s=self._backoff_base,
                respawn_backoff_cap_s=self._backoff_cap,
                device=device,
                stop_event=self._stop,
            )
        except BaseException:
            self.close()  # a failed build must not leak the shards it spawned
            raise

    def attach_tiers(self, tiered) -> None:
        """Swap the plane's sampler for its hot-tier wrapper
        (``sampler.py::TieredSampler`` over this plane's warm sampler):
        ``gauges``, ``telemetry_event`` and ``close`` then see the tiered
        view, ``experience/sample_wait_ms`` becomes the hot-hit wait, and
        the ``tier/*`` gauges appear."""
        self.sampler = tiered

    # -- lifecycle -----------------------------------------------------------
    def _spawn_shard(self, i: int):
        kwargs: dict[str, Any] = dict(trace_id=self.trace_id)
        args = (dict(self._shard_cfg), self.addresses[i], i)
        if self.shard_mode == "process":
            import multiprocessing as mp

            plan = faults.get().plan
            if plan and i not in self._fault_plan_sent:
                kwargs["fault_plan"] = plan
                self._fault_plan_sent.add(i)
            kwargs["untrack_slabs"] = True  # the trainer-side plane owns unlinks
            w = mp.get_context("spawn").Process(target=run_shard_server, args=args, kwargs=kwargs, daemon=True)
        else:
            w = threading.Thread(target=run_shard_server, args=args, kwargs=dict(kwargs, stop_event=self._stop),
                                 daemon=True, name=f"xp-shard-{i}")
        w.start()
        return w

    def supervise(self) -> None:
        """Respawn dead shards in place (same address; clients
        re-negotiate on their own) under the backoff schedule; a respawn
        that stays healthy clears its streak."""
        with self._supervise_lock:
            now = time.monotonic()
            for i, w in enumerate(self.shards):
                if w.is_alive():
                    self._sched.note_alive(i, now)
                    continue
                if not self._sched.due(i, now):
                    continue  # backing off a crash-looping shard
                self.shards[i] = self._spawn_shard(i)
                self.respawns += 1
                self.respawn_backoff_s = self._sched.respawned(i, now)

    def shard_pids(self) -> list[int]:
        """The OS process ids of process shards (empty in thread mode)."""
        return [w.pid for w in self.shards if getattr(w, "pid", None) is not None]

    # -- gauges / telemetry --------------------------------------------------
    def _poll_stats(self, timeout_ms: int = 200) -> None:
        """Refresh the per-shard stats cache over dedicated main-thread
        DEALER channels (the sample socket belongs to the prefetch
        thread). Dead shards keep their last snapshot."""
        self._stats_seq += 1
        pending = []
        for i in range(self.num_shards):
            if self._stats_socks[i] is None:
                self._stats_socks[i] = shard_dealer(self.addresses[i], f"xp-stats-{i}")
            try:
                self._stats_socks[i].send(wire.encode_stats(self._stats_seq), noblock=True)
                pending.append(i)
            except (TimeoutError, OSError):
                continue
        deadline = time.monotonic() + timeout_ms / 1e3
        while pending and time.monotonic() < deadline:
            for i in list(pending):
                if not self._stats_socks[i].poll(20):
                    continue
                try:
                    kind, obj = wire.decode_payload(self._stats_socks[i].recv())
                except sockets.Again:
                    continue
                if kind == "stats_ok":
                    # stale seqs still carry a valid snapshot; keep the newest
                    self._stats_cache[i] = obj["stats"]
                    if int(obj["seq"]) >= self._stats_seq:
                        pending.remove(i)

    def gauges(self, poll: bool = True) -> dict[str, float]:
        """The ``experience/*`` metrics-row gauges (documented in
        ``session/costs.py::GAUGE_REGISTRY``). ``poll=True`` refreshes the
        shard stats over the wire first: call it at the metrics cadence,
        not every iteration."""
        if poll:
            self._poll_stats()
        live = sum(1 for w in self.shards if w.is_alive())
        stats = self._stats_cache
        rows = sum(float(s.get("ingested_rows", 0)) for s in stats)
        fills = [float(s.get("fill", 0.0)) for s in stats if s]
        wire_bytes = sum(float(s.get("wire_bytes_in", 0)) for s in stats) + sum(
            float(s.get("wire_bytes_out", 0)) for s in stats)
        out = {
            "experience/shards_live": float(live),
            "experience/respawns": float(self.respawns),
            "experience/rows": rows,
            "experience/fill": float(np.mean(fills)) if fills else 0.0,
            "experience/ingest_rows_per_s": sum(float(s.get("ingest_rows_per_s", 0.0)) for s in stats),
            "experience/wire_bytes_per_step": wire_bytes / max(rows, 1.0),
            "experience/sample_queue_depth": sum(float(s.get("sample_queue_depth", 0)) for s in stats),
            "experience/sample_wait_ms": float(self.sampler.sample_wait_ms) if self.sampler is not None else 0.0,
            "experience/dropped_rows": float(self.sender.dropped_rows),
            "experience/sent_rows": float(sum(link.sent_rows for link in self.sender.links)),
        }
        # tier/* only while a tier is live, so tiers-off rows are unchanged
        hot = getattr(self.sampler, "hot", None)
        if hot is not None:
            out.update(hot.gauges())
            out["tier/hot_hits"] = float(self.sampler.hot_hits)
            out["tier/hot_misses"] = float(self.sampler.hot_misses)
        spills = [s for s in stats if s and "spill_segments" in s]
        if spills:
            for k in ("spill_segments", "spill_rows", "spill_bytes", "spill_errors", "spill_failed"):
                out[f"tier/{k}"] = sum(float(s.get(k, 0)) for s in spills)
            out["tier/cold_bytes_per_row"] = float(np.mean([float(s.get("cold_bytes_per_row", 0.0)) for s in spills]))
        return out

    def tier_table(self) -> dict:
        """Per-shard tier table: each shard's warm fill beside its spill
        progress, and the learner-side hot tier."""
        hot = getattr(self.sampler, "hot", None)
        shards = {
            str(i): {"warm_size": s.get("size", 0), "warm_fill": s.get("fill", 0.0),
                     **{k: v for k, v in s.items() if k.startswith("spill_") or k == "cold_bytes_per_row"}}
            for i, s in enumerate(self._stats_cache) if s
        }
        return {
            "hot": (dict(hot.gauges(), hits=self.sampler.hot_hits, misses=self.sampler.hot_misses)
                    if hot is not None else None),
            "shards": shards,
        }

    def telemetry_event(self) -> dict:
        """The ``experience_plane`` telemetry event body: per-shard
        snapshots, the sender and sampler view, and the tier table."""
        return {
            "tiers": self.tier_table(),
            "kind": self.kind,
            "num_shards": self.num_shards,
            "shard_mode": self.shard_mode,
            "transports": [link.transport for link in self.sender.links],
            "shards": {
                str(i): {k: v for k, v in s.items() if k not in ("wire_bytes_in", "wire_bytes_out")}
                for i, s in enumerate(self._stats_cache) if s
            },
            "sender": self.sender.gauges(),
            "sampler": self.sampler.gauges() if self.sampler is not None else {},
            **{
                k.split("/", 1)[1]: v for k, v in self.gauges(poll=False).items()
                if k in ("experience/wire_bytes_per_step", "experience/sample_wait_ms")
            },
        }

    def accounting(self) -> dict[str, float]:
        """Final exactly-once row accounting, read at a quiesced boundary
        (collection stopped, shards still alive: call BEFORE the stop is
        set). The sender side is read first and the shard stats second, so
        every row counted in ``sent_rows`` is, by the time
        ``ingested_rows`` is read, ingested, counted dropped, or still
        inflight. Drivers emit it as the ``experience_close`` telemetry
        event; the conservation ``sent == ingested + dropped + inflight``
        is strict while ``rehellos`` and ``respawns`` are zero."""
        snd = self.sender.gauges()
        self._poll_stats()
        stats = self._stats_cache
        return {
            "sent_rows": float(snd["sent_rows"]),
            "dropped_rows": float(snd["dropped_rows"]),
            "inflight_rows": float(snd["inflight_rows"]),
            "resends": float(snd["resends"]),
            "rehellos": float(snd["rehellos"]),
            "dead_links": float(snd["dead_links"]),
            "ingested_rows": sum(float(s.get("ingested_rows", 0)) for s in stats),
            "respawns": float(self.respawns),
            "num_shards": float(self.num_shards),
            "shards_live": float(sum(1 for w in self.shards if w.is_alive())),
        }

    def close(self) -> None:
        self._stop.set()
        if self.sampler is not None:
            self.sampler.close()
        if self.sender is not None:
            self.sender.close()
        for w in self.shards:
            if hasattr(w, "terminate"):
                w.terminate()
            w.join(timeout=5)
        for sock in self._stats_socks:
            if sock is not None:
                sock.close()
