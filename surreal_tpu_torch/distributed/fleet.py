"""InferenceFleet, the port of ``surreal_tpu/distributed/fleet.py``: N
replicated ``InferenceServer``s behind session-affinity routing, each
with its own coalescing budget, respawned in place when one dies, grown
and shrunk from the serve-latency EWMA.

- **Session affinity.** A worker hashes to a replica when it is spawned
  and stays there (``address_for``), so its trajectory streams and its
  shared-memory slabs keep one owner. Routing is rendezvous (highest
  random weight) hashing over the alive slots, with crc32 of fixed-width
  little-endian encodings: a replica's death moves only its own workers
  onto survivors, and a scale-up takes only the share that hashes to the
  new slot.
- **Per-replica budgets.** Each replica's ``min_batch`` is its own worker
  count from the affinity map; ``auto_tune`` follows its live workers
  from there, so each replica runs one forward per lockstep round.
- **Lifecycle.** A dead replica (its serve thread gone, as after the
  ``fleet.replica`` ``kill_replica`` injection) is closed (its slabs
  unlinked) and respawned at its fixed address under the backoff of
  ``utils/respawn.py``, at the fleet's current params version. Its
  workers' requests time out meanwhile, they die, and the worker
  supervisor respawns them against ``address_for``, which routes them to
  survivors.
- **Autoscaling.** The fleet-mean serve-latency EWMA above
  ``scale_up_serve_ms`` adds a replica (re-arming a drained slot first)
  up to ``max_replicas``; below ``scale_down_serve_ms`` the replica with
  the fewest workers is drained, down to ``min_replicas``. One decision
  per call, spaced by a cooldown, and counted.

What the port adds: **no two threads apply one module.** A torch act
function swaps parameters into its module while it runs
(``functional_call``), so the reference's one act closure for every
replica would race. An act function with a ``for_slot(i)`` method hands
each slot its own callable (``launch/seed_trainer.py``: the slot's own
acting copy and generator); any other callable is pure and shared, as in
the reference. ``serve_act`` takes the slot's lock around a per-slot
callable, whichever version it serves.

Parameter distribution outside the process is the fanout
(``distributed/param_fanout.py``); in-process replicas take the new act
function through ``set_act_fn``.
"""

from __future__ import annotations

import queue
import threading
import time
import zlib
from collections import OrderedDict
from typing import Callable

import numpy as np

from surreal_tpu_torch.distributed.inference_server import InferenceServer
from surreal_tpu_torch.utils.net import alloc_address
from surreal_tpu_torch.utils.respawn import RespawnSchedule


def _rendezvous_score(worker_id: int, replica: int) -> int:
    """Highest-random-weight score of (worker, replica): crc32 of
    fixed-width little-endian encodings (the same in every process)."""
    return zlib.crc32(int(worker_id).to_bytes(8, "little") + int(replica).to_bytes(8, "little"))


def _slot_fn(act_fn, slot: int) -> Callable:
    """What replica ``slot`` acts through: ``act_fn.for_slot(slot)`` for
    an act function with per-slot modules, else ``act_fn`` itself."""
    for_slot = getattr(act_fn, "for_slot", None)
    return act_fn if for_slot is None else for_slot(slot)


class InferenceFleet:
    """N replicated servers with the single server's surface (``chunks``,
    ``set_act_fn``, ``version``, ``queue_stats``, ``episode_stats``,
    ``transport_stats``, ``hop_stats``, ``address_for``, ``close``), so
    the SEED trainer does not depend on the tier's size."""

    # a respawn that survives this long clears its slot's failure streak
    _HEALTHY_S = 10.0

    def __init__(
        self,
        act_fn: Callable,
        *,
        num_workers: int,
        replicas: int = 2,
        unroll_length: int = 32,
        max_wait_ms: float = 5.0,
        transport: str = "auto",
        sanitize_obs: bool = True,
        trace_id: str | None = None,
        min_replicas: int = 1,
        max_replicas: int = 4,
        autoscale: bool = False,
        scale_up_serve_ms: float = 40.0,
        scale_down_serve_ms: float = 5.0,
        scale_cooldown_s: float = 30.0,
        respawn_backoff_s: float = 0.5,
        respawn_backoff_cap_s: float = 30.0,
        act_history: int = 8,
        ops_address: str | None = None,
        span_sink=None,
        trace_sample_n: int = 0,
        lineage: bool = True,
    ):
        if replicas < 1:
            raise ValueError(f"inference_fleet.replicas must be >= 1, got {replicas}")
        self._act_fn = act_fn
        self._version = 0
        # {version -> act function}, oldest evicted: a pinned serve asks
        # for "the policy that was version V" after set_act_fn moved on
        self._act_history: "OrderedDict[int, Callable]" = OrderedDict({0: act_fn})
        self._act_history_limit = max(1, int(act_history))
        self.num_workers = int(num_workers)
        self.trace_id = trace_id
        # one output queue for every replica: the trainer's chunk wait
        # stays one blocking get, and eviction prefers the oldest chunk
        # fleet-wide
        self.chunks: "queue.Queue[dict]" = queue.Queue(maxsize=64)
        self._server_kwargs = dict(
            unroll_length=unroll_length, max_wait_ms=max_wait_ms, transport=transport,
            auto_tune=True,  # per-replica budgets follow per-replica liveness
            sanitize_obs=sanitize_obs, trace_id=trace_id, chunks=self.chunks, ops_address=ops_address,
            span_sink=span_sink, trace_sample_n=trace_sample_n, lineage=lineage,
        )
        self._span_sink = span_sink
        self.min_replicas = max(1, int(min_replicas))
        self.max_replicas = max(self.min_replicas, int(max_replicas))
        self.autoscale = bool(autoscale)
        self.scale_up_serve_ms = float(scale_up_serve_ms)
        self.scale_down_serve_ms = float(scale_down_serve_ms)
        self.scale_cooldown_s = float(scale_cooldown_s)
        self.respawns = 0
        self.scale_ups = 0
        self.scale_downs = 0
        self.respawn_backoff_s = 0.0  # gauge: the backoff set by the last respawn
        self._last_scale_at = time.monotonic()
        # slot i: a fixed address and its server (None: drained by a
        # scale-down; a dead server stays until its respawn)
        n = min(max(int(replicas), self.min_replicas), self.max_replicas)
        self._addresses = [alloc_address() for _ in range(n)]
        self._replicas: list[InferenceServer | None] = []
        self._sched = RespawnSchedule(n, respawn_backoff_s, respawn_backoff_cap_s, healthy_s=self._HEALTHY_S)
        # supervision runs on the staging thread's empty polls and on the
        # trainer thread: one lock
        self._lock = threading.Lock()
        try:
            for i in range(n):
                self._replicas.append(self._spawn(i))
        except BaseException:
            self.close()
            raise
        self._rebalance_budgets()

    # -- replica lifecycle ---------------------------------------------------
    def _spawn(self, i: int) -> InferenceServer:
        return InferenceServer(
            act_fn=_slot_fn(self._act_fn, i),
            bind=self._addresses[i],
            min_batch=1,  # _rebalance_budgets installs the affinity share
            version=self._version,
            # a respawn keeps its slot's tier name
            ops_tier=f"fleet.replica{i}",
            **self._server_kwargs,
        )

    def servers(self) -> list[InferenceServer]:
        """The alive replicas, in slot order."""
        return [s for s in self._replicas if s is not None and s.alive]

    def _alive_slots(self) -> list[int]:
        return [i for i, s in enumerate(self._replicas) if s is not None and s.alive]

    def replica_of(self, worker_id: int) -> int:
        """The session-affinity route: ``worker_id`` rendezvous-hashed over
        the alive slots. With none alive, over the slots the supervisor
        will respawn (not drained): a drained slot never rebinds its
        address."""
        alive = self._alive_slots()
        if not alive:
            alive = [i for i, s in enumerate(self._replicas) if s is not None] or list(range(len(self._addresses)))
        return max(alive, key=lambda r: _rendezvous_score(worker_id, r))

    def address_for(self, worker_id: int) -> str:
        return self._addresses[self.replica_of(worker_id)]

    def _affinity_counts(self) -> dict[int, int]:
        """{alive slot -> its worker count} under the affinity map: one
        count for the budgets and the scale-down victim alike."""
        counts = {i: 0 for i in self._alive_slots()}
        for w in range(self.num_workers):
            r = self.replica_of(w)
            if r in counts:
                counts[r] += 1
        return counts

    def _rebalance_budgets(self) -> None:
        """Each replica's coalescing budget is its share of the workers."""
        for i, c in self._affinity_counts().items():
            srv = self._replicas[i]
            if srv is not None:
                srv.min_batch = max(1, c)

    def supervise(self) -> None:
        """Respawn dead replicas in place (fixed address) under the backoff
        schedule; a respawn that stays healthy clears its streak. Drained
        slots stay drained."""
        with self._lock:
            now = time.monotonic()
            for i, srv in enumerate(self._replicas):
                if srv is None:
                    continue
                if srv.alive:
                    self._sched.note_alive(i, now)
                    continue
                if not self._sched.due(i, now):
                    continue  # backing off a crash-looping replica
                # the dead loop released its socket; close() joins it and
                # unlinks every slab before the rebind
                srv.close()
                self._replicas[i] = self._spawn(i)
                self.respawns += 1
                self.respawn_backoff_s = self._sched.respawned(i, now)
                self._rebalance_budgets()

    # -- autoscaling ---------------------------------------------------------
    def _serve_ms_mean(self) -> float | None:
        ewmas = [s._serve_ms_ewma for s in self.servers() if s._serve_ms_ewma is not None]
        return sum(ewmas) / len(ewmas) if ewmas else None

    def maybe_autoscale(self) -> str | None:
        """One scale decision per call (the metrics cadence), after the
        cooldown: 'up', 'down' or None, from the fleet-mean serve EWMA."""
        if not self.autoscale:
            return None
        now = time.monotonic()
        if now - self._last_scale_at < self.scale_cooldown_s:
            return None
        serve_ms = self._serve_ms_mean()
        if serve_ms is None:
            return None
        alive = self._alive_slots()
        if serve_ms > self.scale_up_serve_ms and len(alive) < self.max_replicas:
            self.scale_up()
            self._last_scale_at = now
            return "up"
        if serve_ms < self.scale_down_serve_ms and len(alive) > self.min_replicas:
            self.scale_down()
            self._last_scale_at = now
            return "down"
        return None

    def scale_up(self) -> int:
        """Add one replica, re-arming a drained slot first (its address is
        allocated already), else a new slot. Only new and respawned
        workers route to it: connected workers never move mid-stream."""
        with self._lock:
            for i, srv in enumerate(self._replicas):
                if srv is None:
                    self._replicas[i] = self._spawn(i)
                    break
            else:
                self._addresses.append(alloc_address())
                self._sched.add_slot()
                self._replicas.append(self._spawn(len(self._replicas)))
                i = len(self._replicas) - 1
            self.scale_ups += 1
            self._rebalance_budgets()
            return i

    def scale_down(self) -> int | None:
        """Drain the alive replica with the fewest workers: close it (its
        half-built chunks are lost, as in a crash) and leave its slot
        empty. Its workers time out, die and are respawned against a
        survivor."""
        with self._lock:
            alive = self._alive_slots()
            if len(alive) <= self.min_replicas:
                return None
            counts = self._affinity_counts()
            victim = min(alive, key=lambda i: (counts[i], -i))
            srv = self._replicas[victim]
            self._replicas[victim] = None
            self.scale_downs += 1
        # outside the lock: close() joins the serve thread (2 s at most)
        if srv is not None:
            srv.close()
        self._rebalance_budgets()
        return victim

    # -- the single server's surface ------------------------------------------
    def set_act_fn(self, act_fn: Callable) -> None:
        """Give every alive replica the new policy (each bumps its own
        version; the fleet's counter is what a respawn starts from)."""
        self._act_fn = act_fn
        self._version += 1
        self._act_history[self._version] = act_fn
        while len(self._act_history) > self._act_history_limit:
            self._act_history.popitem(last=False)
        for i, srv in enumerate(self._replicas):
            if srv is not None and srv.alive:
                srv.set_act_fn(_slot_fn(act_fn, i))

    @property
    def version(self) -> int:
        return self._version

    def held_versions(self) -> list[int]:
        """The params versions whose act functions the fleet still holds."""
        return list(self._act_history)

    def serve_act(self, obs, *, replica: int | None = None, version: int | None = None, span_ctx=None):
        """One synchronous forward in the caller's thread (the gateway's
        act path): ``(actions, served_version)``. A dead or drained
        ``replica`` raises ``LookupError``; a ``version`` evicted from the
        history raises ``KeyError``. ``span_ctx`` (a child ``TraceContext``)
        emits a ``replica.forward`` span under it, and the replica adopts
        its exemplar for its next chunk."""
        slot = self.replica_of(0) if replica is None else int(replica)
        srv = self._replicas[slot] if 0 <= slot < len(self._replicas) else None
        if srv is None or not srv.alive:
            raise LookupError(f"replica {slot} is not alive")
        t0 = time.monotonic() if span_ctx is not None else 0.0
        if version is None or version == self._version:
            # the current policy, under the replica's own serve lock
            with srv._act_lock:
                actions, _ = srv._act_fn(obs)
                served = srv._version
        else:
            fn = self._act_history.get(int(version))
            if fn is None:
                raise KeyError(
                    f"param version {version} evicted from the act history (held: {self.held_versions()})"
                )
            call = _slot_fn(fn, slot)
            if call is fn:
                actions, _ = call(obs)  # a pure act function: no lock needed
            else:
                with srv._act_lock:  # it applies the slot's modules
                    actions, _ = call(obs)
            served = int(version)
        if span_ctx is not None and self._span_sink is not None:
            self._span_sink.emit_span(
                "replica.forward", span_ctx, tier=f"fleet.replica{slot}",
                dur_ms=(time.monotonic() - t0) * 1e3, version=int(served),
            )
            srv.note_exemplar(span_ctx.exemplar, span_ctx.span_id)
        return np.asarray(actions), served

    def episode_stats(self) -> dict[str, float] | None:
        stats = [s.episode_stats() for s in self.servers()]
        stats = [s for s in stats if s]
        if not stats:
            return None
        # the mean of the replicas' rolling means
        return {k: sum(s[k] for s in stats) / len(stats) for k in stats[0]}

    def transport_stats(self) -> dict[str, float]:
        servers = self.servers()
        per = [s.transport_stats() for s in servers]
        # the raw byte and step counters summed, not the ratios averaged
        wire = sum(s._wire_bytes for s in servers)
        steps = sum(s._served_steps for s in servers)
        out = {
            "shm_workers": sum(t["shm_workers"] for t in per),
            "pickle_workers": sum(t["pickle_workers"] for t in per),
            "wire_bytes_per_step": wire / max(steps, 1),
        }
        occ = [t["pipeline_occupancy"] for t in per if "pipeline_occupancy" in t]
        if occ:
            out["pipeline_occupancy"] = sum(occ) / len(occ)
        # the replicas' held params versions (a respawn lag shows as min < max)
        versions = [s.version for s in servers]
        if versions:
            out["param_version_min"] = float(min(versions))
            out["param_version_max"] = float(max(versions))
        return out

    def queue_stats(self) -> dict[str, float]:
        """The ``server/*`` gauges aggregated (sums of counters, means of
        EWMAs) and the ``fleet/*`` gauges."""
        servers = self.servers()
        out: dict[str, float] = {
            "server/queue_depth": float(self.chunks.qsize()),
            "server/evicted_chunks": float(sum(s.evicted_chunks for s in servers)),
            "server/evicted_steps": float(sum(s.evicted_steps for s in servers)),
            "server/sanitized_requests": float(sum(s.sanitized_requests for s in servers)),
        }
        serve = self._serve_ms_mean()
        if serve is not None:
            out["server/serve_ms"] = float(serve)
        widths = [s._serve_batch_ewma for s in servers if s._serve_batch_ewma is not None]
        if widths:
            out["server/serve_batch"] = float(sum(widths) / len(widths))
        out.update({f"server/{k}": v for k, v in self.transport_stats().items()})
        lat = [s.queue_stats().get("server/act_latency_ms") for s in servers]
        lat = [v for v in lat if v is not None]
        if lat:
            out["server/act_latency_ms"] = float(sum(lat) / len(lat))
        out.update(self.fleet_gauges())
        return out

    def fleet_gauges(self) -> dict[str, float]:
        """The ``fleet/*`` gauges (``session/costs.py::GAUGE_REGISTRY``)."""
        out = {
            "fleet/replicas_live": float(len(self._alive_slots())),
            "fleet/respawns": float(self.respawns),
            "fleet/scale_ups": float(self.scale_ups),
            "fleet/scale_downs": float(self.scale_downs),
            "fleet/queue_depth": float(self.chunks.qsize()),
        }
        serve = self._serve_ms_mean()
        if serve is not None:
            out["fleet/serve_ms"] = float(serve)
        return out

    def hop_stats(self) -> dict[str, dict]:
        """Fleet-wide hop percentiles: the replicas' sample windows merged."""
        from surreal_tpu_torch.session.telemetry import latency_percentiles

        transit: list[float] = []
        serve: list[float] = []
        for s in self.servers():
            transit.extend(s._hop_transit)
            serve.extend(s._hop_serve)
        out = {}
        p = latency_percentiles(transit)
        if p is not None:
            out["worker_to_server_ms"] = p
        p = latency_percentiles(serve)
        if p is not None:
            out["serve_batch_ms"] = p
        return out

    def worker_traces(self) -> dict[str, str | None]:
        out: dict[str, str | None] = {}
        for s in self.servers():
            out.update(s.worker_traces())
        return out

    def tier_event(self) -> dict:
        """The ``serving_tier`` telemetry event's body (diag's "Serving
        tier"): each replica's state, budget, serve EWMA, workers and
        params version, and the tier gauges."""
        per_replica = {}
        for i, srv in enumerate(self._replicas):
            if srv is None:
                per_replica[str(i)] = {"state": "drained"}
                continue
            per_replica[str(i)] = {
                "state": "alive" if srv.alive else "dead",
                "address": self._addresses[i],
                "min_batch": srv.min_batch,
                "serve_ms": srv._serve_ms_ewma,
                "workers": len(srv.worker_traces()),
                "param_version": srv.version,
                "evicted_chunks": srv.evicted_chunks,
            }
        return {"replicas": per_replica, "autoscale": self.autoscale, "num_workers": self.num_workers,
                **self.fleet_gauges()}

    def close(self) -> None:
        with self._lock:
            replicas, self._replicas = self._replicas, []
        for srv in replicas:
            if srv is not None:
                srv.close()
