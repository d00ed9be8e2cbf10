"""SEED trainer, the port of ``surreal_tpu/launch/seed_trainer.py``
(``hop_event``, ``_DataPlane``, ``SEEDTrainer``) on one device: a central
inference server (or a replicated fleet of them), host env workers and
the learner, the topology for envs that cannot live on the card
(BASELINE config 5's "SEED-RL batched inference").

Data flow:
  env workers --sockets--> InferenceServer, or InferenceFleet
     │                     (topology.inference_fleet: replicas > 1 or
     │                     autoscale; one batched policy forward a replica)
     └─ trajectory chunks --queue--> staging thread (learners/prefetch.py:
        the chunk's host->device copy) --> learner.learn (V-trace corrects
        the one-update staleness; PPO with ``max_staleness`` drops chunks
        acted too many updates ago)

Workers run as threads or as spawned OS processes
(``topology.worker_mode='process'``), both through
``distributed/env_worker.py::run_env_worker``; they never touch CUDA.

Acting: each server thread acts through a ``Learner.acting_copy()`` of
its own, made on the main thread before the servers start
(``functional_call`` swaps parameters into the module object, so two
threads must not apply one module), with its own ``torch.Generator`` on
the learner's device: one copy for the single server, one per replica
slot for a fleet (``SlotActs``; a slot's respawns and scale-ups reuse
its copy). Every ``set_act_fn`` publishes the state the learn just
returned (the learns are out of place), and the servers act on that
snapshot. A serve reads the actions and the behaviour info back in one
device->host copy, and acts on exactly the rows it has (see
``_make_act_fn``). Every worker spawn and respawn goes to
``server.address_for(i)``: the fleet's affinity map, which routes a
worker whose replica died to a survivor.

``run`` is the reference's: ``SessionHooks`` around a ``LoopEngine`` with
the ``collect`` and ``learn`` stages; supervision under the respawn
backoff, the staleness drop, the ``data_plane`` and ``hops`` events, the
metrics row with the data-plane extras, ``staleness/updates_behind`` and
the ``lineage/*`` gauges under the reference's names; with a fleet, its
supervision beside the workers', one autoscale decision and one
``serving_tier`` event a metrics row, and the ``fleet/*`` gauges in it.

The experience plane's chunk relay (``topology.experience_plane.enabled``):
a relay thread ships every chunk the server assembles through the
ExperienceSender into the shards' FIFO arm (``experience/``), and the
staging thread pops chunks from the shards instead of the server's queue
(locally a loop-through; across hosts the seam between an actor fleet
and the learner). The relay thread's death is raised on the main thread,
and the ``experience/*`` gauges ride the metrics row.

The session gateway (``topology.gateway.enabled``, with a fleet): a
``gateway/server.py::GatewayServer`` in front of the fleet serves external
tenants' sessions while the run trains, acting through
``InferenceFleet.serve_act`` on the live policy (or a pinned older
snapshot). Its address goes into ``<folder>/gateway.json`` (an atomic
rename, unlinked at close), its serve thread is supervised with the
workers, its ``gateway/*`` gauges ride the metrics row, its hop windows
join the ``hops`` event, and a ``gateway`` event is written each metrics
row. It is closed before the fleet.

The ops plane: the replicas, the gateway and the relay's shards push
their rows to the session's aggregator (``hooks.ops.address``), and once
every tier exists the remediation engine gets its actuators: the fleet's
``scale_up``, the gateway's admission quotas, each tier's ``supervise``
as its restart, and the learner downshift on the live algo config.

Not carried, and refused with ``NotImplementedError`` naming the key: a dp
mesh (``topology.mesh.dp > 1``) and the learner group
(``topology.learner_group``). DDPG and the trajectory encoder are refused
with the reference's messages.
"""

from __future__ import annotations

import copy
import functools
import json
import os
import queue
import threading
import time
from collections import deque
from typing import Callable

import numpy as np
import torch

from surreal_tpu_torch.distributed.env_worker import run_env_worker
from surreal_tpu_torch.distributed.fleet import InferenceFleet
from surreal_tpu_torch.distributed.inference_server import InferenceServer
from surreal_tpu_torch.engine import EngineConfig, LoopEngine, LoopState, Outcome, StageSpec, sideband_stages
from surreal_tpu_torch.envs.factory import make_env
from surreal_tpu_torch.launch.hooks import SessionHooks, training_env_config
from surreal_tpu_torch.launch.trainer import derive_seed
from surreal_tpu_torch.learners import TRAINING, build_learner
from surreal_tpu_torch.learners.aggregator import to_device
from surreal_tpu_torch.learners.prefetch import Prefetcher
from surreal_tpu_torch.session.telemetry import LineageReducer, TraceContext, latency_percentiles
from surreal_tpu_torch.tune import resolve_autotune
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.device import resolve_device
from surreal_tpu_torch.utils.respawn import RespawnSchedule

_FROM_CONFIG = object()  # sentinel: None is a meaningful max_staleness value


def hop_event(server, plane, learn_ms, gateway=None) -> dict:
    """The per-hop latency percentiles of one ``hops`` telemetry event:
    worker step -> frame in flight -> serve batch -> queue dwell -> learn
    (the learn hop measures its dispatch, the span discipline of
    session/telemetry.py). A live gateway adds its act, transit and attach
    windows."""
    hops = dict(server.hop_stats())
    p = latency_percentiles(list(plane.dwell_ms))
    if p is not None:
        hops["chunk_queue_dwell_ms"] = p
    p = latency_percentiles(list(learn_ms))
    if p is not None:
        hops["learn_dispatch_ms"] = p
    if gateway is not None:
        hops.update(gateway.hop_stats())
    return hops


def _check_topology(topo) -> None:
    """Refuse, naming the key, the topology options this port does not
    carry (all off by default)."""

    def refuse(key: str, what: str):
        raise NotImplementedError(f"session_config.topology.{key}: {what} is not ported to PyTorch yet")

    mesh = topo.get("mesh", None)
    if mesh is not None and int(mesh.get("dp", -1)) > 1:
        refuse("mesh.dp", "a data-parallel SEED learner")
    group = topo.get("learner_group", None)
    if group is not None and int(group.get("members", 1)) > 1:
        refuse("learner_group", "the learner group")


def fleet_config(topo):
    """``topology.inference_fleet`` when it asks for the replicated tier
    (more than one replica, or autoscale), else None."""
    fc = topo.get("inference_fleet", None)
    if fc is not None and (int(fc.get("replicas", 1)) > 1 or bool(fc.get("autoscale", False))):
        return fc
    return None


class SlotActs:
    """Act functions, one per server slot: slot ``i`` acts through its own
    (acting copy, generator) pair, ``make_slot(i)``'s, so no two serve
    threads apply one module. The ``n`` pairs are made when this is built,
    on the main thread before any server starts; every snapshot (``at``)
    shares them, so a slot's respawns reuse its pair."""

    def __init__(self, make_act_fn, make_slot, n: int):
        self._make = make_act_fn       # (actor, state, generator) -> act function
        self._make_slot = make_slot    # i -> (actor, generator)
        self._slots = [make_slot(i) for i in range(n)]
        self.state = None

    def at(self, state) -> "SlotActs":
        """The same slots acting on ``state``."""
        twin = copy.copy(self)
        twin.state = state
        return twin

    def for_slot(self, i: int):
        while len(self._slots) <= i:
            # a slot beyond the pairs made up front: only a scale-up past a
            # dead slot awaiting its respawn asks for one, and scale-ups run
            # on the main thread (the metrics cadence)
            self._slots.append(self._make_slot(len(self._slots)))
        actor, generator = self._slots[i]
        return self._make(actor, self.state, generator)


class _DataPlane:
    """Running SEED data plane: server + worker fleet + supervision.

    ``next_chunk`` waits for experience while supervising workers on every
    empty poll: a dead SOLE worker must be respawned while waiting, not
    after a chunk it can no longer produce. ``respawns`` accumulates for
    the metrics stream. The chunk timeout falls to ``steady_timeout``
    after the first chunk."""

    # a respawn that survives this long clears its worker's failure streak
    # (the exponential backoff targets crash loops, not one-off kills)
    _HEALTHY_S = 10.0

    def __init__(
        self, trainer, server, workers, env_cfg, stop, first_timeout,
        respawn_backoff_s: float = 0.5, respawn_backoff_cap_s: float = 30.0,
    ):
        self.trainer = trainer
        self.server = server
        self.workers = workers
        self.env_cfg = env_cfg
        self.stop = stop
        self.respawns = 0
        self._timeout = first_timeout
        # the steady starvation deadline must cover the worker-silence
        # recovery window: a worker wedged on a reply that never comes (its
        # step frame dropped on the wire) self-kills only after
        # worker_silence_s, and its respawn happens on a supervise() pass
        # after that
        self.steady_timeout = max(30.0, float(getattr(trainer, "worker_silence_s", 0.0)) * 1.5)
        self.last_chunk_age_s = 0.0  # queue dwell of the last chunk served
        # rolling queue-dwell samples for the hop percentiles (appended by
        # whichever thread runs next_chunk, snapshot with list())
        self.dwell_ms: deque = deque(maxlen=256)
        self._sched = RespawnSchedule(
            len(workers), respawn_backoff_s, respawn_backoff_cap_s, healthy_s=self._HEALTHY_S,
        )
        self.respawn_backoff_s = 0.0  # gauge: backoff set by the last respawn
        # supervision runs on the staging thread (empty-poll waits) and on
        # the trainer thread (drop path, after a learn): one lock, so both
        # cannot respawn the same dead worker
        self._supervise_lock = threading.Lock()

    def supervise(self) -> None:
        """Replace any dead worker in place, under the backoff schedule.
        Workers are stateless: a fresh one reopens its DEALER under the
        same identity, and the server's first message from it (obs only)
        replaces the stale pending state without fabricating a
        transition. A fleet's replicas are supervised in the same pass,
        first, and a respawned worker goes to ``address_for``: a worker
        whose replica died re-hellos to a survivor."""
        if isinstance(self.server, InferenceFleet):
            self.server.supervise()
        with self._supervise_lock:
            now = time.monotonic()
            for i, w in enumerate(self.workers):
                if w.is_alive():
                    self._sched.note_alive(i, now)
                    continue
                if not self._sched.due(i, now):
                    continue  # backing off a crash-looping worker
                self.workers[i] = self.trainer._spawn_one(i, self.env_cfg, self.server.address_for(i), self.stop)
                self.respawns += 1
                self.respawn_backoff_s = self._sched.respawned(i, now)

    def next_chunk(self) -> dict:
        deadline = time.monotonic() + self._timeout
        self._timeout = self.steady_timeout
        while True:
            if self.stop.is_set():
                # teardown: the staging thread must not sit out its full
                # chunk timeout against a closed server
                raise TimeoutError("data plane stopped") from None
            try:
                chunk = self.server.chunks.get(timeout=2.0)
                # queue-latency gauge (the server stamps _t_ready at assembly)
                self.last_chunk_age_s = time.monotonic() - chunk.pop("_t_ready", time.monotonic())
                self.dwell_ms.append(self.last_chunk_age_s * 1e3)
                return chunk
            except queue.Empty:
                self.supervise()
                if time.monotonic() >= deadline:
                    raise TimeoutError("no experience chunks arriving from workers") from None

    def close(self) -> None:
        self.stop.set()
        self.server.close()
        for w in self.workers:
            if hasattr(w, "terminate"):  # subprocess workers
                w.terminate()
            w.join(timeout=5)


class SEEDTrainer:
    """SEED topology on one device; ``device`` defaults to the card and
    raises without it."""

    def __init__(
        self,
        config,
        worker_mode: str | None = None,
        max_staleness: int | None | object = _FROM_CONFIG,
        device: str | torch.device = "cuda",
    ):
        # config is the user-facing path (session.topology.worker_mode,
        # learner.algo.max_staleness, both reachable with --set); the
        # constructor arguments override it for tests and embedding
        if worker_mode is None:
            worker_mode = config.session_config.topology.get("worker_mode", "thread")
        if worker_mode not in ("thread", "process"):
            raise ValueError(f"worker_mode {worker_mode!r} not in thread|process")
        algo_name = config.learner_config.algo.name
        if algo_name == "ddpg":
            # the server stitches chunks from behavior-policy info (logp);
            # DDPG's deterministic actor has none
            raise ValueError(
                "SEEDTrainer supports on-policy learners (ppo, impala); "
                "for ddpg use OffPolicyTrainer (host mode)"
            )
        self.config = config
        self.device = resolve_device(device)
        topo = config.session_config.topology
        _check_topology(topo)
        # one env to read the specs (workers build their own)
        probe = make_env(config.env_config)
        self.specs = probe.specs
        probe.close()
        self.learner = build_learner(config.learner_config, self.specs, self.device)
        # the program autotuner: a host-env SEED workload has no device
        # iteration, so its search surface is the LEARN program alone
        # (tune/search.py LEARN_PHASE_DIMS); `tune <algo> <host-env>`
        # populates exactly this fingerprint
        self.tune_decision = resolve_autotune(config, self.learner.config, self.device)
        if self.tune_decision.applied:
            self.learner = build_learner(config.learner_config, self.specs, self.device)
        if getattr(self.learner, "requires_act_carry", False):
            # the server's micro-batches mix worker slices that advance
            # asynchronously, while the act carry keeps one segment
            # position for the whole batch
            raise ValueError(
                "model.encoder.kind='trajectory' is not supported by the "
                "SEED inference server (its micro-batches mix worker "
                "slices that advance asynchronously; the segment carry is "
                "lockstep). Trajectory policies act via the fused device "
                "collectors, the evaluator, `surreal_tpu actor`, and "
                "`eval --follow`."
            )
        self.algo = self.learner.config.algo
        self.seed = config.session_config.seed
        self.num_workers = max(1, topo.num_env_workers)
        self.worker_mode = worker_mode
        # host data plane (distributed/shm_transport.py): 'auto' resolves
        # to pickle for thread workers and to shm negotiation for process
        # workers, which are always spawned on this host
        transport = topo.get("transport", "auto")
        if transport not in ("auto", "shm", "pickle"):
            raise ValueError(f"topology.transport {transport!r} not in auto|shm|pickle")
        self.worker_transport = "pickle" if transport == "auto" and worker_mode == "thread" else transport
        self.worker_silence_s = float(topo.get("worker_silence_s", 120.0))
        # the experience plane's FIFO chunk relay (see the module docstring)
        xp = topo.get("experience_plane", None)
        self.experience_plane_enabled = bool(xp.get("enabled", False)) if xp is not None else False
        # worker indices whose first process spawn already carried the
        # fault plan (see _spawn_one)
        self._fault_plan_sent: set[int] = set()
        # run() sets these from the hooks before the data plane spawns:
        # every worker inherits the run-scoped trace id, the server emits
        # causal spans into the hooks' tracer at its sampling rate, and
        # stamps lineage when telemetry.lineage is on
        self._trace_id: str | None = None
        self._ops_address: str | None = None
        self._span_sink = None
        self._trace_sample_n = 0
        self._lineage = True
        n_envs = int(config.env_config.num_envs)
        # pipelined sub-slices halve each chunk's width: keep the two
        # widths equal (an even split only)
        self.pipeline_workers = bool(topo.get("pipeline_workers", True)) and n_envs >= 2 and n_envs % 2 == 0
        self.chunk_width = n_envs // 2 if self.pipeline_workers else n_envs
        self.steps_per_iter = self.algo.horizon * self.chunk_width  # one chunk a learn
        if max_staleness is _FROM_CONFIG:
            # the extended algo tree (build_learner layered the defaults)
            max_staleness = self.algo.get("max_staleness", None)
        self.max_staleness = max_staleness
        # the learn program (PPO's draws its epoch permutations from the
        # generator it is given; tests pass them as ``perms``)
        self._learn = self.learner.learn

    def _spawn_one(self, i: int, env_cfg, address: str, stop):
        """Start env worker ``i`` against the server at ``address``, as a
        thread or a subprocess. Process mode uses the ``spawn`` start
        method: forking after torch has started threads (and CUDA) is
        unsafe, and workers need only numpy and the host env."""
        kwargs = dict(
            transport=self.worker_transport,
            pipeline=self.pipeline_workers,
            server_silence_s=self.worker_silence_s,
            trace_id=self._trace_id,
        )
        if self.worker_mode == "process":
            import multiprocessing as mp

            # a spawned worker starts with an empty fault registry: forward
            # the plan so worker-site injections reach process mode too
            # (thread workers share this process's registry). First spawn
            # per index only: a respawned process would restart its call
            # counters at zero and re-fire one-shot faults forever
            plan = faults.get().plan
            if plan and i not in self._fault_plan_sent:
                kwargs["fault_plan"] = plan
                self._fault_plan_sent.add(i)
            w = mp.get_context("spawn").Process(
                target=run_env_worker, args=(env_cfg.to_dict(), address, i), kwargs=kwargs, daemon=True,
            )
        else:
            w = threading.Thread(
                target=run_env_worker, args=(env_cfg, address, i), kwargs=dict(kwargs, stop_event=stop),
                daemon=True, name=f"env-worker-{i}",
            )
        w.start()
        return w

    def _slot_acts(self, hooks=None) -> SlotActs:
        """The server slots' act functions, their acting copies and
        generators made here (the main thread): one slot for the single
        server, ``max_replicas`` for a fleet. Slot 0's generator is seeded
        as the overlap loop's collector."""
        fc = fleet_config(self.config.session_config.topology)
        n = max(int(fc.get("max_replicas", 4)), 1) if fc is not None else 1
        return SlotActs(lambda actor, st, gen: self._make_act_fn(actor, st, gen, hooks), self._act_slot, n)

    def _act_slot(self, i: int):
        seed = derive_seed(self.seed, 1) if i == 0 else derive_seed(self.seed, 1, i)
        return self.learner.acting_copy(), torch.Generator(device=self.device).manual_seed(seed)

    def _start_data_plane(self, acts: SlotActs, stop, first_chunk_timeout: float) -> _DataPlane:
        """Start the inference server (or the fleet, under
        ``topology.inference_fleet``) and the env workers; a
        :class:`_DataPlane` owns their supervision, chunk waits and
        teardown."""
        topo = self.config.session_config.topology
        common = dict(
            unroll_length=self.algo.horizon,
            max_wait_ms=5.0,
            transport="pickle" if self.worker_transport == "pickle" else "auto",
            # nonfinite obs payloads (a corrupt slab slot) are sanitized and
            # counted rather than poisoning the whole micro-batch
            sanitize_obs=bool(topo.get("sanitize_obs", True)),
            trace_id=self._trace_id,
            # every replica pushes its own row to the run's ops plane
            ops_address=self._ops_address,
            span_sink=self._span_sink,
            trace_sample_n=self._trace_sample_n,
            lineage=self._lineage,
        )
        fc = fleet_config(topo)
        if fc is not None:
            # the serving tier: session-affinity routing, per-replica
            # coalescing budgets, in-place respawns, autoscaling
            server = InferenceFleet(
                acts,
                num_workers=self.num_workers,
                replicas=int(fc.get("replicas", 1)),
                min_replicas=int(fc.get("min_replicas", 1)),
                max_replicas=int(fc.get("max_replicas", 4)),
                autoscale=bool(fc.get("autoscale", False)),
                scale_up_serve_ms=float(fc.get("scale_up_serve_ms", 40.0)),
                scale_down_serve_ms=float(fc.get("scale_down_serve_ms", 5.0)),
                scale_cooldown_s=float(fc.get("scale_cooldown_s", 30.0)),
                respawn_backoff_s=float(fc.get("respawn_backoff_s", 0.5)),
                respawn_backoff_cap_s=float(fc.get("respawn_backoff_cap_s", 30.0)),
                **common,
            )
        else:
            server = InferenceServer(
                act_fn=acts.for_slot(0),
                # coalesce all workers into one forward per lockstep round;
                # auto_tune keeps this true as the fleet shrinks and regrows
                # and scales the coalescing wait to the serve-latency EWMA
                min_batch=self.num_workers,
                auto_tune=True,
                **common,
            )
        try:
            env_cfg = training_env_config(self.config.env_config)
            workers = [self._spawn_one(i, env_cfg, server.address_for(i), stop) for i in range(self.num_workers)]
        except BaseException:
            server.close()  # a failed spawn must not leak the socket and serve thread
            raise
        return _DataPlane(
            self, server, workers, env_cfg, stop, first_chunk_timeout,
            respawn_backoff_s=float(topo.get("respawn_backoff_s", 0.5)),
            respawn_backoff_cap_s=float(topo.get("respawn_backoff_cap_s", 30.0)),
        )

    def _make_act_fn(self, actor, state, generator: torch.Generator, hooks=None):
        """The server's act function over ``state`` (a snapshot: the
        learns are out of place). The reference pads each micro-batch to a
        power of two only to bound XLA compiles; the port compiles nothing
        and acts on the ``n`` rows it has. With ``hooks``, the act goes
        through its cost counting as the 'act' program with no phase (it
        serves on its own thread: recorded for diag, kept out of the
        gauges)."""
        device = self.device
        act = actor.act
        if hooks is not None:
            act = functools.partial(hooks.count_program, "act", act, phase=None)

        @torch.no_grad()
        def act_fn(obs_np: np.ndarray):
            obs = torch.from_numpy(np.ascontiguousarray(obs_np)).to(device, non_blocking=True)
            action, info = act(state, obs, TRAINING, generator)
            return read_back(action, info)

        return act_fn

    def _stage(self, chunk: dict, tracer):
        """One chunk to the learner's device. The acting versions, the
        lineage stamps and the adopted exemplar stay on the host (the
        staleness and provenance decisions need them before any device
        work)."""
        versions = chunk.pop("param_version")
        lineage = chunk.pop("lineage", None)
        exemplar = chunk.pop("_exemplar", None)
        n_steps = int(chunk["reward"].shape[0] * chunk["reward"].shape[1])
        with tracer.span("h2d-transfer"):
            batch = to_device(chunk, self.device)
        return batch, versions, n_steps, lineage, exemplar

    def run(
        self,
        max_env_steps: int | None = None,
        on_metrics: Callable[[int, dict], object] | None = None,
    ):
        """Train until ``max_env_steps`` (default: session total_env_steps).
        Returns (final_state, last_metrics)."""
        cfg = self.config.session_config
        total = max_env_steps or cfg.total_env_steps
        state = self.learner.init(torch.Generator().manual_seed(self.seed))
        faults.configure_from(cfg)  # install (or reset) the run's fault plan
        hooks = SessionHooks(self.config, self.learner)
        plane = None
        prefetch = None
        xplane = None
        relay_thread = None
        gateway = None
        stop = threading.Event()
        try:
            state, iteration, env_steps = hooks.restore(state)
            hooks.begin_run(iteration, env_steps)
            if self.tune_decision.mode != "off":
                hooks.tune_event(**self.tune_decision.telemetry())
            self._trace_id = hooks.trace_id
            self._ops_address = hooks.ops.address
            self._span_sink = hooks.tracer
            self._trace_sample_n = hooks.trace_sample_n
            self._lineage = hooks.lineage_enabled
            # the server threads' own modules and generators, made here
            # before any starts
            slots = self._slot_acts(hooks)
            fleet = fleet_config(cfg.topology) is not None

            def acts(st):
                """The act function(s) over ``st`` that set_act_fn takes."""
                return slots.at(st) if fleet else slots.at(st).for_slot(0)

            # the first chunk waits out a full unroll of round trips and the
            # first forwards; workers keep their own per-step liveness budget
            plane = self._start_data_plane(slots.at(state), stop, first_chunk_timeout=600.0)
            server = self._server = plane.server
            self._workers = plane.workers  # exposed for tests and fault injection
            gateway = self._start_gateway(server, hooks)
            next_chunk = plane.next_chunk
            if self.experience_plane_enabled:
                xplane, relay_thread, next_chunk = self._start_relay(plane, stop, hooks)
            self._bind_actuators(hooks, plane, gateway, xplane)
            prefetch = Prefetcher(lambda: self._stage(next_chunk(), hooks.tracer), name="seed-stage")

            dropped_stale = 0
            discarded_steps = 0
            # the oldest acting version a chunk may carry: a rollback raises
            # it to the version it re-arms, so chunks any part of which a
            # poisoned policy acted (queued, or in flight) are dropped
            acting_floor = 0
            dp_event_emitted = False
            learn_ms: deque = deque(maxlen=256)  # learn-hop samples
            lineage_reducer = LineageReducer()

            def data_plane_extras() -> dict:
                """The drop, eviction and episode accounting, for every
                metrics row and the run-end reconciliation alike."""
                return {
                    "staleness/dropped_chunks": float(dropped_stale),
                    "staleness/steps_discarded": float(discarded_steps),
                    "workers/respawns": float(plane.respawns),
                    "workers/respawn_backoff_s": float(plane.respawn_backoff_s),
                    "server/chunk_age_s": float(plane.last_chunk_age_s),
                    **server.queue_stats(),
                    **(server.episode_stats() or {}),
                }

            def data_plane_event():
                hooks.data_plane_event(
                    transport=self.worker_transport, pipeline=self.pipeline_workers,
                    workers=self.num_workers, **server.transport_stats(),
                )

            # the SEED collect stage is always overlapped: workers stream
            # chunks into the server queue whatever the engine knob says
            stages = (
                StageSpec("collect", donate=False, overlap=True),
                StageSpec("learn", donate=False),
            ) + sideband_stages()

            def step(ls):
                nonlocal dropped_stale, discarded_steps, dp_event_emitted
                with hooks.tracer.span("chunk-wait"):
                    batch, versions, n_steps, lineage, exemplar = prefetch.get()
                staleness = server.version - int(versions.min())
                # trainer-side stale DROPS count into env_steps (the trainer
                # chose to discard); server-side queue EVICTIONS are
                # surfaced as server/evicted_* but not folded into the budget
                too_old = self.max_staleness is not None and staleness > self.max_staleness
                if too_old or int(versions.min()) < acting_floor:
                    # acted by a too-old policy, or by one from before the
                    # last rollback: drop, don't train. The steps did happen;
                    # keep supervising (a streak of stale chunks must not
                    # pause respawns or outrun the step budget)
                    dropped_stale += 1
                    discarded_steps += n_steps
                    plane.supervise()
                    return Outcome(metrics=None, hook_key=None, steps=n_steps, skip_boundary=True)
                t_learn0 = time.perf_counter()
                with hooks.tracer.span("learn"):
                    ls.state, metrics = hooks.count_program("learn", self._learn, ls.state, batch, ls.key, phase="learn")
                learn_ms.append((time.perf_counter() - t_learn0) * 1e3)
                if exemplar is not None:
                    # the adopted exemplar's last hop: this learn consumed
                    # the chunk the server stamped
                    hooks.tracer.emit_span(
                        "learn.dispatch",
                        TraceContext(exemplar["exemplar"], hooks.tracer.next_span_id(), exemplar["parent"]),
                        tier="learner", dur_ms=learn_ms[-1], version=int(server.version),
                    )
                with hooks.tracer.span("param-publish"):
                    server.set_act_fn(acts(ls.state))
                plane.supervise()
                if gateway is not None:
                    gateway.supervise()
                if not dp_event_emitted:
                    # the negotiated data-plane shape, once the fleet settled
                    data_plane_event()
                    dp_event_emitted = True
                metrics = dict(
                    metrics,
                    **{"staleness/updates_behind": float(staleness)},
                    **(lineage_reducer.reduce(server.version, versions) if self._lineage else {}),
                    **(hooks.tracer.trace_gauges() if self._trace_sample_n > 0 else {}),
                    **data_plane_extras(),
                    # the relay's gauges as of the last cadence (the wire
                    # poll runs in post_metrics, not every iteration)
                    **(xplane.gauges(poll=False) if xplane is not None else {}),
                    **(gateway.gauges() if gateway is not None else {}),
                )

                def post_metrics(m_row):
                    # the hop percentiles ride the metrics cadence (host-side
                    # deques only, no device work)
                    hooks.tracer.event("hops", **hop_event(server, plane, learn_ms, gateway))
                    if fleet:
                        # one scale decision a cadence (cooldown-bounded,
                        # from the serve-latency EWMA) and the per-replica
                        # snapshot
                        server.maybe_autoscale()
                        hooks.serving_event(**server.tier_event())
                    if gateway is not None:
                        hooks.gateway_event(**gateway.event())
                    if xplane is not None:
                        xplane._poll_stats()
                        hooks.experience_event(**xplane.telemetry_event())

                return Outcome(
                    metrics=metrics, hook_key=derive_seed(self.seed, ls.extras["nonce"], ls.iteration + 1),
                    steps=n_steps, post_metrics=post_metrics,
                )

            def apply_fault(ls, f):
                ls.state = faults.apply_trainer_fault(f, ls.state)

            def on_rollback(ls):
                nonlocal acting_floor
                rb = hooks.recovery.rollback(ls.state, fresh=self._fresh_init)
                ls.state, ls.iteration, ls.env_steps = rb.state, rb.iteration, rb.env_steps
                ls.extras["nonce"] = rb.nonce
                ls.key = torch.Generator(device=self.device).manual_seed(derive_seed(self.seed, rb.nonce))
                # the live act function acts on the poisoned state: re-arm
                # it from the restored one now, and drop what the versions
                # before this one acted
                server.set_act_fn(acts(ls.state))
                acting_floor = server.version

            engine = LoopEngine(
                hooks, total, step, stages, EngineConfig.from_session(cfg),
                on_metrics=on_metrics, apply_fault=apply_fault, on_rollback=on_rollback,
            )
            ls = engine.run(LoopState(
                state=state, key=torch.Generator(device=self.device).manual_seed(self.seed),
                iteration=iteration, env_steps=env_steps, extras={"nonce": 0},
            ))
            state, iteration, env_steps = ls.state, ls.iteration, ls.env_steps
            # the drop path spends budget without a metrics-cadence fire:
            # reconcile the trailing row when it trails
            if hooks.last_metrics.get("time/env_steps") != env_steps:
                hooks.final_metrics(env_steps, data_plane_extras())
            if dp_event_emitted:
                data_plane_event()  # the settled end-of-run gauges
            hooks.final_checkpoint(iteration, env_steps, state)
            return state, hooks.last_metrics
        finally:
            stop.set()
            if prefetch is not None:
                prefetch.close()
            if xplane is not None:
                self._close_relay(xplane, relay_thread, hooks)
            if gateway is not None:
                # sessions end with the run; before the fleet, so the gateway
                # never serves into closed replicas
                gateway.close()
                try:
                    os.unlink(os.path.join(cfg.folder, "gateway.json"))
                except OSError:
                    pass  # never written, or already gone
            if plane is not None:
                plane.close()
            hooks.close()

    def _start_gateway(self, server, hooks):
        """The session gateway in front of the fleet, under
        ``topology.gateway.enabled`` (None otherwise, and for a single
        server, which has no version-aware ``serve_act``), and its
        discovery file ``<folder>/gateway.json``: written to a temporary
        name and renamed, since tenants poll it."""
        gw_cfg = self.config.session_config.topology.get("gateway", None)
        if gw_cfg is None or not bool(gw_cfg.get("enabled", False)) or not hasattr(server, "serve_act"):
            return None
        from surreal_tpu_torch.gateway import GatewayServer

        quotas = gw_cfg.get("tenant_quotas", None)
        gateway = GatewayServer(
            server,
            bind=gw_cfg.get("bind", None),
            max_sessions=int(gw_cfg.get("max_sessions", 256)),
            lease_s=float(gw_cfg.get("lease_s", 30.0)),
            tenant_quotas=quotas.to_dict() if hasattr(quotas, "to_dict") else quotas,
            act_cache=int(gw_cfg.get("act_cache", 256)),
            pin_versions=bool(gw_cfg.get("pin_versions", True)),
            # the hooks' ParameterFanout: a session's pin also holds the
            # pinned version's full frame publisher-side
            fanout=hooks.fanout,
            trace_id=hooks.trace_id,
            respawn_backoff_s=float(gw_cfg.get("respawn_backoff_s", 0.5)),
            respawn_backoff_cap_s=float(gw_cfg.get("respawn_backoff_cap_s", 30.0)),
            ops_address=hooks.ops.address,
            span_sink=self._span_sink,
            trace_sample_n=self._trace_sample_n,
        )
        self._gateway = gateway  # exposed for tests
        hooks.log.info("session gateway live at %s", gateway.address)
        path = os.path.join(self.config.session_config.folder, "gateway.json")
        with open(path + ".tmp", "w") as f:
            json.dump({"address": gateway.address, "lease_s": float(gw_cfg.get("lease_s", 30.0))}, f)
        os.replace(path + ".tmp", path)
        return gateway

    def _start_relay(self, plane: _DataPlane, stop, hooks):
        """The experience plane's FIFO arm and its relay thread, which ships
        every chunk the server assembles through the ExperienceSender.
        Returns (the plane, the thread, the staging thread's chunk source:
        a pop from the shards that supervises both planes while it waits,
        as ``_DataPlane.next_chunk`` does, and raises the relay's death)."""
        from surreal_tpu_torch.experience import ExperiencePlane

        xplane = ExperiencePlane(
            kind="fifo", cfg=self.config.session_config.topology.get("experience_plane", None),
            trace_id=hooks.trace_id, ops_address=hooks.ops.address,
        )
        server = plane.server
        relay_error: list[Exception] = []

        def relay_chunks():
            while not stop.is_set():
                try:
                    chunk = server.chunks.get(timeout=0.5)
                except queue.Empty:
                    continue
                chunk = dict(chunk)
                chunk.pop("_t_ready", None)
                # chunk metadata, not a wire column: an adopted exemplar
                # ends its tree at the relay hop (the lineage columns still
                # cross the wire as spec fields)
                ex = chunk.pop("_exemplar", None)
                if ex is not None and self._span_sink is not None:
                    self._span_sink.emit_span(
                        "xplane.relay",
                        TraceContext(ex["exemplar"], self._span_sink.next_span_id(), ex["parent"]),
                        tier="experience",
                    )
                try:
                    xplane.sender.send_chunk(chunk)
                except Exception as e:  # raised on the main thread by the pop below
                    relay_error.append(e)
                    return

        relay_thread = threading.Thread(target=relay_chunks, daemon=True, name="xp-relay")
        relay_thread.start()

        def next_chunk() -> dict:
            deadline = time.monotonic() + plane._timeout
            plane._timeout = plane.steady_timeout
            while True:
                if stop.is_set():
                    raise TimeoutError("data plane stopped") from None
                if relay_error:
                    raise RuntimeError("experience-plane relay thread died") from relay_error[0]
                got = xplane.sampler.pop_chunk(timeout_s=2.0)
                if got is not None:
                    return got[0]
                plane.supervise()
                xplane.supervise()
                if time.monotonic() >= deadline:
                    raise TimeoutError("no experience chunks arriving through the experience plane") from None

        return xplane, relay_thread, next_chunk

    def _bind_actuators(self, hooks, plane: _DataPlane, gateway, xplane) -> None:
        """Hand the remediation engine its actuators once every tier
        exists: the fleet's scale-up, the gateway's admission, each tier's
        supervise as its restart, and a downshift of the live algo config
        (the batch halved at 64 and up, 'full' precision to 'mixed'; the
        reference's overrides path, effective at the next learner build),
        whose prior values the restore puts back."""
        server = plane.server

        def learner_downshift():
            prior = {}
            b = int(self.algo.get("batch_size", 0) or 0)
            if b >= 64:
                prior["batch_size"] = b
                self.algo["batch_size"] = b // 2
            if self.algo.get("precision") == "full":
                prior["precision"] = "full"
                self.algo["precision"] = "mixed"
            return prior or None

        def learner_restore(prior):
            for k, v in (prior or {}).items():
                self.algo[k] = v

        restart = {
            "workers": plane.supervise,
            "fleet": server.supervise if isinstance(server, InferenceFleet) else None,
            "gateway": gateway.supervise if gateway is not None else None,
            "experience": xplane.supervise if xplane is not None else None,
        }
        hooks.bind_remediation_actuators(
            fleet=server if isinstance(server, InferenceFleet) else None,
            admission=gateway.admission if gateway is not None else None,
            restart={k: v for k, v in restart.items() if v is not None},
            learner_downshift=learner_downshift,
            learner_restore=learner_restore,
        )

    def _close_relay(self, xplane, relay_thread, hooks) -> None:
        """Quiesce the relay (the run's stop is set) so the close
        accounting reads a settled ledger, record it (``quiesced`` says
        whether the relay had stopped), then stop and close the plane."""
        relay_thread.join(timeout=5)
        try:
            hooks.tracer.event("experience_close", quiesced=float(not relay_thread.is_alive()), **xplane.accounting())
        except Exception:
            hooks.log.warning("experience_close accounting failed", exc_info=True)
        # unblock a relay wedged in a bounded sender wait, and JOIN before
        # close() touches the sockets it uses
        xplane._stop.set()
        relay_thread.join(timeout=5)
        xplane.close()

    def _fresh_init(self, nonce: int):
        """The divergence guard's fallback when no finite checkpoint exists:
        an init keyed by the rollback count."""
        return self.learner.init(torch.Generator().manual_seed(derive_seed(self.seed, nonce)))


def read_back(action: torch.Tensor, info: dict) -> tuple[np.ndarray, dict]:
    """``action`` and ``info``'s tensors as numpy arrays, read from the
    device in ONE copy: every leaf's bytes side by side in one uint8
    [n, bytes] tensor."""
    leaves = [action, *info.values()]
    n = action.shape[0]
    flat = torch.cat([x.contiguous().reshape(n, -1).view(torch.uint8) for x in leaves], dim=1).cpu().numpy()
    out, off = [], 0
    for x in leaves:
        dtype = np.dtype(str(x.dtype).removeprefix("torch."))
        width = int(np.prod(x.shape[1:], dtype=np.int64)) * dtype.itemsize
        out.append(flat[:, off:off + width].copy().view(dtype).reshape(tuple(x.shape)))
        off += width
    return out[0], dict(zip(info, out[1:]))
