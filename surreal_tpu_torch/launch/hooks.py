"""Session services shared by the training drivers, the port of
``surreal_tpu/launch/hooks.py`` (``SessionHooks``, ``host_metrics``,
``training_env_config``): metrics writing, periodic checkpoints with
keep-best, periodic eval, restore and auto-resume, the interrupt
sentinel, the divergence guard, live parameter publishing, and the
autotuner's ``tune`` event (:meth:`SessionHooks.tune_event`, which the
trainers call at run start when ``algo.autotune`` is not 'off').

Publishing (``session_config.publish.enabled``): the hooks start a
``ParameterPublisher`` and a ``ParameterServer`` (``distributed/param_service.py``),
write their addresses to ``<folder>/param_server.json`` for the ``actor``
and ``eval --follow`` subcommands, and publish the agent's acting view
every ``publish.every_n_iters`` iterations (never from a window the
divergence guard tripped), under the ``param-publish`` span, with the
``publish/version`` metric. A publish costs one device-to-host copy of
the acting view: the one host sync off the metrics cadence. With
``publish.fanout.enabled`` a ``ParameterFanout`` (``distributed/param_fanout.py``)
starts beside them, advertised under ``fanout`` and ``fanout_ack`` in the
same file, and broadcasts the same view as a versioned frame (``wire``,
``delta``, ``ack_ttl_s``); the view is copied to the host once and feeds
both, so a publish stays one sync. Its ``param/*`` gauges ride the
metrics row.

The serving tier (a SEED fleet) records one ``serving_tier`` event a
metrics row through :meth:`SessionHooks.serving_event`, and the
experience plane one ``experience_plane`` event through
:meth:`SessionHooks.experience_event`; both also land in the ops plane.

The ops plane and its control loop, on by default as in the reference
(``session_config.{ops,slo,watchdog,remediate}.enabled``): an
``OpsAggregator`` (``session/opsplane.py``) whose address the tiers push
to (``hooks.ops.address``), with the learner's own row, the fleet's and
the experience plane's merged views and the fanout's version stored
locally; at the metrics cadence a snapshot, then the ``Watchdog`` sweep,
the ``IncidentEngine`` observe and the ``RemediationEngine`` step, whose
actuators the trainer binds (:meth:`SessionHooks.bind_remediation_actuators`).
Their ``ops/*``, ``slo/*`` and ``remediation/*`` gauges ride the metrics
row. All of it is host arithmetic on Python numbers: the window's one
device read stays the metrics read. Faults and recovery trips feed the
flight recorder and the incidents' evidence.

Restore: ``checkpoint.auto_resume`` (on by default) resumes from the
session's own newest finite checkpoint; ``checkpoint.restore_from`` names
another session folder to warm-start the first run from. As in the
reference, the driver's random source is rebuilt from ``seed`` on every
launch and is not checkpointed, and env carries are not saved: a resumed
run continues from the restored state, iteration and env-step count with
fresh envs, and is not bit-equal to an uninterrupted run.

One device->host read per metrics window: ``end_iteration`` stacks the
window's device scalars and copies them back once, at the metrics
cadence only. Between cadences neither the hooks nor the engine read
anything from the card.

Cost accounting and profiling, as the reference's: the trainers route
their hot programs through :meth:`SessionHooks.count_program` (the first
call is counted, ``session/costs.py``), and the ``perf/*`` gauges ride
the metrics cadence, pure host arithmetic over the window's phases;
``session/profile.py``'s ``ProfileManager`` (the ``session.profiler``
window, the trigger file of the ``profile`` subcommand, the
slow-iteration trigger) ticks at every iteration boundary.

The session options the port does not carry raise ``NotImplementedError``
naming the key (see :func:`check_session_options`). A subsystem the
reference builds by default and the port does not have yet would be
listed in ``UNPORTED_SUBSYSTEMS`` (none is left): ``begin_run`` names
those the config turns on in one ``unported`` telemetry event.
"""

from __future__ import annotations

import os
import time

import torch

from surreal_tpu_torch.launch.recovery import RecoveryManager
from surreal_tpu_torch.session.checkpoint import CheckpointManager, make_checkpoint_manager
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.costs import CostAccountant
from surreal_tpu_torch.session.incidents import IncidentEngine
from surreal_tpu_torch.session.interrupt import InterruptSentinel
from surreal_tpu_torch.session.metrics import get_logger, make_metrics_writer
from surreal_tpu_torch.session.opsplane import OpsAggregator
from surreal_tpu_torch.session.profile import ProfileManager
from surreal_tpu_torch.session.remediate import RemediationEngine
from surreal_tpu_torch.session.telemetry import Tracer
from surreal_tpu_torch.session.tracker import PeriodicTracker
from surreal_tpu_torch.session.watchdog import Watchdog, platform_of
from surreal_tpu_torch.utils import faults

# on-by-default subsystems of the reference's SessionHooks that the port
# does not build yet ({name: {switch, metric_prefixes, event_types}}): the
# config switch that turns each on, and the metric prefixes and telemetry
# event types it would add. Empty: every one is ported.
UNPORTED_SUBSYSTEMS: dict[str, dict] = {}


def _switch_on(cfg, dotted: str) -> bool:
    node = cfg
    for part in dotted.split("."):
        node = node.get(part, None) if node is not None else None
    return bool(node)


def unported_subsystems(session_config) -> list[str]:
    """The unported subsystems ``session_config`` turns on."""
    return [name for name, sub in UNPORTED_SUBSYSTEMS.items() if _switch_on(session_config, sub["switch"])]


def check_session_options(config) -> None:
    """Raise ``NotImplementedError`` naming the key for each session option
    that turns on a subsystem the port does not have (all off by
    default)."""
    cfg = config.session_config

    def refuse(key: str, what: str):
        raise NotImplementedError(f"{key}: {what} is not ported to PyTorch yet")

    if cfg.get("compile_cache_dir", None):
        refuse("session_config.compile_cache_dir", "the persistent compile cache")
    topo = cfg.get("topology", None)
    if topo is not None:
        mesh = topo.get("mesh", None)
        if mesh is not None and (mesh.get("dp", -1) not in (-1, 1) or mesh.get("tp", 1) != 1):
            refuse("session_config.topology.mesh", "a multi-device mesh")
        multihost = topo.get("multihost", None)
        if multihost is not None and multihost.get("coordinator", None):
            refuse("session_config.topology.multihost", "a multi-host topology")


class SessionHooks:
    """One per training run. Driver contract:

        hooks = SessionHooks(config, learner)
        try:
            state, it, steps = hooks.restore(state)    # once, before the loop
            hooks.begin_run(it, steps)
            while ...:
                ...train...
                m, stop = hooks.end_iteration(it, steps, state, key, metrics, on_metrics)
                if stop: break
            hooks.final_checkpoint(it, steps, state)
        finally:
            hooks.close()
    """

    def __init__(self, config, learner, name: str = "train"):
        check_session_options(config)
        self.config = config
        cfg = config.session_config
        os.makedirs(cfg.folder, exist_ok=True)
        self.log = get_logger(name, cfg.folder)
        self.writer = make_metrics_writer(cfg, name=name)
        tel = cfg.get("telemetry", None)
        # causal tracing and lineage, read as the reference reads them:
        # telemetry.trace.sample_n head-samples 1 in N worker steps of the
        # SEED path (0 disables span emission); telemetry.lineage stamps
        # every SEED transition with its provenance (on by default: the
        # lineage/* staleness gauges depend on it)
        trace_cfg = tel.get("trace", None) if tel is not None else None
        self.trace_sample_n = int(trace_cfg.get("sample_n", 64) if trace_cfg is not None else 64)
        self.lineage_enabled = bool(tel.get("lineage", True) if tel is not None else True)
        self.tracer = Tracer(
            cfg.folder,
            enabled=bool(tel.enabled) if tel is not None else True,
            name=name,
            max_log_mb=tel.get("max_log_mb", None) if tel is not None else None,
            trace_keep=int(trace_cfg.get("keep", 8) if trace_cfg is not None else 8),
        )
        # the run-scoped trace id every event carries; spawned env workers
        # and the inference server inherit it
        self.trace_id = self.tracer.trace_id
        # cost accounting (session/costs.py): trainers route their hot
        # programs through count_program; the perf/* gauges ride the
        # metrics cadence in end_iteration. The precision policy stamps
        # every program_cost record.
        device = getattr(learner, "device", None)
        pol = getattr(learner, "policy", None)
        self.costs = CostAccountant(cfg, on_event=self.tracer.event, log=self.log, policy=pol, device=device)
        self.ckpt: CheckpointManager | None = make_checkpoint_manager(cfg, on_event=self.tracer.event)
        self.precision = pol
        self._precision_meta = pol.meta() if pol is not None else None
        self._ckpt_every = PeriodicTracker(max(1, cfg.checkpoint.every_n_iters))
        rec = cfg.get("recovery", None)
        self.interrupt = InterruptSentinel(enabled=bool(rec.get("interrupt", True)) if rec is not None else True)
        self.recovery = RecoveryManager(config, self.ckpt, self.tracer, self.log)
        # the run's ops aggregator: the tiers push to ops.address (process
        # tiers inherit it through their spawn kwargs), the learner
        # thread's tiers through push_local; every flight-recorder dump
        # carries the tracer's newest exemplar spans
        self.ops = OpsAggregator(
            cfg.folder, trace_id=self.trace_id, cfg=cfg.get("ops", None), slo_cfg=cfg.get("slo", None),
            on_event=self.tracer.event,
        )
        self.ops.flightrec.exemplar_source = self.tracer.recent_exemplar_spans
        self._interrupt_logged = False
        # step-aligned extra state (the off-policy trainer's replay, with
        # checkpoint.include_replay): a zero-arg callable -> tree
        self.extra_state_fn = None

        self.evaluator = None
        ev = cfg.eval
        if ev.every_n_iters and ev.every_n_iters > 0 and ev.episodes > 0:
            from surreal_tpu_torch.launch.evaluator import Evaluator

            self.evaluator = Evaluator(config.env_config, ev, learner)
            self._eval_every = PeriodicTracker(ev.every_n_iters)
        if self.ckpt is not None:
            self.ckpt.best_key = "eval/return" if self.evaluator else "episode/return"
        self._publisher = None
        self._param_server = None
        self._fanout = None
        pub = cfg.get("publish", None)
        if pub is not None and pub.enabled:
            self._start_publishing(pub, learner)
        # on-demand profiling (session/profile.py): the profiler window,
        # trigger-file captures and the slow-iteration trigger, all behind
        # one boundary tick
        self.profile = ProfileManager(cfg, cfg.folder, self.tracer, self.log, device=device)
        self._start_control_loop(cfg, device)
        self._unported = unported_subsystems(cfg)
        self._last_eval: dict[str, float] = {}
        self._last_train: dict[str, float] = {}
        self._metrics_every = PeriodicTracker(max(1, cfg.metrics.every_n_iters))
        self._t0 = None
        self._steps0 = 0

    def _start_control_loop(self, cfg, device) -> None:
        """The watchdog and the incident engine (``watchdog.enabled``), and
        the remediation engine riding them (``remediate.enabled``); None
        each when off. The regression detector's rows load only from
        ``watchdog.baseline_dir``."""
        self.watchdog = None
        self.incidents = None
        self.remediate = None
        wd_cfg = cfg.get("watchdog", None)
        if wd_cfg is not None and not wd_cfg.get("enabled", True):
            return
        base_dir = wd_cfg.get("baseline_dir", None) if wd_cfg is not None else None
        platform = platform_of(device if device is not None else "cpu")
        kind = torch.cuda.get_device_name(device) if platform == "gpu" else "cpu"
        count = torch.cuda.device_count() if platform == "gpu" else 1
        self.watchdog = Watchdog(
            cfg=wd_cfg, baseline_rows=Watchdog.load_baseline(base_dir) if base_dir else None,
            platform=platform, geometry=f"{count}x{kind}",
        )
        self.incidents = IncidentEngine(
            folder=cfg.folder, cfg=wd_cfg, on_event=self.tracer.event, profile=self.profile,
            flightrec=self.ops.flightrec, exemplar_source=self.tracer.recent_exemplar_spans, trace_id=self.trace_id,
        )
        rem_cfg = cfg.get("remediate", None)
        if rem_cfg is None or rem_cfg.get("enabled", True):
            self.remediate = RemediationEngine(
                folder=cfg.folder, cfg=rem_cfg, incidents=self.incidents, on_event=self.tracer.event,
                trace_id=self.trace_id,
            )

    def bind_remediation_actuators(self, **surfaces) -> None:
        """Hand the remediation engine its actuators (the fleet, the
        gateway's admission, the restart map, the learner downshift and
        restore) once the trainer has built them; nothing when remediation
        is off. See ``RemediationEngine.bind_actuators``."""
        if self.remediate is not None:
            self.remediate.bind_actuators(**surfaces)

    def _start_publishing(self, pub, learner) -> None:
        """Live parameter publishing: a publisher and a parameter server,
        advertised in ``<folder>/param_server.json`` (written atomically:
        the ``actor`` and ``eval --follow`` processes poll for it)."""
        import json

        from surreal_tpu_torch.agents import make_agent
        from surreal_tpu_torch.distributed.param_service import ParameterPublisher, ParameterServer

        self._pub_agent = make_agent(learner)
        self._publisher = ParameterPublisher()
        # span-tagged fetches land in the telemetry spine as param_fetch events
        self._param_server = ParameterServer(self._publisher.address, bind=pub.bind, on_event=self.tracer.event)
        discovery = {"addresses": self._param_server.addresses, "publisher": self._publisher.address}
        fan = pub.get("fanout", None)
        if fan is not None and fan.get("enabled", False):
            # versioned weight frames over PUB/SUB beside the pair above,
            # whose fetch stays the late joiners' fallback
            from surreal_tpu_torch.distributed.param_fanout import ParameterFanout

            self._fanout = ParameterFanout(
                wire=str(fan.get("wire", "f32")), delta=bool(fan.get("delta", True)),
                ack_ttl_s=float(fan.get("ack_ttl_s", 60.0)),
            )
            discovery["fanout"] = self._fanout.address
            discovery["fanout_ack"] = self._fanout.ack_address
        self._pub_every = PeriodicTracker(max(1, pub.every_n_iters))
        self._discovery_path = os.path.join(self.config.session_config.folder, "param_server.json")
        with open(self._discovery_path + ".tmp", "w") as f:
            json.dump(discovery, f)
        os.replace(self._discovery_path + ".tmp", self._discovery_path)
        self.log.info(
            "parameter server live at %s (publish every %d iters)", self._param_server.addresses, self._pub_every.period
        )

    @property
    def fanout(self):
        """The live ``ParameterFanout`` (None unless
        ``publish.fanout.enabled``): the gateway's publisher-side holds of
        pinned versions need it."""
        return self._fanout

    @property
    def last_metrics(self) -> dict[str, float]:
        """Latest synced train metrics merged with latest eval metrics."""
        return {**self._last_train, **self._last_eval}

    def final_metrics(self, env_steps: int, extras=None) -> None:
        """Refresh the trailing metrics row at run end, for loops that can
        spend env steps without a metrics-cadence fire."""
        m = dict(self._last_train)
        m.update({k: float(v) for k, v in (extras or {}).items()})
        m["time/env_steps"] = env_steps
        m["time/env_steps_per_s"] = (env_steps - self._steps0) / max(time.time() - (self._t0 or time.time()), 1e-9)
        self._last_train = m
        self.writer.write(env_steps, m)
        self.tracer.log_metrics(env_steps, m)

    # -- restore -------------------------------------------------------------
    def restore(self, init_state):
        """-> (state, start_iteration, start_env_steps). Own-folder
        auto-resume takes precedence over ``restore_from``: a warm-started
        job that relaunches continues its own curve."""
        cfg = self.config.session_config.checkpoint
        if cfg.auto_resume and self.ckpt is not None:
            # the precision guard first: a policy mismatch surfaces as the
            # named error, not as a structure error from the walk
            self.ckpt.check_precision(self._precision_meta)
            restored = self.recovery.restore_newest_finite(init_state)
            if restored is not None:
                state, meta, _step = restored
                self.log.info("auto-resumed at iteration %d (%d env steps)", meta["iteration"], meta["env_steps"])
                self._reseed_cadences(int(meta["iteration"]))
                return state, int(meta["iteration"]), int(meta["env_steps"])
        if cfg.restore_from:
            mgr = CheckpointManager(cfg.restore_from, on_event=self.tracer.event)
            mgr.check_precision(self._precision_meta)
            restored = mgr.restore(init_state)
            if restored is None:
                raise FileNotFoundError(f"checkpoint.restore_from={cfg.restore_from!r} has no checkpoint")
            state, meta = restored
            self.log.info(
                "restored from %s at iteration %d (%d env steps)",
                cfg.restore_from, meta["iteration"], meta["env_steps"],
            )
            # keep the foreign counters so schedules continue
            self._reseed_cadences(int(meta["iteration"]))
            return state, int(meta["iteration"]), int(meta["env_steps"])
        return init_state, 0, 0

    def _reseed_cadences(self, iteration: int) -> None:
        self._ckpt_every = PeriodicTracker(self._ckpt_every.period, init_count=iteration)
        if self.evaluator is not None:
            self._eval_every = PeriodicTracker(self._eval_every.period, init_count=iteration)
        if self._publisher is not None:
            self._pub_every = PeriodicTracker(self._pub_every.period, init_count=iteration)

    # -- per-iteration -------------------------------------------------------
    def begin_run(self, iteration: int, env_steps: int) -> None:
        """Start the wall clock and the metrics cadence from the (possibly
        resumed) position; record the precision policy and what is not
        built."""
        self._metrics_every = PeriodicTracker(self._metrics_every.period, init_count=iteration)
        self._t0 = time.time()
        self._steps0 = env_steps
        if self._precision_meta is not None:
            self.tracer.event("precision", **self.precision.telemetry())
            self.log.info(
                "precision policy: %s",
                " ".join(f"{k}={v}" for k, v in sorted(self.precision.telemetry().items())),
            )
            if self.ckpt is not None:
                self.ckpt.save_run_metadata(self._precision_meta)
        if self._unported:
            subs = {name: UNPORTED_SUBSYSTEMS[name] for name in self._unported}
            self.tracer.event(
                "unported", subsystems=self._unported,
                switches=[s["switch"] for s in subs.values()],
                metric_prefixes=sorted({p for s in subs.values() for p in s["metric_prefixes"]}),
                event_types=sorted({e for s in subs.values() for e in s["event_types"]}),
            )
            self.log.warning(
                "not ported to PyTorch yet, so not built although the config turns them on: %s",
                ", ".join(f"{n} ({UNPORTED_SUBSYSTEMS[n]['switch']})" for n in self._unported),
            )

    def end_iteration(self, iteration: int, env_steps: int, state, key, metrics=None, on_metrics=None):
        """Per-iteration side-bands. ``metrics`` is a dict of device
        scalars (or a zero-arg callable giving one), read to the host in
        one copy only when the metrics cadence fires; ``state`` may be a
        zero-arg callable, resolved only when eval or a checkpoint fires;
        ``key`` (an int) seeds eval. Returns (synced metrics or None,
        stop), stop echoing a truthy ``on_metrics(iteration, m)`` or an
        interrupt."""
        state_box = [state]

        def resolve_state():
            if callable(state_box[0]):
                state_box[0] = state_box[0]()
            return state_box[0]

        m = None
        trip_reason = None
        if self._metrics_every.track_increment():
            # the one device->host read of the window: it waits for the
            # issued iterations, so this span is the window's fenced tail
            with self.tracer.span("metrics-sync"):
                raw = metrics() if callable(metrics) else (metrics or {})
                m = host_floats(raw)
            m["time/env_steps"] = env_steps
            m["time/env_steps_per_s"] = (env_steps - self._steps0) / max(
                time.time() - (self._t0 or time.time()), 1e-9
            )
            self._last_train = m
            trip_reason = self.recovery.check(m, iteration, env_steps)
            if trip_reason is not None:
                # freeze the minutes before the trip beside the trip
                trip = {"reason": str(trip_reason), "iteration": int(iteration), "env_steps": int(env_steps)}
                self.ops.record_recovery(trip)
                self.ops.dump("recovery")
                if self.incidents is not None:
                    self.incidents.record_recovery(trip)
        # no state-consuming side-band while the guard is tripped: a
        # poisoned save would be restored by the rollback about to happen
        tripped = (
            trip_reason is not None
            or self.recovery.pending is not None
            or self.recovery.last_window_tripped is not None
        )
        if self._publisher is not None and self._pub_every.track_increment() and not tripped:
            # never publish poisoned params to live actors
            with self.tracer.span("param-publish", emit=True):
                version = self.publish_view(resolve_state())
            # the fanout tier's row: its version against the replicas'
            # held ones is the derived staleness
            self.ops.push_local(
                "param_fanout",
                gauges={"version": float(version), **(self._fanout.gauges() if self._fanout is not None else {})},
            )
            if m is not None:
                m["publish/version"] = float(version)
                if self._fanout is not None:
                    m.update(self._fanout.gauges())
        evaled: dict[str, float] = {}
        if self.evaluator is not None and self._eval_every.track_increment() and not tripped:
            with self.tracer.span("eval", emit=True):
                evaled = self.evaluator.evaluate(resolve_state(), key)
            self._last_eval = evaled
        if m is not None:
            # the window's spans as time/* scalars, after eval so its span
            # lands in this row
            m.update(self.tracer.flush_phases(env_steps))
            # perf/* over the same window: host arithmetic on the flushed
            # phase times and the counted programs, no device read
            m.update(self.costs.gauges(self.tracer.last_window))
            self._ops_sweep(m, iteration, env_steps)
            self._last_train = m
        if m or evaled:
            self.writer.write(env_steps, {**(m or {}), **evaled})
            self.tracer.log_metrics(env_steps, {**(m or {}), **evaled})
        if self.ckpt is not None and self._ckpt_every.track_increment():
            if tripped:
                self.log.warning(
                    "skipping checkpoint at iteration %d: divergence guard tripped this window", iteration
                )
            else:
                with self.tracer.span("checkpoint", emit=True):
                    self.ckpt.save(iteration, resolve_state(), env_steps=env_steps, metrics=self.last_metrics)
                    if self.extra_state_fn is not None:
                        self.ckpt.save_extra(iteration, self.extra_state_fn())
        self.profile.tick(iteration)
        if self._drain_faults():
            self.ops.dump("fault")
        stop = m is not None and on_metrics is not None and bool(on_metrics(iteration, m))
        if self.interrupt.fired:
            # stop at this boundary; the driver's final_checkpoint is the
            # emergency save
            if not self._interrupt_logged:
                self._interrupt_logged = True
                self.log.warning(
                    "interrupt (signal %s) latched: stopping after iteration %d, emergency checkpoint follows",
                    self.interrupt.signum, iteration,
                )
                self.tracer.event(
                    "recovery", kind="interrupt", signum=self.interrupt.signum,
                    iteration=int(iteration), env_steps=int(env_steps),
                )
            stop = True
        return m, stop

    def _ops_sweep(self, m: dict, iteration: int, env_steps: int) -> None:
        """The learner's row, the merged snapshot, then the watchdog sweep,
        the incident observe and the remediation step, their gauges into
        ``m``: dict work on Python numbers, no device read."""
        self.ops.push_local("learner", gauges={k: v for k, v in m.items() if isinstance(v, (int, float))})
        snap = self.ops.snapshot(int(iteration), int(env_steps))
        m.update(self.ops.gauges())
        if self.watchdog is None:
            return
        firings = self.watchdog.evaluate(snap)
        self.incidents.observe(firings, snap)
        m.update(self.watchdog.gauges())
        m.update(self.incidents.gauges())
        if self.remediate is not None:
            self.remediate.step(firings, snap)
            m.update(self.remediate.gauges())

    def _drain_faults(self) -> list[dict]:
        """Faults fired since the last call: ``fault`` events, the flight
        recorder's ring and the incidents' evidence."""
        fired = faults.drain_fired()
        for ev in fired:
            self.tracer.event("fault", **ev)
            self.ops.record_fault(ev)
            if self.incidents is not None:
                self.incidents.record_fault(ev)
        return fired

    def publish_view(self, state) -> int:
        """Publish the agent's acting view of ``state``; returns its
        version. The view's copy to the host is the publish's one sync:
        with the fanout on, it is taken once (``host_tree``) and feeds the
        publisher and the fanout alike."""
        view = self._pub_agent.acting_view(state)
        if self._fanout is not None:
            from surreal_tpu_torch.distributed.module_dict import host_tree

            view = host_tree(view)
        version = self._publisher.publish(view)
        if self._fanout is not None:
            self._fanout.publish(view)
        return version

    def count_program(self, name: str, fn, *args, phase: str | None = None, calls_per_phase: int = 1, **kwargs):
        """``fn(*args, **kwargs)``, its first call under ``name`` counted by
        the cost accountant (one ``program_cost`` event; the port's
        counterpart of the reference's ``record_program_costs``, which
        lowers the program instead of running it). ``phase`` names the
        tracer phase whose window times the program (None: recorded for
        diag, kept out of the gauges); ``calls_per_phase`` how often it runs
        in one span of that phase."""
        return self.costs.count_program(name, fn, *args, phase=phase, calls_per_phase=calls_per_phase, **kwargs)

    def tune_event(self, **info) -> None:
        """Record the autotuner's build-time decision (mode, cache hit or
        miss, the chosen config) as one log line and one ``tune``
        telemetry event, which ``diag`` renders: a session folder answers
        "which program actually trained?" without reading configs."""
        self.log.info("autotune: %s", " ".join(f"{k}={v}" for k, v in sorted(info.items())))
        self.tracer.event("tune", **info)

    def data_plane_event(self, **info) -> None:
        """Record the SEED data plane's negotiated shape (transport mix,
        pipeline occupancy, wire bytes a step) as one log line and one
        ``data_plane`` telemetry event."""
        self.log.info("data plane: %s", " ".join(f"{k}={v}" for k, v in sorted(info.items())))
        self.tracer.event("data_plane", **info)

    def experience_event(self, **info) -> None:
        """Record the experience plane's settled shape (shard transports,
        per-shard fill and ingest, wire bytes a step, sample wait) as one
        ``experience_plane`` telemetry event a metrics row; ``diag``'s
        "Experience plane" section renders the last one, and the ops
        plane's ``experience`` row."""
        self.tracer.event("experience_plane", **info)
        self.ops.push_local("experience", body=info)

    def serving_event(self, **info) -> None:
        """Record the serving tier's per-replica snapshot (liveness,
        budgets, serve latency, scale decisions) as one ``serving_tier``
        telemetry event a metrics row; ``diag``'s "Serving tier" section
        renders the last one. The merged view is also the ops plane's
        ``fleet`` row (each replica pushes its own)."""
        self.tracer.event("serving_tier", **info)
        self.ops.push_local("fleet", body=info)

    def gateway_event(self, **info) -> None:
        """Record the session gateway's tenant-facing snapshot (sessions,
        admission counters, cache hit rate, pinned versions) as one
        ``gateway`` telemetry event a metrics row; ``diag``'s "Gateway"
        section renders the last one (the gateway pushes its own ops row)."""
        self.tracer.event("gateway", **info)

    @property
    def interrupted(self) -> bool:
        """True once the sentinel latched a signal."""
        return self.interrupt.fired

    def final_checkpoint(self, iteration: int, env_steps: int, state) -> None:
        """Leave a resumable checkpoint at run end (on the interrupt path,
        the emergency checkpoint), unless the divergence guard is pending
        or the last synced window tripped."""
        if self.recovery.pending is not None or self.recovery.last_window_tripped:
            self.log.warning(
                "skipping final checkpoint: divergence guard %s (relaunch will resume from the last finite "
                "checkpoint)",
                "pending" if self.recovery.pending else "tripped on the last synced window",
            )
            return
        if self.ckpt is not None and self.ckpt.latest_step() != iteration:
            self.ckpt.save(
                iteration, state() if callable(state) else state,
                env_steps=env_steps, metrics={**self._last_train, **self._last_eval},
            )
            if self.extra_state_fn is not None:
                self.ckpt.save_extra(iteration, self.extra_state_fn())

    def close(self) -> None:
        self.interrupt.close()  # restore the process's previous handlers
        if self.evaluator is not None:
            self.evaluator.close()  # a host evaluator's own env instance
        self._drain_faults()  # faults since the last boundary
        # the actions still verifying, then an open incident, before the
        # receiver stops
        if self.remediate is not None:
            self.remediate.close()
        if self.incidents is not None:
            self.incidents.close()
        self.ops.close()
        self.profile.close()  # stop and record a capture cut short by the end
        if self._param_server is not None:
            self._param_server.close()
            self._param_server = None
            # a dead session must not advertise its ports: an actor would
            # spend its wait on the stale address
            try:
                os.unlink(self._discovery_path)
            except OSError:
                pass
        if self._fanout is not None:
            self._fanout.close()
            self._fanout = None
        if self._publisher is not None:
            self._publisher.close()
            self._publisher = None
        self.writer.close()
        self.tracer.close()
        # detach this session's file log handler, so its fd into
        # <folder>/logs/ does not outlive the session
        for h in list(self.log.handlers):
            if str(getattr(h, "_surreal_id", "")).startswith("file:"):
                self.log.removeHandler(h)
                h.close()


def host_floats(raw: dict) -> dict[str, float]:
    """``raw``'s values as Python floats, its tensors (scalars, on one
    device) stacked and copied back in one read."""
    keys = [k for k, v in raw.items() if isinstance(v, torch.Tensor)]
    values = torch.stack([raw[k].to(torch.float32) for k in keys]).tolist() if keys else []
    read = dict(zip(keys, values))
    return {k: read[k] if k in read else float(v) for k, v in raw.items()}


HOST_METRICS_WINDOW = 20  # rolling episode-return window of the host loops


def host_metrics(metrics, recent_returns, window: int = HOST_METRICS_WINDOW):
    """Deferred metrics of a host-env loop: the learner's scalars plus a
    rolling-mean ``episode/return``; a zero-arg callable for
    ``end_iteration``."""
    import numpy as np

    def build():
        m = dict(metrics)
        if recent_returns:
            m["episode/return"] = float(np.mean(list(recent_returns)[-window:]))
        return m

    return build


def training_env_config(env_config) -> Config:
    """The training env never records video (that is eval's job)."""
    return Config(video=Config(enabled=False)).extend(env_config)
