"""The loop engine, the port of ``surreal_tpu/engine/core.py``
(``LoopState``, ``Outcome``, ``LoopEngine``).

``LoopEngine.run`` owns the ``while env_steps < total`` skeleton: the
``trainer.iteration`` fault site, the driver's step closure, the counter
bumps, the ``SessionHooks`` boundary (metrics, eval, checkpoint, the
divergence check), the rollback dispatch and the stop decision. With
``session_config.engine.pipeline_sidebands`` off (the default) the
boundary runs inline. With it on, the boundary goes to a one-thread
staging executor and overlaps the next iteration:

- a stage that updates tensors in place (``StageSpec.donate``) makes the
  engine clone every tensor of the state the boundary reads, on the
  current stream, before the next step is issued (the reference's
  ``jnp.copy`` pin);
- stop and rollback decisions arrive at most one iteration late; a
  boundary still running ``stage_timeout_s`` after the next one is due
  makes the engine skip boundaries (counted in
  ``engine/skipped_boundaries``) until it drains;
- the interrupt latch is read inline every iteration in both modes, so a
  SIGTERM stops at an iteration boundary with the emergency checkpoint
  written by the driver's epilogue.
"""

from __future__ import annotations

import concurrent.futures
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable

import torch

from surreal_tpu_torch.engine.stages import StageSpec
from surreal_tpu_torch.session.telemetry import latency_percentiles
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.tree import tree_map


@dataclass
class LoopState:
    """The loop-carried record a driver's step closure updates. ``key`` is
    the driver's random source (a ``torch.Generator`` in the port)."""

    state: Any
    key: Any
    iteration: int
    env_steps: int
    extras: dict = field(default_factory=dict)


@dataclass
class Outcome:
    """What one driver step hands the boundary.

    ``metrics`` is a dict of device scalars or a zero-arg callable giving
    one; it is read to the host only when the metrics cadence fires.
    ``state_for_hooks`` defaults to ``ls.state``. ``hook_key`` seeds the
    boundary's own draws (eval). ``steps`` is the env-step advance.
    ``skip_boundary``: count the steps, run no boundary and count no
    iteration. ``post_metrics(m_row)`` runs when the metrics cadence
    fired."""

    metrics: Any
    hook_key: Any
    steps: int
    state_for_hooks: Any = None
    skip_boundary: bool = False
    post_metrics: Callable[[dict], None] | None = None


def _clone_tensors(state):
    return tree_map(lambda x: x.clone() if isinstance(x, torch.Tensor) else x, state)


class LoopEngine:
    """Iteration engine over declared stages (stages.py)."""

    def __init__(
        self,
        hooks,
        total: int,
        step: Callable[[LoopState], Outcome],
        stages,
        config,
        *,
        on_metrics=None,
        apply_fault: Callable[[LoopState, dict], None] | None = None,
        on_rollback: Callable[[LoopState], None] | None = None,
        after_step: Callable[[LoopState], None] | None = None,
        agree_stop: Callable[[int, bool], bool] | None = None,
        fire_faults: bool = True,
    ):
        stages = tuple(stages)
        if not stages:
            raise ValueError("LoopEngine needs at least one declared stage")
        for s in stages:
            if not isinstance(s, StageSpec):
                raise TypeError(f"stage {s!r} is not a StageSpec")
        self.hooks = hooks
        self.total = int(total)
        self.step = step
        self.stages = stages
        self.config = config
        self.on_metrics = on_metrics
        self.apply_fault = apply_fault
        self.on_rollback = on_rollback
        self.after_step = after_step
        self.agree_stop = agree_stop
        self.fire_faults = bool(fire_faults)
        self.donating = any(s.donate for s in stages)
        self.pipelined = (
            bool(config.pipeline_sidebands) and any(s.deferrable for s in stages) and hooks is not None
        )
        self._executor = None
        self._pending = None  # (future, iteration) of the deferred boundary
        self._step_ms: deque = deque(maxlen=512)
        self._boundary_ms: deque = deque(maxlen=512)
        self._busy_ms = 0.0  # staging-thread busy time while pipelined
        self._deferred = 0
        self._skipped = 0
        self._kills = 0
        self._t0 = None
        self._warned_wedged = False

    # -- observability --------------------------------------------------------
    def gauge_row(self) -> dict[str, float]:
        """The engine/* gauges merged into every metrics row."""
        b = latency_percentiles(tuple(self._boundary_ms)) or {}
        wall_ms = (time.perf_counter() - self._t0) * 1e3 if self._t0 else 0.0
        return {
            "engine/stage_p50_ms": float(b.get("p50", 0.0)),
            "engine/stage_p99_ms": float(b.get("p99", 0.0)),
            "engine/occupancy": float(self._busy_ms / wall_ms) if wall_ms > 0 else 0.0,
            "engine/queue_depth": 1.0 if self._pending is not None else 0.0,
            "engine/deferred_boundaries": float(self._deferred),
            "engine/skipped_boundaries": float(self._skipped),
            "engine/stage_kills": float(self._kills),
        }

    def _event_fields(self) -> dict:
        return {
            "pipelined": bool(self.pipelined),
            "stages": [s.describe() for s in self.stages],
            "stage_ms": latency_percentiles(tuple(self._boundary_ms)),
            "step_ms": latency_percentiles(tuple(self._step_ms)),
            "occupancy": self.gauge_row()["engine/occupancy"],
            "deferred": self._deferred,
            "skipped": self._skipped,
            "kills": self._kills,
        }

    # -- the boundary ---------------------------------------------------------
    def _wrap_metrics(self, metrics):
        def build():
            base = metrics() if callable(metrics) else metrics
            row = dict(base) if base else {}
            row.update(self.gauge_row())
            return row

        return build

    def _run_boundary(self, iteration, env_steps, state_for_hooks, out):
        """end_iteration, the driver's per-cadence emits and the engine's
        own event; inline, or on the staging thread when pipelined.
        Returns the boundary's stop decision."""
        f = faults.fire("engine.stage")
        if f is not None:
            kind = f.get("kind")
            if kind == "delay_stage":
                faults.sleep_ms(f)
            elif kind == "kill_stage":
                self._kills += 1
                raise faults.FaultInjected(f"engine.stage kill: {f}")
        t0 = time.perf_counter()
        try:
            m_row, stop = self.hooks.end_iteration(
                iteration, env_steps, state_for_hooks, out.hook_key,
                self._wrap_metrics(out.metrics), self.on_metrics,
            )
            if m_row is not None:
                if out.post_metrics is not None:
                    out.post_metrics(m_row)
                self.hooks.tracer.event("engine", **self._event_fields())
            return bool(stop)
        finally:
            dur = (time.perf_counter() - t0) * 1e3
            self._boundary_ms.append(dur)
            if self.pipelined:
                self._busy_ms += dur

    def _collect_pending(self, timeout: float):
        """Await the deferred boundary: (resolved, stop). Unresolved means
        it is still running after ``timeout``; the caller skips this
        iteration's boundary (counted) and tries again next time."""
        fut, it_prev = self._pending
        try:
            stop = fut.result(timeout=timeout)
        except concurrent.futures.TimeoutError:
            if self.hooks is not None and not self._warned_wedged:
                self._warned_wedged = True
                self.hooks.log.warning(
                    "engine: boundary of iteration %d wedged past the %.1fs stage bound — learn continues, "
                    "subsequent boundaries are skipped and counted until it drains", it_prev, timeout,
                )
            return False, False
        except faults.FaultInjected:
            # a killed side-band stage: counted at fire time, surfaced as a
            # drained `fault` event at the next boundary
            self._pending = None
            return True, False
        self._pending = None
        self._warned_wedged = False
        return True, bool(stop)

    def _pin_state(self, ls: LoopState, out: Outcome):
        """The state the boundary reads: a clone, on the current stream,
        when the boundary is deferred and a stage updates tensors in
        place."""
        state = out.state_for_hooks if out.state_for_hooks is not None else ls.state
        if self.pipelined and self.donating and not callable(state):
            state = _clone_tensors(state)
        return state

    def _recovery_pending(self) -> bool:
        return self.hooks is not None and self.hooks.recovery.pending

    def _stop_decision(self, iteration: int, stop: bool) -> bool:
        if self.agree_stop is not None:
            return bool(self.agree_stop(iteration, stop))
        return bool(stop)

    def _flush(self):
        """Drain the deferred boundary at loop exit; one wedged past the
        stage bound is abandoned (counted, logged), never waited on."""
        if self._pending is None:
            return None
        fut, it_prev = self._pending
        try:
            stop = fut.result(timeout=max(self.config.stage_timeout_s, 5.0))
        except concurrent.futures.TimeoutError:
            self._skipped += 1
            if self.hooks is not None:
                self.hooks.log.warning(
                    "engine: abandoning the wedged boundary of iteration %d at loop exit "
                    "(counted in engine/skipped_boundaries)", it_prev,
                )
            return None
        except faults.FaultInjected:
            return None
        finally:
            self._pending = None
        return stop

    # -- the skeleton ---------------------------------------------------------
    def run(self, ls: LoopState) -> LoopState:
        self._t0 = time.perf_counter()
        try:
            while ls.env_steps < self.total:
                if self.fire_faults:
                    f = faults.fire("trainer.iteration")
                    if f is not None and self.apply_fault is not None:
                        self.apply_fault(ls, f)
                t_step = time.perf_counter()
                out = self.step(ls)
                self._step_ms.append((time.perf_counter() - t_step) * 1e3)
                if out.skip_boundary:
                    ls.env_steps += out.steps
                    if self.hooks is not None and self.hooks.interrupted:
                        break
                    continue
                ls.iteration += 1
                ls.env_steps += out.steps
                if self.after_step is not None:
                    self.after_step(ls)
                if not self.pipelined:
                    if self._inline_boundary(ls, out):
                        break
                elif self._pipelined_boundary(ls, out):
                    break
            return ls
        finally:
            self._flush()
            if self._executor is not None:
                self._executor.shutdown(wait=False)

    def _inline_boundary(self, ls: LoopState, out: Outcome) -> bool:
        stop = False
        if self.hooks is not None:
            try:
                stop = self._run_boundary(ls.iteration, ls.env_steps, self._pin_state(ls, out), out)
            except faults.FaultInjected:
                stop = False  # counted at fire time; see _collect_pending
            if self._recovery_pending():
                self.on_rollback(ls)
                return False
        return self._stop_decision(ls.iteration, stop)

    def _pipelined_boundary(self, ls: LoopState, out: Outcome) -> bool:
        # the previous boundary's verdicts first, one iteration late
        if self._pending is not None:
            resolved, stop_prev = self._collect_pending(self.config.stage_timeout_s)
            if not resolved:
                self._skipped += 1
                return bool(self.hooks.interrupted)
            if self._recovery_pending():
                # the current outcome is the poisoned lineage's last
                # iteration: its boundary never runs
                self.on_rollback(ls)
                return False
            if self._stop_decision(ls.iteration, stop_prev):
                return True
        if self._executor is None:
            self._executor = concurrent.futures.ThreadPoolExecutor(max_workers=1, thread_name_prefix="engine-stage")
        state_pinned = self._pin_state(ls, out)
        self._pending = (
            self._executor.submit(self._run_boundary, ls.iteration, ls.env_steps, state_pinned, out),
            ls.iteration,
        )
        self._deferred += 1
        # the interrupt latch is inline in both modes
        return bool(self.hooks.interrupted)
