"""Divergence guard and rollback, the port of
``surreal_tpu/launch/recovery.py`` (``TrainingDiverged``,
``RollbackResult``, ``RecoveryManager``).

The learners' ``health/*`` metrics reach the host at the metrics
cadence. When a synced window shows ``health/nonfinite > 0`` (or
``health/grad_norm`` above ``recovery.grad_norm_limit``), ``SessionHooks``
skips the window's checkpoint and, in mode 'rollback', sets ``pending``;
the driver then calls :meth:`RecoveryManager.rollback`, which restores the
newest checkpoint whose state is finite (a fresh init keyed by the
rollback count when there is none), writes the backed-off LR scale
``max(min_lr_scale, lr_backoff ** nonce)`` into the restored optimizer
states, and hands back the nonce the driver re-seeds its generator and
env carry with. After ``max_rollbacks`` rollbacks without
``heal_after_windows`` healthy windows between them the run raises
:class:`TrainingDiverged`. Mode 'warn' logs and skips poisoned saves but
never rolls back; 'off' does nothing.

Config: ``session_config.recovery`` (``interrupt``, ``on_divergence``,
``max_rollbacks``, ``lr_backoff``, ``min_lr_scale``, ``grad_norm_limit``,
``heal_after_windows``). Every trip, rollback, heal and give-up is a
``recovery`` telemetry event.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from surreal_tpu_torch.learners.base import set_recovery_lr_scale
from surreal_tpu_torch.utils.tree import tensor_leaves


class TrainingDiverged(RuntimeError):
    """The divergence guard exhausted its rollback budget, or had nothing
    to roll back to."""


class RollbackResult(NamedTuple):
    state: Any
    iteration: int
    env_steps: int
    extra: Any | None     # restored auxiliary tree (replay), when asked for
    nonce: int            # rollback count: drivers re-seed with it
    lr_scale: float


def _state_is_finite(state: Any) -> bool:
    """NaN or inf anywhere in the floating leaves? Each leaf is reduced on
    its device into one flag (isfinite of its sum: inf and NaN propagate
    through it), and the flags are read back once."""
    flags = [torch.isfinite(x.sum()) for x in tensor_leaves(state) if x.is_floating_point()]
    if not flags:
        return True
    return bool(torch.stack(flags).all())


class RecoveryManager:
    """One per ``SessionHooks``: the hooks call :meth:`check` on every
    synced metrics window; the driver, which owns the loop state, calls
    :meth:`rollback` when it sees ``pending``."""

    def __init__(self, config, ckpt, tracer, log):
        rc = config.session_config.get("recovery", None)
        get = rc.get if rc is not None else (lambda k, d=None: d)
        self.mode = get("on_divergence", "rollback")
        if self.mode not in ("rollback", "warn", "off"):
            raise ValueError(f"recovery.on_divergence {self.mode!r} not in rollback|warn|off")
        self.max_rollbacks = int(get("max_rollbacks", 3))
        self.lr_backoff = float(get("lr_backoff", 0.5))
        self.min_lr_scale = float(get("min_lr_scale", 0.05))
        self.heal_after_windows = int(get("heal_after_windows", 20))
        limit = get("grad_norm_limit", None)
        self.grad_norm_limit = None if limit is None else float(limit)
        self.rollbacks = 0
        self.pending: str | None = None   # trip reason awaiting the driver
        # what the most recent synced window showed (None = healthy)
        self.last_window_tripped: str | None = None
        self._healthy_streak = 0
        self._trip_iteration: int | None = None
        self._ckpt = ckpt
        self._tracer = tracer
        self._log = log

    def disable_rollback(self, reason: str) -> None:
        """Downgrade 'rollback' to 'warn'."""
        if self.mode == "rollback":
            self.mode = "warn"
            self._log.info("divergence rollback disabled: %s", reason)

    # -- detection (SessionHooks, at the metrics cadence) --------------------
    def check(self, metrics, iteration: int, env_steps: int) -> str | None:
        """Inspect one synced metrics window; the trip reason (and
        ``pending`` in 'rollback' mode) or None."""
        if self.mode == "off" or not metrics:
            return None
        reason = None
        if metrics.get("health/nonfinite", 0.0) > 0.0:
            reason = "nonfinite"
        elif self.grad_norm_limit is not None and metrics.get("health/grad_norm", 0.0) > self.grad_norm_limit:
            reason = "grad_norm"
        self.last_window_tripped = reason
        if reason is None:
            # sustained healthy windows clear the rollback streak; the
            # backed-off LR scale stays until the next rollback
            self._healthy_streak += 1
            if self.rollbacks and self._healthy_streak >= self.heal_after_windows:
                self._log.info(
                    "divergence guard healed: %d healthy windows since the last rollback — "
                    "clearing the rollback streak (%d)", self._healthy_streak, self.rollbacks,
                )
                self._tracer.event(
                    "recovery", kind="healed", rollbacks_cleared=self.rollbacks,
                    healthy_windows=self._healthy_streak,
                )
                self.rollbacks = 0
            return None
        self._healthy_streak = 0
        self._trip_iteration = iteration
        self._log.warning(
            "divergence guard tripped at iteration %d (%s: nonfinite=%s grad_norm=%s) — mode=%s",
            iteration, reason, metrics.get("health/nonfinite"), metrics.get("health/grad_norm"), self.mode,
        )
        self._tracer.event(
            "recovery", kind="tripped", reason=reason, mode=self.mode, iteration=int(iteration),
            env_steps=int(env_steps), grad_norm=metrics.get("health/grad_norm"),
        )
        if self.mode == "rollback":
            self.pending = reason
        return reason

    # -- rollback (the driver) -----------------------------------------------
    def rollback(self, template_state: Any, *, fresh=None, extra_template: Any | None = None) -> RollbackResult:
        """Restore the newest finite checkpoint and clear ``pending``.

        ``template_state`` gives the structure, dtypes and devices to
        restore into (the driver's current, poisoned state will do).
        ``fresh(nonce)`` builds a new state when no finite checkpoint
        exists; the run then restarts at iteration 0. ``extra_template``
        asks for the step-aligned extra tree (the replay) of the same step.
        Raises :class:`TrainingDiverged` past ``max_rollbacks`` or when
        there is nothing to restore."""
        reason, self.pending = self.pending or "manual", None
        self.last_window_tripped = None
        self.rollbacks += 1
        nonce = self.rollbacks
        if self.rollbacks > self.max_rollbacks:
            self._tracer.event("recovery", kind="giveup", reason=reason, rollbacks=self.rollbacks)
            raise TrainingDiverged(
                f"divergence guard tripped {self.rollbacks} times "
                f"(recovery.max_rollbacks={self.max_rollbacks}); the last-good checkpoint "
                "re-diverges even with LR backoff — inspect the health/* metrics"
            )
        restored = self.restore_newest_finite(template_state)
        extra = None
        if restored is not None:
            state, meta, step = restored
            iteration, env_steps = int(meta["iteration"]), int(meta["env_steps"])
            source = f"checkpoint step {step}"
            if extra_template is not None and self._ckpt is not None:
                extra = self._ckpt.restore_extra(extra_template, step=step)
        elif fresh is not None:
            state, iteration, env_steps = fresh(nonce), 0, 0
            source = "fresh init (no finite checkpoint existed)"
        else:
            self._tracer.event("recovery", kind="giveup", reason=reason)
            raise TrainingDiverged(
                "divergence guard tripped with no finite checkpoint to roll back to and no fresh-init fallback"
            )
        lr_scale = max(self.min_lr_scale, self.lr_backoff ** nonce)
        state = set_recovery_lr_scale(state, lr_scale)
        self._log.warning(
            "rollback #%d (%s): resumed from %s at iteration %d (%d env steps), lr scale %.3g — "
            "offending batch re-seeded", nonce, reason, source, iteration, env_steps, lr_scale,
        )
        self._tracer.event(
            "recovery", kind="rollback", reason=reason, nonce=nonce, from_iteration=self._trip_iteration,
            to_iteration=iteration, env_steps=env_steps, lr_scale=lr_scale, source=source,
            extra_restored=extra is not None,
        )
        return RollbackResult(state, iteration, env_steps, extra, nonce, lr_scale)

    def restore_newest_finite(self, template_state):
        """(state, meta, step) of the newest checkpoint whose state is
        finite, or None; the walk of ``CheckpointManager.restore`` with a
        finiteness check. Used by rollback and by auto-resume."""
        if self._ckpt is None:
            return None
        restored = self._ckpt.restore(template_state, validate=_state_is_finite)
        if restored is None:
            return None
        state, meta = restored
        return state, meta, int(meta["iteration"])
