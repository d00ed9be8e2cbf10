"""Stage declarations and engine config for the loop runtime, a copy of
``surreal_tpu/engine/stages.py`` (``StageSpec``, ``sideband_stages``,
``EngineConfig``, ``overlap_collect``).

A driver hands the engine an ordered tuple of :class:`StageSpec`s:

- ``donate`` (required, keyword-only) records whether the stage updates
  its loop-carried tensors in place (the port's counterpart of the
  reference's buffer donation: the replay ring and the env carry). Any
  such stage makes the engine clone the state before a deferred boundary
  reads it, on the current stream and before the next step is issued.
- ``deferrable`` marks side-band stages the engine may run on its staging
  thread, overlapped with the next iteration.
- ``overlap`` is the collect stage's rollout/learn-overlap bit (host-env
  loops, which the port does not have yet).
"""

from __future__ import annotations

from dataclasses import dataclass, replace


@dataclass(frozen=True)
class StageSpec:
    """One declared stage of a driver's iteration program."""

    name: str
    donate: bool
    deferrable: bool = False
    overlap: bool = False

    def describe(self) -> dict:
        return {
            "name": self.name,
            "donate": bool(self.donate),
            "deferrable": bool(self.deferrable),
            "overlap": bool(self.overlap),
        }


def sideband_stages() -> tuple[StageSpec, ...]:
    """The SessionHooks boundary, declared as stages. Shared by every
    driver so the publish/checkpoint/recover/observe contract cannot
    drift between them: publish/checkpoint/observe are deferrable
    side-bands; recover stays on the synchronous path (the rollback
    decision re-seeds the driver's loop state, which only the main
    thread owns — the engine consumes it with at most one iteration of
    lag when pipelining is on)."""
    return (
        StageSpec("publish", donate=False, deferrable=True),
        StageSpec("checkpoint", donate=False, deferrable=True),
        StageSpec("recover", donate=False, deferrable=False),
        StageSpec("observe", donate=False, deferrable=True),
    )


@dataclass(frozen=True)
class EngineConfig:
    """Engine knobs, read from ``session_config.engine``.

    ``pipeline_sidebands=False`` (the default) keeps every boundary
    inline — bit-identical to the historical hand-threaded loops; tests
    pin the parity per driver. ``stage_timeout_s`` is the wedged-stage
    bound: a deferred boundary that has not completed by the time the
    NEXT boundary is due gets that long before the next boundary is
    skipped (counted in ``engine/skipped_boundaries`` + the `engine`
    telemetry event — never silent)."""

    pipeline_sidebands: bool = False
    stage_timeout_s: float = 30.0
    queue_depth: int = 1

    @classmethod
    def from_session(cls, session_config) -> "EngineConfig":
        eng = session_config.get("engine", None)
        if eng is None:
            return cls()
        get = eng.get if hasattr(eng, "get") else dict(eng).get
        return cls(
            pipeline_sidebands=bool(get("pipeline_sidebands", False)),
            stage_timeout_s=float(get("stage_timeout_s", 30.0)),
            queue_depth=max(1, int(get("queue_depth", 1))),
        )

    def inline(self) -> "EngineConfig":
        """Pin the boundary inline regardless of config — the multihost
        drivers use this (a deferred, rank-local stop/rollback decision
        would race the collective schedule's agreed stop), and the
        off-policy driver pins replay-inclusive checkpoints (the saved
        buffer closure must read the exact iteration's ring)."""
        if not self.pipeline_sidebands:
            return self
        return replace(self, pipeline_sidebands=False)


def overlap_collect(session_config) -> bool:
    """Resolve the collect stage's overlap bit: ``engine.overlap_collect``
    when set, else the historical ``topology.overlap_rollouts`` (default
    True) — one resolution point instead of a per-driver fork."""
    eng = session_config.get("engine", None)
    if eng is not None:
        get = eng.get if hasattr(eng, "get") else dict(eng).get
        v = get("overlap_collect", None)
        if v is not None:
            return bool(v)
    return bool(session_config.topology.get("overlap_rollouts", True))
