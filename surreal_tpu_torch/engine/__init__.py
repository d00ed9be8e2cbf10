"""The loop runtime, the port of ``surreal_tpu/engine/``: drivers declare
their stages (``StageSpec``) and hand ``LoopEngine`` a step closure; the
engine runs the iteration skeleton and the ``SessionHooks`` boundary,
inline or pipelined (``session_config.engine.pipeline_sidebands``)."""

from surreal_tpu_torch.engine.core import LoopEngine, LoopState, Outcome
from surreal_tpu_torch.engine.stages import EngineConfig, StageSpec, overlap_collect, sideband_stages

__all__ = [
    "EngineConfig",
    "LoopEngine",
    "LoopState",
    "Outcome",
    "StageSpec",
    "overlap_collect",
    "sideband_stages",
]
