"""Randomized chaos campaigns, the port of ``surreal_tpu/chaos/``: seeded
multi-site fault schedules drawn over the ``utils/faults.py`` registry,
run-wide invariant oracles evaluated from a finished run's telemetry and
artifacts, and a greedy schedule shrinker that reduces any failing
schedule to minimal form.

- :mod:`surreal_tpu_torch.chaos.schedule`: the deterministic generator
- :mod:`surreal_tpu_torch.chaos.invariants`: the post-run oracles
- :mod:`surreal_tpu_torch.chaos.campaign`: N seeded real runs + shrinking

CLI: ``python -m surreal_tpu_torch chaos <algo> [env] --seeds N`` (on
the card).
"""

from surreal_tpu_torch.chaos.schedule import PROFILES, generate_schedule
from surreal_tpu_torch.chaos.invariants import ORACLES, RunRecord, evaluate
from surreal_tpu_torch.chaos.campaign import run_campaign, shrink

__all__ = [
    "PROFILES",
    "generate_schedule",
    "ORACLES",
    "RunRecord",
    "evaluate",
    "run_campaign",
    "shrink",
]
