"""Shape guards for the learn seam, the port of
``surreal_tpu/utils/asserts.py::check_learn_batch`` with plain checks in
place of ``chex``. They read shapes only, so they never wait on the device.
"""

from __future__ import annotations

from typing import Mapping

from surreal_tpu_torch.envs.base import DiscreteSpec, EnvSpecs


def _expect_shape(x, shape: tuple, message: str) -> None:
    if tuple(x.shape) != tuple(shape):
        raise AssertionError(f"{message}: expected shape {tuple(shape)}, got {tuple(x.shape)}")


def check_learn_batch(batch: Mapping, specs: EnvSpecs, name: str = "batch") -> None:
    """Validate a learner batch against the env specs. Accepts time-major
    [T, B, ...] and flat [B, ...] layouts, inferred from ``reward``'s rank."""
    if batch["reward"].dim() not in (1, 2):
        raise AssertionError(
            f"{name}: reward leading dims: expected rank 1 or 2, got {batch['reward'].dim()}"
        )
    lead = tuple(batch["reward"].shape)

    for k in ("obs", "next_obs"):
        if k in batch:
            _expect_shape(batch[k], (*lead, *specs.obs.shape), f"{name}: {k} (obs spec {specs.obs.shape})")
    if "action" in batch:
        if isinstance(specs.action, DiscreteSpec):
            _expect_shape(batch["action"], lead, f"{name}: action (discrete -> scalar per step)")
        else:
            _expect_shape(
                batch["action"], (*lead, *specs.action.shape),
                f"{name}: action (spec {specs.action.shape})",
            )
    for k in ("done", "terminated", "discount", "behavior_logp", "is_weights"):
        if k in batch:
            _expect_shape(batch[k], lead, f"{name}: {k} must match reward dims")
