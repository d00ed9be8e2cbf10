"""Shape guards for the learn and replay-insert seams, the port of
``surreal_tpu/utils/asserts.py`` (``check_learn_batch``,
``check_insert_batch``) with plain checks in place of ``chex``. They read
shapes only, so they never wait on the device.
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


def check_insert_batch(batch: Mapping, storage: Mapping, name: str = "insert") -> None:
    """Validate a replay-insert batch against the buffer storage (both flat
    dicts of tensors): the same keys, one shared leading batch dim, and
    per-leaf trailing dims matching the storage's per-transition shapes."""
    if set(batch) != set(storage):
        raise ValueError(
            f"{name}: batch keys do not match replay storage "
            f"(batch={sorted(batch)}, storage={sorted(storage)})"
        )
    n = next(iter(batch.values())).shape[0]
    for k, buf in storage.items():
        _expect_shape(
            batch[k], (n, *buf.shape[1:]),
            f"{name}: leaf {k!r} (storage per-transition shape {tuple(buf.shape[1:])})",
        )
