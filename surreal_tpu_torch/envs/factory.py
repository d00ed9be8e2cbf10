"""``make_env`` factory, the port of ``surreal_tpu/envs/factory.py``.

Env names keep the reference's ``jax:`` prefix so one config tree drives
both packages: ``jax:lift`` builds the batched torch :class:`BlockLift`
wrapped in :class:`AutoReset`. The other on-device envs and the host
backends (gym, dm_control, robosuite) are not ported yet and raise.
"""

from __future__ import annotations

import torch

from surreal_tpu_torch.envs.device.base import AutoReset
from surreal_tpu_torch.utils.device import resolve_device

_NOT_PORTED = (
    "jax:cartpole", "jax:pendulum", "jax:pong", "jax:pong16", "jax:nut",
    "jax:lift_pixels", "jax:nut_pixels",
)


def make_env(env_config, device: str | torch.device = "cuda") -> AutoReset:
    """Build the configured device env from an ``env_config`` tree."""
    name = env_config.name
    if ":" not in name:
        raise ValueError(
            f"env name {name!r} needs a backend prefix (jax:, gym:, dm_control:, robosuite:)"
        )
    if name == "jax:lift":
        from surreal_tpu_torch.envs.device.lift import BlockLift

        return AutoReset(BlockLift(resolve_device(device)), time_limit=env_config.time_limit)
    backend = name.partition(":")[0]
    if name in _NOT_PORTED or backend in ("gym", "dm_control", "robosuite"):
        raise NotImplementedError(
            f"env {name!r} is not ported to PyTorch yet; the port has 'jax:lift' only"
        )
    raise ValueError(f"unknown env {name!r}")
