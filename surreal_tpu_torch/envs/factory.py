"""``make_env`` factory, the port of ``surreal_tpu/envs/factory.py``.

Env names keep the reference's ``jax:`` prefix so one config tree drives
both packages: ``jax:lift`` builds the batched torch :class:`BlockLift`,
``jax:pong`` and ``jax:pong16`` the pixel :class:`Pong` and
:class:`PongSmall`, ``jax:pendulum`` :class:`Pendulum` and
``jax:cartpole`` :class:`CartPole`, each wrapped in :class:`AutoReset`. The other
on-device envs and the host backends (gym, dm_control, robosuite) are not
ported yet and raise.
"""

from __future__ import annotations

import torch

from surreal_tpu_torch.envs.device.base import AutoReset
from surreal_tpu_torch.utils.device import resolve_device

_NOT_PORTED = ("jax:nut", "jax:lift_pixels", "jax:nut_pixels")
_PORTED = ("jax:lift", "jax:pong", "jax:pong16", "jax:pendulum", "jax:cartpole")


def make_env(env_config, device: str | torch.device = "cuda") -> AutoReset:
    """Build the configured device env from an ``env_config`` tree."""
    name = env_config.name
    if ":" not in name:
        raise ValueError(
            f"env name {name!r} needs a backend prefix (jax:, gym:, dm_control:, robosuite:)"
        )
    if name == "jax:lift":
        from surreal_tpu_torch.envs.device.lift import BlockLift as env_cls
    elif name == "jax:pong":
        from surreal_tpu_torch.envs.device.pong import Pong as env_cls
    elif name == "jax:pong16":
        from surreal_tpu_torch.envs.device.pong import PongSmall as env_cls
    elif name == "jax:pendulum":
        from surreal_tpu_torch.envs.device.pendulum import Pendulum as env_cls
    elif name == "jax:cartpole":
        from surreal_tpu_torch.envs.device.cartpole import CartPole as env_cls
    else:
        backend = name.partition(":")[0]
        if name in _NOT_PORTED or backend in ("gym", "dm_control", "robosuite"):
            raise NotImplementedError(
                f"env {name!r} is not ported to PyTorch yet; the port has {', '.join(_PORTED)}"
            )
        raise ValueError(f"unknown env {name!r}")
    return AutoReset(env_cls(resolve_device(device)), time_limit=env_config.time_limit)
