"""``make_env`` factory, the port of ``surreal_tpu/envs/factory.py``.

Env names keep the reference's backend prefixes so one config tree drives
both packages:

- ``jax:*`` builds a batched torch device env wrapped in
  :class:`AutoReset`: ``jax:lift`` (:class:`BlockLift`), ``jax:nut``
  (:class:`NutAssembly`), ``jax:lift_pixels`` and ``jax:nut_pixels`` (their
  rendered two-view pixel variants), ``jax:pong`` and ``jax:pong16``
  (:class:`Pong`, :class:`PongSmall`), ``jax:pendulum`` and
  ``jax:cartpole``;
- ``gym:*``, ``dm_control:*`` and ``robosuite:*`` build a batched numpy
  :class:`HostEnv` adapter, wrapped in the reference's order: pixel obs,
  grayscale, frame stack, action repeat, episode stats. A host env lives
  on the CPU and takes no ``device``; only the learner and its batches go
  to the card.

Callers branch on :func:`is_jax_env`. With ``env_config.video.enabled``
and a ``video.dir``, a host env ends its chain in ``envs/video.py``'s
``VideoWrapper`` (and gym renders ``rgb_array`` frames for it), as in the
reference; a device env's eval episodes are recorded by the evaluator
from state (``launch/evaluator.py``).
"""

from __future__ import annotations

from typing import Union

import torch

from surreal_tpu_torch.envs.base import HostEnv
from surreal_tpu_torch.envs.device.base import AutoReset
from surreal_tpu_torch.envs.wrappers import (
    ActionRepeatWrapper,
    EpisodeStatsWrapper,
    FrameStackWrapper,
    GrayscaleWrapper,
    PixelObsWrapper,
)
from surreal_tpu_torch.utils.device import resolve_device

AnyEnv = Union[HostEnv, AutoReset]


def _device_env_cls(env_id: str):
    if env_id == "lift":
        from surreal_tpu_torch.envs.device.lift import BlockLift as env_cls
    elif env_id == "nut":
        from surreal_tpu_torch.envs.device.nut_assembly import NutAssembly as env_cls
    elif env_id == "lift_pixels":
        from surreal_tpu_torch.envs.device.pixels import BlockLiftPixels as env_cls
    elif env_id == "nut_pixels":
        from surreal_tpu_torch.envs.device.pixels import NutAssemblyPixels as env_cls
    elif env_id == "pong":
        from surreal_tpu_torch.envs.device.pong import Pong as env_cls
    elif env_id == "pong16":
        from surreal_tpu_torch.envs.device.pong import PongSmall as env_cls
    elif env_id == "pendulum":
        from surreal_tpu_torch.envs.device.pendulum import Pendulum as env_cls
    elif env_id == "cartpole":
        from surreal_tpu_torch.envs.device.cartpole import CartPole as env_cls
    else:
        have = ["cartpole", "lift", "lift_pixels", "nut", "nut_pixels", "pendulum", "pong", "pong16"]
        raise ValueError(f"unknown jax env {env_id!r}; have {have}")
    return env_cls


def is_jax_env(env: AnyEnv) -> bool:
    return isinstance(env, AutoReset)


def make_env(env_config, device: str | torch.device = "cuda") -> AnyEnv:
    """Build the configured environment from an ``env_config`` tree; a
    device env goes on ``device``, a host env ignores it."""
    name = env_config.name
    if ":" not in name:
        raise ValueError(
            f"env name {name!r} needs a backend prefix (jax:, gym:, dm_control:, robosuite:)"
        )
    backend, _, env_id = name.partition(":")
    if backend == "jax":
        env_cls = _device_env_cls(env_id)
        return AutoReset(env_cls(resolve_device(device)), time_limit=env_config.time_limit)

    video = env_config.get("video", None)
    record = video is not None and bool(video.get("enabled", False))
    if backend == "gym":
        from surreal_tpu_torch.envs.gym_adapter import GymAdapter

        # pixel obs and video recording both need rendered frames
        kwargs = {"render_mode": "rgb_array"} if env_config.pixel_obs or record else {}
        env: HostEnv = GymAdapter(env_id, num_envs=env_config.num_envs, seed=env_config.seed, **kwargs)
    elif backend == "dm_control":
        from surreal_tpu_torch.envs.dm_control_adapter import DmControlAdapter

        domain, _, task = env_id.partition("-")
        env = DmControlAdapter(domain, task, num_envs=env_config.num_envs, seed=env_config.seed)
    elif backend == "robosuite":
        try:
            import robosuite  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "robosuite is not installed; use the on-device BlockLifting-class "
                "env 'jax:lift' (or 'jax:nut') for Robosuite-class workloads"
            ) from e
        from surreal_tpu_torch.envs.robosuite_adapter import RobosuiteAdapter

        env = RobosuiteAdapter(
            env_id, num_envs=env_config.num_envs, seed=env_config.seed,
            renderable=bool(env_config.pixel_obs or record),
        )
    else:
        raise ValueError(f"unknown env backend {backend!r}")

    if env_config.pixel_obs:
        env = PixelObsWrapper(env, image_size=tuple(env_config.image_size or (84, 84)))
    if env_config.grayscale:
        env = GrayscaleWrapper(env)
    if env_config.frame_stack > 1:
        env = FrameStackWrapper(env, env_config.frame_stack)
    if env_config.action_repeat > 1:
        env = ActionRepeatWrapper(env, env_config.action_repeat)
    env = EpisodeStatsWrapper(env)
    if record and video.get("dir", None):
        from surreal_tpu_torch.envs.video import VideoWrapper

        env = VideoWrapper(env, video.dir, video.every_n_episodes)
    return env
