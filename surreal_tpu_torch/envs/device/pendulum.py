"""On-device Pendulum-v1, the port of ``surreal_tpu/envs/jax/pendulum.py``
(``Pendulum``, factory name ``jax:pendulum``), written as batched torch ops
over a leading env dimension.

Dynamics, constants and cost are gymnasium's Pendulum-v1, as in the
reference: the canonical [-1, 1] action box is scaled to +-2 torque, the
angular speed is clipped to +-8, and ``done`` is always False (episodes end
by the 200-step time limit in :class:`AutoReset`). Obs is (cos theta,
sin theta, theta_dot).

The angle normalization is a floor-mod, as ``jnp``'s ``%`` is
(``torch.remainder``, not ``fmod``). The constant factors
``3 g / (2 l)`` and ``3 / (m l^2)`` are Python floats folded before any
tensor op, as they are in the reference.

Reset draws [B, 2]: theta in [-pi, pi) and theta_dot in [-1, 1), each
already in its range (uniform from a generator if absent).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs
from surreal_tpu_torch.envs.device.base import DeviceEnv

_MAX_SPEED = 8.0
_MAX_TORQUE = 2.0
_DT = 0.05
_G = 10.0
_M = 1.0
_L = 1.0

RESET_LOW = (-math.pi, -1.0)
RESET_HIGH = (math.pi, 1.0)


class PendulumState(NamedTuple):
    theta: torch.Tensor      # [B]
    theta_dot: torch.Tensor  # [B]


def _angle_normalize(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi


class Pendulum(DeviceEnv):
    """Pendulum swing-up with 3-dim obs and a 1-dim torque action;
    factory name ``jax:pendulum``."""

    max_episode_steps = 200
    reset_draw_dim = 2

    specs = EnvSpecs(
        obs=ArraySpec(shape=(3,), dtype=np.dtype(np.float32), name="state"),
        action=ArraySpec(shape=(1,), dtype=np.dtype(np.float32), name="torque"),
    )

    def __init__(self, device: torch.device | str):
        super().__init__(device)
        f32 = dict(dtype=torch.float32, device=self.device)
        self._reset_low = torch.tensor(RESET_LOW, **f32)
        self._reset_span = torch.tensor(RESET_HIGH, **f32) - self._reset_low

    def reset(
        self,
        num_envs: int,
        generator: torch.Generator | None = None,
        draws: torch.Tensor | None = None,
    ):
        """``draws`` [B, 2] = (theta, theta_dot), each already in its
        range; uniform from ``generator`` if absent."""
        if draws is None:
            draws = self._reset_low + self._uniform(num_envs, self.reset_draw_dim, generator) * self._reset_span
        else:
            draws = self._checked_draws(draws, num_envs, self.reset_draw_dim, "reset")
        state = PendulumState(draws[:, 0].clone(), draws[:, 1].clone())
        return state, self._obs(state)

    def step(self, state: PendulumState, action: torch.Tensor):
        u = torch.clamp(action[:, 0].to(torch.float32), -1.0, 1.0) * _MAX_TORQUE
        cost = _angle_normalize(state.theta) ** 2 + 0.1 * state.theta_dot**2 + 0.001 * u**2
        new_theta_dot = state.theta_dot + (
            3.0 * _G / (2.0 * _L) * torch.sin(state.theta) + 3.0 / (_M * _L**2) * u
        ) * _DT
        new_theta_dot = torch.clamp(new_theta_dot, -_MAX_SPEED, _MAX_SPEED)
        new = PendulumState(theta=state.theta + new_theta_dot * _DT, theta_dot=new_theta_dot)
        done = torch.zeros_like(new_theta_dot, dtype=torch.bool)  # time-limit only (AutoReset)
        return new, self._obs(new), -cost, done, {}

    @staticmethod
    def _obs(state: PendulumState) -> torch.Tensor:
        return torch.stack([torch.cos(state.theta), torch.sin(state.theta), state.theta_dot], dim=1)
