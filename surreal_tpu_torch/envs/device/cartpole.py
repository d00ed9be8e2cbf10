"""On-device CartPole-v1, the port of ``surreal_tpu/envs/jax/cartpole.py``
(``CartPole``, factory name ``jax:cartpole``), written as batched torch ops
over a leading env dimension.

Dynamics per Barto-Sutton-Anderson with gymnasium's constants, as in the
reference: Euler steps of 0.02 s, a +-10 N push (Discrete(2) actions:
1 pushes right, 0 left), reward 1 every step, and ``done`` when the cart
leaves +-2.4 or the pole leans past 12 degrees; episodes are capped at 500
steps by :class:`AutoReset`. Obs is (x, x_dot, theta, theta_dot).

Reset draws [B, 4]: the four state values, each uniform in [-0.05, 0.05)
(from a generator if absent).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

from surreal_tpu_torch.envs.base import ArraySpec, DiscreteSpec, EnvSpecs
from surreal_tpu_torch.envs.device.base import DeviceEnv

_GRAVITY = 9.8
_CART_MASS = 1.0
_POLE_MASS = 0.1
_TOTAL_MASS = _CART_MASS + _POLE_MASS
_POLE_HALF_LEN = 0.5
_POLEMASS_LEN = _POLE_MASS * _POLE_HALF_LEN
_FORCE_MAG = 10.0
_TAU = 0.02
_THETA_LIMIT = 12 * 2 * math.pi / 360
_X_LIMIT = 2.4
_RESET_HALF = 0.05


class CartPoleState(NamedTuple):
    x: torch.Tensor          # [B]
    x_dot: torch.Tensor      # [B]
    theta: torch.Tensor      # [B]
    theta_dot: torch.Tensor  # [B]


class CartPole(DeviceEnv):
    """Cart-pole balancing with 4-dim obs and Discrete(2) actions;
    factory name ``jax:cartpole``."""

    max_episode_steps = 500  # CartPole-v1 limit
    reset_draw_dim = 4

    specs = EnvSpecs(
        obs=ArraySpec(shape=(4,), dtype=np.dtype(np.float32), name="state"),
        action=DiscreteSpec(shape=(), dtype=np.dtype(np.int32), name="action", n=2),
    )

    def reset(
        self,
        num_envs: int,
        generator: torch.Generator | None = None,
        draws: torch.Tensor | None = None,
    ):
        """``draws`` [B, 4] = (x, x_dot, theta, theta_dot), each already in
        [-0.05, 0.05); uniform from ``generator`` if absent."""
        if draws is None:
            u = self._uniform(num_envs, self.reset_draw_dim, generator)
            draws = u * (2 * _RESET_HALF) - _RESET_HALF
        else:
            draws = self._checked_draws(draws, num_envs, self.reset_draw_dim, "reset")
        state = CartPoleState(*(draws[:, i].clone() for i in range(4)))
        return state, self._obs(state)

    def step(self, state: CartPoleState, action: torch.Tensor):
        force = torch.where(action == 1, _FORCE_MAG, -_FORCE_MAG).to(torch.float32)
        cos_t = torch.cos(state.theta)
        sin_t = torch.sin(state.theta)
        temp = (force + _POLEMASS_LEN * state.theta_dot**2 * sin_t) / _TOTAL_MASS
        theta_acc = (_GRAVITY * sin_t - cos_t * temp) / (
            _POLE_HALF_LEN * (4.0 / 3.0 - _POLE_MASS * cos_t**2 / _TOTAL_MASS)
        )
        x_acc = temp - _POLEMASS_LEN * theta_acc * cos_t / _TOTAL_MASS
        new = CartPoleState(
            x=state.x + _TAU * state.x_dot,
            x_dot=state.x_dot + _TAU * x_acc,
            theta=state.theta + _TAU * state.theta_dot,
            theta_dot=state.theta_dot + _TAU * theta_acc,
        )
        done = (torch.abs(new.x) > _X_LIMIT) | (torch.abs(new.theta) > _THETA_LIMIT)
        reward = torch.ones_like(new.x)
        return new, self._obs(new), reward, done, {}

    @staticmethod
    def _obs(state: CartPoleState) -> torch.Tensor:
        return torch.stack(list(state), dim=1)
