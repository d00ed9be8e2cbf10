"""Batched on-device environments, the port of ``surreal_tpu/envs/jax/base.py``.

The JAX package writes each env for one instance and batches it with
``vmap``; here every env is written for a leading batch dimension [B, ...]
from the start, and its state is a NamedTuple of [B, ...] tensors on one
device.

API:
    state, obs = env.reset(num_envs, generator=..., draws=...)
    state, obs, reward, done, info = env.step(state, action)

Randomness is explicit. ``reset`` takes its draws from a
``torch.Generator``, or as a tensor of values already in their ranges
(the parity tests pass the numbers JAX drew).
"""

from __future__ import annotations

import abc
from typing import Any, NamedTuple

import torch

from surreal_tpu_torch.envs.base import EnvSpecs


class DeviceEnv(abc.ABC):
    """Batched functional env definition on one device."""

    specs: EnvSpecs
    max_episode_steps: int | None = None
    reset_draw_dim: int  # width of one env's explicit reset draws

    def __init__(self, device: torch.device | str):
        self.device = torch.device(device)

    @abc.abstractmethod
    def reset(
        self,
        num_envs: int,
        generator: torch.Generator | None = None,
        draws: torch.Tensor | None = None,
    ):
        """-> (state of [B, ...] tensors, obs [B, obs_dim...])"""

    @abc.abstractmethod
    def step(self, state, action: torch.Tensor):
        """-> (state, obs [B, ...], reward [B], done [B] bool, info dict)"""


class AutoResetState(NamedTuple):
    env_state: Any
    step_count: torch.Tensor  # [B] int32


def _select(done: torch.Tensor, reset_leaf: torch.Tensor, cont_leaf: torch.Tensor) -> torch.Tensor:
    mask = done.reshape(done.shape + (1,) * (reset_leaf.dim() - done.dim()))
    return torch.where(mask, reset_leaf, cont_leaf)


class AutoReset:
    """Auto-reset + time-limit composition with the reference's exact
    rules: a reset is drawn on every step and selected where done; on done
    the returned obs IS the reset obs, and the episode's terminal obs is
    surfaced in ``info['terminal_obs']``; ``info['truncated']`` marks a
    time-limit end, and a genuine termination beats a truncation (so a
    real failure state is never bootstrapped)."""

    def __init__(self, env: DeviceEnv, time_limit: int | None = None):
        self.env = env
        self.specs = env.specs
        self.device = env.device
        self.time_limit = time_limit or env.max_episode_steps

    @property
    def reset_draw_dim(self) -> int:
        return self.env.reset_draw_dim

    def reset(
        self,
        num_envs: int,
        generator: torch.Generator | None = None,
        draws: torch.Tensor | None = None,
    ):
        env_state, obs = self.env.reset(num_envs, generator=generator, draws=draws)
        steps = torch.zeros(num_envs, dtype=torch.int32, device=self.device)
        return AutoResetState(env_state, steps), obs

    def step(
        self,
        state: AutoResetState,
        action: torch.Tensor,
        generator: torch.Generator | None = None,
        reset_draws: torch.Tensor | None = None,
    ):
        env_state, obs, reward, done, info = self.env.step(state.env_state, action)
        steps = state.step_count + 1
        if self.time_limit is None:
            truncated = torch.zeros_like(done)
        else:
            truncated = (steps >= self.time_limit) & ~done
        done = done | truncated

        num_envs = done.shape[0]
        reset_state, reset_obs = self.env.reset(num_envs, generator=generator, draws=reset_draws)
        new_env_state = type(env_state)(
            *(_select(done, r, c) for r, c in zip(reset_state, env_state))
        )
        new_obs = _select(done, reset_obs, obs)
        new_steps = torch.where(done, torch.zeros_like(steps), steps)
        info = dict(info)
        info["terminal_obs"] = obs
        info["truncated"] = truncated
        return AutoResetState(new_env_state, new_steps), new_obs, reward, done, info
