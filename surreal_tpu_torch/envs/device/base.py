"""Batched on-device environments, the port of ``surreal_tpu/envs/jax/base.py``.

The JAX package writes each env for one instance and batches it with
``vmap``; here every env is written for a leading batch dimension [B, ...]
from the start, and its state is a NamedTuple of [B, ...] tensors on one
device.

API:
    state, obs = env.reset(num_envs, generator=..., draws=...)
    state, obs, reward, done, info = env.step(state, action)
    state, obs, reward, done, info = env.step(state, action, generator=..., draws=...)

Randomness is explicit. ``reset`` takes its draws from a
``torch.Generator``, or as a tensor [B, reset_draw_dim] of values already
in their ranges (the parity tests pass the numbers JAX drew). An env that
also draws while it steps (Pong's serve angle) has ``step_draw_dim > 0``
and takes the second form of ``step``, with draws [B, step_draw_dim]; the
reference keeps a PRNG key in such an env's state instead.
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
    step_draw_dim: int = 0  # width of one env's explicit step draws (0: none)

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
        """-> (state, obs [B, ...], reward [B], done [B] bool, info dict).
        Envs with ``step_draw_dim > 0`` also take ``generator`` and
        ``draws`` keywords."""

    def _uniform(self, num_envs: int, width: int, generator: torch.Generator | None) -> torch.Tensor:
        """[B, width] uniform [0, 1) draws from ``generator``."""
        return torch.rand((num_envs, width), generator=generator, dtype=torch.float32, device=self.device)

    def _checked_draws(self, draws: torch.Tensor, num_envs: int, width: int, what: str) -> torch.Tensor:
        """Given draws, checked as [B, width] and moved to float32 on the
        env's device."""
        if draws.shape != (num_envs, width):
            raise ValueError(f"{what} draws must be [{num_envs}, {width}]; got {tuple(draws.shape)}")
        return draws.to(device=self.device, dtype=torch.float32)


class AutoResetState(NamedTuple):
    env_state: Any
    step_count: torch.Tensor  # [B] int32


def _select(done: torch.Tensor, reset_leaf, cont_leaf):
    """``reset_leaf`` where ``done``, else ``cont_leaf``; leaves may be
    (nested) NamedTuples of [B, ...] tensors."""
    if isinstance(cont_leaf, tuple):
        return type(cont_leaf)(*(_select(done, r, c) for r, c in zip(reset_leaf, cont_leaf)))
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

    @property
    def step_draw_dim(self) -> int:
        return self.env.step_draw_dim

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
        step_draws: torch.Tensor | None = None,
    ):
        """One step of every env; a reset is drawn for every env (from
        ``generator`` unless ``reset_draws`` is given) and taken where done.
        ``step_draws`` are the env's own step draws, for envs that have
        them."""
        if self.env.step_draw_dim:
            env_state, obs, reward, done, info = self.env.step(
                state.env_state, action, generator=generator, draws=step_draws
            )
        elif step_draws is not None:
            raise ValueError(f"{type(self.env).__name__} takes no step draws")
        else:
            env_state, obs, reward, done, info = self.env.step(state.env_state, action)
        steps = state.step_count + 1
        if self.time_limit is None:
            truncated = torch.zeros_like(done)
        else:
            truncated = (steps >= self.time_limit) & ~done
        done = done | truncated

        num_envs = done.shape[0]
        reset_state, reset_obs = self.env.reset(num_envs, generator=generator, draws=reset_draws)
        new_env_state = _select(done, reset_state, env_state)
        new_obs = _select(done, reset_obs, obs)
        new_steps = torch.where(done, torch.zeros_like(steps), steps)
        info = dict(info)
        info["terminal_obs"] = obs
        info["truncated"] = truncated
        return AutoResetState(new_env_state, new_steps), new_obs, reward, done, info
