"""Env contracts, copied from the JAX package's ``surreal_tpu/envs/base.py``
(numpy only) so the port imports no module of that package: the obs and
action specs, and the host env family.

- :class:`HostEnv`: stateful, **batched** numpy envs on the CPU host (the
  gymnasium, dm_control and robosuite adapters). One host process steps B
  envs and ships one contiguous obs batch to the device.
- The device envs (``envs/device/``) are batched torch envs on the card.

All continuous action spaces are canonicalized to [-1, 1]; adapters own
the rescaling to native bounds.
"""

from __future__ import annotations

import abc
import dataclasses
from typing import Any

import numpy as np


@dataclasses.dataclass(frozen=True)
class ArraySpec:
    """Shape/dtype contract for one obs or action array (unbatched)."""

    shape: tuple[int, ...]
    dtype: np.dtype
    name: str = ""

    def zeros(self, batch: int | None = None) -> np.ndarray:
        shape = self.shape if batch is None else (batch, *self.shape)
        return np.zeros(shape, self.dtype)


@dataclasses.dataclass(frozen=True)
class DiscreteSpec(ArraySpec):
    """Discrete action spec: scalar int action in [0, n)."""

    n: int = 0


@dataclasses.dataclass(frozen=True)
class EnvSpecs:
    obs: ArraySpec
    action: ArraySpec

    @property
    def discrete(self) -> bool:
        return isinstance(self.action, DiscreteSpec)


class StepOutput(dict):
    """Batched step result: obs [B,...], reward [B], done [B], info dict.

    ``done`` marks episode boundaries *after which the obs is already the
    reset obs* (auto-reset semantics — what on-device pipelines need so
    trajectories stay fixed-shape; the pre-reset terminal obs is available
    as ``info['terminal_obs']`` for algorithms that bootstrap off it).
    """

    @property
    def obs(self) -> np.ndarray:
        return self["obs"]

    @property
    def reward(self) -> np.ndarray:
        return self["reward"]

    @property
    def done(self) -> np.ndarray:
        return self["done"]

    @property
    def info(self) -> dict[str, Any]:
        return self.get("info", {})


def rescale_canonical_action(
    actions: np.ndarray, low: np.ndarray, high: np.ndarray
) -> np.ndarray:
    """Map canonical [-1, 1] actions to native [low, high] bounds (the one
    place this arithmetic lives; both host adapters call it)."""
    a = np.clip(actions, -1.0, 1.0)
    return low + (a + 1.0) * 0.5 * (high - low)


class HostEnv(abc.ABC):
    """Batched, auto-resetting host environment.

    ``pre_reset_hook`` — optional callable ``(i, env) -> None`` that
    adapters invoke for env ``i`` immediately before its auto-reset, while
    the terminal state is still live. This is the seam wrappers that derive
    observations from live env state (e.g. rendered pixels) use to capture
    the TRUE terminal observation; without it a render after ``step`` sees
    the next episode's first frame.
    """

    specs: EnvSpecs
    num_envs: int
    pre_reset_hook = None

    @abc.abstractmethod
    def reset(self, seed: int | None = None) -> np.ndarray:
        """Reset all envs; returns obs batch [B, ...]."""

    @abc.abstractmethod
    def step(self, actions: np.ndarray) -> StepOutput:
        """Step all envs with actions [B, ...]; auto-resets finished envs."""

    def close(self) -> None:  # pragma: no cover - trivial default
        pass


class HostWrapper(HostEnv):
    """Base wrapper delegating to an inner env (parity: reference
    ``surreal/env/wrapper.py`` Wrapper base)."""

    def __init__(self, env: HostEnv):
        self.env = env
        self.specs = env.specs
        self.num_envs = env.num_envs

    def reset(self, seed: int | None = None) -> np.ndarray:
        return self.env.reset(seed)

    def step(self, actions: np.ndarray) -> StepOutput:
        return self.env.step(actions)

    def close(self) -> None:
        self.env.close()

    def __getattr__(self, name: str) -> Any:
        return getattr(self.env, name)
