"""Obs/action spec contracts, copied from the JAX package's
``surreal_tpu/envs/base.py`` (numpy only) so the port imports no module of
that package. Host envs (``HostEnv`` and its wrappers) are not ported yet.

All continuous action spaces are canonicalized to [-1, 1].
"""

from __future__ import annotations

import dataclasses

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
