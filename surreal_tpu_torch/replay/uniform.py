"""Uniform replay, the port of ``surreal_tpu/replay/uniform.py``: a ring
buffer sampled uniformly with replacement.

Randomness is explicit: ``sample`` and ``sample_many`` draw their indices
from a ``torch.Generator``, or take them as given (``idx``), so the tests
can inject the indices JAX's ``randint`` drew.
"""

from __future__ import annotations

from typing import Mapping

import torch

from surreal_tpu_torch.replay.base import (
    RingState,
    can_sample,
    init_ring,
    ring_gather,
    ring_gauges,
    ring_insert,
    sample_age_frac,
)


def _draw_indices(
    state: RingState, shape: tuple[int, ...], generator: torch.Generator | None, idx: torch.Tensor | None
) -> torch.Tensor:
    """int32 indices uniform over the current fill (``max(size, 1)``), from
    ``generator``, or ``idx`` checked against ``shape`` and moved to the
    storage's device."""
    device = next(iter(state.storage.values())).device
    if idx is None:
        return torch.randint(
            0, max(state.size, 1), shape, generator=generator, device=device, dtype=torch.int32
        )
    if tuple(idx.shape) != tuple(shape):
        raise ValueError(f"idx must be {list(shape)}; got {tuple(idx.shape)}")
    return idx.to(device=device, dtype=torch.int32)


class UniformReplay:
    """Uniform replay over a device ring buffer, updated in place."""

    def __init__(self, replay_config):
        self.capacity = int(replay_config.capacity)
        self.batch_size = int(replay_config.batch_size)
        self.start_sample_size = int(replay_config.start_sample_size)
        # algo.replay_gather, injected by the off-policy trainer: 'xla' and
        # 'pallas' both reach the gather kernel on the card
        self.gather_impl = replay_config.get("gather_impl", "xla")

    def init(self, example_transition: Mapping[str, torch.Tensor]) -> RingState:
        return init_ring(example_transition, self.capacity)

    def insert(self, state: RingState, batch: Mapping[str, torch.Tensor]) -> RingState:
        return ring_insert(state, batch, self.capacity)

    def can_sample(self, state: RingState) -> bool:
        return can_sample(state.size, self.start_sample_size)

    def sample(
        self,
        state: RingState,
        generator: torch.Generator | None = None,
        batch_size: int | None = None,
        idx: torch.Tensor | None = None,
    ):
        """-> (state, batch, {"idx": idx [bs]}): uniform with replacement
        over the current fill, one gather launch."""
        bs = batch_size or self.batch_size
        idx = _draw_indices(state, (bs,), generator, idx)
        return state, ring_gather(state, idx, impl=self.gather_impl), {"idx": idx}

    def sample_many(
        self,
        state: RingState,
        num_sets: int,
        generator: torch.Generator | None = None,
        batch_size: int | None = None,
        idx: torch.Tensor | None = None,
    ):
        """-> (state, batches {k: [K, bs, ...]}, idx [K, bs]): K index sets
        gathered by ONE gather launch of K * bs rows, the off-policy update
        loop's fast path. Set k equals ``sample`` with ``idx[k]``."""
        bs = batch_size or self.batch_size
        idx = _draw_indices(state, (num_sets, bs), generator, idx)
        flat = ring_gather(state, idx.reshape(-1), impl=self.gather_impl)
        batches = {k: x.reshape(num_sets, bs, *x.shape[1:]) for k, x in flat.items()}
        return state, batches, idx

    # -- telemetry gauges (device scalars; see replay/base.py) ---------------
    def gauges(self, state: RingState) -> dict:
        return ring_gauges(state, self.capacity)

    def age_frac(self, state: RingState, idx: torch.Tensor) -> torch.Tensor:
        return sample_age_frac(state, idx, self.capacity)
