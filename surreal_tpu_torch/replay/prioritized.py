"""Prioritized experience replay, the port of
``surreal_tpu/replay/prioritized.py``: proportional priorities ``p^alpha``,
IS weights with annealed beta, max priority on fresh inserts (Schaul et
al. 2016). Sampling is ``cumsum`` + ``searchsorted`` over the priority
vector, stratified (one draw per equal slice of the mass), in the
reference's order of operations line for line.

The priority refresh is the scatter kernel of ``ops/replay_rows.py`` on
the card (its plain version on the CPU), whatever ``gather_impl`` says; a
repeated index (a stratified draw can pick a high-mass slot twice) keeps
its last update, as the reference's Pallas kernel and XLA's CPU scatter
do. The ring and the priority vector are updated in place.

Numerics: ``torch.cumsum`` and ``pow`` round differently from XLA's (and
from each other on the CPU and the card), so a draw within a few ulps of a
cdf boundary can pick the neighbouring slot. The tests state and check
that rule.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import numpy as np
import torch

from surreal_tpu_torch.ops.replay_rows import scatter_rows
from surreal_tpu_torch.replay.base import (
    RingState,
    can_sample,
    init_ring,
    ring_gather,
    ring_gauges,
    ring_insert,
    ring_spans,
    sample_age_frac,
)


class PrioritizedState(NamedTuple):
    ring: RingState
    priorities: torch.Tensor    # [capacity] float32, 0 = empty slot
    max_priority: torch.Tensor  # scalar float32, priority given to fresh transitions


class PrioritizedReplay:
    def __init__(self, replay_config):
        self.capacity = int(replay_config.capacity)
        self.batch_size = int(replay_config.batch_size)
        self.start_sample_size = int(replay_config.start_sample_size)
        self.alpha = float(replay_config.priority_alpha)
        self.beta0 = float(replay_config.priority_beta0)
        self.eps = float(replay_config.priority_eps)
        self.gather_impl = replay_config.get("gather_impl", "xla")

    def init(self, example_transition: Mapping[str, torch.Tensor]) -> PrioritizedState:
        device = next(iter(example_transition.values())).device
        return PrioritizedState(
            ring=init_ring(example_transition, self.capacity),
            priorities=torch.zeros(self.capacity, dtype=torch.float32, device=device),
            max_priority=torch.ones((), dtype=torch.float32, device=device),
        )

    def insert(self, state: PrioritizedState, batch: Mapping[str, torch.Tensor]) -> PrioritizedState:
        """New transitions enter at the current max priority (so they are
        seen at least once before their TD error takes over)."""
        n = next(iter(batch.values())).shape[0]
        spans = ring_spans(state.ring.cursor, n, self.capacity)
        ring = ring_insert(state.ring, batch, self.capacity)
        for dst, _, length in spans:
            state.priorities[dst : dst + length].copy_(state.max_priority.expand(length))
        return PrioritizedState(ring=ring, priorities=state.priorities, max_priority=state.max_priority)

    def can_sample(self, state: PrioritizedState) -> bool:
        return can_sample(state.ring.size, self.start_sample_size)

    def sample(
        self,
        state: PrioritizedState,
        generator: torch.Generator | None = None,
        batch_size: int | None = None,
        beta: float | None = None,
        uniforms: torch.Tensor | None = None,
    ):
        """-> (state, batch, {"idx": idx [bs] int32, "is_weights": [bs]}).

        ``beta`` is the IS-correction exponent (annealed 0.4 -> 1.0 by the
        caller; defaults to beta0), rounded to float32 as the reference
        passes it. ``uniforms`` [bs] in [0, 1) replace the draws from
        ``generator``."""
        bs = batch_size or self.batch_size
        beta = float(np.float32(self.beta0 if beta is None else beta))
        device = state.priorities.device
        if uniforms is None:
            uniforms = torch.rand(bs, generator=generator, dtype=torch.float32, device=device)
        elif tuple(uniforms.shape) != (bs,):
            raise ValueError(f"uniforms must be [{bs}]; got {tuple(uniforms.shape)}")
        else:
            uniforms = uniforms.to(device=device, dtype=torch.float32)
        p = state.priorities**self.alpha  # empty slots are 0^alpha = 0
        total = p.sum()
        cdf = torch.cumsum(p, dim=0)
        # stratified sampling: one uniform draw per equal slice of the mass
        u = (torch.arange(bs, dtype=torch.float32, device=device) + uniforms) / bs * total
        idx = torch.clamp(torch.searchsorted(cdf, u, out_int32=True), 0, self.capacity - 1)

        probs = p.index_select(0, idx) / torch.clamp_min(total, 1e-12)
        n = float(max(state.ring.size, 1))
        weights = (n * torch.clamp_min(probs, 1e-12)) ** (-beta)
        weights = weights / torch.clamp_min(weights.max(), 1e-12)

        batch = ring_gather(state.ring, idx, impl=self.gather_impl)
        return state, batch, {"idx": idx, "is_weights": weights}

    # -- telemetry gauges (device scalars; see replay/base.py) ---------------
    def gauges(self, state: PrioritizedState) -> dict:
        return {**ring_gauges(state.ring, self.capacity), "replay/max_priority": state.max_priority}

    def age_frac(self, state: PrioritizedState, idx: torch.Tensor) -> torch.Tensor:
        return sample_age_frac(state.ring, idx, self.capacity)

    def update_priorities(
        self, state: PrioritizedState, idx: torch.Tensor, td_errors: torch.Tensor
    ) -> PrioritizedState:
        """Priorities at ``idx`` become ``|td| + eps`` (in place; the last
        occurrence of a repeated index wins) and the max priority follows."""
        prio = torch.abs(td_errors) + self.eps
        priorities = scatter_rows(state.priorities, idx, prio)
        return PrioritizedState(
            ring=state.ring,
            priorities=priorities,
            max_priority=torch.maximum(state.max_priority, prio.max()),
        )
