"""Replay, the port of ``surreal_tpu/replay/`` (ring buffer, uniform and
prioritized replay, kind dispatch). FIFO, the dp-sharded placement and
the tiered hot ring are not ported yet."""

from surreal_tpu_torch.replay.base import RingState, can_sample, init_ring, ring_gather, ring_insert
from surreal_tpu_torch.replay.prioritized import PrioritizedReplay, PrioritizedState
from surreal_tpu_torch.replay.sharded import build_replay
from surreal_tpu_torch.replay.uniform import UniformReplay

__all__ = [
    "RingState",
    "can_sample",
    "init_ring",
    "ring_gather",
    "ring_insert",
    "PrioritizedReplay",
    "PrioritizedState",
    "UniformReplay",
    "build_replay",
]
