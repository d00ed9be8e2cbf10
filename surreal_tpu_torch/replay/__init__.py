"""Replay, the port of ``surreal_tpu/replay/`` (ring buffer, uniform and
prioritized replay, the FIFO queue, the device hot tier, kind dispatch).
The dp-sharded placement is not ported yet."""

from surreal_tpu_torch.replay.base import RingState, can_sample, init_ring, ring_gather, ring_insert
from surreal_tpu_torch.replay.fifo import FIFOReplay, FIFOState
from surreal_tpu_torch.replay.prioritized import PrioritizedReplay, PrioritizedState
from surreal_tpu_torch.replay.sharded import build_replay
from surreal_tpu_torch.replay.uniform import UniformReplay

__all__ = [
    "RingState",
    "can_sample",
    "init_ring",
    "ring_gather",
    "ring_insert",
    "FIFOReplay",
    "FIFOState",
    "PrioritizedReplay",
    "PrioritizedState",
    "UniformReplay",
    "build_replay",
]
