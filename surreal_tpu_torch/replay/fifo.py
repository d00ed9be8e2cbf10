"""FIFO on-policy queue, the port of ``surreal_tpu/replay/fifo.py``
(``FIFOState``, ``FIFOReplay``): whole time-major trajectory batches
[T, B, ...] as queue slots, freshest wins, dequeue on sample. The fused
trainer bypasses it (rollouts feed ``learn`` directly); it exists for
decoupled collection and learning, and for parity.

As the port's ring (``replay/base.py``), the storage is updated in place
and ``head`` and ``size`` are host ints. A dequeued batch is a copy of its
slot, so a later insert cannot change it.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from surreal_tpu_torch.utils.tree import tree_flatten, tree_map


class FIFOState(NamedTuple):
    storage: Any  # {k: [slots, T, B, ...]}
    head: int     # oldest slot
    size: int     # filled slots


class FIFOReplay:
    def __init__(self, replay_config):
        # counted in queued trajectory batches (slots)
        self.slots = int(replay_config.get("slots", 8))

    def init(self, example_traj: Any) -> FIFOState:
        storage = tree_map(lambda x: torch.zeros((self.slots, *x.shape), dtype=x.dtype, device=x.device),
                           example_traj)
        return FIFOState(storage=storage, head=0, size=0)

    def insert(self, state: FIFOState, traj: Any) -> FIFOState:
        """Enqueue one trajectory batch; when full, overwrite the oldest
        (on-policy data ages out: freshest wins)."""
        tail = (state.head + state.size) % self.slots
        new = tree_flatten(traj)
        for path, buf in tree_flatten(state.storage).items():
            buf[tail].copy_(new[path])  # cast to the storage dtype, as the reference's astype
        full = state.size >= self.slots
        return FIFOState(
            storage=state.storage,
            head=(state.head + 1) % self.slots if full else state.head,
            size=state.size if full else state.size + 1,
        )

    def can_sample(self, state: FIFOState) -> bool:
        return state.size > 0

    def sample(self, state: FIFOState, generator: torch.Generator | None = None):
        """Dequeue the oldest trajectory batch -> (state, traj)."""
        del generator
        traj = tree_map(lambda buf: buf[state.head].clone(), state.storage)
        new = FIFOState(storage=state.storage, head=(state.head + 1) % self.slots, size=max(state.size - 1, 0))
        return new, traj
