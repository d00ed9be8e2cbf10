"""Device-resident hot replay tier, the port of
``surreal_tpu/replay/tiers.py`` (``HotTier``): a fixed-capacity ring of
the NEWEST transitions held on the card, on ``replay/base.py``'s ring
(``init_ring``, ``ring_insert``, ``ring_gather``), filled with the
collector's folded transition batches while they are still on the card
and drawn through the replay gather kernel, so a steady-state uniform
sample never touches the host: no wire frame, no unpack, no
host->device copy.

Bit-equality contract: the draw is the in-process ``UniformReplay``
draw, ``torch.randint(0, max(size, 1), (bs,), dtype=int32)`` on a
generator on the ring's device seeded with the update's seed, followed
by the same ``ring_gather``, so for the same capacity, insert stream and
seed a hot sample is BIT-EQUAL to ``UniformReplay.sample`` with a
generator seeded the same way (tested on the CPU and on the card). The
warm fan-in stays the distribution over the full shard rings; the hot
tier is newest-only by design.

``gather_impl`` ('xla' or 'pallas', the reference's knob) does not
route anything: on a CUDA ring ``ring_gather`` launches the replay
gather kernel whatever it says, and on a CPU ring it runs the kernel's
plain version (ROADMAP's ground rule for kernel-routing knobs). Any other
value raises, as in the reference.

Threads: under ``overlap_rollouts`` the staging thread appends while the
main thread samples. ``ring_insert`` writes in place, so appends and
samples are dispatched under one lock and on ONE CUDA stream (the
stream current when the ring was allocated): a gather enqueued before an
insert reads the old rows. The draw and the gather make no host sync.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any, Mapping

import torch

from surreal_tpu_torch.replay.base import GATHER_IMPLS, RingState, init_ring, ring_gather, ring_insert


def default_gather_impl(device: torch.device) -> str:
    """The reference's default label: 'pallas' where the ring lives on
    the accelerator, 'xla' elsewhere (see the module docstring: the label
    routes nothing in the port)."""
    return "pallas" if torch.device(device).type == "cuda" else "xla"


class HotTier:
    """Fixed-capacity device ring of the newest transitions."""

    def __init__(
        self,
        capacity: int,
        batch_size: int,
        gather_impl: str | None = None,
        min_fill: int | None = None,
        example: Mapping[str, Any] | None = None,
    ):
        if gather_impl is not None and gather_impl not in GATHER_IMPLS:
            raise ValueError(f"hot tier gather_impl {gather_impl!r} not in xla|pallas")
        self.capacity = int(capacity)
        self.batch_size = int(batch_size)
        if self.capacity < self.batch_size:
            raise ValueError(f"tiers.hot_capacity={capacity} is smaller than batch_size={batch_size}")
        self.gather_impl = gather_impl
        # minimum fill before the tier claims a hit (a full batch by
        # default: a near-empty ring would oversample its first rows)
        self.min_fill = int(min_fill) if min_fill is not None else self.batch_size
        self._state: RingState | None = None
        self._stream = None
        if example is not None:
            # storage in the caller's staging dtypes (the warm tier's bf16
            # obs under 'bf16'): ring_insert casts appended f32 rows, so a
            # hot sample has a warm batch's dtypes
            self._allocate(dict(example))
        self.size = 0      # rows held (a host int, as the ring's own)
        self.appended = 0  # rows ever appended
        self._lock = threading.Lock()

    def _allocate(self, example: Mapping[str, torch.Tensor]) -> None:
        self._state = init_ring(example, self.capacity)
        self.device = next(iter(example.values())).device
        if self.gather_impl is None:
            self.gather_impl = default_gather_impl(self.device)
        if self.device.type == "cuda":
            self._stream = torch.cuda.current_stream(self.device)

    def _on_stream(self):
        return torch.cuda.stream(self._stream) if self._stream is not None else contextlib.nullcontext()

    def append(self, rows: Mapping[str, torch.Tensor]) -> None:
        """Insert one flat [n, ...] batch (on the ring's device, ideally
        the collector's own tensors). The first append allocates the
        storage from the batch's shapes and dtypes when no example was
        given."""
        n = int(next(iter(rows.values())).shape[0])
        with self._lock:
            if self._state is None:
                self._allocate({k: v[0] for k, v in rows.items()})
            with self._on_stream():
                self._state = ring_insert(self._state, dict(rows), self.capacity)
            self.size = self._state.size
            self.appended += n

    def ready(self) -> bool:
        return self._state is not None and self.size >= max(self.min_fill, self.batch_size)

    def sample(self, seed: int) -> dict[str, torch.Tensor]:
        """One uniform batch, enqueued (no host sync): call it at request
        time so the draw and the gather overlap the learner. A dict of
        device tensors in flat field order."""
        with self._lock:
            if self._state is None:
                raise RuntimeError("hot tier sampled before first append")
            with self._on_stream():
                gen = torch.Generator(device=self.device).manual_seed(int(seed))
                idx = torch.randint(0, max(self._state.size, 1), (self.batch_size,), generator=gen,
                                    device=self.device, dtype=torch.int32)
                return ring_gather(self._state, idx, impl=self.gather_impl)

    def gauges(self) -> dict[str, float]:
        return {"tier/hot_size": float(self.size), "tier/hot_fill": float(self.size) / float(self.capacity)}
