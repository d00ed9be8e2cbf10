"""Replay ring buffer, the port of ``surreal_tpu/replay/base.py``
(``RingState``, ``init_ring``, ``ring_insert``, ``ring_gather``,
``can_sample``, ``ring_gauges``, ``sample_age_frac``).

The buffer is a flat dict of device tensors ``{k: [capacity, ...]}``.
Two things differ from the reference, by design:

- The ring is updated IN PLACE: ``ring_insert`` writes into the storage
  tensors of the state it is given and returns a state around the same
  tensors. This is the port's counterpart of the reference's buffer
  donation; a caller never reads a state after passing it on.
- ``cursor`` and ``size`` are host ints. They depend only on how many
  rows were inserted, a static count, so every decision made from them
  (``can_sample``, the wrap-around of an insert) is taken on the host
  without reading anything back from the card.
"""

from __future__ import annotations

from typing import Mapping, NamedTuple

import torch

from surreal_tpu_torch.ops.replay_rows import gather_rows
from surreal_tpu_torch.utils.asserts import check_insert_batch

GATHER_IMPLS = ("xla", "pallas")


class RingState(NamedTuple):
    """Ring-buffer bookkeeping."""

    storage: dict  # {k: [capacity, ...]} device tensors
    cursor: int    # next write position
    size: int      # current fill


def init_ring(example: Mapping[str, torch.Tensor], capacity: int) -> RingState:
    """Allocate zeroed storage shaped after one example transition
    ``{k: [...]}`` (leading batch dims stripped by the caller), on the
    example's device and in its dtypes."""
    storage = {
        k: torch.zeros((capacity, *x.shape), dtype=x.dtype, device=x.device) for k, x in example.items()
    }
    return RingState(storage=storage, cursor=0, size=0)


def ring_spans(cursor: int, n: int, capacity: int) -> list[tuple[int, int, int]]:
    """The ``(dest_start, src_start, length)`` runs that write ``n`` rows at
    ``cursor`` with wrap-around: one run, or two when the write wraps.
    Together they cover positions ``(cursor + arange(n)) % capacity``."""
    if n > capacity:
        raise ValueError(f"cannot insert {n} rows into a ring of capacity {capacity} at once")
    first = min(n, capacity - cursor)
    spans = [(cursor, 0, first)]
    if n > first:
        spans.append((0, first, n - first))
    return spans


def ring_insert(state: RingState, batch: Mapping[str, torch.Tensor], capacity: int) -> RingState:
    """Insert a [N, ...] batch at the cursor with wrap-around (FIFO evict),
    in place, each leaf cast to the storage dtype (the reference's
    ``.at[idx].set(new.astype(buf.dtype))``, as one or two slice copies per
    leaf). N may not exceed the capacity."""
    check_insert_batch(batch, state.storage, name="ring_insert")
    n = next(iter(batch.values())).shape[0]
    for dst, src, length in ring_spans(state.cursor, n, capacity):
        for k, buf in state.storage.items():
            buf[dst : dst + length].copy_(batch[k][src : src + length])
    return RingState(
        storage=state.storage,
        cursor=(state.cursor + n) % capacity,
        size=min(state.size + n, capacity),
    )


def ring_gather(state: RingState, idx: torch.Tensor, impl: str = "xla") -> dict:
    """Gather transitions at ``idx`` -> {k: [n, ...]}.

    ``impl`` is ``algo.replay_gather``. Both values route by device: on
    CUDA tensors the gather kernel (``ops/replay_rows.py``, every leaf in
    one launch), on CPU tensors its plain version; the outputs are bit-equal
    either way."""
    if impl not in GATHER_IMPLS:
        raise ValueError(f"replay gather impl {impl!r} not in xla|pallas")
    return gather_rows(state.storage, idx)


def can_sample(size: int, start_sample_size: int) -> bool:
    """The reference's ``start_sample_condition`` (min fill before the
    learner may draw), decided on the host."""
    return size >= start_sample_size


def _device(state: RingState) -> torch.device:
    return next(iter(state.storage.values())).device


def ring_gauges(state: RingState, capacity: int) -> dict:
    """Occupancy gauges as device scalars (made by a fill, not copied from
    the host, so they add no host sync): absolute fill and fraction."""
    dev = _device(state)
    return {
        "replay/size": torch.full((), float(state.size), dtype=torch.float32, device=dev),
        "replay/fill": torch.full((), state.size / capacity, dtype=torch.float32, device=dev),
    }


def sample_age_frac(state: RingState, idx: torch.Tensor, capacity: int) -> torch.Tensor:
    """Mean staleness of a sampled index batch, as a fraction of the
    current fill: 0 = just written, ~1 = the oldest transitions held. Ring
    age is the distance behind the newest write, modulo wrap-around."""
    newest = (state.cursor - 1) % capacity
    age = torch.remainder(newest - idx, capacity)
    return age.to(torch.float32).mean() / max(float(state.size), 1.0)
