"""How the reverse-time scan kernels (``csrc/gae.cu``, ``csrc/vtrace.cu``,
``csrc/rev_scan.cu``) cut a [T, B] problem: the column tile a block owns
and the timesteps a stage of its shared-memory ring holds
(``csrc/scan_ring.cuh``).

The choice is made here, in Python, so that the CPU tests can hold it;
the kernels take it as two ints.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

RING_STAGES = 8            # csrc/scan_ring.cuh kStages
TILES = (32, 16, 8)        # columns a block, widest first: 128, 64 or 32 B of a row
STAGE_BYTES = 5 * 1024     # shared memory a stage may take, every input array together
# the reverse scan's (csrc/rev_scan.cu) stage budget: its two arrays at
# [256, 4096] in stages of 32 timesteps, the whole T in the ring, took
# 11.7 us on an H100 against 12.6 us in 5 KB stages of 20 (PERF.md)
REV_SCAN_STAGE_BYTES = 8 * 1024
SLAB_BYTES = 16 * 1024     # a tile's whole [T, tile] slab up to this size is one stage


class ScanPlan(NamedTuple):
    tile: int   # batch columns a block owns
    steps: int  # timesteps a ring stage holds

    def shared_bytes(self, T: int, arrays: int) -> int:
        """The ring's dynamic shared memory at T timesteps of ``arrays``
        f32 inputs: a slot per stage, RING_STAGES at most."""
        return 4 * min(-(-T // self.steps), RING_STAGES) * arrays * self.steps * self.tile


def scan_plan(T: int, B: int, arrays: int, sms: int, stage_bytes: int = STAGE_BYTES) -> ScanPlan:
    """The tile and stage length for a [T, B] scan over ``arrays`` f32
    inputs on a card with ``sms`` multiprocessors.

    Tile: the widest whose blocks number at least half the SMs, so that
    the card is filled (GAE at [256, 4096]: 32 columns, 128 blocks on
    132 SMs), else the narrowest (V-trace at [32, 1024]: 8 columns, 128
    blocks). Stage: the whole T where the tile's slab of every input fits
    SLAB_BYTES (V-trace at [32, 1024]: 8 KB, one round trip and one
    hand-over); else as many timesteps as fit ``stage_bytes``, but no more
    than an eighth of T, so that all of a short T is requested before the
    chain starts (GAE at [256, 4096]: 8; the reverse scan there, with
    REV_SCAN_STAGE_BYTES: 32). Then rounded up to a whole 128 B of each
    array, where a TMA copy of the stage must land.
    """
    if T < 1 or B < 1 or arrays < 1 or sms < 1:
        raise ValueError(f"no scan plan for T={T}, B={B}, arrays={arrays}, sms={sms}")
    tile = next((w for w in TILES if -(-B // w) * 2 >= sms), TILES[-1])
    if 4 * arrays * tile * T <= SLAB_BYTES:
        steps = T
    else:
        steps = max(1, min(-(-T // RING_STAGES), stage_bytes // (4 * arrays * tile)))
    align = 32 // tile
    return ScanPlan(tile, -(-steps // align) * align)


@functools.cache
def multiprocessors(device: torch.device) -> int:
    """The SM count of a CUDA device, read once."""
    return torch.cuda.get_device_properties(device).multi_processor_count
