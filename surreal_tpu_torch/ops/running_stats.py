"""Running observation normalizer (the reference's ZFilter), the port of
``surreal_tpu/ops/running_stats.py``: Chan's parallel variance merge with
an exact int32 sample count that saturates at ``_COUNT_CAP``.

At the cap the prior (count, m2) pair is rescaled so that count + batch
stays exactly at the cap: the update becomes an exponential moving
estimate with horizon ``_COUNT_CAP`` while variance = m2/count stays
consistent. The cross-replica (``axis_name``) merge is not ported yet.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

_COUNT_CAP = 2_000_000_000


class RunningStats(NamedTuple):
    count: torch.Tensor  # scalar int32 sample count (saturates at _COUNT_CAP)
    mean: torch.Tensor   # [obs_dim...]
    m2: torch.Tensor     # [obs_dim...] sum of squared deviations


def init_stats(
    obs_shape: tuple[int, ...], device: torch.device | str, dtype=torch.float32
) -> RunningStats:
    return RunningStats(
        count=torch.zeros((), dtype=torch.int32, device=device),
        mean=torch.zeros(obs_shape, dtype=dtype, device=device),
        m2=torch.zeros(obs_shape, dtype=dtype, device=device),
    )


def _fcount(count: torch.Tensor) -> torch.Tensor:
    """Count as float for ratio math, guarded against the pre-update zero."""
    return torch.clamp_min(count, 1).to(torch.float32)


def _clamped_total(a: torch.Tensor, b: torch.Tensor, raw_tot_f: torch.Tensor) -> torch.Tensor:
    """``min(a + b, _COUNT_CAP)`` that cannot wrap: the float sum flags the
    far-over-cap case where the int32 add itself would overflow."""
    return torch.where(
        raw_tot_f > 2_100_000_000.0,
        torch.full_like(a, _COUNT_CAP),
        torch.clamp_max(a + b, _COUNT_CAP),
    )


def _rescale_at_cap(cf: torch.Tensor, bf: torch.Tensor) -> torch.Tensor:
    return torch.where(
        cf + bf > _COUNT_CAP,
        torch.clamp_min(_COUNT_CAP - bf, 0.0) / torch.clamp_min(cf, 1.0),
        torch.ones_like(cf),
    )


def update_stats(stats: RunningStats, batch: torch.Tensor) -> RunningStats:
    """Fold a batch [..., obs_dim...] into the stats (leading axes reduced)."""
    reduce_dims = tuple(range(batch.dim() - stats.mean.dim()))
    batch = batch.to(stats.mean.dtype)
    n = math.prod(batch.shape[i] for i in reduce_dims) if reduce_dims else 1
    b_count = torch.full((), n, dtype=torch.int32, device=batch.device)
    if reduce_dims:
        b_mean = batch.mean(dim=reduce_dims)
        b_m2 = ((batch - b_mean) ** 2).sum(dim=reduce_dims)
    else:
        b_mean, b_m2 = batch, torch.zeros_like(batch)
    delta = b_mean - stats.mean
    # cf stays a true 0 on the first fold (zeroes the delta^2 cross term)
    cf = stats.count.to(torch.float32)
    bf = b_count.to(torch.float32)
    raw_tot = cf + bf
    scale = _rescale_at_cap(cf, bf)
    cf = cf * scale
    m2 = stats.m2 * scale
    tot = _clamped_total(stats.count, b_count, raw_tot)
    tf = tot.to(torch.float32)
    new_mean = stats.mean + delta * (bf / tf)
    new_m2 = m2 + b_m2 + delta**2 * (cf * (bf / tf))
    return RunningStats(count=tot, mean=new_mean, m2=new_m2)


def merge_stats(a: RunningStats, b: RunningStats) -> RunningStats:
    """Merge two independent stats; at the cap ``a`` is rescaled the same
    way as in :func:`update_stats`."""
    af = a.count.to(torch.float32)
    bf = b.count.to(torch.float32)
    scale = _rescale_at_cap(af, bf)
    raw_tot = af + bf
    af = af * scale
    a_m2 = a.m2 * scale
    tot = _clamped_total(a.count, b.count, raw_tot)
    tf = _fcount(tot)
    delta = b.mean - a.mean
    return RunningStats(
        count=tot,
        mean=a.mean + delta * (bf / tf),
        m2=a_m2 + b.m2 + delta**2 * (af * (bf / tf)),
    )


def normalize(stats: RunningStats, x: torch.Tensor, clip: float = 5.0) -> torch.Tensor:
    std = torch.sqrt(stats.m2 / _fcount(stats.count) + 1e-8)
    return torch.clamp((x - stats.mean) / std, -clip, clip).to(x.dtype)


def variance(stats: RunningStats) -> torch.Tensor:
    return stats.m2 / _fcount(stats.count)
