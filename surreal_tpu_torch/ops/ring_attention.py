"""Single-device causal attention, the port of
``surreal_tpu/ops/ring_attention.py``'s ``full_attention`` and
``decode_attention``.

Layout [B, T, H, D] (batch, time, heads, head dim), as the reference's.
The numerics are the reference's, step for step:

- the scores contraction runs in the operands' dtype (bf16 under
  'mixed') and is then cast to float32 and scaled by 1/sqrt(D);
- masked scores are ``_NEG_BIG = -1e30``, not ``-inf`` (an all-masked row
  stays finite);
- the softmax and the value contraction run in float32, and the output is
  cast back to the query's dtype.

The JAX package computes attention in plain XLA, outside any Pallas
kernel, so this is plain torch too. ``scaled_dot_product_attention`` is
not used: it keeps the scores in the operands' dtype and fuses the
softmax, which rounds elsewhere than the reference does.

``ring_attention`` (the sequence-parallel form over a mesh axis) is not
ported yet.
"""

from __future__ import annotations

import torch

_NEG_BIG = -1e30  # mask value: -inf would propagate NaN through exp(m - m)


def _scale(D: int) -> float:
    # 1 / sqrt(D) as the reference computes it, in float32
    return float(torch.tensor(1.0, dtype=torch.float32) / torch.sqrt(torch.tensor(float(D), dtype=torch.float32)))


def full_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool = False) -> torch.Tensor:
    """Attention over the whole segment (softmax in f32), [B, T, H, D] ->
    [B, T, H, D] in q's dtype."""
    T, D = q.shape[1], q.shape[-1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q, k).to(torch.float32) * _scale(D)
    if causal:
        mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
        scores = torch.where(mask, scores, _NEG_BIG)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32)).to(q.dtype)


def decode_attention(q_t: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor, pos: int) -> torch.Tensor:
    """One position's causal attention against a K/V cache: q_t [B, H, D]
    (the query at position ``pos``, a host int), caches [B, T, H, D] whose
    positions after ``pos`` are masked (their contents may be stale).
    Returns [B, H, D] in q_t's dtype, with :func:`full_attention`'s
    numerics."""
    T, D = k_cache.shape[1], q_t.shape[-1]
    scores = torch.einsum("bhd,bkhd->bhk", q_t, k_cache).to(torch.float32) * _scale(D)
    mask = torch.arange(T, device=q_t.device) <= pos
    scores = torch.where(mask, scores, _NEG_BIG)
    p = torch.softmax(scores, dim=-1)
    return torch.einsum("bhk,bkhd->bhd", p, v_cache.to(torch.float32)).to(q_t.dtype)

