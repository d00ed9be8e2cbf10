"""Return / advantage estimators, the port of ``surreal_tpu/ops/returns.py``.

Every function keeps the reference's contract:

- arrays are time-major [T, ...] of any rank >= 1 (batch dims after T);
  ``values`` is [T+1, ...] with the bootstrap value at index T, and
  ``discounts[t]`` = gamma * (1 - done[t]);
- ``unroll``, where the reference takes it, is accepted and ignored: it
  unrolls the reference's ``lax.scan`` and does not change the math;
- the result has the reference's dtype (bf16 in gives bf16 out).

Inside, the batch dims are folded into one column axis around the [T, B]
float32 kernels ([T] becomes [T, 1], [T, B, K] becomes [T, B*K]) and
unfolded after; the recurrences run in float32, and the result is cast to
the reference's dtype at the end. So for bf16 inputs the port rounds once
where the reference's bf16 scan rounds at every step.

- :func:`gae_advantages` is the fused GAE of ``ops/gae.py``: the CUDA
  kernel for CUDA tensors, the plain reverse loop for CPU tensors.
- :func:`discounted_returns` is the reverse linear scan of
  ``ops/rev_scan.py`` seeded with the bootstrap value.
- :func:`reverse_linear_scan_assoc` and :func:`gae_advantages_assoc` are
  the 'assoc' forms. The reference solves the recurrence with
  ``lax.associative_scan`` in log depth; the port solves the same
  recurrence with the scan of ``ops/rev_scan.py``, which on the card is
  one launch whatever T, and on the CPU the plain loop, so that the card
  and the CPU agree bit for bit. The two reassociate the sum differently
  and agree to rounding (1e-5 at T <= 64, ``tests/test_torch_returns.py``).
- :func:`n_step_returns` is plain tensor code.
"""

from __future__ import annotations

import functools
import math

import torch

from surreal_tpu_torch.ops.gae import gae_advantages_masked
from surreal_tpu_torch.ops.rev_scan import reverse_linear_scan


def result_dtype(*xs: torch.Tensor) -> torch.dtype:
    """The dtype the reference's arithmetic on ``xs`` gives: their promoted
    type, or float32 where that is not a floating type."""
    dtype = functools.reduce(torch.promote_types, (x.dtype for x in xs))
    return dtype if dtype.is_floating_point else torch.float32


def as_columns(x: torch.Tensor) -> torch.Tensor:
    """[T, ...] as float32 [T, N], every batch dim folded into one axis."""
    return x.to(torch.float32).reshape(x.shape[0], math.prod(x.shape[1:]))


def check_time_major(name: str, shape: torch.Size, *xs: torch.Tensor) -> None:
    """Raises unless ``shape`` has a time axis and every one of ``xs`` has
    ``shape``."""
    if len(shape) < 1:
        raise ValueError(f"{name} inputs must be [T, ...]; got a scalar")
    for x in xs:
        if x.shape != shape:
            raise ValueError(f"{name} inputs disagree in shape: {tuple(x.shape)} vs {tuple(shape)}")


def check_values(name: str, shape: torch.Size, values: torch.Tensor) -> None:
    """Raises unless ``values`` is the [T+1, ...] stack for inputs of ``shape``."""
    if values.shape != (shape[0] + 1, *shape[1:]):
        raise ValueError(f"{name}: values of shape {tuple(values.shape)} must be [T+1, ...] for inputs {tuple(shape)}")


def gae_advantages(
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    values: torch.Tensor,
    lam: float,
    unroll: int = 1,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Generalized Advantage Estimation (rewards, discounts [T, ...];
    values [T+1, ...]). Returns (advantages, value_targets) [T, ...],
    targets = advantages + values[:-1], in the reference's dtype."""
    del unroll  # a lax.scan unroll in the reference; the math is the same
    shape = rewards.shape
    check_time_major("GAE", shape, discounts)
    check_values("GAE", shape, values)
    dtype = result_dtype(rewards, discounts, values)
    r, d, v = as_columns(rewards), as_columns(discounts), as_columns(values)
    adv, target = gae_advantages_masked(r, d, d * lam, v[:-1], v[1:])
    return adv.reshape(shape).to(dtype), target.reshape(shape).to(dtype)


def discounted_returns(
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    bootstrap_value: torch.Tensor,
    unroll: int = 1,
) -> torch.Tensor:
    """Monte-Carlo discounted returns with bootstrap (rewards, discounts
    [T, ...]; bootstrap [...]): ``ret_t = r_t + d_t * ret_{t+1}``, ``ret_T =
    bootstrap``, i.e. the scan seeded with the bootstrap value."""
    del unroll  # a lax.scan unroll in the reference; the math is the same
    shape = rewards.shape
    check_time_major("discounted_returns", shape, discounts)
    if bootstrap_value.shape != shape[1:]:
        raise ValueError(f"bootstrap {tuple(bootstrap_value.shape)} does not fit rewards {tuple(shape)}")
    dtype = result_dtype(rewards, discounts, bootstrap_value)
    init = bootstrap_value.to(torch.float32).reshape(-1)
    return reverse_linear_scan(as_columns(discounts), as_columns(rewards), init).reshape(shape).to(dtype)


def reverse_linear_scan_assoc(coeffs: torch.Tensor, deltas: torch.Tensor) -> torch.Tensor:
    """Solve ``x_t = deltas_t + coeffs_t * x_{t+1}`` (x_T = 0) over [T, ...]
    arrays: the 'assoc' recurrence of GAE and V-trace. Launches
    ``csrc/rev_scan.cu`` for CUDA tensors and runs the plain loop for CPU
    tensors; the result has the reference's dtype."""
    shape = deltas.shape
    check_time_major("reverse_linear_scan_assoc", shape, coeffs)
    dtype = result_dtype(coeffs, deltas)
    return reverse_linear_scan(as_columns(coeffs), as_columns(deltas)).reshape(shape).to(dtype)


def gae_advantages_assoc(
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    values: torch.Tensor,
    lam: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """GAE through :func:`reverse_linear_scan_assoc`, the reference's
    expressions; the contract of :func:`gae_advantages`."""
    shape = rewards.shape
    check_time_major("GAE", shape, discounts)
    check_values("GAE", shape, values)
    dtype = result_dtype(rewards, discounts, values)
    r, d, v = (x.to(torch.float32) for x in (rewards, discounts, values))
    deltas = r + d * v[1:] - v[:-1]
    advantages = reverse_linear_scan_assoc(d * lam, deltas)
    return advantages.to(dtype), (advantages + v[:-1]).to(dtype)


def n_step_returns(
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    bootstrap_values: torch.Tensor,
    n_step: int,
) -> torch.Tensor:
    """n-step bootstrapped TD targets over [T, ...] arrays:
    ``G_t = r_t + d_t r_{t+1} + ... + (prod d) * V(s_{t+n})``, truncated at
    episode ends (discount 0) and at the trajectory end (zero padding past
    T). ``bootstrap_values[t]`` is V(s_{t+1}). The reference's window sum,
    step for step."""
    if n_step == 1:
        return rewards + discounts * bootstrap_values
    T = rewards.shape[0]

    def pad(x):
        return torch.cat([x, torch.zeros((n_step, *x.shape[1:]), dtype=x.dtype, device=x.device)])

    r, d, v = pad(rewards), pad(discounts), pad(bootstrap_values)
    g = torch.zeros_like(rewards)
    disc = torch.ones_like(discounts)
    for k in range(n_step):
        g = g + disc * r[k : k + T]
        disc = disc * d[k : k + T]
    return g + disc * v[n_step - 1 : n_step - 1 + T]


__all__ = [
    "discounted_returns",
    "gae_advantages",
    "gae_advantages_assoc",
    "n_step_returns",
    "reverse_linear_scan_assoc",
]
