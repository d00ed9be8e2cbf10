"""Return / advantage estimators, the port of ``surreal_tpu/ops/returns.py``.

- :func:`gae_advantages` is the fused GAE of ``ops/gae.py`` under the
  simple contract: the CUDA kernel for CUDA tensors, the plain reverse
  loop (``gae_masked_plain``) for CPU tensors.
- :func:`discounted_returns` is the reverse linear scan of
  ``ops/rev_scan.py`` seeded with the bootstrap value: the CUDA kernel for
  CUDA tensors, the plain reverse loop for CPU tensors.
- :func:`n_step_returns` is plain tensor code.

``reverse_linear_scan_assoc`` and ``gae_advantages_assoc`` are not ported
yet.

Conventions (all time-major): arrays are [T, B]; ``discounts[t]`` =
gamma * (1 - done[t]); ``values`` is [T+1, B] with the bootstrap value
at index T. GAE returns (advantages, value_targets), both float32 [T, B].
"""

from __future__ import annotations

import torch

from surreal_tpu_torch.ops.gae import gae_advantages
from surreal_tpu_torch.ops.rev_scan import discounted_returns


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


__all__ = ["discounted_returns", "gae_advantages", "n_step_returns"]
