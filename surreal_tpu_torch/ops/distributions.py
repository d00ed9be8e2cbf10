"""Policy distributions as plain functions on parameter tensors, the port
of ``surreal_tpu/ops/distributions.py`` (all eight functions).

Shapes: ``mean``/``log_std``/``x`` are [..., act_dim]; reductions are over
the last axis, returning [...].

Sampling takes its randomness explicitly: either a ``torch.Generator`` or
the draws themselves (``noise``), so tests can feed the numbers JAX drew.
"""

from __future__ import annotations

import math

import torch

_LOG_2PI = math.log(2.0 * math.pi)


# -- diagonal Gaussian ------------------------------------------------------

def diag_gauss_sample(
    mean: torch.Tensor,
    log_std: torch.Tensor,
    generator: torch.Generator | None = None,
    noise: torch.Tensor | None = None,
) -> torch.Tensor:
    """``mean + exp(log_std) * noise`` with standard-normal ``noise``,
    drawn from ``generator`` unless given."""
    if noise is None:
        noise = torch.randn(
            mean.shape, generator=generator, dtype=mean.dtype, device=mean.device
        )
    elif noise.shape != mean.shape:
        raise ValueError(f"noise shape {tuple(noise.shape)} != mean shape {tuple(mean.shape)}")
    return mean + torch.exp(log_std) * noise.to(mean.dtype)


def diag_gauss_logp(mean: torch.Tensor, log_std: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    z = (x - mean) * torch.exp(-log_std)
    return -0.5 * torch.sum(z * z + 2.0 * log_std + _LOG_2PI, dim=-1)


def diag_gauss_entropy(log_std: torch.Tensor) -> torch.Tensor:
    return torch.sum(log_std + 0.5 * (_LOG_2PI + 1.0), dim=-1)


def diag_gauss_kl(
    mean_a: torch.Tensor, log_std_a: torch.Tensor, mean_b: torch.Tensor, log_std_b: torch.Tensor
) -> torch.Tensor:
    """KL(a || b) for diagonal Gaussians."""
    var_a = torch.exp(2.0 * log_std_a)
    var_b = torch.exp(2.0 * log_std_b)
    return torch.sum(
        log_std_b - log_std_a + (var_a + (mean_a - mean_b) ** 2) / (2.0 * var_b) - 0.5,
        dim=-1,
    )


# -- categorical ------------------------------------------------------------

def categorical_sample(
    logits: torch.Tensor,
    generator: torch.Generator | None = None,
    gumbel: torch.Tensor | None = None,
) -> torch.Tensor:
    """Gumbel-max sample (the method ``jax.random.categorical`` uses),
    with standard Gumbel draws from ``generator`` unless given."""
    if gumbel is None:
        u = torch.rand(logits.shape, generator=generator, dtype=logits.dtype, device=logits.device)
        gumbel = -torch.log(-torch.log(u.clamp_min(torch.finfo(logits.dtype).tiny)))
    return torch.argmax(logits + gumbel, dim=-1)


def categorical_logp(logits: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    logp_all = torch.log_softmax(logits, dim=-1)
    return torch.take_along_dim(logp_all, action[..., None].long(), dim=-1)[..., 0]


def categorical_entropy(logits: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def categorical_kl(logits_a: torch.Tensor, logits_b: torch.Tensor) -> torch.Tensor:
    logp_a = torch.log_softmax(logits_a, dim=-1)
    logp_b = torch.log_softmax(logits_b, dim=-1)
    return torch.sum(torch.exp(logp_a) * (logp_a - logp_b), dim=-1)
