"""Network trunks, the port of ``surreal_tpu/models/encoders.py``
(``orthogonal_init``, ``MLP``, ``make_trunk``).

Parameters are kept in float32; activations run in ``compute_dtype``.
Every layer casts its input AND its weight and bias to the compute dtype
explicitly, as flax ``Dense(dtype=...)`` does, rather than leaving it to
``torch.autocast``, whose op lists round at other places. The Nature-CNN
stem for pixel observations is not ported yet.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from surreal_tpu_torch.ops.precision import torch_dtype

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu's default
    "silu": F.silu,
}


def orthogonal_init(
    layer: nn.Linear, scale: float = math.sqrt(2.0), generator: torch.Generator | None = None
) -> nn.Linear:
    """Orthogonal weight with gain ``scale`` and a zero bias (flax's
    ``orthogonal(scale)`` kernel init with its default zero bias)."""
    nn.init.orthogonal_(layer.weight, gain=scale, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype``: input, weight and bias cast."""
    return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))


class MLP(nn.Module):
    """Plain MLP trunk with orthogonal init (gain sqrt(2))."""

    def __init__(
        self,
        in_dim: int,
        hidden: Sequence[int],
        activation: str = "tanh",
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.compute_dtype = compute_dtype
        widths = [in_dim, *hidden]
        self.layers = nn.ModuleList(
            orthogonal_init(nn.Linear(a, b), generator=generator)
            for a, b in zip(widths[:-1], widths[1:])
        )
        self.out_dim = widths[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        for layer in self.layers:
            x = self.act(dense(x, layer, self.compute_dtype))
        return x


def make_trunk(
    model_cfg, in_dim: int, hidden: Sequence[int], generator: torch.Generator | None = None
) -> MLP:
    """Build the obs trunk from a materialized ``learner_config.model``
    subtree (dtypes already resolved by the precision policy)."""
    if model_cfg["cnn"]["enabled"]:
        raise NotImplementedError("the Nature-CNN stem is not ported to PyTorch yet")
    if torch_dtype(model_cfg["dtype"]) != torch.float32:
        raise NotImplementedError("the port keeps parameters in float32 only")
    return MLP(
        in_dim,
        hidden=tuple(hidden),
        activation=model_cfg["activation"],
        compute_dtype=torch_dtype(model_cfg["compute_dtype"]),
        generator=generator,
    )
