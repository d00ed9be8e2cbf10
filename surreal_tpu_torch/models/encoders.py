"""Network trunks, the port of ``surreal_tpu/models/encoders.py``
(``orthogonal_init``, ``MLP``, ``NatureCNN``, ``cnn_from_config``,
``make_trunk``), plus :class:`LayerNorm`, flax's ``nn.LayerNorm`` as it
computes.

Parameters are kept in float32 unless ``model.dtype`` names another
dtype (``make_trunk`` then casts the trunk's parameters; heads stay
float32, as in the reference); activations run in ``compute_dtype``.
Every layer casts its input AND its weight and bias to the compute dtype
explicitly, as flax ``Dense(dtype=...)`` and ``Conv(dtype=...)`` do, rather
than leaving it to ``torch.autocast``, whose op lists round at other places.
By default the bias is added inside the matmul or convolution (one
rounding to the compute dtype); with ``fused_bias=False`` it is added
after the product is rounded, as flax does (two roundings, one more
elementwise op). The trajectory transformer takes the latter: its
LayerNorms amplify a bf16 rounding flip past the models' 2e-2 bar.
Under the 'bf16_fp8' policy the trunks' dense layers (not the convolutions
and not the heads) take the fp8 path of ``ops/precision.py::fp8_linear``,
which is flax's Dense with the reference's ``fp8_dot_general``: the bias
goes after the rounded product there too.

Layout: pixel observations are NHWC ([..., H, W, C], what the envs emit and
what the reference's convolutions take) at every public function. The CNN
permutes to NCHW for ``conv2d`` and back to NHWC before the flatten, so the
dense layer sees features in the reference's (H, W, C) order and its weight
is the flax kernel transposed, like every other dense layer.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from surreal_tpu_torch.ops.precision import fp8_linear, torch_dtype

ACTIVATIONS: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "elu": F.elu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax nn.gelu's default
    "silu": F.silu,
}


def orthogonal_init(
    layer: nn.Linear | nn.Conv2d, scale: float = math.sqrt(2.0), generator: torch.Generator | None = None
) -> nn.Linear | nn.Conv2d:
    """Orthogonal weight with gain ``scale`` and a zero bias (flax's
    ``orthogonal(scale)`` kernel init with its default zero bias)."""
    nn.init.orthogonal_(layer.weight, gain=scale, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


def dense(
    x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype, fused_bias: bool = True, fp8: bool = False
) -> torch.Tensor:
    """``layer(x)`` computed in ``dtype``: input, weight and bias cast;
    ``fused_bias=False`` adds the bias after the product is rounded to
    ``dtype``, as flax's Dense does; ``fp8`` takes the product through
    :func:`fp8_linear` (the bias after it)."""
    if fp8:
        return fp8_linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)
    if fused_bias:
        return F.linear(x.to(dtype), layer.weight.to(dtype), layer.bias.to(dtype))
    return F.linear(x.to(dtype), layer.weight.to(dtype)) + layer.bias.to(dtype)


def uniform_init(layer: nn.Linear, scale: float, generator: torch.Generator | None = None) -> nn.Linear:
    """Weight uniform in [0, scale) and a zero bias (flax's
    ``initializers.uniform(scale)``, which draws from [0, scale), not
    +-scale)."""
    nn.init.uniform_(layer.weight, 0.0, scale, generator=generator)
    nn.init.zeros_(layer.bias)
    return layer


class LayerNorm(nn.Module):
    """flax ``nn.LayerNorm(dtype=compute_dtype)`` over the last axis, as
    flax 0.12 computes it rather than as ``F.layer_norm`` does: statistics
    in float32 whatever the input dtype; the variance by the fast formula
    ``max(0, E[x^2] - E[x]^2)``; epsilon 1e-6 (torch's default is 1e-5);
    ``y = (x - mean) * (rsqrt(var + eps) * scale) + bias`` in float32, then
    cast to the compute dtype. ``scale`` starts at ones, ``bias`` at zeros,
    both float32."""

    def __init__(self, features: int, compute_dtype: torch.dtype = torch.bfloat16, eps: float = 1e-6):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features))
        self.bias = nn.Parameter(torch.zeros(features))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(torch.float32)
        mean = x.mean(dim=-1, keepdim=True)
        mean2 = (x * x).mean(dim=-1, keepdim=True)
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        mul = torch.rsqrt(var + self.eps) * self.scale
        return ((x - mean) * mul + self.bias).to(self.compute_dtype)


class MLP(nn.Module):
    """Plain MLP trunk with orthogonal init (gain sqrt(2)), optionally with
    a :class:`LayerNorm` after each dense layer, before the activation;
    ``use_fp8`` puts every dense layer on the fp8 path."""

    def __init__(
        self,
        in_dim: int,
        hidden: Sequence[int],
        activation: str = "tanh",
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
        use_layer_norm: bool = False,
        use_fp8: bool = False,
    ):
        super().__init__()
        self.act = ACTIVATIONS[activation]
        self.compute_dtype = compute_dtype
        self.use_fp8 = use_fp8
        widths = [in_dim, *hidden]
        self.layers = nn.ModuleList(
            orthogonal_init(nn.Linear(a, b), generator=generator)
            for a, b in zip(widths[:-1], widths[1:])
        )
        self.norms = (
            nn.ModuleList(LayerNorm(b, compute_dtype) for b in widths[1:]) if use_layer_norm else None
        )
        self.out_dim = widths[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x.to(self.compute_dtype)
        for i, layer in enumerate(self.layers):
            x = dense(x, layer, self.compute_dtype, fp8=self.use_fp8)
            if self.norms is not None:
                x = self.norms[i](x)
            x = self.act(x)
        return x


class NatureCNN(nn.Module):
    """Nature-DQN conv stem for NHWC pixel observations: VALID convolutions
    with ReLU, then one dense layer with ReLU. uint8 input is scaled to
    [0, 1] and cast to the compute dtype, rounding as the reference does.
    ``fused_bias=False`` adds each bias after the rounded product (see the
    module doc); ``use_fp8`` puts the dense layer (not the convolutions)
    on the fp8 path, as the reference does."""

    def __init__(
        self,
        obs_shape: Sequence[int],
        channels: Sequence[int] = (32, 64, 64),
        kernels: Sequence[int] = (8, 4, 3),
        strides: Sequence[int] = (4, 2, 1),
        dense: int = 512,
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
        fused_bias: bool = True,
        use_fp8: bool = False,
    ):
        super().__init__()
        h, w, c = obs_shape
        self.compute_dtype = compute_dtype
        self.fused_bias = fused_bias
        self.use_fp8 = use_fp8
        self.strides = tuple(strides)
        convs = []
        for ch, k, s in zip(channels, kernels, strides):
            convs.append(orthogonal_init(nn.Conv2d(c, ch, k, stride=s), generator=generator))
            h, w, c = (h - k) // s + 1, (w - k) // s + 1, ch
            if h < 1 or w < 1:
                raise ValueError(f"obs {tuple(obs_shape)} is too small for the conv stack")
        self.convs = nn.ModuleList(convs)
        self.dense = orthogonal_init(nn.Linear(h * w * c, dense), generator=generator)
        self.out_dim = dense

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cd = self.compute_dtype
        lead = x.shape[:-3]
        if x.dtype == torch.uint8:
            # x.astype(cd) / 255 as XLA computes it under jit: a float32
            # multiply by the reciprocal, then rounded to the compute dtype
            x = (x.to(torch.float32) * (1.0 / 255.0)).to(cd)
        else:
            x = x.to(cd)
        x = x.reshape(-1, *x.shape[-3:]).permute(0, 3, 1, 2)  # NHWC -> NCHW
        for conv, s in zip(self.convs, self.strides):
            if self.fused_bias:
                x = F.conv2d(x, conv.weight.to(cd), conv.bias.to(cd), stride=s)
            else:
                x = F.conv2d(x, conv.weight.to(cd), stride=s) + conv.bias.to(cd)[:, None, None]
            x = F.relu(x)
        x = x.permute(0, 2, 3, 1).reshape(*lead, -1)  # flatten in (H, W, C) order
        return F.relu(dense(x, self.dense, cd, self.fused_bias, self.use_fp8))


def cnn_from_config(
    cnn_cfg,
    obs_shape: Sequence[int],
    compute_dtype: torch.dtype,
    generator: torch.Generator | None = None,
    fused_bias: bool = True,
    use_fp8: bool = False,
) -> NatureCNN:
    """NatureCNN from a ``model.cnn`` subtree."""
    return NatureCNN(
        obs_shape,
        channels=tuple(cnn_cfg["channels"]),
        kernels=tuple(cnn_cfg["kernels"]),
        strides=tuple(cnn_cfg["strides"]),
        dense=cnn_cfg["dense"],
        compute_dtype=compute_dtype,
        generator=generator,
        fused_bias=fused_bias,
        use_fp8=use_fp8,
    )


def make_trunk(
    model_cfg,
    obs_shape: Sequence[int],
    hidden: Sequence[int],
    generator: torch.Generator | None = None,
) -> MLP | NatureCNN:
    """Build the obs trunk from a materialized ``learner_config.model``
    subtree (dtypes and the fp8 flag already resolved by the precision
    policy): the CNN stem for pixel obs ([H, W, C]), an MLP for state obs
    otherwise. Its parameters are cast to ``model.dtype`` (flax's
    ``param_dtype``), after a float32 draw."""
    compute_dtype = torch_dtype(model_cfg["compute_dtype"])
    use_fp8 = bool(model_cfg.get("fp8", False))
    if model_cfg["cnn"]["enabled"]:
        trunk = cnn_from_config(model_cfg["cnn"], obs_shape, compute_dtype, generator, use_fp8=use_fp8)
    else:
        trunk = MLP(
            math.prod(obs_shape),
            hidden=tuple(hidden),
            activation=model_cfg["activation"],
            compute_dtype=compute_dtype,
            generator=generator,
            use_fp8=use_fp8,
        )
    return trunk.to(torch_dtype(model_cfg["dtype"]))
