"""DDPG actor and critic, the port of ``surreal_tpu/models/ddpg_net.py``
(``DDPGActor``, ``DDPGCritic``): a deterministic tanh actor, and a critic
that sees the action concatenated after its first obs layer, with a
flax-exact LayerNorm after each hidden layer.

Parameters are float32, except the trunks' under ``model.dtype`` (the
actor's trunk, and the critic's CNN stem for pixel obs): the reference
pins every other layer to ``param_dtype=float32``, the actor's head
included. Layers compute in ``compute_dtype`` with explicit casts (see
``models/encoders.py``). Under 'bf16_fp8' the trunks' dense layers and
the critic's hidden layers take the fp8 path; the heads do not. Both
heads start uniform in [0, 3e-3) with a zero bias, as flax's
``uniform(scale=3e-3)`` draws them.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch
from torch import nn

from surreal_tpu_torch.models.encoders import (
    ACTIVATIONS,
    LayerNorm,
    dense,
    make_trunk,
    orthogonal_init,
    uniform_init,
)
from surreal_tpu_torch.ops.precision import torch_dtype

HEAD_INIT_SCALE = 3e-3


class DDPGActor(nn.Module):
    """Deterministic policy: obs -> tanh-squashed action in [-1, 1]^act_dim.
    The trunk is ``make_trunk``'s (an MLP of ``actor_hidden``, or the CNN
    stem for pixel obs); the head computes in the trunk's output dtype and
    is cast to float32 before the tanh."""

    def __init__(
        self, model_cfg, obs_shape: Sequence[int], act_dim: int, generator: torch.Generator | None = None
    ):
        super().__init__()
        self.trunk = make_trunk(model_cfg, obs_shape, model_cfg["actor_hidden"], generator)
        self.head = uniform_init(nn.Linear(self.trunk.out_dim, act_dim), HEAD_INIT_SCALE, generator)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        h = self.trunk(obs)
        return torch.tanh(dense(h, self.head, h.dtype).to(torch.float32))


class DDPGCritic(nn.Module):
    """Q(s, a) -> [...] float32. State obs: the first dense layer (with its
    LayerNorm and activation) sees obs only, the action is concatenated
    before the second. Pixel obs (``cnn.enabled``): the CNN stem first, the
    action concatenated to its features, then every ``critic_hidden``
    layer. A dense head of width 1 closes both."""

    def __init__(
        self,
        model_cfg,
        obs_shape: Sequence[int],
        act_dim: int,
        use_layer_norm: bool = True,
        generator: torch.Generator | None = None,
    ):
        super().__init__()
        cd = torch_dtype(model_cfg["compute_dtype"])
        self.compute_dtype = cd
        self.use_fp8 = bool(model_cfg.get("fp8", False))
        self.act = ACTIVATIONS[model_cfg["activation"]]
        hidden = tuple(model_cfg["critic_hidden"])
        if model_cfg["cnn"]["enabled"]:
            self.trunk = make_trunk(model_cfg, obs_shape, hidden, generator)
            widths_in = [self.trunk.out_dim + act_dim, *hidden[:-1]]
            self.concat_at = 0  # the action joins before layers[0]
        else:
            self.trunk = None
            widths_in = [math.prod(obs_shape), hidden[0] + act_dim, *hidden[1:-1]]
            self.concat_at = 1  # ... before layers[1], after the first obs layer
        self.layers = nn.ModuleList(
            orthogonal_init(nn.Linear(a, b), generator=generator) for a, b in zip(widths_in, hidden)
        )
        self.norms = nn.ModuleList(LayerNorm(b, cd) for b in hidden) if use_layer_norm else None
        # with one state-obs layer, the head sees [features, action]
        q_in = hidden[-1] + (act_dim if self.concat_at == len(hidden) else 0)
        self.q_head = uniform_init(nn.Linear(q_in, 1), HEAD_INIT_SCALE, generator)

    def _block(self, i: int, h: torch.Tensor) -> torch.Tensor:
        h = dense(h, self.layers[i], self.compute_dtype, fp8=self.use_fp8)
        if self.norms is not None:
            h = self.norms[i](h)
        return self.act(h)

    def forward(self, obs: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
        if self.trunk is not None:
            h = self.trunk(obs)
        else:
            h = self._block(0, obs.to(self.compute_dtype))
        h = torch.cat([h, action.to(h.dtype)], dim=-1)
        for i in range(self.concat_at, len(self.layers)):
            h = self._block(i, h)
        q = dense(h, self.q_head, self.compute_dtype).to(torch.float32)
        return q[..., 0]
