"""Trajectory transformer policies, the port of
``surreal_tpu/models/attention.py`` (``CausalSelfAttention``,
``TrajectoryEncoder``, ``TrajectoryPPOModel``,
``TrajectoryCategoricalPPOModel``) on one device.

A small pre-LN causal transformer encodes a trajectory [B, T, obs] into
[B, T, features]; policy and value heads read every position. With
``cnn_cfg`` set (pixel trajectories, obs [B, T, H, W, C] uint8) a
NatureCNN stem embeds each frame before the embed layer. Every position
sees only its own prefix, so the learner's whole-segment pass reproduces
what acting saw step by step.

Two call forms share one parameter tree:

- full: ``model(obs_seq)`` over [B, T, ...] -> outputs with [B, T] lead;
- decode: ``model(obs_t, cache=cache, pos=pos)`` for one position [B, ...]
  against per-layer K/V caches ({'k', 'v'} of [B, T, H, D]) -> (outputs
  with [B] lead, cache). ``pos`` is a host int; the caches are written in
  place at ``pos`` (the carry that owns them is made fresh for each
  rollout), and their later positions are masked.

Numerics follow flax's: every Dense and DenseGeneral casts input, kernel
and bias to the compute dtype and adds the bias after the product is
rounded (``dense(..., fused_bias=False)``, the CNN stem too); the
per-layer LayerNorms (``models/encoders.py::LayerNorm``, flax's formula)
output the compute
dtype while ``ln_f`` outputs float32; ``nn.gelu`` is the tanh
approximation; the heads run in float32 on ``ln_f``'s output. Attention is
``ops/ring_attention.py``'s single-device form; the sequence-parallel ring
(``mesh`` not None) is not ported yet and raises.

Parameter names mirror the flax tree (``trunk.attn0.q.weight`` for
``trunk/attn0/q/kernel``); ``utils/convert.py::trajectory_params_from_jax``
maps one onto the other.
"""

from __future__ import annotations

from typing import Any, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from surreal_tpu_torch.models.encoders import LayerNorm, cnn_from_config, orthogonal_init
from surreal_tpu_torch.models.encoders import dense as _dense
from surreal_tpu_torch.models.ppo_net import CategoricalOutput, PolicyOutput
from surreal_tpu_torch.ops.ring_attention import decode_attention, full_attention


def dense(x: torch.Tensor, layer: nn.Linear, dtype: torch.dtype) -> torch.Tensor:
    """flax's Dense in ``dtype``: the bias added to the rounded product."""
    return _dense(x, layer, dtype, fused_bias=False)


def _no_mesh(mesh) -> None:
    if mesh is not None:
        raise NotImplementedError("ring attention over a mesh (model mesh=...) is not ported to PyTorch yet")


class CausalSelfAttention(nn.Module):
    """Multi-head causal self-attention on one device: q, k, v
    projections E -> (H, D), the output projection H*D -> E."""

    def __init__(
        self,
        features: int,
        num_heads: int = 4,
        head_dim: int = 16,
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
        mesh: Any = None,
    ):
        super().__init__()
        _no_mesh(mesh)
        self.num_heads, self.head_dim = num_heads, head_dim
        self.compute_dtype = compute_dtype
        for name in ("q", "k", "v"):
            setattr(self, name, orthogonal_init(nn.Linear(features, num_heads * head_dim), 1.0, generator))
        self.o = orthogonal_init(nn.Linear(num_heads * head_dim, features), 1.0, generator)

    def _proj(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return dense(x, layer, self.compute_dtype).unflatten(-1, (self.num_heads, self.head_dim))

    def forward(self, x: torch.Tensor, cache: dict | None = None, pos: int | None = None):
        """Full: x [B, T, E] -> [B, T, E]. Decode: x [B, E] at ``pos`` ->
        ([B, E], cache with this position's K/V written)."""
        cd = self.compute_dtype
        q, k, v = self._proj(self.q, x), self._proj(self.k, x), self._proj(self.v, x)
        if cache is not None:
            cache["k"][:, pos] = k.to(cache["k"].dtype)
            cache["v"][:, pos] = v.to(cache["v"].dtype)
            out = decode_attention(q, cache["k"], cache["v"], pos)  # [B, H, D]
            return dense(out.flatten(-2), self.o, cd), cache
        out = full_attention(q, k, v, causal=True)
        return dense(out.flatten(-2), self.o, cd)


class TrajectoryEncoder(nn.Module):
    """Pre-LN causal transformer over a trajectory: [B, T, obs] ->
    [B, T, features] (float32)."""

    def __init__(
        self,
        obs_shape: Sequence[int],
        features: int = 64,
        num_layers: int = 2,
        num_heads: int = 4,
        head_dim: int = 16,
        max_len: int = 4096,
        cnn_cfg: dict | None = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
        mesh: Any = None,
    ):
        super().__init__()
        _no_mesh(mesh)
        self.num_layers = num_layers
        self.compute_dtype = compute_dtype
        if cnn_cfg:
            self.cnn_stem = cnn_from_config(cnn_cfg, obs_shape, compute_dtype, generator, fused_bias=False)
            in_dim = self.cnn_stem.out_dim
        else:
            (in_dim,) = obs_shape
        self.embed = orthogonal_init(nn.Linear(in_dim, features), 1.0, generator)
        self.pos_embed = nn.Parameter(torch.empty(max_len, features))
        nn.init.normal_(self.pos_embed, 0.0, 0.02, generator=generator)
        for i in range(num_layers):
            setattr(self, f"ln_a{i}", LayerNorm(features, compute_dtype))
            setattr(self, f"attn{i}", CausalSelfAttention(features, num_heads, head_dim, compute_dtype, generator))
            setattr(self, f"ln_m{i}", LayerNorm(features, compute_dtype))
            setattr(self, f"mlp_in{i}", orthogonal_init(nn.Linear(features, 4 * features), 1.0, generator))
            setattr(self, f"mlp_out{i}", orthogonal_init(nn.Linear(4 * features, features), 1.0, generator))
        self.ln_f = LayerNorm(features, torch.float32)

    def forward(self, obs: torch.Tensor, cache: list | None = None, pos: int | None = None):
        """Full: [B, T, obs] -> [B, T, features]. Decode (``cache`` a
        per-layer list of K/V dicts): obs [B, obs] at ``pos`` ->
        ([B, features], cache)."""
        cd = self.compute_dtype
        if hasattr(self, "cnn_stem"):
            obs = self.cnn_stem(obs)  # [..., H, W, C] -> [..., dense], per position
        x = dense(obs.to(cd), self.embed, cd)
        if cache is not None:
            x = x + self.pos_embed[pos].to(cd)
        else:
            x = x + self.pos_embed[: obs.shape[1]].to(cd)
        for i in range(self.num_layers):
            h = getattr(self, f"ln_a{i}")(x)
            attn = getattr(self, f"attn{i}")
            if cache is not None:
                a, cache[i] = attn(h, cache=cache[i], pos=pos)
            else:
                a = attn(h)
            x = x + a
            h = getattr(self, f"ln_m{i}")(x)
            h = F.gelu(dense(h, getattr(self, f"mlp_in{i}"), cd), approximate="tanh")  # flax nn.gelu
            x = x + dense(h, getattr(self, f"mlp_out{i}"), cd)
        # heads downstream do numerically delicate work in f32
        out = self.ln_f(x.to(torch.float32))
        return (out, cache) if cache is not None else out


def _obs_dtype(obs: torch.Tensor) -> torch.Tensor:
    """The trajectory models' obs-dtype rule: uint8 pixels stay uint8 into
    the CNN stem (which scales them by 1/255), all else runs in float32."""
    return obs if obs.dtype == torch.uint8 else obs.to(torch.float32)


def _trunk(obs_shape, encoder_cfg: dict, cnn_cfg, compute_dtype, generator, mesh) -> TrajectoryEncoder:
    return TrajectoryEncoder(
        obs_shape,
        features=int(encoder_cfg["features"]), num_layers=int(encoder_cfg["num_layers"]),
        num_heads=int(encoder_cfg["num_heads"]), head_dim=int(encoder_cfg["head_dim"]),
        max_len=int(encoder_cfg.get("max_len", 4096)), cnn_cfg=cnn_cfg,
        compute_dtype=compute_dtype, generator=generator, mesh=mesh,
    )


class TrajectoryPPOModel(nn.Module):
    """Sequence actor-critic with a diagonal-Gaussian head: [B, T, obs] ->
    :class:`PolicyOutput` with [B, T] lead; selected by
    ``learner_config.model.encoder.kind='trajectory'`` on continuous
    actions."""

    def __init__(
        self,
        encoder_cfg: dict,
        obs_shape: Sequence[int],
        act_dim: int,
        init_log_std: float = -0.5,
        cnn_cfg: dict | None = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
        mesh: Any = None,
    ):
        super().__init__()
        self.trunk = _trunk(obs_shape, encoder_cfg, cnn_cfg, compute_dtype, generator, mesh)
        features = int(encoder_cfg["features"])
        self.mean = orthogonal_init(nn.Linear(features, act_dim), 0.01, generator)
        self.log_std = nn.Parameter(torch.full((act_dim,), float(init_log_std)))
        self.value = orthogonal_init(nn.Linear(features, 1), 1.0, generator)

    def forward(self, obs_seq: torch.Tensor, cache: list | None = None, pos: int | None = None):
        """Full: [B, T, obs] -> outputs [B, T, ...]. Decode: obs [B, obs] ->
        (outputs [B, ...], cache)."""
        if cache is not None:
            h, cache = self.trunk(_obs_dtype(obs_seq), cache=cache, pos=pos)
        else:
            h = self.trunk(_obs_dtype(obs_seq))
        mean = dense(h, self.mean, torch.float32)
        out = PolicyOutput(
            mean=mean,
            log_std=self.log_std.expand(mean.shape),
            value=dense(h, self.value, torch.float32)[..., 0],
        )
        return (out, cache) if cache is not None else out


class TrajectoryCategoricalPPOModel(nn.Module):
    """Discrete twin of :class:`TrajectoryPPOModel` (CartPole, Pong)."""

    def __init__(
        self,
        encoder_cfg: dict,
        obs_shape: Sequence[int],
        n_actions: int,
        cnn_cfg: dict | None = None,
        compute_dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
        mesh: Any = None,
    ):
        super().__init__()
        self.trunk = _trunk(obs_shape, encoder_cfg, cnn_cfg, compute_dtype, generator, mesh)
        features = int(encoder_cfg["features"])
        self.logits = orthogonal_init(nn.Linear(features, n_actions), 0.01, generator)
        self.value = orthogonal_init(nn.Linear(features, 1), 1.0, generator)

    def forward(self, obs_seq: torch.Tensor, cache: list | None = None, pos: int | None = None):
        if cache is not None:
            h, cache = self.trunk(_obs_dtype(obs_seq), cache=cache, pos=pos)
        else:
            h = self.trunk(_obs_dtype(obs_seq))
        out = CategoricalOutput(
            logits=dense(h, self.logits, torch.float32),
            value=dense(h, self.value, torch.float32)[..., 0],
        )
        return (out, cache) if cache is not None else out
