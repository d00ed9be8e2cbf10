"""Carry weights from the JAX package into the port.

:func:`params_from_jax` maps the flax parameter tree of
``surreal_tpu/models/ppo_net.py::PPOModel``, and
:func:`categorical_params_from_jax` that of ``CategoricalPPOModel`` (as
numpy arrays), onto the names of the port's models of the same names;
:func:`ddpg_params_from_jax` maps the trees of
``surreal_tpu/models/ddpg_net.py``'s ``DDPGActor`` and ``DDPGCritic``.
The PPO-family trees flax builds are::

    MLP_0/Dense_{i}/{kernel,bias}   actor trunk, layer i      (state obs)
    MLP_1/Dense_{i}/{kernel,bias}   critic trunk, layer i     (state obs)
    NatureCNN_0/Conv_{i}/{kernel,bias}, NatureCNN_0/Dense_0/{kernel,bias}
                                    shared stem               (pixel obs)
    Dense_0/{kernel,bias}           mean head | logits head
    Dense_1/{kernel,bias}           value head
    log_std                         (PPOModel only)

The trajectory models' trees (``surreal_tpu/models/attention.py``;
``TrajectoryPPOModel`` and ``TrajectoryCategoricalPPOModel``), read by
:func:`trajectory_params_from_jax` and
:func:`trajectory_categorical_params_from_jax`::

    trunk/embed/{kernel,bias}       obs (or CNN feature) embed
    trunk/pos_embed                 [max_len, features], copied as it is
    trunk/cnn_stem/...              NatureCNN tree           (pixel obs)
    trunk/ln_a{i}, ln_m{i}, ln_f    LayerNorm {scale,bias}
    trunk/attn{i}/{q,k,v}/kernel    DenseGeneral [E, H, D] -> weight [H*D, E]
    trunk/attn{i}/{q,k,v}/bias      [H, D] -> [H*D]
    trunk/attn{i}/o/kernel          [H*D, E] -> weight [E, H*D]
    trunk/mlp_in{i}, mlp_out{i}     Dense
    mean | logits, value            heads (Dense)
    log_std                         (TrajectoryPPOModel only)

The DDPG trees (state obs; a pixel-obs net has ``NatureCNN_0`` in place
of ``MLP_0`` in the actor, and in front of the critic's dense layers)::

    actor:  MLP_0/Dense_{i}, Dense_0 (head)
    critic: Dense_{i} and LayerNorm_{i}/{scale,bias} for each hidden
            layer, then Dense_{n} (the Q head)

A flax ``Dense`` kernel is [in, out]; a torch ``Linear`` weight is
[out, in], so kernels are transposed. A flax ``Conv`` kernel is HWIO; a
torch ``Conv2d`` weight is OIHW. The port's CNN flattens its last conv
output in the reference's (H, W, C) order, so the stem's dense kernel
needs only the transpose. LayerNorm leaves copy as they are. Optimizer
state is not converted.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch


def _tensor(x, axes=None) -> torch.Tensor:
    a = np.array(x, np.float32)
    return torch.from_numpy(np.ascontiguousarray(a if axes is None else a.transpose(axes)))


def _dense(leaf: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _tensor(leaf["kernel"], (1, 0))
    out[f"{prefix}.bias"] = _tensor(leaf["bias"])


def _cnn(cnn: Mapping, prefix: str, out: dict) -> None:
    n_conv = sum(k.startswith("Conv_") for k in cnn)
    if set(cnn) != {f"Conv_{i}" for i in range(n_conv)} | {"Dense_0"}:
        raise ValueError(f"unexpected flax NatureCNN tree {sorted(cnn)}")
    for i in range(n_conv):
        conv = cnn[f"Conv_{i}"]
        out[f"{prefix}.convs.{i}.weight"] = _tensor(conv["kernel"], (3, 2, 0, 1))  # HWIO -> OIHW
        out[f"{prefix}.convs.{i}.bias"] = _tensor(conv["bias"])
    _dense(cnn["Dense_0"], f"{prefix}.dense", out)


def _mlp(node: Mapping, prefix: str, out: dict) -> None:
    for i in range(len(node)):
        _dense(node[f"Dense_{i}"], f"{prefix}.layers.{i}", out)


def _trunks(tree: Mapping, out: dict) -> None:
    if "NatureCNN_0" in tree:
        _cnn(tree["NatureCNN_0"], "stem", out)
        return
    for flax_name, torch_name in (("MLP_0", "actor"), ("MLP_1", "critic")):
        _mlp(tree[flax_name], torch_name, out)


def _convert(flax_params: Mapping, head0: str, extra: tuple[str, ...]) -> dict[str, torch.Tensor]:
    tree = flax_params.get("params", flax_params)
    trunks = {"NatureCNN_0"} if "NatureCNN_0" in tree else {"MLP_0", "MLP_1"}
    expected = trunks | {"Dense_0", "Dense_1", *extra}
    if set(tree) != expected:
        raise ValueError(f"unexpected flax model tree {sorted(tree)}; expected {sorted(expected)}")
    out: dict[str, torch.Tensor] = {}
    _trunks(tree, out)
    _dense(tree["Dense_0"], head0, out)
    _dense(tree["Dense_1"], "value_head", out)
    for name in extra:
        out[name] = _tensor(tree[name])
    return out


def params_from_jax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """flax PPOModel params (``{'params': {...}}`` or its inner dict, leaves
    numpy arrays) -> the port's params dict (CPU float32 tensors)."""
    return _convert(flax_params, "mean_head", ("log_std",))


def categorical_params_from_jax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """flax CategoricalPPOModel params, with the MLP or the CNN trunk ->
    the port's params dict (CPU float32 tensors)."""
    return _convert(flax_params, "logits_head", ())


def _trajectory(flax_params: Mapping, head0: str, extra: tuple[str, ...]) -> dict[str, torch.Tensor]:
    tree = flax_params.get("params", flax_params)
    expected = {"trunk", head0, "value", *extra}
    if set(tree) != expected:
        raise ValueError(f"unexpected flax trajectory model tree {sorted(tree)}; expected {sorted(expected)}")
    trunk = tree["trunk"]
    n_layers = sum(k.startswith("attn") for k in trunk)
    per_layer = ("ln_a", "attn", "ln_m", "mlp_in", "mlp_out")
    want = {"embed", "pos_embed", "ln_f", *(f"{n}{i}" for n in per_layer for i in range(n_layers))}
    if "cnn_stem" in trunk:
        want.add("cnn_stem")
    if set(trunk) != want:
        raise ValueError(f"unexpected flax TrajectoryEncoder tree {sorted(trunk)}")
    out: dict[str, torch.Tensor] = {}
    if "cnn_stem" in trunk:
        _cnn(trunk["cnn_stem"], "trunk.cnn_stem", out)
    _dense(trunk["embed"], "trunk.embed", out)
    out["trunk.pos_embed"] = _tensor(trunk["pos_embed"])
    norms = ["ln_f", *(f"{n}{i}" for n in ("ln_a", "ln_m") for i in range(n_layers))]
    for name in norms:
        out[f"trunk.{name}.scale"] = _tensor(trunk[name]["scale"])
        out[f"trunk.{name}.bias"] = _tensor(trunk[name]["bias"])
    for i in range(n_layers):
        attn = trunk[f"attn{i}"]
        for p in ("q", "k", "v"):
            kernel = np.asarray(attn[p]["kernel"], np.float32)  # [E, H, D]
            out[f"trunk.attn{i}.{p}.weight"] = _tensor(kernel.reshape(kernel.shape[0], -1), (1, 0))
            out[f"trunk.attn{i}.{p}.bias"] = _tensor(np.asarray(attn[p]["bias"], np.float32).reshape(-1))
        _dense(attn["o"], f"trunk.attn{i}.o", out)  # kernel [H*D, E]
        _dense(trunk[f"mlp_in{i}"], f"trunk.mlp_in{i}", out)
        _dense(trunk[f"mlp_out{i}"], f"trunk.mlp_out{i}", out)
    _dense(tree[head0], head0, out)
    _dense(tree["value"], "value", out)
    for name in extra:
        out[name] = _tensor(tree[name])
    return out


def trajectory_params_from_jax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """flax TrajectoryPPOModel params, with or without the CNN stem -> the
    port's params dict (CPU float32 tensors)."""
    return _trajectory(flax_params, "mean", ("log_std",))


def trajectory_categorical_params_from_jax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """flax TrajectoryCategoricalPPOModel params -> the port's params dict
    (CPU float32 tensors)."""
    return _trajectory(flax_params, "logits", ())


def ddpg_params_from_jax(
    actor_params: Mapping, critic_params: Mapping
) -> tuple[dict[str, torch.Tensor], dict[str, torch.Tensor]]:
    """flax DDPGActor and DDPGCritic params (each ``{'params': {...}}`` or
    its inner dict, leaves numpy arrays) -> the port's (actor, critic)
    params dicts (CPU float32 tensors)."""
    atree = actor_params.get("params", actor_params)
    trunk = "NatureCNN_0" if "NatureCNN_0" in atree else "MLP_0"
    if set(atree) != {trunk, "Dense_0"}:
        raise ValueError(f"unexpected flax DDPGActor tree {sorted(atree)}")
    actor: dict[str, torch.Tensor] = {}
    (_cnn if trunk == "NatureCNN_0" else _mlp)(atree[trunk], "trunk", actor)
    _dense(atree["Dense_0"], "head", actor)

    ctree = critic_params.get("params", critic_params)
    n_dense = sum(k.startswith("Dense_") for k in ctree)
    n_norm = sum(k.startswith("LayerNorm_") for k in ctree)
    expected = {f"Dense_{i}" for i in range(n_dense)} | {f"LayerNorm_{i}" for i in range(n_norm)}
    if "NatureCNN_0" in ctree:
        expected.add("NatureCNN_0")
    if set(ctree) != expected or n_norm not in (0, n_dense - 1):
        raise ValueError(f"unexpected flax DDPGCritic tree {sorted(ctree)}")
    critic: dict[str, torch.Tensor] = {}
    if "NatureCNN_0" in ctree:
        _cnn(ctree["NatureCNN_0"], "trunk", critic)
    for i in range(n_dense - 1):
        _dense(ctree[f"Dense_{i}"], f"layers.{i}", critic)
    for i in range(n_norm):
        critic[f"norms.{i}.scale"] = _tensor(ctree[f"LayerNorm_{i}"]["scale"])
        critic[f"norms.{i}.bias"] = _tensor(ctree[f"LayerNorm_{i}"]["bias"])
    _dense(ctree[f"Dense_{n_dense - 1}"], "q_head", critic)
    return actor, critic


def loss_scale_state_from_jax(jax_state: Any, inner_opt_state) -> "LossScaleState":
    """The port's ``LossScaleState`` with the scale, good steps and
    overflows of the reference's (numpy or JAX scalars) around the port's
    own ``inner_opt_state``, so that a test can start both packages from
    the same point of the schedule (the optimizer's moments are not
    converted)."""
    from surreal_tpu_torch.ops.precision import LossScaleState

    device = inner_opt_state.count.device
    return LossScaleState(
        scale=torch.full((), float(np.asarray(jax_state.scale)), dtype=torch.float32, device=device),
        good_steps=torch.full((), int(np.asarray(jax_state.good_steps)), dtype=torch.int32, device=device),
        overflows=torch.full((), int(np.asarray(jax_state.overflows)), dtype=torch.int32, device=device),
        inner=inner_opt_state,
    )
