"""Carry weights from the JAX package into the port.

:func:`params_from_jax` maps the flax parameter tree of
``surreal_tpu/models/ppo_net.py::PPOModel``, and
:func:`categorical_params_from_jax` that of ``CategoricalPPOModel`` (as
numpy arrays), onto the names of the port's models of the same names.
The trees flax builds are::

    MLP_0/Dense_{i}/{kernel,bias}   actor trunk, layer i      (state obs)
    MLP_1/Dense_{i}/{kernel,bias}   critic trunk, layer i     (state obs)
    NatureCNN_0/Conv_{i}/{kernel,bias}, NatureCNN_0/Dense_0/{kernel,bias}
                                    shared stem               (pixel obs)
    Dense_0/{kernel,bias}           mean head | logits head
    Dense_1/{kernel,bias}           value head
    log_std                         (PPOModel only)

A flax ``Dense`` kernel is [in, out]; a torch ``Linear`` weight is
[out, in], so kernels are transposed. A flax ``Conv`` kernel is HWIO; a
torch ``Conv2d`` weight is OIHW. The port's CNN flattens its last conv
output in the reference's (H, W, C) order, so the stem's dense kernel
needs only the transpose. Optimizer state is not converted.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch


def _tensor(x, axes=None) -> torch.Tensor:
    a = np.array(x, np.float32)
    return torch.from_numpy(np.ascontiguousarray(a if axes is None else a.transpose(axes)))


def _dense(leaf: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = _tensor(leaf["kernel"], (1, 0))
    out[f"{prefix}.bias"] = _tensor(leaf["bias"])


def _trunks(tree: Mapping, out: dict) -> None:
    if "NatureCNN_0" in tree:
        cnn = tree["NatureCNN_0"]
        n_conv = sum(k.startswith("Conv_") for k in cnn)
        if set(cnn) != {f"Conv_{i}" for i in range(n_conv)} | {"Dense_0"}:
            raise ValueError(f"unexpected flax NatureCNN tree {sorted(cnn)}")
        for i in range(n_conv):
            conv = cnn[f"Conv_{i}"]
            out[f"stem.convs.{i}.weight"] = _tensor(conv["kernel"], (3, 2, 0, 1))  # HWIO -> OIHW
            out[f"stem.convs.{i}.bias"] = _tensor(conv["bias"])
        _dense(cnn["Dense_0"], "stem.dense", out)
        return
    for flax_name, torch_name in (("MLP_0", "actor"), ("MLP_1", "critic")):
        node = tree[flax_name]
        for i in range(len(node)):
            _dense(node[f"Dense_{i}"], f"{torch_name}.layers.{i}", out)


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
