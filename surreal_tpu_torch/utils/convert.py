"""Carry weights from the JAX package into the port.

:func:`params_from_jax` maps the flax parameter tree of
``surreal_tpu/models/ppo_net.py::PPOModel`` (as numpy arrays) onto the
names of :class:`surreal_tpu_torch.models.ppo_net.PPOModel`. The tree
flax builds is::

    MLP_0/Dense_{i}/{kernel,bias}   actor trunk, layer i
    MLP_1/Dense_{i}/{kernel,bias}   critic trunk, layer i
    Dense_0/{kernel,bias}           mean head
    Dense_1/{kernel,bias}           value head
    log_std

A flax ``Dense`` kernel is [in, out]; a torch ``Linear`` weight is
[out, in], so kernels are transposed. Optimizer state is not converted.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

_MODULES = {"MLP_0": "actor", "MLP_1": "critic", "Dense_0": "mean_head", "Dense_1": "value_head"}


def _dense(leaf: Mapping, prefix: str, out: dict) -> None:
    out[f"{prefix}.weight"] = torch.from_numpy(np.array(leaf["kernel"], np.float32).T.copy())
    out[f"{prefix}.bias"] = torch.from_numpy(np.array(leaf["bias"], np.float32))


def params_from_jax(flax_params: Mapping) -> dict[str, torch.Tensor]:
    """flax PPOModel params (``{'params': {...}}`` or its inner dict, leaves
    numpy arrays) -> the port's params dict (CPU float32 tensors)."""
    tree = flax_params.get("params", flax_params)
    expected = set(_MODULES) | {"log_std"}
    if set(tree) != expected:
        raise ValueError(f"unexpected flax PPOModel tree {sorted(tree)}; expected {sorted(expected)}")
    out: dict[str, torch.Tensor] = {}
    for flax_name, torch_name in _MODULES.items():
        node = tree[flax_name]
        if flax_name.startswith("MLP"):
            for i in range(len(node)):
                _dense(node[f"Dense_{i}"], f"{torch_name}.layers.{i}", out)
        else:
            _dense(node, torch_name, out)
    out["log_std"] = torch.from_numpy(np.array(tree["log_std"], np.float32))
    return out
