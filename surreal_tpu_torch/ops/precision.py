"""Precision policy, the port of ``surreal_tpu/ops/precision.py``
(``PrecisionPolicy``, ``resolve_policy``).

Only the two policies that need no loss scaling are ported:

- ``'f32'``   — compute float32, staging float32;
- ``'mixed'`` — compute bfloat16, staging float32 (the default).

Params and optimizer state are float32 under both. ``'bf16'`` and
``'bf16_fp8'`` raise ``NotImplementedError``: they need dynamic loss
scaling and bf16 staging, which a later slice ports.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

POLICY_NAMES = ("f32", "mixed", "bf16", "bf16_fp8")
_PORTED = ("f32", "mixed")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def torch_dtype(name: str) -> torch.dtype:
    """Map a config dtype string ('float32' | 'bfloat16') to torch."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} not in {sorted(_DTYPES)}")
    return _DTYPES[name]


class PrecisionPolicy(NamedTuple):
    """Resolved, static precision decisions for one learner build."""

    name: str            # 'f32' | 'mixed'
    param_dtype: str     # always 'float32' (optimizer state follows)
    compute_dtype: str   # model activations / matmul dtype
    data_dtype: str      # SGD minibatch staging (float32 under both)
    loss_scaling: bool   # always False for the ported policies

    def model_config(self, model_cfg) -> dict:
        """Materialize a ``learner_config.model`` subtree: ``'auto'``
        dtypes resolve from the policy, explicit values win."""
        cfg = dict(model_cfg.to_dict() if hasattr(model_cfg, "to_dict") else model_cfg)
        if cfg.get("dtype", "auto") in (None, "auto"):
            cfg["dtype"] = self.param_dtype
        if cfg.get("compute_dtype", "auto") in (None, "auto"):
            cfg["compute_dtype"] = self.compute_dtype
        return cfg

    def meta(self) -> dict:
        """What a checkpoint restore must agree on, key for key as the
        reference records it (``session/checkpoint.py`` checks it): the
        fp8 path is the reference's 'bf16_fp8' only, never on here."""
        return {
            "policy": self.name,
            "param_dtype": self.param_dtype,
            "compute_dtype": self.compute_dtype,
            "data_dtype": self.data_dtype,
            "loss_scaling": self.loss_scaling,
            "fp8": False,
        }

    def telemetry(self) -> dict:
        return self.meta()


def resolve_policy(learner_config) -> PrecisionPolicy:
    """Resolve the active policy from a learner config tree, with the
    reference's rules: ``algo.precision`` names it, explicit
    ``model.dtype`` / ``model.compute_dtype`` values override."""
    algo = learner_config.get("algo", None)
    name = (algo.get("precision", "mixed") if algo is not None else "mixed") or "mixed"
    if name not in POLICY_NAMES:
        raise ValueError(f"algo.precision {name!r} not in {'|'.join(POLICY_NAMES)}")
    if name not in _PORTED:
        raise NotImplementedError(
            f"algo.precision {name!r} needs dynamic loss scaling, which the "
            f"PyTorch port does not have yet; use one of {_PORTED}"
        )
    compute = "float32" if name == "f32" else "bfloat16"
    param = "float32"
    model = learner_config.get("model", None)
    if model is not None:
        if model.get("compute_dtype", "auto") not in (None, "auto"):
            compute = str(model["compute_dtype"])
        if model.get("dtype", "auto") not in (None, "auto"):
            param = str(model["dtype"])
    opt = learner_config.get("optimizer", None)
    ls = opt.get("loss_scaling", None) if opt is not None else None
    if ls is not None and ls.get("enabled", "auto") is True:
        raise NotImplementedError("dynamic loss scaling is not ported yet")
    return PrecisionPolicy(
        name=name,
        param_dtype=param,
        compute_dtype=compute,
        data_dtype="float32",
        loss_scaling=False,
    )
