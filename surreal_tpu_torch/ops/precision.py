"""Precision policy, the port of ``surreal_tpu/ops/precision.py``
(``PrecisionPolicy``, ``resolve_policy``, ``LossScaleState``,
``dynamic_loss_scaling``, ``current_loss_scale``, ``loss_scale_metrics``,
``_quantize_f8``, ``fp8_dot_general``), plus ``optax.global_norm``.

Policies, as in the reference:

- ``'f32'``      compute float32, staging float32;
- ``'mixed'``    compute bfloat16, staging float32 (the default; no
  loss-scale state in the optimizer state);
- ``'bf16'``     compute bfloat16 and staging bfloat16 (the SGD minibatch
  obs and the replay obs storage), dynamic loss scaling on by default;
- ``'bf16_fp8'`` 'bf16' plus the fp8 Dense path: both operands of a Dense
  matmul quantized to float8_e4m3fn with a per-tensor dynamic scale.

Parameters and optimizer state are float32 under every policy unless
``model.dtype`` names another dtype.

Dynamic loss scaling wraps the whole optimizer chain. The loss is
multiplied by a power-of-two scale read from the optimizer state, the
wrapper divides the gradients back down, and a nonfinite gradient norm
turns the step into a skip: zero update, the inner state (Adam's count
and moments, the recovery scale) kept bit for bit, the scale backed off.
The reference branches with ``lax.cond``; here every field is chosen by
``torch.where`` on device tensors, so a step never reads ``finite`` back
to the host.

fp8 rounding follows ml_dtypes, which JAX's casts use: a value whose
magnitude rounds above 448 (anything above 464), an infinity or a NaN
becomes NaN. torch's own cast saturates to +-448 instead, so
:func:`e4m3` puts the NaNs back for the cotangent the reference's
autodiff casts to e4m3 in the backward pass, unscaled. The forward
pass needs no such rule: each operand is scaled so that its absolute
max lands on 448 (at most one float32 ulp above it, which rounds to
448), and a NaN or infinite operand makes the scale NaN or infinite,
so the scaled values are NaN or 0 under either cast.
"""

from __future__ import annotations

from typing import Any, Mapping, NamedTuple

import numpy as np
import torch

POLICY_NAMES = ("f32", "mixed", "bf16", "bf16_fp8")

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# the f8 format's finite max (e4m3fn): per-tensor dynamic scaling maps each
# operand's absolute max onto it. XLA computes ``amax / 448`` as a multiply
# by the float32 reciprocal, so the port does too.
_F8_MAX = 448.0
_F8_INV_MAX = float(np.float32(1.0 / _F8_MAX))
# ml_dtypes rounds to nearest even: 464 is the tie between 448 and 480 and
# rounds to 448; anything larger rounds to 480, past the range, so NaN
_F8_NAN_ABOVE = 464.0


def torch_dtype(name: str) -> torch.dtype:
    """Map a config dtype string ('float32' | 'bfloat16') to torch."""
    if name not in _DTYPES:
        raise ValueError(f"dtype {name!r} not in {sorted(_DTYPES)}")
    return _DTYPES[name]


class PrecisionPolicy(NamedTuple):
    """Resolved, static precision decisions for one learner build."""

    name: str            # 'f32' | 'mixed' | 'bf16' | 'bf16_fp8'
    param_dtype: str     # 'float32' unless model.dtype says otherwise
    compute_dtype: str   # model activations / matmul dtype
    data_dtype: str      # SGD minibatch obs staging / replay obs storage
    fp8: bool            # the fp8 matmul path in Dense layers
    loss_scaling: bool   # dynamic loss scaling wraps the optimizer chain
    # loss-scale schedule (powers of two keep scaling exact)
    ls_init: float = 2.0**15
    ls_growth_interval: int = 2000
    ls_growth_factor: float = 2.0
    ls_backoff_factor: float = 0.5
    ls_min: float = 1.0
    ls_max: float = 2.0**24

    def model_config(self, model_cfg) -> dict:
        """Materialize a ``learner_config.model`` subtree: ``'auto'``
        dtypes resolve from the policy, explicit values win, and the fp8
        flag rides along for the models."""
        cfg = dict(model_cfg.to_dict() if hasattr(model_cfg, "to_dict") else model_cfg)
        if cfg.get("dtype", "auto") in (None, "auto"):
            cfg["dtype"] = self.param_dtype
        if cfg.get("compute_dtype", "auto") in (None, "auto"):
            cfg["compute_dtype"] = self.compute_dtype
        cfg["fp8"] = self.fp8
        return cfg

    def cast_stage(self, tree: Mapping[str, Any], keys: tuple[str, ...] = ("obs", "next_obs")) -> dict:
        """The named floating leaves of a batch dict cast to the staging
        dtype (a no-op under 'f32' and 'mixed'). Only obs-class leaves,
        which the models cast to the compute dtype anyway, so the rounding
        point is the same; uint8 pixels and bools pass through."""
        dd = torch_dtype(self.data_dtype)
        if dd == torch.float32:
            return tree
        out = dict(tree)
        for k in keys:
            v = out.get(k)
            if v is not None and v.dtype.is_floating_point:
                out[k] = v.to(dd)
        return out

    def meta(self) -> dict:
        """What a checkpoint restore must agree on, key for key as the
        reference records it (``session/checkpoint.py`` checks it)."""
        return {
            "policy": self.name,
            "param_dtype": self.param_dtype,
            "compute_dtype": self.compute_dtype,
            "data_dtype": self.data_dtype,
            "loss_scaling": self.loss_scaling,
            "fp8": self.fp8,
        }

    def telemetry(self) -> dict:
        return self.meta()


def resolve_policy(learner_config) -> PrecisionPolicy:
    """Resolve the active policy from a learner config tree, with the
    reference's rules: ``algo.precision`` names it; explicit
    ``model.dtype`` / ``model.compute_dtype`` values override the derived
    dtypes; ``optimizer.loss_scaling.enabled`` overrides the policy's
    loss-scaling default ('auto': on for 'bf16' and 'bf16_fp8'); the
    schedule keys of ``optimizer.loss_scaling`` override its fields."""
    algo = learner_config.get("algo", None)
    name = (algo.get("precision", "mixed") if algo is not None else "mixed") or "mixed"
    if name not in POLICY_NAMES:
        raise ValueError(f"algo.precision {name!r} not in {'|'.join(POLICY_NAMES)}")
    compute = "float32" if name == "f32" else "bfloat16"
    data = "bfloat16" if name in ("bf16", "bf16_fp8") else "float32"
    param = "float32"
    model = learner_config.get("model", None)
    if model is not None:
        if model.get("compute_dtype", "auto") not in (None, "auto"):
            compute = str(model["compute_dtype"])
        if model.get("dtype", "auto") not in (None, "auto"):
            param = str(model["dtype"])
    opt = learner_config.get("optimizer", None)
    ls = opt.get("loss_scaling", None) if opt is not None else None
    enabled = ls.get("enabled", "auto") if ls is not None else "auto"
    loss_scaling = name in ("bf16", "bf16_fp8") if enabled in (None, "auto") else bool(enabled)
    kwargs = {}
    if ls is not None:
        for cfg_key, field in (
            ("init", "ls_init"),
            ("growth_interval", "ls_growth_interval"),
            ("growth_factor", "ls_growth_factor"),
            ("backoff_factor", "ls_backoff_factor"),
            ("min", "ls_min"),
            ("max", "ls_max"),
        ):
            v = ls.get(cfg_key, None)
            if v is not None:
                kwargs[field] = type(PrecisionPolicy._field_defaults[field])(v)
    return PrecisionPolicy(
        name=name,
        param_dtype=param,
        compute_dtype=compute,
        data_dtype=data,
        fp8=(name == "bf16_fp8"),
        loss_scaling=loss_scaling,
        **kwargs,
    )


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """``optax.global_norm``: sqrt of the sum of every leaf's sum of
    squares. Each leaf's sum is in its own dtype, and the running sum
    promotes as JAX's does (a bfloat16 leaf's sum joins a float32 one as
    float32)."""
    return torch.sqrt(sum(torch.sum(x * x) for x in tree.values()))


# -- dynamic loss scaling ----------------------------------------------------


class LossScaleState(NamedTuple):
    """State of :class:`DynamicLossScaling`: the live scale, the run of
    finite steps driving growth, a cumulative overflow counter, and the
    wrapped chain's own state."""

    scale: torch.Tensor       # float32 scalar, a power of two
    good_steps: torch.Tensor  # int32, finite steps since the last change
    overflows: torch.Tensor   # int32, skipped steps so far
    inner: Any                # the wrapped chain's state


def _select(cond: torch.Tensor, a: Any, b: Any) -> Any:
    """``a`` where ``cond`` else ``b``, leaf by leaf over two states of the
    same structure (NamedTuples, dicts, tensors)."""
    if isinstance(a, torch.Tensor):
        return torch.where(cond, a, b)
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(_select(cond, x, y) for x, y in zip(a, b)))
    if isinstance(a, dict):
        return {k: _select(cond, a[k], b[k]) for k in a}
    return a


class DynamicLossScaling:
    """An optimizer chain wrapped in dynamic loss scaling (the reference's
    ``dynamic_loss_scaling``), with the ``init`` / ``update`` interface of
    ``learners/base.py::OptimizerChain``.

    ``update`` takes the gradients of the SCALED loss and divides them by
    the scale (a power of two, so exactly; each leaf keeps its dtype). On
    a finite gradient norm the inner chain's step is taken and the scale
    doubles after ``ls_growth_interval`` finite steps in a row, up to
    ``ls_max``; on a nonfinite norm the update is zero, the inner state
    is the old one bit for bit, and the scale is multiplied by
    ``ls_backoff_factor``, down to ``ls_min``. The choice is made on the
    device (``torch.where``), never on the host."""

    def __init__(self, inner, policy: PrecisionPolicy):
        self.inner = inner
        self.policy = policy
        self.growth_interval = max(1, int(policy.ls_growth_interval))

    def init(self, params) -> LossScaleState:
        dev = next(iter(params.values())).device
        return LossScaleState(
            scale=torch.full((), self.policy.ls_init, dtype=torch.float32, device=dev),
            good_steps=torch.zeros((), dtype=torch.int32, device=dev),
            overflows=torch.zeros((), dtype=torch.int32, device=dev),
            inner=self.inner.init(params),
        )

    def update(self, scaled_grads, state: LossScaleState):
        pol = self.policy
        # torch keeps a bf16 leaf bf16 against the 0-dim float32 scale
        grads = {k: g / state.scale for k, g in scaled_grads.items()}
        # the same norm as the inner chain's clip: computed once, passed on
        g_norm = global_norm(grads)
        finite = torch.isfinite(g_norm)
        updates, inner = self.inner.update(grads, state.inner, g_norm=g_norm)
        good = state.good_steps + 1
        grow = good >= self.growth_interval
        grown = torch.where(grow, torch.clamp_max(state.scale * pol.ls_growth_factor, pol.ls_max), state.scale)
        backed_off = torch.clamp_min(state.scale * pol.ls_backoff_factor, pol.ls_min)
        new_state = LossScaleState(
            scale=torch.where(finite, grown, backed_off),
            good_steps=torch.where(finite & ~grow, good, 0),
            overflows=torch.where(finite, state.overflows, state.overflows + 1),
            # a true skip: the old inner state, not one fed zeros (Adam
            # would still decay its moments)
            inner=_select(finite, inner, state.inner),
        )
        return {k: torch.where(finite, u, 0.0) for k, u in updates.items()}, new_state


def dynamic_loss_scaling(inner, policy: PrecisionPolicy) -> DynamicLossScaling:
    """``inner`` wrapped in dynamic loss scaling with ``policy``'s schedule."""
    return DynamicLossScaling(inner, policy)


LOSS_SCALE_KEYS = ("precision/loss_scale", "precision/overflows")


def find_instances(tree: Any, cls: type) -> list:
    """Every ``cls`` instance in ``tree`` (NamedTuples, tuples, lists and
    dicts), in ``jax.tree`` order: fields in order, dict keys sorted."""
    if isinstance(tree, cls):
        return [tree]
    if isinstance(tree, dict):
        return [s for k in sorted(tree) for s in find_instances(tree[k], cls)]
    if isinstance(tree, (tuple, list)):
        return [s for x in tree for s in find_instances(x, cls)]
    return []


def current_loss_scale(opt_state: Any):
    """The loss-scale tensor to multiply the loss by, or the float 1.0 when
    the chain carries no :class:`LossScaleState` ('f32', 'mixed'). The
    first state found wins (DDPG reads each chain's state separately)."""
    found = find_instances(opt_state, LossScaleState)
    return found[0].scale if found else 1.0


def scale_loss(loss: torch.Tensor, scale) -> torch.Tensor:
    """``loss * scale``, or ``loss`` itself when ``scale`` is the float 1.0
    of :func:`current_loss_scale` (no launch, and none in the backward)."""
    return loss * scale if isinstance(scale, torch.Tensor) else loss


def loss_scale_metrics(opt_state: Any) -> dict:
    """Device-scalar telemetry of the loss-scale state: the first scale,
    and the overflows of every state summed as float32. Empty when the
    chain carries none."""
    found = find_instances(opt_state, LossScaleState)
    if not found:
        return {}
    overflows = found[0].overflows
    for s in found[1:]:
        overflows = overflows + s.overflows
    return dict(zip(LOSS_SCALE_KEYS, (found[0].scale, overflows.to(torch.float32))))


# -- the fp8 matmul path -----------------------------------------------------


def e4m3(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8_e4m3fn and back to its dtype, as JAX's
    ``x.astype(float8_e4m3fn)`` rounds (ml_dtypes: to nearest even, NaN
    past the range). torch's cast saturates, so the NaNs are put back."""
    q = x.to(torch.float8_e4m3fn).to(x.dtype)
    return torch.where(torch.isnan(x) | (x.abs() > _F8_NAN_ABOVE), torch.nan, q)


class _Quantize(torch.autograd.Function):
    """Per-tensor dynamic quantization of a float32 ``x`` to e4m3 (the
    reference's ``_quantize_f8``): ``scale = max(amax(|x|), 1e-12) / 448``
    and ``q = x / scale`` rounded to e4m3; returns (q as float32, scale).

    Differentiated as JAX differentiates the reference, where it differs
    from torch's autograd: the cotangent of ``q`` arrives in float32 from
    the matmul and is rounded to bfloat16 (the dtype the reference upcasts
    the quantized operand to) and then to e4m3 (the cast's transpose);
    the division's transpose for the divisor is ``(-ct * x) / scale**2``;
    and the scale's cotangent reaches only the elements at the absolute
    max, through a select (XLA's form of the max's indicator product), so
    a NaN there does not spread to the rest, as ``0 * nan`` would."""

    @staticmethod
    def forward(ctx, x: torch.Tensor):
        amax = x.abs().amax()
        scale = torch.clamp_min(amax, 1e-12) * _F8_INV_MAX
        ctx.save_for_backward(x, amax, scale)
        # |x / scale| <= 448 up to one float32 ulp: torch's saturating cast
        # and ml_dtypes' agree there (see the module doc)
        return x.div(scale).to(torch.float8_e4m3fn).to(torch.float32), scale

    @staticmethod
    def backward(ctx, ct_q: torch.Tensor, ct_scale: torch.Tensor):
        x, amax, scale = ctx.saved_tensors
        ct_q = e4m3(ct_q.to(torch.bfloat16)).to(torch.float32)
        ct_scale = ct_scale + torch.sum((-ct_q * x) / (scale * scale))
        ct_amax = torch.where(amax >= 1e-12, ct_scale * _F8_INV_MAX, 0.0)
        at_max = x.abs() == amax
        ct_abs = torch.where(at_max, ct_amax / at_max.sum(), 0.0)
        return ct_q / scale + torch.where(x >= 0, ct_abs, -ct_abs)


def _quantize_f8(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor dynamic quantization to float8_e4m3fn: the absolute max
    mapped onto the format's finite max. Returns (the quantized values as
    float32, the scale)."""
    return _Quantize.apply(x.to(torch.float32))


def fp8_linear(x: torch.Tensor, weight: torch.Tensor) -> torch.Tensor:
    """The reference's ``fp8_dot_general`` for a Dense layer: ``x [...,
    in] @ weight.T`` (``weight [out, in]``, the torch layout) with both
    operands quantized to e4m3 under per-tensor scales, the product taken
    in float32 (e4m3 products are exact there), rescaled, and returned in
    ``x``'s dtype. The bias is the caller's, added after the rounding, as
    flax's Dense adds it."""
    lq, ls = _quantize_f8(x)
    rq, rs = _quantize_f8(weight)
    out = torch.matmul(lq, rq.t())
    return (out * (ls * rs)).to(x.dtype)
