"""Parity of the PyTorch port's precision layer (``ops/precision.py`` and
where the learners, models, replay and checkpoints read it) with the JAX
package's, mirroring ``tests/test_precision.py``.

Bars, and why:

- Policy resolution, ``model_config``, ``cast_stage`` and the loss-scale
  bookkeeping (scale, good steps, overflows): equal, case for case.
- The loss-scaled chain's updates: the port's Adam bar of the f32 learn
  tests (rtol 1e-5 / atol 1e-7 an update here: a step of lr is 1e-3).
- The fp8 cast: bit for bit against ``jnp.astype(float8_e4m3fn)``, NaN
  where it gives NaN, at every e4m3 boundary between 2^-10 and 512.
- The fp8 Dense product: forward within one bf16 ulp of
  ``fp8_dot_general`` (float32 sums in another order, then one rounding
  to bf16); its gradients bit for bit, NaN where JAX's are, except at
  each operand's absolute-max element, which alone receives the
  per-tensor scale's cotangent: a float32 sum over the whole product,
  taken in another order, so within one bf16 ulp there.
- The optimizer chain on bf16 leaves (``model.dtype='bfloat16'``),
  plain and loss-scaled, against optax run op by op: updates, moments
  and parameters of the bf16 leaves bit for bit, the float32 leaves at
  the Adam bar. (XLA's jit on the CPU drops some of the intermediate
  bf16 roundings, so the chain is held to optax's eager semantics.)
- A one-step learn under 'bf16', 'bf16_fp8' or bf16 parameters against
  JAX: both compute every layer in bf16, but round at other places (the
  memoryless models fuse the bias, flax adds it after the rounded
  product), so the metrics are held to the models' bf16 bar, 2e-2. The
  update each element takes (new - old) is held to JAX's within lr / 10,
  except at a few sign flips: Adam's first step is lr * g / (|g| + eps),
  so a gradient whose bf16 sum lands on the other side of 0 moves its
  weight 2 lr the other way (and one within a few eps of 0, part of
  that). Such an element is allowed only where JAX's |g| is near 0, at
  most a stated share of its leaf's largest, and only in a stated share
  of the elements. Measured, then the bars (share of the elements; |g|
  against its leaf's largest): PPO 'bf16' 0.26%, 0.15% (0.5%, 1%);
  'bf16_fp8', whose cotangents round to e4m3, 1.08%, 5.0% (2%, 10%);
  bf16 parameters 0.07%, 0.08% (0.5%, 1%); DDPG's actor, whose gradient
  crosses the bf16 critic, 1.45%, 1.4% (3%, 3%), its critic 0.31%,
  0.92% (0.5%, 2%). A learn that took no step, or a step the wrong way,
  is off in nearly every element.
- The port's 'bf16' against its 'mixed': 1e-5, the reference's own rule
  (``tests/test_precision.py::test_bf16_vs_f32_fused_iteration``).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import optax
import pytest
import torch

from surreal_tpu.envs.base import ArraySpec as JaxArraySpec
from surreal_tpu.envs.base import EnvSpecs as JaxEnvSpecs
from surreal_tpu.learners import build_learner as jax_build_learner
from surreal_tpu.learners.base import make_optimizer_chain as jax_make_chain
from surreal_tpu.ops import distributions as JD
from surreal_tpu.ops import precision as jprec
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs
from surreal_tpu_torch.learners import build_learner
from surreal_tpu_torch.learners.base import apply_updates, get_recovery_lr_scale, make_optimizer_chain, set_recovery_lr_scale
from surreal_tpu_torch.ops import precision as prec
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.utils.convert import loss_scale_state_from_jax, params_from_jax

OBS, ACT = 17, 4
BF16_TOL = dict(rtol=2e-2, atol=2e-2)


def _np(x) -> np.ndarray:
    """A torch tensor as float32 numpy (bf16 has no numpy dtype in torch)."""
    return x.detach().to(torch.float32).numpy()


def _jnp_np(x) -> np.ndarray:
    return np.asarray(x, np.float32)


# -- policy resolution ---------------------------------------------------------

POLICY_CASES = [
    {},
    {"algo": {"precision": "f32"}},
    {"algo": {"precision": "mixed"}},
    {"algo": {"precision": "bf16"}},
    {"algo": {"precision": "bf16_fp8"}},
    {"algo": {"precision": "bf16"}, "model": {"compute_dtype": "float32"}},
    {"algo": {"precision": "mixed"}, "model": {"dtype": "bfloat16"}},
    {"algo": {"precision": "mixed"}, "optimizer": {"loss_scaling": {"enabled": True}}},
    {"algo": {"precision": "bf16"}, "optimizer": {"loss_scaling": {"enabled": False}}},
    {"algo": {"precision": "f32"}, "optimizer": {"loss_scaling": {"enabled": "auto", "init": 4, "growth_interval": 3,
                                                                   "min": 2.0, "max": 64, "backoff_factor": 0.25}}},
]


@pytest.mark.parametrize("tree", POLICY_CASES, ids=lambda t: repr(t)[:60])
def test_resolve_policy_matches_jax(tree):
    """Every rule of the reference's ``resolve_policy``: the policy's
    dtypes, the 'auto' loss-scaling default and its force, the schedule
    overrides, explicit model dtypes; then ``model_config`` and ``meta``."""
    want = jprec.resolve_policy(JaxConfig(tree))
    got = prec.resolve_policy(Config(tree))
    assert got._asdict() == want._asdict()
    model = {"dtype": "auto", "compute_dtype": "auto", "activation": "tanh"}
    assert got.model_config(Config(model)) == want.model_config(JaxConfig(model))
    assert got.meta() == want.meta() and got.telemetry() == want.telemetry()


def test_resolve_policy_rejects_unknown_names():
    for mod, cfg in ((jprec, JaxConfig), (prec, Config)):
        with pytest.raises(ValueError, match="precision"):
            mod.resolve_policy(cfg(algo=cfg(precision="fp4")))


@pytest.mark.parametrize("name", prec.POLICY_NAMES)
def test_cast_stage_matches_jax(name):
    """Float obs leaves take the staging dtype; uint8 pixels, bools and the
    other keys pass through."""
    rng = np.random.default_rng(0)
    batch = {
        "obs": rng.normal(size=(6, 5)).astype(np.float32),
        "next_obs": rng.integers(0, 255, size=(6, 4, 4, 2)).astype(np.uint8),
        "done": rng.random(6) < 0.5,
        "reward": rng.normal(size=6).astype(np.float32),
    }
    want = jprec.resolve_policy(JaxConfig(algo=JaxConfig(precision=name))).cast_stage(
        {k: jnp.asarray(v) for k, v in batch.items()})
    got = prec.resolve_policy(Config(algo=Config(precision=name))).cast_stage(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    assert set(got) == set(want)
    for k, v in want.items():
        assert str(got[k].dtype).replace("torch.", "") == str(v.dtype), k
        np.testing.assert_array_equal(got[k].to(torch.float32).numpy() if got[k].dtype == torch.bfloat16
                                      else got[k].numpy(), np.asarray(v, np.float32 if v.dtype == jnp.bfloat16
                                                                      else v.dtype), err_msg=k)


# -- dynamic loss scaling ------------------------------------------------------

def _policies(**kw):
    fields = dict(name="bf16", param_dtype="float32", compute_dtype="bfloat16", data_dtype="bfloat16", fp8=False,
                  loss_scaling=True, **kw)
    return jprec.PrecisionPolicy(**fields), prec.PrecisionPolicy(**fields)


# gradient sequences (multiples of the param shape's ones, scaled by the
# current loss scale as a learner would), covering healthy steps, an
# overflow skip (inf, then nan), growth at the interval, the floor and the
# ceiling
SEQUENCES = {
    "healthy": [0.01, -0.02, 0.3, 0.05, -0.4],
    "overflow": [0.5, np.inf, 0.2, np.nan, 0.1],
    "growth": [0.1] * 7,
    "floor": [0.3] + [np.inf] * 6 + [0.1],
    "ceiling": [0.2] * 9,
}
SCHEDULES = {
    "healthy": {},
    "overflow": {},
    "growth": dict(ls_init=4.0, ls_growth_interval=3),
    "floor": dict(ls_init=8.0, ls_min=2.0),
    "ceiling": dict(ls_init=8.0, ls_growth_interval=2, ls_max=32.0),
}


@pytest.mark.parametrize("case", list(SEQUENCES))
def test_dynamic_loss_scaling_matches_jax(case):
    """The port's loss-scaled chain against the reference's on the same
    gradient sequence: scale, good steps and overflows equal after every
    step; the updates at the Adam bar; a skipped step's Adam state bit for
    bit the one before it and its update zero."""
    jpol, tpol = _policies(**SCHEDULES[case])
    rng = np.random.default_rng(1)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32), "b": rng.normal(size=3).astype(np.float32)}
    direction = {k: rng.normal(size=v.shape).astype(np.float32) for k, v in p0.items()}
    jtx, ttx = jax_make_chain(1e-3, 0.5, jpol), make_optimizer_chain(1e-3, 0.5, tpol)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v) for k, v in p0.items()}
    js, ts = jtx.init(jp), ttx.init(tp)
    jupdate = jax.jit(jtx.update)
    for i, g in enumerate(SEQUENCES[case]):
        jg = {k: jnp.asarray(d * np.float32(g)) * jprec.current_loss_scale(js) for k, d in direction.items()}
        tg = {k: torch.from_numpy(d * np.float32(g)) * prec.current_loss_scale(ts) for k, d in direction.items()}
        ju, js_new = jupdate(jg, js, jp)
        tu, ts_new = ttx.update(tg, ts)
        for f in ("scale", "good_steps", "overflows"):
            assert float(getattr(ts_new, f)) == float(getattr(js_new, f)), (i, f)
        for k in p0:
            np.testing.assert_allclose(tu[k].numpy(), np.asarray(ju[k]), rtol=1e-5, atol=1e-7, err_msg=f"{i} {k}")
        if not np.isfinite(g):
            assert all(float(u.abs().max()) == 0.0 for u in tu.values())
            for a, b in zip(ts_new.inner, ts.inner):
                for x, y in zip(a.values() if isinstance(a, dict) else [a], b.values() if isinstance(b, dict) else [b]):
                    assert torch.equal(x, y)
        js, ts = js_new, ts_new
        jp, tp = optax.apply_updates(jp, ju), apply_updates(tp, tu)
    for k in p0:
        np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]), rtol=0, atol=1e-6, err_msg=k)
    m, jm = prec.loss_scale_metrics(ts), jprec.loss_scale_metrics(js)
    assert {k: float(v) for k, v in m.items()} == {k: float(v) for k, v in jm.items()}


def test_loss_scale_helpers_without_the_wrapper():
    """A chain without loss scaling: scale 1.0, no metrics; the recovery
    scale is reached inside the wrapper's ``inner`` too."""
    _, tpol = _policies()
    params = {"w": torch.ones(4)}
    plain = make_optimizer_chain(1e-3, 0.5, tpol._replace(loss_scaling=False)).init(params)
    assert prec.current_loss_scale(plain) == 1.0 and prec.loss_scale_metrics(plain) == {}
    wrapped = make_optimizer_chain(1e-3, 0.5, tpol).init(params)
    assert get_recovery_lr_scale(wrapped) == 1.0
    backed = set_recovery_lr_scale({"a": wrapped, "c": plain}, 0.25)
    assert isinstance(backed["a"], prec.LossScaleState)
    assert float(backed["a"].inner.recovery_scale) == float(backed["c"].recovery_scale) == 0.25
    assert get_recovery_lr_scale(backed) == 0.25 and get_recovery_lr_scale({"x": torch.ones(1)}) is None


# gradient multiples for the bf16-leaf chain: small and large steps, one
# past the clip norm, and (loss-scaled only) an overflow the wrapper skips
BF16_CHAIN_STEPS = [0.02, -0.3, 0.05, 2.0, np.inf, 0.1, -0.04, 0.6]


@pytest.mark.parametrize("loss_scaled", [False, True], ids=["plain", "loss_scaled"])
def test_optimizer_chain_on_bf16_leaves_matches_optax(loss_scaled):
    """The chain on a tree of bf16 trunk leaves and a float32 head leaf
    (``model.dtype='bfloat16'``), eight steps, against the reference's
    chain run op by op: optax keeps bf16 moments, rounds its constants and
    bias corrections to bf16 and promotes the update to float32 through
    the recovery scale. The bf16 leaves' updates, moments and parameters
    bit for bit, the float32 leaf at the Adam bar. The reference's
    loss-scaled chain cannot carry bf16 leaves (ROADMAP §3), so the
    port's is held to the reference's plain chain fed the unscaled
    gradients, and to no step at all at the overflow."""
    fields = dict(name="bf16", param_dtype="bfloat16", compute_dtype="bfloat16", data_dtype="bfloat16", fp8=False,
                  loss_scaling=loss_scaled)
    jpol, tpol = jprec.PrecisionPolicy(**fields), prec.PrecisionPolicy(**fields)
    rng = np.random.default_rng(4)
    dtypes = {"a_b": "bfloat16", "a_w": "bfloat16", "head_w": "float32"}  # sorted: global_norm's order in both
    shapes = {"a_b": (16,), "a_w": (8, 16), "head_w": (16, 3)}
    p0 = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}
    jp = {k: jnp.asarray(v).astype(dtypes[k]) for k, v in p0.items()}
    tp = {k: torch.from_numpy(v).to(getattr(torch, dtypes[k])) for k, v in p0.items()}
    jtx = jax_make_chain(1e-3, 0.5, jpol._replace(loss_scaling=False))
    ttx = make_optimizer_chain(1e-3, 0.5, tpol)
    js, ts = jtx.init(jp), ttx.init(tp)
    for i, m in enumerate(BF16_CHAIN_STEPS if loss_scaled else [m for m in BF16_CHAIN_STEPS if np.isfinite(m)]):
        g = {k: (rng.normal(size=s) * m).astype(np.float32) for k, s in shapes.items()}
        scale = prec.current_loss_scale(ts)
        tu, ts = ttx.update({k: torch.from_numpy(v).to(getattr(torch, dtypes[k])) * scale for k, v in g.items()}, ts)
        if np.isfinite(m):
            ju, js = jtx.update({k: jnp.asarray(v).astype(dtypes[k]) for k, v in g.items()}, js, jp)
            jp = optax.apply_updates(jp, ju)
        else:
            ju = {k: jnp.zeros_like(v, jnp.float32) for k, v in jp.items()}
        tp = apply_updates(tp, tu)
        for k, dt in dtypes.items():
            assert str(tu[k].dtype).replace("torch.", "") == str(ju[k].dtype), (i, k)
            assert str(tp[k].dtype).replace("torch.", "") == str(jp[k].dtype) == dt, (i, k)
            if dt == "bfloat16":
                np.testing.assert_array_equal(_np(tu[k]), _jnp_np(ju[k]), err_msg=f"{i} {k}")
                np.testing.assert_array_equal(_np(tp[k]), _jnp_np(jp[k]), err_msg=f"{i} {k}")
            else:
                np.testing.assert_allclose(_np(tu[k]), _jnp_np(ju[k]), rtol=1e-5, atol=1e-7, err_msg=f"{i} {k}")
    inner, jadam = (ts.inner if loss_scaled else ts), _jax_adam(js)
    assert int(inner.count) == int(jadam.count) == 7
    for k, dt in dtypes.items():
        for t_m, j_m in ((inner.mu[k], jadam.mu[k]), (inner.nu[k], jadam.nu[k])):
            assert str(t_m.dtype).replace("torch.", "") == str(j_m.dtype) == dt, k
            if dt == "bfloat16":
                np.testing.assert_array_equal(_np(t_m), _jnp_np(j_m), err_msg=k)
            else:
                np.testing.assert_allclose(_np(t_m), _jnp_np(j_m), rtol=1e-5, atol=1e-10, err_msg=k)
    if loss_scaled:
        assert float(ts.scale) == 2.0**14 and int(ts.overflows) == 1 and int(ts.good_steps) == 3


# -- fp8 -----------------------------------------------------------------------

def _e4m3_boundaries() -> np.ndarray:
    """Every e4m3 value between 2^-10 and 512, the midpoints between
    neighbours (ties), one float32 ulp either side of each, their
    negations, and the probe's values."""
    grid = np.arange(256, dtype=np.uint8).view(ml_dtypes.float8_e4m3fn).astype(np.float32)
    grid = np.unique(grid[np.isfinite(grid) & (grid >= 0)])
    grid = np.concatenate([grid, [480.0, 512.0]]).astype(np.float32)  # past the range
    mids = ((grid[1:].astype(np.float64) + grid[:-1]) / 2).astype(np.float32)
    pts = np.concatenate([grid, mids])
    pts = pts[(pts >= 2.0**-10) & (pts <= 512)]
    pts = np.concatenate([pts, np.nextafter(pts, np.float32(0)), np.nextafter(pts, np.float32(np.inf))])
    probe = np.array([480, 500, 1e6, np.inf, 449, 464, 465, 0.0015, 0.0009765625, np.nan, 0.0], np.float32)
    pts = np.concatenate([pts, probe])
    return np.concatenate([pts, -pts]).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_e4m3_cast_matches_jax(dtype):
    """The port's fp8 cast rounds as JAX's does, and gives NaN wherever
    JAX's does (above 464, infinities, NaN), from float32 (the forward
    pass) and from bf16 (the backward pass's cotangent)."""
    x = _e4m3_boundaries()
    jx = jnp.asarray(x).astype(dtype)
    want = np.asarray(jax.jit(lambda v: v.astype(jnp.float8_e4m3fn).astype(jnp.float32))(jx))
    got = prec.e4m3(torch.from_numpy(x).to(getattr(torch, dtype))).to(torch.float32).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    assert nan.sum() > 10


def _fp8_operands(seed=0):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=(8, 17)) * 2.0).astype(np.float32)
    w = (rng.normal(size=(17, 64)) * 0.3).astype(np.float32)
    return x, w


def _jax_fp8(x, w):
    dims = (((x.ndim - 1,), (0,)), ((), ()))
    return jprec.fp8_dot_general(x, w, dims)


@pytest.mark.parametrize("ct_scale", [1.0, 2.0**15, 2.0**24])
def test_fp8_linear_matches_jax(ct_scale):
    """``fp8_linear`` on [8, 17] x [17, 64] bf16 operands against the
    reference's ``fp8_dot_general``: forward within one bf16 ulp, the
    gradients of ``sum(out * ct)`` for both operands bit for bit but at
    the absolute-max element (see the module doc), NaN where JAX's are.
    At 2^15 some cotangents pass 464 after the e4m3 cast, at 2^24 most."""
    x, w = _fp8_operands()
    ct = (np.random.default_rng(3).normal(size=(8, 64)) * ct_scale).astype(np.float32)
    jx, jw = jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)
    jct = jnp.asarray(ct)

    def jloss(a, b):
        return jnp.sum(_jax_fp8(a, b).astype(jnp.float32) * jct)

    j_out = np.asarray(jax.jit(_jax_fp8)(jx, jw), np.float32)
    jgx, jgw = map(_jnp_np, jax.jit(jax.grad(jloss, argnums=(0, 1)))(jx, jw))

    tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
    tw = torch.from_numpy(w).to(torch.bfloat16).requires_grad_(True)
    out = prec.fp8_linear(tx, tw.t())
    assert out.dtype == torch.bfloat16
    ulp = np.abs(j_out) * 2.0**-7 + 1e-30
    assert np.all(np.abs(_np(out) - j_out) <= ulp)
    gx, gw = torch.autograd.grad((out.to(torch.float32) * torch.from_numpy(ct)).sum(), (tx, tw))
    for got, want, operand in ((_np(gx), jgx, x), (_np(gw), jgw, w)):
        np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
        at_max = np.abs(operand.astype(ml_dtypes.bfloat16).astype(np.float32))
        at_max = at_max == at_max.max()
        np.testing.assert_array_equal(got[~at_max], want[~at_max])
        ok = np.isnan(want[at_max]) | (np.abs(got[at_max] - want[at_max]) <= np.abs(want[at_max]) * 2.0**-7)
        assert ok.all()
    if ct_scale == 1.0:
        assert np.isfinite(jgx).all() and np.isfinite(jgw).all()
    else:
        assert np.isnan(jgx).any() and np.isnan(jgw).any() and not np.isnan(jgw).all()


@pytest.mark.parametrize("poison", ["x_nan", "x_inf", "w_neg_inf", "x_huge"])
def test_fp8_linear_forward_on_nonfinite_operands_matches_jax(poison):
    """The forward quantization is torch's saturating cast with no NaN
    rule (ops/precision.py's module doc): a NaN or infinite operand makes
    its scale NaN or infinite, so the product is NaN where JAX's is, and
    a huge finite operand scales onto 448 as any other does. Held to
    ``fp8_dot_general`` at the one-bf16-ulp bar, NaN for NaN."""
    x, w = _fp8_operands(seed=5)
    if poison == "x_nan":
        x[2, 3] = np.nan
    elif poison == "x_inf":
        x[0, 0] = np.inf
    elif poison == "w_neg_inf":
        w[4, 7] = -np.inf
    else:
        x[1, 1] = 3e38
    want = np.asarray(jax.jit(_jax_fp8)(jnp.asarray(x, jnp.bfloat16), jnp.asarray(w, jnp.bfloat16)), np.float32)
    got = _np(prec.fp8_linear(torch.from_numpy(x).to(torch.bfloat16), torch.from_numpy(w).to(torch.bfloat16).t()))
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    assert nan.any() == (poison != "x_huge")
    assert np.all(np.abs(got[~nan] - want[~nan]) <= np.abs(want[~nan]) * 2.0**-7)


# -- PPO: the learn under each policy ------------------------------------------

PPO_LR, PPO_STEPS = 3e-4, 16  # the default lr; 4 epochs x 4 minibatches
ONE_STEP = dict(epochs=1, num_minibatches=1)


def _jax_adam(opt_state):
    """The ``ScaleByAdamState`` inside a reference optimizer state."""
    is_adam = lambda n: isinstance(n, optax.ScaleByAdamState)  # noqa: E731
    return next(x for x in jax.tree_util.tree_leaves(opt_state, is_leaf=is_adam) if is_adam(x))


def assert_one_adam_step_matches(old, t_new, j_new, j_mu, lr, max_flips, near_zero=0.01):
    """One Adam step from the same parameters (``old``), the port's
    (``t_new``) against JAX's (``j_new``, numpy in the port's layout, and
    its first moment ``j_mu``, which is (1 - b1) * g after one step): the
    update of every element within lr / 10 of JAX's, but at sign flips,
    each where JAX's |g| is at most ``near_zero`` of its leaf's largest,
    and in at most ``max_flips`` of all the elements (the module doc's
    bars)."""
    assert set(j_new) == set(t_new)
    flips = total = 0
    for k, want in j_new.items():
        before = _np(old[k])
        off = np.abs((_np(t_new[k]) - before) - (np.asarray(want, np.float32) - before)) > lr / 10
        g = np.abs(np.asarray(j_mu[k], np.float32))
        assert np.all(g[off] <= near_zero * g.max()), (k, g[off].max() / g.max())
        flips, total = flips + int(off.sum()), total + off.size
    assert flips <= max_flips * total, (flips, total)


def _ppo_specs():
    f32 = np.dtype(np.float32)
    return (JaxEnvSpecs(obs=JaxArraySpec((OBS,), f32), action=JaxArraySpec((ACT,), f32)),
            EnvSpecs(obs=ArraySpec((OBS,), f32), action=ArraySpec((ACT,), f32)))


def _ppo_tree(precision: str, model: dict | None = None, one_step: bool = False) -> dict:
    return dict(algo=dict(name="ppo", precision=precision, **(ONE_STEP if one_step else {})), model=model or {})


@functools.lru_cache(maxsize=None)
def _jax_ppo(precision: str, model_dtype: str = "auto", one_step: bool = False):
    """One JAX PPO learner and its jitted learn per policy, shared by the
    tests here (each build costs a compile)."""
    jl = jax_build_learner(JaxConfig(_ppo_tree(precision, {"dtype": model_dtype}, one_step)), _ppo_specs()[0])
    return jl, jax.jit(jl.learn)


@functools.lru_cache(maxsize=1)
def _jax_ppo_init():
    jl, _ = _jax_ppo("f32")
    return jax.jit(jl.init)(jax.random.key(0))


def _ppo_batch(T, B, seed):
    """A learner batch with one termination and one truncation."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T, B, OBS)).astype(np.float32)
    next_obs = np.concatenate([obs[1:], rng.normal(size=(1, B, OBS))], 0).astype(np.float32)
    done = np.zeros((T, B), bool)
    done[2, 3] = done[5, 0] = True
    terminated = np.zeros((T, B), bool)
    terminated[2, 3] = True
    mean = (0.3 * rng.normal(size=(T, B, ACT))).astype(np.float32)
    log_std = np.full((T, B, ACT), -0.5, np.float32)
    action = (mean + np.exp(log_std) * rng.normal(size=(T, B, ACT))).astype(np.float32)
    logp = np.asarray(JD.diag_gauss_logp(jnp.asarray(mean), jnp.asarray(log_std), jnp.asarray(action)))
    return {
        "obs": obs, "next_obs": next_obs, "action": action,
        "reward": rng.normal(size=(T, B)).astype(np.float32),
        "done": done, "terminated": terminated, "behavior_logp": logp,
        "behavior": {"mean": mean, "log_std": log_std},
    }


def _ppo_perms(key, n, epochs=4, num_mb=4):
    """The block permutations PPO's _sgd_epochs draws from its learn key
    (by default 4 epochs; 4 minibatches of 16 blocks at T * B = 128)."""
    from surreal_tpu.learners.ppo import _block_layout

    domain = num_mb * _block_layout(n, num_mb, OBS * 4)
    return torch.from_numpy(np.stack([
        np.asarray(jax.random.permutation(k, domain)) for k in jax.random.split(key, epochs)]))


def _ppo_pair(precision: str, model_dtype: str = "auto", one_step: bool = False):
    """JAX and port learners under ``precision``, and the same start state
    in each: the shared f32 init's params (cast to the model's parameter
    dtypes), each learner's fresh optimizer state."""
    jl, jlearn = _jax_ppo(precision, model_dtype, one_step)
    tl = build_learner(Config(_ppo_tree(precision, {"dtype": model_dtype}, one_step)), _ppo_specs()[1], device="cpu")
    j0 = _jax_ppo_init()
    shapes = jax.eval_shape(jl.model.init, jax.random.key(0), jnp.zeros((1, OBS)))
    jparams = jax.tree.map(lambda x, s: x.astype(s.dtype), j0.params, shapes)
    j_state = j0._replace(params=jparams, opt_state=jl.tx.init(jparams))
    t_state = tl.state_from_params(params_from_jax(jax.tree.map(_jnp_np, jparams)))
    return jl, jlearn, tl, j_state, t_state


@pytest.mark.parametrize("precision,model_dtype,max_flips,near_zero", [
    ("bf16", "auto", 5e-3, 1e-2),
    ("bf16_fp8", "auto", 2e-2, 1e-1),
    # bf16 parameters: under 'mixed' (the reference's init cannot draw them
    # on the CPU, and its loss-scaled chain cannot carry them; ROADMAP §3)
    ("mixed", "bfloat16", 5e-3, 1e-2),
])
def test_ppo_learn_matches_jax_under_precision(precision, model_dtype, max_flips, near_zero):
    """A one-step learn (one epoch, one minibatch) from the same params,
    batch and permutation: the metrics at the bf16 bar and each element's
    update at the module doc's bars. The port's state keeps each leaf's
    dtype (bf16 trunks and moments under bf16 parameters) and the
    loss-scale bookkeeping equals the reference's."""
    jl, jlearn, tl, j_state, t_state = _ppo_pair(precision, model_dtype, one_step=True)
    T, B = 8, 16
    batch = _ppo_batch(T, B, seed=1)
    key = jax.random.key(2)
    j_new, j_metrics = jlearn(j_state, jax.tree.map(jnp.asarray, batch), key)
    t_new, t_metrics = tl.learn(t_state, jax.tree.map(torch.from_numpy, batch),
                                perms=_ppo_perms(key, T * B, epochs=1, num_mb=1))

    assert set(t_metrics) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), err_msg=k, **BF16_TOL)
    assert_one_adam_step_matches(
        t_state.params, t_new.params, params_from_jax(jax.tree.map(_jnp_np, j_new.params)),
        params_from_jax(jax.tree.map(_jnp_np, _jax_adam(j_new.opt_state).mu)), PPO_LR, max_flips, near_zero)
    flat = {jax.tree_util.keystr(p): x for p, x in jax.tree_util.tree_flatten_with_path(j_new.params)[0]}
    n_bf16 = sum(str(x.dtype) == "bfloat16" for x in flat.values())
    assert sum(v.dtype == torch.bfloat16 for v in t_new.params.values()) == n_bf16
    if tl.policy.loss_scaling:
        for f in ("scale", "good_steps", "overflows"):
            assert float(getattr(t_new.opt_state, f)) == float(getattr(j_new.opt_state, f)), f
        assert float(t_metrics["precision/loss_scale"]) == 2.0**15
        inner = t_new.opt_state.inner
    else:
        inner = t_new.opt_state
    for k, p in t_new.params.items():
        assert inner.mu[k].dtype == inner.nu[k].dtype == p.dtype, k


def test_bf16_parameters_under_loss_scaling():
    """A fault of the reference that the port repairs (ROADMAP §3): with
    ``model.dtype='bfloat16'`` under loss scaling, the reference's unscale
    ``g / scale`` promotes the bf16 gradients to float32, so Adam's
    moments come out float32 on a finite step and bf16 on a skip, and its
    ``lax.cond`` refuses to trace. The port casts each unscaled gradient
    back to its leaf's dtype (exact: the scale is a power of two), so
    'bf16' with bf16 parameters learns, within 1e-5 of 'mixed' with them."""
    jl, jlearn, tl, j_state, t_state = _ppo_pair("bf16", "bfloat16")
    T, B = 8, 16
    batch = _ppo_batch(T, B, seed=12)
    key = jax.random.key(13)
    with pytest.raises(TypeError, match="cond branches"):
        jlearn(j_state, jax.tree.map(jnp.asarray, batch), key)
    t_batch, perms = jax.tree.map(torch.from_numpy, batch), _ppo_perms(key, T * B)
    new, metrics = tl.learn(t_state, t_batch, perms=perms)
    _, _, tm, _, tm_state = _ppo_pair("mixed", "bfloat16")
    want, _ = tm.learn(tm_state, t_batch, perms=perms)
    assert float(metrics["precision/loss_scale"]) == 2.0**15 and float(metrics["health/nonfinite"]) == 0.0
    for k, v in want.params.items():
        assert new.params[k].dtype == v.dtype and new.opt_state.inner.mu[k].dtype == v.dtype, k
        np.testing.assert_allclose(_np(new.params[k]), _np(v), rtol=0, atol=1e-5, err_msg=k)


def test_ppo_bf16_matches_mixed():
    """The port's 'bf16' against its 'mixed' at 1e-5, the reference's rule:
    both compute in bf16, 'bf16' moves the obs cast to staging (the same
    rounding point) and scales the loss by powers of two (exact)."""
    T, B = 8, 16
    batch = jax.tree.map(torch.from_numpy, _ppo_batch(T, B, seed=5))
    perms = _ppo_perms(jax.random.key(6), T * B)
    out = {}
    for precision in ("mixed", "bf16"):
        _, _, tl, _, t_state = _ppo_pair(precision)
        out[precision] = tl.learn(t_state, batch, perms=perms)
    (sm, mm), (s16, m16) = out["mixed"], out["bf16"]
    for k in ("loss/pg", "loss/value", "policy/kl"):
        np.testing.assert_allclose(float(m16[k]), float(mm[k]), rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in sm.params.items():
        np.testing.assert_allclose(s16.params[k].numpy(), v.numpy(), rtol=0, atol=1e-5, err_msg=k)


def test_nan_guard_trips_on_true_nan_under_loss_scaling():
    """A poisoned batch under 'bf16' (the mirror of the reference's test):
    every minibatch step is skipped, so the parameters and Adam's state are
    bit-unchanged; the health guard still reports the nonfinite gradient;
    the overflows count the 16 minibatches and the scale backs off to
    ``ls_min`` (1.0 is reached after 15 halvings of 2^15), as JAX's."""
    jl, jlearn, tl, j_state, t_state = _ppo_pair("bf16")
    T, B = 8, 16
    batch = _ppo_batch(T, B, seed=7)
    batch["reward"][0, 0] = np.inf
    key = jax.random.key(8)
    j_new, j_metrics = jlearn(j_state, jax.tree.map(jnp.asarray, batch), key)
    t_new, t_metrics = tl.learn(t_state, jax.tree.map(torch.from_numpy, batch), perms=_ppo_perms(key, T * B))
    for m in (t_metrics, j_metrics):
        assert float(m["health/nonfinite"]) == 1.0
        assert float(m["precision/overflows"]) == PPO_STEPS and float(m["precision/loss_scale"]) == 1.0
    for k, v in t_state.params.items():
        assert torch.equal(t_new.params[k], v), k
    old, new = t_state.opt_state.inner, t_new.opt_state.inner
    assert torch.equal(old.count, new.count) and all(torch.equal(old.mu[k], new.mu[k]) for k in old.mu)
    assert all(torch.equal(old.nu[k], new.nu[k]) for k in old.nu)


def test_loss_scale_growth_inside_one_learn_matches_jax():
    """Both packages started one step short of the growth interval
    (``loss_scale_state_from_jax``): the scale doubles at the first
    minibatch and the run of good steps restarts, in both."""
    jl, jlearn, tl, j_state, t_state = _ppo_pair("bf16")
    interval = tl.policy.ls_growth_interval
    j_ls = j_state.opt_state._replace(good_steps=jnp.asarray(interval - 1, jnp.int32))
    j_state = j_state._replace(opt_state=j_ls)
    t_state = t_state._replace(opt_state=loss_scale_state_from_jax(j_ls, t_state.opt_state.inner))
    T, B = 8, 16
    batch = _ppo_batch(T, B, seed=9)
    key = jax.random.key(10)
    j_new, _ = jlearn(j_state, jax.tree.map(jnp.asarray, batch), key)
    t_new, t_metrics = tl.learn(t_state, jax.tree.map(torch.from_numpy, batch), perms=_ppo_perms(key, T * B))
    assert float(t_new.opt_state.scale) == float(j_new.opt_state.scale) == 2.0**16
    assert int(t_new.opt_state.good_steps) == int(j_new.opt_state.good_steps) == PPO_STEPS - 1
    assert float(t_metrics["precision/loss_scale"]) == 2.0**16


# -- DDPG: an update on bf16 replay storage ------------------------------------

def test_ddpg_update_on_bf16_replay_matches_jax():
    """'bf16' stores obs and next_obs in bf16 (reward and discount stay
    float32): the same transitions inserted into both rings give the same
    bf16 storage bit for bit and the same gathered rows; one update on
    them (two loss scales, one per chain) agrees at the bf16 bars."""
    from surreal_tpu.replay.base import init_ring as jax_init_ring
    from surreal_tpu.replay.base import ring_gather as jax_ring_gather
    from surreal_tpu.replay.base import ring_insert as jax_ring_insert
    from surreal_tpu_torch.replay.base import init_ring, ring_gather, ring_insert
    from surreal_tpu_torch.utils.convert import ddpg_params_from_jax

    jspecs, tspecs = _ppo_specs()
    tree = dict(algo=dict(name="ddpg", precision="bf16"))
    jl = jax_build_learner(JaxConfig(tree), jspecs)
    tl = build_learner(Config(tree), tspecs, device="cpu")
    rng = np.random.default_rng(11)
    n, cap = 48, 64
    trans = {
        "obs": rng.normal(size=(n, OBS)).astype(np.float32),
        "next_obs": rng.normal(size=(n, OBS)).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(n, ACT)).astype(np.float32),
        "reward": rng.normal(size=n).astype(np.float32),
        "discount": np.full(n, 0.99, np.float32),
    }
    dd = {"obs": tl.policy.data_dtype, "next_obs": tl.policy.data_dtype}
    j_example = {k: jnp.zeros(v.shape[1:], dd.get(k, "float32")) for k, v in trans.items()}
    t_example = {k: torch.zeros(v.shape[1:], dtype=prec.torch_dtype(dd.get(k, "float32"))) for k, v in trans.items()}
    j_ring = jax_ring_insert(jax_init_ring(j_example, cap), jax.tree.map(jnp.asarray, trans), cap)
    t_ring = ring_insert(init_ring(t_example, cap), {k: torch.from_numpy(v) for k, v in trans.items()}, cap)
    assert t_ring.storage["obs"].dtype == torch.bfloat16 and t_ring.storage["reward"].dtype == torch.float32
    for k, v in j_ring.storage.items():
        np.testing.assert_array_equal(_np(t_ring.storage[k]), _jnp_np(v), err_msg=k)
    idx = rng.integers(0, n, 32).astype(np.int32)
    j_batch = jax_ring_gather(j_ring, jnp.asarray(idx))
    t_batch = ring_gather(t_ring, torch.from_numpy(idx))

    j_state = jax.jit(jl.init)(jax.random.key(12))
    t_state = tl.state_from_params(*ddpg_params_from_jax(jax.tree.map(np.asarray, j_state.actor_params),
                                                         jax.tree.map(np.asarray, j_state.critic_params)))
    j_new, j_metrics = jax.jit(jl.learn)(j_state, j_batch, jax.random.key(13))
    t_new, t_metrics = tl.learn(t_state, t_batch)
    assert set(t_metrics) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(_np(t_metrics[k]), _jnp_np(j_metrics[k]), err_msg=k, **BF16_TOL)
    # one Adam step on each net, at the one-step bars of the module doc
    want = ddpg_params_from_jax(jax.tree.map(_jnp_np, j_new.actor_params), jax.tree.map(_jnp_np, j_new.critic_params))
    mus = ddpg_params_from_jax(jax.tree.map(_jnp_np, _jax_adam(j_new.actor_opt).mu),
                               jax.tree.map(_jnp_np, _jax_adam(j_new.critic_opt).mu))
    lr = tl.config.algo.actor_lr, tl.config.algo.critic_lr
    for old, got, w, mu, lr, bars in zip((t_state.actor_params, t_state.critic_params),
                                         (t_new.actor_params, t_new.critic_params), want, mus, lr,
                                         ((3e-2, 3e-2), (5e-3, 2e-2))):
        assert_one_adam_step_matches(old, got, w, mu, lr, *bars)
    for chain in ("actor_opt", "critic_opt"):
        assert float(getattr(t_new, chain).scale) == float(getattr(j_new, chain).scale) == 2.0**15
    assert float(t_metrics["precision/overflows"]) == 0.0


# -- checkpoints ---------------------------------------------------------------

def _session_cfg(folder: str, precision: str):
    from surreal_tpu_torch.session.default_configs import base_config

    return Config(
        learner_config=Config(algo=Config(name="ppo", precision=precision, horizon=8, epochs=1, num_minibatches=2)),
        env_config=Config(name="jax:pendulum", num_envs=8),
        session_config=Config(
            folder=folder, backend="cpu",
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=1), eval=Config(every_n_iters=0),
        ),
    ).extend(base_config())


def test_loss_scale_checkpoint_round_trip(tmp_path):
    """A 'bf16' session saves its ``LossScaleState`` with the learner state
    and a resume restores it bit for bit; a relaunch under 'mixed' in the
    same folder stops with ``PrecisionMismatchError`` before any array is
    read (the mirror of the reference's
    ``test_precision_mismatch_fails_restore_loudly``)."""
    from surreal_tpu_torch.launch.trainer import Trainer
    from surreal_tpu_torch.session.checkpoint import CheckpointManager, PrecisionMismatchError

    folder = str(tmp_path)
    state, _ = Trainer(_session_cfg(folder, "bf16"), device="cpu").run(max_env_steps=2 * 64)
    saved = state.opt_state
    assert isinstance(saved, prec.LossScaleState) and int(saved.good_steps) == 4
    mgr = CheckpointManager(folder)
    restored, meta = mgr.restore(state)
    assert int(meta["iteration"]) == 2
    for f in ("scale", "good_steps", "overflows"):
        assert torch.equal(getattr(restored.opt_state, f), getattr(saved, f)), f
    assert mgr.run_metadata() == prec.resolve_policy(_session_cfg(folder, "bf16").learner_config).meta()
    with pytest.raises(PrecisionMismatchError, match="algo.precision"):
        Trainer(_session_cfg(folder, "mixed"), device="cpu").run(max_env_steps=3 * 64)
    resumed, _ = Trainer(_session_cfg(folder, "bf16"), device="cpu").run(max_env_steps=3 * 64)
    assert int(resumed.opt_state.good_steps) == 6 and int(resumed.iteration) == 3


def _tiny_bf16(tmp_path, algo="ppo", **session):
    import tests.test_torch_recovery as rec

    cfg = rec._tiny(tmp_path, algo, **session)
    cfg.learner_config.algo.precision = "bf16"
    return cfg


def test_nan_state_rolls_back_under_loss_scaling(tmp_path):
    """Loss scaling is the first fence, the divergence guard the second: a
    ``nan_state`` fault (NaN parameters, not NaN gradients) under 'bf16'
    makes every step a skip that cannot heal the parameters, the window
    still reports ``health/nonfinite``, and the run rolls back to the last
    finite checkpoint with the LR scale written inside the
    ``LossScaleState``'s chain state."""
    from surreal_tpu_torch.launch.trainer import Trainer
    from surreal_tpu_torch.utils import faults

    cfg = _tiny_bf16(tmp_path, faults={"plan": [{"site": "trainer.iteration", "kind": "nan_state", "at": 3}]})
    seen = []
    try:
        state, m = Trainer(cfg, device="cpu").run(max_env_steps=6 * 64, on_metrics=lambda i, m: seen.append(
            (i, m["health/nonfinite"], m["precision/overflows"])))
    finally:
        faults.configure(None)
    assert [(i, n) for i, n, _ in seen[:4]] == [(1, 0.0), (2, 0.0), (3, 0.0), (4, 1.0)]
    assert seen[3][2] > seen[2][2]  # the poisoned learn's steps were skipped
    assert [i for i, _, _ in seen[4:]] == [3, 4, 5, 6] and all(n == 0.0 for _, n, _ in seen[4:])
    assert isinstance(state.opt_state, prec.LossScaleState) and get_recovery_lr_scale(state) == 0.5
    assert all(v == v for k, v in m.items() if k != "episode/return")


def test_ddpg_include_replay_round_trip_in_bf16(tmp_path):
    """Under 'bf16' DDPG's ``include_replay`` checkpoint saves the bf16 obs
    storage and both chains' loss-scale states; the relaunch starts from
    them bit for bit."""
    from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer
    from surreal_tpu_torch.session.checkpoint import CheckpointManager
    from surreal_tpu_torch.utils.tree import tree_flatten

    cfg = _tiny_bf16(tmp_path, "ddpg", checkpoint={"every_n_iters": 3, "include_replay": True})
    tr = OffPolicyTrainer(cfg, device="cpu")
    state, _ = tr.run(max_env_steps=3 * 32)
    replay_template = tr.replay.init(tr._replay_example())
    saved = CheckpointManager(str(tmp_path)).restore_extra({"replay": replay_template}, step=3)["replay"]
    assert saved.ring.storage["obs"].dtype == torch.bfloat16 and saved.ring.size == 96
    seen = {}
    tr2 = OffPolicyTrainer(cfg, device="cpu")
    inner = tr2._device_train_iter

    def first_call(st, replay_state, carry, **kw):
        if not seen:
            seen["state"] = tree_flatten(st)
            seen["replay"] = {k: v.clone() if isinstance(v, torch.Tensor) else v
                              for k, v in tree_flatten(replay_state).items()}
        return inner(st, replay_state, carry, **kw)

    tr2._device_train_iter = first_call
    tr2.run(max_env_steps=4 * 32)
    want = tree_flatten(saved)
    assert seen["replay"].keys() == want.keys()
    for k, v in want.items():
        got = seen["replay"][k]
        assert (got.dtype == v.dtype and torch.equal(got, v)) if isinstance(v, torch.Tensor) else got == v, k
    for chain in ("actor_opt", "critic_opt"):
        for f in ("scale", "good_steps", "overflows"):
            assert torch.equal(seen["state"][f"{chain}/{f}"], getattr(getattr(state, chain), f)), (chain, f)


# -- every path of the port under the loss-scaled policies ----------------------

SMALL_PONG_CNN = dict(enabled=True, channels=[8, 16], kernels=[4, 3], strides=[2, 1], dense=32)
PATHS = {
    # name: (algo, env, learner overrides, env overrides, session topology)
    "device-ppo": ("ppo", "jax:lift", dict(epochs=1, num_minibatches=2), {}, {}),
    "device-ppo-trajectory": ("ppo", "jax:pendulum", dict(epochs=1, num_minibatches=2),
                              {}, {"model": dict(encoder=dict(kind="trajectory", features=16, num_layers=1,
                                                              num_heads=2, head_dim=8))}),
    "device-impala": ("impala", "jax:pong16", {}, {}, {"model": dict(cnn=SMALL_PONG_CNN)}),
    "device-ddpg": ("ddpg", "jax:lift", dict(updates_per_iter=2, exploration=dict(warmup_steps=64)), {}, {}),
    "host-ppo": ("ppo", "gym:Pendulum-v1", dict(epochs=1, num_minibatches=2), {}, {}),
    "host-impala": ("impala", "gym:CartPole-v1", {}, {}, {}),
    "host-ddpg": ("ddpg", "gym:Pendulum-v1", dict(updates_per_iter=2, exploration=dict(warmup_steps=64)), {}, {}),
    "seed-ppo": ("ppo", "gym:Pendulum-v1", dict(epochs=1, num_minibatches=2), {}, {"workers": 1}),
    "seed-impala": ("impala", "gym:CartPole-v1", {}, {}, {"workers": 1}),
}


@pytest.mark.parametrize("precision", ["bf16", "bf16_fp8"])
@pytest.mark.parametrize("path", list(PATHS))
def test_every_path_learns_under_loss_scaled_policies(tmp_path, path, precision):
    """``train`` at 'bf16' and 'bf16_fp8' on each path of the port (the
    fused device loop, the host loops, SEED with one worker; PPO, IMPALA,
    DDPG with prioritized replay), through ``select_trainer`` as the CLI
    does, on the CPU: every metric finite, the loss-scale telemetry in
    the rows that learned, the replay obs stored in bf16."""
    from surreal_tpu_torch.main.launch import select_trainer
    from surreal_tpu_torch.session.default_configs import base_config

    algo, env, learner_algo, env_over, extra = PATHS[path]
    workers = extra.get("workers", 0)
    learner = dict(algo=dict(name=algo, horizon=8, precision=precision, **learner_algo), **extra.get("model", {}) and
                   {"model": extra["model"]})
    if algo == "ddpg":
        learner["replay"] = dict(kind="prioritized", capacity=512, start_sample_size=64, batch_size=16)
    cfg = Config(
        learner_config=learner,
        env_config=dict(name=env, num_envs=8, **env_over),
        session_config=dict(
            folder=str(tmp_path), total_env_steps=3 * 64,
            metrics=dict(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=dict(every_n_iters=0), eval=dict(every_n_iters=0),
            topology=dict(num_env_workers=workers),
        ),
    ).extend(base_config())
    trainer = select_trainer(cfg, device="cpu")
    assert trainer.learner.policy.loss_scaling and trainer.learner.policy.fp8 == (precision == "bf16_fp8")
    rows = []
    state, _ = trainer.run(on_metrics=lambda it, m: rows.append(m))
    assert rows
    for m in rows:
        for k, v in m.items():
            assert np.isfinite(v) or k == "episode/return", (k, v)
    learned = [m for m in rows if m.get("precision/loss_scale", 0.0) > 0]
    assert learned and all(m["precision/loss_scale"] == 2.0**15 for m in learned)
    if algo == "ddpg":
        assert state.actor_opt.scale.dtype == torch.float32
        assert trainer.replay.init(trainer._replay_example()).ring.storage["obs"].dtype == torch.bfloat16
    else:
        assert isinstance(state.opt_state, prec.LossScaleState)
