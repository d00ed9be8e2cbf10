"""The return and V-trace ops of the PyTorch port under the reference's
contract, and their 'assoc' forms, against the JAX package on identical
inputs (made from a numpy seed):

- ``ops/returns.py::{gae_advantages, discounted_returns}`` and
  ``ops/vtrace.py::{vtrace, vtrace_nextobs}`` take [T, ...] of any rank,
  accept ``unroll`` and return the reference's dtype (bf16 in, bf16 out);
- ``reverse_linear_scan_assoc``, ``gae_advantages_assoc``, ``vtrace_assoc``
  and ``vtrace_nextobs_assoc`` solve the reference's ``associative_scan``
  recurrence with the sequential reverse scan (``csrc/rev_scan.cu`` on the
  card);
- on the card (marker ``cuda``), a PPO learn at ``gae_impl='assoc'``
  launches the scan kernel once and matches the same learn on the CPU.

This file imports nothing of the JAX package that needs orbax, so its card
test collects on the card's machine.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.ops import returns as JR
from surreal_tpu.ops import vtrace as JV
from surreal_tpu_torch.ops import returns as R
from surreal_tpu_torch.ops import rev_scan as RS
from surreal_tpu_torch.ops import vtrace as V

GAMMA, LAM = 0.99, 0.95
# f32: the reference's own bar for a T-step recurrence in another framework
# (tests/test_torch_ops.py GAE_TOL): each step may round an ulp apart, as
# XLA contracts a * b + c into one FMA where the port rounds twice.
F32_TOL = dict(rtol=1e-5, atol=1e-5)
# bf16: the reference's scan carries bf16 and rounds each of a step's four
# or so operations to 8 mantissa bits (2**-9 relative each); the port
# computes in f32 and rounds once at the end. Over T = 5-6 steps at values
# of order 1-5 the two differ by a few bf16 ulps of the result (at most
# 0.047, three ulps at 4.4, on these inputs).
BF16_TOL = dict(rtol=4e-2, atol=4e-2)
# 'assoc': XLA's associative_scan reassociates the recurrence's sum (a
# log-depth tree of products and sums), the port runs it in order; the two
# differ by the rounding of the products of up to T coefficients: at most
# 1.5e-6 here, at T <= 64 and values of order 1-10.
ASSOC_TOL = dict(rtol=1e-5, atol=1e-5)

SHAPE = (3, 2)  # batch dims after T: [T, 3, 2] folds into [T, 6] columns


def _np_inputs(op, T, batch, seed):
    """The op's positional inputs as numpy float32, made from ``seed``:
    15% episode ends (half of them true terminations), log-ratios of order
    0.3 so that every V-trace clip acts."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    done = rng.random((T, *batch)) < 0.15
    disc = (GAMMA * ~done).astype(np.float32)
    if op in ("gae", "gae_assoc"):
        return [f(T, *batch), disc, f(T + 1, *batch)]
    if op == "returns":
        return [f(T, *batch), disc, f(*batch)]
    if op == "scan_assoc":
        return [disc * LAM, f(T, *batch)]
    bl = f(T, *batch) * 0.5 - 1.0
    tl = bl + 0.3 * f(T, *batch)
    if op in ("vtrace", "vtrace_assoc"):
        return [bl, tl, f(T, *batch), disc, f(T + 1, *batch)]
    terminated = done & (rng.random((T, *batch)) < 0.5)
    return [bl, tl, f(T, *batch), f(T, *batch), f(T, *batch), done, terminated]


def _calls(op, dtype, unroll=None):
    """(port function, JAX function) over the op's inputs, with the
    reference's keyword arguments."""
    kw = {} if unroll is None else {"unroll": unroll}
    nextobs_kw = dict(gamma=GAMMA, clip_rho=1.0, clip_c=0.9, clip_pg_rho=1.1)
    return {
        "gae": (lambda *x: R.gae_advantages(*x, LAM, **kw), lambda *x: JR.gae_advantages(*x, LAM, **kw)),
        "returns": (lambda *x: R.discounted_returns(*x, **kw), lambda *x: JR.discounted_returns(*x, **kw)),
        "vtrace": (lambda *x: V.vtrace(*x, **kw), lambda *x: JV.vtrace(*x, **kw)),
        "vtrace_nextobs": (lambda *x: V.vtrace_nextobs(*x, **nextobs_kw, **kw),
                           lambda *x: JV.vtrace_nextobs(*x, **nextobs_kw, **kw)),
        "scan_assoc": (R.reverse_linear_scan_assoc, JR.reverse_linear_scan_assoc),
        "gae_assoc": (lambda *x: R.gae_advantages_assoc(*x, LAM), lambda *x: JR.gae_advantages_assoc(*x, LAM)),
        "vtrace_assoc": (V.vtrace_assoc, JV.vtrace_assoc),
        "vtrace_nextobs_assoc": (lambda *x: V.vtrace_nextobs_assoc(*x, **nextobs_kw),
                                 lambda *x: JV.vtrace_nextobs_assoc(*x, **nextobs_kw)),
    }[op]


def _run_both(op, arrays, dtype, unroll=None):
    """The op on identical inputs in both packages, the float inputs in
    ``dtype`` (bool masks stay bool); returns (port outputs, JAX outputs)
    as tuples."""
    port, ref = _calls(op, dtype, unroll)
    jdtype = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16}[dtype]
    j_in = [jnp.asarray(a) if a.dtype == bool else jnp.asarray(a).astype(jdtype) for a in arrays]
    t_in = [torch.from_numpy(a) if a.dtype == bool else torch.from_numpy(a).to(dtype) for a in arrays]
    got, want = port(*t_in), jax.jit(ref)(*j_in)
    as_tuple = lambda x: tuple(x) if isinstance(x, tuple) else (x,)  # noqa: E731
    return as_tuple(got), as_tuple(want)


def _assert_close(got, want, dtype, tol):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == dtype and not g.requires_grad
        assert tuple(g.shape) == w.shape
        np.testing.assert_allclose(g.float().numpy(), np.asarray(w.astype(jnp.float32)), **tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("op,T", [("gae", 6), ("returns", 6), ("vtrace", 5), ("vtrace_nextobs", 5)])
def test_return_ops_match_jax_at_rank_3_with_unroll(op, T, dtype):
    """[T, 3, 2] inputs and ``unroll=2``, in f32 and bf16: the reference's
    contract (its dtype out), at F32_TOL or BF16_TOL."""
    got, want = _run_both(op, _np_inputs(op, T, SHAPE, seed=T), dtype, unroll=2)
    _assert_close(got, want, dtype, F32_TOL if dtype == torch.float32 else BF16_TOL)


@pytest.mark.parametrize("op", ["gae", "returns", "vtrace", "vtrace_nextobs"])
def test_return_ops_match_jax_at_rank_1(op):
    """[T] inputs fold into one column ([T, 1]) and unfold after."""
    got, want = _run_both(op, _np_inputs(op, 9, (), seed=1), torch.float32)
    _assert_close(got, want, torch.float32, F32_TOL)


@pytest.mark.parametrize("T", [1, 17, 64])
@pytest.mark.parametrize("op", ["scan_assoc", "gae_assoc", "vtrace_assoc", "vtrace_nextobs_assoc"])
def test_assoc_forms_match_jax(op, T):
    """The 'assoc' forms against the reference's associative_scan at
    [T, 3, 2], T up to 64, at ASSOC_TOL; the port's outputs are detached."""
    got, want = _run_both(op, _np_inputs(op, T, SHAPE, seed=100 + T), torch.float32)
    _assert_close(got, want, torch.float32, ASSOC_TOL)


@pytest.mark.parametrize("op", ["scan_assoc", "gae_assoc"])
def test_assoc_forms_keep_bf16(op):
    """bf16 in, bf16 out, as the reference's associative_scan carries it."""
    got, want = _run_both(op, _np_inputs(op, 6, SHAPE, seed=7), torch.bfloat16)
    _assert_close(got, want, torch.bfloat16, BF16_TOL)


def test_kernel_level_entry_points_keep_the_pallas_contract():
    """The kernel-level functions stay [T, B] with f32 out for bf16 in,
    and refuse other ranks; the reference-contract wrappers refuse shapes
    that disagree."""
    from surreal_tpu_torch.ops import gae as G

    x = torch.ones(4, 3, dtype=torch.bfloat16)
    assert RS.reverse_linear_scan(x, x).dtype == torch.float32
    assert all(y.dtype == torch.float32 for y in G.gae_advantages(x, x, torch.ones(5, 3), LAM))
    assert all(y.dtype == torch.float32 for y in V.vtrace_fused(*[x] * 8))
    for fn in (lambda y: RS.reverse_linear_scan(y, y), lambda y: G.gae_advantages_masked(*[y] * 5)):
        with pytest.raises(ValueError, match="non-empty"):
            fn(torch.ones(4, 3, 2))
    with pytest.raises(ValueError, match="shape"):
        R.reverse_linear_scan_assoc(torch.ones(4, 3), torch.ones(4, 2))
    with pytest.raises(ValueError, match="T\\+1"):
        R.gae_advantages(torch.ones(4, 3), torch.ones(4, 3), torch.ones(4, 3), LAM)
    with pytest.raises(ValueError, match="bootstrap"):
        R.discounted_returns(torch.ones(4, 3), torch.ones(4, 3), torch.ones(4))


def test_assoc_forms_never_build_the_kernel_for_cpu_tensors(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU tensors must not build or load the {name} kernel")

    monkeypatch.setattr(RS, "load_kernel_library", refuse)
    before = RS.reverse_linear_scan.launches
    arrays = [torch.from_numpy(a) for a in _np_inputs("vtrace_nextobs_assoc", 5, SHAPE, seed=0)]
    V.vtrace_nextobs_assoc(*arrays, gamma=GAMMA)
    R.gae_advantages_assoc(*[torch.from_numpy(a) for a in _np_inputs("gae_assoc", 5, SHAPE, seed=0)], LAM)
    assert RS.reverse_linear_scan.launches == before


@pytest.mark.cuda
def test_ppo_assoc_learn_launches_the_scan_once_and_matches_the_cpu():
    """One PPO learn at gae_impl='assoc' from the same weights, batch and
    epoch permutations on the card and on the CPU: one launch of the scan
    kernel and none of the GAE kernel on the card; metrics and params to
    the card-vs-CPU bar of
    chip_smoke.py's parity phase (sixteen Adam steps in f32 whose sums
    are taken in other orders: 1e-3 relative, params 1e-4)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs
    from surreal_tpu_torch.learners import build_learner
    from surreal_tpu_torch.learners.ppo import _block_layout
    from surreal_tpu_torch.ops import gae as G
    from surreal_tpu_torch.session.config import Config

    T, B, obs_dim, act = 32, 64, 17, 4
    specs = EnvSpecs(obs=ArraySpec((obs_dim,), np.dtype(np.float32)), action=ArraySpec((act,), np.dtype(np.float32)))
    rng = np.random.default_rng(0)
    done = rng.random((T, B)) < 0.1
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    batch = {
        "obs": f(T, B, obs_dim), "next_obs": f(T, B, obs_dim), "action": f(T, B, act), "reward": f(T, B),
        "done": torch.from_numpy(done), "terminated": torch.from_numpy(done & (rng.random((T, B)) < 0.5)),
        "behavior_logp": f(T, B) - 4.0, "behavior": {"mean": 0.3 * f(T, B, act), "log_std": torch.full((T, B, act), -0.5)},
    }
    domain = 4 * _block_layout(T * B, 4, obs_dim * 4)  # block shuffle: 4 minibatches of 64 blocks
    gen = torch.Generator().manual_seed(1)
    perms = torch.stack([torch.randperm(domain, generator=gen) for _ in range(4)])
    out = {}
    for dev in ("cuda", "cpu"):
        learner = build_learner(Config(algo=Config(name="ppo", gae_impl="assoc", precision="f32")), specs, device=dev)
        state = learner.init(torch.Generator().manual_seed(0))
        on_dev = {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev))
                  for k, v in batch.items()}
        scans, gaes = RS.reverse_linear_scan.launches, G.gae_advantages_masked.launches
        new_state, metrics = learner.learn(state, on_dev, perms=perms.to(dev))
        torch.cuda.synchronize()
        out[dev] = ({k: float(v) for k, v in metrics.items()}, {k: v.cpu() for k, v in new_state.params.items()})
        if dev == "cuda":
            assert RS.reverse_linear_scan.launches == scans + 1
            assert G.gae_advantages_masked.launches == gaes
    for k, want in out["cpu"][0].items():
        got = out["cuda"][0][k]
        rtol = 5e-2 if k == "health/update_ratio" else 1e-3
        assert abs(got - want) <= 1e-4 + rtol * abs(want), (k, got, want)
    for k, want in out["cpu"][1].items():
        torch.testing.assert_close(out["cuda"][1][k], want, rtol=0, atol=1e-4)
