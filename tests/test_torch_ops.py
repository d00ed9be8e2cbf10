"""Parity of the PyTorch port's ops with the JAX package: GAE and V-trace
(plain and kernel wrapper), distributions, running stats. Inputs come from
a numpy seed and go through both packages; the Pallas GAE and V-trace
kernels run in interpret mode, as the JAX package's own tests run them on
the CPU.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.ops import distributions as JD
from surreal_tpu.ops import running_stats as JRS
from surreal_tpu.ops.pallas_gae import gae_advantages_pallas, gae_advantages_pallas_masked
from surreal_tpu.ops.pallas_vtrace import vtrace_nextobs_pallas, vtrace_pallas
from surreal_tpu.ops.returns import gae_advantages as jax_gae_advantages
from surreal_tpu.ops.vtrace import vtrace as jax_vtrace
from surreal_tpu.ops.vtrace import vtrace_nextobs as jax_vtrace_nextobs
from surreal_tpu_torch.ops import distributions as D
from surreal_tpu_torch.ops import gae as G
from surreal_tpu_torch.ops import running_stats as RS
from surreal_tpu_torch.ops import vtrace as V
from surreal_tpu_torch.ops.scan_tiles import REV_SCAN_STAGE_BYTES, RING_STAGES, ScanPlan, scan_plan
from surreal_tpu_torch.ops.returns import gae_advantages as torch_gae_loop

GAMMA, LAM = 0.99, 0.95
# GAE tolerance: the reference's own bar for its kernel-vs-scan tests
# (tests/test_ops.py); a T-step f32 recurrence in another framework may
# round each step differently by one ulp.
GAE_TOL = dict(rtol=1e-5, atol=1e-5)


def _gae_inputs(T, B, seed):
    rng = np.random.default_rng(seed)
    reward = rng.normal(size=(T, B)).astype(np.float32)
    v_t = rng.normal(size=(T, B)).astype(np.float32)
    v_next = rng.normal(size=(T, B)).astype(np.float32)
    done = rng.random((T, B)) < 0.15
    terminated = done & (rng.random((T, B)) < 0.5)  # the rest are truncations
    boot = (GAMMA * (1.0 - terminated)).astype(np.float32)
    decay = (GAMMA * LAM * (1.0 - done)).astype(np.float32)
    return reward, boot, decay, v_t, v_next


def _t(*arrays):
    return [torch.from_numpy(np.asarray(a)) for a in arrays]


@pytest.mark.parametrize("B", [1, 200])
def test_gae_masked_matches_pallas_kernel(B):
    arrs = _gae_inputs(17, B, seed=B)
    ref_adv, ref_tgt = gae_advantages_pallas_masked(*map(jnp.asarray, arrs), interpret=True)
    adv, tgt = G.gae_advantages_masked(*_t(*arrs))
    assert adv.dtype == tgt.dtype == torch.float32
    np.testing.assert_allclose(adv.numpy(), np.asarray(ref_adv), **GAE_TOL)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(ref_tgt), **GAE_TOL)


@pytest.mark.parametrize("B", [1, 200])
def test_gae_simple_contract_matches_scan_and_pallas(B):
    rng = np.random.default_rng(7 + B)
    T = 13
    reward = rng.normal(size=(T, B)).astype(np.float32)
    values = rng.normal(size=(T + 1, B)).astype(np.float32)
    done = rng.random((T, B)) < 0.2
    discounts = (GAMMA * (1.0 - done)).astype(np.float32)
    ref = jax_gae_advantages(jnp.asarray(reward), jnp.asarray(discounts), jnp.asarray(values), LAM)
    ref_p = gae_advantages_pallas(
        jnp.asarray(reward), jnp.asarray(discounts), jnp.asarray(values), LAM, interpret=True
    )
    r, d, v = _t(reward, discounts, values)
    for got in (G.gae_advantages(r, d, v, LAM), torch_gae_loop(r, d, v, LAM)):
        for g, want, want_p in zip(got, ref, ref_p):
            np.testing.assert_allclose(g.numpy(), np.asarray(want), **GAE_TOL)
            np.testing.assert_allclose(g.numpy(), np.asarray(want_p), **GAE_TOL)


def test_gae_respects_episode_boundary():
    """A done at t cuts the recurrence: adv[t] = delta[t] exactly, whatever
    follows (mirrors tests/test_ops.py::test_gae_respects_episode_boundary)."""
    reward, boot, decay, v_t, v_next = _gae_inputs(8, 3, seed=3)
    decay[4] = 0.0
    adv, _ = G.gae_advantages_masked(*_t(reward, boot, decay, v_t, v_next))
    delta = reward[4] + boot[4] * v_next[4] - v_t[4]
    np.testing.assert_allclose(adv[4].numpy(), delta, rtol=1e-6, atol=1e-6)


def test_gae_bf16_inputs_give_f32_outputs():
    arrs = [a.astype(jnp.bfloat16) for a in map(jnp.asarray, _gae_inputs(9, 40, seed=11))]
    ref_adv, ref_tgt = gae_advantages_pallas_masked(*arrs, interpret=True)
    bf = [torch.from_numpy(np.asarray(a.astype(jnp.float32))).to(torch.bfloat16) for a in arrs]
    adv, tgt = G.gae_advantages_masked(*bf)
    assert adv.dtype == tgt.dtype == torch.float32
    np.testing.assert_allclose(adv.numpy(), np.asarray(ref_adv), **GAE_TOL)
    np.testing.assert_allclose(tgt.numpy(), np.asarray(ref_tgt), **GAE_TOL)


def test_gae_wrapper_never_builds_the_kernel_for_cpu_tensors(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU tensors must not build or load the {name} kernel")

    monkeypatch.setattr(G, "load_kernel_library", refuse)
    before = G.gae_advantages_masked.launches
    G.gae_advantages_masked(*_t(*_gae_inputs(5, 7, seed=0)))
    assert G.gae_advantages_masked.launches == before


def test_gae_wrapper_rejects_bad_inputs():
    arrs = _t(*_gae_inputs(4, 3, seed=0))
    with pytest.raises(ValueError, match="shape"):
        G.gae_advantages_masked(arrs[0], arrs[1][:3], *arrs[2:])
    with pytest.raises(ValueError, match="non-empty"):
        G.gae_advantages_masked(*(a[0] for a in arrs))


# Shapes at the edges of the scan kernels' shared-memory ring
# (ops/scan_tiles.py): T longer than the ring, T not a multiple of a stage,
# B below one tile or not a multiple of 4 (the cp.async copy), several waves
# of blocks, T below one stage.
SCAN_EDGE_SHAPES = [(1000, 33), (255, 4096), (256, 5), (32, 1023), (64, 65536), (3, 1000)]


@pytest.mark.cuda
def test_gae_kernel_matches_plain_on_card():
    """Bit-exact on the card: the kernel rounds where the plain version
    does (no FMA contraction, see csrc/gae.cu), one launch a call, at the
    path's shape, ragged ones and the ring's edges; and at a plan whose
    ring needs more than 48 KB of shared memory."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    big = ScanPlan(tile=32, steps=16)
    assert big.shared_bytes(256, 5) > 48 * 1024
    for T, B in [(256, 4097), (7, 1000), (1, 1), (256, 4096), *SCAN_EDGE_SHAPES]:
        arrs = [x.cuda() for x in _t(*_gae_inputs(T, B, seed=T))]
        before = G.gae_advantages_masked.launches
        got = G.gae_advantages_masked(*arrs)
        want = G.gae_masked_plain(*arrs)
        torch.cuda.synchronize()
        assert G.gae_advantages_masked.launches == before + 1
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (T, B)
        if (T, B) == (256, 4096):
            assert all(torch.equal(g, w) for g, w in zip(G._launch(arrs, big), want))


@pytest.mark.parametrize("arrays", [2, 5, 8])
@pytest.mark.parametrize("T, B", [(1, 1), (7, 1000), (256, 4096), (32, 1024), *SCAN_EDGE_SHAPES])
def test_scan_plan_fills_the_card_and_fits_the_ring(T, B, arrays):
    """The tile is the widest that gives at least half of 132 SMs a block
    (else the narrowest); a stage holds whole 128 B of each array, and the
    whole T where that slab fits 16 KB, else at most an eighth of T and 5 KB
    (where that leaves a whole 128 B); the ring fits in 48 KB."""
    plan = scan_plan(T, B, arrays, sms=132)
    blocks = -(-B // plan.tile)
    wider = [w for w in (16, 32) if w > plan.tile]
    assert blocks * 2 >= 132 or plan.tile == 8
    assert all(-(-B // w) * 2 < 132 for w in wider)
    align = 32 // plan.tile
    assert plan.steps >= 1 and plan.steps % align == 0
    if 4 * arrays * plan.tile * T <= 16 * 1024:
        assert T <= plan.steps < T + align
    else:
        assert plan.steps - align < max(1, -(-T // RING_STAGES))
        assert plan.steps == align or plan.steps * plan.tile * arrays * 4 <= 5 * 1024
    assert plan.shared_bytes(T, arrays) <= 48 * 1024


def test_scan_plan_at_the_path_shapes_and_edges():
    """GAE at PPO's [256, 4096]: 128 blocks of 32 columns, stages of 8
    timesteps. V-trace at IMPALA's [32, 1024]: 128 blocks of 8 columns, and
    one stage holds all 32 timesteps. The edge shapes land where the card
    tests need them."""
    assert scan_plan(256, 4096, 5, sms=132) == ScanPlan(tile=32, steps=8)
    assert scan_plan(32, 1024, 8, sms=132) == ScanPlan(tile=8, steps=32)
    long_t = scan_plan(1000, 33, 5, sms=132)
    assert long_t.steps * RING_STAGES < 1000            # T longer than the ring
    assert 255 % scan_plan(255, 4096, 5, sms=132).steps  # a partial last stage
    assert scan_plan(256, 5, 5, sms=132).tile > 5        # B below one tile
    assert scan_plan(3, 1000, 5, sms=132).steps > 3      # T below one stage
    assert -(-65536 // scan_plan(64, 65536, 5, sms=132).tile) > 132 * 4  # several waves
    with pytest.raises(ValueError):
        scan_plan(0, 4, 5, sms=132)


def test_scan_plan_for_the_reverse_scan():
    """The reverse scan (two arrays, 8 KB stages): at PPO's [256, 4096],
    128 blocks of 32 columns and stages of 32 timesteps, so the 64 KB ring
    holds all of T; at IMPALA's [32, 1024], 128 blocks of 8 columns and the
    whole T in one stage. The card tests' shapes land on the ring's edges:
    the ring wraps under cp.async (B % 4 != 0) and under TMA, a last stage
    is partial, B is below one tile, T below one stage; no ring passes the
    227 KB a block may have, and GAE's and V-trace's plans are unchanged."""
    plan = lambda T, B: scan_plan(T, B, 2, sms=132, stage_bytes=REV_SCAN_STAGE_BYTES)  # noqa: E731
    assert plan(256, 4096) == ScanPlan(tile=32, steps=32)
    assert plan(256, 4096).shared_bytes(256, 2) == 64 * 1024
    assert plan(32, 1024) == ScanPlan(tile=8, steps=32)
    assert plan(2000, 33).steps * RING_STAGES < 2000 and 33 % 4    # wraps, cp.async
    assert plan(512, 4096).steps * RING_STAGES < 512                # wraps, TMA
    assert 255 % plan(255, 4096).steps                              # a partial last stage
    assert plan(256, 5).tile > 5 and plan(3, 1000).steps > 3
    for T, B in [(2000, 33), (512, 4096), (255, 4096), (256, 5), (3, 1000), (64, 65536), (1, 1)]:
        assert plan(T, B).shared_bytes(T, 2) <= 232_448
    assert scan_plan(256, 4096, 5, sms=132) == ScanPlan(tile=32, steps=8)
    assert scan_plan(32, 1024, 8, sms=132) == ScanPlan(tile=8, steps=32)


# V-trace tolerance: the reference's own bar for its kernel-vs-scan tests
# (tests/test_precision.py): the residual is XLA's FMA contraction inside
# the compiled scan, a few f32 ulps at unit scale.
VTRACE_TOL = dict(rtol=0, atol=5e-6)


def _vtrace_inputs(T, B, seed):
    """Log-ratios of order 0.3, so that every clip level takes effect; 15%
    dones, half of them true terminations."""
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    done = rng.random((T, B)) < 0.15
    return dict(
        behaviour_logp=f(T, B) * 0.3 - 1.0,
        target_logp=f(T, B) * 0.3 - 1.0,
        rewards=f(T, B),
        values=f(T, B),
        values_next=f(T, B),
        done=done,
        terminated=done & (rng.random((T, B)) < 0.5),
    )


def test_vtrace_nextobs_matches_xla_and_pallas():
    kw = _vtrace_inputs(16, 40, seed=0)
    rho = np.exp(kw["target_logp"] - kw["behaviour_logp"])
    assert (rho > 1.0).any() and (rho < 1.0).any()
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    refs = (
        jax_vtrace_nextobs(**jkw, gamma=GAMMA, clip_rho=1.0, clip_c=0.9, clip_pg_rho=1.1),
        vtrace_nextobs_pallas(**jkw, gamma=GAMMA, clip_rho=1.0, clip_c=0.9, clip_pg_rho=1.1, interpret=True),
    )
    got = V.vtrace_nextobs(
        **{k: torch.from_numpy(v) for k, v in kw.items()}, gamma=GAMMA, clip_rho=1.0, clip_c=0.9, clip_pg_rho=1.1
    )
    for ref in refs:
        for g, want in zip(got, ref):
            assert g.dtype == torch.float32 and not g.requires_grad
            np.testing.assert_allclose(g.numpy(), np.asarray(want), **VTRACE_TOL)


def test_vtrace_simple_contract_matches_xla_and_pallas():
    T, B = 12, 40
    rng = np.random.default_rng(1)
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    done = rng.random((T, B)) < 0.1
    disc = (GAMMA * (1.0 - done)).astype(np.float32)
    args = (f(T, B) * 0.3, f(T, B) * 0.3, f(T, B), disc, f(T + 1, B))
    jargs = [jnp.asarray(a) for a in args]
    got = V.vtrace(*_t(*args))
    for ref in (jax_vtrace(*jargs), vtrace_pallas(*jargs, interpret=True)):
        for g, want in zip(got, ref):
            np.testing.assert_allclose(g.numpy(), np.asarray(want), **VTRACE_TOL)


def test_vtrace_outputs_are_detached_f32_for_bf16_inputs_with_grad():
    kw = _vtrace_inputs(9, 5, seed=2)
    t = {k: torch.from_numpy(v) for k, v in kw.items()}
    t["target_logp"] = t["target_logp"].to(torch.bfloat16).requires_grad_(True)
    t["values"] = t["values"].requires_grad_(True)
    got = V.vtrace_nextobs(**t, gamma=GAMMA)
    ref = jax_vtrace_nextobs(
        **{k: jnp.asarray(v) for k, v in kw.items() if k != "target_logp"},
        target_logp=jnp.asarray(kw["target_logp"]).astype(jnp.bfloat16).astype(jnp.float32), gamma=GAMMA,
    )
    for g, want in zip(got, ref):
        assert g.dtype == torch.float32 and not g.requires_grad
        np.testing.assert_allclose(g.numpy(), np.asarray(want), **VTRACE_TOL)


def test_vtrace_wrapper_never_builds_the_kernel_for_cpu_tensors(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU tensors must not build or load the {name} kernel")

    monkeypatch.setattr(V, "load_kernel_library", refuse)
    before = V.vtrace_fused.launches
    V.vtrace_nextobs(**{k: torch.from_numpy(v) for k, v in _vtrace_inputs(5, 7, seed=0).items()}, gamma=GAMMA)
    assert V.vtrace_fused.launches == before
    with pytest.raises(ValueError, match="shape"):
        V.vtrace(*_t(*(np.zeros((4, 3), np.float32) for _ in range(4))), torch.zeros(4, 3))


@pytest.mark.cuda
def test_vtrace_kernel_matches_plain_on_card():
    """Bit-exact on the card: the kernel rounds where the plain version does
    (non-contracting _rn intrinsics, see csrc/vtrace.cu), and rho is expf
    in both; one launch a call, at the path's shape, ragged ones and the
    ring's edges, and at a plan whose ring needs more than 48 KB."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    big = ScanPlan(tile=16, steps=32)
    assert big.shared_bytes(255, 8) > 48 * 1024
    for T, B in [(32, 1025), (7, 1000), (1, 1), (32, 1024), *SCAN_EDGE_SHAPES]:
        kw = _vtrace_inputs(T, B, seed=T)
        done = torch.from_numpy(kw["done"]).float().cuda()
        arrs = [torch.from_numpy(kw[k]).cuda() for k in ("behaviour_logp", "target_logp", "rewards")]
        boot = GAMMA * (1.0 - torch.from_numpy(kw["terminated"]).float().cuda())
        edge = GAMMA * (1.0 - done)
        vt, vn = (torch.from_numpy(kw[k]).cuda() for k in ("values", "values_next"))
        inputs = [*arrs, boot, edge, vt, vn, done]
        before = V.vtrace_fused.launches
        got = V.vtrace_fused(*inputs, 1.0, 0.9, 1.1)
        want = V.vtrace_fused_plain(*inputs, 1.0, 0.9, 1.1)
        torch.cuda.synchronize()
        assert V.vtrace_fused.launches == before + 1
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (T, B)
        if (T, B) == (255, 4096):
            assert all(torch.equal(g, w) for g, w in zip(V._launch(inputs, (1.0, 0.9, 1.1), big), want))


@jax.jit
def _jax_distributions(mean_a, ls_a, mean_b, ls_b, x, logits_a, logits_b, action):
    return (
        JD.diag_gauss_logp(mean_a, ls_a, x),
        JD.diag_gauss_entropy(ls_a),
        JD.diag_gauss_kl(mean_a, ls_a, mean_b, ls_b),
        JD.categorical_logp(logits_a, action),
        JD.categorical_entropy(logits_a),
        JD.categorical_kl(logits_a, logits_b),
    )


def test_distributions_match_jax():
    rng = np.random.default_rng(1)
    mean_a, mean_b, x = (rng.normal(size=(6, 4)).astype(np.float32) for _ in range(3))
    ls_a, ls_b = (rng.uniform(-1.5, 0.5, size=(6, 4)).astype(np.float32) for _ in range(2))
    logits_a, logits_b = (rng.normal(size=(6, 5)).astype(np.float32) for _ in range(2))
    action = rng.integers(0, 5, size=(6,)).astype(np.int32)
    j = jnp.asarray
    tm_a, tm_b, tx, tl_a, tl_b, tg_a, tg_b, tact = _t(
        mean_a, mean_b, x, ls_a, ls_b, logits_a, logits_b, action
    )
    got = (
        D.diag_gauss_logp(tm_a, tl_a, tx),
        D.diag_gauss_entropy(tl_a),
        D.diag_gauss_kl(tm_a, tl_a, tm_b, tl_b),
        D.categorical_logp(tg_a, tact),
        D.categorical_entropy(tg_a),
        D.categorical_kl(tg_a, tg_b),
    )
    want = _jax_distributions(*map(j, (mean_a, ls_a, mean_b, ls_b, x, logits_a, logits_b, action)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5, atol=1e-6)

    # sampling: the port takes JAX's own draws and must give JAX's samples
    key = jax.random.key(5)
    noise = np.asarray(jax.random.normal(key, mean_a.shape, jnp.float32))
    got = D.diag_gauss_sample(tm_a, tl_a, noise=torch.from_numpy(noise))
    want = JD.diag_gauss_sample(key, j(mean_a), j(ls_a))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-6)
    gumbel = np.asarray(jax.random.gumbel(key, logits_a.shape, jnp.float32))
    got = D.categorical_sample(tg_a, gumbel=torch.from_numpy(gumbel))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JD.categorical_sample(key, j(logits_a))))
    # and the generator path draws the right shapes on its own
    g = torch.Generator().manual_seed(0)
    assert D.diag_gauss_sample(tm_a, tl_a, g).shape == (6, 4)
    assert D.categorical_sample(tg_a, g).shape == (6,)


def _stats_np(s):
    return [np.asarray(s.count), np.asarray(s.mean), np.asarray(s.m2)]


def _close_stats(got, want):
    assert int(got.count) == int(want.count)
    # float32 sums over a few hundred samples in another order
    np.testing.assert_allclose(got.mean.numpy(), np.asarray(want.mean), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got.m2.numpy(), np.asarray(want.m2), rtol=1e-5, atol=1e-4)


def test_running_stats_match_jax():
    rng = np.random.default_rng(2)
    js, ts = JRS.init_stats((3,)), RS.init_stats((3,), "cpu")
    update = jax.jit(JRS.update_stats)
    for scale in (1.0, 3.0, 0.5):
        batch = (rng.normal(size=(64, 2, 3)) * scale + 1).astype(np.float32)
        js = update(js, jnp.asarray(batch))
        ts = RS.update_stats(ts, torch.from_numpy(batch))
        _close_stats(ts, js)
    x = rng.normal(size=(4, 3)).astype(np.float32) * 20
    np.testing.assert_allclose(
        RS.normalize(ts, torch.from_numpy(x)).numpy(),
        np.asarray(JRS.normalize(js, jnp.asarray(x))), rtol=1e-5, atol=1e-5,
    )
    assert float(RS.normalize(ts, torch.from_numpy(x)).abs().max()) <= 5.0
    np.testing.assert_allclose(RS.variance(ts).numpy(), np.asarray(JRS.variance(js)), rtol=1e-5)


@pytest.mark.parametrize("count", [1_999_999_950, 2_000_000_000])
def test_running_stats_count_cap_matches_jax(count):
    """At and just below the int32 count cap: the prior is rescaled so the
    total stays exactly at the cap (update_stats), and a merge whose float
    total passes 2.1e9 saturates instead of wrapping (merge_stats)."""
    rng = np.random.default_rng(count % 97)
    mean = rng.normal(size=(3,)).astype(np.float32)
    m2 = (rng.random((3,)) * count).astype(np.float32)
    js = JRS.RunningStats(jnp.asarray(count, jnp.int32), jnp.asarray(mean), jnp.asarray(m2))
    ts = RS.RunningStats(torch.tensor(count, dtype=torch.int32), torch.from_numpy(mean), torch.from_numpy(m2))
    batch = rng.normal(size=(100, 3)).astype(np.float32)
    got, want = RS.update_stats(ts, torch.from_numpy(batch)), JRS.update_stats(js, jnp.asarray(batch))
    assert int(got.count) == int(want.count) == 2_000_000_000
    _close_stats(got, want)
    got, want = RS.merge_stats(ts, ts), JRS.merge_stats(js, js)
    assert int(got.count) == int(want.count) == 2_000_000_000
    _close_stats(got, want)
