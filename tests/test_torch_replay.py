"""Parity of the PyTorch port's replay path with the JAX package: the row
gather and scatter and the reverse linear scan (plain versions against
the Pallas kernels in interpret mode, as the JAX package's own tests run
them on the CPU), the ring buffer, uniform replay (JAX's randint indices
injected) and prioritized replay (JAX's uniforms injected). The CUDA
kernels themselves run only on the card (marker ``cuda``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.ops.pallas_replay import gather_rows_pallas, scatter_rows_pallas
from surreal_tpu.ops.pallas_returns import reverse_linear_scan_pallas
from surreal_tpu.ops.returns import discounted_returns as jax_discounted_returns
from surreal_tpu.ops.returns import n_step_returns as jax_n_step_returns
from surreal_tpu.replay import build_replay as jax_build_replay
from surreal_tpu.replay.base import RingState as JaxRingState
from surreal_tpu.replay.prioritized import PrioritizedState as JaxPrioritizedState
from surreal_tpu_torch.ops import replay_rows as RR
from surreal_tpu_torch.ops import rev_scan as RS
from surreal_tpu_torch.ops.returns import discounted_returns, n_step_returns
from surreal_tpu_torch.replay import RingState, build_replay
from surreal_tpu_torch.replay.prioritized import PrioritizedState
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.utils.asserts import check_insert_batch

# XLA on the CPU contracts ``d + c * x`` into one fused multiply-add; the
# port (and its CUDA kernel, with _rn intrinsics) rounds the product and
# the sum separately. Over a T-step recurrence that is a few ulps: the
# reference's own bar for its scan kernels (tests/test_ops.py).
SCAN_TOL = dict(rtol=1e-5, atol=1e-5)


def _t(x):
    return torch.from_numpy(np.array(x))


def _leaves(rng, capacity):
    """Replay-like leaves: f32 rows of 17 (68 B), the same in bf16 (34 B),
    a 1-D leaf and a [3, 5] one."""
    obs = rng.normal(size=(capacity, 17)).astype(np.float32)
    return {
        "obs": obs,
        "obs16": jnp.asarray(obs).astype(jnp.bfloat16),
        "reward": rng.normal(size=capacity).astype(np.float32),
        "grid": rng.normal(size=(capacity, 3, 5)).astype(np.float32),
    }


def _to_torch(x):
    if x.dtype == jnp.bfloat16:
        return _t(np.asarray(x.astype(jnp.float32))).to(torch.bfloat16)
    return _t(x)


def _to_np(x: torch.Tensor):
    return x.to(torch.float32).numpy() if x.dtype == torch.bfloat16 else x.numpy()


def test_gather_rows_plain_matches_pallas_with_duplicates():
    """Bit-exact against gather_rows_pallas(interpret=True) and storage[idx]
    on f32, bf16, 1-D and [3, 5] leaves, with repeated indices."""
    rng = np.random.default_rng(0)
    leaves = _leaves(rng, 64)
    idx = rng.integers(0, 64, 23).astype(np.int32)
    idx[[4, 9, 17]] = idx[2]
    got = RR.gather_rows({k: _to_torch(v) for k, v in leaves.items()}, _t(idx))
    for k, v in leaves.items():
        want = np.asarray(gather_rows_pallas(jnp.asarray(v), jnp.asarray(idx), interpret=True))
        np.testing.assert_array_equal(_to_np(got[k]), np.asarray(want, np.float32), err_msg=k)
        np.testing.assert_array_equal(_to_np(got[k]), np.asarray(jnp.asarray(v)[idx], np.float32), err_msg=k)


@pytest.mark.parametrize("row_shape", [(), (3,)])
def test_scatter_rows_plain_matches_pallas_with_duplicates(row_shape):
    """Bit-exact against scatter_rows_pallas(interpret=True) and XLA's
    ``.at[idx].set``; a repeated index keeps its last update."""
    rng = np.random.default_rng(1)
    dest = rng.normal(size=(64, *row_shape)).astype(np.float32)
    idx = np.array([3, 5, 3, 7, 3, 60, 9, 9, 0, 60], np.int32)
    upd = rng.normal(size=(len(idx), *row_shape)).astype(np.float32)
    want = np.asarray(scatter_rows_pallas(jnp.asarray(dest), jnp.asarray(idx), jnp.asarray(upd), interpret=True))
    want_xla = np.asarray(jax.jit(lambda d, i, u: d.at[i].set(u))(dest, idx, upd))
    got = RR.scatter_rows(_t(dest.copy()), _t(idx), _t(upd)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, want_xla)
    np.testing.assert_array_equal(got[3], upd[4])  # the last of three writes
    untouched = np.setdiff1d(np.arange(64), idx)
    np.testing.assert_array_equal(got[untouched], dest[untouched])


def test_reverse_linear_scan_matches_pallas():
    """The plain scan against reverse_linear_scan_pallas(interpret=True),
    and discounted_returns against the reference's, at SCAN_TOL."""
    T, B = 20, 50
    rng = np.random.default_rng(2)
    r = rng.standard_normal((T, B)).astype(np.float32)
    d = (0.97 * (rng.random((T, B)) >= 0.1)).astype(np.float32)
    boot = rng.standard_normal(B).astype(np.float32)
    for init in (None, boot):
        want = reverse_linear_scan_pallas(jnp.asarray(d), jnp.asarray(r), None if init is None else jnp.asarray(init),
                                          interpret=True)
        got = RS.reverse_linear_scan(_t(d), _t(r), None if init is None else _t(init))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    got = discounted_returns(_t(r), _t(d), _t(boot)).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_discounted_returns(jnp.asarray(r), jnp.asarray(d), jnp.asarray(boot))),
                               **SCAN_TOL)


@pytest.mark.parametrize("n", [1, 3])
def test_n_step_returns_match_jax(n):
    """The window sum, step for step; its multiply-adds are contracted by
    XLA (SCAN_TOL)."""
    rng = np.random.default_rng(n)
    r, v = rng.standard_normal((2, 12, 6)).astype(np.float32)
    d = (0.99 * (rng.random((12, 6)) >= 0.2)).astype(np.float32)
    want = jax.jit(jax_n_step_returns, static_argnums=3)(r, d, v, n)
    np.testing.assert_allclose(n_step_returns(_t(r), _t(d), _t(v), n).numpy(), np.asarray(want), **SCAN_TOL)


def test_wrappers_never_build_kernels_for_cpu_tensors(monkeypatch):
    def refuse(name):
        raise AssertionError(f"CPU tensors must not build or load the {name} kernel")

    monkeypatch.setattr(RR, "load_kernel_library", refuse)
    monkeypatch.setattr(RS, "load_kernel_library", refuse)
    counts = (RR.gather_rows.launches, RR.scatter_rows.launches, RS.reverse_linear_scan.launches)
    leaves = {"a": torch.arange(12.0).reshape(6, 2), "b": torch.arange(6)}
    RR.gather_rows(leaves, torch.tensor([5, 0, 5], dtype=torch.int32))
    RR.scatter_rows(torch.zeros(6), torch.tensor([1, 1]), torch.ones(2))
    RS.reverse_linear_scan(torch.ones(3, 2), torch.ones(3, 2))
    assert (RR.gather_rows.launches, RR.scatter_rows.launches, RS.reverse_linear_scan.launches) == counts


def test_wrappers_reject_bad_inputs():
    leaves = {"a": torch.zeros(6, 2)}
    with pytest.raises(IndexError):
        RR.gather_rows(leaves, torch.tensor([6]))
    with pytest.raises(ValueError, match="capacity"):
        RR.gather_rows({"a": torch.zeros(6, 2), "b": torch.zeros(5)}, torch.tensor([0]))
    with pytest.raises(ValueError, match="at most"):
        RR.gather_rows({str(i): torch.zeros(3) for i in range(RR.MAX_LEAVES + 1)}, torch.tensor([0]))
    with pytest.raises(ValueError, match="integer"):
        RR.scatter_rows(torch.zeros(6), torch.tensor([0.0]), torch.ones(1))
    with pytest.raises(ValueError, match="updates"):
        RR.scatter_rows(torch.zeros(6, 2), torch.tensor([0]), torch.ones(1))
    with pytest.raises(ValueError, match="fit"):
        RS.reverse_linear_scan(torch.ones(3, 2), torch.ones(3, 2), init=torch.zeros(3))


# The DDPG path's replay leaves (jax:lift): 160 B a transition.
DDPG_ROW_SHAPES = {"obs": (17,), "next_obs": (17,), "action": (4,), "reward": (), "discount": ()}


def _u8_offset_leaf(capacity, row, device, generator=None):
    """A uint8 [capacity, row] leaf that is a contiguous slice starting one
    byte into its buffer, so its base address is odd."""
    buf = torch.randint(0, 256, (capacity * row + 1,), dtype=torch.uint8, device=device, generator=generator)
    return buf[1:].view(capacity, row)


def _plan_leaves():
    """Leaf dicts whose row plans differ: DDPG's, bf16 obs, odd-sized and
    odd-addressed uint8 rows, int64 rows, and one 1-D leaf."""
    ddpg = {k: torch.zeros((8, *shape)) for k, shape in DDPG_ROW_SHAPES.items()}
    return [
        ddpg,
        {**ddpg, "obs": torch.zeros(8, 17, dtype=torch.bfloat16)},
        {"u8": _u8_offset_leaf(8, 16, "cpu"), "bytes": torch.zeros(8, 3, dtype=torch.uint8),
         "ids": torch.zeros(8, 2, dtype=torch.int64)},
        {"reward": torch.zeros(8)},
        {"wide": torch.zeros(8, 200)},
    ]


@pytest.mark.parametrize("case", range(5))
def test_gather_plan_units_and_threads(case):
    """The row plan the gather kernel walks: every unit divides its leaf's
    row size and both base addresses (16-byte units only where both allow),
    and each leaf's threads per row are the largest power of two (up to
    MAX_GROUP) that is no more than its units, so that thread j's units
    j, j + group, ... cover the row once, at most GATHER_TASKS each."""
    leaves = _plan_leaves()[case]
    outs = {k: torch.empty((3, *x.shape[1:]), dtype=x.dtype) for k, x in leaves.items()}
    rows = [RR._row_bytes(x) for x in leaves.values()]
    srcs = [x.data_ptr() for x in leaves.values()]
    dsts = [y.data_ptr() for y in outs.values()]
    plan = RR.gather_plan(rows, srcs, dsts)
    assert len(plan) == len(leaves)
    for row, src, dst, (unit, units, group) in zip(rows, srcs, dsts, plan):
        assert unit in (16, 8, 4, 2, 1) and unit * units == row
        assert src % unit == 0 and dst % unit == 0
        if unit < 16:  # no wider unit would have been legal
            wider = 2 * unit
            assert row % wider or src % wider or dst % wider
        assert group & (group - 1) == 0 and 1 <= group <= max(units, 1)
        assert group == RR.MAX_GROUP or units < 2 * group
        copied = sorted(j + k * group for j in range(group) for k in range(-(-units // group)) if j + k * group < units)
        assert copied == list(range(units))
    if case == 0:  # DDPG: obs rows in 17 4-byte units, action rows in one 16-byte unit
        assert plan == ((4, 17, 16), (4, 17, 16), (16, 1, 1), (4, 1, 1), (4, 1, 1))
    if case == 2:  # the odd-addressed 16-byte rows fall back to bytes
        assert plan[0] == (1, 16, 16) and plan[2][0] in (16, 8)
    if case == 4:  # 800-byte rows: 50 16-byte units, 32 threads a row
        assert plan == ((16, 50, 32),)


def test_copy_unit_and_scatter_scratch():
    assert [RR.copy_unit(b, 0) for b in (16, 32, 24, 12, 6, 3, 0)] == [16, 16, 8, 4, 2, 1, 16]
    assert RR.copy_unit(16, 0, 4) == 4 and RR.copy_unit(16, 1) == 1 and RR.copy_unit(8, 8, 16) == 8
    # one block: the row index and the position share a 32-bit word
    n = RR.SCATTER_BLOCK_ROWS  # positions take log2(n) bits
    wide = 2 ** (32 - (n - 1).bit_length())
    assert RR.scatter_scratch_bytes(1, 2**32 - 1) == RR.scatter_scratch_bytes(n, wide - 1) == 0
    assert RR.scatter_scratch_bytes(256, 200_000) == 0
    # grid-wide: 8-byte slots, the next power of two >= 2n of them
    assert RR.scatter_scratch_bytes(n, wide) == 8 * 2 * n
    assert RR.scatter_scratch_bytes(n + 1, 10) == RR.scatter_scratch_bytes(2 * n, 10) == 8 * 4 * n
    assert RR.scatter_scratch_bytes(256, 2**24) == 8 * 512  # 24 + 8 bits do not fit 32


def _require_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_replay_kernels_match_plain_on_card():
    """Bit-exact on the card: rows copied verbatim (f32, bf16, int64, odd
    byte counts, an odd-addressed uint8 leaf), duplicates resolved to the
    last write; the one-block scatter and the grid-wide one (n above
    SCATTER_BLOCK_ROWS, or row indices too wide for the one-block table),
    at the low and high end of the rows, every index the same; the DDPG
    leaves at 256 and at 16,384 rows (uniform sample_many)."""
    _require_card()
    gen = torch.Generator(device="cuda").manual_seed(0)
    for capacity, n in [(200_000, 256), (7, 1), (1000, 3000), (200_000, 16_384)]:
        leaves = {
            "obs": torch.randn(capacity, 17, device="cuda", generator=gen),
            "obs16": torch.randn(capacity, 17, device="cuda", generator=gen).to(torch.bfloat16),
            "bytes": torch.randint(0, 255, (capacity, 3), device="cuda", generator=gen, dtype=torch.uint8),
            "u8": _u8_offset_leaf(capacity, 16, "cuda", gen),
            "ids": torch.randint(0, 2**40, (capacity, 2), device="cuda", generator=gen),
            "reward": torch.randn(capacity, device="cuda", generator=gen),
        }
        ddpg = {k: torch.randn((capacity, *shape), device="cuda", generator=gen) for k, shape in DDPG_ROW_SHAPES.items()}
        idx = torch.randint(0, capacity, (n,), device="cuda", generator=gen, dtype=torch.int32)
        for lv in (leaves, ddpg):
            got, want = RR.gather_rows(lv, idx), RR.gather_rows_plain(lv, idx)
            torch.cuda.synchronize()
            assert all(torch.equal(got[k], want[k]) for k in lv)
    # the scatter: one block; grid-wide above SCATTER_BLOCK_ROWS rows, or
    # where capacity << log2(n) does not fit 32 bits (2**24 rows at n 256)
    for capacity, n in [(200_000, 256), (7, 1), (1000, 3000), (200_000, 16_384), (2**24 + 3, 256)]:
        for row_shape in [(), (3,)]:
            dest = torch.randn(capacity, *row_shape, device="cuda", generator=gen)
            upd = torch.randn(n, *row_shape, device="cuda", generator=gen)
            for idx in (torch.randint(0, min(capacity, 64), (n,), device="cuda", generator=gen, dtype=torch.int32),
                        torch.randint(max(capacity - 64, 0), capacity, (n,), device="cuda", generator=gen, dtype=torch.int32),
                        torch.full((n,), capacity // 2, device="cuda", dtype=torch.int32)):
                got = RR.scatter_rows(dest.clone(), idx, upd)
                want = RR.scatter_rows_plain(dest.clone(), idx, upd)
                torch.cuda.synchronize()
                assert torch.equal(got, want)


# Shapes at the edges of the reverse scan's ring (ops/scan_tiles.py with
# REV_SCAN_STAGE_BYTES): the ring wrapping under cp.async (B % 4 != 0) and
# under TMA, a partial last stage, B below one tile or not a multiple of 4,
# several waves of blocks, T below one stage; and PPO's and IMPALA's shapes.
REV_SCAN_EDGE_SHAPES = [(2000, 33), (512, 4096), (255, 4096), (256, 5), (32, 1023), (64, 65536), (3, 1000),
                        (256, 4096), (32, 1024)]


@pytest.mark.cuda
def test_rev_scan_kernel_matches_plain_on_card():
    """Bit-exact on the card (the _rn intrinsics, see csrc/rev_scan.cu), one
    launch a call, at ragged shapes and the ring's edges, and at plans
    whose ring wraps many times or needs more than 48 KB."""
    _require_card()
    from surreal_tpu_torch.ops.scan_tiles import ScanPlan

    gen = torch.Generator(device="cuda").manual_seed(1)
    for T, B in [(256, 4097), (7, 1000), (1, 1), *REV_SCAN_EDGE_SHAPES]:
        c = 0.97 * (torch.rand(T, B, device="cuda", generator=gen) >= 0.1)
        d = torch.randn(T, B, device="cuda", generator=gen)
        init = torch.randn(B, device="cuda", generator=gen)
        before = RS.reverse_linear_scan.launches
        got, want = RS.reverse_linear_scan(c, d, init), RS.reverse_linear_scan_plain(c, d, init)
        torch.cuda.synchronize()
        assert RS.reverse_linear_scan.launches == before + 1
        assert torch.equal(got, want), (T, B)
        if (T, B) == (256, 4096):
            for plan in (ScanPlan(tile=32, steps=4), ScanPlan(tile=16, steps=64)):
                assert torch.equal(RS._launch(c, d, init, plan), want), plan


# -- ring, uniform and prioritized replay ------------------------------------

def _replay_cfg(kind, **kw):
    """One replay config for both packages. The JAX replay reads it by
    attribute and ``.get``, as the port's Config gives them; the JAX
    package's own Config would import its session package, and with it
    orbax, which the card's machine does not have."""
    shared = dict(kind=kind, capacity=16, batch_size=8, start_sample_size=1, priority_alpha=0.6,
                  priority_beta0=0.4, priority_eps=1e-6)
    shared.update(kw)
    cfg = Config(shared)
    return cfg, cfg


def _trans(n, seed):
    rng = np.random.default_rng(seed)
    return {
        "obs": rng.normal(size=(n, 3)).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(n, 2)).astype(np.float32),
        "reward": rng.normal(size=n).astype(np.float32),
    }


def _assert_ring_equal(t_ring: RingState, j_ring: JaxRingState):
    assert (t_ring.cursor, t_ring.size) == (int(j_ring.cursor), int(j_ring.size))
    for k, v in j_ring.storage.items():
        np.testing.assert_array_equal(t_ring.storage[k].numpy(), np.asarray(v), err_msg=k)


def test_uniform_replay_matches_jax():
    """Inserts that wrap around the ring, then ``sample`` and
    ``sample_many`` with JAX's randint indices injected: bit-equal
    batches, the same staleness gauge and occupancy gauges."""
    jcfg, tcfg = _replay_cfg("uniform")
    jr, tr = jax_build_replay(jcfg), build_replay(tcfg)
    example = {k: v[0] for k, v in _trans(1, 0).items()}
    j_state = jr.init(jax.tree.map(jnp.asarray, example))
    t_state = tr.init({k: _t(v) for k, v in example.items()})
    j_insert = jax.jit(jr.insert)
    for n, seed in ((10, 1), (10, 2)):  # the second insert wraps
        batch = _trans(n, seed)
        j_state = j_insert(j_state, jax.tree.map(jnp.asarray, batch))
        t_state = tr.insert(t_state, {k: _t(v) for k, v in batch.items()})
        _assert_ring_equal(t_state, j_state)
    assert (t_state.cursor, t_state.size) == (4, 16)

    key = jax.random.key(3)
    _, j_batch, j_info = jax.jit(jr.sample)(j_state, key)
    _, t_batch, t_info = tr.sample(t_state, idx=_t(j_info["idx"]))
    for k in j_batch:
        np.testing.assert_array_equal(t_batch[k].numpy(), np.asarray(j_batch[k]), err_msg=k)
    np.testing.assert_allclose(float(tr.age_frac(t_state, t_info["idx"])),
                               float(jr.age_frac(j_state, j_info["idx"])), rtol=1e-7)

    keys = jax.random.split(jax.random.key(4), 5)
    _, j_batches, j_idx = jax.jit(jr.sample_many)(j_state, keys)
    _, t_batches, t_idx = tr.sample_many(t_state, 5, idx=_t(j_idx))
    assert t_idx.dtype == torch.int32 and tuple(t_idx.shape) == (5, 8)
    for k in j_batches:
        np.testing.assert_array_equal(t_batches[k].numpy(), np.asarray(j_batches[k]), err_msg=k)
    for name, v in jr.gauges(j_state).items():
        assert float(tr.gauges(t_state)[name]) == pytest.approx(float(v), rel=1e-7)


def test_prioritized_insert_and_update_match_jax():
    """Fresh inserts take the max priority (also across a wrap); the
    refresh writes |td| + eps with the last of repeated indices winning,
    and raises the max priority: bit-exact."""
    jcfg, tcfg = _replay_cfg("prioritized")
    jr, tr = jax_build_replay(jcfg), build_replay(tcfg)
    example = {k: v[0] for k, v in _trans(1, 0).items()}
    j_state = jr.init(jax.tree.map(jnp.asarray, example))
    t_state = tr.init({k: _t(v) for k, v in example.items()})
    idx = np.array([1, 4, 1, 9, 4, 1], np.int32)
    td = np.random.default_rng(5).normal(size=6).astype(np.float32) * 3.0
    for step, (n, seed) in enumerate(((10, 1), (10, 2))):
        batch = _trans(n, seed)
        j_state = jax.jit(jr.insert)(j_state, jax.tree.map(jnp.asarray, batch))
        t_state = tr.insert(t_state, {k: _t(v) for k, v in batch.items()})
        if step == 0:
            j_state = jax.jit(jr.update_priorities)(j_state, jnp.asarray(idx), jnp.asarray(td))
            t_state = tr.update_priorities(t_state, _t(idx), _t(td))
            assert float(t_state.priorities[1]) == float(np.abs(td[5]) + np.float32(1e-6))
        _assert_ring_equal(t_state.ring, j_state.ring)
        np.testing.assert_array_equal(t_state.priorities.numpy(), np.asarray(j_state.priorities))
        assert float(t_state.max_priority) == float(j_state.max_priority)
    assert float(t_state.max_priority) == float(np.abs(td).max() + np.float32(1e-6))
    assert float(t_state.priorities[1]) == float(t_state.max_priority)  # re-inserted by the wrap


# A draw of the prioritized sampler picks the first slot whose cdf value
# reaches it. torch's cumsum and pow round differently from XLA's, so where
# a draw lies within a few ulps of a cdf boundary the two can pick
# neighbouring slots. The rule: every index that differs from JAX's
# differs by one slot, and its draw lies within BOUNDARY_ULPS ulps (of the
# draw's value) of JAX's cdf value between the two slots.
BOUNDARY_ULPS = 8


def test_prioritized_sample_matches_jax_up_to_cdf_boundaries():
    """200,000 priorities of the form |N(0, 1)| (so p = |N|^0.6), 512
    stratified draws with JAX's uniforms injected: indices equal except by
    the boundary rule above (which the test checks), the gathered rows
    those of the indices, and IS weights within 1e-5 relative wherever the
    indices agree."""
    C, bs, beta = 200_000, 512, 0.7
    jcfg, tcfg = _replay_cfg("prioritized", capacity=C, batch_size=bs)
    jr, tr = jax_build_replay(jcfg), build_replay(tcfg)
    prio = np.abs(np.random.default_rng(6).normal(size=C)).astype(np.float32)
    slots = np.arange(C, dtype=np.float32)
    j_state = JaxPrioritizedState(
        ring=JaxRingState(storage={"slot": jnp.asarray(slots)}, cursor=jnp.int32(0), size=jnp.int32(C)),
        priorities=jnp.asarray(prio), max_priority=jnp.float32(1.0),
    )
    t_state = PrioritizedState(
        ring=RingState(storage={"slot": _t(slots)}, cursor=0, size=C),
        priorities=_t(prio), max_priority=torch.tensor(1.0),
    )
    key = jax.random.key(7)
    _, j_batch, j_info = jax.jit(jr.sample)(j_state, key, beta=beta)
    uniforms = np.asarray(jax.random.uniform(key, (bs,)))
    _, t_batch, t_info = tr.sample(t_state, beta=beta, uniforms=_t(uniforms))

    @jax.jit
    def cdf_and_draws(p):
        p = p ** 0.6
        return jnp.cumsum(p), (jnp.arange(bs) + jnp.asarray(uniforms)) / bs * p.sum()

    cdf, u = map(np.asarray, cdf_and_draws(jnp.asarray(prio)))
    j_idx, t_idx = np.asarray(j_info["idx"]), t_info["idx"].numpy()
    assert t_info["idx"].dtype == torch.int32
    differ = np.flatnonzero(j_idx != t_idx)
    assert len(differ) < bs // 10
    for i in differ:
        assert abs(int(j_idx[i]) - int(t_idx[i])) == 1, (i, j_idx[i], t_idx[i])
        boundary = cdf[min(j_idx[i], t_idx[i])]
        assert abs(u[i] - boundary) <= BOUNDARY_ULPS * np.spacing(u[i]), (i, (u[i] - boundary) / np.spacing(u[i]))
    np.testing.assert_array_equal(t_batch["slot"].numpy(), t_idx.astype(np.float32))
    same = j_idx == t_idx
    np.testing.assert_allclose(t_info["is_weights"].numpy()[same], np.asarray(j_info["is_weights"])[same], rtol=1e-5)


def test_build_replay_kinds():
    assert type(build_replay(_replay_cfg("uniform")[1])).__name__ == "UniformReplay"
    assert type(build_replay(_replay_cfg("prioritized")[1])).__name__ == "PrioritizedReplay"
    assert type(build_replay(_replay_cfg("fifo")[1])).__name__ == "FIFOReplay"
    with pytest.raises(ValueError, match="remote"):
        build_replay(_replay_cfg("remote")[1])
    with pytest.raises(ValueError, match="unknown"):
        build_replay(_replay_cfg("ring")[1])


def test_check_insert_batch_names_the_bad_leaf():
    storage = {"obs": torch.zeros(8, 3), "reward": torch.zeros(8)}
    check_insert_batch({"obs": torch.zeros(2, 3), "reward": torch.zeros(2)}, storage)
    with pytest.raises(ValueError, match="keys"):
        check_insert_batch({"obs": torch.zeros(2, 3)}, storage)
    with pytest.raises(AssertionError, match="'obs'"):
        check_insert_batch({"obs": torch.zeros(2, 4), "reward": torch.zeros(2)}, storage)
