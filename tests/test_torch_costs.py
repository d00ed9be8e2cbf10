"""The port's cost accounting (``surreal_tpu_torch/session/costs.py``)
against the reference's (``surreal_tpu/session/costs.py``), on the CPU.

- FLOPs: the counted call of a Dense layer, a 2-layer MLP forward and a
  NatureCNN forward equals ``jitted.lower(...).cost_analysis()`` of the
  reference's module exactly, FLOPs and transcendentals, in float32
  (matmuls and convolutions 2·M·N·K; bias adds, activations and the
  uint8 scaling one op an element, as XLA counts them). Under bf16
  compute the port converts the weights at each call where flax converts
  them once, so its conversions (one FLOP an element) run 0.26% over;
  the bar is 0.5%. The CNN's gradient: 0.23% under, bar 0.5%.
- One PPO minibatch step (loss, gradients, Adam, the update), held to
  the reference's jitted step on the same shapes, under every policy.
  Measured: FLOPs 0.43% under XLA's (the reference's elementwise ops
  that PyTorch fuses or spells differently; 0.17% under at 'bf16',
  0.57% over at 'bf16_fp8', whose quantization and cotangent cast add
  elementwise ops), transcendentals 1.8% over, bytes 0.65, 0.69, 0.73
  and 0.76 of XLA's (XLA's pass runs before fusion and also counts
  broadcasts, reshapes and constants). Bars: FLOPs within 1%,
  transcendentals within 2.5%, bytes between 0.5 and 0.8 of XLA's.
- The gauge arithmetic by hand, mirroring ``tests/test_perf_obs.py``
  (the hand-computed window, no peak spec, the peak override reaching
  the denominator of a real run, the override and table lookup), plus
  the port's one change: a window's ``metrics-sync`` seconds join the
  denominator.
- A counted iteration is bit-equal to an uncounted one.
- Each kernel wrapper reports its formula and nothing of its plain
  version."""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import tests.test_torch_ppo as tp
from surreal_tpu.models.encoders import MLP as JaxMLP
from surreal_tpu.models.encoders import NatureCNN as JaxNatureCNN
from surreal_tpu.session import costs as jax_costs
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu_torch.launch.trainer import Trainer
from surreal_tpu_torch.learners.base import apply_updates, global_norm
from surreal_tpu_torch.models.encoders import MLP, NatureCNN, dense
from surreal_tpu_torch.ops import gae as G
from surreal_tpu_torch.ops import replay_rows as RR
from surreal_tpu_torch.ops import rev_scan as RS
from surreal_tpu_torch.ops import vtrace as V
from surreal_tpu_torch.session import costs
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config


def _xla(f, *args):
    c = jax.jit(f).lower(*args).cost_analysis()
    return {"flops": float(c.get("flops", 0.0)), "transcendentals": float(c.get("transcendentals", 0.0)),
            "bytes": float(c.get("bytes accessed", 0.0))}


def _port(f, *args):
    _, c = costs.program_costs(f, *args)
    return {"flops": c["flops"], "transcendentals": c["transcendentals"], "bytes": c["bytes_accessed"]}


# -- FLOPs against XLA's cost model -------------------------------------------

def test_dense_layer_flops_equal_xla():
    rng = np.random.default_rng(0)
    x, w, b = (rng.normal(size=s).astype(np.float32) for s in ((32, 17), (17, 64), (64,)))
    want = _xla(lambda x, w, b: x @ w + b, x, w, b)
    layer = torch.nn.Linear(17, 64)
    got = _port(lambda x: dense(x, layer, torch.float32), torch.from_numpy(x))
    assert got["flops"] == want["flops"] == 2 * 32 * 17 * 64 + 32 * 64
    assert got["transcendentals"] == want["transcendentals"] == 0


def test_mlp_forward_flops_equal_xla():
    x = np.random.default_rng(1).normal(size=(32, 17)).astype(np.float32)
    jm = JaxMLP(hidden=(64, 64), compute_dtype=jnp.float32)
    jp = jm.init(jax.random.key(0), jnp.asarray(x))
    want = _xla(lambda p, x: jm.apply(p, x), jp, jnp.asarray(x))
    got = _port(MLP(17, (64, 64), compute_dtype=torch.float32), torch.from_numpy(x))
    assert got["flops"] == want["flops"]
    assert got["transcendentals"] == want["transcendentals"] == 2 * 32 * 64  # the two tanh


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nature_cnn_forward_flops_match_xla(dtype):
    x = np.random.default_rng(2).integers(0, 255, size=(4, 42, 42, 2)).astype(np.uint8)
    widths = dict(channels=(8, 16), kernels=(4, 3), strides=(2, 1), dense=32)
    jm = JaxNatureCNN(**widths, compute_dtype=jnp.dtype(dtype))
    jp = jm.init(jax.random.key(0), jnp.asarray(x))
    want = _xla(lambda p, x: jm.apply(p, x), jp, jnp.asarray(x))
    got = _port(NatureCNN((42, 42, 2), **widths, compute_dtype=getattr(torch, dtype)), torch.from_numpy(x))
    assert got["transcendentals"] == want["transcendentals"] == 0
    if dtype == "float32":
        assert got["flops"] == want["flops"]
    else:
        assert got["flops"] == pytest.approx(want["flops"], rel=5e-3)


def test_nature_cnn_gradient_flops_match_xla():
    """The convolutions' backward (input and weight gradients, 2·M·N·K
    each) and the bias gradients' reductions: measured 0.23% under XLA's
    (its pass also counts the transposes and pads of the gradient
    convolutions); the bar is 0.5%."""
    x = np.random.default_rng(2).integers(0, 255, size=(4, 42, 42, 2)).astype(np.uint8)
    widths = dict(channels=(8, 16), kernels=(4, 3), strides=(2, 1), dense=32)
    jm = JaxNatureCNN(**widths, compute_dtype=jnp.float32)
    jp = jm.init(jax.random.key(0), jnp.asarray(x))
    want = _xla(jax.grad(lambda p, x: jm.apply(p, x).sum()), jp, jnp.asarray(x))
    tm = NatureCNN((42, 42, 2), **widths, compute_dtype=torch.float32)
    got = _port(lambda x: torch.autograd.grad(tm(x).sum(), list(tm.parameters())), torch.from_numpy(x))
    assert got["flops"] == pytest.approx(want["flops"], rel=5e-3)
    assert got["transcendentals"] == want["transcendentals"] == 0


@pytest.mark.parametrize("precision", ["f32", "mixed", "bf16", "bf16_fp8"])
def test_ppo_minibatch_step_totals_within_the_measured_band(precision):
    jl, tl = tp._learners({"precision": precision})
    j_state = tp._jax_init_state()
    n = 64
    rng = np.random.default_rng(3)
    shapes = {"obs": (n, tp.OBS), "action": (n, tp.ACT), "behavior_logp": (n,), "adv": (n,), "target": (n,),
              "value_old": (n,), "b_mean": (n, tp.ACT), "b_log_std": (n, tp.ACT)}
    mb = {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}

    def jax_step(params, opt_state, mb):
        grads, aux = jax.grad(jl._loss_fn, has_aux=True)(params, mb, 1.0, 1.0, 1.0)
        aux["grad_norm"] = optax.global_norm(grads)
        updates, opt_state = jl.tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, aux

    def port_step(params, opt_state, mb):
        leaves = {k: v.detach().requires_grad_(True) for k, v in params.items()}
        total, aux = tl._loss_fn(leaves, mb, torch.tensor(1.0), torch.tensor(1.0))
        grads = dict(zip(leaves, torch.autograd.grad(total, list(leaves.values()))))
        with torch.no_grad():
            aux["grad_norm"] = global_norm(grads)
            updates, opt_state = tl.tx.update(grads, opt_state)
            return apply_updates(params, updates), opt_state, aux

    want = _xla(jax_step, j_state.params, jl.tx.init(j_state.params), jax.tree.map(jnp.asarray, mb))
    t_state = tl.state_from_params(tp.params_from_jax(tp._np_tree(j_state.params)))
    got = _port(port_step, t_state.params, t_state.opt_state, {k: torch.from_numpy(v) for k, v in mb.items()})
    assert got["flops"] == pytest.approx(want["flops"], rel=1e-2)
    assert got["transcendentals"] == pytest.approx(want["transcendentals"], rel=2.5e-2)
    assert 0.5 * want["bytes"] <= got["bytes"] <= 0.8 * want["bytes"]


# -- gauge arithmetic, by hand --------------------------------------------------

def _accountants(cfg: dict):
    return jax_costs.CostAccountant(JaxConfig(cfg)), costs.CostAccountant(Config(cfg))


def test_mfu_gauge_arithmetic_hand_computed():
    """As tests/test_perf_obs.py's: one program of known FLOPs and bytes,
    a window of known count and seconds, exact peaks; both accountants
    give the hand-computed numbers."""
    cfg = {"perf": {"peak_flops": 1e9, "peak_membw": 1e8, "memory_analysis": False}}
    for acct in _accountants(cfg):
        acct.peak = (jax_costs if isinstance(acct, jax_costs.CostAccountant) else costs).PeakSpec(
            1e9, 1e8, "test", "override")
        acct._programs["prog"] = {"name": "prog", "phase": "train_iter", "calls_per_phase": 1, "flops": 1e6,
                                  "bytes_accessed": 5e5, "arithmetic_intensity": 2.0}
        window = {"train_iter": {"count": 4, "total_s": 0.5, "max_ms": 200.0}}
        g = acct.gauges(window)
        assert g["perf/flops_per_s"] == pytest.approx(8e6)
        assert g["perf/mfu"] == pytest.approx(8e6 / 1e9)
        assert g["perf/membw_util"] == pytest.approx(4e6 / 1e8)
        acct._programs["prog"]["calls_per_phase"] = 3
        assert acct.gauges(window)["perf/mfu"] == pytest.approx(3 * g["perf/mfu"])
        assert acct.gauges({"other": {"count": 1, "total_s": 1.0}}) == {}
        assert acct.gauges({}) == {} and acct.gauges(None) == {}


def test_metrics_sync_joins_the_denominator():
    """The port's one change to the arithmetic: the window's fence, the
    metrics-sync span, is where the device's tail lands, so its seconds
    join the programs' phase seconds; a window without a program phase
    stays empty."""
    acct = costs.CostAccountant(Config({"perf": {"peak_flops": 1e9, "peak_membw": 1e8}}))
    acct.peak = costs.PeakSpec(1e9, 1e8, "test", "override")
    acct._programs["prog"] = {"name": "prog", "phase": "train_iter", "calls_per_phase": 1, "flops": 1e6,
                              "bytes_accessed": 5e5}
    window = {"train_iter": {"count": 4, "total_s": 0.3}, "metrics-sync": {"count": 4, "total_s": 0.2}}
    g = acct.gauges(window)
    assert g["perf/flops_per_s"] == pytest.approx(4e6 / 0.5)
    assert g["perf/membw_util"] == pytest.approx(2e6 / 0.5 / 1e8)
    assert acct.gauges({"metrics-sync": {"count": 1, "total_s": 1.0}}) == {}


def test_gauges_without_peak_spec_still_report_flops():
    for acct in _accountants({"perf": {"memory_analysis": False}}):
        mod = jax_costs if isinstance(acct, jax_costs.CostAccountant) else costs
        acct.peak = mod.PeakSpec(None, None, "mystery-chip", "unknown")
        acct._programs["p"] = {"name": "p", "phase": "learn", "calls_per_phase": 1, "flops": 2e6,
                               "bytes_accessed": 1e6, "arithmetic_intensity": 2.0}
        g = acct.gauges({"learn": {"count": 2, "total_s": 1.0}})
        assert g["perf/flops_per_s"] == pytest.approx(4e6)
        assert "perf/mfu" not in g and "perf/membw_util" not in g


def test_resolve_peak_spec_override_table_and_h100():
    spec = costs.resolve_peak_spec(Config(perf=Config(peak_flops=1e12, peak_membw=2e11)))
    assert (spec.source, spec.flops, spec.membw) == ("override", 1e12, 2e11)
    for cfg in (Config(perf=Config()), Config(perf=Config(peak_flops=3e11))):
        want = jax_costs._table_lookup("cpu")
        got = costs.resolve_peak_spec(cfg, "cpu")
        assert got.device_kind == "cpu" and got.membw == want[1]  # the reference's cpu row
    assert costs._table_lookup("NVIDIA H100 80GB HBM3") == (989.4e12, 3.35e12)
    assert costs._table_lookup("TPU v5 lite") == jax_costs._table_lookup("TPU v5 lite")
    assert set(costs.GAUGE_REGISTRY) == set(jax_costs.GAUGE_REGISTRY)
    assert costs.GAUGE_UNITS == jax_costs.GAUGE_UNITS


def _tiny_session(folder, **session):
    horizon, num_envs = 8, 8
    cfg = Config(
        learner_config=Config(algo=Config(name="ppo", horizon=horizon, epochs=1, num_minibatches=1)),
        env_config=Config(name="jax:cartpole", num_envs=num_envs),
        session_config=Config(
            folder=str(folder), total_env_steps=horizon * num_envs * 4,
            metrics=Config(every_n_iters=2, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0), **session,
        ),
    ).extend(base_config())
    return Trainer(cfg, device="cpu").run()


def test_mfu_uses_peak_override(tmp_path):
    """As the reference's: the override is the denominator, so mfu over
    flops/s is exactly 1 / peak in a real run."""
    _, m = _tiny_session(tmp_path, perf=Config(peak_flops=1e10, peak_membw=1e10))
    assert m["perf/mfu"] > 0 and m["perf/membw_util"] > 0
    assert m["perf/mfu"] / m["perf/flops_per_s"] == pytest.approx(1e-10)


# -- the counted call -----------------------------------------------------------

def test_counted_iteration_is_bit_equal_to_an_uncounted_one():
    cfg = Config(
        learner_config=Config(algo=Config(name="ppo", horizon=8, epochs=2, num_minibatches=2)),
        env_config=Config(name="jax:lift", num_envs=8),
        session_config=Config(folder="unused"),
    ).extend(base_config())
    trainer = Trainer(cfg, device="cpu")
    state = trainer.learner.init(torch.Generator().manual_seed(0))
    carry = trainer.init_loop_state(torch.Generator().manual_seed(1))

    def run(counted: bool):
        args = (copy.deepcopy(state), copy.deepcopy(carry), torch.Generator().manual_seed(2))
        if counted:
            out, c = costs.program_costs(trainer._device_train_iter, *args)
            assert c["flops"] > 0 and c["kernels"]["gae"]["calls"] == 1
            return out
        return trainer._device_train_iter(*args)

    plain, counted = run(False), run(True)
    flat_p, spec_p = torch.utils._pytree.tree_flatten(plain)
    flat_c, spec_c = torch.utils._pytree.tree_flatten(counted)
    assert spec_p == spec_c and len(flat_p) == len(flat_c)
    for a, b in zip(flat_p, flat_c):
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b) or (a.isnan().any() and torch.equal(a.isnan(), b.isnan()))
        else:
            assert a == b


def test_count_program_counts_the_first_call_only():
    events = []
    acct = costs.CostAccountant(Config({}), on_event=lambda t, **kw: events.append((t, kw)))
    x = torch.ones(4, 3)
    calls = []

    def fn(x):
        calls.append(1)
        return x * 2

    for _ in range(3):
        assert torch.equal(acct.count_program("p", fn, x, phase="learn", calls_per_phase=2), x * 2)
    assert len(calls) == 3 and [t for t, _ in events] == ["program_cost"]
    rec = events[0][1]
    assert (rec["name"], rec["phase"], rec["calls_per_phase"], rec["flops"]) == ("p", "learn", 2, 12.0)
    assert rec["device_kind"] == "cpu" and rec["peak_source"] == "table"
    off = costs.CostAccountant(Config({"perf": {"enabled": False}}))
    assert torch.equal(off.count_program("p", fn, x), x * 2) and off.programs == {}


# -- the kernels' own counts ----------------------------------------------------

def _kernel_cases():
    rng = np.random.default_rng(4)
    T, B = 16, 8

    def f32(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))

    leaves = {"obs": f32(100, 17), "action": f32(100, 4), "reward": f32(100)}
    idx = torch.from_numpy(rng.integers(0, 100, size=32).astype(np.int32))
    return [
        ("gae", G.gae_advantages_masked, [f32(T, B) for _ in range(5)], G.GAE_OPS * T * B, 7 * 4 * T * B),
        ("vtrace", V.vtrace_fused, [*(f32(T, B) for _ in range(7)), torch.zeros(T, B)],
         V.VTRACE_OPS * T * B, 10 * 4 * T * B),
        ("rev_scan", RS.reverse_linear_scan, [f32(T, B), f32(T, B)], 2 * T * B, 3 * 4 * T * B + 4 * B),
        ("replay_gather", RR.gather_rows, [leaves, idx], 0, 2 * 32 * (17 + 4 + 1) * 4 + 4 * 32),
        ("replay_scatter", RR.scatter_rows, [f32(100), idx, f32(32)], 0, 4 * 32 + 2 * 32 * 4),
    ]


@pytest.mark.parametrize("case", range(5), ids=[c[0] for c in _kernel_cases()])
def test_kernel_wrapper_reports_its_formula(case):
    name, fn, args, flops, nbytes = _kernel_cases()[case]
    want = fn(*copy.deepcopy(args))
    got, c = costs.program_costs(fn, *args)
    assert c["kernels"] == {name: {"calls": 1, "flops": flops, "bytes": nbytes}}
    # nothing of the plain version (nor the wrapper's checks) is counted
    assert (c["ops"], c["flops"], c["bytes_accessed"], c["transcendentals"]) == (0, flops, nbytes, 0)
    # the counted call computes what the uncounted one does
    for a, b in zip(torch.utils._pytree.tree_leaves(got), torch.utils._pytree.tree_leaves(want)):
        assert torch.equal(a, b)
    assert costs.active_counter() is None
