"""Drive the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 (any
sm_90 card) and the CUDA toolkit. Two paths are driven: PPO on jax:lift
(the GAE kernel) and IMPALA on pixel jax:pong (the V-trace kernel).
Phases, each printing one JSON line:

1. device  - the card as nvidia-smi and torch name it;
2. build   - every CUDA kernel of both paths, compiled from csrc/, one nvcc
             per source, all started together;
3. kernels - each kernel against its plain PyTorch version on the card,
             at its path's shapes and ragged ones, plus its time, its
             bound and the plain version's time (GAE, then V-trace);
4. parity  - one small f32 train iteration on the card and on the CPU
             with the same injected randomness (the CPU path is the one
             the tests hold against the JAX package), TF32 off: PPO on
             jax:lift, then IMPALA on jax:pong;
5. train   - ``Trainer(config).run`` with four warm-up iterations and
             eight timed ones; checks finite metrics and that every learn
             launched its path's kernel once:
             PPO at the north-star geometry (MLP 64x64, jax:lift, 4096
             envs x 256 steps, 4 epochs x 4 minibatches, 'mixed'), then
             IMPALA at the pong geometry (NatureCNN (32, 64, 64) / (8, 4,
             3) / (4, 2, 1) / 512, jax:pong [42, 42, 2] uint8 pixels, 1024
             envs x 32 steps, 'mixed').

Then the kernels summary line, the nvidia-smi line, and as the last line
``{"ok": true, "device": {...}}``. Any failure raises and exits non-zero;
without CUDA, or outside a checkout, it exits non-zero before printing.
"""

from __future__ import annotations

import json
import math
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
MAIN_T, MAIN_B = 256, 4096      # GAE's shape on the main path
KERNEL_SHAPES = [(MAIN_T, MAIN_B), (1, 1), (7, 1000), (MAIN_T, MAIN_B + 1)]
PONG_T, PONG_B = 32, 1024       # V-trace's shape on the IMPALA path
VTRACE_SHAPES = [(PONG_T, PONG_B), (1, 1), (7, 1000), (PONG_T, PONG_B + 1)]
# V-trace's float operations per element (csrc/vtrace.cu): rho 2 (sub,
# exp), delta 5, recursion 4, vs 1, successor 4, pg advantage 5
VTRACE_OPS = 21
WARMUP_ITERS, TIMED_ITERS = 4, 8
TRAIN_ITERS = WARMUP_ITERS + TIMED_ITERS
SPIN_CYCLES = 1_000_000         # about 0.5 ms of the card's clock, see time_cuda_ms
KERNEL_REPLACES = {  # the TPU kernel body each CUDA kernel replaces
    "gae": "surreal_tpu/ops/pallas_gae.py:51",
    "vtrace": "surreal_tpu/ops/pallas_vtrace.py:49",
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def gae_inputs(T: int, B: int, seed: int, device: str) -> list[torch.Tensor]:
    """Random GAE inputs with episode ends: 15% dones, half of them true
    terminations and half time-limit truncations."""
    rng = np.random.default_rng(seed)
    gamma, lam = 0.99, 0.97
    done = rng.random((T, B)) < 0.15
    terminated = done & (rng.random((T, B)) < 0.5)
    arrays = [
        rng.normal(size=(T, B)),                 # rewards
        gamma * (1.0 - terminated),              # bootstrap discount
        gamma * lam * (1.0 - done),              # accumulation decay
        rng.normal(size=(T, B)),                 # v_t
        rng.normal(size=(T, B)),                 # v_next
    ]
    return [torch.from_numpy(a.astype(np.float32)).to(device) for a in arrays]


def time_cuda_ms(fn, runs: int, flush: torch.Tensor, spin: bool) -> float:
    """Median CUDA-event time of one call, over ``runs`` calls after two
    warm-up calls, with L2 flushed before each (the 50 MB L2 would
    otherwise hold the whole working set between calls).

    With ``spin``, the card then spins for about half a millisecond
    (``torch.cuda._sleep``) before the start event, so that the host has
    enqueued the call before the card reaches it: the events bracket the
    card's time for the call alone. Without it they also take in the
    host's time to issue the call (the wrapper's allocations and the
    ctypes call for a kernel; every launch for the plain versions, whose
    time is mostly that)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def kernel_phase(name: str, wrapper, plain, make_inputs, shapes, reads: int, writes: int, ops: int) -> dict:
    """One kernel against its plain version on the card, exactly, at each
    of ``shapes`` (the first is its path's, which is also timed), with its
    bound from ``reads`` f32 inputs read and ``writes`` f32 outputs written
    once each, and ``ops`` f32 operations, per element."""
    checks = []
    max_abs = 0.0
    for T, B in shapes:
        inputs = make_inputs(T, B, seed=T * 7919 + B, device="cuda")
        got = wrapper(*inputs)
        want = plain(*inputs)
        torch.cuda.synchronize()
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        rel_err = max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max()) for g, w in zip(got, want))
        if not all(torch.equal(g, w) for g, w in zip(got, want)):
            raise AssertionError(f"{name} kernel != plain at [{T}, {B}]: max abs err {abs_err}")
        max_abs = max(max_abs, abs_err)
        checks.append({"shape": [T, B], "max_abs_err": abs_err, "max_rel_err": rel_err})

    T, B = shapes[0]
    inputs = make_inputs(T, B, seed=0, device="cuda")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    ms = time_cuda_ms(lambda: wrapper(*inputs), runs=30, flush=flush, spin=True)
    issued_ms = time_cuda_ms(lambda: wrapper(*inputs), runs=30, flush=flush, spin=False)
    plain_ms = time_cuda_ms(lambda: plain(*inputs), runs=5, flush=flush, spin=False)
    bytes_ms = (reads + writes) * 4 * T * B / H100_BYTES_PER_S * 1e3
    ops_ms = ops * T * B / H100_F32_FLOPS * 1e3
    result = {
        "name": name,
        "route": "cuda",
        "source": f"surreal_tpu_torch/csrc/{name}.cu",
        "replaces": KERNEL_REPLACES[name],
        "tpu_kernel": f"ops/pallas_{name}.py::_{name}_kernel",
        "max_abs_err": max_abs,
        "max_err": max_abs,
        "tolerance": "exact (0)",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,  # no single PyTorch call computes either
    }
    emit({"phase": "kernels", "kernel": name, "checks": checks, "timed_shape": [T, B],
          "ms_with_host_issue": issued_ms, **result})
    return result


def phase_kernels(ops_gae) -> dict:
    """GAE kernel vs its plain version. Exact equality is required: the
    kernel uses non-contracting _rn intrinsics (csrc/gae.cu), so it rounds
    where the plain version rounds. Per element: mul, add, sub, mul, add,
    add."""
    return kernel_phase(
        "gae", ops_gae.gae_advantages_masked, ops_gae.gae_masked_plain, gae_inputs, KERNEL_SHAPES,
        reads=5, writes=2, ops=6,
    )


def vtrace_inputs(T: int, B: int, seed: int, device: str) -> list[torch.Tensor]:
    """Random V-trace inputs in the kernel's order (bl, tl, r, boot, edge,
    v_t, v_next, done): 15% dones, half of them true terminations, and
    log-ratios of order 0.3, so that every clip level takes effect."""
    rng = np.random.default_rng(seed)
    gamma = 0.99
    done = rng.random((T, B)) < 0.15
    terminated = done & (rng.random((T, B)) < 0.5)
    bl = rng.normal(size=(T, B)) * 0.5 - 1.0
    arrays = [
        bl,                                      # behaviour log-prob
        bl + 0.3 * rng.normal(size=(T, B)),      # target log-prob
        rng.normal(size=(T, B)),                 # rewards
        gamma * (1.0 - terminated),              # boot: TD-delta discount
        gamma * (1.0 - done),                    # edge: recursion coefficient
        rng.normal(size=(T, B)),                 # v_t
        rng.normal(size=(T, B)),                 # v_next
        done,                                    # done mask
    ]
    return [torch.from_numpy(np.asarray(a, np.float32)).to(device) for a in arrays]


def phase_vtrace_kernel(ops_vtrace) -> dict:
    """V-trace kernel vs its plain version, at IMPALA's clip levels (all
    1.0). Exact equality is required: the kernel uses non-contracting _rn
    intrinsics (csrc/vtrace.cu) and takes rho with expf, the function
    torch.exp calls for float32 on the card, so it rounds where the plain
    version rounds (measured bit-equal on an H100 at every shape here)."""
    for T, B in (shape for shape in VTRACE_SHAPES if shape != (1, 1)):
        bl, tl = vtrace_inputs(T, B, seed=T * 7919 + B, device="cpu")[:2]
        rho = torch.exp(tl - bl)
        if not (bool((rho > 1.0).any()) and bool((rho < 1.0).any())):
            raise AssertionError(f"vtrace inputs at [{T}, {B}] do not exercise the clips")
    return kernel_phase(
        "vtrace", ops_vtrace.vtrace_fused, ops_vtrace.vtrace_fused_plain, vtrace_inputs, VTRACE_SHAPES,
        reads=8, writes=2, ops=VTRACE_OPS,
    )


def phase_parity(Config, base_config, Trainer) -> None:
    """One small f32 iteration on the card and on the CPU from the same
    weights and the same injected draws. Tolerances: the rollout is f32
    elementwise physics and small matmuls, whose transcendental functions
    and sums round differently on the two devices (1e-4); the metrics sum
    sixteen Adam steps (1e-3 relative). The update-ratio metric is held
    to 5e-2: obs dims that are constant over the batch normalize to
    rounding noise whose sign can differ between devices, and Adam steps
    those weights by up to lr whatever the noise's size."""
    from surreal_tpu_torch.envs.device.lift import RESET_HIGH, RESET_LOW
    from surreal_tpu_torch.learners.ppo import _block_layout

    B, T, epochs, num_mb = 64, 32, 4, 4
    cfg = Config(
        learner_config=Config(algo=Config(
            name="ppo", horizon=T, epochs=epochs, num_minibatches=num_mb, precision="f32")),
        env_config=Config(name="jax:lift", num_envs=B, time_limit=20),
        session_config=Config(folder="unused"),
    ).extend(base_config())
    gen = torch.Generator().manual_seed(1)
    lo, hi = torch.tensor(RESET_LOW), torch.tensor(RESET_HIGH)
    draws_init = lo + torch.rand((B, 5), generator=gen) * (hi - lo)
    draws = lo + torch.rand((T, B, 5), generator=gen) * (hi - lo)
    noise = torch.randn((T, B, 4), generator=gen)
    bpm = _block_layout(T * B, num_mb, 17 * 4)
    domain = num_mb * bpm if bpm else T * B
    perms = torch.stack([torch.randperm(domain, generator=gen) for _ in range(epochs)])
    out = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(cfg, device=dev)
        state = tr.learner.init(torch.Generator().manual_seed(0))
        carry = tr.init_loop_state(reset_draws=draws_init.to(dev))
        state, carry, metrics = tr._device_train_iter(
            state, carry, action_noise=noise.to(dev), reset_draws=draws.to(dev), perms=perms.to(dev),
        )
        out[dev] = (carry.obs.cpu(), {k: float(v) for k, v in metrics.items()})
    obs_err = float((out["cuda"][0] - out["cpu"][0]).abs().max())
    if obs_err > 1e-4:
        raise AssertionError(f"final obs differ between cuda and cpu by {obs_err}")
    errs = {}
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        rtol = 5e-2 if k == "health/update_ratio" else 1e-3
        if not ((math.isnan(want) and math.isnan(got)) or abs(got - want) <= 1e-4 + rtol * abs(want)):
            raise AssertionError(f"metric {k}: cuda {got} vs cpu {want}")
        errs[k] = abs(got - want)
    emit({"phase": "parity", "num_envs": B, "horizon": T, "final_obs_max_abs_err": obs_err,
          "metric_abs_err": errs})


def pong_config(Config, base_config, num_envs: int, horizon: int, precision: str, cnn: dict, **env):
    return Config(
        learner_config=Config(
            algo=Config(name="impala", horizon=horizon, precision=precision),
            model=Config(cnn=Config(enabled=True, **cnn)),
        ),
        env_config=Config(name="jax:pong", num_envs=num_envs, **env),
        session_config=Config(folder="unused", metrics=Config(every_n_iters=1)),
    ).extend(base_config())


def phase_parity_impala(Config, base_config, Trainer) -> None:
    """One small f32 IMPALA iteration on jax:pong (narrow NatureCNN, dense
    64, 8 envs x 16 steps, time limit 6 so envs reset mid-rollout) on the
    card and on the CPU, from the same weights and the same injected draws
    (Gumbel noise, Pong's serve and reset draws). TF32 is off for cuDNN
    and matmuls (utils/device.py), so both devices convolve in f32.
    Tolerances: the pixels are thresholds on f32 positions that the two
    devices compute with the same elementwise operations, and the actions
    an argmax over logits plus Gumbel noise, so the final obs must be
    equal; the metrics come from one Adam step whose convolution sums are
    taken in other orders (1e-3 relative). The update-ratio metric is
    held to 5e-2: Adam's first step is lr * g / (|g| + eps), so a weight
    whose gradient is near zero moves by up to lr on a last-bit difference
    of its gradient sum."""
    B, T = 8, 16
    cfg = pong_config(Config, base_config, B, T, "f32", dict(channels=(16, 32, 32), dense=64), time_limit=6)
    gen = torch.Generator().manual_seed(2)
    u = lambda *shape: torch.rand(shape, generator=gen)  # noqa: E731
    side = lambda *shape: (u(*shape) < 0.5).float()  # noqa: E731
    init_draws = torch.stack([u(B) * 0.04 - 0.02, side(B)], dim=1)
    reset_draws = torch.stack([u(T, B) * 0.04 - 0.02, side(T, B)], dim=2)
    step_draws = u(T, B, 1) * 0.04 - 0.02
    gumbel = -torch.log(-torch.log(u(T, B, 3).clamp_min(1e-20)))
    out = {}
    for dev in ("cuda", "cpu"):
        tr = Trainer(cfg, device=dev)
        state = tr.learner.init(torch.Generator().manual_seed(0))
        carry = tr.init_loop_state(reset_draws=init_draws.to(dev))
        state, carry, metrics = tr._device_train_iter(
            state, carry, action_noise=gumbel.to(dev), reset_draws=reset_draws.to(dev),
            step_draws=step_draws.to(dev),
        )
        out[dev] = (carry.obs.cpu(), {k: float(v) for k, v in metrics.items()})
    if torch.backends.cudnn.allow_tf32 or torch.backends.cuda.matmul.allow_tf32:
        raise AssertionError("TF32 is on; the f32 parity phase needs it off")
    if not torch.equal(out["cuda"][0], out["cpu"][0]):
        raise AssertionError("final pong obs differ between cuda and cpu")
    errs = {}
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        rtol = 5e-2 if k == "health/update_ratio" else 1e-3
        if not ((math.isnan(want) and math.isnan(got)) or abs(got - want) <= 1e-4 + rtol * abs(want)):
            raise AssertionError(f"impala metric {k}: cuda {got} vs cpu {want}")
        errs[k] = abs(got - want)
    emit({"phase": "parity", "path": "impala", "env": "jax:pong", "num_envs": B, "horizon": T,
          "tf32": False, "final_obs_equal": True, "metric_abs_err": errs})


def timed_run(trainer, wrapper, kernel: str):
    """``trainer.run`` for TRAIN_ITERS iterations on the card, with the
    kernel wrapper's launch count set to 0 just before and read just
    after; checks that every learn launched the kernel once and that
    every metric is finite. Returns (state, timing and count fields)."""
    if trainer.device.type != "cuda":
        raise AssertionError(f"Trainer ran on {trainer.device}")
    stamps = []

    def on_metrics(iteration, metrics):
        # run() reads the metrics back each iteration: a host sync, so the
        # gaps between these calls are fenced iteration times
        stamps.append((iteration, time.perf_counter(), metrics))

    torch.cuda.reset_peak_memory_stats()
    wrapper.launches = 0
    t0 = time.perf_counter()
    state, _ = trainer.run(max_env_steps=TRAIN_ITERS * trainer.steps_per_iter, on_metrics=on_metrics)
    launches = wrapper.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    if len(stamps) != TRAIN_ITERS:
        raise AssertionError(f"expected {TRAIN_ITERS} iterations, got {len(stamps)}")
    if launches != TRAIN_ITERS:
        raise AssertionError(f"{kernel} kernel launched {launches} times in {TRAIN_ITERS} learn calls")
    for _, _, metrics in stamps:
        for k, v in metrics.items():
            if not math.isfinite(v) and not (k == "episode/return" and math.isnan(v)):
                raise AssertionError(f"metric {k} is {v}")
    # iter_ms[i] is iteration i + 2; the median is over the timed ones
    iter_ms = [(b[1] - a[1]) * 1e3 for a, b in zip(stamps, stamps[1:])]
    median_ms = statistics.median(iter_ms[WARMUP_ITERS - 1:])
    return state, {
        "first_iter_ms": (stamps[0][1] - t0) * 1e3,
        "iter_ms": iter_ms,
        "warmup_iters": WARMUP_ITERS, "timed_iters": TIMED_ITERS,
        "iter_ms_median": median_ms,
        "env_steps_per_s": trainer.steps_per_iter / (median_ms / 1e3),
        f"{kernel}_launches": launches,
        "learn_calls": len(stamps),
        "peak_mem_gb": peak_gb,
        "metrics": stamps[-1][2],
    }


def phase_train(Config, base_config, Trainer, ops_gae) -> dict:
    cfg = Config(
        learner_config=Config(algo=Config(name="ppo", horizon=MAIN_T, epochs=4, num_minibatches=4, precision="mixed")),
        env_config=Config(name="jax:lift", num_envs=MAIN_B),
        session_config=Config(folder="unused", metrics=Config(every_n_iters=1)),
    ).extend(base_config())
    trainer = Trainer(cfg)  # the default device: the card
    state, timing = timed_run(trainer, ops_gae.gae_advantages_masked, "gae")
    result = {
        "phase": "train",
        "num_envs": MAIN_B, "horizon": MAIN_T, "epochs": 4, "num_minibatches": 4,
        "precision": "mixed",
        **timing,
        **breakdown(trainer, state),
    }
    emit(result)
    return result


def phase_train_impala(Config, base_config, Trainer, ops_vtrace) -> dict:
    """IMPALA at the pong geometry: the default NatureCNN, 1024 envs x 32
    steps, 'mixed', IMPALA's defaults (lr 6e-4, clip levels 1.0, value
    coefficient 0.5, entropy coefficient 0.01)."""
    cfg = pong_config(Config, base_config, PONG_B, PONG_T, "mixed", {})
    trainer = Trainer(cfg)  # the default device: the card
    state, timing = timed_run(trainer, ops_vtrace.vtrace_fused, "vtrace")
    result = {
        "phase": "train",
        "path": "impala",
        "env": "jax:pong",
        "num_envs": PONG_B, "horizon": PONG_T, "precision": "mixed",
        "cnn": {k: list(v) if isinstance(v, tuple) else v for k, v in trainer.learner.model_cfg["cnn"].items()},
        **timing,
        **breakdown(trainer, state),
    }
    emit(result)
    return result


def breakdown(trainer, state, reps: int = 2) -> dict:
    """Where an iteration's time goes: the rollout and the learn, each
    fenced by synchronize, after the counted run (these launches are not
    counted)."""
    from surreal_tpu_torch.launch.rollout import device_rollout

    generator = torch.Generator(device="cuda").manual_seed(1)
    carry = trainer.init_loop_state(generator)

    def fenced_ms(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    rollout_ms, learn_ms = [], []
    for _ in range(reps):
        (carry, batch), ms = fenced_ms(lambda: device_rollout(
            trainer.env, trainer.learner, state, carry, trainer.horizon, generator))
        rollout_ms.append(ms)
        batch = {k: batch[k] for k in (
            "obs", "next_obs", "action", "reward", "done", "terminated", "behavior_logp", "behavior")}
        (state, _), ms = fenced_ms(lambda: trainer.learner.learn(state, batch, generator))
        learn_ms.append(ms)
    return {"rollout_ms": rollout_ms, "learn_ms": learn_ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from surreal_tpu_torch.launch.trainer import Trainer
    from surreal_tpu_torch.ops import gae as ops_gae
    from surreal_tpu_torch.ops import vtrace as ops_vtrace
    from surreal_tpu_torch.session.config import Config
    from surreal_tpu_torch.session.default_configs import base_config
    from surreal_tpu_torch.utils.kernel_build import build_kernel

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    kernels = ["gae", "vtrace"]
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(kernels)) as pool:  # one nvcc per source, all at once
        list(pool.map(build_kernel, kernels))
    emit({"phase": "build", "kernels": kernels, "seconds": time.perf_counter() - t0})

    gae = phase_kernels(ops_gae)
    vtrace = phase_vtrace_kernel(ops_vtrace)
    phase_parity(Config, base_config, Trainer)
    phase_parity_impala(Config, base_config, Trainer)
    train = phase_train(Config, base_config, Trainer, ops_gae)
    gae["launches"] = train["gae_launches"]
    train_impala = phase_train_impala(Config, base_config, Trainer, ops_vtrace)
    vtrace["launches"] = train_impala["vtrace_launches"]

    emit({"kernels": [gae, vtrace]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
