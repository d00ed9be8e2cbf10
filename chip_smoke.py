"""Drive the PyTorch port's main path on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout, on a machine with an NVIDIA H100 (any
sm_90 card) and the CUDA toolkit. Phases, each printing one JSON line:

1. device  - the card as nvidia-smi and torch name it;
2. build   - every CUDA kernel of the main path, compiled from csrc/;
3. kernels - each kernel against its plain PyTorch version on the card,
             at the main path's shapes and ragged ones, plus its time, its
             bound and the plain version's time;
4. parity  - one small f32 train iteration on the card and on the CPU
             with the same injected randomness (the CPU path is the one
             the tests hold against the JAX package);
5. train   - ``Trainer(config).run`` at the north-star geometry (PPO, MLP
             64x64, jax:lift, 4096 envs x 256 steps, 4 epochs x 4
             minibatches, 'mixed'), four warm-up iterations and eight
             timed ones; checks finite metrics and that every learn launched
             the GAE kernel.

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

import numpy as np
import torch

H100_BYTES_PER_S = 3.35e12      # HBM3, H100 SXM data sheet
H100_F32_FLOPS = 67e12          # float32 outside the tensor cores
MAIN_T, MAIN_B = 256, 4096      # GAE's shape on the main path
KERNEL_SHAPES = [(MAIN_T, MAIN_B), (1, 1), (7, 1000), (MAIN_T, MAIN_B + 1)]
WARMUP_ITERS, TIMED_ITERS = 4, 8
TRAIN_ITERS = WARMUP_ITERS + TIMED_ITERS


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


def time_cuda_ms(fn, runs: int, flush: torch.Tensor) -> float:
    """Median CUDA-event time of one call, over ``runs`` calls after two
    warm-up calls, with L2 flushed before each (the 50 MB L2 would
    otherwise hold the whole working set between calls)."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_kernels(ops_gae) -> dict:
    """GAE kernel vs its plain version. Exact equality is required: the
    kernel uses non-contracting _rn intrinsics (csrc/gae.cu), so it rounds
    where the plain version rounds."""
    checks = []
    max_abs = 0.0
    for T, B in KERNEL_SHAPES:
        inputs = gae_inputs(T, B, seed=T * 7919 + B, device="cuda")
        got = ops_gae.gae_advantages_masked(*inputs)
        want = ops_gae.gae_masked_plain(*inputs)
        torch.cuda.synchronize()
        abs_err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        rel_err = max(float(((g - w).abs() / w.abs().clamp_min(1e-30)).max()) for g, w in zip(got, want))
        if abs_err != 0.0:
            raise AssertionError(f"gae kernel != plain at [{T}, {B}]: max abs err {abs_err}")
        max_abs = max(max_abs, abs_err)
        checks.append({"shape": [T, B], "max_abs_err": abs_err, "max_rel_err": rel_err})

    inputs = gae_inputs(MAIN_T, MAIN_B, seed=0, device="cuda")
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    ms = time_cuda_ms(lambda: ops_gae.gae_advantages_masked(*inputs), runs=30, flush=flush)
    plain_ms = time_cuda_ms(lambda: ops_gae.gae_masked_plain(*inputs), runs=5, flush=flush)
    n = MAIN_T * MAIN_B
    bytes_moved = (5 + 2) * 4 * n      # 5 f32 inputs read, 2 f32 outputs written
    flops = 6 * n                      # mul, add, sub, mul, add, add per element
    bytes_ms = bytes_moved / H100_BYTES_PER_S * 1e3
    ops_ms = flops / H100_F32_FLOPS * 1e3
    result = {
        "name": "gae",
        "route": "cuda",
        "source": "surreal_tpu_torch/csrc/gae.cu",
        "replaces": "surreal_tpu/ops/pallas_gae.py:51",
        "tpu_kernel": "ops/pallas_gae.py::_gae_kernel",
        "max_abs_err": max_abs,
        "max_err": max_abs,
        "tolerance": "exact (0)",
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": None,
    }
    emit({"phase": "kernels", "kernel": "gae", "checks": checks, "timed_shape": [MAIN_T, MAIN_B], **result})
    return result


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


def phase_train(Config, base_config, Trainer, ops_gae) -> dict:
    cfg = Config(
        learner_config=Config(algo=Config(name="ppo", horizon=MAIN_T, epochs=4, num_minibatches=4, precision="mixed")),
        env_config=Config(name="jax:lift", num_envs=MAIN_B),
        session_config=Config(folder="unused", metrics=Config(every_n_iters=1)),
    ).extend(base_config())
    trainer = Trainer(cfg)  # the default device: the card
    if trainer.device.type != "cuda":
        raise AssertionError(f"Trainer ran on {trainer.device}")
    stamps = []

    def on_metrics(iteration, metrics):
        # run() reads the metrics back each iteration: a host sync, so the
        # gaps between these calls are fenced iteration times
        stamps.append((iteration, time.perf_counter(), metrics))

    torch.cuda.reset_peak_memory_stats()
    ops_gae.gae_advantages_masked.launches = 0
    t0 = time.perf_counter()
    state, _ = trainer.run(max_env_steps=TRAIN_ITERS * trainer.steps_per_iter, on_metrics=on_metrics)
    launches = ops_gae.gae_advantages_masked.launches
    if len(stamps) != TRAIN_ITERS:
        raise AssertionError(f"expected {TRAIN_ITERS} iterations, got {len(stamps)}")
    if launches != TRAIN_ITERS:
        raise AssertionError(f"GAE kernel launched {launches} times in {TRAIN_ITERS} learn calls")
    last = stamps[-1][2]
    for k, v in last.items():
        if not math.isfinite(v) and not (k == "episode/return" and math.isnan(v)):
            raise AssertionError(f"metric {k} is {v}")
    # iter_ms[i] is iteration i + 2; the median is over the timed ones
    iter_ms = [(b[1] - a[1]) * 1e3 for a, b in zip(stamps, stamps[1:])]
    median_ms = statistics.median(iter_ms[WARMUP_ITERS - 1:])
    result = {
        "phase": "train",
        "num_envs": MAIN_B, "horizon": MAIN_T, "epochs": 4, "num_minibatches": 4,
        "precision": "mixed",
        "first_iter_ms": (stamps[0][1] - t0) * 1e3,
        "iter_ms": iter_ms,
        "warmup_iters": WARMUP_ITERS, "timed_iters": TIMED_ITERS,
        "iter_ms_median": median_ms,
        "env_steps_per_s": trainer.steps_per_iter / (median_ms / 1e3),
        "gae_launches": launches,
        "learn_calls": len(stamps),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        "metrics": last,
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
    from surreal_tpu_torch.session.config import Config
    from surreal_tpu_torch.session.default_configs import base_config
    from surreal_tpu_torch.utils.kernel_build import build_kernel

    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind, "count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda})

    t0 = time.perf_counter()
    build_kernel("gae")
    emit({"phase": "build", "kernels": ["gae"], "seconds": time.perf_counter() - t0})

    gae = phase_kernels(ops_gae)
    phase_parity(Config, base_config, Trainer)
    train = phase_train(Config, base_config, Trainer, ops_gae)
    gae["launches"] = train["gae_launches"]

    emit({"kernels": [gae]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
