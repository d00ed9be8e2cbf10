"""Measurement-driven search over the declared candidate space, the port
of ``surreal_tpu/tune/search.py``.

Timing: warm-up iterations absorb the first use of each program (the
kernels' nvcc build included, once a process), a throwaway chained window
follows, and the measured window is a CHAINED loop (each iteration
consumes the previous state) on the host clock, fenced by
``torch.cuda.synchronize()`` before and after, as ``chip_smoke.py``'s
timed runs fence theirs (on the CPU, eager ops are synchronous).
Candidates are timed through the REAL trainer programs
(``Trainer._device_train_iter`` / ``OffPolicyTrainer._device_train_iter``,
or ``learner.learn`` for host envs), not proxies, so the winner is the
winner of the program that will actually run. Each trial builds its own
trainer from its own seeded generators (never the session's) and
releases it, and the card's cached blocks, before the next.

Search strategy, the reference's: greedy coordinate descent in the
space's declared order. Measure the static default as the incumbent, then
walk one dimension at a time, adopting a candidate only when it beats the
incumbent by ``min_gain`` (2%).
"""

from __future__ import annotations

import copy
import gc
import sys
import time

import numpy as np
import torch

from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.tune.cache import TuningCache, resolve_tuning_cache_dir
from surreal_tpu_torch.tune.fingerprint import workload_fingerprint
from surreal_tpu_torch.tune.space import candidate_space, skip_dimension
from surreal_tpu_torch.utils.device import resolve_device

WARMUP = 2       # first use of each program (unmeasured)
THROWAWAY = 2    # a chained window before the measured one (unmeasured)
ITERS = 8        # measured chained iterations per candidate
MIN_GAIN = 0.02  # adoption threshold vs the incumbent (noise floor)
TIMING = ("chained window on the host clock, fenced by torch.cuda.synchronize "
          "(eager ops on the CPU)")

# The dims that live inside the LEARN program alone: the search surface
# for HOST-env workloads (gym/dm_control/SEED), whose rollout is host
# python. The reference's tuple; of it the port's space has precision,
# gae_impl, shuffle and vtrace_impl.
LEARN_PHASE_DIMS = (
    "gae_impl", "gae_unroll", "sgd_unroll", "shuffle",
    "precision", "vtrace_impl",
)


def search_space_for(config, extended_learner_config) -> list[tuple[str, list]]:
    """The dims :func:`tune_workload` will search for this workload: the
    full declared space for device (``jax:*``) envs, the learn-phase
    subset for host envs. Empty means the workload has nothing searchable
    (host-env DDPG: its update loop runs over n-step REPLAY batches, which
    the synthetic learn batch cannot fabricate); callers stay on
    defaults."""
    space = candidate_space(extended_learner_config)
    if not str(config.env_config.name).startswith("jax:"):
        if extended_learner_config.algo.name == "ddpg":
            return []
        space = [(n, v) for n, v in space if n in LEARN_PHASE_DIMS]
    return space


def _candidate_config(config, point: dict):
    """A deep-copied config bundle with the candidate knobs pinned and the
    autotuner disabled (the measured trainer must not recurse into the
    cache it is populating)."""
    from surreal_tpu_torch.session.config import Config

    cfg = copy.deepcopy(config)
    algo = cfg.learner_config.get("algo", None)
    if algo is None:
        cfg.learner_config.algo = Config()
        algo = cfg.learner_config.algo
    for k, v in point.items():
        algo[k] = v
    algo["autotune"] = "off"
    return cfg


def _fence(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _timed(step, device: torch.device, warmup: int, throwaway: int, iters: int) -> float:
    """ms an iteration of ``step()`` (which chains its own state) over the
    measured window."""
    for _ in range(warmup + throwaway):
        step()
    _fence(device)
    t0 = time.perf_counter()
    for _ in range(iters):
        step()
    _fence(device)
    return (time.perf_counter() - t0) / iters * 1e3


def _measure_onpolicy(cfg, warmup: int, throwaway: int, iters: int, device) -> float:
    """ms/iter of the device on-policy iteration (PPO / IMPALA)."""
    from surreal_tpu_torch.launch.trainer import Trainer

    trainer = Trainer(cfg, device=device)
    generator = torch.Generator(device=trainer.device).manual_seed(0)
    loop = [trainer.learner.init(torch.Generator().manual_seed(0)), trainer.init_loop_state(generator)]

    def step():
        loop[0], loop[1], _ = trainer._device_train_iter(loop[0], loop[1], generator)

    return _timed(step, trainer.device, warmup, throwaway, iters)


def _measure_offpolicy(cfg, warmup: int, throwaway: int, iters: int, device) -> float:
    """ms/iter of the device off-policy iteration (DDPG).

    The measurement copy caps ``replay.start_sample_size`` at one chunk so
    the timed window exercises the ``updates_per_iter`` loop (otherwise a
    large start gate would time rollout-only iterations)."""
    from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer
    from surreal_tpu_torch.session.config import Config

    steps_per_chunk = int(cfg.env_config.num_envs) * int(cfg.learner_config.algo.get("horizon", 16))
    cfg = Config(
        learner_config=Config(replay=Config(start_sample_size=min(1000, steps_per_chunk))),
    ).extend(cfg)
    trainer = OffPolicyTrainer(cfg, device=device)
    generator = torch.Generator(device=trainer.device).manual_seed(0)
    carry, replay_state = trainer.init_loop_state(generator)
    loop = [trainer.learner.init(torch.Generator().manual_seed(0)), replay_state, carry, True]

    def step():
        state, replay_state, carry, first = loop
        loop[:3] = trainer._device_train_iter(state, replay_state, carry, 0.5, False, first, generator)[:3]
        loop[3] = False

    return _timed(step, trainer.device, warmup, throwaway, iters)


def _synthetic_learn_batch(specs, T: int, B: int, seed: int = 0) -> dict:
    """A [T, B] learner batch matching the PPO/IMPALA batch contract
    (utils/asserts.check_learn_batch), shapes and dtypes from the env
    specs, values from a fixed-seed RNG: the reference's draws, in its
    order. The timed learn program is shape-determined; values only have
    to be plausible (finite logps, sparse episode boundaries)."""
    rng = np.random.default_rng(seed)
    obs_shape = (T, B, *specs.obs.shape)
    if np.dtype(specs.obs.dtype) == np.uint8:
        obs = rng.integers(0, 256, obs_shape, dtype=np.uint8)
        next_obs = rng.integers(0, 256, obs_shape, dtype=np.uint8)
    else:
        obs = rng.standard_normal(obs_shape, dtype=np.float32)
        next_obs = rng.standard_normal(obs_shape, dtype=np.float32)
    done = rng.random((T, B)) < 1.0 / 50.0  # ~one boundary per 50 steps
    batch = {
        "obs": obs,
        "next_obs": next_obs,
        "reward": rng.standard_normal((T, B), dtype=np.float32),
        "done": done,
        "terminated": done & (rng.random((T, B)) < 0.5),
        "behavior_logp": rng.normal(-1.0, 0.1, (T, B)).astype(np.float32),
    }
    if specs.discrete:
        n = int(specs.action.n)
        batch["action"] = rng.integers(0, n, (T, B), dtype=np.int32)
        batch["behavior"] = {"logits": rng.normal(0.0, 0.1, (T, B, n)).astype(np.float32)}
    else:
        a = int(specs.action.shape[0])
        batch["action"] = rng.uniform(-1.0, 1.0, (T, B, a)).astype(np.float32)
        batch["behavior"] = {
            "mean": rng.normal(0.0, 0.1, (T, B, a)).astype(np.float32),
            "log_std": np.full((T, B, a), -0.5, np.float32),
        }
    return batch


def _measure_learn(cfg, warmup: int, throwaway: int, iters: int, device) -> float:
    """ms/iter of the LEARN program alone, on a synthetic batch: the
    host-env measurement surface (there is no device iteration to time
    when envs step on the host). The batch is [algo.horizon,
    env_config.num_envs], the chunk of the host loops and the
    non-pipelined SEED plane; SEED's pipelined sub-slices halve the chunk
    width, so for exact-geometry winners there tune with num_envs set to
    the chunk width you train."""
    from surreal_tpu_torch.launch.hooks import training_env_config
    from surreal_tpu_torch.learners import build_learner
    from surreal_tpu_torch.learners.aggregator import to_device

    device = resolve_device(device)
    probe = make_env(training_env_config(cfg.env_config), device)
    specs = probe.specs
    if hasattr(probe, "close"):
        probe.close()
    learner = build_learner(cfg.learner_config, specs, device)
    T = int(learner.config.algo.horizon)
    B = int(cfg.env_config.num_envs)
    batch = to_device(_synthetic_learn_batch(specs, T, B), device)
    generator = torch.Generator(device=device).manual_seed(0)
    loop = [learner.init(torch.Generator().manual_seed(0))]

    def step():
        loop[0], _ = learner.learn(loop[0], batch, generator)

    return _timed(step, device, warmup, throwaway, iters)


def measure_point(
    config,
    point: dict,
    warmup: int = WARMUP,
    throwaway: int = THROWAWAY,
    iters: int = ITERS,
    surface: str = "fused",
    device="cuda",
) -> float:
    """ms/iter of the workload's measured program with ``point`` pinned:
    the device iteration (``surface='fused'``), or the learn-only program
    (``surface='learn'``, the host-env surface). The trial's trainer and
    the card's cached blocks are released before it returns, so the next
    trial neither times the allocator nor runs out of memory."""
    cfg = _candidate_config(config, point)
    try:
        if surface == "learn":
            return _measure_learn(cfg, warmup, throwaway, iters, device)
        if cfg.learner_config.algo.name == "ddpg":
            return _measure_offpolicy(cfg, warmup, throwaway, iters, device)
        return _measure_onpolicy(cfg, warmup, throwaway, iters, device)
    finally:
        gc.collect()
        if torch.device(device).type == "cuda":
            torch.cuda.empty_cache()


def tune_workload(
    config,
    *,
    dims: list[tuple[str, list]] | None = None,
    warmup: int = WARMUP,
    throwaway: int = THROWAWAY,
    iters: int = ITERS,
    min_gain: float = MIN_GAIN,
    force: bool = False,
    verbose: bool = False,
    device="cuda",
) -> dict:
    """Search this workload's candidate space on ``device`` (default: the
    card) and persist the winner.

    Returns the cache entry plus ``cache_hit`` (True means a stored entry
    was returned with ZERO measurements: the pure-hit contract a second
    ``tune`` run relies on) and ``measured`` (trial count). ``dims``
    overrides the declared space (tests / bounded CLI runs).
    """
    from surreal_tpu_torch.launch.hooks import training_env_config
    from surreal_tpu_torch.learners import build_learner
    from surreal_tpu_torch.session.costs import device_kind
    from surreal_tpu_torch.session.watchdog import platform_of

    device = resolve_device(device)
    env_name = str(config.env_config.name)
    # host envs have no device iteration to time: their search surface is
    # the learn program alone, over the learn-phase subset of the space
    surface = "fused" if env_name.startswith("jax:") else "learn"
    probe = make_env(training_env_config(config.env_config), device)
    learner = build_learner(config.learner_config, probe.specs, device)
    if hasattr(probe, "close"):
        probe.close()
    extended = learner.config
    del learner  # its parameters would stay on the card through every trial
    key, fp = workload_fingerprint(extended, config.env_config, device=device)
    cache_dir = resolve_tuning_cache_dir(config.session_config)
    cache = TuningCache(cache_dir)
    if not force:
        entry = cache.lookup(key)
        if entry is not None:
            return dict(entry, cache_hit=True, measured=0)

    space = dims if dims is not None else search_space_for(config, extended)
    if not space:
        raise ValueError(
            f"no searchable dimensions for algo "
            f"{extended.algo.name!r} on {env_name!r} (host-env workloads "
            "search the learn-phase subset only — "
            f"{', '.join(LEARN_PHASE_DIMS)}); nothing to tune"
        )
    point = {name: extended.algo.get(name) for name, _ in space}

    def note(msg):
        if verbose:
            print(f"tune: {msg}", file=sys.stderr, flush=True)

    note(f"fingerprint {key} ({env_name}, algo={extended.algo.name}, "
         f"surface={surface}); searching {[n for n, _ in space]}")
    trials = []

    def run_trial(p):
        ms = measure_point(config, p, warmup, throwaway, iters, surface=surface, device=device)
        trials.append({"config": dict(p), "iter_ms": ms})
        note(f"{p} -> {ms:.2f} ms/iter")
        return ms

    default_snapshot = dict(point)
    default_ms = run_trial(point)
    incumbent_ms = default_ms
    for name, values in space:
        if skip_dimension(name, point, extended):
            note(f"skip {name} (moot under {point})")
            continue
        best_val, best_ms = None, None
        for val in values:
            if val == point.get(name):
                continue  # the incumbent's value is already measured
            ms = run_trial({**point, name: val})
            if best_ms is None or ms < best_ms:
                best_val, best_ms = val, ms
        if best_ms is not None and best_ms < incumbent_ms * (1.0 - min_gain):
            note(f"adopt {name}={best_val} "
                 f"({incumbent_ms:.2f} -> {best_ms:.2f} ms)")
            point[name] = best_val
            incumbent_ms = best_ms

    entry = {
        "key": key,
        "fingerprint": fp,
        "config": dict(point),        # the full chosen point (pins every
                                      # searched dim, defaults included)
        "default": default_snapshot,
        "default_ms": default_ms,
        "chosen_ms": incumbent_ms,
        "speedup": default_ms / max(incumbent_ms, 1e-9),
        "trials": trials,
        "platform": platform_of(device),
        "device_kind": device_kind(device),
        "torch": torch.__version__,
        "measure": {
            "surface": surface,  # 'fused' device iteration | 'learn'
                                 # (host-env learn-only program)
            "warmup": warmup,
            "throwaway": throwaway,
            "iters": iters,
            "min_gain": min_gain,
            "timing": TIMING,
        },
        "created_t": time.time(),
    }
    cache.store(key, entry)
    return dict(entry, cache_hit=False, measured=len(trials))
