"""Chaos campaigns, the port of ``surreal_tpu/chaos/campaign.py``: N
seeded short REAL training runs under generated multi-site fault
schedules, every run judged by the invariant oracles, and any failing
schedule greedily shrunk (drop one spec at a time, re-run
deterministically) to a minimal plan that still fails before it is
reported. The runs go through the port's trainers on the session's
backend: ``backend='tpu'`` (the default) is the CUDA card, ``'cpu'`` the
CPU.

Reproducing a failure is two values: ``(profile, seed)`` regenerates the
exact schedule (``schedule.generate_schedule``), and the injector fires
by call count, so the replay is the run. The shrinker's replays reuse the
same runner with the reduced plan — determinism is the debugging tool,
not a test nicety.

Runner and oracle sets are injectable: the shrinker tests drive
``shrink``/``run_campaign`` with a stub runner and a deliberately-broken
oracle, proving convergence to the known-minimal schedule without paying
for real runs.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time

from surreal_tpu_torch.chaos import schedule as chaos_schedule
from surreal_tpu_torch.chaos.invariants import ORACLES, RunRecord, evaluate
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.utils import faults

# teardown residue the campaign looks for (chaos/invariants.py residue
# oracle): repo-named worker threads, the port's data-plane shm slabs (the
# JAX package's own are surreal_dp_*, and not this package's residue),
# session fds
_THREAD_PREFIXES = ("xp-shard-", "xp-sample", "ops-aggregator")
_SHM_GLOB = "/dev/shm/surreal_pt_*"
_RESIDUE_GRACE_S = 5.0


def _build_config(profile: str, folder: str, plan: list[dict],
                  seed: int, env: str | None = None, backend: str = "tpu") -> Config:
    """One profile's short-run config with the fault plan installed, on
    ``backend`` ('tpu': the card; 'cpu'). Thread-mode workers/shards ONLY:
    the campaign's injector, telemetry, and call counts must live in this
    process (a process worker's firings are invisible to the parent's
    registry)."""
    from surreal_tpu_torch.session.default_configs import base_config

    meta = chaos_schedule.PROFILES[profile]
    common = dict(
        folder=folder,
        backend=backend,
        metrics=Config(every_n_iters=1, tensorboard=False, console=False),
        eval=Config(every_n_iters=0),
        faults=Config(plan=[dict(e) for e in plan]),
        seed=int(seed),
    )
    if profile == "seed_gateway":
        cfg = Config(
            learner_config=Config(algo=Config(name="impala", horizon=8)),
            env_config=Config(name=env or meta["env"], num_envs=4),
            session_config=Config(
                total_env_steps=600,
                checkpoint=Config(every_n_iters=2),
                publish=Config(enabled=True, every_n_iters=1,
                               fanout=Config(enabled=True)),
                topology=Config(
                    num_env_workers=2,
                    # short silence budget: a wedged worker (dropped step
                    # frame) must die and respawn within the campaign's
                    # short runs, exercising the real recovery path
                    worker_silence_s=6.0,
                    inference_fleet=Config(replicas=2),
                    gateway=Config(enabled=True, lease_s=10.0),
                ),
                **common,
            ),
        )
    elif profile == "seed_experience":
        cfg = Config(
            learner_config=Config(algo=Config(name="impala", horizon=8)),
            env_config=Config(name=env or meta["env"], num_envs=4),
            session_config=Config(
                total_env_steps=600,
                checkpoint=Config(every_n_iters=0),
                topology=Config(
                    num_env_workers=1,
                    worker_silence_s=6.0,  # see seed_gateway
                    experience_plane=Config(enabled=True, num_shards=2,
                                            shard_mode="thread"),
                ),
                **common,
            ),
        )
    elif profile == "ddpg_spill":
        cfg = Config(
            learner_config=Config(
                algo=Config(name="ddpg", horizon=8, updates_per_iter=2,
                            exploration=Config(warmup_steps=0)),
                replay=Config(
                    kind="remote", remote_kind="uniform", capacity=512,
                    start_sample_size=16, batch_size=32,
                    tiers=Config(spill=Config(enabled=True)),
                ),
            ),
            env_config=Config(name=env or meta["env"], num_envs=4),
            session_config=Config(
                # 8 iterations: the engine.stage 'at' window tops out at 5,
                # so a kill always leaves healthy boundaries behind it to
                # carry the bumped counter into a metrics row
                total_env_steps=8 * 4 * 8,
                checkpoint=Config(every_n_iters=0),
                topology=Config(
                    overlap_rollouts=False,
                    experience_plane=Config(num_shards=2,
                                            shard_mode="thread"),
                ),
                **common,
            ),
        )
    else:
        raise ValueError(f"unknown chaos profile {profile!r}")
    return cfg.extend(base_config())


def _residue_before(folder: str) -> dict:
    return {
        "threads": {
            t.name for t in threading.enumerate()
            if t.name.startswith(_THREAD_PREFIXES)
        },
        "shm": set(glob.glob(_SHM_GLOB)),
    }


def _folder_fds(folder: str) -> list[str]:
    root = os.path.realpath(folder)
    out = []
    try:
        for fd in os.listdir("/proc/self/fd"):
            try:
                target = os.readlink(f"/proc/self/fd/{fd}")
            except OSError:
                continue
            if target.startswith(root):
                out.append(target)
    except OSError:
        pass  # no /proc (non-linux): fd residue not observable
    return out


def _residue_after(folder: str, before: dict) -> dict:
    """Post-teardown residue, with a bounded grace window for daemon
    threads to finish dying (joins in the close paths are bounded, not
    synchronous)."""
    deadline = time.monotonic() + _RESIDUE_GRACE_S
    while True:
        threads = [
            t.name for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(_THREAD_PREFIXES)
            and t.name not in before["threads"]
        ]
        shm = [
            p for p in glob.glob(_SHM_GLOB) if p not in before["shm"]
        ]
        fds = _folder_fds(folder)
        if not (threads or shm or fds) or time.monotonic() > deadline:
            return {"threads": threads, "shm": shm, "fds": fds}
        time.sleep(0.2)


def _read_events(folder: str) -> list[dict]:
    from surreal_tpu_torch.session.telemetry import _iter_jsonl

    path = os.path.join(folder, "telemetry", "events.jsonl")
    return list(_iter_jsonl(path))


def run_once(sched: dict, folder: str, env: str | None = None,
             backend: str = "tpu") -> RunRecord:
    """Execute one schedule as a real training run on ``backend`` and
    collect the oracle record. The injector is configured by the trainer
    itself (``faults.configure_from``) off the config's plan: exactly the
    production wiring, nothing campaign-special."""
    from surreal_tpu_torch.main.launch import backend_device

    profile = sched["profile"]
    cfg = _build_config(profile, folder, sched["plan"], sched["seed"],
                        env=env, backend=backend)
    device = backend_device(backend)
    before = _residue_before(folder)
    state, metrics, error = None, {}, None
    try:
        if chaos_schedule.PROFILES[profile]["algo"] == "ddpg":
            from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer

            state, metrics = OffPolicyTrainer(cfg, device=device).run()
        else:
            from surreal_tpu_torch.launch.seed_trainer import SEEDTrainer

            state, metrics = SEEDTrainer(cfg, device=device).run()
    except Exception as e:  # a crashed run IS an oracle violation
        error = f"{type(e).__name__}: {e}"
    counts = faults.get().counts()
    residue = _residue_after(folder, before)
    return RunRecord(
        folder=folder,
        plan=[dict(e) for e in sched["plan"]],
        profile=profile,
        seed=int(sched["seed"]),
        metrics=dict(metrics or {}),
        events=_read_events(folder),
        counts=counts,
        residue=residue,
        state=state,
        error=error,
    )


def shrink(plan: list[dict], still_fails, max_runs: int = 32):
    """Greedy one-at-a-time reduction (ddmin-lite): repeatedly drop the
    first spec whose removal keeps the failure, to a fixpoint. Returns
    ``(minimal_plan, runs_spent)``. ``still_fails(plan) -> bool`` re-runs
    deterministically; the result is 1-minimal — removing ANY single
    remaining spec makes the failure vanish (or the budget ran out)."""
    cur = [dict(e) for e in plan]
    runs = 0
    changed = True
    while changed and runs < max_runs:
        changed = False
        for i in range(len(cur)):
            if runs >= max_runs:
                break
            cand = cur[:i] + cur[i + 1:]
            runs += 1
            if still_fails(cand):
                cur = cand
                changed = True
                break
    return cur, runs


def run_campaign(
    seeds: int,
    base_dir: str,
    profiles: list[str] | None = None,
    env: str | None = None,
    oracles=None,
    runner=None,
    shrink_failing: bool = True,
    max_shrink_runs: int = 12,
    log=print,
    backend: str = "tpu",
) -> dict:
    """Run ``seeds`` schedules (seed i -> profile i % len(profiles)),
    evaluate every oracle per run, shrink failures, and return the
    campaign artifact dict. ``runner(sched, folder) -> RunRecord``
    defaults to :func:`run_once` (real runs on ``backend``)."""
    profiles = list(profiles or chaos_schedule.PROFILES)
    oracles = ORACLES if oracles is None else oracles
    if runner is None:
        runner = lambda sched, folder: run_once(sched, folder, env=env, backend=backend)  # noqa: E731
    t0 = time.monotonic()
    schedules = []
    failures = []
    sites_covered: set[str] = set()
    faults_injected = 0
    violations_total = 0
    shrink_iters = 0
    for seed in range(int(seeds)):
        profile = profiles[seed % len(profiles)]
        sched = chaos_schedule.generate_schedule(seed, profile)
        folder = os.path.join(base_dir, f"run-{profile}-{seed:03d}")
        os.makedirs(folder, exist_ok=True)
        rec = runner(sched, folder)
        verdict = evaluate(rec, oracles)
        delivered = rec.delivered()
        faults_injected += sum(
            min(rec.counts.get(e["site"], 0) - e["at"], e.get("times", 1))
            for e in delivered
        )
        fired = sorted({e["site"] for e in delivered})
        sites_covered.update(fired)
        n_viol = len(verdict["violations"])
        violations_total += n_viol
        schedules.append({
            "seed": sched["seed"],
            "profile": profile,
            "intensity": sched["intensity"],
            "plan": sched["plan"],
            "fired_sites": fired,
            "violations": n_viol,
            "oracles": verdict["oracles"],
        })
        log(f"chaos seed={seed} profile={profile} "
            f"faults={len(sched['plan'])} fired_sites={len(fired)} "
            f"violations={n_viol}")
        if n_viol and shrink_failing:
            def still_fails(plan, _profile=profile, _seed=seed):
                sub = os.path.join(
                    base_dir, f"shrink-{_profile}-{_seed:03d}-"
                    f"{len(plan)}-{int(time.monotonic() * 1e3) % 100000}"
                )
                os.makedirs(sub, exist_ok=True)
                r = runner(dict(sched, plan=plan), sub)
                return bool(evaluate(r, oracles)["violations"])

            minimal, spent = shrink(
                sched["plan"], still_fails, max_runs=max_shrink_runs
            )
            shrink_iters += spent
            failures.append({
                "seed": sched["seed"],
                "profile": profile,
                "violations": verdict["violations"],
                "minimal_plan": minimal,
                "shrink_runs": spent,
                "replay": {"profile": profile, "seed": sched["seed"]},
            })
            log(f"chaos seed={seed} SHRUNK {len(sched['plan'])} -> "
                f"{len(minimal)} specs in {spent} runs")
    wall_s = time.monotonic() - t0
    artifact = {
        "version": 1,
        "kind": "chaos_campaign",
        "profiles": profiles,
        "seeds": int(seeds),
        "schedules": schedules,
        "failures": failures,
        "sites_covered": sorted(sites_covered),
        "gauges": {
            "chaos/schedules": float(len(schedules)),
            "chaos/violations": float(violations_total),
            "chaos/faults_injected": float(faults_injected),
            "chaos/sites_covered": float(len(sites_covered)),
            "chaos/shrink_iters": float(shrink_iters),
            "chaos/run_ms": float(wall_s * 1e3),
        },
    }
    _write_campaign_events(base_dir, artifact)
    return artifact


def _write_campaign_events(base_dir: str, artifact: dict) -> None:
    """Mirror the campaign outcome onto the telemetry spine (one
    ``chaos_campaign`` event + one ``chaos_violation`` per failure) so
    ``diag``-style JSONL readers see campaigns like any other run."""
    tdir = os.path.join(base_dir, "telemetry")
    try:
        os.makedirs(tdir, exist_ok=True)
        with open(os.path.join(tdir, "events.jsonl"), "a") as f:
            f.write(json.dumps({
                "type": "chaos_campaign", "t": time.time(),
                "profiles": artifact["profiles"],
                "seeds": artifact["seeds"],
                "sites_covered": artifact["sites_covered"],
                **artifact["gauges"],
            }) + "\n")
            for fail in artifact["failures"]:
                f.write(json.dumps({
                    "type": "chaos_violation", "t": time.time(), **fail,
                }) + "\n")
    except OSError:
        pass  # campaign dir lost: the returned artifact still reports


def write_artifact(path: str, artifact: dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(artifact, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
