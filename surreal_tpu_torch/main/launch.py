"""Experiment launcher, the port of ``surreal_tpu/main/launch.py``
(``build_config``, ``select_trainer``, ``run_train``, ``run_eval``,
``run_actor``, ``run_tune``, ``run_chaos``, the offline readers,
``main``):

    python -m surreal_tpu_torch train ppo jax:lift --folder /tmp/exp1
    python -m surreal_tpu_torch train ddpg jax:lift --folder /tmp/exp2 \\
        --num-envs 256 --set learner_config.algo.n_step=3
    python -m surreal_tpu_torch train ppo dm_control:cheetah-run --folder /tmp/exp3 --num-envs 32
    python -m surreal_tpu_torch train impala gym:CartPole-v1 --folder /tmp/exp4 --workers 2

It builds the reference's three config trees from the same flags, writes
``<folder>/config.json`` (atomically), picks the driver (``OffPolicyTrainer``
for ddpg, ``SEEDTrainer`` for a host env with ``--workers N`` env
workers, else ``Trainer``), runs it with the session services of
``launch/hooks.py`` and prints the final metrics as one sorted JSON line.

``session_config.backend`` keeps the reference's values: 'tpu' (the
default, "the accelerator") runs on the CUDA card and raises without
one; 'cpu' runs on the CPU (``--set session_config.backend=cpu``).

Scoring a session, and acting against a live one:

    python -m surreal_tpu_torch eval /tmp/exp1 --best --episodes 10   # a checkpoint (or --folder F)
    python -m surreal_tpu_torch eval /tmp/exp1 --follow --rounds 2    # the live session's published params
    python -m surreal_tpu_torch actor --folder /tmp/exp1 --episodes 4 --min-version 2

``actor`` and ``eval --follow`` need a session trained with
``session_config.publish.enabled=true``: they find its parameter server
in ``<folder>/param_server.json`` (or ``--connect tcp://host:port``),
wait up to ``--wait`` seconds for it and for a first publish (rc 2 with a
message if none comes), and act on the session's backend (the card for
'tpu', the CPU for 'cpu'), from parameters fetched over the wire. The
actor prints a JSON line per finished episode and a summary whose
``actor/versions_seen`` counts the versions it acted with; eval prints
one JSON line per round (``--follow``) or one for the checkpoint, and
records eval episodes to video when the session's ``env_config.video``
asks for it.

The offline subcommands, with the reference's arguments, messages and
exit codes (pure file work, so they run on any machine, also beside a
live session on the card):

    python -m surreal_tpu_torch profile /tmp/exp1 --iters 2   # ask a live session for a capture
    python -m surreal_tpu_torch diag /tmp/exp1                # phases, health, perf, captures
    python -m surreal_tpu_torch trace /tmp/exp4               # SEED causal span trees
    python -m surreal_tpu_torch top /tmp/exp4 [--once]        # live ops snapshot, SLOs, incidents
    python -m surreal_tpu_torch why /tmp/exp4 [--incident N]  # incidents, causes, actions

The program autotuner and chaos campaigns, on the session's backend
(``tune``) or the card (``chaos``):

    python -m surreal_tpu_torch tune ppo jax:lift --folder /tmp/tuned --num-envs 4096 \\
        --set learner_config.algo.horizon=256 --iters 4   # search, cache the winner
    python -m surreal_tpu_torch train ppo jax:lift --folder /tmp/tuned --num-envs 4096 \\
        --set learner_config.algo.horizon=256 learner_config.algo.autotune=cache
    python -m surreal_tpu_torch chaos all --seeds 3 --out /tmp/campaign.json

Refused with exit code 2: ``--workers`` with ddpg or a ``jax:`` env (the
reference's rule and message), and, not ported yet, ``--local-procs``
(process groups, with the multi-host SEED trainer).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config

PROG = "surreal_tpu_torch"
ALGOS = ("ppo", "ddpg", "impala")
BACKENDS = {"tpu": "cuda", "cpu": "cpu"}


def build_config(args) -> Config:
    """CLI args -> the fully extended three-tree config bundle."""
    overrides = Config(
        learner_config=Config(algo=Config(name=args.algo)),
        env_config=Config(name=args.env, num_envs=args.num_envs),
        session_config=Config(folder=args.folder),
    )
    if args.total_steps is not None:
        overrides.session_config.total_env_steps = args.total_steps
    if args.restore_from is not None:
        overrides.session_config.checkpoint = Config(restore_from=args.restore_from)
    if getattr(args, "workers", None) is not None:
        overrides.session_config.topology = Config(num_env_workers=args.workers)
    if args.set:
        overrides.override_from_dotlist(args.set)
    return overrides.extend(base_config())


def backend_device(backend: str) -> str:
    """``session_config.backend`` -> the torch device: 'tpu' (the
    accelerator) is the CUDA card, 'cpu' the CPU."""
    if backend not in BACKENDS:
        raise ValueError(f"session_config.backend {backend!r} not in tpu|cpu")
    if BACKENDS[backend] == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "session_config.backend='tpu' (the default) selects the CUDA card, and "
            "torch.cuda.is_available() is False; pass --set session_config.backend=cpu to run on the CPU"
        )
    return BACKENDS[backend]


def _validate_seed_topology(config) -> int:
    """The SEED inference-server topology needs a HOST env and an
    on-policy algo (the reference's rule, kept so a config the reference
    refuses is refused here with the same message). Returns
    num_env_workers."""
    algo = config.learner_config.algo.name
    env_name = config.env_config.name
    workers = config.session_config.topology.num_env_workers
    if workers > 0 and (algo == "ddpg" or env_name.startswith("jax:")):
        raise ValueError(
            f"topology.num_env_workers={workers} selects the SEED "
            "inference-server topology, which needs a HOST env (gym:/"
            "dm_control:/robosuite:) and an on-policy algo (ppo, impala); "
            f"got algo={algo!r}, env={env_name!r} — drop --workers, or "
            "use a host env / on-policy algo"
        )
    return workers


def select_trainer(config, device: str = "cuda"):
    """Map config -> trainer: ddpg -> ``OffPolicyTrainer``; a host env with
    env workers -> ``SEEDTrainer`` (the batched inference server and its
    worker threads or processes); else ``Trainer`` (the fused device loop,
    or the host loops for a host env)."""
    workers = _validate_seed_topology(config)
    if config.learner_config.algo.name == "ddpg":
        from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer

        return OffPolicyTrainer(config, device=device)
    if workers > 0:
        from surreal_tpu_torch.launch.seed_trainer import SEEDTrainer

        return SEEDTrainer(config, device=device)
    from surreal_tpu_torch.launch.trainer import Trainer

    return Trainer(config, device=device)


def run_train(args) -> int:
    if getattr(args, "local_procs", None):
        print("surreal_tpu_torch: --local-procs (process groups) is not ported to PyTorch yet", file=sys.stderr)
        return 2
    config = build_config(args)
    try:
        _validate_seed_topology(config)
    except ValueError as e:
        print(f"surreal_tpu_torch: {e}", file=sys.stderr)
        return 2
    device = backend_device(config.session_config.backend)
    folder = config.session_config.folder
    os.makedirs(folder, exist_ok=True)
    # the resolved config, so later runs and readers can rebuild the
    # session; tmp + rename, as readers may poll for it
    cfg_path = os.path.join(folder, "config.json")
    with open(cfg_path + ".tmp", "w") as f:
        f.write(config.dumps())
    os.replace(cfg_path + ".tmp", cfg_path)
    trainer = select_trainer(config, device)
    _, metrics = trainer.run()
    print(json.dumps({k: v for k, v in sorted(metrics.items())}, default=float))
    return 0


def _load_session_config(folder: str, wait_s: float = 0.0):
    """The session's ``config.json``, or None; with ``wait_s``, polled for
    that long (an actor may start before the trainer wrote it). A file
    that does not parse counts as not there yet."""
    import time

    cfg_path = os.path.join(folder, "config.json")
    deadline = time.monotonic() + wait_s
    while True:
        if os.path.exists(cfg_path):
            try:
                with open(cfg_path) as f:
                    return Config(json.load(f))
            except (json.JSONDecodeError, OSError):
                pass
        if time.monotonic() >= deadline:
            return None
        time.sleep(0.2)


def _discover_param_server(folder: str, connect: str | None, wait_s: float) -> str:
    """The live session's parameter-server address: ``--connect`` when
    given, else ``<folder>/param_server.json`` (written by ``SessionHooks``
    under ``session_config.publish.enabled``), polled for ``wait_s``."""
    import time

    if connect:
        return connect
    path = os.path.join(folder, "param_server.json")
    deadline = time.monotonic() + wait_s
    while True:
        if os.path.exists(path):
            try:
                with open(path) as f:
                    return json.load(f)["addresses"][0]
            except (json.JSONDecodeError, OSError, KeyError, IndexError):
                pass  # racing the atomic replace; retry
        if time.monotonic() >= deadline:
            raise TimeoutError(
                f"no {path} after {wait_s:.0f}s: is a training session with "
                "session_config.publish.enabled=true running? (or pass --connect tcp://host:port)"
            )
        time.sleep(0.2)


_ACTOR_MODES = {
    "training": "training",
    "deterministic": "eval_deterministic",
    "stochastic": "eval_stochastic",
}


def _wait_for_publish(agent, folder, connect, address, wait_s, *, min_version=1, fetch_every=1) -> bool:
    """Wait until a view of version >= ``min_version`` has been fetched
    into ``agent``: True, or False after ``wait_s``. Polls with
    version-only probes and, unless the address was pinned with
    ``--connect``, re-reads the discovery file between them, reconnecting
    when a new session has rewritten it (a dead session's stale file must
    not eat the wait)."""
    import time

    deadline = time.monotonic() + wait_s
    while True:
        try:
            if agent.peek_published_version(timeout_ms=2000) >= min_version and agent.fetch_params():
                return True
        except TimeoutError:
            pass
        if time.monotonic() >= deadline:
            return False
        time.sleep(0.3)
        if not connect:
            try:
                new_addr = _discover_param_server(folder, None, 0.0)
            except TimeoutError:
                continue
            if new_addr != address:
                address = new_addr
                state = agent.state
                agent.close()
                agent.connect(address, state, fetch_every=fetch_every)


def _connect_live(args, learner, mode: str, seed: int, min_version: int = 1, fetch_every: int = 1):
    """(an agent of ``learner`` on the live session's server with a view
    of version >= ``min_version`` fetched, None), or (None, the message of
    an exit with code 2)."""
    from surreal_tpu_torch.agents import make_agent

    try:
        address = _discover_param_server(args.folder, args.connect, args.wait)
    except TimeoutError as e:
        return None, str(e)
    agent = make_agent(learner, _ACTOR_MODES[mode])
    agent.connect(address, learner.init(torch.Generator().manual_seed(seed)), fetch_every=fetch_every)
    if not _wait_for_publish(agent, args.folder, args.connect, address, args.wait,
                             min_version=min_version, fetch_every=fetch_every):
        agent.close()
        return None, f"nothing published (>= version {min_version}) on {address} after {args.wait:.0f}s"
    return agent, None


def run_actor(args) -> int:
    """A standalone actor against a LIVE training session: acts with
    parameters fetched from its server every ``--fetch-every`` acts.
    Prints one JSON line per finished episode (episode, return, length,
    param_version) and a summary; ``actor/versions_seen`` > 1 shows it
    tracked a live learner, not a snapshot."""
    import numpy as np

    from surreal_tpu_torch.envs import is_jax_env, make_env
    from surreal_tpu_torch.learners import build_learner

    config = _load_session_config(args.folder, wait_s=args.wait)
    if config is None:
        print(f"no config.json under {args.folder!r} (launch training first)", file=sys.stderr)
        return 2
    device = backend_device(config.session_config.get("backend", "tpu"))
    env_cfg = config.env_config
    if args.num_envs is not None:
        env_cfg = Config(num_envs=args.num_envs).extend(env_cfg)
    if args.video_dir:
        if env_cfg.name.startswith("jax:"):
            raise ValueError(
                "--video-dir records through the host VideoWrapper; device (jax:*) env episodes are "
                "recorded by eval's state renderer (env_config.video on the training session) instead"
            )
        env_cfg = Config(video=Config(enabled=True, dir=args.video_dir, every_n_episodes=1)).extend(env_cfg)
    env = make_env(env_cfg, device)
    learner = build_learner(config.learner_config, env.specs, device)
    agent, why = _connect_live(args, learner, args.mode, args.seed,
                               min_version=max(1, args.min_version), fetch_every=args.fetch_every)
    if agent is None:
        print(why, file=sys.stderr)
        if not is_jax_env(env):
            env.close()
        return 2

    B = env_cfg.num_envs
    generator = torch.Generator(device=device).manual_seed(args.seed + 1)
    ep_ret = np.zeros(B, np.float64)
    ep_len = np.zeros(B, np.int64)
    episodes_done = 0
    versions_seen: set[int] = set()

    def on_step(reward: np.ndarray, done: np.ndarray) -> None:
        nonlocal episodes_done
        ep_ret[:] += reward
        ep_len[:] += 1
        versions_seen.add(agent.param_version)
        for i in np.nonzero(done)[0]:
            episodes_done += 1
            print(json.dumps({"episode": episodes_done, "return": float(ep_ret[i]), "length": int(ep_len[i]),
                              "param_version": agent.param_version}), flush=True)
            ep_ret[i] = 0.0
            ep_len[i] = 0
        if hasattr(agent, "mask_noise_on_reset"):
            agent.mask_noise_on_reset(done)  # DDPG's OU state must not leak across resets

    act_steps = 0  # across the batch: each pass acts B envs
    cap = args.max_steps if args.max_steps is not None else 10**9
    final_version = agent.param_version
    try:
        if is_jax_env(env):
            env_state, obs = env.reset(B, generator=generator)
            while episodes_done < args.episodes and act_steps < cap:
                action, _ = agent.remote_act(obs, generator)
                env_state, obs, reward, done, _ = env.step(env_state, action, generator)
                on_step(reward.cpu().numpy(), done.cpu().numpy())
                act_steps += B
        else:
            obs = env.reset(seed=env_cfg.seed)
            while episodes_done < args.episodes and act_steps < cap:
                action, _ = agent.remote_act(obs, generator)
                out = env.step(action.cpu().numpy())
                on_step(out.reward, out.done)
                obs = out.obs
                act_steps += B
    finally:
        final_version = max(final_version, agent.param_version)
        agent.close()
        if not is_jax_env(env):
            env.close()
    print(json.dumps({
        "actor/episodes": episodes_done,
        "actor/steps": act_steps,
        "actor/param_version": final_version,
        "actor/versions_seen": len(versions_seen),
    }), flush=True)
    return 0


def run_eval(args) -> int:
    """Score a session folder from its newest (or ``--best``) checkpoint,
    or, with ``--follow``, the LIVE session's published parameters, fetched
    afresh each of ``--rounds`` rounds."""
    from surreal_tpu_torch.envs import is_jax_env, make_env
    from surreal_tpu_torch.launch.evaluator import Evaluator
    from surreal_tpu_torch.learners import build_learner
    from surreal_tpu_torch.session.checkpoint import CheckpointManager

    folder = args.folder_pos or args.folder
    if folder is None or (args.folder_pos and args.folder and args.folder_pos != args.folder):
        print(f"{PROG} eval: give the session folder once, as FOLDER or --folder", file=sys.stderr)
        return 2
    args.folder = folder
    config = _load_session_config(folder, wait_s=args.wait if args.follow else 0.0)
    if config is None:
        print(f"no config.json under {folder!r} (was it trained via the CLI?)", file=sys.stderr)
        return 2
    # eval runs on the backend the session trained on
    device = backend_device(config.session_config.get("backend", "tpu"))
    probe = make_env(config.env_config, device)
    learner = build_learner(config.learner_config, probe.specs, device)
    if not is_jax_env(probe):
        probe.close()
    eval_cfg = Config(episodes=args.episodes, mode=args.mode, max_steps=args.max_steps)

    if args.follow:
        agent, why = _connect_live(args, learner, args.mode, 0)
        if agent is None:
            print(why, file=sys.stderr)
            return 2
        ev = Evaluator(config.env_config, eval_cfg, learner)
        try:
            for rnd in range(args.rounds):
                if rnd:
                    agent.fetch_params()  # the freshest published view each round
                out = ev.evaluate(agent.state, args.seed + rnd)
                out["param_version"] = agent.param_version
                print(json.dumps({k: v for k, v in sorted(out.items())}, default=float), flush=True)
        finally:
            ev.close()
            agent.close()
        return 0

    mgr = CheckpointManager(config.session_config.folder)
    template = learner.init()
    restored = mgr.restore_best(template) if args.best else mgr.restore(template)
    if restored is None:
        print(f"no {'best ' if args.best else ''}checkpoint under {folder!r}", file=sys.stderr)
        return 2
    state, meta = restored
    ev = Evaluator(config.env_config, eval_cfg, learner)
    try:
        out = ev.evaluate(state, args.seed)
    finally:
        ev.close()
    out["checkpoint/iteration"] = meta["iteration"]
    out["checkpoint/env_steps"] = meta["env_steps"]
    print(json.dumps({k: v for k, v in sorted(out.items())}, default=float))
    return 0


def run_profile(args) -> int:
    """Request an on-demand profiler capture from a live training session:
    drops ``<folder>/profile.trigger``, which the session's
    ``ProfileManager`` (``session/profile.py``) polls at iteration
    boundaries; the Chrome trace lands under
    ``<folder>/telemetry/profiles/`` and is announced as a ``profile``
    telemetry event (``diag`` lists it). Pure file writing."""
    if not os.path.isdir(args.folder):
        print(f"no session folder {args.folder!r}", file=sys.stderr)
        return 2
    from surreal_tpu_torch.session.profile import write_trigger

    path = write_trigger(args.folder, num_iters=args.iters)
    print(
        f"profile trigger written: {path}\n"
        "a live session (session_config.profile.trigger_file=true, the "
        "default) will capture at its next iteration boundary; check "
        f"`{PROG} diag {args.folder}` for the capture."
    )
    return 0


def run_diag(args) -> int:
    """Offline session diagnosis from the telemetry JSONL logs
    (``session/telemetry.py``): phase-time breakdown, training-health
    summary, performance, heartbeats. Pure file reading, so it runs off
    the card and against live sessions."""
    from surreal_tpu_torch.session.telemetry import diag_report, diag_summary

    if args.json:
        summary = diag_summary(args.folder)
        if summary is None:
            print(f"no telemetry under {args.folder!r} "
                  "(session_config.telemetry.enabled=false, or not a "
                  "session folder?)", file=sys.stderr)
            return 2
        print(json.dumps(summary, default=float))
        return 0
    report = diag_report(args.folder)
    if report is None:
        print(f"no telemetry under {args.folder!r} "
              "(session_config.telemetry.enabled=false, or not a "
              "session folder?)", file=sys.stderr)
        return 2
    print(report)
    return 0


def run_top(args) -> int:
    """The live cross-tier ops view from the aggregator's snapshot file
    (``session/opsplane.py``): tier health, the per-tenant SLO table, hop
    latencies, MFU, incidents and actions. Only reads files, so it runs
    against a live session from any machine; refreshes every
    ``--interval`` seconds until interrupted, or prints once with
    ``--once`` (exit 2 when there is no snapshot)."""
    import time

    from surreal_tpu_torch.session.opsplane import load_snapshot, top_report

    if not os.path.isdir(args.folder):
        print(f"no session folder {args.folder!r}", file=sys.stderr)
        return 2
    if args.once:
        snap = load_snapshot(args.folder)
        print(top_report(snap, args.folder))
        return 0 if snap is not None else 2
    try:
        while True:
            report = top_report(load_snapshot(args.folder), args.folder)
            if sys.stdout.isatty():
                print("\x1b[2J\x1b[H", end="")  # clear and home, like top(1)
            print(report, flush=True)
            time.sleep(max(0.2, float(args.interval)))
    except KeyboardInterrupt:
        return 0


def run_why(args) -> int:
    """Root-caused incident reports (``session/incidents.py``): what fired,
    the ranked causes with their evidence, the captured artifacts, and the
    remediation actions with their verdicts (``session/remediate.py``).
    Only reads files under ``telemetry/incidents/`` and
    ``telemetry/actions/``."""
    from surreal_tpu_torch.session.incidents import incidents_report

    if not os.path.isdir(args.folder):
        print(f"no session folder {args.folder!r}", file=sys.stderr)
        return 2
    report = incidents_report(args.folder, incident=args.incident)
    if report is None:
        print(f"no telemetry under {args.folder!r} (is this a "
              "session folder?)", file=sys.stderr)
        return 2
    print(report)
    return 0


def run_trace(args) -> int:
    """Causal span-tree timelines for the head-sampled exemplars
    (``session/telemetry.py::trace_report``): one tree per exemplar, torn
    hops marked. Pure file reading over the telemetry event log."""
    from surreal_tpu_torch.session.telemetry import trace_report

    if not os.path.isdir(args.folder):
        print(f"no session folder {args.folder!r}", file=sys.stderr)
        return 2
    report = trace_report(args.folder, limit=args.limit)
    if report is None:
        print(f"no telemetry under {args.folder!r} (is this a "
              "session folder?)", file=sys.stderr)
        return 2
    print(report)
    return 0


def _parse_dims(spec: str) -> list:
    """``--dims`` spec -> [(name, [values])]; e.g.
    ``precision=f32,mixed;gae_impl=xla,assoc``. Values parse as JSON when
    possible (ints), else stay strings (impl names)."""
    dims = []
    for part in spec.split(";"):
        part = part.strip()
        if not part:
            continue
        name, sep, vals = part.partition("=")
        if not sep or not vals:
            raise ValueError(f"--dims entry {part!r} is not name=v1,v2,...")
        values = []
        for v in vals.split(","):
            v = v.strip()
            try:
                values.append(json.loads(v))
            except json.JSONDecodeError:
                values.append(v)
        dims.append((name.strip(), values))
    return dims


def _merge_tune_artifact(path: str, row: dict) -> None:
    """Append/replace ``row`` (keyed by fingerprint) in a shared
    ``tune`` artifact, atomically: repeated ``tune`` runs against
    different geometries accumulate into one record instead of
    clobbering each other. ``device`` and ``platform`` name the device
    the row was measured on, so a CPU run never passes for a card's."""
    data = {"metric": "autotune_fused_iter_ms", "workloads": []}
    try:
        with open(path) as f:
            old = json.load(f)
        if isinstance(old, dict) and isinstance(old.get("workloads"), list):
            data = old
    except (OSError, json.JSONDecodeError):
        pass
    data["workloads"] = [w for w in data["workloads"] if w.get("key") != row.get("key")] + [row]
    data["device"] = str(row.get("device_kind"))
    data["platform"] = str(row.get("platform"))
    with open(path + ".tmp", "w") as f:
        json.dump(data, f, indent=2, default=float)
    os.replace(path + ".tmp", path)


def run_tune(args) -> int:
    """Standalone autotuner run (``tune/``): search this workload's
    candidate space with fenced chained timing on the session's backend,
    persist the winner in the per-workload tuning cache, and record a
    ``tune`` telemetry event (+ optional shared artifact). A second run on
    the same fingerprint is a PURE cache hit (zero measurements) unless
    ``--force``; trainers with ``algo.autotune='cache'`` then build with
    the cached config without paying any search cost."""
    config = build_config(args)
    device = backend_device(config.session_config.backend)
    from surreal_tpu_torch.session.telemetry import Tracer
    from surreal_tpu_torch.tune import resolve_tuning_cache_dir
    from surreal_tpu_torch.tune.search import tune_workload

    result = tune_workload(
        config,
        dims=_parse_dims(args.dims) if args.dims else None,
        warmup=args.warmup,
        iters=args.iters,
        force=args.force,
        verbose=True,
        device=device,
    )

    fp = result.get("fingerprint", {})
    summary = {
        "workload": f"{args.algo} {args.env}",
        "geometry": (
            f"{fp.get('env', {}).get('num_envs', args.num_envs)} envs x "
            f"{fp.get('algo', {}).get('horizon', '?')} horizon"
        ),
        "key": result["key"],
        "cache_hit": result["cache_hit"],
        "measured": result["measured"],
        "config": result["config"],
        "default": result.get("default", {}),
        "default_ms": result.get("default_ms"),
        "chosen_ms": result.get("chosen_ms"),
        "speedup": result.get("speedup"),
        "platform": result.get("platform"),
        "device_kind": result.get("device_kind"),
        "trials": result.get("trials", []),
    }

    # the tune event lands in the session folder's telemetry, so `diag
    # <folder>` renders the candidate timings and hit/miss
    os.makedirs(config.session_config.folder, exist_ok=True)
    tracer = Tracer(config.session_config.folder, name="tune")
    tracer.event(
        "tune",
        mode="search",
        key=result["key"],
        hit=bool(result["cache_hit"]),
        source="cache" if result["cache_hit"] else "search",
        cache_dir=resolve_tuning_cache_dir(config.session_config),
        config=result["config"],
        default_ms=result.get("default_ms"),
        chosen_ms=result.get("chosen_ms"),
        trials=result.get("trials", []),
    )
    tracer.close()

    if args.out:
        _merge_tune_artifact(args.out, summary)
    print(json.dumps(summary, default=float))
    return 0


def run_chaos(args) -> int:
    """Randomized chaos campaign (``chaos/``): N seeded multi-site fault
    schedules executed as short REAL training runs on the card, every run
    judged by the invariant oracles, failing schedules shrunk to minimal
    form. Exit 0 only on zero failures."""
    import tempfile

    from surreal_tpu_torch.chaos import campaign as chaos_campaign
    from surreal_tpu_torch.chaos import schedule as chaos_schedule

    profiles = [
        p for p, meta in chaos_schedule.PROFILES.items()
        if args.algo in ("all", meta["algo"])
    ]
    if not profiles:
        print(f"no chaos profile for algo {args.algo!r} "
              f"(profiles: {sorted(chaos_schedule.PROFILES)})",
              file=sys.stderr)
        return 2
    base_dir = args.dir or tempfile.mkdtemp(prefix="surreal_chaos_")
    os.makedirs(base_dir, exist_ok=True)
    env = args.env if args.env not in (None, "default") else None
    artifact = chaos_campaign.run_campaign(
        seeds=args.seeds,
        base_dir=base_dir,
        profiles=profiles,
        env=env,
        max_shrink_runs=args.max_shrink_runs,
    )
    if args.out:
        chaos_campaign.write_artifact(args.out, artifact)
        print(f"wrote {args.out}")
    g = artifact["gauges"]
    print(f"chaos campaign: {int(g['chaos/schedules'])} schedules, "
          f"{int(g['chaos/sites_covered'])} sites fired, "
          f"{int(g['chaos/faults_injected'])} faults injected, "
          f"{int(g['chaos/violations'])} violations "
          f"({g['chaos/run_ms'] / 1e3:.1f}s)")
    for fail in artifact["failures"]:
        print(f"  FAIL seed={fail['seed']} profile={fail['profile']}: "
              f"minimal plan {json.dumps(fail['minimal_plan'])} "
              f"(replay: {PROG} chaos ... --seeds 1 with this "
              f"(profile, seed))")
    return 1 if artifact["failures"] else 0


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(prog=PROG)
    sub = parser.add_subparsers(dest="cmd", required=True)
    t = sub.add_parser("train", help="launch a training experiment")
    t.add_argument("algo", choices=ALGOS)
    t.add_argument("env", help="env name with backend prefix: jax:lift, jax:nut_pixels, gym:CartPole-v1, dm_control:cheetah-run, ...")
    t.add_argument("--folder", required=True, help="session/experiment directory")
    t.add_argument("--num-envs", type=int, default=64)
    t.add_argument("--total-steps", type=int, default=None)
    t.add_argument("--restore-from", default=None, help="foreign session folder to warm-start from")
    t.add_argument("--workers", type=int, default=None, help="env workers of the SEED topology (a host env, ppo or impala)")
    t.add_argument("--local-procs", type=int, default=None, help="not ported: local multi-process groups")
    t.add_argument("--set", nargs="*", metavar="KEY=VAL", default=[],
                   help="dotlist overrides, e.g. learner_config.algo.horizon=64")
    t.set_defaults(fn=run_train)

    e = sub.add_parser("eval", help="evaluate a trained session folder, or "
                       "--follow a live session's parameter server")
    e.add_argument("folder_pos", nargs="?", metavar="FOLDER", help="the session folder (or --folder)")
    e.add_argument("--folder", default=None)
    e.add_argument("--episodes", type=int, default=10)
    e.add_argument("--mode", choices=("deterministic", "stochastic"), default="deterministic")
    e.add_argument("--best", action="store_true", help="use the keep-best checkpoint instead of the latest")
    e.add_argument("--max-steps", type=int, default=None,
                   help="per-episode step cap (default: env time limit on device envs, 10000 on host envs)")
    e.add_argument("--seed", type=int, default=0)
    e.add_argument("--follow", action="store_true",
                   help="score the LIVE session's published params instead of a checkpoint (needs session_config.publish)")
    e.add_argument("--connect", default=None,
                   help="parameter-server address (default: discover via <folder>/param_server.json)")
    e.add_argument("--rounds", type=int, default=1, help="--follow only: eval rounds, re-fetching params each round")
    e.add_argument("--wait", type=float, default=60.0,
                   help="--follow only: seconds to wait for the live session's server / first publish")
    e.set_defaults(fn=run_eval)

    a = sub.add_parser("actor", help="standalone actor against a live training session's parameter server")
    a.add_argument("--folder", required=True, help="the live session's folder (config.json + param_server.json discovery)")
    a.add_argument("--connect", default=None,
                   help="parameter-server address (default: discover via <folder>/param_server.json)")
    a.add_argument("--episodes", type=int, default=10)
    a.add_argument("--fetch-every", type=int, default=100, help="re-fetch params every K acts")
    a.add_argument("--min-version", type=int, default=1,
                   help="block until the published version reaches this before acting (wait out warmup)")
    a.add_argument("--mode", choices=("training", "deterministic", "stochastic"), default="training")
    a.add_argument("--num-envs", type=int, default=None,
                   help="actor batch width (default: the session's env_config.num_envs)")
    a.add_argument("--max-steps", type=int, default=None, help="total act-step cap across the batch (safety stop)")
    a.add_argument("--video-dir", default=None, help="record episodes (host envs) via VideoWrapper")
    a.add_argument("--wait", type=float, default=60.0,
                   help="seconds to wait for the live session's config/server/first publish")
    a.add_argument("--seed", type=int, default=0)
    a.set_defaults(fn=run_actor)

    p = sub.add_parser("profile", help="ask a LIVE session for an "
                       "on-demand torch.profiler capture (writes "
                       "<folder>/profile.trigger; the capture lands under "
                       "<folder>/telemetry/profiles/)")
    p.add_argument("folder", help="the live session's folder")
    p.add_argument("--iters", type=int, default=None,
                   help="capture window length in iterations (default: "
                        "the session's session_config.profile.num_iters)")
    p.set_defaults(fn=run_profile)

    d = sub.add_parser("diag", help="offline session diagnosis from the "
                       "telemetry JSONL log: phase times, health summary, "
                       "heartbeats (works off the card and on live sessions)")
    d.add_argument("folder", help="session folder (holds telemetry/)")
    d.add_argument("--json", action="store_true",
                   help="print the aggregated summary as one JSON object "
                        "instead of the human-readable report")
    d.set_defaults(fn=run_diag)

    tr = sub.add_parser("trace", help="causal span-tree timelines for "
                        "the head-sampled exemplars (worker step -> "
                        "server forward -> learner dispatch), from the "
                        "telemetry event log; torn hops marked")
    tr.add_argument("folder", help="session folder (holds telemetry/)")
    tr.add_argument("--limit", type=int, default=16,
                    help="newest exemplars to render (default 16)")
    tr.set_defaults(fn=run_trace)

    tp = sub.add_parser("top", help="live cross-tier ops view from the "
                        "run's merged snapshot (telemetry/"
                        "ops_snapshot.json): tier health, per-tenant "
                        "SLO/error-budget table, hop latencies, MFU")
    tp.add_argument("folder", help="the live session's folder")
    tp.add_argument("--once", action="store_true",
                    help="print one snapshot and exit (scripts/tests)")
    tp.add_argument("--interval", type=float, default=2.0,
                    help="refresh period in seconds (default 2)")
    tp.set_defaults(fn=run_top)

    w = sub.add_parser("why", help="root-caused incident reports from "
                       "the watchdog (what fired, ranked cause "
                       "hypotheses, correlated faults/SLO breaches/"
                       "exemplars, auto-captured artifacts, remediation "
                       "actions with counter-detector verdicts)")
    w.add_argument("folder", help="session folder (holds telemetry/)")
    w.add_argument("--incident", type=int, default=None,
                   help="render one incident in full detail (default: "
                   "all, newest last)")
    w.set_defaults(fn=run_why)

    tu = sub.add_parser("tune", help="autotune a workload's program: "
                        "search precision/gae_impl/shuffle/vtrace_impl "
                        "candidates with fenced chained timing and persist "
                        "the winner in the per-workload tuning cache "
                        "(trainers apply it via "
                        "learner_config.algo.autotune='cache'|'search')")
    tu.add_argument("algo", choices=ALGOS)
    tu.add_argument("env", help="env with backend prefix; jax:* tunes the "
                    "device iteration over the full space, host envs "
                    "(gym:/dm_control:, the SEED fingerprints) tune the "
                    "learn-phase knobs against the learn program alone")
    tu.add_argument("--folder", required=True,
                    help="session directory (tuning cache + telemetry "
                         "land here unless session_config.tuning_cache_dir"
                         " points elsewhere)")
    tu.add_argument("--num-envs", type=int, default=64)
    tu.add_argument("--set", nargs="*", metavar="KEY=VAL", default=[],
                    help="dotlist overrides (geometry knobs, "
                         "session_config.tuning_cache_dir, "
                         "session_config.backend, ...)")
    tu.add_argument("--iters", type=int, default=8,
                    help="measured chained iterations per candidate")
    tu.add_argument("--warmup", type=int, default=2,
                    help="unmeasured warm-up iterations per candidate")
    tu.add_argument("--dims", default=None,
                    help="restrict the search space, e.g. "
                         "'precision=f32,mixed;gae_impl=xla,assoc' "
                         "(default: the full declared space, tune/space.py)")
    tu.add_argument("--force", action="store_true",
                    help="re-measure even on a cache hit")
    tu.add_argument("--out", default=None,
                    help="merge the result into a shared tune artifact "
                         "(keyed by fingerprint)")
    tu.set_defaults(fn=run_tune, total_steps=None, restore_from=None,
                    workers=None)

    c = sub.add_parser("chaos", help="randomized chaos campaign: N "
                       "seeded multi-site fault schedules run as short "
                       "real training sessions on the card, judged by the "
                       "run-wide invariant oracles (chaos/invariants.py); "
                       "failing schedules are shrunk to minimal "
                       "reproducers")
    c.add_argument("algo", choices=("impala", "ddpg", "all"),
                   help="which campaign profiles to run (profile algo "
                   "family; 'all' interleaves every profile)")
    c.add_argument("env", nargs="?", default="default",
                   help="env name override for every profile "
                   "(default: each profile's own env)")
    c.add_argument("--seeds", type=int, default=25,
                   help="number of seeded schedules (seed i -> "
                   "profile i %% len(profiles); intensity ramps with "
                   "seed %% 3)")
    c.add_argument("--out", default=None,
                   help="write the campaign artifact JSON here")
    c.add_argument("--dir", default=None,
                   help="scratch dir for the runs' session folders "
                   "(default: a fresh temp dir)")
    c.add_argument("--max-shrink-runs", type=int, default=12,
                   help="re-run budget per failing schedule for the "
                   "greedy shrinker")
    c.set_defaults(fn=run_chaos)
    return parser


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
