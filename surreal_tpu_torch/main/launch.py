"""Experiment launcher, the port of ``surreal_tpu/main/launch.py``'s
``train`` subcommand (``build_config``, ``select_trainer``, ``run_train``,
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

The offline subcommands, with the reference's arguments, messages and
exit codes (pure file work, so they run on any machine, also beside a
live session on the card):

    python -m surreal_tpu_torch profile /tmp/exp1 --iters 2   # ask a live session for a capture
    python -m surreal_tpu_torch diag /tmp/exp1                # phases, health, perf, captures
    python -m surreal_tpu_torch trace /tmp/exp4               # SEED causal span trees

Refused with exit code 2: ``--workers`` with ddpg or a ``jax:`` env (the
reference's rule and message), and, not ported yet, ``--local-procs``
(process groups, with the multi-host SEED trainer) and the other
subcommands (eval, actor, tune, top, why, chaos).
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
UNPORTED_COMMANDS = ("eval", "actor", "tune", "top", "why", "chaos")
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


def _not_ported(args) -> int:
    print(f"surreal_tpu_torch: the {args.cmd!r} subcommand is not ported to PyTorch yet; "
          "use python -m surreal_tpu for it", file=sys.stderr)
    return 2


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
    for name in UNPORTED_COMMANDS:
        u = sub.add_parser(name, help="not ported to PyTorch yet")
        u.add_argument("rest", nargs=argparse.REMAINDER)
        u.set_defaults(fn=_not_ported)
    return parser


def main(argv=None) -> int:
    args = make_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
