"""Time the 'mixed' north-star paths of two checkouts of the port in turns
on one CUDA card, as a change is held against its parent.

    mkdir -p build/parent && git archive HEAD | tar -x -C build/parent
    python3 ab_trees.py build/parent . [--rounds 1]

Each turn is one process started in the checkout under test: it builds
that checkout's kernels and runs that checkout's own ``chip_smoke.py``
steps, so both sides are measured by the same code they shipped with:

- ``phase_train``: the north-star, 4096 envs x 256 steps at 'mixed'
  (``timed_run``'s median of 4 iterations after 2 warm-up ones);
- ``session_cli_ppo``: ``train ppo jax:lift`` at that geometry for 8
  iterations with eval and a checkpoint every 4 (its metrics windows);
- ``session_learning``: PPO on ``jax:lift`` at 256 x 64 until the return
  reaches 400 (its seconds).

The turns run A, B, B, A in each of ``--rounds`` rounds. Prints one JSON
line per turn, then a summary line with each checkout's medians, then the
card's name and power limit; needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import statistics
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from types import SimpleNamespace

KEYS = ("north_star_iter_ms", "session_iter_ms_bare", "session_iter_ms_with_eval_and_checkpoint",
        "learning_seconds")


def turn() -> dict:
    """One turn in the current directory's checkout (``--turn``)."""
    import torch

    sys.path.insert(0, os.getcwd())
    import chip_smoke as C
    import surreal_tpu_torch.main.launch as launch
    from surreal_tpu_torch.launch.hooks import SessionHooks
    from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer
    from surreal_tpu_torch.launch.trainer import Trainer
    from surreal_tpu_torch.ops import gae as ops_gae
    from surreal_tpu_torch.ops import rev_scan as RS
    from surreal_tpu_torch.session.checkpoint import CheckpointManager
    from surreal_tpu_torch.session.config import Config
    from surreal_tpu_torch.session.default_configs import base_config
    from surreal_tpu_torch.session.telemetry import _iter_jsonl
    from surreal_tpu_torch.utils.kernel_build import build_kernel
    from surreal_tpu_torch.utils.tree import tree_flatten

    M = SimpleNamespace(Config=Config, base_config=base_config, Trainer=Trainer, OffPolicyTrainer=OffPolicyTrainer,
                        launch=launch, SessionHooks=SessionHooks, CheckpointManager=CheckpointManager,
                        iter_jsonl=_iter_jsonl, tree_flatten=tree_flatten)
    try:
        with ThreadPoolExecutor(len(C.KERNEL_SOURCES)) as pool:
            list(pool.map(build_kernel, C.KERNEL_SOURCES))
        gae = {"gae": (ops_gae.gae_advantages_masked, 1), "rev_scan": (RS.reverse_linear_scan, 0)}
        train = C.phase_train(Config, base_config, Trainer, gae)
        cli = C.session_cli_ppo(M, gae)
        learning = C.session_learning(M)
    finally:
        for root in C._SCRATCH:
            shutil.rmtree(root, ignore_errors=True)
        torch.cuda.synchronize()
    return {"north_star_iter_ms": train["iter_ms_median"],
            "session_iter_ms_bare": cli["iteration_ms_without_cadence_work"],
            "session_iter_ms_with_eval_and_checkpoint": max(cli["iteration_ms_with_eval_and_checkpoint"]),
            "learning_seconds": learning["seconds_to_target"]}


def main() -> int:
    parser = argparse.ArgumentParser()
    parser.add_argument("trees", nargs="*", help="two checkouts: A (the parent), B (the change)")
    parser.add_argument("--rounds", type=int, default=1)
    parser.add_argument("--turn", action="store_true", help="run one turn in the current directory")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("ab_trees: needs a CUDA card", file=sys.stderr)
        return 2
    if args.turn:
        print("TURN " + json.dumps(turn()), flush=True)
        return 0
    if len(args.trees) != 2:
        parser.error("give two checkouts")
    trees = [os.path.abspath(t) for t in args.trees]
    rows = {t: [] for t in trees}
    for _ in range(args.rounds):
        for tree in (trees[0], trees[1], trees[1], trees[0]):
            out = subprocess.run([sys.executable, os.path.abspath(__file__), "--turn"], cwd=tree,
                                 capture_output=True, text=True, check=False)
            line = next((x for x in out.stdout.splitlines() if x.startswith("TURN ")), None)
            if out.returncode != 0 or line is None:
                print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
                raise SystemExit(f"ab_trees: the turn in {tree} failed (rc {out.returncode})")
            row = json.loads(line[5:])
            rows[tree].append(row)
            print(json.dumps({"tree": tree, **row}), flush=True)
    summary = {name: {k: statistics.median(r[k] for r in rows[t]) for k in KEYS}
               for name, t in zip(("A", "B"), trees)}
    summary["B_over_A"] = {k: summary["B"][k] / summary["A"][k] for k in KEYS}
    print(json.dumps({"trees": {"A": trees[0], "B": trees[1]}, "rounds": args.rounds, **summary}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
