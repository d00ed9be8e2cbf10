"""Card-only check of the program autotuner (marker ``cuda``; it skips
without a card). This file imports nothing of the JAX package, so it
collects on a machine that has the port and a card only:

    python -m pytest tests/test_torch_tune_cuda.py -m cuda

A search at the north-star geometry (PPO, jax:lift, 4096 envs x 256
steps, 4 epochs x 4 minibatches, 'mixed') over ``gae_impl`` 'xla' and
'assoc', one warm-up and one measured iteration a trial: GAE launches once
a learn of the 'xla' trial, the reverse scan once a learn of the 'assoc'
one, the entry names the card, and each trial's memory is released.
The same search again is a pure hit: nothing measured, nothing
launched."""

import pytest
import torch

from surreal_tpu_torch.ops import gae as ops_gae
from surreal_tpu_torch.ops import rev_scan as ops_rev_scan
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.tune.search import tune_workload


@pytest.mark.cuda
def test_north_star_trials_then_a_pure_hit(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cfg = Config(
        learner_config={"algo": {"name": "ppo", "horizon": 256, "epochs": 4, "num_minibatches": 4}},
        env_config={"name": "jax:lift", "num_envs": 4096},
        session_config={"folder": str(tmp_path)},
    ).extend(base_config())
    gae, scan = ops_gae.gae_advantages_masked, ops_rev_scan.reverse_linear_scan
    dims = [("gae_impl", ["xla", "assoc"])]
    torch.cuda.reset_peak_memory_stats()
    baseline = torch.cuda.memory_allocated()
    gae.launches = scan.launches = 0
    out = tune_workload(cfg, dims=dims, warmup=1, throwaway=0, iters=1)
    assert not out["cache_hit"] and out["measured"] == 2
    assert [t["config"]["gae_impl"] for t in out["trials"]] == ["xla", "assoc"]
    assert (gae.launches, scan.launches) == (2, 2)
    assert out["platform"] == "gpu" and out["device_kind"] == torch.cuda.get_device_name(0)
    assert all(t["iter_ms"] > 0 for t in out["trials"])
    # the trials' trainers are gone: what stays (the cuBLAS workspaces,
    # about 65 MB on an H100) is a small part of one trial's peak
    peak = torch.cuda.max_memory_allocated() - baseline
    left = torch.cuda.memory_allocated() - baseline
    assert left < peak / 10, f"{left} of a {peak}-byte peak still allocated after the trials"
    gae.launches = scan.launches = 0
    again = tune_workload(cfg, dims=dims, warmup=1, throwaway=0, iters=1)
    assert again["cache_hit"] and again["measured"] == 0 and again["config"] == out["config"]
    assert (gae.launches, scan.launches) == (0, 0)
