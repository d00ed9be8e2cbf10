"""Card-only checks of the trajectory-policy learns (marker ``cuda``; they
skip without a card). This file imports nothing of the JAX package, so it
collects on a machine that has the port and a card only:

    python -m pytest tests/test_torch_trajectory_cuda.py -m cuda

One sequence learn of each algorithm from the same weights and batch on
the card and on the CPU (whose path tests/test_torch_trajectory.py holds
against the JAX package): PPO's ``_learn_seq`` launches the GAE kernel
once (the reverse scan's at ``gae_impl='assoc'``), IMPALA's the V-trace
kernel once. Bar: chip_smoke.py's card-vs-CPU one (f32 sums in other
orders: metrics 1e-3 relative, the update ratio 5e-2, params 1e-4), and
the attention's key biases to lr per Adam step: their gradient is zero in
exact arithmetic (the softmax cancels them), so Adam steps rounding noise
by up to lr."""

import numpy as np
import pytest
import torch

from surreal_tpu_torch.envs.base import ArraySpec, DiscreteSpec, EnvSpecs
from surreal_tpu_torch.learners import build_learner
from surreal_tpu_torch.ops import gae as G
from surreal_tpu_torch.ops import rev_scan as RS
from surreal_tpu_torch.ops import vtrace as V
from surreal_tpu_torch.session.config import Config

T, B, OBS = 32, 64, 3
ENC = dict(kind="trajectory", features=64, num_layers=2, num_heads=4, head_dim=16)


def _batch(discrete: bool, seed: int = 0):
    rng = np.random.default_rng(seed)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))  # noqa: E731
    done = rng.random((T, B)) < 0.05
    batch = {
        "obs": f(T, B, OBS), "next_obs": f(T, B, OBS), "reward": f(T, B),
        "done": torch.from_numpy(done), "terminated": torch.from_numpy(done & (rng.random((T, B)) < 0.5)),
        "behavior_logp": f(T, B) - 1.0,
    }
    if discrete:
        batch["action"] = torch.from_numpy(rng.integers(0, 2, (T, B)).astype(np.int32))
        batch["behavior"] = {"logits": f(T, B, 2)}
    else:
        batch["action"] = f(T, B, 1)
        batch["behavior"] = {"mean": 0.3 * f(T, B, 1), "log_std": torch.full((T, B, 1), -0.5)}
    return batch


def _specs(discrete: bool):
    f32 = np.dtype(np.float32)
    action = DiscreteSpec((), np.dtype(np.int32), n=2) if discrete else ArraySpec((1,), f32)
    return EnvSpecs(obs=ArraySpec((OBS,), f32), action=action)


def _on(dev, batch):
    return {k: ({kk: vv.to(dev) for kk, vv in v.items()} if isinstance(v, dict) else v.to(dev)) for k, v in batch.items()}


def _learn_both(algo: Config, discrete: bool, counter, expected: dict, **learn_kw):
    out = {}
    for dev in ("cuda", "cpu"):
        learner = build_learner(Config(algo=algo, model=Config(encoder=Config(ENC))), _specs(discrete), device=dev)
        assert learner.seq_policy
        state = learner.init(torch.Generator().manual_seed(0))
        before = {name: w.launches for name, w in counter.items()}
        kw = {k: v.to(dev) for k, v in learn_kw.items()}
        new_state, metrics = learner.learn(state, _on(dev, _batch(discrete)), **kw)
        if dev == "cuda":
            torch.cuda.synchronize()
            for name, w in counter.items():
                assert w.launches - before[name] == expected[name], name
        out[dev] = ({k: float(v) for k, v in metrics.items()}, {k: v.cpu() for k, v in new_state.params.items()})
    return out


def _assert_card_matches_cpu(out, lr: float, steps: int):
    for k, want in out["cpu"][0].items():
        got = out["cuda"][0][k]
        rtol = 5e-2 if k == "health/update_ratio" else 1e-3
        assert abs(got - want) <= 1e-4 + rtol * abs(want), (k, got, want)
    for k, want in out["cpu"][1].items():
        got = out["cuda"][1][k]
        if k.endswith(".k.bias"):
            assert (got - want).abs().max() <= lr * steps * 1.01, k
        else:
            torch.testing.assert_close(got, want, rtol=0, atol=1e-4, msg=k)


@pytest.mark.cuda
@pytest.mark.parametrize("gae_impl", ["xla", "assoc"])
def test_trajectory_ppo_learn_launches_its_scan_once_and_matches_the_cpu(gae_impl):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    algo = Config(name="ppo", horizon=T, epochs=2, num_minibatches=2, precision="f32", gae_impl=gae_impl)
    gen = torch.Generator().manual_seed(1)
    perms = torch.stack([torch.randperm(2 * 32, generator=gen) for _ in range(2)])  # 2 minibatches x 32 blocks
    xla = gae_impl == "xla"
    out = _learn_both(
        algo, False, {"gae": G.gae_advantages_masked, "rev_scan": RS.reverse_linear_scan},
        {"gae": int(xla), "rev_scan": int(not xla)}, perms=perms,
    )
    _assert_card_matches_cpu(out, lr=3e-4, steps=4)


@pytest.mark.cuda
def test_trajectory_impala_learn_launches_vtrace_once_and_matches_the_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    algo = Config(name="impala", horizon=T, precision="f32")
    out = _learn_both(algo, True, {"vtrace": V.vtrace_fused, "rev_scan": RS.reverse_linear_scan},
                      {"vtrace": 1, "rev_scan": 0})
    _assert_card_matches_cpu(out, lr=6e-4, steps=1)
