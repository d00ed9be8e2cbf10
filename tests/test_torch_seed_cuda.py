"""Card-only checks of the port's SEED topology (marker ``cuda``; they skip
without a card): one SEED IMPALA run and one SEED PPO run on the card,
and one IMPALA run behind a fleet of two replicas, with thread workers stepping a seeded numpy env defined here (this file
imports nothing of the JAX package and no env package, so it collects on
any machine with the port and a card):

    python -m pytest tests/test_torch_seed_cuda.py -m cuda

Each learn launches its scan kernel once (V-trace for IMPALA, GAE for
PPO), every serve acts on the card, and the metrics are finite."""

import math

import numpy as np
import pytest
import torch

from surreal_tpu_torch.distributed import env_worker as env_worker_mod
from surreal_tpu_torch.envs.base import ArraySpec, DiscreteSpec, EnvSpecs, HostEnv, StepOutput
from surreal_tpu_torch.envs.wrappers import EpisodeStatsWrapper
from surreal_tpu_torch.launch import seed_trainer as seed_mod
from surreal_tpu_torch.ops import gae as ops_gae
from surreal_tpu_torch.ops import vtrace as ops_vtrace
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config


class DriftEnv(HostEnv):
    """B point masses pushed by the action (one of ``n`` directions, or a
    continuous force) with seeded numpy noise; reward -|x|^2, episodes
    truncated every 20 steps."""

    def __init__(self, num_envs, n=None, obs_dim=4, act_dim=2, seed=0):
        self.num_envs, self._rng = num_envs, np.random.default_rng(seed)
        f32 = np.dtype(np.float32)
        action = (DiscreteSpec(shape=(), dtype=np.dtype(np.int32), name="action", n=n) if n
                  else ArraySpec(shape=(act_dim,), dtype=f32, name="action"))
        self.specs = EnvSpecs(obs=ArraySpec(shape=(obs_dim,), dtype=f32, name="obs"), action=action)
        self._push = np.random.default_rng(99).normal(0.0, 0.3, (n or act_dim, obs_dim)).astype(np.float32)

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = np.zeros(self.num_envs, np.int64)
        self._x = self._rng.normal(0.0, 1.0, (self.num_envs, self.specs.obs.shape[0])).astype(np.float32)
        return self._x.copy()

    def step(self, actions):
        force = self._push[actions] if self.specs.discrete else np.clip(actions, -1, 1) @ self._push
        self._x = (0.9 * self._x + force + 0.01 * self._rng.normal(size=self._x.shape)).astype(np.float32)
        reward = -(self._x ** 2).sum(1).astype(np.float32)
        self._t += 1
        done = self._t >= 20
        terminal = self._x.copy()
        if done.any():
            self._x[done] = self._rng.normal(0.0, 1.0, (int(done.sum()), self._x.shape[1])).astype(np.float32)
            self._t[done] = 0
        return StepOutput(obs=self._x.copy(), reward=reward, done=done,
                          info={"terminal_obs": terminal, "truncated": done.copy()})


@pytest.mark.cuda
@pytest.mark.parametrize("algo,wrapper", [
    (dict(name="impala", horizon=16), "vtrace"),
    (dict(name="ppo", horizon=16, epochs=2, num_minibatches=2), "gae"),
])
def test_seed_run_on_the_card(tmp_path, monkeypatch, algo, wrapper):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    discrete = algo["name"] == "impala"

    def make_env(env_config, device="cuda"):
        return EpisodeStatsWrapper(DriftEnv(env_config.num_envs, n=3 if discrete else None, seed=env_config.seed))

    monkeypatch.setattr(env_worker_mod, "make_env", make_env)
    monkeypatch.setattr(seed_mod, "make_env", make_env)
    acted_on = set()
    real_read_back = seed_mod.read_back

    def read_back(action, info):
        acted_on.add(action.device.type)
        return real_read_back(action, info)

    monkeypatch.setattr(seed_mod, "read_back", read_back)
    cfg = Config(
        learner_config=Config(algo=Config(algo)),
        env_config=Config(name="gym:Fixture", num_envs=8),
        session_config=Config(
            folder=str(tmp_path), total_env_steps=40 * 16 * 4,
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
            topology=Config(num_env_workers=2),
        ),
    ).extend(base_config())
    trainer = seed_mod.SEEDTrainer(cfg)  # the default device: the card
    counted = ops_vtrace.vtrace_fused if wrapper == "vtrace" else ops_gae.gae_advantages_masked
    counted.launches = 0
    rows = []
    state, metrics = trainer.run(on_metrics=lambda it, m: rows.append(m))
    assert trainer.device.type == "cuda" and acted_on == {"cuda"}
    learns = int(state.iteration)
    assert learns == len(rows) >= 40 and counted.launches == learns
    for k, v in metrics.items():
        assert math.isfinite(v), k


@pytest.mark.cuda
def test_seed_fleet_of_two_replicas_on_the_card(tmp_path, monkeypatch):
    """``topology.inference_fleet.replicas=2``: 4 thread workers over two
    replicas, each acting on the card through its own acting copy; V-trace
    once a learn; both replicas alive and serving at the end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")

    def make_env(env_config, device="cuda"):
        return EpisodeStatsWrapper(DriftEnv(env_config.num_envs, n=3, seed=env_config.seed))

    monkeypatch.setattr(env_worker_mod, "make_env", make_env)
    monkeypatch.setattr(seed_mod, "make_env", make_env)
    cfg = Config(
        learner_config=Config(algo=Config(name="impala", horizon=16)),
        env_config=Config(name="gym:Fixture", num_envs=8),
        session_config=Config(
            folder=str(tmp_path), total_env_steps=40 * 16 * 4,
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
            topology=Config(num_env_workers=4, inference_fleet=Config(replicas=2)),
        ),
    ).extend(base_config())
    trainer = seed_mod.SEEDTrainer(cfg)
    ops_vtrace.vtrace_fused.launches = 0
    rows = []
    state, metrics = trainer.run(on_metrics=lambda it, m: rows.append(m))
    learns = int(state.iteration)
    assert trainer.device.type == "cuda" and learns == len(rows) >= 40
    assert ops_vtrace.vtrace_fused.launches == learns
    assert metrics["fleet/replicas_live"] == 2.0 and metrics["server/serve_ms"] > 0
    for k, v in metrics.items():
        assert math.isfinite(v), k
