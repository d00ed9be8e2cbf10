"""Card-only checks of the port's host-env training paths (marker
``cuda``; they skip without a card): one host PPO iteration and two host
DDPG iterations on the card against the same on the CPU, from the same
weights and the same injected draws. This file imports nothing of the JAX
package and no env package: the host env is a small seeded numpy env
defined here, so it collects on any machine with the port and a card:

    python -m pytest tests/test_torch_host_cuda.py -m cuda

Tolerances (the memoryless parity phases of chip_smoke.py): the card and
the CPU round f32 matmuls and sums differently, so continuous actions and
the obs they drive agree to 1e-4, discrete actions and the obs exactly;
metrics to 1e-4 + 1e-3 relative, the update ratio to 5e-2."""

import math

import numpy as np
import pytest
import torch

from surreal_tpu_torch.envs.base import ArraySpec, DiscreteSpec, EnvSpecs, HostEnv, StepOutput
from surreal_tpu_torch.envs.wrappers import EpisodeStatsWrapper
from surreal_tpu_torch.launch import offpolicy_trainer as offpolicy_mod
from surreal_tpu_torch.launch import trainer as trainer_mod
from surreal_tpu_torch.learners.aggregator import to_device
from surreal_tpu_torch.learners.ppo import _block_layout
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config


class DriftEnv(HostEnv):
    """B point masses in ``obs_dim`` dimensions pushed by the action (one
    of ``n`` directions, or a continuous force), with seeded numpy noise;
    reward -|x|^2, episodes truncated every ``limit`` steps."""

    def __init__(self, num_envs, obs_dim=4, n=None, act_dim=2, limit=6, seed=0):
        self.num_envs, self._limit, self._rng = num_envs, limit, np.random.default_rng(seed)
        f32 = np.dtype(np.float32)
        action = (DiscreteSpec(shape=(), dtype=np.dtype(np.int32), name="action", n=n) if n
                  else ArraySpec(shape=(act_dim,), dtype=f32, name="action"))
        self.specs = EnvSpecs(obs=ArraySpec(shape=(obs_dim,), dtype=f32, name="obs"), action=action)
        k = n if n else act_dim
        self._push = np.random.default_rng(99).normal(0.0, 0.3, (k, obs_dim)).astype(np.float32)

    def reset(self, seed=None):
        self._t = np.zeros(self.num_envs, np.int64)
        self._x = self._rng.normal(0.0, 1.0, (self.num_envs, self.specs.obs.shape[0])).astype(np.float32)
        return self._x.copy()

    def step(self, actions):
        force = self._push[actions] if self.specs.discrete else np.clip(actions, -1, 1) @ self._push
        self._x = (0.9 * self._x + force + 0.01 * self._rng.normal(size=self._x.shape)).astype(np.float32)
        reward = -(self._x ** 2).sum(1).astype(np.float32)
        self._t += 1
        done = self._t >= self._limit
        terminal = self._x.copy()
        if done.any():
            self._x[done] = self._rng.normal(0.0, 1.0, (int(done.sum()), self._x.shape[1])).astype(np.float32)
            self._t[done] = 0
        return StepOutput(obs=self._x.copy(), reward=reward, done=done,
                          info={"terminal_obs": terminal, "truncated": done.copy()})


def _config(tmp_path, algo, replay=None):
    learner = Config(algo=Config(precision="f32", **algo), **({"replay": Config(replay)} if replay else {}))
    return Config(learner_config=learner, env_config=Config(name="gym:Fixture", num_envs=8),
                  session_config=Config(folder=str(tmp_path))).extend(base_config())


def _close(got: dict, want: dict, what: str):
    for k, w in want.items():
        g = float(got[k])
        rtol = 5e-2 if k == "health/update_ratio" else 1e-3
        assert (math.isnan(w) and math.isnan(g)) or abs(g - w) <= 1e-4 + rtol * abs(w), (what, k, g, w)


@pytest.mark.cuda
def test_host_ppo_iteration_on_the_card_matches_the_cpu(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    T, B = 16, 8
    gen = torch.Generator().manual_seed(0)
    gumbel = -torch.log(-torch.log(torch.rand((T, B, 3), generator=gen).clamp_min(1e-20)))
    domain = 2 * _block_layout(T * B, 2, 16) or T * B
    perms = torch.stack([torch.randperm(domain, generator=gen) for _ in range(2)])
    out = {}
    for dev in ("cuda", "cpu"):
        monkeypatch.setattr(trainer_mod, "make_env", lambda cfg, device: EpisodeStatsWrapper(DriftEnv(B, n=3)))
        tr = trainer_mod.Trainer(_config(tmp_path, dict(name="ppo", horizon=T, epochs=2, num_minibatches=2)),
                                 device=dev)
        state = tr.learner.init(torch.Generator().manual_seed(0))
        state, obs, metrics, stats = tr._host_train_iter(
            state, tr.env.reset(seed=0), action_noise=gumbel.to(dev), perms=perms.to(dev))
        out[dev] = (obs, {k: float(v) for k, v in metrics.items()}, stats, state.params)
    np.testing.assert_array_equal(out["cuda"][0], out["cpu"][0])
    assert out["cuda"][2] == out["cpu"][2]
    _close(out["cuda"][1], out["cpu"][1], "ppo")
    for k, v in out["cpu"][3].items():
        assert out["cuda"][3][k].device.type == "cuda"
        torch.testing.assert_close(out["cuda"][3][k].cpu(), v, rtol=0, atol=1e-4)


@pytest.mark.cuda
def test_host_ddpg_iterations_on_the_card_match_the_cpu(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    H, B, K, BS = 8, 8, 4, 16
    gen = torch.Generator().manual_seed(1)
    warm = (torch.rand((H, B, 2), generator=gen) * 2 - 1).numpy()
    normals = torch.randn((H, B, 2), generator=gen)
    uniforms = torch.rand((2, K, BS), generator=gen)
    replay = dict(kind="prioritized", capacity=256, start_sample_size=B * H, batch_size=BS)
    out = {}
    for dev in ("cuda", "cpu"):
        monkeypatch.setattr(offpolicy_mod, "make_env", lambda cfg, device: EpisodeStatsWrapper(DriftEnv(B)))
        tr = offpolicy_mod.OffPolicyTrainer(_config(tmp_path, dict(
            name="ddpg", horizon=H, updates_per_iter=K, n_step=3, exploration=dict(warmup_steps=B * H)), replay),
            device=dev)
        state = tr.learner.init(torch.Generator().manual_seed(0))
        roll = tr.host_roll_state(tr.env.reset(seed=0), 0)
        replay_state, tail = tr.replay.init(tr._replay_example()), tr._fake_tail()
        for it in range(2):
            traj, _ = tr._explore_rollout(roll, state, it == 0, warmup_actions=warm, action_noise=normals)
            state, replay_state, tail, metrics = tr._host_update(
                state, replay_state, tail, to_device(traj, tr.device), it == 0, 0.4,
                sample_draws=uniforms[it].to(dev))
        out[dev] = (roll["obs"], {k: float(v) for k, v in metrics.items()}, replay_state.priorities.cpu())
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], rtol=0, atol=1e-4)
    _close(out["cuda"][1], out["cpu"][1], "ddpg")
    torch.testing.assert_close(out["cuda"][2], out["cpu"][2], rtol=0, atol=1e-4)
