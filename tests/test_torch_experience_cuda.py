"""Card-only checks of the experience plane's device hot tier (marker
``cuda``; they skip without a card). This file imports nothing of the JAX
package and no env package: the host env is a small seeded numpy env
defined here, so it collects on any machine with the port and a card:

    python -m pytest tests/test_torch_experience_cuda.py -m cuda

- a hot sample on the card is bit-equal to ``UniformReplay.sample`` on the
  card for the same capacity, insert stream and seed, the draw and the
  replay gather kernel make no host sync, and the kernel equals its plain
  version on the hot ring's rows;
- a remote DDPG run with ``replay.tiers.hot.enabled`` launches the replay
  gather kernel once per update on a hot hit;
- with ``replay.tiers.spill.enabled`` its shards write the log, and
  ``replay_from_log`` over it on the card launches the gather once per
  update, gives equal digests twice, and with the CPU's draws injected
  lands within 1% of the CPU's update of every leaf.
"""

import numpy as np
import pytest
import torch

from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs, HostEnv, StepOutput
from surreal_tpu_torch.envs.wrappers import EpisodeStatsWrapper
from surreal_tpu_torch.launch import offpolicy_trainer as offpolicy_mod
from surreal_tpu_torch.ops import replay_rows as RR
from surreal_tpu_torch.replay.tiers import HotTier
from surreal_tpu_torch.replay.uniform import UniformReplay
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config


class PushEnv(HostEnv):
    """B point masses in 3 dimensions pushed by a 1-d continuous force,
    with seeded numpy noise; reward -|x|^2, episodes truncated every 20
    steps."""

    def __init__(self, num_envs, seed=0):
        f32 = np.dtype(np.float32)
        self.specs = EnvSpecs(obs=ArraySpec(shape=(3,), dtype=f32, name="obs"),
                              action=ArraySpec(shape=(1,), dtype=f32, name="action"))
        self.num_envs, self._rng = num_envs, np.random.default_rng(seed)
        self._push = np.random.default_rng(99).normal(0.0, 0.3, (1, 3)).astype(np.float32)

    def reset(self, seed=None):
        if seed is not None:
            self._rng = np.random.default_rng(seed)
        self._t = np.zeros(self.num_envs, np.int64)
        self._x = self._rng.normal(0.0, 0.5, (self.num_envs, 3)).astype(np.float32)
        return self._x.copy()

    def step(self, actions):
        self._x = (0.95 * self._x + np.clip(actions, -1, 1) @ self._push
                   + 0.05 * self._rng.normal(size=self._x.shape)).astype(np.float32)
        reward = -(self._x ** 2).sum(1).astype(np.float32)
        self._t += 1
        truncated = self._t >= 20
        terminal = self._x.copy()
        if truncated.any():
            self._x[truncated] = self._rng.normal(0.0, 0.5, (int(truncated.sum()), 3)).astype(np.float32)
            self._t[truncated] = 0
        return StepOutput(obs=self._x.copy(), reward=reward, done=truncated,
                          info={"terminal_obs": terminal, "truncated": truncated})


def _example(device):
    return {"obs": torch.zeros(3, device=device), "action": torch.zeros(1, device=device),
            "reward": torch.zeros((), device=device), "discount": torch.zeros((), device=device)}


@pytest.mark.cuda
def test_hot_sample_on_the_card_is_uniform_replay_bit_for_bit():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cap, bs = 4096, 256
    replay = UniformReplay(Config(capacity=cap, batch_size=bs, start_sample_size=bs))
    state = replay.init(_example("cuda"))
    hot = HotTier(capacity=cap, batch_size=bs, example=_example("cuda"))
    assert hot.gather_impl == "pallas"
    gen = torch.Generator(device="cuda").manual_seed(0)
    for _ in range(6):
        rows = {k: torch.randn((1000, *v.shape), generator=gen, device="cuda") for k, v in _example("cuda").items()}
        state = replay.insert(state, rows)
        hot.append(rows)
    torch.cuda.synchronize()
    RR.gather_rows.launches = 0
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = [hot.sample(seed) for seed in (1, 2, 3)]
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert RR.gather_rows.launches == 3
    for seed, batch in zip((1, 2, 3), got):
        _, want, info = replay.sample(state, torch.Generator(device="cuda").manual_seed(seed))
        plain = RR.gather_rows_plain(hot._state.storage, info["idx"])
        for k in want:
            assert torch.equal(batch[k], want[k]) and torch.equal(batch[k], plain[k]), k


@pytest.mark.cuda
def test_remote_ddpg_hot_tier_launches_the_gather_once_per_update(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(offpolicy_mod, "make_env", lambda cfg, device: EpisodeStatsWrapper(PushEnv(cfg.num_envs)))
    iters, K = 5, 4
    cfg = Config(
        learner_config=Config(
            algo=Config(name="ddpg", horizon=16, updates_per_iter=K, exploration=Config(warmup_steps=0)),
            replay=Config(kind="remote", remote_kind="uniform", capacity=4096, start_sample_size=128,
                          batch_size=128, tiers=Config(hot=Config(enabled=True, capacity=2048))),
        ),
        env_config=Config(name="gym:Pendulum-v1", num_envs=8),
        session_config=Config(
            folder=str(tmp_path), total_env_steps=16 * 8 * iters,
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
            topology=Config(overlap_rollouts=False, experience_plane=Config(num_shards=2, transport="shm")),
        ),
    ).extend(base_config())
    RR.gather_rows.launches = 0
    _state, metrics = offpolicy_mod.OffPolicyTrainer(cfg).run()
    hits = metrics["tier/hot_hits"]
    assert hits > 0 and metrics["tier/hot_misses"] == 0.0
    assert RR.gather_rows.launches == hits == K * iters
    assert np.isfinite(metrics["loss/critic"]) and metrics["experience/dropped_rows"] == 0.0


def _spill_run_cfg(folder, iters):
    return Config(
        learner_config=Config(
            algo=Config(name="ddpg", horizon=16, updates_per_iter=4, precision="f32",
                        exploration=Config(warmup_steps=0)),
            replay=Config(kind="remote", remote_kind="uniform", capacity=4096, start_sample_size=128,
                          batch_size=128, tiers=Config(spill=Config(enabled=True))),
        ),
        env_config=Config(name="gym:Pendulum-v1", num_envs=8),
        session_config=Config(
            folder=str(folder), total_env_steps=16 * 8 * iters,
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
            topology=Config(overlap_rollouts=False, experience_plane=Config(num_shards=2, transport="shm")),
        ),
    ).extend(base_config())


@pytest.mark.cuda
def test_replay_from_log_on_the_card(tmp_path, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    monkeypatch.setattr(offpolicy_mod, "make_env", lambda cfg, device: EpisodeStatsWrapper(PushEnv(cfg.num_envs)))
    cfg = _spill_run_cfg(tmp_path, 4)
    trainer = offpolicy_mod.OffPolicyTrainer(cfg)
    _state, metrics = trainer.run()
    log = str(tmp_path / "spill")
    outs = []
    for _ in range(2):
        RR.gather_rows.launches = 0
        outs.append(trainer.replay_from_log(log))
        assert RR.gather_rows.launches == outs[-1]["updates"] > 0
    assert outs[0]["params_digest"] == outs[1]["params_digest"]
    assert outs[0]["rows"] == metrics["tier/spill_rows"] == metrics["experience/rows"]
    # the card against the CPU on one log, the CPU's draws injected
    cpu = offpolicy_mod.OffPolicyTrainer(cfg, device="cpu")
    start = cpu.learner.init(torch.Generator().manual_seed(cfg.session_config.seed))
    draws = torch.randint(0, 128, (outs[0]["updates"], 128), generator=torch.Generator().manual_seed(5),
                          dtype=torch.int32)
    want = cpu.replay_from_log(log, state=start, sample_draws=draws)
    got = trainer.replay_from_log(log, state=trainer.learner.init(torch.Generator().manual_seed(cfg.session_config.seed)),
                                  sample_draws=draws)
    for name in ("actor_params", "critic_params"):
        g, w, s0 = dict(getattr(got["state"], name)), dict(getattr(want["state"], name)), dict(getattr(start, name))
        for k in w:
            moved = (w[k] - s0[k]).norm()
            assert (g[k].cpu() - w[k]).norm() <= 1e-2 * moved, (name, k)
