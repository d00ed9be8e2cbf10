"""The port's agents (``surreal_tpu_torch/agents/``) against the JAX
package's (``surreal_tpu/agents/``), from the same parameters (converted
from JAX's with ``utils/convert.py``) and the same obs normalizer, with
JAX's own draws injected (the Gaussian action noise from the act key, the
OU normals from its ``k_noise`` split):

- ``PPOAgent`` and ``DDPGAgent`` in the three modes, through ``act`` and
  through the remote path (a view published by a ``ParameterPublisher``,
  fetched over the wire into an agent that started from other weights,
  then ``remote_act``): actions and behaviour info within 1e-5 under
  'f32' and 2e-2 under 'mixed';
- DDPG's OU noise carried over six steps from JAX's noise each step
  (rtol 1e-6 / atol 1e-7: ``noise + drift + diffusion`` is two
  multiply-adds that XLA fuses into FMAs and torch rounds twice, ROADMAP
  §3) and masked on reset bit for bit; DDPG's wire view is the actor only;
- the fetch cadence, the ``param_version`` stamp (int32 a row), the guards
  before ``connect``, and a trajectory agent's acting context, kept across
  a fetch and made afresh on connect and on a new batch size.

Every socket wait has its own deadline."""

import functools
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.agents import DDPGAgent as JaxDDPGAgent
from surreal_tpu.agents import PPOAgent as JaxPPOAgent
from surreal_tpu.envs.base import ArraySpec as JaxArraySpec
from surreal_tpu.envs.base import EnvSpecs as JaxEnvSpecs
from surreal_tpu.learners import build_learner as jax_build_learner
from surreal_tpu.ops.running_stats import RunningStats as JaxRunningStats
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu_torch.agents import AGENT_MODES, Agent, DDPGAgent, PPOAgent, make_agent
from surreal_tpu_torch.distributed import ParameterPublisher, ParameterServer
from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs
from surreal_tpu_torch.learners import build_learner
from surreal_tpu_torch.ops.running_stats import RunningStats
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.utils.convert import ddpg_params_from_jax, params_from_jax

OBS, ACT, B = 17, 4, 8
TOL = {"f32": dict(rtol=0, atol=1e-5), "mixed": dict(rtol=0, atol=2e-2)}
FMA_TOL = dict(rtol=1e-6, atol=1e-7)


def _specs():
    f32 = np.dtype(np.float32)
    return (JaxEnvSpecs(obs=JaxArraySpec((OBS,), f32), action=JaxArraySpec((ACT,), f32)),
            EnvSpecs(obs=ArraySpec((OBS,), f32), action=ArraySpec((ACT,), f32)))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _stats():
    """A warm obs normalizer (count 50), the same on both sides."""
    rng = np.random.default_rng(3)
    mean = rng.normal(size=OBS).astype(np.float32)
    m2 = (rng.uniform(0.5, 2.0, size=OBS) * 50).astype(np.float32)
    return (JaxRunningStats(jnp.int32(50), jnp.asarray(mean), jnp.asarray(m2)),
            RunningStats(torch.tensor(50, dtype=torch.int32), torch.from_numpy(mean), torch.from_numpy(m2)))


@functools.lru_cache(maxsize=None)
def _pair(algo: str, precision: str, noise: str = "ou"):
    """(JAX learner, JAX state, port learner, port state) from JAX's init,
    the weights converted, the obs normalizer warm."""
    jspecs, tspecs = _specs()
    tree = {"algo": {"name": algo, "precision": precision}}
    if algo == "ddpg":
        tree["algo"]["exploration"] = {"noise": noise, "sigma": 0.3}
    jl = jax_build_learner(JaxConfig(tree), jspecs)
    tl = build_learner(Config(tree), tspecs, device="cpu")
    j_state = jax.jit(jl.init)(jax.random.key(0))
    j_stats, t_stats = _stats()
    j_state = j_state._replace(obs_stats=j_stats)
    if algo == "ddpg":
        t_state = tl.state_from_params(*ddpg_params_from_jax(_np_tree(j_state.actor_params),
                                                             _np_tree(j_state.critic_params)))
    else:
        t_state = tl.state_from_params(params_from_jax(_np_tree(j_state.params)))
    return jl, j_state, tl, t_state._replace(obs_stats=t_stats)


def _obs(seed: int) -> np.ndarray:
    return np.random.default_rng(seed).normal(size=(B, OBS)).astype(np.float32)


class _Live:
    """A publisher and a server; ``publish`` waits (bounded) until the
    server serves the new version."""

    def __init__(self):
        self.pub = ParameterPublisher()
        self.server = ParameterServer(self.pub.address)
        self.address = self.server.address

    def publish(self, agent: Agent, view) -> int:
        version = self.pub.publish(view)
        deadline = time.monotonic() + 5
        while agent.peek_published_version(timeout_ms=2000) < version:
            assert time.monotonic() < deadline, "the server never saw the publish"
            time.sleep(0.01)
        return version

    def close(self):
        self.server.close()
        self.pub.close()


def _close(got, want, tol, what):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64), err_msg=what, **tol)


@pytest.mark.parametrize("precision", ["f32", "mixed"])
@pytest.mark.parametrize("mode", AGENT_MODES)
def test_ppo_agent_matches_jax(mode, precision):
    """``act`` from the same state, then ``remote_act`` from the published
    view fetched into an agent that started from other weights."""
    jl, j_state, tl, t_state = _pair("ppo", precision)
    tol = TOL[precision]
    obs, key = _obs(1), jax.random.key(5)
    j_action, j_info = JaxPPOAgent(jl, mode).act(j_state, jnp.asarray(obs), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (B, ACT), jnp.float32)))
    agent = PPOAgent(tl, mode)
    action, info = agent.act(t_state, obs, noise=noise)
    _close(action, j_action, tol, "act action")
    for k in ("logp", "mean", "value"):
        _close(info[k], j_info[k], tol, f"act {k}")
    live = _Live()
    try:
        agent.connect(live.address, tl.init(torch.Generator().manual_seed(9)), fetch_every=1)
        live.publish(agent, agent.acting_view(t_state))
        action, info = agent.remote_act(torch.from_numpy(obs), noise=noise)
        assert agent.param_version == 1
        _close(action, j_action, tol, "remote action")
        _close(info["logp"], j_info["logp"], tol, "remote logp")
        assert info["param_version"].dtype == torch.int32 and info["param_version"].tolist() == [1] * B
    finally:
        agent.close()
        live.close()


@pytest.mark.parametrize("precision", ["f32", "mixed"])
@pytest.mark.parametrize("mode", AGENT_MODES)
def test_ddpg_agent_matches_jax(mode, precision):
    """Three acts in a row (training mode carries OU noise between them),
    the last through the remote path; JAX's normals of each step's
    ``k_noise`` injected."""
    jl, j_state, tl, t_state = _pair("ddpg", precision)
    tol = TOL[precision]
    ja, agent = JaxDDPGAgent(jl, mode), DDPGAgent(tl, mode)
    live = _Live()
    try:
        for step in range(3):
            obs, key = _obs(10 + step), jax.random.key(20 + step)
            j_action, _ = ja.act(j_state, jnp.asarray(obs), key)
            normals = torch.from_numpy(np.array(jax.random.normal(jax.random.split(key)[1], (B, ACT), jnp.float32)))
            if step < 2:
                action, info = agent.act(t_state, obs, noise=normals)
            else:
                agent.connect(live.address, tl.init(torch.Generator().manual_seed(9)))
                live.publish(agent, agent.acting_view(t_state))
                action, info = agent.remote_act(obs, noise=normals)
                assert agent.param_version == 1
            assert info == {}
            _close(action, j_action, tol, f"step {step}")
        if mode == "training":
            _close(agent._noise, ja._noise, FMA_TOL, "ou noise")
        else:
            assert agent._noise is None and ja._noise is None
    finally:
        agent.close()
        live.close()


def test_ddpg_gaussian_exploration_matches_jax():
    jl, j_state, tl, t_state = _pair("ddpg", "f32", "gaussian")
    obs, key = _obs(2), jax.random.key(4)
    j_action, _ = JaxDDPGAgent(jl).act(j_state, jnp.asarray(obs), key)
    noise = torch.from_numpy(np.array(jax.random.normal(key, (B, ACT), jnp.float32)))
    action, _ = DDPGAgent(tl).act(t_state, obs, noise=noise)
    _close(action, j_action, TOL["f32"], "gaussian")


def test_ddpg_ou_noise_is_carried_and_masked_on_reset_as_in_jax():
    """Six training-mode steps: each starts from JAX's noise state, steps
    it with JAX's normals (FMA_TOL), then both agents mask the rows whose
    episode ended (bit for bit)."""
    jl, j_state, tl, t_state = _pair("ddpg", "f32")
    ja, agent = JaxDDPGAgent(jl), DDPGAgent(tl)
    dones = np.random.default_rng(7).random((6, B)) < 0.3
    for step in range(6):
        obs, key = _obs(30 + step), jax.random.key(40 + step)
        if ja._noise is not None:
            agent._noise = torch.from_numpy(np.array(ja._noise))
        j_action, _ = ja.act(j_state, jnp.asarray(obs), key)
        normals = np.asarray(jax.random.normal(jax.random.split(key)[1], (B, ACT), jnp.float32))
        action, _ = agent.act(t_state, obs, noise=torch.from_numpy(normals))
        np.testing.assert_allclose(agent._noise.numpy(), np.asarray(ja._noise), err_msg=f"step {step}", **FMA_TOL)
        _close(action, j_action, TOL["f32"], f"step {step}")
        agent._noise = torch.from_numpy(np.array(ja._noise))
        ja.mask_noise_on_reset(jnp.asarray(dones[step]))
        agent.mask_noise_on_reset(dones[step])
        np.testing.assert_array_equal(agent._noise.numpy(), np.asarray(ja._noise))
        assert (agent._noise.numpy()[dones[step]] == 0).all()


def test_wire_views_and_make_agent():
    """make_agent maps as the reference's; DDPG publishes the actor and the
    obs normalizer only, PPO the params and the normalizer."""
    jl, j_state, tl, t_state = _pair("ddpg", "f32")
    view = make_agent(tl).acting_view(t_state)
    assert isinstance(make_agent(tl), DDPGAgent) and set(view) == {"actor_params", "obs_stats"}
    assert set(view) == set(JaxDDPGAgent(jl).acting_view(j_state))
    assert t_state._replace(**view).critic_params is t_state.critic_params
    _, _, ptl, pts = _pair("ppo", "f32")
    assert isinstance(make_agent(ptl), PPOAgent) and set(make_agent(ptl).acting_view(pts)) == {"params", "obs_stats"}
    impala = build_learner(Config(algo=Config(name="impala")), _specs()[1], device="cpu")
    assert type(make_agent(impala, "eval_stochastic")) is PPOAgent
    with pytest.raises(ValueError, match="mode"):
        Agent(ptl, "greedy")
    view = make_agent(tl).eval_view(deterministic=False)
    assert type(view) is DDPGAgent and view.mode == "eval_stochastic"


def test_fetch_cadence_version_stamp_and_guards():
    """fetch_every=1 fetches before every act; fetch_every=3 every third
    act; a timeout keeps the copy held; every guard before connect."""
    _, _, tl, t_state = _pair("ppo", "f32")
    agent = PPOAgent(tl)
    obs = np.zeros((2, OBS), np.float32)
    for call in (lambda: agent.remote_act(obs), agent.fetch_params, agent.peek_published_version):
        with pytest.raises(RuntimeError, match="connect"):
            call()
    with pytest.raises(ValueError, match="fetch_every"):
        agent.connect("tcp://127.0.0.1:1", t_state, 0)
    live = _Live()
    try:
        agent.connect(live.address, tl.init(torch.Generator().manual_seed(1)), fetch_every=1)
        _, info = agent.remote_act(obs)
        assert agent.param_version == 0 and info["param_version"].tolist() == [0, 0]
        for expected in (1, 2):
            live.publish(agent, agent.acting_view(t_state))
            _, info = agent.remote_act(obs)
            assert agent.param_version == expected and info["param_version"].tolist() == [expected] * 2
        agent.connect(live.address, t_state, fetch_every=3)
        seen = []
        for _ in range(6):
            live.publish(agent, agent.acting_view(t_state))
            agent.remote_act(obs)
            seen.append(agent.param_version)
        # the first act fetches (version 3), then every third (6)
        assert seen == [3, 3, 3, 6, 6, 6]
        real = agent._client.fetch
        agent._client.fetch = lambda *a, **k: (_ for _ in ()).throw(TimeoutError())
        assert agent.fetch_params() is False and agent.param_version == 6
        agent._client.fetch = real
    finally:
        agent.close()
        live.close()


def test_trajectory_agent_keeps_its_context_across_a_fetch():
    """A trajectory policy acts remotely through act_init/act_step: its
    actions are the learner's own act_step loop with the same draws, its
    context survives a fetch, and it starts afresh on connect and on a new
    batch size."""
    tspecs = _specs()[1]
    cfg = Config(algo=Config(name="ppo", horizon=8, precision="f32"),
                 model=Config(encoder=Config(kind="trajectory", features=32, num_layers=1, num_heads=2,
                                             head_dim=8)))
    tl = build_learner(cfg, tspecs, device="cpu")
    state = tl.init(torch.Generator().manual_seed(42))
    g = torch.Generator().manual_seed(0)
    obs = [torch.randn(4, OBS, generator=g) for _ in range(4)]
    noise = [torch.randn(4, ACT, generator=g) for _ in range(4)]
    live = _Live()
    agent = PPOAgent(tl)
    try:
        agent.connect(live.address, state, fetch_every=3)
        carry = tl.act_init(4)
        for t in range(3):
            a, _ = agent.remote_act(obs[t], noise=noise[t])
            want, _, carry = tl.act_step(state, carry, obs[t], "training", noise=noise[t])
            assert torch.equal(a, want)
        assert agent._act_carry["pos"] == 3
        live.publish(agent, agent.acting_view(tl.init(torch.Generator().manual_seed(7))))
        assert agent.fetch_params() and agent.param_version == 1
        agent.remote_act(obs[3], noise=noise[3])
        assert agent._act_carry["pos"] == 4  # not reset by the fetch
        agent.remote_act(obs[0][:2])
        assert agent._act_carry["pos"] == 1  # a new batch size: a fresh context
        agent.connect(live.address, state)
        assert agent._act_carry is None
    finally:
        agent.close()
        live.close()
