"""Parity of the PyTorch port's Pendulum and CartPole (``jax:pendulum``,
``jax:cartpole``) with the JAX package. States, actions and the reset
draws come from numpy or from JAX itself and go through both packages.

Both envs step with ``sin`` and ``cos``, which XLA and torch evaluate with
different polynomials on the CPU (one ulp apart at most, ROADMAP §3), and
both dynamics amplify a last-bit difference over a long free run. So the
300-step trajectories step the port from the JAX state at every step
(teacher forcing) and hold each step to 1e-5; whatever the step and the
auto-reset compute beyond ``sin``/``cos`` agrees to float rounding."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.envs.jax.base import AutoReset as JaxAutoReset
from surreal_tpu.envs.jax.base import batch_step
from surreal_tpu.envs.jax.cartpole import CartPole as JaxCartPole
from surreal_tpu.envs.jax.cartpole import CartPoleState as JaxCartPoleState
from surreal_tpu.envs.jax.pendulum import Pendulum as JaxPendulum
from surreal_tpu.envs.jax.pendulum import PendulumState as JaxPendulumState
from surreal_tpu.envs.jax.pendulum import _angle_normalize as jax_angle_normalize
from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.envs.device.base import AutoReset
from surreal_tpu_torch.envs.device.cartpole import CartPole, CartPoleState
from surreal_tpu_torch.envs.device.pendulum import Pendulum, PendulumState, _angle_normalize
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import BASE_ENV_CONFIG

# one step of f32 physics through sin/cos, one ulp apart between XLA and
# torch on the CPU; observed at most 1.9e-6 (see each test)
STEP_TOL = dict(rtol=0, atol=1e-5)

ENVS = {
    "pendulum": (JaxPendulum, Pendulum, JaxPendulumState, PendulumState),
    "cartpole": (JaxCartPole, CartPole, JaxCartPoleState, CartPoleState),
}

split_sub = jax.jit(jax.vmap(lambda k: jax.random.split(k)[1]))


def _reset_draws(jax_cls):
    """What ``jax_cls.reset`` draws from each key, as the port's [B, n]
    reset draws (the reset state's leaves, in order)."""
    return jax.jit(lambda keys: jnp.stack(list(jax.vmap(jax_cls().reset)(keys)[0]), axis=1))


def test_angle_normalize_is_floor_mod():
    x = np.concatenate([np.linspace(-20, 20, 4001), [-np.pi, np.pi, 3 * np.pi, -3 * np.pi]]).astype(np.float32)
    got = _angle_normalize(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax.jit(jax_angle_normalize)(jnp.asarray(x))))
    assert got.min() >= -np.pi - 1e-6 and got.max() < np.pi


@pytest.mark.parametrize("name", sorted(ENVS))
def test_control_env_one_step_matches_jax(name):
    """One step from states spread over the whole phase space (pendulum:
    every angle, speeds near the clip, actions beyond the box; cartpole:
    both pushes, states on both sides of the termination bounds)."""
    jax_cls, port_cls, jax_state, port_state = ENVS[name]
    rng = np.random.default_rng(0)
    B = 4096
    if name == "pendulum":
        leaves = [rng.uniform(-7, 7, B), rng.uniform(-8.5, 8.5, B)]
        action = rng.uniform(-1.5, 1.5, (B, 1)).astype(np.float32)
    else:
        leaves = [rng.uniform(-2.5, 2.5, B), rng.uniform(-2, 2, B), rng.uniform(-0.25, 0.25, B), rng.uniform(-2, 2, B)]
        action = rng.integers(0, 2, B).astype(np.int32)
    leaves = [x.astype(np.float32) for x in leaves]
    j_state, j_obs, j_rew, j_done, _ = jax.jit(jax.vmap(jax_cls().step))(
        jax_state(*map(jnp.asarray, leaves)), jnp.asarray(action)
    )
    t_state, t_obs, t_rew, t_done, _ = port_cls("cpu").step(
        port_state(*map(torch.from_numpy, leaves)), torch.from_numpy(action)
    )
    errs = [np.abs(g.numpy() - np.asarray(w)).max() for g, w in zip((*t_state, t_obs, t_rew), (*j_state, j_obs, j_rew))]
    assert max(errs) <= STEP_TOL["atol"], errs  # observed 1.9e-6 (pendulum, |theta_dot| up to 8), 2.4e-7 (cartpole)
    np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
    if name == "cartpole":
        assert 0 < int(t_done.sum()) < B


@pytest.mark.parametrize("name", sorted(ENVS))
def test_control_env_trajectory_matches_jax(name):
    """300 steps of 32 envs through AutoReset with a time limit of 90
    steps (pendulum) or 15 (cartpole, which also terminates): the port steps from JAX's state each step,
    with JAX's reset draws, and obs, reward, done, truncation,
    terminal_obs and the step counts agree."""
    jax_cls, port_cls, _, port_state = ENVS[name]
    B, T, limit = 32, 300, 90 if name == "pendulum" else 15
    j_env = JaxAutoReset(jax_cls(), time_limit=limit)
    t_env = AutoReset(port_cls("cpu"), time_limit=limit)
    draws_of = _reset_draws(jax_cls)
    keys = jax.random.split(jax.random.key(7), B)
    j_state, j_obs = jax.jit(jax.vmap(j_env.reset))(keys)
    t_state, t_obs = t_env.reset(B, draws=torch.from_numpy(np.asarray(draws_of(split_sub(keys)))))
    np.testing.assert_allclose(t_obs.numpy(), np.asarray(j_obs), **STEP_TOL)
    step = jax.jit(lambda s, a: batch_step(j_env, s, a))
    rng = np.random.default_rng(1)
    max_err, n_done, n_trunc = 0.0, 0, 0
    for t in range(T):
        if name == "pendulum":
            action = rng.uniform(-1.5, 1.5, (B, 1)).astype(np.float32)
        else:
            action = rng.integers(0, 2, B).astype(np.int32)
        # teacher forcing: the port steps from JAX's state (see the module doc)
        t_state = t_state._replace(
            env_state=port_state(*(torch.from_numpy(np.asarray(x)) for x in j_state.env_state)),
            step_count=torch.from_numpy(np.asarray(j_state.step_count)),
        )
        draws = torch.from_numpy(np.asarray(draws_of(split_sub(j_state.key))))
        j_state, j_obs, j_rew, j_done, j_info = step(j_state, jnp.asarray(action))
        t_state, t_obs, t_rew, t_done, t_info = t_env.step(t_state, torch.from_numpy(action), reset_draws=draws)
        for got, want in ((t_obs, j_obs), (t_rew, j_rew), (t_info["terminal_obs"], j_info["terminal_obs"]),
                          *zip(t_state.env_state, j_state.env_state)):
            err = float(np.abs(got.numpy() - np.asarray(want)).max())
            assert err <= STEP_TOL["atol"], (t, err)
            max_err = max(max_err, err)
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done), err_msg=f"step {t}")
        np.testing.assert_array_equal(t_info["truncated"].numpy(), np.asarray(j_info["truncated"]))
        np.testing.assert_array_equal(t_state.step_count.numpy(), np.asarray(j_state.step_count))
        n_done += int(t_done.sum())
        n_trunc += int(t_info["truncated"].sum())
    # observed: max_err 9.5e-7 (pendulum), 2.4e-7 (cartpole)
    assert n_trunc >= B and (name == "pendulum" or n_done > n_trunc), (n_done, n_trunc, max_err)


@pytest.mark.parametrize("name,cls,obs_dim", [("jax:pendulum", Pendulum, 3), ("jax:cartpole", CartPole, 4)])
def test_make_env_builds_control_envs(name, cls, obs_dim):
    env = make_env(Config(name=name).extend(BASE_ENV_CONFIG), device="cpu")
    jax_cls = JaxPendulum if cls is Pendulum else JaxCartPole
    assert isinstance(env.env, cls) and env.time_limit == jax_cls.max_episode_steps
    for got, want in ((env.specs.obs, jax_cls.specs.obs), (env.specs.action, jax_cls.specs.action)):
        assert (got.shape, got.dtype, got.name) == (want.shape, want.dtype, want.name)
    assert env.specs.discrete == (cls is CartPole)
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(256, generator=g)
    assert obs.shape == (256, obs_dim) and obs.dtype == torch.float32
    first = torch.stack(list(state.env_state), dim=1)
    if cls is Pendulum:
        assert first[:, 0].abs().max() <= np.pi and first[:, 1].abs().max() <= 1.0
        assert first[:, 0].abs().max() > 2.5
    else:
        assert first.abs().max() <= 0.05 and first.abs().max() > 0.04
    with pytest.raises(ValueError, match="reset draws"):
        env.reset(3, draws=torch.zeros(3, cls.reset_draw_dim + 1))
