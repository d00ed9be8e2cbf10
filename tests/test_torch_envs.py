"""Parity of the PyTorch port's BlockLift, Pong and AutoReset with the JAX
package. States, actions and the env draws come from numpy or from JAX
itself and go through both packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.envs.jax.base import AutoReset as JaxAutoReset
from surreal_tpu.envs.jax.base import batch_step
from surreal_tpu.envs.jax.lift import BlockLift as JaxBlockLift
from surreal_tpu.envs.jax.lift import LiftState as JaxLiftState
from surreal_tpu.envs.jax.pong import Pong as JaxPong
from surreal_tpu.envs.jax.pong import PongSmall as JaxPongSmall
from surreal_tpu.envs.jax.pong import _serve as jax_serve
from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.envs.device.base import AutoReset
from surreal_tpu_torch.envs.device.lift import BlockLift, LiftState
from surreal_tpu_torch.envs.device.pong import Pong, PongSmall
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import BASE_ENV_CONFIG


@jax.jit
def _jax_reset_draws(keys):
    state, _ = jax.vmap(JaxBlockLift().reset)(keys)
    return jnp.concatenate(
        [state.block_pos[:, :2], state.grip_pos[:, :2], state.grip_width[:, None]], axis=1
    )


def reset_draws_from_keys(keys):
    """The values JAX's BlockLift.reset draws from each key, as the port's
    explicit [B, 5] reset draws (block xy, hand xy, opening)."""
    return np.asarray(_jax_reset_draws(keys))


split_sub = jax.jit(jax.vmap(lambda k: jax.random.split(k)[1]))


def _random_states(rng, B):
    """States spread over free fall, table contact, partial and full grasp."""
    block = np.stack([rng.uniform(-0.1, 0.1, B), rng.uniform(-0.1, 0.1, B),
                      rng.uniform(0.02, 0.12, B)], 1)
    near = rng.random(B) < 0.7
    grip = np.where(near[:, None], block + rng.uniform(-0.025, 0.025, (B, 3)),
                    block + rng.uniform(-0.2, 0.2, (B, 3)))
    grip[:, 2] = np.clip(grip[:, 2], 0.0, 0.35)
    return [x.astype(np.float32) for x in (
        grip, rng.uniform(-0.3, 0.3, (B, 3)), rng.uniform(0.025, 0.06, B),
        block, rng.uniform(-0.3, 0.3, (B, 3)),
    )]


def test_lift_one_step_matches_jax():
    rng = np.random.default_rng(0)
    B = 256
    leaves = _random_states(rng, B)
    action = rng.uniform(-1.3, 1.3, (B, 4)).astype(np.float32)
    j_state, j_obs, j_rew, j_done, j_info = jax.jit(jax.vmap(JaxBlockLift().step))(
        JaxLiftState(*map(jnp.asarray, leaves)), jnp.asarray(action)
    )
    t_state, t_obs, t_rew, t_done, t_info = BlockLift("cpu").step(
        LiftState(*map(torch.from_numpy, leaves)), torch.from_numpy(action)
    )
    # identical f32 elementwise physics; XLA may fold constants differently
    tol = dict(rtol=0, atol=1e-6)
    for got, want in zip(t_state, j_state):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    np.testing.assert_allclose(t_obs.numpy(), np.asarray(j_obs), **tol)
    np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), **tol)
    np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
    for k in ("success", "grasped"):
        np.testing.assert_array_equal(t_info[k].numpy(), np.asarray(j_info[k]))
    # the sample covers every physics branch
    assert 0 < int(t_info["grasped"].sum()) < B


def _scripted(grip, block, width):
    """Reach -> close -> lift (tests/test_envs.py::_lift_scripted_action),
    batched in numpy."""
    rel = block - grip
    near_xy = np.linalg.norm(rel[:, :2], axis=1) < 0.01
    at_block = np.linalg.norm(rel, axis=1) < 0.015
    v = np.clip(rel * 20, -1, 1)
    target_z = np.where(near_xy, block[:, 2], 0.08)
    vz = np.clip((target_z - grip[:, 2]) * 20, -1, 1)
    closed = width < 0.045
    vz = np.where(closed & at_block, 1.0, vz)
    vx = np.where(closed, 0.0, v[:, 0])
    vy = np.where(closed, 0.0, v[:, 1])
    return np.stack([vx, vy, vz, np.where(at_block, 1.0, -1.0)], 1).astype(np.float32)


def test_lift_autoreset_trajectory_matches_jax():
    """70 scripted steps with a 45-step time limit: the grasp, the lift,
    the truncation, terminal_obs and the auto-reset all agree. Actions are
    computed from the JAX trajectory and fed to both; reset draws follow
    JAX's per-env key chain."""
    B, T, limit = 4, 70, 45
    j_env = JaxAutoReset(JaxBlockLift(), time_limit=limit)
    t_env = AutoReset(BlockLift("cpu"), time_limit=limit)
    keys = jax.random.split(jax.random.key(3), B)
    j_state, j_obs = jax.jit(jax.vmap(j_env.reset))(keys)
    first = split_sub(keys)
    t_state, t_obs = t_env.reset(B, draws=torch.from_numpy(reset_draws_from_keys(first)))
    step = jax.jit(lambda s, a: batch_step(j_env, s, a))
    np.testing.assert_allclose(t_obs.numpy(), np.asarray(j_obs), atol=1e-6)
    grasped = 0
    for t in range(T):
        s = j_state.env_state
        action = _scripted(np.asarray(s.grip_pos), np.asarray(s.block_pos), np.asarray(s.grip_width))
        subs = split_sub(j_state.key)
        draws = torch.from_numpy(reset_draws_from_keys(subs))
        j_state, j_obs, j_rew, j_done, j_info = step(j_state, jnp.asarray(action))
        t_state, t_obs, t_rew, t_done, t_info = t_env.step(t_state, torch.from_numpy(action), reset_draws=draws)
        # 70 steps of f32 physics; errors stay at float rounding
        np.testing.assert_allclose(t_obs.numpy(), np.asarray(j_obs), atol=1e-5, err_msg=f"step {t}")
        np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), atol=1e-5, err_msg=f"step {t}")
        np.testing.assert_allclose(
            t_info["terminal_obs"].numpy(), np.asarray(j_info["terminal_obs"]), atol=1e-5
        )
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
        np.testing.assert_array_equal(t_info["truncated"].numpy(), np.asarray(j_info["truncated"]))
        np.testing.assert_array_equal(t_state.step_count.numpy(), np.asarray(j_state.step_count))
        grasped += int(t_info["grasped"].sum())
        if t == limit - 1:
            assert bool(t_done.all()) and bool(t_info["truncated"].all())
    assert grasped > 0, "the scripted policy never grasped: physics branches not exercised"


def test_make_env_builds_lift_and_refuses_unported_envs(tmp_path):
    env = make_env(Config(name="jax:lift", time_limit=7).extend(BASE_ENV_CONFIG), device="cpu")
    assert isinstance(env, AutoReset) and env.time_limit == 7
    assert env.specs.obs.shape == (17,) and env.specs.action.shape == (4,)
    state, obs = env.reset(3, generator=torch.Generator().manual_seed(0))
    assert obs.shape == (3, 17) and state.step_count.dtype == torch.int32
    with pytest.raises(ValueError, match="no step draws"):
        env.step(state, torch.zeros(3, 4), step_draws=torch.zeros(3, 1))
    # every env name is ported, and video recording on a host env: without
    # a video dir nothing records, with one the chain ends in the recorder;
    # robosuite stays behind the reference's import guard
    for video, last in ((Config(enabled=True), "EpisodeStatsWrapper"),
                        (Config(enabled=True, dir=str(tmp_path)), "VideoWrapper")):
        host = make_env(Config(name="gym:CartPole-v1", video=video).extend(BASE_ENV_CONFIG), device="cpu")
        assert type(host).__name__ == last and host.envs[0].render_mode == "rgb_array"
        host.close()
    with pytest.raises(ImportError, match="robosuite"):
        make_env(Config(name="robosuite:Lift").extend(BASE_ENV_CONFIG), device="cpu")


@pytest.mark.parametrize("name,port_cls,jax_cls", [
    ("jax:pong", Pong, JaxPong), ("jax:pong16", PongSmall, JaxPongSmall),
])
def test_make_env_builds_pong_with_generator_draws(name, port_cls, jax_cls):
    env = make_env(Config(name=name).extend(BASE_ENV_CONFIG), device="cpu")
    assert isinstance(env.env, port_cls) and env.time_limit == jax_cls.max_episode_steps
    for got, want in ((env.specs.obs, jax_cls.specs.obs), (env.specs.action, jax_cls.specs.action)):
        assert (got.shape, got.dtype, got.name) == (want.shape, want.dtype, want.name)
    assert env.specs.discrete and env.specs.action.n == 3 and env.step_draw_dim == 1
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset(64, generator=g)
    vel = state.env_state.vel
    assert obs.dtype == torch.uint8 and obs.shape == (64, *jax_cls.specs.obs.shape)
    assert (vel[:, 1].abs() <= 0.02).all() and (vel[:, 0] < 0).any() and (vel[:, 0] > 0).any()
    for _ in range(40):
        state, obs, reward, done, info = env.step(state, torch.randint(0, 3, (64,), generator=g), g)
    assert (vel[:, 1].abs() <= 0.06).all()


def _pong_draws(ar_state):
    """The draws JAX's Pong makes on the next AutoReset.step, from its two
    key chains: the serve vy of a point (the env's own key, split on every
    step) and the fresh reset (AutoReset's key), as the port's step draws
    [B, 1] and reset draws [B, 2]."""
    serve_vy = jax.vmap(lambda k: jax_serve(jax.random.split(k)[1], False)[1][1])(ar_state.env_state.key)
    reset, _ = jax.vmap(JaxPong().reset)(split_sub(ar_state.key))
    reset_draws = jnp.stack([reset.vel[:, 1], (reset.vel[:, 0] < 0).astype(jnp.float32)], axis=1)
    return serve_vy[:, None], reset_draws


@pytest.mark.parametrize("port_cls,jax_cls", [(Pong, JaxPong), (PongSmall, JaxPongSmall)])
def test_pong_trajectory_matches_jax(port_cls, jax_cls):
    """300 steps of 16 envs with a 120-step time limit: paddle hits, points
    both ways, wall bounces, time-limit truncations and (for two envs that
    start at 20-20) wins at 21 all agree. Pixels are thresholds on f32
    positions, so obs must be bit-equal, and reward, done and score equal.
    The draws follow JAX's key chains; actions track the ball with noise."""
    B, T, limit = 16, 300, 120
    j_env = JaxAutoReset(jax_cls(), time_limit=limit)
    t_env = AutoReset(port_cls("cpu"), time_limit=limit)
    keys = jax.random.split(jax.random.key(11), B)
    j_state, j_obs = jax.jit(jax.vmap(j_env.reset))(keys)
    reset, _ = jax.vmap(JaxPong().reset)(split_sub(keys))
    draws = np.stack([np.asarray(reset.vel[:, 1]), np.asarray(reset.vel[:, 0] < 0, np.float32)], 1)
    t_state, t_obs = t_env.reset(B, draws=torch.from_numpy(draws))
    np.testing.assert_array_equal(t_obs.numpy(), np.asarray(j_obs))
    # four envs one point from a win, for either side
    score = np.zeros(B, np.int32)
    score[:4] = 20
    j_state = j_state._replace(env_state=j_state.env_state._replace(
        agent_score=jnp.asarray(score), opp_score=jnp.asarray(score)))
    t_state = t_state._replace(env_state=t_state.env_state._replace(
        agent_score=torch.from_numpy(score), opp_score=torch.from_numpy(score.copy())))

    @jax.jit
    def j_step(state, action):
        """This step's draws (from the keys before it), then the step."""
        draws = _pong_draws(state)
        state, obs, reward, done, info = batch_step(j_env, state, action)
        outs = (obs, info["terminal_obs"], reward, done, info["truncated"], info["score"], info["point"])
        return state, draws, (*outs, *state.env_state[:-1])

    rng = np.random.default_rng(0)
    got, want = [], []
    for t in range(T):
        # track the ball, with noise (from the port's state, which equals JAX's)
        ball_y, paddle_y = t_state.env_state.ball[:, 1].numpy(), t_state.env_state.agent_y.numpy()
        track = np.where(ball_y < paddle_y - 0.02, 1, np.where(ball_y > paddle_y + 0.02, 2, 0))
        action = np.where(rng.random(B) < 0.4, track, rng.integers(0, 3, B)).astype(np.int32)
        j_state, (step_draws, reset_draws), j_outs = j_step(j_state, jnp.asarray(action))
        t_state, t_obs, t_rew, t_done, t_info = t_env.step(
            t_state, torch.from_numpy(action),
            reset_draws=torch.from_numpy(np.asarray(reset_draws)), step_draws=torch.from_numpy(np.asarray(step_draws)),
        )
        got.append((t_obs, t_info["terminal_obs"], t_rew, t_done, t_info["truncated"], t_info["score"],
                    t_info["point"], *t_state.env_state))
        want.append(j_outs)
    names = ("obs", "terminal_obs", "reward", "done", "truncated", "score", "point", *t_state.env_state._fields)
    for i, name in enumerate(names):
        g = np.stack([x[i].numpy() for x in got])
        w = np.stack([np.asarray(x[i]) for x in want])
        bad = np.nonzero((g != w).reshape(T, -1).any(axis=1))[0]
        assert bad.size == 0, f"{name} differs first at step {bad[:1]}"
    done, truncated, point, reward = (np.stack([x[i].numpy() for x in got]) for i in (3, 4, 6, 2))
    assert point.sum() >= 8 and (done & ~truncated).sum() >= 2 and truncated.sum() >= B
    assert set(np.unique(reward).tolist()) == {-1.0, 0.0, 1.0}
