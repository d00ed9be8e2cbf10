"""Parity of the PyTorch port's host envs with the JAX package: the
gymnasium and dm_control adapters, each numpy wrapper, the factory's
wrapper chain and its refusals. Both packages run the same numpy code on
the same seeds and actions, so every comparison is bit for bit."""

import numpy as np
import pytest

from surreal_tpu.envs import base as jax_base
from surreal_tpu.envs import factory as jax_factory
from surreal_tpu.envs import wrappers as jax_wrappers
from surreal_tpu.envs.dm_control_adapter import DmControlAdapter as JaxDmControlAdapter
from surreal_tpu.envs.gym_adapter import GymAdapter as JaxGymAdapter
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import BASE_ENV_CONFIG as JAX_BASE_ENV_CONFIG
from surreal_tpu_torch.envs import base as port_base
from surreal_tpu_torch.envs import factory as port_factory
from surreal_tpu_torch.envs import wrappers as port_wrappers
from surreal_tpu_torch.envs.dm_control_adapter import DmControlAdapter
from surreal_tpu_torch.envs.gym_adapter import GymAdapter
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import BASE_ENV_CONFIG


def _assert_step_equal(got, want, where: str):
    np.testing.assert_array_equal(got.obs, want.obs, err_msg=f"obs {where}")
    np.testing.assert_array_equal(got.reward, want.reward, err_msg=f"reward {where}")
    np.testing.assert_array_equal(got.done, want.done, err_msg=f"done {where}")
    assert set(got.info) == set(want.info), where
    for k in want.info:
        np.testing.assert_array_equal(got.info[k], want.info[k], err_msg=f"{k} {where}")
    assert got.obs.dtype == want.obs.dtype and got.reward.dtype == want.reward.dtype


def _actions(specs, B, rng):
    if specs.discrete:
        return rng.integers(0, specs.action.n, B).astype(np.int32)
    return rng.uniform(-1.3, 1.3, (B, *specs.action.shape)).astype(np.float32)


@pytest.mark.parametrize("make,steps,truncates", [
    pytest.param(lambda pkg, B: pkg[0]("CartPole-v1", num_envs=B, seed=3), 60, False, id="gym-CartPole-v1"),
    pytest.param(lambda pkg, B: pkg[0]("Pendulum-v1", num_envs=B, seed=3), 205, True, id="gym-Pendulum-v1"),
    pytest.param(lambda pkg, B: pkg[1]("cheetah", "run", num_envs=B, seed=3), 1003, True,
                 id="dm_control-cheetah-run"),
])
def test_host_adapters_match_jax(make, steps, truncates):
    """Same seeds, same actions (outside [-1, 1] too, to exercise the
    clip of the canonical rescale): obs, reward, done, truncated and
    terminal_obs bit-equal over a run long enough for episode ends (pole
    falls, Pendulum's 200-step and cheetah-run's 1000-step limits)."""
    B = 2
    ours, theirs = make((GymAdapter, DmControlAdapter), B), make((JaxGymAdapter, JaxDmControlAdapter), B)
    for got, want in ((ours.specs.obs, theirs.specs.obs), (ours.specs.action, theirs.specs.action)):
        assert (got.shape, got.dtype, got.name, getattr(got, "n", None)) == (
            want.shape, want.dtype, want.name, getattr(want, "n", None))
    np.testing.assert_array_equal(ours.reset(), theirs.reset())
    rng = np.random.default_rng(0)
    dones = truncs = 0
    for t in range(steps):
        a = _actions(theirs.specs, B, rng)
        got, want = ours.step(a.copy()), theirs.step(a.copy())
        _assert_step_equal(got, want, f"step {t}")
        dones += int(want.done.sum())
        truncs += int(want.info["truncated"].sum())
    assert dones > 0, "no episode ended: the boundary was not exercised"
    assert (truncs > 0) == truncates
    # a second reset continues the streams (no re-seed), in both
    np.testing.assert_array_equal(ours.reset(), theirs.reset())
    ours.close(), theirs.close()


def _fake_env(base, B=3, obs_shape=(4, 4, 3), done_every=4, renderable=False):
    """A deterministic batched numpy env of the given package's HostEnv:
    obs a function of (step, env), done on a schedule (the middle env
    truncated), terminal_obs the pre-reset obs; with ``renderable`` its
    ``envs`` render frames and its auto-reset fires ``pre_reset_hook``."""

    class _Inner:
        def __init__(self, i):
            self.i, self.t = i, 0

        def render(self):
            return np.full((6, 8, 3), (self.t * 7 + self.i * 31) % 256, np.uint8)

    class FakeEnv(base.HostEnv):
        num_envs = B
        specs = base.EnvSpecs(
            obs=base.ArraySpec(shape=obs_shape, dtype=np.dtype(np.uint8)),
            action=base.ArraySpec(shape=(2,), dtype=np.dtype(np.float32)),
        )

        def __init__(self):
            self.envs = [_Inner(i) for i in range(B)]

        def _obs(self):
            return np.stack([np.full(obs_shape, (e.t * 5 + e.i * 11) % 256, np.uint8) for e in self.envs])

        def reset(self, seed=None):
            for e in self.envs:
                e.t = 0
            return self._obs()

        def step(self, actions):
            terminal = np.zeros((B, *obs_shape), np.uint8)
            done = np.zeros(B, bool)
            for e in self.envs:
                e.t += 1
                if e.t % (done_every + e.i) == 0:
                    done[e.i] = True
                    terminal[e.i] = self._obs()[e.i]
                    if renderable and self.pre_reset_hook is not None:
                        self.pre_reset_hook(e.i, e)
                    e.t = 0
            reward = np.asarray([float(a.sum()) + e.t for a, e in zip(actions, self.envs)], np.float32)
            truncated = done & (np.arange(B) == 1)
            return base.StepOutput(obs=self._obs(), reward=reward, done=done,
                                   info={"terminal_obs": terminal, "truncated": truncated})

    return FakeEnv()


WRAPPERS = {
    "frame_stack": lambda W, env: W.FrameStackWrapper(env, 3),
    "grayscale": lambda W, env: W.GrayscaleWrapper(env),
    "transpose": lambda W, env: W.TransposeWrapper(env, (2, 0, 1)),
    "action_repeat": lambda W, env: W.ActionRepeatWrapper(env, 3),
    "pixel_obs": lambda W, env: W.PixelObsWrapper(env, image_size=(5, 7)),
    "episode_stats": lambda W, env: W.EpisodeStatsWrapper(env),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_matches_jax(name):
    """Each wrapper over the same fake env against its twin, 25 steps
    across several episode ends: obs, rewards, dones and every info leaf
    bit-equal, specs equal. PixelObs renders the fake env's frames and
    captures the terminal frame through the adapter's pre-reset hook."""
    renderable = name == "pixel_obs"
    ours = WRAPPERS[name](port_wrappers, _fake_env(port_base, renderable=renderable))
    theirs = WRAPPERS[name](jax_wrappers, _fake_env(jax_base, renderable=renderable))
    assert (ours.specs.obs.shape, ours.specs.obs.dtype) == (theirs.specs.obs.shape, theirs.specs.obs.dtype)
    np.testing.assert_array_equal(ours.reset(), theirs.reset())
    rng = np.random.default_rng(1)
    for t in range(25):
        a = rng.normal(size=(3, 2)).astype(np.float32)
        _assert_step_equal(ours.step(a), theirs.step(a), f"{name} step {t}")
    if renderable:
        # the hook was installed on the innermost adapter and fired
        assert ours.env.pre_reset_hook is not None


def _chain(env):
    names = []
    while True:
        names.append(type(env).__name__)
        if not hasattr(env, "env") or type(env).__name__ in ("GymAdapter", "DmControlAdapter"):
            return names
        env = env.env


def test_factory_builds_the_reference_wrapper_chain():
    """gym with pixel obs, grayscale, frame stack and action repeat: the
    port wraps in the reference's order, with the same obs spec, and a
    device env stays a device env."""
    over = dict(name="gym:CartPole-v1", num_envs=2, pixel_obs=True, image_size=[16, 16], grayscale=True,
                frame_stack=2, action_repeat=2)
    ours = port_factory.make_env(Config(over).extend(BASE_ENV_CONFIG), device="cpu")
    theirs = jax_factory.make_env(JaxConfig(over).extend(JAX_BASE_ENV_CONFIG))
    assert _chain(ours) == _chain(theirs) == [
        "EpisodeStatsWrapper", "ActionRepeatWrapper", "FrameStackWrapper", "GrayscaleWrapper",
        "PixelObsWrapper", "GymAdapter",
    ]
    assert ours.specs.obs.shape == theirs.specs.obs.shape == (16, 16, 2)
    assert not port_factory.is_jax_env(ours) and not jax_factory.is_jax_env(theirs)
    np.testing.assert_array_equal(ours.reset(seed=0), theirs.reset(seed=0))
    for _ in range(3):
        a = np.ones(2, np.int32)
        _assert_step_equal(ours.step(a), theirs.step(a), "pixel chain")
    ours.close(), theirs.close()
    dm = port_factory.make_env(Config(name="dm_control:cheetah-run", num_envs=1).extend(BASE_ENV_CONFIG))
    assert _chain(dm) == ["EpisodeStatsWrapper", "DmControlAdapter"] and dm.specs.obs.shape == (17,)
    assert port_factory.is_jax_env(port_factory.make_env(Config(name="jax:nut").extend(BASE_ENV_CONFIG), "cpu"))


def test_factory_refusals(tmp_path):
    """robosuite sits behind the reference's import guard (it is not
    installed); unknown names raise. Video on a host env ends the chain in
    the VideoWrapper, as the reference's does, over envs that render
    ``rgb_array`` frames."""
    with pytest.raises(ImportError, match="robosuite is not installed"):
        port_factory.make_env(Config(name="robosuite:Lift").extend(BASE_ENV_CONFIG))
    with pytest.raises(ImportError):
        jax_factory.make_env(JaxConfig(name="robosuite:Lift").extend(JAX_BASE_ENV_CONFIG))
    video = dict(name="gym:CartPole-v1", video=dict(enabled=True, dir=str(tmp_path / "v")))
    ours = port_factory.make_env(Config(video).extend(BASE_ENV_CONFIG))
    theirs = jax_factory.make_env(JaxConfig(video).extend(JAX_BASE_ENV_CONFIG))
    try:
        assert _chain(ours) == _chain(theirs) == ["VideoWrapper", "EpisodeStatsWrapper", "GymAdapter"]
        assert ours.envs[0].render_mode == theirs.envs[0].render_mode == "rgb_array"
    finally:
        ours.close(), theirs.close()
    with pytest.raises(ValueError, match="unknown jax env"):
        port_factory.make_env(Config(name="jax:nope").extend(BASE_ENV_CONFIG), "cpu")
    with pytest.raises(ValueError, match="unknown env backend"):
        port_factory.make_env(Config(name="atari:Pong").extend(BASE_ENV_CONFIG))
    with pytest.raises(ValueError, match="backend prefix"):
        port_factory.make_env(Config(name="CartPole-v1").extend(BASE_ENV_CONFIG))
