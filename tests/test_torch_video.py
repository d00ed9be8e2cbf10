"""Eval video in the port (``envs/video.py``, ``envs/device/pixels.py::
frame_renderer``, the evaluator's device recording, the host
``VideoWrapper``) against the JAX package's:

- ``frame_renderer`` gives bit-equal frames to the reference's for
  ``jax:lift``, ``jax:nut``, ``jax:lift_pixels``, ``jax:nut_pixels``,
  ``jax:pong`` and ``jax:pong16`` on the same states (JAX's, after a reset
  and random steps), and None for the envs with no visual form;
- the device evaluator records the same episodes (every
  ``every_n_episodes``-th evaluation) with the same frame count, frame
  shape and file stem as the reference's, and the host evaluator on
  ``gym:CartPole-v1`` (the same f32 weights, the same env seed) writes
  the same frames under the same stem;
- ``eval FOLDER --best --max-steps`` after ``train`` scores the keep-best
  checkpoint and records its episode, on a host env and on a device env.
"""

import io
import json
import os
import shutil
from contextlib import redirect_stdout

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import surreal_tpu.envs.video as jax_video
import surreal_tpu_torch.envs.video as port_video
import surreal_tpu_torch.main.launch as launch
from surreal_tpu.envs.base import ArraySpec as JaxArraySpec
from surreal_tpu.envs.base import DiscreteSpec as JaxDiscreteSpec
from surreal_tpu.envs.base import EnvSpecs as JaxEnvSpecs
from surreal_tpu.envs.jax import cartpole as jax_cartpole
from surreal_tpu.envs.jax import lift as jax_lift
from surreal_tpu.envs.jax import nut_assembly as jax_nut
from surreal_tpu.envs.jax import pixels as jax_pixels
from surreal_tpu.envs.jax import pong as jax_pong
from surreal_tpu.launch.evaluator import Evaluator as JaxEvaluator
from surreal_tpu.learners import build_learner as jax_build_learner
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import BASE_ENV_CONFIG as JAX_BASE_ENV_CONFIG
from surreal_tpu_torch.envs.base import ArraySpec, DiscreteSpec, EnvSpecs
from surreal_tpu_torch.envs.device import cartpole, lift, nut_assembly, pixels, pong
from surreal_tpu_torch.launch.evaluator import Evaluator
from surreal_tpu_torch.learners import build_learner
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import BASE_ENV_CONFIG
from surreal_tpu_torch.utils.convert import categorical_params_from_jax, params_from_jax

RENDERED = {
    "lift": (jax_lift.BlockLift, lift.BlockLift),
    "nut": (jax_nut.NutAssembly, nut_assembly.NutAssembly),
    "lift_pixels": (jax_pixels.BlockLiftPixels, pixels.BlockLiftPixels),
    "nut_pixels": (jax_pixels.NutAssemblyPixels, pixels.NutAssemblyPixels),
    "pong": (jax_pong.Pong, pong.Pong),
    "pong16": (jax_pong.PongSmall, pong.PongSmall),
}


def _batch1(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x)[None])


def _to_port(j):
    """One JAX env state as the port's batch of one."""
    if hasattr(j, "prev"):
        return pixels.PixelState(_to_port(j.inner), _batch1(j.prev))
    if hasattr(j, "threaded"):
        return nut_assembly.NutState(_to_port(j.hand), _batch1(j.threaded))
    if hasattr(j, "prev_frame"):
        return pong.PongState(*(_batch1(getattr(j, f)) for f in pong.PongState._fields))
    return lift.LiftState(*map(_batch1, j))


@pytest.mark.parametrize("name", sorted(RENDERED))
def test_frame_renderer_is_bit_equal_to_jax(name):
    """Six envs from a reset, then eight steps of random actions: every
    frame bit-equal, [H, W, 3] uint8."""
    jax_cls, port_cls = RENDERED[name]
    j_env = jax_cls()
    j_render = jax_pixels.frame_renderer(j_env)
    t_render = pixels.frame_renderer(port_cls("cpu"))
    n = 6
    states, _ = jax.jit(jax.vmap(j_env.reset))(jax.random.split(jax.random.key(3), n))
    step = jax.jit(jax.vmap(j_env.step))
    rng = np.random.default_rng(0)
    frames = 0
    for t in range(9):
        for i in range(n):
            one = jax.tree.map(lambda x: x[i], states)
            want = np.asarray(j_render(one))
            got = t_render(_to_port(one))
            assert got.dtype == np.uint8 and got.shape == want.shape and got.ndim == 3 and got.shape[-1] == 3
            np.testing.assert_array_equal(got, want, err_msg=f"{name} env {i} step {t}")
            frames += 1
        if name.startswith("pong"):
            action = jnp.asarray(rng.integers(0, 3, n), jnp.int32)
        else:
            action = jnp.asarray(rng.uniform(-1, 1, (n, 4)), jnp.float32)
        states, *_ = step(states, action)
    assert frames == 54


def test_envs_without_a_visual_form_have_no_renderer():
    assert jax_pixels.frame_renderer(jax_cartpole.CartPole()) is None
    assert pixels.frame_renderer(cartpole.CartPole("cpu")) is None
    with pytest.raises(ValueError, match="frame renderer"):
        env_cfg = Config(name="jax:cartpole", video=Config(enabled=True, dir="v")).extend(BASE_ENV_CONFIG)
        specs = EnvSpecs(obs=ArraySpec((4,), np.dtype(np.float32)), action=DiscreteSpec(shape=(), dtype=np.dtype(np.int32), n=2))
        Evaluator(env_cfg, Config(episodes=1, mode="deterministic"), build_learner(
            Config(algo=Config(name="ppo")), specs, device="cpu"))


def _recorder(monkeypatch, module):
    """Record what ``module.save_episode_frames`` is given, writing nothing."""
    seen = []
    monkeypatch.setattr(module, "save_episode_frames",
                        lambda frames, out_dir, idx: seen.append((len(frames), np.asarray(frames[0]).shape, idx)))
    return seen


def test_device_eval_recording_matches_jax(tmp_path, monkeypatch):
    """jax:lift, every second evaluation recorded, 12-step cap: one episode
    of 13 frames (reset frame, 12 steps) at evaluations 0 and 2, as the
    reference records them; then the file on disk."""
    env = dict(name="jax:lift", num_envs=1, video=dict(enabled=True, dir=str(tmp_path / "v"), every_n_episodes=2))
    ev_cfg = dict(episodes=2, mode="deterministic", max_steps=12)
    f32 = np.dtype(np.float32)
    jl = jax_build_learner(JaxConfig(algo=JaxConfig(name="ppo")),
                           JaxEnvSpecs(obs=JaxArraySpec((17,), f32), action=JaxArraySpec((4,), f32)))
    j_state = jl.init(jax.random.key(0))
    tl = build_learner(Config(algo=Config(name="ppo")), EnvSpecs(obs=ArraySpec((17,), f32),
                                                                 action=ArraySpec((4,), f32)), device="cpu")
    t_state = tl.state_from_params(params_from_jax(jax.tree.map(np.asarray, j_state.params)))
    jev = JaxEvaluator(JaxConfig(env).extend(JAX_BASE_ENV_CONFIG), JaxConfig(ev_cfg), jl)
    tev = Evaluator(Config(env).extend(BASE_ENV_CONFIG), Config(ev_cfg), tl)
    theirs, ours = _recorder(monkeypatch, jax_video), _recorder(monkeypatch, port_video)
    for k in range(3):
        jev.evaluate(j_state, jax.random.key(k))
        tev.evaluate(t_state, k)
    assert ours == theirs == [(13, (192, 387, 3), 0), (13, (192, 387, 3), 2)]
    monkeypatch.undo()
    tev.evaluate(t_state, 5)  # the fourth evaluation: not recorded
    assert not os.path.exists(tmp_path / "v")
    tev.evaluate(t_state, 6)
    (written,) = os.listdir(tmp_path / "v")
    assert written.split(".")[0] == "episode_000004"
    if written.endswith(".npz"):
        assert np.load(tmp_path / "v" / written)["frames"].shape == (13, 192, 387, 3)


def test_host_eval_recording_matches_jax(tmp_path):
    """gym:CartPole-v1 through the VideoWrapper, the same f32 weights and
    env seed in both packages: the same frames (rendered by gymnasium from
    the same states) under the same stem."""
    f32 = np.dtype(np.float32)
    jl = jax_build_learner(JaxConfig(algo=JaxConfig(name="ppo", precision="f32")),
                           JaxEnvSpecs(obs=JaxArraySpec((4,), f32), action=JaxDiscreteSpec(shape=(), dtype=np.dtype(np.int32), n=2)))
    j_state = jl.init(jax.random.key(1))
    tl = build_learner(Config(algo=Config(name="ppo", precision="f32")),
                       EnvSpecs(obs=ArraySpec((4,), f32), action=DiscreteSpec(shape=(), dtype=np.dtype(np.int32), n=2)), device="cpu")
    t_state = tl.state_from_params(categorical_params_from_jax(jax.tree.map(np.asarray, j_state.params)))
    got = {}
    for tag, (Ev, C, base, learner, state, key) in {
        "jax": (JaxEvaluator, JaxConfig, JAX_BASE_ENV_CONFIG, jl, j_state, jax.random.key(0)),
        "port": (Evaluator, Config, BASE_ENV_CONFIG, tl, t_state, 0),
    }.items():
        vdir = tmp_path / tag
        env = C(name="gym:CartPole-v1", num_envs=1, video=C(enabled=True, dir=str(vdir), every_n_episodes=1))
        ev = Ev(env.extend(base), C(episodes=1, mode="deterministic", max_steps=500), learner)
        try:
            out = ev.evaluate(state, key)
        finally:
            ev.close()
        (name,) = os.listdir(vdir)
        got[tag] = (name, out["eval/length"], _frames(vdir / name))
    assert got["port"][0] == got["jax"][0] and got["port"][0].startswith("episode_000000")
    assert got["port"][1] == got["jax"][1]
    np.testing.assert_array_equal(got["port"][2], got["jax"][2])
    assert len(got["port"][2]) == got["port"][1] + 1  # the reset frame and one a step


def _frames(path) -> np.ndarray:
    if str(path).endswith(".npz"):
        return np.load(path)["frames"]
    import imageio.v2 as imageio

    return np.stack(imageio.mimread(path, memtest=False))


def _main(argv) -> tuple[int, list[dict]]:
    out = io.StringIO()
    with redirect_stdout(out):
        rc = launch.main(argv)
    return rc, [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


@pytest.mark.parametrize("env", ["gym:CartPole-v1", "jax:lift"])
def test_cli_eval_best_with_video_and_step_cap(env, tmp_path):
    """``train`` with eval feeding keep-best and ``env_config.video`` on,
    then ``eval FOLDER --best --max-steps``: the best checkpoint scored,
    the eval namespace and the checkpoint's counters printed, the episode
    recorded."""
    folder, vdir = str(tmp_path / "exp"), str(tmp_path / "videos")
    rc, _ = _main([
        "train", "ppo", env, "--folder", folder, "--num-envs", "4", "--total-steps", str(8 * 4 * 3), "--set",
        "learner_config.algo.horizon=8", "learner_config.algo.epochs=1", "learner_config.algo.num_minibatches=1",
        "session_config.backend=cpu", "session_config.metrics.every_n_iters=1",
        "session_config.metrics.tensorboard=false", "session_config.metrics.console=false",
        "session_config.eval.every_n_iters=1", "session_config.eval.episodes=1", "session_config.eval.max_steps=10",
        "session_config.checkpoint.every_n_iters=1", "env_config.video.enabled=true",
        f'env_config.video.dir="{vdir}"', "env_config.video.every_n_episodes=1",
    ])
    assert rc == 0 and os.path.exists(os.path.join(folder, "checkpoints", "best_metric.json"))
    shutil.rmtree(vdir, ignore_errors=True)  # what training's evaluations recorded
    rc, lines = _main(["eval", folder, "--best", "--episodes", "1", "--max-steps", "30"])
    assert rc == 0
    (out,) = lines
    assert set(out) == {"eval/return", "eval/length", "eval/success", "checkpoint/iteration", "checkpoint/env_steps"}
    assert np.isfinite(out["eval/return"]) and 1 <= out["checkpoint/iteration"] <= 3
    assert [f.split(".")[0] for f in os.listdir(vdir)] == ["episode_000000"]
