"""Parity of the PyTorch port's NutAssembly and the two device pixel envs
(``jax:nut``, ``jax:lift_pixels``, ``jax:nut_pixels``) with the JAX
package, and of one fused PPO iteration with the NatureCNN on
``jax:nut_pixels`` (BASELINE config ④'s shape).

Float states drift apart over a free run (an ulp a step from XLA's and
torch's different transcendental and norm roundings, amplified by the
contact physics), so the envs are stepped from JAX's own state at every
step of a 200-step run (teacher forcing): one step's outputs agree to
1e-5, and the rasterized pixels, which threshold float positions, bit
for bit."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.envs.jax.base import AutoReset as JaxAutoReset
from surreal_tpu.envs.jax.base import batch_step
from surreal_tpu.envs.jax.nut_assembly import NutAssembly as JaxNutAssembly
from surreal_tpu.envs.jax.pixels import BlockLiftPixels as JaxBlockLiftPixels
from surreal_tpu.envs.jax.pixels import NutAssemblyPixels as JaxNutAssemblyPixels
from surreal_tpu.launch.rollout import device_rollout as jax_device_rollout
from surreal_tpu.launch.rollout import init_device_carry as jax_init_device_carry
from surreal_tpu.launch import trainer as jax_trainer_mod
from surreal_tpu.launch.trainer import Trainer as JaxTrainer
from surreal_tpu.learners.ppo import _block_layout
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import base_config as jax_base_config
from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.envs.device.base import AutoReset
from surreal_tpu_torch.envs.device.lift import BlockLift, LiftState
from surreal_tpu_torch.envs.device.nut_assembly import PEG_HEIGHT, PEG_XY, NutAssembly, NutState
from surreal_tpu_torch.envs.device.pixels import BlockLiftPixels, NutAssemblyPixels, PixelState
from surreal_tpu_torch.launch.rollout import device_rollout
from surreal_tpu_torch.launch.trainer import Trainer
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import BASE_ENV_CONFIG, base_config
from surreal_tpu_torch.utils.convert import params_from_jax

BLOCK_HALF = 0.02
# one step of f32 contact physics from the same state (tests/test_torch_envs.py)
STEP_TOL = dict(rtol=0, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _lift_state(j) -> LiftState:
    return LiftState(*(torch.from_numpy(np.array(x)) for x in j))


def _to_port(j_state):
    """A JAX env state (LiftState, NutState or the pixel state) as the port's."""
    if hasattr(j_state, "prev"):
        return PixelState(_to_port(j_state.inner), torch.from_numpy(np.array(j_state.prev)))
    if hasattr(j_state, "threaded"):
        return NutState(_lift_state(j_state.hand), torch.from_numpy(np.array(j_state.threaded)))
    return _lift_state(j_state)


def _hand(state):
    return state.hand if hasattr(state, "hand") else state


def _scripted(state, threaded=None):
    """Reach -> grasp -> carry over the peg -> release -> retreat (the
    port's copy of tests/test_envs.py::_nut_scripted_action), batched in
    numpy over [B] states; without the peg (``threaded`` None) it lifts."""
    grip, block, width = (np.asarray(x) for x in (state.grip_pos, state.block_pos, state.grip_width))
    rel = block - grip
    d = np.linalg.norm(rel, axis=1)
    near_xy = np.linalg.norm(rel[:, :2], axis=1) < 0.01
    at_nut = d < 0.015
    vx, vy = np.clip(rel[:, 0] * 20, -1, 1), np.clip(rel[:, 1] * 20, -1, 1)
    target_z = np.where(near_xy, block[:, 2], 0.08)
    vz = np.clip((target_z - grip[:, 2]) * 20, -1, 1)
    g = np.where(at_nut, 1.0, -1.0)
    holding = (width < 0.045) & (d < 0.03)
    if threaded is None:
        vz = np.where(holding, 1.0, vz)
        vx, vy = np.where(holding, 0.0, vx), np.where(holding, 0.0, vy)
        return np.stack([vx, vy, vz, g], 1).astype(np.float32)
    hover_z = PEG_HEIGHT + BLOCK_HALF + 0.04
    to_peg = PEG_XY[None] - grip[:, :2]
    below = grip[:, 2] < hover_z - 0.005
    vx = np.where(holding, np.where(below, 0.0, np.clip(to_peg[:, 0] * 20, -1, 1)), vx)
    vy = np.where(holding, np.where(below, 0.0, np.clip(to_peg[:, 1] * 20, -1, 1)), vy)
    vz = np.where(holding, np.where(below, 1.0, 0.0), vz)
    over = (np.linalg.norm(block[:, :2] - PEG_XY[None], axis=1) < 0.010) & (block[:, 2] > BLOCK_HALF + 0.01)
    vx, vy, vz, g = (np.where(over, v, x) for x, v in ((vx, 0.0), (vy, 0.0), (vz, 0.0), (g, -1.0)))
    threaded = np.asarray(threaded)
    vx, vy, vz, g = (np.where(threaded, v, x) for x, v in ((vx, 0.0), (vy, 0.0), (vz, 1.0), (g, -1.0)))
    return np.stack([vx, vy, vz, g], 1).astype(np.float32)


ENVS = {
    "nut": (JaxNutAssembly, NutAssembly),
    "lift_pixels": (JaxBlockLiftPixels, BlockLiftPixels),
    "nut_pixels": (JaxNutAssemblyPixels, NutAssemblyPixels),
}


@pytest.mark.parametrize("name", sorted(ENVS))
def test_env_steps_from_jax_state_match(name):
    """200 steps of 8 envs under the scripted policy (half of them with
    noise on the actions, some beyond [-1, 1]), each step taken by the port
    from JAX's state: states, obs and rewards at 1e-5, dones and the
    success / grasp / threading flags equal, pixels bit-equal. The run
    grasps, and on the nut threads, so every physics branch is taken."""
    jax_cls, port_cls = ENVS[name]
    B = 8
    j_env, t_env = jax_cls(), port_cls("cpu")
    j_state, j_obs = jax.jit(jax.vmap(j_env.reset))(jax.random.split(jax.random.key(5), B))
    step = jax.jit(jax.vmap(j_env.step))
    rng = np.random.default_rng(0)
    noisy = np.arange(B) % 2 == 1
    seen = {"grasped": 0, "threaded": 0}
    for t in range(200):
        inner = getattr(j_state, "inner", j_state)
        action = _scripted(_hand(inner), getattr(inner, "threaded", None) if "nut" in name else None)
        action = np.where(noisy[:, None], action + rng.normal(0, 0.6, action.shape), action).astype(np.float32)
        t_out = t_env.step(_to_port(j_state), torch.from_numpy(action))
        j_state, j_obs, j_rew, j_done, j_info = step(j_state, jnp.asarray(action))
        t_state, t_obs, t_rew, t_done, t_info = t_out
        got, want = [x.numpy() for x in jax.tree.leaves(t_state)], jax.tree.leaves(_np_tree(j_state))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            if b.dtype.kind == "f":
                np.testing.assert_allclose(a, b, err_msg=f"state, step {t}", **STEP_TOL)
            else:
                np.testing.assert_array_equal(a, b, err_msg=f"state, step {t}")
        if name.endswith("pixels"):
            np.testing.assert_array_equal(t_obs.numpy(), np.asarray(j_obs), err_msg=f"pixels, step {t}")
            assert t_obs.dtype == torch.uint8 and t_obs.shape == (B, 64, 64, 4)
        else:
            np.testing.assert_allclose(t_obs.numpy(), np.asarray(j_obs), err_msg=f"obs, step {t}", **STEP_TOL)
        np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), err_msg=f"reward, step {t}", **STEP_TOL)
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
        for k in ("success", "grasped", "threaded"):
            if k in j_info:
                np.testing.assert_array_equal(t_info[k].numpy(), np.asarray(j_info[k]), err_msg=f"{k}, step {t}")
        seen["grasped"] += int(np.asarray(j_info["grasped"]).sum())
        seen["threaded"] += int(np.asarray(j_info.get("threaded", False)).sum())
    assert seen["grasped"] > 0
    assert (seen["threaded"] > 0) == ("nut" in name)


@functools.partial(jax.jit, static_argnums=0)
def _jax_reset_draws(env_cls, keys):
    """What the manipulation envs' reset draws from each key, as the port's
    [B, 5] draws (object xy, hand xy, finger opening)."""
    state, _ = jax.vmap(env_cls().reset)(keys)
    hand = _hand(getattr(state, "inner", state))
    return jnp.concatenate([hand.block_pos[:, :2], hand.grip_pos[:, :2], hand.grip_width[:, None]], axis=1)


@functools.partial(jax.jit, static_argnums=1)
def _jax_env_key_chain(env_keys, horizon):
    """Per step t, the key AutoReset.step splits off each env's key chain."""
    def step(keys, _):
        pair = jax.vmap(jax.random.split)(keys)
        return pair[:, 0], pair[:, 1]
    _, subs = jax.lax.scan(step, env_keys, None, length=horizon)
    return subs


def test_nut_pixels_autoreset_matches_jax():
    """Through AutoReset (time limit 30, 70 steps): the nested pixel state
    is selected leaf by leaf at the resets, and obs, rewards, dones,
    truncations and terminal obs match JAX's with its reset draws."""
    B, T, limit = 4, 70, 30
    j_env = JaxAutoReset(JaxNutAssemblyPixels(), time_limit=limit)
    t_env = AutoReset(NutAssemblyPixels("cpu"), time_limit=limit)
    keys = jax.random.split(jax.random.key(3), B)
    j_state, j_obs = jax.jit(jax.vmap(j_env.reset))(keys)
    init_subs = jax.vmap(lambda k: jax.random.split(k)[1])(keys)
    t_state, t_obs = t_env.reset(B, draws=torch.from_numpy(np.array(_jax_reset_draws(JaxNutAssemblyPixels, init_subs))))
    np.testing.assert_array_equal(t_obs.numpy(), np.asarray(j_obs))
    step = jax.jit(lambda s, a: batch_step(j_env, s, a))
    rng = np.random.default_rng(2)
    for t in range(T):
        subs = jax.vmap(lambda k: jax.random.split(k)[1])(j_state.key)
        draws = torch.from_numpy(np.array(_jax_reset_draws(JaxNutAssemblyPixels, subs)))
        action = rng.uniform(-1, 1, (B, 4)).astype(np.float32)
        t_state = t_state._replace(env_state=_to_port(j_state.env_state))  # teacher forcing
        j_state, j_obs, j_rew, j_done, j_info = step(j_state, jnp.asarray(action))
        t_state, t_obs, t_rew, t_done, t_info = t_env.step(t_state, torch.from_numpy(action), reset_draws=draws)
        np.testing.assert_array_equal(t_obs.numpy(), np.asarray(j_obs), err_msg=f"step {t}")
        np.testing.assert_array_equal(t_info["terminal_obs"].numpy(), np.asarray(j_info["terminal_obs"]))
        np.testing.assert_allclose(t_rew.numpy(), np.asarray(j_rew), **STEP_TOL)
        np.testing.assert_array_equal(t_done.numpy(), np.asarray(j_done))
        np.testing.assert_array_equal(t_info["truncated"].numpy(), np.asarray(j_info["truncated"]))
        np.testing.assert_array_equal(t_state.step_count.numpy(), np.asarray(j_state.step_count))
        if t == limit - 1:
            assert bool(t_done.all())


def test_nut_scripted_policy_threads_and_succeeds():
    """The port's copy of tests/test_envs.py::test_nut_scripted_policy_threads_and_succeeds:
    from JAX's reset of key 5, the scripted policy grasps the nut, carries
    it over the peg and releases it; it threads, rests at the base
    (success) and scores more than 250 over the episode."""
    env = NutAssembly("cpu")
    state, _ = env.reset(1, draws=torch.from_numpy(np.array(_jax_reset_draws(JaxNutAssembly, jax.random.key(5)[None]))))
    total = 0.0
    for _ in range(200):
        action = _scripted(state.hand, state.threaded.numpy())
        state, _, reward, _, info = env.step(state, torch.from_numpy(action))
        total += float(reward[0])
    assert bool(info["threaded"][0]) and bool(info["success"][0])
    assert total > 250.0


def test_nut_cannot_thread_by_table_slide():
    """The airborne gate: a nut resting at the peg's xy does not thread."""
    env = NutAssembly("cpu")
    state, _ = env.reset(1, generator=torch.Generator().manual_seed(0))
    hand = state.hand._replace(
        block_pos=torch.tensor([[float(PEG_XY[0]), float(PEG_XY[1]), BLOCK_HALF]]),
        block_vel=torch.zeros(1, 3),
        grip_pos=torch.tensor([[-0.2, -0.2, 0.3]]),
    )
    state = NutState(hand, torch.zeros(1, dtype=torch.bool))
    for _ in range(20):
        state, _, _, _, info = env.step(state, torch.zeros(1, 4))
    assert not bool(info["threaded"][0]) and not bool(info["success"][0])


def test_make_env_builds_nut_envs():
    for name, cls, shape in (("jax:nut", NutAssembly, (20,)), ("jax:lift_pixels", BlockLiftPixels, (64, 64, 4)),
                             ("jax:nut_pixels", NutAssemblyPixels, (64, 64, 4))):
        env = make_env(Config(name=name).extend(BASE_ENV_CONFIG), device="cpu")
        assert isinstance(env.env, cls) and env.time_limit == 200 and env.specs.obs.shape == shape
        state, obs = env.reset(3, generator=torch.Generator().manual_seed(0))
        state, obs, *_ = env.step(state, torch.zeros(3, 4), torch.Generator().manual_seed(1))
        assert obs.shape == (3, *shape)
    assert isinstance(BlockLiftPixels("cpu").inner, BlockLift)


# -- one fused PPO iteration on jax:nut_pixels --------------------------------

NUT_CNN = dict(enabled=True, channels=[8, 16, 16], dense=32)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)  # the learn-level bars (tests/test_torch_ppo.py)
PARAM_TOL = dict(rtol=0, atol=1e-5)


def _nut_pixels_configs(tmp_path, precision="f32"):
    shared = dict(
        learner_config=dict(algo=dict(name="ppo", horizon=8, epochs=2, num_minibatches=2, precision=precision),
                            model=dict(cnn=NUT_CNN)),
        env_config=dict(name="jax:nut_pixels", num_envs=8, time_limit=5),
        session_config=dict(folder=str(tmp_path)),
    )
    return JaxConfig(shared).extend(jax_base_config()), Config(shared).extend(base_config())


def test_nut_pixels_ppo_iteration_matches_jax(tmp_path):
    """One fused iteration (rollout + PPO learn) on jax:nut_pixels in f32
    with a narrow NatureCNN, B=8, T=8, time limit 5 so envs reset
    mid-rollout, with JAX's action noise, reset draws and epoch
    permutations injected: the pixels bit-equal, the rest of the batch at
    1e-5, the params and metrics at the learn-level bars."""
    jcfg, tcfg = _nut_pixels_configs(tmp_path)
    jt, tt = JaxTrainer(jcfg), Trainer(tcfg, device="cpu")
    B, T = 8, 8
    key = jax.random.key(0)
    key, init_key, env_key = jax.random.split(key, 3)
    j_state = jax.jit(jt.learner.init)(init_key)
    it_key = jax.random.fold_in(key, 1)
    bpm = _block_layout(T * B, 2, 64 * 64 * 4)
    domain = 2 * bpm if bpm else T * B

    @jax.jit
    def reference(j_state):
        """JAX's side in one program: the carry, the iteration
        (``_device_train_iter``) with the batch its rollout made, and the
        draws the port is handed (action noise, reset draws, epoch
        permutations)."""
        j_carry = jax_init_device_carry(jt.env, env_key, B)
        batches = []

        def rollout(*a, **kw):
            out = jax_device_rollout(*a, **kw)
            batches.append(out[1])
            return out

        real, jax_trainer_mod.device_rollout = jax_trainer_mod.device_rollout, rollout
        try:
            j_new, j_carry2, j_metrics = jt._device_train_iter(j_state, j_carry, it_key)
        finally:
            jax_trainer_mod.device_rollout = real
        ckey, lkey = jax.random.split(it_key)
        akeys = jax.vmap(lambda k: jax.random.split(k)[0])(jax.random.split(ckey, T))
        noise = jax.vmap(lambda k: jax.random.normal(k, (B, 4), jnp.float32))(akeys)
        init_subs = jax.vmap(lambda k: jax.random.split(k)[1])(jax.random.split(env_key, B))
        step_subs = _jax_env_key_chain(j_carry.env_state.key, T)
        draws = jax.vmap(lambda k: _jax_reset_draws(JaxNutAssemblyPixels, k))(step_subs)
        perms = jnp.stack([jax.random.permutation(k, domain) for k in jax.random.split(lkey, 2)])
        return (j_carry, j_new, j_carry2, j_metrics, batches[0], noise,
                _jax_reset_draws(JaxNutAssemblyPixels, init_subs), draws, perms)

    j_carry, j_new, j_carry2, j_metrics, j_batch, noise, init_draws, draws, perms = reference(j_state)

    t_state = tt.learner.state_from_params(params_from_jax(_np_tree(j_state.params)))
    t_carry = tt.init_loop_state(reset_draws=torch.from_numpy(np.array(init_draws)))
    np.testing.assert_array_equal(t_carry.obs.numpy(), np.asarray(j_carry.obs))
    inject = dict(action_noise=torch.from_numpy(np.array(noise)), reset_draws=torch.from_numpy(np.array(draws)))
    _, t_batch = device_rollout(tt.env, tt.learner, t_state, t_carry, T, **inject)
    t_new, t_carry2, t_metrics = tt._device_train_iter(t_state, t_carry, perms=torch.from_numpy(np.array(perms)), **inject)

    for path, want in jax.tree_util.tree_flatten_with_path(_np_tree(j_batch))[0]:
        node = t_batch
        for p in path:
            node = node[p.key]
        name = jax.tree_util.keystr(path)
        if want.dtype == np.uint8 or want.dtype == bool:
            np.testing.assert_array_equal(node.numpy(), want, err_msg=name)
        else:
            np.testing.assert_allclose(node.numpy(), want, rtol=0, atol=1e-5, err_msg=name)
    assert bool(t_batch["done"].any()) and not bool(t_batch["terminated"].any())
    np.testing.assert_array_equal(t_carry2.obs.numpy(), np.asarray(j_carry2.obs))
    want = params_from_jax(_np_tree(j_new.params))
    for k, v in want.items():
        np.testing.assert_allclose(t_new.params[k].numpy(), v.numpy(), err_msg=k, **PARAM_TOL)
    ratio = "health/update_ratio"
    np.testing.assert_allclose(float(t_metrics.pop(ratio)), float(j_metrics.pop(ratio)), rtol=5e-2)
    assert set(t_metrics) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), err_msg=k, **METRIC_TOL)


def test_nut_pixels_mixed_forward_matches_jax(tmp_path):
    """The 'mixed' forward of the CNN policy on nut pixels (bf16 compute,
    f32 params) within 2e-2 of JAX's, as for the other memoryless models."""
    jcfg, tcfg = _nut_pixels_configs(tmp_path, "mixed")
    jt, tt = JaxTrainer(jcfg), Trainer(tcfg, device="cpu")
    j_state = jax.jit(jt.learner.init)(jax.random.key(1))
    t_state = tt.learner.state_from_params(params_from_jax(_np_tree(j_state.params)))
    j_carry = jax.jit(lambda k: jax_init_device_carry(jt.env, k, 16))(jax.random.key(2))
    obs = np.asarray(j_carry.obs)
    _, j_info = jax.jit(lambda s, o: jt.learner.act(s, o, jax.random.key(0), "eval_deterministic"))(j_state, obs)
    _, t_info = tt.learner.act(t_state, torch.from_numpy(obs), "eval_deterministic")
    for k in ("mean", "value", "logp"):
        np.testing.assert_allclose(t_info[k].float().numpy(), np.asarray(j_info[k], np.float32), rtol=2e-2,
                                   atol=2e-2, err_msg=k)


@pytest.mark.slow
def test_ppo_learns_on_nut(tmp_path):
    """The port's mirror of tests/test_envs.py::test_ppo_learns_on_nut:
    fused PPO on jax:nut (256 envs x 64 steps, 4 x 4) clearly learns the
    reach / grasp / carry shaping, an episode return of 200, within
    10,000,000 env steps."""
    cfg = Config(
        learner_config=Config(algo=Config(name="ppo", horizon=64, epochs=4, num_minibatches=4)),
        env_config=Config(name="jax:nut", num_envs=256),
        session_config=Config(
            folder=str(tmp_path), total_env_steps=10_000_000,
            metrics=Config(every_n_iters=10, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
        ),
    ).extend(base_config())
    best = {"ret": float("-inf")}

    def cb(it, m):
        r = m.get("episode/return", float("nan"))
        if r == r:
            best["ret"] = max(best["ret"], r)
        return best["ret"] >= 200.0

    Trainer(cfg, device="cpu").run(on_metrics=cb)
    assert best["ret"] >= 200.0, f"best nut return {best['ret']} < 200"


@pytest.mark.slow
def test_ppo_cheetah_run_improves(tmp_path):
    """The port's mirror of tests/test_ppo.py::test_ppo_cheetah_run_improves
    (BASELINE config (2) through the host loop): PPO on dm_control
    cheetah-run, 16 envs, horizon 128, seed 3, 150,000 env steps; the late
    episode returns beat the early ones by more than 5 and by a factor of
    two."""
    cfg = Config(
        learner_config=Config(algo=Config(name="ppo", horizon=128, epochs=4)),
        env_config=Config(name="dm_control:cheetah-run", num_envs=16),
        session_config=Config(
            folder=str(tmp_path), seed=3, total_env_steps=150_000,
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
        ),
    ).extend(base_config())
    returns = []
    Trainer(cfg, device="cpu").run(on_metrics=lambda it, m: returns.append(m.get("episode/return", np.nan)))
    returns = np.asarray(returns, np.float64)
    valid = returns[np.isfinite(returns)]
    assert len(valid) >= 10, f"too few completed episodes: {returns}"
    early = valid[: max(3, len(valid) // 4)].mean()
    late = valid[-max(3, len(valid) // 4):].mean()
    assert late > early + 5.0 and late > 2 * early, f"no improvement on cheetah-run: early {early:.1f} -> late {late:.1f}"
