"""Parity of the PyTorch port's model, PPO learner and fused train
iteration with the JAX package. Weights are converted from JAX; the
randomness JAX draws (action noise, env reset draws, epoch permutations)
is taken from JAX itself, on the keys its own code splits, and handed to
the port as explicit tensors."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.envs.base import ArraySpec as JaxArraySpec
from surreal_tpu.envs.base import EnvSpecs as JaxEnvSpecs
from surreal_tpu.envs.jax.lift import BlockLift as JaxBlockLift
from surreal_tpu.launch.rollout import init_device_carry as jax_init_device_carry
from surreal_tpu.launch.trainer import Trainer as JaxTrainer
from surreal_tpu.learners import build_learner as jax_build_learner
from surreal_tpu.learners.ppo import _block_layout
from surreal_tpu.ops import distributions as JD
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import base_config as jax_base_config
from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs
from surreal_tpu_torch.launch.rollout import device_rollout
from surreal_tpu_torch.launch.trainer import Trainer
from surreal_tpu_torch.learners import build_learner
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.utils.convert import params_from_jax

OBS, ACT = 17, 4
# learn-level bar: metrics rtol 1e-4 / atol 1e-5, params atol 1e-5.
# Sixteen Adam steps in f32 in two frameworks: sums (matmuls, means,
# global norms) are taken in another order. Adam's m/sqrt(v) divides by
# the gradient's own scale, so for a weight whose gradient is near zero
# the last-bit difference of the minibatch gradient sum becomes a
# fraction of lr (3e-4) per step; the inputs here keep every weight
# inside 1e-5, about half of it at most.
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=1e-5)


def _specs():
    f32 = np.dtype(np.float32)
    return (
        JaxEnvSpecs(obs=JaxArraySpec((OBS,), f32), action=JaxArraySpec((ACT,), f32)),
        EnvSpecs(obs=ArraySpec((OBS,), f32), action=ArraySpec((ACT,), f32)),
    )


def _learners(algo: dict):
    jspecs, tspecs = _specs()
    jl = jax_build_learner(JaxConfig(algo=JaxConfig(name="ppo", **algo)), jspecs)
    tl = build_learner(Config(algo=Config(name="ppo", **algo)), tspecs, device="cpu")
    return jl, tl


@functools.lru_cache(maxsize=1)
def _jax_init():
    """One jitted JAX PPOLearner.init shared by every test here: the state
    it builds does not depend on the knobs the tests vary (precision,
    shuffle, ppo_mode), and compiling it once is cheaper than running it
    eagerly."""
    jl, _ = _learners({"precision": "f32"})
    return jax.jit(jl.init)


def _jax_init_state(key=None):
    return _jax_init()(jax.random.key(0) if key is None else key)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _assert_params_close(t_params, j_params, **tol):
    want = params_from_jax(_np_tree(j_params))
    assert set(want) == set(t_params)
    for k, v in want.items():
        np.testing.assert_allclose(t_params[k].detach().numpy(), v.numpy(), err_msg=k, **tol)


def _assert_metrics_close(t_metrics, j_metrics, **tol):
    assert set(t_metrics) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), err_msg=k, **tol)


@pytest.mark.parametrize("precision", ["f32", "mixed", "bf16_fp8"])
def test_ppo_model_forward_matches_jax(precision):
    """Converted weights give the reference's outputs: tightly under 'f32';
    under 'mixed' and 'bf16_fp8' (the trunks' dense layers on the fp8
    path) to bf16 tolerance (both compute every layer in bf16 with
    f32 accumulation, but round the bias add and the tanh at other places:
    bf16 keeps 8 mantissa bits, ~4e-3 relative per rounding, compounded
    over three layers)."""
    jl, tl = _learners({"precision": precision})
    j_state = _jax_init_state()
    params = params_from_jax(_np_tree(j_state.params))
    obs = np.random.default_rng(0).normal(size=(5, 7, OBS)).astype(np.float32)
    j_out = jl.model.apply(j_state.params, jnp.asarray(obs))
    t_out = tl.apply(tl.state_from_params(params).params, torch.from_numpy(obs))
    tol = dict(rtol=1e-5, atol=1e-5) if precision == "f32" else dict(rtol=2e-2, atol=2e-2)
    for got, want in zip(t_out, j_out):
        assert got.dtype == torch.float32
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


def _fixed_batch(T, B, seed):
    """A learner batch with one termination and one truncation."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T, B, OBS)).astype(np.float32)
    next_obs = np.concatenate([obs[1:], rng.normal(size=(1, B, OBS))], 0).astype(np.float32)
    done = np.zeros((T, B), bool)
    done[2, 3] = done[5, 0] = True
    terminated = np.zeros((T, B), bool)
    terminated[2, 3] = True           # (5, 0) is a time-limit truncation
    next_obs[5, 0] = rng.normal(size=OBS)  # the pre-reset terminal obs
    mean = (0.3 * rng.normal(size=(T, B, ACT))).astype(np.float32)
    log_std = np.full((T, B, ACT), -0.5, np.float32)
    action = (mean + np.exp(log_std) * rng.normal(size=(T, B, ACT))).astype(np.float32)
    logp = np.asarray(JD.diag_gauss_logp(jnp.asarray(mean), jnp.asarray(log_std), jnp.asarray(action)))
    return {
        "obs": obs, "next_obs": next_obs, "action": action,
        "reward": rng.normal(size=(T, B)).astype(np.float32),
        "done": done, "terminated": terminated, "behavior_logp": logp,
        "behavior": {"mean": mean, "log_std": log_std},
    }


def _jax_epoch_perms(key, epochs, perm_domain):
    """The permutations PPOLearner._sgd_epochs draws from its learn key."""
    return np.stack([
        np.asarray(jax.random.permutation(k, perm_domain)) for k in jax.random.split(key, epochs)
    ])


def _perm_domain(N, num_mb, shuffle):
    bpm = _block_layout(N, num_mb, OBS * 4) if shuffle == "block" else 0
    return num_mb * bpm if bpm else N


@pytest.mark.parametrize("shuffle,ppo_mode,knobs", [
    pytest.param("block", "clip", {}, id="block-clip"),
    pytest.param("row", "adapt", {}, id="row-adapt"),
    # 'assoc' GAE: the reference's associative_scan against the port's
    # reverse scan, which reassociate the sum (tests/test_torch_returns.py)
    pytest.param("block", "clip", {"gae_impl": "assoc"}, id="block-clip-assoc"),
    # the scan unrolls of the reference, which change nothing in the port
    pytest.param("block", "clip", {"gae_unroll": 2, "sgd_unroll": 2}, id="block-clip-unroll2"),
])
def test_ppo_learn_matches_jax(shuffle, ppo_mode, knobs):
    """One learn from the same params, batch and epoch permutations, both
    learners built from the same algo config, at the learn-level bar."""
    T, B = 8, 16
    algo = {"precision": "f32", "shuffle": shuffle, "ppo_mode": ppo_mode, **knobs}
    jl, tl = _learners(algo)
    j_state = _jax_init_state()
    batch = _fixed_batch(T, B, seed=1)
    key = jax.random.key(2)
    j_new, j_metrics = jax.jit(jl.learn)(j_state, jax.tree.map(jnp.asarray, batch), key)

    perms = _jax_epoch_perms(key, 4, _perm_domain(T * B, 4, shuffle))
    t_state = tl.state_from_params(params_from_jax(_np_tree(j_state.params)))
    t_batch = jax.tree.map(torch.from_numpy, batch)
    t_new, t_metrics = tl.learn(t_state, t_batch, perms=torch.from_numpy(perms))

    _assert_metrics_close(t_metrics, j_metrics, **METRIC_TOL)
    _assert_params_close(t_new.params, j_new.params, **PARAM_TOL)
    assert int(t_new.iteration) == 1 and int(t_new.obs_stats.count) == T * B
    np.testing.assert_allclose(t_new.obs_stats.mean.numpy(), np.asarray(j_new.obs_stats.mean), rtol=1e-5, atol=1e-6)


def _slice_configs(tmp_path):
    shared = dict(
        learner_config=dict(algo=dict(name="ppo", horizon=16, epochs=4, num_minibatches=4, precision="f32")),
        env_config=dict(name="jax:lift", num_envs=8, time_limit=5),
        session_config=dict(folder=str(tmp_path)),
    )
    return JaxConfig(shared).extend(jax_base_config()), Config(shared).extend(base_config())


@jax.jit
def _jax_reset_draws(keys):
    """What BlockLift.reset draws from each key, as the port's [B, 5] draws."""
    state, _ = jax.vmap(JaxBlockLift().reset)(keys)
    return jnp.concatenate(
        [state.block_pos[:, :2], state.grip_pos[:, :2], state.grip_width[:, None]], axis=1
    )


@functools.partial(jax.jit, static_argnums=1)
def _jax_env_key_chain(env_keys, horizon):
    """Per step t, the key AutoReset.step splits off each env's key chain."""
    def step(keys, _):
        pair = jax.vmap(jax.random.split)(keys)
        return pair[:, 0], pair[:, 1]
    _, subs = jax.lax.scan(step, env_keys, None, length=horizon)
    return subs


def test_train_iter_slice_matches_jax(tmp_path):
    """The slice as a whole: one fused iteration (rollout + learn) on
    jax:lift in f32, B=8, T=16, time_limit=5 so envs reset mid-rollout,
    with JAX's action noise, reset draws and epoch permutations injected."""
    jcfg, tcfg = _slice_configs(tmp_path)
    jt, tt = JaxTrainer(jcfg), Trainer(tcfg, device="cpu")
    B, T = 8, 16
    key = jax.random.key(0)
    key, init_key, env_key = jax.random.split(key, 3)
    j_state = _jax_init_state(init_key)
    j_carry = jax.jit(lambda k: jax_init_device_carry(jt.env, k, B))(env_key)
    it_key = jax.random.fold_in(key, 1)

    # the draws JAX makes inside _device_train_iter, from the same keys
    ckey, lkey = jax.random.split(it_key)
    akeys = jax.vmap(lambda k: jax.random.split(k)[0])(jax.random.split(ckey, T))
    noise = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (B, ACT), jnp.float32))(akeys))
    init_subs = jax.vmap(lambda k: jax.random.split(k)[1])(jax.random.split(env_key, B))
    step_subs = _jax_env_key_chain(j_carry.env_state.key, T)
    draws = np.asarray(jax.vmap(_jax_reset_draws)(step_subs))
    perms = _jax_epoch_perms(lkey, 4, _perm_domain(T * B, 4, "block"))

    j_new, j_carry2, j_metrics = jax.jit(jt._device_train_iter)(j_state, j_carry, it_key)
    from surreal_tpu.launch.rollout import device_rollout as jax_device_rollout

    _, j_batch = jax.jit(
        lambda s, c, k: jax_device_rollout(jt.env, jt.learner, s, c, k, T)
    )(j_state, j_carry, ckey)

    t_state = tt.learner.state_from_params(params_from_jax(_np_tree(j_state.params)))
    t_carry = tt.init_loop_state(reset_draws=torch.from_numpy(np.asarray(_jax_reset_draws(init_subs))))
    np.testing.assert_allclose(t_carry.obs.numpy(), np.asarray(j_carry.obs), atol=1e-6)
    _, t_batch = device_rollout(
        tt.env, tt.learner, t_state, t_carry, T,
        action_noise=torch.from_numpy(noise), reset_draws=torch.from_numpy(draws),
    )
    t_new, t_carry2, t_metrics = tt._device_train_iter(
        t_state, t_carry, action_noise=torch.from_numpy(noise),
        reset_draws=torch.from_numpy(draws), perms=torch.from_numpy(perms),
    )

    flat_j = jax.tree_util.tree_flatten_with_path(_np_tree(j_batch))[0]
    for path, want in flat_j:
        node = t_batch
        for p in path:
            node = node[p.key]
        np.testing.assert_allclose(
            node.numpy().astype(np.float64), want.astype(np.float64), rtol=0, atol=1e-5,
            err_msg=jax.tree_util.keystr(path),
        )
    assert bool(t_batch["done"].any()) and bool((t_batch["done"] & ~t_batch["terminated"]).any())
    np.testing.assert_allclose(t_carry2.obs.numpy(), np.asarray(j_carry2.obs), atol=1e-5)

    # One op diverges, in the reference: obs dims that are constant over
    # the batch (the block's height while it rests on the table) should
    # normalize to exactly 0. The port's update_stats mean is exact there;
    # the reference's jnp.mean over (T, B) rounds, so its normalized input
    # is a constant ~1e-4 of rounding noise, and Adam, which divides by
    # the gradient's own scale, steps those first-layer weight columns by
    # up to lr per step. Those columns are held to that, and the
    # update-ratio metric, which sums every step, to 5e-2 relative.
    obs = t_batch["obs"].numpy()
    const = np.all(obs == obs[:1, :1], axis=(0, 1))
    assert const.any() and not const.all()
    lr, n_steps = 3e-4, 16
    want = params_from_jax(_np_tree(j_new.params))
    start = params_from_jax(_np_tree(j_state.params))
    got = dict(t_new.params)
    for name in ("actor.layers.0.weight", "critic.layers.0.weight"):
        np.testing.assert_array_equal(got[name][:, const].numpy(), start[name][:, const].numpy())
        assert (want[name][:, const] - got[name][:, const]).abs().max() <= lr * n_steps * 1.01
        got[name], want[name] = got[name][:, ~const], want[name][:, ~const]
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].numpy(), v.numpy(), err_msg=k, **PARAM_TOL)
    ratio = "health/update_ratio"
    np.testing.assert_allclose(float(t_metrics.pop(ratio)), float(j_metrics.pop(ratio)), rtol=5e-2)
    _assert_metrics_close(t_metrics, j_metrics, **METRIC_TOL)
