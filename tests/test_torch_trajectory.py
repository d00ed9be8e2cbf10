"""Parity of the PyTorch port's trajectory-policy path with the JAX
package: the sequence learns of PPO (``_learn_seq``) and IMPALA,
discrete-action PPO and PPO's ``value_bootstrap='shared'``, one fused
trajectory iteration (KV-cached acting on ``jax:pendulum``, then the
sequence learn) against JAX's ``_device_train_iter``, and the port's own
mirrors of ``tests/test_trajectory_policy.py`` (acting against learn
conditioning, kv against padded acting, the guards).

Weights are carried over by ``utils/convert.py``; the randomness JAX draws
(epoch permutations, action noise, reset draws) is taken from JAX itself,
on the keys its own code splits, and handed to the port as tensors.

Learn-level bar, as in tests/test_torch_ppo.py: metrics rtol 1e-4 / atol
1e-5, params atol 1e-5, in f32. The transformer's sums (matmuls, the
softmax's, LayerNorm's and the means) are taken in another order in the
two frameworks; Adam divides each gradient by its own scale, so a weight
whose gradient is near zero moves by a fraction of lr on a last-bit
difference. The inputs here keep every weight inside 1e-5."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.envs.base import ArraySpec as JaxArraySpec
from surreal_tpu.envs.base import DiscreteSpec as JaxDiscreteSpec
from surreal_tpu.envs.base import EnvSpecs as JaxEnvSpecs
from surreal_tpu.envs.jax.pendulum import Pendulum as JaxPendulum
from surreal_tpu.launch.rollout import device_rollout as jax_device_rollout
from surreal_tpu.launch.rollout import init_device_carry as jax_init_device_carry
from surreal_tpu.launch.trainer import Trainer as JaxTrainer
from surreal_tpu.learners import build_learner as jax_build_learner
from surreal_tpu.learners.ppo import _block_layout
from surreal_tpu.ops import distributions as JD
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import base_config as jax_base_config
from surreal_tpu_torch.envs.base import ArraySpec, DiscreteSpec, EnvSpecs
from surreal_tpu_torch.launch.evaluator import Evaluator
from surreal_tpu_torch.launch.rollout import device_rollout
from surreal_tpu_torch.launch.trainer import Trainer
from surreal_tpu_torch.learners import build_learner
from surreal_tpu_torch.ops import distributions as D
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.utils.convert import (
    categorical_params_from_jax,
    params_from_jax,
    trajectory_categorical_params_from_jax,
    trajectory_params_from_jax,
)

METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=1e-5)
OBS, ACT, N_ACTIONS = 5, 2, 3
ENC = dict(kind="trajectory", features=32, num_layers=2, num_heads=2, head_dim=8, max_len=16)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _specs(discrete: bool):
    f32 = np.dtype(np.float32)
    if discrete:
        return (
            JaxEnvSpecs(obs=JaxArraySpec((OBS,), f32), action=JaxDiscreteSpec((), np.dtype(np.int32), n=N_ACTIONS)),
            EnvSpecs(obs=ArraySpec((OBS,), f32), action=DiscreteSpec((), np.dtype(np.int32), n=N_ACTIONS)),
        )
    return (
        JaxEnvSpecs(obs=JaxArraySpec((OBS,), f32), action=JaxArraySpec((ACT,), f32)),
        EnvSpecs(obs=ArraySpec((OBS,), f32), action=ArraySpec((ACT,), f32)),
    )


def _learners(algo: dict, discrete: bool, model: dict | None = None):
    tree = dict(algo=algo, model=model if model is not None else dict(encoder=ENC))
    jspecs, tspecs = _specs(discrete)
    return jax_build_learner(JaxConfig(tree), jspecs), build_learner(Config(tree), tspecs, device="cpu")


def _converter(jl):
    if jl.seq_policy:
        return trajectory_categorical_params_from_jax if jl.discrete else trajectory_params_from_jax
    return categorical_params_from_jax if jl.discrete else params_from_jax


def _params(jl, seed):
    """The tree flax's init builds, filled with N(0, 1/fan_in) draws and
    LayerNorm scales around 1, so that logits, values and the importance
    ratios are all far from their trivial values."""
    shape = jl.specs.obs.shape
    obs = jnp.zeros((1, 1, *shape) if jl.seq_policy else (1, *shape), jnp.float32)
    shapes = jax.eval_shape(jl.model.init, jax.random.key(0), obs)
    rng = np.random.default_rng(seed)

    def draw(path, leaf):
        name = jax.tree_util.keystr(path)
        if name.endswith("['scale']"):
            return (1.0 + 0.2 * rng.normal(size=leaf.shape)).astype(np.float32)
        if name.endswith("['log_std']"):
            return np.full(leaf.shape, -0.5, np.float32)
        fan_in = leaf.shape[0] if len(leaf.shape) > 1 else 8
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _states(jl, tl, seed=4):
    params = _params(jl, seed)
    j_state = jax.jit(jl.init)(jax.random.key(0))
    j_state = j_state._replace(params=params, opt_state=jl.tx.init(params))
    return j_state, tl.state_from_params(_converter(jl)(params))


def _batch(T, B, discrete, seed):
    """A learner batch with one termination and one mid-segment
    truncation, behaviour log-probs 0.3 off the behaviour head's."""
    rng = np.random.default_rng(seed)
    obs = rng.normal(size=(T + 1, B, OBS)).astype(np.float32)
    next_obs = obs[1:].copy()
    next_obs[5, 0] = rng.normal(size=OBS)  # the pre-reset terminal obs of a truncation
    if discrete:
        behavior = {"logits": rng.normal(size=(T, B, N_ACTIONS)).astype(np.float32)}
        action = rng.integers(0, N_ACTIONS, (T, B)).astype(np.int32)
        logp = np.asarray(JD.categorical_logp(jnp.asarray(behavior["logits"]), jnp.asarray(action)))
    else:
        mean = (0.3 * rng.normal(size=(T, B, ACT))).astype(np.float32)
        log_std = np.full((T, B, ACT), -0.5, np.float32)
        action = (mean + np.exp(log_std) * rng.normal(size=(T, B, ACT))).astype(np.float32)
        behavior = {"mean": mean, "log_std": log_std}
        logp = np.asarray(JD.diag_gauss_logp(*map(jnp.asarray, (mean, log_std, action))))
    done = np.zeros((T, B), bool)
    done[2, 3] = done[5, 0] = True
    terminated = np.zeros((T, B), bool)
    terminated[2, 3] = True
    return {
        "obs": obs[:-1], "next_obs": next_obs, "action": action,
        "reward": rng.normal(size=(T, B)).astype(np.float32),
        "done": done, "terminated": terminated,
        "behavior_logp": (logp + 0.3 * rng.normal(size=(T, B))).astype(np.float32),
        "behavior": behavior,
    }


def _jax_epoch_perms(key, epochs, perm_domain):
    """The permutations PPOLearner._sgd_epochs draws from its learn key."""
    return np.stack([
        np.asarray(jax.random.permutation(k, perm_domain)) for k in jax.random.split(key, epochs)
    ])


def _perm_domain(domain, num_mb, row_bytes):
    bpm = _block_layout(domain, num_mb, row_bytes)
    return num_mb * bpm if bpm else domain


def _assert_params_close(t_params, j_params, convert, lr=None, steps=0, **tol):
    """Params at ``tol``, except the attention layers' key biases when
    ``steps`` Adam steps of ``lr`` were taken: a key bias adds q.b_k to
    every score of a query's row, which the softmax cancels, so its
    gradient is zero in exact arithmetic and both frameworks hand Adam
    rounding noise, which it steps by up to lr whatever its size. Those
    are held to lr * steps."""
    want = convert(_np_tree(j_params))
    assert set(want) == set(t_params)
    for k, v in want.items():
        got = t_params[k].detach().numpy()
        if steps and k.endswith(".k.bias"):
            assert np.abs(got - v.numpy()).max() <= lr * steps * 1.01, k
            continue
        np.testing.assert_allclose(got, v.numpy(), err_msg=k, **tol)


def _assert_metrics_close(t_metrics, j_metrics, **tol):
    assert set(t_metrics) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), err_msg=k, **tol)


PPO_CASES = [
    # the sequence learn: extended [B, T+1] pass, env-wise minibatches
    pytest.param(True, False, {}, id="seq-continuous"),
    pytest.param(True, True, {}, id="seq-discrete"),
    pytest.param(True, False, {"gae_impl": "assoc"}, id="seq-continuous-assoc"),
    pytest.param(True, True, {"shuffle": "row", "ppo_mode": "adapt"}, id="seq-discrete-row-adapt"),
    # the memoryless learn: discrete actions, and the shared bootstrap
    pytest.param(False, True, {}, id="discrete"),
    pytest.param(False, False, {"value_bootstrap": "shared"}, id="shared"),
    pytest.param(False, True, {"value_bootstrap": "shared", "shuffle": "row"}, id="discrete-shared-row"),
]


@pytest.mark.parametrize("seq,discrete,knobs", PPO_CASES)
def test_ppo_learn_matches_jax(seq, discrete, knobs):
    """One learn from the same params, batch and epoch permutations, both
    learners built from the same config, at the learn-level bar."""
    T, B, epochs, num_mb = 8, 16, 2, 2
    algo = dict(name="ppo", precision="f32", horizon=T, epochs=epochs, num_minibatches=num_mb, **knobs)
    model = dict(encoder=ENC) if seq else dict(actor_hidden=(32, 32), critic_hidden=(32, 32))
    jl, tl = _learners(algo, discrete, model)
    assert jl.seq_policy == tl.seq_policy == seq and tl.discrete == discrete
    j_state, t_state = _states(jl, tl)
    batch = _batch(T, B, discrete, seed=1)
    key = jax.random.key(2)
    j_new, j_metrics = jax.jit(jl.learn)(j_state, jax.tree.map(jnp.asarray, batch), key)

    # the reference's row bytes: sequence rows are whole segments [T, ...]
    width = max(OBS, N_ACTIONS if discrete else ACT) * 4
    domain, row_bytes = (B, T * width) if seq else (T * B, width)
    shuffle = knobs.get("shuffle", "block")
    perm_domain = _perm_domain(domain, num_mb, row_bytes) if shuffle == "block" else domain
    perms = _jax_epoch_perms(key, epochs, perm_domain)
    t_new, t_metrics = tl.learn(t_state, jax.tree.map(torch.from_numpy, batch), perms=torch.from_numpy(perms))

    _assert_metrics_close(t_metrics, j_metrics, **METRIC_TOL)
    steps = epochs * num_mb if seq else 0
    _assert_params_close(t_new.params, j_new.params, _converter(jl), lr=3e-4, steps=steps, **PARAM_TOL)
    assert int(t_new.iteration) == 1 and int(t_new.obs_stats.count) == T * B
    np.testing.assert_allclose(t_new.obs_stats.mean.numpy(), np.asarray(j_new.obs_stats.mean), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("discrete,knobs", [
    pytest.param(True, {}, id="discrete"),
    pytest.param(False, {}, id="continuous"),
    pytest.param(True, {"vtrace_impl": "assoc"}, id="discrete-assoc"),
])
def test_impala_seq_learn_matches_jax(discrete, knobs):
    """IMPALA's sequence learn (one extended [B, T+1] pass, V-trace's
    bootstrap from the shifted values, one Adam step) against JAX's."""
    T, B = 8, 6
    jl, tl = _learners(dict(name="impala", precision="f32", horizon=T, **knobs), discrete)
    assert tl.seq_policy and tl.requires_act_carry
    j_state, t_state = _states(jl, tl)
    batch = _batch(T, B, discrete, seed=3)
    j_new, j_metrics = jax.jit(jl.learn)(j_state, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
    t_new, t_metrics = tl.learn(t_state, jax.tree.map(torch.from_numpy, batch))
    assert 0.0 < float(t_metrics["policy/rho_mean"]) != 1.0
    _assert_metrics_close(t_metrics, j_metrics, **METRIC_TOL)
    _assert_params_close(t_new.params, j_new.params, _converter(jl), lr=6e-4, steps=1, **PARAM_TOL)
    assert int(t_new.iteration) == 1 and int(t_new.opt_state.count) == 1


# -- one fused iteration: kv acting on jax:pendulum, then the sequence learn --

def _slice_configs(folder, B, T, limit):
    shared = dict(
        learner_config=dict(
            algo=dict(name="ppo", horizon=T, epochs=2, num_minibatches=2, precision="f32"),
            model=dict(encoder=dict(ENC, max_len=T + 1)),
        ),
        env_config=dict(name="jax:pendulum", num_envs=B, time_limit=limit),
        session_config=dict(folder=folder),
    )
    return JaxConfig(shared).extend(jax_base_config()), Config(shared).extend(base_config())


@jax.jit
def _pendulum_draws(keys):
    """What Pendulum.reset draws from each key, as the port's [B, 2]."""
    state, _ = jax.vmap(JaxPendulum().reset)(keys)
    return jnp.stack([state.theta, state.theta_dot], axis=1)


@functools.partial(jax.jit, static_argnums=1)
def _jax_env_key_chain(env_keys, horizon):
    """Per step t, the key AutoReset.step splits off each env's key chain."""
    def step(keys, _):
        pair = jax.vmap(jax.random.split)(keys)
        return pair[:, 0], pair[:, 1]
    _, subs = jax.lax.scan(step, env_keys, None, length=horizon)
    return subs


def test_trajectory_train_iter_slice_matches_jax(tmp_path):
    """The slice as a whole: one fused iteration of PPO with the trajectory
    transformer on jax:pendulum in f32, B=8, T=12, time limit 5 (envs reset
    mid-segment), kv acting, with JAX's action noise, reset draws and epoch
    permutations injected. The rollout batch is held to 1e-5 (sin and cos
    are an ulp apart between XLA and torch, tests/test_torch_control_envs.py),
    the learn to the learn-level bar."""
    B, T = 8, 12
    jcfg, tcfg = _slice_configs(str(tmp_path), B, T, limit=5)
    jt, tt = JaxTrainer(jcfg), Trainer(tcfg, device="cpu")
    assert tt.learner.seq_policy and tt.learner.config.model.encoder.act_impl == "kv"
    key = jax.random.key(0)
    key, init_key, env_key = jax.random.split(key, 3)
    j_state = jax.jit(jt.learner.init)(init_key)
    params = _params(jt.learner, seed=5)
    j_state = j_state._replace(params=params, opt_state=jt.learner.tx.init(params))
    j_carry = jax.jit(lambda k: jax_init_device_carry(jt.env, k, B))(env_key)
    it_key = jax.random.fold_in(key, 1)

    # the draws JAX makes inside _device_train_iter, from the same keys
    ckey, lkey = jax.random.split(it_key)
    akeys = jax.vmap(lambda k: jax.random.split(k)[0])(jax.random.split(ckey, T))
    noise = np.asarray(jax.vmap(lambda k: jax.random.normal(k, (B, 1), jnp.float32))(akeys))
    init_subs = jax.vmap(lambda k: jax.random.split(k)[1])(jax.random.split(env_key, B))
    draws = np.asarray(jax.vmap(_pendulum_draws)(_jax_env_key_chain(j_carry.env_state.key, T)))
    perm_domain = _perm_domain(B, 2, T * OBS * 4)
    perms = _jax_epoch_perms(lkey, 2, perm_domain)

    j_new, j_carry2, j_metrics = jax.jit(jt._device_train_iter)(j_state, j_carry, it_key)
    _, j_batch = jax.jit(lambda s, c, k: jax_device_rollout(jt.env, jt.learner, s, c, k, T))(j_state, j_carry, ckey)

    t_state = tt.learner.state_from_params(trajectory_params_from_jax(params))
    t_carry = tt.init_loop_state(reset_draws=torch.from_numpy(np.asarray(_pendulum_draws(init_subs))))
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
    assert bool(t_batch["done"].any()) and not bool(t_batch["terminated"].any())
    np.testing.assert_allclose(t_carry2.obs.numpy(), np.asarray(j_carry2.obs), atol=1e-5)
    _assert_metrics_close(t_metrics, j_metrics, **METRIC_TOL)
    _assert_params_close(t_new.params, j_new.params, trajectory_params_from_jax, lr=3e-4, steps=4, **PARAM_TOL)


# -- the port's mirrors of tests/test_trajectory_policy.py ---------------------
# These hold the port against itself, under the default 'mixed' policy:
# acting (the kv decode or the padded form) and the learn's whole-segment
# pass run in bf16 under two program shapes, so the bar is bf16's mantissa
# (3e-2), as in the reference's tests.

SEQ_ENC = dict(kind="trajectory", features=32, num_layers=1, num_heads=2, head_dim=8)


def _seq_learner(horizon=8, discrete=False, algo="ppo", act_impl="kv"):
    _, specs = _specs(discrete)
    extra = dict(epochs=2, num_minibatches=2) if algo == "ppo" else {}
    cfg = Config(
        algo=Config(name=algo, horizon=horizon, **extra),
        model=Config(encoder=Config(SEQ_ENC, act_impl=act_impl)),
    )
    return build_learner(cfg, specs, device="cpu")


def _act_through(learner, state, obs_seq, seed):
    carry = learner.act_init(obs_seq.shape[1])
    g = torch.Generator().manual_seed(seed)
    logps, actions = [], []
    for t in range(obs_seq.shape[0]):
        a, info, carry = learner.act_step(state, carry, obs_seq[t], "training", g)
        actions.append(a)
        logps.append(info["logp"])
    return torch.stack(logps), torch.stack(actions)


def _learn_logp(learner, state, obs_seq, acts):
    out = learner.apply(state.params, learner._norm_obs(state.obs_stats, obs_seq).transpose(0, 1))
    if learner.discrete:
        return D.categorical_logp(out.logits.transpose(0, 1), acts)
    return D.diag_gauss_logp(out.mean.transpose(0, 1), out.log_std.transpose(0, 1), acts)


@pytest.mark.parametrize("discrete", [False, True])
def test_act_step_matches_learn_conditioning(discrete):
    """The ratio contract: stepping through act_step reproduces, position
    by position, the behaviour log-probs the learner recomputes from one
    whole-segment pass."""
    T, B = 8, 4
    learner = _seq_learner(horizon=T, discrete=discrete)
    state = learner.init(torch.Generator().manual_seed(0))
    obs_seq = torch.randn((T, B, OBS), generator=torch.Generator().manual_seed(1))
    act_logp, acts = _act_through(learner, state, obs_seq, seed=100)
    torch.testing.assert_close(act_logp, _learn_logp(learner, state, obs_seq, acts), atol=3e-2, rtol=3e-2)


def test_impala_seq_act_matches_learn_conditioning():
    """V-trace's rho = exp(target_logp - behaviour_logp) contract for
    IMPALA's trajectory policy."""
    T, B = 8, 4
    learner = _seq_learner(horizon=T, discrete=True, algo="impala")
    assert learner.seq_policy and learner.requires_act_carry
    state = learner.init(torch.Generator().manual_seed(0))
    obs_seq = torch.randn((T, B, OBS), generator=torch.Generator().manual_seed(1))
    act_logp, acts = _act_through(learner, state, obs_seq, seed=100)
    torch.testing.assert_close(act_logp, _learn_logp(learner, state, obs_seq, acts), atol=3e-2, rtol=3e-2)


@pytest.mark.parametrize("discrete", [False, True])
def test_kv_decode_matches_padded_acting(discrete):
    """act_impl='kv' reproduces the padded form position by position, with
    the same params, draws and obs, across a segment wrap (1.5 segments)."""
    T, B = 6, 3
    kv = _seq_learner(horizon=T, discrete=discrete)
    padded = _seq_learner(horizon=T, discrete=discrete, act_impl="padded")
    state = kv.init(torch.Generator().manual_seed(0))
    steps = T + T // 2
    obs_seq = torch.randn((steps, B, OBS), generator=torch.Generator().manual_seed(1))
    kv_carry, pad_carry = kv.act_init(B), padded.act_init(B)
    assert "cache" in kv_carry and "buf" in pad_carry
    assert kv_carry["cache"][0]["k"].dtype == torch.bfloat16 and pad_carry["buf"].dtype == torch.float32
    for t in range(steps):
        draws = torch.randn((B, ACT), generator=torch.Generator().manual_seed(100 + t))
        if discrete:
            draws = -torch.log(-torch.log(torch.rand((B, N_ACTIONS), generator=torch.Generator().manual_seed(t))))
        a_kv, i_kv, kv_carry = kv.act_step(state, kv_carry, obs_seq[t], noise=draws)
        a_pd, i_pd, pad_carry = padded.act_step(state, pad_carry, obs_seq[t], noise=draws)
        torch.testing.assert_close(i_kv["logp"], i_pd["logp"], atol=3e-2, rtol=3e-2, msg=f"logp at step {t}")
        torch.testing.assert_close(i_kv["value"], i_pd["value"], atol=3e-2, rtol=3e-2, msg=f"value at step {t}")
        if discrete:
            assert torch.equal(a_kv, a_pd), f"actions diverge at step {t}"
    assert kv_carry["pos"] == pad_carry["pos"] == T // 2  # wrapped once


def test_pixel_trajectory_kv_matches_padded():
    """Pixel trajectories (the NatureCNN stem per frame): the kv decode
    reproduces the padded form on uint8 frames, and both keep pixels uint8
    into the stem."""
    from surreal_tpu_torch.envs.device.pong import PongSmall

    T, B = 6, 3
    cfg = lambda act_impl: Config(  # noqa: E731
        algo=Config(name="ppo", horizon=T, epochs=1, num_minibatches=1),
        model=Config(
            cnn=Config(enabled=True, channels=(8, 16), kernels=(4, 3), strides=(2, 1), dense=32),
            encoder=Config(SEQ_ENC, act_impl=act_impl),
        ),
    )
    kv = build_learner(cfg("kv"), PongSmall.specs, device="cpu")
    padded = build_learner(cfg("padded"), PongSmall.specs, device="cpu")
    state = kv.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    obs_seq = torch.randint(0, 255, (T, B, *PongSmall.specs.obs.shape), generator=g).to(torch.uint8)
    kv_carry, pad_carry = kv.act_init(B), padded.act_init(B)
    assert pad_carry["buf"].dtype == torch.uint8
    for t in range(T):
        a_kv, i_kv, kv_carry = kv.act_step(state, kv_carry, obs_seq[t], "eval_deterministic")
        a_pd, i_pd, pad_carry = padded.act_step(state, pad_carry, obs_seq[t], "eval_deterministic")
        assert torch.equal(a_kv, a_pd)
        torch.testing.assert_close(i_kv["logp"], i_pd["logp"], atol=3e-2, rtol=3e-2)


def test_evaluator_wraps_the_trajectory_context(tmp_path):
    """Pendulum episodes (200 steps) outrun a horizon of 8, so the
    evaluator's act_step wraps the context 24 times: kv and padded acting
    score the same deterministic episodes alike (f32, from the same seed)."""
    out = {}
    for act_impl in ("kv", "padded"):
        cfg = Config(
            learner_config=Config(
                algo=Config(name="ppo", horizon=8, epochs=1, num_minibatches=1, precision="f32"),
                model=Config(encoder=Config(SEQ_ENC, act_impl=act_impl)),
            ),
            env_config=Config(name="jax:pendulum", num_envs=4),
            session_config=Config(folder=str(tmp_path)),
        ).extend(base_config())
        tr = Trainer(cfg, device="cpu")
        state = tr.learner.init(torch.Generator().manual_seed(0))
        ev = Evaluator(cfg.env_config, Config(episodes=3, mode="deterministic"), tr.learner)
        out[act_impl] = ev.evaluate(state, key=7)
    assert out["kv"]["eval/length"] == out["padded"]["eval/length"] == 200.0
    np.testing.assert_allclose(out["kv"]["eval/return"], out["padded"]["eval/return"], rtol=1e-5)


def test_trajectory_policy_guards(tmp_path):
    """Drivers that cannot thread the context carry, and what the port does
    not have yet (the sp mesh), refuse loudly."""
    learner = _seq_learner()
    state = learner.init()
    with pytest.raises(RuntimeError, match="act_init/act_step"):
        learner.act(state, torch.zeros((2, OBS)))
    with pytest.raises(NotImplementedError, match="rebind_mesh"):
        learner.rebind_mesh(object(), "sp")
    memoryless = build_learner(Config(algo=Config(name="ppo")), _specs(False)[1], device="cpu")
    memoryless.rebind_mesh(object(), "sp")  # a no-op, as in the reference
    assert memoryless.act_init(4) is None and not memoryless.requires_act_carry

    def trainer(env: str, encoder: dict, mesh: dict | None = None):
        session = dict(folder=str(tmp_path))
        if mesh is not None:
            session["topology"] = dict(mesh=mesh)
        return Trainer(Config(
            learner_config=dict(algo=dict(name="ppo"), model=dict(encoder=encoder)),
            env_config=dict(name=env, num_envs=4),
            session_config=session,
        ).extend(base_config()), device="cpu")

    with pytest.raises(ValueError, match="device env"):
        trainer("gym:CartPole-v1", dict(kind="trajectory"))
    with pytest.raises(ValueError, match="requires model.encoder.kind='trajectory'"):
        trainer("jax:cartpole", dict(kind="auto"), mesh=dict(dp=1, sp=2))
    with pytest.raises(NotImplementedError, match="rebind_mesh"):
        trainer("jax:cartpole", dict(kind="trajectory"), mesh=dict(dp=1, sp=2))
    with pytest.raises(ValueError, match="max_len >= 9"):
        build_learner(Config(algo=Config(name="ppo", horizon=8), model=Config(encoder=Config(kind="trajectory",
                                                                                           max_len=8))),
                      _specs(False)[1], device="cpu")


def test_ddpg_rejects_trajectory_encoder():
    with pytest.raises(ValueError, match="on-policy seam"):
        build_learner(
            Config(algo=Config(name="ddpg"), model=Config(encoder=Config(kind="trajectory"))),
            _specs(False)[1], device="cpu",
        )


def test_trajectory_cli_trains_with_eval(tmp_path, capsys):
    """``train ppo jax:pendulum --set ...encoder.kind=trajectory`` through
    the CLI on the CPU: two iterations, eval on (its 200-step episodes
    wrap the 8-step context), a checkpoint, finite metrics."""
    import json

    import surreal_tpu_torch.main.launch as launch

    folder = tmp_path / "run"
    argv = ["train", "ppo", "jax:pendulum", "--folder", str(folder), "--num-envs", "4",
            "--total-steps", str(2 * 4 * 8), "--set",
            "learner_config.model.encoder.kind=trajectory", "learner_config.model.encoder.features=16",
            "learner_config.model.encoder.num_layers=1", "learner_config.algo.horizon=8",
            "learner_config.algo.epochs=1", "learner_config.algo.num_minibatches=2",
            "session_config.backend=cpu", "session_config.metrics.every_n_iters=1",
            "session_config.metrics.tensorboard=false", "session_config.eval.every_n_iters=2",
            "session_config.eval.episodes=2", "session_config.checkpoint.every_n_iters=2"]
    assert launch.main(argv) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["eval/length"] == 200.0 and np.isfinite(final["eval/return"])
    assert all(np.isfinite(v) for k, v in final.items() if k != "episode/return")
    assert (folder / "checkpoints" / "2").is_dir()


@pytest.mark.slow
def test_trajectory_ppo_learns_cartpole(tmp_path):
    """E2E: a small attention policy trains on jax:cartpole; the late-run
    episode return is clearly above the early-run mean (the reference's
    tests/test_trajectory_policy.py::test_trajectory_ppo_learns_cartpole)."""
    horizon, num_envs = 16, 32
    cfg = Config(
        learner_config=Config(
            algo=Config(name="ppo", horizon=horizon, epochs=4, num_minibatches=2, entropy_coeff=0.01),
            model=Config(encoder=Config(SEQ_ENC)),
            optimizer=Config(lr=1e-3),
        ),
        env_config=Config(name="jax:cartpole", num_envs=num_envs),
        session_config=Config(
            folder=str(tmp_path),
            total_env_steps=horizon * num_envs * 150,
            metrics=Config(every_n_iters=5, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0),
            eval=Config(every_n_iters=0),
        ),
    ).extend(base_config())
    returns = []

    def on_metrics(iteration, m):
        r = m.get("episode/return")
        if r is not None and np.isfinite(r):
            returns.append(r)

    Trainer(cfg, device="cpu").run(on_metrics=on_metrics)
    assert len(returns) >= 10, "too few episode-return samples"
    early = float(np.mean(returns[:3]))
    late = float(np.max(returns[-5:]))
    assert late > max(2.0 * early, early + 30.0), (early, late, returns)


@pytest.mark.slow
def test_ppo_cartpole_reaches_475(tmp_path):
    """Discrete-action PPO (the memoryless categorical model) learns
    jax:cartpole to an episode return of 475 within 600,000 env steps, at
    the reference's config (tests/test_ppo.py::test_ppo_cartpole_reaches_475)."""
    cfg = Config(
        learner_config=Config(algo=Config(name="ppo", epochs=4), optimizer=Config(lr=2.5e-3)),
        env_config=Config(name="jax:cartpole", num_envs=16),
        session_config=Config(
            folder=str(tmp_path),
            total_env_steps=600_000,
            metrics=Config(every_n_iters=10, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0),
            eval=Config(every_n_iters=0),
        ),
    ).extend(base_config())
    best = {"ret": 0.0}

    def cb(iteration, m):
        r = m.get("episode/return", float("nan"))
        if not np.isnan(r):
            best["ret"] = max(best["ret"], r)
        return best["ret"] >= 475.0  # early stop

    Trainer(cfg, device="cpu").run(on_metrics=cb)
    assert best["ret"] >= 475.0, f"best return {best['ret']} < 475"
