"""Parity of the PyTorch port's IMPALA learner and of one fused IMPALA
iteration on pixel Pong with the JAX package. Weights are carried over by
``utils/convert.py``; the randomness JAX draws (Gumbel action noise, Pong's
serve draws and resets) is taken from JAX itself, on the keys its own code
splits, and handed to the port as explicit tensors."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tests.test_torch_precision as tprec
from surreal_tpu.envs.base import ArraySpec as JaxArraySpec
from surreal_tpu.envs.base import EnvSpecs as JaxEnvSpecs
from surreal_tpu.envs.jax.pong import Pong as JaxPong
from surreal_tpu.envs.jax.pong import PongSmall as JaxPongSmall
from surreal_tpu.envs.jax.pong import _serve as jax_serve
from surreal_tpu.launch.rollout import device_rollout as jax_device_rollout
from surreal_tpu.launch.rollout import init_device_carry as jax_init_device_carry
from surreal_tpu.launch.trainer import Trainer as JaxTrainer
from surreal_tpu.learners import build_learner as jax_build_learner
from surreal_tpu.learners.impala import IMPALAState as JaxIMPALAState
from surreal_tpu.ops import distributions as JD
from surreal_tpu.ops import running_stats as JRS
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import base_config as jax_base_config
from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs
from surreal_tpu_torch.envs.device.pong import Pong, PongSmall
from surreal_tpu_torch.launch.trainer import Trainer
from surreal_tpu_torch.learners import build_learner
from surreal_tpu_torch.learners.impala import IMPALALearner
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.utils.convert import categorical_params_from_jax, params_from_jax

# learn-level bar, as for PPO (tests/test_torch_ppo.py): one Adam step in
# f32 in two frameworks; sums (convolutions, matmuls, means, global norms)
# are taken in another order. Adam's first step is lr * g / (|g| + eps),
# so a weight whose gradient sum is near zero can move by a fraction of lr
# on a last-bit difference; the inputs here keep every weight inside 1e-5.
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=1e-5)
# the reference's narrow CNN for pong16 (tests/test_envs.py): last conv 5x5
PONG16_CNN = dict(enabled=True, channels=(8, 16), kernels=(4, 3), strides=(2, 1), dense=32)
# a narrow NatureCNN for 42x42 (default kernels and strides)
PONG_CNN = dict(enabled=True, channels=(8, 16, 16), dense=32)
LIFT_OBS, LIFT_ACT = 17, 4


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _learners(kind: str, algo: dict):
    if kind == "pong16":
        jspecs, tspecs = JaxPongSmall.specs, PongSmall.specs
        model = dict(cnn=PONG16_CNN)
    else:
        f32 = np.dtype(np.float32)
        jspecs = JaxEnvSpecs(obs=JaxArraySpec((LIFT_OBS,), f32), action=JaxArraySpec((LIFT_ACT,), f32))
        tspecs = EnvSpecs(obs=ArraySpec((LIFT_OBS,), f32), action=ArraySpec((LIFT_ACT,), f32))
        model = dict(actor_hidden=(32, 32), critic_hidden=(32, 32))
    tree = dict(algo=dict(name="impala", **algo), model=model)
    return jax_build_learner(JaxConfig(tree), jspecs), build_learner(Config(tree), tspecs, device="cpu")


def _params(jl, obs, seed):
    """The tree flax's init builds (names and shapes from ``eval_shape``),
    filled with N(0, 1/fan_in) draws, so that logits, values and the
    importance ratios are all far from their trivial values."""
    shapes = jax.eval_shape(jl.model.init, jax.random.key(0), jnp.asarray(obs))
    rng = np.random.default_rng(seed)

    def draw(leaf):
        fan_in = int(np.prod(leaf.shape[:-1])) if len(leaf.shape) > 1 else 8
        return (rng.normal(size=leaf.shape) / np.sqrt(fan_in)).astype(np.float32)

    return jax.tree.map(draw, shapes)


def _batch(kind, T, B, seed):
    """A learner batch with one termination and one truncation, behaviour
    log-probs 0.3 off the learner's so that every clip level acts."""
    rng = np.random.default_rng(seed)
    if kind == "pong16":
        obs = np.where(rng.random((T + 1, B, 16, 16, 2)) < 0.1, 255, 0).astype(np.uint8)
        action = rng.integers(0, 3, (T, B)).astype(np.int32)
        behavior = {"logits": rng.normal(size=(T, B, 3)).astype(np.float32)}
        logp = np.asarray(JD.categorical_logp(jnp.asarray(behavior["logits"]), jnp.asarray(action)))
        reward = rng.choice(np.float32([-1, 0, 0, 0, 1]), (T, B))
    else:
        obs = rng.normal(size=(T + 1, B, LIFT_OBS)).astype(np.float32)
        mean = (0.3 * rng.normal(size=(T, B, LIFT_ACT))).astype(np.float32)
        log_std = np.full((T, B, LIFT_ACT), -0.5, np.float32)
        action = (mean + np.exp(log_std) * rng.normal(size=(T, B, LIFT_ACT))).astype(np.float32)
        behavior = {"mean": mean, "log_std": log_std}
        logp = np.asarray(JD.diag_gauss_logp(*map(jnp.asarray, (mean, log_std, action))))
        reward = rng.normal(size=(T, B)).astype(np.float32)
    next_obs = obs[1:].copy()
    next_obs[5, 0] = obs[0, 1]  # the pre-reset terminal obs of a truncation
    done = np.zeros((T, B), bool)
    done[2, 3] = done[5, 0] = True
    terminated = np.zeros((T, B), bool)
    terminated[2, 3] = True
    return {
        "obs": obs[:-1], "next_obs": next_obs, "action": action, "reward": reward,
        "done": done, "terminated": terminated,
        "behavior_logp": (logp + 0.3 * rng.normal(size=(T, B))).astype(np.float32),
        "behavior": behavior,
    }


def _assert_params_close(t_params, j_params, convert, **tol):
    want = convert(_np_tree(j_params))
    assert set(want) == set(t_params)
    for k, v in want.items():
        np.testing.assert_allclose(t_params[k].detach().numpy(), v.numpy(), err_msg=k, **tol)


def _assert_metrics_close(t_metrics, j_metrics, **tol):
    assert set(t_metrics) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), err_msg=k, **tol)


@pytest.mark.parametrize("kind,knobs", [
    pytest.param("pong16", {}, id="pong16"),
    pytest.param("lift", {}, id="lift"),
    # 'assoc' V-trace: the reference's associative_scan against the port's
    # reverse scan, which reassociate the sum (tests/test_torch_returns.py)
    pytest.param("pong16", {"vtrace_impl": "assoc"}, id="pong16-assoc"),
    # the V-trace scan's unroll in the reference, which changes nothing here
    pytest.param("lift", {"gae_unroll": 2}, id="lift-unroll2"),
])
def test_impala_learn_matches_jax(kind, knobs):
    """One learn from the same params and batch: categorical head and
    pixel CNN on pong16, Gaussian head and MLP (with the obs filter) on
    lift, both in f32, both learners built from the same algo config."""
    T, B = 8, 6
    jl, tl = _learners(kind, {"precision": "f32", **knobs})
    batch = _batch(kind, T, B, seed=3)
    params = _params(jl, batch["obs"][0, :1], seed=4)
    obs_shape = jl.specs.obs.shape if jl._use_obs_filter else (1,)
    j_state = JaxIMPALAState(
        params=params, opt_state=jl.tx.init(params), obs_stats=JRS.init_stats(obs_shape),
        iteration=jnp.zeros((), jnp.int32),
    )
    j_new, j_metrics = jax.jit(jl.learn)(j_state, jax.tree.map(jnp.asarray, batch), jax.random.key(0))

    convert = categorical_params_from_jax if kind == "pong16" else params_from_jax
    t_state = tl.state_from_params(convert(params))
    t_new, t_metrics = tl.learn(t_state, jax.tree.map(torch.from_numpy, batch))

    assert 0.0 < float(t_metrics["policy/rho_mean"]) != 1.0
    _assert_metrics_close(t_metrics, j_metrics, **METRIC_TOL)
    _assert_params_close(t_new.params, j_new.params, convert, **PARAM_TOL)
    assert int(t_new.iteration) == 1 and int(t_new.opt_state.count) == 1
    if kind == "lift":
        assert int(t_new.obs_stats.count) == T * B
        np.testing.assert_allclose(t_new.obs_stats.mean.numpy(), np.asarray(j_new.obs_stats.mean), rtol=1e-5, atol=1e-6)
    else:
        assert int(t_new.obs_stats.count) == 0  # no obs filter for uint8 pixels


# the bf16 bars of tests/test_torch_precision.py: both compute in bf16 and
# round at other places (2e-2, the models' forward bar); one Adam step
# moves a weight by lr * g / |g|, so each element's update is held to
# JAX's within lr / 10 but at a few sign flips where |g| is near 0
# (measured: 'bf16' 0.16% of the elements, at most 0.08% of their leaf's
# largest |g|; 'bf16_fp8' 0.52% and 2.7%; the bars are about twice that)
BF16_METRIC_TOL = dict(rtol=2e-2, atol=2e-2)
IMPALA_LR = 6e-4


@pytest.mark.parametrize("precision,max_flips,near_zero", [("bf16", 5e-3, 1e-2), ("bf16_fp8", 1e-2, 5e-2)])
def test_impala_learn_matches_jax_under_precision(precision, max_flips, near_zero):
    """One learn on pong16 (CNN stem, its dense layer on the fp8 path under
    'bf16_fp8') under dynamic loss scaling, against JAX's: the metrics at
    the bf16 bar, each element's update at the bars above, the loss-scale
    state and metrics equal."""
    T, B = 8, 6
    jl, tl = _learners("pong16", {"precision": precision})
    batch = _batch("pong16", T, B, seed=3)
    params = _params(jl, batch["obs"][0, :1], seed=4)
    j_state = JaxIMPALAState(
        params=params, opt_state=jl.tx.init(params), obs_stats=JRS.init_stats((1,)),
        iteration=jnp.zeros((), jnp.int32),
    )
    j_new, j_metrics = jax.jit(jl.learn)(j_state, jax.tree.map(jnp.asarray, batch), jax.random.key(0))
    t_new, t_metrics = tl.learn(tl.state_from_params(categorical_params_from_jax(params)),
                                jax.tree.map(torch.from_numpy, batch))
    assert float(t_metrics["precision/loss_scale"]) == float(j_metrics["precision/loss_scale"]) == 2.0**15
    _assert_metrics_close(t_metrics, j_metrics, **BF16_METRIC_TOL)
    tprec.assert_one_adam_step_matches(
        categorical_params_from_jax(params), t_new.params, categorical_params_from_jax(_np_tree(j_new.params)),
        categorical_params_from_jax(_np_tree(tprec._jax_adam(j_new.opt_state).mu)), IMPALA_LR, max_flips, near_zero)
    for f in ("scale", "good_steps", "overflows"):
        assert float(getattr(t_new.opt_state, f)) == float(getattr(j_new.opt_state, f)), f


def test_impala_rejects_unported_options():
    with pytest.raises(ValueError, match="vtrace_impl"):
        build_learner(Config(algo=Config(name="impala", vtrace_impl="scan")), PongSmall.specs, device="cpu")


def _slice_configs(tmp_path, B, T, limit):
    shared = dict(
        learner_config=dict(algo=dict(name="impala", horizon=T, precision="f32"), model=dict(cnn=PONG_CNN)),
        env_config=dict(name="jax:pong", num_envs=B, time_limit=limit),
        session_config=dict(folder=str(tmp_path)),
    )
    return JaxConfig(shared).extend(jax_base_config()), Config(shared).extend(base_config())


def test_impala_trainer_defaults_to_cuda_and_raises_without_it(monkeypatch, tmp_path):
    _, cfg = _slice_configs(tmp_path, B=2, T=4, limit=None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        Trainer(cfg)
    trainer = Trainer(cfg, device="cpu")
    assert trainer.device.type == "cpu" and isinstance(trainer.learner, IMPALALearner)
    assert isinstance(trainer.env.env, Pong) and trainer.learner.config.optimizer.lr == 6e-4


def _reset_draws(state):
    """What Pong.reset drew, as the port's reset draws [B, 2]."""
    return jnp.stack([state.vel[:, 1], (state.vel[:, 0] < 0).astype(jnp.float32)], axis=1)


def _pong_draw_chain(ar_state, horizon, limit):
    """Per step t, the draws Pong and AutoReset make from their key chains
    (serve vy of a point, fresh reset), replayed ahead of the rollout: with
    a time limit shorter than a game to 21 points, each env resets on its
    step count alone, and the env key restarts from the reset's."""

    def step(carry, _):
        env_key, ar_key, steps = carry
        pair = jax.vmap(jax.random.split)(env_key)
        serve_vy = jax.vmap(lambda k: jax_serve(k, False)[1][1])(pair[:, 1])
        ar_pair = jax.vmap(jax.random.split)(ar_key)
        reset, _ = jax.vmap(JaxPong().reset)(ar_pair[:, 1])
        steps = steps + 1
        done = steps >= limit
        env_key = jnp.where(done, reset.key, pair[:, 0])
        steps = jnp.where(done, 0, steps)
        return (env_key, ar_pair[:, 0], steps), (serve_vy[:, None], _reset_draws(reset))

    init = (ar_state.env_state.key, ar_state.key, ar_state.step_count)
    _, (step_draws, reset_draws) = jax.lax.scan(step, init, None, length=horizon)
    return step_draws, reset_draws


def test_train_iter_slice_matches_jax(tmp_path):
    """The slice as a whole: one fused iteration (rollout + IMPALA learn)
    on jax:pong in f32 with a narrow NatureCNN, B=8, T=16, time_limit=6 so
    envs reset mid-rollout, with JAX's Gumbel noise and env draws
    injected."""
    B, T, limit = 8, 16, 6
    jcfg, tcfg = _slice_configs(tmp_path, B, T, limit)
    jt, tt = JaxTrainer(jcfg), Trainer(tcfg, device="cpu")
    key = jax.random.key(0)
    key, _, env_key = jax.random.split(key, 3)
    jl = jt.learner
    params = _params(jl, np.zeros((1, 42, 42, 2), np.uint8), seed=5)
    j_state = JaxIMPALAState(
        params=params, opt_state=jl.tx.init(params), obs_stats=JRS.init_stats((1,)),
        iteration=jnp.zeros((), jnp.int32),
    )
    j_carry = jax.jit(lambda k: jax_init_device_carry(jt.env, k, B))(env_key)
    it_key = jax.random.fold_in(key, 1)

    # the draws JAX makes inside _device_train_iter, from the same keys
    @jax.jit
    def jax_draws(it_key, env_key, ar_state):
        ckey, _ = jax.random.split(it_key)
        akeys = jax.vmap(lambda k: jax.random.split(k)[0])(jax.random.split(ckey, T))
        gumbel = jax.vmap(lambda k: jax.random.gumbel(k, (B, 3), jnp.float32))(akeys)
        init_subs = jax.vmap(lambda k: jax.random.split(k)[1])(jax.random.split(env_key, B))
        init_draws = _reset_draws(jax.vmap(JaxPong().reset)(init_subs)[0])
        return (gumbel, init_draws, *_pong_draw_chain(ar_state, T, limit))

    gumbel, init_draws, step_draws, reset_draws = map(np.asarray, jax_draws(it_key, env_key, j_carry.env_state))

    @jax.jit
    def j_iter(s, c, k):
        ck, _ = jax.random.split(k)
        _, batch = jax_device_rollout(jt.env, jt.learner, s, c, ck, T)
        return jt._device_train_iter(s, c, k), batch

    (j_new, j_carry2, j_metrics), j_batch = j_iter(j_state, j_carry, it_key)

    t_state = tt.learner.state_from_params(categorical_params_from_jax(_np_tree(j_state.params)))
    t_carry = tt.init_loop_state(reset_draws=torch.from_numpy(init_draws))
    np.testing.assert_array_equal(t_carry.obs.numpy(), np.asarray(j_carry.obs))
    draws = dict(
        action_noise=torch.from_numpy(gumbel),
        reset_draws=torch.from_numpy(reset_draws),
        step_draws=torch.from_numpy(step_draws),
    )
    from surreal_tpu_torch.launch.rollout import device_rollout

    _, t_batch = device_rollout(tt.env, tt.learner, t_state, t_carry, T, **draws)
    t_new, t_carry2, t_metrics = tt._device_train_iter(t_state, t_carry, **draws)

    # pixels, actions and env outputs exactly; logits and log-probs at f32
    # convolution rounding
    flat_j = jax.tree_util.tree_flatten_with_path(_np_tree(j_batch))[0]
    for path, want in flat_j:
        node = t_batch
        for p in path:
            node = node[p.key]
        name = jax.tree_util.keystr(path)
        if want.dtype.kind == "f" and name not in ("['reward']", "['ep_return']"):
            np.testing.assert_allclose(node.numpy(), want, rtol=0, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(node.numpy(), want, err_msg=name)
    assert set(t_batch["behavior"]) == {"logits"}
    assert bool(t_batch["done"].any()) and not bool(t_batch["terminated"].any())
    np.testing.assert_array_equal(t_carry2.obs.numpy(), np.asarray(j_carry2.obs))
    _assert_params_close(t_new.params, j_new.params, categorical_params_from_jax, **PARAM_TOL)
    _assert_metrics_close(t_metrics, j_metrics, **METRIC_TOL)
