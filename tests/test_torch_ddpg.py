"""Parity of the PyTorch port's DDPG path with the JAX package: the actor
and critic (through ``utils/convert.py``), the flax-exact LayerNorm,
``learn`` in both target modes, ``nstep_transitions``,
``scrub_fake_prefix_windows``, ``ou_noise_step``, and two fused off-policy
iterations on ``jax:lift`` under uniform and prioritized replay. The
randomness JAX draws (OU normals, warm-up actions, env reset draws,
replay draws) is taken from JAX itself, on the keys its own code splits,
and handed to the port as explicit tensors.

XLA on the CPU contracts ``a * b + c`` into one fused multiply-add (a
jitted ``c + a * b`` equals the float64-emulated FMA of its inputs, not
the separately rounded expression), while PyTorch rounds the product and
the sum separately. Where a reference expression has that
shape, the port agrees to the last bit or two, not bit for bit; those
comparisons state their tolerance.
"""

import functools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from surreal_tpu.envs.base import ArraySpec as JaxArraySpec
from surreal_tpu.envs.base import EnvSpecs as JaxEnvSpecs
from surreal_tpu.envs.jax.lift import BlockLift as JaxBlockLift
from surreal_tpu.launch.offpolicy_trainer import OffPolicyTrainer as JaxOffPolicyTrainer
from surreal_tpu.launch.offpolicy_trainer import scrub_fake_prefix_windows as jax_scrub
from surreal_tpu.learners import build_learner as jax_build_learner
from surreal_tpu.learners.aggregator import nstep_transitions as jax_nstep_transitions
from surreal_tpu.learners.ddpg import ou_noise_step as jax_ou_noise_step
from surreal_tpu.models.encoders import MLP as JaxMLP
from surreal_tpu.replay import build_replay as jax_build_replay
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import base_config as jax_base_config
from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs
from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer, scrub_fake_prefix_windows
from surreal_tpu_torch.learners import build_learner
from surreal_tpu_torch.learners.aggregator import nstep_transitions
from surreal_tpu_torch.learners.ddpg import ou_noise_step
from surreal_tpu_torch.models.encoders import MLP, LayerNorm
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.utils.convert import ddpg_params_from_jax

OBS, ACT = 17, 4
# the PPO learn tests' bar: metrics rtol 1e-4 / atol 1e-5, params atol
# 1e-5 (f32 sums taken in another order; Adam divides by the gradient's
# own scale, so a near-zero gradient's last bits reach a fraction of lr)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=1e-5)
# one contracted multiply-add against two roundings: an ulp or two
FMA_TOL = dict(rtol=1e-6, atol=1e-7)


PIXELS = (42, 42, 2)  # Pong's frames: the NatureCNN stem ends at 1 x 1
SMALL_CNN = dict(enabled=True, channels=(4, 8, 8), dense=16)


def _specs(obs_shape=(OBS,), obs_dtype=np.float32):
    obs, act = np.dtype(obs_dtype), np.dtype(np.float32)
    return (
        JaxEnvSpecs(obs=JaxArraySpec(obs_shape, obs), action=JaxArraySpec((ACT,), act)),
        EnvSpecs(obs=ArraySpec(obs_shape, obs), action=ArraySpec((ACT,), act)),
    )


def _learners(algo: dict, model: dict | None = None, specs=None):
    jspecs, tspecs = specs or _specs()
    tree = dict(algo=dict(name="ddpg", **algo), model=model or {})
    jl = jax_build_learner(JaxConfig(tree), jspecs)
    tl = build_learner(Config(tree), tspecs, device="cpu")
    return jl, tl


@functools.lru_cache(maxsize=1)
def _jax_init():
    """One jitted JAX DDPGLearner.init shared by the tests here: the state
    it builds does not depend on the knobs they vary."""
    jl, _ = _learners({"precision": "f32"})
    return jax.jit(jl.init)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _converted(j_state, target=False):
    prefix = "target_" if target else ""
    return ddpg_params_from_jax(
        _np_tree(getattr(j_state, f"{prefix}actor_params")), _np_tree(getattr(j_state, f"{prefix}critic_params"))
    )


def _port_state(tl, j_state):
    return tl.state_from_params(*_converted(j_state))


def _assert_close_dict(got: dict, want: dict, **tol):
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(got[k].detach().numpy(), v.numpy(), err_msg=k, **tol)


def _assert_metrics_close(t_metrics, j_metrics, **tol):
    assert set(t_metrics) == set(j_metrics)
    for k in j_metrics:
        np.testing.assert_allclose(float(t_metrics[k]), float(j_metrics[k]), err_msg=k, **tol)


@pytest.mark.parametrize("precision,pixels", [("f32", False), ("mixed", False), ("f32", True), ("bf16_fp8", False)])
def test_ddpg_nets_forward_match_jax(precision, pixels):
    """Converted weights give the reference's Q and actions: 'f32' to 1e-6;
    'mixed' and 'bf16_fp8' (the trunk's and the critic's hidden layers on
    the fp8 path) to the PPO model test's bf16 bar, 2e-2 (both compute in bf16 with f32
    accumulation but round the bias add, the LayerNorm output cast and the
    tanh at other places). The pixel case puts a (narrow) NatureCNN stem
    in front of both nets, on uint8 frames."""
    rng = np.random.default_rng(0)
    if pixels:
        jl, tl = _learners({"precision": precision}, dict(cnn=SMALL_CNN), _specs(PIXELS, np.uint8))
        j_state = jax.jit(jl.init)(jax.random.key(0))
        obs = rng.integers(0, 256, size=(6, 5, *PIXELS)).astype(np.uint8)
    else:
        jl, tl = _learners({"precision": precision})
        j_state = _jax_init()(jax.random.key(0))
        obs = rng.normal(size=(6, 5, OBS)).astype(np.float32)
    t_state = _port_state(tl, j_state)
    act = rng.uniform(-1, 1, size=(6, 5, ACT)).astype(np.float32)
    j_q = jax.jit(jl.critic.apply)(j_state.critic_params, jnp.asarray(obs), jnp.asarray(act))
    j_a = jax.jit(jl.actor.apply)(j_state.actor_params, jnp.asarray(obs))
    t_q = tl.critic_apply(t_state.critic_params, torch.from_numpy(obs), torch.from_numpy(act))
    t_a = tl.actor_apply(t_state.actor_params, torch.from_numpy(obs))
    tol = dict(rtol=1e-6, atol=1e-6) if precision == "f32" else dict(rtol=2e-2, atol=2e-2)
    for got, want in ((t_q, j_q), (t_a, j_a)):
        assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **tol)


@pytest.mark.parametrize("case", ["large_mean", "small_variance"])
def test_layer_norm_is_flax_formula(case):
    """The port's LayerNorm against flax's, on inputs whose sums are exact
    in any order (so both frameworks' statistics are the same numbers):

    - large_mean: integers 120..136 over 64 features, variance ~25. The
      fast variance E[x^2] - E[x]^2 rounds E[x]^2 (~1.6e4) to f32, an error
      of 1e-3 in the variance that the two-pass variance of F.layer_norm
      does not make;
    - small_variance: multiples of 2^-10 around 0, variance ~7e-6, where
      eps 1e-6 (flax) and 1e-5 (torch's default) give different scales.

    The port matches flax to 1e-6; F.layer_norm misses by more than ten
    times that in both cases. The MLP trunk with ``use_layer_norm`` (a
    LayerNorm after each dense layer) matches flax's on the large-mean
    inputs."""
    rng = np.random.default_rng(3)
    if case == "large_mean":
        x = rng.integers(120, 137, size=(32, 64)).astype(np.float32)
    else:
        x = (rng.integers(-4, 5, size=(32, 64)) * 2.0**-10).astype(np.float32)
    scale = rng.normal(size=64).astype(np.float32)
    bias = rng.normal(size=64).astype(np.float32)
    want = np.asarray(jax.jit(fnn.LayerNorm(dtype=jnp.float32).apply)(
        {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}, jnp.asarray(x)))
    ln = LayerNorm(64, torch.float32)
    ln.scale.data, ln.bias.data = torch.from_numpy(scale), torch.from_numpy(bias)
    got = ln(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    torch_default = F.layer_norm(torch.from_numpy(x), (64,), torch.from_numpy(scale), torch.from_numpy(bias))
    assert np.abs(torch_default.numpy() - want).max() > 1e-5
    if case == "small_variance":
        return

    jmlp = JaxMLP(hidden=(8, 8), compute_dtype=jnp.float32, use_layer_norm=True)
    j_params = jax.jit(jmlp.init)(jax.random.key(0), jnp.asarray(x))
    tmlp = MLP(64, (8, 8), compute_dtype=torch.float32, use_layer_norm=True)
    p = j_params["params"]
    with torch.no_grad():
        for i in range(2):
            tmlp.layers[i].weight.copy_(torch.from_numpy(np.array(p[f"Dense_{i}"]["kernel"]).T))
            tmlp.layers[i].bias.copy_(torch.from_numpy(np.array(p[f"Dense_{i}"]["bias"])))
            tmlp.norms[i].scale.copy_(torch.from_numpy(np.array(p[f"LayerNorm_{i}"]["scale"])))
    np.testing.assert_allclose(tmlp(torch.from_numpy(x)).detach().numpy(),
                               np.asarray(jax.jit(jmlp.apply)(j_params, jnp.asarray(x))), rtol=1e-6, atol=1e-6)


def _learn_batch(B, seed):
    rng = np.random.default_rng(seed)
    done = rng.random(B) < 0.2
    return {
        "obs": rng.normal(size=(B, OBS)).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(B, ACT)).astype(np.float32),
        "reward": rng.normal(size=B).astype(np.float32),
        "next_obs": rng.normal(size=(B, OBS)).astype(np.float32),
        "discount": (0.99 * ~done).astype(np.float32),
        "is_weights": rng.uniform(0.2, 1.0, size=B).astype(np.float32),
    }


@pytest.mark.parametrize("target", [{"mode": "soft"}, {"mode": "hard", "hard_every": 2}])
def test_ddpg_learn_matches_jax(target):
    """Two learn calls with IS weights, soft (tau 0.005) or hard targets
    (copied at the second call), at the PPO learn tests' bar; the obs filter
    starts fresh, as in a state built from converted weights."""
    algo = {"precision": "f32", "target": target}
    jl, tl = _learners(algo)
    j_state = _jax_init()(jax.random.key(1))
    t_state = _port_state(tl, j_state)
    j_learn = jax.jit(jl.learn)
    for seed in (4, 5):
        batch = _learn_batch(32, seed)
        j_state, j_metrics = j_learn(j_state, jax.tree.map(jnp.asarray, batch), jax.random.key(seed))
        t_state, t_metrics = tl.learn(t_state, {k: torch.from_numpy(v) for k, v in batch.items()})
        np.testing.assert_allclose(
            t_metrics.pop("priority/td_abs").numpy(), np.asarray(j_metrics.pop("priority/td_abs")),
            rtol=1e-5, atol=1e-6,
        )
        _assert_metrics_close(t_metrics, j_metrics, **METRIC_TOL)
    for target_params in (False, True):
        for got, want in zip(
            (t_state.target_actor_params if target_params else t_state.actor_params,
             t_state.target_critic_params if target_params else t_state.critic_params),
            _converted(j_state, target=target_params),
        ):
            _assert_close_dict(got, want, **PARAM_TOL)
    assert int(t_state.iteration) == 2
    if target["mode"] == "hard":
        for k, v in t_state.actor_params.items():
            assert torch.equal(t_state.target_actor_params[k], v)


def test_ddpg_rejects_unported_options():
    """Options the port does not carry raise instead of being ignored."""
    jcfg, tcfg = _slice_configs("fifo")
    # the FIFO queue is ported, but holds trajectories, not transitions
    with pytest.raises(ValueError, match="fifo"):
        OffPolicyTrainer(tcfg, device="cpu")


def test_offpolicy_trainer_defaults_to_the_card():
    """No device argument means the card; without one it raises rather
    than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        OffPolicyTrainer(_slice_configs("uniform")[1])


def test_offpolicy_iteration_before_sampling_reports_zero_metrics():
    """Below ``start_sample_size`` the iteration inserts and skips the
    updates, reporting the same metric keys with zeros (the reference's
    ``lax.cond`` skip branch), and launches nothing of the update loop."""
    jcfg, tcfg = _slice_configs("prioritized")
    tcfg.learner_config.replay.start_sample_size = 2 * B * H
    tt = OffPolicyTrainer(tcfg, device="cpu")
    state = tt.learner.init()
    carry, replay = tt.init_loop_state(torch.Generator().manual_seed(0))
    keys = []
    for it in range(2):
        before = state.iteration
        state, replay, carry, metrics = tt._device_train_iter(
            state, replay, carry, beta=0.4, first=it == 0, generator=torch.Generator().manual_seed(it))
        keys.append(list(metrics))
        if it == 0:
            assert int(state.iteration) == int(before) == 0
            assert all(float(metrics[k]) == 0.0 for k in ("loss/critic", "health/grad_norm", "replay/sample_age_frac"))
    assert keys[0] == keys[1] and int(state.iteration) == K
    assert replay.ring.size == 2 * B * H


def _traj(T, B, seed):
    """A time-major trajectory with terminations and truncations."""
    rng = np.random.default_rng(seed)
    done = rng.random((T, B)) < 0.25
    return {
        "obs": rng.normal(size=(T, B, OBS)).astype(np.float32),
        "next_obs": rng.normal(size=(T, B, OBS)).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(T, B, ACT)).astype(np.float32),
        "reward": rng.normal(size=(T, B)).astype(np.float32),
        "done": done,
        "terminated": done & (rng.random((T, B)) < 0.5),
    }


@pytest.mark.parametrize("n", [1, 3])
def test_nstep_transitions_match_jax(n):
    """n = 1 is bit-exact. At n = 3 the reward and discount sums
    ``g + alive * gamma^k * r`` are multiply-adds that XLA contracts
    (FMA_TOL); obs, actions and the bootstrap obs stay bit-exact."""
    traj = _traj(8, 5, seed=n)
    want = _np_tree(jax.jit(jax_nstep_transitions, static_argnums=(1, 2))(
        jax.tree.map(jnp.asarray, traj), 0.99, n))
    got = nstep_transitions({k: torch.from_numpy(v) for k, v in traj.items()}, 0.99, n)
    assert set(got) == set(want)
    for k, v in want.items():
        if n == 1 or k in ("obs", "action", "next_obs"):
            np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)
        else:
            np.testing.assert_allclose(got[k].numpy(), v, err_msg=k, **FMA_TOL)


def test_scrub_fake_prefix_windows_matches_jax():
    n, B = 3, 4
    trans = nstep_transitions({k: torch.from_numpy(v) for k, v in _traj(8, B, seed=7).items()}, 0.99, n)
    want = _np_tree(jax_scrub({k: jnp.asarray(v.numpy()) for k, v in trans.items()}, n, B))
    got = scrub_fake_prefix_windows(trans, n, B)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v, err_msg=k)


def test_ou_noise_step_matches_jax():
    """JAX's normals injected. ``noise + drift + diffusion`` is two
    multiply-adds to XLA (FMA_TOL); the normals are JAX's, bit for bit."""
    noise = np.random.default_rng(8).normal(size=(16, ACT)).astype(np.float32)
    key = jax.random.key(9)
    want = np.asarray(jax.jit(lambda n, k: jax_ou_noise_step(n, k, 0.15, 0.2, 1.0))(jnp.asarray(noise), key))
    normals = np.array(jax.random.normal(key, noise.shape, jnp.float32))
    got = ou_noise_step(torch.from_numpy(noise), 0.15, 0.2, 1.0, normals=torch.from_numpy(normals))
    np.testing.assert_allclose(got.numpy(), want, **FMA_TOL)


# -- the slice as a whole ----------------------------------------------------

B, H, CAPACITY, BS, K = 8, 8, 512, 32, 4


def _slice_configs(kind, algo=None):
    n_step = 3 if kind == "uniform" else 1
    shared = dict(
        learner_config=dict(
            algo=dict(
                name="ddpg", horizon=H, updates_per_iter=K, n_step=n_step, precision="f32",
                exploration=dict(warmup_steps=B * H), **(algo or {}),
            ),
            replay=dict(kind=kind, capacity=CAPACITY, start_sample_size=B * H, batch_size=BS),
        ),
        env_config=dict(name="jax:lift", num_envs=B, time_limit=5),
        session_config=dict(folder="unused"),
    )
    return JaxConfig(shared).extend(jax_base_config()), Config(shared).extend(base_config())


@jax.jit
def _jax_reset_draws(keys):
    """What BlockLift.reset draws from each key, as the port's [..., 5] draws."""
    def one(key):
        state, _ = JaxBlockLift().reset(key)
        return jnp.concatenate([state.block_pos[:2], state.grip_pos[:2], state.grip_width[None]])
    return jnp.vectorize(one, signature="()->(n)")(keys)


@jax.jit
def _jax_slice_draws(env_keys, it_keys, sizes):
    """Every draw of two _device_train_iter calls, from JAX's own keys:

    - per step t, the reset draws AutoReset.step takes from the key it
      splits off each env's key chain: [2, H, B, 5];
    - per iteration, from its key (rollout key, update key): per rollout
      step (akey, nkey, wkey) the OU normals and the warm-up actions, then
      per update both forms of the replay's draw, the uniform replay's
      randint indices (over ``sizes``) and the prioritized replay's
      uniforms."""
    def chain(keys, _):
        pair = jax.vmap(jax.random.split)(keys)
        return pair[:, 0], pair[:, 1]
    _, subs = jax.lax.scan(chain, env_keys, None, length=2 * H)
    reset = _jax_reset_draws(subs).reshape(2, H, B, 5)

    def per_iter(it_key, size):
        rkey, ukey = jax.random.split(it_key)
        step_keys = jax.vmap(lambda k: jax.random.split(k, 3))(jax.random.split(rkey, H))
        normals = jax.vmap(lambda k: jax.random.normal(k, (B, ACT), jnp.float32))(step_keys[:, 1])
        warm = jax.vmap(lambda k: jax.random.uniform(k, (B, ACT), jnp.float32, -1.0, 1.0))(step_keys[:, 2])
        ukeys = jax.random.split(ukey, K)
        idx = jax.vmap(lambda k: jax.random.randint(k, (BS,), 0, jnp.maximum(size, 1)))(ukeys)
        uniforms = jax.vmap(lambda k: jax.random.uniform(k, (BS,)))(ukeys)
        return normals, warm, idx, uniforms

    return (reset, *jax.vmap(per_iter)(it_keys, sizes))


# Slice bar for params, per leaf: the port's update (final - start) within
# 1% of JAX's, in norm. Eight Adam steps at lr 1e-3 move every weight by
# about lr whatever its gradient's size, so a weight whose gradient is
# near zero turns a last-bit difference of it into a fraction of lr: one
# such weight lands 3.4e-4 off here. An elementwise bar would have to
# allow that for every weight; the norm bar holds the leaf as a whole.
SLICE_UPDATE_RTOL = 1e-2


def _assert_updates_close(got: dict, want: dict, start: dict):
    assert set(got) == set(want) == set(start)
    for k in want:
        moved = (want[k] - start[k]).norm()
        assert moved > 0, k
        assert (got[k] - want[k]).norm() <= SLICE_UPDATE_RTOL * moved, (k, float((got[k] - want[k]).norm() / moved))


@pytest.mark.parametrize("kind,algo", [
    pytest.param("uniform", {}, id="uniform"),
    pytest.param("prioritized", {}, id="prioritized"),
    # the update scan's unroll in the reference, which changes nothing in
    # the port's update loop
    pytest.param("uniform", {"update_unroll": 2}, id="uniform-update_unroll2"),
])
def test_offpolicy_slice_matches_jax(kind, algo):
    """The slice as a whole: two fused iterations on jax:lift (8 envs x 8
    steps, time limit 5 so envs reset mid-rollout, capacity 512, batch
    32, 4 updates per iteration, 'f32'), the first under warm-up actions,
    against JAX's ``_device_train_iter`` with JAX's draws injected from
    the trainer's own key split. Uniform replay runs n_step 3 (the tail
    carry and the first-chunk scrub) through the batched gather;
    prioritized replay n_step 1 through the sequential sample / learn /
    priority-refresh loop. Compared: params and target params, the ring,
    priorities, max priority and every metric. Both trainers are built
    from the same algo config (``update_unroll=2`` in one case).

    Prioritized indices: a draw that picked another slot than JAX's would
    leave |td| + eps at another slot and max priority at this one, far
    outside the priorities' tolerance, so the priorities' agreement shows
    that every one of the 256 draws picked JAX's slot. (The module-level
    rule for draws next to a cdf boundary is tested in
    tests/test_torch_replay.py.)"""
    jcfg, tcfg = _slice_configs(kind, algo)
    jt, tt = JaxOffPolicyTrainer(jcfg), OffPolicyTrainer(tcfg, device="cpu")
    # one device: the test session simulates eight CPU devices, over which
    # the JAX trainer shards its replay; its single-device replay is the
    # unscaled build, and _device_train_iter without an axis name its path
    jt.replay = jax_build_replay(jt._replay_build_cfg)
    prioritized = kind == "prioritized"
    total = 2 * B * H

    key = jax.random.key(0)
    key, init_key, env_key = jax.random.split(key, 3)
    j_state = _jax_init()(init_key)  # the slice learner's init: same nets and chains
    j_carry, j_replay = jax.jit(jt._init_carry)(env_key), jt.replay.init(jt._replay_example())
    init_subs = jax.vmap(lambda k: jax.random.split(k)[1])(jax.random.split(env_key, B))
    keys = []
    for _ in range(2):
        key, it_key, _ = jax.random.split(key, 3)
        keys.append(it_key)
    sizes = jnp.asarray([min((it + 1) * B * H, CAPACITY) for it in range(2)])
    reset, normals, warm, idx, uniforms = map(
        np.array, _jax_slice_draws(j_carry.env_state.key, jnp.stack(keys), sizes))
    sample = uniforms if prioritized else idx

    t_state = _port_state(tt.learner, j_state)
    start_params = (t_state.actor_params, t_state.critic_params)
    t_carry, t_replay = tt.init_loop_state(reset_draws=torch.from_numpy(np.array(_jax_reset_draws(init_subs))))
    np.testing.assert_allclose(t_carry.obs.numpy(), np.asarray(j_carry.obs), atol=1e-6)

    j_iter = jax.jit(jt._device_train_iter)
    for it in range(2):
        env_steps = it * B * H
        beta = jt._beta(env_steps, total)
        warmup = env_steps < B * H
        j_state, j_replay, j_carry, j_metrics = j_iter(
            j_state, j_replay, j_carry, keys[it], jnp.float32(beta), jnp.asarray(warmup), jnp.asarray(it == 0))
        t_state, t_replay, t_carry, t_metrics = tt._device_train_iter(
            t_state, t_replay, t_carry, beta=beta, warmup=warmup, first=it == 0,
            action_noise=torch.from_numpy(normals[it]),
            warmup_uniforms=torch.from_numpy(warm[it]),
            reset_draws=torch.from_numpy(reset[it]),
            sample_draws=torch.from_numpy(sample[it]),
        )
        # the update ratio sums every step of every weight, the constant-dim
        # columns below included: 5e-2, as tests/test_torch_ppo.py holds it
        ratio = "health/update_ratio"
        np.testing.assert_allclose(float(t_metrics.pop(ratio)), float(j_metrics.pop(ratio)), rtol=5e-2)
        _assert_metrics_close(t_metrics, j_metrics, **METRIC_TOL)
        assert float(t_metrics["episode/count"]) > 0

    np.testing.assert_allclose(t_carry.obs.numpy(), np.asarray(j_carry.obs), atol=1e-5)
    np.testing.assert_allclose(t_carry.noise.numpy(), np.asarray(j_carry.noise), atol=1e-5)
    j_ring = j_replay.ring if prioritized else j_replay
    t_ring = t_replay.ring if prioritized else t_replay
    assert (t_ring.cursor, t_ring.size) == (int(j_ring.cursor), int(j_ring.size)) == (2 * B * H, 2 * B * H)
    for k, v in j_ring.storage.items():
        np.testing.assert_allclose(t_ring.storage[k].numpy(), np.asarray(v), rtol=0, atol=1e-5, err_msg=k)
    if prioritized:
        # |td| + eps: Q-values are ~0.1, TDs ~0.02, held to 1e-4 of Q
        np.testing.assert_allclose(t_replay.priorities.numpy(), np.asarray(j_replay.priorities), rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(t_replay.max_priority), float(j_replay.max_priority), rtol=1e-5)

    # The reference's rounding fault on constant obs dims (ROADMAP §3):
    # the block's height is constant while it rests, the port normalizes it
    # to exactly 0 and the reference to rounding noise, so the reference's
    # Adam moves those first-layer weight columns by up to lr per update.
    # Those columns are held to that bound; everything else to the bar.
    obs = t_ring.storage["obs"][: t_ring.size].numpy()
    const = np.all(obs == obs[:1], axis=0)
    assert const.any() and not const.all()
    bound = 1e-3 * 2 * K * 1.01
    for target in (False, True):
        got_pair = (
            (t_state.target_actor_params, t_state.target_critic_params) if target
            else (t_state.actor_params, t_state.critic_params)
        )
        for got, want, start, first in zip(
            got_pair, _converted(j_state, target), start_params, ("trunk.layers.0.weight", "layers.0.weight")
        ):
            got, start = dict(got), dict(start)
            assert (got[first][:, const] - want[first][:, const]).abs().max() <= bound
            for tree in (got, want, start):
                tree[first] = tree[first][:, ~const]
            _assert_updates_close(got, want, start)
