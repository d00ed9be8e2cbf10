"""Parity of the PyTorch port's host-env training paths with the JAX
package: ``host_rollout``, one iteration of the Trainer's alternate loop
(PPO and IMPALA), two iterations of DDPG's host loop (uniform and
prioritized replay, n-step 1 and 3), the host evaluator; then the overlap
loop's contract (steps counted, the in-flight rollout discarded at stop,
collector errors raised on the main thread, rollback), the ``train`` CLI
on a host env, and what the port refuses.

The JAX side runs its own drivers (``Trainer.run``, ``OffPolicyTrainer.run``
in host mode with ``topology.overlap_rollouts`` off); the port is handed
the draws JAX made from its keys (action noise, Gumbel draws, warm-up
actions, OU normals, epoch permutations, replay draws) and JAX's initial
weights through ``utils/convert.py``. The gym envs are the same seeded
numpy code in both packages."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.launch.evaluator import Evaluator as JaxEvaluator
from surreal_tpu.launch.offpolicy_trainer import OffPolicyTrainer as JaxOffPolicyTrainer
from surreal_tpu.launch.rollout import host_rollout as jax_host_rollout
from surreal_tpu.launch.trainer import Trainer as JaxTrainer
from surreal_tpu.learners.ppo import _block_layout
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import base_config as jax_base_config
from surreal_tpu_torch.launch import trainer as trainer_mod
from surreal_tpu_torch.launch.evaluator import Evaluator
from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer
from surreal_tpu_torch.launch.rollout import host_rollout
from surreal_tpu_torch.launch.seed_trainer import SEEDTrainer
from surreal_tpu_torch.launch.trainer import Trainer
from surreal_tpu_torch.learners.aggregator import to_device
from surreal_tpu_torch.main import launch as torch_launch
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.session.telemetry import _iter_jsonl
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.convert import categorical_params_from_jax, ddpg_params_from_jax, params_from_jax
from surreal_tpu_torch.utils.tree import tree_flatten

# the learn-level bars (tests/test_torch_ppo.py): f32 sums taken in another
# order; Adam divides by the gradient's own scale
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=1e-5)
# a host rollout of continuous actions: the actions differ from JAX's by
# float rounding (exp, the normal's scale), and the env integrates them
ROLLOUT_TOL = dict(rtol=0, atol=1e-5)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _session(folder, **over):
    # the session subsystems the port does not build (ops plane, SLOs,
    # watchdog, remediation, cost gauges, profile trigger) off in both
    # packages: they change no update, and the cost gauges compile each
    # program once more on the JAX side
    sess = dict(folder=str(folder), seed=0, topology=dict(overlap_rollouts=False),
                metrics=dict(every_n_iters=1, tensorboard=False, console=False),
                checkpoint=dict(every_n_iters=0), eval=dict(every_n_iters=0),
                ops=dict(enabled=False), slo=dict(enabled=False), watchdog=dict(enabled=False),
                remediate=dict(enabled=False), perf=dict(enabled=False), profile=dict(trigger_file=False))
    for k, v in over.items():
        sess[k] = {**sess.get(k, {}), **v} if isinstance(v, dict) else v
    return sess


def _configs(tmp_path, algo: dict, env: str, num_envs: int, replay: dict | None = None, **session):
    learner = dict(algo=dict(precision="f32", **algo))
    if replay is not None:
        learner["replay"] = replay
    shared = dict(learner_config=learner, env_config=dict(name=env, num_envs=num_envs),
                  session_config=_session(tmp_path, **session))
    return JaxConfig(shared).extend(jax_base_config()), Config(shared).extend(base_config())


def _convert(learner, j_params):
    convert = categorical_params_from_jax if learner.discrete else params_from_jax
    return convert(_np_tree(j_params))


def _rollout_noise(key, horizon, B, learner):
    """Per step, the draw JAX's host_rollout makes from the key it splits
    off: Gumbel [B, n] for a categorical head, normals [B, A] else."""
    draw = jax.random.gumbel if learner.discrete else jax.random.normal
    width = learner.specs.action.n if learner.discrete else learner.specs.action.shape[0]
    out = []
    for _ in range(horizon):
        key, akey = jax.random.split(key)
        out.append(np.asarray(draw(akey, (B, width), jnp.float32)))
    return np.stack(out)


def _assert_batch_close(t_batch, j_batch):
    for path, want in jax.tree_util.tree_flatten_with_path(_np_tree(j_batch))[0]:
        node = t_batch
        for p in path:
            node = node[p.key]
        name = jax.tree_util.keystr(path)
        got = node.numpy()
        assert got.shape == want.shape, name
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got, want, err_msg=name, **ROLLOUT_TOL)
        else:
            np.testing.assert_array_equal(got, want, err_msg=name)


@pytest.fixture(scope="module")
def ppo_twins(tmp_path_factory):
    """Per host env, built once for the module (the rollout and evaluator
    tests share the JAX side's compiled programs): the configs, JAX's
    host-mode Trainer and the port's (PPO, 4 envs, f32), and the initial
    state JAX draws from key 1, converted for the port."""
    made = {}

    def get(env):
        if env not in made:
            jcfg, tcfg = _configs(tmp_path_factory.mktemp("ppo"), dict(name="ppo", horizon=8), env, 4)
            jt, tt = JaxTrainer(jcfg), Trainer(tcfg, device="cpu")
            j_state = jax.jit(jt.learner.init)(jax.random.key(1))
            t_state = tt.learner.state_from_params(_convert(tt.learner, j_state.params))
            made[env] = (jcfg, tcfg, jt, tt, j_state, t_state)
        return made[env]

    return get


def _run_jax(jt, max_env_steps):
    """``jt.run(max_env_steps=...)`` -> (final state, final metrics, the
    initial state the run drew), the initial state captured from the
    run's own ``learner.init`` call rather than computed again."""
    init, drawn = jt.learner.init, []

    def capture(key):
        drawn.append(init(key))
        return drawn[-1]

    jt.learner.init = capture
    try:
        final, metrics = jt.run(max_env_steps=max_env_steps)
    finally:
        jt.learner.init = init
    return final, metrics, drawn[0]


@pytest.mark.parametrize("env", ["gym:CartPole-v1", "gym:Pendulum-v1"])
def test_host_rollout_matches_jax(ppo_twins, env):
    """32 steps of 4 envs through each package's host_rollout from the same
    weights and env seed, JAX's action draws injected: every batch leaf
    (discrete actions and env outputs exactly, floats at 1e-5) and the
    finished episodes' returns."""
    B, T = 4, 32
    _, _, jt, tt, j_state, t_state = ppo_twins(env)
    assert not jt.device_mode and not tt.device_mode
    key = jax.random.key(2)
    noise = _rollout_noise(key, T, B, tt.learner)
    j_obs, j_batch, j_stats = jax_host_rollout(jt.env, jt._act, j_state, jt.env.reset(seed=0), key, T)
    t_obs, t_batch, t_stats = host_rollout(
        tt.env, tt.learner, t_state, tt.env.reset(seed=0), T, action_noise=torch.from_numpy(noise)
    )
    _assert_batch_close(t_batch, j_batch)
    np.testing.assert_allclose(t_obs, j_obs, **ROLLOUT_TOL)
    np.testing.assert_allclose(t_stats["returns"], j_stats["returns"], rtol=1e-5)
    assert t_stats["lengths"] == j_stats["lengths"]
    assert bool(t_batch["done"].any()) == (env == "gym:CartPole-v1")
    assert t_batch["obs"].device.type == "cpu" and t_batch["obs"].shape == (T, B, *tt.env.specs.obs.shape)


def _jax_run_key(seed):
    """The key JAX's ``Trainer.run`` splits its iterations' keys from."""
    return jax.random.split(jax.random.key(seed), 3)[0]


@pytest.mark.parametrize("algo", [
    pytest.param(dict(name="ppo", epochs=2, num_minibatches=2), id="ppo"),
    pytest.param(dict(name="impala"), id="impala"),
])
def test_host_alternate_iteration_matches_jax(tmp_path, algo):
    """One iteration of JAX's host-mode Trainer (overlap off: rollout, then
    learn) on gym:CartPole-v1, 4 envs x 16 steps, against the port's
    ``_host_train_iter`` from the same initial weights and env seed with
    JAX's Gumbel draws and epoch permutations injected: params and
    metrics at the learn-level bars."""
    B, T = 4, 16
    jcfg, tcfg = _configs(tmp_path / "jax", dict(algo, horizon=T), "gym:CartPole-v1", B)
    tcfg.session_config.folder = str(tmp_path / "torch")
    jt, tt = JaxTrainer(jcfg), Trainer(tcfg, device="cpu")
    j_final, j_metrics, j_state = _run_jax(jt, T * B)

    _, r_key, l_key, _ = jax.random.split(_jax_run_key(0), 4)
    noise = _rollout_noise(r_key, T, B, tt.learner)
    draws = {}
    if algo["name"] == "ppo":
        bpm = _block_layout(T * B, 2, 4 * 4)
        domain = 2 * bpm if bpm else T * B
        draws["perms"] = torch.from_numpy(
            np.stack([np.asarray(jax.random.permutation(k, domain)) for k in jax.random.split(l_key, 2)]))
    t_state = tt.learner.state_from_params(_convert(tt.learner, j_state.params))
    t_new, _, t_metrics, t_stats = tt._host_train_iter(
        t_state, tt.env.reset(seed=0), action_noise=torch.from_numpy(noise), **draws
    )
    want = _convert(tt.learner, j_final.params)
    for k, v in want.items():
        np.testing.assert_allclose(t_new.params[k].numpy(), v.numpy(), err_msg=k, **PARAM_TOL)
    for k, v in t_metrics.items():
        np.testing.assert_allclose(float(v), j_metrics[k], err_msg=k, **METRIC_TOL)
    assert t_stats["returns"], "no episode finished"
    np.testing.assert_allclose(np.mean(t_stats["returns"]), j_metrics["episode/return"], rtol=1e-6)


# -- DDPG's host loop --------------------------------------------------------

DDPG_B, DDPG_H, DDPG_K, DDPG_BS = 4, 8, 4, 16


def _ddpg_draws(seed, kind, act_dim):
    """Every draw of two iterations of JAX's ``_run_host`` from its keys:
    per rollout step (akey, nkey), the warm-up actions of iteration 0
    (numpy's generator seeded from akey) and the OU normals of iteration 1;
    per update the replay's draw from its sample key (uniform indices over
    the ring's size at the time, or prioritized uniforms)."""
    base_key = jax.random.key(seed + 1)
    ukey, rkey = jax.random.fold_in(base_key, 0), jax.random.fold_in(base_key, 1)
    B, H, K = DDPG_B, DDPG_H, DDPG_K
    warm, normals, samples = [], [], []
    for it in range(2):
        w, n = [], []
        for _ in range(H):
            rkey, akey, nkey = jax.random.split(rkey, 3)
            rng = np.random.default_rng(int(jax.random.randint(akey, (), 0, 2**31 - 1)))
            w.append(rng.uniform(-1.0, 1.0, (B, act_dim)).astype(np.float32))
            n.append(np.asarray(jax.random.normal(nkey, (B, act_dim), jnp.float32)))
        warm.append(np.stack(w))
        normals.append(np.stack(n))
        size = (it + 1) * B * H
        s = []
        for _ in range(K):
            ukey, skey = jax.random.split(ukey)
            if kind == "prioritized":
                s.append(np.asarray(jax.random.uniform(skey, (DDPG_BS,))))
            else:
                s.append(np.asarray(jax.random.randint(skey, (DDPG_BS,), 0, size)))
        samples.append(np.stack(s))
        ukey, _ = jax.random.split(ukey)  # the hook key
    return warm, normals, samples


# each leaf's update within 1% of JAX's in norm (tests/test_torch_ddpg.py)
SLICE_UPDATE_RTOL = 1e-2


@pytest.mark.parametrize("kind,n_step", [("uniform", 1), ("uniform", 3), ("prioritized", 1), ("prioritized", 3)])
def test_ddpg_host_iterations_match_jax(tmp_path, kind, n_step):
    """Two iterations of JAX's ``_run_host`` (overlap off) on gym:Pendulum-v1,
    4 envs x 8 steps, 4 updates of 16 from the first insert on, the first
    iteration under warm-up actions, the second with OU noise, against the
    port's ``_explore_rollout`` + ``_host_update`` with JAX's draws: each
    leaf's update within 1% of JAX's in norm, the last iteration's
    metrics at the learn-level bars (the update ratio at 5e-2, as the
    DDPG slice test holds it)."""
    B, H = DDPG_B, DDPG_H
    algo = dict(name="ddpg", horizon=H, updates_per_iter=DDPG_K, n_step=n_step,
                exploration=dict(warmup_steps=B * H))
    replay = dict(kind=kind, capacity=512, start_sample_size=B * H, batch_size=DDPG_BS)
    jcfg, tcfg = _configs(tmp_path / "jax", algo, "gym:Pendulum-v1", B, replay)
    jt, tt = JaxOffPolicyTrainer(jcfg), OffPolicyTrainer(tcfg, device="cpu")
    total = 2 * B * H
    j_final, j_metrics, j_state = _run_jax(jt, total)
    t_state = tt.learner.state_from_params(*ddpg_params_from_jax(
        _np_tree(j_state.actor_params), _np_tree(j_state.critic_params)))
    start = (dict(t_state.actor_params), dict(t_state.critic_params))
    warm, normals, samples = _ddpg_draws(0, kind, tt.act_dim)
    roll = tt.host_roll_state(tt.env.reset(seed=0), 0)
    replay_state, tail = tt.replay.init(tt._replay_example()), tt._fake_tail()
    for it in range(2):
        traj, _ = tt._explore_rollout(roll, t_state, it == 0, warmup_actions=warm[it],
                                      action_noise=torch.from_numpy(normals[it]))
        t_state, replay_state, tail, t_metrics = tt._host_update(
            t_state, replay_state, tail, to_device(traj, tt.device), it == 0, tt._beta(it * B * H, total),
            sample_draws=torch.from_numpy(samples[it]),
        )
    want = ddpg_params_from_jax(_np_tree(j_final.actor_params), _np_tree(j_final.critic_params))
    for got, wanted, began in zip((t_state.actor_params, t_state.critic_params), want, start):
        for k in wanted:
            moved = (wanted[k] - began[k]).norm()
            assert moved > 0, k
            assert (got[k] - wanted[k]).norm() <= SLICE_UPDATE_RTOL * moved, k
    ratio = "health/update_ratio"
    np.testing.assert_allclose(float(t_metrics.pop(ratio)), j_metrics[ratio], rtol=5e-2)
    for k, v in t_metrics.items():
        np.testing.assert_allclose(float(v), j_metrics[k], err_msg=k, **METRIC_TOL)
    assert int(replay_state.size if kind == "uniform" else replay_state.ring.size) == total


# -- the host evaluator ------------------------------------------------------

@pytest.mark.parametrize("env", ["gym:CartPole-v1", "gym:Pendulum-v1"])
def test_host_evaluator_matches_jax(ppo_twins, env):
    """The evaluator on a host env (3 parallel episodes of its own env
    instance, deterministic mode) against JAX's ``_host_eval`` from the
    same weights: return, length and success. Pendulum's 200-step
    episodes integrate the deterministic actions, which differ from JAX's
    by float rounding."""
    jcfg, tcfg, jt, tt, j_state, t_state = ppo_twins(env)
    ev_cfg = dict(episodes=3, mode="deterministic")
    j_ev = JaxEvaluator(jcfg.env_config, JaxConfig(ev_cfg).extend(jcfg.session_config.eval), jt.learner)
    t_ev = Evaluator(tcfg.env_config, Config(ev_cfg).extend(tcfg.session_config.eval), tt.learner)
    for _ in range(2):  # a second eval continues the env's streams, in both
        want = j_ev.evaluate(j_state, jax.random.key(0))
        got = t_ev.evaluate(t_state, key=0)
        assert got.keys() == want.keys()
        np.testing.assert_allclose([got[k] for k in want], [want[k] for k in want], rtol=1e-5)
    assert got["eval/length"] == (200.0 if env == "gym:Pendulum-v1" else got["eval/length"])
    t_ev.close()


# -- the overlap loop --------------------------------------------------------

def _host_trainer(tmp_path, overlap=True, algo=None, **session):
    _, cfg = _configs(tmp_path, algo or dict(name="ppo", horizon=8, epochs=1, num_minibatches=1),
                      "gym:CartPole-v1", 4, topology=dict(overlap_rollouts=overlap), **session)
    return Trainer(cfg, device="cpu")


def test_overlap_loop_counts_steps_and_discards_the_in_flight_rollout(tmp_path, monkeypatch):
    """Five iterations: five learns, 5 x 32 env steps counted, the rollouts
    the collector made past the stop discarded uncounted, and the
    collector stopped."""
    collected = []
    real = trainer_mod.host_rollout

    def counting(*a, **kw):
        out = real(*a, **kw)
        collected.append(out[1]["reward"].shape)
        return out

    monkeypatch.setattr(trainer_mod, "host_rollout", counting)
    tr = _host_trainer(tmp_path)
    learns = []
    real_learn = tr.learner.learn
    tr.learner.learn = lambda *a, **kw: learns.append(1) or real_learn(*a, **kw)
    iters = []
    _, m = tr.run(max_env_steps=5 * 32, on_metrics=lambda i, m: iters.append(i))
    assert iters == [1, 2, 3, 4, 5] and len(learns) == 5
    assert m["time/env_steps"] == 5 * 32
    assert len(collected) >= 5  # at most one in flight and one queued were dropped
    assert all(t.name != "host-collector" for t in __import__("threading").enumerate())


def test_apply_module_is_thread_safe(tmp_path):
    """Threads acting through acting copies of one learner, each made on
    the main thread before its thread starts, while the main thread
    applies the learner's own module with other parameters (more threads
    than cores, a short switch interval): every call gets the output of
    its own parameters, as the collector's acting does during a learn."""
    import sys
    import threading

    learner = _host_trainer(tmp_path).learner
    x = torch.randn(32, 4, generator=torch.Generator().manual_seed(0))
    n = 8
    params = [learner.init(torch.Generator().manual_seed(i)).params for i in range(n + 1)]
    want = [learner.apply(p, x) for p in params]
    same = lambda a, b: all(torch.equal(u, v) for u, v in zip(a, b))  # noqa: E731
    bad, errors = [], []

    def work(i, actor):
        try:
            for _ in range(100):
                if not same(actor.apply(params[i], x), want[i]):
                    bad.append(i)
        except BaseException as e:
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work, args=(i, learner.acting_copy())) for i in range(n)]
        for t in threads:
            t.start()
        for _ in range(100):  # the main thread's learn applies the module itself meanwhile
            if not same(learner.apply(params[n], x), want[n]):
                bad.append(n)
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads) and not errors and not bad


def test_overlap_loop_raises_collector_errors_on_the_main_thread(tmp_path):
    tr = _host_trainer(tmp_path)
    calls = [0]
    real_step = tr.env.step

    def failing(actions):
        calls[0] += 1
        if calls[0] > 20:
            raise RuntimeError("env crashed in the collector")
        return real_step(actions)

    tr.env.step = failing
    with pytest.raises(RuntimeError, match="env crashed in the collector"):
        tr.run(max_env_steps=10 * 32)


@pytest.mark.parametrize("overlap", [True, False])
def test_host_loops_roll_back_after_nan_state(tmp_path, overlap):
    """``nan_state`` before iteration 4 poisons its learn; the run rolls
    back to the checkpoint of iteration 2 with the LR backed off and ends
    finite, in both host loops (the overlap loop drops a queued rollout of
    the poisoned policy)."""
    tr = _host_trainer(tmp_path, overlap, checkpoint=dict(every_n_iters=2),
                       faults=dict(plan=[{"site": "trainer.iteration", "kind": "nan_state", "at": 3}]))
    seen = []
    try:
        state, m = tr.run(max_env_steps=6 * 32, on_metrics=lambda i, m: seen.append((i, m["health/nonfinite"])))
    finally:
        faults.configure(None)
    assert seen[:4] == [(1, 0.0), (2, 0.0), (3, 0.0), (4, 1.0)]
    assert [i for i, _ in seen[4:]] == [3, 4, 5, 6] and all(n == 0.0 for _, n in seen[4:])
    assert float(state.opt_state.recovery_scale) == 0.5
    events = list(_iter_jsonl(os.path.join(str(tmp_path), "telemetry", "events.jsonl")))
    assert [e["kind"] for e in events if e["type"] == "recovery"] == ["tripped", "rollback"]


def test_ddpg_host_overlap_runs_with_include_replay(tmp_path):
    """DDPG's host loop under the staging thread (prioritized, n-step 3):
    three iterations, the replay saved with the checkpoints, and a relaunch
    that resumes from the saved ring bit for bit."""
    algo = dict(name="ddpg", horizon=8, updates_per_iter=2, n_step=3, exploration=dict(warmup_steps=32))
    replay = dict(kind="prioritized", capacity=256, start_sample_size=32, batch_size=8)
    _, cfg = _configs(tmp_path, algo, "gym:Pendulum-v1", 4, replay, topology=dict(overlap_rollouts=True),
                      checkpoint=dict(every_n_iters=3, include_replay=True))
    def snapshot(replay_state):  # the ring is updated in place
        return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in tree_flatten(replay_state).items()}

    def spying(tr, into):
        real = tr._host_update

        def spy(state, replay_state, *a, **kw):
            into.append(snapshot(replay_state))
            out = real(state, replay_state, *a, **kw)
            into.append(snapshot(out[1]))
            return out

        tr._host_update = spy
        return tr

    saved, resumed = [], []
    _, m = spying(OffPolicyTrainer(cfg, device="cpu"), saved).run(max_env_steps=3 * 32)
    assert m["time/env_steps"] == 3 * 32 and np.isfinite(m["loss/critic"])
    spying(OffPolicyTrainer(cfg, device="cpu"), resumed).run(max_env_steps=4 * 32)
    want, got = saved[-1], resumed[0]
    assert want["ring/cursor"] == 96 and got.keys() == want.keys()
    for k, v in want.items():
        assert torch.equal(got[k], v) if isinstance(v, torch.Tensor) else got[k] == v, k


# -- the CLI and the refusals ------------------------------------------------

def test_train_cli_on_a_host_env(tmp_path, capsys):
    """``python -m surreal_tpu_torch train ppo gym:CartPole-v1 --set
    session_config.backend=cpu`` end to end: config.json, a checkpoint, the
    host evaluator's metrics and the final metrics line."""
    folder = str(tmp_path / "run")
    rc = torch_launch.main([
        "train", "ppo", "gym:CartPole-v1", "--folder", folder, "--num-envs", "4", "--total-steps", "96",
        "--set", "session_config.backend=cpu", "learner_config.algo.horizon=8", "learner_config.algo.epochs=1",
        "learner_config.algo.num_minibatches=1", "session_config.eval.every_n_iters=3",
        "session_config.eval.episodes=2", "session_config.checkpoint.every_n_iters=3", "session_config.metrics.every_n_iters=1",
        "session_config.metrics.tensorboard=false", "session_config.metrics.console=false",
    ])
    assert rc == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["time/env_steps"] == 96 and np.isfinite(final["loss/pg"]) and final["eval/length"] > 0
    assert os.path.isfile(os.path.join(folder, "config.json"))
    assert os.path.isdir(os.path.join(folder, "checkpoints", "3"))


def test_host_paths_refuse_what_the_port_does_not_carry(tmp_path, monkeypatch, capsys):
    def cfg(algo="ppo", env="gym:CartPole-v1", **over):
        tree = dict(learner_config=dict(algo=dict(name=algo), **over), env_config=dict(name=env, num_envs=2),
                    session_config=dict(folder=str(tmp_path)))
        return Config(tree).extend(base_config())

    # env workers on a host env select the SEED topology (tests/test_torch_seed.py runs it)
    host_seed = cfg()
    host_seed.session_config.topology.num_env_workers = 2
    assert isinstance(torch_launch.select_trainer(host_seed, "cpu"), SEEDTrainer)
    device_seed = cfg(env="jax:lift")
    device_seed.session_config.topology.num_env_workers = 2
    with pytest.raises(ValueError, match="needs a HOST env"):
        torch_launch.select_trainer(device_seed, "cpu")
    # the remote experience plane runs on a host env (tests/test_torch_experience.py), with no
    # in-process replay object; a device env keeps its device-resident replay
    remote = OffPolicyTrainer(cfg("ddpg", "gym:Pendulum-v1", replay=dict(kind="remote")), device="cpu")
    assert remote.remote and remote.replay is None
    with pytest.raises(ValueError, match="device-resident replay"):
        OffPolicyTrainer(cfg("ddpg", "jax:lift", replay=dict(kind="remote")), device="cpu")
    with pytest.raises(ValueError, match="fifo"):
        OffPolicyTrainer(cfg("ddpg", "gym:Pendulum-v1", replay=dict(kind="fifo")), device="cpu")
    with pytest.raises(ValueError, match="device env"):
        Trainer(cfg(model=dict(encoder=dict(kind="trajectory"))), device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for trainer_cls, args in ((Trainer, ()), (OffPolicyTrainer, ("ddpg", "gym:Pendulum-v1"))):
        with pytest.raises(RuntimeError, match="cuda"):
            trainer_cls(cfg(*args))
