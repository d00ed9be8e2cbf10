"""The port's SEED topology (``distributed/inference_server.py``,
``distributed/env_worker.py``, ``launch/seed_trainer.py``) against the JAX
package's, on the CPU:

- chunk parity: the JAX ``InferenceServer`` fed by a JAX worker thread and
  the port's fed by a port worker thread, one worker on seeded
  gym:CartPole-v1 with a numpy policy that depends only on each row's obs
  (so batching cannot change it), assemble the same first three chunks,
  bit for bit in every key, under pickle and shm, pipelined or not;
- learn parity: one chunk from the JAX server, learned by the JAX
  ``SEEDTrainer``'s learn program and by the port's from the same weights
  (PPO with JAX's epoch permutations injected), at the learn-level bars;
- the behaviour of tests/test_distributed.py's and tests/test_faults.py's
  SEED cases on the port; the server acting through an acting copy while
  the main thread learns; the CLI.

Every wait is bounded; no assertion is on speed."""

import json
import os
import pickle
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

import surreal_tpu.main.launch as jax_launch
import surreal_tpu_torch.main.launch as torch_launch
from surreal_tpu.distributed import InferenceServer as JaxInferenceServer
from surreal_tpu.distributed import run_env_worker as jax_run_env_worker
from surreal_tpu.launch.seed_trainer import SEEDTrainer as JaxSEEDTrainer
from surreal_tpu.learners.ppo import _block_layout
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import BASE_ENV_CONFIG as JAX_BASE_ENV_CONFIG
from surreal_tpu.session.default_configs import base_config as jax_base_config
from surreal_tpu_torch.distributed import InferenceServer, run_env_worker
from surreal_tpu_torch.distributed.sockets import Dealer
from surreal_tpu_torch.launch.seed_trainer import SEEDTrainer, _DataPlane, read_back
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import BASE_ENV_CONFIG, base_config
from surreal_tpu_torch.session.telemetry import Tracer, _iter_jsonl
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.convert import categorical_params_from_jax, params_from_jax

# the learn-level bars (tests/test_torch_ppo.py)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)
PARAM_TOL = dict(rtol=0, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_faults():
    faults.configure(None)
    yield
    faults.configure(None)


def _policy(continuous: bool):
    """A numpy policy whose actions and info depend only on each row's obs:
    a categorical head (2 actions) or a Gaussian one (1 action)."""

    def act_fn(obs):
        b = obs.shape[0]
        flat = np.nan_to_num(obs.reshape(b, -1).astype(np.float32))
        s = flat.sum(axis=1)
        if continuous:
            mean = np.tanh(0.3 * s)[:, None].astype(np.float32)
            log_std = np.full((b, 1), -0.5, np.float32)
            action = (mean + 0.1 * np.sin(3.0 * s)[:, None]).astype(np.float32)
            z = (action - mean) / np.exp(log_std)
            logp = (-0.5 * z**2 - log_std - 0.5 * np.log(2 * np.pi)).sum(axis=1).astype(np.float32)
            return action, {"logp": logp, "mean": mean, "log_std": log_std, "value": s.astype(np.float32)}
        logits = np.stack([0.5 * s, -0.5 * s], axis=1).astype(np.float32)
        action = (s > 0).astype(np.int32)
        logz = np.log(np.exp(logits).sum(axis=1))
        logp = (logits[np.arange(b), action] - logz).astype(np.float32)
        return action, {"logp": logp, "logits": logits, "value": s.astype(np.float32)}

    return act_fn


def _collect(server_cls, worker, env_cfg, n_chunks, unroll=8, continuous=False, **worker_kw):
    """The first ``n_chunks`` chunks a server assembles from one worker
    thread (``_t_ready`` popped)."""
    server = server_cls(act_fn=_policy(continuous), unroll_length=unroll, transport="auto")
    stop = threading.Event()
    w = threading.Thread(target=worker, args=(env_cfg, server.address, 0),
                         kwargs=dict(stop_event=stop, **worker_kw), daemon=True)
    try:
        w.start()
        chunks = [server.chunks.get(timeout=30) for _ in range(n_chunks)]
    finally:
        stop.set()
        server.close()
        w.join(timeout=10)
    assert not w.is_alive()
    for c in chunks:
        c.pop("_t_ready")
    return chunks


def _assert_equal_trees(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_equal_trees(got[k], want[k], f"{path}/{k}")
        else:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, f"{path}/{k}"
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path}/{k}")


@pytest.mark.parametrize("pipeline", [False, True], ids=["serial", "pipelined"])
@pytest.mark.parametrize("transport", ["pickle", "shm"])
def test_chunks_equal_the_reference_servers(transport, pipeline):
    """The first three chunks, every key (obs, next_obs, action, reward,
    done, terminated, the behaviour info, param_version, lineage), bit for
    bit; pipelined, the two sub-slices' chunks arrive alternately in both."""
    kw = dict(transport=transport, pipeline=pipeline)
    want = _collect(JaxInferenceServer, jax_run_env_worker,
                    JaxConfig(name="gym:CartPole-v1", num_envs=4).extend(JAX_BASE_ENV_CONFIG), 3, **kw)
    got = _collect(InferenceServer, run_env_worker,
                   Config(name="gym:CartPole-v1", num_envs=4).extend(BASE_ENV_CONFIG), 3, **kw)
    for g, w in zip(got, want):
        _assert_equal_trees(g, w)
    width = 2 if pipeline else 4
    assert got[0]["obs"].shape == (8, width, 4) and "lineage" in got[0]


def _learn_configs(tmp_path, algo: dict, env: str, num_envs: int):
    shared = dict(
        learner_config=dict(algo=dict(precision="f32", **algo)),
        env_config=dict(name=env, num_envs=num_envs),
        session_config=dict(folder=str(tmp_path), topology=dict(num_env_workers=1)),
    )
    return JaxConfig(shared).extend(jax_base_config()), Config(shared).extend(base_config())


@pytest.mark.parametrize("algo,env", [
    pytest.param(dict(name="impala", horizon=16), "gym:CartPole-v1", id="impala-cartpole"),
    pytest.param(dict(name="ppo", horizon=16, epochs=2, num_minibatches=2), "gym:Pendulum-v1", id="ppo-pendulum"),
])
def test_seed_learn_on_a_chunk_matches_jax(tmp_path, algo, env):
    """One chunk from the JAX server (one pipelined worker, chunks [16, 2]),
    through the JAX SEEDTrainer's learn program and the port's, from the
    same weights: params atol 1e-5, metrics rtol 1e-4 / atol 1e-5."""
    jcfg, tcfg = _learn_configs(tmp_path, algo, env, 4)
    (chunk,) = _collect(JaxInferenceServer, jax_run_env_worker, JaxConfig(jcfg.env_config), 1,
                        unroll=algo["horizon"], continuous=env == "gym:Pendulum-v1", pipeline=True)
    jt, tt = JaxSEEDTrainer(jcfg), SEEDTrainer(tcfg, device="cpu")
    j_state = jax.jit(jt.learner.init)(jax.random.key(3))
    lkey = jax.random.key(4)
    j_chunk = {k: v for k, v in chunk.items() if k not in ("param_version", "lineage")}
    j_new, j_metrics = jt._learn(j_state, jax.device_put(j_chunk), lkey)

    convert = categorical_params_from_jax if tt.learner.discrete else params_from_jax
    t_state = tt.learner.state_from_params(convert(jax.tree.map(np.asarray, j_state.params)))
    batch, versions, n_steps, lineage, exemplar = tt._stage(dict(chunk), Tracer(None))
    assert n_steps == algo["horizon"] * 2 and (versions == 0).all() and exemplar is None
    assert set(lineage) == {"worker", "episode", "step"}
    draws = {}
    if algo["name"] == "ppo":
        T, B = chunk["reward"].shape
        bpm = _block_layout(T * B, algo["num_minibatches"], 3 * 4)
        domain = algo["num_minibatches"] * bpm if bpm else T * B
        draws["perms"] = torch.from_numpy(np.stack(
            [np.asarray(jax.random.permutation(k, domain)) for k in jax.random.split(lkey, algo["epochs"])]))
    t_new, t_metrics = tt._learn(t_state, batch, None, **draws)
    want = convert(jax.tree.map(np.asarray, j_new.params))
    for k, v in want.items():
        np.testing.assert_allclose(t_new.params[k].numpy(), v.numpy(), err_msg=k, **PARAM_TOL)
    for k, v in t_metrics.items():
        np.testing.assert_allclose(float(v), float(j_metrics[k]), err_msg=k, **METRIC_TOL)


def test_read_back_is_one_copy_of_every_leaf():
    """The serve's device->host read: every leaf back with its dtype and
    shape, bit for bit."""
    g = torch.Generator().manual_seed(0)
    action = torch.randint(0, 3, (5,), generator=g, dtype=torch.int32)
    info = {"logp": torch.randn(5, generator=g), "logits": torch.randn(5, 3, generator=g),
            "mean": torch.randn(5, 2, generator=g).double()}
    a, got = read_back(action, info)
    assert a.dtype == np.int32 and (a == action.numpy()).all()
    for k, v in info.items():
        assert got[k].dtype == v.numpy().dtype and got[k].shape == tuple(v.shape)
        np.testing.assert_array_equal(got[k], v.numpy())


# -- the server and workers (tests/test_distributed.py) ------------------------

def _worker_thread(server, env_cfg, i, stop, **kw):
    w = threading.Thread(target=run_env_worker, args=(env_cfg, server.address, i),
                         kwargs=dict(stop_event=stop, **kw), daemon=True)
    w.start()
    return w


def _cartpole(num_envs):
    return Config(name="gym:CartPole-v1", num_envs=num_envs).extend(BASE_ENV_CONFIG)


def test_seed_inference_server_with_env_workers():
    """Two worker threads on CartPole against one batched policy: well
    formed time-major chunks whose rewards are the recorded actions'
    outcomes (CartPole pays 1.0 every step)."""
    server = InferenceServer(act_fn=_policy(False), unroll_length=8)
    stop = threading.Event()
    workers = [_worker_thread(server, _cartpole(3), i, stop, max_steps=600) for i in range(2)]
    try:
        chunk = server.chunks.get(timeout=30)
        assert chunk["obs"].shape == chunk["next_obs"].shape == (8, 3, 4)
        assert chunk["action"].shape == chunk["reward"].shape == (8, 3) and chunk["done"].dtype == bool
        assert chunk["behavior"]["logits"].shape == (8, 3, 2)
        np.testing.assert_allclose(chunk["reward"], 1.0)
    finally:
        stop.set()
        server.close()
        for w in workers:
            w.join(timeout=10)
    assert not any(w.is_alive() for w in workers)


def test_inference_server_tags_param_versions():
    """Every transition carries the version of the params that chose it;
    set_act_fn bumps the version."""
    server = InferenceServer(act_fn=_policy(False), unroll_length=4)
    stop = threading.Event()
    w = _worker_thread(server, _cartpole(2), 0, stop, max_steps=4000)
    try:
        assert server.version == 0
        chunk = server.chunks.get(timeout=30)
        assert chunk["param_version"].shape == (4, 2) and (chunk["param_version"] == 0).all()
        server.set_act_fn(_policy(False))
        server.set_act_fn(_policy(False))
        assert server.version == 2
        for _ in range(200):  # fresh chunks are soon tagged v2
            chunk = server.chunks.get(timeout=30)
            if (chunk["param_version"] == 2).all():
                break
        else:
            pytest.fail("no chunk tagged with the new params version")
    finally:
        stop.set()
        server.close()
        w.join(timeout=10)


class _SentCapture:
    """Stand-in ROUTER capturing send_multipart payloads."""

    def __init__(self):
        self.sent = []

    def send_multipart(self, parts):
        self.sent.append(parts)


def _stopped_server(act_fn, unroll=1):
    """An InferenceServer whose loop is stopped and whose socket is a
    capture, so _serve_batch runs synchronously on the test thread."""
    server = InferenceServer(act_fn=act_fn, unroll_length=unroll)
    server.close()
    server._stop.clear()
    server._sock = _SentCapture()
    return server


def test_single_request_fast_path_matches_batched():
    """The lone-request fast path (no gather, no re-slice) gives records,
    replies and chunks identical to the batched path on the same obs."""

    def act_fn(obs):
        obs = np.asarray(obs)
        return obs * 2.0 + 1.0, {"logp": obs.sum(axis=1)}

    rng = np.random.default_rng(0)
    o1, o2 = rng.normal(size=(3, 4)).astype(np.float32), rng.normal(size=(2, 4)).astype(np.float32)
    r1, r2 = rng.normal(size=3).astype(np.float32), rng.normal(size=2).astype(np.float32)
    d1, d2 = np.array([False, True, False]), np.array([True, False])
    single, batched = _stopped_server(act_fn), _stopped_server(act_fn)
    single._serve_batch([(b"w1", {"obs": o1})])
    single._serve_batch([(b"w2", {"obs": o2})])
    batched._serve_batch([(b"w1", {"obs": o1}), (b"w2", {"obs": o2})])
    single._serve_batch([(b"w1", {"obs": o1 + 0.5, "reward": r1, "done": d1})])
    single._serve_batch([(b"w2", {"obs": o2 - 0.5, "reward": r2, "done": d2})])
    batched._serve_batch([(b"w1", {"obs": o1 + 0.5, "reward": r1, "done": d1}),
                          (b"w2", {"obs": o2 - 0.5, "reward": r2, "done": d2})])

    def replies(server):
        out = {}
        for ident, payload in server._sock.sent:
            slot, actions = pickle.loads(payload)
            assert slot == 0
            out.setdefault(ident, []).append(actions)
        return out

    rs, rb = replies(single), replies(batched)
    assert set(rs) == set(rb) == {b"w1", b"w2"}
    for ident in rs:
        assert len(rs[ident]) == len(rb[ident]) == 2
        for a, b in zip(rs[ident], rb[ident]):
            np.testing.assert_array_equal(a, b)

    def chunks(server):
        got = []
        while not server.chunks.empty():
            c = server.chunks.get_nowait()
            c.pop("_t_ready")
            got.append(c)
        return sorted(got, key=lambda c: c["obs"].sum())

    cs, cb = chunks(single), chunks(batched)
    assert len(cs) == len(cb) == 2
    for a, b in zip(cs, cb):
        _assert_equal_trees(a, b)


def test_full_queue_drops_the_oldest_chunk():
    """On a full chunk queue the OLDEST chunk is evicted (counted in chunks
    and steps), so a lagging learner sees the freshest data."""
    server = InferenceServer(act_fn=_policy(False), unroll_length=2)
    server.chunks.maxsize = 2
    stop = threading.Event()
    w = _worker_thread(server, _cartpole(1), 0, stop, max_steps=100_000)
    try:
        for _ in range(300):  # bounded: at most 30 s
            if server.evicted_chunks >= 3:
                break
            time.sleep(0.1)
        server.set_act_fn(_policy(False))
        at_bump = server.evicted_chunks
        for _ in range(300):  # chunks acted after the bump displace the older ones
            if server.evicted_chunks >= at_bump + 5:
                break
            time.sleep(0.1)
        assert server.chunks.full() and server.evicted_chunks >= at_bump + 5
        assert server.evicted_steps == server.evicted_chunks * 2
        c1, c2 = server.chunks.get(timeout=5), server.chunks.get(timeout=5)
        assert c2["param_version"].max() >= c1["param_version"].max() == 1
    finally:
        stop.set()
        server.close()
        w.join(timeout=10)


def test_dropped_partial_chunk_on_worker_rehello():
    """A respawned worker's obs-only hello under an identity with half-built
    steps DROPS the partial chunk (splicing its fresh episode onto the dead
    worker's steps would hide an episode boundary from GAE/V-trace)."""
    server = InferenceServer(act_fn=lambda obs: (np.zeros(len(obs), np.int64),
                                                 {"logp": np.zeros(len(obs), np.float32)}), unroll_length=4)

    def connect():
        s = Dealer(b"worker-0", send_timeout_s=5.0)
        s.connect(server.address)
        return s

    def xchg(s, msg):
        s.send(pickle.dumps(msg, protocol=5))
        assert s.poll(5000), "server did not reply"
        return pickle.loads(s.recv())

    obs = np.zeros((2, 3), np.float32)
    step = {"obs": obs, "reward": np.ones(2, np.float32), "done": np.zeros(2, bool),
            "truncated": np.zeros(2, bool), "terminal_obs": obs}
    try:
        w1 = connect()
        xchg(w1, {"obs": obs})
        xchg(w1, dict(step, obs=obs + 1))
        xchg(w1, dict(step, obs=obs + 2))
        w1.close()  # the worker dies mid-chunk
        w2 = connect()  # respawned, same identity
        xchg(w2, {"obs": obs + 10})
        for k in range(4):
            xchg(w2, dict(step, obs=obs + 11 + k))
        chunk = server.chunks.get(timeout=5)
        assert chunk["obs"].shape == (4, 2, 3)
        np.testing.assert_allclose(chunk["obs"][0], 10.0)
        assert server.chunks.empty()
        w2.close()
    finally:
        server.close()


@pytest.mark.parametrize("transport", ["shm", "pickle"])
def test_corrupt_slab_slot_is_sanitized_not_propagated(transport):
    """``corrupt_slab`` NaN-stomps an outgoing obs payload; the server
    sanitizes and counts it, and every chunk stays finite."""
    faults.configure([{"site": "transport.send", "kind": "corrupt_slab", "at": 10, "times": 2}])
    server = InferenceServer(act_fn=_policy(False), unroll_length=8, transport="auto")
    stop = threading.Event()
    w = _worker_thread(server, _cartpole(3), 0, stop, max_steps=240, transport=transport)
    try:
        w.join(timeout=60)
        assert not w.is_alive()
        chunks = []
        for _ in range(50):
            try:
                chunks.append(server.chunks.get(timeout=0.3))
            except Exception:
                break
        assert server.sanitized_requests >= 1
        assert server.queue_stats()["server/sanitized_requests"] >= 1.0
        assert chunks, "no trajectory chunks assembled"
        for c in chunks:
            assert np.isfinite(c["obs"]).all() and np.isfinite(c["next_obs"]).all()
    finally:
        stop.set()
        server.close()


# -- the trainer (tests/test_distributed.py, tests/test_faults.py) ------------

def _seed_cfg(folder, total, algo=None, num_envs=4, ckpt_every=0, plan=None, **topo):
    return Config(
        learner_config=Config(algo=Config(algo or dict(name="impala", horizon=8))),
        env_config=Config(name="gym:CartPole-v1", num_envs=num_envs),
        session_config=Config(
            folder=str(folder), total_env_steps=total,
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=ckpt_every), eval=Config(every_n_iters=0),
            topology=Config(num_env_workers=topo.pop("num_env_workers", 1), **topo),
            faults=Config(plan=plan),
        ),
    ).extend(base_config())


def test_seed_trainer_impala_runs(tmp_path):
    """Workers -> batched inference -> IMPALA learn, a few hundred steps:
    finite metrics, the data-plane gauges, lineage and trace gauges, the
    data_plane and hops events."""
    trainer = SEEDTrainer(_seed_cfg(tmp_path, 600, num_env_workers=2), device="cpu")
    seen = []
    state, metrics = trainer.run(on_metrics=lambda it, m: seen.append(m))
    assert seen and int(state.iteration) >= 1 and metrics["time/env_steps"] >= 600
    for k, v in seen[-1].items():
        assert np.isfinite(v), k
    for key in ("staleness/updates_behind", "lineage/staleness_p50", "lineage/staleness_max", "trace/spans",
                "server/serve_ms", "server/wire_bytes_per_step", "workers/respawns", "server/chunk_age_s"):
        assert key in metrics, key
    events = list(_iter_jsonl(os.path.join(str(tmp_path), "telemetry", "events.jsonl")))
    types = {e["type"] for e in events}
    assert {"data_plane", "hops"} <= types
    spans = [e for e in events if e["type"] == "span" and "exemplar" in e]
    assert {"worker.step", "replica.forward"} <= {e["name"] for e in spans}


def test_seed_trainer_max_staleness_accounting(tmp_path):
    """A max_staleness that never drops: zero drops and discarded steps,
    and queue evictions (if any) counted chunk by chunk."""
    algo = dict(name="impala", horizon=4)
    trainer = SEEDTrainer(_seed_cfg(tmp_path, 200, algo, num_envs=2, num_env_workers=2),
                          max_staleness=1_000_000, device="cpu")
    _, metrics = trainer.run()
    assert metrics["staleness/dropped_chunks"] == 0.0 and metrics["staleness/steps_discarded"] == 0.0
    assert "server/queue_depth" in metrics
    assert metrics["server/evicted_steps"] == metrics["server/evicted_chunks"] * 4 * (2 // 2)


def test_seed_worker_mode_and_staleness_wired_from_config():
    """topology.worker_mode and algo.max_staleness reach the trainer from
    the CLI path (build_config --set)."""

    class A:
        algo, env, num_envs, folder = "impala", "gym:CartPole-v1", 2, "/tmp/seed_cfg"
        total_steps = restore_from = None
        workers = 2
        set = ["session_config.topology.worker_mode=process", "learner_config.algo.max_staleness=7",
               "session_config.backend=cpu"]

    trainer = torch_launch.select_trainer(torch_launch.build_config(A), "cpu")
    assert isinstance(trainer, SEEDTrainer)
    assert (trainer.worker_mode, trainer.max_staleness) == ("process", 7)

    class B(A):
        set = []

    t2 = torch_launch.select_trainer(torch_launch.build_config(B), "cpu")
    assert (t2.worker_mode, t2.max_staleness) == ("thread", None)

    class C(A):
        set = ["session_config.topology.worker_mode=fiber"]

    with pytest.raises(ValueError, match="worker_mode"):
        torch_launch.select_trainer(torch_launch.build_config(C), "cpu")


def test_seed_stale_streak_honors_env_step_budget(tmp_path):
    """max_staleness=-1 drops EVERY chunk: the steps still count, so the
    run ends on its budget, having trained nothing."""
    algo = dict(name="impala", horizon=4)
    trainer = SEEDTrainer(_seed_cfg(tmp_path, 64, algo, num_envs=2), max_staleness=-1, device="cpu")
    state, metrics = trainer.run()
    assert int(state.iteration) == 0
    assert metrics["staleness/dropped_chunks"] >= 16 and metrics["time/env_steps"] >= 64


def test_seed_trainer_ppo_with_staleness_guard(tmp_path):
    """PPO over SEED: behaviour info flows through the chunks, the
    staleness guard is active, training completes."""
    algo = dict(name="ppo", horizon=8, epochs=2, num_minibatches=1)
    trainer = SEEDTrainer(_seed_cfg(tmp_path, 320, algo, num_env_workers=2), max_staleness=3, device="cpu")
    _, metrics = trainer.run()
    assert np.isfinite(metrics["loss/pg"]) and np.isfinite(metrics["loss/value"])
    assert metrics["staleness/dropped_chunks"] >= 0.0 and metrics["time/env_steps"] >= 320


def test_seed_episode_stats_flow_from_workers_to_metrics(tmp_path):
    trainer = SEEDTrainer(_seed_cfg(tmp_path, 1500, num_env_workers=2), device="cpu")
    _, metrics = trainer.run()
    assert metrics["episode/return"] > 0 and metrics["episode/length"] > 1


def test_seed_trainer_refuses_what_it_does_not_carry(tmp_path):
    ddpg = Config(learner_config=Config(algo=Config(name="ddpg")), env_config=Config(name="gym:Pendulum-v1", num_envs=2),
                  session_config=Config(folder=str(tmp_path))).extend(base_config())
    with pytest.raises(ValueError, match="OffPolicyTrainer"):
        SEEDTrainer(ddpg, device="cpu")
    traj = _seed_cfg(tmp_path, 8)
    traj.learner_config.model = Config(encoder=Config(kind="trajectory"))
    with pytest.raises(ValueError, match="trajectory"):
        SEEDTrainer(traj, device="cpu")
    for key, over in [
        ("mesh.dp", dict(mesh=dict(dp=2))),
        ("learner_group", dict(learner_group=dict(members=2))),
    ]:
        with pytest.raises(NotImplementedError, match=key):
            SEEDTrainer(_seed_cfg(tmp_path, 8, **over), device="cpu")
    with pytest.raises(ValueError, match="thread|process"):
        SEEDTrainer(_seed_cfg(tmp_path, 8), worker_mode="fiber", device="cpu")


def test_respawn_backoff_defers_hot_loop():
    """A worker that dies at once is respawned base * 2^k apart, capped."""

    class _Dead:
        def is_alive(self):
            return False

    class _Stub:
        spawns = 0

        def _spawn_one(self, i, env_cfg, address, stop):
            self.spawns += 1
            return _Dead()

    stub = _Stub()
    class _Server:
        address = "tcp://127.0.0.1:1"

        def address_for(self, worker_id):
            return self.address

    plane = _DataPlane(stub, _Server(), [_Dead()], None, threading.Event(), 1.0,
                       respawn_backoff_s=0.05, respawn_backoff_cap_s=0.2)
    plane.supervise()
    assert stub.spawns == 1 and plane.respawn_backoff_s == pytest.approx(0.05)
    plane.supervise()  # inside the backoff window: deferred
    assert stub.spawns == 1
    for want, backoff in ((2, 0.1), (3, 0.2), (4, 0.2)):
        time.sleep(plane.respawn_backoff_s + 0.01)
        plane.supervise()
        assert stub.spawns == want and plane.respawn_backoff_s == pytest.approx(backoff)


def test_seed_worker_kill_chaos_respawns_and_reports_backoff(tmp_path):
    """``kill_worker`` at step 25: the sole worker dies, the supervisor
    respawns it under the backoff schedule, the run makes its budget."""
    plan = [{"site": "env_worker.step", "kind": "kill_worker", "at": 25}]
    _, metrics = SEEDTrainer(_seed_cfg(tmp_path, 800, plan=plan), device="cpu").run()
    assert metrics["time/env_steps"] >= 800 and metrics["workers/respawns"] >= 1.0
    assert metrics["workers/respawn_backoff_s"] == pytest.approx(0.5)


def test_seed_dropped_frame_recovers_via_respawn(tmp_path):
    """``drop_frame``: a worker request is swallowed on the wire; the worker
    runs out its (shortened) silence budget and dies, and the respawned
    worker finishes the budget."""
    plan = [{"site": "transport.send", "kind": "drop_frame", "at": 30}]
    cfg = _seed_cfg(tmp_path, 600, plan=plan, worker_silence_s=2.0, respawn_backoff_s=0.05, pipeline_workers=False)
    _, metrics = SEEDTrainer(cfg, device="cpu").run()
    assert metrics["time/env_steps"] >= 600 and metrics["workers/respawns"] >= 1.0


def test_seed_nan_state_rolls_back_and_keeps_serving(tmp_path):
    """A forced-NaN state: the guard trips, the trainer restores the last
    finite checkpoint, re-arms the server's act function from it, and the
    run finishes its budget with finite health."""
    plan = [{"site": "trainer.iteration", "kind": "nan_state", "at": 3}]
    _, metrics = SEEDTrainer(_seed_cfg(tmp_path, 400, plan=plan, ckpt_every=2), device="cpu").run()
    assert metrics["time/env_steps"] >= 400 and metrics["health/nonfinite"] == 0.0
    kinds = [e.get("kind") for e in _iter_jsonl(os.path.join(str(tmp_path), "telemetry", "events.jsonl"))
             if e["type"] == "recovery"]
    assert "tripped" in kinds and "rollback" in kinds


def test_seed_trainer_process_workers(tmp_path):
    """worker_mode='process': spawned env workers feed the same server."""
    trainer = SEEDTrainer(_seed_cfg(tmp_path, 500, num_env_workers=2), worker_mode="process", device="cpu")
    _, metrics = trainer.run()
    assert np.isfinite(metrics["loss/pg"]) and np.isfinite(metrics["loss/value"])
    assert metrics["time/env_steps"] >= 500 and metrics["staleness/updates_behind"] >= 0.0
    assert metrics["server/shm_workers"] >= 1.0  # process + auto negotiates the slabs


@pytest.mark.slow
@pytest.mark.parametrize("workers", [2, 1], ids=["one-of-two", "sole-worker"])
def test_seed_trainer_respawns_killed_process_worker(tmp_path, workers):
    """Terminate a process worker mid-run (the sole one too, which must be
    respawned from inside the chunk wait): it is respawned, and the run
    completes."""
    trainer = SEEDTrainer(_seed_cfg(tmp_path, 1200, num_env_workers=workers), worker_mode="process", device="cpu")
    killed = []

    def cb(it, m):
        if it >= 1 and not killed:
            killed.append(trainer._workers[0].pid)
            trainer._workers[0].terminate()
            trainer._workers[0].join(timeout=5)
        return False

    _, metrics = trainer.run(on_metrics=cb)
    assert killed and metrics["workers/respawns"] >= 1.0 and metrics["time/env_steps"] >= 1200


def test_server_acting_copy_is_safe_while_the_main_thread_learns(tmp_path):
    """The server thread acts through an acting copy on a fixed state while
    the main thread learns with the learner's own modules (more threads
    than needed, a short switch interval): every served row's logits and
    value are the fixed state's, as the SEED trainer's serving is during
    its learns."""
    trainer = SEEDTrainer(_seed_cfg(tmp_path, 8, num_env_workers=2), device="cpu")
    learner = trainer.learner
    fixed = learner.init(torch.Generator().manual_seed(5))
    served, lock = [], threading.Lock()
    inner = trainer._make_act_fn(learner.acting_copy(), fixed, torch.Generator().manual_seed(1))

    def act_fn(obs):
        actions, info = inner(obs)
        with lock:
            served.append((np.array(obs), info["logits"], info["value"]))
        return actions, info

    server = InferenceServer(act_fn=act_fn, unroll_length=8)
    stop = threading.Event()
    workers = [_worker_thread(server, _cartpole(4), i, stop, max_steps=4000) for i in range(3)]
    state = learner.init(torch.Generator().manual_seed(6))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        chunk = server.chunks.get(timeout=30)
        batch = trainer._stage(chunk, Tracer(None))[0]
        for _ in range(30):  # the main thread's learns meanwhile
            state, _ = trainer._learn(state, batch, None)
    finally:
        sys.setswitchinterval(old)
        stop.set()
        server.close()
        for w in workers:
            w.join(timeout=10)
    assert not any(w.is_alive() for w in workers)
    assert len(served) > 10
    for obs, logits, value in served:
        out = learner.apply(fixed.params, learner._norm_obs(fixed.obs_stats, torch.from_numpy(obs)))
        np.testing.assert_array_equal(logits, out.logits.numpy())
        np.testing.assert_array_equal(value, out.value.numpy())


# -- the CLI --------------------------------------------------------------------

def _cli_argv(algo, folder, *extra):
    return ["train", algo, "gym:CartPole-v1", "--folder", str(folder), "--num-envs", "4", "--total-steps", "128",
            "--workers", "2", "--set", "session_config.backend=cpu", "learner_config.algo.horizon=8",
            "session_config.metrics.every_n_iters=1", "session_config.metrics.tensorboard=false",
            "session_config.metrics.console=false", *extra]


def test_train_cli_runs_seed_and_writes_the_reference_config(tmp_path, capsys, monkeypatch):
    """``train impala gym:CartPole-v1 --workers 2 --set
    session_config.backend=cpu``: exit 0, finite losses, and a config.json
    equal to the JAX build_config's for the same argv."""
    argv = _cli_argv("impala", tmp_path / "run")
    assert torch_launch.main(argv) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert final["time/env_steps"] >= 128 and np.isfinite(final["loss/pg"]) and np.isfinite(final["loss/value"])
    got = []
    monkeypatch.setattr(jax_launch, "run_train", lambda args: got.append(args) or 0)
    assert jax_launch.main(argv) == 0
    with open(os.path.join(str(tmp_path / "run"), "config.json")) as f:
        assert f.read() == jax_launch.build_config(got[0]).dumps()


def test_train_cli_runs_seed_ppo_with_process_workers(tmp_path, capsys):
    argv = _cli_argv("ppo", tmp_path / "run", "session_config.topology.worker_mode=process",
                     "learner_config.algo.epochs=1", "learner_config.algo.num_minibatches=1")
    assert torch_launch.main(argv) == 0
    final = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert np.isfinite(final["loss/pg"]) and np.isfinite(final["loss/value"])
    assert final["server/shm_workers"] >= 1.0


@pytest.mark.parametrize("algo,env", [("ddpg", "gym:Pendulum-v1"), ("impala", "jax:lift")])
def test_train_cli_refuses_workers_where_the_reference_does(tmp_path, capsys, algo, env):
    assert torch_launch.main(["train", algo, env, "--folder", str(tmp_path), "--workers", "2"]) == 2
    assert "selects the SEED inference-server topology, which needs a HOST env" in capsys.readouterr().err
