"""Live parameter publishing in the port (``launch/hooks.py`` with
``session_config.publish.enabled``) and its consumers, the ``actor`` and
``eval --follow`` subcommands (``main/launch.py``), against the
reference's ``tests/test_publish.py``:

- ``SessionHooks`` of both packages, driven through the same iterations
  and metrics windows (every 2 iterations, a window with
  ``health/nonfinite`` among them), publish at the same iterations with
  the same versions, and never from a tripped window; the port's hooks
  write the discovery file at set-up, the fetched view is the state's
  acting view bit for bit, and close() retracts the file;
- in process, a ``Trainer`` thread on ``jax:pendulum`` (8 envs, CPU)
  with publishing on, and ``main(["actor", ...])`` (PPO and DDPG) and
  ``main(["eval", "--follow", ...])`` against it: the actor sees at least
  two versions, eval scores two rounds without the version going back;
- an actor with nothing published exits 2 within its ``--wait``;
- ``_wait_for_publish`` re-discovers a rewritten discovery file;
- the CLI in subprocesses, as the reference's ``test_cli_live_*`` (marked
  slow, as the reference marks them).

Every socket and process wait has its own deadline."""

import io
import json
import os
import subprocess
import sys
import threading
import time
from contextlib import redirect_stdout

import jax
import numpy as np
import pytest
import torch

from surreal_tpu.envs import make_env as jax_make_env
from surreal_tpu.launch.hooks import SessionHooks as JaxSessionHooks
from surreal_tpu.learners import build_learner as jax_build_learner
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import base_config as jax_base_config
import surreal_tpu_torch.main.launch as launch
from surreal_tpu_torch.agents import make_agent
from surreal_tpu_torch.distributed.param_service import ParameterClient, ParameterPublisher, ParameterServer
from surreal_tpu_torch.envs import make_env
from surreal_tpu_torch.envs.base import ArraySpec, EnvSpecs
from surreal_tpu_torch.launch.hooks import SessionHooks
from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer
from surreal_tpu_torch.launch.trainer import Trainer
from surreal_tpu_torch.learners import build_learner
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.utils.tree import tree_flatten

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tree(folder, algo: str = "ppo", **publish):
    learner = {"algo": {"name": "ppo", "horizon": 8, "epochs": 1, "num_minibatches": 1}}
    if algo == "ddpg":
        learner = {"algo": {"name": "ddpg", "horizon": 8, "updates_per_iter": 2,
                            "exploration": {"warmup_steps": 0}},
                   "replay": {"start_sample_size": 64, "batch_size": 64, "capacity": 4096}}
    return {
        "learner_config": learner,
        "env_config": {"name": "jax:pendulum", "num_envs": 8, "time_limit": 50},
        "session_config": {
            "folder": str(folder), "backend": "cpu", "publish": {"enabled": True, **publish},
            "metrics": {"every_n_iters": 1, "tensorboard": False, "console": False},
            "eval": {"every_n_iters": 0}, "checkpoint": {"every_n_iters": 10**9},
        },
    }


# the iterations driven through both packages' hooks, and whether each
# iteration's metrics window holds a nonfinite value
WINDOWS = [(1, False), (2, False), (3, False), (4, True), (5, False), (6, False)]


def test_hooks_publish_on_the_reference_cadence_and_never_when_tripped(tmp_path):
    config = Config(_tree(tmp_path / "port", every_n_iters=2)).extend(base_config())
    jconfig = JaxConfig(_tree(tmp_path / "jax", every_n_iters=2)).extend(jax_base_config())
    learner = build_learner(config.learner_config, make_env(config.env_config, "cpu").specs, device="cpu")
    jlearner = jax_build_learner(jconfig.learner_config, jax_make_env(jconfig.env_config).specs)
    state = learner.init()
    j_state = jlearner.init(jax.random.key(0))
    hooks, jhooks = SessionHooks(config, learner), JaxSessionHooks(jconfig, jlearner)
    ours, theirs = [], []
    try:
        info = json.load(open(tmp_path / "port" / "param_server.json"))
        assert set(info) == set(json.load(open(tmp_path / "jax" / "param_server.json")))
        client = ParameterClient(info["addresses"][0], make_agent(learner).acting_view(state))
        assert client.fetch(timeout_ms=2000) is None  # nothing published yet
        hooks.begin_run(0, 0)
        jhooks.begin_run(0, 0)
        for it, poisoned in WINDOWS:
            metrics = {"health/nonfinite": float(poisoned)}
            state = state._replace(kl_beta=state.kl_beta + 1.0)
            m, _ = hooks.end_iteration(it, 64 * it, state, it, dict(metrics))
            jm, _ = jhooks.end_iteration(it, 64 * it, j_state, jax.random.key(it), dict(metrics))
            ours.append(m.get("publish/version"))
            theirs.append(jm.get("publish/version"))
            if it == 2:
                deadline = time.monotonic() + 10
                view = None
                while view is None and time.monotonic() < deadline:
                    view = client.fetch(timeout_ms=2000)
                assert client.version == 1
                want = tree_flatten(make_agent(learner).acting_view(state))
                got = tree_flatten(view)
                assert want.keys() == got.keys() and all(torch.equal(got[k], v) for k, v in want.items())
        client.close()
    finally:
        hooks.close()
        jhooks.close()
    assert ours == theirs
    assert ours[:2] == [None, 1.0] and ours[3] is None  # the tripped window published nothing
    assert not os.path.exists(tmp_path / "port" / "param_server.json")


def _write_config(config) -> None:
    with open(os.path.join(config.session_config.folder, "config.json"), "w") as f:
        f.write(config.dumps())


class _LiveTrainer:
    """A training session on a thread, publishing every iteration, until
    stopped (each metrics window checks the stop flag)."""

    def __init__(self, folder, algo: str):
        self.config = Config(_tree(folder, algo)).extend(base_config())
        _write_config(self.config)
        cls = OffPolicyTrainer if algo == "ddpg" else Trainer
        self.trainer = cls(self.config, device="cpu")
        self._stop = threading.Event()
        self.error = []
        self.thread = threading.Thread(target=self._run, daemon=True)
        self.thread.start()

    def _run(self):
        try:
            self.trainer.run(max_env_steps=10**9, on_metrics=lambda it, m: self._stop.is_set())
        except BaseException as e:  # surfaced by stop()
            self.error.append(e)

    def stop(self):
        self._stop.set()
        self.thread.join(60)
        assert not self.thread.is_alive(), "the trainer thread did not stop"
        assert not self.error, self.error


def _main(argv) -> tuple[int, list[dict]]:
    out = io.StringIO()
    with redirect_stdout(out):
        rc = launch.main(argv)
    return rc, [json.loads(line) for line in out.getvalue().splitlines() if line.startswith("{")]


@pytest.mark.parametrize("algo", ["ppo", "ddpg"])
def test_actor_and_follow_eval_against_a_live_session(algo, tmp_path):
    live = _LiveTrainer(tmp_path, algo)
    try:
        rc, lines = _main(["actor", "--folder", str(tmp_path), "--episodes", "4", "--num-envs", "2",
                           "--fetch-every", "10", "--min-version", "2", "--max-steps", "2000", "--wait", "60"])
        assert rc == 0, lines
        summary, episodes = lines[-1], [ln for ln in lines if "episode" in ln]
        assert len(episodes) >= 4 and all(ep["param_version"] >= 2 and np.isfinite(ep["return"]) for ep in episodes)
        assert summary["actor/versions_seen"] >= 2 and summary["actor/param_version"] >= 2
        if algo == "ppo":
            rc, rounds = _main(["eval", str(tmp_path), "--follow", "--rounds", "2", "--episodes", "2",
                                "--wait", "60"])
            assert rc == 0 and len(rounds) == 2
            assert all(np.isfinite(r["eval/return"]) and r["param_version"] >= 1 for r in rounds)
            assert rounds[1]["param_version"] >= rounds[0]["param_version"]
        assert live.thread.is_alive()  # the learner stayed up through both
    finally:
        live.stop()
    assert not os.path.exists(tmp_path / "param_server.json")


def test_actor_exits_2_when_nothing_is_published(tmp_path, capsys):
    config = Config(_tree(tmp_path)).extend(base_config())
    _write_config(config)
    pub = ParameterPublisher()
    server = ParameterServer(pub.address)
    with open(tmp_path / "param_server.json", "w") as f:
        json.dump({"addresses": server.addresses, "publisher": pub.address}, f)
    try:
        t0 = time.monotonic()
        assert launch.main(["actor", "--folder", str(tmp_path), "--wait", "1"]) == 2
        assert launch.main(["eval", str(tmp_path), "--follow", "--wait", "1"]) == 2
        assert time.monotonic() - t0 < 20
        assert capsys.readouterr().err.count("nothing published") == 2
        os.unlink(tmp_path / "param_server.json")
        assert launch.main(["actor", "--folder", str(tmp_path), "--wait", "0.5"]) == 2
        assert "param_server.json" in capsys.readouterr().err
    finally:
        server.close()
        pub.close()


def test_wait_for_publish_rediscovers_rewritten_address(tmp_path):
    """A dead session's stale param_server.json must not strand a waiting
    actor: a new session rewrites the file 1 s later and publishes."""
    specs = EnvSpecs(obs=ArraySpec((3,), np.dtype(np.float32)), action=ArraySpec((1,), np.dtype(np.float32)))
    learner = build_learner(Config(algo=Config(name="ppo")), specs, device="cpu")
    state = learner.init()
    stale = "tcp://127.0.0.1:1"
    path = tmp_path / "param_server.json"
    path.write_text(json.dumps({"addresses": [stale], "publisher": "x"}))
    agent = make_agent(learner)
    agent.connect(stale, state, fetch_every=1)
    pub = ParameterPublisher()
    srv = ParameterServer(pub.address)
    errors = []

    def relaunch():
        try:
            time.sleep(1.0)
            with open(str(path) + ".tmp", "w") as f:
                json.dump({"addresses": [srv.address], "publisher": pub.address}, f)
            os.replace(str(path) + ".tmp", str(path))
            time.sleep(0.3)
            pub.publish(agent.acting_view(state))
        except BaseException as e:
            errors.append(e)
            raise

    t = threading.Thread(target=relaunch)
    t.start()
    try:
        ok = launch._wait_for_publish(agent, str(tmp_path), connect=None, address=stale, wait_s=30)
        t.join(10)
        assert not errors, errors
        assert ok and agent.param_version >= 1
    finally:
        t.join(10)
        agent.close()
        srv.close()
        pub.close()


# -- the CLI in subprocesses (slow, as the reference's) ----------------------

_SET_COMMON = [
    "session_config.backend=cpu", "learner_config.algo.horizon=8", "learner_config.algo.epochs=1",
    "learner_config.algo.num_minibatches=1", "session_config.publish.enabled=true",
    "session_config.metrics.every_n_iters=1", "session_config.metrics.tensorboard=false",
    "session_config.metrics.console=false", "session_config.eval.every_n_iters=0",
    "session_config.checkpoint.every_n_iters=1000000", "env_config.time_limit=50",
]
_DDPG_SET = [
    "session_config.backend=cpu", "learner_config.algo.horizon=8", "learner_config.algo.updates_per_iter=2",
    "learner_config.algo.exploration.warmup_steps=0", "learner_config.replay.start_sample_size=64",
    "learner_config.replay.batch_size=64", "learner_config.replay.capacity=4096",
    "session_config.publish.enabled=true", "session_config.metrics.every_n_iters=1",
    "session_config.metrics.tensorboard=false", "session_config.metrics.console=false",
    "session_config.eval.every_n_iters=0", "session_config.checkpoint.every_n_iters=1000000",
    "env_config.time_limit=50",
]


def _cli(*argv):
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, [os.environ.get("PYTHONPATH"), REPO])))
    return [sys.executable, "-m", "surreal_tpu_torch", *argv], env


@pytest.mark.slow
@pytest.mark.parametrize("algo", ["ppo", "ddpg"])
def test_cli_live_actor_and_follow_eval(algo, tmp_path):
    """A CLI training session and separately launched actor and eval
    processes meet over the wire: the actor's version advances mid-run and
    --follow eval rounds flow, the trainer alive throughout."""
    folder = str(tmp_path / "live")
    cmd, env = _cli("train", algo, "jax:pendulum", "--folder", folder, "--num-envs", "8",
                    "--total-steps", str(10**9), "--set", *(_DDPG_SET if algo == "ddpg" else _SET_COMMON))
    trainer = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
    try:
        cmd, env = _cli("actor", "--folder", folder, "--episodes", "4", "--num-envs", "2", "--fetch-every", "10",
                        "--min-version", "2", "--max-steps", "2000", "--wait", "240")
        actor = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
        assert actor.returncode == 0, actor.stdout + actor.stderr
        lines = [json.loads(ln) for ln in actor.stdout.splitlines()]
        assert [ln for ln in lines if "episode" in ln] and lines[-1]["actor/versions_seen"] >= 2, lines
        if algo == "ppo":
            cmd, env = _cli("eval", folder, "--follow", "--rounds", "2", "--episodes", "2", "--wait", "120")
            follow = subprocess.run(cmd, capture_output=True, text=True, timeout=300, env=env, cwd=REPO)
            assert follow.returncode == 0, follow.stdout + follow.stderr
            rounds = [json.loads(ln) for ln in follow.stdout.splitlines()]
            assert len(rounds) == 2 and rounds[1]["param_version"] >= rounds[0]["param_version"] >= 1
        assert trainer.poll() is None
    finally:
        trainer.kill()
        trainer.communicate(timeout=60)
