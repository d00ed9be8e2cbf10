"""The port's ``train`` entry point (``surreal_tpu_torch/main/launch.py``)
and session runtime against the JAX package's.

- The same argv through each package's own parser and ``build_config``
  gives equal ``config.dumps()``; the port's ``run_train`` on
  ``session_config.backend=cpu`` writes a ``config.json`` equal to the
  reference's for that argv. Exact.
- One short device-mode run of each package's ``Trainer`` on jax:lift
  with the same cadences gives the same iterations at which metrics fire,
  the same checkpoint steps, the same metric keys and the same telemetry
  event types, the ops plane's, the SLOs', the watchdog's and
  remediation's included (``launch/hooks.py::UNPORTED_SUBSYSTEMS`` is
  empty); the ``perf/*`` gauges and the ``program_cost`` and ``profile``
  events are compared with the reference's. Exact.
- The profiler window (``session.profiler``) and the slow-iteration
  trigger (``session.profile.slow_iter_factor``) of a port session give
  the reference ``ProfileManager``'s capture windows.
- What the port does not carry raises or exits 2, by name."""

import json
import os

import jax
import pytest
import torch

import surreal_tpu.main.launch as jax_launch
import surreal_tpu_torch.main.launch as torch_launch
from surreal_tpu.launch.trainer import Trainer as JaxTrainer
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session import profile as jax_profile
from surreal_tpu.session.default_configs import base_config as jax_base_config
from surreal_tpu.session.telemetry import _iter_jsonl as jax_iter_jsonl
from surreal_tpu_torch.launch.hooks import UNPORTED_SUBSYSTEMS
from surreal_tpu_torch.launch.trainer import Trainer
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.session.telemetry import _iter_jsonl
from surreal_tpu_torch.utils import faults

ARGVS = [
    ["train", "ppo", "jax:lift", "--folder", "F"],
    ["train", "ddpg", "jax:lift", "--folder", "F", "--num-envs", "256", "--total-steps", "1000",
     "--set", "learner_config.algo.n_step=3", "session_config.checkpoint.include_replay=true"],
    ["train", "impala", "jax:pong", "--folder", "F", "--restore-from", "G",
     "--set", "learner_config.algo.horizon=32", "session_config.backend=cpu"],
    ["train", "ppo", "jax:lift", "--folder", "F", "--workers", "0", "--set",
     "session_config.faults.plan=[{\"site\": \"trainer.iteration\", \"kind\": \"delay\"}]"],
]


def _parsed(module, argv, monkeypatch):
    """``argv`` through ``module``'s own ``main`` and parser, stopping at
    ``run_train``: the args it would get."""
    got = []
    monkeypatch.setattr(module, "run_train", lambda args: got.append(args) or 0)
    assert module.main(list(argv)) == 0
    return got[0]


@pytest.mark.parametrize("i", range(len(ARGVS)))
def test_build_config_matches_jax(i, monkeypatch):
    argv = ARGVS[i]
    want = jax_launch.build_config(_parsed(jax_launch, argv, monkeypatch)).dumps()
    got = torch_launch.build_config(_parsed(torch_launch, argv, monkeypatch)).dumps()
    assert got == want


def test_run_train_on_cpu_writes_the_reference_config_and_prints_metrics(tmp_path, capsys, monkeypatch):
    folder = str(tmp_path / "run")
    argv = ["train", "ppo", "jax:lift", "--folder", folder, "--num-envs", "8", "--total-steps", "64", "--set",
            "session_config.backend=cpu", "learner_config.algo.horizon=8", "learner_config.algo.epochs=1",
            "learner_config.algo.num_minibatches=1", "session_config.metrics.every_n_iters=1",
            "session_config.metrics.console=false", "session_config.metrics.tensorboard=false"]
    assert torch_launch.main(argv) == 0
    metrics = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(metrics) == sorted(metrics) and metrics["time/env_steps"] == 64
    with open(os.path.join(folder, "config.json")) as f:
        written = f.read()
    want = jax_launch.build_config(_parsed(jax_launch, argv, monkeypatch)).dumps()
    assert written == want
    assert os.listdir(os.path.join(folder, "checkpoints")).count("1") == 1  # the run-end checkpoint


def test_cli_refuses_what_is_not_ported(tmp_path, capsys, monkeypatch):
    base = ["train", "ppo", "jax:lift", "--folder", str(tmp_path)]
    assert torch_launch.main(base + ["--workers", "2"]) == 2
    assert torch_launch.main(base + ["--local-procs", "2"]) == 2
    assert "not ported" in capsys.readouterr().err
    # eval and actor are ported: on a folder with no session they exit 2
    # with the reference's message, not with "not ported"
    assert torch_launch.main(["eval", str(tmp_path)]) == 2
    assert torch_launch.main(["actor", "--folder", str(tmp_path), "--wait", "0"]) == 2
    err = capsys.readouterr().err
    assert err.count("no config.json") == 2 and "not ported" not in err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="session_config.backend=cpu"):
        torch_launch.main(base)  # 'tpu', the default, is the card
    with pytest.raises(ValueError, match="backend"):
        torch_launch.main(base + ["--set", "session_config.backend=gpu"])


UNPORTED_OPTIONS = {
    "session_config.compile_cache_dir": {"session_config": {"compile_cache_dir": "xla_cache"}},
    "session_config.topology.mesh": {"session_config": {"topology": {"mesh": {"dp": 2}}}},
    "session_config.topology.multihost": {"session_config": {"topology": {"multihost": {"coordinator": "h:1"}}}},
    "lgroup.member": {"session_config": {"faults": {"plan": [{"site": "lgroup.member", "kind": "kill_member"}]}}},
}


def _option_tree(over: dict, tmp_path) -> Config:
    tree = {
        "learner_config": {"algo": {"name": "ppo", "horizon": 4, "epochs": 1, "num_minibatches": 1,
                                    **over.get("learner_config", {}).get("algo", {})}},
        "env_config": {"name": "jax:lift", "num_envs": 2, **over.get("env_config", {})},
        "session_config": {"folder": str(tmp_path), "metrics": {"tensorboard": False},
                           **over.get("session_config", {})},
    }
    return Config(tree).extend(base_config())


@pytest.mark.parametrize("key", sorted(UNPORTED_OPTIONS))
def test_every_unported_session_option_raises(key, tmp_path):
    try:
        with pytest.raises(NotImplementedError, match=key.split(".")[-1]):
            Trainer(_option_tree(UNPORTED_OPTIONS[key], tmp_path), device="cpu").run(max_env_steps=8)
    finally:
        faults.configure(None)


# options the port refused until it had their paths: each now trains
PORTED_OPTIONS = {
    "session_config.publish.enabled": {"session_config": {"publish": {"enabled": True}}},
    "session_config.publish.fanout.enabled": {"session_config": {
        "publish": {"enabled": True, "fanout": {"enabled": True}},
        "metrics": {"every_n_iters": 1, "tensorboard": False}}},
    "env_config.video": {"env_config": {"video": {"enabled": True, "dir": "v"}},
                         "session_config": {"eval": {"every_n_iters": 1, "episodes": 2, "max_steps": 6}}},
    "learner_config.algo.autotune": {"learner_config": {"algo": {"autotune": "cache"}}},
    "watchdog.eval": {"session_config": {
        "faults": {"plan": [{"site": "watchdog.eval", "kind": "drop_eval"}]},
        "metrics": {"every_n_iters": 1, "tensorboard": False}}},
}


@pytest.mark.parametrize("key", sorted(PORTED_OPTIONS))
def test_formerly_unported_session_option_trains(key, tmp_path):
    """One iteration with the option on: publishing starts the parameter
    server, publishes once (a ``param-publish`` span) and retracts its
    discovery file at the end, and the fanout broadcasts that publish as
    one full frame (its ``param/*`` gauges in the metrics row); video
    records the eval episode of the device env (reset frame, 6 steps); the
    watchdog's fault site drops the first sweep, counted and written as a
    ``fault`` event; the autotuner in 'cache' mode on an empty cache
    builds with the defaults and records its miss as one ``tune``
    event."""
    over = PORTED_OPTIONS[key]
    if key == "env_config.video":
        over = {**over, "env_config": {"video": {**over["env_config"]["video"], "dir": str(tmp_path / "v")}}}
    Trainer(_option_tree(over, tmp_path), device="cpu").run(max_env_steps=8)
    events = list(_iter_jsonl(os.path.join(tmp_path, "telemetry", "events.jsonl")))
    if key == "env_config.video":
        assert [f.split(".")[0] for f in os.listdir(tmp_path / "v")] == ["episode_000000"]
    elif key == "learner_config.algo.autotune":
        (event,) = [e for e in events if e["type"] == "tune"]
        assert (event["mode"], event["hit"], event["source"], event["config"]) == ("cache", False, "default", {})
    elif key == "watchdog.eval":
        assert [e["site"] for e in events if e["type"] == "fault"] == ["watchdog.eval"]
        (row,) = [e["values"] for e in events if e["type"] == "metrics"]
        assert row["ops/watchdog_dropped_evals"] == 1.0 and row["ops/watchdog_evals"] == 0.0
    else:
        assert [e["name"] for e in events if e["type"] == "span" and e["name"] == "param-publish"] == ["param-publish"]
        assert not os.path.exists(tmp_path / "param_server.json")
        if "fanout" in key:
            (row,) = [e["values"] for e in events if e["type"] == "metrics" and "param/publishes" in e["values"]]
            assert row["param/publishes"] == row["param/full_frames"] == 1.0 and row["param/bytes_last_publish"] > 0


PROFILE_OPTIONS = {
    # the window: iterations 2-4 of 6
    "session_config.profiler.enabled": {"profiler": {"enabled": True, "start_iter": 2, "num_iters": 2}},
    # a 1.5 s iteration (a delay fault) after 13 of a few tens of ms
    "session_config.profile.slow_iter_factor": {
        "profile": {"slow_iter_factor": 3.0, "num_iters": 1, "max_auto_captures": 1, "trigger_file": False},
        "faults": {"plan": [{"site": "trainer.iteration", "kind": "delay", "at": 13, "ms": 1500}]},
    },
}


class _Sink:
    def __init__(self):
        self.events = []

    def event(self, type_, **kw):
        self.events.append((type_, kw))


class _Log:
    def info(self, *a):
        pass

    warning = info


@pytest.mark.parametrize("key", sorted(PROFILE_OPTIONS))
def test_profile_options_match_the_reference(key, tmp_path, monkeypatch):
    """What was refused before this slice: a port session with the
    option on captures the windows the reference's ProfileManager opens
    on the same boundary ticks (the reference's jax.profiler calls
    stubbed), each with its Chrome trace on disk."""
    session = PROFILE_OPTIONS[key]
    iters = 6 if "profiler" in session else 16
    tree = {
        "learner_config": {"algo": {"name": "ppo", "horizon": 4, "epochs": 1, "num_minibatches": 1}},
        "env_config": {"name": "jax:lift", "num_envs": 4},
        "session_config": {"folder": str(tmp_path), "metrics": {"tensorboard": False, "console": False},
                           "checkpoint": {"every_n_iters": 0}, **session},
    }
    try:
        Trainer(Config(tree).extend(base_config()), device="cpu").run(max_env_steps=iters * 16)
    finally:
        faults.configure(None)
    events = [e for e in _iter_jsonl(os.path.join(tmp_path, "telemetry", "events.jsonl")) if e["type"] == "profile"]
    got = [(e["reason"].split("(")[0], e["start_iter"], e["end_iter"]) for e in events]
    assert len(got) == 1 and "error" not in events[0]
    assert os.path.getsize(os.path.join(events[0]["dir"], "trace.json")) > 0

    # the reference's manager on the same ticks: uniform 10 ms iterations,
    # and the one at whose boundary the port's capture started slow
    monkeypatch.setattr(jax.profiler, "start_trace", lambda d: None)
    monkeypatch.setattr(jax.profiler, "stop_trace", lambda: None)
    clock = [0.0]
    monkeypatch.setattr(jax_profile.time, "monotonic", lambda: clock[0])
    sink = _Sink()
    pm = jax_profile.ProfileManager(JaxConfig(tree["session_config"]), str(tmp_path / "ref"), sink, _Log())
    for i in range(1, iters + 1):
        clock[0] += 1.5 if i == got[0][1] and "profile" in session else 0.01
        pm.tick(i)
    pm.close()
    want = [(kw["reason"].split("(")[0], kw["start_iter"], kw["end_iter"]) for t, kw in sink.events if t == "profile"]
    assert got == want


def _session(folder):
    """A short run on jax:lift: metrics every 2, checkpoint every 3, eval
    every 4 (2 episodes of at most 10 steps), 6 iterations."""
    return dict(
        learner_config=dict(algo=dict(name="ppo", horizon=8, epochs=1, num_minibatches=1, precision="f32")),
        env_config=dict(name="jax:lift", num_envs=8, time_limit=5),
        session_config=dict(folder=str(folder), metrics=dict(every_n_iters=2, tensorboard=False, console=False),
                            checkpoint=dict(every_n_iters=3), eval=dict(every_n_iters=4, episodes=2, max_steps=10)),
    )


def _record(folder, run, iter_jsonl):
    rows = []
    run(lambda i, m: rows.append((i, set(m))))
    ckpt = os.path.join(folder, "checkpoints")
    events = list(iter_jsonl(os.path.join(folder, "telemetry", "events.jsonl")))
    return {
        "fired": [i for i, _ in rows],
        "row_keys": [keys for _, keys in rows],
        "steps": sorted(int(n) for n in os.listdir(ckpt) if n.isdigit()),
        "best": os.path.isdir(os.path.join(ckpt, "best")),
        "files": sorted(n for n in os.listdir(ckpt) if not n.isdigit()),
        "event_types": [e["type"] for e in events],
        "unported": [e for e in events if e["type"] == "unported"],
    }


def test_short_run_matches_the_reference_session(tmp_path):
    jdir, tdir = tmp_path / "jax", tmp_path / "torch"
    steps = 6 * 8 * 8
    want = _record(
        str(jdir), lambda cb: JaxTrainer(JaxConfig(_session(jdir)).extend(jax_base_config())).run(steps, cb),
        jax_iter_jsonl,
    )
    got = _record(
        str(tdir), lambda cb: Trainer(Config(_session(tdir)).extend(base_config()), device="cpu").run(steps, cb),
        _iter_jsonl,
    )
    # nothing is left unported: the ops plane, SLOs, watchdog and
    # remediation add the reference's keys and events
    assert UNPORTED_SUBSYSTEMS == {} and got["unported"] == want["unported"] == []
    assert got == want
    assert {"ops_snapshot"} <= set(got["event_types"])
    assert {"ops/snapshots", "slo/breaches", "ops/watchdog_evals", "remediation/actions"} <= got["row_keys"][0]
    assert want["fired"] == [2, 4, 6] and want["steps"] == [3, 6] and want["best"]
    assert want["event_types"].count("span") == 3  # two checkpoints and one eval
