"""The port's offline readers (``surreal_tpu_torch/session/telemetry.py``:
``diag_summary``, ``diag_report``, ``trace_summary``, ``trace_report``,
``HeartbeatWriter``) and its ``diag`` and ``trace`` subcommands, against
the reference's on the same telemetry folders. Exact.

The folders: one written by a short port session (PPO on jax:lift with a
profiler window: phases, metrics with the perf gauges, program_cost,
profile, engine and precision events), one by a short port SEED session
(IMPALA on CartPole over two thread workers, every step head-sampled:
causal span trees, hops, the data plane), one by a short reference
session, the reference tests' heartbeat cases (a dead rank, the cadence
of old logs inferred), torn tails, and a missing folder (exit code 2 and
the reference's message)."""

import json
import os
import time

import pytest

import surreal_tpu.main.launch as jax_launch
import surreal_tpu_torch.main.launch as torch_launch
from surreal_tpu.launch.trainer import Trainer as JaxTrainer
from surreal_tpu.session import telemetry as jax_tel
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import base_config as jax_base_config
from surreal_tpu_torch.launch.seed_trainer import SEEDTrainer
from surreal_tpu_torch.launch.trainer import Trainer
from surreal_tpu_torch.session import telemetry as torch_tel
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config

NOW = 1_800_000_000.0  # the clock both readers see (heartbeat ages)


def _frozen(monkeypatch):
    """Both readers age heartbeats by ``time.time()`` at the call; one
    fixed clock keeps the two calls alike (the event writers ran before)."""
    monkeypatch.setattr(time, "time", lambda: NOW)


def _assert_readers_agree(folder, monkeypatch):
    _frozen(monkeypatch)
    want, got = jax_tel.diag_summary(str(folder)), torch_tel.diag_summary(str(folder))
    assert got == want
    assert torch_tel.diag_report(str(folder)) == jax_tel.diag_report(str(folder))
    assert torch_tel.trace_summary(str(folder)) == jax_tel.trace_summary(str(folder))
    for limit in (16, 1):
        assert torch_tel.trace_report(str(folder), limit) == jax_tel.trace_report(str(folder), limit)
    return got


def _cli(launch, argv, capsys):
    rc = launch.main(argv)
    out = capsys.readouterr()
    return rc, out.out, out.err


def test_a_port_session_reads_alike(tmp_path, monkeypatch, capsys):
    tree = {
        "learner_config": {"algo": {"name": "ppo", "horizon": 8, "epochs": 1, "num_minibatches": 1}},
        "env_config": {"name": "jax:lift", "num_envs": 8},
        "session_config": {"folder": str(tmp_path), "metrics": {"every_n_iters": 2, "tensorboard": False,
                                                                  "console": False},
                           "checkpoint": {"every_n_iters": 3}, "eval": {"every_n_iters": 0},
                           "profiler": {"enabled": True, "start_iter": 2, "num_iters": 2}},
    }
    Trainer(Config(tree).extend(base_config()), device="cpu").run(max_env_steps=6 * 64)
    capsys.readouterr()  # the session's own log lines
    s = _assert_readers_agree(tmp_path, monkeypatch)
    assert set(s["programs"]) == {"train_iter"} and s["programs"]["train_iter"]["kernels"]["gae"]["calls"] == 1
    assert {"perf/mfu", "perf/flops_per_s", "perf/membw_util"} <= set(s["perf"])
    assert [p["reason"] for p in s["profiles"]] == ["profiler_knob"]
    report = torch_tel.diag_report(str(tmp_path))
    for needle in ("Performance", "train_iter", "mfu", "GFLOPs/call", "profiler captures", "device cpu"):
        assert needle in report, needle
    for argv in (["diag", str(tmp_path)], ["diag", str(tmp_path), "--json"], ["trace", str(tmp_path)]):
        assert _cli(torch_launch, argv, capsys) == _cli(jax_launch, argv, capsys)


def test_a_port_seed_session_reads_alike(tmp_path, monkeypatch, capsys):
    cfg = Config(
        learner_config=Config(algo=Config(name="impala", horizon=8)),
        env_config=Config(name="gym:CartPole-v1", num_envs=4),
        session_config=Config(
            folder=str(tmp_path), total_env_steps=200,
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
            topology=Config(num_env_workers=2), telemetry=Config(trace=Config(sample_n=1)),
        ),
    ).extend(base_config())
    SEEDTrainer(cfg, device="cpu").run()
    capsys.readouterr()
    s = _assert_readers_agree(tmp_path, monkeypatch)
    assert {"act", "learn"} <= set(s["programs"]) and s["programs"]["act"]["phase"] is None
    assert s["hops"] and s["data_plane"]
    t = torch_tel.trace_summary(str(tmp_path))
    assert t["exemplars"]
    report = torch_tel.trace_report(str(tmp_path))
    assert "MISSING" not in report and "worker.step" in report
    for argv in (["trace", str(tmp_path)], ["trace", str(tmp_path), "--limit", "2"]):
        assert _cli(torch_launch, argv, capsys) == _cli(jax_launch, argv, capsys)


def test_a_reference_session_reads_alike(tmp_path, monkeypatch):
    tree = {
        "learner_config": {"algo": {"name": "ppo", "horizon": 8, "epochs": 1, "num_minibatches": 1}},
        "env_config": {"name": "jax:lift", "num_envs": 8},
        "session_config": {"folder": str(tmp_path), "metrics": {"every_n_iters": 2, "tensorboard": False,
                                                                  "console": False},
                           "checkpoint": {"every_n_iters": 0}, "eval": {"every_n_iters": 0}},
    }
    JaxTrainer(JaxConfig(tree).extend(jax_base_config())).run(4 * 64)
    s = _assert_readers_agree(tmp_path, monkeypatch)
    assert "train_iter" in s["programs"] and s["perf"]


def _heartbeats(folder, records):
    tel = folder / "telemetry"
    os.makedirs(tel, exist_ok=True)
    for rank, recs in records.items():
        with open(tel / f"heartbeat_rank{rank}.jsonl", "w") as f:
            for rec in recs:
                f.write(json.dumps({"type": "heartbeat", "rank": rank, **rec}) + "\n")


def test_heartbeat_cases_read_alike(tmp_path, monkeypatch):
    """The reference tests' two cases: a rank older than 3x its cadence
    is DEAD beside a fresh one, and an old log's cadence is inferred from
    its beat deltas."""
    _heartbeats(tmp_path / "dead", {
        0: [{"t": NOW, "iteration": 5, "env_steps": 100, "every_s": 10.0}],
        1: [{"t": NOW - 120.0, "iteration": 2, "env_steps": 40, "every_s": 10.0}],
    })
    _heartbeats(tmp_path / "old", {0: [{"t": NOW - 500 + i * 5.0, "iteration": i, "env_steps": i * 10}
                                      for i in range(5)]})
    s = _assert_readers_agree(tmp_path / "dead", monkeypatch)
    assert (s["heartbeats"][0]["dead"], s["heartbeats"][1]["dead"]) == (False, True)
    report = torch_tel.diag_report(str(tmp_path / "dead"))
    assert "DEAD" in report and "alive" in report and "rank(s) 1" in report
    s = _assert_readers_agree(tmp_path / "old", monkeypatch)
    assert s["heartbeats"][0]["cadence_s"] == pytest.approx(5.0) and s["heartbeats"][0]["dead"]


def test_heartbeat_writer_writes_what_the_reference_writes(tmp_path, monkeypatch):
    _frozen(monkeypatch)
    for mod, tag in ((jax_tel, "jax"), (torch_tel, "torch")):
        hb = mod.HeartbeatWriter(str(tmp_path / tag), rank=3, every_s=60.0)
        hb.beat(1, 10)
        hb.beat(2, 20)  # throttled
        hb.beat(3, 30, force=True)
    read = [
        (tmp_path / tag / "telemetry" / "heartbeat_rank3.jsonl").read_text() for tag in ("jax", "torch")
    ]
    assert read[0] == read[1] and len(read[1].splitlines()) == 2
    assert torch_tel.HeartbeatWriter(None, rank=0)._path is None


def test_torn_tails_read_alike(tmp_path, monkeypatch):
    tel = tmp_path / "telemetry"
    os.makedirs(tel)
    with open(tel / "events.jsonl", "wb") as f:
        f.write(json.dumps({"type": "metrics", "t": NOW, "trace": "t1", "step": 1,
                            "values": {"loss/pg": 0.5, "perf/mfu": 0.25}}).encode() + b"\n")
        f.write(json.dumps({"type": "span", "t": NOW, "exemplar": "e1", "span": 2, "parent": 1,
                            "tier": "server", "name": "replica.forward", "dur_ms": 1.5}).encode() + b"\n")
        f.write(b'{"type": "metrics", "step": 2, "values": {"loss/pg\xe2')  # cut inside a UTF-8 sequence
    with open(tel / "events.jsonl.1", "w") as f:  # an older rotated segment
        f.write(json.dumps({"type": "phases", "t": NOW - 1, "step": 0,
                            "phases": {"learn": {"count": 2, "total_s": 0.5, "max_ms": 300.0}}}) + "\n")
        f.write('{"type": "span", "na')
    s = _assert_readers_agree(tmp_path, monkeypatch)
    assert s["health"]["loss/pg"]["last"] == 0.5 and s["phases"]["learn"]["count"] == 2
    assert "MISSING" in torch_tel.trace_report(str(tmp_path))  # the torn tree is shown, marked


def test_a_missing_folder_exits_2_as_the_reference(tmp_path, capsys):
    missing = str(tmp_path / "nope")
    assert torch_tel.diag_summary(missing) is None and torch_tel.trace_summary(missing) is None
    for argv in (["diag", missing], ["diag", missing, "--json"], ["trace", missing]):
        got, want = _cli(torch_launch, argv, capsys), _cli(jax_launch, argv, capsys)
        assert got == want and got[0] == 2 and got[2]
    empty = tmp_path / "empty"
    os.makedirs(empty)  # a folder without telemetry: diag 2, trace 2
    for argv in (["diag", str(empty)], ["trace", str(empty)]):
        got, want = _cli(torch_launch, argv, capsys), _cli(jax_launch, argv, capsys)
        assert got == want and got[0] == 2
