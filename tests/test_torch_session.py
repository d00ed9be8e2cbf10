"""The port's session layer (``surreal_tpu_torch/session/``,
``utils/faults.py``) against the JAX package's, and the port's checkpoint
manager on its own.

Against the reference, on identical inputs, with exact comparisons (they
are decisions, keys and counts): ``PeriodicTracker``, ``MetricAggregator``
and ``PeriodicTimeTracker`` over the same count and clock sequences,
``InterruptSentinel`` over the same signals, ``check_precision_metadata``
over the same metadata pairs (same raise, same message),
``PrecisionPolicy.meta()`` key for key, ``latency_percentiles`` and the
fault plan's validation. The checkpoint round trips are the port's own:
bit-exact save and restore, keep-last and keep-best retention, the
fallback past a truncated step, the nonfinite-step skip and the refusal
of a template of another shape or dtype."""

import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

from surreal_tpu.ops.precision import resolve_policy as jax_resolve_policy
from surreal_tpu.session import checkpoint as jax_checkpoint
from surreal_tpu.session import interrupt as jax_interrupt
from surreal_tpu.session import telemetry as jax_telemetry
from surreal_tpu.session import tracker as jax_tracker
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.utils import faults as jax_faults
from surreal_tpu_torch.launch.recovery import _state_is_finite
from surreal_tpu_torch.ops.precision import resolve_policy
from surreal_tpu_torch.session import checkpoint as torch_checkpoint
from surreal_tpu_torch.session import interrupt as torch_interrupt
from surreal_tpu_torch.session import metrics as torch_metrics
from surreal_tpu_torch.session import telemetry as torch_telemetry
from surreal_tpu_torch.session import tracker as torch_tracker
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.utils import faults as torch_faults

@pytest.fixture(autouse=True)
def _reset_fault_registries():
    yield
    jax_faults.configure(None)
    torch_faults.configure(None)


# -- trackers -----------------------------------------------------------------

@pytest.mark.parametrize("period,init,incs", [(1, 0, [1] * 5), (3, 0, [1] * 10), (4, 7, [1, 2, 5, 1, 3]), (10, 9, [1])])
def test_periodic_tracker_matches_jax(period, init, incs):
    def decisions(mod):
        t = mod.PeriodicTracker(period, init_count=init)
        return [(t.track_increment(n), t.count) for n in incs]

    assert decisions(torch_tracker) == decisions(jax_tracker)
    with pytest.raises(ValueError):
        torch_tracker.PeriodicTracker(0)


def test_time_tracker_and_aggregator_match_jax(monkeypatch):
    times = [0.0, 0.5, 1.0, 1.2, 2.5, 2.6, 4.0]

    def decisions(mod):
        ticks = iter(times)
        monkeypatch.setattr(mod.time, "monotonic", lambda: next(ticks))
        t = mod.PeriodicTimeTracker(1.0)
        return [t.track() for _ in times]

    assert decisions(torch_tracker) == decisions(jax_tracker) == [True, False, True, False, True, False, True]
    rows = [{"a": 1.0, "b": 2.0}, {"a": 3.0}, {"b": float("nan")}]

    def flushed(mod):
        agg = mod.MetricAggregator()
        for r in rows:
            agg.add(r)
        n = len(agg)
        return n, agg.flush(), len(agg)

    want, got = flushed(jax_tracker), flushed(torch_tracker)
    assert got[0] == want[0] and got[2] == want[2] == 0
    assert got[1]["a"] == want[1]["a"] and np.isnan(got[1]["b"]) and np.isnan(want[1]["b"])


# -- the interrupt sentinel ---------------------------------------------------

def _sentinel_record(mod):
    """Install, fire SIGTERM, then SIGINT (the escalation), then close:
    what the sentinel decided at each step."""
    before = signal.getsignal(signal.SIGTERM)
    s = mod.InterruptSentinel()
    rec = [s.installed, s.fired, s.signum]
    os.kill(os.getpid(), signal.SIGTERM)
    rec += [s.fired, s.signum]
    try:
        os.kill(os.getpid(), signal.SIGINT)
        rec.append("no escalation")
    except KeyboardInterrupt as e:
        rec.append(str(e))
    rec += [s.fired, s.signum]
    s.close()
    rec += [s.installed, signal.getsignal(signal.SIGTERM) is before]
    s.close()  # idempotent
    disabled = mod.InterruptSentinel(enabled=False)
    disabled.trigger()
    rec += [disabled.installed, disabled.fired, disabled.signum == signal.SIGTERM]
    off_main = []
    th = threading.Thread(target=lambda: off_main.append(mod.InterruptSentinel().installed))
    th.start()
    th.join(timeout=10)
    rec += [th.is_alive(), off_main]
    return rec


def test_interrupt_sentinel_matches_jax():
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers install only on the main thread")
    want, got = _sentinel_record(jax_interrupt), _sentinel_record(torch_interrupt)
    assert got == want
    assert want[:3] == [True, False, None] and want[3] is True and "second interrupt" in want[5]
    assert want[-2:] == [False, [False]]  # off the main thread: a no-op


# -- precision metadata -------------------------------------------------------

META_F32 = {"policy": "f32", "param_dtype": "float32", "compute_dtype": "float32", "data_dtype": "float32",
            "loss_scaling": False, "fp8": False}
META_PAIRS = [
    (None, META_F32),
    (META_F32, None),
    (META_F32, dict(META_F32)),
    (META_F32, dict(META_F32, policy="mixed", compute_dtype="bfloat16")),
    ({"policy": "bf16", "loss_scaling": True}, META_F32),
    ({"legacy": 1}, META_F32),
    (dict(META_F32, fp8=True), META_F32),
]


@pytest.mark.parametrize("pair", range(len(META_PAIRS)))
def test_check_precision_metadata_matches_jax(pair):
    recorded, active = META_PAIRS[pair]

    def outcome(mod):
        try:
            mod.check_precision_metadata(recorded, active)
        except mod.PrecisionMismatchError as e:
            return str(e)
        return None

    assert outcome(torch_checkpoint) == outcome(jax_checkpoint)


@pytest.mark.parametrize("precision", ["f32", "mixed"])
def test_precision_meta_matches_jax(precision):
    tree = {"algo": {"precision": precision}, "model": {}}
    assert resolve_policy(Config(tree)).meta() == jax_resolve_policy(JaxConfig(tree)).meta()
    assert resolve_policy(Config(tree)).telemetry() == jax_resolve_policy(JaxConfig(tree)).telemetry()


# -- telemetry, metrics, faults -----------------------------------------------

def test_latency_percentiles_match_jax():
    rng = np.random.default_rng(0)
    for n in (0, 1, 2, 7, 100):
        xs = rng.exponential(size=n).tolist()
        assert torch_telemetry.latency_percentiles(xs) == jax_telemetry.latency_percentiles(xs)


def test_tracer_spans_events_rotation_and_torn_tail(tmp_path):
    tr = torch_telemetry.Tracer(str(tmp_path), max_log_mb=0.002)
    with tr.span("train_iter"):
        pass
    with tr.span("train_iter"):
        pass
    with tr.span("eval", emit=True):
        pass
    row = tr.flush_phases(step=5)
    assert set(row) == {"time/train_iter_ms", "time/eval_ms"}
    assert tr.last_window["train_iter"]["count"] == 2
    assert tr.flush_phases(step=6) == {}  # the window was reset
    for i in range(40):  # past 2 kB: rotates to events.jsonl.1
        tr.log_metrics(i, {"loss": float(i)})
    tr.close()
    assert tr.rotations >= 1 and os.path.exists(tr.path + ".1")
    with open(tr.path, "a") as f:
        f.write('{"type": "metrics", "torn')  # a kill mid-write
    events = list(torch_telemetry._iter_jsonl(tr.path))
    assert events == list(jax_telemetry._iter_jsonl(tr.path))
    steps = [e["step"] for e in events if e["type"] == "metrics"]
    assert steps == sorted(steps) and steps[-1] == 39  # chronological across the rotation
    assert all(e["trace"] == tr.trace_id for e in events)
    disabled = torch_telemetry.Tracer(None)
    with disabled.span("x"):
        pass
    disabled.event("metrics")
    assert disabled.flush_phases(0) == {}


def test_metrics_writer_drops_nan_and_degrades_without_tensorboard(tmp_path, monkeypatch, capsys):
    monkeypatch.setattr(torch_metrics, "_event_file_writer", lambda d: (None, ImportError("no tensorboard")))
    w = torch_metrics.MetricsWriter(str(tmp_path), tensorboard=True, console=True)
    w.write(3, {"a": 1.5, "b": float("nan")})
    w.close()
    out = capsys.readouterr().out
    assert "[3] a=1.5" in out and "b=" not in out


@pytest.mark.parametrize("plan", [
    [{"site": "trainer.iteration", "kind": "nan_state", "at": 2}],
    json.dumps([{"site": "engine.stage", "kind": "delay_stage", "at": 0, "times": 2, "ms": 1}]),
    [{"site": "trainer.iteration", "kind": "explode"}],
    [{"site": "no.such.site", "kind": "delay"}],
    [{"site": "trainer.iteration"}],
])
def test_fault_plans_match_jax(plan):
    """The same plan validates (or fails) alike, and fires on the same
    calls; a site of a path the port lacks raises NotImplementedError."""

    def record(mod, cfg_cls):
        try:
            inj = mod.configure_from(cfg_cls({"faults": {"plan": plan}}))
        except ValueError as e:
            return type(e).__name__
        fired = [(site, mod.fire(site) is not None) for site in ["trainer.iteration", "engine.stage"] * 4]
        return fired, mod.drain_fired(), inj.counts()

    assert record(torch_faults, Config) == record(jax_faults, JaxConfig)
    with pytest.raises(NotImplementedError, match="ops.push"):
        torch_faults.configure([{"site": "ops.push", "kind": "drop_frame"}])


# -- checkpoints --------------------------------------------------------------

def _state(seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return {
        "params": {"w": torch.randn(3, 4, generator=g), "b": torch.randn(4, generator=g).to(torch.bfloat16)},
        "count": torch.tensor(seed, dtype=torch.int32),
        "ring": (torch.randint(0, 255, (5, 2), generator=g).to(torch.uint8), 7, None),
    }


def _equal(a, b):
    from surreal_tpu_torch.utils.tree import tree_flatten

    fa, fb = tree_flatten(a), tree_flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k
    return True


def test_checkpoint_round_trip_is_bit_exact_and_refuses_other_templates(tmp_path):
    mgr = torch_checkpoint.CheckpointManager(str(tmp_path), keep_last=3)
    assert mgr.restore(_state()) is None  # an empty folder
    saved = _state(1)
    mgr.save(4, saved, env_steps=400)
    state, meta = mgr.restore(_state(9))
    assert _equal(state, saved) and meta == {"iteration": 4, "env_steps": 400}
    assert mgr.latest_step() == 4 and mgr.steps() == [4]
    wrong_shape = _state(9)
    wrong_shape["params"]["w"] = torch.zeros(4, 3)
    with pytest.raises(ValueError, match="params/w"):
        mgr.restore(wrong_shape, step=4)
    wrong_dtype = _state(9)
    wrong_dtype["params"]["b"] = wrong_dtype["params"]["b"].float()
    with pytest.raises(ValueError, match="params/b"):
        mgr.restore(wrong_dtype)  # every step fails: the newest error is raised
    extra = _state(9)
    extra["params"]["v"] = torch.zeros(1)
    with pytest.raises(ValueError, match="missing"):
        mgr.restore(extra, step=4)
    # the saved file is a flat dict of tensors and plain leaves
    payload = torch.load(os.path.join(mgr.directory, "4", "state.pt"), weights_only=True)
    assert set(payload["tensors"]) == {"params/w", "params/b", "count", "ring/0"}
    assert payload["leaves"] == {"ring/1": 7, "ring/2": None}


def test_checkpoint_keep_last_keep_best_and_stale_steps(tmp_path):
    events = []
    mgr = torch_checkpoint.CheckpointManager(
        str(tmp_path), keep_last=2, best_key="eval/return", on_event=lambda t, **f: events.append((t, f))
    )
    for step, ret in [(1, 5.0), (2, 9.0), (3, float("nan")), (4, 7.0)]:
        mgr.save(step, _state(step), env_steps=step * 10, metrics={"eval/return": ret})
    assert mgr.steps() == [3, 4]
    assert mgr.best_metric() == {"value": 9.0, "step": 2}
    best, meta = mgr.restore_best(_state())
    assert _equal(best, _state(2)) and meta["iteration"] == 2
    mgr.save(4, _state(99))  # a step not above the newest is skipped, as orbax does
    assert _equal(mgr.restore(_state(), step=4)[0], _state(4))
    mgr.save(6, _state(6))
    mgr.save_extra(6, {"replay": _state(60)})
    assert mgr.restore_extra({"replay": _state()}, step=5) is None
    assert _equal(mgr.restore_extra({"replay": _state()}, step=6)["replay"], _state(60))
    # a kill mid-save leaves only a temporary directory, which is ignored
    # and cleared by the next manager
    os.makedirs(os.path.join(mgr.directory, ".tmp-8-dead"))
    again = torch_checkpoint.CheckpointManager(str(tmp_path), keep_last=2)
    assert again.steps() == [4, 6] and not any(n.startswith(".tmp") for n in os.listdir(mgr.directory))
    assert events == []


def test_checkpoint_falls_back_past_damaged_and_nonfinite_steps(tmp_path):
    events = []
    mgr = torch_checkpoint.CheckpointManager(str(tmp_path), keep_last=5, on_event=lambda t, **f: events.append(f))
    mgr.save(1, _state(1), env_steps=10)
    poisoned = _state(2)
    poisoned["params"]["w"][0, 0] = float("nan")
    mgr.save(2, poisoned, env_steps=20)
    mgr.save(3, _state(3), env_steps=30)
    path = os.path.join(mgr.directory, "3", "state.pt")
    with open(path, "r+b") as f:  # a truncated newest step
        f.truncate(os.path.getsize(path) // 2)
    state, meta = mgr.restore(_state(), validate=_state_is_finite)
    assert meta["iteration"] == 1 and _equal(state, _state(1))
    assert [e["kind"] for e in events] == ["checkpoint_fallback", "skipped_nonfinite_checkpoint"]
    assert events[0]["bad_step"] == 3 and events[0]["next_step"] == 2 and events[1]["step"] == 2
    # an explicit step raises its own error
    with pytest.raises(Exception):
        mgr.restore(_state(), step=3)
    # every readable step rejected: None, the caller starts fresh
    only_poison = torch_checkpoint.CheckpointManager(str(tmp_path / "p"))
    only_poison.save(2, poisoned)
    assert only_poison.restore(_state(), validate=_state_is_finite) is None


def test_checkpoint_run_metadata_guards_the_precision_policy(tmp_path):
    mgr = torch_checkpoint.CheckpointManager(str(tmp_path))
    assert mgr.run_metadata() is None
    mgr.check_precision(META_F32)  # no record: passes
    mgr.save_run_metadata(META_F32)
    assert mgr.run_metadata() == META_F32
    with pytest.raises(torch_checkpoint.PrecisionMismatchError, match="policy"):
        mgr.check_precision(dict(META_F32, policy="mixed", compute_dtype="bfloat16"))
    with open(os.path.join(mgr.directory, "run_meta.json"), "w") as f:
        f.write('{"torn')
    assert mgr.run_metadata() is None
    cfg = Config({"folder": str(tmp_path), "checkpoint": {"every_n_iters": 0, "keep_last": 1, "keep_best": True}})
    assert torch_checkpoint.make_checkpoint_manager(cfg) is None


def test_state_is_finite_reads_every_floating_leaf():
    state = _state(1)
    assert _state_is_finite(state)
    state["params"]["b"][1] = float("inf")
    assert not _state_is_finite(state)
    assert _state_is_finite({"n": 3, "i": torch.ones(2, dtype=torch.int64)})


@pytest.mark.slow
def test_ppo_learns_on_lift(tmp_path):
    """The CPU mirror of tests/test_envs.py::test_ppo_learns_on_lift, on the
    port through ``Trainer.run``: the same config (256 envs x 64 steps,
    4 epochs x 4 minibatches, 'mixed', metrics every 10 iterations, at most
    5,000,000 env steps) must push the episode return past 400."""
    from surreal_tpu_torch.launch.trainer import Trainer
    from surreal_tpu_torch.session.default_configs import base_config

    cfg = Config(
        learner_config=Config(algo=Config(name="ppo", horizon=64, epochs=4, num_minibatches=4)),
        env_config=Config(name="jax:lift", num_envs=256),
        session_config=Config(
            folder=str(tmp_path), total_env_steps=5_000_000,
            metrics=Config(every_n_iters=10, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
        ),
    ).extend(base_config())
    best = {"ret": float("-inf")}

    def cb(it, m):
        r = m.get("episode/return", float("nan"))
        if r == r:
            best["ret"] = max(best["ret"], r)
        return best["ret"] >= 400.0

    Trainer(cfg, device="cpu").run(on_metrics=cb)
    assert best["ret"] >= 400.0, f"best lift return {best['ret']} < 400"
