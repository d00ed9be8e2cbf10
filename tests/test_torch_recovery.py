"""The port's divergence guard (``launch/recovery.py``) against the JAX
package's, and the recovery paths of the port's trainers on the CPU.

Against the reference: the same sequences of synced metric windows
(healthy, NaN, over-limit ``health/grad_norm``) go to both
``RecoveryManager``s, and every decision must be equal: the trip reason,
``pending``, ``last_window_tripped``, the rollback count and nonce, the
LR scale, the heal streak and ``TrainingDiverged``. All exact.

The port's own, through ``Trainer.run`` and ``OffPolicyTrainer.run`` at a
tiny size: a ``nan_state`` fault rolls back to the last finite checkpoint
with the LR backed off, repeated faults end in ``TrainingDiverged``, a
SIGTERM stops the run at the boundary with an emergency checkpoint that
a relaunch resumes bit-equal, ``restore_from`` warm-starts from another
folder, and DDPG's ``include_replay`` restores the ring bit-equal."""

import os
import signal
import threading

import pytest
import torch

from surreal_tpu.launch import recovery as jax_recovery
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu_torch.launch import recovery as torch_recovery
from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer
from surreal_tpu_torch.launch.trainer import Trainer
from surreal_tpu_torch.learners.base import OptState, set_recovery_lr_scale
from surreal_tpu_torch.session.checkpoint import CheckpointManager
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.session.telemetry import _iter_jsonl
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.tree import tree_flatten

NAN = float("nan")


@pytest.fixture(autouse=True)
def _reset_fault_registry():
    yield
    faults.configure(None)


class _Log:
    def info(self, *a):
        pass

    warning = info


class _Tracer:
    def __init__(self):
        self.events = []

    def event(self, type_, **fields):
        self.events.append((type_, fields.get("kind"), fields.get("reason")))


HEALTHY = {"health/nonfinite": 0.0, "health/grad_norm": 1.0}
WINDOWS = {
    # a trip, a rollback, healthy windows that heal the streak, a second trip
    "heal": ([HEALTHY, {"health/nonfinite": 1.0}] + [HEALTHY] * 3 + [{"health/nonfinite": 1.0, "health/grad_norm": NAN}],
             {"heal_after_windows": 3}),
    # grad norm over the limit, then repeated trips past max_rollbacks
    "giveup": ([HEALTHY, {"health/nonfinite": 0.0, "health/grad_norm": 50.0}, HEALTHY,
                {"health/nonfinite": 1.0}, {"health/nonfinite": 1.0}],
               {"grad_norm_limit": 10.0, "max_rollbacks": 2, "lr_backoff": 0.3, "min_lr_scale": 0.1}),
    "warn": ([{"health/nonfinite": 1.0}, HEALTHY, {"health/grad_norm": 99.0}], {"on_divergence": "warn", "grad_norm_limit": 5.0}),
    "off": ([{"health/nonfinite": 1.0}, {}], {"on_divergence": "off"}),
    "defaults": ([{"health/nonfinite": 1.0}] * 5, {}),
}


def _decisions(mod, cfg_cls, windows, rc):
    """Feed the windows; roll back whenever the guard says pending (from
    no checkpoint, onto a fresh init). The decisions, in order."""
    tracer = _Tracer()
    mgr = mod.RecoveryManager(cfg_cls({"session_config": {"recovery": rc}}), None, tracer, _Log())
    out = []
    for i, m in enumerate(windows):
        reason = mgr.check(m, i, i * 10)
        out.append(("check", reason, mgr.pending, mgr.last_window_tripped, mgr.rollbacks, mgr._healthy_streak))
        if mgr.pending:
            try:
                rb = mgr.rollback({}, fresh=lambda nonce: {})
                out.append(("rollback", rb.iteration, rb.env_steps, rb.nonce, rb.lr_scale, rb.extra))
            except mod.TrainingDiverged:
                out.append(("diverged", mgr.rollbacks))
                break
    with pytest.raises(mod.TrainingDiverged):
        mgr.rollback({}, fresh=None)  # nothing to roll back to
    return out, tracer.events


@pytest.mark.parametrize("name", sorted(WINDOWS))
def test_recovery_decisions_match_jax(name):
    windows, rc = WINDOWS[name]
    want = _decisions(jax_recovery, JaxConfig, windows, rc)
    got = _decisions(torch_recovery, Config, windows, rc)
    assert got == want
    kinds = [e[1] for e in want[1]]
    if name == "heal":
        assert kinds == ["tripped", "rollback", "healed", "tripped", "rollback", "giveup"]
    if name == "giveup":
        assert ("diverged", 3) in want[0] and "grad_norm" in [e[2] for e in want[1]]
    with pytest.raises(ValueError):
        torch_recovery.RecoveryManager(Config({"session_config": {"recovery": {"on_divergence": "x"}}}), None, _Tracer(), _Log())


def _tiny(tmp_path, algo="ppo", **session):
    learner = {"algo": {"name": "ppo", "horizon": 8, "epochs": 1, "num_minibatches": 1, "precision": "f32"}}
    if algo == "ddpg":
        learner = {
            "algo": {"name": "ddpg", "horizon": 4, "updates_per_iter": 2, "precision": "f32"},
            "replay": {"kind": "prioritized", "capacity": 256, "start_sample_size": 32, "batch_size": 16},
        }
    sess = {"folder": str(tmp_path), "metrics": {"every_n_iters": 1, "tensorboard": False, "console": False},
            "checkpoint": {"every_n_iters": 2}, "eval": {"every_n_iters": 0}}
    for k, v in session.items():
        sess[k] = {**sess.get(k, {}), **v} if isinstance(v, dict) else v
    return Config(learner_config=learner, env_config={"name": "jax:lift", "num_envs": 8, "time_limit": 5},
                  session_config=sess).extend(base_config())


def _events(folder):
    return list(_iter_jsonl(os.path.join(folder, "telemetry", "events.jsonl")))


def _bit_equal(a, b):
    fa, fb = tree_flatten(a), tree_flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype and torch.equal(fa[k], fb[k]), k
        else:
            assert fa[k] == fb[k], k
    return True


def test_set_recovery_lr_scale_reaches_every_optimizer_state(tmp_path):
    for algo, n in (("ppo", 1), ("ddpg", 2)):
        tr = (OffPolicyTrainer if algo == "ddpg" else Trainer)(_tiny(tmp_path, algo), device="cpu")
        state = set_recovery_lr_scale(tr.learner.init(), 0.25)
        opts = [x for x in state if isinstance(x, OptState)]
        assert len(opts) == n and all(float(o.recovery_scale) == 0.25 for o in opts)
        assert len({o.recovery_scale.data_ptr() for o in opts}) == n  # one tensor each


def test_nan_state_rolls_back_to_the_last_finite_checkpoint(tmp_path):
    """``nan_state`` before iteration 4 poisons its learn; the window trips,
    its checkpoint is skipped, the run rolls back to step 2 with the LR
    scale at lr_backoff, replays iterations 3-8 and ends finite."""
    cfg = _tiny(tmp_path, faults={"plan": [{"site": "trainer.iteration", "kind": "nan_state", "at": 3}]})
    seen = []
    state, m = Trainer(cfg, device="cpu").run(max_env_steps=8 * 64, on_metrics=lambda i, m: seen.append(
        (i, m["health/nonfinite"])))
    assert seen[:4] == [(1, 0.0), (2, 0.0), (3, 0.0), (4, 1.0)]
    assert [i for i, _ in seen[4:]] == [3, 4, 5, 6, 7, 8] and all(n == 0.0 for _, n in seen[4:])
    assert float(state.opt_state.recovery_scale) == 0.5
    assert all(v == v for k, v in m.items() if k != "episode/return") and m["time/env_steps"] == 8 * 64
    rec = [e for e in _events(str(tmp_path)) if e["type"] == "recovery"]
    assert [e["kind"] for e in rec] == ["tripped", "rollback"]
    assert rec[1]["to_iteration"] == 2 and rec[1]["lr_scale"] == 0.5 and rec[1]["source"] == "checkpoint step 2"
    assert [e["kind"] for e in _events(str(tmp_path)) if e["type"] == "fault"] == ["nan_state"]
    assert CheckpointManager(str(tmp_path)).steps() == [4, 6, 8]  # keep_last 3


def test_repeated_divergence_ends_in_training_diverged(tmp_path):
    cfg = _tiny(
        tmp_path, checkpoint={"every_n_iters": 1}, recovery={"max_rollbacks": 2},
        faults={"plan": [{"site": "trainer.iteration", "kind": "nan_state", "at": 1, "times": 50}]},
    )
    with pytest.raises(torch_recovery.TrainingDiverged, match="max_rollbacks=2"):
        Trainer(cfg, device="cpu").run(max_env_steps=20 * 64)
    kinds = [e["kind"] for e in _events(str(tmp_path)) if e["type"] == "recovery"]
    assert kinds == ["tripped", "rollback", "tripped", "rollback", "tripped", "giveup"]


def test_sigterm_stops_at_the_boundary_and_a_relaunch_resumes_bit_equal(tmp_path):
    """Kill and resume: SIGTERM from ``on_metrics`` at iteration 3 stops
    the run there with the emergency checkpoint; a relaunch into the same
    folder restores that state bit-equal and continues the curve at
    iteration 4 and 3 x 64 env steps."""
    if threading.current_thread() is not threading.main_thread():
        pytest.skip("signal handlers install only on the main thread")
    cfg = _tiny(tmp_path, checkpoint={"every_n_iters": 100})
    prev = signal.getsignal(signal.SIGTERM)

    def on_metrics(i, m):
        if i == 3:
            os.kill(os.getpid(), signal.SIGTERM)

    stopped, m = Trainer(cfg, device="cpu").run(max_env_steps=10 * 64, on_metrics=on_metrics)
    assert signal.getsignal(signal.SIGTERM) is prev  # the handlers were restored
    assert m["time/env_steps"] == 3 * 64
    assert CheckpointManager(str(tmp_path)).steps() == [3]
    interrupts = [e for e in _events(str(tmp_path)) if e.get("kind") == "interrupt"]
    assert len(interrupts) == 1 and interrupts[0]["iteration"] == 3

    tr = Trainer(cfg, device="cpu")
    restored, meta = CheckpointManager(str(tmp_path)).restore(tr.learner.init())
    assert meta == {"iteration": 3, "env_steps": 3 * 64} and _bit_equal(restored, stopped)
    seen = []
    tr.run(max_env_steps=5 * 64, on_metrics=lambda i, m: seen.append((i, m["time/env_steps"])))
    assert seen == [(4, 4 * 64), (5, 5 * 64)]
    assert CheckpointManager(str(tmp_path)).steps() == [3, 5]


def test_restore_from_warm_starts_from_a_foreign_folder(tmp_path):
    src, dst = tmp_path / "src", tmp_path / "dst"
    saved, _ = Trainer(_tiny(src), device="cpu").run(max_env_steps=2 * 64)
    cfg = _tiny(dst, checkpoint={"restore_from": str(src)})
    tr = Trainer(cfg, device="cpu")
    seen = []
    tr.run(max_env_steps=3 * 64, on_metrics=lambda i, m: seen.append(i))
    assert seen == [3]
    with pytest.raises(FileNotFoundError):
        Trainer(_tiny(tmp_path / "x", checkpoint={"restore_from": str(tmp_path / "empty")}), device="cpu").run(
            max_env_steps=64)


def test_ddpg_include_replay_round_trip(tmp_path):
    """Three DDPG iterations save the prioritized replay (storage, host
    cursor and size, priorities, max priority) with the checkpoint; the
    relaunch's first iteration starts from that replay, bit-equal."""
    cfg = _tiny(tmp_path, "ddpg", checkpoint={"every_n_iters": 3, "include_replay": True})

    def capture(tr, into):
        inner = tr._device_train_iter

        def wrapped(state, replay_state, carry, **kw):
            # clones: the iteration updates the ring in place
            into.append(("in", tree_flatten_clone(replay_state), kw["first"]))
            out = inner(state, replay_state, carry, **kw)
            into.append(("out", tree_flatten_clone(out[1]), kw["first"]))
            return out

        tr._device_train_iter = wrapped

    def tree_flatten_clone(tree):
        return {k: v.clone() if isinstance(v, torch.Tensor) else v for k, v in tree_flatten(tree).items()}

    first, again = [], []
    tr = OffPolicyTrainer(cfg, device="cpu")
    capture(tr, first)
    tr.run(max_env_steps=3 * 32)
    saved = first[-1][1]
    assert saved["ring/cursor"] == 96 and saved["ring/size"] == 96
    tr2 = OffPolicyTrainer(cfg, device="cpu")
    capture(tr2, again)
    tr2.run(max_env_steps=4 * 32)
    resumed = again[0][1]
    assert again[0][2] is True  # a fresh carry: its first chunk is scrubbed again
    assert resumed.keys() == saved.keys()
    for k in saved:
        assert (torch.equal(resumed[k], saved[k]) if isinstance(saved[k], torch.Tensor) else resumed[k] == saved[k]), k
    assert sorted(os.listdir(os.path.join(tmp_path, "checkpoints", "extra"))) == ["3", "4"]
