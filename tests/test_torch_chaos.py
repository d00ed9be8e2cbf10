"""The port's chaos campaigns (``surreal_tpu_torch/chaos/``) against the
JAX package's ``surreal_tpu/chaos/``, on the CPU:

- ``generate_schedule(seed, profile)`` gives JSON-equal plans for seeds
  0-29 of every profile, each valid in the port's fault registry;
- every oracle gives the reference's verdict (violations and skip reason,
  exact) on the same synthetic records, the checkpoint oracle on each
  package's own checkpoints of one finite or NaN state and the WAL oracle
  on one spill log (the packages' logs are byte-equal);
- ``shrink`` and ``run_campaign`` over the reference's stub runner and
  broken oracle give the reference's artifact but for the wall time
  (``chaos/run_ms``), and the same telemetry events;
- a real mini campaign (``seed_experience`` and ``ddpg_spill``, one seed
  each) passes every oracle on the CPU, the artifact round-tripping
  through ``write_artifact``."""

import copy
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.chaos import campaign as jax_campaign
from surreal_tpu.chaos import invariants as jax_inv
from surreal_tpu.chaos import schedule as jax_schedule
from surreal_tpu.session.checkpoint import CheckpointManager as JaxCheckpointManager
from surreal_tpu_torch.chaos import campaign as chaos_campaign
from surreal_tpu_torch.chaos import invariants as inv
from surreal_tpu_torch.chaos import schedule as chaos_schedule
from surreal_tpu_torch.experience import wire
from surreal_tpu_torch.experience.spill import build_writer
from surreal_tpu_torch.session.checkpoint import CheckpointManager
from surreal_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _no_faults():
    faults.configure(None)
    yield
    faults.configure(None)


# -- schedule ------------------------------------------------------------------

@pytest.mark.parametrize("profile", sorted(jax_schedule.PROFILES))
def test_schedules_equal_the_reference(profile):
    assert chaos_schedule.PROFILES == jax_schedule.PROFILES
    assert chaos_schedule.SITE_META == jax_schedule.SITE_META
    for seed in range(30):
        got = chaos_schedule.generate_schedule(seed, profile)
        assert json.dumps(got, sort_keys=True) == json.dumps(jax_schedule.generate_schedule(seed, profile),
                                                             sort_keys=True), seed
        faults.FaultInjector(got["plan"])
        assert {e["site"] for e in got["plan"]} <= set(chaos_schedule.PROFILES[profile]["sites"])


# -- oracles ---------------------------------------------------------------------

def _close_event(**over):
    base = {
        "type": "experience_close", "quiesced": 1.0,
        "sent_rows": 100.0, "ingested_rows": 90.0, "dropped_rows": 6.0,
        "inflight_rows": 4.0, "resends": 0.0, "rehellos": 0.0,
        "dead_links": 0.0, "respawns": 0.0, "num_shards": 2.0,
        "shards_live": 2.0,
    }
    base.update(over)
    return base


def _rows(*vals):
    return [{"type": "metrics", "values": {"param/publishes": v}} for v in vals]


def _tiers(respawns):
    return [
        {"type": "serving_tier", "fleet/respawns": 0.0,
         "replicas": {"0": {"state": "alive", "param_version": 4}}},
        {"type": "serving_tier", "fleet/respawns": respawns,
         "replicas": {"0": {"state": "alive", "param_version": 2}, "1": {"state": "dead"}}},
    ]


KILL = [{"site": "env_worker.step", "kind": "kill_worker", "at": 3, "times": 1}]
SPAN = [{"site": "trace.emit", "kind": "drop_span", "at": 1, "times": 1}]
TEAR = [{"site": "experience.spill", "kind": "truncate_segment", "at": 0, "times": 1}]

RECORDS = {
    "exactly_once-ok": dict(events=[_close_event()]),
    "exactly_once-dup": dict(events=[_close_event(ingested_rows=99.0)]),
    "exactly_once-loss": dict(events=[_close_event(inflight_rows=0.0)]),
    "exactly_once-rekeyed": dict(events=[_close_event(rehellos=2.0, ingested_rows=999.0)]),
    "exactly_once-wedged": dict(events=[_close_event(quiesced=0.0, ingested_rows=999.0)]),
    "exactly_once-shard-down": dict(events=[_close_event(shards_live=1.0, ingested_rows=999.0)]),
    "counted-silent": dict(plan=KILL, counts={"env_worker.step": 10}, metrics={"workers/respawns": 0.0}),
    "counted-ok": dict(plan=KILL, counts={"env_worker.step": 10}, metrics={"workers/respawns": 1.0}),
    "counted-undelivered": dict(plan=KILL, counts={"env_worker.step": 2}, metrics={"workers/respawns": 0.0}),
    "monotone-ok": dict(events=_rows(1.0, 2.0, 2.0, 5.0)),
    "monotone-decreased": dict(events=_rows(3.0, 1.0)),
    "monotone-rows": dict(events=[{"type": "metrics", "values": {"experience/rows": v, "experience/respawns": r}}
                                  for v, r in ((10.0, 0.0), (4.0, 0.0), (2.0, 1.0))]),
    "monotone-replica-regressed": dict(events=_tiers(0.0)),
    "monotone-replica-respawned": dict(events=_tiers(1.0)),
    "residue-leaky": dict(residue={"threads": ["xp-shard-0"], "shm": ["/dev/shm/surreal_pt_x"], "fds": ["f"]}),
    "residue-none": dict(residue={}),
    "surfacing-ok": dict(plan=SPAN, counts={"trace.emit": 5},
                         events=[{"type": "fault", "site": "trace.emit", "kind": "drop_span"}]),
    "surfacing-vanished": dict(plan=SPAN, counts={"trace.emit": 5}),
    "crashed": dict(error="RuntimeError: boom"),
}


def _rec(module, folder="/nonexistent", **over):
    base = dict(folder=folder, plan=[], metrics={}, events=[], counts={},
                residue={"threads": [], "shm": [], "fds": []})
    base.update(copy.deepcopy(over))
    return module.RunRecord(**base)


@pytest.mark.parametrize("name", sorted(RECORDS))
def test_oracles_give_the_reference_verdicts(name):
    want = jax_inv.evaluate(_rec(jax_inv, **RECORDS[name]))
    got = inv.evaluate(_rec(inv, **RECORDS[name]))
    assert got == want
    assert [o.__name__ for o in inv.ORACLES] == [o.__name__ for o in jax_inv.ORACLES]


@pytest.mark.parametrize("case", ["finite", "nan", "nan-over-finite"])
def test_checkpoint_oracle_gives_the_reference_verdict(case, tmp_path):
    """Each package's own checkpoints of one state (finite, or NaN in one
    leaf, the newest over a finite older one) and its final state as the
    template: the same verdict."""
    verdicts = []
    steps = {"finite": [1.0], "nan": [float("nan")], "nan-over-finite": [1.0, float("nan")]}[case]
    for module, mgr_cls, make in ((jax_inv, JaxCheckpointManager, jnp.asarray),
                                  (inv, CheckpointManager, torch.tensor)):
        folder = str(tmp_path / module.__name__.split(".")[0])
        mgr = mgr_cls(folder)
        for step, v in enumerate(steps, 1):
            mgr.save(step, {"w": make(np.array([v, 2.0], np.float32)), "n": make(np.array(step, np.int32))})
        template = {"w": make(np.zeros(2, np.float32)), "n": make(np.array(0, np.int32))}
        verdict = module.oracle_checkpoint_restorable(_rec(module, folder=folder, state=template))
        verdicts.append(json.loads(json.dumps(verdict).replace(folder, "F")))
    assert verdicts[1] == verdicts[0]
    assert bool(verdicts[0]["violations"]) == (case == "nan")


@pytest.mark.parametrize("case", ["clean", "short-ledger", "torn-injected", "torn-silent"])
def test_wal_oracle_gives_the_reference_verdict(case, tmp_path):
    spec = wire.PlaneSpec.from_example({"obs": np.zeros((3,), np.float32), "reward": np.zeros((), np.float32)})
    if case.startswith("torn"):
        faults.configure([{"site": "experience.spill", "kind": "truncate_segment", "at": 1}])
    w = build_writer({"enabled": True, "dir": str(tmp_path / "spill")}, spec, 0)
    rng = np.random.default_rng(0)
    for _ in range(3):
        w.append({"obs": rng.normal(size=(8, 3)).astype(np.float32),
                  "reward": rng.normal(size=(8,)).astype(np.float32)}, 8)
    w.close()
    faults.configure(None)
    over = dict(metrics={"tier/spill_segments": 5.0 if case == "short-ledger" else 2.0},
                plan=TEAR if case == "torn-injected" else [], counts={"experience.spill": 3})
    got = inv.oracle_wal_consistency(_rec(inv, folder=str(tmp_path), **over))
    assert got == jax_inv.oracle_wal_consistency(_rec(jax_inv, folder=str(tmp_path), **over))
    assert bool(got["violations"]) == (case in ("short-ledger", "torn-silent"))


# -- shrinker and campaign over a stub runner ---------------------------------------

BAD = ("trace.emit", "drop_span")


def _stub_runner_factory(module, bad_pair=BAD):
    """The reference's stub (tests/test_chaos.py): every fault reads as
    delivered, and the broken oracle fails iff the poisoned spec is still
    in the plan."""

    def runner(sched, folder):
        return _rec(module, plan=[dict(e) for e in sched["plan"]],
                    counts={e["site"]: e["at"] + 5 for e in sched["plan"]})

    def broken_oracle(rec):
        bad = [e for e in rec.plan if (e["site"], e["kind"]) == bad_pair]
        return {"name": "broken", "skipped": None,
                "violations": [{"oracle": "broken", "what": "synthetic", **e} for e in bad]}

    return runner, broken_oracle


def test_shrinker_converges_as_the_reference():
    profile = "seed_experience"
    seed = next(s for s in range(100)
                if any((e["site"], e["kind"]) == BAD for e in chaos_schedule.generate_schedule(s, profile)["plan"]))
    sched = chaos_schedule.generate_schedule(seed, profile)
    out = []
    for module, camp in ((jax_inv, jax_campaign), (inv, chaos_campaign)):
        runner, broken = _stub_runner_factory(module)

        def still_fails(plan, runner=runner, broken=broken, module=module):
            return bool(module.evaluate(runner(dict(sched, plan=plan), "/nonexistent"), (broken,))["violations"])

        out.append(camp.shrink(sched["plan"], still_fails))
    assert out[1] == out[0]
    minimal, runs = out[1]
    assert len(minimal) == 1 and (minimal[0]["site"], minimal[0]["kind"]) == BAD and runs <= 32


def test_campaign_artifact_equals_the_reference(tmp_path):
    artifacts, events = [], []
    for module, camp in ((jax_inv, jax_campaign), (inv, chaos_campaign)):
        runner, broken = _stub_runner_factory(module)
        base = str(tmp_path / module.__name__.split(".")[0])
        art = camp.run_campaign(seeds=6, base_dir=base, oracles=(broken,), runner=runner, log=lambda *_: None)
        assert art["gauges"].pop("chaos/run_ms") >= 0
        artifacts.append(art)
        events.append([{k: v for k, v in e.items() if k not in ("t", "chaos/run_ms")}
                       for e in chaos_campaign._read_events(base)])
    assert artifacts[1] == artifacts[0]
    assert events[1] == events[0]
    assert artifacts[1]["failures"] and artifacts[1]["gauges"]["chaos/schedules"] == 6.0
    for fail in artifacts[1]["failures"]:
        assert fail["replay"] == {"profile": fail["profile"], "seed": fail["seed"]}
        assert [(e["site"], e["kind"]) for e in fail["minimal_plan"]] == [BAD]


# -- a real mini campaign -------------------------------------------------------------

def test_mini_campaign_two_real_runs_zero_violations(tmp_path):
    """Two seeded REAL runs on the CPU (SEED through the experience plane;
    host DDPG over the remote replay with the spill WAL) under generated
    multi-site schedules, every oracle clean."""
    artifact = chaos_campaign.run_campaign(
        seeds=2, base_dir=str(tmp_path), profiles=["seed_experience", "ddpg_spill"],
        log=lambda *_: None, backend="cpu",
    )
    assert artifact["gauges"]["chaos/schedules"] == 2.0
    assert artifact["gauges"]["chaos/faults_injected"] >= 2
    assert len(artifact["sites_covered"]) >= 2
    for s in artifact["schedules"]:
        assert s["violations"] == 0, (s["seed"], s["profile"], s["oracles"])
    assert artifact["failures"] == []
    out = tmp_path / "campaign.json"
    chaos_campaign.write_artifact(str(out), artifact)
    assert json.loads(out.read_text())["kind"] == "chaos_campaign"
    assert os.path.exists(tmp_path / "telemetry" / "events.jsonl")
