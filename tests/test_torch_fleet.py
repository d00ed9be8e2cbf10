"""The port's serving tier (``distributed/fleet.py``, the fleet paths of
``distributed/inference_server.py`` and ``launch/seed_trainer.py``)
against the JAX package's, on the CPU:

- routing parity: ``replica_of`` equal to the reference's for 64 worker
  ids over every alive subset of 4 slots, and each replica's ``min_batch``
  equal to the reference's;
- chunk parity: the per-worker chunk streams of a 2-replica fleet equal
  to the reference fleet's, bit for bit, with one deterministic numpy
  act function and thread workers on gym:CartPole-v1;
- the behaviour of tests/test_fleet.py's cases on the port: affinity,
  rendezvous remap, supervise and backoff, autoscale bounds and
  cooldown, kill-replica chaos, fd and slab hygiene; ``serve_act``'s
  pinned, evicted and dead-slot cases; two replica slots acting at once
  equal to the same requests served one after another.

The reference's own kill-replica chaos test fails on every tree, on
timing: its remediation engine (on by default) may answer the kill's
incident with a ``fleet_scale_up`` (3 replicas at the end), and its
killed replica's worker may never time out (killed before it connected,
or answered by the respawned replica after zmq's DEALER reconnects). The
port has no remediation and its DEALER does not reconnect; its mirror is
held to 2 replicas with its iterations paced, and compared (``-m slow``)
with the reference run with ``session_config.remediate.enabled=False``.

Every wait is bounded; no assertion is on speed."""

import glob
import itertools
import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from surreal_tpu.distributed import run_env_worker as jax_run_env_worker
from surreal_tpu.distributed.fleet import InferenceFleet as JaxFleet
from surreal_tpu.distributed.fleet import _rendezvous_score as jax_rendezvous_score
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import BASE_ENV_CONFIG as JAX_BASE_ENV_CONFIG
from surreal_tpu_torch.distributed import InferenceFleet, run_env_worker
from surreal_tpu_torch.distributed.fleet import _rendezvous_score
from surreal_tpu_torch.distributed.shm_transport import SLAB_PREFIX
from surreal_tpu_torch.launch.seed_trainer import SEEDTrainer
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import BASE_ENV_CONFIG, base_config
from surreal_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _no_faults():
    faults.configure(None)
    yield
    faults.configure(None)


def _act_fn(obs):
    """Actions and info from each row's obs alone (batching cannot change
    them)."""
    b = obs.shape[0]
    s = np.nan_to_num(obs.reshape(b, -1).astype(np.float32)).sum(axis=1)
    logits = np.stack([0.5 * s, -0.5 * s], axis=1).astype(np.float32)
    action = (s > 0).astype(np.int32)
    logp = (logits[np.arange(b), action] - np.log(np.exp(logits).sum(axis=1))).astype(np.float32)
    return action, {"logp": logp, "logits": logits}


def _wait(cond, timeout_s=10.0):
    deadline = time.monotonic() + timeout_s
    while not cond() and time.monotonic() < deadline:
        time.sleep(0.02)
    return cond()


def _kill(fleet, slot):
    """Close one replica's server and wait for its serve thread to go."""
    fleet._replicas[slot].close()
    assert _wait(lambda: not fleet._replicas[slot].alive)


def _port_slabs():
    return glob.glob(f"/dev/shm/{SLAB_PREFIX}*_{os.getpid()}_*")


def test_routing_and_budgets_match_the_reference():
    """crc32 rendezvous routing: the scores, ``replica_of`` for 64 worker
    ids over every alive subset of 4 slots, and each replica's
    ``min_batch`` (its affinity share of 7 workers) equal the reference's."""
    assert all(_rendezvous_score(w, r) == jax_rendezvous_score(w, r) for w in range(64) for r in range(6))
    port = InferenceFleet(_act_fn, num_workers=7, replicas=4, unroll_length=4)
    ref = JaxFleet(_act_fn, num_workers=7, replicas=4, unroll_length=4)
    try:
        for srv in port._replicas + ref._replicas:
            srv.auto_tune = False  # the budgets as installed, not as the serve loops retune them
        for k in range(1, 5):
            for alive in itertools.combinations(range(4), k):
                port._alive_slots = ref._alive_slots = lambda alive=alive: list(alive)
                got = [port.replica_of(w) for w in range(64)]
                assert got == [ref.replica_of(w) for w in range(64)], alive
                assert set(got) <= set(alive)
                assert [port.address_for(w) for w in range(4)] == [port._addresses[r] for r in got[:4]]
                port._rebalance_budgets()
                ref._rebalance_budgets()
                budgets = [port._replicas[i].min_batch for i in alive]
                assert budgets == [ref._replicas[i].min_batch for i in alive], alive
                assert budgets == [max(1, got[:7].count(i)) for i in alive]
    finally:
        port.close()
        ref.close()


def _fleet_streams(fleet_cls, worker, env_cfg, n_workers, per_worker):
    """The first ``per_worker`` chunks of each of ``n_workers`` thread
    workers behind a 2-replica fleet, keyed by the lineage worker id."""
    fleet = fleet_cls(_act_fn, num_workers=n_workers, replicas=2, unroll_length=8)
    stop = threading.Event()
    threads = [
        threading.Thread(target=worker, args=(env_cfg, fleet.address_for(i), i),
                         kwargs=dict(stop_event=stop, transport="pickle"), daemon=True)
        for i in range(n_workers)
    ]
    streams: dict[int, list] = {}
    try:
        for t in threads:
            t.start()
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and (
            len(streams) < n_workers or min(len(v) for v in streams.values()) < per_worker
        ):
            chunk = fleet.chunks.get(timeout=30)
            chunk.pop("_t_ready")
            streams.setdefault(int(chunk["lineage"]["worker"][0, 0]), []).append(chunk)
        served_by = sorted(fleet.replica_of(i) for i in range(n_workers))
    finally:
        stop.set()
        fleet.close()
        for t in threads:
            t.join(timeout=10)
    return {w: c[:per_worker] for w, c in streams.items()}, served_by


def _assert_equal_trees(got, want, path=""):
    assert set(got) == set(want), path
    for k in want:
        if isinstance(want[k], dict):
            _assert_equal_trees(got[k], want[k], f"{path}/{k}")
        else:
            assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, f"{path}/{k}"
            np.testing.assert_array_equal(got[k], want[k], err_msg=f"{path}/{k}")


def test_chunk_streams_match_the_reference_fleet():
    """4 workers over 2 replicas: each worker's first two chunks, every
    key, bit for bit against the reference fleet's; both replicas serve."""
    want, ref_served = _fleet_streams(JaxFleet, jax_run_env_worker,
                                      JaxConfig(name="gym:CartPole-v1", num_envs=2).extend(JAX_BASE_ENV_CONFIG), 4, 2)
    got, served = _fleet_streams(InferenceFleet, run_env_worker,
                                 Config(name="gym:CartPole-v1", num_envs=2).extend(BASE_ENV_CONFIG), 4, 2)
    assert served == ref_served and set(served) == {0, 1}
    assert set(got) == set(want) and len(got) == 4
    for w in want:
        for g, c in zip(got[w], want[w]):
            _assert_equal_trees(g, c)
    assert next(iter(got.values()))[0]["obs"].shape == (8, 2, 4)


def test_fleet_affinity_routes_and_serves_chunks():
    """tests/test_fleet.py's first case on the port: per-replica budgets
    are the affinity shares, chunks flow through the shared queue, and
    ``set_act_fn`` reaches every replica."""
    fleet = InferenceFleet(_act_fn, num_workers=4, replicas=2, unroll_length=8)
    env_cfg = Config(name="gym:CartPole-v1", num_envs=2).extend(BASE_ENV_CONFIG)
    stop = threading.Event()
    workers = []
    try:
        assign = [fleet.replica_of(w) for w in range(4)]
        assert set(assign) == {0, 1}
        # the budgets installed: each replica's affinity share
        assert fleet._affinity_counts() == {i: assign.count(i) for i in (0, 1)}
        for i in range(4):
            w = threading.Thread(target=run_env_worker, args=(env_cfg, fleet.address_for(i), i),
                                 kwargs={"stop_event": stop, "max_steps": 600}, daemon=True)
            w.start()
            workers.append(w)
        assert fleet.chunks.get(timeout=30)["obs"].shape == (8, 2, 4)
        fleet.set_act_fn(_act_fn)
        assert fleet.version == 1 and all(s.version == 1 for s in fleet.servers())
        stats = fleet.queue_stats()
        assert stats["fleet/replicas_live"] == 2.0 and "server/queue_depth" in stats
        assert stats["server/param_version_min"] == stats["server/param_version_max"] == 1.0
        tier = fleet.tier_event()
        assert set(tier["replicas"]) == {"0", "1"} and tier["num_workers"] == 4
        assert all(r["state"] == "alive" and r["param_version"] == 1 for r in tier["replicas"].values())
    finally:
        stop.set()
        fleet.close()
        for w in workers:
            w.join(timeout=10)


def test_fleet_rendezvous_remap_only_moves_dead_replicas_workers():
    fleet = InferenceFleet(_act_fn, num_workers=16, replicas=3, unroll_length=4)
    try:
        before = {w: fleet.replica_of(w) for w in range(16)}
        victim = before[0]
        _kill(fleet, victim)
        after = {w: fleet.replica_of(w) for w in range(16)}
        for w in range(16):
            assert (after[w] != victim) if before[w] == victim else (after[w] == before[w])
    finally:
        fleet.close()


def test_fleet_supervise_respawns_dead_replica_with_backoff():
    """In place (same address), at the fleet's version, under the backoff:
    a second death within the backoff waits it out."""
    fleet = InferenceFleet(_act_fn, num_workers=2, replicas=2, unroll_length=4,
                           respawn_backoff_s=0.05, respawn_backoff_cap_s=0.2)
    try:
        fleet.set_act_fn(_act_fn)  # version 1
        addr = fleet._addresses[0]
        _kill(fleet, 0)
        assert fleet.replica_of(0) == 1 == fleet.replica_of(1)  # routed to the survivor
        fleet.supervise()
        assert fleet.respawns == 1 and fleet.respawn_backoff_s == pytest.approx(0.05)
        srv = fleet._replicas[0]
        assert srv.alive and srv.version == fleet.version == 1
        assert fleet._addresses[0] == addr == srv.address
        _kill(fleet, 0)
        fleet.supervise()  # inside the 0.05 s backoff: not yet
        assert fleet.respawns == 1 and not fleet._replicas[0].alive
        time.sleep(0.06)
        fleet.supervise()
        assert fleet.respawns == 2 and fleet.respawn_backoff_s == pytest.approx(0.1)
        assert fleet.fleet_gauges()["fleet/replicas_live"] == 2.0
    finally:
        fleet.close()


def test_fleet_autoscale_up_down_bounded_by_cooldown_and_limits():
    fleet = InferenceFleet(_act_fn, num_workers=4, replicas=1, unroll_length=4, autoscale=True,
                           min_replicas=1, max_replicas=2, scale_up_serve_ms=10.0, scale_down_serve_ms=1.0,
                           scale_cooldown_s=0.0)
    try:
        assert fleet.maybe_autoscale() is None  # no serve samples yet
        fleet.servers()[0]._serve_ms_ewma = 50.0
        assert fleet.maybe_autoscale() == "up" and len(fleet._alive_slots()) == 2
        for s in fleet.servers():
            s._serve_ms_ewma = 50.0
        assert fleet.maybe_autoscale() is None  # at max_replicas
        for s in fleet.servers():
            s._serve_ms_ewma = 0.5
        assert fleet.maybe_autoscale() == "down" and len(fleet._alive_slots()) == 1
        assert fleet.tier_event()["replicas"][str(fleet._replicas.index(None))] == {"state": "drained"}
        fleet.servers()[0]._serve_ms_ewma = 0.5
        assert fleet.maybe_autoscale() is None  # at min_replicas
        assert fleet.scale_ups == 1 and fleet.scale_downs == 1
        # a scale-up re-arms the drained slot at its address
        drained = fleet._replicas.index(None)
        assert fleet.scale_up() == drained and len(fleet._replicas) == 2
        fleet.scale_cooldown_s = 60.0
        fleet._last_scale_at = time.monotonic()
        for s in fleet.servers():
            s._serve_ms_ewma = 0.5
        assert fleet.maybe_autoscale() is None  # the cooldown spaces decisions
    finally:
        fleet.close()


class _SlotFn:
    """An act function with per-slot callables: slot i's actions are
    offset by 10 * i, and each call is recorded with its slot."""

    def __init__(self, calls, offset=0):
        self.calls, self.offset = calls, offset

    def for_slot(self, i):
        def act(obs):
            self.calls.append(i)
            a, info = _act_fn(obs)
            return a + 10 * i + self.offset, info

        return act


def test_serve_act_pinned_evicted_and_dead_slot():
    calls = []
    fleet = InferenceFleet(_SlotFn(calls), num_workers=2, replicas=2, unroll_length=4, act_history=2)
    obs = np.ones((3, 4), np.float32)
    try:
        a, v = fleet.serve_act(obs, replica=1)
        assert v == 0 and list(a) == [11, 11, 11] and calls == [1]
        fleet.set_act_fn(_SlotFn(calls, offset=100))
        fleet.set_act_fn(_SlotFn(calls, offset=200))
        assert fleet.held_versions() == [1, 2]
        a, v = fleet.serve_act(obs, replica=0, version=1)  # pinned: the held version's slot-0 callable
        assert v == 1 and list(a) == [101] * 3
        a, v = fleet.serve_act(obs, replica=0)
        assert v == 2 and list(a) == [201] * 3
        with pytest.raises(KeyError, match="evicted"):
            fleet.serve_act(obs, replica=0, version=0)
        _kill(fleet, 1)
        with pytest.raises(LookupError, match="not alive"):
            fleet.serve_act(obs, replica=1)
        with pytest.raises(LookupError):
            fleet.serve_act(obs, replica=7)
    finally:
        fleet.close()


def test_two_slots_acting_at_once_equal_serial():
    """The SEED trainer's per-slot act functions: two slots acting at once
    on different states (slot 1 on an older policy, as a pinned serve
    would) return what the same requests return served one after
    another; the slots hold distinct acting copies."""
    cfg = _seed_cfg("unused", 8, num_env_workers=2, inference_fleet=dict(replicas=2))
    trainer = SEEDTrainer(cfg, device="cpu")
    slots = trainer._slot_acts()
    assert len(slots._slots) == 4 and len({id(actor.model) for actor, _ in slots._slots}) == 4
    states = [trainer.learner.init(torch.Generator().manual_seed(s)) for s in (0, 1)]
    rng = np.random.default_rng(0)
    batches = [rng.normal(size=(16, 4)).astype(np.float32) for _ in range(30)]

    def run(slot, out):
        fn = slots.at(states[slot]).for_slot(slot)
        out.extend(fn(b) for b in batches)

    def reseed():
        for i, (_, g) in enumerate(slots._slots[:2]):
            g.manual_seed(100 + i)

    reseed()
    serial = [[], []]
    for slot in (0, 1):
        run(slot, serial[slot])
    reseed()
    concurrent = [[], []]
    threads = [threading.Thread(target=run, args=(slot, concurrent[slot])) for slot in (0, 1)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    for slot in (0, 1):
        for (a, info), (b, want) in zip(concurrent[slot], serial[slot]):
            np.testing.assert_array_equal(a, b)
            for k in want:
                np.testing.assert_array_equal(info[k], want[k])
    # the two policies differ, so a shared module would have shown
    assert not all(np.array_equal(x[1]["logits"], y[1]["logits"]) for x, y in zip(serial[0], serial[1]))


def _seed_tree(folder, total, faults_plan=None, **topology) -> dict:
    return dict(
        learner_config=dict(algo=dict(name="impala", horizon=8)),
        env_config=dict(name="gym:CartPole-v1", num_envs=4),
        session_config=dict(
            folder=str(folder), total_env_steps=total,
            metrics=dict(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=dict(every_n_iters=0), eval=dict(every_n_iters=0),
            topology=dict(worker_silence_s=2.0, respawn_backoff_s=0.05, **topology),
            faults=dict(plan=faults_plan or []),
        ),
    )


def _seed_cfg(folder, total, faults_plan=None, **topology):
    return Config(_seed_tree(folder, total, faults_plan, **topology)).extend(base_config())


KILL_REPLICA = {"site": "fleet.replica", "kind": "kill_replica", "at": 40}
# at least 80 ms an iteration (44 learns), so the run outlasts the killed replica's
# worker's 2 s silence budget on any machine: unpaced, a fast machine
# finishes the budget on the surviving worker before the orphan times out
PACING = {"site": "trainer.iteration", "kind": "delay", "ms": 80, "times": 10**6}


def _kill_replica_tree(folder, paced: bool = True) -> dict:
    """tests/test_fleet.py::test_fleet_kill_replica_chaos_workers_rehello_to_survivor's
    session: IMPALA, CartPole, 2 workers, 2 replicas, 700 env steps (44
    learns), a replica killed at the 41st serve-loop turn of the two."""
    return _seed_tree(folder, 700, [KILL_REPLICA, PACING] if paced else [KILL_REPLICA],
                      num_env_workers=2, inference_fleet=dict(replicas=2, respawn_backoff_s=0.05))


def _events(folder):
    with open(os.path.join(str(folder), "telemetry", "events.jsonl")) as f:
        return [json.loads(line) for line in f if line.strip()]


def test_fleet_kill_replica_chaos_workers_rehello_to_survivor(tmp_path):
    """The reference's chaos case on the port: the killed replica's workers
    time out and are respawned against a survivor, the replica respawns
    in place, the budget completes, 2 replicas live at the end."""
    assert not _port_slabs()
    _, metrics = SEEDTrainer(Config(_kill_replica_tree(tmp_path)).extend(base_config()), device="cpu").run()
    assert metrics["time/env_steps"] >= 700
    assert metrics["fleet/respawns"] >= 1.0 and metrics["fleet/replicas_live"] == 2.0
    assert metrics["workers/respawns"] >= 1.0
    assert not _port_slabs()
    events = _events(tmp_path)
    assert any(e.get("site") == "fleet.replica" for e in events if e["type"] == "fault")
    tiers = [e for e in events if e["type"] == "serving_tier"]
    assert tiers and all(r["state"] == "alive" for r in tiers[-1]["replicas"].values())


@pytest.mark.slow
def test_kill_replica_mirror_matches_the_reference_without_remediation(tmp_path):
    """The mirror against the reference run with its remediation off, both
    on the reference's own session (unpaced): the same gauges at the end
    (2 replicas live, a replica respawn, no scale-up, the budget reached).
    Whether the killed replica's worker died and was respawned depends on
    timing in both, so it is not compared: the reference's zmq DEALER
    reconnects to the respawned replica, whose worker then may never time
    out; the port's worker always times out, but the run may end first."""
    from surreal_tpu.launch.seed_trainer import SEEDTrainer as JaxSEEDTrainer
    from surreal_tpu.session.default_configs import base_config as jax_base_config
    from surreal_tpu.utils import faults as jax_faults

    ref = _kill_replica_tree(tmp_path / "ref", paced=False)
    ref["session_config"]["remediate"] = dict(enabled=False)
    try:
        _, want = JaxSEEDTrainer(JaxConfig(ref).extend(jax_base_config())).run()
    finally:
        jax_faults.configure(None)
    port = _kill_replica_tree(tmp_path / "port", paced=False)
    _, got = SEEDTrainer(Config(port).extend(base_config()), device="cpu").run()
    for name, m in (("reference", want), ("port", got)):
        gauges = {k: m[k] for k in ("fleet/replicas_live", "fleet/scale_ups", "fleet/respawns", "workers/respawns",
                                    "time/env_steps")}
        assert m["fleet/replicas_live"] == 2.0 and m["fleet/scale_ups"] == 0.0, (name, gauges)
        assert m["fleet/respawns"] >= 1.0, (name, gauges)
        assert m["time/env_steps"] >= 700, (name, gauges)


def test_seed_trainer_autoscales_the_fleet(tmp_path):
    """``inference_fleet.autoscale`` through ``SEEDTrainer``: a threshold
    every serve passes scales the fleet up within the run; each metrics
    row carries the ``fleet/*`` gauges and a ``serving_tier`` event."""
    cfg = _seed_cfg(tmp_path, 320, num_env_workers=2, inference_fleet=dict(
        replicas=1, autoscale=True, max_replicas=2, scale_up_serve_ms=0.0, scale_down_serve_ms=0.0,
        scale_cooldown_s=0.0))
    _, metrics = SEEDTrainer(cfg, device="cpu").run()
    assert metrics["fleet/scale_ups"] == 1.0 and metrics["fleet/replicas_live"] == 2.0
    assert metrics["time/env_steps"] >= 320
    tiers = [e for e in _events(tmp_path) if e["type"] == "serving_tier"]
    assert tiers and tiers[-1]["autoscale"] is True and len(tiers[-1]["replicas"]) == 2


def test_fleet_lifecycle_fds_steady_over_kill_respawn_cycles():
    fd_counts = []
    for _ in range(3):
        fleet = InferenceFleet(_act_fn, num_workers=2, replicas=2, unroll_length=4, respawn_backoff_s=0.01)
        _kill(fleet, 0)
        fleet.supervise()
        assert fleet.respawns == 1
        fleet.close()
        fd_counts.append(len(os.listdir("/proc/self/fd")))
    assert fd_counts[2] <= fd_counts[0] + 2, fd_counts


def test_fleet_kill_replica_releases_shm_slabs():
    """Workers on slabs, a replica killed by the injection and respawned:
    no slab of this process left after the cycle or after close."""
    assert not _port_slabs()
    faults.configure([{"site": "fleet.replica", "kind": "kill_replica", "at": 30}])
    fleet = InferenceFleet(_act_fn, num_workers=2, replicas=2, unroll_length=4, transport="auto",
                           respawn_backoff_s=0.05)
    env_cfg = Config(name="gym:CartPole-v1", num_envs=2).extend(BASE_ENV_CONFIG)
    stop = threading.Event()
    workers = []
    try:
        for i in range(2):
            w = threading.Thread(target=run_env_worker, args=(env_cfg, fleet.address_for(i), i),
                                 kwargs={"stop_event": stop, "max_steps": 4000, "transport": "shm",
                                         "server_silence_s": 3.0}, daemon=True)
            w.start()
            workers.append(w)
        assert _wait(lambda: bool(_port_slabs()), 30), "shm never negotiated"
        assert _wait(lambda: len(fleet._alive_slots()) == 1, 30), "kill_replica never fired"
        time.sleep(0.1)
        fleet.supervise()
        assert len(fleet._alive_slots()) == 2 and fleet.respawns == 1
    finally:
        stop.set()
        for w in workers:
            w.join(timeout=10)
        fleet.close()
    assert not _port_slabs(), "fleet close leaked shm"
