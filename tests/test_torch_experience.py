"""The port's sharded experience plane (``surreal_tpu_torch/experience/``)
against the reference (``surreal_tpu/experience/``) and against the port's
own in-process replay, on the CPU.

Contracts held here:

- the wire: every frame the port encodes is byte-equal to the
  reference's for the same inputs (a SAMPLE frame's 8 bytes a drawn set
  carry a uint64 seed in the port and a JAX key's data in the reference,
  so the frames are compared for the same key bytes), bfloat16 fields
  included; ``decode_payload`` reads the reference's frames;
- ``shard_of_slot`` equals the reference's;
- a shard with the reference's draws injected: uniform rows bit-equal to
  the reference shard's; prioritized rows the same, or a neighbouring
  slot where the draw lies within 8 ulps of a cdf boundary, IS weights
  within 1e-5 (the in-process prioritized replay's rule);
- a one-shard remote uniform sample is BIT-EQUAL to the port's in-process
  ``UniformReplay.sample`` on a CPU ring with a generator seeded as the
  shard's, over shm, tcp and pickle;
- strict remote training (``overlap_rollouts=false``) is the same from
  run to run; the exactly-once row accounting adds up under
  ``corrupt_wire_frame`` and ``drop_frame``; shard kills respawn with no
  /dev/shm residue and a steady fd count.
"""

import glob
import json
import os
import signal
import time

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from surreal_tpu.experience import shard as ref_shard
from surreal_tpu.experience import wire as ref_wire
from surreal_tpu.experience.sender import shard_of_slot as ref_shard_of_slot
from surreal_tpu_torch.distributed import sockets
from surreal_tpu_torch.experience import shard, wire
from surreal_tpu_torch.experience.plane import ExperiencePlane
from surreal_tpu_torch.experience.sampler import fold_seed, partition_shards
from surreal_tpu_torch.experience.sender import shard_of_slot
from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer
from surreal_tpu_torch.launch.seed_trainer import SEEDTrainer
from surreal_tpu_torch.replay.prioritized import PrioritizedReplay
from surreal_tpu_torch.replay.uniform import UniformReplay
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.session.telemetry import _iter_jsonl, diag_report
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.net import alloc_address

BOUNDARY_ULPS = 8   # a prioritized draw this close to a cdf boundary may pick the neighbouring slot
WEIGHT_TOL = 1e-5   # IS weights of the same slot


def _slabs(pids=None):
    """This process's plane slabs in /dev/shm (a slab's name carries the
    pid of the shard that made it: this process's for thread shards, or
    ``pids``), not those of tests running beside this one."""
    return [f for pid in (pids or [os.getpid()]) for f in glob.glob(f"/dev/shm/surreal_pt_xp_*_{pid}_*")]


def _example():
    return {
        "obs": np.zeros((3,), np.float32),
        "action": np.zeros((2,), np.float32),
        "reward": np.zeros((), np.float32),
    }


def _rows(rng, n=12):
    return {
        "obs": rng.normal(size=(n, 3)).astype(np.float32),
        "action": rng.normal(size=(n, 2)).astype(np.float32),
        "reward": rng.normal(size=(n,)).astype(np.float32),
    }


def _make_plane(transport="tcp", kind="uniform", shards=1, **over):
    cfg = {
        "num_shards": shards, "shard_mode": "thread", "transport": transport, "ack_timeout_s": 1.0,
        "sample_timeout_s": 2.0, "watermark_timeout_s": 1.0, "respawn_backoff_s": 0.05,
        "respawn_backoff_cap_s": 0.5,
    }
    cfg.update(over)
    return ExperiencePlane(
        kind=kind, example=_example(), capacity=64 * shards, batch_size=8 * shards, updates_per_iter=2, num_slots=4, max_insert_rows=16, cfg=cfg, base_seed=7, prefetch=False,
    )


def _torch_rows(rows):
    return {k: torch.from_numpy(v) for k, v in rows.items()}


# -- the wire ----------------------------------------------------------------

def _specs():
    """The same spec in both packages: a bf16 obs (the 'bf16' policy's
    replay example), a nested dict, a bool."""
    ref = ref_wire.PlaneSpec.from_example({
        "obs": np.zeros((3,), ml_dtypes.bfloat16), "behavior": {"mean": np.zeros((2,), np.float32)},
        "done": np.zeros((), bool),
    })
    port = wire.PlaneSpec.from_example({
        "obs": torch.zeros(3, dtype=torch.bfloat16), "behavior": {"mean": torch.zeros(2)},
        "done": torch.zeros((), dtype=torch.bool),
    })
    return ref, port


def test_plane_spec_matches_the_reference_and_round_trips():
    ref, port = _specs()
    assert port.names() == ref.names() == ["behavior/mean", "done", "obs"]
    assert port.to_json() == ref.to_json() and port.row_nbytes == ref.row_nbytes
    assert port.bf16 == {"obs"} and wire.PlaneSpec.from_json(ref.to_json()).matches(port)
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(5, 3)).astype(ml_dtypes.bfloat16)
    batch = {"behavior/mean": rng.normal(size=(5, 2)).astype(np.float32), "done": rng.random(5) > 0.5}
    body = port.pack({**batch, "obs": obs.view(np.uint16)}, 5)
    assert body == ref.pack({**batch, "obs": obs}, 5)
    out = port.unpack(body, 5)
    np.testing.assert_array_equal(out["obs"], obs.view(np.uint16))
    for k in batch:
        np.testing.assert_array_equal(out[k], batch[k])
    assert set(wire.unflatten_fields(batch)["behavior"]) == {"mean"}
    with pytest.raises(ValueError, match="bfloat16"):
        port.pack({**batch, "obs": obs.astype(np.float32)}, 5)


def _frames(W, spec, slab):
    """Every frame kind, encoded by the package ``W`` from the same inputs
    (SAMPLE's 8 key bytes a set given, so equal in both)."""
    idx, prio = np.arange(4, dtype=np.uint32), np.linspace(0.5, 2.0, 4).astype(np.float32)
    rows = {"behavior/mean": np.ones((2, 2), np.float32), "done": np.array([True, False]),
            "obs": np.arange(6, dtype=np.uint16).reshape(2, 3)}
    rows_w = dict(rows, obs=rows["obs"].view(ml_dtypes.bfloat16)) if W is ref_wire else rows
    return {
        "hello": W.encode_hello("sender", spec, 16, 4, "shm", trace="t1", token="abcd", seq_base=9,
                                caps=("lineage",)),
        "hello_ok_shm": W.encode_hello_reply("shm", name="seg", slab=slab, ingested_rows=5, token="abcd"),
        "hello_ok_tcp": W.encode_hello_reply("tcp", ingested_rows=5, token="abcd"),
        "hello_no": W.encode_hello_reply(None, reason="busy", token="abcd"),
        "insert": W.encode_insert(3, 2, 1, t_send=1.25, body=spec.pack(rows_w, 2)),
        "insert_ok": W.encode_insert_ok(3, 99),
        "sample": W.encode_sample(5, 8, 40, 0.5, 2, bytes(range(16)), nkeys=2, t_send=2.5),
        "sample_ok": W.encode_sample_ok(5, 2, 1, 0, W.F_HAS_WEIGHTS, W.pack_sample_body(
            spec, [(idx[:2], prio[:2], rows_w)])),
        "prio": W.encode_prio(1, idx, prio, t_send=3.0),
        "stats": W.encode_stats(7),
        "stats_ok": W.encode_stats_reply(7, {"shard": 0, "fill": 0.5}),
        "pop": W.encode_pop(4, slot=1, t_send=4.0),
        "pop_ok": W.encode_pop_reply(4, 2, spec, spec.pack(rows_w, 2)),
        "pop_empty": W.encode_pop_reply(4, 0, None),
    }


FRAME_KINDS = ["hello", "hello_ok_shm", "hello_ok_tcp", "hello_no", "insert", "insert_ok", "sample", "sample_ok",
               "prio", "stats", "stats_ok", "pop", "pop_ok", "pop_empty"]


@pytest.mark.parametrize("kind", FRAME_KINDS)
def test_frames_byte_equal_to_the_reference(kind):
    ref, port = _specs()
    ref_frame = _frames(ref_wire, ref, ref_wire.PlaneSlab(ref, 16, 4, extras=ref_wire.SAMPLE_EXTRAS))[kind]
    port_frame = _frames(wire, port, wire.PlaneSlab(port, 16, 4, extras=wire.SAMPLE_EXTRAS))[kind]
    assert port_frame == ref_frame
    got_kind, got = wire.decode_payload(ref_frame)
    want_kind, want = ref_wire.decode_payload(ref_frame)
    assert got_kind == want_kind
    for k, v in want.items():
        g = got[k]
        if isinstance(v, ref_wire.PlaneSpec):
            # the reference reads its own bf16 "<V2" back as a plain 2-byte
            # void (which re-encodes as "|V2"); the port keeps it bf16
            assert [(n, s, d.itemsize) for n, s, d in g.fields] == [(n, s, d.itemsize) for n, s, d in v.fields]
            assert g.bf16 == {"obs"} and g.to_json() == ref.to_json()
        elif isinstance(v, (memoryview, np.ndarray)):
            assert bytes(g) == bytes(v), k
        else:
            assert g == v, k


def test_slab_layout_matches_the_reference():
    ref, port = _specs()
    r = ref_wire.PlaneSlab(ref, 16, 4, extras=ref_wire.SAMPLE_EXTRAS)
    p = wire.PlaneSlab(port, 16, 4, extras=wire.SAMPLE_EXTRAS)
    assert p.nbytes == r.nbytes and json.dumps(p.to_json()) == json.dumps(r.to_json())
    assert [{k: v[0] for k, v in f.items()} for f in p._layout] == [{k: v[0] for k, v in f.items()} for f in r._layout]
    # the pickle fallback routes through the same decoder
    kind, obj = wire.decode_payload(wire.encode_pickle_msg({"kind": "insert", "seq": 1}))
    assert kind == "msg" and obj["kind"] == "insert"


def test_shard_of_slot_equals_the_reference():
    for S in range(1, 9):
        assert [shard_of_slot(i, S) for i in range(256)] == [ref_shard_of_slot(i, S) for i in range(256)]
    # the first num_shards slots never collapse onto one shard
    for S in (2, 4):
        assert len({shard_of_slot(i, S) for i in range(S * 2)}) == S


def test_partition_shards_equals_the_reference():
    from surreal_tpu.experience.sampler import partition_shards as ref_partition

    for S in range(1, 9):
        for members in range(1, S + 1):
            assert partition_shards(S, members) == ref_partition(S, members)
    for bad in ((2, 0), (2, 3)):
        with pytest.raises(ValueError, match="members"):
            partition_shards(*bad)


def test_transport_resolution_matches_the_reference():
    for mode in ("auto", "shm", "tcp", "pickle"):
        for addr in ("tcp://127.0.0.1:5555", "tcp://10.0.0.2:5555"):
            assert wire.resolve_transport(mode, addr) == ref_wire.resolve_transport(mode, addr)
    with pytest.raises(ValueError, match="transport"):
        wire.resolve_transport("udp", "tcp://127.0.0.1:1")


# -- the shard's rows with the reference's draws -----------------------------

def _ring_pair(kind, capacity=32, inserts=3, n=12):
    ref_spec = ref_wire.PlaneSpec.from_example(_example())
    port_spec = wire.PlaneSpec.from_example(_example())
    if kind == "uniform":
        ref, port = ref_shard.HostRing(ref_spec, capacity), shard.HostRing(port_spec, capacity)
    else:
        ref = ref_shard.HostPrioritized(ref_spec, capacity)
        port = shard.HostPrioritized(port_spec, capacity)
    rng = np.random.default_rng(1)
    for _ in range(inserts):
        rows = _rows(rng, n)
        ref.insert(rows, n)
        port.insert(rows, n)
    return ref, port


def test_shard_uniform_rows_bit_equal_to_the_reference_with_its_draws():
    ref, port = _ring_pair("uniform")
    keys = jax.random.split(jax.random.key(3), 3)
    draws = np.asarray(jax.vmap(lambda k: jax.random.randint(k, (8,), 0, max(ref.size, 1)))(keys))
    want = ref.sample_many(keys, 8)
    got = port.sample_many([0, 0, 0], 8, draws=draws)
    for (gi, grows, gw), (wi, wrows, ww) in zip(got, want):
        np.testing.assert_array_equal(gi, wi)
        assert gw is None and ww is None
        for k in wrows:
            np.testing.assert_array_equal(grows[k], wrows[k])


def test_shard_prioritized_rows_within_tolerance_of_the_reference():
    ref, port = _ring_pair("prioritized")
    td = np.abs(np.random.default_rng(2).normal(size=8)).astype(np.float32)
    for ring in (ref, port):
        ring.update_priorities(np.arange(3, 11), td)
    np.testing.assert_array_equal(port.priorities, ref.priorities)
    keys = jax.random.split(jax.random.key(4), 2)
    uniforms = np.asarray(jax.vmap(lambda k: jax.random.uniform(k, (8,)))(keys), np.float32)
    want = ref.sample_many(keys, 8, beta=0.5)
    got = port.sample_many([0, 0], 8, beta=0.5, draws=uniforms)
    p = port.priorities ** port.alpha
    cdf = np.cumsum(p, dtype=np.float32)
    total = p.sum(dtype=np.float32)
    for u_row, (gi, grows, gw), (wi, wrows, ww) in zip(uniforms, got, want):
        u = (np.arange(8, dtype=np.float32) + u_row) / np.float32(8) * total
        for i in np.flatnonzero(gi != wi):
            assert abs(int(gi[i]) - int(wi[i])) == 1
            boundary = cdf[min(gi[i], wi[i])]
            assert abs(u[i] - boundary) <= BOUNDARY_ULPS * np.spacing(u[i])
        same = gi == wi
        np.testing.assert_allclose(gw[same], ww[same], rtol=0, atol=WEIGHT_TOL)
        for k in wrows:
            np.testing.assert_array_equal(grows[k][same], wrows[k][same])


def test_shard_seed_draws_are_the_in_process_draws():
    """A shard's own draw from a seed is the port's in-process draw from a
    CPU generator seeded the same way (uniform indices, prioritized
    uniforms)."""
    _, port = _ring_pair("uniform")
    rep = UniformReplay(Config(kind="uniform", capacity=32, batch_size=8, start_sample_size=1))
    state = rep.init({k: torch.from_numpy(v) for k, v in _example().items()})
    state = state._replace(size=port.size)
    for seed in (0, 5, 2**63 + 11):
        _, _, info = rep.sample(state, torch.Generator().manual_seed(seed))
        np.testing.assert_array_equal(port.draw_indices(seed, 8), info["idx"].numpy())
    assert shard.seeds_from_bytes(np.asarray([1, 2**64 - 1], "<u8").tobytes(), 2) == [1, 2**64 - 1]
    assert fold_seed(1, 0) != fold_seed(1, 1) and 0 <= fold_seed(2**64 - 1, 7) < 2**64


# -- the plane against the in-process replay ---------------------------------

@pytest.mark.parametrize("transport", ["shm", "tcp", "pickle"])
def test_remote_uniform_bit_equal_in_process(transport):
    """One-shard remote plane == the port's in-process UniformReplay, bit
    for bit, for the same insert stream and seeds."""
    plane = _make_plane(transport=transport)
    try:
        rep = UniformReplay(Config(kind="uniform", capacity=64, batch_size=8, start_sample_size=1))
        state = rep.init(_torch_rows(_example()))
        rng = np.random.default_rng(0)
        for _ in range(3):
            rows = _rows(rng)
            wm = plane.sender.send_rows(rows, np.arange(12) % 4)
            state = rep.insert(state, _torch_rows(rows))
        for seed in (42, 43):
            batch, info = plane.sampler.fetch_batch(seed, 0.0, wm)
            _, ref_batch, ref_info = rep.sample(state, torch.Generator().manual_seed(seed))
            np.testing.assert_array_equal(ref_info["idx"].numpy(), info["shard_idx"][0])
            for k in ref_batch:
                np.testing.assert_array_equal(ref_batch[k].numpy(), batch[k])
        assert plane.sender.links[0].transport == transport
    finally:
        plane.close()


def test_remote_prioritized_matches_in_process():
    """Prioritized arm: the same stratified draws (a neighbouring slot only
    at a cdf boundary), IS weights within 1e-5, and the shard's priorities
    after wire-shipped BATCHED updates equal the in-process ones; one PRIO
    frame a refresh."""
    plane = _make_plane(transport="shm", kind="prioritized")
    try:
        rep = PrioritizedReplay(Config(kind="prioritized", capacity=64, batch_size=8, start_sample_size=1,
                                       priority_alpha=0.6, priority_beta0=0.4, priority_eps=1e-6))
        state = rep.init(_torch_rows(_example()))
        rng = np.random.default_rng(0)
        match = 0
        for it in range(3):
            rows = _rows(rng)
            wm = plane.sender.send_rows(rows, np.arange(12) % 4)
            state = rep.insert(state, _torch_rows(rows))
            batch, info = plane.sampler.fetch_batch(100 + it, 0.5, wm)
            _, _, ri = rep.sample(state, torch.Generator().manual_seed(100 + it), beta=0.5)
            same = ri["idx"].numpy() == info["shard_idx"][0]
            match += int(same.all())
            assert np.all(np.abs(ri["idx"].numpy()[~same] - info["shard_idx"][0][~same]) == 1)
            np.testing.assert_allclose(ri["is_weights"].numpy()[same], batch["is_weights"][same], rtol=0,
                                       atol=WEIGHT_TOL)
            td = np.abs(rng.normal(size=(8,)).astype(np.float32))
            plane.sampler.update_priorities([info], [td])
            state = rep.update_priorities(state, ri["idx"], torch.from_numpy(td))
        assert match >= 2
        assert plane.sampler.prio_frames == 3
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            plane._poll_stats()
            if plane._stats_cache[0].get("prio_updates", 0) >= 24:
                break
            time.sleep(0.05)
        st = plane._stats_cache[0]
        assert st["prio_updates"] == 24  # 3 batched frames x 8 pairs
        assert np.isclose(st["max_priority"], float(state.max_priority), rtol=1e-6)
    finally:
        plane.close()


def test_sender_hash_routing_and_watermarks():
    plane = _make_plane(transport="tcp", shards=2)
    try:
        rows = _rows(np.random.default_rng(1), n=16)
        slots = np.arange(16) % 4
        wm = plane.sender.send_rows(rows, slots)
        expect = [0, 0]
        for s in slots:
            expect[shard_of_slot(int(s), 2)] += 1
        assert wm == expect and all(w > 0 for w in wm)
        plane._poll_stats()
        assert [int(plane._stats_cache[i]["ingested_rows"]) for i in (0, 1)] == expect
        # fan-in geometry: 2 updates x (8 + 8) rows, shard-major
        plane.sampler.request_iteration(wm, 0.0)
        staged = plane.sampler.get_iteration()
        assert len(staged) == 2
        batch, seed, info = staged[0]
        assert batch["obs"].shape == (16, 3) and isinstance(seed, int)
        assert set(info["shard_idx"]) == {0, 1} and all(len(v) == 8 for v in info["shard_idx"].values())
        # the watermark defers a sample the shard cannot serve yet, until
        # the deferral times out (counted)
        t0 = time.monotonic()
        plane.sampler.fetch_batch(5, 0.0, [w + 100 for w in wm])
        assert time.monotonic() - t0 >= 0.9
        plane._poll_stats()
        assert sum(s["watermark_timeouts"] for s in plane._stats_cache) == 2
    finally:
        plane.close()


def test_shm_slabs_unlink_on_close_and_no_fd_leak():
    fd_counts = []
    for cycle in range(3):
        plane = _make_plane(transport="shm", shards=2)
        plane.sender.send_rows(_rows(np.random.default_rng(2)), np.arange(12) % 4)
        plane.sampler.fetch_batch(1, 0.0, plane.sender.watermarks())
        if cycle == 0:
            assert _slabs(), "the shm arm should have negotiated slabs"
        plane.close()
        fd_counts.append(len(os.listdir("/proc/self/fd")))
    assert not _slabs(), "client-owned unlink leaked"
    assert fd_counts[2] <= fd_counts[0] + 2, fd_counts


# -- faults and accounting -----------------------------------------------------

@pytest.mark.parametrize("kind", ["corrupt_wire_frame", "drop_frame"])
def test_lost_insert_frame_counted_and_redelivered_exactly_once(kind):
    """A corrupted INSERT is counted and dropped by the shard (a dropped one
    never arrives); the sender's stale-frame resend redelivers it: no row
    lost, none ingested twice, and the accounting adds up."""
    faults.configure([{"site": "experience.send", "kind": kind, "at": 1}])
    try:
        plane = _make_plane(transport="tcp")
        try:
            rng = np.random.default_rng(3)
            plane.sender.send_rows(_rows(rng), np.arange(12) % 4)
            assert plane.sender.send_rows(_rows(rng), np.arange(12) % 4) == [24]
            time.sleep(1.1)  # past the ack budget: the next send resends the lost frame
            assert plane.sender.send_rows(_rows(rng), np.arange(12) % 4) == [36]
            deadline = time.monotonic() + 4.0
            while time.monotonic() < deadline:
                plane.sender._pump(plane.sender.links[0], 20)
                plane._poll_stats()
                if plane._stats_cache[0].get("ingested_rows") == 36 and not plane.sender.inflight_rows():
                    break
            st = plane._stats_cache[0]
            assert st["ingested_rows"] == 36, st
            assert st["decode_errors"] == (1 if kind == "corrupt_wire_frame" else 0)
            assert plane.sender.resends >= 1
            acc = plane.accounting()
            assert acc["sent_rows"] == acc["ingested_rows"] + acc["dropped_rows"] + acc["inflight_rows"] == 36
            assert acc["rehellos"] == 0 and acc["dropped_rows"] == 0
            assert any(f["site"] == "experience.send" for f in faults.drain_fired())
        finally:
            plane.close()
    finally:
        faults.configure(None)


def test_delay_sample_fault_is_absorbed():
    faults.configure([{"site": "experience.sample", "kind": "delay_sample", "at": 0, "ms": 200}])
    try:
        plane = _make_plane(transport="tcp")
        try:
            wm = plane.sender.send_rows(_rows(np.random.default_rng(4)), np.arange(12) % 4)
            batch, _info = plane.sampler.fetch_batch(0, 0.0, wm)
            assert batch["obs"].shape == (8, 3)
            assert any(f["site"] == "experience.sample" for f in faults.drain_fired())
        finally:
            plane.close()
    finally:
        faults.configure(None)


def test_refetch_outlives_a_survivor_that_dies_in_turn():
    """Shard 1 is down; shard 0 serves its own share, then fails the
    refetch of shard 1's share once (it died in its turn) and answers the
    next ask: the fetch waits for it instead of raising, and the
    refetched share is sourced from shard 0."""
    plane = _make_plane(transport="tcp", shards=2)
    try:
        sampler = plane.sampler
        wm = plane.sender.send_rows(_rows(np.random.default_rng(6)), np.arange(12) % 4)
        sampler.links[1].schedule_backoff(600.0, 600.0)  # down, and not due for revival in this test
        real, asks = sampler._fetch_shard, []

        def survivor_dies_once(link, *a):
            asks.append(link.shard_id)
            return None if len(asks) == 1 else real(link, *a)

        sampler._fetch_shard = survivor_dies_once
        batch, info = sampler.fetch_batch(0, 0.0, [wm[0], 0])
        assert batch["obs"].shape == (16, 3)
        assert info["shard_src"] == {0: 0, 1: 0} and sampler.refetches == 1
        assert asks == [0, 1, 0]
    finally:
        plane.close()


def test_killed_thread_shard_respawns_and_clients_renegotiate():
    """A kill_shard fault ends a thread shard; the supervisor respawns it at
    the same address and the sender's and sampler's DEALERs reconnect and
    re-negotiate in place (shm), with no /dev/shm residue."""
    faults.configure([{"site": "experience.shard", "kind": "kill_shard", "at": 30}])
    try:
        plane = _make_plane(transport="shm", shards=2)
        try:
            rng = np.random.default_rng(5)
            deadline = time.monotonic() + 10
            while plane.respawns == 0 and time.monotonic() < deadline:
                plane.sender.send_rows(_rows(rng), np.arange(12) % 4)
                plane.supervise()
                time.sleep(0.05)
            assert plane.respawns >= 1
            for _ in range(3):
                wm = plane.sender.send_rows(_rows(rng), np.arange(12) % 4)
            batch, _ = plane.sampler.fetch_batch(1, 0.0, wm)
            assert batch["obs"].shape == (16, 3)
            assert plane.gauges()["experience/shards_live"] == 2.0
            assert all(link.transport == "shm" for link in plane.sender.links)
        finally:
            plane.close()
    finally:
        faults.configure(None)
    assert not _slabs(), "the respawn cycle leaked shm"


@pytest.mark.slow
def test_process_shard_sigkill_respawns_no_leaks():
    """Process shards: SIGKILL one mid-run; the supervisor respawns it at
    the same address, the clients re-negotiate, no /dev/shm segment leaks,
    the fd count holds steady over kill cycles, and no shard process ever
    opened the card. Slow tier: each spawned shard imports torch (a few
    seconds a process on a loaded CPU); the thread-mode kill test keeps the
    respawn path in tier 1."""
    plane = _make_plane(transport="shm", shards=2, shard_mode="process")
    fds, pids = [], set(plane.shard_pids())
    try:
        rng = np.random.default_rng(5)
        for _ in range(3):
            plane.sender.send_rows(_rows(rng), np.arange(12) % 4)
        for cycle in range(2):
            victim = plane.shards[0]
            os.kill(victim.pid, signal.SIGKILL)
            victim.join(timeout=10)
            deadline = time.monotonic() + 60
            while time.monotonic() < deadline:
                plane.supervise()
                if plane.shards[0].is_alive() and plane.respawns >= cycle + 1:
                    break
                time.sleep(0.1)
            assert plane.respawns == cycle + 1
            pids.update(plane.shard_pids())
            # the respawned shard binds once its process has imported the
            # port; the sender's link then re-negotiates at the same address
            while plane.sender.rehellos < cycle + 1 and time.monotonic() < deadline:
                wm = plane.sender.send_rows(_rows(rng), np.arange(12) % 4)
                time.sleep(0.1)
            assert plane.sender.links[0].transport == "shm"
            for _ in range(2):
                wm = plane.sender.send_rows(_rows(rng), np.arange(12) % 4)
            batch, _ = plane.sampler.fetch_batch(cycle, 0.0, wm)
            assert batch["obs"].shape == (16, 3)
            fds.append(len(os.listdir("/proc/self/fd")))
        plane._poll_stats()
        assert all(s.get("cuda_initialized") is False for s in plane._stats_cache), plane._stats_cache
    finally:
        plane.close()
    assert fds[1] <= fds[0] + 2, fds
    assert not _slabs(pids), "the SIGKILL cycle leaked shm"


# -- the reconnecting DEALER ----------------------------------------------------

def _received(dealer, router, n):
    """The first ``n`` messages ``router`` receives from ``dealer`` while
    the dealer polls (its connection attempts run inside poll and send)."""
    got, deadline = [], time.monotonic() + 3
    while len(got) < n and time.monotonic() < deadline:
        dealer.poll(10)
        while router.poll(10):
            got.append(router.recv_multipart())
    return got


def test_reconnecting_dealer_connects_before_the_bind_and_after_a_restart():
    addr = alloc_address()
    dealer = sockets.Dealer(b"xp-test-0", 2.0, reconnect=True)
    dealer.connect(addr)  # nothing bound yet: not an error, the message waits
    dealer.send(b"before-bind")
    router = sockets.Router(addr)
    try:
        dealer.send(b"after-bind")
        assert _received(dealer, router, 2) == [(b"xp-test-0", b"before-bind"), (b"xp-test-0", b"after-bind")]
        router.send_multipart([b"xp-test-0", b"reply"])
        assert dealer.poll(2000) and dealer.recv() == b"reply"
        router.close()
        # the server restarts at the same address: the identity goes first
        # again, and a message sent while it was down is delivered
        time.sleep(0.05)
        dealer.send(b"while-down")
        router = sockets.Router(addr)
        assert _received(dealer, router, 1) == [(b"xp-test-0", b"while-down")]
        assert dealer.connects == 2
    finally:
        router.close()
        dealer.close()


def test_default_dealer_still_never_reconnects():
    """SEED workers keep the old behaviour: a gone server drops sends and
    the worker's silence budget decides (the kill-replica mirror relies on
    it)."""
    router = sockets.Router()
    dealer = sockets.Dealer(b"worker-0", 2.0)
    dealer.connect(router.address)
    router.close()
    time.sleep(0.05)
    assert not dealer.poll(100)
    dealer.send(b"dropped")
    assert dealer.connects == 1
    dealer.close()
    with pytest.raises(ConnectionRefusedError):
        sockets.Dealer(b"worker-1", 0.5).connect(router.address)


# -- trainer integration --------------------------------------------------------

def _remote_cfg(folder, transport="shm", overlap=False, iters=3, kind="uniform", plan=None, **plane):
    cfg = Config(
        learner_config=Config(
            algo=Config(name="ddpg", horizon=8, updates_per_iter=2, exploration=Config(warmup_steps=0)),
            replay=Config(kind="remote", remote_kind=kind, capacity=512, start_sample_size=16, batch_size=32),
        ),
        env_config=Config(name="gym:Pendulum-v1", num_envs=4),
        session_config=Config(
            folder=str(folder), total_env_steps=8 * 4 * iters,
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
            topology=Config(overlap_rollouts=overlap, experience_plane=Config(
                **{"num_shards": 2, "shard_mode": "thread", "transport": transport, **plane})),
        ),
    ).extend(base_config())
    if plan is not None:
        cfg.session_config.faults = Config(plan=plan)
    return cfg


def test_strict_remote_training_is_deterministic(tmp_path):
    """overlap_rollouts=false with watermarked sampling: two identical
    remote runs give identical final losses and grad norm, with the
    experience gauges in the metrics row and the plane's events written."""
    finals = []
    for run in range(2):
        _state, metrics = OffPolicyTrainer(_remote_cfg(tmp_path / f"run{run}"), device="cpu").run()
        finals.append(metrics)
    for k in ("loss/critic", "loss/actor", "health/grad_norm"):
        assert finals[0][k] == finals[1][k], (k, finals[0][k], finals[1][k])
    assert finals[0]["experience/rows"] == finals[1]["experience/rows"] == 96.0
    assert finals[0]["experience/dropped_rows"] == 0.0 and finals[0]["experience/shards_live"] == 2.0
    events = list(_iter_jsonl(str(tmp_path / "run0" / "telemetry" / "events.jsonl")))
    (close,) = [e for e in events if e["type"] == "experience_close"]
    assert close["quiesced"] == 1.0 and close["sent_rows"] == close["ingested_rows"] == 96.0
    xp = [e for e in events if e["type"] == "experience_plane"]
    assert xp and xp[-1]["transports"] == ["shm", "shm"] and xp[-1]["num_shards"] == 2
    report = diag_report(str(tmp_path / "run0"))
    assert "Experience plane" in report and "sample-wait" in report


@pytest.mark.parametrize("kind,transport", [("prioritized", "tcp"), ("uniform", "pickle")])
def test_remote_training_other_arms(tmp_path, kind, transport):
    """Prioritized shards over tcp (one PRIO frame per shard per iteration
    that learned) and uniform over pickle, under overlap_rollouts."""
    trainer = OffPolicyTrainer(_remote_cfg(tmp_path, transport=transport, overlap=True, kind=kind), device="cpu")
    _state, metrics = trainer.run()
    assert np.isfinite(metrics["loss/critic"]) and metrics["experience/rows"] > 0
    events = list(_iter_jsonl(str(tmp_path / "telemetry" / "events.jsonl")))
    xp = [e for e in events if e["type"] == "experience_plane"][-1]
    assert xp["transports"] == [transport, transport]
    if kind == "prioritized":
        learned = sum(1 for e in events if e["type"] == "metrics" and e["values"].get("loss/critic", 0.0) != 0.0)
        assert xp["sampler"]["prio_frames"] == 2 * learned > 0


def test_kill_shard_respawns_learner_keeps_training(tmp_path):
    """A killed thread shard respawns under the schedule while training
    continues; the gauges say so, and no /dev/shm residue remains."""
    cfg = _remote_cfg(tmp_path, iters=3, plan=[{"site": "experience.shard", "kind": "kill_shard", "at": 4}],
                      ack_timeout_s=0.5, sample_timeout_s=1.0, watermark_timeout_s=0.5, respawn_backoff_s=0.05)
    cfg.learner_config.algo.updates_per_iter = 1
    _state, metrics = OffPolicyTrainer(cfg, device="cpu").run()
    assert np.isfinite(metrics["loss/critic"])
    assert metrics["experience/respawns"] >= 1.0 and metrics["experience/shards_live"] == 2.0
    assert metrics["time/env_steps"] >= 8 * 4 * 3
    assert not _slabs(), "the respawn cycle leaked shm"


def test_remote_refusals_name_their_keys(tmp_path):
    with pytest.raises(ValueError, match="remote"):
        OffPolicyTrainer(Config(learner_config=Config(algo=Config(name="ddpg"), replay=Config(kind="remote")),
                                env_config=Config(name="jax:pendulum", num_envs=4),
                                session_config=Config(folder=str(tmp_path))).extend(base_config()), device="cpu")
    group = _remote_cfg(tmp_path)
    group.session_config.topology.learner_group = Config(members=1)
    with pytest.raises(NotImplementedError, match="learner_group"):
        OffPolicyTrainer(group, device="cpu")
    from surreal_tpu_torch.replay import build_replay

    with pytest.raises(ValueError, match="experience"):
        build_replay(Config(kind="remote"))


# -- the SEED relay --------------------------------------------------------------

def test_fifo_chunk_relay_component():
    """Whole trajectory chunks (a nested behaviour dict, int32 version
    rows) round-trip sender.send_chunk -> fifo shard -> sampler.pop_chunk
    in order, the spec carried in-frame."""
    plane = ExperiencePlane(kind="fifo", cfg={"num_shards": 1, "shard_mode": "thread", "transport": "tcp"})
    try:
        rng = np.random.default_rng(6)
        chunks = []
        for _ in range(2):
            chunk = {
                "obs": rng.normal(size=(4, 2, 3)).astype(np.float32),
                "behavior": {"mean": rng.normal(size=(4, 2, 1)).astype(np.float32)},
                "param_version": np.full((4, 2), 7, np.int32),
            }
            chunks.append(chunk)
            assert plane.sender.send_chunk(chunk)
        for sent in chunks:
            got, n = plane.sampler.pop_chunk(timeout_s=5.0)
            assert n == 4
            np.testing.assert_array_equal(got["obs"], sent["obs"])
            np.testing.assert_array_equal(got["behavior"]["mean"], sent["behavior"]["mean"])
            assert got["param_version"].dtype == np.int32
        assert plane.sampler.pop_chunk(timeout_s=0.3) is None  # drained
    finally:
        plane.close()


def _seed_cfg(folder, algo):
    extra = dict(epochs=2, num_minibatches=2) if algo == "ppo" else {}
    return Config(
        learner_config=Config(algo=Config(name=algo, horizon=8, **extra)),
        env_config=Config(name="gym:CartPole-v1", num_envs=4),
        session_config=Config(
            folder=str(folder), total_env_steps=8 * 4 * 2,
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
            topology=Config(num_env_workers=1, experience_plane=Config(
                enabled=True, num_shards=2, shard_mode="thread", transport="tcp")),
        ),
    ).extend(base_config())


@pytest.mark.parametrize("algo", ["ppo", "impala"])
def test_seed_trainer_chunks_relay_through_plane(tmp_path, algo):
    """SEED through the relay: chunks route server -> shards -> learner
    and training completes with finite losses and the plane's gauges."""
    _state, metrics = SEEDTrainer(_seed_cfg(tmp_path, algo), device="cpu").run()
    assert metrics["time/env_steps"] >= 8 * 4 * 2
    assert np.isfinite(metrics["loss/pg"])
    assert metrics["experience/rows"] > 0 and metrics["experience/dropped_rows"] == 0.0
    events = list(_iter_jsonl(str(tmp_path / "telemetry" / "events.jsonl")))
    assert [e["kind"] for e in events if e["type"] == "experience_plane"][-1] == "fifo"
    assert len([e for e in events if e["type"] == "experience_close"]) == 1


def test_seed_relay_death_is_raised_on_the_main_thread(tmp_path, monkeypatch):
    from surreal_tpu_torch.experience.sender import ExperienceSender

    def broken(self, chunk):
        raise OSError("relay wire broke")

    monkeypatch.setattr(ExperienceSender, "send_chunk", broken)
    with pytest.raises(RuntimeError, match="relay thread died") as err:
        SEEDTrainer(_seed_cfg(tmp_path, "impala"), device="cpu").run()
    assert isinstance(err.value.__cause__, OSError)
