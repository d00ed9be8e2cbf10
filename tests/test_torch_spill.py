"""The port's disk spill tier (``experience/spill.py``, the shards'
write-ahead hook, the plane's ``tier/spill_*`` gauges and
``OffPolicyTrainer.replay_from_log``) against the JAX package's, on the
CPU:

- the cold codec byte-equal to the reference's for seeded rows (quant on
  and off, float32 and bfloat16 specs), and its decode within
  ``q8_error_bound``;
- logs: the port's segments byte-equal to the reference's for the same
  appends, each package's ``SpillLog`` reading the other's, and the
  reference's durability cases (merge order, a torn segment, ENOSPC, a
  delayed fsync) on the port;
- ``replay_from_log`` on one log against the reference's, with JAX's
  initial parameters and sample indices injected: each leaf's update
  within 1% of JAX's in norm; two port runs give equal digests;
- remote DDPG with the spill tier on thread shards (the ``tier/*`` gauges
  equal to the segments and rows on disk, with and without an ENOSPC
  plan), and a spawned process shard writing its own log without
  touching CUDA and closing it on SIGTERM."""

import os
import time

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from surreal_tpu.experience import spill as jax_spill
from surreal_tpu.experience import wire as jax_wire
from surreal_tpu.launch.offpolicy_trainer import OffPolicyTrainer as JaxOffPolicyTrainer
from surreal_tpu.session.config import Config as JaxConfig
from surreal_tpu.session.default_configs import base_config as jax_base_config
from surreal_tpu.utils import faults as jax_faults
from surreal_tpu_torch.experience import spill, wire
from surreal_tpu_torch.experience.plane import ExperiencePlane
from surreal_tpu_torch.experience.spill import ColdCodec, SpillLog, build_writer, q8_error_bound
from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.convert import ddpg_params_from_jax


@pytest.fixture(autouse=True)
def _no_faults():
    faults.configure(None)
    jax_faults.configure(None)
    yield
    faults.configure(None)
    jax_faults.configure(None)


_FIELDS = {"obs": (3,), "next_obs": (3,), "action": (1,), "reward": (), "discount": (), "done": ()}


def _rows(seed, n, bf16=False):
    """Seeded rows of a DDPG transition layout plus a bool column; the obs
    columns in bfloat16 (as their 16-bit words for the port) when asked."""
    rng = np.random.default_rng(seed)
    rows = {
        "obs": rng.normal(size=(n, 3)).astype(np.float32),
        "next_obs": rng.normal(size=(n, 3)).astype(np.float32),
        "action": rng.uniform(-1, 1, size=(n, 1)).astype(np.float32),
        "reward": (rng.normal(size=(n,)) * 5).astype(np.float32),
        "discount": np.where(rng.random(n) < 0.1, 0.0, 0.99).astype(np.float32),
        "done": rng.random(n) < 0.1,
    }
    if not bf16:
        return rows, rows
    jax_rows = dict(rows, obs=rows["obs"].astype(ml_dtypes.bfloat16), next_obs=rows["next_obs"].astype(ml_dtypes.bfloat16))
    port_rows = dict(rows, obs=jax_rows["obs"].view(np.uint16), next_obs=jax_rows["next_obs"].view(np.uint16))
    return jax_rows, port_rows


def _specs(bf16=False):
    jax_fields, port_fields = [], []
    for name, shape in _FIELDS.items():
        dtype = np.bool_ if name == "done" else np.float32
        if bf16 and name.endswith("obs"):
            jax_fields.append((name, shape, ml_dtypes.bfloat16))
            port_fields.append((name, shape, "bfloat16"))
        else:
            jax_fields.append((name, shape, dtype))
            port_fields.append((name, shape, dtype))
    return jax_wire.PlaneSpec(jax_fields), wire.PlaneSpec(port_fields)


# -- the cold codec -------------------------------------------------------------

@pytest.mark.parametrize("quant", [True, False], ids=["quant", "raw"])
@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_cold_codec_byte_equal_to_the_reference(quant, bf16):
    jspec, pspec = _specs(bf16)
    assert jspec.to_json() == pspec.to_json()
    jrows, prows = _rows(3, 64, bf16)
    want = jax_spill.ColdCodec(jspec, quant=quant).encode(jrows, 64)
    codec = ColdCodec(pspec, quant=quant)
    got = codec.encode(prows, 64)
    assert got[0] == want[0] and got[1] == want[1]
    assert codec.cold_row_nbytes == jax_spill.ColdCodec(jspec, quant=quant).cold_row_nbytes
    back = codec.decode(got[0], 64, got[1])
    if quant:
        assert set(got[1]) == {"reward", "discount"}
        for name, (lo, hi) in got[1].items():
            err = np.abs(back[name].astype(np.float64) - prows[name].astype(np.float64)).max()
            assert err <= q8_error_bound(lo, hi), (name, err)
        if not bf16:  # float16 storage: relative roundoff
            assert np.abs(back["obs"] - prows["obs"]).max() <= 2.0 ** -10 * np.abs(prows["obs"]).max() + 1e-6
    else:
        assert got[1] == {}
        for name in ("reward", "discount", "action"):
            np.testing.assert_array_equal(back[name], prows[name])
    # bfloat16 columns travel raw, as their 16-bit words, and the bools exactly
    for name in ("done", *(("obs", "next_obs") if bf16 else ())):
        np.testing.assert_array_equal(back[name], prows[name])


def test_cold_rows_are_a_quarter_smaller():
    _, pspec = _specs()
    raw = sum(d.itemsize * int(np.prod(s, dtype=np.int64)) for _, s, d in pspec.fields)
    assert ColdCodec(pspec, quant=True).cold_row_nbytes <= 0.75 * raw


# -- logs -------------------------------------------------------------------------

def _write_logs(module, spec, folder, rows_of, shards=2, segments=3, **cfg):
    writers = [module.build_writer({"enabled": True, "dir": str(folder), **cfg}, spec, s) for s in range(shards)]
    for seq in range(segments):
        for s, w in enumerate(writers):
            w.append(rows_of(10 * seq + s), 8 + seq)
    for w in writers:
        w.close()
    return writers


@pytest.mark.parametrize("bf16", [False, True], ids=["f32", "bf16"])
def test_logs_are_byte_equal_and_read_across_packages(tmp_path, bf16):
    """The same appends through both writers give equal files; each
    package's SpillLog reads the other's log in (seq, shard) order, to the
    same rows."""
    jspec, pspec = _specs(bf16)
    _write_logs(jax_spill, jspec, tmp_path / "jax", lambda s: _rows(s, 8 + s // 10, bf16)[0])
    writers = _write_logs(spill, pspec, tmp_path / "port", lambda s: _rows(s, 8 + s // 10, bf16)[1])
    for s in range(2):
        assert (tmp_path / "jax" / f"shard{s}.log").read_bytes() == (tmp_path / "port" / f"shard{s}.log").read_bytes()
        assert writers[s].stats()["spill_segments"] == 3 and writers[s].stats()["spill_errors"] == 0
    ours = list(SpillLog(str(tmp_path / "jax")).segments())
    theirs = list(jax_spill.SpillLog(str(tmp_path / "port")).segments())
    order = [(q, s, 8 + q) for q in range(3) for s in range(2)]
    assert [(h["seq"], h["shard"], n) for h, _, n in ours] == [(h["seq"], h["shard"], n) for h, _, n in theirs] == order
    for (h, a, n), (_, b, _) in zip(ours, theirs):
        for k in a:
            other = np.asarray(b[k])
            np.testing.assert_array_equal(a[k], other if other.dtype == a[k].dtype else other.view(a[k].dtype))
        np.testing.assert_array_equal(a["done"], _rows(10 * h["seq"] + h["shard"], n, bf16)[1]["done"])


def _spill_spec():
    return wire.PlaneSpec.from_example({"obs": np.zeros((3,), np.float32), "reward": np.zeros((), np.float32)})


def _spill_rows(seed, n=8):
    rng = np.random.default_rng(seed)
    return {"obs": rng.normal(size=(n, 3)).astype(np.float32), "reward": rng.normal(size=(n,)).astype(np.float32)}


def test_spill_roundtrip_merge_order(tmp_path):
    writers = [build_writer({"enabled": True, "dir": str(tmp_path)}, _spill_spec(), s) for s in range(2)]
    for seq in range(3):
        for s, w in enumerate(writers):
            w.append(_spill_rows(10 * seq + s), 8)
    for w in writers:
        w.close()
    log = SpillLog(str(tmp_path))
    assert [(h["seq"], h["shard"]) for h, _r, _n in log.segments()] == [
        (0, 0), (0, 1), (1, 0), (1, 1), (2, 0), (2, 1)]
    assert log.torn_segments == 0
    assert build_writer({"enabled": False, "dir": str(tmp_path)}, _spill_spec(), 0) is None
    assert build_writer({"enabled": True}, _spill_spec(), 0) is None


def test_spill_torn_segment_is_skipped_and_counted(tmp_path):
    """``truncate_segment`` at the second append: the reader skips the torn
    frame by resyncing on the magic, counts it, and decodes every other
    segment; the reference's reader sees the same."""
    faults.configure([{"site": "experience.spill", "kind": "truncate_segment", "at": 1}])
    w = build_writer({"enabled": True, "dir": str(tmp_path)}, _spill_spec(), 0)
    for seq in range(4):
        w.append(_spill_rows(seq), 8)
    w.close()
    assert w.stats()["spill_segments"] == 3
    for reader in (SpillLog, jax_spill.SpillLog):
        log = reader(str(tmp_path))
        got = [(h["seq"], rows) for h, rows, _n in log.segments()]
        assert [seq for seq, _ in got] == [0, 2, 3]
        assert log.torn_segments >= 1  # a resync may count one tear twice
        for seq, rows in got:
            np.testing.assert_allclose(rows["obs"], _spill_rows(seq)["obs"], atol=2.0 ** -9)


def test_spill_enospc_degrades_counted(tmp_path):
    faults.configure([{"site": "experience.spill", "kind": "enospc", "at": 0, "times": 2}])
    w = build_writer({"enabled": True, "dir": str(tmp_path)}, _spill_spec(), 0)
    for seq in range(4):
        w.append(_spill_rows(seq), 8)
    w.close()
    st = w.stats()
    assert (st["spill_errors"], st["spill_failed"], st["spill_segments"]) == (2, 0, 2)
    log = SpillLog(str(tmp_path))
    assert sum(1 for _ in log.segments()) == 2 and log.torn_segments == 0


def test_spill_enospc_streak_latches_the_writer_off(tmp_path):
    """MAX_CONSECUTIVE_ERRORS failures in a row latch the writer: later
    appends cost nothing and write nothing."""
    n = spill.SpillWriter.MAX_CONSECUTIVE_ERRORS
    faults.configure([{"site": "experience.spill", "kind": "enospc", "at": 0, "times": n}])
    w = build_writer({"enabled": True, "dir": str(tmp_path)}, _spill_spec(), 0)
    for seq in range(n + 3):
        w.append(_spill_rows(seq), 8)
    w.close()
    assert w.stats()["spill_errors"] == n and w.stats()["spill_failed"] == 1
    assert faults.get().counts()["experience.spill"] == n
    assert sum(1 for _ in SpillLog(str(tmp_path)).segments()) == 0


def test_spill_delayed_fsync_never_loses_data(tmp_path):
    faults.configure([{"site": "experience.spill", "kind": "delay_fsync", "at": 0, "ms": 5}])
    w = build_writer({"enabled": True, "dir": str(tmp_path), "fsync": True}, _spill_spec(), 0)
    t0 = time.monotonic()
    w.append(_spill_rows(0), 8)
    assert time.monotonic() - t0 >= 0.005
    w.close()
    assert sum(1 for _ in SpillLog(str(tmp_path)).segments()) == 1


# -- replay from the log ------------------------------------------------------------

B, H, BS, UPI, START = 4, 8, 16, 2, 48
SEGMENTS = [32, 24, 40, 16, 32]


def _replay_tree(capacity=256, **algo):
    return dict(
        learner_config=dict(
            algo=dict(name="ddpg", horizon=H, updates_per_iter=UPI, precision="f32", **algo),
            replay=dict(kind="uniform", capacity=capacity, start_sample_size=START, batch_size=BS),
        ),
        env_config=dict(name="gym:Pendulum-v1", num_envs=B),
        session_config=dict(folder="unused", seed=3),
    )


def _pendulum_log(folder):
    """Five segments of Pendulum-shaped DDPG rows over two shards."""
    spec = wire.PlaneSpec.from_example({k: np.zeros(s, np.float32) for k, s in (
        ("obs", (3,)), ("next_obs", (3,)), ("action", (1,)), ("reward", ()), ("discount", ()))})
    writers = [build_writer({"enabled": True, "dir": str(folder)}, spec, s) for s in range(2)]
    for i, n in enumerate(SEGMENTS):
        rows, _ = _rows(100 + i, n)
        writers[i % 2].append({k: rows[k] for k in spec.names()}, n)
    for w in writers:
        w.close()
    return str(folder)


def _jax_draws(seed, capacity):
    """Every update's sample indices in the reference's replay_from_log key
    chain, from the segment sizes in log order."""
    key = jax.random.key(seed)
    key, _init_key = jax.random.split(key)
    size, idx = 0, []
    for n in _log_order():
        size = min(size + n, capacity)
        if size < START:
            continue
        for _ in range(UPI):
            key, skey, _lkey = jax.random.split(key, 3)
            idx.append(np.asarray(jax.random.randint(skey, (BS,), 0, jnp.maximum(jnp.int32(size), 1))))
    return np.stack(idx)


def _log_order():
    """The segment sizes in the log's (seq, shard) order."""
    seqs = {0: 0, 1: 0}
    keyed = []
    for i, n in enumerate(SEGMENTS):
        keyed.append(((seqs[i % 2], i % 2), n))
        seqs[i % 2] += 1
    return [n for _, n in sorted(keyed)]


def _updates_close(got, want, start):
    for k in want:
        moved = (want[k] - start[k]).norm()
        assert moved > 0, k
        assert (got[k] - want[k]).norm() <= 1e-2 * moved, (k, float((got[k] - want[k]).norm() / moved))


def test_replay_from_log_matches_the_reference(tmp_path):
    """One log, both trainers: JAX's replay_from_log, and the port's with
    JAX's initial parameters and sample indices injected. Counts equal;
    each leaf of the actor, the critic and their targets within 1% of
    JAX's update in norm; two port runs from the session seed give equal
    digests, a third with another seed another."""
    log = _pendulum_log(tmp_path / "spill")
    jt = JaxOffPolicyTrainer(JaxConfig(_replay_tree()).extend(jax_base_config()))
    tt = OffPolicyTrainer(Config(_replay_tree()).extend(base_config()), device="cpu")
    inits = []
    init = jt.learner.init
    jt.learner.init = lambda key: inits.append(init(key)) or inits[-1]  # keep JAX's initial state
    want = jt.replay_from_log(log)
    idx = _jax_draws(3, 256)
    (j_init,) = inits

    def converted(state, target=False):
        p = "target_" if target else ""
        tree = jax.tree.map(np.asarray, (getattr(state, f"{p}actor_params"), getattr(state, f"{p}critic_params")))
        return ddpg_params_from_jax(*tree)

    start = tt.learner.state_from_params(*converted(j_init))
    got = tt.replay_from_log(log, state=start, sample_draws=torch.from_numpy(idx))
    assert (got["updates"], got["rows"], got["segments"], got["torn_segments"]) == (
        want["updates"], want["rows"], want["segments"], want["torn_segments"]) == (len(idx), sum(SEGMENTS), 5, 0)
    start_pair = converted(j_init)
    for target in (False, True):
        p = "target_" if target else ""
        got_pair = (getattr(got["state"], f"{p}actor_params"), getattr(got["state"], f"{p}critic_params"))
        for g, w, s in zip(got_pair, converted(want["state"], target), start_pair):
            _updates_close(dict(g), dict(w), dict(s))
    assert set(got["metrics"]) == set(want["metrics"])
    for k in ("loss/critic", "loss/actor"):
        np.testing.assert_allclose(got["metrics"][k], want["metrics"][k], rtol=1e-2, err_msg=k)
    runs = [tt.replay_from_log(log) for _ in range(2)]
    assert runs[0]["params_digest"] == runs[1]["params_digest"]
    assert runs[0]["updates"] == len(idx)
    assert tt.replay_from_log(log, max_updates=3)["updates"] == 3
    other = OffPolicyTrainer(Config(dict(_replay_tree(), session_config=dict(folder="unused", seed=4))).extend(
        base_config()), device="cpu")
    assert other.replay_from_log(log)["params_digest"] != runs[0]["params_digest"]


def test_replay_from_log_refuses_device_envs():
    cfg = Config(dict(_replay_tree(), env_config=dict(name="jax:pendulum", num_envs=2))).extend(base_config())
    with pytest.raises(ValueError, match="host-path"):
        OffPolicyTrainer(cfg, device="cpu").replay_from_log("unused")


# -- the spill tier on the remote plane --------------------------------------------

def _remote_cfg(folder, plan=None, iters=3):
    cfg = Config(
        learner_config=Config(
            algo=Config(name="ddpg", horizon=8, updates_per_iter=2, exploration=Config(warmup_steps=0)),
            replay=Config(kind="remote", remote_kind="uniform", capacity=512, start_sample_size=16, batch_size=32,
                          tiers=Config(spill=Config(enabled=True))),
        ),
        env_config=Config(name="gym:Pendulum-v1", num_envs=4),
        session_config=Config(
            folder=str(folder), total_env_steps=8 * 4 * iters,
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
            topology=Config(overlap_rollouts=False, experience_plane=Config(
                num_shards=2, shard_mode="thread", transport="tcp")),
        ),
    ).extend(base_config())
    if plan is not None:
        cfg.session_config.faults = Config(plan=plan)
    return cfg


@pytest.mark.parametrize("plan", [None, [{"site": "experience.spill", "kind": "enospc", "at": 1, "times": 2}]],
                         ids=["clean", "enospc"])
def test_remote_training_spills_what_the_gauges_say(tmp_path, plan):
    """Remote DDPG on two thread shards with the spill tier on: the log
    lands under <folder>/spill, one file a shard, and the tier/* gauges
    equal the segments and rows on disk; under ENOSPC the errors are
    counted, the segments that failed are missing and training carries on;
    replay_from_log reads the log's rows."""
    trainer = OffPolicyTrainer(_remote_cfg(tmp_path, plan), device="cpu")
    _state, m = trainer.run()
    spill_dir = os.path.join(str(tmp_path), "spill")
    assert sorted(os.listdir(spill_dir)) == ["shard0.log", "shard1.log"]
    log = SpillLog(spill_dir)
    segs = [(h["shard"], n) for h, _rows, n in log.segments()]
    assert log.torn_segments == 0
    assert m["tier/spill_segments"] == len(segs) > 0
    assert m["tier/spill_rows"] == sum(n for _, n in segs)
    assert m["tier/spill_bytes"] == sum(os.path.getsize(os.path.join(spill_dir, f)) for f in os.listdir(spill_dir))
    assert m["tier/spill_errors"] == (2.0 if plan else 0.0) and m["tier/spill_failed"] == 0.0
    if plan:
        assert m["tier/spill_rows"] < m["experience/rows"]
    else:
        assert m["tier/spill_rows"] == m["experience/rows"]
    assert m["tier/cold_bytes_per_row"] == ColdCodec(wire.PlaneSpec.from_example(trainer._replay_example())).cold_row_nbytes
    assert np.isfinite(m["loss/critic"])
    out = trainer.replay_from_log(spill_dir)
    assert out["rows"] == m["tier/spill_rows"] and out["segments"] == len(segs) and out["updates"] > 0


def test_process_shard_writes_its_own_log_without_cuda(tmp_path):
    """One spawned process shard with the spill tier: it writes shard0.log
    as rows arrive, reports ``cuda_initialized`` false, and closes its log
    when the plane terminates it (SIGTERM): every segment is whole."""
    example = {"obs": np.zeros(3, np.float32), "reward": np.zeros((), np.float32)}
    plane = ExperiencePlane(kind="uniform", example=example, capacity=64, batch_size=8,
                            cfg={"num_shards": 1, "shard_mode": "process", "transport": "tcp"},
                            tiers={"spill": {"enabled": True, "dir": str(tmp_path)}})
    try:
        for i in range(3):
            plane.sender.send_rows(_spill_rows(i, 8), np.zeros(8, np.int64))
        deadline = time.monotonic() + 60
        while time.monotonic() < deadline and plane.gauges().get("tier/spill_segments", 0.0) < 3:
            time.sleep(0.1)
        g = plane.gauges()
        assert g["tier/spill_segments"] == 3.0 and g["tier/spill_rows"] == 24.0
        (stats,) = [s for s in plane._stats_cache if s]
        assert stats["cuda_initialized"] is False
    finally:
        plane.close()
    assert not plane.shards[0].is_alive()
    log = SpillLog(str(tmp_path))
    assert [n for _h, _r, n in log.segments()] == [8, 8, 8] and log.torn_segments == 0
