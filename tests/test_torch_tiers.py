"""The port's replay tiers and FIFO queue against the reference, on the
CPU: the device hot tier (``replay/tiers.py``) bit-equal to the port's
in-process ``UniformReplay`` for the same capacity, insert stream and
seed, its ring bit-equal to the reference's ``HotTier`` ring, its
readiness and refusals; ``FIFOReplay`` equal to the reference's over
pushes and pops; and the tiered remote DDPG path (hits, misses while the
ring fills, the tiers-off record unchanged)."""

import sys
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from surreal_tpu.replay.fifo import FIFOReplay as RefFIFOReplay
from surreal_tpu.replay.tiers import HotTier as RefHotTier
from surreal_tpu_torch.experience.plane import ExperiencePlane
from surreal_tpu_torch.experience.sampler import TieredSampler, next_seeds
from surreal_tpu_torch.launch.offpolicy_trainer import OffPolicyTrainer
from surreal_tpu_torch.replay.fifo import FIFOReplay
from surreal_tpu_torch.replay.tiers import HotTier
from surreal_tpu_torch.replay.uniform import UniformReplay
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import base_config


def _example():
    return {
        "obs": torch.zeros(3),
        "action": torch.zeros(1),
        "reward": torch.zeros(()),
        "discount": torch.zeros(()),
    }


def _batches(n_batches, rows, seed=0):
    rng = np.random.default_rng(seed)
    return [{
        "obs": rng.normal(size=(rows, 3)).astype(np.float32),
        "action": rng.normal(size=(rows, 1)).astype(np.float32),
        "reward": (rng.normal(size=(rows,)) * 5).astype(np.float32),
        "discount": np.full((rows,), 0.99, np.float32),
    } for _ in range(n_batches)]


def _t(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_hot_tier_bit_equal_to_uniform_replay(impl):
    """Same capacity, insert stream and seed: a hot sample is BIT-EQUAL to
    UniformReplay.sample with a generator seeded the same way (both
    gather_impl values, which route nothing on the CPU)."""
    cap, bs = 64, 8
    replay = UniformReplay(Config(capacity=cap, batch_size=bs, start_sample_size=bs, gather_impl=impl))
    state = replay.init(_example())
    hot = HotTier(capacity=cap, batch_size=bs, gather_impl=impl, example=_example())
    for batch in _batches(12, 16):  # 192 rows: wraps the 64-ring twice
        state = replay.insert(state, _t(batch))
        hot.append(_t(batch))
    assert hot.size == cap and hot.ready() and hot.appended == 192
    for seed in (7, 8, 2**62 + 3):
        _, want, _ = replay.sample(state, torch.Generator().manual_seed(seed))
        got = hot.sample(seed)
        for k in want:
            assert torch.equal(got[k], want[k]), k


def test_hot_ring_bit_equal_to_the_reference_ring():
    """The same append stream leaves the port's hot ring bit-equal to the
    reference's (storage, cursor, size), bf16 obs storage included."""
    ref_example = {"obs": jnp.zeros((3,), jnp.bfloat16), "action": jnp.zeros((1,)), "reward": jnp.zeros(()),
                   "discount": jnp.zeros(())}
    port_example = dict(_example(), obs=torch.zeros(3, dtype=torch.bfloat16))
    ref = RefHotTier(capacity=40, batch_size=8, gather_impl="xla", example=ref_example)
    port = HotTier(capacity=40, batch_size=8, gather_impl="xla", example=port_example)
    for batch in _batches(5, 12, seed=3):
        ref.append({k: jnp.asarray(v) for k, v in batch.items()})
        port.append(_t(batch))
    assert port.size == ref.size == 40 and port._state.cursor == int(ref._state.cursor) == 20
    for k, buf in port._state.storage.items():
        want = np.asarray(ref._state.storage[k])
        if buf.dtype == torch.bfloat16:
            np.testing.assert_array_equal(buf.view(torch.int16).numpy(), want.view(np.int16))
        else:
            np.testing.assert_array_equal(buf.numpy(), want)


def test_hot_tier_not_ready_until_min_fill():
    hot = HotTier(capacity=32, batch_size=8, gather_impl="xla", example=_example())
    assert not hot.ready()
    hot.append(_t(_batches(1, 4)[0]))
    assert not hot.ready()  # 4 < batch_size
    hot.append(_t(_batches(1, 4, seed=1)[0]))
    assert hot.ready()
    assert hot.gauges() == {"tier/hot_size": 8.0, "tier/hot_fill": 0.25}
    late = HotTier(capacity=32, batch_size=8, min_fill=16)  # storage from the first append
    late.append(_t(_batches(1, 12)[0]))
    assert not late.ready() and late.gather_impl == "xla"
    with pytest.raises(RuntimeError, match="before first append"):
        HotTier(capacity=32, batch_size=8).sample(0)


def test_hot_tier_refuses_undersized_capacity_and_unknown_impl():
    with pytest.raises(ValueError, match="hot_capacity"):
        HotTier(capacity=4, batch_size=8)
    with pytest.raises(ValueError, match="xla|pallas"):
        HotTier(capacity=16, batch_size=8, gather_impl="triton")


def test_hot_tier_appends_and_samples_from_two_threads():
    """Under overlap the staging thread appends while the main thread
    samples: every sample is a full batch of rows some append wrote."""
    hot = HotTier(capacity=64, batch_size=8, example=_example())
    hot.append(_t(_batches(1, 8)[0]))
    batches = _batches(40, 8, seed=5)
    written = {tuple(r) for b in [_batches(1, 8)[0], *batches] for r in b["obs"]}

    def appender():
        for b in batches:
            hot.append(_t(b))

    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)  # interleave the two threads as often as the interpreter can
    try:
        t = threading.Thread(target=appender)
        t.start()
        samples = [hot.sample(s) for s in range(40)]
        t.join(timeout=30)
    finally:
        sys.setswitchinterval(switch)
    assert not t.is_alive() and hot.appended == 8 * 41
    for got in samples:
        assert got["obs"].shape == (8, 3)
        assert all(tuple(r) in written for r in got["obs"].numpy())


# -- the FIFO queue ----------------------------------------------------------

def test_fifo_replay_matches_the_reference():
    """The same pushes and pops give the same trajectories, head and size,
    including an overwrite of the oldest slot when full."""
    rng = np.random.default_rng(2)
    trajs = [{"obs": rng.normal(size=(4, 2, 3)).astype(np.float32),
              "behavior": {"logits": rng.normal(size=(4, 2, 2)).astype(np.float32)},
              "reward": rng.normal(size=(4, 2)).astype(np.float32)} for _ in range(6)]

    def t_tree(tr):
        return {"obs": torch.from_numpy(tr["obs"]), "behavior": {"logits": torch.from_numpy(tr["behavior"]["logits"])},
                "reward": torch.from_numpy(tr["reward"])}

    ref, port = RefFIFOReplay(Config(slots=3)), FIFOReplay(Config(slots=3))
    rs, ps = ref.init({k: v for k, v in trajs[0].items()}), port.init(t_tree(trajs[0]))
    assert not port.can_sample(ps) and not bool(ref.can_sample(rs))
    ops = ["push", "push", "pop", "push", "push", "push", "pop", "pop", "push", "pop", "pop"]
    pushed = iter(trajs)
    for op in ops:
        if op == "push":
            tr = next(pushed)
            rs, ps = ref.insert(rs, tr), port.insert(ps, t_tree(tr))
        else:
            rs, r_traj = ref.sample(rs)
            ps, p_traj = port.sample(ps)
            np.testing.assert_array_equal(p_traj["obs"].numpy(), np.asarray(r_traj["obs"]))
            np.testing.assert_array_equal(p_traj["behavior"]["logits"].numpy(),
                                          np.asarray(r_traj["behavior"]["logits"]))
        assert (ps.head, ps.size) == (int(rs.head), int(rs.size)), op
        assert port.can_sample(ps) == bool(ref.can_sample(rs))


# -- the tiered remote path --------------------------------------------------

def test_tiered_sampler_falls_back_to_the_shards_while_the_ring_fills():
    example = {"obs": np.zeros((3,), np.float32), "action": np.zeros((1,), np.float32),
               "reward": np.zeros((), np.float32), "discount": np.zeros((), np.float32)}
    plane = ExperiencePlane(kind="uniform", example=example, capacity=64, batch_size=8, updates_per_iter=2, num_slots=4, max_insert_rows=16,
                            cfg={"num_shards": 1, "transport": "tcp"}, base_seed=3, prefetch=False)
    try:
        hot = HotTier(capacity=32, batch_size=8, min_fill=24, example=_example())
        tiered = TieredSampler(plane.sampler, hot)
        plane.attach_tiers(tiered)
        gen = torch.Generator().manual_seed(3)
        for it, batch in enumerate(_batches(3, 12, seed=4)):
            wm = plane.sender.send_rows(batch, np.arange(12) % 4)
            tiered.append(_t(batch))
            tiered.request_iteration(wm)
            staged = tiered.get_iteration()
            seeds = next_seeds(gen, 2)  # the wrapper's chain: the warm sampler's, unsplit
            assert [s for _, s, _ in staged] == seeds
            if it < 1:  # 12 rows < min_fill 24: the shards serve it
                assert all("shard_idx" in info for _, _, info in staged)
            else:
                assert all(info == {"tier": "hot"} for _, _, info in staged)
                assert staged[0][0]["obs"].shape == (8, 3)
        g = plane.gauges()
        assert g["tier/hot_misses"] == 2.0 and g["tier/hot_hits"] == 4.0 and g["tier/hot_size"] == 32.0
    finally:
        plane.close()
    with pytest.raises(ValueError, match="uniform"):
        TieredSampler(type("W", (), {"prioritized": True, "kind": "prioritized"})(), hot)


def _tiered_cfg(folder, tiers=None, iters=4):
    cfg = Config(
        learner_config=Config(
            algo=Config(name="ddpg", horizon=8, updates_per_iter=2, exploration=Config(warmup_steps=0)),
            replay=Config(kind="remote", remote_kind="uniform", capacity=512, start_sample_size=16, batch_size=32),
        ),
        env_config=Config(name="gym:Pendulum-v1", num_envs=4),
        session_config=Config(
            folder=str(folder), total_env_steps=8 * 4 * iters,
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
            topology=Config(overlap_rollouts=False, experience_plane=Config(num_shards=2, transport="shm")),
        ),
    ).extend(base_config())
    if tiers is not None:
        cfg.learner_config.replay.tiers = tiers
    return cfg


def test_tiers_off_bit_identical(tmp_path):
    """A tiers block present but disabled trains bit-identically to none."""
    finals = []
    for run, tiers in enumerate([None, Config(hot=Config(enabled=False), spill=Config(enabled=False))]):
        _state, metrics = OffPolicyTrainer(_tiered_cfg(tmp_path / f"run{run}", tiers), device="cpu").run()
        finals.append(metrics)
    for k in ("loss/critic", "loss/actor", "health/grad_norm", "experience/rows"):
        assert finals[0][k] == finals[1][k], k
    assert "tier/hot_hits" not in finals[0] and "tier/hot_hits" not in finals[1]


def test_tiered_training_serves_updates_from_the_hot_ring(tmp_path):
    """Tiers on, end to end: after the ring holds min_fill rows every
    update is a hot hit (the gather on the ring's device), the misses
    before are counted, and the learns stay finite."""
    cfg = _tiered_cfg(tmp_path, Config(hot=Config(enabled=True, capacity=256, min_fill=64)))
    trainer = OffPolicyTrainer(cfg, device="cpu")
    _state, metrics = trainer.run()
    # a request after each of the 4 chunks (32, 64, 96, 128 rows): one
    # miss, then hits, 2 updates each
    assert metrics["tier/hot_misses"] == 2.0 and metrics["tier/hot_hits"] == 6.0
    assert metrics["tier/hot_size"] == 128.0 and np.isfinite(metrics["loss/critic"])
