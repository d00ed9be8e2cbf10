"""The port's host data plane (``distributed/shm_transport.py``) held
against the JAX package's: slab layouts and control frames byte-equal to
``surreal_tpu.distributed.shm_transport``'s, decoding in both directions;
then the mirrors of tests/test_shm_transport.py on the port (slab
renegotiation under one identity, close unlinking every slab, the pickle
server denying shm, the silence budget, the transport knobs read from
config, a SIGKILLed process worker respawned with no /dev/shm residue).
Every wait is bounded."""

import glob
import os
import threading
import time

import numpy as np
import pytest

from surreal_tpu.distributed import shm_transport as jdp
from surreal_tpu_torch.distributed import InferenceServer, run_env_worker
from surreal_tpu_torch.distributed import shm_transport as dp
from surreal_tpu_torch.distributed.sockets import Dealer, Router
from surreal_tpu_torch.launch.seed_trainer import SEEDTrainer
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.default_configs import BASE_ENV_CONFIG, base_config

SPECS = [
    pytest.param(([3, 2], (4,), np.float32, (), np.int32), id="state-discrete"),
    pytest.param(([16, 16], (17,), np.float32, (6,), np.float32), id="state-continuous"),
    pytest.param(([64], (42, 42, 2), np.uint8, (), np.int32), id="pixels-uint8"),
    pytest.param(([5, 3], (42, 42, 2), np.uint8, (), np.int32), id="pixels-odd-split"),
]


def _leaked_slabs():
    """This process's live slabs (servers here create them; other test
    processes' slabs are theirs)."""
    return glob.glob(f"/dev/shm/{dp.SLAB_PREFIX}*_{os.getpid()}_*")


def _det_act_fn(n_actions=2):
    """Actions and info that depend only on each row's obs."""

    def act_fn(obs):
        b = obs.shape[0]
        flat = obs.reshape(b, -1).astype(np.float64)
        actions = (np.nan_to_num(flat).sum(axis=1) > 0).astype(np.int64) % n_actions
        logits = np.stack([flat.sum(axis=1), -flat.sum(axis=1)], axis=1).astype(np.float32)
        return actions, {"logp": np.full(b, -np.log(n_actions), np.float32), "logits": logits}

    return act_fn


# -- layouts and frames against the reference ---------------------------------

@pytest.mark.parametrize("args", SPECS)
def test_slab_layout_equals_the_reference(args):
    """Offsets, shapes, dtypes and sizes of every field of every slot, and
    the JSON a hello carries."""
    got, want = dp.SlabSpec(*args), jdp.SlabSpec(*args)
    assert got.nbytes == want.nbytes
    assert got._layout == want._layout
    assert got.to_json() == want.to_json()
    assert got.matches(dp.SlabSpec.from_json(want.to_json()))
    for fields in got._layout:
        offs = [off for off, _, _ in fields.values()]
        assert all(off % 64 == 0 for off in offs) and offs == sorted(offs)


@pytest.mark.parametrize("args", SPECS)
def test_control_frames_equal_the_reference(args):
    """Each frame the port encodes is byte-equal to the reference's, and
    each package decodes the other's."""
    spec, jspec = dp.SlabSpec(*args), jdp.SlabSpec(*args)
    pairs = [
        (dp.encode_hello(spec, trace="abc123"), jdp.encode_hello(jspec, trace="abc123")),
        (dp.encode_hello(spec), jdp.encode_hello(jspec)),
        (dp.encode_hello_reply("surreal_dp_x", spec), jdp.encode_hello_reply("surreal_dp_x", jspec)),
        (dp.encode_hello_reply(None, None, "transport=pickle"), jdp.encode_hello_reply(None, None, "transport=pickle")),
        (dp.encode_step(1, dp.F_HAS_REWARD | dp.F_HAS_GAUGES | dp.F_HAS_TERMINAL, 12.5, 0.75, span=2**33 + 7,
                        t_send=1.7e9 + 0.123, ep_returns=[100.0, 50.5], ep_lengths=[200.0, 99.0]),
         jdp.encode_step(1, jdp.F_HAS_REWARD | jdp.F_HAS_GAUGES | jdp.F_HAS_TERMINAL, 12.5, 0.75, span=2**33 + 7,
                         t_send=1.7e9 + 0.123, ep_returns=[100.0, 50.5], ep_lengths=[200.0, 99.0])),
        (dp.encode_step(0, dp.F_FINAL, 0.0, 0.0), jdp.encode_step(0, jdp.F_FINAL, 0.0, 0.0)),
        (dp.encode_step_reply(1), jdp.encode_step_reply(1)),
    ]
    for ours, theirs in pairs:
        assert ours == theirs
        kind, obj = dp.decode_payload(theirs)
        jkind, jobj = jdp.decode_payload(ours)
        assert kind == jkind and obj == jobj
    msg = {"obs": np.arange(6, dtype=np.float32).reshape(2, 3), "reward": np.ones(2, np.float32), "slot": 1}
    assert dp.encode_pickle_msg(msg) == jdp.encode_pickle_msg(msg)
    assert dp.encode_pickle_reply(1, np.arange(3)) == jdp.encode_pickle_reply(1, np.arange(3))
    slot, acts = dp.decode_pickle_reply(jdp.encode_pickle_reply(1, np.arange(3)))
    assert slot == 1 and (acts == np.arange(3)).all()
    assert (dp.MAGIC, dp.HELLO, dp.HELLO_OK, dp.HELLO_NO, dp.STEP, dp.STEP_REPLY) == (
        jdp.MAGIC, jdp.HELLO, jdp.HELLO_OK, jdp.HELLO_NO, jdp.STEP, jdp.STEP_REPLY)


def test_slab_views_are_disjoint_and_typed():
    spec = dp.SlabSpec([2, 3], (5,), np.float32, (2,), np.float32)
    shm = dp.create_slab(spec, tag="layout-test")
    try:
        views = spec.views(shm.buf)
        assert [v["obs"].shape for v in views] == [(2, 5), (3, 5)]
        assert views[0]["action"].shape == (2, 2) and views[0]["done"].dtype == bool
        for i, v in enumerate(views):
            for j, name in enumerate(spec.FIELDS):
                v[name][...] = (i * 10 + j) if v[name].dtype != bool else bool(j % 2)
        for i, v in enumerate(views):
            for j, name in enumerate(spec.FIELDS):
                expect = (i * 10 + j) if v[name].dtype != bool else bool(j % 2)
                assert (v[name] == expect).all(), (i, name)
    finally:
        del views
        shm.close()
        shm.unlink()


# -- slab lifecycle -----------------------------------------------------------

def _hello(sock, spec, timeout_ms=5000):
    sock.send(dp.encode_hello(spec))
    assert sock.poll(timeout_ms), "no hello reply"
    return dp.decode_payload(sock.recv())


def _connect(server, ident: bytes) -> Dealer:
    s = Dealer(ident, send_timeout_s=5.0)
    s.connect(server.address)
    return s


def test_slab_renegotiation_reuses_then_recreates():
    """A respawned worker's hello under the same identity with the SAME
    geometry re-attaches the existing slab; a CHANGED geometry gets a
    fresh slab and the orphan is unlinked at once."""
    server = InferenceServer(act_fn=_det_act_fn(), unroll_length=4)
    spec = dp.SlabSpec([2], (4,), np.float32, (), np.int32)
    try:
        w1 = _connect(server, b"worker-7")
        kind, ok1 = _hello(w1, spec)
        assert kind == "hello_ok" and glob.glob(f"/dev/shm/{ok1['name']}")
        w1.close()  # SIGKILL stand-in: no goodbye

        w2 = _connect(server, b"worker-7")  # respawn, same identity, same geometry
        kind, ok2 = _hello(w2, spec)
        assert kind == "hello_ok" and ok2["name"] == ok1["name"]
        w2.close()

        w3 = _connect(server, b"worker-7")  # respawn with another geometry
        kind, ok3 = _hello(w3, dp.SlabSpec([4], (4,), np.float32, (), np.int32))
        assert kind == "hello_ok" and ok3["name"] != ok1["name"]
        assert not glob.glob(f"/dev/shm/{ok1['name']}")  # the orphan is unlinked now
        w3.close()
    finally:
        server.close()
    assert not _leaked_slabs()


def test_server_close_unlinks_all_slabs():
    server = InferenceServer(act_fn=_det_act_fn(), unroll_length=4)
    socks = []
    try:
        for i in range(3):
            socks.append(_connect(server, f"worker-{i}".encode()))
            kind, _ = _hello(socks[-1], dp.SlabSpec([2], (3,), np.float32, (), np.int32))
            assert kind == "hello_ok"
        assert len(_leaked_slabs()) == 3
    finally:
        for s in socks:
            s.close()
        server.close()
    assert not _leaked_slabs()


def test_pickle_server_denies_shm_and_worker_falls_back():
    """transport='pickle' on the server denies every hello; an 'auto'
    worker falls back to the pickle wire and experience still flows."""
    server = InferenceServer(act_fn=_det_act_fn(), unroll_length=4, transport="pickle")
    env_cfg = Config(name="gym:CartPole-v1", num_envs=2).extend(BASE_ENV_CONFIG)
    stop = threading.Event()
    w = threading.Thread(
        target=run_env_worker, args=(env_cfg, server.address, 0),
        kwargs={"stop_event": stop, "max_steps": 200, "transport": "auto"}, daemon=True,
    )
    try:
        w.start()
        chunk = server.chunks.get(timeout=30)
        assert chunk["obs"].shape == (4, 2, 4)
        stats = server.transport_stats()
        assert stats["shm_workers"] == 0.0 and stats["pickle_workers"] == 1.0
    finally:
        stop.set()
        server.close()
        w.join(timeout=10)
    assert not w.is_alive()
    assert not _leaked_slabs()


def test_worker_silence_budget_is_configurable():
    """Against a bound but mute server, a small silence budget times the
    worker out (raising), instead of the default two minutes later."""
    mute = Router("tcp://127.0.0.1:*")
    env_cfg = Config(name="gym:CartPole-v1", num_envs=1).extend(BASE_ENV_CONFIG)
    try:
        with pytest.raises(TimeoutError, match="silent for 1s"):
            run_env_worker(env_cfg, mute.address, 0, max_steps=10, transport="pickle", server_silence_s=1.0)
    finally:
        mute.close()


def test_seed_trainer_resolves_transport_and_pipeline_from_config(tmp_path):
    """topology.transport / pipeline_workers / worker_silence_s reach the
    trainer; thread-mode 'auto' resolves to the pickle wire."""

    def make(workers_mode="thread", n_envs=4, **topo):
        cfg = Config(
            learner_config=Config(algo=Config(name="impala", horizon=4)),
            env_config=Config(name="gym:CartPole-v1", num_envs=n_envs),
            session_config=Config(folder=str(tmp_path), topology=Config(num_env_workers=1, **topo)),
        ).extend(base_config())
        return SEEDTrainer(cfg, worker_mode=workers_mode, device="cpu")

    t = make()
    assert (t.worker_transport, t.pipeline_workers, t.worker_silence_s) == ("pickle", True, 120.0)
    assert make(workers_mode="process").worker_transport == "auto"  # process + auto -> negotiate shm
    t = make(transport="shm", worker_silence_s=7.5, pipeline_workers=False)
    assert (t.worker_transport, t.worker_silence_s, t.pipeline_workers) == ("shm", 7.5, False)
    assert make(n_envs=3).pipeline_workers is False  # odd width: no even split
    with pytest.raises(ValueError, match="transport"):
        make(transport="carrier-pigeon")


@pytest.mark.slow
def test_sigkilled_process_worker_respawns_on_shm_and_leaks_nothing(tmp_path):
    """SIGKILL (not terminate) a process worker mid-run under the forced
    shm transport: the supervisor respawns it, the respawn renegotiates
    its slab under the same identity, the run completes, and closing the
    plane leaves /dev/shm empty (the server owns every slab)."""
    cfg = Config(
        learner_config=Config(algo=Config(name="impala", horizon=8)),
        env_config=Config(name="gym:CartPole-v1", num_envs=4),
        session_config=Config(
            folder=str(tmp_path), total_env_steps=1500,
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
            topology=Config(num_env_workers=2, transport="shm"),
        ),
    ).extend(base_config())
    trainer = SEEDTrainer(cfg, worker_mode="process", device="cpu")
    killed = {"pid": None}

    def cb(it, m):
        if it >= 2 and killed["pid"] is None:
            # both workers on their slabs first (a spawned worker's start is
            # slow under load; the run waits here, bounded)
            deadline = time.monotonic() + 60
            while trainer._server.transport_stats()["shm_workers"] < 2 and time.monotonic() < deadline:
                time.sleep(0.05)
            killed["pid"] = trainer._workers[0].pid
            trainer._workers[0].kill()  # SIGKILL: no atexit, no tracker
            trainer._workers[0].join(timeout=5)
        return False

    _, metrics = trainer.run(on_metrics=cb)
    assert killed["pid"] is not None and trainer._workers[0].pid != killed["pid"]
    assert metrics["workers/respawns"] >= 1.0
    assert metrics["time/env_steps"] >= 1500
    assert metrics["server/shm_workers"] == 2.0
    assert not any(w.is_alive() for w in trainer._workers)
    assert not _leaked_slabs()
    assert os.path.isfile(os.path.join(str(tmp_path), "telemetry", "events.jsonl"))
