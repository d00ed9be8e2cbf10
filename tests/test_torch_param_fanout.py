"""The port's parameter fanout (``distributed/param_fanout.py``), the
queued PUB and the PUSH/PULL pair under it (``distributed/sockets.py``)
and its wiring into the session hooks, against the reference's
``tests/test_param_fanout.py`` and its ``surreal_tpu.distributed.param_fanout``:

- codec parity: frames byte-equal to the reference's, and decoded leaves
  and shadows bit-equal, under the f32 and bf16 wires, full and delta,
  with float, integer and bfloat16 leaves (finite values, tolerance 0;
  both trees' dict keys sorted, so the reference's ``jax.tree`` order and
  the port's ``tree_flatten`` order agree);
- torch's f32 -> bf16 cast equal to ml_dtypes' on finite values and -0.0
  (NaN payloads differ: ml_dtypes gives 0x7FC0, torch 0xFFFF; a publish
  never carries NaN);
- the reference's cases on the port: full and delta round trips, the
  bf16 wire, the stale-ack re-key, the late joiner's fetch fallback, the
  drop and delay chaos, the hooks' discovery keys and gauges, the bf16
  delta drift guard; and the queued PUB: 50 frames to a subscriber that
  polls only at the end all arrive in order, and frames beyond the
  high-water mark are dropped, counted and recovered through
  ``catch_up``.

Every socket wait has its own deadline."""

import json
import time

import ml_dtypes
import numpy as np
import pytest
import torch

import jax
from surreal_tpu.distributed.param_fanout import FanoutCodec as JaxFanoutCodec
from surreal_tpu.distributed.param_fanout import ParameterFanout as JaxParameterFanout
from surreal_tpu_torch.distributed import (
    FanoutCodec,
    ParameterClient,
    ParameterFanout,
    ParameterPublisher,
    ParameterServer,
    ParameterSubscriber,
)
from surreal_tpu_torch.distributed.param_fanout import from_bf16_bits, to_bf16_bits
from surreal_tpu_torch.distributed.sockets import Again, Pull, Push
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.tree import tree_flatten


@pytest.fixture(autouse=True)
def _no_faults():
    faults.configure(None)
    yield
    faults.configure(None)


def _params(seed=0, n=64):
    g = torch.Generator().manual_seed(seed)
    return {
        "b": torch.randn(n, generator=g),
        "count": torch.tensor(seed, dtype=torch.int64),  # a non-float leaf ships raw
        "w": torch.randn(n, n, generator=g),
    }


def _step(params, g, scale=1e-3):
    return {
        "b": params["b"] + scale * torch.randn(params["b"].shape, generator=g),
        "count": params["count"] + 1,
        "w": params["w"] + scale * torch.randn(params["w"].shape, generator=g),
    }


def _pair(template=None, **kw):
    fan = ParameterFanout(**kw)
    sub = ParameterSubscriber(fan.address, fan.ack_address, _params() if template is None else template)
    time.sleep(0.3)  # the subscription reaches the PUB's thread
    return fan, sub


def _recv(sub, version, timeout_s=10.0):
    deadline = time.time() + timeout_s
    got = None
    while sub.version < version and time.time() < deadline:
        out = sub.poll(timeout_ms=100)
        got = out if out is not None else got
    return got


def _wait_acks(fan, n, timeout_s=5.0):
    deadline = time.time() + timeout_s
    while fan.subscribers < n and time.time() < deadline:
        fan._drain_acks()
        time.sleep(0.02)
    return fan.subscribers


def _bits(x) -> bytes:
    return np.ascontiguousarray(x).tobytes()


def _codec_leaves(seed: int):
    """The same leaves for both codecs (keys sorted): float32, int64,
    bfloat16 (numpy: ml_dtypes; torch: bfloat16) and a float32 scalar."""
    rng = np.random.default_rng(seed)
    ref = {
        "a_bias": rng.normal(size=16).astype(np.float32),
        "b_count": np.array(seed + 3, np.int64),
        "c_trunk": rng.normal(size=(8, 4)).astype(ml_dtypes.bfloat16),
        "d_kernel": (rng.normal(size=(16, 8)) * np.array([1e-30, 1.0, 1e4, -0.0, 3.0, 1e-3, 7.0, 2.0])
                     ).astype(np.float32),
        "e_scale": np.float32(rng.normal()),
    }
    port = {k: torch.from_numpy(np.array(v).view(np.uint16)).view(torch.bfloat16) if v.dtype == ml_dtypes.bfloat16
            else torch.from_numpy(np.array(v)) for k, v in ref.items()}
    return ref, port


@pytest.mark.parametrize("wire", ["f32", "bf16"])
def test_codec_frames_byte_equal_the_reference(wire):
    """Two full frames and three deltas: every frame byte-equal, every
    shadow and decoded leaf bit-equal; the bfloat16 leaf ships raw and
    full (numpy's rule, as under ml_dtypes), the float leaves as deltas."""
    ref0, port0 = _codec_leaves(0)
    jc, pc = JaxFanoutCodec(ref0), FanoutCodec(port0)
    assert pc.floating == [True, False, False, True, True] == jc.floating
    j_shadow = p_shadow = None
    for v in range(1, 6):
        ref, port = _codec_leaves(v)
        j_leaves = [np.asarray(x) for x in jax.tree.leaves(ref)]
        p_leaves = [x.view(torch.int16).numpy().view(np.uint16) if x.dtype == torch.bfloat16 else x.numpy()
                    for x in port.values()]
        delta = v > 2
        kw = dict(base_version=v - 1) if delta else {}
        jf, jn = jc.encode(v, j_leaves, wire=wire, shadow=j_shadow if delta else None, **kw)
        pf, pn = pc.encode(v, p_leaves, wire=wire, shadow=p_shadow if delta else None, **kw)
        assert pf == jf, (wire, v)
        assert [_bits(x) for x in pn] == [_bits(x) for x in jn]
        jd, pd = jc.decode(jf, j_shadow), pc.decode(pf, p_shadow)
        assert pd[:2] == jd[:2] == (v, v - 1 if delta else 0)
        assert [_bits(x) for x in pd[2]] == [_bits(x) for x in jd[2]] == [_bits(x) for x in pn]
        j_shadow, p_shadow = jn, pn
    assert pc.decode(pf, None)[2] is None  # a delta with no state to apply it to
    tree = pc.to_tree(p_shadow)
    assert tree["c_trunk"].dtype == torch.bfloat16 and tree["b_count"].dtype == torch.int64
    assert tree["a_bias"].dtype == torch.float32


def test_bf16_cast_matches_ml_dtypes_on_finite_values():
    rng = np.random.default_rng(1)
    x = np.concatenate([rng.normal(size=4096).astype(np.float32) * 10.0 ** rng.integers(-38, 38, 4096),
                        np.array([0.0, -0.0, 1.0, -1.0, 3.4e38, -3.4e38, 1e-45, 1.0000001, 1.00390625,
                                  1.01171875], np.float32)]).astype(np.float32)
    x = x[np.isfinite(x)]
    want = x.astype(ml_dtypes.bfloat16).view(np.uint16)
    np.testing.assert_array_equal(to_bf16_bits(x), want)
    np.testing.assert_array_equal(from_bf16_bits(want), want.view(ml_dtypes.bfloat16).astype(np.float32))


def test_full_f32_roundtrip_is_exact_and_acked():
    fan, sub = _pair(wire="f32", delta=False)
    try:
        p = _params(1)
        assert fan.publish(p)["kind"] == "full"
        got = _recv(sub, 1)
        assert got is not None and sub.version == 1
        for k in ("w", "b"):
            assert torch.equal(got[k], p[k])
        assert int(got["count"]) == 1 and got["count"].dtype == torch.int64
        assert _wait_acks(fan, 1) == 1
        assert sub.gauges() == {"param/applied_frames": 1.0, "param/stale_frames": 0.0,
                                "param/fallback_fetches": 0.0}
    finally:
        sub.close()
        fan.close()


def test_delta_chain_reconstructs_and_shrinks_frames():
    fan, sub = _pair(wire="f32", delta=True)
    try:
        g = torch.Generator().manual_seed(2)
        p = _params(2)
        sizes = []
        for _ in range(5):
            info = fan.publish(p)
            sizes.append(info["bytes"])
            assert _recv(sub, info["version"]) is not None
            _wait_acks(fan, 1)
            time.sleep(0.05)  # the ack lands before the next publish
            p = _step(p, g)
        assert fan.full_frames == 1 and fan.delta_frames == 4
        assert max(sizes[1:]) < sizes[0]
        got = [x.numpy() for x in tree_flatten(sub.params).values()]
        assert [_bits(a) for a in got] == [_bits(b) for b in fan._shadow]
    finally:
        sub.close()
        fan.close()


def test_bf16_wire_reconstructs_rounded_exactly_when_delta_disabled():
    fan, sub = _pair(wire="bf16", delta=False)
    try:
        p = _params(3)
        info = fan.publish(p)
        assert info["kind"] == "full"
        assert info["bytes"] < sum(p[k].numel() * 4 for k in ("w", "b")) * 0.6
        got = _recv(sub, 1)
        assert got is not None
        for k in ("w", "b"):
            assert torch.equal(got[k], p[k].to(torch.bfloat16).to(torch.float32))
            torch.testing.assert_close(got[k], p[k], rtol=2**-7, atol=1e-6)
        assert int(got["count"]) == 3 and fan.delta_frames == 0
    finally:
        sub.close()
        fan.close()


def test_stale_ack_forces_full_frame_rekey():
    fan, sub = _pair(wire="f32", delta=True)
    try:
        g = torch.Generator().manual_seed(4)
        p = _params(4)
        fan.publish(p)
        assert _recv(sub, 1) is not None
        _wait_acks(fan, 1)
        p = _step(p, g)
        assert fan.publish(p)["kind"] == "delta"  # the ack was fresh at v1
        p = _step(p, g)
        for ident in fan._acked:  # a lagging ack: it missed v2
            fan._acked[ident] = (1, time.monotonic())
        info3 = fan.publish(p)
        assert info3["kind"] == "full" and fan.rekeys >= 1
        got = _recv(sub, 3)
        assert got is not None and sub.version == 3 and torch.equal(got["w"], p["w"])
        fan.force_rekey()  # a requested re-key is counted the same
        _wait_acks(fan, 1)
        time.sleep(0.05)
        assert fan.publish(_step(p, g))["kind"] == "full" and fan.rekeys == 2
    finally:
        sub.close()
        fan.close()


def test_late_joiner_catches_up_via_fetch_then_subscribes():
    """A late joiner misses the early frames, counts an inapplicable delta,
    catches up through ``ParameterClient.fetch`` against the session's
    ParameterServer, and then applies the stream's deltas."""
    g = torch.Generator().manual_seed(5)
    p = _params(5)
    fan = ParameterFanout(wire="f32", delta=True)
    established = ParameterSubscriber(fan.address, fan.ack_address, _params())
    pub = ParameterPublisher()
    srv = ParameterServer(pub.address)
    late = client = None
    try:
        time.sleep(0.3)
        for _ in range(3):
            fan.publish(p)
            pub.publish(p)  # the fetch fallback sees the same versions
            assert _recv(established, fan.version) is not None
            _wait_acks(fan, 1)
            time.sleep(0.05)
            p = _step(p, g)
        late = ParameterSubscriber(fan.address, fan.ack_address, _params())
        time.sleep(0.3)
        assert fan.publish(p)["kind"] == "delta"
        pub.publish(p)
        assert _recv(established, fan.version) is not None
        deadline = time.time() + 10
        while not late.needs_resync and time.time() < deadline:
            late.poll(timeout_ms=100)
        assert late.needs_resync and late.stale_frames >= 1
        client = ParameterClient(srv.address, _params())
        deadline = time.time() + 10
        while late.params is None and time.time() < deadline:
            late.catch_up(client)
            time.sleep(0.1)
        assert late.fallback_fetches >= 1 and late.version == fan.version
        assert all(torch.equal(late.params[k], p[k]) for k in p)
        _wait_acks(fan, 2)
        time.sleep(0.05)
        p = _step(p, g)
        assert fan.publish(p)["kind"] == "delta"
        got = _recv(late, fan.version)
        assert got is not None and not late.needs_resync
        torch.testing.assert_close(got["w"], p["w"], rtol=0, atol=1e-6)
    finally:
        for c in (client, late, established):
            if c is not None:
                c.close()
        fan.close()
        srv.close()
        pub.close()


def test_chaos_dropped_fanout_frame_recovers_counted_never_silent():
    faults.configure([{"site": "param.publish", "kind": "drop_frame", "at": 1}])
    fan, sub = _pair(wire="f32", delta=True)
    try:
        g = torch.Generator().manual_seed(6)
        p = _params(6)
        fan.publish(p)
        assert _recv(sub, 1) is not None
        _wait_acks(fan, 1)
        p = _step(p, g)
        assert fan.publish(p).get("dropped")  # v2 swallowed on the wire
        assert sub.poll(timeout_ms=300) is None and sub.version == 1
        p = _step(p, g)
        info = fan.publish(p)  # the stale ack (v1) re-keys
        assert info["kind"] == "full" and fan.rekeys >= 1
        got = _recv(sub, 3)
        assert got is not None and sub.version == 3 and torch.equal(got["w"], p["w"])
        assert any(f["site"] == "param.publish" for f in faults.drain_fired())
    finally:
        sub.close()
        fan.close()


def test_chaos_delay_publish_fires_and_still_delivers():
    faults.configure([{"site": "param.publish", "kind": "delay_publish", "at": 0, "ms": 50}])
    fan, sub = _pair(wire="f32", delta=False)
    try:
        t0 = time.monotonic()
        fan.publish(_params(7))
        assert time.monotonic() - t0 >= 0.05
        assert _recv(sub, 1) is not None
        assert any(f["site"] == "param.publish" for f in faults.drain_fired())
    finally:
        sub.close()
        fan.close()


def test_queued_pub_delivers_every_delta_in_order():
    """50 delta frames to a subscriber that polls only at the end, below
    the high-water mark: every frame applied in order, none stale, and
    the result bit-equal to the publisher's shadow."""
    fan, sub = _pair(_params(n=16), wire="f32", delta=True)
    try:
        g = torch.Generator().manual_seed(9)
        p = _params(9, n=16)
        fan.publish(p)
        assert _recv(sub, 1) is not None
        _wait_acks(fan, 1)
        for _ in range(49):
            p = _step(p, g)
            assert fan.publish(p)["kind"] == "delta"  # the subscriber's ack stays at v1 ...
            fan._acked = {k: (fan.version, time.monotonic()) for k in fan._acked}  # ... so keep it fresh
        got = _recv(sub, 50)
        assert got is not None and sub.version == 50
        assert sub.applied == 50 and sub.stale_frames == 0 and fan.wire_drops == 0
        assert [_bits(x.numpy()) for x in tree_flatten(got).values()] == [_bits(x) for x in fan._shadow]
    finally:
        sub.close()
        fan.close()


def test_queued_pub_above_the_high_water_mark_drops_counted_and_recovers():
    """A subscriber that does not read while 12 frames of 4 MB go out
    behind a mark of 4 loses the last ones: the PUB counts them. Its ack
    then re-keys the next publish; a delta sent before the publisher
    hears it (simulated: every ack rewound to fresh) is one the subscriber
    cannot apply (counted, ``needs_resync``), and ``catch_up`` (a fetch)
    recovers it."""
    fan = ParameterFanout(wire="f32", delta=True)
    fan._pub.hwm = 4
    sub = ParameterSubscriber(fan.address, fan.ack_address, _params(n=1024))
    pub = ParameterPublisher()
    srv = ParameterServer(pub.address)
    client = None

    def publish(p):
        time.sleep(0.05)  # the acks sent so far land
        fan._drain_acks()
        fan._acked = {k: (fan.version, time.monotonic()) for k in fan._acked}  # every ack fresh: a delta
        want = "full" if fan.version == 0 else "delta"
        assert fan.publish(p)["kind"] == want
        pub.publish(p)  # the fetch fallback sees the same versions

    try:
        time.sleep(0.3)
        g = torch.Generator().manual_seed(10)
        p = _params(10, n=1024)
        publish(p)
        assert _recv(sub, 1) is not None
        _wait_acks(fan, 1)
        for _ in range(12):
            p = _step(p, g)
            publish(p)
        assert fan.wire_drops >= 1 and fan._pub.pending() <= 4 + 1
        while sub._sub.poll(500):  # what did arrive, in order
            sub.poll(timeout_ms=0)
        assert 1 <= sub.version < fan.version and sub.stale_frames == 0
        p = _step(p, g)
        publish(p)
        deadline = time.time() + 10
        while not sub.needs_resync and time.time() < deadline:
            sub.poll(timeout_ms=100)
        assert sub.stale_frames == 1 and sub.needs_resync
        client = ParameterClient(srv.address, _params(n=1024))
        deadline = time.time() + 10
        while sub.version < fan.version and time.time() < deadline:
            sub.catch_up(client)
            time.sleep(0.05)
        assert sub.fallback_fetches >= 1 and sub.version == fan.version and not sub.needs_resync
        assert all(torch.equal(sub.params[k], p[k]) for k in p)
    finally:
        if client is not None:
            client.close()
        sub.close()
        fan.close()
        srv.close()
        pub.close()


def test_push_pull_never_blocks_and_drops_without_a_peer():
    pull = Pull()
    push = Push()
    push.connect(pull.address)
    try:
        assert all(push.send(f"m{i}".encode()) for i in range(20))
        got = []
        deadline = time.time() + 5
        while len(got) < 20 and time.time() < deadline:
            if pull.poll(100):
                got.append(pull.recv())
        assert got == [f"m{i}".encode() for i in range(20)]
        with pytest.raises(Again):
            pull.recv()
        address = pull.address
        pull.close()
        time.sleep(0.05)
        t0 = time.monotonic()
        sent = [push.send(b"lost") for _ in range(3)]
        assert time.monotonic() - t0 < 1.0 and not sent[-1]  # no peer: dropped, not blocked
        pull = Pull(address)  # a Pull back at the address: the next send reconnects
        deadline = time.time() + 5
        while not push.send(b"again") and time.time() < deadline:
            time.sleep(0.05)
        assert pull.poll(2000) and pull.recv() == b"again"
    finally:
        push.close()
        pull.close()


def test_pinned_versions_hold_decodable_full_frames():
    fan = ParameterFanout(wire="bf16", delta=True)
    try:
        with pytest.raises(KeyError):
            fan.pin_version()  # nothing published
        p = _params(11)
        fan.publish(p)
        assert fan.pin_version() == 1 and fan.pin_version(1) == 1 and fan.holds == 1
        fan.publish(_step(p, torch.Generator().manual_seed(0)))
        with pytest.raises(KeyError):
            fan.pin_version(1 + 5)
        codec = FanoutCodec(_params())
        version, base, leaves = codec.decode(fan.held_frame(1), None)
        assert (version, base) == (1, 0)
        assert torch.equal(codec.to_tree(leaves)["w"], p["w"].to(torch.bfloat16).float())
        fan.release_pin(1)
        assert fan.holds == 1
        fan.release_pin(1)
        fan.release_pin(1)  # an unheld version: nothing happens
        assert fan.holds == 0 and fan.held_frame(1) is None
        assert set(fan.gauges()) == set(JaxParameterFanout.gauges(_RefGauges()))
    finally:
        fan.close()


class _RefGauges:
    """Just enough of a reference ``ParameterFanout`` for its ``gauges``."""

    frames = full_frames = delta_frames = rekeys = last_bytes = bytes_published = subscribers = holds = 0


def test_hooks_wire_fanout_into_publish_path(tmp_path):
    """``publish.fanout.enabled``: the fanout starts beside the publisher
    and server, is advertised in the discovery file, broadcasts on the
    publish cadence (bf16 wire: the subscriber holds the bf16-rounded
    acting view) and rides the ``param/*`` gauges into the metrics row;
    the view is copied to the host once for both."""
    from surreal_tpu_torch.agents import make_agent
    from surreal_tpu_torch.envs.factory import make_env
    from surreal_tpu_torch.launch.hooks import SessionHooks
    from surreal_tpu_torch.learners import build_learner
    from surreal_tpu_torch.session.config import Config
    from surreal_tpu_torch.session.default_configs import base_config

    config = Config(
        learner_config=Config(algo=Config(name="ppo", horizon=8, epochs=1, num_minibatches=1)),
        env_config=Config(name="jax:pendulum", num_envs=8),
        session_config=Config(
            folder=str(tmp_path), backend="cpu",
            publish=Config(enabled=True, every_n_iters=1, fanout=Config(enabled=True, wire="bf16", delta=False)),
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            eval=Config(every_n_iters=0), checkpoint=Config(every_n_iters=10**9),
        ),
    ).extend(base_config())
    env = make_env(config.env_config, "cpu")
    learner = build_learner(config.learner_config, env.specs, "cpu")
    state = learner.init(torch.Generator().manual_seed(0))
    hooks = SessionHooks(config, learner)
    sub = None
    try:
        info = json.load(open(tmp_path / "param_server.json"))
        assert set(info) == {"addresses", "publisher", "fanout", "fanout_ack"}
        template = make_agent(learner).acting_view(state)
        sub = ParameterSubscriber(info["fanout"], info["fanout_ack"], template)
        time.sleep(0.3)
        hooks.begin_run(0, 0)
        m, _ = hooks.end_iteration(1, 64, state, 1, {})
        assert m is not None and m["param/publishes"] == m["param/full_frames"] == 1.0
        assert m["publish/version"] == 1.0
        got = None
        deadline = time.time() + 20
        while got is None and time.time() < deadline:
            got = sub.poll(timeout_ms=100)
        assert got is not None and sub.version == 1
        want = tree_flatten(template)
        for k, a in tree_flatten(got).items():
            if want[k].is_floating_point():
                assert torch.equal(a, want[k].to(torch.bfloat16).float()), k
            else:
                assert torch.equal(a, want[k]), k
    finally:
        if sub is not None:
            sub.close()
        hooks.close()
    assert not (tmp_path / "param_server.json").exists()


def test_codec_delta_bf16_shadow_never_accumulates_error():
    """50 bf16 deltas in a row stay within one bf16 rounding step of the
    true params (the publisher deltas against its own reconstruction)."""
    rng = np.random.default_rng(8)
    true_w = rng.normal(size=(32, 32)).astype(np.float32)
    codec = FanoutCodec({"w": torch.from_numpy(true_w)})
    shadow = None
    for version in range(1, 51):
        frame, shadow_new = codec.encode(version, [true_w], wire="bf16",
                                         base_version=version - 1 if shadow is not None else 0, shadow=shadow)
        _, _, decoded = codec.decode(frame, shadow)
        np.testing.assert_array_equal(decoded[0], shadow_new[0])
        shadow = shadow_new
        np.testing.assert_allclose(shadow[0], true_w, rtol=2**-6, atol=1e-2)
        true_w = true_w + 1e-3 * rng.normal(size=(32, 32)).astype(np.float32)
