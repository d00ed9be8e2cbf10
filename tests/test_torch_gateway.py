"""The port's session gateway (``surreal_tpu_torch/gateway/``) against the
JAX package's, on the CPU:

- the codec: every ``encode_*`` byte-equal to the reference's, and each
  package decoding the other's frames;
- the session table: one scripted sequence of operations journaled by
  both packages, each journal replayed by both to the same table;
- admission: token buckets and the admission book under an injected
  clock;
- the behaviour of tests/test_gateway.py's and tests/test_loadgen.py's
  non-slow cases on a port fleet (attach, act, cache, detach on both
  transports; span and transit hops; re-attach and its credential; quota
  rejection and backpressure eviction; hostile frames; the pickle gate;
  lease expiry; version pinning and the counted catch-up; the act cache;
  the fault site's drop_frame and kill_replica; the serve thread's
  respawn; the load generator's mix and its counted rejections);
- the tenant-facing socket: a raw TCP peer writing bytes that are not the
  port's length framing is dropped without stopping the serve loop or
  other sessions.

A full SEED training run behind the gateway is ``-m slow``. Every wait is
bounded; no assertion is on speed."""

import glob
import json
import os
import pickle
import socket
import threading
import time

import numpy as np
import pytest

from surreal_tpu.gateway import protocol as jax_gw
from surreal_tpu.gateway.admission import AdmissionController as JaxAdmission
from surreal_tpu.gateway.table import SessionRecord as JaxRecord
from surreal_tpu.gateway.table import SessionTable as JaxTable
from surreal_tpu_torch.distributed import InferenceFleet
from surreal_tpu_torch.distributed.shm_transport import SLAB_PREFIX
from surreal_tpu_torch.distributed.sockets import parse_tcp
from surreal_tpu_torch.gateway import GatewayError, GatewayServer, GatewaySession
from surreal_tpu_torch.gateway import protocol as gw
from surreal_tpu_torch.gateway.admission import AdmissionController, TokenBucket
from surreal_tpu_torch.gateway.loadgen import PROFILES, LoadGenerator, default_mix
from surreal_tpu_torch.gateway.table import SessionRecord, SessionTable
from surreal_tpu_torch.session.config import Config
from surreal_tpu_torch.session.costs import GAUGE_REGISTRY
from surreal_tpu_torch.session.default_configs import base_config
from surreal_tpu_torch.utils import faults


@pytest.fixture(autouse=True)
def _reset_registry():
    faults.configure(None)
    yield
    faults.configure(None)  # never leak a plan into the next test


def _act_fn(obs):
    b = obs.shape[0]
    return np.random.randint(0, 2, size=b), {"logp": np.full(b, -np.log(2), np.float32)}


def _versioned_act_fn(v):
    """An act function whose output names the version that served it: the
    pinning tests read the action values as the witness of the served
    version, independent of the reply header."""
    def fn(obs):
        return np.full(obs.shape[0], v, np.int64), {}
    return fn


def _stack(act_fn=_act_fn, fleet_kw=None, **server_kw):
    fleet = InferenceFleet(act_fn, num_workers=2, replicas=2, unroll_length=4, **(fleet_kw or {}))
    server_kw.setdefault("lease_s", 30.0)
    return fleet, GatewayServer(fleet, **server_kw)


def _close(fleet, server):
    server.close()
    fleet.close()


def _recv_until(sess, want, timeout_s=10.0):
    """Decoded frames from a session's own socket until ``want(kind, obj)``."""
    deadline = time.monotonic() + timeout_s
    while time.monotonic() < deadline:
        if not sess._sock.poll(200):
            continue
        kind, obj = gw.decode_payload(sess._sock.recv())
        if want(kind, obj):
            return kind, obj
    return None


def _wait(cond, timeout_s=10.0):
    """``cond()``'s first truthy value within ``timeout_s``, else its last."""
    deadline = time.monotonic() + timeout_s
    while True:
        got = cond()
        if got or time.monotonic() >= deadline:
            return got
        time.sleep(0.02)


# -- the codec ---------------------------------------------------------------

_SID = "0123456789abcdef"
_OBS = np.arange(12, dtype=np.float32).reshape(3, 4)
_ENCODERS = {
    "hello": lambda m: m.encode_hello("alpha", session=_SID, token="tok", obs_shape=(3, 4), obs_dtype="<f4",
                                      transport="pickle", pin_version=7, trace="tr", caps=("trace", "b")),
    "hello_default": lambda m: m.encode_hello("beta"),
    "hello_ok": lambda m: m.encode_hello_ok(_SID, 30.0, "tcp", 1, pinned_version=3, token="tok"),
    "hello_no": lambda m: m.encode_hello_no("tenant 'x' at session quota (1/1)"),
    "act": lambda m: m.encode_act(_SID, 2**32 + 5, _OBS, span=9, t_send=1.25),
    "act_ok": lambda m: m.encode_act_ok(11, 2**40, np.array([[1, 0], [0, 1]], np.int64), flags=3, t_send=2.5),
    "act_err": lambda m: m.encode_act_err(4, "unknown session", _SID),
    "detach": lambda m: m.encode_detach(_SID),
    "detach_ok": lambda m: m.encode_detach_ok(_SID, 12),
    "journal": lambda m: m.encode_journal({"op": "rebind", "session": _SID, "replica": 1}),
}


@pytest.mark.parametrize("name", sorted(_ENCODERS))
def test_every_frame_is_byte_equal_to_the_reference(name):
    ours, theirs = _ENCODERS[name](gw), _ENCODERS[name](jax_gw)
    assert ours == theirs
    (k1, o1), (k2, o2) = gw.decode_payload(ours), jax_gw.decode_payload(theirs)
    assert k1 == k2
    if "body" in o1:
        assert bytes(o1.pop("body")) == bytes(o2.pop("body"))
    assert o1 == o2


def test_pickle_envelope_and_act_reply_decode_across_packages():
    """PMSG: the id in the clear, then the dict's pickle (protocol 5), equal
    bytes; each package's decode_act_ok reads the other's reply."""
    msg = {"kind": "act", "seq": 3, "span": 1, "obs": _OBS, "t_send": 0.0}
    assert gw.encode_pickle_act(_SID, msg) == jax_gw.encode_pickle_act(_SID, msg)
    kind, obj = gw.decode_payload(jax_gw.encode_pickle_act(_SID, msg))
    assert kind == "pmsg" and obj["session"] == _SID
    np.testing.assert_array_equal(gw.decode_pickle_body(obj["body"])["obs"], _OBS)
    actions = np.array([0.5, -1.0], np.float32)
    for enc, dec in ((gw, jax_gw), (jax_gw, gw)):
        got, info = dec.decode_act_ok(dec.decode_payload(enc.encode_act_ok(8, 5, actions, flags=gw.F_UNPINNED))[1])
        np.testing.assert_array_equal(got, actions)
        assert info == {"param_version": 5, "cached": False, "unpinned": True}
    assert (gw.MAGIC, gw.SID_BYTES, gw.F_CACHED, gw.F_UNPINNED) == (
        jax_gw.MAGIC, jax_gw.SID_BYTES, jax_gw.F_CACHED, jax_gw.F_UNPINNED)
    with pytest.raises(ValueError, match="MAGIC"):
        gw.decode_payload(pickle.dumps({}))
    with pytest.raises(ValueError, match="16 bytes"):
        gw.encode_act("short", 1, _OBS)


# -- the session table ---------------------------------------------------------

def _scripted(table_cls, record_cls):
    table = table_cls()
    for i in range(5):
        table.attach(record_cls(f"sid{i:012d}epog", f"t{i % 2}", i % 3, transport="pickle" if i == 4 else "tcp",
                                pinned_version=2 if i == 1 else None))
    table.pin("sid000000000000epog", 5)
    table.rebind(1, lambda sid: 2)
    table.detach("sid000000000003epog")
    table.pin("sid000000000001epog", None)
    for i in range(70):  # enough churn to compact the journal once
        table.attach(record_cls(f"chr{i:09d}epog", "churn", 0))
        table.detach(f"chr{i:09d}epog")
    table.rebind(0, lambda sid: 1)
    return table


def _table_view(table):
    return {r.session: (r.tenant, r.replica, r.pinned_version, r.transport, r.last_act_seq) for r in table.records()}


def test_journal_frames_and_replays_match_the_reference():
    """One scripted sequence (attaches, pins, rebinds, detaches, enough
    churn to compact): the two journals are equal frame for frame, and
    each replays, in either package, to the live table."""
    ours, theirs = _scripted(SessionTable, SessionRecord), _scripted(JaxTable, JaxRecord)
    assert ours.journal() == theirs.journal()
    assert ours.migrations == theirs.migrations == 3
    want = _table_view(ours)
    assert want == _table_view(theirs)
    for replay in (SessionTable.replay, JaxTable.replay):
        assert _table_view(replay(ours.journal())) == want


def test_session_table_journal_replays_and_self_compacts():
    table = SessionTable()
    for i in range(4):
        table.attach(SessionRecord(f"sid{i:012d}epog", "acme", i % 2))
    table.pin("sid000000000000epog", 5)
    table.rebind(1, lambda sid: 0)
    table.detach("sid000000000003epog")
    frames = [bytes(f) for f in table.journal()]
    replayed = SessionTable.replay(frames)
    assert {r.session for r in replayed.records()} == {r.session for r in table.records()}
    for rec in table.records():
        twin = replayed.get(rec.session)
        assert (twin.replica, twin.tenant, twin.pinned_version) == (rec.replica, rec.tenant, rec.pinned_version)
    assert all(r.replica == 0 for r in replayed.records())
    for i in range(300):
        sid = f"churn{i:08d}epog"[:16]
        table.attach(SessionRecord(sid, "acme", 0))
        table.detach(sid)
    assert len(table.journal()) <= max(SessionTable._COMPACT_FACTOR * len(table.records()), 64) + 1
    with pytest.raises(ValueError, match="not a journal frame"):
        SessionTable.replay([gw.encode_detach("x")])


# -- admission under an injected clock -----------------------------------------

def test_token_bucket_under_an_injected_clock():
    b = TokenBucket(rate=2.0, burst=3.0, now=100.0)
    assert [b.try_take(100.0) for _ in range(4)] == [True, True, True, False]
    assert not b.try_take(100.4)        # 0.8 tokens
    assert b.try_take(100.5)            # 1.0 token
    assert not b.try_take(100.5)
    assert b.try_take(110.0) and b.tokens == pytest.approx(2.0)  # refill capped at the burst
    assert all(TokenBucket(rate=0.0, burst=1.0).try_take(0.0) for _ in range(5))  # rate 0: unlimited


def test_admission_book_matches_the_reference_under_an_injected_clock(monkeypatch):
    """The same quota book and the same act stream at the same instants:
    the reference (its clock patched to the instants) and the port (given
    them) admit, throttle, queue, evict and drain alike."""
    from types import SimpleNamespace

    import surreal_tpu.gateway.admission as jax_admission

    quotas = {"default": {"rate": 4.0, "burst": 2.0, "queue_depth": 2}, "vip": {"rate": 0.0, "max_sessions": 1}}
    clock = [50.0]
    monkeypatch.setattr(jax_admission, "time", SimpleNamespace(monotonic=lambda: clock[0]))
    ours, theirs = AdmissionController(quotas, max_sessions_total=3), JaxAdmission(quotas, max_sessions_total=3)
    log = {id(ours): [], id(theirs): []}
    for t in (50.0, 50.0, 50.0, 50.05, 50.1, 50.3, 50.35, 51.0, 51.0):
        clock[0] = t
        for book, kw in ((ours, {"now": t}), (theirs, {})):
            out = log[id(book)]
            for tenant in ("a", "vip"):
                if book.try_act(tenant, **kw):
                    out.append(("served", tenant))
                else:
                    out.append(("evicted", book.enqueue(tenant, (tenant, t))))
                out.append(("drained", book.drain(tenant, **kw)))
    assert log[id(ours)] == log[id(theirs)]
    assert ours.gauges() == theirs.gauges()
    assert ours.gauges()["gateway/throttled_acts"] > 0 and ours.gauges()["gateway/evicted_requests"] > 0
    for book in (ours, theirs):
        assert book.admit_session("vip", 1, 1) is not None and book.admit_session("a", 5, 3) is not None
    assert ours.gauges() == theirs.gauges()
    assert ours.set_quota("a", {"rate": 1.0}, now=60.0) == theirs.set_quota("a", {"rate": 1.0})


# -- the live gateway on a port fleet ----------------------------------------------

def test_gateway_attach_act_detach_roundtrip_both_transports():
    fleet, server = _stack()
    try:
        obs = np.arange(8, dtype=np.float32).reshape(2, 4)
        s1 = GatewaySession(server.address, tenant="alpha", obs_shape=(2, 4))
        assert len(s1.session) == gw.SID_BYTES
        assert s1.lease_s == pytest.approx(30.0)
        a1, info1 = s1.act(obs)
        assert a1.shape == (2,)
        assert info1["cached"] is False and info1["unpinned"] is False
        a2, info2 = s1.act(obs)  # same obs, same version: the cache answers
        assert info2["cached"] is True
        np.testing.assert_array_equal(a1, a2)
        s2 = GatewaySession(server.address, tenant="beta", obs_shape=(2, 4), transport="pickle")
        a3, info3 = s2.act(obs * 3)
        assert a3.shape == (2,) and info3["param_version"] == fleet.version
        assert server.gauges()["gateway/sessions"] == 2.0
        assert server.hop_stats()["gateway_act_ms"]["p50"] >= 0.0
        stats = server.tenant_stats()
        assert stats["alpha"]["sessions"] == 1 and stats["beta"]["sessions"] == 1
        s1.close()
        s2.close()
        assert _wait(lambda: server.gauges()["gateway/sessions"] == 0.0)
        g = server.gauges()
        assert (g["gateway/attaches"], g["gateway/detaches"], g["gateway/acts"]) == (2.0, 2.0, 3.0)
        assert (g["gateway/cache_hits"], g["gateway/cache_misses"]) == (1.0, 2.0)
        assert server.event()["cache_hit_rate"] == pytest.approx(1 / 3)
        assert set(g) <= set(GAUGE_REGISTRY)
    finally:
        _close(fleet, server)


def test_gateway_act_frames_stamp_span_and_transit_hops():
    fleet, server = _stack()
    try:
        s1 = GatewaySession(server.address, obs_shape=(1, 4))
        assert s1._stamp_clock is True  # tcp://127.0.0.1 shares the clock
        for _ in range(3):
            s1.act(np.random.rand(1, 4).astype(np.float32))
        assert s1._span == 3
        s2 = GatewaySession(server.address, obs_shape=(1, 4), transport="pickle")
        s2.act(np.random.rand(1, 4).astype(np.float32))
        hops = server.hop_stats()
        assert hops["gateway_transit_ms"]["n"] == 4 and hops["gateway_transit_ms"]["p99"] >= 0.0
        assert hops["gateway_attach_ms"]["n"] == 2
        s1.close()
        s2.close()
    finally:
        _close(fleet, server)


def test_gateway_reattach_keeps_binding_and_quota():
    fleet, server = _stack()
    try:
        s1 = GatewaySession(server.address, obs_shape=(1, 4))
        sid, token, replica = s1.session, s1.token, s1.replica
        assert token
        s1._sock.close()  # vanish without detaching
        s2 = GatewaySession(server.address, session=sid, token=token, obs_shape=(1, 4))
        assert (s2.session, s2.replica, s2.token) == (sid, replica, token)
        assert server.reattaches == 1 and server.attaches == 1
        assert server.gauges()["gateway/sessions"] == 1.0
        s2.close()
    finally:
        _close(fleet, server)


def test_gateway_reattach_requires_tenant_and_token():
    fleet, server = _stack()
    try:
        victim = GatewaySession(server.address, tenant="alpha", obs_shape=(2, 4))
        sid, token = victim.session, victim.token
        spec_before = server._obs_specs[sid]
        with pytest.raises(GatewayError, match="resume denied"):
            GatewaySession(server.address, tenant="alpha", session=sid, obs_shape=(9, 9))
        with pytest.raises(GatewayError, match="resume denied"):
            GatewaySession(server.address, tenant="mallory", session=sid, token=token, obs_shape=(9, 9))
        assert server._obs_specs[sid] == spec_before
        assert server.reattaches == 0
        assert server.gauges()["gateway/rejected_sessions"] == 2.0
        s2 = GatewaySession(server.address, tenant="alpha", session=sid, token=token, obs_shape=(2, 4))
        assert s2.session == sid and server.reattaches == 1
        s2.act(np.zeros((2, 4), np.float32))
        s2.close()
        victim._sock.close()
    finally:
        _close(fleet, server)


def test_gateway_quota_rejection_and_backpressure_eviction_counted():
    fleet, server = _stack(tenant_quotas={"default": {"max_sessions": 1, "rate": 0.5, "burst": 1, "queue_depth": 2}})
    try:
        sess = GatewaySession(server.address, obs_shape=(1, 2))
        with pytest.raises(GatewayError, match="session quota"):
            GatewaySession(server.address, obs_shape=(1, 2))
        assert server.gauges()["gateway/rejected_sessions"] == 1.0
        # 4 raw acts back to back: the burst token covers #1, #2 and #3
        # wait, #4 overflows and evicts #2 with an ACT_ERR
        obs = np.zeros((1, 2), np.float32)
        for seq in range(1, 5):
            sess._sock.send(gw.encode_act(sess.session, seq, obs + seq))
        got = {}
        deadline = time.monotonic() + 10
        while len(got) < 4 and time.monotonic() < deadline:
            if sess._sock.poll(1000):
                kind, obj = gw.decode_payload(sess._sock.recv())
                got[int(obj["seq"])] = kind
        assert got == {1: "act_ok", 2: "act_err", 3: "act_ok", 4: "act_ok"}
        g = server.gauges()
        assert g["gateway/throttled_acts"] >= 3.0 and g["gateway/evicted_requests"] == 1.0
        sess.close()
    finally:
        _close(fleet, server)


_PICKLE_TRIPPED = []


def _trip_canary():
    # unpickling tenant bytes would run this; the tests hold it empty
    _PICKLE_TRIPPED.append(True)
    return {}


class _PickleCanary:
    def __reduce__(self):
        return (_trip_canary, ())


def test_gateway_serve_loop_survives_malformed_and_hostile_frames():
    fleet, server = _stack()
    try:
        sess = GatewaySession(server.address, obs_shape=(1, 2))
        hostile = [
            b"",
            b"garbage that is not a gateway frame",
            pickle.dumps(_PickleCanary()),
            gw.MAGIC,
            gw.MAGIC + bytes([gw.ACT]) + b"\x01",
            gw.MAGIC + bytes([gw.ACT_ERR]) + b"{not json",
            gw.MAGIC + bytes([123]),
            gw.MAGIC + bytes([gw.PMSG]) + b"short",
            # a PMSG naming a session that negotiated tcp: never unpickled
            gw.MAGIC + bytes([gw.PMSG]) + sess.session.encode() + pickle.dumps(_PickleCanary()),
        ]
        for frame in hostile:
            sess._sock.send(frame)
        sess._sock.send(gw.encode_act(sess.session, 77, np.zeros(9, np.float32)))
        got = _recv_until(sess, lambda k, o: k == "act_err" and o["seq"] == 77)
        assert got is not None and "bad obs body" in got[1]["reason"]
        assert not _PICKLE_TRIPPED, "tenant bytes were unpickled"
        assert server.alive and server.respawns == 0
        assert server.gauges()["gateway/bad_frames"] >= 9.0
        actions, _ = sess.act(np.zeros((1, 2), np.float32))
        assert actions.shape == (1,)
        sess.close()
    finally:
        _close(fleet, server)


def test_raw_socket_garbage_peer_is_dropped_and_the_loop_serves_on():
    """A plain TCP client writing bytes that are not the length framing
    (text, random bytes, a declared length past the bound, a well-formed
    identity followed by an oversized frame) is dropped by the ROUTER; the
    serve loop, and a session attached before and after, serve on."""
    fleet, server = _stack()
    try:
        sess = GatewaySession(server.address, obs_shape=(1, 2))
        host, port = parse_tcp(server.address)
        rng = np.random.default_rng(0)
        garbage = [
            b"GET / HTTP/1.1\r\nHost: gateway\r\n\r\n",
            rng.integers(0, 256, 4096, dtype=np.uint8).tobytes(),
            (2**31).to_bytes(4, "little") + b"x" * 64,
            (5).to_bytes(4, "little") + b"rogue" + (2**30).to_bytes(4, "little") + b"y" * 64,
        ]
        closed = 0
        for data in garbage:
            with socket.create_connection((host, port), timeout=5) as raw:
                raw.sendall(data)
                try:
                    closed += raw.recv(16) == b""  # the server closed the connection
                except (ConnectionResetError, TimeoutError):
                    closed += 1
            actions, _ = sess.act(rng.normal(size=(1, 2)).astype(np.float32))
            assert actions.shape == (1,)
        assert closed == len(garbage)
        assert server.alive and server.respawns == 0
        late = GatewaySession(server.address, obs_shape=(1, 2))
        late.act(np.zeros((1, 2), np.float32))
        late.close()
        sess.close()
    finally:
        _close(fleet, server)


def test_gateway_pickle_fallback_is_gated_per_session():
    fleet, server = _stack()
    try:
        sess = GatewaySession(server.address, obs_shape=(1, 2), transport="pickle")
        a, _ = sess.act(np.zeros((1, 2), np.float32))
        assert a.shape == (1,)
        sess._sock.send(gw.MAGIC + bytes([gw.PMSG]) + sess.session.encode() + b"\x00not a pickle")
        got = _recv_until(sess, lambda k, o: k == "act_err")
        assert got is not None and "undecodable" in got[1]["reason"]
        assert server.gauges()["gateway/bad_frames"] >= 1.0
        a, _ = sess.act(np.ones((1, 2), np.float32))
        assert a.shape == (1,)
        sess.close()
    finally:
        _close(fleet, server)


def test_gateway_lease_expiry_reaps_silent_sessions():
    fleet, server = _stack(lease_s=0.3)
    try:
        sess = GatewaySession(server.address, obs_shape=(1, 2))
        sess.act(np.zeros((1, 2), np.float32))
        assert _wait(lambda: len(server.table) == 0)
        g = server.gauges()
        assert g["gateway/sessions"] == 0.0 and g["gateway/expired_leases"] == 1.0
        with pytest.raises(GatewayError, match="unknown session"):
            sess.act(np.zeros((1, 2), np.float32))
        sess._sock.close()
    finally:
        _close(fleet, server)


def test_gateway_version_pinning_and_counted_catch_up():
    fleet, server = _stack(_versioned_act_fn(0), fleet_kw={"act_history": 2})
    try:
        fleet.set_act_fn(_versioned_act_fn(1))
        assert 0 in fleet.held_versions()
        pinned = GatewaySession(server.address, tenant="pinned", obs_shape=(1, 3), pin_version=0)
        assert pinned.pinned_version == 0
        fresh = GatewaySession(server.address, tenant="fresh", obs_shape=(1, 3))
        obs = np.ones((1, 3), np.float32)
        a_pin, info_pin = pinned.act(obs)
        assert info_pin["param_version"] == 0 and a_pin[0] == 0  # the held v0 act function served
        a_new, info_new = fresh.act(obs * 2)
        assert info_new["param_version"] == 1 and a_new[0] == 1
        assert server.gauges()["gateway/pinned_sessions"] == 1.0
        with pytest.raises(GatewayError, match="not held"):
            GatewaySession(server.address, obs_shape=(1, 3), pin_version=99)
        fleet.set_act_fn(_versioned_act_fn(2))
        fleet.set_act_fn(_versioned_act_fn(3))
        assert 0 not in fleet.held_versions()
        a_cu, info_cu = pinned.act(obs * 5)
        assert info_cu["unpinned"] is True and info_cu["param_version"] == fleet.version and a_cu[0] == 3
        g = server.gauges()
        assert g["gateway/catch_ups"] == 1.0 and g["gateway/pinned_sessions"] == 0.0
        pinned.close()
        fresh.close()
    finally:
        _close(fleet, server)


def test_gateway_act_cache_is_version_keyed_and_bounded():
    fleet, server = _stack(_versioned_act_fn(0), act_cache=4)
    try:
        sess = GatewaySession(server.address, obs_shape=(1, 2))
        obs = np.full((1, 2), 7, np.float32)
        a0, _ = sess.act(obs)
        _, info = sess.act(obs)
        assert info["cached"] is True
        fleet.set_act_fn(_versioned_act_fn(1))
        a1, info = sess.act(obs)
        assert info["cached"] is False and a1[0] == 1 and a0[0] == 0
        for i in range(8):
            sess.act(np.full((1, 2), 100 + i, np.float32))
        assert len(server._cache) <= 4
        sess.close()
    finally:
        _close(fleet, server)


def test_gateway_act_cache_purges_dead_pin_entries():
    fleet, server = _stack(_versioned_act_fn(0), fleet_kw={"act_history": 2})
    try:
        fleet.set_act_fn(_versioned_act_fn(1))
        sess = GatewaySession(server.address, obs_shape=(1, 3), pin_version=0)
        obs = np.ones((1, 3), np.float32)
        a0, info = sess.act(obs)
        assert a0[0] == 0 and info["param_version"] == 0
        _, info = sess.act(obs)
        assert info["cached"] is True and info["param_version"] == 0
        fleet.set_act_fn(_versioned_act_fn(2))
        fleet.set_act_fn(_versioned_act_fn(3))
        a_cu, info_cu = sess.act(obs)
        assert info_cu["cached"] is False and info_cu["unpinned"] is True
        assert a_cu[0] == 3 and info_cu["param_version"] == fleet.version
        assert server.gauges()["gateway/catch_ups"] == 1.0
        assert not any(k[0] == 0 for k in server._cache)
        sess.close()
    finally:
        _close(fleet, server)


def test_gateway_chaos_drop_frame_client_resend_recovers():
    fleet, server = _stack()
    try:
        sess = GatewaySession(server.address, obs_shape=(1, 2), timeout_s=4.0, retries=4)
        faults.configure([{"site": "gateway.session", "kind": "drop_frame", "at": 0}])
        assert _wait(lambda: faults.get().drain_fired())  # fires on the next loop pass
        actions, _ = sess.act(np.zeros((1, 2), np.float32))
        assert actions.shape == (1,) and sess.resends >= 1
        assert server.gauges()["gateway/dropped_replies"] == 1.0
        sess.close()
    finally:
        _close(fleet, server)


def test_gateway_fault_site_fires_under_sustained_load():
    """A tenant flooding ACT frames without waiting for replies keeps the
    inbox from emptying: the loop still reaches its fault site (and its
    heal, reap and drain) every pass, so a ``drop_frame`` configured
    mid-flood fires within a second."""
    fleet, server = _stack()
    stop = threading.Event()
    sess = GatewaySession(server.address, tenant="flood", obs_shape=(1, 2))

    def flood():
        seq = 1
        while not stop.is_set():
            sess._sock.send(gw.encode_act(sess.session, seq, np.full((1, 2), seq % 7, np.float32)))
            seq += 1
            while sess._sock.poll(0):
                sess._sock.recv()

    t = threading.Thread(target=flood, daemon=True)
    try:
        t.start()
        assert _wait(lambda: server.acts > 200)
        faults.configure([{"site": "gateway.session", "kind": "drop_frame", "at": 0}])
        assert _wait(lambda: faults.get().drain_fired(), 1.0), "the loop never reached its fault site"
        assert _wait(lambda: server.dropped_replies == 1, 5.0)
    finally:
        stop.set()
        t.join(timeout=10)
        sess._sock.close()
        _close(fleet, server)


def _slabs():
    """This process's slabs in /dev/shm (a slab's name carries the pid of
    its maker), not those of tests running beside this one."""
    return glob.glob(f"/dev/shm/{SLAB_PREFIX}*_{os.getpid()}_*")


def test_gateway_chaos_kill_replica_migrates_every_session():
    """Kill a replica with live sessions bound to it: every one migrates
    to the survivor (the count equals the migrations gauge), every
    tenant's next act serves, the fleet respawns the replica in place,
    and three cycles leave no fd or slab residue."""
    slabs_before = set(_slabs())
    fd_counts = []
    for _ in range(3):
        fleet = InferenceFleet(_act_fn, num_workers=4, replicas=2, unroll_length=4, respawn_backoff_s=0.01)
        server = GatewayServer(fleet, lease_s=30.0)
        sessions = []
        try:
            for i in range(24):
                sessions.append(GatewaySession(server.address, tenant=f"t{i % 2}", obs_shape=(1, 3),
                                               timeout_s=6.0, retries=4))
                if len(sessions) >= 4 and {server.table.get(s.session).replica for s in sessions} == {0, 1}:
                    break
            obs = np.zeros((1, 3), np.float32)
            for i, s in enumerate(sessions):
                s.act(obs + i)
            bound = {s.session: server.table.get(s.session).replica for s in sessions}
            assert set(bound.values()) == {0, 1}
            faults.configure([{"site": "gateway.session", "kind": "kill_replica", "at": 0}])
            assert _wait(lambda: len(fleet._alive_slots()) == 1), "kill never fired"
            faults.configure(None)
            (survivor,) = fleet._alive_slots()
            n_victims = sum(1 for r in bound.values() if r != survivor)
            assert n_victims >= 1
            for i, s in enumerate(sessions):
                actions, _ = s.act(obs + 10 + i)
                assert actions.shape == (1,)
            assert server.table.migrations == n_victims == server.gauges()["gateway/migrations"]
            assert all(server.table.get(s.session).replica == survivor for s in sessions)
            time.sleep(0.05)
            fleet.supervise()
            assert len(fleet._alive_slots()) == 2 and fleet.respawns == 1
        finally:
            faults.configure(None)
            for s in sessions:
                s.close()
            _close(fleet, server)
        fd_counts.append(len(os.listdir("/proc/self/fd")))
    assert fd_counts[2] <= fd_counts[0] + 2, fd_counts
    assert set(_slabs()) <= slabs_before, "gateway cycles leaked shm"


def test_gateway_supervise_respawns_serve_thread_in_place():
    fleet, server = _stack(respawn_backoff_s=0.01)
    try:
        sess = GatewaySession(server.address, obs_shape=(1, 2))
        sess.act(np.zeros((1, 2), np.float32))
        server._stop.set()  # the serve thread ends (close() would end the table too)
        server._thread.join(timeout=5)
        assert not server.alive
        server._stop.clear()
        time.sleep(0.02)
        server.supervise()
        assert server.alive and server.respawns == 1
        assert server.respawn_backoff_s == pytest.approx(0.01)
        actions, _ = sess.act(np.ones((1, 2), np.float32))  # the session's DEALER reconnects
        assert actions.shape == (1,)
        sess.close()
    finally:
        _close(fleet, server)


def test_gateway_refuses_an_ops_address():
    fleet = InferenceFleet(_act_fn, num_workers=1, replicas=2, unroll_length=4)
    try:
        with pytest.raises(NotImplementedError, match="ops plane"):
            GatewayServer(fleet, ops_address="tcp://127.0.0.1:1")
    finally:
        fleet.close()


# -- the load generator ---------------------------------------------------------

def test_default_mix_is_production_shaped():
    mix = default_mix(n_steady=3)
    assert sum(1 for s in mix if s["profile"] == "steady") == 3
    assert {s["profile"] for s in mix} == set(PROFILES)
    names = [s["tenant"] for s in mix]
    assert len(names) == len(set(names))
    from surreal_tpu.gateway.loadgen import default_mix as jax_default_mix

    assert mix == jax_default_mix(n_steady=3)


def test_unknown_profile_fails_fast():
    with pytest.raises(ValueError, match="unknown loadgen profile"):
        LoadGenerator("tcp://127.0.0.1:1", tenants=[{"tenant": "x", "profile": "stampede"}])


def test_loadgen_mix_drives_live_gateway_every_outcome_counted():
    fleet, server = _stack(tenant_quotas={
        "bursty": {"rate": 10.0, "burst": 2.0, "queue_depth": 2},
        "hotkey": {"rate": 50.0, "burst": 5.0, "queue_depth": 4},
    })
    gen = LoadGenerator(server.address, tenants=[
        {"tenant": "steady-0", "profile": "steady", "rate_hz": 40.0},
        {"tenant": "churner", "profile": "attach_storm", "acts_per_life": 1},
        {"tenant": "hotkey", "profile": "hot_key"},
        {"tenant": "bursty", "profile": "act_burst", "burst_n": 16, "idle_s": 0.1},
        {"tenant": "mallory", "profile": "adversarial", "rate_hz": 100.0},
    ], obs_shape=(1, 4), timeout_s=3.0, retries=2)
    events = []
    gen._on_event = lambda type_, **kw: events.append({"type": type_, **kw})
    try:
        gen.start()
        time.sleep(1.5)
    finally:
        rep = gen.stop()
        _close(fleet, server)
    assert all(t["error"] is None for t in rep["tenants"].values()), rep
    g = gen.gauges()
    assert g["loadgen/acts"] > 0 and g["loadgen/attaches"] >= 4 and g["loadgen/act_rtt_ms"] > 0.0
    churner = rep["tenants"]["churner"]
    assert churner["attaches"] >= 2 and churner["detaches"] >= 2
    assert g["loadgen/hostile_frames"] > 0 and server.gauges()["gateway/bad_frames"] > 0
    assert server.admission.throttled_acts > 0
    assert [e["type"] for e in events] == ["loadgen"]
    assert events[0]["tenants"]["hotkey"]["profile"] == "hot_key"
    assert set(g) <= set(GAUGE_REGISTRY)


def test_loadgen_rejected_attaches_are_counted_not_fatal():
    fleet, server = _stack(tenant_quotas={"churner": {"max_sessions": 1}})
    pin = GatewaySession(server.address, tenant="churner", obs_shape=(1, 4))
    gen = LoadGenerator(server.address, tenants=[{"tenant": "churner", "profile": "attach_storm",
                                                  "acts_per_life": 1}], obs_shape=(1, 4), timeout_s=2.0)
    try:
        gen.start()
        time.sleep(0.8)
    finally:
        rep = gen.stop()
        pin.close()
        _close(fleet, server)
    assert rep["loadgen/rejected"] > 0, rep
    assert rep["tenants"]["churner"]["error"] is None
    assert server.gauges()["gateway/rejected_sessions"] > 0


# -- the gateway on the SEED fleet ----------------------------------------------

def _seed_gateway_cfg(folder, total):
    return Config(
        learner_config=Config(algo=Config(name="impala", horizon=8)),
        env_config=Config(name="gym:CartPole-v1", num_envs=4),
        session_config=Config(
            folder=str(folder), total_env_steps=total,
            metrics=Config(every_n_iters=1, tensorboard=False, console=False),
            checkpoint=Config(every_n_iters=0), eval=Config(every_n_iters=0),
            topology=Config(num_env_workers=2, inference_fleet=Config(replicas=2),
                            gateway=Config(enabled=True, lease_s=10.0)),
        ),
    ).extend(base_config())


def test_seed_trainer_runs_the_gateway_on_its_fleet(tmp_path):
    """A short SEED IMPALA run with ``topology.gateway.enabled``: the
    gateway is live on the fleet while training (an external session acts
    on the live policy through the discovery file), its gauges ride the
    metrics rows, a ``gateway`` event and the ``hops`` windows are
    written, and the discovery file is gone after the run."""
    from surreal_tpu_torch.launch.seed_trainer import SEEDTrainer
    from surreal_tpu_torch.session.telemetry import _iter_jsonl

    trainer = SEEDTrainer(_seed_gateway_cfg(tmp_path, 8 * 2 * 6), device="cpu")
    acts, stop = [], threading.Event()

    def tenant():
        path = os.path.join(str(tmp_path), "gateway.json")
        if not _wait(lambda: os.path.exists(path) or stop.is_set(), 60):
            return
        with open(path) as f:
            address = json.load(f)["address"]
        # a short timeout: the detach at the end waits it out against the
        # closed gateway
        sess = GatewaySession(address, tenant="external", obs_shape=(1, 4), timeout_s=2.0)
        while not stop.is_set():
            try:
                _, info = sess.act(np.random.rand(1, 4).astype(np.float32))
            except TimeoutError:
                continue  # a replica's first act counts its costs for a while, holding the slot's lock
            acts.append(info["param_version"])
            time.sleep(0.02)
        sess.close()

    def tenant_checked():
        try:
            tenant()
        except Exception as e:  # raised in the test below
            acts_error.append(e)

    acts_error = []
    t = threading.Thread(target=tenant_checked, daemon=True)
    t.start()
    orig_learn = trainer._learn

    def paced(*a, **kw):  # the tenant must act during the run
        _wait(lambda: len(acts) >= 2, 10)
        return orig_learn(*a, **kw)

    trainer._learn = paced
    try:
        _, metrics = trainer.run()
    finally:
        stop.set()
        t.join(timeout=15)
    assert not acts_error, acts_error
    assert acts, "the external tenant got no act served"
    assert metrics["gateway/acts"] >= 1.0 and metrics["gateway/attaches"] == 1.0
    assert not os.path.exists(os.path.join(str(tmp_path), "gateway.json"))
    events = list(_iter_jsonl(os.path.join(str(tmp_path), "telemetry", "events.jsonl")))
    gw_events = [e for e in events if e["type"] == "gateway"]
    assert gw_events and "external" in gw_events[-1]["tenants"]
    hops = [e for e in events if e["type"] == "hops"]
    assert hops and "gateway_act_ms" in hops[-1]


@pytest.mark.slow
def test_gateway_rides_training_run_end_to_end(tmp_path):
    """The reference's end-to-end case on the port: a SEED run of 600 env
    steps with the gateway on serves an external tenant while training, the
    versions advancing under it."""
    from surreal_tpu_torch.launch.seed_trainer import SEEDTrainer

    trainer = SEEDTrainer(_seed_gateway_cfg(tmp_path, 600), device="cpu")
    tenant_acts, stop = [], threading.Event()

    def tenant_loop():
        if not _wait(lambda: getattr(trainer, "_gateway", None) is not None, 60):
            return
        sess = GatewaySession(trainer._gateway.address, tenant="external", obs_shape=(1, 4), timeout_s=10.0)
        while not stop.is_set():
            try:
                _, info = sess.act(np.random.rand(1, 4).astype(np.float32))
            except (TimeoutError, GatewayError):
                break
            tenant_acts.append(int(info["param_version"]))
            time.sleep(0.05)
        sess.close()

    t = threading.Thread(target=tenant_loop, daemon=True)
    t.start()
    try:
        _, metrics = trainer.run()
    finally:
        stop.set()
        t.join(timeout=15)
    assert metrics["time/env_steps"] >= 600
    assert tenant_acts and max(tenant_acts) > 0
    assert metrics["gateway/acts"] >= 1.0
    assert not _slabs()
