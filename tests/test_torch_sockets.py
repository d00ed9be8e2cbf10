"""The port's standard-library ROUTER/DEALER pair (``distributed/sockets.py``),
the SEED wire in place of zmq: framing, identity routing, the identity
handover on reconnect, the send and poll timeouts, and a ROUTER that a
peer which stops reading cannot stall. Every wait is bounded."""

import numpy as np
import pytest

from surreal_tpu_torch.distributed.sockets import Again, Dealer, Router, _frame, _Frames, parse_tcp


def _recv(router: Router, timeout_ms: float = 5000):
    assert router.poll(timeout_ms), "the router received nothing"
    return router.recv_multipart()


def _reply(dealer: Dealer, timeout_ms: float = 5000) -> bytes:
    assert dealer.poll(timeout_ms), "the dealer received nothing"
    return dealer.recv()


@pytest.fixture
def router():
    r = Router("tcp://127.0.0.1:*")
    yield r
    r.close()


def _dealer(router: Router, ident: bytes, send_timeout_s: float = 5.0) -> Dealer:
    d = Dealer(ident, send_timeout_s=send_timeout_s)
    d.connect(router.address)
    return d


def test_frames_decode_whatever_the_split():
    """Length-prefixed frames come out whole and in order however the byte
    stream is cut (empty, small and 300 KB payloads)."""
    rng = np.random.default_rng(0)
    payloads = [b"", b"x", rng.bytes(300_000), b"\x00" * 7, rng.bytes(4)]
    stream = b"".join(_frame(p) for p in payloads)
    for cuts in (1, 3, 4096, len(stream)):
        dec = _Frames()
        for i in range(0, len(stream), cuts):
            dec.feed(stream[i:i + cuts])
        assert list(dec.frames) == payloads


def test_addresses():
    assert parse_tcp("tcp://127.0.0.1:*") == ("127.0.0.1", 0)
    assert parse_tcp("tcp://localhost:5555") == ("localhost", 5555)
    for bad in ("ipc:///tmp/sock", "inproc://x", "tcp://nohost", "127.0.0.1:5"):
        with pytest.raises(ValueError):
            parse_tcp(bad)
    with pytest.raises(ValueError):
        Router("ipc:///tmp/surreal")
    r = Router()
    try:
        host, port = parse_tcp(r.address)
        assert host == "127.0.0.1" and port > 0  # the bound port, as LAST_ENDPOINT reports it
        with pytest.raises(ValueError):
            Dealer(b"w", send_timeout_s=1.0).connect("tcp://127.0.0.1:*")
    finally:
        r.close()


def test_identity_routing(router):
    """Each DEALER's messages arrive under its identity, and a send to an
    identity reaches that peer only; a 225 KB message (a pickled pixel
    batch) arrives whole."""
    a, b = _dealer(router, b"worker-0"), _dealer(router, b"worker-1")
    big = np.random.default_rng(1).bytes(64 * 42 * 42 * 2)
    try:
        a.send(b"from a")
        b.send(big)
        got = dict(_recv(router) for _ in range(2))
        assert got == {b"worker-0": b"from a", b"worker-1": big}
        router.send_multipart([b"worker-1", b"to b"])
        router.send_multipart([b"worker-0", b"to a"])
        router.send_multipart([b"nobody", b"dropped"])  # no such peer: dropped
        assert _reply(a) == b"to a" and _reply(b) == b"to b"
        assert not a.poll(50) and not b.poll(50)
        with pytest.raises(Again):
            router.recv_multipart()
    finally:
        a.close()
        b.close()


def test_handover_to_the_newest_connection(router):
    """A connection under a known identity replaces the old one (a
    respawned worker) and closes it: replies go to the new peer only, and
    the old peer's sends are dropped without raising."""
    old = _dealer(router, b"worker-3")
    try:
        old.send(b"old")
        assert _recv(router) == (b"worker-3", b"old")
        new = _dealer(router, b"worker-3")
        try:
            new.send(b"new")
            assert _recv(router) == (b"worker-3", b"new")
            router.send_multipart([b"worker-3", b"reply"])
            assert _reply(new) == b"reply"
            assert not old.poll(100)  # closed by the handover: nothing arrives
            old.send(b"after the handover")  # a gone peer is no error
            new.send(b"still here")
            assert _recv(router) == (b"worker-3", b"still here")
            assert not router.poll(50)
        finally:
            new.close()
    finally:
        old.close()


def test_dealer_poll_times_out_and_a_gone_server_is_no_error():
    router = Router()
    d = _dealer(router, b"worker-0")
    try:
        d.send(b"ping")
        assert _recv(router) == (b"worker-0", b"ping")
        assert not d.poll(100)  # no reply: False after the timeout
        router.close()
        assert not d.poll(100)  # the server is gone: still just no message
        d.send(b"into the void")  # dropped, as zmq queues it forever
        with pytest.raises(Again):
            d.recv()
    finally:
        d.close()


def test_dealer_send_times_out_against_a_server_that_does_not_read():
    """A server that takes nothing (bound, never polled): once the kernel's
    buffers are full the bounded send raises TimeoutError, and so does a
    non-blocking one."""
    router = Router()
    d = Dealer(b"worker-0", send_timeout_s=0.2)
    try:
        d.connect(router.address)
        chunk = bytes(1 << 20)
        with pytest.raises(TimeoutError, match="timed out"):
            for _ in range(512):
                d.send(chunk)
        with pytest.raises(TimeoutError):
            d.send(chunk, noblock=True)
    finally:
        d.close()
        router.close()


def test_router_is_not_stalled_by_a_peer_that_stops_reading(router):
    """Replies the kernel cannot take wait in the connection's buffer: the
    ROUTER's sends return at once, it keeps serving other peers, and the
    buffered replies arrive once the peer reads again."""
    slow, fast = _dealer(router, b"worker-0"), _dealer(router, b"worker-1")
    try:
        slow.send(b"hello")
        fast.send(b"hello")
        assert len({_recv(router)[0] for _ in range(2)}) == 2
        big = bytes(1 << 20)
        for _ in range(32):  # 32 MB to a peer that is not reading
            router.send_multipart([b"worker-0", big])
        for i in range(5):
            fast.send(b"%d" % i)
            assert _recv(router) == (b"worker-1", b"%d" % i)
            router.send_multipart([b"worker-1", b"ok"])
            assert _reply(fast) == b"ok"
        got = 0
        for _ in range(3000):  # bounded: at most 3000 polls of 10 ms
            if got == 32:
                break
            router.poll(0)  # the router flushes as the socket drains
            if slow.poll(10):
                assert slow.recv() == big
                got += 1
        assert got == 32
    finally:
        slow.close()
        fast.close()
