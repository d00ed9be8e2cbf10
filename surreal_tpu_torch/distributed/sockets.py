"""Message sockets over the standard library (``socket``, ``selectors``
and ``threading``), in place of the pyzmq sockets the reference uses.
pyzmq is not among what the card's machine has, so the port carries
exactly the semantics its callers rely on. Four pairs:

- ROUTER/DEALER, the SEED wire (``surreal_tpu/distributed/inference_server.py:209-216``,
  ``env_worker.py:108-116``);
- REQ/REP and PUB/SUB, the parameter service
  (``surreal_tpu/distributed/param_service.py``);
- PUB/SUB and PUSH/PULL, the parameter fanout's frames and acks
  (``surreal_tpu/distributed/param_fanout.py``).

Common to all:

- messages are length-framed (a little-endian u32 length, then the
  payload); a multipart message (REQ/REP, PUB/SUB) is one frame holding
  its parts, each length-framed in turn (:func:`pack_parts`);
- ``bind("tcp://127.0.0.1:*")`` binds a free port and reports the bound
  ``tcp://host:port`` (zmq's ``LAST_ENDPOINT``); any other address scheme
  raises;
- every wait takes a timeout; each socket belongs to one thread, as a zmq
  socket does (a ``Pub``'s own I/O thread is internal to it).

ROUTER/DEALER:

- a DEALER sends its identity (``worker-{i}``) as the first frame of a
  connection, and the ROUTER receives ``(identity, payload)`` pairs and
  sends to an identity;
- ``ROUTER_HANDOVER``: a connection that names an identity already
  connected replaces the old connection and closes it (a respawned worker
  reuses its dead predecessor's identity, and a SIGKILLed one never said
  goodbye);
- a peer whose bytes are not this framing is dropped: an identity frame
  longer than ``IDENTITY_MAX_BYTES`` (zmq's limit, 255), or, with
  ``Router(max_frame_bytes=N)``, any frame longer than N (zmq's
  ``MAXMSGSIZE``), closes its connection and nothing it sent after the
  last whole frame is delivered. A raw TCP peer writing text or random
  bytes is dropped at its first four bytes;
- the ROUTER never blocks: receives are non-blocking behind ``poll`` with
  a timeout, and a reply the kernel cannot take at once waits in the
  connection's buffer until the socket is writable, so a worker that
  stops reading cannot stall the server loop; a message to an identity
  with no connection is dropped, as a ROUTER drops it;
- a DEALER's sends are bounded by ``send_timeout_s`` (zmq's ``SNDTIMEO``):
  a timeout raises ``TimeoutError``, so a worker whose server is wedged
  dies into its supervisor's respawn, as with ``zmq.Again``; its
  receives wait behind ``poll``. A server that has gone away is not an
  error on either call: sends are dropped and polls find nothing, and the
  worker's silence budget (or its stop event) ends it, as with zmq;
- ``Dealer(..., reconnect=True)`` is zmq's DEALER in full, for the
  experience plane's shard links: ``connect`` only records the address,
  the connection is made (and, after the server has gone, made again)
  every ``_RECONNECT_S`` while the caller sends or polls, each time with
  the identity frame first, and messages sent while no connection is up
  wait for the next one (up to ``_RECONNECT_QUEUE``; beyond, the oldest
  are dropped). A server that binds after its clients were built, or a
  respawned one at the same address, is reached without any help from
  the caller. SEED's workers keep the default, which never reconnects:
  they time out into their supervisor's respawn.

REQ/REP:

- a ``Req`` alternates strictly, send then receive (a second send before
  the reply raises, as zmq's EFSM does). Its connection is made while it
  waits, so a request to a server not up yet is delivered once it binds
  within the wait. After a timeout the caller closes it and makes a new
  one (the reference's ``ParameterClient._request_once``);
- a ``Rep`` binds several endpoints and serves them all; ``recv`` takes
  the oldest request of any peer and ``send_multipart`` answers that
  peer. A reply to a peer that has gone away (a client that timed out and
  reconnected) is dropped without blocking, and the Rep serves the new
  connection as any other.

PUB/SUB:

- a ``Sub`` sends its topic prefixes to the ``Pub`` (as a zmq SUB does
  over TCP); the Pub sends a message only to subscribers with a prefix of
  its first part;
- ``Pub.send_multipart`` never blocks: an I/O thread of the Pub's own
  writes to the subscribers. By default, per subscriber the Pub keeps
  only the message it is writing and the newest one not yet started
  (zmq's ``CONFLATE``); older ones are dropped, as a subscriber to
  parameter snapshots needs only the newest. And a subscriber that
  connects after a publish receives the newest message of its topic at
  once (a last-value cache), so it never misses a snapshot by joining
  late;
- ``Pub(hwm=N)`` queues instead (zmq's PUB with its high-water mark): per
  subscriber up to N messages wait behind the one being written, every
  one delivered in order; a message that finds N waiting is dropped for
  that subscriber and counted (``dropped``), and a subscriber that joins
  late receives only what is published after it (a delta stream needs
  every frame, and no frame from before its join).

PUSH/PULL:

- a ``Pull`` binds and receives from any number of ``Push`` peers, behind
  ``poll`` as a ``Router`` does;
- ``Push.send`` never blocks its caller for long: it connects on first
  use, and a message the connection cannot take within 0.1 s, or one
  with no ``Pull`` to connect to, is dropped (the reference's
  ``NOBLOCK`` send under ``SNDTIMEO``). It returns whether the message
  went out.
"""

from __future__ import annotations

import selectors
import socket
import struct
import threading
import time
from collections import deque

_LEN = struct.Struct("<I")
_RECV_BYTES = 1 << 20
_NOBLOCK_SEND_S = 0.1  # a non-blocking DEALER send: what the kernel takes at once, or this long
_RECONNECT_S = 0.05    # a Req's or reconnecting Dealer's pause between connection attempts
_RECONNECT_QUEUE = 1000  # a reconnecting Dealer's messages held while no connection is up
IDENTITY_MAX_BYTES = 255  # a ROUTER peer's first frame, as zmq bounds routing ids


class Again(Exception):
    """A receive found no complete message (``zmq.Again``)."""


def parse_tcp(address: str) -> tuple[str, int]:
    """``tcp://host:port`` -> (host, port); port ``*`` is 0 (any free
    port, binding only)."""
    if not address.startswith("tcp://"):
        raise ValueError(f"address {address!r}: only tcp://host:port is supported")
    host, sep, port = address[len("tcp://"):].rpartition(":")
    if not sep or not host:
        raise ValueError(f"address {address!r}: expected tcp://host:port")
    return host, 0 if port == "*" else int(port)


class _Frames:
    """Incremental decoder of length-prefixed frames. ``limits`` (first
    frame, later frames; None for no bound) bound the lengths a peer may
    declare: one above its bound sets ``bad``, and nothing more is
    decoded."""

    __slots__ = ("_buf", "frames", "limits", "decoded", "bad")

    def __init__(self, limits: tuple[int | None, int | None] = (None, None)):
        self._buf = bytearray()
        self.frames: deque[bytes] = deque()
        self.limits = limits
        self.decoded = 0
        self.bad = False

    def feed(self, data: bytes) -> None:
        if self.bad:
            return
        buf = self._buf
        buf += data
        off = 0
        with memoryview(buf) as view:
            while len(buf) - off >= _LEN.size:
                (n,) = _LEN.unpack_from(buf, off)
                limit = self.limits[0 if self.decoded == 0 else 1]
                if limit is not None and n > limit:
                    self.bad = True
                    break
                if len(buf) - off - _LEN.size < n:
                    break
                self.decoded += 1
                self.frames.append(bytes(view[off + _LEN.size:off + _LEN.size + n]))
                off += _LEN.size + n
        if off:
            del buf[:off]


def _frame(payload: bytes) -> bytes:
    return b"".join((_LEN.pack(len(payload)), payload))


def pack_parts(parts) -> bytes:
    """A multipart message as one payload: the part count, then each part
    length-framed."""
    out = [_LEN.pack(len(parts))]
    for p in parts:
        out += (_LEN.pack(len(p)), p)
    return b"".join(out)


def unpack_parts(payload: bytes) -> list[bytes]:
    """:func:`pack_parts`' inverse."""
    (n,) = _LEN.unpack_from(payload, 0)
    off, parts = _LEN.size, []
    for _ in range(n):
        (k,) = _LEN.unpack_from(payload, off)
        off += _LEN.size
        parts.append(payload[off:off + k])
        off += k
    return parts


class _Peer:
    __slots__ = ("sock", "ident", "frames", "out", "off", "waiting", "topics")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.ident: bytes | None = None  # a DEALER's first frame
        self.frames = _Frames()
        self.out = bytearray()           # being written; out[off:] not taken by the kernel yet
        self.off = 0
        self.waiting: deque[bytes] = deque()  # a Pub's messages not started yet
        self.topics: list[bytes] = []    # a Sub's prefixes


class _Server:
    """Bound endpoints and their accepted peers, on one selector: the
    non-blocking accept, read and write shared by ``Router``, ``Rep`` and
    ``Pub``. A subclass takes each received frame in ``_deliver``."""

    def __init__(self):
        self._sel = selectors.DefaultSelector()
        self.addresses: list[str] = []

    def bind(self, address: str) -> str:
        """Listen on ``address`` as well; returns the bound address."""
        host, port = parse_tcp(address)
        listen = socket.create_server((host, port))
        listen.setblocking(False)
        self._sel.register(listen, selectors.EVENT_READ, None)
        bound = f"tcp://{host}:{listen.getsockname()[1]}"
        self.addresses.append(bound)
        return bound

    @property
    def address(self) -> str:
        return self.addresses[0]

    def _pump(self, timeout_s: float) -> None:
        for key, mask in self._sel.select(timeout_s):
            if key.data is None:
                self._accept(key.fileobj)
                continue
            peer = key.data
            if peer.sock.fileno() < 0:
                continue  # dropped earlier in this pass (a handover)
            if mask & selectors.EVENT_WRITE:
                self._flush(peer)
            if mask & selectors.EVENT_READ and peer.sock.fileno() >= 0:
                self._read(peer)

    def _accept(self, listen: socket.socket) -> None:
        while True:
            try:
                sock, _ = listen.accept()
            except BlockingIOError:
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer = _Peer(sock)
            self._sel.register(sock, selectors.EVENT_READ, peer)
            self._accepted(peer)

    def _accepted(self, peer: _Peer) -> None:
        pass

    def _read(self, peer: _Peer) -> None:
        closed = False
        while True:
            try:
                data = peer.sock.recv(_RECV_BYTES)
            except BlockingIOError:
                break
            except OSError:
                data = b""
            if not data:
                closed = True
                break
            peer.frames.feed(data)
        # what arrived before a close is delivered, as zmq delivers it
        while peer.frames.frames:
            self._deliver(peer, peer.frames.frames.popleft())
        if closed or peer.frames.bad:
            self._drop(peer)

    def _deliver(self, peer: _Peer, payload: bytes) -> None:
        raise NotImplementedError

    def _drop(self, peer: _Peer) -> None:
        try:
            self._sel.unregister(peer.sock)
        except (KeyError, ValueError):
            pass  # already unregistered
        peer.sock.close()
        peer.out, peer.off = bytearray(), 0
        peer.waiting.clear()

    def _send(self, peer: _Peer, data: bytes) -> None:
        """Queue ``data`` after what ``peer`` still has to write, and write
        what the kernel takes now."""
        if peer.off and peer.off == len(peer.out):
            peer.out, peer.off = bytearray(), 0
        peer.out += data
        self._flush(peer)

    def _flush(self, peer: _Peer) -> None:
        while True:
            if peer.off >= len(peer.out):
                if not peer.waiting:
                    peer.out, peer.off = bytearray(), 0
                    break
                peer.out, peer.off = peer.waiting.popleft(), 0  # bytes shared by every subscriber
            try:
                with memoryview(peer.out) as view, view[peer.off:] as rest:
                    sent = peer.sock.send(rest)
            except BlockingIOError:
                break
            except OSError:
                self._drop(peer)
                return
            peer.off += sent
        pending = peer.off < len(peer.out) or bool(peer.waiting)
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if pending else 0)
        if self._sel.get_key(peer.sock).events != events:
            self._sel.modify(peer.sock, events, peer)

    def _close_all(self) -> None:
        for key in list(self._sel.get_map().values()):
            key.fileobj.close()
        self._sel.close()


class _Inbox(_Server):
    """A server whose received messages wait in an inbox, read behind
    ``poll`` (``Router``, ``Rep``)."""

    def __init__(self):
        super().__init__()
        self._inbox: deque = deque()

    def poll(self, timeout_ms: float) -> bool:
        """True once a message is waiting, or False after ``timeout_ms``;
        accepts connections and flushes pending replies meanwhile."""
        deadline = time.monotonic() + max(0.0, timeout_ms) / 1e3
        while True:
            if self._inbox:
                return True
            self._pump(max(0.0, deadline - time.monotonic()))
            if self._inbox:
                return True
            if time.monotonic() >= deadline:
                return False

    def _next(self):
        if not self._inbox:
            self._pump(0.0)
        if not self._inbox:
            raise Again
        return self._inbox.popleft()


class Router(_Inbox):
    """The server side of ROUTER/DEALER: many identified peers, one
    non-blocking loop."""

    def __init__(self, bind: str = "tcp://127.0.0.1:*", max_frame_bytes: int | None = None):
        super().__init__()
        self.bind(bind)
        self._routes: dict[bytes, _Peer] = {}
        self._limits = (IDENTITY_MAX_BYTES, max_frame_bytes)

    def _accepted(self, peer: _Peer) -> None:
        peer.frames.limits = self._limits

    def recv_multipart(self) -> tuple[bytes, bytes]:
        """The oldest waiting (identity, payload); ``Again`` if none."""
        return self._next()

    def _deliver(self, peer: _Peer, payload: bytes) -> None:
        if peer.ident is None:
            self._adopt(peer, payload)
        else:
            self._inbox.append((peer.ident, payload))

    def _adopt(self, peer: _Peer, ident: bytes) -> None:
        """ROUTER_HANDOVER: the newest connection under an identity wins."""
        peer.ident = ident
        old = self._routes.get(ident)
        if old is not None and old is not peer:
            self._drop(old)
        self._routes[ident] = peer

    def _drop(self, peer: _Peer) -> None:
        if peer.ident is not None and self._routes.get(peer.ident) is peer:
            del self._routes[peer.ident]
        super()._drop(peer)

    def send_multipart(self, parts) -> None:
        """Send ``payload`` to ``identity`` without blocking; what the
        kernel does not take waits for the socket to become writable."""
        ident, payload = parts
        peer = self._routes.get(ident)
        if peer is None:
            return  # no such peer: dropped, as a ROUTER drops it
        self._send(peer, _frame(payload))

    def close(self) -> None:
        """Close every connection; replies still buffered here are dropped,
        as zmq's ``close(0)`` drops them."""
        self._close_all()
        self._routes.clear()


class Rep(_Inbox):
    """REP: requests from any peer on any bound endpoint, each answered to
    its own peer."""

    def __init__(self):
        super().__init__()
        self._peer: _Peer | None = None

    def _deliver(self, peer: _Peer, payload: bytes) -> None:
        self._inbox.append((peer, payload))

    def recv(self) -> bytes:
        """The oldest waiting request; ``Again`` if none. The next
        ``send_multipart`` answers its peer."""
        self._peer, payload = self._next()
        return payload

    def send_multipart(self, parts) -> None:
        """Answer the last request's peer without blocking; dropped when
        that peer has gone away."""
        peer, self._peer = self._peer, None
        if peer is None:
            raise RuntimeError("Rep.send_multipart before recv")
        if peer.sock.fileno() < 0:
            return  # the client gave up and closed: dropped, as zmq drops it
        self._send(peer, _frame(pack_parts(parts)))

    def close(self) -> None:
        self._close_all()
        self._inbox.clear()


class Pub(_Server):
    """PUB: multipart messages to every subscriber of their topic, written
    by an I/O thread of its own, never blocking the caller. ``hwm=None``:
    per subscriber only the newest message not yet started is kept, and a
    late subscriber gets the newest at once; ``hwm=N``: up to N wait per
    subscriber, in order, and the ones beyond are dropped and counted."""

    def __init__(self, bind: str = "tcp://127.0.0.1:*", hwm: int | None = None):
        super().__init__()
        if hwm is not None and hwm < 1:
            raise ValueError(f"hwm must be >= 1 or None, got {hwm}")
        self.bind(bind)
        self.hwm = hwm
        self.dropped = 0  # queued mode: messages dropped at a subscriber's high-water mark
        self._lock = threading.Lock()
        self._peers: list[_Peer] = []
        self._last: dict[bytes, bytes] = {}  # conflating mode: topic -> its newest framed message
        self._wake_r, self._wake_w = socket.socketpair()
        self._wake_r.setblocking(False)
        self._wake_w.setblocking(False)
        self._sel.register(self._wake_r, selectors.EVENT_READ, "wake")
        self._dirty = False
        self._closed = False
        self._thread = threading.Thread(target=self._io, name="pub-io", daemon=True)
        self._thread.start()

    def send_multipart(self, parts) -> None:
        """Queue ``parts`` for every subscriber of ``parts[0]``; returns at once."""
        topic = bytes(parts[0])
        msg = _frame(pack_parts(parts))
        with self._lock:
            if self.hwm is None:
                self._last[topic] = msg
            for peer in self._peers:
                if not any(topic.startswith(t) for t in peer.topics):
                    continue
                if self.hwm is None:
                    peer.waiting.clear()  # conflate: an older unstarted message is dropped
                elif len(peer.waiting) >= self.hwm:
                    self.dropped += 1  # at the high-water mark: this message is dropped for this subscriber
                    continue
                peer.waiting.append(msg)
            self._dirty = True
        try:
            self._wake_w.send(b"\0")
        except (BlockingIOError, OSError):
            pass  # a wake-up is already pending, or the Pub is closing

    def pending(self) -> int:
        """Messages held for subscribers (started or not): at most two a
        subscriber when conflating, ``hwm + 1`` when queued."""
        with self._lock:
            return sum((p.off < len(p.out)) + len(p.waiting) for p in self._peers)

    def _io(self) -> None:
        while not self._closed:
            try:
                with self._lock:
                    self._pump(0.1)
            except (OSError, ValueError):
                if self._closed:
                    return
                raise

    def _pump(self, timeout_s: float) -> None:
        # select without the lock, so send_multipart never waits on the wire
        self._lock.release()
        try:
            ready = self._sel.select(timeout_s)
        finally:
            self._lock.acquire()
        for key, mask in ready:
            if key.data is None:
                self._accept(key.fileobj)
            elif key.data == "wake":
                try:
                    while self._wake_r.recv(4096):
                        pass
                except (BlockingIOError, OSError):
                    pass
            else:
                peer = key.data
                if peer.sock.fileno() < 0:
                    continue
                if mask & selectors.EVENT_WRITE:
                    self._flush(peer)
                if mask & selectors.EVENT_READ and peer.sock.fileno() >= 0:
                    self._read(peer)
        if self._dirty:
            self._dirty = False
            for peer in list(self._peers):
                if peer.waiting and peer.sock.fileno() >= 0:
                    self._flush(peer)

    def _accepted(self, peer: _Peer) -> None:
        self._peers.append(peer)

    def _deliver(self, peer: _Peer, payload: bytes) -> None:
        """A subscription: the prefix, and (conflating) the newest message
        it matches."""
        peer.topics.append(payload)
        newest = [msg for topic, msg in self._last.items() if topic.startswith(payload)]
        if newest and not peer.waiting:
            peer.waiting.append(newest[-1])
            self._flush(peer)

    def _drop(self, peer: _Peer) -> None:
        if peer in self._peers:
            self._peers.remove(peer)
        super()._drop(peer)

    def close(self) -> None:
        with self._lock:
            self._closed = True
        try:
            self._wake_w.send(b"\0")
        except OSError:
            pass
        self._thread.join(timeout=2)
        with self._lock:
            self._close_all()
            self._peers.clear()
        self._wake_w.close()


class Pull(_Inbox):
    """PULL: messages from any number of ``Push`` peers, oldest first."""

    def __init__(self, bind: str = "tcp://127.0.0.1:*"):
        super().__init__()
        self.bind(bind)

    def _deliver(self, peer: _Peer, payload: bytes) -> None:
        self._inbox.append(payload)

    def recv(self) -> bytes:
        """The oldest waiting message; ``Again`` if none."""
        return self._next()

    def close(self) -> None:
        self._close_all()
        self._inbox.clear()


class _Client:
    """One connection to a bound endpoint, length-framed both ways."""

    def __init__(self):
        self._sock: socket.socket | None = None
        self._sel: selectors.BaseSelector | None = None
        self._frames = _Frames()
        self._gone = False  # the server closed the connection

    def _open(self, address: str, timeout_s: float) -> None:
        host, port = parse_tcp(address)
        if port == 0:
            raise ValueError(f"address {address!r}: a client connects to a bound port")
        self._sock = socket.create_connection((host, port), timeout=timeout_s)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._sock, selectors.EVENT_READ)

    def _receive(self, wait_s: float) -> None:
        """Read what arrives within ``wait_s`` into the frame decoder."""
        if self._gone or self._sel is None:
            time.sleep(max(0.0, wait_s))
            return
        if self._sel.select(max(0.0, wait_s)):
            self._sock.settimeout(0.0)
            try:
                data = self._sock.recv(_RECV_BYTES)
            except BlockingIOError:
                return
            except OSError:
                data = b""
            if not data:
                self._gone = True
                return
            self._frames.feed(data)

    def close(self) -> None:
        if self._sel is not None:
            self._sel.close()
            self._sel = None
        if self._sock is not None:
            self._sock.close()
            self._sock = None


class Dealer(_Client):
    """The worker side of ROUTER/DEALER: one connection, identity first.
    With ``reconnect``, the connection is made lazily and remade after the
    server has gone (see the module docstring)."""

    def __init__(self, identity: bytes, send_timeout_s: float, reconnect: bool = False):
        super().__init__()
        self.identity = bytes(identity)
        self._send_timeout = send_timeout_s
        self._reconnect = reconnect
        self._address: str | None = None
        self._queued: deque[bytes] = deque(maxlen=_RECONNECT_QUEUE)
        self._next_attempt = 0.0
        self.connects = 0  # connections made (a reconnecting Dealer's first, then one a server restart)

    def connect(self, address: str) -> None:
        if self._reconnect:
            parse_tcp(address)  # malformed addresses raise here
            self._address = address
            self._try_connect()
            return
        self._open(address, self._send_timeout)
        self.send(self.identity)
        self.connects += 1

    def _try_connect(self) -> bool:
        """A reconnecting Dealer's attempt to (re)connect, at most one every
        ``_RECONNECT_S``; on success the identity, then the queued
        messages, go first."""
        if self._sock is not None and not self._gone:
            return True
        now = time.monotonic()
        if now < self._next_attempt:
            return False
        self._next_attempt = now + _RECONNECT_S
        self.close()
        self._gone = False
        arrived = self._frames.frames
        self._frames = _Frames()  # a partial frame of the old connection is lost with it,
        self._frames.frames = arrived  # what arrived whole is still delivered
        try:
            self._open(self._address, max(self._send_timeout, 1e-3))
        except OSError:
            self.close()  # nothing bound there (yet): the next send or poll tries again
            return False
        self.connects += 1
        self._sock.settimeout(self._send_timeout)
        try:
            self._sock.sendall(_frame(self.identity))
            while self._queued:
                self._sock.sendall(self._queued[0])
                self._queued.popleft()
        except OSError:
            self._gone = True
            return False
        return True

    def send(self, payload: bytes, noblock: bool = False) -> None:
        """Send one message; raises ``TimeoutError`` when the server takes
        none of it for ``send_timeout_s`` (0.1 s with ``noblock``)."""
        if self._reconnect:
            if self._sock is not None and not self._gone:
                self._receive(0.0)  # a server that closed since: noticed now, not after the send
            if not self._try_connect():
                self._queued.append(_frame(payload))
                return
        if self._gone:
            return  # the server is gone: dropped; the silence budget decides
        timeout = _NOBLOCK_SEND_S if noblock else self._send_timeout
        self._sock.settimeout(timeout)
        try:
            self._sock.sendall(_frame(payload))
        except TimeoutError:
            raise TimeoutError(f"send to {self._address or 'the inference server'} timed out after {timeout}s") from None
        except (BrokenPipeError, ConnectionResetError):
            self._gone = True

    def poll(self, timeout_ms: float) -> bool:
        """True once a message is waiting, or False after ``timeout_ms``
        (``poll(0)`` reads what has already arrived, without waiting)."""
        deadline = time.monotonic() + max(0.0, timeout_ms) / 1e3
        while not self._frames.frames:
            if self._reconnect and not self._try_connect():
                wait = deadline - time.monotonic()
                if wait <= 0:
                    return False
                time.sleep(min(_RECONNECT_S, wait))
                continue
            self._receive(max(0.0, deadline - time.monotonic()))
            if time.monotonic() >= deadline:
                break
        return bool(self._frames.frames)

    def recv(self) -> bytes:
        """The oldest waiting message; ``Again`` if none (poll first)."""
        if not self._frames.frames:
            raise Again
        return self._frames.frames.popleft()

    def refresh(self) -> None:
        """Read what has arrived, without waiting, whatever is already
        waiting (so a server that closed the connection is noticed), and
        for a reconnecting Dealer make the new connection now."""
        for _ in range(64):  # bounded: a peer that keeps sending cannot hold the caller
            if self._sock is None or self._gone or not self._sel.select(0):
                break
            self._receive(0.0)
        if self._reconnect:
            self._try_connect()


class Push(_Client):
    """PUSH: messages to one ``Pull``; a send never blocks for long, and
    one that cannot go out is dropped."""

    def __init__(self):
        super().__init__()
        self._address: str | None = None

    def connect(self, address: str) -> None:
        parse_tcp(address)  # malformed addresses raise here
        self._address = address

    def send(self, payload: bytes) -> bool:
        """Send one message within 0.1 s (connecting first if need be);
        False when it was dropped."""
        if self._sock is None or self._gone:
            self.close()
            self._gone = False
            try:
                self._open(self._address, _NOBLOCK_SEND_S)
            except OSError:
                self.close()  # no Pull there (yet): dropped, retried on the next send
                return False
        self._sock.settimeout(_NOBLOCK_SEND_S)
        try:
            self._sock.sendall(_frame(payload))
            return True
        except OSError:
            # a timeout may have sent part of the frame: a new connection
            # starts the next message on a frame boundary
            self.close()
            return False


class Req(_Client):
    """REQ: send, then receive, strictly. The connection is made (and
    retried every 50 ms) while the request waits, so ``connect`` never
    fails and a silent or absent server costs the caller's poll timeout
    only."""

    def __init__(self):
        super().__init__()
        self._address: str | None = None
        self._out: bytes | None = None   # the request, until the server has it
        self._awaiting = False

    def connect(self, address: str) -> None:
        parse_tcp(address)  # malformed addresses raise here
        self._address = address

    def send(self, payload: bytes) -> None:
        if self._awaiting:
            raise RuntimeError("Req.send before the previous request's reply was received")
        self._out = _frame(payload)
        self._awaiting = True

    def _try_send(self, deadline: float) -> None:
        if self._sock is None:
            try:
                self._open(self._address, max(1e-3, deadline - time.monotonic()))
            except OSError:
                self.close()  # refused or unreachable: retried while the wait lasts
                time.sleep(max(0.0, min(_RECONNECT_S, deadline - time.monotonic())))
                return
        if self._sock is not None and self._out is not None:
            self._sock.settimeout(max(1e-3, deadline - time.monotonic()))
            try:
                self._sock.sendall(self._out)
                self._out = None
            except TimeoutError:
                pass  # the server takes nothing: the wait runs out
            except OSError:
                self._gone = True

    def poll(self, timeout_ms: float) -> bool:
        """True once the reply is waiting, or False after ``timeout_ms``."""
        deadline = time.monotonic() + max(0.0, timeout_ms) / 1e3
        while not self._frames.frames:
            if time.monotonic() >= deadline:
                return False
            if self._out is not None and not self._gone:
                self._try_send(deadline)
                continue
            self._receive(deadline - time.monotonic())  # a gone server: sleeps out the wait
        return True

    def recv_multipart(self) -> list[bytes]:
        """The reply's parts; ``Again`` if none (poll first)."""
        if not self._frames.frames:
            raise Again
        self._awaiting = False
        return unpack_parts(self._frames.frames.popleft())


class Sub(_Client):
    """SUB: messages of the subscribed topics from one ``Pub``."""

    def __init__(self, connect_timeout_s: float = 5.0):
        super().__init__()
        self._timeout = connect_timeout_s
        self._topics: list[bytes] = []

    def connect(self, address: str) -> None:
        self._open(address, self._timeout)

    def subscribe(self, topic: bytes) -> None:
        self._topics.append(bytes(topic))
        self._sock.settimeout(self._timeout)
        self._sock.sendall(_frame(bytes(topic)))

    def poll(self, timeout_ms: float) -> bool:
        """True once a message of a subscribed topic is waiting, or False
        after ``timeout_ms``."""
        deadline = time.monotonic() + max(0.0, timeout_ms) / 1e3
        while True:
            while self._frames.frames:
                # a packed message: the part count and the first part's length, then the topic
                if any(self._frames.frames[0][2 * _LEN.size:].startswith(t) for t in self._topics):
                    return True
                self._frames.frames.popleft()  # another topic: filtered out
            wait = deadline - time.monotonic()
            if wait <= 0 and not self._pending():
                return False
            self._receive(max(0.0, wait))

    def _pending(self) -> bool:
        return self._sel is not None and not self._gone and bool(self._sel.select(0))

    def recv_multipart(self) -> list[bytes]:
        """The oldest waiting message's parts; ``Again`` if none (poll first)."""
        if not self._frames.frames:
            raise Again
        return unpack_parts(self._frames.frames.popleft())
