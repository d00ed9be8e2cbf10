"""A ROUTER/DEALER socket pair over the standard library (``socket`` and
``selectors``): the SEED wire of the port, in place of the pyzmq pair the
reference uses (``surreal_tpu/distributed/inference_server.py:209-216``,
``env_worker.py:108-116``). pyzmq is not among what the card's machine
has, so the port carries exactly the semantics SEED relies on:

- messages are length-framed (a little-endian u32 length, then the
  payload); the bytes inside a frame are ``shm_transport``'s, unchanged;
- a DEALER sends its identity (``worker-{i}``) as the first frame of a
  connection, and the ROUTER receives ``(identity, payload)`` pairs and
  sends to an identity;
- ``Router(bind="tcp://127.0.0.1:*")`` binds a free port and reports the
  bound ``tcp://host:port`` in ``address`` (zmq's ``LAST_ENDPOINT``);
  any other address scheme raises;
- ``ROUTER_HANDOVER``: a connection that names an identity already
  connected replaces the old connection and closes it (a respawned worker
  reuses its dead predecessor's identity, and a SIGKILLed one never said
  goodbye);
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
  worker's silence budget (or its stop event) ends it, as with zmq.

Each socket belongs to one thread, as a zmq socket does.
"""

from __future__ import annotations

import selectors
import socket
import struct
import time
from collections import deque

_LEN = struct.Struct("<I")
_RECV_BYTES = 1 << 20
_NOBLOCK_SEND_S = 0.1  # a non-blocking DEALER send: what the kernel takes at once, or this long


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
    """Incremental decoder of length-prefixed frames."""

    __slots__ = ("_buf", "frames")

    def __init__(self):
        self._buf = bytearray()
        self.frames: deque[bytes] = deque()

    def feed(self, data: bytes) -> None:
        buf = self._buf
        buf += data
        off = 0
        with memoryview(buf) as view:
            while len(buf) - off >= _LEN.size:
                (n,) = _LEN.unpack_from(buf, off)
                if len(buf) - off - _LEN.size < n:
                    break
                self.frames.append(bytes(view[off + _LEN.size:off + _LEN.size + n]))
                off += _LEN.size + n
        if off:
            del buf[:off]


def _frame(payload: bytes) -> bytes:
    return b"".join((_LEN.pack(len(payload)), payload))


class _Peer:
    __slots__ = ("sock", "ident", "frames", "out")

    def __init__(self, sock: socket.socket):
        self.sock = sock
        self.ident: bytes | None = None  # the connection's first frame
        self.frames = _Frames()
        self.out = bytearray()           # what the kernel has not taken yet


class Router:
    """The server side: many identified peers, one non-blocking loop."""

    def __init__(self, bind: str = "tcp://127.0.0.1:*"):
        host, port = parse_tcp(bind)
        self._listen = socket.create_server((host, port))
        self._listen.setblocking(False)
        self.address = f"tcp://{host}:{self._listen.getsockname()[1]}"
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._listen, selectors.EVENT_READ, None)
        self._routes: dict[bytes, _Peer] = {}
        self._inbox: deque[tuple[bytes, bytes]] = deque()

    # -- receiving -------------------------------------------------------------
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

    def recv_multipart(self) -> tuple[bytes, bytes]:
        """The oldest waiting (identity, payload); ``Again`` if none."""
        if not self._inbox:
            self._pump(0.0)
        if not self._inbox:
            raise Again
        return self._inbox.popleft()

    def _pump(self, timeout_s: float) -> None:
        for key, mask in self._sel.select(timeout_s):
            if key.data is None:
                self._accept()
                continue
            peer = key.data
            if peer.sock.fileno() < 0:
                continue  # dropped earlier in this pass (a handover)
            if mask & selectors.EVENT_WRITE:
                self._flush(peer)
            if mask & selectors.EVENT_READ:
                self._read(peer)

    def _accept(self) -> None:
        while True:
            try:
                sock, _ = self._listen.accept()
            except BlockingIOError:
                return
            sock.setblocking(False)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            peer = _Peer(sock)
            self._sel.register(sock, selectors.EVENT_READ, peer)

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
            payload = peer.frames.frames.popleft()
            if peer.ident is None:
                self._adopt(peer, payload)
            else:
                self._inbox.append((peer.ident, payload))
        if closed:
            self._drop(peer)

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
        try:
            self._sel.unregister(peer.sock)
        except (KeyError, ValueError):
            pass  # already unregistered
        peer.sock.close()
        peer.out.clear()

    # -- sending ---------------------------------------------------------------
    def send_multipart(self, parts) -> None:
        """Send ``payload`` to ``identity`` without blocking; what the
        kernel does not take waits for the socket to become writable."""
        ident, payload = parts
        peer = self._routes.get(ident)
        if peer is None:
            return  # no such peer: dropped, as a ROUTER drops it
        peer.out += _frame(payload)
        self._flush(peer)

    def _flush(self, peer: _Peer) -> None:
        if peer.out:
            try:
                sent = peer.sock.send(peer.out)
            except BlockingIOError:
                sent = 0
            except OSError:
                self._drop(peer)
                return
            del peer.out[:sent]
        events = selectors.EVENT_READ | (selectors.EVENT_WRITE if peer.out else 0)
        if self._sel.get_key(peer.sock).events != events:
            self._sel.modify(peer.sock, events, peer)

    def close(self) -> None:
        """Close every connection; replies still buffered here are dropped,
        as zmq's ``close(0)`` drops them."""
        for key in list(self._sel.get_map().values()):
            key.fileobj.close()
        self._sel.close()
        self._routes.clear()


class Dealer:
    """The worker side: one connection, identity first."""

    def __init__(self, identity: bytes, send_timeout_s: float):
        self.identity = bytes(identity)
        self._send_timeout = send_timeout_s
        self._sock: socket.socket | None = None
        self._sel: selectors.BaseSelector | None = None
        self._frames = _Frames()
        self._gone = False  # the server closed the connection

    def connect(self, address: str) -> None:
        host, port = parse_tcp(address)
        if port == 0:
            raise ValueError(f"address {address!r}: a DEALER connects to a bound port")
        self._sock = socket.create_connection((host, port), timeout=self._send_timeout)
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._sel = selectors.DefaultSelector()
        self._sel.register(self._sock, selectors.EVENT_READ)
        self.send(self.identity)

    def send(self, payload: bytes, noblock: bool = False) -> None:
        """Send one message; raises ``TimeoutError`` when the server takes
        none of it for ``send_timeout_s`` (0.1 s with ``noblock``)."""
        if self._gone:
            return  # the server is gone: dropped; the silence budget decides
        timeout = _NOBLOCK_SEND_S if noblock else self._send_timeout
        self._sock.settimeout(timeout)
        try:
            self._sock.sendall(_frame(payload))
        except TimeoutError:
            raise TimeoutError(f"send to the inference server timed out after {timeout}s") from None
        except (BrokenPipeError, ConnectionResetError):
            self._gone = True

    def poll(self, timeout_ms: float) -> bool:
        """True once a message is waiting, or False after ``timeout_ms``."""
        deadline = time.monotonic() + max(0.0, timeout_ms) / 1e3
        while not self._frames.frames:
            wait = deadline - time.monotonic()
            if wait <= 0:
                return False
            if self._gone:
                time.sleep(wait)
                return False
            if self._sel.select(wait):
                self._sock.settimeout(0.0)
                try:
                    data = self._sock.recv(_RECV_BYTES)
                except BlockingIOError:
                    continue
                except OSError:
                    data = b""
                if not data:
                    self._gone = True
                    continue
                self._frames.feed(data)
        return True

    def recv(self) -> bytes:
        """The oldest waiting message; ``Again`` if none (poll first)."""
        if not self._frames.frames:
            raise Again
        return self._frames.frames.popleft()

    def close(self) -> None:
        """Close the connection; sent bytes the kernel holds still leave
        (the final fire-and-forget flush of a worker that is exiting)."""
        if self._sel is not None:
            self._sel.close()
        if self._sock is not None:
            self._sock.close()
