"""Parameter distribution to processes outside the training program, the
port of ``surreal_tpu/distributed/param_service.py``
(``ParameterPublisher`` -> ``ParameterServer`` -> ``ParameterClient``,
and ``ShardedParameterServer``), with the reference's protocol on the
port's standard-library sockets (``distributed/sockets.py``) and wire
format (``distributed/module_dict.py``):

- the publisher sends ``[b"params", version (u64 LE), blob]`` on a PUB
  socket; it never blocks the learner, and a stalled subscriber holds at
  most the newest snapshot;
- a server caches the newest snapshot it has received (a SUB drained to
  the newest) and answers REQ/REP requests on one or several endpoints:
  ``b"version"`` -> ``[version, b""]``; ``b"fetch?" + version (u64) [+
  span (u32)]`` (14 or 18 bytes) -> ``[b"unchanged", b""]`` when the
  client holds the newest version already, else ``[version, blob]``; any
  other request -> ``[version, blob]``; ``[b"none", b""]`` before the
  first publish. A span-tagged (18-byte) fetch is mirrored as a
  ``param_fetch`` event to ``on_event``;
- the fault site ``param_service.reply`` (kind ``delay_reply``) stalls a
  reply past the client's timeout;
- a client's request costs at most ``retries + 1`` timeouts with
  exponential backoff between them, each timeout replacing its REQ
  socket, and then raises ``TimeoutError``;
- ``ShardedParameterServer.address_for`` routes a client id by crc32, as
  the reference does (the same shard for the same id).
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Any, Sequence

from surreal_tpu_torch.distributed.module_dict import dumps_pytree, loads_pytree
from surreal_tpu_torch.distributed.sockets import Pub, Rep, Req, Sub
from surreal_tpu_torch.utils import faults

TOPIC = b"params"
_POLL_MS = 50  # the server threads' poll period, which bounds how fast close() returns


class ParameterPublisher:
    """Learner side: publish (version, params) snapshots (PUB)."""

    def __init__(self, bind: str = "tcp://127.0.0.1:*"):
        self._sock = Pub(bind)
        self.address = self._sock.address
        self._version = 0

    def publish(self, params: Any) -> int:
        """Encode ``params`` (one device-to-host copy) and send it; returns
        its version. Never waits on a subscriber."""
        self._version += 1
        self._sock.send_multipart([TOPIC, self._version.to_bytes(8, "little"), dumps_pytree(params)])
        return self._version

    def close(self) -> None:
        self._sock.close()


class ParameterServer:
    """Caches the newest published params and serves REQ/REP fetches, on
    two threads of its own: one drains the subscription to the newest
    snapshot, one answers requests. ``bind`` is one address or several,
    all served (``addresses`` lists them bound; ``address`` is the first)."""

    def __init__(self, publisher_address: str, bind: str | Sequence[str] = "tcp://127.0.0.1:*", on_event=None):
        # on_event(type, **fields): a telemetry sink (SessionHooks passes
        # Tracer.event); span-tagged fetches are mirrored as 'param_fetch'
        self._on_event = on_event
        self._sub = Sub()
        self._sub.connect(publisher_address)
        self._sub.subscribe(TOPIC)
        self._rep = Rep()
        for b in [bind] if isinstance(bind, str) else list(bind):
            self._rep.bind(b)
        self.addresses: list[str] = list(self._rep.addresses)
        self.address = self.addresses[0]
        self._latest: tuple[int, bytes] | None = None
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._threads = [
            threading.Thread(target=self._drain, name="param-sub", daemon=True),
            threading.Thread(target=self._serve, name="param-rep", daemon=True),
        ]
        for t in self._threads:
            t.start()

    def _drain(self) -> None:
        """Keep the newest snapshot: a trainer publishing every iteration
        can outpace the clients, and only the newest is ever served."""
        while not self._stop.is_set():
            if not self._sub.poll(_POLL_MS):
                continue
            latest = None
            while self._sub.poll(0):
                latest = self._sub.recv_multipart()
            if latest is not None:
                _, ver, blob = latest
                with self._lock:
                    self._latest = (int.from_bytes(ver, "little"), blob)

    def _serve(self) -> None:
        while not self._stop.is_set():
            if not self._rep.poll(_POLL_MS):
                continue
            req = self._rep.recv()
            f = faults.fire("param_service.reply")
            if f is not None and f["kind"] == "delay_reply":
                # stall past the client's timeout; the reply to a client
                # that gave up and reconnected is dropped by the Rep
                faults.sleep_ms(f)
            with self._lock:
                latest = self._latest
            if latest is None:
                self._rep.send_multipart([b"none", b""])
            elif req == b"version":
                # the version-only probe: a poll for a minimum version
                # without shipping the blob
                self._rep.send_multipart([latest[0].to_bytes(8, "little"), b""])
            elif req.startswith(b"fetch?") and len(req) in (14, 18) and int.from_bytes(req[6:14], "little") == latest[0]:
                # the client holds this snapshot: 14 bytes each way, no blob
                self._rep.send_multipart([b"unchanged", b""])
                self._fetch_event(req, latest[0], unchanged=True)
            else:  # any other request is "give me the newest"
                ver, blob = latest
                self._rep.send_multipart([ver.to_bytes(8, "little"), blob])
                if req.startswith(b"fetch?"):
                    self._fetch_event(req, ver, unchanged=False, nbytes=len(blob))

    def _fetch_event(self, req: bytes, version: int, unchanged: bool, nbytes: int = 0) -> None:
        """Mirror one span-tagged fetch into the telemetry sink; a sink
        failure never stops the serve loop."""
        if self._on_event is None or len(req) < 18:
            return
        try:
            self._on_event(
                "param_fetch", span=int.from_bytes(req[14:18], "little"), version=int(version),
                unchanged=bool(unchanged), bytes=int(nbytes),
            )
        except (TypeError, ValueError, OSError):
            pass

    def close(self) -> None:
        self._stop.set()
        for t in self._threads:
            t.join(timeout=2)
        self._sub.close()
        self._rep.close()


class ShardedParameterServer:
    """``num_shards`` independent :class:`ParameterServer` shards on one
    publisher, with a client routed to a shard by crc32 of its id. Each
    shard caches the newest snapshot, so any shard answers any client."""

    def __init__(self, publisher_address: str, num_shards: int = 2, binds: Sequence[str] | None = None):
        if num_shards < 1:
            raise ValueError(f"num_shards must be >= 1, got {num_shards}")
        if binds is not None and len(binds) != num_shards:
            raise ValueError(f"got {len(binds)} bind addresses for {num_shards} shards")
        if binds is None:
            binds = ["tcp://127.0.0.1:*"] * num_shards
        self.shards = [ParameterServer(publisher_address, bind=b) for b in binds]
        self.addresses = [s.address for s in self.shards]

    def address_for(self, client_id: str) -> str:
        """The shard of ``client_id`` (crc32: the same in every process)."""
        return self.addresses[zlib.crc32(client_id.encode()) % len(self.addresses)]

    def close(self) -> None:
        for s in self.shards:
            s.close()


class ParameterClient:
    """Actor and eval side: fetch the newest params when asked (REQ), into
    ``template``'s structure, dtypes and device."""

    def __init__(self, server_address: str, template: Any):
        self._address = server_address
        self._req = self._new_req()
        self.template = template
        self.version = 0
        # the span id appended to every fetch: the server mirrors tagged
        # fetches as 'param_fetch' events
        self.span = 0

    def _new_req(self) -> Req:
        req = Req()
        req.connect(self._address)
        return req

    def _request_once(self, payload: bytes, timeout_ms: int):
        self._req.send(payload)
        if not self._req.poll(timeout_ms):
            # a REQ with a request outstanding can send nothing more: replace it
            self._req.close()
            self._req = self._new_req()
            raise TimeoutError("parameter server did not reply")
        return self._req.recv_multipart()

    def _request(self, payload: bytes, timeout_ms: int, retries: int, backoff_s: float):
        """At most ``retries + 1`` attempts, sleeping ``backoff_s * 2**k``
        after the k-th timeout, then ``TimeoutError``."""
        attempts = max(0, int(retries)) + 1
        for attempt in range(attempts):
            try:
                return self._request_once(payload, timeout_ms)
            except TimeoutError:
                if attempt == attempts - 1:
                    raise TimeoutError(
                        f"parameter server at {self._address} did not reply "
                        f"in {attempts} attempt(s) of {timeout_ms} ms"
                    ) from None
                time.sleep(backoff_s * (2.0 ** attempt))

    def fetch(self, timeout_ms: int = 5000, retries: int = 2, backoff_s: float = 0.25) -> Any | None:
        """The newest params, or None when there is nothing new for this
        client (nothing published yet, or the version it holds)."""
        self.span = (self.span + 1) & 0xFFFFFFFF
        ver, blob = self._request(
            b"fetch?" + self.version.to_bytes(8, "little") + self.span.to_bytes(4, "little"),
            timeout_ms, retries, backoff_s,
        )
        if ver in (b"none", b"unchanged"):
            return None
        view = loads_pytree(self.template, blob)
        self.version = int.from_bytes(ver, "little")
        return view

    def peek_version(self, timeout_ms: int = 5000, retries: int = 0, backoff_s: float = 0.25) -> int:
        """The newest published version without the blob (0 before the
        first publish); does not change :attr:`version`."""
        ver, _ = self._request(b"version", timeout_ms, retries, backoff_s)
        return 0 if ver == b"none" else int.from_bytes(ver, "little")

    def close(self) -> None:
        self._req.close()
