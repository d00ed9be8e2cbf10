"""GatewayServer, the port of ``surreal_tpu/gateway/server.py``: the
tenant-facing session tier in front of the
:class:`~surreal_tpu_torch.distributed.fleet.InferenceFleet`:
attach, act and detach over the gateway wire protocol, admission control,
migrating session state, version pinning and the act cache.

Shape: one ROUTER (``distributed/sockets.py``) at a FIXED address
(``utils/net.py::alloc_address``), bound in one serve thread supervised
under ``utils/respawn.py::RespawnSchedule``. Each loop pass (at most
``FRAMES_PER_PASS`` frames, where the reference serves until its inbox
is empty, which under sustained traffic starves the rest of the pass):

1. fires the ``gateway.session`` fault site (``drop_frame`` swallows the
   next act reply, and the client's bounded resend recovers;
   ``kill_replica`` kills the acting session's bound fleet replica, and
   the heal below must migrate);
2. **heals**: every session bound to a replica the fleet no longer lists
   alive is rebound to a survivor by the rendezvous rule that placed it
   (``fleet.replica_of(crc32(session id))``), counted as a migration;
   clients never notice;
3. **reaps** sessions idle past their lease (quota released, pins
   dropped, counted);
4. **drains** the per-tenant backpressure queues as the token buckets
   refill (oldest first);
5. serves frames: an admitted act goes to the session's bound replica
   through ``fleet.serve_act``, which takes the slot's lock and serves a
   pinned version from the fleet's act history (real snapshots: the
   learns are out of place). A pin whose version has left the history
   takes the counted catch-up (unpinned, the current version,
   ``F_UNPINNED`` on the reply). Results land in a bounded LRU act cache
   keyed on (version, digest of the obs bytes), so a repeated
   observation at one version skips the forward (hits and misses
   counted).

The gateway holds no module of its own: every act goes through the
fleet, on the card one host-to-device copy of the obs and one
device-to-host copy of the actions.

Input hardening: every frame is served behind a frame boundary. A
malformed, truncated or hostile payload is counted
(``gateway/bad_frames``) and answered where possible, never allowed to
end the serve loop; a peer whose bytes are not the socket framing at all
is dropped by the ROUTER (``max_frame_bytes``). The pickle fallback
deserializes only for sessions that negotiated it
(``gateway/protocol.py``), and a re-attach needs the granted resume
token, not just a session id.

Not ported yet: the ops plane's push (an ``ops_address`` raises, naming
it).
"""

from __future__ import annotations

import hashlib
import struct
import threading
import time
import zlib
from collections import OrderedDict, deque

import numpy as np

from surreal_tpu_torch.distributed import sockets
from surreal_tpu_torch.gateway import protocol as gw
from surreal_tpu_torch.gateway.admission import AdmissionController
from surreal_tpu_torch.gateway.table import SessionRecord, SessionTable
from surreal_tpu_torch.session.telemetry import head_sampled, latency_percentiles
from surreal_tpu_torch.utils import faults
from surreal_tpu_torch.utils.net import alloc_address
from surreal_tpu_torch.utils.respawn import RespawnSchedule

# the longest message a tenant may send: a frame declaring more is not
# the framing, and its connection is dropped
MAX_FRAME_BYTES = 1 << 26
# frames served in one loop pass: under sustained traffic the inbox never
# empties, and the pass's fault site, heal, reap and queue drain must
# still run
FRAMES_PER_PASS = 64


class GatewayServer:
    """Runs the session loop in a background thread.

    Args:
      fleet: the :class:`InferenceFleet` this gateway fronts (routing,
        version-aware serving, liveness).
      bind: fixed service address (default: ``alloc_address()``).
      max_sessions: global session cap (0 = unbounded).
      lease_s: idle lease; any frame from a session renews it.
      tenant_quotas: {tenant: {max_sessions, rate, burst, queue_depth}};
        the ``default`` entry covers unlisted tenants.
      act_cache: LRU act-result cache capacity (0 disables).
      pin_versions: honor per-session version-pin requests.
      fanout: optional ``ParameterFanout``: session pins also hold the
        pinned version's full frame publisher-side.
    """

    def __init__(
        self,
        fleet,
        *,
        bind: str | None = None,
        max_sessions: int = 256,
        lease_s: float = 30.0,
        tenant_quotas: dict | None = None,
        act_cache: int = 256,
        pin_versions: bool = True,
        fanout=None,
        trace_id: str | None = None,
        respawn_backoff_s: float = 0.5,
        respawn_backoff_cap_s: float = 30.0,
        ops_address: str | None = None,
        span_sink=None,
        trace_sample_n: int = 0,
    ):
        if ops_address is not None:
            raise NotImplementedError(
                "GatewayServer(ops_address=...): the ops plane (session/opsplane.py) is not ported to PyTorch yet"
            )
        self.fleet = fleet
        self.address = bind or alloc_address()
        self.lease_s = float(lease_s)
        self.pin_versions = bool(pin_versions)
        self.fanout = fanout
        self.trace_id = trace_id
        self.admission = AdmissionController(tenant_quotas, max_sessions_total=int(max_sessions))
        self.table = SessionTable()
        # the negotiated obs geometry of each session (raw ACT bodies decode
        # with it); not journaled: a re-attaching client negotiates it again
        self._obs_specs: dict[str, tuple[tuple, np.dtype]] = {}
        # the resume tokens: the re-attach credential (the session id alone
        # routes but does not authenticate); never journaled
        self._resume_tokens: dict[str, str] = {}
        # each session's negotiated capabilities (the hello's "caps"):
        # "trace" opts its acts into the head-sampled causal span exemplars
        self._session_caps: dict[str, set] = {}
        self._span_sink = span_sink
        self.trace_sample_n = int(trace_sample_n)
        self._cache_cap = int(act_cache)
        self._cache: "OrderedDict[tuple, tuple[np.ndarray, int]]" = OrderedDict()
        self.attaches = 0
        self.reattaches = 0
        self.detaches = 0
        self.acts = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.catch_ups = 0
        self.dropped_replies = 0
        self.bad_frames = 0
        self.respawns = 0
        self.respawn_backoff_s = 0.0
        # rolling windows: the act's serve time (receipt -> reply), the
        # tenant -> gateway transit (only frames stamped under the local
        # clock guard) and the attach handling time
        self._hop_act: "deque[float]" = deque(maxlen=512)
        self._hop_transit: "deque[float]" = deque(maxlen=512)
        self._hop_attach: "deque[float]" = deque(maxlen=512)
        self._drop_next_reply = 0
        self._tenant_acts: dict[str, int] = {}
        self._last_replica: int | None = None
        self._sched = RespawnSchedule(1, respawn_backoff_s, respawn_backoff_cap_s)
        self._lock = threading.Lock()  # supervise against close
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name="gateway")
        self._thread.start()

    # -- lifecycle -----------------------------------------------------------
    @property
    def alive(self) -> bool:
        return self._thread.is_alive()

    def supervise(self) -> None:
        """Respawn a dead serve thread in place (the same fixed address and
        table: sessions survive their gateway's crash) under the backoff
        schedule."""
        with self._lock:
            now = time.monotonic()
            if self._thread.is_alive():
                self._sched.note_alive(0, now)
                return
            if not self._sched.due(0, now):
                return
            self.respawns += 1
            self.respawn_backoff_s = self._sched.respawned(0, now)
            self._thread = threading.Thread(target=self._loop, daemon=True, name="gateway")
            self._thread.start()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2)
        if self.fanout is not None:
            for v, n in self.table.pinned_versions().items():
                for _ in range(n):
                    self.fanout.release_pin(v)

    # -- the loop ------------------------------------------------------------
    def _loop(self) -> None:
        # bound in the serve thread, so a crashed loop's finally releases
        # the socket and a supervised respawn can rebind the fixed address
        sock = sockets.Router(self.address, max_frame_bytes=MAX_FRAME_BYTES)
        try:
            self._loop_body(sock)
        finally:
            sock.close()

    def _loop_body(self, sock) -> None:
        while not self._stop.is_set():
            f = faults.fire("gateway.session")
            if f is not None:
                self._apply_fault(f)
            self._heal(sock)
            expired = self.table.expire_idle(self.lease_s)
            if expired:
                self.admission.note_expired(len(expired))
                for rec in expired:
                    self._forget(rec)
            for tenant in list(self.admission.tenants()):
                for req in self.admission.drain(tenant):
                    self._serve_one(sock, req)
            if not sock.poll(50):
                continue
            for _ in range(FRAMES_PER_PASS):
                try:
                    ident, payload = sock.recv_multipart()
                except sockets.Again:
                    break
                try:
                    self._handle_frame(sock, ident, payload)
                except Exception:
                    # the frame boundary: any tenant frame (malformed,
                    # truncated, hostile) is counted and dropped here, never
                    # unwinding the serve loop into a respawn backoff
                    self.bad_frames += 1

    def _handle_frame(self, sock, ident: bytes, payload: bytes) -> None:
        """Serve ONE tenant frame. Raising is allowed (the caller's frame
        boundary counts it), but every anticipated bad input gets a
        reasoned reply."""
        try:
            kind, obj = gw.decode_payload(payload)
        except (ValueError, KeyError, IndexError, EOFError, struct.error):
            # not ours, a truncated header, garbage: counted, never reaches
            # a deserializer
            self.bad_frames += 1
            return
        if kind == "hello":
            t0 = time.monotonic()
            self._handle_hello(sock, ident, obj)
            self._hop_attach.append((time.monotonic() - t0) * 1e3)
        elif kind == "act":
            sid = obj["session"]
            self._note_transit(obj.get("t_send", 0.0))
            try:
                obs = self._act_obs(obj)
            except ValueError as e:
                # a body that does not fit the negotiated spec: a reasoned
                # reply, not a frombuffer crash
                self.bad_frames += 1
                self._reply(sock, ident, gw.encode_act_err(obj["seq"], f"bad obs body: {e}", sid))
                return
            if obs is None:
                self._reply(sock, ident, gw.encode_act_err(obj["seq"], "unknown session", sid))
                return
            self._admit_act(sock, (ident, sid, obj["seq"], obs))
        elif kind == "pmsg":
            self._handle_pmsg(sock, ident, obj)
        elif kind == "detach":
            rec = self.table.detach(obj["session"])
            if rec is not None:
                self.detaches += 1
                self._forget(rec)
            self._reply(sock, ident, gw.encode_detach_ok(obj["session"], rec.acts if rec else 0))

    def _forget(self, rec: SessionRecord) -> None:
        """A detached or expired session's pin, spec, token and caps."""
        self._release_pin(rec)
        self._obs_specs.pop(rec.session, None)
        self._resume_tokens.pop(rec.session, None)
        self._session_caps.pop(rec.session, None)

    def _handle_pmsg(self, sock, ident: bytes, obj: dict) -> None:
        """The negotiated pickle fallback's act request. The envelope's
        session id is checked against the table BEFORE anything is
        unpickled: only a session that negotiated ``transport='pickle'``
        gets its bytes deserialized."""
        sid = obj["session"]
        rec = self.table.get(sid)
        if rec is None:
            self._reply(sock, ident, gw.encode_act_err(0, "unknown session", sid))
            return
        if rec.transport != "pickle":
            self.bad_frames += 1
            self._reply(sock, ident, gw.encode_act_err(0, "pickle transport not negotiated for this session", sid))
            return
        try:
            msg = gw.decode_pickle_body(obj["body"])
            if not isinstance(msg, dict) or msg.get("kind") != "act":
                raise ValueError("fallback frame is not an act dict")
            seq = int(msg["seq"])
            obs = np.asarray(msg["obs"])
            self._note_transit(float(msg.get("t_send", 0.0)))
        except Exception:
            # a corrupt or hostile fallback body: counted and answered; the
            # session and the tier survive it
            self.bad_frames += 1
            self._reply(sock, ident, gw.encode_act_err(0, "undecodable fallback act frame", sid))
            return
        self._admit_act(sock, (ident, rec.session, seq, obs))

    def _apply_fault(self, f: dict) -> None:
        kind = f["kind"]
        if kind == "delay":
            faults.sleep_ms(f)
        elif kind == "drop_frame":
            # swallow the NEXT act reply: the tenant's bounded resend
            # re-serves the same session and seq
            self._drop_next_reply += 1
        elif kind == "kill_replica":
            # kill the acting session's bound replica like a crash; the heal
            # migrates its sessions, and the fleet respawns it in place
            slot = self._last_replica
            if slot is None:
                bound = {r.replica for r in self.table.records()}
                both = sorted(bound & set(self.fleet._alive_slots()))
                slot = both[0] if both else None
            if slot is not None:
                srv = self.fleet._replicas[slot]
                if srv is not None and srv.alive:
                    srv.close()

    def _heal(self, sock) -> None:
        """Rebind the sessions whose replica the fleet no longer lists
        alive (the migration happens between acts)."""
        alive = set(self.fleet._alive_slots())
        if not alive:
            return  # nothing to rebind TO; the fleet's supervisor first
        dead = {r.replica for r in self.table.records()} - alive
        for slot in dead:
            self.table.rebind(slot, lambda sid: self.fleet.replica_of(zlib.crc32(sid.encode())))

    def _note_transit(self, t_send: float) -> None:
        """One tenant -> gateway transit sample; a client outside the local
        clock guard stamps 0 and gives none (clock skew is not latency)."""
        if t_send and t_send > 0:
            self._hop_transit.append(max(0.0, (time.time() - t_send) * 1e3))

    # -- frame handlers ------------------------------------------------------
    def _reply(self, sock, ident: bytes, payload: bytes) -> None:
        if self._drop_next_reply > 0 and payload[4:5] == bytes([gw.ACT_OK]):
            self._drop_next_reply -= 1
            self.dropped_replies += 1
            return
        sock.send_multipart([ident, payload])

    def _handle_hello(self, sock, ident: bytes, obj: dict) -> None:
        transport = obj.get("transport", "tcp")
        if transport not in ("tcp", "pickle"):
            self._reply(sock, ident, gw.encode_hello_no(f"transport {transport!r} not in tcp|pickle"))
            return
        tenant = str(obj.get("tenant", "default"))
        try:
            spec = self._parse_obs_spec(obj)
        except (TypeError, ValueError) as e:
            # the tenant's error, not the tier's crash: a reasoned
            # GHELLO_NO before anything is installed
            self._reply(sock, ident, gw.encode_hello_no(f"bad obs spec: {e}"))
            return
        sid = obj.get("session")
        if sid:
            rec = self.table.get(str(sid))
            if rec is not None:
                # a re-attach after client churn keeps the binding and any
                # pin, once the resumer proves ownership (the same tenant
                # AND the granted resume token); a guessed id resumes and
                # renews nothing
                if tenant != rec.tenant or obj.get("token") != self._resume_tokens.get(rec.session):
                    self.admission.note_rejected(tenant)
                    self._reply(sock, ident, gw.encode_hello_no("session resume denied (tenant/token mismatch)"))
                    return
                self.table.touch(rec.session)
                self.reattaches += 1
                self._obs_specs[rec.session] = spec
                self._session_caps[rec.session] = set(obj.get("caps") or ())
                self._reply(sock, ident, gw.encode_hello_ok(
                    rec.session, self.lease_s, rec.transport, rec.replica, rec.pinned_version,
                    token=self._resume_tokens.get(rec.session),
                ))
                return
        reason = self.admission.admit_session(tenant, self.table.tenant_counts().get(tenant, 0), len(self.table))
        if reason is not None:
            self._reply(sock, ident, gw.encode_hello_no(reason))
            return
        pin = obj.get("pin_version")
        if pin is not None and self.pin_versions:
            pin = int(pin)
            if pin not in self.fleet.held_versions():
                self._reply(sock, ident, gw.encode_hello_no(
                    f"version {pin} not held (held: {self.fleet.held_versions()})"))
                return
            if self.fanout is not None:
                try:
                    self.fanout.pin_version(pin)
                except KeyError:
                    pass  # the fleet holds the act function; the frame hold is best effort
        else:
            pin = None
        sid = gw.new_session_id()
        token = gw.new_resume_token()
        replica = self.fleet.replica_of(zlib.crc32(sid.encode()))
        rec = SessionRecord(sid, tenant, replica, transport=transport, pinned_version=pin)
        self.table.attach(rec)
        self.attaches += 1
        self._obs_specs[sid] = spec
        self._resume_tokens[sid] = token
        self._session_caps[sid] = set(obj.get("caps") or ())
        self._reply(sock, ident, gw.encode_hello_ok(sid, self.lease_s, transport, replica, pin, token=token))

    @staticmethod
    def _parse_obs_spec(obj: dict) -> tuple[tuple, np.dtype]:
        """The hello's obs geometry, checked up front (``np.dtype`` of a
        hostile string raises TypeError, which belongs in a GHELLO_NO)."""
        return tuple(int(d) for d in obj.get("obs_shape", ())), np.dtype(obj.get("obs_dtype", "<f4"))

    def _act_obs(self, obj: dict) -> np.ndarray | None:
        spec = self._obs_specs.get(obj["session"])
        if spec is None:
            return None
        shape, dtype = spec
        body = obj["body"]
        expected = int(np.prod(shape, dtype=np.int64)) * dtype.itemsize
        if body.nbytes != expected:
            raise ValueError(f"{body.nbytes} bytes against negotiated spec {shape}/{dtype.str} ({expected} bytes)")
        # a copy: the act function hands it to torch, which wants writable memory
        return np.frombuffer(body, dtype).reshape(shape).copy()

    def _admit_act(self, sock, req: tuple) -> None:
        ident, sid, seq, obs = req
        rec = self.table.get(sid)
        if rec is None:
            self._reply(sock, ident, gw.encode_act_err(seq, "unknown session", sid))
            return
        if self.admission.try_act(rec.tenant):
            self._serve_one(sock, req)
            return
        evicted = self.admission.enqueue(rec.tenant, req)
        if evicted is not None:
            ev_ident, ev_sid, ev_seq, _ = evicted
            self._reply(sock, ev_ident, gw.encode_act_err(ev_seq, "evicted by backpressure (tenant queue full)",
                                                          ev_sid))

    def _catch_up(self, rec: SessionRecord) -> None:
        """The counted catch-up: the pin's version has left the history, so
        the session is unpinned EXPLICITLY and that version's cache entries
        dropped."""
        self.catch_ups += 1
        self._purge_cache_version(rec.pinned_version)
        self._release_pin(rec)
        self.table.pin(rec.session, None)

    def _serve_act(self, rec: SessionRecord, obs, span_child):
        """``fleet.serve_act`` for ``rec``: (actions, served version). A pin
        evicted between the held check and the serve (the learn thread's
        ``set_act_fn``) takes the catch-up and serves the current version;
        a dead bound replica raises LookupError."""
        try:
            return self.fleet.serve_act(obs, replica=rec.replica, version=rec.pinned_version, span_ctx=span_child)
        except KeyError:  # before LookupError: KeyError IS a LookupError
            self._catch_up(rec)
            return self.fleet.serve_act(obs, replica=rec.replica, span_ctx=span_child)

    def _serve_one(self, sock, req: tuple) -> None:
        ident, sid, seq, obs = req
        rec = self.table.get(sid)
        if rec is None:
            self._reply(sock, ident, gw.encode_act_err(seq, "session expired while queued", sid))
            return
        t0 = time.monotonic()
        flags = 0
        pinned = rec.pinned_version
        # the head-sampled causal exemplar: the root span of a gateway ->
        # replica -> learner tree; serve_act emits replica.forward under
        # the child and the replica adopts the exemplar for its next chunk
        span_root = self._trace_root(rec, seq)
        span_child = span_root.child(self._span_sink.next_span_id()) if span_root is not None else None
        if rec.pinned_version is not None and rec.pinned_version not in self.fleet.held_versions():
            # catch up BEFORE the cache lookup, so a dead pin cannot keep
            # serving stale cached hits without the counted path
            self._catch_up(rec)
            flags |= gw.F_UNPINNED
        version_key = self._version_key(rec)
        digest = None
        if self._cache_cap > 0:
            digest = hashlib.blake2b(obs.tobytes() + str((obs.shape, obs.dtype.str)).encode(),
                                     digest_size=16).digest()
            hit = self._cache.get((version_key, digest))
            if hit is not None:
                self._cache.move_to_end((version_key, digest))
                self.cache_hits += 1
                actions, served = hit
                self._finish_act(sock, ident, rec, seq, actions, served, flags | gw.F_CACHED, t0)
                if span_root is not None:
                    # a hit never reaches a replica: the root is the tree
                    self._span_sink.emit_span("gateway.act", span_root, tier="gateway",
                                              dur_ms=(time.monotonic() - t0) * 1e3, tenant=rec.tenant,
                                              seq=int(seq), cached=True)
                return
            self.cache_misses += 1
        try:
            try:
                actions, served = self._serve_act(rec, obs, span_child)
            except LookupError:
                # the bound replica died between heal passes: migrate NOW and
                # serve from the survivor
                self._heal(sock)
                rec = self.table.get(sid)
                if rec is None:
                    return
                actions, served = self._serve_act(rec, obs, span_child)
        except LookupError:
            self._reply(sock, ident, gw.encode_act_err(seq, "no alive replica", sid))
            return
        if pinned is not None and rec.pinned_version is None:
            flags |= gw.F_UNPINNED  # a catch-up: never a silent jump
        if self._cache_cap > 0 and digest is not None:
            self._cache[(served, digest)] = (actions, served)
            self._cache.move_to_end((served, digest))
            while len(self._cache) > self._cache_cap:
                self._cache.popitem(last=False)
        self._finish_act(sock, ident, rec, seq, actions, served, flags, t0)
        if span_root is not None:
            self._span_sink.emit_span("gateway.act", span_root, tier="gateway", dur_ms=(time.monotonic() - t0) * 1e3,
                                      tenant=rec.tenant, seq=int(seq), version=int(served))

    def _trace_root(self, rec: SessionRecord, seq: int):
        """The act's root ``TraceContext``, or None: it needs a span sink,
        sampling on, the session's "trace" capability and the 1-in-N head
        sample over the session's seq stream."""
        sink = self._span_sink
        if sink is None or self.trace_sample_n <= 0:
            return None
        if "trace" not in self._session_caps.get(rec.session, ()):
            return None
        if not head_sampled(seq, self.trace_sample_n):
            return None
        return sink.trace_context(f"gw:{rec.session[:6]}:a{int(seq)}")

    def _finish_act(self, sock, ident, rec, seq, actions, served, flags, t0) -> None:
        self.table.touch(rec.session, seq=seq)
        self.acts += 1
        self._tenant_acts[rec.tenant] = self._tenant_acts.get(rec.tenant, 0) + 1
        self._last_replica = rec.replica
        self._hop_act.append((time.monotonic() - t0) * 1e3)
        self._reply(sock, ident, gw.encode_act_ok(seq, served, actions, flags=flags, t_send=time.time()))

    def _version_key(self, rec: SessionRecord) -> int:
        """The version a forward for this session WOULD serve: the pin, else
        the bound replica's applied version (the counter ``serve_act``
        returns, which keys the store), so lookups and stores share one
        source."""
        if rec.pinned_version is not None:
            return int(rec.pinned_version)
        srv = self.fleet._replicas[rec.replica] if 0 <= rec.replica < len(self.fleet._replicas) else None
        if srv is not None and srv.alive:
            return int(srv.version)
        return int(self.fleet.version)

    def _purge_cache_version(self, version: int | None) -> None:
        """Drop every cache entry served at ``version`` (an evicted pin's
        entries must not outlive its act function)."""
        for key in [k for k in self._cache if k[0] == version]:
            del self._cache[key]

    def _release_pin(self, rec: SessionRecord) -> None:
        if self.fanout is not None and rec.pinned_version is not None:
            self.fanout.release_pin(rec.pinned_version)

    # -- observability -------------------------------------------------------
    def gauges(self) -> dict[str, float]:
        """The ``gateway/*`` gauges (``session/costs.py::GAUGE_REGISTRY``)."""
        out = {
            "gateway/sessions": float(len(self.table)),
            "gateway/attaches": float(self.attaches),
            "gateway/reattaches": float(self.reattaches),
            "gateway/detaches": float(self.detaches),
            "gateway/acts": float(self.acts),
            "gateway/cache_hits": float(self.cache_hits),
            "gateway/cache_misses": float(self.cache_misses),
            "gateway/migrations": float(self.table.migrations),
            "gateway/catch_ups": float(self.catch_ups),
            "gateway/pinned_sessions": float(sum(self.table.pinned_versions().values())),
            "gateway/dropped_replies": float(self.dropped_replies),
            "gateway/bad_frames": float(self.bad_frames),
            "gateway/respawns": float(self.respawns),
        }
        out.update(self.admission.gauges())
        return out

    def hop_stats(self) -> dict[str, dict]:
        out = {}
        for name, window in (
            ("gateway_act_ms", self._hop_act),
            ("gateway_transit_ms", self._hop_transit),
            ("gateway_attach_ms", self._hop_attach),
        ):
            p = latency_percentiles(list(window))
            if p is not None:
                out[name] = p
        return out

    def tenant_stats(self) -> dict[str, dict]:
        """Per-tenant table for diag's Gateway section."""
        counts = self.table.tenant_counts()
        out: dict[str, dict] = {}
        for name, t in self.admission.tenants().items():
            out[name] = {
                "sessions": counts.get(name, 0),
                "max_sessions": t.max_sessions,
                "rate": t.bucket.rate,
                "acts": self._tenant_acts.get(name, 0),
                "queued": len(t.queue),
                "throttled": t.throttled,
                "evicted": t.evicted,
                "rejected": t.rejected,
            }
        for name, n in counts.items():
            if name not in out:
                out[name] = {"sessions": n, "acts": self._tenant_acts.get(name, 0)}
        return out

    def event(self) -> dict:
        """The ``gateway`` telemetry event's body (diag's "Gateway")."""
        hits, misses = self.cache_hits, self.cache_misses
        return {
            "address": self.address,
            "tenants": self.tenant_stats(),
            "pinned_versions": {str(v): n for v, n in self.table.pinned_versions().items()},
            "cache_hit_rate": hits / max(hits + misses, 1),
            "lease_s": self.lease_s,
            **self.gauges(),
        }
