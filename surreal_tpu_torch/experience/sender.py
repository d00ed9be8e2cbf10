"""ExperienceSender, the port of ``surreal_tpu/experience/sender.py``: the
actor-side half of the experience plane.

Routing is a pure function of the env slot (``shard_of_slot``: crc32,
stable across processes), so every transition an env produces lands on
the same shard and the learner-side fan-in reassembles a stationary
mixture.

Backpressure and retry: each shard link bounds its unacked INSERT window
(shm: the slab's slot count, a slot is reused only after its ack;
tcp/pickle: ``insert_slots`` frames). A full window blocks the SENDER
(the collector or staging thread, never the learner), acks are awaited
with a bounded timeout, unacked frames are RESENT with exponential
backoff (the shard dedups by seq), and an exhausted budget marks the
shard dead: its rows are dropped and counted while the rest of the fleet
keeps ingesting, with re-negotiation attempts backed off ``base * 2^k``,
capped, as the SEED worker respawn schedule.

Faults: site ``experience.send`` fires per outgoing frame
(``corrupt_wire_frame`` scrambles the payload on the wire: the shard
counts and drops it and the resend redelivers; ``drop_frame`` and
``delay_frame`` as in the SEED data plane).
"""

from __future__ import annotations

import time
import zlib
from typing import Mapping, Sequence

import numpy as np

from surreal_tpu_torch.experience import wire
from surreal_tpu_torch.experience.link import ShardLinkBase, negotiate_link
from surreal_tpu_torch.utils import faults


def shard_of_slot(slot: int, num_shards: int) -> int:
    """Deterministic env-slot -> shard route (crc32: stable across
    processes, unlike the builtin salted hash) of the slot's 8-byte
    little-endian encoding: crc32 of short ASCII digit strings is
    unbalanced mod small shard counts, while the fixed-width form covers
    every shard within the first ``num_shards`` slots for 2 and 4 shards."""
    return zlib.crc32(int(slot).to_bytes(8, "little")) % num_shards


class _ShardLink(ShardLinkBase):
    """Sender-side shard link: the shared base plus the INSERT-window state
    (slab free slots, the unacked-frame inflight map, the watermark)."""

    def __init__(self, address: str, shard_id: int, identity: str):
        super().__init__(address, shard_id, identity)
        self.free_slots: list[int] = []
        # seq -> [slab slot or None, resendable frame bytes, n rows,
        #         monotonic send stamp (refreshed on resend)]
        self.inflight: dict[int, list] = {}
        self.sent_rows = 0
        self.stale_resends = 0  # consecutive no-ack resend rounds

    def on_slab(self, layout: wire.PlaneSlab) -> None:
        self.free_slots = list(range(layout.slots))


class ExperienceSender:
    def __init__(
        self,
        addresses: Sequence[str],
        spec: wire.PlaneSpec | None,
        num_slots: int,
        slot_rows: int,
        transport: str = "auto",
        insert_slots: int = 4,
        trace: str | None = None,
        retries: int = 3,
        backoff_s: float = 0.25,
        ack_timeout_s: float = 5.0,
        hello_timeout_s: float = 60.0,
        respawn_backoff_s: float = 0.5,
        respawn_backoff_cap_s: float = 30.0,
        name: str = "sender",
        stop_event=None,
    ):
        self.addresses = list(addresses)
        self.spec = spec  # None for the FIFO arm (derived from the first chunk)
        self.mode = transport
        self.slot_rows = int(slot_rows)
        self.insert_slots = max(1, int(insert_slots))
        self.trace = trace
        self.retries = max(0, int(retries))
        self.backoff_s = float(backoff_s)
        self.ack_timeout_s = float(ack_timeout_s)
        self.hello_timeout_s = float(hello_timeout_s)
        self._respawn_base = float(respawn_backoff_s)
        self._respawn_cap = float(respawn_backoff_cap_s)
        # set at plane shutdown: every bounded wait below bails, so the
        # thread running sends can be JOINED before the plane closes the
        # sockets it uses (a socket belongs to one thread)
        self._stop = stop_event
        self.links = [_ShardLink(a, s, f"xp-{name}-{s}") for s, a in enumerate(self.addresses)]
        # env slot -> shard route, precomputed for the row masks
        S = len(self.addresses)
        self.route = np.array([shard_of_slot(i, S) for i in range(int(num_slots))], np.int64)
        self.dropped_rows = 0
        self.resends = 0
        self.rehellos = 0
        self.wire_bytes = 0
        self._rr = 0  # FIFO-arm round-robin cursor
        if self.spec is not None:
            for link in self.links:
                self._negotiate(link, self.hello_timeout_s)

    # -- negotiation ---------------------------------------------------------
    def _negotiate(self, link: _ShardLink, timeout_s: float) -> bool:
        """Hello handshake (``link.negotiate_link``, sent through
        ``_send_raw`` so the fault site and byte accounting cover hellos
        too), then the sender's part: the watermark re-base and the
        inflight invalidation. Failure marks the link dead (revived later
        under the backoff schedule)."""
        renegotiation = link.negotiated  # negotiate_link sets it on success
        obj = negotiate_link(
            link, lambda payload: self._send_raw(link, payload),
            role="sender", spec=self.spec, slot_rows=self.slot_rows,
            slots=self.insert_slots, mode=self.mode, timeout_s=timeout_s,
            trace=self.trace, stop_event=self._stop, seq_base=link.seq,
            # declared, not required: lineage columns are more spec fields
            # to a shard that ignores the cap
            caps=("lineage",),
        )
        if obj is None:
            return self._mark_dead(link)
        # a re-hello re-bases sent_rows below, which breaks the global
        # sent == ingested + dropped + inflight conservation: counted, so
        # the accounting knows when strict conservation no longer applies.
        # (The reference tests link.negotiated after negotiate_link has set
        # it, so it counts every first hello too.)
        if renegotiation:
            self.rehellos += 1
        # a respawned shard restarts empty: re-base the watermark counter on
        # what it holds, so samplers' deferral stays consistent
        link.sent_rows = int(obj.get("ingested_rows", 0))
        for _slot, _f, n, _t in link.inflight.values():
            # frames unacked across a re-hello are never resent: counted,
            # never silent (the shard's dedup compaction relies on it)
            self.dropped_rows += n
        link.inflight.clear()
        link.stale_resends = 0
        return True

    def _mark_dead(self, link: _ShardLink) -> bool:
        link.schedule_backoff(self._respawn_base, self._respawn_cap)
        for slot, _f, n, _t in link.inflight.values():
            # undelivered rows die with the link (counted, never silent)
            self.dropped_rows += n
            if slot is not None and slot not in link.free_slots:
                link.free_slots.append(slot)
        link.inflight.clear()
        return False

    def _revive(self, link: _ShardLink) -> bool:
        if link.negotiated and not link.dead and not link.restarted():
            return True
        if not link.revive_due() and not link.restarted():
            return False  # a shard back at its address is revived at once, not after the backoff
        # first contact gets the generous budget (a spawned shard is still
        # importing); revival probes are quick, the backoff bounds them
        return self._negotiate(link, self.hello_timeout_s if not link.dead else 2.0)

    # -- wire ----------------------------------------------------------------
    def _send_raw(self, link: _ShardLink, payload: bytes) -> None:
        f = faults.fire("experience.send")
        if f is not None:
            if f["kind"] == "drop_frame":
                return  # swallowed on the wire; the ack retry redelivers
            if f["kind"] == "delay_frame":
                faults.sleep_ms(f)
            elif f["kind"] == "corrupt_wire_frame":
                # scramble the frame on the wire (length kept): the shard
                # must count and drop it, and the resend must redeliver
                corrupted = bytearray(payload)
                for i in range(0, len(corrupted), 7):
                    corrupted[i] ^= 0xA5
                payload = bytes(corrupted)
        self.wire_bytes += len(payload)
        link.sock.send(payload)

    def _pump(self, link: _ShardLink, timeout_ms: int = 0) -> None:
        """Drain acks on one link (non-blocking by default)."""
        while link.sock.poll(timeout_ms):
            timeout_ms = 0
            kind, obj = wire.decode_payload(link.sock.recv())
            if kind == "msg":
                kind = obj.get("kind", "?")
            if kind == "insert_ok":
                entry = link.inflight.pop(int(obj["seq"]), None)
                link.stale_resends = 0
                if entry is not None and entry[0] is not None:
                    link.free_slots.append(entry[0])

    def _retry_stale(self, link: _ShardLink) -> None:
        """Liveness for half-open links: an unacked frame older than the
        ack budget is resent even when the window is NOT full (otherwise a
        dropped or corrupted frame would redeliver only once the window
        filled, and a watermarked sample would stall until the shard's
        deferral timeout). Staleness is per frame (its own send stamp,
        refreshed on resend); ``retries`` consecutive no-ack resend rounds
        declare the shard dead."""
        if not link.inflight:
            return
        now = time.monotonic()
        stale = [entry for entry in link.inflight.values() if now - entry[3] >= self.ack_timeout_s]
        if not stale:
            return
        if link.stale_resends >= self.retries:
            self._mark_dead(link)
            return
        link.stale_resends += 1
        self.resends += len(stale)
        for entry in stale:
            self._send_raw(link, entry[1])
            entry[3] = now

    def _await_window(self, link: _ShardLink, need_slot: bool) -> bool:
        """Block (the collector thread, never the learner) until the link
        has send credit: an ack frees a slab slot or an inflight entry.
        Bounded: ``retries`` resend rounds with exponential backoff, then
        the shard is declared dead and its rows drop."""
        window = len(link.views) or self.insert_slots
        for attempt in range(self.retries + 1):
            deadline = time.monotonic() + self.ack_timeout_s
            while time.monotonic() < deadline:
                if self._stop is not None and self._stop.is_set():
                    self._mark_dead(link)  # counts the inflight rows
                    return False
                # credit first: the reference pumps (up to 50 ms) before it
                # looks, so a send with credit waits out the poll
                if len(link.inflight) < window and (not need_slot or link.free_slots):
                    return True
                self._pump(link, timeout_ms=50)
            # resend every unacked frame (the shard dedups by seq)
            if attempt < self.retries:
                self.resends += len(link.inflight)
                now = time.monotonic()
                for _seq, entry in sorted(link.inflight.items()):
                    self._send_raw(link, entry[1])
                    entry[3] = now
                wait = self.backoff_s * 2.0 ** attempt
                if self._stop is not None:
                    if self._stop.wait(wait):
                        self._mark_dead(link)
                        return False
                else:
                    time.sleep(wait)
        self._mark_dead(link)
        return False

    def _send_insert(self, link: _ShardLink, spec: wire.PlaneSpec, rows: Mapping[str, np.ndarray], n: int) -> bool:
        if not self._revive(link):
            self.dropped_rows += n
            return False
        self._pump(link)
        self._retry_stale(link)
        if link.dead:
            self.dropped_rows += n
            return False
        need_slot = link.transport == "shm"
        if not self._await_window(link, need_slot):
            self.dropped_rows += n
            return False
        link.seq += 1
        t_send = time.time() if wire.local_address(link.address) else 0.0
        if link.transport == "shm":
            slot = link.free_slots.pop(0)
            v = link.views[slot]
            for name in spec.names():
                v[name][:n] = rows[name][:n]
            frame = wire.encode_insert(link.seq, n, slot, t_send=t_send)
            link.inflight[link.seq] = [slot, frame, n, time.monotonic()]
        elif link.transport == "pickle":
            frame = wire.encode_pickle_msg({
                "kind": "insert", "seq": link.seq, "n": n,
                "rows": {k: np.ascontiguousarray(v[:n]) for k, v in rows.items()},
                "t_send": t_send,
            })
            link.inflight[link.seq] = [None, frame, n, time.monotonic()]
        else:
            frame = wire.encode_insert(link.seq, n, 0, t_send=t_send, body=spec.pack(rows, n))
            link.inflight[link.seq] = [None, frame, n, time.monotonic()]
        self._send_raw(link, frame)
        link.sent_rows += n
        return True

    # -- public API ----------------------------------------------------------
    def send_rows(self, rows: Mapping[str, np.ndarray], slots: np.ndarray) -> list[int]:
        """Hash-route a flat transition batch to its shards; returns the
        per-shard sent-row watermarks AFTER this batch (the sampler's
        deferral contract). ``slots[i]`` is row i's env slot. A bfloat16
        field (``spec.bf16``) is given as its 16-bit words."""
        flat = wire.flatten_fields(rows)
        targets = self.route[np.asarray(slots, np.int64)]
        for s, link in enumerate(self.links):
            mask = targets == s
            n = int(mask.sum())
            if n == 0:
                continue
            sub = {k: np.ascontiguousarray(v[mask]) for k, v in flat.items()}
            self._send_insert(link, self.spec, sub, n)
        return self.watermarks()

    def send_chunk(self, chunk: Mapping[str, np.ndarray]) -> bool:
        """FIFO arm (SEED): ship one whole trajectory chunk to the next
        shard round-robin. The chunk's spec is derived from the chunk
        (rows = its time axis)."""
        flat = {k: np.ascontiguousarray(v) for k, v in wire.flatten_fields(chunk).items()}
        n = int(next(iter(flat.values())).shape[0])
        spec = wire.PlaneSpec([(k, v.shape[1:], v.dtype) for k, v in flat.items()])
        if self.spec is None or not self.spec.matches(spec):
            self.spec = spec
            self.slot_rows = max(self.slot_rows, n)
            for link in self.links:
                link.negotiated = False  # re-hello with the (new) spec
        link = self.links[self._rr % len(self.links)]
        self._rr += 1
        ok = self._send_insert(link, self.spec, flat, n)
        if not ok and len(self.links) > 1:
            # dead shard: route this chunk to the next one instead of
            # dropping a whole trajectory (its rows already counted dropped)
            link = self.links[self._rr % len(self.links)]
            self._rr += 1
            ok = self._send_insert(link, self.spec, flat, n)
        return ok

    def watermarks(self) -> list[int]:
        return [link.sent_rows for link in self.links]

    def inflight_rows(self) -> int:
        """Rows sent but not yet acked (nor invalidated into
        ``dropped_rows``): the slack term of the exactly-once conservation
        ``sent == ingested + dropped + inflight``, which holds at a
        quiesced boundary when no re-hello re-based a watermark
        (``rehellos == 0``)."""
        return int(sum(entry[2] for link in self.links for entry in list(link.inflight.values())))

    def gauges(self) -> dict[str, float]:
        return {
            "sent_rows": float(sum(link.sent_rows for link in self.links)),
            "dropped_rows": float(self.dropped_rows),
            "resends": float(self.resends),
            "rehellos": float(self.rehellos),
            "inflight_rows": float(self.inflight_rows()),
            "wire_bytes_out": float(self.wire_bytes),
            "dead_links": float(sum(1 for link in self.links if link.dead)),
        }

    def close(self) -> None:
        for link in self.links:
            link.close()
