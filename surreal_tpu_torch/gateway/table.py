"""The gateway's session table, the port of ``surreal_tpu/gateway/table.py``:
(tenant, session id, replica binding, pinned param version, last-act seq)
per session, checkpointed incrementally as wire frames.

Every mutation encodes as one ``gateway/protocol.py`` JOURNAL frame,
bytes any transport can carry, and ``SessionTable.replay`` folds a frame
stream back into the live table (the frames are the reference's, so
either package's journal replays in the other). The journal compacts
itself (the live sessions re-encoded as attach ops once the op log
outgrows the table), so the checkpoint stream is bounded by the session
population, not by its history.

Migration: on a replica's death the gateway calls :meth:`rebind`, and
every session bound to it moves to the survivor the fleet's rendezvous
rule names (``fleet.replica_of`` over the alive set), counted per move.
Clients never see it: their next act serves from the survivor.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Iterable

from surreal_tpu_torch.gateway.protocol import decode_payload, encode_journal


class SessionRecord:
    __slots__ = ("session", "tenant", "replica", "pinned_version",
                 "last_act_seq", "attached_at", "last_seen", "transport",
                 "acts", "migrations")

    def __init__(self, session: str, tenant: str, replica: int,
                 transport: str = "tcp",
                 pinned_version: int | None = None):
        self.session = session
        self.tenant = tenant
        self.replica = int(replica)
        self.pinned_version = pinned_version
        self.last_act_seq = 0
        self.attached_at = time.monotonic()
        self.last_seen = self.attached_at
        self.transport = transport
        self.acts = 0
        self.migrations = 0

    def to_op(self, op: str = "attach") -> dict:
        return {
            "op": op,
            "session": self.session,
            "tenant": self.tenant,
            "replica": self.replica,
            "pinned_version": self.pinned_version,
            "last_act_seq": self.last_act_seq,
            "transport": self.transport,
        }


class SessionTable:
    """The gateway-owned session map + its incremental checkpoint.

    Thread-safe (the serve thread mutates; supervise/telemetry read).
    ``sink`` (optional) receives every journal frame as it is cut — the
    hook the server uses to ship the checkpoint over a live wire."""

    # journal self-compaction threshold: ops kept per live session
    _COMPACT_FACTOR = 8

    def __init__(self, sink: Callable[[bytes], None] | None = None):
        self._records: dict[str, SessionRecord] = {}
        self._journal: list[bytes] = []
        self._sink = sink
        self._lock = threading.Lock()
        self.migrations = 0

    # -- mutations (each cuts one journal frame) -----------------------------
    def _cut(self, op: dict) -> None:
        frame = encode_journal(op)
        self._journal.append(frame)
        if len(self._journal) > max(
            self._COMPACT_FACTOR * max(len(self._records), 1), 64
        ):
            # compact: the live table re-encoded as attach ops replaces
            # the op history (replay-equivalent, population-bounded)
            self._journal = [
                encode_journal(r.to_op()) for r in self._records.values()
            ]
        if self._sink is not None:
            self._sink(frame)

    def attach(self, record: SessionRecord) -> None:
        with self._lock:
            self._records[record.session] = record
            self._cut(record.to_op())

    def touch(self, session: str, seq: int | None = None) -> SessionRecord | None:
        """Renew a session's lease (any frame does); seq advances the
        last-act watermark. Touches are NOT journaled — the checkpoint
        carries bindings, not heartbeats."""
        with self._lock:
            rec = self._records.get(session)
            if rec is None:
                return None
            rec.last_seen = time.monotonic()
            if seq is not None:
                rec.last_act_seq = max(rec.last_act_seq, int(seq))
                rec.acts += 1
            return rec

    def pin(self, session: str, version: int | None) -> None:
        with self._lock:
            rec = self._records.get(session)
            if rec is None:
                return
            rec.pinned_version = version
            self._cut({"op": "pin", "session": session, "version": version})

    def detach(self, session: str) -> SessionRecord | None:
        with self._lock:
            rec = self._records.pop(session, None)
            if rec is not None:
                self._cut({"op": "detach", "session": session})
            return rec

    def rebind(self, dead_replica: int,
               choose: Callable[[str], int]) -> list[SessionRecord]:
        """Move every session bound to ``dead_replica`` to the survivor
        ``choose(session_id)`` names; returns the migrated records
        (counted here AND per record)."""
        moved = []
        with self._lock:
            for rec in self._records.values():
                if rec.replica != dead_replica:
                    continue
                rec.replica = int(choose(rec.session))
                rec.migrations += 1
                self.migrations += 1
                self._cut({
                    "op": "rebind", "session": rec.session,
                    "replica": rec.replica,
                })
                moved.append(rec)
        return moved

    def expire_idle(self, lease_s: float) -> list[SessionRecord]:
        """Reap sessions silent past their lease; returns the reaped."""
        now = time.monotonic()
        reaped = []
        with self._lock:
            for sid in [
                s for s, r in self._records.items()
                if now - r.last_seen > lease_s
            ]:
                reaped.append(self._records.pop(sid))
                self._cut({"op": "detach", "session": sid})
        return reaped

    # -- reads ---------------------------------------------------------------
    def get(self, session: str) -> SessionRecord | None:
        with self._lock:
            return self._records.get(session)

    def __len__(self) -> int:
        with self._lock:
            return len(self._records)

    def records(self) -> list[SessionRecord]:
        with self._lock:
            return list(self._records.values())

    def tenant_counts(self) -> dict[str, int]:
        with self._lock:
            out: dict[str, int] = {}
            for r in self._records.values():
                out[r.tenant] = out.get(r.tenant, 0) + 1
            return out

    def sessions_on(self, replica: int) -> list[str]:
        with self._lock:
            return [
                s for s, r in self._records.items()
                if r.replica == int(replica)
            ]

    def pinned_versions(self) -> dict[int, int]:
        """{pinned version -> session count} (diag's pin column)."""
        with self._lock:
            out: dict[int, int] = {}
            for r in self._records.values():
                if r.pinned_version is not None:
                    v = int(r.pinned_version)
                    out[v] = out.get(v, 0) + 1
            return out

    # -- checkpoint ----------------------------------------------------------
    def journal(self) -> list[bytes]:
        """The current incremental checkpoint: a frame list whose replay
        reconstructs the live table."""
        with self._lock:
            return list(self._journal)

    @classmethod
    def replay(cls, frames: Iterable[bytes]) -> "SessionTable":
        """Fold a journal frame stream back into a table (the failover /
        cold-restore path; frames may have crossed any wire)."""
        table = cls()
        for frame in frames:
            kind, op = decode_payload(bytes(frame))
            if kind != "journal":
                raise ValueError(f"not a journal frame: {kind}")
            name = op["op"]
            if name == "attach":
                rec = SessionRecord(
                    op["session"], op["tenant"], op["replica"],
                    transport=op.get("transport", "tcp"),
                    pinned_version=op.get("pinned_version"),
                )
                rec.last_act_seq = int(op.get("last_act_seq", 0))
                table._records[rec.session] = rec
            elif name == "rebind":
                rec = table._records.get(op["session"])
                if rec is not None:
                    rec.replica = int(op["replica"])
            elif name == "pin":
                rec = table._records.get(op["session"])
                if rec is not None:
                    rec.pinned_version = op["version"]
            elif name == "detach":
                table._records.pop(op["session"], None)
            else:
                raise ValueError(f"unknown journal op {name!r}")
        return table
