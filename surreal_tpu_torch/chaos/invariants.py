"""Run-wide invariant oracles, evaluated post-run from telemetry and
artifacts only (plus the final in-memory state for restorability), the
port of ``surreal_tpu/chaos/invariants.py``:

- ``exactly_once``    sender rows == shard ingested + every counted drop
                      + close-time inflight (the ``experience_close``
                      conservation law; strict only when no re-hello or
                      respawn re-based a ledger — those re-keys are
                      legitimate and counted, so the oracle says WHY it
                      relaxed, never silently passes)
- ``counted_never_silent``  every delivered lossy/kill fault left a
                      counter delta in the final metrics row
- ``monotone_versions``  published-param and fleet-replica versions never
                      step backwards (outside counted respawn re-syncs),
                      and declared cumulative counters never decrease
- ``residue``         zero leaked named threads, /dev/shm slabs, or open
                      fds into the session folder after teardown
- ``checkpoint_restorable``  the newest checkpoint restores against the
                      final state as template and is finite everywhere
- ``wal_consistency`` the spill WAL re-reads consistently: durable
                      segments >= the writer's last-polled ledger, torn
                      tails only where a tear was injected
- ``fault_surfacing`` every plan entry whose site reached its scheduled
                      call count surfaces as a ``fault`` telemetry event
                      (incident bookkeeping: injected => observed)

Each oracle returns ``{"name", "violations": [...], "skipped": reason}``;
``evaluate`` runs a list of them over one :class:`RunRecord`. Oracles are
pure functions of the record — the campaign's shrinker re-runs them
deterministically against re-executed schedules.
"""

from __future__ import annotations

import glob
import os
from dataclasses import dataclass, field
from typing import Any, Callable

# final-metrics counters that must be nondecreasing across metrics events
MONOTONE_COUNTERS = (
    "param/publishes",
    "param/rekeys",
    "fleet/respawns",
    "workers/respawns",
    "experience/respawns",
    "experience/dropped_rows",
    "engine/stage_kills",
    "engine/deferred_boundaries",
    "trace/dropped_spans",
    "ops/watchdog_dropped_evals",
)

# (site, kind) -> final-metrics counter that must be > 0 once delivered
COUNTER_MAP = {
    ("env_worker.step", "kill_worker"): "workers/respawns",
    ("fleet.replica", "kill_replica"): "fleet/respawns",
    ("experience.shard", "kill_shard"): "experience/respawns",
    ("engine.stage", "kill_stage"): "engine/stage_kills",
    ("trace.emit", "drop_span"): "trace/dropped_spans",
    ("watchdog.eval", "drop_eval"): "ops/watchdog_dropped_evals",
    ("transport.send", "corrupt_slab"): "server/sanitized_requests",
    ("experience.spill", "enospc"): "tier/spill_errors",
}


@dataclass
class RunRecord:
    """Everything one campaign run leaves behind for the oracles."""

    folder: str
    plan: list[dict]
    profile: str = ""
    seed: int = 0
    metrics: dict = field(default_factory=dict)
    events: list[dict] = field(default_factory=list)
    counts: dict[str, int] = field(default_factory=dict)
    residue: dict = field(default_factory=dict)
    state: Any = None
    error: str | None = None

    def events_of(self, kind: str) -> list[dict]:
        return [e for e in self.events if e.get("type") == kind]

    def delivered(self) -> list[dict]:
        """Plan entries whose site's call count reached their window."""
        return [
            e for e in self.plan
            if self.counts.get(e["site"], 0) > int(e.get("at", 0))
        ]


def _violation(oracle: str, what: str, **detail) -> dict:
    return {"oracle": oracle, "what": what, **detail}


def oracle_exactly_once(rec: RunRecord) -> dict:
    name = "exactly_once"
    closes = rec.events_of("experience_close")
    if not closes:
        return {"name": name, "violations": [],
                "skipped": "no experience plane in this run"}
    acct = closes[-1]
    if not acct.get("quiesced", 1.0):
        return {"name": name, "violations": [],
                "skipped": "relay not quiesced at close"}
    if acct.get("rehellos", 0) or acct.get("respawns", 0) or (
        acct.get("shards_live", 0) < acct.get("num_shards", 0)
    ):
        # a re-hello/respawn re-based the sent watermark against a fresh
        # shard ledger: strict conservation no longer holds by design;
        # the re-key itself must have been counted, which it was to get
        # here (rehellos/respawns are the counters)
        return {"name": name, "violations": [],
                "skipped": "ledger re-keyed (rehellos=%d respawns=%d)" % (
                    int(acct.get("rehellos", 0)),
                    int(acct.get("respawns", 0)))}
    sent = float(acct.get("sent_rows", 0))
    ingested = float(acct.get("ingested_rows", 0))
    dropped = float(acct.get("dropped_rows", 0))
    inflight = float(acct.get("inflight_rows", 0))
    out = []
    if ingested + dropped > sent:
        out.append(_violation(
            name, "duplication: ingested + dropped > sent",
            sent=sent, ingested=ingested, dropped=dropped,
        ))
    if sent - ingested - dropped > inflight:
        out.append(_violation(
            name, "silent loss: sent - ingested - dropped > inflight",
            sent=sent, ingested=ingested, dropped=dropped,
            inflight=inflight,
        ))
    return {"name": name, "violations": out, "skipped": None}


def oracle_counted_never_silent(rec: RunRecord) -> dict:
    name = "counted_never_silent"
    out = []
    for entry in rec.delivered():
        counter = COUNTER_MAP.get((entry["site"], entry["kind"]))
        if counter is None:
            continue
        if float(rec.metrics.get(counter, 0.0)) <= 0.0:
            out.append(_violation(
                name, "delivered fault left no counter delta",
                site=entry["site"], kind=entry["kind"], counter=counter,
                value=float(rec.metrics.get(counter, 0.0)),
            ))
    return {"name": name, "violations": out, "skipped": None}


def oracle_monotone_versions(rec: RunRecord) -> dict:
    name = "monotone_versions"
    out = []
    # cumulative counters across metrics rows (re-keys excepted:
    # experience/rows legitimately collapses when a shard respawns empty,
    # so it is checked only across windows with a constant respawn count)
    rows = [e.get("values", {}) for e in rec.events_of("metrics")]
    prev: dict[str, float] = {}
    prev_respawn = 0.0
    for values in rows:
        respawn = float(values.get("experience/respawns", 0.0))
        for key in MONOTONE_COUNTERS:
            if key not in values:
                continue
            cur = float(values[key])
            if key in prev and cur < prev[key]:
                out.append(_violation(
                    name, "cumulative counter decreased", counter=key,
                    before=prev[key], after=cur,
                ))
            prev[key] = cur
        if "experience/rows" in values:
            cur = float(values["experience/rows"])
            if ("experience/rows" in prev and respawn == prev_respawn
                    and cur < prev["experience/rows"]):
                out.append(_violation(
                    name, "ingested-row ledger decreased without respawn",
                    before=prev["experience/rows"], after=cur,
                ))
            prev["experience/rows"] = cur
        prev_respawn = respawn
    # fleet replica param versions: nondecreasing per replica while the
    # replica stays alive and no respawn landed between snapshots
    last_ver: dict[str, float] = {}
    last_respawns = 0.0
    for tier in rec.events_of("serving_tier"):
        respawns = float(tier.get("fleet/respawns", 0.0))
        for idx, rep in (tier.get("replicas") or {}).items():
            if rep.get("state") != "alive":
                last_ver.pop(idx, None)
                continue
            ver = float(rep.get("param_version", 0))
            if (idx in last_ver and respawns == last_respawns
                    and ver < last_ver[idx]):
                out.append(_violation(
                    name, "replica param version regressed", replica=idx,
                    before=last_ver[idx], after=ver,
                ))
            last_ver[idx] = ver
        last_respawns = respawns
    return {"name": name, "violations": out, "skipped": None}


def oracle_residue(rec: RunRecord) -> dict:
    name = "residue"
    res = rec.residue
    if not res:
        return {"name": name, "violations": [],
                "skipped": "no residue snapshot captured"}
    out = []
    for shm in res.get("shm", ()):  # /dev/shm/surreal_pt_* leftovers
        out.append(_violation(name, "leaked shm slab", path=shm))
    for th in res.get("threads", ()):  # named worker threads still alive
        out.append(_violation(name, "leaked worker thread", thread=th))
    for fd in res.get("fds", ()):  # fds still open into the session folder
        out.append(_violation(name, "leaked fd into session folder",
                              target=fd))
    return {"name": name, "violations": out, "skipped": None}


def oracle_checkpoint_restorable(rec: RunRecord) -> dict:
    name = "checkpoint_restorable"
    ckpt_dir = os.path.join(rec.folder, "checkpoints")
    if rec.state is None or not glob.glob(
        os.path.join(ckpt_dir, "[0-9]*")  # step dirs are bare step numbers
    ):
        return {"name": name, "violations": [],
                "skipped": "no checkpoint written (or no final state)"}
    import torch

    from surreal_tpu_torch.session.checkpoint import CheckpointManager
    from surreal_tpu_torch.utils.tree import tensor_leaves

    def _finite(state) -> bool:
        return all(
            bool(torch.isfinite(x).all())
            for x in tensor_leaves(state)
            if x.is_floating_point()
        )

    mgr = CheckpointManager(rec.folder)
    restored = mgr.restore(rec.state, validate=_finite)
    if restored is None:
        return {"name": name, "violations": [_violation(
            name, "newest checkpoint failed finite restore",
            directory=ckpt_dir,
        )], "skipped": None}
    return {"name": name, "violations": [], "skipped": None}


def oracle_wal_consistency(rec: RunRecord) -> dict:
    name = "wal_consistency"
    spill_dir = os.path.join(rec.folder, "spill")
    if not glob.glob(os.path.join(spill_dir, "shard*.log")):
        return {"name": name, "violations": [],
                "skipped": "no spill WAL in this run"}
    from surreal_tpu_torch.experience.spill import SpillLog

    out = []
    log = SpillLog(spill_dir)
    parsed = 0
    for _header, _rows, n in log.segments():
        parsed += 1
        if n <= 0:
            out.append(_violation(name, "durable segment with no rows"))
    # the writer ledger is the last metrics poll — a lower bound (rows
    # ingested after the final poll may have appended more segments)
    ledger = float(rec.metrics.get("tier/spill_segments", 0.0))
    if parsed < ledger:
        out.append(_violation(
            name, "WAL re-read found fewer segments than the ledger",
            parsed=parsed, ledger=ledger,
        ))
    tears_injected = any(
        e["site"] == "experience.spill" and e["kind"] == "truncate_segment"
        for e in rec.delivered()
    )
    if log.torn_segments and not tears_injected:
        out.append(_violation(
            name, "torn WAL segments without an injected tear",
            torn=log.torn_segments,
        ))
    return {"name": name, "violations": out, "skipped": None}


def oracle_fault_surfacing(rec: RunRecord) -> dict:
    name = "fault_surfacing"
    seen = {
        (e.get("site"), e.get("kind"))
        for e in rec.events_of("fault")
    }
    out = []
    for entry in rec.delivered():
        if (entry["site"], entry["kind"]) not in seen:
            out.append(_violation(
                name, "delivered fault never surfaced as a fault event",
                site=entry["site"], kind=entry["kind"],
                at=entry.get("at"),
                calls=rec.counts.get(entry["site"], 0),
            ))
    return {"name": name, "violations": out, "skipped": None}


ORACLES: tuple[Callable[[RunRecord], dict], ...] = (
    oracle_exactly_once,
    oracle_counted_never_silent,
    oracle_monotone_versions,
    oracle_residue,
    oracle_checkpoint_restorable,
    oracle_wal_consistency,
    oracle_fault_surfacing,
)


def evaluate(rec: RunRecord, oracles=None) -> dict:
    """Run every oracle over one record. A run that errored out is itself
    a violation (the campaign's schedules are survivable by
    construction)."""
    results = []
    violations: list[dict] = []
    if rec.error is not None:
        violations.append(_violation(
            "run_completed", "run raised instead of completing",
            error=rec.error,
        ))
    for oracle in (ORACLES if oracles is None else oracles):
        r = oracle(rec)
        results.append(r)
        violations.extend(r["violations"])
    return {
        "violations": violations,
        "oracles": [
            {"name": r["name"], "violations": len(r["violations"]),
             "skipped": r["skipped"]}
            for r in results
        ],
    }
