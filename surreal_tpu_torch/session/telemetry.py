"""Telemetry spine and its offline readers, the port of
``surreal_tpu/session/telemetry.py``: ``Tracer`` (span accumulators, the
JSONL event log under ``<folder>/telemetry/events.jsonl`` with size-based
rotation, and causal span emission), ``latency_percentiles``,
``TraceContext``, ``head_sampled``, ``LineageReducer``,
``HeartbeatWriter`` and ``_iter_jsonl``; and the readers behind the
``diag`` and ``trace`` subcommands, ``diag_summary``/``diag_report`` and
``trace_summary``/``trace_report``, near copies of the reference's that
only read files.

Spans are unfenced, as in the reference: a span around a dispatch of
CUDA work measures the host's time to issue it. Per-window totals still
converge to wall time, because the one fence of a window is the metrics
read in ``SessionHooks.end_iteration``. Spans accumulate in memory per
phase and are written as one ``phases`` event per ``flush_phases`` call
(the metrics cadence); only side-band spans (eval, checkpoint) emit a
``span`` event each, with ``emit=True``.

Events are one JSON object per line with ``type``, ``t`` (unix seconds),
``trace`` (the run's trace id) and ``seq``. The types the port writes:
``session``, ``phases``, ``span``, ``metrics``, ``precision``,
``recovery``, ``fault``, ``engine``, ``data_plane`` and ``hops`` (the
SEED trainer), ``serving_tier`` (the inference fleet),
``experience_plane`` and ``experience_close`` (the experience plane),
``program_cost`` (``session/costs.py``), ``profile``
(``session/profile.py``), and the ops plane's ``ops_snapshot``,
``ops_flightrec``, ``slo_breach``, ``incident_open``/``_update``/``_close``,
``remediation`` and ``remediation_verdict`` (``session/opsplane.py``,
``slo.py``, ``incidents.py``, ``remediate.py``), the autotuner's
``tune`` (``launch/hooks.py::SessionHooks.tune_event`` and the ``tune``
subcommand) and a chaos campaign's ``chaos_campaign`` and
``chaos_violation`` (``chaos/campaign.py``). The readers also render the
reference's compile-cache events, which the port does not write: a
section whose events are absent renders nothing.

Causal spans (the SEED path): the inference server head-samples 1 in
``telemetry.trace.sample_n`` worker steps (:func:`head_sampled`), emits a
worker root span and a forward child through :meth:`Tracer.emit_span`,
and the learn that consumes the chunk closes the tree. ``emit_span``
passes the ``trace.emit`` fault site (``drop_span`` is counted in
``trace/dropped_spans``) and keeps the last ``telemetry.trace.keep``
spans in a ring, which every flight-recorder dump and incident reads
(:meth:`Tracer.recent_exemplar_spans`). ``diag``'s report ends with the
incident brief of ``session/incidents.py``.
"""

from __future__ import annotations

import glob
import json
import os
import threading
import time
import uuid
from collections import deque
from contextlib import contextmanager

TELEMETRY_DIR = "telemetry"
EVENTS_FILE = "events.jsonl"
PROFILES_DIR = "profiles"  # <folder>/telemetry/profiles/<tag>/ captures


def latency_percentiles(samples) -> dict[str, float] | None:
    """{p50, p90, p99, n} of a latency sample window, with the
    reference's index rule ``xs[min(n-1, int(p*(n-1)+0.5))]``."""
    xs = sorted(float(x) for x in samples)
    if not xs:
        return None
    n = len(xs)

    def pct(p: float) -> float:
        return xs[min(n - 1, int(p * (n - 1) + 0.5))]

    return {"p50": pct(0.50), "p90": pct(0.90), "p99": pct(0.99), "n": n}


class TraceContext:
    """One head-sampled request's position in its causal span tree: the
    exemplar id names the tree, ``span_id`` this hop, ``parent_id`` the
    hop that caused it."""

    __slots__ = ("exemplar", "span_id", "parent_id")

    def __init__(self, exemplar: str, span_id: int, parent_id: int | None = None):
        self.exemplar = str(exemplar)
        self.span_id = int(span_id)
        self.parent_id = None if parent_id is None else int(parent_id)

    def child(self, span_id: int) -> "TraceContext":
        return TraceContext(self.exemplar, span_id, self.span_id)


def head_sampled(counter: int, sample_n: int) -> bool:
    """The 1-in-N head-sampling rule: the FIRST request of a stream
    (counter 1) is always an exemplar, then every ``sample_n``-th after
    it. ``sample_n <= 0`` disables."""
    if sample_n <= 0:
        return False
    return (int(counter) - 1) % int(sample_n) == 0


class LineageReducer:
    """Exact per-update staleness from per-transition lineage stamps: every
    transition carries the param version that acted it, and the reducer
    turns one update's version column (host memory, popped before the
    chunk goes to the card) into the ``lineage/*`` gauges. Percentiles use
    :func:`latency_percentiles`' index rule over the sorted staleness
    multiset, walked through the version counts."""

    def __init__(self):
        self.updates = 0
        self.last: dict[str, float] = {}

    def reduce(self, current_version: int, versions) -> dict[str, float]:
        """One update's ``lineage/*`` gauges from its acting-version column
        (a host int array of any shape); empty when the column is empty."""
        import numpy as np

        arr = np.asarray(versions).reshape(-1)
        if arr.size == 0:
            return {}
        vals, counts = np.unique(arr.astype(np.int64), return_counts=True)
        cur = int(current_version)
        # staleness ascending = current - version with the versions walked
        # descending; cumulative counts give the element at any exact index
        stal = [int(cur - v) for v in vals[::-1]]
        cnts = [int(c) for c in counts[::-1]]
        n = int(arr.size)

        def pct(p: float) -> int:
            k = min(n - 1, int(p * (n - 1) + 0.5))
            seen = 0
            for st, c in zip(stal, cnts):
                seen += c
                if k < seen:
                    return st
            return stal[-1]

        self.updates += 1
        self.last = {
            "lineage/staleness_p50": float(pct(0.50)),
            "lineage/staleness_p99": float(pct(0.99)),
            "lineage/staleness_max": float(stal[-1]),
            "lineage/versions_per_batch": float(len(stal)),
        }
        return dict(self.last)


class Tracer:
    """Span tracing and the JSONL event log of one session. A disabled
    tracer (``enabled=False`` or no folder) is a free no-op. Thread-safe:
    the pipelined engine boundary writes from its staging thread."""

    def __init__(self, folder: str | None, enabled: bool = True, name: str = "train",
                 trace_id: str | None = None, max_log_mb: float | None = None, trace_keep: int = 8):
        self.enabled = bool(enabled) and folder is not None
        self._lock = threading.Lock()
        self._phases: dict[str, list] = {}  # name -> [count, total_s, max_s]
        self._f = None
        self.path = None
        # rotation: past max_log_mb the log moves to <path>.1 (one older
        # generation kept) and a fresh file starts
        self._max_bytes = int(float(max_log_mb) * 1e6) if max_log_mb else None
        self._bytes = 0
        self.rotations = 0
        self.trace_id = trace_id or uuid.uuid4().hex[:16]
        self._seq = 0
        # causal spans: a run-unique span-id counter (every emitter is a
        # thread of this process), the emitted and fault-dropped counts,
        # and the ring of the newest spans the flight recorder dumps
        self.spans_emitted = 0
        self.dropped_spans = 0
        self._span_ids = 0
        self._recent_exemplars: deque = deque(maxlen=max(1, int(trace_keep)))
        # the last flushed phase window ({name: {count, total_s, max_ms}})
        self.last_window: dict[str, dict] = {}
        if self.enabled:
            try:
                tel_dir = os.path.join(folder, TELEMETRY_DIR)
                os.makedirs(tel_dir, exist_ok=True)
                self.path = os.path.join(tel_dir, EVENTS_FILE)
                self._f = open(self.path, "a", buffering=1)  # line-buffered
                self._bytes = os.path.getsize(self.path)  # a resumed session appends
            except OSError:
                # telemetry never kills training (e.g. a read-only folder)
                self.enabled = False
                self._f = None
        if self.enabled:
            self.event("session", name=name, pid=os.getpid())

    # -- raw events ----------------------------------------------------------
    def event(self, type_: str, **fields) -> None:
        """Append one event line. Fields must be JSON-serializable."""
        if not self.enabled:
            return
        with self._lock:
            if self._f is None:
                return
            self._seq += 1
            line = json.dumps(
                {"type": type_, "t": time.time(), "trace": self.trace_id, "seq": self._seq, **fields},
                default=float,
            )
            try:
                self._f.write(line + "\n")
                self._bytes += len(line) + 1
                if self._max_bytes and self._bytes > self._max_bytes:
                    self._f.close()
                    os.replace(self.path, self.path + ".1")
                    self._f = open(self.path, "a", buffering=1)
                    self._bytes = 0
                    self.rotations += 1
            except OSError:
                # a disk-full or lost mount mid-run disables the log
                try:
                    if self._f is not None:
                        self._f.close()
                except OSError:
                    pass
                self._f = None
                self.enabled = False

    # -- spans ---------------------------------------------------------------
    @contextmanager
    def span(self, name: str, emit: bool = False):
        """Time a region into the ``name`` phase accumulator; ``emit=True``
        also writes one ``span`` event (low-frequency side-bands only)."""
        if not self.enabled:
            yield
            return
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dur = time.perf_counter() - t0
            with self._lock:
                st = self._phases.setdefault(name, [0, 0.0, 0.0])
                st[0] += 1
                st[1] += dur
                st[2] = max(st[2], dur)
            if emit:
                self.event("span", name=name, dur_s=dur)

    # -- causal spans ----------------------------------------------------------
    def next_span_id(self) -> int:
        """A run-unique span id."""
        with self._lock:
            self._span_ids += 1
            return self._span_ids

    def trace_context(self, exemplar: str) -> TraceContext:
        """A ROOT context for a newly head-sampled request."""
        return TraceContext(exemplar, self.next_span_id(), None)

    def emit_span(self, name: str, ctx: TraceContext, *, tier: str | None = None,
                  dur_ms: float | None = None, **fields) -> None:
        """One causal ``span`` event for hop ``ctx`` of its exemplar tree
        (callers measure ``dur_ms`` before calling, so a delayed emit never
        moves a hop's time). The ``trace.emit`` fault site: ``drop_span``
        swallows the span but counts it, and its id stays allocated, so
        ``trace`` renders the tree torn; ``delay`` stalls the emit."""
        if not self.enabled:
            return
        from surreal_tpu_torch.utils import faults

        f = faults.fire("trace.emit")
        if f is not None:
            if f["kind"] == "drop_span":
                with self._lock:
                    self.dropped_spans += 1
                return
            if f["kind"] == "delay":
                faults.sleep_ms(f)
        rec = {"name": name, "exemplar": ctx.exemplar, "span": ctx.span_id, "parent": ctx.parent_id, **fields}
        if tier is not None:
            rec["tier"] = tier
        if dur_ms is not None:
            rec["dur_ms"] = float(dur_ms)
        with self._lock:
            self.spans_emitted += 1
            self._recent_exemplars.append(dict(rec, t=time.time()))
        self.event("span", **rec)

    def trace_gauges(self) -> dict[str, float]:
        """The ``trace/*`` gauges merged into a metrics row."""
        return {"trace/spans": float(self.spans_emitted), "trace/dropped_spans": float(self.dropped_spans)}

    def recent_exemplar_spans(self) -> list[dict]:
        """The newest exemplar spans (oldest first), for the flight
        recorder's dumps and the incidents' evidence."""
        with self._lock:
            return [dict(r) for r in self._recent_exemplars]

    def flush_phases(self, step) -> dict[str, float]:
        """Write one ``phases`` event for the window since the last flush
        and return ``time/<phase>_ms`` (mean per call). Resets the window."""
        with self._lock:
            phases = {
                k: {"count": c, "total_s": t, "max_ms": mx * 1e3} for k, (c, t, mx) in self._phases.items()
            }
            self._phases.clear()
        self.last_window = phases
        if not phases:
            return {}
        self.event("phases", step=int(step), phases=phases)
        return {f"time/{k}_ms": v["total_s"] / max(v["count"], 1) * 1e3 for k, v in phases.items()}

    def log_metrics(self, step, metrics) -> None:
        """Mirror one synced metrics row into the event log."""
        if not self.enabled or not metrics:
            return
        self.event("metrics", step=int(step), values={k: float(v) for k, v in metrics.items()})

    def close(self) -> None:
        # the tail window first (step -1 marks an at-close flush)
        self.flush_phases(step=-1)
        with self._lock:
            if self._f is not None:
                self._f.close()
                self._f = None
        self.enabled = False


class HeartbeatWriter:
    """Per-host liveness events for multi-host runs: each rank appends to
    its OWN ``telemetry/heartbeat_rank<k>.jsonl`` (no cross-rank
    coordination — a wedged rank is visible precisely because it stops
    writing). Ranks whose host cannot write the session folder disable
    themselves silently: ranks > 0 are not required to mount it. (No
    trainer of the port has a second rank yet; ``diag`` reads the files
    the reference's multi-host runs write.)"""

    def __init__(self, folder: str | None, rank: int, every_s: float = 10.0,
                 enabled: bool = True):
        self.rank = int(rank)
        self.every_s = float(every_s)
        self._last: float | None = None
        self._path = None
        if enabled and folder:
            try:
                tel_dir = os.path.join(folder, TELEMETRY_DIR)
                os.makedirs(tel_dir, exist_ok=True)
                self._path = os.path.join(
                    tel_dir, f"heartbeat_rank{self.rank}.jsonl"
                )
                with open(self._path, "a"):
                    pass  # probe writability up front
            except OSError:
                self._path = None

    def beat(self, iteration: int, env_steps: int, force: bool = False) -> None:
        """Append a heartbeat, time-throttled to ``every_s`` (call it every
        iteration; it is a no-op between beats)."""
        if self._path is None:
            return
        now = time.monotonic()
        if not force and self._last is not None and now - self._last < self.every_s:
            return
        self._last = now
        rec = {
            "type": "heartbeat", "t": time.time(), "rank": self.rank,
            "iteration": int(iteration), "env_steps": int(env_steps),
            # cadence rides in the record so diag can flag a rank whose
            # newest beat is older than 3x its own cadence as DEAD
            "every_s": self.every_s,
        }
        try:
            with open(self._path, "a") as f:
                f.write(json.dumps(rec) + "\n")
        except OSError:
            self._path = None  # host lost the folder; stop trying


# -- diag --------------------------------------------------------------------

_HEALTH_PREFIXES = ("health/", "loss/", "policy/kl", "episode/return")


def _iter_jsonl(path, rotated: bool = True):
    """Yield one JSON object per parseable line: a torn last line (a kill
    mid-write) is skipped, and a line cut inside a UTF-8 sequence is read
    lossily and skipped. With ``rotated``, the older ``<path>.1`` segment
    is read first, so the stream is chronological."""
    paths = [path]
    if rotated and os.path.exists(path + ".1"):
        paths.insert(0, path + ".1")
    for p in paths:
        try:
            with open(p, errors="replace") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        yield json.loads(line)
                    except json.JSONDecodeError:
                        continue
        except OSError:
            continue


def diag_summary(folder: str) -> dict | None:
    """Aggregate the session's telemetry files into one dict, or None when
    no event log exists. Pure file reading, safe off the card."""
    events_path = os.path.join(folder, TELEMETRY_DIR, EVENTS_FILE)
    events = list(_iter_jsonl(events_path))
    hb_paths = sorted(
        glob.glob(os.path.join(folder, TELEMETRY_DIR, "heartbeat_rank*.jsonl"))
    )
    if not events and not hb_paths:
        return None

    phases: dict[str, dict] = {}
    health: dict[str, dict] = {}
    compile_cache = None
    data_plane = None
    experience = None
    serving = None
    gateway = None
    engine = None
    trace_id = None
    programs: dict[str, dict] = {}   # program_cost events (last per name)
    precision = None                 # last 'precision' event (active policy)
    perf_last: dict[str, float] = {}  # perf/* gauges from the last row
    hops = None                      # last 'hops' event's percentiles
    profiles: list[dict] = []        # 'profile' capture events
    tune = None
    tune_hits = tune_misses = 0
    recovery_counts: dict[str, int] = {}
    recovery_last = None
    fault_count = 0
    fault_sites: dict[str, int] = {}
    fault_last = None
    nonfinite_windows = 0
    t_first = t_last = None
    last_step = None
    for ev in events:
        t = ev.get("t")
        if isinstance(t, (int, float)):
            t_first = t if t_first is None else min(t_first, t)
            t_last = t if t_last is None else max(t_last, t)
        if trace_id is None and ev.get("trace"):
            trace_id = ev["trace"]
        if ev.get("type") == "phases":
            step = ev.get("step")
            if isinstance(step, int) and step >= 0:  # -1 = at-close flush
                last_step = step
            for name, st in (ev.get("phases") or {}).items():
                agg = phases.setdefault(
                    name, {"count": 0, "total_s": 0.0, "max_ms": 0.0}
                )
                agg["count"] += int(st.get("count", 0))
                agg["total_s"] += float(st.get("total_s", 0.0))
                agg["max_ms"] = max(agg["max_ms"], float(st.get("max_ms", 0.0)))
        elif ev.get("type") == "compile_cache":
            # counters are cumulative; the last event is the session total
            compile_cache = {
                "dir": ev.get("dir"),
                "hits": int(ev.get("hits", 0)),
                "misses": int(ev.get("misses", 0)),
            }
        elif ev.get("type") == "data_plane":
            # the last event is the settled negotiation (SEED trainers emit
            # one after the first learn and one at run end)
            data_plane = {
                k: v for k, v in ev.items() if k not in ("type", "t", "trace", "seq")
            }
        elif ev.get("type") == "serving_tier":
            # the last event is the settled tier shape (one per metrics
            # row while an InferenceFleet is active)
            serving = {
                k: v for k, v in ev.items() if k not in ("type", "t", "trace", "seq")
            }
        elif ev.get("type") == "experience_plane":
            # the last event is the settled plane shape (one per metrics
            # row while a sharded experience plane is active)
            experience = {
                k: v for k, v in ev.items() if k not in ("type", "t", "trace", "seq")
            }
        elif ev.get("type") == "gateway":
            # the last event is the settled tenant picture (one per
            # metrics row while the session gateway is live)
            gateway = {
                k: v for k, v in ev.items() if k not in ("type", "t", "trace", "seq")
            }
        elif ev.get("type") == "engine":
            # the last event is the settled loop-engine picture (one per
            # metrics row; counters are cumulative)
            engine = {
                k: v for k, v in ev.items() if k not in ("type", "t", "trace", "seq")
            }
        elif ev.get("type") == "tune":
            # the last event is the active decision; hit/miss counts
            # accumulate over the session (trainer builds + CLI runs)
            tune = {k: v for k, v in ev.items() if k not in ("type", "t", "trace", "seq")}
            if ev.get("hit"):
                tune_hits += 1
            else:
                tune_misses += 1
        elif ev.get("type") == "recovery":
            kind = str(ev.get("kind", "?"))
            recovery_counts[kind] = recovery_counts.get(kind, 0) + 1
            recovery_last = {
                k: v for k, v in ev.items() if k not in ("type", "t", "trace", "seq")
            }
        elif ev.get("type") == "fault":
            fault_count += 1
            site = str(ev.get("site", "?"))
            fault_sites[site] = fault_sites.get(site, 0) + 1
            fault_last = {
                k: v for k, v in ev.items() if k not in ("type", "t", "trace", "seq")
            }
        elif ev.get("type") == "program_cost":
            name = str(ev.get("name", "?"))
            programs[name] = {
                k: v for k, v in ev.items()
                if k not in ("type", "t", "trace", "seq")
            }
        elif ev.get("type") == "precision":
            # last event wins (one per run; a resumed session re-emits)
            precision = {
                k: v for k, v in ev.items()
                if k not in ("type", "t", "trace", "seq")
            }
        elif ev.get("type") == "hops":
            # last event wins: the window's rolling-deque percentiles
            hops = {
                k: v for k, v in ev.items()
                if k not in ("type", "t", "trace", "seq")
            }
        elif ev.get("type") == "profile":
            profiles.append({
                k: v for k, v in ev.items()
                if k not in ("type", "t", "trace", "seq")
            })
        elif ev.get("type") == "metrics":
            last_step = ev.get("step", last_step)
            vals = ev.get("values") or {}
            for k, v in vals.items():
                if (
                    k.startswith(("perf/", "lineage/", "trace/"))
                    and isinstance(v, (int, float))
                ):
                    perf_last[k] = v
            if vals.get("health/nonfinite", 0):
                nonfinite_windows += 1
            for k, v in vals.items():
                if not isinstance(v, (int, float)):
                    continue
                if not any(k.startswith(p) or k == p for p in _HEALTH_PREFIXES):
                    continue
                if v != v:  # NaN rows carry no summary information
                    continue
                h = health.setdefault(
                    k, {"last": v, "min": v, "max": v, "n": 0}
                )
                h["last"] = v
                h["min"] = min(h["min"], v)
                h["max"] = max(h["max"], v)
                h["n"] += 1

    heartbeats = {}
    now = time.time()
    for path in hb_paths:
        last = None
        prev_t = None
        deltas: list[float] = []
        for rec in _iter_jsonl(path):
            if rec.get("type") == "heartbeat":
                t = rec.get("t")
                if isinstance(t, (int, float)) and prev_t is not None:
                    deltas.append(t - prev_t)
                prev_t = t if isinstance(t, (int, float)) else prev_t
                last = rec
        if last is not None:
            # staleness: a rank whose newest beat is older than 3x its
            # cadence is flagged DEAD instead of silently looking fine.
            # Cadence comes from the record (new runs), else is inferred
            # from the observed beat deltas (old logs), else defaults.
            cadence = last.get("every_s")
            if not isinstance(cadence, (int, float)) or cadence <= 0:
                cadence = (
                    sorted(deltas)[len(deltas) // 2] if deltas else 10.0
                )
            age = now - float(last.get("t", now))
            heartbeats[int(last.get("rank", -1))] = {
                **last,
                "age_s": age,
                "cadence_s": float(cadence),
                "dead": age > 3.0 * float(cadence),
            }

    return {
        "folder": folder,
        "trace_id": trace_id,
        "events": len(events),
        "wall_s": (t_last - t_first) if (t_first is not None and t_last is not None) else 0.0,
        "last_step": last_step,
        "phases": phases,
        "health": health,
        "compile_cache": compile_cache,
        "data_plane": data_plane,
        "experience": experience,
        "serving": serving,
        "gateway": gateway,
        "engine": engine,
        "tune": tune,
        "tune_hits": tune_hits,
        "tune_misses": tune_misses,
        "recovery": (
            {"counts": recovery_counts, "last": recovery_last}
            if recovery_counts else None
        ),
        "faults": (
            {"count": fault_count, "by_site": fault_sites, "last": fault_last}
            if fault_count else None
        ),
        "nonfinite_windows": nonfinite_windows,
        "heartbeats": heartbeats,
        "programs": programs,
        "precision": precision,
        "perf": perf_last,
        "hops": hops,
        "profiles": profiles,
    }


def diag_report(folder: str) -> str | None:
    """Human-readable diag: phase-time breakdown, health summary,
    last-heartbeat table. None when the folder has no telemetry."""
    s = diag_summary(folder)
    if s is None:
        return None
    wall = s["wall_s"]
    lines = [
        f"Telemetry diag — {s['folder']}",
        f"{s['events']} events over {wall:.1f} s"
        + (f", last step {s['last_step']}" if s["last_step"] is not None else "")
        + (f", trace {s['trace_id']}" if s.get("trace_id") else ""),
        "",
        "Phase-time breakdown",
    ]
    if s["phases"]:
        lines.append(
            f"  {'phase':<20} {'calls':>8} {'total s':>10} {'mean ms':>10} "
            f"{'max ms':>10} {'% wall':>7}"
        )
        for name, st in sorted(
            s["phases"].items(), key=lambda kv: -kv[1]["total_s"]
        ):
            mean_ms = st["total_s"] / max(st["count"], 1) * 1e3
            pct = 100.0 * st["total_s"] / wall if wall > 0 else 0.0
            lines.append(
                f"  {name:<20} {st['count']:>8} {st['total_s']:>10.2f} "
                f"{mean_ms:>10.2f} {st['max_ms']:>10.2f} {pct:>6.1f}%"
            )
        lines.append(
            "  (device-loop phases measure async dispatch; window totals "
            "are honest under backpressure — see session/telemetry.py)"
        )
    else:
        lines.append("  (no phase windows recorded)")
    cc = s.get("compile_cache")
    if cc is not None:
        total = cc["hits"] + cc["misses"]
        lines += [
            "",
            f"Compile cache — {cc.get('dir')}",
            f"  {cc['hits']} hits / {cc['misses']} misses"
            + (
                f" ({100.0 * cc['hits'] / total:.0f}% warm)"
                if total else ""
            ),
        ]
    dpl = s.get("data_plane")
    if dpl is not None:
        lines += [
            "",
            "Data plane — "
            + ", ".join(f"{k}={dpl[k]}" for k in sorted(dpl)),
        ]
    eng_lines = _engine_lines(s)
    if eng_lines:
        lines += ["", "Loop engine"] + eng_lines
    tier_lines = _serving_tier_lines(s)
    if tier_lines:
        lines += ["", "Serving tier"] + tier_lines
    xp_lines = _experience_plane_lines(s)
    if xp_lines:
        lines += ["", "Experience plane"] + xp_lines
    gw_lines = _gateway_lines(s)
    if gw_lines:
        lines += ["", "Gateway"] + gw_lines
    tn = s.get("tune")
    if tn is not None:
        cfg = tn.get("config") or {}
        lines += [
            "",
            f"Autotuner — mode={tn.get('mode')} "
            f"source={tn.get('source')} "
            f"{'cache hit' if tn.get('hit') else 'cache miss'} "
            f"({s.get('tune_hits', 0)} hits / {s.get('tune_misses', 0)} "
            "misses this session)",
            "  config: "
            + (
                ", ".join(f"{k}={cfg[k]}" for k in sorted(cfg))
                if cfg else "(static defaults)"
            ),
        ]
        trials = tn.get("trials")
        if trials:
            lines.append(
                f"  {len(trials)} candidates measured "
                f"(default {tn.get('default_ms', 0):.2f} ms -> chosen "
                f"{tn.get('chosen_ms', 0):.2f} ms/iter):"
            )
            for t in trials[:16]:
                lines.append(
                    f"    {t.get('iter_ms', 0):>9.2f} ms  {t.get('config')}"
                )
            if len(trials) > 16:
                lines.append(f"    ... {len(trials) - 16} more")
    perf_lines = _performance_lines(s)
    if perf_lines:
        lines += ["", "Performance"] + perf_lines
    rec = s.get("recovery")
    if rec is not None:
        counts = ", ".join(
            f"{k}={rec['counts'][k]}" for k in sorted(rec["counts"])
        )
        lines += ["", f"Recovery — {counts}"]
        last = rec.get("last") or {}
        if last:
            lines.append(
                "  last: "
                + ", ".join(f"{k}={last[k]}" for k in sorted(last))
            )
    flt = s.get("faults")
    if flt is not None:
        sites = ", ".join(
            f"{k}: {flt['by_site'][k]}" for k in sorted(flt["by_site"])
        )
        lines += [
            "",
            f"Faults injected (chaos harness) — {flt['count']} fired "
            f"({sites})",
        ]
    lines += ["", "Training health"]
    if s["health"]:
        lines.append(
            f"  {'signal':<26} {'last':>12} {'min':>12} {'max':>12} {'rows':>6}"
        )
        for k in sorted(s["health"]):
            h = s["health"][k]
            lines.append(
                f"  {k:<26} {h['last']:>12.4g} {h['min']:>12.4g} "
                f"{h['max']:>12.4g} {h['n']:>6}"
            )
        if s["nonfinite_windows"]:
            lines.append(
                f"  !! {s['nonfinite_windows']} metrics window(s) flagged "
                "health/nonfinite > 0 — NaN/inf hit the grads or params"
            )
        else:
            lines.append("  nonfinite guard: clean (no window flagged)")
    else:
        lines.append("  (no metrics rows recorded)")
    lines += ["", "Heartbeats"]
    if s["heartbeats"]:
        lines.append(
            f"  {'rank':>4} {'age s':>8} {'iteration':>10} {'env_steps':>12}"
            f"  status"
        )
        dead_ranks = []
        for rank in sorted(s["heartbeats"]):
            hb = s["heartbeats"][rank]
            age = float(hb.get("age_s", 0.0))
            dead = bool(hb.get("dead"))
            if dead:
                dead_ranks.append(rank)
            lines.append(
                f"  {rank:>4} {age:>8.1f} {hb.get('iteration', 0):>10} "
                f"{hb.get('env_steps', 0):>12}  "
                + (
                    f"DEAD (> 3x {hb.get('cadence_s', 0.0):.0f}s cadence)"
                    if dead else "alive"
                )
            )
        if dead_ranks:
            lines.append(
                f"  !! rank(s) {', '.join(str(r) for r in dead_ranks)} "
                "stopped heartbeating — wedged, killed, or the run ended"
            )
    else:
        lines.append("  (none recorded — single-host session)")
    # the incident brief; the full report is ``why``'s (a failing import
    # must not take diag down)
    try:
        from surreal_tpu_torch.session.incidents import incidents_brief

        inc_lines = incidents_brief(s["folder"])
    except Exception:
        inc_lines = []
    if inc_lines:
        lines += ["", "Incidents (surreal_tpu why for the full report)"]
        lines += inc_lines
    return "\n".join(lines)


def _engine_lines(s: dict) -> list[str]:
    """The diag 'Loop engine' section: declared stage table (donate /
    deferrable / overlap bits), boundary + step latency percentiles,
    staging occupancy, and the deferred/skipped/killed boundary counters
    from the last ``engine`` event. Empty list when the session predates
    the engine (no event recorded)."""
    eng = s.get("engine")
    if not eng:
        return []
    lines = [
        "  pipelined={p} — {d} boundaries deferred, {sk} skipped "
        "(wedged past the stage bound), {k} stage kills".format(
            p=bool(eng.get("pipelined")),
            d=int(eng.get("deferred", 0)),
            sk=int(eng.get("skipped", 0)),
            k=int(eng.get("kills", 0)),
        ),
    ]
    st = eng.get("stage_ms") or {}
    sp = eng.get("step_ms") or {}
    if st or sp:
        lines.append(
            "  boundary p50/p99 {a:.2f}/{b:.2f} ms, step p50/p99 "
            "{c:.2f}/{d:.2f} ms, staging occupancy {o:.1%}".format(
                a=float(st.get("p50", 0.0)), b=float(st.get("p99", 0.0)),
                c=float(sp.get("p50", 0.0)), d=float(sp.get("p99", 0.0)),
                o=float(eng.get("occupancy", 0.0)),
            )
        )
    stages = eng.get("stages") or []
    if stages:
        lines.append(
            f"  {'stage':<12} {'donate':>7} {'deferrable':>11} {'overlap':>8}"
        )
        for spec in stages:
            lines.append(
                f"  {str(spec.get('name', '?')):<12} "
                f"{str(bool(spec.get('donate'))):>7} "
                f"{str(bool(spec.get('deferrable'))):>11} "
                f"{str(bool(spec.get('overlap'))):>8}"
            )
    return lines


def _serving_tier_lines(s: dict) -> list[str]:
    """The diag 'Serving tier' section: replica liveness/budget table,
    fleet-mean serve latency, scale/respawn counters from the last
    ``serving_tier`` event. Empty list when the session ran no fleet."""
    tier = s.get("serving")
    if not tier:
        return []
    lines = [
        "  {n} replica(s) alive over {w} workers — respawns {r:g}, "
        "scale ups {u:g} / downs {d:g}, autoscale {a}".format(
            n=int(tier.get("fleet/replicas_live", 0)),
            w=tier.get("num_workers", "?"),
            r=float(tier.get("fleet/respawns", 0)),
            u=float(tier.get("fleet/scale_ups", 0)),
            d=float(tier.get("fleet/scale_downs", 0)),
            a="on" if tier.get("autoscale") else "off",
        ),
    ]
    if tier.get("fleet/serve_ms") is not None:
        lines.append(
            f"  fleet serve EWMA {float(tier['fleet/serve_ms']):.2f} ms, "
            f"queue depth {float(tier.get('fleet/queue_depth', 0)):g}"
        )
    replicas = tier.get("replicas") or {}
    if replicas:
        lines.append(
            f"  {'replica':>8} {'state':<8} {'workers':>8} "
            f"{'min_batch':>10} {'serve ms':>9} {'evicted':>8}"
        )
        for rid in sorted(replicas, key=lambda x: int(x)):
            r = replicas[rid]
            serve = r.get("serve_ms")
            lines.append(
                f"  {rid:>8} {r.get('state', '?'):<8} "
                f"{r.get('workers', 0):>8} {r.get('min_batch', 0):>10} "
                + (f"{float(serve):>9.2f}" if serve is not None else f"{'n/a':>9}")
                + f" {r.get('evicted_chunks', 0):>8}"
            )
    return lines


def _experience_plane_lines(s: dict) -> list[str]:
    """The diag 'Experience plane' section: shard geometry/transport mix,
    per-shard replay gauges (fill, ingested rows, samples served, sample
    queue depth), the learner's sample-wait, and per-hop
    sender->shard->learner percentiles from the last ``experience_plane``
    event. Empty list when the session ran no plane."""
    xp = s.get("experience")
    if not xp:
        return []
    lines = [
        f"  {xp.get('kind', '?')} x {xp.get('num_shards', '?')} shards "
        f"({xp.get('shard_mode', '?')} mode), transports "
        f"{xp.get('transports', [])}",
        f"  wire {xp.get('wire_bytes_per_step', 0):.1f} B/step, learner "
        f"sample-wait {xp.get('sample_wait_ms', 0):.2f} ms (EWMA)",
    ]
    shards = xp.get("shards") or {}
    if shards:
        lines.append(
            f"  {'shard':>6} {'fill':>7} {'rows':>10} {'samples':>9} "
            f"{'queue':>6} {'ingest p50/p90/p99 ms':>24}"
        )
        for sid in sorted(shards, key=lambda x: int(x)):
            sh = shards[sid]
            tr = sh.get("ingest_transit_ms") or {}
            hop = (
                f"{tr.get('p50', 0):.2f}/{tr.get('p90', 0):.2f}/"
                f"{tr.get('p99', 0):.2f}" if tr else "n/a"
            )
            lines.append(
                f"  {sid:>6} {float(sh.get('fill', 0)):>7.2f} "
                f"{int(sh.get('ingested_rows', 0)):>10} "
                f"{int(sh.get('samples_served', 0)):>9} "
                f"{int(sh.get('sample_queue_depth', 0)):>6} {hop:>24}"
            )
    snd = xp.get("sender") or {}
    smp = xp.get("sampler") or {}
    if snd or smp:
        lines.append(
            "  sender: "
            + ", ".join(f"{k}={snd[k]:g}" for k in sorted(snd))
            + " | sampler: "
            + ", ".join(f"{k}={smp[k]:g}" for k in sorted(smp))
        )
    return lines


def _gateway_lines(s: dict) -> list[str]:
    """The diag 'Gateway' section: session/act totals, act-cache hit
    rate, migration/catch-up counters, pinned-version census, and the
    per-tenant admission table from the last ``gateway`` event. Empty
    list when the session ran no gateway."""
    gw = s.get("gateway")
    if not gw:
        return []
    acts = float(gw.get("gateway/acts", 0))
    lines = [
        "  {n:g} session(s) live at {a} — attaches {at:g} "
        "(+{re:g} re-attach), detaches {d:g}, expired {ex:g}".format(
            n=float(gw.get("gateway/sessions", 0)),
            a=gw.get("address", "?"),
            at=float(gw.get("gateway/attaches", 0)),
            re=float(gw.get("gateway/reattaches", 0)),
            d=float(gw.get("gateway/detaches", 0)),
            ex=float(gw.get("gateway/expired_leases", 0)),
        ),
        "  {ac:g} acts, cache hit-rate {hr:.0%} ({h:g} hits / {m:g} "
        "misses), migrations {mi:g}, catch-ups {cu:g}".format(
            ac=acts,
            hr=float(gw.get("cache_hit_rate", 0.0)),
            h=float(gw.get("gateway/cache_hits", 0)),
            m=float(gw.get("gateway/cache_misses", 0)),
            mi=float(gw.get("gateway/migrations", 0)),
            cu=float(gw.get("gateway/catch_ups", 0)),
        ),
    ]
    pins = gw.get("pinned_versions") or {}
    if pins:
        lines.append(
            "  pinned versions: "
            + ", ".join(
                f"v{v}×{pins[v]}" for v in sorted(pins, key=lambda x: int(x))
            )
        )
    tenants = gw.get("tenants") or {}
    if tenants:
        lines.append(
            f"  {'tenant':<12} {'sessions':>9} {'quota':>6} {'queued':>7} "
            f"{'throttled':>10} {'evicted':>8} {'rejected':>9}"
        )
        for name in sorted(tenants):
            t = tenants[name]
            quota = int(t.get("max_sessions", 0))
            lines.append(
                f"  {name:<12} {int(t.get('sessions', 0)):>9} "
                + (f"{quota:>6}" if quota else f"{'inf':>6}")
                + f" {int(t.get('queued', 0)):>7} "
                f"{int(t.get('throttled', 0)):>10} "
                f"{int(t.get('evicted', 0)):>8} "
                f"{int(t.get('rejected', 0)):>9}"
            )
    return lines


def _performance_lines(s: dict) -> list[str]:
    """The diag 'Performance' section: per-program roofline numbers
    (FLOPs / bytes / arithmetic intensity from program_cost events), the
    live perf/* gauges from the last metrics row, per-hop latency
    percentiles (the stitched cross-process timeline), and captured
    profiler traces. Empty list when the session recorded none of them."""
    progs = s.get("programs") or {}
    prec = s.get("precision") or {}
    perf = s.get("perf") or {}
    hops = s.get("hops") or {}
    profiles = s.get("profiles") or []
    lines: list[str] = []
    if prec:
        # the active precision policy leads: every roofline number below
        # was produced under it (ops/precision.py)
        lines.append(
            f"  precision policy: {prec.get('policy', '?')} "
            f"(compute {prec.get('compute_dtype', '?')}, "
            f"staging {prec.get('data_dtype', '?')}, params "
            f"{prec.get('param_dtype', 'float32')}, loss scaling "
            + ("on" if prec.get("loss_scaling") else "off")
            + (", fp8 matmuls" if prec.get("fp8") else "")
            + ")"
        )
    if progs:
        any_rec = next(iter(progs.values()))
        kind = any_rec.get("device_kind", "?")
        pk_f, pk_b = any_rec.get("peak_flops"), any_rec.get("peak_membw")
        src = any_rec.get("peak_source", "?")
        lines.append(
            f"  device {kind} — peak "
            + (f"{pk_f / 1e12:.1f} TFLOP/s" if pk_f else "? FLOP/s")
            + ", "
            + (f"{pk_b / 1e9:.0f} GB/s" if pk_b else "? B/s")
            + f" ({src})"
        )
        lines.append(
            f"  {'program':<16} {'GFLOPs/call':>12} {'MB/call':>10} "
            f"{'arith int':>10} {'phase':<12}"
        )
        for name in sorted(progs):
            p = progs[name]
            ai = p.get("arithmetic_intensity")
            lines.append(
                f"  {name:<16} {p.get('flops', 0) / 1e9:>12.3f} "
                f"{p.get('bytes_accessed', 0) / 1e6:>10.2f} "
                + (f"{ai:>10.2f} " if ai else f"{'n/a':>10} ")
                + f"{p.get('phase') or '(unphased)':<12}"
            )
    if perf:
        bits = []
        if "perf/mfu" in perf:
            bits.append(f"mfu {perf['perf/mfu'] * 100:.3f}%")
        if "perf/membw_util" in perf:
            bits.append(f"membw_util {perf['perf/membw_util'] * 100:.2f}%")
        if "perf/flops_per_s" in perf:
            bits.append(
                f"flops/s {perf['perf/flops_per_s'] / 1e9:.2f} G"
            )
        lines.append("  gauges (last metrics row): " + ", ".join(bits))
    lin_p50 = perf.get("lineage/staleness_p50")
    if lin_p50 is not None:
        lines.append(
            "  lineage (exact per-update staleness, in updates): "
            f"p50 {lin_p50:g}, p99 {perf.get('lineage/staleness_p99', 0):g}, "
            f"max {perf.get('lineage/staleness_max', 0):g}, "
            f"{perf.get('lineage/versions_per_batch', 0):g} version(s)/batch"
        )
    if perf.get("trace/spans"):
        lines.append(
            f"  trace exemplars: {perf['trace/spans']:g} span(s) emitted, "
            f"{perf.get('trace/dropped_spans', 0):g} dropped (chaos)"
        )
    if hops:
        lines.append("  per-hop latency (cross-process timeline):")
        for hop in sorted(hops):
            st = hops[hop]
            if not isinstance(st, dict):
                continue
            lines.append(
                f"    {hop:<24} p50 {st.get('p50', 0):>8.2f} ms  "
                f"p90 {st.get('p90', 0):>8.2f}  p99 {st.get('p99', 0):>8.2f}"
                f"  (n={st.get('n', 0)})"
            )
    if profiles:
        lines.append(f"  profiler captures ({len(profiles)}):")
        for p in profiles[-8:]:
            lines.append(
                f"    {p.get('dir', '?')} — reason={p.get('reason', '?')}"
                + (
                    f", iters {p.get('start_iter')}-{p.get('end_iter')}"
                    if p.get("start_iter") is not None else ""
                )
            )
    return lines


# -- trace (causal span trees) ----------------------------------------------


def trace_summary(folder: str) -> dict | None:
    """Collect every causal span event (the ones ``Tracer.emit_span``
    stamps with an ``exemplar`` id) from the session's event log into
    per-exemplar groups. Pure file reading, safe off the card. None
    when no event log exists."""
    events_path = os.path.join(folder, TELEMETRY_DIR, EVENTS_FILE)
    if not (os.path.exists(events_path)
            or os.path.exists(events_path + ".1")):
        return None
    exemplars: dict[str, list[dict]] = {}
    trace_id = None
    dropped = spans = None
    for ev in _iter_jsonl(events_path):
        if trace_id is None and ev.get("trace"):
            trace_id = ev["trace"]
        if ev.get("type") == "span" and ev.get("exemplar"):
            exemplars.setdefault(str(ev["exemplar"]), []).append(ev)
        elif ev.get("type") == "metrics":
            vals = ev.get("values") or {}
            if "trace/dropped_spans" in vals:
                dropped = vals["trace/dropped_spans"]
            if "trace/spans" in vals:
                spans = vals["trace/spans"]
    return {
        "folder": folder,
        "trace_id": trace_id,
        "exemplars": exemplars,
        "spans": spans,
        "dropped_spans": dropped,
    }


def _render_exemplar(spans: list[dict]) -> list[str]:
    """One exemplar's span tree, children indented under parents, ordered
    by wall time within a level. A span whose parent id was never emitted
    (chaos ``drop_span``, a crashed tier) is NOT hidden: it renders as a
    root with the missing hop marked — a torn tree is evidence."""
    by_id = {int(s["span"]): s for s in spans if s.get("span") is not None}
    kids: dict[int | None, list[dict]] = {}
    for s in sorted(spans, key=lambda x: (x.get("t", 0), x.get("seq", 0))):
        parent = s.get("parent")
        if parent is not None and int(parent) not in by_id:
            parent = ("missing", int(parent))  # torn: render as a root
        elif parent is not None:
            parent = int(parent)
        kids.setdefault(parent, []).append(s)
    t0 = min((s.get("t", 0) for s in spans), default=0)
    lines: list[str] = []

    def emit(s: dict, depth: int, missing_parent: int | None) -> None:
        dur = s.get("dur_ms")
        rel = (s.get("t", t0) - t0) * 1e3
        lines.append(
            f"  {'  ' * depth}[+{rel:8.2f} ms] {s.get('name', '?'):<22} "
            f"span {s.get('span')}  tier {s.get('tier', '?')}"
            + (f"  {float(dur):.3f} ms" if dur is not None else "")
            + (
                f"  !! parent span {missing_parent} MISSING "
                "(dropped/torn hop)" if missing_parent is not None else ""
            )
        )
        for child in kids.get(int(s["span"]), []) if s.get("span") is not None else []:
            emit(child, depth + 1, None)

    for root in kids.get(None, []):
        emit(root, 0, None)
    for parent_key in sorted(
        (k for k in kids if isinstance(k, tuple)),
        key=lambda k: k[1],
    ):
        for orphan in kids[parent_key]:
            emit(orphan, 0, parent_key[1])
    return lines


def trace_report(folder: str, limit: int = 16) -> str | None:
    """Human-readable causal trace timelines for the ``trace`` subcommand:
    one span tree per head-sampled exemplar, newest last, torn hops
    marked. None when the folder has no telemetry."""
    s = trace_summary(folder)
    if s is None:
        return None
    exemplars = s["exemplars"]
    header = f"Causal trace exemplars — {s['folder']}"
    if s.get("trace_id"):
        header += f" (trace {s['trace_id']})"
    lines = [header]
    total = sum(len(v) for v in exemplars.values())
    summary = f"{len(exemplars)} exemplar(s), {total} span event(s)"
    if s.get("dropped_spans"):
        summary += (
            f"; {s['dropped_spans']:g} span(s) DROPPED by chaos — "
            "trees below may be torn"
        )
    lines.append(summary)
    if not exemplars:
        lines.append("  (no causal spans recorded — telemetry.trace "
                     "disabled or nothing sampled yet)")
        return "\n".join(lines)
    ordered = sorted(
        exemplars.items(),
        key=lambda kv: min(s.get("t", 0) for s in kv[1]),
    )
    if len(ordered) > limit:
        lines.append(f"  (showing oldest {limit} of {len(ordered)})")
        ordered = ordered[:limit]
    for name, spans in ordered:
        tiers = []
        for sp in sorted(spans, key=lambda x: (x.get("t", 0),
                                               x.get("seq", 0))):
            tier = sp.get("tier", "?")
            if tier not in tiers:
                tiers.append(tier)
        lines.append("")
        lines.append(
            f"exemplar {name} — {len(spans)} span(s), tiers: "
            + " -> ".join(tiers)
        )
        lines += _render_exemplar(spans)
    return "\n".join(lines)
