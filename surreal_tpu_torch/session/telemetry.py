"""Telemetry spine, the port of the core of
``surreal_tpu/session/telemetry.py``: ``Tracer`` (span accumulators, the
JSONL event log under ``<folder>/telemetry/events.jsonl`` with size-based
rotation, and causal span emission), ``latency_percentiles``,
``TraceContext``, ``head_sampled``, ``LineageReducer`` and
``_iter_jsonl``.

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
SEED trainer) and ``unported`` (the subsystems a session's config turns
on that the port does not have; see ``launch/hooks.py``).

Causal spans (the SEED path): the inference server head-samples 1 in
``telemetry.trace.sample_n`` worker steps (:func:`head_sampled`), emits a
worker root span and a forward child through :meth:`Tracer.emit_span`,
and the learn that consumes the chunk closes the tree. The reference's
``trace.emit`` fault site is not ported.

Not ported yet: the heartbeat writer, the flight recorder's exemplar ring
and the readers (``diag``, ``trace``, ``top``, ``why``).
"""

from __future__ import annotations

import json
import os
import threading
import time
import uuid
from contextlib import contextmanager

TELEMETRY_DIR = "telemetry"
EVENTS_FILE = "events.jsonl"


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
                 trace_id: str | None = None, max_log_mb: float | None = None):
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
        # thread of this process) and the emitted count
        self.spans_emitted = 0
        self._span_ids = 0
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
        (callers measure ``dur_ms`` before calling)."""
        if not self.enabled:
            return
        rec = {"name": name, "exemplar": ctx.exemplar, "span": ctx.span_id, "parent": ctx.parent_id, **fields}
        if tier is not None:
            rec["tier"] = tier
        if dur_ms is not None:
            rec["dur_ms"] = float(dur_ms)
        with self._lock:
            self.spans_emitted += 1
        self.event("span", **rec)

    def trace_gauges(self) -> dict[str, float]:
        """The ``trace/*`` gauges merged into a metrics row."""
        return {"trace/spans": float(self.spans_emitted)}

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
