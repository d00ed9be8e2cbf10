"""Cost and utilization accounting, the port of
``surreal_tpu/session/costs.py``: per-program FLOPs and bytes, resolved
against a peak FLOP/s and bandwidth table, so the metrics stream carries
``perf/flops_per_s``, ``perf/mfu`` and ``perf/membw_util``.

Counting a program. The reference lowers a jitted program and reads
XLA's cost model without running it. PyTorch has no such pass, so the
port counts the program's first real call instead (:func:`program_costs`,
through :meth:`CostAccountant.count_program`): the call runs once, as it
would anyway, under :class:`OpCounter`, a ``TorchDispatchMode`` that reads
only shapes and dtypes of each aten op's inputs and outputs. So the
counted call gives bit-equal results to an uncounted one and adds no host
sync. Autograd's backward ops are counted too, also where the engine runs
them on its device threads (the mode stack travels with autograd's thread
state). The rules are those of XLA's ``HloCostAnalysis``:

- a matmul or convolution is 2·M·N·K FLOPs, backward included
  (``torch.utils.flop_counter``'s formulas), plus one FLOP an output
  element for a bias it adds (``addmm``, ``baddbmm``, a convolution's
  bias; XLA counts that add on its own);
- an elementwise arithmetic op is one FLOP an output element (a clamp
  with both bounds two, ``addcmul``/``addcdiv`` two, ``lerp`` three, a
  dtype conversion one, a copy none); transcendentals (exp, log, tanh,
  sigmoid, pow, sqrt, rsqrt, sin, cos, erf and kin) are counted apart,
  as XLA does, and kept out of ``flops``;
- a reduction is one FLOP an input element less one an output element
  (a mean adds the division), a softmax four an input element;
- ``bytes_accessed`` is each op's inputs plus outputs; views, aliases and
  uninitialised allocations move nothing and count nothing.

Two differences from the reference's numbers remain, both of what is
counted rather than how: XLA's pass runs on the program before fusion,
so it also counts the bytes of broadcasts, reshapes and constants that
PyTorch never materialises; and it counts a loop body (a ``lax.scan``
rollout, the epoch and minibatch scans) once, where the port's counted
call runs every iteration of it. The tests hold the rules to the
reference (``tests/test_torch_costs.py``).

The kernels. A kernel called through ``ctypes`` is invisible to a
dispatch mode, while its plain CPU version would be counted op by op.
So each kernel wrapper (``ops/gae.py``, ``ops/vtrace.py``,
``ops/rev_scan.py``, ``ops/replay_rows.py``) runs inside
:func:`kernel_cost`, which hides its inner ops from an active counter and
reports one entry instead: the bytes and float32 operations of the
kernel's bound (each input read once, each output written once; PERF.md
§6). It does so on both devices, so the CPU and the card count the same
work for one config, and a roofline reads the same numbers whatever
implements the kernel.

The gauges. ``CostAccountant.gauges(window)`` is pure host arithmetic
over a flushed phase window (``Tracer.last_window``), with no device
read. The port's spans are unfenced host clocks (``session/telemetry.py``):
a phase that issues CUDA work measures its dispatch, and the device's
tail lands in the window's one fence, the ``metrics-sync`` span. So the
denominator is the registered programs' phase seconds plus the window's
``metrics-sync`` seconds: it covers the device's work of the window, and
the gauges never read high because the host ran ahead. (On a window with
no ``metrics-sync`` phase the arithmetic is the reference's.)
``chip_smoke.py`` holds ``perf/flops_per_s`` against a fenced measurement.

``session.perf.memory_analysis``: 'auto' (the default) is off, as the
reference's rule makes it without an active compile cache, which the
port refuses; ``True`` records the counted call's peak allocation on CUDA
(``torch.cuda.max_memory_allocated`` after
``reset_peak_memory_stats``, host-side allocator counters).

Gauge registry: every ``perf/*`` scalar the port emits is listed in
:data:`GAUGE_REGISTRY`; ``tests/test_torch_hygiene.py`` lints source
literals against it.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any

import torch
from torch.utils._python_dispatch import TorchDispatchMode

# the units a registered gauge may declare. The watchdog's threshold
# arithmetic keys off these (counters vs latencies vs ratios), and
# the reference's `why` renders firing values with them — so the unit
# lint in tests/test_torch_hygiene.py rejects anything outside this set.
GAUGE_UNITS = frozenset(
    {"ms", "bytes", "count", "ratio", "steps/s", "flops/s", "scalar"}
)


def _g(unit: str, desc: str) -> dict[str, str]:
    """One GAUGE_REGISTRY record: a documented description plus the
    machine-readable unit."""
    return {"unit": unit, "desc": desc}


def gauge_unit(name: str) -> str | None:
    """The declared unit of a registered gauge, None for unregistered
    names (per-instance body keys the tiers invent)."""
    rec = GAUGE_REGISTRY.get(name)
    return rec.get("unit") if isinstance(rec, dict) else None


# Documented registry of every perf/*, replay/*, experience/*, fleet/*,
# param/*, gateway/* (and the other families below) gauge the reference
# emits, copied whole so the two packages document one set of names.
# tests/test_torch_hygiene.py scans the port's source for whole
# "<prefix>/<name>" literals and fails on any not listed here; every
# record carries a {unit, desc} dict. Keep descriptions current — diag
# and README point here. Per-shard detail for the experience plane rides the
# 'experience_plane' telemetry EVENT (diag's "Experience plane" section);
# the metrics-row gauges below are the fleet aggregates.
GAUGE_REGISTRY = {
    "perf/mfu": _g("ratio",
        'model FLOP utilization over the metrics window: sum over '
        'registered programs of (flops/call x calls) / ((phase seconds + '
        'the window\'s metrics-sync seconds) x peak FLOP/s). Lower bound '
        'when a phase contains non-program work.'),
    "perf/membw_util": _g("ratio",
        'memory-bandwidth utilization over the metrics window: bytes '
        'accessed (the counted call\'s bytes, session/costs.py) per '
        'second / peak bytes/s.'),
    "perf/flops_per_s": _g("flops/s",
        'achieved model FLOP/s over the metrics window (the MFU numerator; '
        'emitted even when no peak spec is known for the device).'),
    # -- replay occupancy (replay/base.py ring gauges; device scalars) ------
    "replay/size": _g("count",
        'absolute ring fill (transitions currently held).'),
    "replay/fill": _g("ratio", 'ring fill as a fraction of capacity.'),
    "replay/max_priority": _g("scalar",
        "prioritized replay's fresh-insert priority scale (pmax-synced "
        'across dp shards).'),
    "replay/sample_age_frac": _g("ratio",
        'mean staleness of a sampled index batch as a fraction of the '
        'current fill (0 = just written).'),
    # -- experience plane (surreal_tpu/experience/; fleet aggregates) -------
    "experience/shards_live": _g("count",
        'replay shard servers currently alive.'),
    "experience/respawns": _g("count",
        'shard respawns performed by the plane supervisor this run.'),
    "experience/rows": _g("count",
        'total transitions ingested across all shards.'),
    "experience/fill": _g("ratio", 'mean shard ring fill fraction.'),
    "experience/ingest_rows_per_s": _g("steps/s",
        'summed shard ingestion rate (the actor-fleet throughput the plane '
        'absorbs).'),
    "experience/wire_bytes_per_step": _g("bytes",
        'shard-side wire bytes (in+out) per ingested transition — the '
        'zero-copy success metric (control frames vs shipped arrays).'),
    "experience/sample_queue_depth": _g("count",
        'sample requests deferred at shards (watermark not yet ingested).'),
    "experience/sample_wait_ms": _g("ms",
        "EWMA of the learner's wait for a prefetched iteration of batches — "
        '~0 means the learner never waits on experience ingest.'),
    "experience/dropped_rows": _g("count",
        "transitions dropped after the sender's bounded retry budget "
        'exhausted against a dead shard.'),
    "experience/sent_rows": _g("count",
        "sender-side transitions handed to the wire (watermark units — "
        're-based to the shard ledger on a re-hello); with ingested + '
        'dropped + inflight it closes the exactly-once conservation law '
        'the chaos oracle checks.'),
    # -- serving tier (distributed/fleet.py; fleet aggregates) --------------
    "fleet/replicas_live": _g("count",
        'inference-server replicas currently alive.'),
    "fleet/respawns": _g("count",
        'replica respawns performed by the fleet supervisor this run (in '
        'place, fixed address, exponential backoff).'),
    "fleet/scale_ups": _g("count", 'autoscale replica additions this run.'),
    "fleet/scale_downs": _g("count", 'autoscale replica drains this run.'),
    "fleet/serve_ms": _g("ms",
        "fleet-mean serve-latency EWMA — the autoscaler's up/down signal."),
    "fleet/queue_depth": _g("count",
        'summed trajectory-chunk queue depth across replicas.'),
    # -- parameter fanout (distributed/param_fanout.py) ---------------------
    "param/publishes": _g("count",
        'weight frames broadcast by the fanout this run.'),
    "param/full_frames": _g("count", 'full (key) frames among them.'),
    "param/delta_frames": _g("count", 'delta frames among them.'),
    "param/rekeys": _g("count",
        'full frames FORCED by a stale/absent subscriber ack (a dropped '
        'frame or late joiner re-keys the delta stream).'),
    "param/bytes_last_publish": _g("bytes", 'wire bytes of the newest frame.'),
    "param/bytes_published": _g("bytes",
        'cumulative fanout wire bytes this run.'),
    "param/subscribers": _g("count",
        'subscribers with a fresh (ttl-bounded) ack.'),
    # subscriber-side counters (ParameterSubscriber.gauges — actor/eval
    # processes and tests; not part of the trainer's metrics rows)
    "param/applied_frames": _g("count", 'frames this subscriber applied.'),
    "param/stale_frames": _g("count",
        'inapplicable deltas this subscriber dropped (missed frame / fresh '
        'join) — each flags needs_resync toward the fetch fallback.'),
    "param/fallback_fetches": _g("count",
        'ParameterClient.fetch catch-ups this subscriber performed (the '
        'late-joiner / dropped-frame path; counted, never silent).'),
    "param/holds": _g("count",
        'param versions the fanout currently holds pinned for gateway '
        'sessions (full frames retained until every pin releases).'),
    # -- session gateway (surreal_tpu/gateway/; tenant-facing tier) ---------
    "gateway/sessions": _g("count",
        'sessions currently attached across all tenants.'),
    "gateway/attaches": _g("count",
        'sessions admitted this run (first attach only).'),
    "gateway/reattaches": _g("count",
        're-attaches onto a live session id (client reconnect; the session '
        'record and its replica binding survive).'),
    "gateway/detaches": _g("count", 'explicit tenant detaches this run.'),
    "gateway/acts": _g("count", 'act requests served (cache hits included).'),
    "gateway/cache_hits": _g("count",
        'acts answered from the bounded (version, obs-digest) act cache '
        'without touching a fleet replica.'),
    "gateway/cache_misses": _g("count",
        'acts that paid a fleet serve_act forward.'),
    "gateway/migrations": _g("count",
        'session rebinds performed after a replica death (invisible '
        'failover; counted per moved session).'),
    "gateway/catch_ups": _g("count",
        'pinned sessions force-unpinned because their param version was '
        "evicted from the fleet's act history (flagged on the reply — "
        'counted, never silent).'),
    "gateway/pinned_sessions": _g("count",
        'sessions currently pinned to a param version.'),
    "gateway/dropped_replies": _g("count",
        'act replies swallowed by fault injection (gateway.session '
        "drop_frame); the client's bounded resend redelivers."),
    "gateway/bad_frames": _g("count",
        "malformed/hostile tenant frames dropped at the serve loop's frame "
        'boundary (truncated headers, bad obs bodies, undecodable or '
        'un-negotiated pickle fallbacks) — counted, never a crash.'),
    "gateway/respawns": _g("count",
        'gateway serve-thread respawns performed by its supervisor (in '
        'place, fixed address, shared backoff schedule).'),
    # admission plane (gateway/admission.py)
    "gateway/rejected_sessions": _g("count",
        'attach attempts refused — by session quota (global or per-tenant) '
        'or by the re-attach tenant/token credential check.'),
    "gateway/throttled_acts": _g("count",
        "acts past a tenant's token-bucket rate, parked in its bounded "
        'queue instead of served immediately.'),
    "gateway/evicted_requests": _g("count",
        "oldest queued acts evicted when a tenant's backpressure queue "
        'overflowed (each gets an ACT_ERR — counted, never silent).'),
    "gateway/expired_leases": _g("count",
        'sessions reaped idle past their lease.'),
    "gateway/queued_acts": _g("count",
        'acts currently parked across tenant queues.'),
    # -- live ops plane (session/opsplane.py; ---------------------
    "ops/tiers": _g("count",
        'tiers that have pushed at least one row to the run aggregator '
        '(gateway, fleet replicas, experience shards, learner, fanout).'),
    "ops/bad_frames": _g("count",
        "undecodable/hostile rows dropped at the aggregator's PULL boundary "
        '— counted, never a crash.'),
    "ops/snapshots": _g("count",
        'merged run snapshots written to telemetry/ops_snapshot.json (one '
        'per metrics cadence; the file `surreal_tpu top` renders).'),
    "ops/flightrec_dumps": _g("count",
        'flight-recorder dumps written under telemetry/flightrec/ (recovery '
        'trip, chaos fault, SLO budget exhaustion, or an opened incident; '
        'at most one per trigger per cooldown).'),
    # watchdog & incident engine (session/watchdog.py, session/incidents.py)
    "ops/watchdog_evals": _g("count",
        'detector sweeps run over merged ops snapshots (one per metrics '
        'cadence while session_config.watchdog.enabled).'),
    "ops/watchdog_dropped_evals": _g("count",
        'detector sweeps skipped by the watchdog.eval chaos site '
        '(drop_eval) — counted, never silent.'),
    "ops/watchdog_firings": _g("count",
        'detector firings across all sweeps this run (breakout, '
        'saturation, growth, liveness, regression).'),
    "ops/incidents_open": _g("count",
        'whether an incident is currently open (0/1 — the engine holds at '
        'most one open incident, extending it while detectors keep '
        'firing).'),
    "ops/incidents_total": _g("count",
        'incidents opened this run (each persisted under '
        'telemetry/incidents/incident-<n>.json and rendered by '
        '`surreal_tpu why`).'),
    # per-tenant SLOs (session/slo.py)
    "slo/breaches": _g("count",
        'SLO evaluation windows that breached a declared objective (every '
        'one is also a counted slo_breach telemetry event).'),
    "slo/exhaustions": _g("count",
        'error budgets exhausted this run (edge-triggered: one per '
        'incident, each freezing a flightrec/slo dump).'),
    "slo/objectives": _g("count",
        'objectives armed via session_config.slo.* targets.'),
    "lineage/staleness_p50": _g("count",
        'exact per-update staleness median: p50 over (current version - '
        'acting version) of every transition in the batch that entered this '
        'gradient, from the collection-time lineage stamps. Host numpy over '
        'the already-fetched version column — no device sync.'),
    "lineage/staleness_p99": _g("count",
        "exact per-update staleness p99 over the batch's acting-policy "
        "versions (the SLO plane's staleness objective prefers this over "
        'the published-vs-held approximation when lineage is on).'),
    "lineage/staleness_max": _g("count",
        'oldest transition that entered this update, in version lags.'),
    "lineage/versions_per_batch": _g("count",
        "distinct acting-policy versions mixed into this update's batch (1 "
        '== perfectly on-policy data).'),
    "trace/spans": _g("count",
        "causal spans emitted so far by this process's tracer (head-sampled "
        'exemplars, telemetry.trace.sample_n).'),
    "trace/dropped_spans": _g("count",
        'spans dropped by the trace.emit chaos site — counted, never '
        "silent; the exemplar's tree renders with the torn hop marked."),
    # -- closed-loop remediation (session/remediate.py; -----------
    "remediation/actions": _g("count",
        'bounded actions executed by the remediation engine (each a '
        'remediation event, an atomic telemetry/actions/action-<n>.json '
        "record, and evidence on the incident that triggered it)."),
    "remediation/suppressed": _g("count",
        'would-be actions stopped by the global max_actions budget or a '
        'per-kind cooldown — loud (a counted remediation event), never a '
        'silent retry loop.'),
    "remediation/unmapped": _g("count",
        "decision sweeps where the open incident's top cause had no bound "
        'actuator or no actionable target — counted, never guessed.'),
    "remediation/reverted": _g("count",
        'actions undone by the counter-detector after their triggering '
        'objective regressed further (quota restored, replica drained, '
        'overrides rolled back).'),
    "remediation/ineffective": _g("count",
        'actions the counter-detector judged ineffective over '
        'verify_windows post-action sweeps.'),
    "remediation/effective": _g("count",
        'actions whose triggering objective did NOT regress further over '
        'the verification window.'),
    "remediation/errors": _g("count",
        'actuator calls that raised (execute or revert) — journaled and '
        'counted; actuation must never kill training.'),
    "remediation/active": _g("count",
        'actions currently inside their verification window.'),
    # -- elastic learner group (parallel/learner_group.py; --------
    "lgroup/members": _g("count",
        'alive data-parallel learner-group members draining the '
        'experience plane.'),
    "lgroup/rebalances": _g("count",
        'shard-subset repartitions (join/leave/failure/respawn each '
        'costs one rebalance, not a run).'),
    "lgroup/rekeys": _g("count",
        'fanout full-frame re-keys forced by membership changes (each '
        'also counts into param/rekeys on the one distribution tree).'),
    "lgroup/joins": _g("count", 'members that joined mid-run.'),
    "lgroup/leaves": _g("count",
        'members removed mid-run (planned scale-down).'),
    "lgroup/respawns": _g("count",
        'crashed members revived under the RespawnSchedule backoff.'),
    "lgroup/respawn_backoff_s": _g("scalar",
        'current member-respawn backoff (exponential, capped).'),
    "lgroup/sample_wait_ms": _g("ms",
        "slowest member's EWMA batch-stitch wait — the group analogue "
        'of experience/sample_wait_ms.'),
    "lgroup/allreduce_learns": _g("count",
        'SGD updates run through the shard_map gradient all-reduce '
        '(M members on >= M devices).'),
    "lgroup/fallback_learns": _g("count",
        'M>1 updates degraded to ONE full-batch learn (single device / '
        'indivisible batch) — the honesty counter: artifacts report a '
        'ratio, never a fabricated speedup.'),
    # -- tenant load generator (gateway/loadgen.py; ---------------
    "gateway/quota_changes": _g("count",
        'runtime per-tenant quota mutations via AdmissionController.'
        'set_quota (operator reconfigs and remediation throttles alike).'),
    "loadgen/tenants": _g("count",
        'tenant threads in the generator mix (steady + abusive profiles).'),
    "loadgen/attaches": _g("count",
        'sessions the generator attached across all tenants.'),
    "loadgen/detaches": _g("count",
        'sessions the generator detached (attach_storm churns these).'),
    "loadgen/acts": _g("count",
        'acts served to generator tenants end-to-end.'),
    "loadgen/act_errors": _g("count",
        'acts answered with a counted gateway rejection (throttle '
        'eviction, quota, dead session) — the expected outcome for the '
        'abusive profiles.'),
    "loadgen/rejected": _g("count",
        'attach attempts denied by admission control.'),
    "loadgen/timeouts": _g("count",
        'acts that exhausted client retries without a reply.'),
    "loadgen/hostile_frames": _g("count",
        'malformed frames the adversarial profile put on the wire (each '
        "must land in the server's gateway/bad_frames, never a crash)."),
    "loadgen/act_rtt_ms": _g("ms",
        'mean client-observed act round-trip across generator tenants.'),
    # -- replay tiers (replay/tiers.py, experience/spill.py; ------
    "tier/hot_size": _g("count",
        "transitions resident in the device hot ring."),
    "tier/hot_fill": _g("ratio",
        "hot ring occupancy (size / hot_capacity)."),
    "tier/hot_hits": _g("count",
        'updates whose batch was drawn on-device from the hot tier '
        '(no wire frame, no host->device transfer).'),
    "tier/hot_misses": _g("count",
        'updates that fell back to the warm shard fan-in (hot ring '
        'still filling) — counted, never silent.'),
    "tier/spill_segments": _g("count",
        'WAL segments appended across shards (experience/spill.py).'),
    "tier/spill_rows": _g("count",
        'transitions spilled to the WAL across shards.'),
    "tier/spill_bytes": _g("bytes",
        'total WAL bytes on disk across shards (framed, after '
        'quantization).'),
    "tier/spill_errors": _g("count",
        'WAL appends that failed (ENOSPC, IO error) — the writer '
        'degrades and the warm ring keeps serving.'),
    "tier/spill_failed": _g("count",
        'shards whose writer latched off after consecutive append '
        'failures (1 per latched shard).'),
    "tier/cold_bytes_per_row": _g("bytes",
        'encoded WAL bytes per transition (the quantization win vs the '
        'raw f32 row — BENCH_tiers.json commits the ratio).'),
    "tier/torn_segments": _g("count",
        'torn WAL segments skipped by magic-resync on read (crash '
        'mid-append; the experience.spill chaos site drives this).'),
    # ---- loop engine (engine/core.py, ----
    "engine/stage_p50_ms": _g("ms",
        'median deferred-boundary duration (publish/checkpoint/observe '
        'side-bands + metrics materialization), last 512 boundaries.'),
    "engine/stage_p99_ms": _g("ms",
        'p99 deferred-boundary duration over the same window.'),
    "engine/occupancy": _g("ratio",
        'staging-worker busy fraction of wall time while pipelining — '
        'the off-critical-path work actually reclaimed.'),
    "engine/queue_depth": _g("count",
        'deferred boundaries in flight (bounded at 1: one pending slot).'),
    "engine/deferred_boundaries": _g("count",
        'boundaries submitted to the staging executor this run.'),
    "engine/skipped_boundaries": _g("count",
        'boundaries skipped because the previous one wedged past '
        'stage_timeout_s (never silent — warned and counted).'),
    "engine/stage_kills": _g("count",
        'engine.stage kill_stage chaos firings absorbed by the boundary '
        '(the stage crashed; training continued).'),
    # ---- chaos campaigns (chaos/campaign.py, ----
    "chaos/schedules": _g("count",
        'seeded multi-site fault schedules executed by this campaign.'),
    "chaos/violations": _g("count",
        'invariant-oracle violations across the campaign (the gate '
        'requires zero in the committed artifact).'),
    "chaos/faults_injected": _g("count",
        'fault firings actually delivered across all campaign runs '
        '(plan entries whose site reached its scheduled call count).'),
    "chaos/sites_covered": _g("count",
        'distinct fault sites that FIRED at least once this campaign '
        '(the artifact gate requires >= 10).'),
    "chaos/shrink_iters": _g("count",
        're-runs spent by the greedy shrinker reducing failing '
        'schedules to minimal form (0 on a clean campaign).'),
    "chaos/run_ms": _g("ms", 'campaign wall-clock, all runs + shrinking.'),
}

# Public peak specs per accelerator: (needle, peak FLOP/s bf16, peak HBM
# bytes/s), matched by substring against the lowercased device kind
# (``torch.cuda.get_device_name()`` on CUDA). The H100 row is the SXM5
# 80 GB card at 700 W from NVIDIA's data sheet: 989.4 TFLOP/s dense bf16,
# 3.35 TB/s HBM3. The TPU rows are the reference's, kept so a folder
# written by either package resolves alike.
PEAK_SPECS: tuple[tuple[str, float, float], ...] = (
    ("h100", 989.4e12, 3.35e12),
    ("v5 lite", 197e12, 819e9),   # TPU v5e (jax reports 'TPU v5 lite')
    ("v5litepod", 197e12, 819e9),
    ("v5e", 197e12, 819e9),
    ("v5p", 459e12, 2765e9),
    ("v6 lite", 918e12, 1640e9),  # Trillium
    ("v6e", 918e12, 1640e9),
    ("v4", 275e12, 1228e9),
    ("v3", 123e12, 900e9),
    ("v2", 45e12, 700e9),
    # host CPU: the reference's nominal order-of-magnitude figure, so CPU
    # gauges equal the reference's; real CPU runs should override via
    # session.perf.peak_flops / peak_membw
    ("cpu", 1e11, 5e10),
)


def device_kind(device=None) -> str:
    """``torch.cuda.get_device_name`` of a CUDA ``device``, else 'cpu'."""
    device = torch.device(device) if device is not None else torch.device("cpu")
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


class PeakSpec:
    """Resolved peak numbers for the active device."""

    __slots__ = ("flops", "membw", "device_kind", "source")

    def __init__(self, flops, membw, device_kind: str, source: str):
        self.flops = float(flops) if flops else None
        self.membw = float(membw) if membw else None
        self.device_kind = device_kind
        self.source = source  # 'override' | 'table' | 'unknown'

    def to_dict(self) -> dict:
        return {
            "peak_flops": self.flops,
            "peak_membw": self.membw,
            "device_kind": self.device_kind,
            "peak_source": self.source,
        }


def resolve_peak_spec(session_cfg, device=None) -> PeakSpec:
    """Peak FLOP/s and bytes/s for ``device``: the
    ``session.perf.peak_flops``/``peak_membw`` overrides win; otherwise
    the :data:`PEAK_SPECS` device-kind table; otherwise an 'unknown'
    spec (costs still recorded, utilization gauges limited to
    ``perf/flops_per_s``)."""
    kind = device_kind(device)
    perf = session_cfg.get("perf", None) if session_cfg is not None else None
    over_f = perf.get("peak_flops", None) if perf is not None else None
    over_b = perf.get("peak_membw", None) if perf is not None else None
    if over_f or over_b:
        # a partial override fills the other half from the table
        t_f, t_b = _table_lookup(kind)
        return PeakSpec(over_f or t_f, over_b or t_b, kind, "override")
    t_f, t_b = _table_lookup(kind)
    if t_f is not None:
        return PeakSpec(t_f, t_b, kind, "table")
    return PeakSpec(None, None, kind, "unknown")


def _table_lookup(kind: str) -> tuple[float | None, float | None]:
    lowered = (kind or "").lower()
    for needle, flops, membw in PEAK_SPECS:
        if needle in lowered:
            return flops, membw
    return None, None


# -- counting ------------------------------------------------------------------

_aten = torch.ops.aten
_TRANSCENDENTAL = frozenset({
    "exp", "exp2", "expm1", "log", "log2", "log10", "log1p", "tanh", "sigmoid", "pow", "sqrt", "rsqrt",
    "sin", "cos", "tan", "erf", "erfc", "erfinv", "atan", "atan2", "asin", "acos", "sinh", "cosh", "logit",
    "softplus", "float_power", "xlogy", "special_xlog1py", "lgamma", "digamma",
})
# elementwise ops counted as more (or fewer) than one op an output element
_POINTWISE_FLOPS = {"clone": 0, "addcmul": 2, "addcdiv": 2, "lerp": 3, "tanh_backward": 3,
                    "sigmoid_backward": 3}
_NO_BYTES = frozenset({
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "_local_scalar_dense",
    "lift_fresh", "detach", "alias", "set_", "resize_", "record_stream",
})
_SOFTMAX = {"_softmax": (4, 1), "_log_softmax": (4, 1), "_softmax_backward_data": (4, 0),
            "_log_softmax_backward_data": (3, 1)}  # (flops, transcendentals) an input element
_BIAS_ADD = frozenset({"addmm", "baddbmm"})
_CONV = frozenset({"convolution", "_convolution", "cudnn_convolution", "convolution_overrideable"})

_local = threading.local()


def _numel(x) -> int:
    return x.numel() if isinstance(x, torch.Tensor) else 0


def _tensors(x, out: list) -> list:
    """The tensors of an op's arguments or results (tensors, and lists or
    tuples of them; a hand walk, several times cheaper than a pytree's)."""
    if isinstance(x, torch.Tensor):
        out.append(x)
    elif isinstance(x, (list, tuple)):
        for y in x:
            _tensors(y, out)
    elif isinstance(x, dict):
        for y in x.values():
            _tensors(y, out)
    return out


def _nbytes(tensors: list) -> int:
    return sum(x.numel() * x.element_size() for x in tensors)


_KINDS: dict = {}  # func -> (name, kind) where kind selects the rule of op_cost


def _kind(func) -> tuple[str, str]:
    got = _KINDS.get(func)
    if got is None:
        name = func._overloadpacket.__name__
        # an in-place variant counts as its functional form
        name = name[:-1] if name.endswith("_") and not name.startswith("_") else name
        if func.is_view or name in _NO_BYTES:
            kind = "none"
        elif func._overloadpacket in _flop_registry():
            kind = "registry"
        elif name in _SOFTMAX:
            kind = "softmax"
        elif torch.Tag.pointwise in func.tags:
            kind = "pointwise"
        elif torch.Tag.reduction in func.tags:
            kind = "reduction"
        else:
            kind = "other"
        got = _KINDS[func] = (name, kind)
    return got


def op_cost(func, args, kwargs, out) -> tuple[int, int, int]:
    """(flops, transcendentals, bytes) of one aten op call by the rules of
    the module docstring; reads shapes and dtypes only."""
    name, kind = _kind(func)
    if kind == "none":
        return 0, 0, 0
    tensors_in = _tensors(args, _tensors(kwargs, []))
    tensors_out = _tensors(out, [])
    nbytes = _nbytes(tensors_in) + _nbytes(tensors_out)
    out_n = sum(x.numel() for x in tensors_out)
    flops = trans = 0
    if kind == "registry":
        flops = int(_flop_registry()[func._overloadpacket](*args, **kwargs, out_val=out))
        if name in _BIAS_ADD:
            flops += out_n
        elif name in _CONV and len(args) > 2 and isinstance(args[2], torch.Tensor):
            flops += out_n
        elif name == "convolution_backward" and len(args) > 10 and args[10][2]:
            flops += _numel(args[0]) - _numel(out[2])  # the bias gradient's reduction
    elif kind == "softmax":
        per_f, per_t = _SOFTMAX[name]
        x = tensors_in[0]
        dim = args[1] if name in ("_softmax", "_log_softmax") else args[2]
        n = x.numel()
        rows = n // max(1, x.shape[dim] if x.dim() else 1)
        flops, trans = per_f * n - 2 * rows, per_t * (n if name != "_log_softmax" else n + rows)
    elif kind == "pointwise":
        if name in _TRANSCENDENTAL:
            trans = out_n
        elif name == "clamp":
            flops = out_n * sum(1 for b in args[1:3] if b is not None)
        else:
            flops = out_n * _POINTWISE_FLOPS.get(name, 1)
    elif kind == "reduction":
        in_n = tensors_in[0].numel() if tensors_in else 0
        flops = max(0, in_n - out_n) + (out_n if name == "mean" else 0)
        if name == "linalg_vector_norm":
            flops += in_n  # the squares
            trans = out_n   # the root
    elif name == "_to_copy":
        src = tensors_in[0]
        if kwargs.get("dtype", src.dtype) != src.dtype:
            flops = out_n  # a conversion
    elif name == "cumsum":
        flops = out_n
    return flops, trans, nbytes


_REGISTRY: list = []


def _flop_registry():
    if not _REGISTRY:
        from torch.utils.flop_counter import flop_registry

        _REGISTRY.append(flop_registry)
    return _REGISTRY[0]


class OpCounter(TorchDispatchMode):
    """Counts the aten ops run under it (see the module docstring), and
    the kernels that report themselves through :func:`kernel_cost`."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.transcendentals = 0
        self.bytes = 0
        self.ops = 0
        self.kernels: dict[str, dict[str, int]] = {}
        self._hidden = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not self._hidden:
            f, t, b = op_cost(func, args, kwargs, out)
            self.flops += f
            self.transcendentals += t
            self.bytes += b
            self.ops += 1
        return out

    def __enter__(self):
        stack = getattr(_local, "counters", None)
        if stack is None:
            stack = _local.counters = []
        stack.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _local.counters.pop()
        return super().__exit__(*exc)

    def add_kernel(self, name: str, flops: int, nbytes: int) -> None:
        k = self.kernels.setdefault(name, {"calls": 0, "flops": 0, "bytes": 0})
        k["calls"] += 1
        k["flops"] += int(flops)
        k["bytes"] += int(nbytes)
        self.flops += int(flops)
        self.bytes += int(nbytes)

    def costs(self) -> dict[str, Any]:
        return {
            "flops": float(self.flops),
            "bytes_accessed": float(self.bytes),
            "arithmetic_intensity": (self.flops / self.bytes) if self.bytes > 0 else None,
            "transcendentals": float(self.transcendentals),
            "ops": self.ops,
            "kernels": {k: dict(v) for k, v in sorted(self.kernels.items())},
        }


def active_counter() -> OpCounter | None:
    """The :class:`OpCounter` this thread runs under, if any."""
    stack = getattr(_local, "counters", None)
    return stack[-1] if stack else None


@contextmanager
def kernel_cost(name: str, flops: int, nbytes: int):
    """Run a kernel wrapper's body as one counted entry: under an active
    :class:`OpCounter`, its inner ops (the launch's casts and allocations,
    or the plain CPU version) are hidden and ``flops`` and ``nbytes``
    reported instead. Without a counter it costs one thread-local read."""
    counter = active_counter()
    if counter is None:
        yield
        return
    counter.add_kernel(name, flops, nbytes)
    counter._hidden += 1
    try:
        yield
    finally:
        counter._hidden -= 1


def program_costs(fn, *args, **kwargs) -> tuple[Any, dict]:
    """Run ``fn(*args, **kwargs)`` once under an :class:`OpCounter`:
    (its result, ``{"flops", "bytes_accessed", "arithmetic_intensity",
    "transcendentals", "ops", "kernels"}``)."""
    with OpCounter() as counter:
        out = fn(*args, **kwargs)
    return out, counter.costs()


SYNC_PHASE = "metrics-sync"  # SessionHooks.end_iteration's one fence of a window


class CostAccountant:
    """Per-session registry of hot-program costs and the live perf gauges.

    Trainers route each hot program's calls through :meth:`count_program`
    (``SessionHooks.count_program``), naming the tracer phase that times
    it; its first call is counted, later calls go straight through::

        state, carry, metrics = hooks.count_program(
            "train_iter", self._device_train_iter, state, carry, generator,
            phase="train_iter",
        )

    ``gauges(window)`` then turns a flushed phase window into ``perf/*``
    host floats.
    """

    def __init__(self, session_cfg, on_event=None, log=None, policy=None, device=None):
        # policy: the learner's resolved PrecisionPolicy, stamped into
        # every program_cost record so rows of different policies never mix
        self.policy = policy
        self._cfg = session_cfg
        self._device = torch.device(device) if device is not None else torch.device("cpu")
        self.enabled = True
        perf = session_cfg.get("perf", None) if session_cfg is not None else None
        if perf is not None and not perf.get("enabled", True):
            self.enabled = False
        self._mem_mode = perf.get("memory_analysis", "auto") if perf is not None else "auto"
        self._on_event = on_event
        self._log = log
        self._programs: dict[str, dict] = {}
        self._counting: set[str] = set()  # a first call in flight (another thread's)
        self._lock = threading.Lock()
        self.peak: PeakSpec | None = None  # resolved at the first count

    @property
    def programs(self) -> dict[str, dict]:
        return dict(self._programs)

    def _memory_analysis_ok(self) -> bool:
        # 'auto' is on only with an active persistent compile cache in the
        # reference; the port refuses that cache, so 'auto' is off
        return self._mem_mode is True and self._device.type == "cuda"

    def count_program(self, name: str, fn, *args, phase: str | None = None, calls_per_phase: int = 1, **kwargs):
        """``fn(*args, **kwargs)``; its first call under ``name`` is counted
        and recorded (one ``program_cost`` event). ``phase`` names the
        tracer phase whose window times this program (None: recorded for
        diag, kept out of the gauges); ``calls_per_phase`` how often it
        runs in one span of that phase."""
        with self._lock:
            first = self.enabled and name not in self._programs and name not in self._counting
            if first:
                self._counting.add(name)
        if not first:
            return fn(*args, **kwargs)
        try:
            if self.peak is None:
                self.peak = resolve_peak_spec(self._cfg, self._device)
            mem = self._memory_analysis_ok()
            if mem:
                torch.cuda.reset_peak_memory_stats(self._device)
            out, costs = program_costs(fn, *args, **kwargs)
            rec = {"name": name, "phase": phase, "calls_per_phase": int(calls_per_phase), **costs}
            if self.policy is not None:
                rec["precision"] = getattr(self.policy, "name", str(self.policy))
            if mem:
                rec["memory"] = {"peak_allocated": int(torch.cuda.max_memory_allocated(self._device))}
            with self._lock:
                self._programs[name] = rec
        finally:
            with self._lock:
                self._counting.discard(name)
        if self._log is not None:
            self._log.info(
                "program cost %r: %.3g FLOPs/call, %.3g bytes/call%s", name, rec["flops"], rec["bytes_accessed"],
                f", AI {rec['arithmetic_intensity']:.2f}" if rec.get("arithmetic_intensity") else "",
            )
        if self._on_event is not None:
            self._on_event("program_cost", **rec, **self.peak.to_dict())
        return out

    def gauges(self, window: dict | None) -> dict[str, float]:
        """``perf/*`` scalars for one flushed phase window, pure host float
        arithmetic. Programs whose phase did not run in the window
        contribute nothing; an empty result means no registered program
        ran. The denominator adds the window's ``metrics-sync`` seconds
        (see the module docstring)."""
        if not self.enabled or not window or not self._programs:
            return {}
        flops = 0.0
        byts = 0.0
        denom_s = 0.0
        seen_phases: set[str] = set()
        for rec in list(self._programs.values()):
            ph = rec.get("phase")
            if ph is None or ph not in window:
                continue
            st = window[ph]
            count = float(st.get("count", 0))
            flops += rec["flops"] * count * rec["calls_per_phase"]
            byts += rec["bytes_accessed"] * count * rec["calls_per_phase"]
            if ph not in seen_phases:
                seen_phases.add(ph)
                denom_s += float(st.get("total_s", 0.0))
        if seen_phases and SYNC_PHASE in window and SYNC_PHASE not in seen_phases:
            denom_s += float(window[SYNC_PHASE].get("total_s", 0.0))
        if denom_s <= 0.0 or (flops <= 0.0 and byts <= 0.0):
            return {}
        out = {"perf/flops_per_s": flops / denom_s}
        peak = self.peak
        if peak is not None and peak.flops:
            out["perf/mfu"] = flops / denom_s / peak.flops
        if peak is not None and peak.membw and byts > 0.0:
            out["perf/membw_util"] = byts / denom_s / peak.membw
        return out

