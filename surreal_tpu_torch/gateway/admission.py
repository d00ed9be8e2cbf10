"""Admission control for the session gateway, the port of
``surreal_tpu/gateway/admission.py``: per-tenant token-bucket rate limits,
session quotas and bounded backpressure queues.

- **Counted, never silent**: a rejected attach, a throttled act and a
  backpressure eviction each bump a counter AND get a reply frame.
- **Bounded queues, oldest evicted**: a burst beyond the tenant's rate
  waits in a bounded per-tenant queue drained as tokens refill; overflow
  evicts the OLDEST queued request (its requester gets an ACT_ERR).
- **Leases**: any frame renews a session's lease; the server reaps every
  session idle past it, so tenants that vanish without detaching cannot
  hold quota.

Bookkeeping only (no sockets, no threads), so quota policy is tested
without a wire. Every clock read takes an explicit ``now=`` (a
``time.monotonic`` reading) for deterministic tests; None reads the
clock.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Any


class TokenBucket:
    """Classic token bucket: ``rate`` tokens/s refill up to ``burst``.
    ``rate <= 0`` disables limiting (always allows)."""

    def __init__(self, rate: float, burst: float, now: float | None = None):
        self.rate = float(rate)
        self.burst = max(1.0, float(burst))
        self.tokens = self.burst
        self._t = time.monotonic() if now is None else now

    def try_take(self, now: float | None = None) -> bool:
        if self.rate <= 0:
            return True
        now = time.monotonic() if now is None else now
        self.tokens = min(
            self.burst, self.tokens + (now - self._t) * self.rate
        )
        self._t = now
        if self.tokens >= 1.0:
            self.tokens -= 1.0
            return True
        return False


class _Tenant:
    """Per-tenant admission state: bucket + bounded backpressure queue."""

    __slots__ = ("bucket", "queue", "max_sessions", "queue_depth",
                 "throttled", "evicted", "rejected")

    def __init__(self, quota: dict, now: float | None = None):
        self.bucket = TokenBucket(
            float(quota.get("rate", 0.0)), float(quota.get("burst", 1.0)), now
        )
        self.max_sessions = int(quota.get("max_sessions", 0))
        self.queue_depth = max(1, int(quota.get("queue_depth", 64)))
        self.queue: deque = deque()
        self.throttled = 0
        self.evicted = 0
        self.rejected = 0


class AdmissionController:
    """Quota book for every tenant the gateway has seen.

    ``quotas`` maps tenant name -> quota dict ``{max_sessions, rate,
    burst, queue_depth}``; the ``default`` entry applies to tenants not
    named (0 / absent knobs mean unlimited). ``max_sessions_total`` caps
    the gateway globally regardless of per-tenant generosity."""

    def __init__(self, quotas: dict[str, dict] | None = None,
                 max_sessions_total: int = 0):
        quotas = dict(quotas or {})
        self._default = dict(quotas.pop("default", {}))
        self._quotas = quotas
        self.max_sessions_total = int(max_sessions_total)
        self._tenants: dict[str, _Tenant] = {}
        self.rejected_sessions = 0
        self.throttled_acts = 0
        self.evicted_requests = 0
        self.expired_leases = 0
        self.quota_changes = 0

    def tenant(self, name: str, now: float | None = None) -> _Tenant:
        t = self._tenants.get(name)
        if t is None:
            t = self._tenants[name] = _Tenant(
                self._quotas.get(name, self._default), now
            )
        return t

    def tenants(self) -> dict[str, _Tenant]:
        return self._tenants

    # -- runtime quota mutation ----------------------------------------------
    def quota_of(self, name: str) -> dict:
        """The quota dict currently governing ``name`` (named entry or
        the default) — what ``set_quota`` must be handed to restore it."""
        return dict(self._quotas.get(name, self._default))

    def set_quota(self, name: str, quota: dict, now: float | None = None) -> dict:
        """Replace tenant ``name``'s quota at runtime — the throttle/shed
        actuator, and the operator path that makes a quota change a
        config action instead of a gateway restart. Counted (``quota_changes``); returns the PREVIOUS
        quota dict so the caller can revert.

        The live ``_Tenant`` keeps its queue and counters (history is
        evidence); only the bucket and limits are rebuilt, so a reduced
        rate takes effect on the very next act."""
        prev = self.quota_of(name)
        quota = dict(quota)
        self._quotas[name] = quota
        t = self._tenants.get(name)
        if t is not None:
            t.bucket = TokenBucket(
                float(quota.get("rate", 0.0)), float(quota.get("burst", 1.0)), now
            )
            t.max_sessions = int(quota.get("max_sessions", 0))
            t.queue_depth = max(1, int(quota.get("queue_depth", 64)))
        self.quota_changes += 1
        return prev

    # -- session admission ---------------------------------------------------
    def admit_session(self, name: str, tenant_sessions: int,
                      total_sessions: int) -> str | None:
        """None = admitted; else the counted rejection reason."""
        if (
            self.max_sessions_total
            and total_sessions >= self.max_sessions_total
        ):
            self.rejected_sessions += 1
            self.tenant(name).rejected += 1
            return (
                f"gateway at capacity ({total_sessions}/"
                f"{self.max_sessions_total} sessions)"
            )
        t = self.tenant(name)
        if t.max_sessions and tenant_sessions >= t.max_sessions:
            self.rejected_sessions += 1
            t.rejected += 1
            return (
                f"tenant {name!r} at session quota "
                f"({tenant_sessions}/{t.max_sessions})"
            )
        return None

    def note_rejected(self, name: str) -> None:
        """Count an attach denial decided OUTSIDE the quota arithmetic
        (e.g. the server's resume-credential check) — same counters as a
        quota rejection, so no denial is silent."""
        self.rejected_sessions += 1
        self.tenant(name).rejected += 1

    # -- act rate limiting + backpressure ------------------------------------
    def try_act(self, name: str, now: float | None = None) -> bool:
        """One token for one act; False = throttle (enqueue the request)."""
        if self.tenant(name, now).bucket.try_take(now):
            return True
        self.throttled_acts += 1
        self.tenant(name).throttled += 1
        return False

    def enqueue(self, name: str, item: Any) -> Any | None:
        """Park a throttled request; returns the EVICTED oldest request
        when the bounded queue overflowed (the caller must answer it —
        counted, never silent), else None."""
        t = self.tenant(name)
        evicted = None
        if len(t.queue) >= t.queue_depth:
            evicted = t.queue.popleft()
            self.evicted_requests += 1
            t.evicted += 1
        t.queue.append(item)
        return evicted

    def drain(self, name: str, now: float | None = None) -> list:
        """Dequeue every parked request the refilled bucket now covers
        (oldest first — FIFO fairness within a tenant)."""
        t = self.tenant(name, now)
        out = []
        while t.queue and t.bucket.try_take(now):
            out.append(t.queue.popleft())
        return out

    def queued(self) -> int:
        return sum(len(t.queue) for t in self._tenants.values())

    def note_expired(self, n: int = 1) -> None:
        self.expired_leases += int(n)

    def gauges(self) -> dict[str, float]:
        return {
            "gateway/rejected_sessions": float(self.rejected_sessions),
            "gateway/throttled_acts": float(self.throttled_acts),
            "gateway/evicted_requests": float(self.evicted_requests),
            "gateway/expired_leases": float(self.expired_leases),
            "gateway/queued_acts": float(self.queued()),
            "gateway/quota_changes": float(self.quota_changes),
        }
