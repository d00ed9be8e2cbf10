"""Respawn backoff bookkeeping, a copy of ``surreal_tpu/utils/respawn.py``
(``RespawnSchedule``; jax-free). The SEED data plane
(``launch/seed_trainer.py::_DataPlane``) supervises its env workers with
it, and the inference fleet (``distributed/fleet.py``) its replicas:

- first death respawns immediately; consecutive deaths back off
  ``base * 2^k`` up to ``cap`` (a component that dies AT STARTUP must
  not respawn-loop hot);
- a respawn that survives ``healthy_s`` clears its slot's failure
  streak (the budget targets crash LOOPS, not one-off kills).

Callers keep their own spawn mechanics, counters, and locking; this
class owns only the per-slot failure/backoff/streak arithmetic, so a
future schedule change (jitter, a streak-rule fix) lands once.
"""

from __future__ import annotations

import time


class RespawnSchedule:
    def __init__(self, n_slots: int, base_s: float, cap_s: float,
                 healthy_s: float = 10.0):
        self.base_s = float(base_s)
        self.cap_s = float(cap_s)
        self.healthy_s = float(healthy_s)
        now = time.monotonic()
        self._failures = [0] * int(n_slots)
        self._next_spawn_at = [0.0] * int(n_slots)
        self._spawned_at = [now] * int(n_slots)

    def add_slot(self) -> int:
        """Register one more supervised slot (fleet scale-up)."""
        self._failures.append(0)
        self._next_spawn_at.append(0.0)
        self._spawned_at.append(time.monotonic())
        return len(self._failures) - 1

    def note_alive(self, i: int, now: float | None = None) -> None:
        """Tick a live slot: a respawn that outlived its probation window
        clears the failure streak."""
        now = time.monotonic() if now is None else now
        if self._failures[i] and now - self._spawned_at[i] > self.healthy_s:
            self._failures[i] = 0

    def due(self, i: int, now: float | None = None) -> bool:
        """True when a dead slot may respawn (its backoff has elapsed)."""
        now = time.monotonic() if now is None else now
        return now >= self._next_spawn_at[i]

    def respawned(self, i: int, now: float | None = None) -> float:
        """Record one respawn of slot ``i``; returns the backoff (s) now
        armed against its NEXT death (the supervisors' gauge value)."""
        now = time.monotonic() if now is None else now
        self._failures[i] += 1
        self._spawned_at[i] = now
        backoff = min(
            self.cap_s, self.base_s * (2.0 ** (self._failures[i] - 1))
        )
        self._next_spawn_at[i] = now + backoff
        return backoff
