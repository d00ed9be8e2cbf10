"""On-demand profiling on ``torch.profiler``, the port of
``surreal_tpu/session/profile.py``: capture windows started and stopped at
iteration boundaries.

Three triggers, one manager (owned by ``SessionHooks``, ticked once per
``end_iteration``), with the reference's rules:

- **legacy window** — the ``session.profiler`` knob (enabled, start_iter,
  num_iters); its capture lands under ``telemetry/profiles/`` with the
  on-demand ones.
- **trigger file** — ``python -m surreal_tpu_torch profile <folder>``
  writes ``<folder>/profile.trigger``; the running session polls for it
  (a stat at most once a second) and captures a
  ``session.profile.num_iters`` window from the next iteration boundary,
  then removes the file. The file's JSON body may override ``num_iters``.
- **slow-iteration auto-trigger** — with ``session.profile.
  slow_iter_factor`` set, an iteration whose host wall time exceeds
  factor x the iteration-time EWMA starts a capture (at most
  ``max_auto_captures`` a run). Pure host clock deltas between ticks: no
  device read.

A capture records the CPU, and CUDA too when the session's device is a
CUDA card, and writes one Chrome trace,
``<folder>/telemetry/profiles/iterNNNNNNNN/`` + :data:`TRACE_FILE`
(``NNNNNNNN`` the iteration it started at). Each is announced by a
``profile`` telemetry event (``dir``, ``reason``, ``start_iter``,
``end_iter``) that ``diag`` lists. A failure to start or to stop is
logged and written as a ``profile`` event with ``error``; training goes
on. Stopping a CUDA capture waits for the card (the profiler flushes its
records), at the capture's last boundary only.
"""

from __future__ import annotations

import json
import os
import time

import torch

from surreal_tpu_torch.session.telemetry import PROFILES_DIR, TELEMETRY_DIR

TRIGGER_FILE = "profile.trigger"
TRACE_FILE = "trace.json"  # the Chrome trace in each capture directory

# EWMA shape for the slow-iteration detector: the first _WARM_TICKS ticks
# only seed the average (first calls and warm-up dominate there), later
# ticks blend at _ALPHA. A capture in progress suspends detection.
_WARM_TICKS = 10
_ALPHA = 0.1


def write_trigger(folder: str, num_iters: int | None = None) -> str:
    """Drop the trigger file a live session polls for (the CLI side of
    ``profile <folder>``). Atomic tmp + rename: the session may race the
    write."""
    path = os.path.join(folder, TRIGGER_FILE)
    body = {} if num_iters is None else {"num_iters": int(num_iters)}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(body, f)
    os.replace(tmp, path)
    return path


class ProfileManager:
    """Iteration-boundary profiler control. ``tick(iteration)`` is cheap
    in the steady state: one monotonic read, one EWMA update, and (at
    most once a second) one ``os.path.exists``."""

    def __init__(self, session_cfg, folder: str, tracer, log, device=None):
        self._folder = folder
        self._tracer = tracer
        self._log = log
        self._cuda = device is not None and torch.device(device).type == "cuda"
        prof = session_cfg.get("profile", None)
        self._trigger_enabled = bool(prof.get("trigger_file", True)) if prof is not None else True
        self._num_iters = int(prof.get("num_iters", 5)) if prof is not None else 5
        factor = prof.get("slow_iter_factor", None) if prof is not None else None
        self._slow_factor = float(factor) if factor else None
        self._max_auto = int(prof.get("max_auto_captures", 2)) if prof is not None else 2
        self._auto_fired = 0
        # the legacy fixed window (session.profiler), folded into the same
        # capture machinery so both share start/stop and telemetry
        legacy = session_cfg.get("profiler", None)
        self._legacy_start = None
        self._legacy_iters = 5
        if legacy is not None and legacy.get("enabled", False):
            self._legacy_start = int(legacy.get("start_iter", 20))
            self._legacy_iters = int(legacy.get("num_iters", 5))
        self._trigger_path = os.path.join(folder, TRIGGER_FILE)
        self._last_stat = 0.0
        self._pending: tuple[str, int] | None = None  # (reason, num_iters)
        self._active: dict | None = None
        self.last_capture_dir: str | None = None  # the newest completed capture
        self._last_tick: float | None = None
        self._last_iter = 0  # the newest iteration ticked (close() reports it)
        self._ewma_s: float | None = None
        self._ticks = 0

    # -- capture lifecycle ---------------------------------------------------
    def _start(self, iteration: int, reason: str, num_iters: int) -> None:
        tag = f"iter{iteration:08d}"
        trace_dir = os.path.join(self._folder, TELEMETRY_DIR, PROFILES_DIR, tag)
        try:
            os.makedirs(trace_dir, exist_ok=True)
            activities = [torch.profiler.ProfilerActivity.CPU]
            if self._cuda:
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            prof = torch.profiler.profile(activities=activities)
            prof.start()
        except Exception as e:
            # profiling never kills training (an unwritable folder, a
            # profiler the build lacks); the failure is recorded instead
            self._log.warning("profiler start failed (%s): %s", reason, e)
            self._tracer.event("profile", dir=trace_dir, reason=reason, error=str(e))
            return
        self._active = {
            "dir": trace_dir,
            "reason": reason,
            "start_iter": int(iteration),
            "stop_at": int(iteration) + max(1, num_iters),
            "prof": prof,
        }
        self._log.info("profiler capture started (%s) -> %s", reason, trace_dir)

    def _stop(self, iteration: int) -> None:
        act = self._active
        self._active = None
        if act is None:
            return
        self.last_capture_dir = act["dir"]
        fields = {"dir": act["dir"], "reason": act["reason"], "start_iter": act["start_iter"],
                  "end_iter": int(iteration)}
        try:
            act["prof"].stop()
            act["prof"].export_chrome_trace(os.path.join(act["dir"], TRACE_FILE))
        except Exception as e:
            self._log.warning("profiler stop failed: %s", e)
            self._tracer.event("profile", **fields, error=str(e))
            return
        self._tracer.event("profile", **fields)
        self._log.info("profiler capture saved -> %s", act["dir"])

    def request(self, reason: str, num_iters: int | None = None) -> bool:
        """Queue a capture window starting at the next boundary tick (the
        programmatic spelling of the trigger file). Refused (False) while
        a capture is active or already queued."""
        if self._active is not None or self._pending is not None:
            return False
        self._pending = (str(reason), max(1, int(num_iters or self._num_iters)))
        return True

    # -- per-iteration tick --------------------------------------------------
    def tick(self, iteration: int) -> None:
        now = time.monotonic()
        self._last_iter = int(iteration)
        # slow-iteration detector: host wall time between boundary ticks
        if self._last_tick is not None:
            dt = now - self._last_tick
            self._ticks += 1
            if self._ewma_s is None:
                self._ewma_s = dt
            elif self._ticks <= _WARM_TICKS:
                self._ewma_s += (dt - self._ewma_s) / self._ticks
            else:
                if (
                    self._slow_factor is not None
                    and self._active is None
                    and self._pending is None
                    and self._auto_fired < self._max_auto
                    and dt > self._slow_factor * self._ewma_s
                ):
                    self._auto_fired += 1
                    self._log.warning(
                        "slow iteration %d: %.3fs vs %.3fs EWMA (>%.1fx) — auto-capturing a profile window",
                        iteration, dt, self._ewma_s, self._slow_factor,
                    )
                    self._pending = (f"slow_iter({dt:.3f}s/{self._ewma_s:.3f}s)", self._num_iters)
                self._ewma_s += _ALPHA * (dt - self._ewma_s)
        self._last_tick = now

        if self._active is not None:
            if iteration >= self._active["stop_at"]:
                self._stop(iteration)
            return

        # the legacy fixed window
        if self._legacy_start is not None and iteration >= self._legacy_start:
            self._legacy_start = None  # one window a run
            self._start(iteration, "profiler_knob", self._legacy_iters)
            return

        if self._pending is not None:
            reason, n = self._pending
            self._pending = None
            self._start(iteration, reason, n)
            return

        # the trigger file, a stat at most once a second
        if self._trigger_enabled and now - self._last_stat >= 1.0:
            self._last_stat = now
            if os.path.exists(self._trigger_path):
                n = self._num_iters
                try:
                    with open(self._trigger_path) as f:
                        body = json.load(f)
                    n = int(body.get("num_iters", n))
                except (OSError, json.JSONDecodeError, ValueError, TypeError, AttributeError):
                    pass
                try:
                    os.unlink(self._trigger_path)
                except OSError:
                    pass
                self._start(iteration, "trigger_file", n)

    def close(self) -> None:
        # a capture cut short by the run's end reports the iteration it
        # reached, not the stop_at it never got to
        if self._active is not None:
            self._stop(self._last_iter)
