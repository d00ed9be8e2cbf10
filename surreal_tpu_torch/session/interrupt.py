"""Preemption-safe shutdown sentinel, a copy of
``surreal_tpu/session/interrupt.py`` (``InterruptSentinel``).

The handler only latches a flag; the emergency checkpoint is written at
the next iteration boundary by the thread that owns the checkpoint
manager (``launch/hooks.py``), never from the handler. A second
SIGTERM/SIGINT raises ``KeyboardInterrupt`` so a wedged run can still be
killed. The handlers are installed only on the main thread (elsewhere the
sentinel is a disabled no-op, as under pytest-xdist workers' threads),
and ``close()`` restores the previous ones.
"""

from __future__ import annotations

import signal
import threading


class InterruptSentinel:
    """Latch SIGTERM/SIGINT into a flag polled at iteration boundaries."""

    SIGNALS = (signal.SIGTERM, signal.SIGINT)

    def __init__(self, enabled: bool = True):
        self._fired = threading.Event()
        self.signum: int | None = None
        self._count = 0
        self._prev: dict[int, object] = {}
        self.installed = False
        if not enabled:
            return
        if threading.current_thread() is not threading.main_thread():
            return  # signal.signal would raise; stay a disabled no-op
        try:
            for s in self.SIGNALS:
                self._prev[s] = signal.signal(s, self._handle)
            self.installed = True
        except (ValueError, OSError):  # exotic embedding; stay disabled
            self._prev.clear()

    def _handle(self, signum, frame):
        # async-signal context: latch and return — never touch locks,
        # logging, or the checkpoint manager from here (module docstring)
        self._count += 1
        self.signum = signum
        self._fired.set()
        if self._count >= 2:
            raise KeyboardInterrupt(
                f"second interrupt (signal {signum}): forcing teardown"
            )

    @property
    def fired(self) -> bool:
        return self._fired.is_set()

    def trigger(self, signum: int = signal.SIGTERM) -> None:
        """In-process latch (tests / the chaos harness's non-signal path)."""
        self.signum = signum
        self._fired.set()

    def close(self) -> None:
        """Restore the previous handlers (idempotent)."""
        if not self.installed:
            return
        for s, prev in self._prev.items():
            try:
                signal.signal(s, prev)
            except (ValueError, OSError):  # off-main-thread close; leave as-is
                pass
        self._prev.clear()
        self.installed = False
