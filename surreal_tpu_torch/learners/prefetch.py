"""Double-buffered host→device staging, a copy of
``surreal_tpu/learners/prefetch.py`` (the dispatch-pipeline seam: the
reference's learner never waited on actors — a prefetch thread kept
batches queued, SURVEY.md §3.4; batched-RL systems pipeline simulation/
staging against learner compute as their core throughput lever,
PAPERS.md: TensorFlow Agents arXiv:1709.02878, Accelerated Methods
arXiv:1803.02811).

:class:`Prefetcher` runs a caller-supplied ``produce`` callable on a
staging thread and hands its results out in order. ``produce`` does
whatever "get the next batch onto the device" means for the caller —
step a host env for one horizon chunk and ship it to the card as one
copy per leaf (offpolicy_trainer's host loop). While the
device crunches batch k, the staging thread overlaps the wait + H2D
transfer (and, for host envs, the simulation itself) of batch k+1, so
iteration wall-clock approaches max(stage, learn) instead of their sum.

Fence discipline: staging is pure host→device traffic (non-blocking
copies, numpy stacking); it adds no device→host read of its own (a
host env's rollout reads one action back per env step, inside ``produce``).

Threading contract: ``produce`` runs ONLY on the staging thread after
construction; closures over mutable rollout state (env obs, noise, key
chains) are safe as long as no other thread touches that state.
Exceptions from ``produce`` are re-raised from :meth:`get` (the same
surface-the-crash contract as launch/trainer.py's overlap collector),
after which the prefetcher is dead. The buffer is bounded, so a slow
consumer backpressures the producer instead of queueing unboundedly
stale batches — at most ``depth`` staged items plus ONE mid-produce are
in flight (depth+1 total; at the default depth=1, consumers acting from
a shared state holder run at most two updates stale).
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Callable


class Prefetcher:
    """Bounded background producer: ``get()`` returns ``produce()``
    results in order, overlapping the next call with the consumer."""

    def __init__(
        self,
        produce: Callable[[], Any],
        depth: int = 1,
        name: str = "prefetch",
    ):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._produce = produce
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True, name=name)
        self._thread.start()

    def _loop(self) -> None:
        while not self._stop.is_set():
            try:
                item = (None, self._produce())
            except BaseException as e:  # surfaced from get(); thread exits
                item = (e, None)
            while not self._stop.is_set():
                try:
                    self._q.put(item, timeout=0.2)
                    break
                except queue.Full:
                    continue
            if item[0] is not None:
                return

    def get(self, timeout: float | None = None) -> Any:
        """Next staged item (blocks until one is ready, or raises
        ``queue.Empty`` after ``timeout`` seconds). Re-raises the
        producer's exception if it died — the prefetcher is unusable
        after that (close() and handle the error)."""
        exc, val = self._q.get(timeout=timeout)
        if exc is not None:
            raise exc
        return val

    def close(self) -> None:
        """Stop the staging thread. In-flight staged items are discarded
        (their env steps were never counted — the same stop-boundary
        budget discipline as the overlap collector's discarded rollout).
        The thread is a daemon: a ``produce`` blocked in a long wait
        cannot hold process exit hostage."""
        self._stop.set()
        self._thread.join(timeout=5)
