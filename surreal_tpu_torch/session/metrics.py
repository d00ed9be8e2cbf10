"""Metrics writer and session logger, the port of
``surreal_tpu/session/metrics.py`` (``MetricsWriter``,
``make_metrics_writer``, ``get_logger``).

``MetricsWriter.write(step, metrics)`` sends each float to TensorBoard
event files under ``<folder>/tb/<name>/`` and, when asked, to the console;
NaN values are dropped key by key (a window with no finished episode has
a NaN ``episode/return``). Without the ``tensorboard`` package the
TensorBoard side is off and one warning says so; training goes on.
``get_logger`` writes console lines and ``<folder>/logs/<name>.log``.
"""

from __future__ import annotations

import logging
import os
import sys
import time
from typing import Mapping

LOGGER_ROOT = "surreal_tpu_torch"


def _event_file_writer(tb_dir: str):
    """A TensorBoard ``EventFileWriter`` and the proto classes, or the
    ImportError that says why there is none. Imported here, not at module
    import, so that importing the port never needs ``tensorboard``."""
    try:
        from tensorboard.compat.proto.event_pb2 import Event
        from tensorboard.compat.proto.summary_pb2 import Summary
        from tensorboard.summary.writer.event_file_writer import EventFileWriter
    except ImportError as e:
        return None, e
    os.makedirs(tb_dir, exist_ok=True)
    return (EventFileWriter(tb_dir), Event, Summary), None


class MetricsWriter:
    """Scalar metrics sink for one session; tags keep their namespaced
    form (``loss/total``, ``episode/return``, ``eval/return``)."""

    def __init__(self, folder: str, tensorboard: bool = True, console: bool = True, name: str = "train"):
        self.folder = folder
        self.console = console
        self._tb = None
        if tensorboard:
            tb, err = _event_file_writer(os.path.join(folder, "tb", name))
            if err is not None:
                logging.getLogger(LOGGER_ROOT).warning(
                    "metrics.tensorboard=True but tensorboard is not importable (%s); scalar events disabled",
                    err,
                )
            else:
                self._tb, self._Event, self._Summary = tb

    def write(self, step: int, metrics: Mapping[str, float]) -> None:
        clean = {k: float(v) for k, v in metrics.items() if float(v) == float(v)}  # drop NaN
        if self._tb is not None:
            event = self._Event(
                step=int(step),
                summary=self._Summary(value=[self._Summary.Value(tag=k, simple_value=v) for k, v in clean.items()]),
            )
            event.wall_time = time.time()
            self._tb.add_event(event)
        if self.console:
            parts = " ".join(f"{k}={v:.4g}" for k, v in sorted(clean.items()))
            print(f"[{step}] {parts}", flush=True)

    def close(self) -> None:
        if self._tb is not None:
            self._tb.flush()
            self._tb.close()
            self._tb = None


def make_metrics_writer(session_config, name: str = "train") -> MetricsWriter:
    """Build a writer from a ``session_config`` tree."""
    m = session_config.metrics
    return MetricsWriter(session_config.folder, tensorboard=m.tensorboard, console=m.console, name=name)


class _StderrHandler(logging.StreamHandler):
    """Console handler that writes to whatever ``sys.stderr`` is at the
    time of the record (a harness may swap it between sessions)."""

    @property
    def stream(self):
        return sys.stderr

    @stream.setter
    def stream(self, value):
        pass


def get_logger(name: str, folder: str | None = None) -> logging.Logger:
    """Console + ``<folder>/logs/<name>.log``. Idempotent per (name,
    folder); a call with another folder retargets the file handler
    (closing the old one), so sequential sessions never cross-write."""
    logger = logging.getLogger(f"{LOGGER_ROOT}.{name}")
    logger.setLevel(logging.INFO)
    logger.propagate = False
    fmt = logging.Formatter("%(asctime)s %(name)s %(levelname)s %(message)s", "%H:%M:%S")
    have = {getattr(h, "_surreal_id", None) for h in logger.handlers}
    if "console" not in have:
        h = _StderrHandler()
        h.setFormatter(fmt)
        h._surreal_id = "console"
        logger.addHandler(h)
    if folder is not None:
        log_dir = os.path.join(folder, "logs")
        file_id = f"file:{log_dir}"
        if file_id not in have:
            for stale in [h for h in logger.handlers if str(getattr(h, "_surreal_id", "")).startswith("file:")]:
                logger.removeHandler(stale)
                stale.close()
            os.makedirs(log_dir, exist_ok=True)
            h = logging.FileHandler(os.path.join(log_dir, f"{name}.log"))
            h.setFormatter(fmt)
            h._surreal_id = file_id
            logger.addHandler(h)
    return logger
