"""Persistent JSON tuning cache, the port of ``surreal_tpu/tune/cache.py``
with the reference's layout.

One file per workload fingerprint (``tune_<key>.json``), holding the
chosen config plus the full measurement record (default/chosen timings,
every trial, platform, framework version) so artifacts and ``diag`` can
answer "why this config?" without re-measuring. Writes are atomic (tmp +
rename): trainers in other processes may read these files and must never
observe a torn entry. Corrupt or missing entries read as misses: a
damaged cache re-measures instead of crashing the trainer.
"""

from __future__ import annotations

import json
import os


def resolve_tuning_cache_dir(session_cfg) -> str:
    """``session.tuning_cache_dir``: relative paths live under the session
    folder (a session-local cache), absolute paths share one cache across
    sessions. Unset defaults to ``<folder>/tuning_cache`` so
    ``algo.autotune`` works with zero extra config."""
    cache_dir = session_cfg.get("tuning_cache_dir", None) or "tuning_cache"
    if not os.path.isabs(cache_dir):
        cache_dir = os.path.join(session_cfg.folder, cache_dir)
    return cache_dir


class TuningCache:
    def __init__(self, cache_dir: str):
        self.dir = cache_dir

    def path(self, key: str) -> str:
        return os.path.join(self.dir, f"tune_{key}.json")

    def lookup(self, key: str) -> dict | None:
        """The stored entry for ``key``, or None (missing/corrupt read as
        a miss so a damaged file re-measures rather than crashes)."""
        try:
            with open(self.path(key)) as f:
                entry = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None
        if not isinstance(entry, dict) or "config" not in entry:
            return None
        return entry

    def store(self, key: str, entry: dict) -> str:
        """Atomically persist ``entry`` under ``key``; returns the path."""
        os.makedirs(self.dir, exist_ok=True)
        path = self.path(key)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(entry, f, indent=2, default=str)
        os.replace(tmp, path)
        return path
