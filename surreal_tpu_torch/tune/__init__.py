"""Program autotuner with a persistent per-workload tuning cache, the port
of ``surreal_tpu/tune/``.

Three layers, as in the reference:

- :mod:`fingerprint`: a workload fingerprint (algo + model + geometry +
  backend + device kind + torch version, MINUS the searched knobs
  themselves) keys every cache entry, so a tuned config can never leak
  onto a workload it was not measured on.
- :mod:`cache`: a JSON tuning cache (``session.tuning_cache_dir``;
  relative paths resolve under the session folder, absolute paths share
  one cache across sessions). Atomic writes; corrupt/missing entries read
  as misses.
- :mod:`search` (+ :mod:`space`): greedy coordinate descent over the
  declared candidate space (``precision``, PPO's ``gae_impl`` and
  ``shuffle``, IMPALA's ``vtrace_impl``: the knobs that change the port's
  program, see :mod:`space`), each candidate timed as a chained window of
  the REAL trainer program on the card.

Trainers consult the cache at build time via ``algo.autotune``:

- ``'off'``   (default): hand-set knobs, no cache traffic;
- ``'cache'``: apply a cached winner when the fingerprint hits, keep the
  static defaults on a miss (never pays search cost);
- ``'search'``: on a miss, run the search at build time and persist the
  winner. Device (``jax:*``) envs search the full space against the
  device iteration; host envs (gym/dm_control/SEED) search the
  learn-phase subset against the learn program alone
  (search.LEARN_PHASE_DIMS); workloads with nothing searchable keep
  defaults.

The decision lands in telemetry as a ``tune`` event (hit/miss, chosen
config), rendered by ``diag``; ``python -m surreal_tpu_torch tune <algo>
<env>`` runs the search standalone and can write a shared artifact.
"""

from __future__ import annotations

from typing import NamedTuple

from surreal_tpu_torch.tune.cache import TuningCache, resolve_tuning_cache_dir
from surreal_tpu_torch.tune.fingerprint import TUNABLE_KEYS, workload_fingerprint

AUTOTUNE_MODES = ("off", "cache", "search")


class TuneDecision(NamedTuple):
    """What the autotuner decided at trainer build time."""

    mode: str             # 'off' | 'cache' | 'search'
    key: str | None       # workload fingerprint key (None when off)
    hit: bool | None      # cache hit (None when off)
    applied: dict         # tuned knobs merged into the learner config
    source: str           # 'default' | 'cache' | 'search'
    cache_dir: str | None
    note: str = ""        # e.g. nothing searchable for a host-env DDPG

    def telemetry(self) -> dict:
        """The ``tune`` event payload (hooks.tune_event / diag)."""
        out = {
            "mode": self.mode,
            "key": self.key,
            "hit": bool(self.hit),
            "source": self.source,
            "cache_dir": self.cache_dir,
            "config": dict(self.applied),
        }
        if self.note:
            out["note"] = self.note
        return out

    def artifact(self) -> dict:
        """Compact record for artifacts, so a perf row can never silently
        mix tuned and untuned arms."""
        return {
            "mode": self.mode,
            "hit": self.hit,
            "source": self.source,
            "config": dict(self.applied),
            "key": self.key,
        }


_OFF = TuneDecision(
    mode="off", key=None, hit=None, applied={}, source="default",
    cache_dir=None,
)


def _apply_tuned(config, tuned: dict) -> None:
    """Merge tuned knobs into the RAW learner override tree (the one
    ``build_learner`` extends), so a rebuild picks them up. Tuned values
    deliberately override hand-set ones: ``autotune != 'off'`` hands the
    searched keys to the tuner; pin them manually with ``autotune='off'``.
    """
    from surreal_tpu_torch.session.config import Config

    algo = config.learner_config.get("algo", None)
    if algo is None:
        config.learner_config.algo = Config()
        algo = config.learner_config.algo
    for k, v in tuned.items():
        algo[k] = v


def _multi_process() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def resolve_autotune(config, extended_learner_config, device="cuda") -> TuneDecision:
    """Consult (or populate) the tuning cache for this workload on
    ``device``; called by every trainer constructor right after it builds
    its learner.

    ``extended_learner_config`` is the fully-extended learner tree (the
    built learner's ``.config``): the raw user tree lacks the defaults the
    fingerprint needs. On a decision with ``applied`` non-empty the caller
    rebuilds its learner from ``config.learner_config``, which this
    function has updated in place.
    """
    algo = extended_learner_config.algo
    mode = algo.get("autotune", "off") or "off"
    if mode not in AUTOTUNE_MODES:
        raise ValueError(
            f"algo.autotune {mode!r} not in {'|'.join(AUTOTUNE_MODES)}"
        )
    if mode == "off":
        return _OFF

    key, _fp = workload_fingerprint(extended_learner_config, config.env_config, device=device)
    cache_dir = resolve_tuning_cache_dir(config.session_config)
    cache = TuningCache(cache_dir)
    entry = cache.lookup(key)
    if entry is not None:
        tuned = dict(entry.get("config", {}))
        _apply_tuned(config, tuned)
        return TuneDecision(mode, key, True, tuned, "cache", cache_dir)
    if mode == "cache":
        return TuneDecision(mode, key, False, {}, "default", cache_dir)

    # mode == 'search': run the measurement at build time and persist.
    from surreal_tpu_torch.tune.search import search_space_for, tune_workload

    if not search_space_for(config, extended_learner_config):
        # host-env DDPG: its update loop learns on replay batches the
        # synthetic learn batch cannot fabricate
        return TuneDecision(
            mode, key, False, {}, "default", cache_dir,
            note="no searchable dimensions for this workload; "
                 "static defaults kept",
        )
    if _multi_process():
        # ranks would each measure with independent timing noise and pick
        # DIVERGENT programs; the cache path is deterministic across ranks
        # (one shared file), so require it
        raise ValueError(
            "algo.autotune='search' is single-process only (per-rank "
            "timing noise would pick divergent programs): run "
            "`surreal_tpu_torch tune` once against the shared tuning cache, "
            "then train with algo.autotune='cache'"
        )
    result = tune_workload(config, device=device)
    tuned = dict(result.get("config", {}))
    _apply_tuned(config, tuned)
    return TuneDecision(mode, key, False, tuned, "search", cache_dir)


__all__ = [
    "AUTOTUNE_MODES",
    "TUNABLE_KEYS",
    "TuneDecision",
    "TuningCache",
    "resolve_autotune",
    "resolve_tuning_cache_dir",
    "workload_fingerprint",
]
