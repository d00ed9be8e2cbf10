"""Workload fingerprint: the cache key of a tuning decision, the port of
``surreal_tpu/tune/fingerprint.py``.

A tuned program is only valid for the program it was measured on, so the
fingerprint covers everything that changes the iteration: algorithm and
hyperparameters, model architecture, batch geometry (env name, num_envs,
horizon live in the algo/env trees), replay shape, the backend platform
and device kind, and the framework version. It EXCLUDES the searched
knobs themselves: applying a cached winner must not change the key it
was stored under, or a second lookup would miss its own result.

The tree parts are the reference's, canonicalised the same way. The port
fills the three device fields itself: ``backend`` from the device type
(``"gpu"`` for CUDA, ``"cpu"``), ``device_kind`` from
``torch.cuda.get_device_name`` (``"cpu"`` on the CPU) and ``torch``'s
version where the reference records ``jax``'s, so an entry the JAX
package wrote never hits in the port.
"""

from __future__ import annotations

import hashlib
import json

# the searched dimensions of either package (tune/space.py declares the
# port's candidate values); excluded from the fingerprint along with the
# autotune mode knob itself
TUNABLE_KEYS = (
    "rollout_unroll",
    "sgd_unroll",
    "update_unroll",
    "gae_unroll",
    "gae_impl",
    "shuffle",
    "precision",      # the precision policy (ops/precision.py)
    "vtrace_impl",    # IMPALA's V-trace recurrence
    "replay_gather",  # DDPG's batched replay gather
)
_EXCLUDED = TUNABLE_KEYS + ("autotune",)


def fingerprint_dict(
    extended_learner_config,
    env_config,
    platform: str | None = None,
    device_kind: str | None = None,
    torch_version: str | None = None,
    device=None,
) -> dict:
    """The human-readable fingerprint components (stored in each cache
    entry so `cat <entry>.json` answers "tuned for WHAT?"). The device
    fields not given are read from ``device`` (default: the card)."""
    if platform is None or device_kind is None or torch_version is None:
        import torch

        from surreal_tpu_torch.session.costs import device_kind as kind_of
        from surreal_tpu_torch.session.watchdog import platform_of

        dev = torch.device("cuda" if device is None else device)
        platform = platform or platform_of(dev)
        device_kind = device_kind or kind_of(dev)
        torch_version = torch_version or torch.__version__
    algo = {
        k: v
        for k, v in extended_learner_config.algo.to_dict().items()
        if k not in _EXCLUDED
    }
    model = (
        extended_learner_config.model.to_dict()
        if "model" in extended_learner_config
        else {}
    )
    # 'auto' dtypes resolve FROM the searched precision knob
    # (ops/precision.py): hashing them as the policy's concrete values
    # would leak the excluded knob back into the key. Both canonicalise to
    # the pre-policy defaults, as in the reference; an EXPLICIT dtype
    # string changes the program independently of the search and hashes
    # as itself.
    if model.get("dtype") in (None, "auto"):
        model["dtype"] = "float32"
    if model.get("compute_dtype") in (None, "auto"):
        model["compute_dtype"] = "bfloat16"
    optimizer = (
        extended_learner_config.optimizer.to_dict()
        if "optimizer" in extended_learner_config
        else {}
    )
    # the loss_scaling subtree follows algo.precision, the excluded knob
    optimizer.pop("loss_scaling", None)
    return {
        "algo": algo,
        "model": model,
        "replay": extended_learner_config.replay.to_dict()
        if "replay" in extended_learner_config
        else {},
        "optimizer": optimizer,
        "env": {
            "name": env_config.name,
            "num_envs": int(env_config.get("num_envs", 1)),
            "action_repeat": env_config.get("action_repeat", 1),
            "frame_stack": env_config.get("frame_stack", 1),
            "image_size": env_config.get("image_size", None),
        },
        "backend": platform,
        "device_kind": device_kind,
        "torch": torch_version,
    }


def fingerprint_key(fp: dict) -> str:
    """Stable 16-hex key of a fingerprint dict (sorted-key JSON; tuples
    serialize as lists, so config-tree tuple/list spelling cannot fork
    the key)."""
    blob = json.dumps(fp, sort_keys=True, default=str)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def workload_fingerprint(extended_learner_config, env_config, **kw) -> tuple[str, dict]:
    """-> (key, fingerprint-dict). The one entry point callers use."""
    fp = fingerprint_dict(extended_learner_config, env_config, **kw)
    return fingerprint_key(fp), fp
