"""Replay-kind dispatch, the port of ``surreal_tpu/replay/sharded.py::build_replay``.

The dp-sharded placement (``shard_replay_state``, ``scale_replay_config``)
waits for the port's dp mesh.
"""

from __future__ import annotations


def build_replay(replay_config):
    """Dispatch on ``replay.kind``: 'fifo', 'uniform' and 'prioritized'
    build their replay; 'remote' raises as in the reference (the sharded
    experience plane, ``experience/``, has no in-process replay object)."""
    kind = replay_config.kind
    if kind == "uniform":
        from surreal_tpu_torch.replay.uniform import UniformReplay

        return UniformReplay(replay_config)
    if kind == "prioritized":
        from surreal_tpu_torch.replay.prioritized import PrioritizedReplay

        return PrioritizedReplay(replay_config)
    if kind == "fifo":
        from surreal_tpu_torch.replay.fifo import FIFOReplay

        return FIFOReplay(replay_config)
    if kind == "remote":
        raise ValueError(
            "replay.kind='remote' is the sharded experience plane; the trainer "
            "builds it directly (the host off-policy path), so there is no "
            "in-process replay object to construct"
        )
    raise ValueError(f"unknown replay kind {kind!r}; have fifo | uniform | prioritized | remote")
