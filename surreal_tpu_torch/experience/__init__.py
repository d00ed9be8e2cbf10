"""The sharded experience plane, the port of ``surreal_tpu/experience/``:
the ExperienceSender -> replay shard server -> ShardedSampler path, so
actor fleets on other hosts can feed one learner.

Modules:

- ``wire``    the experience wire codec: transport-negotiated framing
              (shm slabs same-host, a length-framed tcp codec cross-host,
              pickle as the per-peer fallback) and the hello handshake
              carrying the run trace id;
- ``link``    the shard link and its hello negotiation, shared by the
              sender and the sampler, on ``distributed/sockets.py``'s
              reconnecting DEALER;
- ``shard``   ``run_shard_server``: one replay shard thread or process
              owning a host-memory ring (uniform or prioritized) or the
              SEED FIFO chunk relay;
- ``sender``  ``ExperienceSender``: actor-side hash routing of env slots
              to shards with backpressure and bounded retry;
- ``sampler`` ``ShardedSampler``: the learner-side fan-in, prefetched
              through ``learners/prefetch.py::Prefetcher``; and
              ``TieredSampler``, the device hot tier in front of it;
- ``plane``   ``ExperiencePlane``: spawn, supervise, respawn with
              backoff, close, and the ``experience/*`` and spill
              ``tier/*`` gauges;
- ``spill``   the disk spill tier: each ring shard's write-ahead log of
              cold-encoded segments, and its reader.
"""

from surreal_tpu_torch.experience.plane import ExperiencePlane
from surreal_tpu_torch.experience.sampler import ShardedSampler, TieredSampler
from surreal_tpu_torch.experience.sender import ExperienceSender, shard_of_slot

__all__ = [
    "ExperiencePlane",
    "ExperienceSender",
    "ShardedSampler",
    "TieredSampler",
    "shard_of_slot",
]
