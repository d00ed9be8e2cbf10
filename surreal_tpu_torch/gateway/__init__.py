"""The session gateway, the port of ``surreal_tpu/gateway/``: the
tenant-facing session tier in front of the inference fleet (attach and
detach with leases, per-tenant admission control, migrating session
state, version pinning and a bounded act cache).

- :mod:`surreal_tpu_torch.gateway.protocol`: the wire codec (the
  reference's frames, byte for byte) and the tenant-side
  :class:`GatewaySession` client, on the port's sockets (zmq clients
  cannot attach);
- :mod:`surreal_tpu_torch.gateway.admission`: token buckets, session
  quotas, bounded backpressure queues (counted, never silent);
- :mod:`surreal_tpu_torch.gateway.table`: the session table, its
  journal of wire frames and the replica-death rebind;
- :mod:`surreal_tpu_torch.gateway.server`: the ROUTER loop that ties
  them to ``distributed/fleet.py``'s ``serve_act``;
- :mod:`surreal_tpu_torch.gateway.loadgen`: the tenant load generator.
"""

from surreal_tpu_torch.gateway.protocol import GatewayError, GatewaySession
from surreal_tpu_torch.gateway.server import GatewayServer

__all__ = ["GatewayError", "GatewaySession", "GatewayServer"]
