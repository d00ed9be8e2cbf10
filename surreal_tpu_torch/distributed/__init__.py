"""The host data plane of the port, the port of ``surreal_tpu/distributed/``:
the SEED batched inference server and its replicated, autoscaled fleet
(``InferenceFleet``), the env worker and the shared-memory transport; the
parameter service (publisher, server, sharded server, client) with its
wire format (``ModuleDict``, ``dumps_pytree``, ``loads_pytree``) and the
versioned parameter fanout (``FanoutCodec``, ``ParameterFanout``,
``ParameterSubscriber``); and, in place of zmq, the standard-library
sockets they talk over.
"""

from surreal_tpu_torch.distributed.env_worker import run_env_worker
from surreal_tpu_torch.distributed.fleet import InferenceFleet
from surreal_tpu_torch.distributed.inference_server import InferenceServer
from surreal_tpu_torch.distributed.module_dict import ModuleDict, dumps_pytree, loads_pytree
from surreal_tpu_torch.distributed.param_fanout import FanoutCodec, ParameterFanout, ParameterSubscriber
from surreal_tpu_torch.distributed.param_service import (
    ParameterClient,
    ParameterPublisher,
    ParameterServer,
    ShardedParameterServer,
)
from surreal_tpu_torch.distributed.shm_transport import SlabSpec, negotiate_worker_transport

__all__ = [
    "run_env_worker",
    "InferenceServer",
    "InferenceFleet",
    "SlabSpec",
    "negotiate_worker_transport",
    "ModuleDict",
    "dumps_pytree",
    "loads_pytree",
    "ParameterClient",
    "ParameterPublisher",
    "ParameterServer",
    "ShardedParameterServer",
    "FanoutCodec",
    "ParameterFanout",
    "ParameterSubscriber",
]
