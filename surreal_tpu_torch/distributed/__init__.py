"""The SEED host data plane, the port of ``surreal_tpu/distributed/``'s
single-server path: the batched inference server, the env worker, the
shared-memory transport and, in place of zmq, the standard-library
ROUTER/DEALER sockets they talk over. Not ported yet: ``InferenceFleet``,
the parameter service and fanout, and ``module_dict``.
"""

from surreal_tpu_torch.distributed.env_worker import run_env_worker
from surreal_tpu_torch.distributed.inference_server import InferenceServer
from surreal_tpu_torch.distributed.shm_transport import SlabSpec, negotiate_worker_transport

__all__ = ["run_env_worker", "InferenceServer", "SlabSpec", "negotiate_worker_transport"]
