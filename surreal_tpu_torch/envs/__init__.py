"""Environment layer of the PyTorch port: the batched device envs
(``envs/device/``), the host adapters (gymnasium, dm_control, robosuite)
with their numpy wrappers, and the ``make_env`` factory."""

from surreal_tpu_torch.envs.base import ArraySpec, DiscreteSpec, EnvSpecs, HostEnv, HostWrapper, StepOutput
from surreal_tpu_torch.envs.factory import is_jax_env, make_env

__all__ = ["ArraySpec", "DiscreteSpec", "EnvSpecs", "HostEnv", "HostWrapper", "StepOutput", "is_jax_env", "make_env"]
