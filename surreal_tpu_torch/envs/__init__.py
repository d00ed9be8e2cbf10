"""Environment layer of the PyTorch port (device envs only so far)."""

from surreal_tpu_torch.envs.factory import make_env

__all__ = ["make_env"]
