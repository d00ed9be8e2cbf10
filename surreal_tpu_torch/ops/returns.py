"""Return / advantage estimators, the port of ``surreal_tpu/ops/returns.py``.

Only :func:`gae_advantages` is ported so far, and it is the fused GAE of
``ops/gae.py`` under the simple contract: the CUDA kernel for CUDA
tensors, the plain reverse loop (``gae_masked_plain``) for CPU tensors.

Conventions (all time-major): arrays are [T, B]; ``discounts[t]`` =
gamma * (1 - done[t]); ``values`` is [T+1, B] with the bootstrap value
at index T. Returns (advantages, value_targets), both float32 [T, B].
"""

from surreal_tpu_torch.ops.gae import gae_advantages

__all__ = ["gae_advantages"]
