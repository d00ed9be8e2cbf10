"""Fused truncation-exact GAE: the CUDA kernel ``csrc/gae.cu`` and its plain
PyTorch version, the port of ``surreal_tpu/ops/pallas_gae.py``.

Two entry points, the counterparts of the Pallas module's:

- :func:`gae_advantages_masked` — the two-mask form the PPO learner uses
  (bootstrap discount ``gamma*(1-terminated)`` for the TD delta,
  accumulation decay ``gamma*lam*(1-done)``, per-step ``v_next`` from the
  pre-reset terminal obs); all inputs [T, B].
- :func:`gae_advantages` — the simple contract (one discount array,
  ``values`` as a [T+1, B] stack).

Dtype contract: inputs of any dtype are cast to float32 and both outputs
are float32; the recurrence accumulates T terms and needs f32.

Routing is by the device of the tensors, never by a switch: on a CUDA
tensor the wrapper launches the kernel (or raises), on a CPU tensor it
runs :func:`gae_masked_plain`. So in the PPO learner both
``gae_impl='xla'`` (the default) and ``'pallas'`` reach the kernel on the
card; ``'assoc'`` goes to ``ops/returns.py::reverse_linear_scan_assoc``
(the reverse scan's kernel) instead.

The kernel cuts [T, B] into column tiles and time stages; the wrapper
passes it :func:`~surreal_tpu_torch.ops.scan_tiles.scan_plan`'s choice
for the shape and the card.

``gae_advantages_masked.launches`` counts kernel launches (and nothing
else), so a run can show that its main path went through the kernel.
Under a cost counter (``session/costs.py``) the wrapper reports one
entry on either device, the kernel's bound: 5 float32 inputs read and 2
outputs written once each, 6 operations an element.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from surreal_tpu_torch.ops.scan_tiles import ScanPlan, multiprocessors, scan_plan
from surreal_tpu_torch.session.costs import kernel_cost
from surreal_tpu_torch.utils.kernel_build import load_kernel_library

_INT32_MAX = 2**31 - 1
GAE_OPS = 6  # float32 operations an element: mul, add, sub, mul, add, add


def gae_masked_plain(
    rewards: torch.Tensor,
    boot_disc: torch.Tensor,
    decay: torch.Tensor,
    values_t: torch.Tensor,
    values_next: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain PyTorch version: a reverse loop over T with the kernel's
    exact order of operations. Used for CPU tensors, and as the reference
    the kernel is held against on the card."""
    r, boot, dec, v_t, v_n = (x.to(torch.float32) for x in (rewards, boot_disc, decay, values_t, values_next))
    deltas = r + boot * v_n - v_t
    adv = torch.empty_like(deltas)
    acc = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + dec[t] * acc
        adv[t] = acc
    return adv, adv + v_t


@functools.cache
def _kernel():
    """The kernel's C entry point, built and typed once, at first launch."""
    fn = load_kernel_library("gae").gae_masked_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _launch(inputs: list[torch.Tensor], plan: ScanPlan | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Launches the kernel, cut by ``plan`` (default: :func:`scan_plan`'s)."""
    T, B = inputs[0].shape
    if T * B > _INT32_MAX:
        raise ValueError(f"[T, B] = [{T}, {B}] exceeds the kernel's int32 index range")
    fn = _kernel()
    arrs = [x.to(torch.float32).contiguous() for x in inputs]
    adv = torch.empty((T, B), dtype=torch.float32, device=arrs[0].device)
    tgt = torch.empty_like(adv)
    plan = plan or scan_plan(T, B, len(arrs), multiprocessors(adv.device))
    with torch.cuda.device(adv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(x.data_ptr() for x in arrs), adv.data_ptr(), tgt.data_ptr(), T, B, stream, *plan)
    if err != 0:
        raise RuntimeError(f"gae kernel launch failed: cudaError {err}")
    gae_advantages_masked.launches += 1
    return adv, tgt


def gae_advantages_masked(
    rewards: torch.Tensor,
    boot_disc: torch.Tensor,
    decay: torch.Tensor,
    values_t: torch.Tensor,
    values_next: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Truncation-exact GAE; all inputs [T, B] on one device.

    Returns (advantages, value_targets), both float32 [T, B]. Launches the
    CUDA kernel for CUDA tensors (on the current stream, without
    synchronising) and the plain version for CPU tensors.
    """
    inputs = [rewards, boot_disc, decay, values_t, values_next]
    shape = rewards.shape
    if len(shape) != 2 or 0 in shape:
        raise ValueError(f"GAE inputs must be non-empty [T, B]; got {tuple(shape)}")
    for x in inputs:
        if x.shape != shape:
            raise ValueError(f"GAE inputs disagree in shape: {tuple(x.shape)} vs {tuple(shape)}")
        if x.device != rewards.device:
            raise ValueError(f"GAE inputs on different devices: {x.device} vs {rewards.device}")
        if x.is_complex() or x.dtype == torch.bool:
            raise TypeError(f"GAE inputs must be real numbers; got {x.dtype}")
    T, B = shape
    with kernel_cost("gae", GAE_OPS * T * B, 7 * 4 * T * B):
        if rewards.device.type == "cuda":
            return _launch(inputs)
        if rewards.device.type == "cpu":
            return gae_masked_plain(*inputs)
    raise ValueError(f"GAE has no path for device {rewards.device}")


gae_advantages_masked.launches = 0


def gae_advantages(
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    values: torch.Tensor,
    lam: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Simple contract (rewards/discounts [T, B], values [T+1, B]), the
    counterpart of ``gae_advantages_pallas``; float32 outputs."""
    return gae_advantages_masked(rewards, discounts, discounts * lam, values[:-1], values[1:])
