"""Reverse linear recurrence: the CUDA kernel ``csrc/rev_scan.cu`` and its
plain PyTorch version, the port of ``surreal_tpu/ops/pallas_returns.py``
(``reverse_linear_scan_pallas``, ``discounted_returns_pallas``).

``x_t = deltas_t + coeffs_t * x_{t+1}`` with ``x_T = init`` is the
recurrence every return estimator solves; GAE and V-trace have their own
fused kernels (``ops/gae.py``, ``ops/vtrace.py``), this is the generic one,
which the 'assoc' forms (``ops/returns.py::reverse_linear_scan_assoc``) and
``ops/returns.py::discounted_returns`` launch.

Dtype contract: inputs of any real dtype are cast to float32 and the
output is float32; the recurrence accumulates T terms and needs f32.

Routing is by the device of the tensors, never by a switch: on a CUDA
tensor :func:`reverse_linear_scan` launches the kernel (or raises), on a
CPU tensor it runs :func:`reverse_linear_scan_plain`.
The kernel cuts [T, B] into column tiles and time stages; the wrapper
passes it :func:`~surreal_tpu_torch.ops.scan_tiles.scan_plan`'s choice
for the shape and the card, with the scan's own stage budget
(``REV_SCAN_STAGE_BYTES``).

``reverse_linear_scan.launches`` counts kernel launches (and nothing
else). Under a cost counter (``session/costs.py``) the wrapper reports
one entry on either device, the kernel's bound: coeffs and deltas read,
the output written, init read, once each (float32), 2 operations an
element.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from surreal_tpu_torch.ops.scan_tiles import REV_SCAN_STAGE_BYTES, ScanPlan, multiprocessors, scan_plan
from surreal_tpu_torch.session.costs import kernel_cost
from surreal_tpu_torch.utils.kernel_build import load_kernel_library

_INT32_MAX = 2**31 - 1


def reverse_linear_scan_plain(
    coeffs: torch.Tensor, deltas: torch.Tensor, init: torch.Tensor
) -> torch.Tensor:
    """The plain PyTorch version: a reverse loop over T with the kernel's
    order of operations. Used for CPU tensors, and as the reference the
    kernel is held against on the card."""
    c, d = coeffs.to(torch.float32), deltas.to(torch.float32)
    out = torch.empty_like(d)
    acc = init.to(torch.float32)
    for t in range(d.shape[0] - 1, -1, -1):
        acc = d[t] + c[t] * acc
        out[t] = acc
    return out


@functools.cache
def _kernel():
    """The kernel's C entry point, built and typed once, at first launch."""
    fn = load_kernel_library("rev_scan").rev_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def _launch(
    coeffs: torch.Tensor, deltas: torch.Tensor, init: torch.Tensor, plan: ScanPlan | None = None
) -> torch.Tensor:
    """Launches the kernel, cut by ``plan`` (default: :func:`scan_plan`'s)."""
    T, B = deltas.shape
    if T * B > _INT32_MAX:
        raise ValueError(f"[T, B] = [{T}, {B}] exceeds the kernel's int32 index range")
    fn = _kernel()
    c, d, x0 = (x.to(torch.float32).contiguous() for x in (coeffs, deltas, init))
    out = torch.empty((T, B), dtype=torch.float32, device=d.device)
    plan = plan or scan_plan(T, B, 2, multiprocessors(out.device), REV_SCAN_STAGE_BYTES)
    with torch.cuda.device(out.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(c.data_ptr(), d.data_ptr(), x0.data_ptr(), out.data_ptr(), T, B, stream, *plan)
    if err != 0:
        raise RuntimeError(f"rev_scan kernel launch failed: cudaError {err}")
    reverse_linear_scan.launches += 1
    return out


def reverse_linear_scan(
    coeffs: torch.Tensor, deltas: torch.Tensor, init: torch.Tensor | None = None
) -> torch.Tensor:
    """Solve ``x_t = deltas_t + coeffs_t * x_{t+1}`` over [T, B] arrays with
    ``x_T = init`` ([B], default zeros). Returns float32 [T, B]. Launches
    the CUDA kernel for CUDA tensors (on the current stream, without
    synchronising) and the plain version for CPU tensors."""
    shape = deltas.shape
    if len(shape) != 2 or 0 in shape:
        raise ValueError(f"scan inputs must be non-empty [T, B]; got {tuple(shape)}")
    T, B = shape
    with kernel_cost("rev_scan", 2 * T * B, 3 * 4 * T * B + 4 * B):
        return _dispatch(coeffs, deltas, init)


def _dispatch(coeffs: torch.Tensor, deltas: torch.Tensor, init: torch.Tensor | None) -> torch.Tensor:
    shape = deltas.shape
    if init is None:
        init = torch.zeros(shape[1], dtype=torch.float32, device=deltas.device)
    if coeffs.shape != shape or tuple(init.shape) != (shape[1],):
        raise ValueError(
            f"coeffs {tuple(coeffs.shape)} and init {tuple(init.shape)} do not fit deltas {tuple(shape)}"
        )
    for x in (coeffs, init):
        if x.device != deltas.device:
            raise ValueError(f"scan inputs on different devices: {x.device} vs {deltas.device}")
    for x in (coeffs, deltas, init):
        if x.is_complex() or x.dtype == torch.bool:
            raise TypeError(f"scan inputs must be real numbers; got {x.dtype}")
    if deltas.device.type == "cuda":
        return _launch(coeffs, deltas, init)
    if deltas.device.type == "cpu":
        return reverse_linear_scan_plain(coeffs, deltas, init)
    raise ValueError(f"reverse_linear_scan has no path for device {deltas.device}")


reverse_linear_scan.launches = 0

