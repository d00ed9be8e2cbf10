"""V-trace: the fused CUDA kernel ``csrc/vtrace.cu`` and its plain PyTorch
version, the port of ``surreal_tpu/ops/vtrace.py`` (``VTraceOutput``,
``vtrace``, ``vtrace_nextobs``, ``vtrace_assoc``, ``vtrace_nextobs_assoc``)
and ``surreal_tpu/ops/pallas_vtrace.py`` (``vtrace_pallas``,
``vtrace_nextobs_pallas``).

One function computes V-trace in one reverse pass over [T, B], the
kernel-level :func:`vtrace_fused` (the Pallas module's ``_vtrace_call``):
float32 outputs for inputs of any real dtype. Two entry points build its
inputs, the counterparts of the reference's two contracts:

- :func:`vtrace_nextobs` — the truncation-exact learner form: TD-delta
  discount ``boot = gamma*(1-terminated)`` against V(pre-reset successor
  obs), recursion coefficient ``edge = gamma*(1-done)``, and the done mask
  that cuts the pg tail at episode boundaries.
- :func:`vtrace` — the simple contract: ``discounts`` serve as both
  ``boot`` and ``edge``, ``values`` is the [T+1, ...] stack, no done mask.

Their 'assoc' twins, :func:`vtrace_nextobs_assoc` and :func:`vtrace_assoc`,
follow the reference's structure instead: the elementwise rhos, clipped
rhos, cs and deltas in PyTorch, one
``ops/returns.py::reverse_linear_scan_assoc`` (``csrc/rev_scan.cu`` on the
card), then the successor values and the pg advantages.

The four entry points keep the reference's contract: inputs [T, ...] of
any rank >= 1 (folded into one column axis around the kernels and unfolded
after), ``unroll`` accepted and ignored where the reference takes it (a
``lax.scan`` unroll), and outputs in the reference's dtype, computed in
float32. Every output is detached (the reference applies
``stop_gradient``; there is no backward kernel).

Routing is by the device of the tensors, never by a switch: on a CUDA
tensor :func:`vtrace_fused` launches the kernel (or raises), on a CPU
tensor it runs :func:`vtrace_fused_plain`. So in the IMPALA learner both
``vtrace_impl='xla'`` (the default) and ``'pallas'`` reach the fused
kernel on the card, and ``'assoc'`` the reverse scan's.

The kernel cuts [T, B] into column tiles and time stages; the wrapper
passes it :func:`~surreal_tpu_torch.ops.scan_tiles.scan_plan`'s choice
for the shape and the card.

``vtrace_fused.launches`` counts kernel launches (and nothing else), so a
run can show that its main path went through the kernel. Under a cost
counter (``session/costs.py``) :func:`vtrace_fused` reports one entry on
either device, the kernel's bound: 8 float32 inputs read and 2 outputs
written once each, :data:`VTRACE_OPS` operations an element.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from surreal_tpu_torch.ops.returns import (
    as_columns,
    check_time_major,
    check_values,
    result_dtype,
    reverse_linear_scan_assoc,
)
from surreal_tpu_torch.ops.scan_tiles import ScanPlan, multiprocessors, scan_plan
from surreal_tpu_torch.session.costs import kernel_cost
from surreal_tpu_torch.utils.kernel_build import load_kernel_library

_INT32_MAX = 2**31 - 1
# float32 operations an element (csrc/vtrace.cu): rho 2 (sub, exp), delta
# 5, recursion 4, vs 1, successor 4, pg advantage 5
VTRACE_OPS = 21


class VTraceOutput(NamedTuple):
    vs: torch.Tensor             # [T, B] V-trace value targets
    pg_advantages: torch.Tensor  # [T, B] policy-gradient advantages


@torch.no_grad()
def vtrace_fused_plain(
    bl: torch.Tensor,
    tl: torch.Tensor,
    rewards: torch.Tensor,
    boot: torch.Tensor,
    edge: torch.Tensor,
    values_t: torch.Tensor,
    values_next: torch.Tensor,
    done: torch.Tensor,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
    clip_pg_rho: float = 1.0,
) -> VTraceOutput:
    """The plain PyTorch version: a reverse loop over T with the Pallas
    kernel's order of operations (``pallas_vtrace.py:58-80``), which the
    CUDA kernel follows too. Used for CPU tensors, and as the reference
    the kernel is held against on the card."""
    bl, tl, r, boot, edge, v_t, v_n, done = (
        x.to(torch.float32) for x in (bl, tl, rewards, boot, edge, values_t, values_next, done)
    )
    rho = torch.exp(tl - bl)
    deltas = torch.clamp_max(rho, clip_rho) * ((r + boot * v_n) - v_t)
    coeffs = edge * torch.clamp_max(rho, clip_c)
    vs = torch.empty_like(deltas)
    acc = torch.zeros_like(deltas[0])
    for t in range(deltas.shape[0] - 1, -1, -1):
        acc = deltas[t] + coeffs[t] * acc
        vs[t] = acc + v_t[t]
    vs_next = torch.cat([vs[1:], v_n[-1:]])
    succ = done * v_n + (1.0 - done) * vs_next
    pg = torch.clamp_max(rho, clip_pg_rho) * ((r + boot * succ) - v_t)
    return VTraceOutput(vs=vs, pg_advantages=pg)


@functools.cache
def _kernel():
    """The kernel's C entry point, built and typed once, at first launch."""
    fn = load_kernel_library("vtrace").vtrace_f32
    fn.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_void_p]
        + [ctypes.c_int, ctypes.c_int]
    )
    fn.restype = ctypes.c_int
    return fn


def _launch(
    inputs: list[torch.Tensor], clips: tuple[float, float, float], plan: ScanPlan | None = None
) -> VTraceOutput:
    """Launches the kernel, cut by ``plan`` (default: :func:`scan_plan`'s)."""
    T, B = inputs[0].shape
    if T * B > _INT32_MAX:
        raise ValueError(f"[T, B] = [{T}, {B}] exceeds the kernel's int32 index range")
    fn = _kernel()
    arrs = [x.detach().to(torch.float32).contiguous() for x in inputs]
    vs = torch.empty((T, B), dtype=torch.float32, device=arrs[0].device)
    pg = torch.empty_like(vs)
    plan = plan or scan_plan(T, B, len(arrs), multiprocessors(vs.device))
    with torch.cuda.device(vs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(*(x.data_ptr() for x in arrs), vs.data_ptr(), pg.data_ptr(), T, B, *clips, stream, *plan)
    if err != 0:
        raise RuntimeError(f"vtrace kernel launch failed: cudaError {err}")
    vtrace_fused.launches += 1
    return VTraceOutput(vs=vs, pg_advantages=pg)


def vtrace_fused(
    bl: torch.Tensor,
    tl: torch.Tensor,
    rewards: torch.Tensor,
    boot: torch.Tensor,
    edge: torch.Tensor,
    values_t: torch.Tensor,
    values_next: torch.Tensor,
    done: torch.Tensor,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
    clip_pg_rho: float = 1.0,
) -> VTraceOutput:
    """Fused V-trace; all eight inputs [T, B] on one device (behaviour and
    target log-probs, rewards, TD-delta discount, recursion coefficient,
    V(s_t), V(s'_t), done mask).

    Returns float32 (vs, pg_advantages). Launches the CUDA kernel for CUDA
    tensors (on the current stream, without synchronising) and the plain
    version for CPU tensors.
    """
    inputs = [bl, tl, rewards, boot, edge, values_t, values_next, done]
    shape = rewards.shape
    if len(shape) != 2 or 0 in shape:
        raise ValueError(f"V-trace inputs must be non-empty [T, B]; got {tuple(shape)}")
    for x in inputs:
        if x.shape != shape:
            raise ValueError(f"V-trace inputs disagree in shape: {tuple(x.shape)} vs {tuple(shape)}")
        if x.device != rewards.device:
            raise ValueError(f"V-trace inputs on different devices: {x.device} vs {rewards.device}")
        if x.is_complex():
            raise TypeError(f"V-trace inputs must be real numbers; got {x.dtype}")
    clips = (float(clip_rho), float(clip_c), float(clip_pg_rho))
    T, B = shape
    with kernel_cost("vtrace", VTRACE_OPS * T * B, 10 * 4 * T * B):
        if rewards.device.type == "cuda":
            return _launch(inputs, clips)
        if rewards.device.type == "cpu":
            return vtrace_fused_plain(*inputs, *clips)
    raise ValueError(f"V-trace has no path for device {rewards.device}")


vtrace_fused.launches = 0


def _unfold(out: VTraceOutput, shape: torch.Size, dtype: torch.dtype) -> VTraceOutput:
    return VTraceOutput(*(x.reshape(shape).to(dtype) for x in out))


def vtrace_nextobs(
    behaviour_logp: torch.Tensor,
    target_logp: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    values_next: torch.Tensor,
    done: torch.Tensor,
    terminated: torch.Tensor,
    gamma: float,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
    clip_pg_rho: float = 1.0,
    unroll: int = 1,
) -> VTraceOutput:
    """Truncation-exact V-trace over auto-reset trajectories, all inputs
    [T, ...]: the counterpart of ``vtrace_nextobs`` and
    ``vtrace_nextobs_pallas``, through :func:`vtrace_fused`."""
    del unroll  # a lax.scan unroll in the reference; the math is the same
    shape = rewards.shape
    check_time_major("V-trace", shape, behaviour_logp, target_logp, values, values_next, done, terminated)
    dtype = result_dtype(behaviour_logp, target_logp, rewards, values, values_next)
    done_f = as_columns(done)
    out = vtrace_fused(
        as_columns(behaviour_logp), as_columns(target_logp), as_columns(rewards),
        gamma * (1.0 - as_columns(terminated)),  # boot: TD-delta discount
        gamma * (1.0 - done_f),                  # edge: recursion coefficient
        as_columns(values), as_columns(values_next), done_f,
        clip_rho, clip_c, clip_pg_rho,
    )
    return _unfold(out, shape, dtype)


def vtrace(
    behaviour_logp: torch.Tensor,
    target_logp: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    values: torch.Tensor,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
    clip_pg_rho: float = 1.0,
    unroll: int = 1,
) -> VTraceOutput:
    """Simple contract (log-probs, rewards, discounts [T, ...]; values
    [T+1, ...]), the counterpart of ``vtrace`` and ``vtrace_pallas``,
    through :func:`vtrace_fused`."""
    del unroll  # a lax.scan unroll in the reference; the math is the same
    shape = rewards.shape
    check_time_major("V-trace", shape, behaviour_logp, target_logp, discounts)
    check_values("V-trace", shape, values)
    dtype = result_dtype(behaviour_logp, target_logp, rewards, discounts, values)
    disc, v = as_columns(discounts), as_columns(values)
    out = vtrace_fused(
        as_columns(behaviour_logp), as_columns(target_logp), as_columns(rewards), disc, disc,
        v[:-1], v[1:], torch.zeros_like(disc),
        clip_rho, clip_c, clip_pg_rho,
    )
    return _unfold(out, shape, dtype)


@torch.no_grad()
def vtrace_assoc(
    behaviour_logp: torch.Tensor,
    target_logp: torch.Tensor,
    rewards: torch.Tensor,
    discounts: torch.Tensor,
    values: torch.Tensor,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
    clip_pg_rho: float = 1.0,
) -> VTraceOutput:
    """:func:`vtrace` through ``reverse_linear_scan_assoc``, the reference's
    expressions (``surreal_tpu/ops/vtrace.py::vtrace_assoc``)."""
    shape = rewards.shape
    check_time_major("V-trace", shape, behaviour_logp, target_logp, discounts)
    check_values("V-trace", shape, values)
    dtype = result_dtype(behaviour_logp, target_logp, rewards, discounts, values)
    bl, tl, r, disc, v = (x.to(torch.float32) for x in (behaviour_logp, target_logp, rewards, discounts, values))
    rhos = torch.exp(tl - bl)
    cs = torch.clamp_max(rhos, clip_c)
    deltas = torch.clamp_max(rhos, clip_rho) * (r + disc * v[1:] - v[:-1])
    vs = reverse_linear_scan_assoc(disc * cs, deltas) + v[:-1]
    vs_next = torch.cat([vs[1:], v[-1:]])
    pg = torch.clamp_max(rhos, clip_pg_rho) * (r + disc * vs_next - v[:-1])
    return VTraceOutput(vs=vs.to(dtype), pg_advantages=pg.to(dtype))


@torch.no_grad()
def vtrace_nextobs_assoc(
    behaviour_logp: torch.Tensor,
    target_logp: torch.Tensor,
    rewards: torch.Tensor,
    values: torch.Tensor,
    values_next: torch.Tensor,
    done: torch.Tensor,
    terminated: torch.Tensor,
    gamma: float,
    clip_rho: float = 1.0,
    clip_c: float = 1.0,
    clip_pg_rho: float = 1.0,
) -> VTraceOutput:
    """:func:`vtrace_nextobs` through ``reverse_linear_scan_assoc``, the
    reference's expressions (``surreal_tpu/ops/vtrace.py::vtrace_nextobs_assoc``):
    the per-step coefficient ``gamma * (1 - done) * c_t``, the additive term
    the clipped TD delta."""
    shape = rewards.shape
    check_time_major("V-trace", shape, behaviour_logp, target_logp, values, values_next, done, terminated)
    dtype = result_dtype(behaviour_logp, target_logp, rewards, values, values_next)
    bl, tl, r, v, v_n, done_f, term = (
        x.to(torch.float32) for x in (behaviour_logp, target_logp, rewards, values, values_next, done, terminated)
    )
    rhos = torch.exp(tl - bl)
    cs = torch.clamp_max(rhos, clip_c)
    boot = gamma * (1.0 - term)
    deltas = torch.clamp_max(rhos, clip_rho) * (r + boot * v_n - v)
    vs = reverse_linear_scan_assoc(gamma * (1.0 - done_f) * cs, deltas) + v
    vs_shift = torch.cat([vs[1:], v_n[-1:]])
    vs_next = done_f * v_n + (1.0 - done_f) * vs_shift
    pg = torch.clamp_max(rhos, clip_pg_rho) * (r + boot * vs_next - v)
    return VTraceOutput(vs=vs.to(dtype), pg_advantages=pg.to(dtype))
