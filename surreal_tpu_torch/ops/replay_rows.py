"""Replay row gather and priority scatter: the CUDA kernels of
``csrc/replay_rows.cu`` and their plain PyTorch versions, the port of
``surreal_tpu/ops/pallas_replay.py`` (``gather_rows_pallas``,
``scatter_rows_pallas``).

- :func:`gather_rows` — ``{k: leaf[idx]}`` over a dict of ``[capacity,
  ...]`` leaves, every leaf in ONE kernel launch (the Pallas module takes
  one leaf per call; the replay layer mapped it over the pytree).
- :func:`scatter_rows` — ``dest[idx] = updates`` in place; where ``idx``
  names a row more than once, the last occurrence wins, as the Pallas
  kernel's grid order (and XLA's ``.at[].set`` on the CPU) leave it.

Both copy rows verbatim, so any dtype is bit-exact. Indices are int32 on
the card (the kernels take int32, as the Pallas kernels do); other integer
dtypes are cast.

What the kernels need to know about the buffers is worked out here, where
the CPU tests can hold it: the gather's row plan (:func:`gather_plan`:
each leaf's copy unit, units per row and threads per row), passed to the
kernel by value, and the scatter's copy unit (:func:`copy_unit`). A
scatter of more than :data:`SCATTER_BLOCK_ROWS` rows (or into more rows
than its 32-bit table words can name) runs grid-wide and takes device
scratch for its hash table (:func:`scatter_scratch_bytes`), allocated
here; the kernel allocates nothing.

Routing is by the device of the tensors, never by a switch: on a CUDA
tensor the wrapper launches the kernel (or raises), on a CPU tensor it
runs :func:`gather_rows_plain` / :func:`scatter_rows_plain`. Indices are
bounds-checked only where they already lie on the host; on the card they
are not read back (the kernel never dereferences an out-of-range row: the
gather writes zeros for it, the scatter skips it).

``gather_rows.launches`` and ``scatter_rows.launches`` count kernel
launches (and nothing else), so a run can show that its main path went
through the kernels. Under a cost counter (``session/costs.py``) each
wrapper reports one entry on either device, the kernel's bound: no
float operations, and the rows read and written once with the int32
indices read (the scatter reads its updates in ``dest``'s dtype).
"""

from __future__ import annotations

import ctypes
import functools
import math
import struct
from typing import Mapping, Sequence

import torch

from surreal_tpu_torch.session.costs import kernel_cost
from surreal_tpu_torch.utils.kernel_build import load_kernel_library

MAX_LEAVES = 8  # leaves one gather launch carries (csrc/replay_rows.cu)
GATHER_TASKS = 2  # units of a row one gather thread copies per pass (csrc/replay_rows.cu)
MAX_GROUP = 128  # gather threads per row at most: one block (csrc/replay_rows.cu)
SCATTER_BLOCK_ROWS = 1024  # rows the one-block scatter takes; more go grid-wide (csrc/replay_rows.cu)
_INT32_MAX = 2**31 - 1
# csrc/replay_rows.cu's GatherPlan: per leaf (src, dst, row_bytes, unit,
# units, group, pad), then num_leaves and pad, in the C layout
_PLAN = struct.Struct("@" + "PPqiiii" * MAX_LEAVES + "ii")


def _row_bytes(x: torch.Tensor) -> int:
    # from the shape: indexing a row would build a view, a few microseconds
    # of host time per leaf per launch
    return math.prod(x.shape[1:]) * x.element_size()


def copy_unit(row_bytes: int, *ptrs: int) -> int:
    """The widest copy unit (16, 8, 4, 2 or 1 bytes) that divides
    ``row_bytes`` and every base address in ``ptrs``, so that each row of
    each buffer starts on a unit boundary."""
    bits = 0
    for p in ptrs:
        bits |= p
    for unit in (16, 8, 4, 2):
        if row_bytes % unit == 0 and bits % unit == 0:
            return unit
    return 1


def _check_idx(idx: torch.Tensor, device: torch.device, capacity: int) -> None:
    if idx.dim() != 1 or idx.dtype.is_floating_point or idx.is_complex() or idx.dtype == torch.bool:
        raise ValueError(f"idx must be a 1-D integer tensor; got {idx.dtype} {tuple(idx.shape)}")
    if idx.device != device:
        raise ValueError(f"idx on {idx.device}, rows on {device}")
    if idx.shape[0] > _INT32_MAX:
        raise ValueError(f"{idx.shape[0]} indices exceed the kernel's int32 range")
    if idx.device.type == "cpu" and idx.numel() and not (
        0 <= int(idx.min()) and int(idx.max()) < capacity
    ):
        raise IndexError(f"idx out of range [0, {capacity}): min {int(idx.min())}, max {int(idx.max())}")


# -- gather -----------------------------------------------------------------

def gather_rows_plain(leaves: Mapping[str, torch.Tensor], idx: torch.Tensor) -> dict[str, torch.Tensor]:
    """The plain PyTorch version: ``index_select`` per leaf. Used for CPU
    tensors, and as the reference the kernel is held against on the card."""
    return {k: x.index_select(0, idx) for k, x in leaves.items()}


def gather_plan(row_bytes: Sequence[int], srcs: Sequence[int], dsts: Sequence[int]) -> tuple:
    """The gather kernel's row plan for leaves of ``row_bytes`` each, at
    base addresses ``srcs`` (storage) and ``dsts`` (outputs): one ``(unit,
    units, group)`` per leaf.

    Each leaf's rows are copied in ``units`` units of ``unit`` bytes
    (:func:`copy_unit` of its row size and both base addresses), by
    ``group`` threads a row, thread ``j`` units ``j, j + group, ...``: the
    largest power of two, up to :data:`MAX_GROUP`, that is no more than
    the units, so that every thread has a unit and none more than
    :data:`GATHER_TASKS` (a row of more than ``GATHER_TASKS * MAX_GROUP``
    units takes passes). A block of the kernel copies rows of one leaf.
    """
    return _plan(tuple((b, s % 16, d % 16) for b, s, d in zip(row_bytes, srcs, dsts)))


@functools.lru_cache(maxsize=64)
def _plan(leaves: tuple) -> tuple:
    # base addresses matter only modulo the widest unit (16), so the plan
    # of a replay dict is built once and reused
    plan = []
    for b, s, d in leaves:
        unit = copy_unit(b, s, d)
        units = b // unit
        plan.append((unit, units, min(MAX_GROUP, 1 << (max(units, 1).bit_length() - 1))))
    return tuple(plan)


@functools.cache
def _gather_kernel():
    """The gather's C entry point, built and typed once, at first launch;
    checks that the packed plan has the C struct's size."""
    lib = load_kernel_library("replay_rows")
    if lib.replay_gather_plan_bytes() != _PLAN.size:
        raise RuntimeError(f"gather plan packs {_PLAN.size} bytes, the kernel takes {lib.replay_gather_plan_bytes()}")
    fn = lib.replay_gather
    fn.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _launch_gather(leaves: Mapping[str, torch.Tensor], idx: torch.Tensor, capacity: int) -> dict:
    fn = _gather_kernel()
    idx = idx.to(torch.int32).contiguous()
    n = idx.shape[0]
    out = {k: torch.empty((n, *x.shape[1:]), dtype=x.dtype, device=x.device) for k, x in leaves.items()}
    srcs = [x.data_ptr() for x in leaves.values()]
    dsts = [y.data_ptr() for y in out.values()]
    rows = [_row_bytes(x) for x in leaves.values()]
    fields = []
    for src, dst, row, leaf_plan in zip(srcs, dsts, rows, gather_plan(rows, srcs, dsts)):
        fields += [src, dst, row, *leaf_plan, 0]
    fields += [0] * (7 * (MAX_LEAVES - len(rows))) + [len(rows), 0]
    with torch.cuda.device(idx.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(_PLAN.pack(*fields), idx.data_ptr(), n, capacity, stream)
    if err != 0:
        raise RuntimeError(f"replay gather kernel launch failed: cudaError {err}")
    gather_rows.launches += 1
    return out


def gather_rows(leaves: Mapping[str, torch.Tensor], idx: torch.Tensor) -> dict[str, torch.Tensor]:
    """``{k: leaf[idx]}`` for a dict of ``[capacity, ...]`` leaves (at most
    :data:`MAX_LEAVES`, each contiguous, one shared capacity, one device)
    and integer ``idx`` [n]. Launches the CUDA kernel for CUDA tensors
    (once for all leaves, on the current stream, without synchronising)
    and the plain version for CPU tensors."""
    if not leaves:
        raise ValueError("gather_rows needs at least one leaf")
    if len(leaves) > MAX_LEAVES:
        raise ValueError(f"gather_rows takes at most {MAX_LEAVES} leaves; got {len(leaves)}")
    first = next(iter(leaves.values()))
    device = first.device
    capacity = first.shape[0] if first.dim() else None
    for k, x in leaves.items():
        if x.dim() < 1 or x.shape[0] != capacity:
            raise ValueError(f"leaf {k!r} {tuple(x.shape)} is not [capacity={capacity}, ...]")
        if x.device != device:
            raise ValueError(f"leaf {k!r} on {x.device}, others on {device}")
        if not x.is_contiguous():
            raise ValueError(f"leaf {k!r} is not contiguous")
    n = idx.numel()
    # the bound: the rows read and written once, the int32 indices read
    with kernel_cost("replay_gather", 0, 2 * n * sum(_row_bytes(x) for x in leaves.values()) + 4 * n):
        _check_idx(idx, device, capacity)
        if device.type == "cuda":
            return _launch_gather(leaves, idx, capacity)
        if device.type == "cpu":
            return gather_rows_plain(leaves, idx)
    raise ValueError(f"gather_rows has no path for device {device}")


gather_rows.launches = 0


# -- scatter ----------------------------------------------------------------

def scatter_rows_plain(dest: torch.Tensor, idx: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """The plain PyTorch version, in place: ``dest[idx[i]] = updates[i]`` as
    a loop over i in order would leave it (the last occurrence of an index
    wins), written as one ``index_copy_`` of the rows no later index
    overwrites. Used for CPU tensors, and as the reference the kernel is
    held against on the card."""
    idx = idx.to(torch.long)
    later = torch.triu(idx[:, None] == idx[None, :], diagonal=1).any(dim=1)
    keep = ~later
    dest.index_copy_(0, idx[keep], updates[keep].to(dest.dtype))
    return dest


def scatter_scratch_bytes(n: int, capacity: int) -> int:
    """Device scratch the scatter of ``n`` rows into ``capacity`` needs.
    None where the one-block kernel takes it: n up to
    :data:`SCATTER_BLOCK_ROWS`, and the row index and the position fit
    one 32-bit word (capacity << ceil(log2 n) < 2**32). Otherwise the
    grid-wide kernel's hash table: 8-byte slots, the next power of two
    >= 2n of them."""
    if n <= SCATTER_BLOCK_ROWS and capacity << max(n - 1, 0).bit_length() < 2**32:
        return 0
    return 8 << (2 * n - 1).bit_length()


@functools.cache
def _scatter_kernel():
    """The scatter's C entry point, built and typed once, at first launch."""
    fn = load_kernel_library("replay_rows").replay_scatter
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
        ctypes.c_longlong, ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
    ]
    fn.restype = ctypes.c_int
    return fn


def _launch_scatter(dest: torch.Tensor, idx: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    fn = _scatter_kernel()
    idx = idx.to(torch.int32).contiguous()
    upd = updates.to(dest.dtype).contiguous()
    n, row = idx.shape[0], _row_bytes(dest)
    nbytes = scatter_scratch_bytes(n, dest.shape[0])
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=dest.device) if nbytes else None
    with torch.cuda.device(dest.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(dest.data_ptr(), idx.data_ptr(), upd.data_ptr(), n, row,
                 copy_unit(row, dest.data_ptr(), upd.data_ptr()), dest.shape[0],
                 scratch.data_ptr() if nbytes else None, nbytes, stream)
    if err != 0:
        raise RuntimeError(f"replay scatter kernel launch failed: cudaError {err}")
    scatter_rows.launches += 1
    return dest


def scatter_rows(dest: torch.Tensor, idx: torch.Tensor, updates: torch.Tensor) -> torch.Tensor:
    """``dest[idx] = updates`` in place for a contiguous ``[capacity, ...]``
    ``dest``, integer ``idx`` [n] and ``updates`` [n, ...] (cast to
    ``dest``'s dtype); the last occurrence of a repeated index wins.
    Returns ``dest``. Launches the CUDA kernel for CUDA tensors (on the
    current stream, without synchronising) and the plain version for CPU
    tensors."""
    if dest.dim() < 1:
        raise ValueError("scatter_rows needs a [capacity, ...] destination")
    if not dest.is_contiguous():
        raise ValueError("dest is not contiguous")
    n = idx.numel()
    # the bound: the int32 indices and the updates read, the rows written
    with kernel_cost("replay_scatter", 0, 4 * n + 2 * n * _row_bytes(dest)):
        _check_idx(idx, dest.device, dest.shape[0])
        if tuple(updates.shape) != (idx.shape[0], *dest.shape[1:]):
            raise ValueError(f"updates {tuple(updates.shape)} are not [{idx.shape[0]}, *{tuple(dest.shape[1:])}]")
        if updates.device != dest.device:
            raise ValueError(f"updates on {updates.device}, dest on {dest.device}")
        if dest.device.type == "cuda":
            return _launch_scatter(dest, idx, updates)
        if dest.device.type == "cpu":
            return scatter_rows_plain(dest, idx, updates)
    raise ValueError(f"scatter_rows has no path for device {dest.device}")


scatter_rows.launches = 0
