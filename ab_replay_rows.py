"""Time the replay gather and scatter kernels of csrc/replay_rows.cu against
an older version of the same source, in turns, on one CUDA card.

    git show c0e1b90:surreal_tpu_torch/csrc/replay_rows.cu > build/replay_rows_old.cu
    python3 ab_replay_rows.py build/replay_rows_old.cu

The old source is the one whose C interface had no row plan:
``replay_gather(srcs, dsts, row_bytes, num_leaves, idx, n, capacity,
stream)`` and ``replay_scatter(dest, idx, updates, n, row_bytes, capacity,
stream)``. It is built with the same nvcc flags into build/torch_kernels/
under another name; the new one through ops/replay_rows.py as usual.

Cases: the DDPG path's gather (256 rows of the five leaves, 160 B a row,
from a 200,000-row ring) and scatter (256 f32 priorities into 200,000, 32
of them repeated), uniform sample_many's gather of 16,384 rows, and a
scatter of 3,072 rows (three times the new one-block limit: the
grid-wide kernel). Both versions are first held bit for bit against the plain
versions. Each measurement is chip_smoke.py's ``time_cuda_ms`` (CUDA
events, L2 flushed, the card spinning first so the events hold the card's
time alone), run in the order old, new, new, old for each of ROUNDS
rounds. Beside them: the library call, the launch floor (a one-element
``fill_``), the byte bound, and the host time of one wrapper call (no
sync; both through ops/replay_rows.py's checks, the old one with the
launch code it had). Prints one JSON line per case and a summary line;
needs a card.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import statistics
import subprocess
import sys
import time

import torch

from surreal_tpu_torch.ops import replay_rows as RR

ROUNDS = 3
RUNS = 30


def build_old(src: str):
    from surreal_tpu_torch.utils.kernel_build import BUILD_DIR, NVCC_FLAGS, _nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / "libreplay_rows_old.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), src], check=True)
    lib = ctypes.CDLL(str(out))
    lib.replay_gather.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_longlong),
        ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p,
    ]
    lib.replay_scatter.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_longlong,
        ctypes.c_void_p,
    ]
    return lib


def old_row_bytes(x: torch.Tensor) -> int:
    """A row's bytes as the old wrapper took them (from a view of row 0)."""
    return x[0].numel() * x.element_size() if x.shape[0] else 0


def old_launches(lib):
    """The launch functions of ops/replay_rows.py as they were for the old
    source (its C interface), for :func:`old_wrappers` to put in place."""
    def launch_gather(leaves, idx, capacity):
        idx = idx.to(torch.int32).contiguous()
        n, k = idx.shape[0], len(leaves)
        out = {name: torch.empty((n, *x.shape[1:]), dtype=x.dtype, device=x.device) for name, x in leaves.items()}
        srcs = (ctypes.c_void_p * k)(*(x.data_ptr() for x in leaves.values()))
        dsts = (ctypes.c_void_p * k)(*(y.data_ptr() for y in out.values()))
        rows = (ctypes.c_longlong * k)(*(old_row_bytes(x) for x in leaves.values()))
        with torch.cuda.device(idx.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.replay_gather(srcs, dsts, rows, k, idx.data_ptr(), n, capacity, stream)
        if err:
            raise RuntimeError(f"old gather: cudaError {err}")
        return out

    def launch_scatter(dest, idx, updates):
        idx = idx.to(torch.int32).contiguous()
        upd = updates.to(dest.dtype).contiguous()
        with torch.cuda.device(dest.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = lib.replay_scatter(dest.data_ptr(), idx.data_ptr(), upd.data_ptr(), idx.shape[0],
                                     old_row_bytes(dest), dest.shape[0], stream)
        if err:
            raise RuntimeError(f"old scatter: cudaError {err}")
        return dest

    return launch_gather, launch_scatter


@contextlib.contextmanager
def old_wrappers(lib):
    """Within it, RR.gather_rows and RR.scatter_rows launch the old kernels:
    the same checks and routing, the old launch code."""
    saved = RR._launch_gather, RR._launch_scatter
    RR._launch_gather, RR._launch_scatter = old_launches(lib)
    try:
        yield
    finally:
        RR._launch_gather, RR._launch_scatter = saved


def old(lib, fn):
    """``fn`` run with the old kernels in place."""
    def call():
        with old_wrappers(lib):
            return fn()
    return call


def host_us(fn, calls: int = 2000) -> float:
    """Host time of one call, enqueue only, over ``calls`` calls."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def in_turns(old, new, flush) -> dict:
    """Card times of ``old`` and ``new``, ROUNDS rounds of old, new, new, old."""
    from chip_smoke import time_cuda_ms

    times = {"old": [], "new": []}
    for _ in range(ROUNDS):
        for name in ("old", "new", "new", "old"):
            times[name].append(time_cuda_ms(old if name == "old" else new, runs=RUNS, flush=flush, spin=True))
    return {**{f"{k}_ms": v for k, v in times.items()},
            **{f"{k}_ms_median": statistics.median(v) for k, v in times.items()}}


def main() -> int:
    if len(sys.argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_replay_rows: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import DDPG_BS, DDPG_CAPACITY, DDPG_MANY_ROWS, DDPG_ROW_SHAPES, H100_BYTES_PER_S
    from chip_smoke import launch_floor_ms, nvidia_smi, time_cuda_ms

    lib = build_old(sys.argv[1])
    smi = nvidia_smi()
    gen = torch.Generator(device="cuda").manual_seed(7)
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    leaves = {k: torch.randn((DDPG_CAPACITY, *s), generator=gen, device="cuda") for k, s in DDPG_ROW_SHAPES.items()}
    row_bytes = sum(x[0].numel() * x.element_size() for x in leaves.values())
    results = {"device": smi, "rounds": ROUNDS, "runs": RUNS}

    for label, rows in (("gather_path", DDPG_BS), ("gather_sample_many", DDPG_MANY_ROWS)):
        idx = torch.randint(0, DDPG_CAPACITY, (rows,), generator=gen, device="cuda", dtype=torch.int32)
        want = RR.gather_rows_plain(leaves, idx)
        gather = lambda: RR.gather_rows(leaves, idx)  # noqa: E731
        for version, out in (("old", old(lib, gather)()), ("new", gather())):
            torch.cuda.synchronize()
            if not all(torch.equal(out[k], want[k]) for k in leaves):
                raise AssertionError(f"{label}: the {version} gather differs from the plain version")
        nbytes = 2 * rows * row_bytes + 4 * rows
        results[label] = {
            "rows": rows, "row_bytes": row_bytes,
            **in_turns(old(lib, gather), gather, flush),
            "library_ms": sum(time_cuda_ms(lambda x=x: x.index_select(0, idx), runs=RUNS, flush=flush, spin=True)
                              for x in leaves.values()),
            "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
            "host_us_old": old(lib, lambda: host_us(gather))(),
            "host_us_new": host_us(gather),
        }
        print(json.dumps({"case": label, **results[label]}), flush=True)

    for label, rows, span in (("scatter_path", DDPG_BS, DDPG_CAPACITY),
                              ("scatter_grid_wide", 3 * RR.SCATTER_BLOCK_ROWS, 2 * RR.SCATTER_BLOCK_ROWS)):
        dest = torch.rand(DDPG_CAPACITY, generator=gen, device="cuda")
        idx = torch.randint(0, span, (rows,), generator=gen, device="cuda", dtype=torch.int32)
        if label == "scatter_path":
            idx[rows // 2:: 4] = idx[: rows // 8]  # forced duplicates, as chip_smoke.py's path case
        upd = torch.rand(rows, generator=gen, device="cuda")
        want = RR.scatter_rows_plain(dest.clone(), idx, upd)
        scatter = lambda d=dest: RR.scatter_rows(d, idx, upd)  # noqa: E731
        for version, out in (("old", old(lib, lambda: scatter(dest.clone()))()), ("new", scatter(dest.clone()))):
            torch.cuda.synchronize()
            if not torch.equal(out, want):
                raise AssertionError(f"{label}: the {version} scatter differs from the plain version")
        unique = torch.randperm(DDPG_CAPACITY, generator=gen, device="cuda")[:rows]
        results[label] = {
            "rows": rows, "repeated_indices": rows - torch.unique(idx).numel(),
            **in_turns(old(lib, scatter), scatter, flush),
            "library_ms": time_cuda_ms(lambda: dest.index_copy_(0, unique, upd), runs=RUNS, flush=flush, spin=True),
            "bound_ms": 12 * rows / H100_BYTES_PER_S * 1e3,
            "host_us_old": old(lib, lambda: host_us(scatter))(),
            "host_us_new": host_us(scatter),
        }
        print(json.dumps({"case": label, **results[label]}), flush=True)

    results["launch_floor_ms"] = launch_floor_ms(flush)
    print(json.dumps({"summary": {k: ({kk: vv for kk, vv in v.items() if not kk.endswith("_ms")}
                                      if isinstance(v, dict) else v) for k, v in results.items()}}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
