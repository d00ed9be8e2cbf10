"""Time the reverse-time scan kernels (csrc/gae.cu, csrc/vtrace.cu,
csrc/rev_scan.cu) against older versions of the same sources, in turns, on
one CUDA card.

    git show 5c55276:surreal_tpu_torch/csrc/gae.cu > build/gae_old.cu
    git show 5c55276:surreal_tpu_torch/csrc/vtrace.cu > build/vtrace_old.cu
    git show 9c58f31:surreal_tpu_torch/csrc/rev_scan.cu > build/rev_scan_old.cu
    python3 ab_scan_kernels.py [--gae OLD.cu] [--vtrace OLD.cu] [--rev-scan OLD.cu] [--sweep]

Each kernel named by an option is timed against the old source given for
it. The old sources are the one-thread-a-column designs, whose C entry
points took no plan: ``gae_masked_f32(r, boot, decay, v_t, v_next, adv,
target, T, B, stream)``, ``vtrace_f32(bl, tl, r, boot, edge, v_t, v_next,
done, vs, pg, T, B, clip_rho, clip_c, clip_pg_rho, stream)`` and
``rev_scan_f32(coeffs, deltas, init, out, T, B, stream)``. They are built
with the same nvcc flags into build/torch_kernels/ under other names; the
new ones through ops/gae.py, ops/vtrace.py and ops/rev_scan.py as usual.

Cases: each kernel at its path's shape (GAE [256, 4096], PPO's; V-trace
[32, 1024], IMPALA's; the reverse scan at both, since PPO's and IMPALA's
'assoc' forms launch it) and at one larger shape (64K columns). Both
versions are first held bit for bit against the plain versions. Each
measurement is chip_smoke.py's ``time_cuda_ms`` (CUDA events, L2 flushed,
the card spinning first, median of RUNS calls), in the order old, new,
new, old for each of ROUNDS rounds; beside them the new kernel with L2
warm, the byte bound, one ``copy_`` moving as many bytes, and the launch
floor (a one-element ``fill_``). With ``--sweep``, the new kernel is also
timed, once each, at other tiles and stage lengths than scan_plan's (each
checked bit for bit first). Prints one JSON line per case and a summary
line; needs a card.
"""

from __future__ import annotations

import argparse
import contextlib
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from surreal_tpu_torch.ops import gae as G
from surreal_tpu_torch.ops import rev_scan as RS
from surreal_tpu_torch.ops import vtrace as V
from surreal_tpu_torch.ops.scan_tiles import REV_SCAN_STAGE_BYTES, TILES, ScanPlan, multiprocessors, scan_plan

ROUNDS = 3
RUNS = 30
CLIPS = (1.0, 1.0, 1.0)  # IMPALA's clip levels
SWEEP_STEPS = (1, 2, 4, 8, 16, 20, 32, 64)
MAX_SHARED_BYTES = 232_448  # dynamic shared memory a block can have on Hopper


def build_old(name: str, src: str) -> ctypes.CDLL:
    from surreal_tpu_torch.utils.kernel_build import BUILD_DIR, NVCC_FLAGS, _nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}_old.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), src], check=True)
    return ctypes.CDLL(str(out))


def _stream() -> int:
    return torch.cuda.current_stream().cuda_stream


def old_gae_launch(lib):
    """ops/gae.py's launch function as it was for the old source."""
    fn = lib.gae_masked_f32
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(inputs):
        T, B = inputs[0].shape
        arrs = [x.to(torch.float32).contiguous() for x in inputs]
        adv = torch.empty((T, B), dtype=torch.float32, device=arrs[0].device)
        tgt = torch.empty_like(adv)
        with torch.cuda.device(adv.device):
            err = fn(*(x.data_ptr() for x in arrs), adv.data_ptr(), tgt.data_ptr(), T, B, _stream())
        if err:
            raise RuntimeError(f"old gae: cudaError {err}")
        return adv, tgt

    return launch


def old_vtrace_launch(lib):
    """ops/vtrace.py's launch function as it was for the old source."""
    fn = lib.vtrace_f32
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(inputs, clips):
        T, B = inputs[0].shape
        arrs = [x.detach().to(torch.float32).contiguous() for x in inputs]
        vs = torch.empty((T, B), dtype=torch.float32, device=arrs[0].device)
        pg = torch.empty_like(vs)
        with torch.cuda.device(vs.device):
            err = fn(*(x.data_ptr() for x in arrs), vs.data_ptr(), pg.data_ptr(), T, B, *clips, _stream())
        if err:
            raise RuntimeError(f"old vtrace: cudaError {err}")
        return V.VTraceOutput(vs=vs, pg_advantages=pg)

    return launch


def old_rev_scan_launch(lib):
    """ops/rev_scan.py's launch function as it was for the old source."""
    fn = lib.rev_scan_f32
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def launch(coeffs, deltas, init):
        T, B = deltas.shape
        c, d, x0 = (x.to(torch.float32).contiguous() for x in (coeffs, deltas, init))
        out = torch.empty((T, B), dtype=torch.float32, device=d.device)
        with torch.cuda.device(out.device):
            err = fn(c.data_ptr(), d.data_ptr(), x0.data_ptr(), out.data_ptr(), T, B, _stream())
        if err:
            raise RuntimeError(f"old rev_scan: cudaError {err}")
        return out

    return launch


@contextlib.contextmanager
def old_wrapper(module, launch):
    """Within it, the module's wrapper launches the old kernel: the same
    checks and routing, the old launch code."""
    saved = module._launch
    module._launch = launch
    try:
        yield
    finally:
        module._launch = saved


def in_turns(old, new, flush) -> dict:
    """Card times of ``old`` and ``new``, ROUNDS rounds of old, new, new, old."""
    from chip_smoke import time_cuda_ms

    times = {"old": [], "new": []}
    for _ in range(ROUNDS):
        for name in ("old", "new", "new", "old"):
            times[name].append(time_cuda_ms(old if name == "old" else new, runs=RUNS, flush=flush, spin=True))
    return {**{f"{k}_ms": v for k, v in times.items()},
            **{f"{k}_ms_median": statistics.median(v) for k, v in times.items()},
            "new_faster_in_every_pair_by": min(o / n for o, n in zip(times["old"], times["new"]))}


def copy_ms(n: int, flush) -> float:
    """The card time of one ``copy_`` of ``n`` floats: the same bytes read and
    written as a kernel that reads and writes 2n floats in all, a yardstick
    of how fast one plain elementwise launch moves them."""
    from chip_smoke import time_cuda_ms

    src = torch.rand(n, device="cuda")
    dst = torch.empty_like(src)
    return time_cuda_ms(lambda: dst.copy_(src), runs=RUNS, flush=flush, spin=True)


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--gae", metavar="OLD.cu", help="old csrc/gae.cu to time the GAE kernel against")
    parser.add_argument("--vtrace", metavar="OLD.cu", help="old csrc/vtrace.cu to time the V-trace kernel against")
    parser.add_argument("--rev-scan", metavar="OLD.cu", help="old csrc/rev_scan.cu to time the reverse scan against")
    parser.add_argument("--sweep", action="store_true", help="also time the new kernels at other plans")
    args = parser.parse_args()
    olds = {k: v for k, v in (("gae", args.gae), ("vtrace", args.vtrace), ("rev_scan", args.rev_scan)) if v}
    if not olds:
        parser.error("name at least one old source")
    if not torch.cuda.is_available():
        print("ab_scan_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import H100_BYTES_PER_S, gae_inputs, launch_floor_ms, nvidia_smi, rev_scan_inputs, time_cuda_ms
    from chip_smoke import vtrace_inputs

    smi = nvidia_smi()
    sms = multiprocessors(torch.device("cuda", torch.cuda.current_device()))
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    results = {"device": smi, "rounds": ROUNDS, "runs": RUNS}

    # per kernel: (module, old launch builder, wrapper, plain version, inputs, launch at a given plan,
    # f32 words read and written per element, bytes per batch column, ring arrays, the wrapper's
    # stage budget)
    kernels = {
        "gae": (G, old_gae_launch, G.gae_advantages_masked, G.gae_masked_plain, gae_inputs,
                lambda x, plan: G._launch(x, plan), 7, 0, 5, {}),
        "vtrace": (V, old_vtrace_launch, lambda *x: V.vtrace_fused(*x, *CLIPS),
                   lambda *x: V.vtrace_fused_plain(*x, *CLIPS), vtrace_inputs,
                   lambda x, plan: V._launch(x, CLIPS, plan), 10, 0, 8, {}),
        "rev_scan": (RS, old_rev_scan_launch, lambda *x: (RS.reverse_linear_scan(*x),),
                     lambda *x: (RS.reverse_linear_scan_plain(*x),), rev_scan_inputs,
                     lambda x, plan: (RS._launch(*x, plan),), 3, 4, 2, {"stage_bytes": REV_SCAN_STAGE_BYTES}),
    }
    cases = {
        "gae": [("gae_path", 256, 4096), ("gae_large", 256, 65536)],
        "vtrace": [("vtrace_path", 32, 1024), ("vtrace_large", 32, 65536)],
        "rev_scan": [("rev_scan_ppo", 256, 4096), ("rev_scan_impala", 32, 1024), ("rev_scan_large", 256, 65536)],
    }
    for kernel, src in olds.items():
        module, old_launch, wrapper, plain, make_inputs, launch_with, words, per_b, arrays, budget = kernels[kernel]
        launch = old_launch(build_old(kernel, src))
        for label, T, B in cases[kernel]:
            inputs = make_inputs(T, B, seed=T * 7919 + B, device="cuda")
            want = plain(*inputs)
            new = lambda: wrapper(*inputs)  # noqa: E731

            def old():
                with old_wrapper(module, launch):
                    return wrapper(*inputs)

            for version, out in (("old", old()), ("new", new())):
                torch.cuda.synchronize()
                if not all(torch.equal(g, w) for g, w in zip(out, want)):
                    raise AssertionError(f"{label}: the {version} {kernel} kernel differs from the plain version")
            nbytes = words * 4 * T * B + per_b * B
            results[label] = {
                "shape": [T, B], "plan": scan_plan(T, B, arrays, sms, **budget)._asdict(),
                **in_turns(old, new, flush),
                "new_ms_warm_l2": time_cuda_ms(new, runs=RUNS, flush=None, spin=True),
                "bound_ms": nbytes / H100_BYTES_PER_S * 1e3,
                "copy_same_bytes_ms": copy_ms(nbytes // 8, flush),
            }
            if args.sweep:
                timed = {}
                for tile in TILES:
                    for steps in SWEEP_STEPS:
                        trial = ScanPlan(tile, steps)
                        if trial.shared_bytes(T, arrays) > MAX_SHARED_BYTES:
                            continue
                        got = launch_with(inputs, trial)
                        torch.cuda.synchronize()
                        if not all(torch.equal(g, w) for g, w in zip(got, want)):
                            raise AssertionError(f"{label}: the new kernel at {trial} differs from the plain version")
                        timed[f"{tile}x{steps}"] = time_cuda_ms(lambda p=trial: launch_with(inputs, p), runs=RUNS,
                                                              flush=flush, spin=True)
                results[label]["sweep_ms"] = timed
            print(json.dumps({"case": label, **results[label]}), flush=True)

    results["launch_floor_ms"] = launch_floor_ms(flush)
    print(json.dumps({"summary": {k: ({kk: vv for kk, vv in v.items() if not kk.endswith("_ms") and kk != "sweep_ms"}
                                      if isinstance(v, dict) else v) for k, v in results.items()}}), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
