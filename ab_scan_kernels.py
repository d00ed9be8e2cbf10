"""Time the GAE and V-trace kernels (csrc/gae.cu, csrc/vtrace.cu) against
older versions of the same sources, in turns, on one CUDA card.

    git show 5c55276:surreal_tpu_torch/csrc/gae.cu > build/gae_old.cu
    git show 5c55276:surreal_tpu_torch/csrc/vtrace.cu > build/vtrace_old.cu
    python3 ab_scan_kernels.py build/gae_old.cu build/vtrace_old.cu [--sweep]

The old sources are the one-thread-a-column design, whose C entry points
took no plan: ``gae_masked_f32(r, boot, decay, v_t, v_next, adv, target,
T, B, stream)`` and ``vtrace_f32(bl, tl, r, boot, edge, v_t, v_next, done,
vs, pg, T, B, clip_rho, clip_c, clip_pg_rho, stream)``. They are built
with the same nvcc flags into build/torch_kernels/ under other names; the
new ones through ops/gae.py and ops/vtrace.py as usual.

Cases: each kernel at its path's shape (GAE [256, 4096], PPO's; V-trace
[32, 1024], IMPALA's) and at one larger shape (64K columns). Both versions
are first held bit for bit against the plain versions. Each measurement
is chip_smoke.py's ``time_cuda_ms`` (CUDA events, L2 flushed, the card
spinning first, median of RUNS calls), in the order old, new, new, old for
each of ROUNDS rounds; beside them the new kernel with L2 warm, the byte
bound, one ``copy_`` moving as many bytes, and the launch floor (a
one-element ``fill_``). With ``--sweep``,
the new kernel is also timed, once each, at other tiles and stage lengths
than scan_plan's (each checked bit for bit first). Prints one JSON line
per case and a summary line; needs a card.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import statistics
import subprocess
import sys

import torch

from surreal_tpu_torch.ops import gae as G
from surreal_tpu_torch.ops import vtrace as V
from surreal_tpu_torch.ops.scan_tiles import TILES, ScanPlan, multiprocessors, scan_plan

ROUNDS = 3
RUNS = 30
CLIPS = (1.0, 1.0, 1.0)  # IMPALA's clip levels
SWEEP_STEPS = (1, 2, 4, 8, 16, 32)
MAX_SHARED_BYTES = 232_448  # dynamic shared memory a block can have on Hopper


def build_old(name: str, src: str) -> ctypes.CDLL:
    from surreal_tpu_torch.utils.kernel_build import BUILD_DIR, NVCC_FLAGS, _nvcc

    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}_old.so"
    subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(out), src], check=True)
    return ctypes.CDLL(str(out))


def old_launches(gae_lib, vtrace_lib):
    """The launch functions of ops/gae.py and ops/vtrace.py as they were
    for the old sources (their C interface), for :func:`old_wrappers`."""
    gae_fn, vtrace_fn = gae_lib.gae_masked_f32, vtrace_lib.vtrace_f32
    gae_fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    vtrace_fn.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 3 + [ctypes.c_void_p]
    )
    gae_fn.restype = vtrace_fn.restype = ctypes.c_int

    def launch_gae(inputs):
        T, B = inputs[0].shape
        arrs = [x.to(torch.float32).contiguous() for x in inputs]
        adv = torch.empty((T, B), dtype=torch.float32, device=arrs[0].device)
        tgt = torch.empty_like(adv)
        with torch.cuda.device(adv.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = gae_fn(*(x.data_ptr() for x in arrs), adv.data_ptr(), tgt.data_ptr(), T, B, stream)
        if err:
            raise RuntimeError(f"old gae: cudaError {err}")
        return adv, tgt

    def launch_vtrace(inputs, clips):
        T, B = inputs[0].shape
        arrs = [x.detach().to(torch.float32).contiguous() for x in inputs]
        vs = torch.empty((T, B), dtype=torch.float32, device=arrs[0].device)
        pg = torch.empty_like(vs)
        with torch.cuda.device(vs.device):
            stream = torch.cuda.current_stream().cuda_stream
            err = vtrace_fn(*(x.data_ptr() for x in arrs), vs.data_ptr(), pg.data_ptr(), T, B, *clips, stream)
        if err:
            raise RuntimeError(f"old vtrace: cudaError {err}")
        return V.VTraceOutput(vs=vs, pg_advantages=pg)

    return launch_gae, launch_vtrace


@contextlib.contextmanager
def old_wrappers(launches):
    """Within it, the GAE and V-trace wrappers launch the old kernels: the
    same checks and routing, the old launch code."""
    saved = G._launch, V._launch
    G._launch, V._launch = launches
    try:
        yield
    finally:
        G._launch, V._launch = saved


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
    args = [a for a in sys.argv[1:] if a != "--sweep"]
    sweep = "--sweep" in sys.argv[1:]
    if len(args) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("ab_scan_kernels: needs a CUDA card", file=sys.stderr)
        return 2
    from chip_smoke import H100_BYTES_PER_S, gae_inputs, launch_floor_ms, nvidia_smi, time_cuda_ms, vtrace_inputs

    launches = old_launches(build_old("gae", args[0]), build_old("vtrace", args[1]))
    smi = nvidia_smi()
    sms = multiprocessors(torch.device("cuda", torch.cuda.current_device()))
    flush = torch.empty(128 * 2**20, dtype=torch.uint8, device="cuda")
    results = {"device": smi, "rounds": ROUNDS, "runs": RUNS}

    # (wrapper, plain version, inputs, launch at a given plan, f32 words read and written per element)
    kernels = {
        "gae": (G.gae_advantages_masked, G.gae_masked_plain, gae_inputs, lambda x, plan: G._launch(x, plan), 7),
        "vtrace": (lambda *x: V.vtrace_fused(*x, *CLIPS), lambda *x: V.vtrace_fused_plain(*x, *CLIPS),
                   vtrace_inputs, lambda x, plan: V._launch(x, CLIPS, plan), 10),
    }
    cases = [("gae_path", "gae", 256, 4096), ("gae_large", "gae", 256, 65536),
             ("vtrace_path", "vtrace", 32, 1024), ("vtrace_large", "vtrace", 32, 65536)]
    for label, kernel, T, B in cases:
        wrapper, plain, make_inputs, launch_with, words = kernels[kernel]
        inputs = make_inputs(T, B, seed=T * 7919 + B, device="cuda")
        want = plain(*inputs)
        new = lambda: wrapper(*inputs)  # noqa: E731

        def old():
            with old_wrappers(launches):
                return wrapper(*inputs)

        for version, out in (("old", old()), ("new", new())):
            torch.cuda.synchronize()
            if not all(torch.equal(g, w) for g, w in zip(out, want)):
                raise AssertionError(f"{label}: the {version} {kernel} kernel differs from the plain version")
        plan = scan_plan(T, B, len(inputs), sms)
        results[label] = {
            "shape": [T, B], "plan": plan._asdict(),
            **in_turns(old, new, flush),
            "new_ms_warm_l2": time_cuda_ms(new, runs=RUNS, flush=None, spin=True),
            "bound_ms": words * 4 * T * B / H100_BYTES_PER_S * 1e3,
            "copy_same_bytes_ms": copy_ms(words * T * B // 2, flush),
        }
        if sweep:
            timed = {}
            for tile in TILES:
                for steps in SWEEP_STEPS:
                    trial = ScanPlan(tile, steps)
                    if trial.shared_bytes(T, len(inputs)) > MAX_SHARED_BYTES:
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
