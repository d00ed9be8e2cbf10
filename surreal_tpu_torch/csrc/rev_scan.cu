// Reverse linear recurrence as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel surreal_tpu/ops/pallas_returns.py::_rev_scan_kernel
// (the pl.pallas_call of reverse_linear_scan_pallas, which
// discounted_returns_pallas also calls). Same function, arrays [T, B]
// row-major float32, init [B]:
//
//   x_t = deltas_t + coeffs_t * x_{t+1},   x_T = init
//
// It is the recurrence of every return estimator: the port's 'assoc' GAE
// and V-trace (ops/returns.py::reverse_linear_scan_assoc) solve theirs with
// it, and discounted_returns seeds it with the bootstrap value.
//
// Bound: memory traffic. Two f32 reads and one f32 write per element plus
// init: 12 B * T * B + 4 B * B, about 12.6 MB at T=256, B=4096, so about
// 3.8 us at the H100 SXM's 3.35 TB/s. Two flops per element are negligible,
// and so is the chain itself: two dependent operations a step.
//
// Design: GAE's (csrc/gae.cu), on the ring of csrc/scan_ring.cuh. A block
// owns a tile of 8, 16 or 32 columns; its copying warp streams the tile's
// [T, tile] slabs of coeffs and deltas from t = T-1 down, a stage of S
// timesteps at a time, into eight shared-memory slots (a TMA box per array
// and stage, or 4 B cp.async where a row is not 16 B-aligned); warp 0 runs
// the chains, a lane a column, with the carry in a register seeded from
// init (read once, while the first stages are in flight). The chain loads
// eight steps' inputs from the slot into registers, then runs those steps
// and stores each x from the register, coalesced across the tile. The tile
// and S come from ops/scan_tiles.py::scan_plan with 8 KB stages: at
// [256, 4096], 128 blocks of 32 columns on 132 SMs and stages of 32
// timesteps, so the 64 KB ring holds the whole T and every load is issued
// at once; at [32, 1024], 128 blocks of 8 columns and the whole T in one
// stage. Measured on an H100 at [256, 4096] (PERF.md, ab_scan_kernels.py):
// 11.7 us, against 12.6 us in 5 KB stages of 20 timesteps and 10.1 us for
// a copy_ of the same bytes; a first build that loaded each step's inputs
// only as its step came was slower at every stage length. The first port (one thread a column, each step's loads
// issued after the previous step's carry) took about 27 us there.
//
// Rounding: __fmul_rn and __fadd_rn, which nvcc never contracts into an
// FMA, in the order above, per column, so the kernel rounds exactly where
// the plain PyTorch version in surreal_tpu_torch/ops/rev_scan.py rounds,
// and the two agree bit for bit on the card.

#include <cuda_runtime.h>

#include "scan_ring.cuh"

namespace {

constexpr int kArrays = 2;    // coeffs, deltas
constexpr int kThreads = 64;  // warp 0 runs the chains, warp 1 copies
constexpr int kGroup = 8;     // chain steps whose inputs are loaded together

template <int TW, scan_ring::Copy C>
__global__ void __launch_bounds__(kThreads)
    rev_scan_kernel(const __grid_constant__ scan_ring::Source<kArrays, C> src, const float* __restrict__ init,
                    float* __restrict__ out, int T, int B, int S) {
  __shared__ scan_ring::Barriers bars;
  extern __shared__ __align__(128) float ring[];
  const int col0 = blockIdx.x * TW;
  const int ncols = min(TW, B - col0);
  scan_ring::init<C>(bars);
  __syncthreads();
  if (threadIdx.x >= 32) {
    scan_ring::copy_stages<kArrays, TW, C>(bars, ring, src, T, B, S, col0, ncols);
    return;
  }
  const int lane = threadIdx.x;
  const int b = col0 + lane;
  const int nstages = (T + S - 1) / S;
  float acc = lane < ncols ? init[b] : 0.0f;
#pragma unroll 1
  for (int k = 0; k < nstages; ++k) {
    const float* s = scan_ring::acquire<kArrays, TW>(bars, ring, k, S) + lane;
    if (lane < ncols) {
      const scan_ring::Span span = scan_ring::stage_span(k, T, S);
      // a group of kGroup steps' inputs is loaded before its chain runs, so
      // the chain waits on shared memory once a group, not once a step
      float* o = out + static_cast<ptrdiff_t>(span.base + S - 1) * B + b;
      int j = S - 1;
#pragma unroll 1
      for (; j - kGroup + 1 >= span.first; j -= kGroup) {
        float c[kGroup], d[kGroup];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) c[u] = s[(j - u) * TW], d[u] = s[(S + j - u) * TW];
#pragma unroll
        for (int u = 0; u < kGroup; ++u) {
          acc = __fadd_rn(d[u], __fmul_rn(c[u], acc));
          *o = acc;
          o -= B;
        }
      }
#pragma unroll 1
      for (; j >= span.first; --j) {
        acc = __fadd_rn(s[(S + j) * TW], __fmul_rn(s[j * TW], acc));
        *o = acc;
        o -= B;
      }
    }
    scan_ring::release<32>(bars, k);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// the error of allowing the ring's shared memory or of encoding the tensor
// maps, or cudaErrorInvalidValue for a tile other than 8, 16 or 32 or a
// stage length below 1. Pointers are device pointers to contiguous float32
// arrays: coeffs, deltas and out [T, B], init [B]; `tile` columns a block,
// `steps` timesteps a stage (ops/scan_tiles.py::scan_plan).
extern "C" int rev_scan_f32(const void* coeffs, const void* deltas, const void* init, void* out, int T, int B,
                            void* stream, int tile, int steps) {
  const float* const inputs[kArrays] = {static_cast<const float*>(coeffs), static_cast<const float*>(deltas)};
  return scan_ring::dispatch<kArrays>(inputs, T, B, tile, steps, [&](auto tw, const auto& src) {
    constexpr int TW = decltype(tw)::value;
    constexpr scan_ring::Copy C = std::remove_reference_t<decltype(src)>::kCopy;
    const size_t smem = scan_ring::ring_bytes(kArrays, T, steps, TW);
    const cudaError_t err = scan_ring::reserve_shared<rev_scan_kernel<TW, C>>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    rev_scan_kernel<TW, C><<<(B + TW - 1) / TW, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        src, static_cast<const float*>(init), static_cast<float*>(out), T, B, steps);
    return static_cast<int>(cudaGetLastError());
  });
}
