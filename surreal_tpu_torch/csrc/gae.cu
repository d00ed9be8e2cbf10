// Truncation-exact GAE as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel surreal_tpu/ops/pallas_gae.py::_gae_kernel (the
// pl.pallas_call of gae_advantages_pallas_masked). Same function, all
// arrays [T, B] row-major float32:
//
//   delta_t  = r_t + boot_t * v_next_t - v_t
//   acc_t    = delta_t + decay_t * acc_{t+1},   acc_T = 0
//   adv_t    = acc_t,   target_t = acc_t + v_t
//
// Bound: memory traffic. 5 float32 reads and 2 float32 writes per element,
// 28 B * T * B: about 29.4 MB at T=256, B=4096, so about 8.8 us at the
// H100 SXM's 3.35 TB/s. The arithmetic (6 flops per element) is negligible,
// and so is the order of the chain: two dependent operations a step.
//
// Design: what limited the first port (one thread a column, each step's
// loads issued after the previous step's carry, 0.44 us a step) was the
// loads in flight, not the chain. So the chain keeps its order and the
// loads run ahead of it, through the ring of csrc/scan_ring.cuh: a block
// owns a tile of 8, 16 or 32 columns; its copying warp streams the tile's
// [T, tile] slabs of the five inputs from t = T-1 down, a stage of S
// timesteps at a time, into eight shared-memory slots (a TMA box per array
// and stage, or 4 B cp.async where a row is not 16 B-aligned); warp 0 runs
// the chains, a lane a column with the carry in a register, and stores
// both outputs from registers at every step, coalesced across the tile.
// The tile and S come from ops/scan_tiles.py::scan_plan: at [256, 4096],
// 128 blocks of 32 columns on 132 SMs, stages of 8 timesteps, 40 KB of
// ring a block, seven stages in flight.
//
// Rounding: every multiply and add uses the _rn intrinsics, which nvcc never
// contracts into FMAs, in the order of the loop above, per column. The
// kernel therefore rounds exactly where the plain PyTorch version in
// surreal_tpu_torch/ops/gae.py rounds, and the two agree bit for bit on the
// card. A chunked two-pass scan would reassociate the sum and lose that.
//
// Left on the table: measured on an H100 (PERF.md), the kernel takes about
// 19 us at the path shape against the 8.8 us bound: it moves its 29.4 MB
// about as fast as a plain elementwise kernel moving the same bytes, and
// with L2 flushed before each call about 5 us of that is the launch itself.
// Splitting the stage into an elementwise pass over four warps and a chain
// pass (as csrc/vtrace.cu does) made GAE slower; the chain lane's stores
// are not what holds it back.

#include <cuda_runtime.h>

#include "scan_ring.cuh"

namespace {

constexpr int kArrays = 5;   // rewards, boot, decay, v_t, v_next
constexpr int kThreads = 64;  // warp 0 runs the chains, warp 1 copies

template <int TW, scan_ring::Copy C>
__global__ void __launch_bounds__(kThreads)
    gae_masked_kernel(const __grid_constant__ scan_ring::Source<kArrays, C> src, float* __restrict__ adv,
                      float* __restrict__ target, int T, int B, int S) {
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
  float acc = 0.0f;
#pragma unroll 1
  for (int k = 0; k < nstages; ++k) {
    const float* s = scan_ring::acquire<kArrays, TW>(bars, ring, k, S) + lane;
    if (lane < ncols) {
      const scan_ring::Span span = scan_ring::stage_span(k, T, S);
#pragma unroll 4
      for (int j = S - 1; j >= span.first; --j) {
        const float r = s[(0 * S + j) * TW];
        const float bt = s[(1 * S + j) * TW];
        const float dc = s[(2 * S + j) * TW];
        const float v = s[(3 * S + j) * TW];
        const float vn = s[(4 * S + j) * TW];
        const float delta = __fsub_rn(__fadd_rn(r, __fmul_rn(bt, vn)), v);
        acc = __fadd_rn(delta, __fmul_rn(dc, acc));
        const size_t i = static_cast<size_t>(span.base + j) * B + b;
        adv[i] = acc;
        target[i] = __fadd_rn(acc, v);
      }
    }
    scan_ring::release<32>(bars, k);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// the error of allowing the ring's shared memory or of encoding the tensor
// maps, or cudaErrorInvalidValue for a tile other than 8, 16 or 32 or a
// stage length below 1. Pointers are device pointers to contiguous [T, B]
// float32 arrays; `tile` columns a block, `steps` timesteps a stage
// (ops/scan_tiles.py::scan_plan).
extern "C" int gae_masked_f32(const void* rewards, const void* boot, const void* decay, const void* v_t,
                              const void* v_next, void* adv, void* target, int T, int B, void* stream,
                              int tile, int steps) {
  const float* const inputs[kArrays] = {static_cast<const float*>(rewards), static_cast<const float*>(boot),
                                        static_cast<const float*>(decay), static_cast<const float*>(v_t),
                                        static_cast<const float*>(v_next)};
  return scan_ring::dispatch<kArrays>(inputs, T, B, tile, steps, [&](auto tw, const auto& src) {
    constexpr int TW = decltype(tw)::value;
    constexpr scan_ring::Copy C = std::remove_reference_t<decltype(src)>::kCopy;
    const size_t smem = scan_ring::ring_bytes(kArrays, T, steps, TW);
    const cudaError_t err = scan_ring::reserve_shared<gae_masked_kernel<TW, C>>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    gae_masked_kernel<TW, C><<<(B + TW - 1) / TW, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        src, static_cast<float*>(adv), static_cast<float*>(target), T, B, steps);
    return static_cast<int>(cudaGetLastError());
  });
}
