// Fused V-trace as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel surreal_tpu/ops/pallas_vtrace.py::_vtrace_kernel
// (the pl.pallas_call of _vtrace_call, behind vtrace_nextobs_pallas and
// vtrace_pallas). Same function, all arrays [T, B] row-major float32:
//
//   rho_t  = exp(tl_t - bl_t)
//   delta_t = min(clip_rho, rho_t) * (r_t + boot_t * v_next_t - v_t)
//   acc_t  = delta_t + (edge_t * min(clip_c, rho_t)) * acc_{t+1},  acc_T = 0
//   vs_t   = acc_t + v_t
//   succ_t = done_t * v_next_t + (1 - done_t) * vs_{t+1},  vs_T = v_next_{T-1}
//   pg_t   = min(clip_pg_rho, rho_t) * (r_t + boot_t * succ_t - v_t)
//
// Bound: memory traffic. 8 float32 reads and 2 float32 writes per element,
// 40 B * T * B: about 1.3 MB at T=32, B=1024, so about 0.4 us at the H100
// SXM's 3.35 TB/s. The arithmetic (about 21 operations per element, one of
// them an exp) is smaller still. At that shape what the card can reach is
// the launch itself (about 5 us, L2 flushed) plus one round trip to device
// memory and a 32-step chain.
//
// Design: the ring of csrc/scan_ring.cuh, as in csrc/gae.cu: a block owns
// a tile of 8, 16 or 32 columns, and its copying warp streams the tile's
// slabs of the eight inputs from t = T-1 down into shared-memory stages
// (TMA boxes, or 4 B cp.async where a row is not 16 B-aligned). Four warps
// run each stage in three passes over its slot: the elementwise work that
// needs no carry (rho, delta, the clipped coefficients) spread over all of
// them; the chain (acc and vs) on warp 0, a lane a column, its inputs
// loaded eight steps at a time into registers; then the successor values,
// the pg advantages and the stores, spread again. vs_{t+1} starts from
// v_next[T-1], the last row of the first stage. The tile and the stage
// come from ops/scan_tiles.py::scan_plan: at [32, 1024], 128 blocks of 8
// columns on 132 SMs, each with its whole [32, 8] slab of all eight inputs
// (8 KB) in one stage, so one round trip brings it in.
//
// Rounding: every multiply, add and subtract uses the _rn intrinsics, which
// nvcc never contracts into FMAs, and the products group as written above,
// in the order of the loop per column. rho uses expf, the function
// torch.exp calls for float32 on the card. The kernel therefore rounds
// where the plain PyTorch version in surreal_tpu_torch/ops/vtrace.py rounds,
// and the two agree bit for bit on the card.
//
// Left on the table: at the IMPALA shape the kernel takes about 8 us, under
// 3 us above the 5 us launch floor measured beside it on an H100 (PERF.md):
// the launch, one round trip for the inputs, the three passes (a 32-step
// chain among them) and the stores' drain. Only fusing V-trace into the
// learner's neighbouring launches, or a CUDA graph, goes below the floor.

#include <cuda_runtime.h>

#include "scan_ring.cuh"

namespace {

constexpr int kArrays = 8;  // bl, tl, rewards, boot, edge, v_t, v_next, done
constexpr int kChunk = 8;   // chain steps whose inputs are loaded together
// Warps that run the stages: warp 0 runs the chains, and all of them share
// the elementwise passes, whose latency a single warp would expose in full.
// The warp after them copies.
constexpr int kStageThreads = 4 * 32;
constexpr int kThreads = kStageThreads + 32;

template <int TW, scan_ring::Copy C>
__global__ void __launch_bounds__(kThreads)
    vtrace_kernel(const __grid_constant__ scan_ring::Source<kArrays, C> src, float* __restrict__ vs_out,
                  float* __restrict__ pg_out, int T, int B, int S, float clip_rho, float clip_c,
                  float clip_pg_rho) {
  __shared__ scan_ring::Barriers bars;
  extern __shared__ __align__(128) float ring[];
  const int col0 = blockIdx.x * TW;
  const int ncols = min(TW, B - col0);
  scan_ring::init<C>(bars);
  __syncthreads();
  if (threadIdx.x >= kStageThreads) {
    scan_ring::copy_stages<kArrays, TW, C>(bars, ring, src, T, B, S, col0, ncols);
    return;
  }
  // Each stage in three passes over its slot, in place. The chain pass is
  // the only sequential one, so the other two spread the stage's elements
  // over all the stage threads (row j, column c of element e: j = e / TW,
  // c = e % TW).
  // 1. rho and what depends on it alone: delta over bl, the recursion
  //    coefficient over tl, the pg clip over edge.
  // 2. the chain, a lane a column: acc and vs, vs over delta.
  // 3. the successor value and the pg advantage; vs and pg stored.
  // Every element goes through the operations above in the same order, so
  // the values are those of one thread walking its column.
  __shared__ float above[TW];  // vs_{t+1} of each column's top row in the stage
  const int tid = threadIdx.x;
  const int nstages = (T + S - 1) / S;
  float acc = 0.0f;
  float vs_carry = 0.0f;  // the lane's column: vs of the previous stage's bottom row
#pragma unroll 1
  for (int k = 0; k < nstages; ++k) {
    float* s = scan_ring::acquire<kArrays, TW>(bars, ring, k, S);
    float *bl = s, *tl = s + S * TW, *r = s + 2 * S * TW, *bt = s + 3 * S * TW, *eg = s + 4 * S * TW;
    float *v = s + 5 * S * TW, *vn = s + 6 * S * TW, *d = s + 7 * S * TW;
    const scan_ring::Span span = scan_ring::stage_span(k, T, S);
    const int e0 = span.first * TW, e1 = S * TW;
#pragma unroll 2
    for (int e = e0 + tid; e < e1; e += kStageThreads) {
      const float rho = expf(__fsub_rn(tl[e], bl[e]));
      bl[e] = __fmul_rn(fminf(clip_rho, rho), __fsub_rn(__fadd_rn(r[e], __fmul_rn(bt[e], vn[e])), v[e]));
      tl[e] = __fmul_rn(eg[e], fminf(clip_c, rho));
      eg[e] = fminf(clip_pg_rho, rho);
    }
    scan_ring::sync_stage_threads<kStageThreads>();
    if (tid < ncols) {
      if (k == 0) vs_carry = vn[(S - 1) * TW + tid];  // v_next[T-1]
      above[tid] = vs_carry;
      // kChunk rows at a time: their loads first, then the chain on registers
#pragma unroll 1
      for (int top = S - 1; top >= span.first; top -= kChunk) {
        float delta[kChunk], coef[kChunk], value[kChunk];
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          const int e = (top - u) * TW + tid;
          if (top - u >= span.first) delta[u] = bl[e], coef[u] = tl[e], value[u] = v[e];
        }
#pragma unroll
        for (int u = 0; u < kChunk; ++u) {
          if (top - u >= span.first) {
            acc = __fadd_rn(delta[u], __fmul_rn(coef[u], acc));
            bl[(top - u) * TW + tid] = __fadd_rn(acc, value[u]);
          }
        }
      }
      vs_carry = bl[e0 + tid];
    }
    scan_ring::sync_stage_threads<kStageThreads>();
#pragma unroll 2
    for (int e = e0 + tid; e < e1; e += kStageThreads) {
      const int j = e / TW, c = e % TW;
      if (c < ncols) {
        const float vs_next = j == S - 1 ? above[c] : bl[e + TW];
        const float succ = __fadd_rn(__fmul_rn(d[e], vn[e]), __fmul_rn(__fsub_rn(1.0f, d[e]), vs_next));
        const size_t i = static_cast<size_t>(span.base + j) * B + col0 + c;
        vs_out[i] = bl[e];
        pg_out[i] = __fmul_rn(eg[e], __fsub_rn(__fadd_rn(r[e], __fmul_rn(bt[e], succ)), v[e]));
      }
    }
    scan_ring::release<kStageThreads>(bars, k);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success), or
// the error of allowing the ring's shared memory or of encoding the tensor
// maps, or cudaErrorInvalidValue for a tile other than 8, 16 or 32 or a
// stage length below 1. Pointers are device pointers to contiguous [T, B]
// float32 arrays, in the order (bl, tl, rewards, boot, edge, v_t, v_next,
// done, vs, pg); `tile` columns a block, `steps` timesteps a stage
// (ops/scan_tiles.py::scan_plan).
extern "C" int vtrace_f32(const void* bl, const void* tl, const void* rewards, const void* boot,
                          const void* edge, const void* v_t, const void* v_next, const void* done, void* vs,
                          void* pg, int T, int B, float clip_rho, float clip_c, float clip_pg_rho, void* stream,
                          int tile, int steps) {
  const float* const inputs[kArrays] = {
      static_cast<const float*>(bl),   static_cast<const float*>(tl),  static_cast<const float*>(rewards),
      static_cast<const float*>(boot), static_cast<const float*>(edge), static_cast<const float*>(v_t),
      static_cast<const float*>(v_next), static_cast<const float*>(done)};
  return scan_ring::dispatch<kArrays>(inputs, T, B, tile, steps, [&](auto tw, const auto& src) {
    constexpr int TW = decltype(tw)::value;
    constexpr scan_ring::Copy C = std::remove_reference_t<decltype(src)>::kCopy;
    const size_t smem = scan_ring::ring_bytes(kArrays, T, steps, TW);
    const cudaError_t err = scan_ring::reserve_shared<vtrace_kernel<TW, C>>(smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    vtrace_kernel<TW, C><<<(B + TW - 1) / TW, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
        src, static_cast<float*>(vs), static_cast<float*>(pg), T, B, steps, clip_rho, clip_c, clip_pg_rho);
    return static_cast<int>(cudaGetLastError());
  });
}
