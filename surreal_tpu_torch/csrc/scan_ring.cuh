// A ring of shared-memory stages for reverse-time scans over [T, B] arrays,
// shared by csrc/gae.cu, csrc/vtrace.cu and csrc/rev_scan.cu.
//
// A block owns a tile of TW batch columns (TW = 8, 16 or 32: each array's
// row segment is one to four whole 32 B sectors) and walks time from
// t = T-1 down to 0 in stages of S timesteps. Stage k covers the timesteps
// base + j for j in [first, S), where base = T - (k+1)*S and first =
// max(0, -base): every stage but the last is whole, and the last one is cut
// on the t = 0 side. kStages slots of shared memory hold the stages in
// turn; a slot is [NA][S][TW] floats, its row j timestep base + j.
//
// Two jobs in a block. Its last warp copies: it fills the slots ahead and
// has each stage's copies arrive on the slot's "full" mbarrier as they
// land. The warps before it run the stages: they wait for a slot to be
// full, run the stage's timesteps (warp 0 the chains, a lane a column),
// store the outputs, and arrive on the slot's "empty" mbarrier, which the
// copying warp waits for before it refills the slot. So kStages - 1 stages
// stay in flight while the chains run, and the stores never hold up the
// copies (with one warp doing both, each stage cost about a round trip to
// memory on an H100).
//
// Two ways to copy, chosen per launch by the C entry points:
// - TMA (kTma): one lane issues, per stage, one 2-D tensor copy of a
//   [S, TW] box per array, with the stage's bytes expected on the full
//   barrier. It needs 16 B-aligned rows (B % 4 == 0, 16 B-aligned bases)
//   and a tensor no smaller than the box; boxes that reach past column B or
//   before t = 0 are filled with zeros, which no thread reads.
// - cp.async (kCpAsync), every other shape: the 32 lanes copy the stage's
//   rows 4 B at a time, and each lane's copies arrive on the full barrier
//   when they land (cp.async.mbarrier.arrive.noinc). On an H100 a warp's
//   cp.async, even 16 B a lane, moved a short stage in about a round trip,
//   where TMA boxes kept the stages streaming (PERF.md).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>
#include <type_traits>

namespace scan_ring {

constexpr int kStages = 8;  // slots in the ring

enum Copy { kCpAsync, kTma };

// Where the input arrays are, passed by value as a __grid_constant__ kernel
// parameter: their base pointers for cp.async (a loop over them indexes the
// parameter bank instead of unrolling into a copy of the loop per array),
// or a tensor map each for TMA.
template <int NA, Copy C>
struct Source {
  static constexpr Copy kCopy = C;
  const float* p[NA];
};

template <int NA>
struct Source<NA, kTma> {
  static constexpr Copy kCopy = kTma;
  CUtensorMap map[NA];
};

struct Barriers {
  uint64_t full[kStages];   // the stage's copies landed
  uint64_t empty[kStages];  // the stage threads are done with the slot
};

struct Span {
  int base, first;  // row j of the slot is timestep base + j, for j >= first
};

__device__ __forceinline__ Span stage_span(int k, int T, int S) {
  const int base = T - (k + 1) * S;
  return {base, base < 0 ? -base : 0};
}

__device__ __forceinline__ unsigned shared_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The ring's shared memory: a slot per stage, kStages at most.
inline size_t ring_bytes(int NA, int T, int S, int TW) {
  const int nstages = (T + S - 1) / S;
  return sizeof(float) * (nstages < kStages ? nstages : kStages) * NA * S * TW;
}

template <int NA, int TW>
__device__ __forceinline__ float* slot(float* ring, int k, int S) {
  return ring + static_cast<size_t>(k % kStages) * NA * S * TW;
}

__device__ __forceinline__ void wait_phase(uint64_t* bar, int parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(shared_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Sets up the barriers; the caller then __syncthreads() before any use. A
// full barrier takes one arrival from the TMA lane, or one from each of the
// 32 copying lanes.
template <Copy C>
__device__ __forceinline__ void init(Barriers& bars) {
  constexpr int kFullArrivals = C == kTma ? 1 : 32;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(shared_addr(&bars.full[s])), "n"(kFullArrivals)
                   : "memory");
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(shared_addr(&bars.empty[s])) : "memory");
    }
  }
}

// The copying warp's whole job: every stage of the tile at column col0
// (ncols columns of it lie before B), each into its slot once the stage
// threads have released the slot's previous stage. The loops stay rolled, to
// keep the kernel's code small: the timing flushes L2, so a cold
// instruction comes from device memory.
template <int NA, int TW, Copy C>
__device__ __forceinline__ void copy_stages(Barriers& bars, float* ring, const Source<NA, C>& src, int T, int B,
                                            int S, int col0, int ncols) {
  const int lane = threadIdx.x % 32;
  const int nstages = (T + S - 1) / S;
#pragma unroll 1
  for (int k = 0; k < nstages; ++k) {
    if (k >= kStages) wait_phase(&bars.empty[k % kStages], (k / kStages - 1) & 1);
    const Span s = stage_span(k, T, S);
    float* dst = slot<NA, TW>(ring, k, S);
    const unsigned full = shared_addr(&bars.full[k % kStages]);
    if constexpr (C == kTma) {
      if (lane == 0) {
        asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(full),
                     "r"(static_cast<unsigned>(sizeof(float) * NA * S * TW))
                     : "memory");
#pragma unroll 1
        for (int a = 0; a < NA; ++a) {
          asm volatile(
              "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
              " [%0], [%1, {%2, %3}], [%4];\n"
              ::"r"(shared_addr(dst + a * S * TW)), "l"(&src.map[a]), "r"(col0), "r"(s.base), "r"(full)
              : "memory");
        }
      }
    } else {
      const int n = (S - s.first) * TW;
#pragma unroll 1
      for (int a = 0; a < NA; ++a) {
        const float* from = src.p[a] + static_cast<ptrdiff_t>(s.base + s.first) * B + col0;
        float* to = dst + (a * S + s.first) * TW;
#pragma unroll 1
        for (int i = lane; i < n; i += 32) {
          const int j = i / TW;
          const int c = i % TW;
          if (c < ncols) {
            asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(shared_addr(to + i)),
                         "l"(from + static_cast<size_t>(j) * B + c)
                         : "memory");
          }
        }
      }
      asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(full) : "memory");
    }
  }
  if constexpr (C == kCpAsync) asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// The chain warp's side: stage k's slot, once every copy into it landed.
template <int NA, int TW>
__device__ __forceinline__ float* acquire(Barriers& bars, float* ring, int k, int S) {
  wait_phase(&bars.full[k % kStages], (k / kStages) & 1);
  return slot<NA, TW>(ring, k, S);
}

// Waits for the block's first N threads, the warps that run the stages
// (named barrier 1, which the copying warp never joins).
template <int N>
__device__ __forceinline__ void sync_stage_threads() {
  if constexpr (N == 32) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;\n" ::"n"(N) : "memory");
  }
}

// The N threads that run the stages are done with stage k's slot: the
// copying warp may refill it.
template <int N>
__device__ __forceinline__ void release(Barriers& bars, int k) {
  sync_stage_threads<N>();
  if (threadIdx.x == 0) {
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(shared_addr(&bars.empty[k % kStages])) : "memory");
  }
}

// ---- host side ---------------------------------------------------------

// cuTensorMapEncodeTiled, reached through the runtime, so that the library
// needs no link to libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// Whether TMA can copy these [T, B] arrays in [S, TW] boxes: rows and bases
// 16 B-aligned, a box no larger than the tensor, and every box's place in
// the ring 128 B-aligned.
inline bool tma_fits(const float* const* arrays, int NA, int T, int B, int S, int TW) {
  bool fits = B % 4 == 0 && B >= TW && T >= S && S * TW % 32 == 0 && encode_tiled() != nullptr;
  for (int a = 0; a < NA; ++a) fits = fits && reinterpret_cast<size_t>(arrays[a]) % 16 == 0;
  return fits;
}

// One tensor map per [T, B] float32 array, with a [S, TW] box.
template <int NA>
cudaError_t encode(Source<NA, kTma>& src, const float* const* arrays, int T, int B, int S, int TW) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(B), static_cast<cuuint64_t>(T)};
  const cuuint64_t row_bytes[1] = {static_cast<cuuint64_t>(B) * sizeof(float)};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(TW), static_cast<cuuint32_t>(S)};
  const cuuint32_t unit[2] = {1, 1};
  for (int a = 0; a < NA; ++a) {
    const CUresult r = encode_tiled()(&src.map[a], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(arrays[a]),
                                      dims, row_bytes, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                                      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                                      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// Dynamic shared memory above 48 KB must be allowed for each kernel before
// its launch; this allows it once per kernel (on the current device) and
// returns the error of the attempt.
template <auto Kernel>
cudaError_t reserve_shared(size_t bytes) {
  static size_t allowed = 48 * 1024;
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(Kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

// Calls launch(tw, src) for the plan's tile (8, 16 or 32, as a
// std::integral_constant) and the copy these arrays allow (src a filled
// Source<NA, kTma> or Source<NA, kCpAsync>). Returns cudaErrorInvalidValue
// for any other tile or a stage length below 1.
template <int NA, typename Launch>
int dispatch(const float* const* arrays, int T, int B, int tile, int steps, Launch&& launch) {
  if (steps < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto with_copy = [&](auto tw) {
    constexpr int TW = decltype(tw)::value;
    if (tma_fits(arrays, NA, T, B, steps, TW)) {
      Source<NA, kTma> src;
      const cudaError_t err = encode<NA>(src, arrays, T, B, steps, TW);
      return err != cudaSuccess ? static_cast<int>(err) : launch(tw, src);
    }
    Source<NA, kCpAsync> src;
    for (int a = 0; a < NA; ++a) src.p[a] = arrays[a];
    return launch(tw, src);
  };
  switch (tile) {
    case 8: return with_copy(std::integral_constant<int, 8>{});
    case 16: return with_copy(std::integral_constant<int, 16>{});
    case 32: return with_copy(std::integral_constant<int, 32>{});
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace scan_ring
