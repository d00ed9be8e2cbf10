// Replay row gather and priority scatter as CUDA kernels for Hopper (sm_90a).
//
// Replaces the two TPU kernels of surreal_tpu/ops/pallas_replay.py:
//
//   replay_gather   <- _copy_row_kernel     (gather_rows_pallas):
//                      out_leaf[i] = storage_leaf[idx[i]] for every leaf
//   replay_scatter  <- _scatter_row_kernel  (scatter_rows_pallas):
//                      dest[idx[i]] = updates[i], in place, the LAST i that
//                      names a row winning, as the Pallas grid order does
//
// Both copy bytes verbatim, so any dtype is bit-exact (f32, bf16, ints).
//
// Gather design: one launch moves every leaf of the replay dict. Up to
// kMaxLeaves (src, dst, row bytes) triples travel by value in the kernel's
// argument struct, so there is no pointer table to copy to the device
// first. Each leaf is cut into copy units of 4, 2 or 1 bytes (the widest
// that divides its row size and both base pointers; obs rows of 17 f32 are
// 68 B, 4-byte units; bf16 obs rows of 34 B take 2-byte units), and a
// grid-stride loop walks the flattened (leaf, row, unit) space, so
// neighbouring threads copy neighbouring units of one row. The TPU kernel
// instead issued one (1, F)-row DMA per grid step with F padded to 128
// lanes; Hopper has no counterpart to the padding and needs none.
//
// Scatter design: one thread per (update row, unit). A thread writes only
// if no later update row names the same destination row: a linear scan of
// idx[i+1:], n^2 / 2 comparisons at most (32,640 at n = 256, all from L1).
// A plain parallel scatter (index_put_, index_copy_) leaves the winner
// among duplicate indices unspecified; this rule makes it the last one.
//
// Bounds: data movement. The gather at the DDPG path's shape (256 rows of
// 160 B over five leaves) reads and writes 81,920 B plus 1,024 B of idx,
// about 0.025 us at 3.35 TB/s; the scatter of 256 f32 priorities 3,072 B.
// Both are far below one launch's latency, so they are latency-bound, and
// this simple design spends nothing on vector widths or prefetching.
//
// Indices are int32 (as the Pallas kernels take them). A row index outside
// [0, capacity) is never dereferenced: the gather writes zeros for it and
// the scatter skips it. The wrappers in ops/replay_rows.py check indices on
// the host where they are on the host; on the card they are not read back.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxLeaves = 8;
constexpr int kThreads = 256;
constexpr int kMaxBlocks = 132 * 8;  // a few waves of blocks on 132 SMs

struct GatherArgs {
  const unsigned char* src[kMaxLeaves];
  unsigned char* dst[kMaxLeaves];
  int units_per_row[kMaxLeaves];
  int unit[kMaxLeaves];            // bytes per copy unit: 4, 2 or 1
  long long row_bytes[kMaxLeaves];
  long long start[kMaxLeaves + 1];  // first flat work item of each leaf
  int num_leaves;
};

__device__ __forceinline__ void copy_unit(unsigned char* dst, const unsigned char* src, int unit) {
  if (unit == 4) {
    *reinterpret_cast<uint32_t*>(dst) = *reinterpret_cast<const uint32_t*>(src);
  } else if (unit == 2) {
    *reinterpret_cast<uint16_t*>(dst) = *reinterpret_cast<const uint16_t*>(src);
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void zero_unit(unsigned char* dst, int unit) {
  if (unit == 4) {
    *reinterpret_cast<uint32_t*>(dst) = 0u;
  } else if (unit == 2) {
    *reinterpret_cast<uint16_t*>(dst) = 0;
  } else {
    *dst = 0;
  }
}

__global__ void gather_kernel(const GatherArgs a, const int* __restrict__ idx, long long capacity) {
  const long long total = a.start[a.num_leaves];
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < total;
       g += stride) {
    int leaf = 0;
    while (g >= a.start[leaf + 1]) ++leaf;
    const long long local = g - a.start[leaf];
    const int upr = a.units_per_row[leaf];
    const long long row = local / upr;
    const int u = static_cast<int>(local - row * upr);
    const int unit = a.unit[leaf];
    const long long offset = static_cast<long long>(u) * unit;
    unsigned char* dst = a.dst[leaf] + row * a.row_bytes[leaf] + offset;
    const int s = idx[row];
    if (s < 0 || s >= capacity) {
      zero_unit(dst, unit);
    } else {
      copy_unit(dst, a.src[leaf] + static_cast<long long>(s) * a.row_bytes[leaf] + offset, unit);
    }
  }
}

__global__ void scatter_kernel(unsigned char* __restrict__ dest, const int* __restrict__ idx,
                               const unsigned char* __restrict__ updates, int n, int units_per_row,
                               int unit, long long row_bytes, long long capacity) {
  const long long total = static_cast<long long>(n) * units_per_row;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long g = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; g < total;
       g += stride) {
    const int i = static_cast<int>(g / units_per_row);
    const int u = static_cast<int>(g - static_cast<long long>(i) * units_per_row);
    const int s = idx[i];
    if (s < 0 || s >= capacity) continue;
    bool overwritten = false;
    for (int j = i + 1; j < n; ++j) {
      if (idx[j] == s) {
        overwritten = true;
        break;
      }
    }
    if (overwritten) continue;
    const long long offset = static_cast<long long>(u) * unit;
    copy_unit(dest + static_cast<long long>(s) * row_bytes + offset,
              updates + static_cast<long long>(i) * row_bytes + offset, unit);
  }
}

// The widest copy unit that divides the row size and keeps every row's
// start aligned in each of the given buffers.
int unit_for(long long row_bytes, const void* p, const void* q) {
  const uintptr_t bits = reinterpret_cast<uintptr_t>(p) | reinterpret_cast<uintptr_t>(q);
  for (int unit = 4; unit > 1; unit /= 2) {
    if (row_bytes % unit == 0 && bits % unit == 0) return unit;
  }
  return 1;
}

int blocks_for(long long work) {
  const long long blocks = (work + kThreads - 1) / kThreads;
  return static_cast<int>(blocks < kMaxBlocks ? blocks : kMaxBlocks);
}

}  // namespace

// Gathers rows idx[0..n) of `num_leaves` (<= 8) row-major [capacity, ...]
// device buffers into n-row outputs, in one launch on `stream`. Returns
// cudaGetLastError() (0 on success), or cudaErrorInvalidValue for bad
// arguments.
extern "C" int replay_gather(const void* const* srcs, void* const* dsts, const long long* row_bytes,
                             int num_leaves, const void* idx, int n, long long capacity,
                             void* stream) {
  if (num_leaves < 1 || num_leaves > kMaxLeaves || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GatherArgs a{};
  a.num_leaves = num_leaves;
  a.start[0] = 0;
  for (int l = 0; l < num_leaves; ++l) {
    a.src[l] = static_cast<const unsigned char*>(srcs[l]);
    a.dst[l] = static_cast<unsigned char*>(dsts[l]);
    a.row_bytes[l] = row_bytes[l];
    a.unit[l] = unit_for(row_bytes[l], srcs[l], dsts[l]);
    const long long upr = row_bytes[l] / a.unit[l];
    if (upr > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
    a.units_per_row[l] = static_cast<int>(upr);
    a.start[l + 1] = a.start[l] + upr * n;
  }
  if (a.start[num_leaves] == 0) return static_cast<int>(cudaSuccess);
  gather_kernel<<<blocks_for(a.start[num_leaves]), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      a, static_cast<const int*>(idx), capacity);
  return static_cast<int>(cudaGetLastError());
}

// dest[idx[i]] = updates[i] for i in [0, n) over rows of `row_bytes`, the
// last i naming a row winning; in place, one launch on `stream`. Returns
// cudaGetLastError() (0 on success).
extern "C" int replay_scatter(void* dest, const void* idx, const void* updates, int n,
                              long long row_bytes, long long capacity, void* stream) {
  if (n < 0 || row_bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int unit = unit_for(row_bytes, dest, updates);
  const long long upr = row_bytes / unit;
  if (upr > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const long long work = upr * n;
  if (work == 0) return static_cast<int>(cudaSuccess);
  scatter_kernel<<<blocks_for(work), kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<unsigned char*>(dest), static_cast<const int*>(idx),
      static_cast<const unsigned char*>(updates), n, static_cast<int>(upr), unit, row_bytes,
      capacity);
  return static_cast<int>(cudaGetLastError());
}
