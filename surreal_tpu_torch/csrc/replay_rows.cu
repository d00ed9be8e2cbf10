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
// What bounds them: not bytes. The DDPG path gathers 256 rows of 160 B
// (five leaves) and scatters 256 f32 priorities; their byte bounds are
// 0.025 us and 0.001 us, while a launch alone costs a few microseconds
// on this card and a load that misses L2 most of one. So each kernel is
// bound by its launch, by the number of DEPENDENT device-memory round
// trips it makes, and by the instructions that stand between them. Code
// size counts too: where L2 has been flushed, the kernel's instructions
// come from device memory as they are first executed.
//
// Gather design: two round trips, the least a gather can make (the index,
// then the row), and little else. A row plan, built by the wrapper
// (ops/replay_rows.py::gather_plan) and passed by value in the kernel's
// argument struct, gives each leaf its copy unit (the widest of 16, 8, 4,
// 2, 1 bytes that divides its row size and both base pointers: 16 B for
// the DDPG action rows, 4 B for the 68 B obs rows, whose starts are only
// 4-byte aligned), its units per row and its threads per row (the largest
// power of two up to 128 that is no more than the units, so each thread
// copies one or two units: 16 for a 17-unit obs row, 1 for a 4 B reward).
// Each block copies rows of ONE leaf (the entry point lays the leaves'
// blocks end to end), so the leaf, its unit and its fields are the same
// for the whole block: no per-thread search, no division (shifts), no
// divergent unit branches, and one switch to code compiled for that unit.
// The threads of a row read its index word together (one request a warp),
// then issue their loads before their stores. One launch moves every leaf
// of the replay dict: 70 blocks of 128 threads for 256 DDPG rows, 4,480
// for uniform sample_many's 16,384.
//
// Scatter design: for n <= kScatterBlockRows (the path's 256 and every
// batch size the trainers use), ONE block, a thread a position. Each
// thread first loads its index and the first unit of its update row into
// registers, both at once: one round trip in all (the rest of a longer row
// its winner reads again). "The last occurrence wins" is resolved in
// shared memory with O(1) work per index: an open-addressed hash table of
// 2n to 4n 32-bit slots, each (row index << pos_bits) | position. An
// index goes in with one atomicCAS if its row is new and an atomicMax if
// it repeats (same row bits, so the max keeps the later position); after
// a barrier, a row is written only by the index whose word the slot
// holds. This is deterministic whatever order the atomics land in, and
// needs no sort and no scan of later indices (the earlier design scanned
// idx[i+1:] from memory: 255 dependent loads for the first thread, 18 us
// on an H100). The kernel is compiled once per copy unit, so a launch
// runs straight-line code. Larger n (or a capacity whose row index does
// not fit the 32-bit word beside the position) runs the same algorithm
// grid-wide as a cooperative kernel, with a table of 64-bit slots in
// device scratch that the wrapper allocates, and two grid barriers
// (clear, insert, copy).
//
// Indices are int32 (as the Pallas kernels take them). A row index outside
// [0, capacity) is never dereferenced: the gather writes zeros for it and
// the scatter skips it. The wrappers in ops/replay_rows.py check indices on
// the host where they are on the host; on the card they are not read back.
// The entry points check the plan they are given (units, alignment,
// threads per row) and refuse one that would make a misaligned access.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

constexpr int kMaxLeaves = 8;
constexpr int kGatherThreads = 128;  // mirrored in ops/replay_rows.py (MAX_GROUP)

// The row plan of one leaf, as ops/replay_rows.py packs it. (Outside the
// unnamed namespace: the C entry point takes it, and a type of that
// namespace would make the entry point internal.)
struct GatherLeaf {
  const unsigned char* src;
  unsigned char* dst;
  long long row_bytes;
  int unit;   // bytes per copy unit: 16, 8, 4, 2 or 1
  int units;  // units per row: row_bytes / unit
  int group;  // threads per row: a power of two, at most kGatherThreads
  int pad_;
};

struct GatherPlan {
  GatherLeaf leaf[kMaxLeaves];
  int num_leaves;
  int pad_;
};

// The kernel's argument: the plan, and where each leaf's blocks begin.
struct GatherArgs {
  long long first_block[kMaxLeaves];  // LLONG_MAX for an unused leaf
  int shift[kMaxLeaves];              // log2(group)
  int passes[kMaxLeaves];             // ceil(units / (kTasks * group))
  long long blocks;                   // all leaves'
  GatherPlan plan;
};

namespace {

constexpr int kWarp = 32;
constexpr int kTasks = 2;                 // units a gather thread copies per pass
constexpr int kMaxBlocks = 1 << 16;       // then a grid-stride loop
constexpr int kScatterBlockRows = 1024;   // one a thread; mirrored in ops/replay_rows.py
constexpr int kScatterThreads = 1024;     // the grid-wide kernel's blocks
constexpr int kMinSlots = 64;

bool is_unit(int unit) { return unit == 16 || unit == 8 || unit == 4 || unit == 2 || unit == 1; }

bool aligned(const void* p, int unit) { return reinterpret_cast<uintptr_t>(p) % unit == 0; }

int ceil_log2(long long x) {
  int bits = 0;
  while ((1LL << bits) < x) ++bits;
  return bits;
}

// The type that moves one copy unit of kUnit bytes.
template <int kUnit> struct UnitWord;
template <> struct UnitWord<16> { using T = uint4; };
template <> struct UnitWord<8> { using T = uint2; };
template <> struct UnitWord<4> { using T = uint32_t; };
template <> struct UnitWord<2> { using T = uint16_t; };
template <> struct UnitWord<1> { using T = uint8_t; };

// Row `row` of leaf f from storage row s (zeros where !valid): this
// thread's units lane, lane + group, ...; all of a pass's loads before its
// stores.
template <int kUnit>
__device__ __forceinline__ void copy_row(const GatherLeaf& f, int passes, long long row, int lane, int s,
                                         bool valid) {
  using W = typename UnitWord<kUnit>::T;
  const W* src = reinterpret_cast<const W*>(f.src) + static_cast<long long>(s) * f.units;
  W* dst = reinterpret_cast<W*>(f.dst) + row * f.units;
#pragma unroll 1
  for (int pass = 0; pass < passes; ++pass) {
    W v[kTasks];
#pragma unroll
    for (int k = 0; k < kTasks; ++k) {
      const int u = lane + (pass * kTasks + k) * f.group;
      v[k] = W{};
      if (valid && u < f.units) v[k] = src[u];
    }
#pragma unroll
    for (int k = 0; k < kTasks; ++k) {
      const int u = lane + (pass * kTasks + k) * f.group;
      if (u < f.units) dst[u] = v[k];
    }
  }
}

// Block b copies rows of one leaf, the last whose first block is <= b:
// kGatherThreads / group rows, `group` threads a row, each thread units
// lane and lane + group of its row (and more passes for rows of more than
// kTasks * group units, group stopping at kGatherThreads).
__global__ void __launch_bounds__(kGatherThreads)
gather_kernel(const GatherArgs a, const int* __restrict__ idx, const long long n, const long long capacity) {
  for (long long b = blockIdx.x; b < a.blocks; b += gridDim.x) {
    // The block's leaf, the same for all its threads (an unused leaf's
    // first block is out of reach), with its first block and shift
    // picked from values all loaded at once: one level of parameter loads
    // before the index load.
    int l = 0;
    long long first = 0;
    int shift = a.shift[0];
#pragma unroll
    for (int m = 1; m < kMaxLeaves; ++m) {
      if (b >= a.first_block[m]) {
        l = m;
        first = a.first_block[m];
        shift = a.shift[m];
      }
    }
    const long long row = ((b - first) * kGatherThreads + threadIdx.x) >> shift;
    if (row >= n) continue;
    const GatherLeaf& f = a.plan.leaf[l];
    const int lane = threadIdx.x & ((1 << shift) - 1);
    // Round trip 1: the threads of a row read one word. Round trip 2 is
    // the row, in copy_row.
    const int s = idx[row];
    const bool valid = s >= 0 && s < capacity;
    // the same for the whole block; 4-byte units (f32 rows) fall through
    if (f.unit == 4) {
      copy_row<4>(f, a.passes[l], row, lane, s, valid);
    } else if (f.unit == 16) {
      copy_row<16>(f, a.passes[l], row, lane, s, valid);
    } else if (f.unit == 8) {
      copy_row<8>(f, a.passes[l], row, lane, s, valid);
    } else if (f.unit == 2) {
      copy_row<2>(f, a.passes[l], row, lane, s, valid);
    } else {
      copy_row<1>(f, a.passes[l], row, lane, s, valid);
    }
  }
}

// -- scatter ------------------------------------------------------------------

__device__ __forceinline__ unsigned hash_slot(int key, int bits) {
  return (static_cast<unsigned>(key) * 0x9E3779B1u) >> (32 - bits);
}

// The scatter's hash table: 2^bits slots, each (key << pos_bits) | the
// largest position that names the key, or all ones when empty (no slot
// of a key below capacity is all ones: launch_scatter checks that the
// word holds capacity << pos_bits). Inserts `mine` = (key << pos_bits) |
// pos and returns its slot: one atomicCAS for a key not seen before, and
// an atomicMax for a repeat (the key bits are equal, so the max holds the
// larger position). The table holds at most half as many keys as slots,
// so the probe ends.
template <typename Word>
__device__ __forceinline__ unsigned insert_key(Word* table, Word mine, int key, int pos_bits, int bits) {
  const unsigned mask = bits == 32 ? 0xffffffffu : (1u << bits) - 1u;
  unsigned s = hash_slot(key, bits);
  while (true) {
    const Word prev = atomicCAS(&table[s], ~Word{0}, mine);
    if (prev == ~Word{0}) return s;
    if (prev >> pos_bits == mine >> pos_bits) {
      atomicMax(&table[s], mine);
      return s;
    }
    s = (s + 1u) & mask;
  }
}

// n <= kScatterBlockRows: one block of n threads rounded up to a warp;
// thread i owns position i, and holds the first unit of its update row in
// a register (a winner reads the rest of a longer row again). Shared
// memory: the table, 2^bits 32-bit slots.
template <int kUnit>
__global__ void __launch_bounds__(kScatterBlockRows)
scatter_block_kernel(unsigned char* __restrict__ dest, const int* __restrict__ idx,
                     const unsigned char* __restrict__ updates, const int n, const int units,
                     const long long capacity, const int bits, const int pos_bits) {
  using W = typename UnitWord<kUnit>::T;
  extern __shared__ unsigned table[];
  const int i = threadIdx.x;
  const W* upd = reinterpret_cast<const W*>(updates) + static_cast<long long>(i) * units;

  // 1. Both loads at once: the index and the update.
  const int key = i < n ? idx[i] : -1;
  const W first = i < n ? upd[0] : W{};
#pragma unroll 1
  for (int s = i; s < 1 << bits; s += blockDim.x) table[s] = ~0u;
  __syncthreads();

  // 2. Insert the index.
  const bool valid = key >= 0 && key < capacity;
  const unsigned mine = static_cast<unsigned>(key) << pos_bits | static_cast<unsigned>(i);
  const unsigned slot = valid ? insert_key(table, mine, key, pos_bits, bits) : 0u;
  __syncthreads();

  // 3. The winner writes the row.
  if (!valid || table[slot] != mine) return;
  W* out = reinterpret_cast<W*>(dest) + static_cast<long long>(key) * units;
  out[0] = first;
#pragma unroll 1
  for (int u = 1; u < units; ++u) out[u] = upd[u];
}

// Any n, as a cooperative launch of as many blocks as fit on the card at
// once, with the table in device scratch (2^bits 64-bit slots; pos_bits
// 32, so any key fits); a winner copies its row.
template <int kUnit>
__global__ void __launch_bounds__(kScatterThreads)
scatter_grid_kernel(unsigned char* __restrict__ dest, const int* __restrict__ idx,
                    const unsigned char* __restrict__ updates, const int n, const int units,
                    const long long capacity, const int bits, unsigned long long* __restrict__ table) {
  using W = typename UnitWord<kUnit>::T;
  cg::grid_group grid = cg::this_grid();
  const long long tid = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long nt = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long s = tid; s < 1LL << bits; s += nt) table[s] = ~0ull;
  grid.sync();
  for (long long i = tid; i < n; i += nt) {
    const int k = idx[i];
    if (k >= 0 && k < capacity) insert_key(table, static_cast<unsigned long long>(k) << 32 | i, k, 32, bits);
  }
  grid.sync();
  const unsigned mask = bits == 32 ? 0xffffffffu : (1u << bits) - 1u;
  for (long long i = tid; i < n; i += nt) {
    const int k = idx[i];
    if (k < 0 || k >= capacity) continue;
    unsigned s = hash_slot(k, bits);
    while (table[s] >> 32 != static_cast<unsigned long long>(k)) s = (s + 1u) & mask;
    if (static_cast<long long>(table[s] & 0xffffffffull) != i) continue;
    W* out = reinterpret_cast<W*>(dest) + static_cast<long long>(k) * units;
    const W* in = reinterpret_cast<const W*>(updates) + i * units;
    for (int u = 0; u < units; ++u) out[u] = in[u];
  }
}

// One scatter launch with the copy unit fixed: the one-block kernel where
// it can take n and capacity, else the grid-wide one.
template <int kUnit>
int launch_scatter(unsigned char* dest, const int* idx, const unsigned char* updates, int n, int units,
                   long long capacity, void* scratch, long long scratch_bytes, cudaStream_t stream) {
  const int pos_bits = ceil_log2(n);
  if (n <= kScatterBlockRows && capacity < (1LL << (32 - pos_bits))) {
    const int bits = ceil_log2(2LL * n > kMinSlots ? 2LL * n : kMinSlots);
    const int threads = (n + kWarp - 1) / kWarp * kWarp;
    const size_t smem = static_cast<size_t>(4) << bits;  // the table
    scatter_block_kernel<kUnit><<<1, threads, smem, stream>>>(dest, idx, updates, n, units, capacity, bits,
                                                              pos_bits);
    return static_cast<int>(cudaGetLastError());
  }
  int bits = ceil_log2(2LL * n);
  if (scratch == nullptr || !aligned(scratch, 8) || scratch_bytes < (8LL << bits)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, scatter_grid_kernel<kUnit>, kScatterThreads, 0);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long work = (1LL << bits) > n ? (1LL << bits) : n;
  const long long need = (work + kScatterThreads - 1) / kScatterThreads;
  const long long fit = static_cast<long long>(per_sm) * sms;
  const int blocks = static_cast<int>(need < fit ? need : fit);
  auto* table = static_cast<unsigned long long*>(scratch);
  void* args[] = {&dest, &idx, &updates, &n, &units, &capacity, &bits, &table};
  err = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(scatter_grid_kernel<kUnit>), blocks,
                                    kScatterThreads, args, 0, stream);
  if (err != cudaSuccess) {
    cudaGetLastError();  // clear it
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// sizeof the plan replay_gather takes, for the wrapper to check its packing.
extern "C" int replay_gather_plan_bytes() { return static_cast<int>(sizeof(GatherPlan)); }

// Gathers rows idx[0..n) of the plan's leaves (row-major [capacity, ...]
// device buffers) into their n-row outputs, in one launch on `stream`.
// Returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue for
// a bad plan or arguments.
extern "C" int replay_gather(const GatherPlan* plan, const void* idx, int n, long long capacity,
                             void* stream) {
  if (plan == nullptr || n < 0 || plan->num_leaves < 1 || plan->num_leaves > kMaxLeaves) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  GatherArgs a{};
  a.plan = *plan;
  for (int l = 0; l < kMaxLeaves; ++l) a.first_block[l] = 0x7fffffffffffffffLL;
  for (int l = 0; l < a.plan.num_leaves; ++l) {
    const GatherLeaf& f = a.plan.leaf[l];
    const int g = f.group;
    if (!is_unit(f.unit) || f.units < 0 || static_cast<long long>(f.units) * f.unit != f.row_bytes ||
        !aligned(f.src, f.unit) || !aligned(f.dst, f.unit) || g < 1 || g > kGatherThreads ||
        (g & (g - 1)) != 0 || f.units > 0x7fffffff - kTasks * kGatherThreads) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    const long long rows_per_block = kGatherThreads / g;
    a.shift[l] = ceil_log2(g);
    a.first_block[l] = a.blocks;
    a.blocks += f.units ? (n + rows_per_block - 1) / rows_per_block : 0;
    a.passes[l] = static_cast<int>((static_cast<long long>(f.units) + kTasks * g - 1) / (kTasks * g));
  }
  if (a.blocks == 0) return static_cast<int>(cudaSuccess);
  gather_kernel<<<static_cast<int>(a.blocks < kMaxBlocks ? a.blocks : kMaxBlocks), kGatherThreads, 0,
                  static_cast<cudaStream_t>(stream)>>>(a, static_cast<const int*>(idx), n, capacity);
  return static_cast<int>(cudaGetLastError());
}

// dest[idx[i]] = updates[i] for i in [0, n) over rows of `row_bytes`, the
// last i naming a row winning; in place, one launch on `stream`, copying
// `unit`-byte units (16, 8, 4, 2 or 1, dividing the row size and both
// pointers). Where the one-block kernel cannot take the launch (n above
// kScatterBlockRows, or capacity << ceil(log2 n) not below 2^32), the
// grid-wide one needs `scratch` of at least 8 * 2^ceil(log2(2n)) bytes
// (ops/replay_rows.py::scatter_scratch_bytes). Returns cudaGetLastError()
// (0 on success), or cudaErrorInvalidValue for bad arguments.
extern "C" int replay_scatter(void* dest, const void* idx, const void* updates, int n,
                              long long row_bytes, int unit, long long capacity, void* scratch,
                              long long scratch_bytes, void* stream) {
  if (n < 0 || row_bytes < 0 || !is_unit(unit) || row_bytes % unit != 0 || !aligned(dest, unit) ||
      !aligned(updates, unit)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long units = row_bytes / unit;
  if (units > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0 || units == 0) return static_cast<int>(cudaSuccess);
  auto* d = static_cast<unsigned char*>(dest);
  const auto* ix = static_cast<const int*>(idx);
  const auto* up = static_cast<const unsigned char*>(updates);
  const int u = static_cast<int>(units);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (unit) {
    case 16: return launch_scatter<16>(d, ix, up, n, u, capacity, scratch, scratch_bytes, s);
    case 8: return launch_scatter<8>(d, ix, up, n, u, capacity, scratch, scratch_bytes, s);
    case 4: return launch_scatter<4>(d, ix, up, n, u, capacity, scratch, scratch_bytes, s);
    case 2: return launch_scatter<2>(d, ix, up, n, u, capacity, scratch, scratch_bytes, s);
    default: return launch_scatter<1>(d, ix, up, n, u, capacity, scratch, scratch_bytes, s);
  }
}
