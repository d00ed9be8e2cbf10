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
// Design: one thread per batch column b, the carry acc in a register, a
// loop over t = T-1 ... 0. Row-major [T, B] makes each timestep's loads and
// stores contiguous across a warp (32 neighbouring columns = 128 bytes), so
// every access is coalesced. The ragged edge is masked (b < B); nothing is
// padded. The TPU version instead padded B to 128 lanes and held a whole
// [T, 128] stripe in VMEM; Hopper has no counterpart and needs none, since
// each element is read and written exactly once.
//
// Bound: memory traffic. 5 float32 reads and 2 float32 writes per element,
// 28 B * T * B: about 29.4 MB at T=256, B=4096, so about 8.8 us at the
// H100 SXM's 3.35 TB/s. The arithmetic (6 flops per element) is negligible.
//
// What this simple design leaves on the table: at B=4096 there are only
// 4096 threads, 32 blocks of 128, on 132 SMs, and each thread runs one
// dependent chain of T steps, so few loads are in flight per SM. Splitting
// T into chunks (a two-pass linear-recurrence scan) or prefetching several
// timesteps ahead would raise memory-level parallelism; that is later work.
//
// Rounding: every multiply and add uses the _rn intrinsics, which nvcc never
// contracts into FMAs. The kernel therefore rounds exactly where the plain
// PyTorch version in surreal_tpu_torch/ops/gae.py rounds, and the two agree
// bit for bit on the card.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void gae_masked_kernel(const float* __restrict__ rewards,
                                  const float* __restrict__ boot,
                                  const float* __restrict__ decay,
                                  const float* __restrict__ v_t,
                                  const float* __restrict__ v_next,
                                  float* __restrict__ adv,
                                  float* __restrict__ target,
                                  int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float acc = 0.0f;
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * B + b;
    const float v = v_t[i];
    const float delta =
        __fsub_rn(__fadd_rn(rewards[i], __fmul_rn(boot[i], v_next[i])), v);
    acc = __fadd_rn(delta, __fmul_rn(decay[i], acc));
    adv[i] = acc;
    target[i] = __fadd_rn(acc, v);
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers to contiguous [T, B] float32 arrays.
extern "C" int gae_masked_f32(const void* rewards, const void* boot,
                              const void* decay, const void* v_t,
                              const void* v_next, void* adv, void* target,
                              int T, int B, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  gae_masked_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(rewards), static_cast<const float*>(boot),
      static_cast<const float*>(decay), static_cast<const float*>(v_t),
      static_cast<const float*>(v_next), static_cast<float*>(adv),
      static_cast<float*>(target), T, B);
  return static_cast<int>(cudaGetLastError());
}
