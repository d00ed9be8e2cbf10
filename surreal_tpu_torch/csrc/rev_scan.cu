// Reverse linear recurrence as one CUDA kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel surreal_tpu/ops/pallas_returns.py::_rev_scan_kernel
// (the pl.pallas_call of reverse_linear_scan_pallas, which
// discounted_returns_pallas also calls). Same function, arrays [T, B]
// row-major float32, init [B]:
//
//   x_t = deltas_t + coeffs_t * x_{t+1},   x_T = init
//
// Design: GAE's skeleton (csrc/gae.cu). One thread per batch column b, the
// carry in a register, a loop over t = T-1 ... 0; each timestep's loads and
// stores are contiguous across a warp, so every access is coalesced. The
// ragged edge is masked (b < B), nothing is padded. The TPU version padded
// B to 128 lanes and held [T, 128] stripes in VMEM.
//
// Bound: memory traffic. Two f32 reads and one f32 write per element plus
// init: 12 B * T * B + 4 B * B, about 12.6 MB at T=256, B=4096, i.e. 3.8 us
// at the H100 SXM's 3.35 TB/s. Two flops per element are negligible. Like
// GAE's kernel it is latency-bound in practice (one dependent chain of T
// steps per thread); chunking T is later work.
//
// Rounding: the _rn intrinsics, which nvcc never contracts into an FMA, so
// the kernel rounds exactly where the plain PyTorch version in
// surreal_tpu_torch/ops/rev_scan.py rounds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void rev_scan_kernel(const float* __restrict__ coeffs,
                                const float* __restrict__ deltas,
                                const float* __restrict__ init,
                                float* __restrict__ out, int T, int B) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float acc = init[b];
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * B + b;
    acc = __fadd_rn(deltas[i], __fmul_rn(coeffs[i], acc));
    out[i] = acc;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers to contiguous float32 arrays: coeffs,
// deltas and out [T, B], init [B].
extern "C" int rev_scan_f32(const void* coeffs, const void* deltas, const void* init, void* out,
                            int T, int B, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  rev_scan_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(coeffs), static_cast<const float*>(deltas),
      static_cast<const float*>(init), static_cast<float*>(out), T, B);
  return static_cast<int>(cudaGetLastError());
}
