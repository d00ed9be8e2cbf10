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
// Design: one thread per batch column b, the two-value carry (acc, vs_{t+1})
// in registers, a loop over t = T-1 ... 0. Row-major [T, B] makes each
// timestep's eight loads and two stores contiguous across a warp (32
// neighbouring columns = 128 bytes), so every access is coalesced. The
// ragged edge is masked (b < B); nothing is padded. The TPU version padded B
// to 128 lanes and held eight [T, 128] stripes in VMEM; Hopper needs neither,
// since each element is read and written exactly once.
//
// Bound: memory traffic. 8 float32 reads and 2 float32 writes per element,
// 40 B * T * B: about 1.3 MB at T=32, B=1024, so about 0.4 us at the H100
// SXM's 3.35 TB/s. The arithmetic (about 21 operations per element, one of
// them an exp) is smaller still. At that shape the kernel is bound by launch
// latency: 1024 threads are 8 blocks of 128 on 132 SMs, each thread one
// dependent 32-step chain.
//
// Rounding: every multiply, add and subtract uses the _rn intrinsics, which
// nvcc never contracts into FMAs, and the products group as written above.
// rho uses expf, the function torch.exp calls for float32 on the card. The
// kernel therefore rounds where the plain PyTorch version in
// surreal_tpu_torch/ops/vtrace.py rounds.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;

__global__ void vtrace_kernel(const float* __restrict__ bl,
                              const float* __restrict__ tl,
                              const float* __restrict__ rewards,
                              const float* __restrict__ boot,
                              const float* __restrict__ edge,
                              const float* __restrict__ v_t,
                              const float* __restrict__ v_next,
                              const float* __restrict__ done,
                              float* __restrict__ vs_out,
                              float* __restrict__ pg_out,
                              int T, int B,
                              float clip_rho, float clip_c, float clip_pg_rho) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;
  float acc = 0.0f;
  float vs_next = v_next[static_cast<size_t>(T - 1) * B + b];
  for (int t = T - 1; t >= 0; --t) {
    const size_t i = static_cast<size_t>(t) * B + b;
    const float rho = expf(__fsub_rn(tl[i], bl[i]));
    const float r = rewards[i];
    const float bt = boot[i];
    const float v = v_t[i];
    const float vn = v_next[i];
    const float d = done[i];
    const float delta = __fmul_rn(
        fminf(clip_rho, rho), __fsub_rn(__fadd_rn(r, __fmul_rn(bt, vn)), v));
    acc = __fadd_rn(delta, __fmul_rn(__fmul_rn(edge[i], fminf(clip_c, rho)), acc));
    const float vs = __fadd_rn(acc, v);
    vs_out[i] = vs;
    const float succ =
        __fadd_rn(__fmul_rn(d, vn), __fmul_rn(__fsub_rn(1.0f, d), vs_next));
    pg_out[i] = __fmul_rn(
        fminf(clip_pg_rho, rho), __fsub_rn(__fadd_rn(r, __fmul_rn(bt, succ)), v));
    vs_next = vs;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// Pointers are device pointers to contiguous [T, B] float32 arrays, in the
// order (bl, tl, rewards, boot, edge, v_t, v_next, done, vs, pg).
extern "C" int vtrace_f32(const void* bl, const void* tl, const void* rewards,
                          const void* boot, const void* edge, const void* v_t,
                          const void* v_next, const void* done, void* vs,
                          void* pg, int T, int B, float clip_rho, float clip_c,
                          float clip_pg_rho, void* stream) {
  const int blocks = (B + kThreads - 1) / kThreads;
  vtrace_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(bl), static_cast<const float*>(tl),
      static_cast<const float*>(rewards), static_cast<const float*>(boot),
      static_cast<const float*>(edge), static_cast<const float*>(v_t),
      static_cast<const float*>(v_next), static_cast<const float*>(done),
      static_cast<float*>(vs), static_cast<float*>(pg), T, B, clip_rho, clip_c,
      clip_pg_rho);
  return static_cast<int>(cudaGetLastError());
}
