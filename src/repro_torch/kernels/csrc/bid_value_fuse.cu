// bid_value_fuse: learning-value fusion of the planner's Eq.-32 bids,
//   out[m, n] = bids[m, n] * (1 + w * value[n])     bids (M, N), value (N,), fp32
// with the fusion weight w (FLConfig.uncertainty_weight) passed by value.
//
// Replaces the TPU kernel repro/kernels/diffusion.py::_bid_value_kernel (the
// pallas_call in bid_value_fuse_pallas), an elementwise VPU tile with the
// value row broadcast down the model axis.  The device planner no longer
// launches it: its bids run as the epilogue of bid_fused_kernel
// (dol_bid_scores.cu), which rounds the same three operations one at a time
// and so equals this kernel after dol_bid_scores and the subtraction, bit
// for bit.  It stays as the standalone op (kernels/ops.py::bid_value_fuse).
//
// What bounds it on the H100: memory.  8 bytes of bids moved per element
// (read and write) for 3 flops; at the planner's sizes (M, N <= 20) the
// launch alone.
//
// Design: one thread per element, consecutive threads on consecutive
// elements of a row (coalesced), value[n] read through L1.  The three
// operations are rounded one at a time (__fmul_rn / __fadd_rn), which keeps
// nvcc from contracting them into an FMA: the result then equals the plain
// PyTorch version, which rounds each of its three elementwise ops, bit for
// bit.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
bid_value_fuse_kernel(const float* __restrict__ bids,
                      const float* __restrict__ value, float w,
                      float* __restrict__ out, long long total, int N) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  if (i >= total) return;
  const float v = __ldg(value + i % N);
  out[i] = __fmul_rn(bids[i], __fadd_rn(1.0f, __fmul_rn(w, v)));
}

}  // namespace

// bids (M, N), value (N,), out (M, N): fp32, contiguous, on the current
// device.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_bid_value_fuse_f32(const float* bids, const float* value,
                                        float w, float* out, int M, int N,
                                        cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  const long long total = static_cast<long long>(M) * N;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  bid_value_fuse_kernel<<<blocks, kThreads, 0, stream>>>(bids, value, w, out,
                                                         total, N);
  return static_cast<int>(cudaGetLastError());
}
