// ssm_scan: the Mamba-1 diagonal recurrence, every state kept.
//
//   da, dbx (B, S, D, N) fp32 -> hs (B, S, D, N) fp32,
//   h_t = da_t * h_{t-1} + dbx_t from h_{-1} = 0, per (b, d, n) channel.
//
// Replaces the TPU kernel repro/kernels/ssm_scan.py::_scan_kernel (the
// pallas_call in ssm_scan_pallas): a (batch, d-block, seq-chunk) grid whose
// chunk axis runs in order, carrying a (block_d, N) state in VMEM scratch
// and stepping through the chunk with a fori_loop.
//
// What bounds it on the H100: memory.  It reads two (B, S, D, N) tensors
// and writes one, two flops per element; at falcon-mamba-7b's prefill width
// (D = 8192, N = 16) that is 12 bytes per 2 flops against 3.35 TB/s.
//
// Design.  The channels are independent, so one thread owns one (b, d, n)
// channel and walks the whole sequence; there is no chunking and no carry
// between blocks.  Channel c = d*N + n is the fastest axis of every (b, t)
// slice, so a warp's 32 threads read 32 contiguous floats per step.  Each
// thread loads kUnroll steps of da and dbx before it uses them, which keeps
// 2*kUnroll independent loads in flight per thread to cover the latency of
// device memory.  The update is __fmul_rn then __fadd_rn — two roundings,
// no contraction — the arithmetic of the plain version (a multiply, then
// an add), so the two agree bit for bit.  At D*N = 131,072 channels per
// batch row the grid is 512 blocks of 256 threads.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;

__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const float* __restrict__ da, const float* __restrict__ dbx,
                float* __restrict__ hs, int S, int DN) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= DN) return;
  const long long step = DN;
  long long off = (long long)blockIdx.y * S * step + c;
  float h = 0.f;
  int t = 0;
  for (; t + kUnroll <= S; t += kUnroll) {
    float a[kUnroll], x[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      a[u] = __ldg(da + off + u * step);
      x[u] = __ldg(dbx + off + u * step);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(a[u], h), x[u]);
      hs[off + u * step] = h;
    }
    off += kUnroll * step;
  }
  for (; t < S; ++t, off += step) {
    h = __fadd_rn(__fmul_rn(__ldg(da + off), h), __ldg(dbx + off));
    hs[off] = h;
  }
}

}  // namespace

// Returns cudaGetLastError() after the launch.
extern "C" int repro_ssm_scan_f32(const void* da, const void* dbx, void* hs,
                                  int B, int S, int DN, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || DN <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((DN + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(da), static_cast<const float*>(dbx),
      static_cast<float*>(hs), S, DN);
  return static_cast<int>(cudaGetLastError());
}
