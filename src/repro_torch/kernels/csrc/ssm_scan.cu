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

// The backward, in reverse time from g = 0 with da_S = 0:
//   g = dhs_t + da_{t+1} * g,  ddbx_t = g,  dda_t = g * h_{t-1} (h_{-1} = 0),
// __fmul_rn then __fadd_rn as in ssm_scan_bwd_ref, so the two agree bit
// for bit.  It replaces no TPU kernel (the reference differentiates its
// inline XLA scan) and is bound by memory too: three (B, S, D, N) reads
// (dhs, da, hs) and two writes.  The same one thread per channel, walking
// the sequence backwards kUnroll steps at a time with every load of the
// group issued first; da_t is carried to the next (earlier) step.
__global__ void __launch_bounds__(kThreads)
ssm_scan_bwd_kernel(const float* __restrict__ da,
                    const float* __restrict__ hs,
                    const float* __restrict__ dhs, float* __restrict__ dda,
                    float* __restrict__ ddbx, int S, int DN) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= DN) return;
  const long long step = DN;
  const long long base = (long long)blockIdx.y * S * step + c;
  float g = 0.f, a_next = 0.f;
  int t = S - 1;
  for (; t + 1 >= kUnroll; t -= kUnroll) {
    float dh[kUnroll], a[kUnroll], hp[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = base + (long long)(t - u) * step;
      dh[u] = __ldg(dhs + off);
      a[u] = __ldg(da + off);
      hp[u] = t - u > 0 ? __ldg(hs + off - step) : 0.f;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long off = base + (long long)(t - u) * step;
      g = __fadd_rn(dh[u], __fmul_rn(a_next, g));
      ddbx[off] = g;
      dda[off] = __fmul_rn(g, hp[u]);
      a_next = a[u];
    }
  }
  for (; t >= 0; --t) {
    const long long off = base + (long long)t * step;
    const float hp = t > 0 ? __ldg(hs + off - step) : 0.f;
    g = __fadd_rn(__ldg(dhs + off), __fmul_rn(a_next, g));
    ddbx[off] = g;
    dda[off] = __fmul_rn(g, hp);
    a_next = __ldg(da + off);
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

// The backward; returns cudaGetLastError() after the launch.
extern "C" int repro_ssm_scan_bwd_f32(const void* da, const void* hs,
                                      const void* dhs, void* dda, void* ddbx,
                                      int B, int S, int DN, void* stream) {
  if (B <= 0 || B > 65535 || S <= 0 || DN <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const dim3 grid((DN + kThreads - 1) / kThreads, B);
  ssm_scan_bwd_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(da), static_cast<const float*>(hs),
      static_cast<const float*>(dhs), static_cast<float*>(dda),
      static_cast<float*>(ddbx), S, DN);
  return static_cast<int>(cudaGetLastError());
}
