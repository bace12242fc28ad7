// stc_rows: masked per-row sparse ternary compression against a shared
// reference row (the STC-compressed D2D hops of feddif_stc and the STC
// uplink of stc).  For row c of x (C, n) with mask[c]:
//   out[c] = ref + mu_c * sign(x_c - ref) * 1[|x_c - ref| >= tau_c]
// and out[c] = x[c] bit for bit where mask[c] == 0.  tau_c, the k-th largest
// |x_c - ref|, is computed outside these kernels (torch.topk), as the
// reference leaves it to an XLA sort.
//
// Replaces the TPU kernels of repro/kernels/diffusion.py::stc_rows_pallas:
//   _stc_reduce_kernel (first pallas_call)  -> stc_reduce_kernel
//   _stc_apply_kernel  (second pallas_call) -> stc_apply_kernel
//
// Semantics: like the Pallas kernels these keep EVERY entry with
// |delta| >= tau_c.  The plain version (repro_torch.kernels.ref.stc_rows_ref,
// like repro.kernels.ref.stc_rows_ref) keeps EXACTLY k entries chosen by
// top-k.  The two differ only where |delta| ties at tau_c.
//
// What bounds them on the H100: memory.  Reduce reads C*n*4 bytes (plus the
// shared ref row) for ~3 flops per element; apply reads and writes C*n*4
// bytes each.
//
// Design: reduce is one block per row with a grid-stride loop over the row,
// per-thread fp32 sum and int count, then a warp-shuffle + shared-memory
// block reduction — no cross-block carry, so no atomics and a result that
// does not depend on scheduling order.  Apply is elementwise on a
// (row-chunk, row) grid; mu_c = sum_c / max(cnt_c, 1) is computed in the
// kernel from the reduce outputs, so no host step sits between the two.
#include <cuda_runtime.h>

namespace {

constexpr int kReduceThreads = 512;
constexpr int kApplyThreads = 256;
constexpr int kApplyMaxChunks = 1024;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
  return v;
}

__global__ void __launch_bounds__(kReduceThreads)
stc_reduce_kernel(const float* __restrict__ x, const float* __restrict__ ref,
                  const float* __restrict__ thr, float* __restrict__ ssum,
                  float* __restrict__ cnt, int n) {
  const int c = blockIdx.x;
  const float* row = x + static_cast<size_t>(c) * n;
  const float t = thr[c];
  float s = 0.f;
  int k = 0;
  for (int i = threadIdx.x; i < n; i += kReduceThreads) {
    const float a = fabsf(__ldg(row + i) - __ldg(ref + i));
    if (a >= t) {
      s += a;
      ++k;
    }
  }
  constexpr int kWarps = kReduceThreads / 32;
  __shared__ float s_part[kWarps];
  __shared__ int k_part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  s = warp_sum(s);
  k = warp_sum(k);
  if (lane == 0) {
    s_part[warp] = s;
    k_part[warp] = k;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? s_part[lane] : 0.f;
    k = lane < kWarps ? k_part[lane] : 0;
    s = warp_sum(s);
    k = warp_sum(k);
    if (lane == 0) {
      ssum[c] = s;
      cnt[c] = static_cast<float>(k);
    }
  }
}

__global__ void __launch_bounds__(kApplyThreads)
stc_apply_kernel(const float* __restrict__ x, const float* __restrict__ ref,
                 const float* __restrict__ thr, const float* __restrict__ ssum,
                 const float* __restrict__ cnt, const int* __restrict__ mask,
                 float* __restrict__ out, int n) {
  const int c = blockIdx.y;
  const size_t base = static_cast<size_t>(c) * n;
  const bool masked = mask[c] != 0;
  const float t = thr[c];
  const float mu = ssum[c] / fmaxf(cnt[c], 1.f);
  for (int i = blockIdx.x * kApplyThreads + threadIdx.x; i < n;
       i += gridDim.x * kApplyThreads) {
    const float xv = __ldg(x + base + i);
    float o = xv;
    if (masked) {
      const float r = __ldg(ref + i);
      const float d = xv - r;
      const float sgn = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
      o = r + (fabsf(d) >= t ? sgn * mu : 0.f);
    }
    out[base + i] = o;
  }
}

}  // namespace

// x (C, n), ref (n,), thr (C,) in; ssum (C,), cnt (C,) out.  fp32,
// contiguous, on the current device.  Returns cudaGetLastError().
extern "C" int repro_stc_rows_reduce_f32(const float* x, const float* ref,
                                         const float* thr, float* ssum,
                                         float* cnt, int C, int n,
                                         cudaStream_t stream) {
  if (C <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  stc_reduce_kernel<<<C, kReduceThreads, 0, stream>>>(x, ref, thr, ssum, cnt,
                                                      n);
  return static_cast<int>(cudaGetLastError());
}

// x (C, n), ref (n,), thr/ssum/cnt (C,) fp32, mask (C,) int32 in; out (C, n)
// fp32.  Returns cudaGetLastError().
extern "C" int repro_stc_rows_apply_f32(const float* x, const float* ref,
                                        const float* thr, const float* ssum,
                                        const float* cnt, const int* mask,
                                        float* out, int C, int n,
                                        cudaStream_t stream) {
  if (C <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  int chunks = (n + kApplyThreads - 1) / kApplyThreads;
  if (chunks > kApplyMaxChunks) chunks = kApplyMaxChunks;
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(C));
  stc_apply_kernel<<<grid, kApplyThreads, 0, stream>>>(x, ref, thr, ssum, cnt,
                                                       mask, out, n);
  return static_cast<int>(cudaGetLastError());
}
