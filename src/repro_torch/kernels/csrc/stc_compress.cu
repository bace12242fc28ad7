// stc_compress: whole-tensor sparse ternary compression (Sattler et al.),
// the STC of the host data plane: the compressed D2D hops of feddif_stc and
// the STC uplink of stc, one call per slot and per leaf.  For a flat fp32
// tensor x of n elements and the threshold tau (the k-th largest |x|,
// computed outside these kernels with torch.topk, as the reference leaves it
// to an XLA sort):
//   reduce: sum = SUM |x_i| * 1[|x_i| >= tau],  count = SUM 1[|x_i| >= tau]
//   apply:  out_i = mu * sign(x_i) * 1[|x_i| >= tau],
//           mu = (sum - (count - k) * tau) / k
//
// Replaces the TPU kernels of repro/kernels/stc_compress.py:
//   _reduce_kernel (stc_reduce_pallas) -> stc_reduce_kernel
//   _apply_kernel  (stc_apply_pallas)  -> stc_apply_kernel
//
// Semantics: like the Pallas kernels these keep EVERY entry with
// |x| >= tau.  The plain version of the whole compression
// (repro_torch.kernels.ref.stc_compress_ref, like the reference's
// stc_compress_ref) keeps EXACTLY k entries chosen by top-k, and its mu is
// the mean of those k magnitudes.  The apply forms that same mu: the
// count - k survivors past the k-th all have |x| == tau, so the top-k sum is
// sum - (count - k) * tau (mu = sum / k when nothing ties).  The largest tie
// is tau == 0, a tensor with fewer than k nonzeros (rows no batch touched):
// every zero then survives, and mu = sum / count would be sum(|x|) / n, up
// to n / k times too small; sum / k is the exact-k mu.  The kernels and the
// plain version then give the same values, since a surviving zero maps to
// 0.  Where tau > 0 ties, the kernels also send the tied entries past the
// k-th, at the same mu.  The count is an int32, exact for any n < 2^31 (the
// Pallas kernel's fp32 count is exact only up to 2^24).
//
// What bounds them on the H100: memory.  Reduce reads 4n bytes for ~3 flops
// per element; apply reads 4n and writes 4n bytes.  At the fcn leaves
// (n <= 16384) both are launch-bound.
//
// Design.  The Pallas reduce carries its sums across a grid that runs in
// order; on the card blocks run in parallel and in no order, so:
//   * reduce is a grid-stride pass (16-byte float4 loads when x is 16-byte
//     aligned, a scalar tail) in which each block writes one partial, an
//     fp32 sum and an int count, from a fixed warp-shuffle + shared-memory
//     tree.  The last block to finish (an integer atomic ticket, no fp32
//     atomics) adds the partials in block order, in a fixed tree, and writes
//     the result.  The grid depends only on n and the SM count, so the same
//     input gives the same bits on every run on one card.
//   * apply reads tau, sum and count from device memory and forms mu itself
//     (k is a launch argument: it depends only on n and the sparsity), so
//     no host read sits between the two passes.  Same vector/tail split.
// One launch each; a whole tensor spreads over every SM (stc_rows, which
// puts one block on a row, would run a single tensor on one SM).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kBlocksPerSm = 4;
constexpr int kMaxBlocks = 1024;     // the wrapper's partials buffers
constexpr int kUnroll = 2;           // float4 loads in flight per thread

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

// Block-wide (sum, count) in a fixed order; the result is valid in thread 0.
__device__ __forceinline__ void block_sum(float& s, int& k) {
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
  }
}

__device__ __forceinline__ void keep_add(float v, float t, float& s, int& k) {
  const float a = fabsf(v);
  if (a >= t) {
    s += a;
    ++k;
  }
}

// n4 float4s from x4 (0 when x is not 16-byte aligned), then the scalar
// elements [first_scalar, n).
__global__ void __launch_bounds__(kThreads)
stc_reduce_kernel(const float* __restrict__ x, const float4* __restrict__ x4,
                  long long n4, long long first_scalar, long long n,
                  const float* __restrict__ thr, float* __restrict__ part_sum,
                  int* __restrict__ part_cnt, unsigned* __restrict__ ticket,
                  float* __restrict__ out_sum, int* __restrict__ out_cnt) {
  const float t = thr[0];
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  float s = 0.f;
  int k = 0;
  long long i = tid;
  for (; i + (kUnroll - 1) * stride < n4; i += kUnroll * stride) {
    float4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = __ldg(x4 + i + u * stride);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      keep_add(v[u].x, t, s, k);
      keep_add(v[u].y, t, s, k);
      keep_add(v[u].z, t, s, k);
      keep_add(v[u].w, t, s, k);
    }
  }
  for (; i < n4; i += stride) {
    const float4 v = __ldg(x4 + i);
    keep_add(v.x, t, s, k);
    keep_add(v.y, t, s, k);
    keep_add(v.z, t, s, k);
    keep_add(v.w, t, s, k);
  }
  for (long long j = first_scalar + tid; j < n; j += stride) {
    keep_add(__ldg(x + j), t, s, k);
  }
  block_sum(s, k);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    part_sum[blockIdx.x] = s;
    part_cnt[blockIdx.x] = k;
    __threadfence();          // partials visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last block: the partials in block order, a fixed tree.
  s = 0.f;
  k = 0;
  for (int b = threadIdx.x; b < static_cast<int>(gridDim.x); b += kThreads) {
    s += __ldcg(part_sum + b);
    k += __ldcg(part_cnt + b);
  }
  __syncthreads();            // block_sum's shared buffers are reused
  block_sum(s, k);
  if (threadIdx.x == 0) {
    out_sum[0] = s;
    out_cnt[0] = k;
    ticket[0] = 0u;
  }
}

__device__ __forceinline__ float ternary(float v, float t, float mu) {
  if (!(fabsf(v) >= t)) return 0.f;
  return v > 0.f ? mu : (v < 0.f ? -mu : 0.f);
}

__global__ void __launch_bounds__(kThreads)
stc_apply_kernel(const float* __restrict__ x, const float4* __restrict__ x4,
                 long long n4, long long first_scalar, long long n,
                 const float* __restrict__ thr, const float* __restrict__ ssum,
                 const int* __restrict__ cnt, int k, float* out,
                 float4* out4) {
  const float t = thr[0];
  const float extra = static_cast<float>(cnt[0] - k);
  const float mu = __fdiv_rn(__fsub_rn(ssum[0], __fmul_rn(extra, t)),
                             static_cast<float>(k));
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  for (long long i = tid; i < n4; i += stride) {
    const float4 v = __ldg(x4 + i);
    out4[i] = make_float4(ternary(v.x, t, mu), ternary(v.y, t, mu),
                          ternary(v.z, t, mu), ternary(v.w, t, mu));
  }
  for (long long j = first_scalar + tid; j < n; j += stride) {
    out[j] = ternary(__ldg(x + j), t, mu);
  }
}

// The grid: enough blocks for one float4 (or element) per thread, at most
// kBlocksPerSm per SM.  Returns 0 on a device query error.
int grid_for(long long work) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  long long blocks = (work + kThreads - 1) / kThreads;
  long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (cap > kMaxBlocks) cap = kMaxBlocks;
  if (blocks > cap) blocks = cap;
  return blocks < 1 ? 1 : static_cast<int>(blocks);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace

// Largest grid the reduce launches: the size of its partials buffers.
extern "C" int repro_stc_reduce_max_blocks() { return kMaxBlocks; }

// x (n,) and thr (1,) fp32 in; part_sum (kMaxBlocks,) fp32 and part_cnt
// (kMaxBlocks,) int32 scratch; ticket (1,) uint32 scratch holding 0 (left
// at 0); out_sum (1,) fp32 and out_cnt (1,) int32 out.  Contiguous, on the
// current device.  Returns cudaGetLastError().
extern "C" int repro_stc_reduce_f32(const float* x, const float* thr,
                                    float* part_sum, int* part_cnt,
                                    unsigned* ticket, float* out_sum,
                                    int* out_cnt, long long n,
                                    cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = aligned16(x) ? n / 4 : 0;
  const int blocks = grid_for(n4 > 0 ? n4 : n);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  stc_reduce_kernel<<<blocks, kThreads, 0, stream>>>(
      x, reinterpret_cast<const float4*>(x), n4, 4 * n4, n, thr, part_sum,
      part_cnt, ticket, out_sum, out_cnt);
  return static_cast<int>(cudaGetLastError());
}

// x (n,), thr (1,), ssum (1,) fp32 and cnt (1,) int32 in, k the number of
// entries STC keeps (1 <= k <= n); out (n,) fp32.  Returns
// cudaGetLastError().
extern "C" int repro_stc_apply_f32(const float* x, const float* thr,
                                   const float* ssum, const int* cnt, int k,
                                   float* out, long long n,
                                   cudaStream_t stream) {
  if (n <= 0 || k < 1 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  const long long n4 = aligned16(x) && aligned16(out) ? n / 4 : 0;
  const int blocks = grid_for(n4 > 0 ? n4 : n);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  stc_apply_kernel<<<blocks, kThreads, 0, stream>>>(
      x, reinterpret_cast<const float4*>(x), n4, 4 * n4, n, thr, ssum, cnt,
      k, out, reinterpret_cast<float4*>(out));
  return static_cast<int>(cudaGetLastError());
}
