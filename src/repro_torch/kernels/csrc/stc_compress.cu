// stc_compress: whole-tensor sparse ternary compression (Sattler et al.),
// the STC of the host data plane: the compressed D2D hops of feddif_stc and
// the STC uplink of stc, one call per slot and per leaf.  For a flat fp32
// tensor x of n elements and the threshold tau (the k-th largest |x|,
// computed outside these kernels with torch.topk, as the reference leaves it
// to an XLA sort):
//   reduce: sum = SUM |x_i| * 1[|x_i| >= tau],  count = SUM 1[|x_i| >= tau],
//           and per block the number of |x_i| == tau (the ties)
//   apply:  out_i = mu * sign(x_i) on the k survivors, 0 elsewhere,
//           mu = (sum - (count - k) * tau) / k
//
// Replaces the TPU kernels of repro/kernels/stc_compress.py:
//   _reduce_kernel (stc_reduce_pallas) -> stc_reduce_kernel
//   _apply_kernel  (stc_apply_pallas)  -> stc_apply_kernel
//
// Semantics: exactly k survivors, the ones lax.top_k keeps (the plain
// version of record, repro_torch.kernels.ref.stc_compress_ref, like the
// reference's host STC): every |x| > tau, plus the first k - count_{>tau}
// entries with |x| == tau in index order.  (The Pallas kernels keep every
// |x| >= tau, so they send the tied entries past the k-th as well.)  mu is
// the mean of the k survivors' magnitudes: the count - k entries of
// |x| >= tau left out all equal tau, so the top-k sum is
// sum - (count - k) * tau.  The largest tie is tau == 0, a tensor with
// fewer than k nonzeros (rows no batch touched): mu = sum / k, and the
// zeros kept map to 0.  Counts are int32, exact for any n < 2^31 (the
// Pallas kernel's fp32 count is exact only up to 2^24).
//
// What bounds them on the H100: memory.  Reduce reads 4n bytes for ~3 flops
// per element; apply reads 4n and writes 4n bytes.  At the fcn leaves
// (n <= 16384) both are launch-bound.
//
// Design.  The Pallas reduce carries its sums across a grid that runs in
// order; on the card blocks run in parallel and in no order, so:
//   * both kernels cut x into the same contiguous segments, one per block
//     (the grid depends only on n and the SM count), walked in tiles of
//     4 * kThreads elements, 16-byte float4 loads where x is 16-byte
//     aligned.  Reduce writes one partial per block, an fp32 sum and int
//     counts, from a fixed warp-shuffle + shared-memory tree.  The last
//     block to finish (an integer atomic ticket, no fp32 atomics) adds the
//     partials in block order, in a fixed tree, and turns the per-block tie
//     counts into their exclusive prefix (entry `blocks` holds the total).
//     The same input gives the same bits on every run on one card.
//   * apply reads tau, sum, count and the tie prefix from device memory and
//     forms mu itself (k is a launch argument: it depends only on n and the
//     sparsity), so no host read sits between the two passes.  Where the
//     ties all survive (count == k, the tie-free case) or tau == 0 (a kept
//     zero maps to 0) it keeps every |x| >= tau.  Otherwise a block whose
//     ties fall wholly before or after the cut keeps all or none of them;
//     only the block that straddles it ranks its ties, a block-wide scan
//     per tile.
// One launch each; a whole tensor spreads over every SM (stc_rows, which
// puts one block on a row, would run a single tensor on one SM).
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 4 * kThreads;  // elements per block step
constexpr int kBlocksPerSm = 4;
constexpr int kMaxBlocks = 1024;     // the wrapper's partials buffers

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

// Block-wide (sum, count, ties) in a fixed order; valid in thread 0.
__device__ __forceinline__ void block_sum(float& s, int& k, int& e) {
  __shared__ float s_part[kWarps];
  __shared__ int k_part[kWarps];
  __shared__ int e_part[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  s = warp_sum(s);
  k = warp_sum(k);
  e = warp_sum(e);
  if (lane == 0) {
    s_part[warp] = s;
    k_part[warp] = k;
    e_part[warp] = e;
  }
  __syncthreads();
  if (warp == 0) {
    s = lane < kWarps ? s_part[lane] : 0.f;
    k = lane < kWarps ? k_part[lane] : 0;
    e = lane < kWarps ? e_part[lane] : 0;
    s = warp_sum(s);
    k = warp_sum(k);
    e = warp_sum(e);
  }
}

// Exclusive prefix of v over the block's threads in thread order; `total`
// gets the block's sum.  Every thread of the block must call it.
__device__ __forceinline__ int block_scan(int v, int& total) {
  __shared__ int w_sum[kWarps];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) w_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    int w = lane < kWarps ? w_sum[lane] : 0;
#pragma unroll
    for (int o = 1; o < kWarps; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < kWarps) w_sum[lane] = w;
  }
  __syncthreads();
  const int exc = inc - v + (warp > 0 ? w_sum[warp - 1] : 0);
  total = w_sum[kWarps - 1];
  __syncthreads();           // w_sum is reused by the next call
  return exc;
}

// The four elements of thread `threadIdx.x` in the tile at `base`, with
// `m` of them inside [0, n) (0 to 4); a float4 load when `vec`.
__device__ __forceinline__ int load4(const float* __restrict__ x, bool vec,
                                     long long base, long long end,
                                     float (&v)[4]) {
  const long long i = base + 4ll * threadIdx.x;
  const long long left = end - i;
  const int m = left >= 4 ? 4 : (left > 0 ? static_cast<int>(left) : 0);
  if (m == 4 && vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(x + i));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = u < m ? __ldg(x + i + u) : 0.f;
  }
  return m;
}

__global__ void __launch_bounds__(kThreads)
stc_reduce_kernel(const float* __restrict__ x, bool vec, long long n,
                  long long seg, const float* __restrict__ thr,
                  float* __restrict__ part_sum, int* __restrict__ part_cnt,
                  int* __restrict__ ties, unsigned* __restrict__ ticket,
                  float* __restrict__ out_sum, int* __restrict__ out_cnt) {
  const float t = thr[0];
  const long long start = seg * blockIdx.x;
  const long long end = start + seg < n ? start + seg : n;
  float s = 0.f;
  int k = 0, e = 0;
  for (long long base = start; base < end; base += kTile) {
    float v[4];
    const int m = load4(x, vec, base, end, v);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float a = fabsf(v[u]);
      if (u < m && a >= t) {
        s += a;
        ++k;
        e += a == t;
      }
    }
  }
  block_sum(s, k, e);

  __shared__ bool last;
  if (threadIdx.x == 0) {
    part_sum[blockIdx.x] = s;
    part_cnt[blockIdx.x] = k;
    ties[blockIdx.x] = e;
    __threadfence();          // partials visible before the ticket is taken
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  // The last block: the partials in block order, a fixed tree.
  const int blocks = static_cast<int>(gridDim.x);
  s = 0.f;
  k = 0;
  e = 0;
  for (int b = threadIdx.x; b < blocks; b += kThreads) {
    s += __ldcg(part_sum + b);
    k += __ldcg(part_cnt + b);
  }
  __syncthreads();            // block_sum's shared buffers are reused
  block_sum(s, k, e);
  if (threadIdx.x == 0) {
    out_sum[0] = s;
    out_cnt[0] = k;
    ticket[0] = 0u;
  }
  // The per-block tie counts become their exclusive prefix: thread i owns
  // entries 4i..4i+3 (blocks <= kMaxBlocks = 4 * kThreads).
  int own[4], mine = 0;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int b = 4 * threadIdx.x + u;
    own[u] = b < blocks ? __ldcg(ties + b) : 0;
    mine += own[u];
  }
  int total;
  int run = block_scan(mine, total);
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int b = 4 * threadIdx.x + u;
    if (b < blocks) ties[b] = run;
    run += own[u];
  }
  if (threadIdx.x == 0) ties[blocks] = total;
}

__device__ __forceinline__ float ternary(float v, bool keep, float mu) {
  if (!keep) return 0.f;
  return v > 0.f ? mu : (v < 0.f ? -mu : 0.f);
}

__global__ void __launch_bounds__(kThreads)
stc_apply_kernel(const float* __restrict__ x, bool vec, long long n,
                 long long seg, const float* __restrict__ thr,
                 const float* __restrict__ ssum, const int* __restrict__ cnt,
                 const int* __restrict__ ties, int k,
                 float* __restrict__ out) {
  const float t = thr[0];
  const float extra = static_cast<float>(cnt[0] - k);
  const float mu = __fdiv_rn(__fsub_rn(ssum[0], __fmul_rn(extra, t)),
                             static_cast<float>(k));
  const int blocks = static_cast<int>(gridDim.x);
  const int tied = ties[blocks];             // entries with |x| == tau
  const int need = k - (cnt[0] - tied);      // ties that survive
  const int before = ties[blockIdx.x];       // ties in earlier blocks
  const int own = ties[blockIdx.x + 1] - before;
  // -1: keep every tie of this block; 0: none; 1: rank them.
  const int mode = (need >= tied || t == 0.f || before + own <= need) ? -1
                   : (before >= need ? 0 : 1);
  const long long start = seg * blockIdx.x;
  const long long end = start + seg < n ? start + seg : n;
  int run = before;                          // ties before this tile
  for (long long base = start; base < end; base += kTile) {
    float v[4];
    const int m = load4(x, vec, base, end, v);
    bool keep[4];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float a = fabsf(v[u]);
      keep[u] = a > t;
      if (u < m && a == t) {
        keep[u] = mode < 0;
        ++mine;
      }
    }
    if (mode > 0) {
      int tile_ties;
      int rank = run + block_scan(mine, tile_ties);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < m && fabsf(v[u]) == t) keep[u] = rank++ < need;
      }
      run += tile_ties;
    }
    const long long i = base + 4ll * threadIdx.x;
    if (m == 4 && vec) {
      *reinterpret_cast<float4*>(out + i) = make_float4(
          ternary(v[0], keep[0], mu), ternary(v[1], keep[1], mu),
          ternary(v[2], keep[2], mu), ternary(v[3], keep[3], mu));
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < m) out[i + u] = ternary(v[u], keep[u], mu);
      }
    }
  }
}

// The grid and the segment of each block: as many blocks as fill the SMs
// (kBlocksPerSm each, at most kMaxBlocks) without a block of less than one
// tile, segments a whole number of tiles.  Depends only on n and the SM
// count, so reduce and apply cut x alike.  Returns 0 blocks on a device
// query error.
int plan(long long n, long long* seg) {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess) {
    return 0;
  }
  const long long tiles = (n + kTile - 1) / kTile;
  long long cap = static_cast<long long>(sms) * kBlocksPerSm;
  if (cap > kMaxBlocks) cap = kMaxBlocks;
  const long long per = (tiles + cap - 1) / cap;   // tiles per block
  *seg = per * kTile;
  return static_cast<int>((tiles + per - 1) / per);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace

// Largest grid the reduce launches: the size of its partials buffers (the
// tie prefix takes one entry more).
extern "C" int repro_stc_reduce_max_blocks() { return kMaxBlocks; }

// x (n,) and thr (1,) fp32 in; part_sum (kMaxBlocks,) fp32 and part_cnt
// (kMaxBlocks,) int32 scratch; ticket (1,) uint32 scratch holding 0 (left
// at 0); out_sum (1,) fp32, out_cnt (1,) int32 and ties (kMaxBlocks + 1,)
// int32 (the tie prefix for the apply) out.  Contiguous, on the current
// device.  Returns cudaGetLastError().
extern "C" int repro_stc_reduce_f32(const float* x, const float* thr,
                                    float* part_sum, int* part_cnt,
                                    int* ties, unsigned* ticket,
                                    float* out_sum, int* out_cnt, long long n,
                                    cudaStream_t stream) {
  if (n <= 0) return static_cast<int>(cudaErrorInvalidValue);
  long long seg = 0;
  const int blocks = plan(n, &seg);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  stc_reduce_kernel<<<blocks, kThreads, 0, stream>>>(
      x, aligned16(x), n, seg, thr, part_sum, part_cnt, ties, ticket,
      out_sum, out_cnt);
  return static_cast<int>(cudaGetLastError());
}

// x (n,), thr (1,), ssum (1,) fp32, cnt (1,) int32 and ties (the reduce's
// tie prefix) in, k the number of entries STC keeps (1 <= k <= n); out (n,)
// fp32.  Returns cudaGetLastError().
extern "C" int repro_stc_apply_f32(const float* x, const float* thr,
                                   const float* ssum, const int* cnt,
                                   const int* ties, int k, float* out,
                                   long long n, cudaStream_t stream) {
  if (n <= 0 || k < 1 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  long long seg = 0;
  const int blocks = plan(n, &seg);
  if (blocks == 0) return static_cast<int>(cudaGetLastError());
  stc_apply_kernel<<<blocks, kThreads, 0, stream>>>(
      x, aligned16(x) && aligned16(out), n, seg, thr, ssum, cnt, ties, k,
      out);
  return static_cast<int>(cudaGetLastError());
}
