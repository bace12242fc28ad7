// stc_rows: masked per-row sparse ternary compression against a shared
// reference row (the STC-compressed D2D hops of feddif_stc and the STC
// uplink of stc).  For row c of x (C, n) with mask[c], delta = x_c - ref:
//   out[c] = ref + mu_c * sign(delta) on the row's k survivors, ref elsewhere
// and out[c] = x[c] bit for bit where mask[c] == 0.  tau_c, the k-th largest
// |delta|, is computed outside these kernels (torch.topk), as the reference
// leaves it to an XLA sort.
//
// Replaces the TPU kernels of repro/kernels/diffusion.py::stc_rows_pallas:
//   _stc_reduce_kernel (first pallas_call)  -> stc_reduce_kernel
//   _stc_apply_kernel  (second pallas_call) -> stc_apply_kernel
// for rows of more than N_FUSED = 131072 elements.  Shorter rows (every FL
// leaf) take one launch of stc_fused_kernel<true> in stc_compress.cu, which
// selects each row's tau_c on chip.
//
// Semantics: exactly k survivors per row, the ones lax.top_k keeps (the
// plain version of record, repro_torch.kernels.ref.stc_rows_ref, like
// repro.kernels.ref.stc_rows_ref): every |delta| > tau_c, plus the first
// k - count_{>tau} entries with |delta| == tau_c in index order.  mu_c is
// their mean magnitude, (sum - (count - k) * tau_c) / k from the survivor
// sum and count over |delta| >= tau_c: the count - k entries left out all
// equal tau_c.  At tau_c == 0 (a row with fewer than k nonzero deltas) that
// is sum / k, where sum / count would be sum / n.  (The Pallas kernels keep
// every |delta| >= tau_c at mu = sum / count.)
//
// What bounds them on the H100: memory.  Reduce reads C*n*4 bytes (plus the
// shared ref row) for ~3 flops per element; apply reads and writes C*n*4
// bytes each.
//
// Design: both kernels cut a row into the same contiguous chunks (a whole
// number of 4 * kApplyThreads-element tiles, at most kMaxChunks; they depend
// only on n).  Reduce is one block per row with a block-stride loop over the
// row (float4 loads where the rows are 16-byte aligned): per-thread fp32 sum
// and int count, then a warp-shuffle + shared-memory block reduction — no
// cross-block carry and no fp32 atomics, so a result that does not depend on
// scheduling order.  It also counts each chunk's ties (|delta| == tau_c),
// one integer shared-memory add per warp and step, and writes their
// exclusive prefix over the chunks (the row's total last).  Apply is
// elementwise on
// a (chunk, row) grid; mu_c is formed in the kernel from the reduce outputs,
// so no host step sits between the two.  Where a row's ties all survive or
// tau_c == 0 (a kept zero delta maps to ref) it keeps every |delta| >=
// tau_c; otherwise a chunk whose ties fall wholly before or after the cut
// keeps all or none of them, and only the chunk that straddles it ranks its
// ties, a block-wide scan per tile.
#include <cuda_runtime.h>

namespace {

constexpr int kReduceThreads = 512;
constexpr int kApplyThreads = 256;
constexpr int kTile = 4 * kApplyThreads;   // elements per apply step
constexpr int kMaxChunks = 64;

constexpr int kReduceWarps = kReduceThreads / 32;

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

// Block-wide sum in a fixed order, valid in thread 0.  Every thread of the
// block must call it; `part` is kWarps shared slots.
template <int kThreads, typename T>
__device__ __forceinline__ T block_sum(T v, T* part) {
  constexpr int kWarps = kThreads / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  v = warp_sum(v);
  if (lane == 0) part[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < kWarps ? part[lane] : T(0);
    v = warp_sum(v);
  }
  __syncthreads();           // part is reused by the next call
  return v;
}

// Exclusive prefix of v over the apply block's threads in thread order;
// `total` gets the block's sum.  Every thread of the block must call it.
__device__ __forceinline__ int block_scan(int v, int& total) {
  constexpr int kWarps = kApplyThreads / 32;
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
  __syncthreads();
  return exc;
}

// Four consecutive elements of `row` from index i (m of them below the
// row's end, 0 to 4); a float4 load when `vec`.
__device__ __forceinline__ void load4(const float* __restrict__ row, bool vec,
                                      long long i, int m, float (&v)[4]) {
  if (m == 4 && vec) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(row + i));
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = u < m ? __ldg(row + i + u) : 0.f;
  }
}

__device__ __forceinline__ int in_row(long long i, long long end) {
  const long long left = end - i;
  return left >= 4 ? 4 : (left > 0 ? static_cast<int>(left) : 0);
}

__global__ void __launch_bounds__(kReduceThreads)
stc_reduce_kernel(const float* __restrict__ x, const float* __restrict__ ref,
                  const float* __restrict__ thr, float* __restrict__ ssum,
                  float* __restrict__ cnt, int* __restrict__ ties, int n,
                  int seg, int chunks, bool vec) {
  __shared__ float s_part[kReduceWarps];
  __shared__ int i_part[kReduceWarps];
  __shared__ int chunk_ties[kMaxChunks];
  for (int ch = threadIdx.x; ch < chunks; ch += kReduceThreads) {
    chunk_ties[ch] = 0;
  }
  __syncthreads();
  const int c = blockIdx.x;
  const float* row = x + static_cast<long long>(c) * n;
  const float t = thr[c];
  const int lane = threadIdx.x & 31;
  float s = 0.f;
  int k = 0;
#pragma unroll 4
  for (long long base = 0; base < n; base += 4 * kReduceThreads) {
    const long long i = base + 4ll * threadIdx.x;
    const int m = in_row(i, n);
    float xv[4], rv[4];
    load4(row, vec, i, m, xv);
    load4(ref, vec, i, m, rv);
    int e = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float a = fabsf(xv[u] - rv[u]);
      if (u < m && a >= t) {
        s += a;
        ++k;
        e += a == t;
      }
    }
    // A warp's 128 elements lie in one chunk (chunks are whole tiles):
    // one integer shared-memory add per warp, whose total does not depend
    // on the order.
    e = __reduce_add_sync(0xffffffffu, e);
    if (lane == 0 && e > 0) atomicAdd(&chunk_ties[i / seg], e);
  }
  s = block_sum<kReduceThreads>(s, s_part);
  k = block_sum<kReduceThreads>(k, i_part);
  if (threadIdx.x == 0) {
    ssum[c] = s;
    cnt[c] = static_cast<float>(k);
    int* row_ties = ties + static_cast<long long>(c) * (kMaxChunks + 1);
    int before = 0;
    for (int ch = 0; ch < chunks; ++ch) {
      row_ties[ch] = before;
      before += chunk_ties[ch];
    }
    row_ties[chunks] = before;
  }
}

__global__ void __launch_bounds__(kApplyThreads)
stc_apply_kernel(const float* __restrict__ x, const float* __restrict__ ref,
                 const float* __restrict__ thr, const float* __restrict__ ssum,
                 const float* __restrict__ cnt, const int* __restrict__ ties,
                 const int* __restrict__ mask, float* __restrict__ out,
                 int k, int n, int seg, bool vec) {
  const int c = blockIdx.y;
  const int ch = blockIdx.x;
  const long long off = static_cast<long long>(c) * n;
  const long long start = static_cast<long long>(ch) * seg;
  const long long end = min(start + seg, static_cast<long long>(n));
  if (mask[c] == 0) {
    for (long long i = start + threadIdx.x; i < end; i += kApplyThreads) {
      out[off + i] = x[off + i];
    }
    return;
  }
  const float t = thr[c];
  const float extra = __fsub_rn(cnt[c], static_cast<float>(k));
  const float mu = __fdiv_rn(__fsub_rn(ssum[c], __fmul_rn(extra, t)),
                             static_cast<float>(k));
  const int* row_ties = ties + static_cast<long long>(c) * (kMaxChunks + 1);
  const int tied = row_ties[gridDim.x];        // |delta| == tau_c in the row
  const int need = k - (static_cast<int>(cnt[c]) - tied);
  const int before = row_ties[ch];             // ties in earlier chunks
  const int own = row_ties[ch + 1] - before;
  // -1: keep every tie of this chunk; 0: none; 1: rank them.
  const int mode = (need >= tied || t == 0.f || before + own <= need) ? -1
                   : (before >= need ? 0 : 1);
  int run = before;
  for (long long base = start; base < end; base += kTile) {
    const long long i = base + 4ll * threadIdx.x;
    const int m = in_row(i, end);
    float xv[4], rv[4];
    load4(x + off, vec, i, m, xv);
    load4(ref, vec, i, m, rv);
    bool keep[4];
    int mine = 0;
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float a = fabsf(xv[u] - rv[u]);
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
        if (u < m && fabsf(xv[u] - rv[u]) == t) keep[u] = rank++ < need;
      }
      run += tile_ties;
    }
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float d = xv[u] - rv[u];
      const float sgn = d > 0.f ? 1.f : (d < 0.f ? -1.f : 0.f);
      o[u] = rv[u] + (keep[u] ? sgn * mu : 0.f);
    }
    if (m == 4 && vec) {
      *reinterpret_cast<float4*>(out + off + i) =
          make_float4(o[0], o[1], o[2], o[3]);
    } else {
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        if (u < m) out[off + i + u] = o[u];
      }
    }
  }
}

// Chunks of a row of n: a whole number of tiles each, at most kMaxChunks.
int plan(int n, int* seg) {
  const int tiles = (n + kTile - 1) / kTile;
  const int per = (tiles + kMaxChunks - 1) / kMaxChunks;
  *seg = per * kTile;
  return (tiles + per - 1) / per;
}

bool aligned16(const void* p) {
  return (reinterpret_cast<unsigned long long>(p) & 15ull) == 0;
}

}  // namespace

// Columns of the tie-prefix buffer per row, less one.
extern "C" int repro_stc_rows_max_chunks() { return kMaxChunks; }

// x (C, n), ref (n,), thr (C,) in; ssum (C,), cnt (C,) fp32 and ties
// (C, kMaxChunks + 1) int32 (each row's tie prefix over its chunks, then
// its total) out.  Contiguous, on the current device.  Returns
// cudaGetLastError().
extern "C" int repro_stc_rows_reduce_f32(const float* x, const float* ref,
                                         const float* thr, float* ssum,
                                         float* cnt, int* ties, int C, int n,
                                         cudaStream_t stream) {
  if (C <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  int seg = 0;
  const int chunks = plan(n, &seg);
  const bool vec = n % 4 == 0 && aligned16(x) && aligned16(ref);
  stc_reduce_kernel<<<C, kReduceThreads, 0, stream>>>(
      x, ref, thr, ssum, cnt, ties, n, seg, chunks, vec);
  return static_cast<int>(cudaGetLastError());
}

// x (C, n), ref (n,), thr/ssum/cnt (C,) fp32, ties (the reduce's tie
// prefix) and mask (C,) int32 in, k the entries STC keeps per row
// (1 <= k <= n); out (C, n) fp32.  Returns cudaGetLastError().
extern "C" int repro_stc_rows_apply_f32(const float* x, const float* ref,
                                        const float* thr, const float* ssum,
                                        const float* cnt, const int* ties,
                                        const int* mask, float* out, int k,
                                        int C, int n, cudaStream_t stream) {
  if (C <= 0 || n <= 0) return static_cast<int>(cudaSuccess);
  if (k < 1 || k > n) return static_cast<int>(cudaErrorInvalidValue);
  int seg = 0;
  const int chunks = plan(n, &seg);
  const bool vec =
      n % 4 == 0 && aligned16(x) && aligned16(ref) && aligned16(out);
  const dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(C));
  stc_apply_kernel<<<grid, kApplyThreads, 0, stream>>>(
      x, ref, thr, ssum, cnt, ties, mask, out, k, n, seg, vec);
  return static_cast<int>(cudaGetLastError());
}
