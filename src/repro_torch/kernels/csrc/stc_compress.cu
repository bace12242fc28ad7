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
// puts one block on a row, would run a single tensor on one SM).  They
// serve tensors of more than N_FUSED elements; smaller ones take
// stc_fused_kernel below.
//
// stc_fused_kernel: the whole STC of a tensor of n <= N_FUSED = 131072
// elements in one launch, with tau selected on chip.  It replaces
// _reduce_kernel and _apply_kernel and, for these sizes, the XLA sort that
// the Pallas design leaves tau to ("a global sort would serialize a Pallas
// grid"): on Hopper a tensor this size fits in the registers of one thread
// block cluster, whose blocks read each other's shared memory (DSMEM).
//
// What bounds it: at the host plane's leaves (10 to 16384 elements) the
// launch and the chain of barriers, not the 8n bytes it must move (x read
// once, out written once: 0.04 us at n = 16384); at 16384 also the one
// SM's shared-memory atomics (one per key per pass) and its share of the
// L2 bandwidth.  So the design moves x once and keeps every intermediate
// on chip:
//   * one block per 16384 elements (1024 threads x 4 float4 chunks in
//     registers, chunk j of thread t at j T + t so that a warp's accesses
//     are contiguous; smaller tensors get one block of one thread per
//     chunk), up to a cluster of 8 (portable), launched with the cluster
//     dimension as a launch attribute so that one kernel serves every
//     size (a cluster costs two DSMEM round trips and a cluster barrier
//     per pass, more than it saves below 16384 elements);
//   * tau by radix select on the bit patterns of |x| (for non-negative
//     fp32 values uint32 order is value order, subnormals and +0
//     included): 4 passes of 8-bit digits, each a shared-memory histogram
//     of the digit among the keys that match the prefix so far
//     (integer shared-memory atomics, skipped by a warp vote where no key
//     of the warp matches), summed over the cluster through DSMEM in rank
//     order; the pass picks the digit where the count from the top
//     reaches k.  After the last pass tau is exactly the k-th largest |x|
//     and that pass's histogram holds count_{>tau} and count_{=tau}, per
//     block and in all.  A lone block stops early once the keys that
//     match the prefix fit one warp (at most 32; a tensor of at most 32
//     elements from the start): it gathers them and one warp ranks them
//     by shuffles, which gives the same tau and counts;
//   * each block sums its survivors (|x| >= tau) from registers in a fixed
//     tree; every block reads all partials over DSMEM in rank order, so all
//     form the same sum and mu (stc_mu_ref's formula, __fsub_rn, __fmul_rn,
//     __fdiv_rn), and applies from registers; only the block that straddles
//     the cut ranks its ties (one block-wide scan);
//   * integer atomics only in shared memory and no fp32 atomics: the same
//     input gives the same bits on every run.  No global scratch, no
//     ticket, no fence; a final cluster barrier keeps each block's shared
//     memory alive while peers may still read it.
//
// stc_fused_kernel<true> is the same kernel over the rows of a (C, n)
// block against a shared reference row: the masked per-row STC of the
// fleet plane's hops and uplinks (repro_torch.kernels.diffusion.
// stc_rows_fused_cuda).  It replaces repro/kernels/diffusion.py's
// _stc_reduce_kernel and _stc_apply_kernel (stc_rows_pallas) and, for rows
// of n <= N_FUSED, the per-row XLA sort the reference leaves tau_c to.
// The grid is (ctas, C) with clusters of (ctas, 1, 1): each cluster takes
// one row (blockIdx.y), row offsets in 64 bits.  A block loads its segment
// of x_c and of ref and selects on delta = x_c - ref in registers; the
// output is ref + mu_c * sign(delta) on the row's k survivors and ref + 0
// elsewhere, the plain version's r + tern (stc_rows_apply_ref), so a -0 in
// ref comes out as it does there.  ref is read again for that sum, from
// L1/L2 (every row reads the same row), rather than held in 16 more
// registers through the select.  The blocks of a row whose mask is 0 copy
// x_c and leave.  tau_c, the survivor sum and count go to (C,) outputs, 0
// for unmasked rows.  At the fcn fleet's (8, n) leaves each row is one
// block on its own SM; at C > 132 rows the blocks run in waves.
#include <cooperative_groups.h>
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

namespace cg = cooperative_groups;

constexpr int kChunks = 4;                  // float4 chunks per thread
constexpr int kVpt = 4 * kChunks;           // values per thread
constexpr int kFusedThreads = 1024;
constexpr int kFusedSeg = kVpt * kFusedThreads;   // elements per block
constexpr int kMaxCluster = 8;              // portable cluster size
constexpr int kFusedMaxN = kFusedSeg * kMaxCluster;
constexpr int kMaxRows = 65535;             // rows: gridDim.y
constexpr int kBins = 256;                  // 8-bit digits
constexpr int kPasses = 4;
constexpr int kCands = 32;                  // keys one warp ranks directly

__device__ __forceinline__ unsigned mag_key(float v) {
  return __float_as_uint(fabsf(v));        // -0 and +0 key alike
}

// Exclusive prefix of v over the block's threads in thread order, for any
// block of whole warps (64-bit, so that four 16-bit counts scan at once);
// `total` gets the block's sum.
__device__ __forceinline__ unsigned long long block_scan_u64(
    unsigned long long v, unsigned long long& total) {
  __shared__ unsigned long long w_sum[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  unsigned long long inc = v;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned long long u = __shfl_up_sync(0xffffffffu, inc, o);
    if (lane >= o) inc += u;
  }
  if (lane == 31) w_sum[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    unsigned long long w = lane < warps ? w_sum[lane] : 0ull;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const unsigned long long u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    if (lane < warps) w_sum[lane] = w;
  }
  __syncthreads();
  total = w_sum[warps - 1];
  return inc - v + (warp > 0 ? w_sum[warp - 1] : 0ull);
}

// Block-wide fp32 sum in a fixed order (shuffle tree per warp, then the
// warps' partials in a shuffle tree); valid in thread 0.
__device__ __forceinline__ float block_sum_any(float s) {
  __shared__ float w_part[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  s = warp_sum(s);
  if (lane == 0) w_part[warp] = s;
  __syncthreads();
  if (warp == 0) {
    s = lane < static_cast<int>(blockDim.x >> 5) ? w_part[lane] : 0.f;
    s = warp_sum(s);
  }
  return s;
}

// Four consecutive values of p from index i, m of them in range (0 to 4,
// the rest 0); a float4 load when vec.
__device__ __forceinline__ void load_chunk(const float* __restrict__ p,
                                           bool vec, int i, int m,
                                           float (&q)[4]) {
  if (m == 4 && vec) {
    const float4 f = __ldg(reinterpret_cast<const float4*>(p + i));
    q[0] = f.x; q[1] = f.y; q[2] = f.z; q[3] = f.w;
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) q[u] = u < m ? __ldg(p + i + u) : 0.f;
  }
}

__device__ __forceinline__ void store_chunk(float* __restrict__ p, bool vec,
                                            int i, int m,
                                            const float (&q)[4]) {
  if (m == 4 && vec) {
    *reinterpret_cast<float4*>(p + i) = make_float4(q[0], q[1], q[2], q[3]);
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      if (u < m) p[i + u] = q[u];
    }
  }
}

// A cluster of ctas blocks of T threads (ctas = gridDim.x, the cluster
// dimension) per row; kRows: row blockIdx.y of a (C, n) block, its values
// x_c - ref, else one flat tensor (C = 1).  Block r covers elements
// [16 T r, 16 T (r + 1)) of the row; thread t holds its float4 chunks t,
// T + t, 2T + t and 3T + t of that segment, so a warp's loads and stores
// are contiguous.  Index order within a block is (chunk slot, thread, lane
// of the float4).
template <bool kRows>
__global__ void __launch_bounds__(kFusedThreads)
stc_fused_kernel(const float* __restrict__ x, const float* __restrict__ ref,
                 const int* __restrict__ mask, bool vec_in, bool vec_out,
                 int n, int k, float* __restrict__ out,
                 float* __restrict__ out_thr, float* __restrict__ out_sum,
                 int* __restrict__ out_cnt) {
  cg::cluster_group cluster = cg::this_cluster();
  const int ctas = static_cast<int>(gridDim.x);
  const int rank = ctas > 1 ? static_cast<int>(cluster.block_rank()) : 0;
  const int T = static_cast<int>(blockDim.x);
  const int tid = static_cast<int>(threadIdx.x);
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = kRows ? static_cast<int>(blockIdx.y) : 0;
  const long long off = static_cast<long long>(row) * n;
  x += off;
  out += off;

  const int base = rank * kVpt * T;
  int valid[kChunks];                      // values of each chunk in [0, n)
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int left = n - (base + 4 * (j * T + tid));
    valid[j] = left >= 4 ? 4 : (left > 0 ? left : 0);
  }
  if (kRows && mask[row] == 0) {
    // An unmasked row passes through bit for bit; the whole cluster leaves
    // here, before any cluster barrier.
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      const int i = base + 4 * (j * T + tid);
      float q[4];
      load_chunk(x, vec_in, i, valid[j], q);
      store_chunk(out, vec_out, i, valid[j], q);
    }
    if (rank == 0 && tid == 0) {
      out_thr[row] = 0.f;
      out_sum[row] = 0.f;
      out_cnt[row] = 0;
    }
    return;
  }

  __shared__ int hist[kPasses][kBins];     // this block's counts
  __shared__ int sum_hist[kBins];          // the cluster's, by digit
  __shared__ int below_hist[kBins];        // lower ranks', last pass
  __shared__ unsigned cand[kCands];        // keys left for a warp to rank
  __shared__ int s_ncand;
  __shared__ unsigned s_digit, s_key;
  __shared__ int s_above, s_eq, s_before;
  __shared__ float s_part, s_total;

  for (int b = tid; b < kPasses * kBins; b += T) (&hist[0][0])[b] = 0;
  if (tid == 0) s_ncand = 0;
  float v[kVpt];                           // x, or delta = x_c - ref
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int i = base + 4 * (j * T + tid);
    float q[4];
    load_chunk(x, vec_in, i, valid[j], q);
    if (kRows) {
      float r[4];
      load_chunk(ref, vec_in, i, valid[j], r);
#pragma unroll
      for (int u = 0; u < 4; ++u) q[u] -= r[u];
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) v[4 * j + u] = q[u];
  }
  __syncthreads();

  // Radix select: prefix holds the digits chosen so far, rem the rank of
  // tau among the keys that match it (from the top, 1-based), above the
  // keys past the prefix (> tau once all four digits are chosen), left
  // the keys that match it.
  unsigned prefix = 0u;
  int rem = k, above = 0, left = n;
#pragma unroll 1
  for (int p = 0; p < kPasses; ++p) {
    const int shift = 24 - 8 * p;
    if (ctas == 1 && left <= kCands) {
      // The keys that match the prefix fit one warp: rank them there.
#pragma unroll
      for (int e = 0; e < kVpt; ++e) {
        const unsigned key = mag_key(v[e]);
        if ((e & 3) < valid[e >> 2] &&
            (p == 0 || (key >> (shift + 8)) == prefix)) {
          cand[atomicAdd(&s_ncand, 1)] = key;
        }
      }
      __syncthreads();
      if (warp == 0) {
        const int nc = s_ncand;
        const unsigned c = lane < nc ? cand[lane] : 0u;
        int gt = 0, eq = 0;
#pragma unroll
        for (int o = 0; o < kCands; ++o) {
          const unsigned d = __shfl_sync(0xffffffffu, c, o);
          gt += o < nc && d > c;
          eq += o < nc && d == c;
        }
        if (lane < nc && gt < rem && rem <= gt + eq) {
          s_key = c;                       // lanes that write share c
          s_above = gt;
          s_eq = eq;
        }
      }
      __syncthreads();
      prefix = s_key;                      // the whole key of tau
      rem -= s_above;
      above += s_above;
      break;
    }
#pragma unroll
    for (int e = 0; e < kVpt; ++e) {
      const unsigned key = mag_key(v[e]);
      const bool live = (e & 3) < valid[e >> 2] &&
                        (p == 0 || (key >> (shift + 8)) == prefix);
      if (__any_sync(0xffffffffu, live) && live) {
        atomicAdd(&hist[p][(key >> shift) & (kBins - 1)], 1);
      }
    }
    const int* h = &hist[p][0];
    if (ctas > 1) {
      // Every block sums the cluster's counts itself, in rank order.
      cluster.sync();
      for (int b = tid; b < kBins; b += T) {
        int tot = 0, below = 0;
#pragma unroll
        for (int r = 0; r < kMaxCluster; ++r) {
          if (r < ctas) {
            const int c = cluster.map_shared_rank(&hist[p][0], r)[b];
            tot += c;
            below += r < rank ? c : 0;
          }
        }
        sum_hist[b] = tot;
        below_hist[b] = below;
      }
      h = sum_hist;
    }
    __syncthreads();
    if (warp == 0) {
      // Lane l holds digits 255 - 8l ... 248 - 8l.
      int c[8], tot = 0;
#pragma unroll
      for (int u = 0; u < 8; ++u) {
        c[u] = h[kBins - 1 - 8 * lane - u];
        tot += c[u];
      }
      int inc = tot;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const int w = __shfl_up_sync(0xffffffffu, inc, o);
        if (lane >= o) inc += w;
      }
      int run = inc - tot;
      if (run < rem && rem <= inc) {
        bool found = false;
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          if (!found && run + c[u] >= rem) {
            found = true;
            const unsigned d = kBins - 1 - 8 * lane - u;
            s_digit = d;
            s_above = run;
            s_eq = c[u];
            s_before = ctas > 1 ? below_hist[d] : 0;
          }
          run += c[u];
        }
      }
    }
    __syncthreads();
    prefix = (prefix << 8) | s_digit;
    rem -= s_above;
    above += s_above;
    left = s_eq;
  }
  const float t = __uint_as_float(prefix);
  const int tied = s_eq;                   // |x| == tau in the cluster
  const int need = rem;                    // ties that survive, >= 1
  const int before = ctas > 1 ? s_before : 0;    // ties in lower ranks
  const int own = ctas > 1 ? hist[kPasses - 1][prefix & (kBins - 1)] : tied;
  const int count = above + tied;          // |x| >= tau

  // The survivors' sum, per block in a fixed order, then over the cluster
  // in rank order: every block forms the same bits.
  float s = 0.f;
#pragma unroll
  for (int e = 0; e < kVpt; ++e) {
    const float a = fabsf(v[e]);
    if ((e & 3) < valid[e >> 2] && a >= t) s += a;
  }
  s = block_sum_any(s);
  if (ctas > 1) {
    if (tid == 0) s_part = s;
    cluster.sync();
    if (tid == 0) {
      float part[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        part[r] = r < ctas ? *cluster.map_shared_rank(&s_part, r) : 0.f;
      }
      s = 0.f;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) {
        if (r < ctas) s += part[r];
      }
    }
  }
  if (tid == 0) s_total = s;
  __syncthreads();
  const float total = s_total;
  const float extra = static_cast<float>(count - k);
  const float mu = __fdiv_rn(__fsub_rn(total, __fmul_rn(extra, t)),
                             static_cast<float>(k));

  // Keep every |x| > tau and the first `need` ties in index order.
  const bool all_ties = t == 0.f || need >= tied || before + own <= need;
  bool keep[kVpt];
  unsigned long long mine = 0ull;          // ties per chunk, 16 bits each
#pragma unroll
  for (int e = 0; e < kVpt; ++e) {
    const unsigned key = mag_key(v[e]);
    keep[e] = key > prefix;
    if ((e & 3) < valid[e >> 2] && key == prefix) {
      keep[e] = all_ties;
      mine += 1ull << (16 * (e >> 2));
    }
  }
  if (!all_ties && before < need) {        // this block straddles the cut
    unsigned long long slot_total;
    const unsigned long long exc = block_scan_u64(mine, slot_total);
    int slot_base = before;
#pragma unroll
    for (int j = 0; j < kChunks; ++j) {
      int r = slot_base + static_cast<int>((exc >> (16 * j)) & 0xffffu);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int e = 4 * j + u;
        if (u < valid[j] && mag_key(v[e]) == prefix) keep[e] = r++ < need;
      }
      slot_base += static_cast<int>((slot_total >> (16 * j)) & 0xffffu);
    }
  }
#pragma unroll
  for (int j = 0; j < kChunks; ++j) {
    const int i = base + 4 * (j * T + tid);
    float o[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      o[u] = ternary(v[4 * j + u], keep[4 * j + u], mu);
    }
    if (kRows) {
      // ref + tern, as the plain version forms it (ref + 0 off the
      // survivors).
      float r[4];
      load_chunk(ref, vec_in, i, valid[j], r);
#pragma unroll
      for (int u = 0; u < 4; ++u) o[u] = r[u] + o[u];
    }
    store_chunk(out, vec_out, i, valid[j], o);
  }
  if (rank == 0 && tid == 0) {
    out_thr[row] = t;
    out_sum[row] = total;
    out_cnt[row] = count;
  }
  // No block leaves while a peer may still read its shared memory.
  if (ctas > 1) cluster.sync();
}

// One launch of stc_fused_kernel<kRows> over `rows` rows of n: a cluster
// of ceil(n / 16384) blocks per row.  Returns the launch's error or
// cudaGetLastError().
template <bool kRows>
int launch_fused(const float* x, const float* ref, const int* mask,
                 float* out, float* thr, float* ssum, int* cnt, int rows,
                 int n, int k, cudaStream_t stream) {
  if (rows < 1 || rows > kMaxRows || n <= 0 || n > kFusedMaxN || k < 1 ||
      k > n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  // One block of 1024 threads per 16384 elements; a row that fits one
  // block takes one thread per float4 chunk (whole warps, at most 1024).
  const int ctas = (n + kFusedSeg - 1) / kFusedSeg;
  int threads = kFusedThreads;
  if (ctas == 1) {
    const int chunks = (n + 3) / 4;
    threads = chunks >= kFusedThreads ? kFusedThreads
                                      : (chunks + 31) / 32 * 32;
  }
  // Rows after the first start 16-byte aligned only where n % 4 == 0.
  const bool rows_aligned = rows == 1 || n % 4 == 0;
  const bool vec_in =
      rows_aligned && aligned16(x) && (ref == nullptr || aligned16(ref));
  const bool vec_out = rows_aligned && aligned16(out);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(ctas, rows, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = ctas;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, stc_fused_kernel<kRows>, x, ref, mask, vec_in, vec_out, n, k,
      out, thr, ssum, cnt);
  if (err != cudaSuccess) {
    cudaGetLastError();
    return static_cast<int>(err);
  }
  return static_cast<int>(cudaGetLastError());
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

// Largest tensor stc_fused takes (N_FUSED): a cluster of 8 blocks of 16384.
extern "C" int repro_stc_fused_max_n() { return kFusedMaxN; }

// x (n,) fp32 in, k the number of entries STC keeps (1 <= k <= n); out (n,)
// fp32 = mu * sign(x) on the k survivors, thr (1,) fp32 = tau, ssum (1,)
// fp32 = the sum of |x| >= tau, cnt (1,) int32 = their count.  Contiguous,
// on the current device, n <= N_FUSED.  One launch: a cluster of
// ceil(n / 16384) blocks.  Returns the launch's error or
// cudaGetLastError().
extern "C" int repro_stc_fused_f32(const float* x, float* out, float* thr,
                                   float* ssum, int* cnt, int n, int k,
                                   cudaStream_t stream) {
  return launch_fused<false>(x, nullptr, nullptr, out, thr, ssum, cnt, 1, n,
                             k, stream);
}

// The masked per-row STC of x (C, n) against ref (n,), fp32, mask (C,)
// int32, k the entries kept per masked row (1 <= k <= n): out (C, n) fp32
// = ref + mu_c * sign(x_c - ref) on row c's k survivors and ref elsewhere
// where mask[c], x_c bit for bit where not; thr, ssum (C,) fp32 and cnt
// (C,) int32 = tau_c, the sum and count of |x_c - ref| >= tau_c (0 where
// mask[c] == 0).  Contiguous, on the current device, n <= N_FUSED,
// C <= 65535.  One launch.  Returns the launch's error or
// cudaGetLastError().
extern "C" int repro_stc_rows_fused_f32(const float* x, const float* ref,
                                        const int* mask, float* out,
                                        float* thr, float* ssum, int* cnt,
                                        int C, int n, int k,
                                        cudaStream_t stream) {
  return launch_fused<true>(x, ref, mask, out, thr, ssum, cnt, C, n, k,
                            stream);
}
