// mix_aggregate: the Eq.-10/11 weighted reduction of the FL data plane,
//   out[g, f] = sum_c w[g, c] * x[c, f]      x (C, F), w (G, C), out (G, F), fp32
// over the flattened client-stacked fleet (repro_torch.kernels.diffusion
// .stack_ravel).  Eq.-11 aggregation is G = 1 (every round of every
// strategy); a MixOp is G = C.
//
// Replaces the TPU kernel repro/kernels/diffusion.py::_mix_kernel (the
// pallas_call in mix_aggregate_pallas), which streamed (BC, BF) client tiles
// through VMEM into a revolving (G, BF) output block on the MXU.
//
// What bounds it on the H100: memory.  At G = 1 it is a GEMV down the client
// axis over a long feature axis: C*F*4 bytes read for 2*C*F flops, about
// 0.5 flop per byte against the card's ~20 flop/byte fp32 ridge.
//
// Design: a block owns 32 consecutive feature columns and GT output rows.
// Its 8 warps split the client axis (warp k takes rows k, k+8, ...) and
// each lane owns one column, so a warp reads 128 contiguous bytes per row
// (one coalesced transaction) and many independent rows are in flight per
// SM.  Lanes accumulate in fp32 registers with fmaf; w[g, c] is the same
// address for the whole warp (a broadcast through L1).  The 8 per-warp
// partials meet in shared memory and one pass sums them and writes
// coalesced rows of out.  No cross-block carry: the whole client axis lives
// inside the block.  Each x element is read once per GT-row tile, i.e. once
// in all at G <= GT.  Loads are 4 bytes a lane: the main path's F (26122,
// 22554) is not a multiple of 4, so 16-byte loads would not stay aligned
// across rows.  w is read through L1 rather than staged in shared memory.
// mix_tree_kernel below takes the alternatives where a leaf allows them
// (16-byte loads, w from the kernel's parameters, no shared-memory reduce
// at C <= 8).  Measured on an H100 (PERF.md §6, row 17): this kernel 2.12 us
// on the fcn block (8, 26122, 1) and 3.43 on the lm model's
// (8, 77312, 1); mix_tree_kernel 2.10 and 2.30 on the same trees.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;

template <int GT>
__global__ void __launch_bounds__(kThreads)
mix_aggregate_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int C, int F, int G) {
  __shared__ float part[kWarps][GT][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g0 = blockIdx.y * GT;
  const long long f = static_cast<long long>(blockIdx.x) * kCols + lane;

  float acc[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) acc[g] = 0.f;

  if (f < F) {
    const float* xp = x + static_cast<size_t>(warp) * F + f;
    const size_t stride = static_cast<size_t>(kWarps) * F;
#pragma unroll 4
    for (int c = warp; c < C; c += kWarps, xp += stride) {
      const float xv = __ldg(xp);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        // Rows past G read row G-1 (a valid address); they are never stored.
        const int gr = min(g0 + g, G - 1);
        acc[g] = fmaf(__ldg(w + static_cast<size_t>(gr) * C + c), xv, acc[g]);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GT; ++g) part[warp][g][lane] = acc[g];
  __syncthreads();

  for (int i = threadIdx.x; i < GT * kCols; i += kThreads) {
    const int g = i / kCols;
    const int col = i % kCols;
    const long long fc = static_cast<long long>(blockIdx.x) * kCols + col;
    if (g0 + g < G && fc < F) {
      float s = part[0][g][col];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) s += part[k][g][col];
      out[static_cast<size_t>(g0 + g) * F + fc] = s;
    }
  }
}

template <int GT>
void launch(const float* x, const float* w, float* out, int C, int F, int G,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((F + kCols - 1) / kCols),
                  static_cast<unsigned>((G + GT - 1) / GT));
  mix_aggregate_kernel<GT><<<grid, kThreads, 0, stream>>>(x, w, out, C, F, G);
}

}  // namespace

// x (C, F), w (G, C), out (G, F): fp32, contiguous, on the current device.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_mix_aggregate_f32(const float* x, const float* w,
                                       float* out, int C, int F, int G,
                                       cudaStream_t stream) {
  if (C <= 0 || F <= 0 || G <= 0) return static_cast<int>(cudaSuccess);
  if (G == 1) launch<1>(x, w, out, C, F, G, stream);
  else launch<8>(x, w, out, C, F, G, stream);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------- mix_tree
//
// mix_tree: the same reduction over a client-stacked tree in one launch,
// every leaf read and written where it lies,
//   out_l[g, i] = sum_c w[g, c] * x_l[c, i]   x_l (C, n_l), out_l (G, n_l)
// for every leaf l.  It replaces, on the card, the chain stack_ravel ->
// mix_aggregate_kernel -> stack_unravel (the reference's stack_ravel,
// _mix_kernel and stack_unravel in repro/kernels/diffusion.py): no (C, F)
// block is built by a cat and read a second time, and each output leaf is
// its own contiguous tensor.
//
// Bits: each output element is summed in mix_aggregate_kernel's order --
// eight fmaf chains over c = k (mod 8), each from +0, then the eight
// partials added for k = 0..7 in order, an empty chain adding +0 -- so the
// tree equals the old chain bit for bit at every shape.
//
// What bounds it on the H100: memory, (C + G) * F * 4 bytes for 2*G*C*F
// flops; at the FL shapes (C <= 8, F ~ 26k-77k) the launch and one round
// trip to memory, as for the old kernel.
//
// Design.  A leaf table (input and output pointer, n, first tile and
// alignment class of up to kTreeLeaves leaves) and, for a host w of at
// most kTreeW floats, w itself travel by value as a __grid_constant__
// parameter; a larger or device w is read from device memory.  A block
// owns one tile of one leaf's columns, found by two ballots over the first
// tiles (no search loop).  A thread owns 4 columns: one 16-byte load a row
// where the leaf's n % 4 == 0 and both its bases are 16-byte aligned (every
// fcn leaf but the (10,) bias), 4-byte loads where not.  Two modes:
//  * C <= 8 (every FL run): a chain holds one term, so a thread owns all
//    eight for its 4 columns -- 64 threads a block, 256 columns a tile, all
//    C loads issued before the first FMA, the partials summed in registers,
//    no shared memory and no barrier.  GT = 8 output rows cost 32
//    accumulator registers, not 8 chains x 8 rows x 4 columns.
//  * C > 8: warp k owns chain k (c = k, k + 8, ...), lane l 4 columns, so a
//    warp reads 512 contiguous bytes a row -- 256 threads, 128 columns a
//    tile; each thread issues its chain's next 8 loads before their FMAs,
//    and the 8 partials meet in shared memory as in mix_aggregate_kernel.
// Either way one wave: the fcn tree is ~110 tiles, the lm model ~310, the
// (1024, 26122) scaling fleet ~210 blocks of 256.  G > GT goes over the
// grid's y axis in tiles of GT rows; rows past G are not stored.
// Measured beside this design on an H100 (PERF.md §6): 16 loads in
// flight a chain at C > 8 were slower (40.1 -> 42.0 us at
// (1024, 26122, 1)); 32-thread blocks at C <= 8 won 0.05-0.13 us on the
// fcn, cnn and lm trees and lost on the 4-client lm adapter, measured
// with another leaf lookup only.

namespace {

constexpr int kTreeLeaves = 64;      // L_MAX: leaves a launch takes
constexpr int kTreeW = 512;          // W_MAX: floats of w in the parameters
constexpr int kChains = 8;
constexpr int kVec = 4;              // columns a thread owns
constexpr int kSingleThreads = 64;   // C <= 8
constexpr int kSplitThreads = 32 * kChains;
constexpr int kSingleCols = kSingleThreads * kVec;   // 256
constexpr int kSplitCols = 32 * kVec;                // 128

// One launch's table: per leaf its input (C, n) and output (G, n) rows,
// n, first tile and alignment class (1: 16-byte loads); then w (G, C)
// row-major when it came from the host, else wdev.
struct MixTreeTable {
  const float* x[kTreeLeaves];
  float* out[kTreeLeaves];
  int n[kTreeLeaves];
  int tile0[kTreeLeaves];
  int vec[kTreeLeaves];
  float w[kTreeW];
  const float* wdev;
  int leaves, C, G;
};
static_assert(sizeof(MixTreeTable) <= 4096,
              "the table fits the classic 4 KB of kernel parameters");
static_assert(kTreeLeaves == 64, "tree_leaf() ballots over 64 entries");

// The leaf whose tiles hold `tile`: first tiles are strictly increasing
// (no empty leaf has an entry), so it is the count of first tiles <= tile,
// less one -- two ballots over one load a lane, no search loop.  The
// leaf's entry is then read at one warp-uniform index.  (Reading every
// field of every entry a lane and shuffling the leaf's over cost more:
// lane-varying parameter loads serialise, 2.46 -> 3.11 us at the lm
// model's 37 leaves, PERF.md §6.)  Whole warps only.
__device__ __forceinline__ int tree_leaf(const MixTreeTable& t, int tile) {
  const int lane = threadIdx.x & 31;
  const unsigned lo = __ballot_sync(
      0xffffffffu, lane < t.leaves && t.tile0[lane] <= tile);
  const unsigned hi = __ballot_sync(
      0xffffffffu, lane + 32 < t.leaves && t.tile0[lane + 32] <= tile);
  return __popc(lo) + __popc(hi) - 1;
}

template <bool kWParam>
__device__ __forceinline__ float tree_weight(const MixTreeTable& t, int i) {
  return kWParam ? t.w[i] : __ldg(t.wdev + i);
}

// Columns col .. col + 3 of one row (col < n); past n read as 0.
__device__ __forceinline__ float4 load4(const float* row, int col, int n,
                                        bool vec) {
  if (vec) return __ldg(reinterpret_cast<const float4*>(row + col));
  float4 v;
  v.x = __ldg(row + col);
  v.y = col + 1 < n ? __ldg(row + col + 1) : 0.f;
  v.z = col + 2 < n ? __ldg(row + col + 2) : 0.f;
  v.w = col + 3 < n ? __ldg(row + col + 3) : 0.f;
  return v;
}

__device__ __forceinline__ void store4(float* row, int col, int n, bool vec,
                                       float4 v) {
  if (vec) {
    *reinterpret_cast<float4*>(row + col) = v;
    return;
  }
  row[col] = v.x;
  if (col + 1 < n) row[col + 1] = v.y;
  if (col + 2 < n) row[col + 2] = v.z;
  if (col + 3 < n) row[col + 3] = v.w;
}

__device__ __forceinline__ float4 fma4(float w, float4 x, float4 acc) {
  return make_float4(__fmaf_rn(w, x.x, acc.x), __fmaf_rn(w, x.y, acc.y),
                     __fmaf_rn(w, x.z, acc.z), __fmaf_rn(w, x.w, acc.w));
}

__device__ __forceinline__ float4 add4(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

// At least two blocks of 256 threads (a 128-register budget): without the
// minimum, ptxas held one instance to 64 registers and spilled.
template <int GT, bool kSplit, bool kWParam>
__global__ void __launch_bounds__(kSplit ? kSplitThreads : kSingleThreads,
                                  kSplit ? 2 : 8)
mix_tree_kernel(const __grid_constant__ MixTreeTable t) {
  const int tile = blockIdx.x;
  const int l = tree_leaf(t, tile);
  const int n = t.n[l];
  const int first = t.tile0[l];
  const bool vec = t.vec[l] != 0;
  const float* x = t.x[l];
  float* out = t.out[l];
  const int C = t.C, G = t.G;
  const int g0 = blockIdx.y * GT;
  const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);

  if constexpr (!kSplit) {
    const int col = (tile - first) * kSingleCols + threadIdx.x * kVec;
    if (col >= n) return;
    float4 xv[kChains];
#pragma unroll
    for (int k = 0; k < kChains; ++k)
      xv[k] = k < C ? load4(x + static_cast<size_t>(k) * n, col, n, vec)
                    : zero;
#pragma unroll
    for (int g = 0; g < GT; ++g) {
      const int gr = g0 + g;
      if (gr < G) {
        const int wr = gr * C;
        // Chain 0 holds c = 0 (C >= 1); chain k >= C is empty, adds +0.
        float4 s = fma4(tree_weight<kWParam>(t, wr), xv[0], zero);
#pragma unroll
        for (int k = 1; k < kChains; ++k)
          s = add4(s, k < C ? fma4(tree_weight<kWParam>(t, wr + k), xv[k],
                                   zero)
                            : zero);
        store4(out + static_cast<size_t>(gr) * n, col, n, vec, s);
      }
    }
  } else {
    __shared__ float4 part[kChains][GT][32];
    const int lane = threadIdx.x & 31;
    const int k = threadIdx.x >> 5;                       // this warp's chain
    const int base = (tile - first) * kSplitCols;
    const int col = base + lane * kVec;
    float4 acc[GT];
#pragma unroll
    for (int g = 0; g < GT; ++g) acc[g] = zero;
    if (col < n) {
      constexpr int kDepth = 8;          // loads in flight before the FMAs
      for (int c0 = k; c0 < C; c0 += kChains * kDepth) {
        float4 xv[kDepth];
#pragma unroll
        for (int j = 0; j < kDepth; ++j) {
          const int c = c0 + kChains * j;
          xv[j] = c < C ? load4(x + static_cast<size_t>(c) * n, col, n, vec)
                        : zero;
        }
#pragma unroll
        for (int j = 0; j < kDepth; ++j) {
          const int c = c0 + kChains * j;
          if (c < C) {
#pragma unroll
            for (int g = 0; g < GT; ++g) {
              // Rows past G read row G-1 (a valid address); never stored.
              const int gr = min(g0 + g, G - 1);
              acc[g] = fma4(tree_weight<kWParam>(t, gr * C + c), xv[j],
                            acc[g]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int g = 0; g < GT; ++g) part[k][g][lane] = acc[g];
    __syncthreads();
    for (int i = threadIdx.x; i < GT * 32; i += kSplitThreads) {
      const int g = i >> 5;
      const int cc = base + (i & 31) * kVec;
      if (g0 + g < G && cc < n) {
        float4 s = part[0][g][i & 31];
#pragma unroll
        for (int kk = 1; kk < kChains; ++kk) s = add4(s, part[kk][g][i & 31]);
        store4(out + static_cast<size_t>(g0 + g) * n, cc, n, vec, s);
      }
    }
  }
}

template <int GT, bool kSplit>
void launch_tree(const MixTreeTable& t, int tiles, cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(tiles),
                  static_cast<unsigned>((t.G + GT - 1) / GT));
  const int threads = kSplit ? kSplitThreads : kSingleThreads;
  if (t.wdev == nullptr)
    mix_tree_kernel<GT, kSplit, true><<<grid, threads, 0, stream>>>(t);
  else
    mix_tree_kernel<GT, kSplit, false><<<grid, threads, 0, stream>>>(t);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// The table's capacity and a tile's width, which the wrapper's table
// builder (repro_torch.kernels.diffusion.mix_tree_table) must agree with;
// chip_smoke.py checks that it does.
extern "C" int repro_mix_tree_max_leaves() { return kTreeLeaves; }
extern "C" int repro_mix_tree_max_w() { return kTreeW; }
extern "C" int repro_mix_tree_tile_cols(int C) {
  return C <= kChains ? kSingleCols : kSplitCols;
}

// One launch over `leaves` leaves: x[l] (C, n[l]) and out[l] (G, n[l]) fp32
// device pointers, each leaf contiguous; tile0 (leaves + 1 host ints) the
// first tile of each leaf and the total; vec[l] 1 where leaf l takes
// 16-byte loads.  w (G, C) row-major: w_host (host floats, G * C <= kTreeW)
// or w_dev (device), exactly one of them.  Returns cudaGetLastError() after
// the launch (0 on success), or cudaErrorInvalidValue for a table the
// kernel does not take (checked in full: a wrong tile or alignment class
// would read out of bounds).
extern "C" int repro_mix_tree_f32(const float* const* x, float* const* out,
                                  const int* n, const int* tile0,
                                  const int* vec, int leaves, int C, int G,
                                  const float* w_host, const float* w_dev,
                                  cudaStream_t stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  if (leaves < 1 || leaves > kTreeLeaves || C < 1 || G < 1 ||
      (w_host == nullptr) == (w_dev == nullptr) ||
      (w_host != nullptr && static_cast<long long>(G) * C > kTreeW) ||
      (G + 7) / 8 > 65535 || tile0[0] != 0)
    return bad;
  const int cols = repro_mix_tree_tile_cols(C);
  MixTreeTable t;
  for (int l = 0; l < leaves; ++l) {
    if (n[l] < 1 || tile0[l + 1] - tile0[l] != (n[l] + cols - 1) / cols ||
        (vec[l] != 0 && (n[l] % 4 != 0 || !aligned16(x[l]) ||
                         !aligned16(out[l]))))
      return bad;
    t.x[l] = x[l];
    t.out[l] = out[l];
    t.n[l] = n[l];
    t.tile0[l] = tile0[l];
    t.vec[l] = vec[l];
  }
  if (w_host != nullptr)
    for (int i = 0; i < G * C; ++i) t.w[i] = w_host[i];
  t.wdev = w_dev;
  t.leaves = leaves;
  t.C = C;
  t.G = G;
  const int tiles = tile0[leaves];
  if (C <= kChains) {
    if (G == 1) launch_tree<1, false>(t, tiles, stream);
    else launch_tree<8, false>(t, tiles, stream);
  } else {
    if (G == 1) launch_tree<1, true>(t, tiles, stream);
    else launch_tree<8, true>(t, tiles, stream);
  }
  return static_cast<int>(cudaGetLastError());
}
