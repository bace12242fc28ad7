// flash_attention: causal / sliding-window online-softmax attention.
//
//   q (B, Sq, H, D), k/v (B, Sk, H, D), bf16 or fp32 (one type for all
//   three) -> o (B, Sq, H, D) in that type.  Heads are pre-repeated for GQA
//   by the caller.  Query i sits at position i + Sk - Sq (right-aligned to
//   the end of the keys); key j is visible to it when j <= q_pos (causal)
//   and j > q_pos - window (window > 0).  Softmax in fp32 with scale
//   1/sqrt(D) unless given; a row that sees no key returns 0.  On request
//   (a non-null lse) the epilogue also stores each row's natural-log
//   log-sum-exp from the (m, l) it carries, +inf for a row that sees no
//   key: the backward (flash_attention_bwd.cu) recomputes P from it.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_attn_kernel
// (the pallas_call in flash_attention_pallas): a (batch*heads, q-block,
// kv-block) grid whose kv axis runs in order, carrying the fp32 (m, l, acc)
// state in VMEM scratch and skipping kv blocks that the mask hides.
//
// What bounds it on the H100: operations.  4*D flops per visible (q, k)
// pair against a few bytes per element of q, k, v and o; at the zoo's
// prefill shapes (S = 4096) that is hundreds of flops per byte.
//
// Two kernels, one per input type.  bf16 (D in {64, 80, 128, 160, 256},
// every call the zoo makes; q, k, v and o 16-byte aligned; scale > 0) runs
// on Hopper's warpgroup tensor cores, fed by TMA
// (flash_attention_wgmma_kernel, below).  fp32 (D % 4 == 0, D <= 256) runs
// as fp32 FMAs on the CUDA cores (flash_attention_kernel):
//
// One block per (64-query tile, b*h); the heaviest (last) causal tiles are
// scheduled first.  Four threads share a query row: each keeps a quarter of
// the head dim of q and of the fp32 accumulator in registers (float4 groups
// g = sub + 4j), so a row's score is four partial dots joined by two warp
// shuffles.  K and V tiles of 32 keys are staged through dynamic shared
// memory (rows of 16·ceil(D / 16) floats: 64 KB at D = 256); the 8 rows of
// a warp read the same float4s (broadcast).  Only tiles between
// the block's first and last visible key are loaded, so wholly masked tiles
// are skipped.  Per tile: 32 scores in registers, one max, one rescale of
// (l, acc) by exp(m_old - m_new), then p = exp(s - m) accumulated against
// V.  The -1e30 sentinel and the guards on fully masked rows follow the
// reference's _attn_kernel, in both kernels.
#include <cuda.h>           // CUtensorMap and its enums; libcuda is not linked
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kTPR = 4;                 // threads per query row
constexpr int kThreads = kBQ * kTPR;    // 256
constexpr int kBK = 32;                 // keys per shared-memory tile
constexpr int kDMax = 256;              // largest head dim
constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// kG4: float4 groups of the head dim per thread, ceil(D / 16).
template <int kG4>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       float* __restrict__ lse, int H,
                       int Sq, int Sk, int D, float scale, int causal,
                       int window) {
  // Rows of kRow = 16·kG4 >= D floats (a compile-time stride).
  constexpr int kRow = 16 * kG4;
  extern __shared__ __align__(16) float kv_smem[];
  float* k_s = kv_smem;                  // [kBK][kRow]
  float* v_s = kv_smem + kBK * kRow;     // [kBK][kRow]

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int row = threadIdx.x / kTPR;
  const int sub = threadIdx.x % kTPR;
  const int i = q0 + row;
  const bool valid_q = i < Sq;
  const int shift = Sk - Sq;
  const int q_pos = i + shift;
  const int d4 = D / 4;
  const long long row_stride = (long long)H * D;

  float4 qr[kG4], acc[kG4];
  const float* qrow =
      q + ((long long)b * Sq + i) * row_stride + (long long)h * D;
#pragma unroll
  for (int j = 0; j < kG4; ++j) {
    const int g = sub + kTPR * j;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid_q && g < d4) {
      x = make_float4(qrow[4 * g], qrow[4 * g + 1], qrow[4 * g + 2],
                      qrow[4 * g + 3]);
    }
    qr[j] = x;
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // The keys this block can see (block-uniform): tiles outside are skipped.
  const int last_q = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, last_q + shift + 1) : Sk;
  int k_lo = window > 0 ? max(0, q0 + shift - window + 1) : 0;
  k_lo = k_lo / kBK * kBK;

  for (int kt = k_lo; kt < k_hi; kt += kBK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int c = e - r * D;
      const int kp = kt + r;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        const long long off = ((long long)b * Sk + kp) * row_stride
                              + (long long)h * D + c;
        kv = k[off];
        vv = v[off];
      }
      k_s[r * kRow + c] = kv;
      v_s[r * kRow + c] = vv;
    }
    __syncthreads();

    float s[kBK];
    float m_cur = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      const float4* krow = reinterpret_cast<const float4*>(k_s + jj * kRow);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kG4; ++j) {
        const int g = sub + kTPR * j;
        if (g < d4) part += dot4(qr[j], krow[g]);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = kt + jj;
      const bool vis = valid_q && kp < Sk && (!causal || kp <= q_pos)
                       && (window <= 0 || kp > q_pos - window);
      s[jj] = vis ? part * scale : kNegInf;
      m_cur = fmaxf(m_cur, s[jj]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float safe_m = m_new <= 0.5f * kNegInf ? 0.f : m_new;
    const float alpha = m <= 0.5f * kNegInf ? 0.f : expf(m - safe_m);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < kG4; ++j) {
      acc[j].x *= alpha; acc[j].y *= alpha;
      acc[j].z *= alpha; acc[j].w *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      const float p = s[jj] <= 0.5f * kNegInf ? 0.f : expf(s[jj] - safe_m);
      l += p;
      const float4* vrow = reinterpret_cast<const float4*>(v_s + jj * kRow);
#pragma unroll
      for (int j = 0; j < kG4; ++j) {
        const int g = sub + kTPR * j;
        if (g < d4) {
          const float4 x = vrow[g];
          acc[j].x += p * x.x; acc[j].y += p * x.y;
          acc[j].z += p * x.z; acc[j].w += p * x.w;
        }
      }
    }
    m = m_new;
  }

  if (!valid_q) return;
  if (lse != nullptr && sub == 0) {
    lse[(long long)bh * Sq + i] = l > 0.f ? m + logf(l) : INFINITY;
  }
  const float inv = 1.f / fmaxf(l, 1e-20f);
  float* orow = o + ((long long)b * Sq + i) * row_stride + (long long)h * D;
#pragma unroll
  for (int j = 0; j < kG4; ++j) {
    const int g = sub + kTPR * j;
    if (g < d4) {
      orow[4 * g] = acc[j].x * inv;
      orow[4 * g + 1] = acc[j].y * inv;
      orow[4 * g + 2] = acc[j].z * inv;
      orow[4 * g + 3] = acc[j].w * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// bf16 on Hopper: warp-specialised wgmma + TMA.
//
// One block per (128-query tile, b*h), the heaviest causal tiles first, with
// three warpgroups.  Warpgroup 0 is the producer (setmaxnreg.dec to 24
// registers): one thread loads the block's Q tile once, then streams K/V
// tiles of 128 keys into a ring of shared-memory stages with TMA
// (cp.async.bulk.tensor), each stage guarded by a "full" mbarrier (TMA
// bytes landed) and an "empty" one (both consumers done with it).  Past
// D = 128 the tiles hold 64 keys (WgmmaConfig::kBK): 128-key tiles would
// not fit two stages beside the Q tile in the 227 KB a block may use, and
// their scores and P would not fit a consumer's registers beside O.
// Warpgroups 1 and 2 are consumers (setmaxnreg.inc to 240) of 64 query rows
// each.  Per tile a consumer runs
//   S = Q K^T    wgmma m64n128k16 (m64n64k16 on 64-key tiles), Q and K
//                from shared memory (K-major),
//   online softmax on S in registers: row maxima over the lane quad (the
//                wgmma accumulator layout gives lane l rows l/4 and l/4 + 8
//                of its warp's 16), p = exp2(s * scale*log2e - m) as one
//                FMA, l and O rescaled by exp2(m_old - m_new),
//   O += P V     wgmma m64nDk16 with P rounded to bf16 in registers (as the
//                reference's XLA path rounds p to v's dtype) as the A
//                operand and V read from shared memory MN-major (trans-b).
// The products overlap the softmax twice over: a consumer issues tile j's
// Q K^T together with tile j-1's P V and runs tile j's softmax while they
// run, and the two consumers take turns to issue (ping-pong on named
// barriers), so one's softmax runs under the other's products.  O is
// rescaled only in warps where a row maximum moved.  A stage is
// released once tile j-1's P V is done, so the ring holds 3 stages (4 at
// D = 64, 2 at D = 256).  The element mask runs only on tiles that cross the causal
// diagonal, the window's lower edge or the ragged end of Sk (TMA zero-fills
// keys past Sk, and a zero key scores 0, not -inf, so that tail keeps its
// mask); both consumers visit every tile of the block's range, so their
// turns pair up.
// The epilogue writes O / l as bf16 into the consumer's half of the Q tile
// (its own rows, no longer read) and a TMA store copies it out, clipping
// rows past Sq.
//
// Tensor maps view q, k, v and o in place as 4-d (D, H, S, B) arrays with
// byte strides (2D, 2HD, 2SHD): no transpose pass.  A box is 64 columns of D
// (128 bytes, the 128-byte swizzle atom) by 128 rows (Q), kBK rows (K, V)
// or 64 (the output), so a tile is ceil(D / 64) such chunks.  D = 80 is
// zero-padded to 128 and D = 160 to 192 in shared memory by TMA's
// out-of-bounds fill: Q K^T skips the all-zero k-steps, P V runs at N = D
// (its B operand spans whole swizzle atoms and 16 or 32 columns of the
// next) and the store drops columns past D.  The
// maps come from cuTensorMapEncodeTiled, fetched through the runtime's
// driver entry point (no libcuda link), and reach the kernel as
// __grid_constant__ parameters.
constexpr int kWgThreads = 384;          // producer + two consumer warpgroups
constexpr int kWgBQ = 128;               // query rows per block
constexpr int kQChunkBytes = kWgBQ * 128;   // 64 bf16 columns of the Q tile
constexpr int kConsumerThreads = 256;
constexpr int kBlockSmemMax = 232448;    // 227 KB: a block's shared memory

template <int kD>
struct WgmmaConfig {
  static constexpr int kChunks = (kD + 63) / 64;        // 64-column chunks
  static constexpr int kBK = kD <= 128 ? 128 : 64;      // keys per K/V tile
  static constexpr int kKVChunkBytes = kBK * 128;
  static constexpr int kKSteps = kD / 16;               // k-steps of Q K^T
  static constexpr int kQBytes = kChunks * kQChunkBytes;
  static constexpr int kTileBytes = kChunks * kKVChunkBytes;  // K or V
  static constexpr int kStages =                        // K/V ring depth
      kChunks == 1 ? 4 : kChunks == 4 ? 2 : 3;
  static constexpr int kBarOffset = kQBytes + 2 * kTileBytes * kStages;
  static constexpr int kSmemBytes = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kSmemBytes <= kBlockSmemMax, "K/V ring past shared memory");
};


template <int kD>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_attention_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                             __grid_constant__ const CUtensorMap tm_k,
                             __grid_constant__ const CUtensorMap tm_v,
                             __grid_constant__ const CUtensorMap tm_o,
                             float* __restrict__ lse, int H, int Sq, int Sk,
                             float scale_log2, int causal, int window) {
  using Cfg = WgmmaConfig<kD>;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  constexpr int kBK = Cfg::kBK;
  const uint32_t q_s = base;                        // Q tile, then O
  const uint32_t kv_s = base + Cfg::kQBytes;        // stage s: K, then V
  const uint32_t bars = base + Cfg::kBarOffset;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + Cfg::kStages + s); };
  auto k_tile = [&](int s) { return kv_s + 2u * Cfg::kTileBytes * s; };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kWgBQ;
  const int shift = Sk - Sq;
  // The keys this block can see: only the tiles between them are visited.
  const int last_q = min(q0 + kWgBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, last_q + shift + 1) : Sk;
  const int k_lo =
      window > 0 ? max(0, q0 + shift - window + 1) / kBK * kBK : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kBK - 1) / kBK : 0;

  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: one thread issues every TMA load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    if (threadIdx.x == 0) {
      mbar_expect_tx(q_full, Cfg::kQBytes);
      for (int c = 0; c < Cfg::kChunks; ++c) {
        tma_load(q_s + c * kQChunkBytes, &tm_q, q_full, 64 * c, h, q0, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % Cfg::kStages;
        mbar_wait(empty(s), ((j / Cfg::kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * Cfg::kTileBytes);
        const int kt = k_lo + j * kBK;
        for (int c = 0; c < Cfg::kChunks; ++c) {
          const uint32_t at = k_tile(s) + c * Cfg::kKVChunkBytes;
          tma_load(at, &tm_k, full(s), 64 * c, h, kt, b);
          tma_load(at + Cfg::kTileBytes, &tm_v, full(s), 64 * c, h, kt, b);
        }
      }
    }
  } else {
    // ---- consumers: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const int row0 = q0 + 64 * cw + 16 * warp + g;   // this lane's two rows
    const int pos0 = row0 + shift, pos1 = pos0 + 8;
    const int wg_first = q0 + 64 * cw;
    const bool live = wg_first < Sq;
    const int p_first = wg_first + shift;
    const int p_last = min(wg_first + 63, Sq - 1) + shift;
    const uint32_t q_wg = q_s + 64 * 128 * cw;       // this warpgroup's rows

    float acc[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) acc[i] = 0.f;
    float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;  // l: lane partials
    float sc[kBK / 2];        // one tile's scores, then its probabilities
    uint32_t pa[kBK / 16][4]; // the previous tile's P, bf16 A-fragments

    // S = Q K^T over stage s's kBK keys (issued, not waited for).
    auto issue_qk = [&](int s) {
      fence_regs(sc);
      wgmma_fence();
      // Q's descriptors are rebuilt per tile from an opaque copy of its
      // address: hoisted out of the loop they would hold 16 registers.
      uint32_t q_at;
      asm volatile("mov.b32 %0, %1;\n" : "=r"(q_at) : "r"(q_wg));
#pragma unroll
      for (int ks = 0; ks < Cfg::kKSteps; ++ks) {
        const uint32_t col = (ks % 4) * 32;
        wgmma_ss(sc, sw128_desc(q_at + (ks / 4) * kQChunkBytes + col, 16,
                                1024),
                 sw128_desc(k_tile(s) + (ks / 4) * Cfg::kKVChunkBytes + col,
                            16, 1024), ks > 0);
      }
      wgmma_commit();
    };
    // O += P V over stage s: V is MN-major (D contiguous), 64-column
    // chunks kKVChunkBytes apart, 8-key groups 1024 bytes apart.
    auto issue_pv = [&](int s) {
      fence_regs(acc);
      fence_regs(pa);
      wgmma_fence();
      const uint32_t v_tile = k_tile(s) + Cfg::kTileBytes;
#pragma unroll
      for (int kk = 0; kk < kBK / 16; ++kk) {
        wgmma_rs(acc, pa[kk], sw128_desc(v_tile + kk * 16 * 128,
                                         Cfg::kKVChunkBytes, 1024));
      }
      wgmma_commit();
    };
    // Online softmax of the tile at key kt: sc becomes p, (m, l) advance
    // and the factors that rescale O are returned in al0 / al1.
    // sc[4j + e]: key kt + 8j + 2t + (e & 1), row pos0 (e < 2) or pos1.
    auto softmax = [&](int kt, float& al0, float& al1) {
      const bool masked =
          kt + kBK > Sk || (causal && kt + kBK - 1 > p_first)
          || (window > 0 && kt <= p_last - window);
      float mx0 = kNegInf, mx1 = kNegInf;
      if (masked) {
        // Each row's visible keys [lo, hi), relative to key kt + 2t.
        const int base = kt + 2 * t;
        const int hi0 = (causal ? min(Sk, pos0 + 1) : Sk) - base;
        const int hi1 = (causal ? min(Sk, pos1 + 1) : Sk) - base;
        const int lo0 = window > 0 ? pos0 - window + 1 - base : -kBK;
        const int lo1 = window > 0 ? pos1 - window + 1 - base : -kBK;
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const int off = 8 * (i / 4) + (i & 1);
          const bool vis = (i & 2) ? (off < hi1 && off >= lo1)
                                   : (off < hi0 && off >= lo0);
          sc[i] = vis ? sc[i] * scale_log2 : kNegInf;
        }
      }
#pragma unroll
      for (int i = 0; i < kBK / 2; i += 4) {
        mx0 = fmaxf(mx0, fmaxf(sc[i], sc[i + 1]));
        mx1 = fmaxf(mx1, fmaxf(sc[i + 2], sc[i + 3]));
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      if (masked) {
        // Scores scaled and masked with the sentinel: guard rows that
        // have seen no key yet (the reference's _attn_kernel).
        const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
        const float sm0 = mn0 <= 0.5f * kNegInf ? 0.f : mn0;
        const float sm1 = mn1 <= 0.5f * kNegInf ? 0.f : mn1;
        al0 = m0 <= 0.5f * kNegInf ? 0.f : exp2_fast(m0 - sm0);
        al1 = m1 <= 0.5f * kNegInf ? 0.f : exp2_fast(m1 - sm1);
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          const float sm = (i & 2) ? sm1 : sm0;
          sc[i] = sc[i] <= 0.5f * kNegInf ? 0.f : exp2_fast(sc[i] - sm);
        }
      } else {
        // Every score visible: the maxima are of unscaled scores (scale
        // > 0), and p = exp2(s * scale*log2e - m) is one FMA and one ex2.
        const float mn0 = fmaxf(m0, mx0 * scale_log2);
        const float mn1 = fmaxf(m1, mx1 * scale_log2);
        al0 = exp2_fast(m0 - mn0);
        al1 = exp2_fast(m1 - mn1);
        m0 = mn0;
        m1 = mn1;
#pragma unroll
        for (int i = 0; i < kBK / 2; ++i) {
          sc[i] = exp2_fast(fmaf(sc[i], scale_log2, (i & 2) ? -mn1 : -mn0));
        }
      }
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int i = 0; i < kBK / 2; i += 4) {
        ls0 += sc[i] + sc[i + 1];
        ls1 += sc[i + 2] + sc[i + 3];
      }
      l0 = l0 * al0 + ls0;
      l1 = l1 * al1 + ls1;
    };
    // P (fp32 in sc) to bf16 A-fragments: key step i / 8 holds keys 0-7
    // in regs 0 (row g) and 1 (row g + 8), keys 8-15 in regs 2 and 3.
    auto pack_p = [&]() {
#pragma unroll
      for (int i = 0; i < kBK / 2; i += 4) {
        pa[i / 8][(i / 4) % 2 * 2] = pack_bf16(sc[i], sc[i + 1]);
        pa[i / 8][(i / 4) % 2 * 2 + 1] = pack_bf16(sc[i + 2], sc[i + 3]);
      }
    };
    // Ping-pong: a consumer issues its products only on its turn (named
    // barrier 3 + cw), then hands the turn over, so one warpgroup's
    // softmax runs under the other's products.  Each barrier sees as many
    // arrivals as waits: consumer 1 opens consumer 0's first turn and
    // skips its own last hand-over.
    auto my_turn = [&]() {
      asm volatile("bar.sync %0, 256;\n" :: "r"(3 + cw) : "memory");
    };
    auto hand_over = [&]() {
      asm volatile("bar.arrive %0, 256;\n" :: "r"(4 - cw) : "memory");
    };

    mbar_wait(q_full, 0);
    if (n_tiles > 0) {
      if (cw == 1) hand_over();
      // Tile 0: S, softmax, P.  Tile j > 0: S_j is issued together with
      // the P V of tile j - 1, and the softmax of S_j runs while P V does.
      mbar_wait(full(0), 0);
      my_turn();
      issue_qk(0);
      if (cw == 0 || n_tiles > 1) hand_over();
      wgmma_wait_all();
      fence_regs(sc);
      float al0, al1;
      softmax(k_lo, al0, al1);
      pack_p();
      for (int j = 1; j < n_tiles; ++j) {
        const int s = j % Cfg::kStages;
        const int prev = (j - 1) % Cfg::kStages;
        mbar_wait(full(s), (j / Cfg::kStages) & 1);
        my_turn();
        issue_qk(s);
        issue_pv(prev);
        if (cw == 0 || j + 1 < n_tiles) hand_over();
        asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
        fence_regs(sc);
        softmax(k_lo + j * kBK, al0, al1);
        wgmma_wait_all();
        fence_regs(acc);
        mbar_arrive(empty(prev));
        // Rescale O only where a row maximum moved (a factor of exactly 1
        // changes nothing), decided per warp.
        if (__any_sync(0xffffffffu, al0 != 1.f || al1 != 1.f)) {
#pragma unroll
          for (int i = 0; i < kD / 2; i += 4) {
            acc[i] *= al0;
            acc[i + 1] *= al0;
            acc[i + 2] *= al1;
            acc[i + 3] *= al1;
          }
        }
        pack_p();
      }
      const int last = (n_tiles - 1) % Cfg::kStages;
      issue_pv(last);
      wgmma_wait_all();
      fence_regs(acc);
      mbar_arrive(empty(last));
    }

    if (live) {
      // O / l (0 for a row that saw nothing) as bf16 into this warpgroup's
      // rows of the Q tile, in the 128-byte-swizzled layout of a TMA box.
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = 1.f / fmaxf(l0, 1e-20f);
      const float inv1 = 1.f / fmaxf(l1, 1e-20f);
      if (lse != nullptr && t == 0) {
        // m is in log2 units of scaled scores: lse = ln 2 * (m + log2 l).
        float* at = lse + (long long)bh * Sq;
        if (row0 < Sq) {
          at[row0] = l0 > 0.f ? kLn2 * (m0 + log2f(l0)) : INFINITY;
        }
        if (row0 + 8 < Sq) {
          at[row0 + 8] = l1 > 0.f ? kLn2 * (m1 + log2f(l1)) : INFINITY;
        }
      }
      const int r = 16 * warp + g;
#pragma unroll
      for (int j = 0; j < kD / 8; ++j) {
        const uint32_t at = q_wg + (j / 8) * kQChunkBytes
                            + ((((j % 8) ^ g) << 4) | (4 * t));
        asm volatile("st.shared.b32 [%0], %1;\n" ::
                     "r"(at + r * 128),
                     "r"(pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0))
                     : "memory");
        asm volatile("st.shared.b32 [%0], %1;\n" ::
                     "r"(at + (r + 8) * 128),
                     "r"(pack_bf16(acc[4 * j + 2] * inv1,
                                   acc[4 * j + 3] * inv1))
                     : "memory");
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
      if (tid == 0) {
        for (int c = 0; c < Cfg::kChunks; ++c) {
          tma_store(&tm_o, q_wg + c * kQChunkBytes, 64 * c, h, wg_first,
                    b);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}


template <int kD>
int launch_wgmma(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int H, int Sq, int Sk, float scale,
                 int causal, int window, cudaStream_t stream) {
  using Cfg = WgmmaConfig<kD>;
  CUtensorMap tq, tk, tv, to;
  if (!make_map(&tq, q, B, Sq, H, kD, kWgBQ)
      || !make_map(&tk, k, B, Sk, H, kD, Cfg::kBK)
      || !make_map(&tv, v, B, Sk, H, kD, Cfg::kBK)
      || !make_map(&to, o, B, Sq, H, kD, kWgBQ / 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_wgmma_kernel<kD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kSmemBytes);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((Sq + kWgBQ - 1) / kWgBQ, B * H);
  flash_attention_wgmma_kernel<kD>
      <<<grid, kWgThreads, Cfg::kSmemBytes, stream>>>(
          tq, tk, tv, to, lse, H, Sq, Sk, scale * 1.4426950408889634f,
          causal, window);
  return static_cast<int>(cudaGetLastError());
}

// Launches of each device kernel and instance since the library was loaded,
// counted where a launch succeeds: 0 the fp32 kernel (every D), 1-5 the
// wgmma kernel at D = 64, 80, 128, 160, 256
// (repro_flash_attention_kernel_launches).
constexpr int kCountedKernels = 6;
long long g_launches[kCountedKernels] = {0, 0, 0, 0, 0, 0};

int counted(int err, int kind) {
  if (err == static_cast<int>(cudaSuccess)) ++g_launches[kind];
  return err;
}

// bf16: the wgmma kernel for D in {64, 80, 128, 160, 256}, 16-byte aligned
// q, k, v and o (TMA) and scale > 0; anything else is cudaErrorInvalidValue.
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int Sq, int Sk, int D, float scale,
                int causal, int window, cudaStream_t stream) {
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
      | reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  if (align % 16 != 0 || !(scale > 0.f)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#define REPRO_WGMMA_CASE(d, kind)                                           \
  case d:                                                                   \
    return counted(launch_wgmma<d>(q, k, v, o, lse, B, H, Sq, Sk, scale,    \
                                   causal, window, stream),                 \
                   kind);
  switch (D) {
    REPRO_WGMMA_CASE(64, 1)
    REPRO_WGMMA_CASE(80, 2)
    REPRO_WGMMA_CASE(128, 3)
    REPRO_WGMMA_CASE(160, 4)
    REPRO_WGMMA_CASE(256, 5)
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_WGMMA_CASE
}

// One instance of the fp32 kernel: its K and V tiles take 2·kBK·16·kG4
// floats of dynamic shared memory, past the 48 KB default from kG4 = 13
// (D > 192) on.
template <int kG4>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Sq, int Sk, int D, float scale, int causal,
           int window, cudaStream_t stream) {
  constexpr int kSmem = 2 * kBK * 16 * kG4 * static_cast<int>(sizeof(float));
  static bool smem_set = false;
  if (kSmem > 48 * 1024 && !smem_set) {
    const cudaError_t err = cudaFuncSetAttribute(
        flash_attention_kernel<kG4>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set = true;
  }
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<kG4><<<grid, kThreads, kSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, H, Sq, Sk,
      D, scale, causal, window);
  return static_cast<int>(cudaGetLastError());
}

// fp32: the CUDA-core kernel for D % 4 == 0, D <= 256.
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int Sq, int Sk, int D, float scale,
               int causal, int window, cudaStream_t stream) {
#define REPRO_F32_CASE(g4)                                                  \
  case g4:                                                                  \
    return counted(launch<g4>(q, k, v, o, lse, B, H, Sq, Sk, D, scale,      \
                              causal, window, stream),                      \
                   0);
  switch ((D + 15) / 16) {
    REPRO_F32_CASE(1) REPRO_F32_CASE(2) REPRO_F32_CASE(3) REPRO_F32_CASE(4)
    REPRO_F32_CASE(5) REPRO_F32_CASE(6) REPRO_F32_CASE(7) REPRO_F32_CASE(8)
    REPRO_F32_CASE(9) REPRO_F32_CASE(10) REPRO_F32_CASE(11)
    REPRO_F32_CASE(12) REPRO_F32_CASE(13) REPRO_F32_CASE(14)
    REPRO_F32_CASE(15) REPRO_F32_CASE(16)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef REPRO_F32_CASE
}

}  // namespace

// dtype: 0 = fp32 (D % 4 == 0, D <= 256), 1 = bf16 (D in {64, 80, 128,
// 160, 256}, q/k/v/o 16-byte aligned, scale > 0); window <= 0 means no
// window; causal is 0 or 1.  lse: null, or (B, H, Sq) fp32 that receives
// each row's natural-log log-sum-exp of its scaled visible scores (+inf for
// a row that sees no key); o does not depend on it.  Returns
// cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, void* lse,
                                     int dtype, int B, int H, int Sq, int Sk,
                                     int D, float scale, int causal,
                                     int window, void* stream) {
  if (D <= 0 || D % 4 != 0 || D > kDMax || B * H > 65535 || Sq <= 0
      || Sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_ = static_cast<float*>(lse);
  if (dtype == 0) {
    return launch_f32(q, k, v, o, lse_, B, H, Sq, Sk, D, scale, causal,
                      window, s);
  }
  if (dtype == 1) {
    return launch_bf16(q, k, v, o, lse_, B, H, Sq, Sk, D, scale, causal,
                       window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Copies the launch counts (see g_launches) into out; returns their number.
extern "C" int repro_flash_attention_kernel_launches(long long* out) {
  for (int i = 0; i < kCountedKernels; ++i) out[i] = g_launches[i];
  return kCountedKernels;
}
