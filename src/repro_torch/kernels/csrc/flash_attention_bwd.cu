// flash_attention_bwd: the backward of causal / sliding-window attention.
//
//   q (B, Sq, H, D), k/v (B, Sk, H, D), o and do (B, Sq, H, D), all bf16
//   or all fp32, and the forward's row log-sum-exp lse (B, H, Sq) fp32
//   -> dq (B, Sq, H, D), dk and dv (B, Sk, H, D) in that dtype, q
//   right-aligned to the end of the keys, heads pre-repeated for GQA.
//
// Replaces no TPU kernel: the reference has no backward Pallas body (its
// models differentiate XLA's inline attention with jax.grad).  It was
// added so that the zoo trains through the hand-written forward
// (flash_attention.cu); its plain version is
// repro_torch/kernels/ref.py::flash_attention_bwd_ref.
//
// What bounds it on the H100: operations.  Five (Sq x Sk x D) products per
// (b, h) against the tensor cores' 989 TFLOP/s in bf16.
//
// Three launches, no float atomics, so two calls give the same bits:
//   1. delta = rowsum(dO * O), fp32 (B, H, Sq) (fa_bwd_delta_kernel).
//   2. dK/dV over key blocks, walking the query tiles that see them.
//   3. dQ over query blocks, walking the key tiles they see.
// P = exp(s * scale - lse) comes from the forward's lse, so the scores are
// computed twice (once per pass) and dP = dO V^T twice: seven products of
// 2*D flops a visible pair against the bound's five (eight past D = 128,
// below).  A query that sees no key has lse = +inf, so P = 0 and it adds
// nothing.
//
// bf16 (D in {64, 80, 128, 160, 256}, the forward's contract; every
// pointer 16-byte aligned) runs on Hopper's warpgroup tensor cores fed by
// TMA, with the forward's skeleton (hopper.cuh): a producer warpgroup
// (setmaxnreg.dec to 24) and two consumer warpgroups (setmaxnreg.inc to
// 240) between an mbarrier-guarded ring of shared-memory stages.  The
// streamed tiles hold kT = 64 rows (32 at D = 256, so that three stages
// fit beside the 128 resident rows in the 227 KB a block may use).
//   dK/dV (fa_bwd_dkdv_wgmma_kernel): a block per (128 keys, b*h), the
//     earliest keys (the most work under causal) first.  K and V are loaded
//     once; the producer streams (Q, dO) tiles of kT query rows by TMA, and
//     a second producer warp copies their lse (times log2 e) and delta into
//     the stage's stats.  Each consumer owns 64 keys and per query tile runs
//       S^T = K Q^T, dP^T = V dO^T   wgmma m64nkTk16, both operands in
//                                    shared memory (K-major),
//       P^T = exp2(S^T * scale*log2e - lse*log2e), dS^T = P^T * (dP^T -
//                                    delta), in registers,
//       dV += P^T dO, dK += dS^T Q   wgmma m64nDk16 with P^T / dS^T rounded
//                                    to bf16 in registers as the A operand
//                                    (as the reference's bf16 backward
//                                    rounds them) and dO / Q read MN-major.
//     Up to D = 128 dK and dV stay in registers together (2 x D/2 a
//     thread).  Past it they would not fit beside S^T and dP^T in the 240
//     registers, so the block walks its query tiles twice: a dK pass (S^T,
//     dP^T, dK += dS^T Q) and then a dV pass (S^T, dV += P^T dO), one
//     accumulator held at a time: one S^T product more a visible pair and a
//     second read of the (Q, dO) stream.  dK is scaled once at the end,
//     and each leaves through the consumer's rows of a tile it no longer
//     reads (dK over V after the dK pass, dV over K) and a TMA store.
//   dQ (fa_bwd_dq_wgmma_kernel): a block per (128 query rows, b*h), the
//     latest (heaviest causal) first; Q, dO, lse and delta stay resident
//     while K/V tiles of kT keys stream in.  Per tile each consumer (64
//     rows) runs S = Q K^T and dP = dO V^T (m64nkTk16, shared memory), P
//     and dS in registers, and dQ += dS K with K read MN-major; one owner
//     per dQ row, so no atomics.
// Only tiles that cross the causal diagonal or the window's edge get the
// element mask.  The ragged ends need none: TMA zero-fills rows past S, a
// query past Sq gets lse = +inf (P = 0), and a key past Sk has K = V = 0,
// so it adds 0 to dQ and its own dK / dV rows are clipped by the store.
// D = 80 is zero-padded to 128 and D = 160 to 192 in shared memory by
// TMA's out-of-bounds fill: the D-deep products skip the all-zero k-steps
// and the D-wide ones run at N = D (a legal wgmma width); the stores drop
// the columns past D.
//
// fp32 (D % 4 == 0, D <= 256; also bf16 widened by the caller at other D)
// runs as fp32 FMAs on the CUDA cores: after the delta launch, one block
// per 64 keys (dK/dV) and one per 64 query rows (dQ), tiles staged in
// shared memory as fp32 with an odd row stride (D + 1), 256 threads as
// 16 x 16, a thread owning rows ty + 16r of the 64 resident rows and
// columns tx + 16c of each streamed tile (64 rows; 32 past D = 192, so the
// four tiles fit in shared memory) and of the (64 x D) accumulator.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr float kLog2e = 1.4426950408889634f;

// The bf16 head dims, in the order of their launch counts; -1 for a head
// dim the wgmma kernels do not take.
constexpr int wgmma_index(int d) {
  return d == 64 ? 0 : d == 80 ? 1 : d == 128 ? 2 : d == 160 ? 3
         : d == 256 ? 4 : -1;
}

// Launches of each device kernel and instance since the library was
// loaded, counted where a launch succeeds: 0 delta, 1-5 dK/dV wgmma at D =
// 64, 80, 128, 160, 256, 6-10 dQ wgmma at the same D, 11 dK/dV fp32, 12 dQ
// fp32 (repro_flash_attention_bwd_kernel_launches).
constexpr int kCountedKernels = 13;
constexpr int kDkdvWgmma = 1, kDqWgmma = 6, kDkdvF32 = 11, kDqF32 = 12;
long long g_launches[kCountedKernels] = {};

cudaError_t counted(int kind) {
  const cudaError_t err = cudaGetLastError();
  if (err == cudaSuccess) ++g_launches[kind];
  return err;
}

// ---------------------------------------------------------------- delta

// delta[b, h, i] = sum_d dO[b, i, h, d] * O[b, i, h, d] in fp32: a
// half-warp a row of the (B, Sq, H, D) tensors in memory order, bf16 rows
// as 16-byte loads (D / 8 of them, up to two a lane).
template <typename T>
__global__ void __launch_bounds__(256)
fa_bwd_delta_kernel(const T* __restrict__ o, const T* __restrict__ dO,
                    float* __restrict__ delta, int H, int Sq, int D,
                    long long rows) {
  const long long r = (long long)blockIdx.x * 16 + threadIdx.x / 16;
  const int lane = threadIdx.x % 16;
  float acc = 0.f;
  if (r < rows) {
    const T* orow = o + r * D;
    const T* drow = dO + r * D;
    if constexpr (std::is_same<T, __nv_bfloat16>::value) {
      for (int c = lane; c < D / 8; c += 16) {
        const uint4 a = reinterpret_cast<const uint4*>(orow)[c];
        const uint4 b = reinterpret_cast<const uint4*>(drow)[c];
        const __nv_bfloat162* a2 = reinterpret_cast<const __nv_bfloat162*>(&a);
        const __nv_bfloat162* b2 = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 x = __bfloat1622float2(a2[e]);
          const float2 y = __bfloat1622float2(b2[e]);
          acc = fmaf(x.x, y.x, acc);
          acc = fmaf(x.y, y.y, acc);
        }
      }
    } else {
      for (int c = lane; c < D; c += 16) acc = fmaf(orow[c], drow[c], acc);
    }
  }
#pragma unroll
  for (int off = 1; off < 16; off <<= 1) {
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  }
  if (lane == 0 && r < rows) {
    const long long bi = r / H;                 // b * Sq + i
    const int h = static_cast<int>(r - bi * H);
    const long long b = bi / Sq;
    const int i = static_cast<int>(bi - b * Sq);
    delta[(b * H + h) * Sq + i] = acc;
  }
}

// ------------------------------------------------- bf16: wgmma + TMA

constexpr int kWgThreads = 384;          // producer + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kBlockSmemMax = 232448;    // 227 KB: a block's shared memory

template <int kD>
struct BwdConfig {
  static constexpr int kChunks = (kD + 63) / 64;        // 64-column chunks
  static constexpr int kN = kD;                         // dQ/dK/dV width
  static constexpr int kKSteps = kD / 16;               // k-steps over D
  // dK and dV in two passes over the query tiles (one accumulator at a
  // time) past D = 128.
  static constexpr bool kTwoPass = kD > 128;
  // Rows of a streamed tile: query rows (dK/dV), keys (dQ).
  static constexpr int kT = kD == 256 ? 32 : 64;
  static constexpr int kRowChunk = kT * 128;            // bytes a chunk
  static constexpr int kRowTile = kChunks * kRowChunk;
  // 128 resident rows: K and V (dK/dV), Q and dO (dQ).
  static constexpr int kResChunk = 128 * 128;
  static constexpr int kResTile = kChunks * kResChunk;
  static constexpr int kStages = kChunks <= 2 ? 4 : kChunks == 3 ? 2 : 3;
  // dK/dV: the stages, then each stage's stats (lse * log2e and delta,
  // kT each), then the mbarriers.
  static constexpr int kStats = 8 * kT;
  static constexpr int kKvStats = 2 * kResTile + kStages * 2 * kRowTile;
  static constexpr int kKvBars = kKvStats + kStages * kStats;
  static constexpr int kKvSmem = kKvBars + 8 * (1 + 2 * kStages) + 1024;
  // dQ: the stages (K, then V), then the mbarriers.
  static constexpr int kDqBars = 2 * kResTile + kStages * 2 * kRowTile;
  static constexpr int kDqSmem = kDqBars + 8 * (1 + 2 * kStages) + 1024;
  static_assert(kKvSmem <= kBlockSmemMax && kDqSmem <= kBlockSmemMax,
                "stages past shared memory");
};

// Rows 0-63 of each chunk of a (rows x kD) tile, K-major at k-step ks.
__device__ __forceinline__ uint32_t kstep(uint32_t tile, int chunk_bytes,
                                          int ks) {
  return tile + (ks / 4) * chunk_bytes + (ks % 4) * 32;
}

// P or dS (fp32, a 64 x kM wgmma accumulator) to bf16 A-fragments: step
// i / 8 holds columns 0-7 in regs 0 (row g) and 1 (row g + 8), columns
// 8-15 in regs 2 and 3.
template <int kM>
__device__ __forceinline__ void pack_a(const float (&x)[kM / 2],
                                       uint32_t (&a)[kM / 16][4]) {
#pragma unroll
  for (int i = 0; i < kM / 2; i += 4) {
    a[i / 8][(i / 4) % 2 * 2] = pack_bf16(x[i], x[i + 1]);
    a[i / 8][(i / 4) % 2 * 2 + 1] = pack_bf16(x[i + 2], x[i + 3]);
  }
}

// acc (64 x kN, fp32, scaled) as bf16 into rows 0-63 of a tile whose
// chunks are chunk_bytes apart, in the 128-byte-swizzled layout of a TMA
// box; lane (warp, g, t) holds rows 16 warp + g (+ 8), columns 8j + 2t.
template <int kN>
__device__ __forceinline__ void store_rows(uint32_t tile, int chunk_bytes,
                                           const float (&acc)[kN / 2],
                                           float scale, int warp, int g,
                                           int t) {
  const int r = 16 * warp + g;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const uint32_t at = tile + (j / 8) * chunk_bytes
                        + ((((j % 8) ^ g) << 4) | (4 * t));
    asm volatile("st.shared.b32 [%0], %1;\n" ::
                 "r"(at + r * 128),
                 "r"(pack_bf16(acc[4 * j] * scale, acc[4 * j + 1] * scale))
                 : "memory");
    asm volatile("st.shared.b32 [%0], %1;\n" ::
                 "r"(at + (r + 8) * 128),
                 "r"(pack_bf16(acc[4 * j + 2] * scale,
                               acc[4 * j + 3] * scale))
                 : "memory");
  }
}

// acc += a b: a (64 x kM) bf16 A-fragments, b (kM x kN) read MN-major from
// a tile whose 64-column chunks are chunk_bytes apart; waited for.
template <int kM, int kN>
__device__ __forceinline__ void accumulate(float (&acc)[kN / 2],
                                           uint32_t (&a)[kM / 16][4],
                                           uint32_t b, int chunk_bytes) {
  fence_regs(acc);
  fence_regs(a);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kM / 16; ++kk) {
    wgmma_rs(acc, a[kk], sw128_desc(b + kk * 16 * 128, chunk_bytes, 1024));
  }
  wgmma_commit();
  wgmma_wait_all();
  fence_regs(acc);
}

template <int kD>
__global__ void __launch_bounds__(kWgThreads, 1)
fa_bwd_dkdv_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                         __grid_constant__ const CUtensorMap tm_k,
                         __grid_constant__ const CUtensorMap tm_v,
                         __grid_constant__ const CUtensorMap tm_do,
                         __grid_constant__ const CUtensorMap tm_dk,
                         __grid_constant__ const CUtensorMap tm_dv,
                         const float* __restrict__ lse,
                         const float* __restrict__ delta, int H, int Sq,
                         int Sk, float scale, float scale_log2, int causal,
                         int window) {
  using Cfg = BwdConfig<kD>;
  constexpr int kT = Cfg::kT;
  extern __shared__ uint8_t smem_raw[];
  // 1024-byte alignment: the 128-byte swizzle repeats every 8 rows.
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t k_s = base;
  const uint32_t v_s = base + Cfg::kResTile;
  // Stage s: Q (kT rows), dO (kT rows); its stats: lse * log2e, delta.
  auto stage = [&](int s) {
    return base + 2u * Cfg::kResTile + 2u * Cfg::kRowTile * s;
  };
  auto stats = [&](int s) { return base + Cfg::kKvStats + Cfg::kStats * s; };
  const uint32_t bars = base + Cfg::kKvBars;
  const uint32_t kv_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + Cfg::kStages + s); };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int k0 = blockIdx.x * 128;
  const int shift = Sk - Sq;
  // The query tiles that see some key of [k0, k0 + 128).
  const int k_last = min(k0 + 128, Sk) - 1;
  const int i_lo = causal ? max(0, k0 - shift) : 0;
  const int i_hi =
      window > 0 ? min(Sq - 1, k_last + window - 1 - shift) : Sq - 1;
  const int t_lo = i_lo / kT;
  const int n_tiles = i_hi >= i_lo ? i_hi / kT - t_lo + 1 : 0;
  // The stream: the tiles once, or twice (the dK pass, then the dV pass).
  const int n_stream = (Cfg::kTwoPass ? 2 : 1) * n_tiles;

  if (threadIdx.x == 0) {
    mbar_init(kv_full, 1);
    for (int s = 0; s < Cfg::kStages; ++s) {
      mbar_init(full(s), 1 + 32);       // the TMA thread + the stats warp
      mbar_init(empty(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---- producer: thread 0 issues the TMA loads, warp 1 the stats ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n" ::: "memory");
    const int warp = threadIdx.x / 32;
    if (threadIdx.x == 0) {
      mbar_expect_tx(kv_full, 2 * Cfg::kResTile);
      for (int c = 0; c < Cfg::kChunks; ++c) {
        tma_load(k_s + c * Cfg::kResChunk, &tm_k, kv_full, 64 * c, h, k0, b);
        tma_load(v_s + c * Cfg::kResChunk, &tm_v, kv_full, 64 * c, h, k0, b);
      }
      for (int j = 0; j < n_stream; ++j) {
        const int s = j % Cfg::kStages;
        mbar_wait(empty(s), ((j / Cfg::kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * Cfg::kRowTile);
        const int i0 = (t_lo + j % n_tiles) * kT;
        for (int c = 0; c < Cfg::kChunks; ++c) {
          tma_load(stage(s) + c * Cfg::kRowChunk, &tm_q, full(s), 64 * c, h,
                   i0, b);
          tma_load(stage(s) + Cfg::kRowTile + c * Cfg::kRowChunk, &tm_do,
                   full(s), 64 * c, h, i0, b);
        }
      }
    } else if (warp == 1) {
      const int lane = threadIdx.x % 32;
      const float* lse_bh = lse + (long long)bh * Sq;
      const float* delta_bh = delta + (long long)bh * Sq;
      for (int j = 0; j < n_stream; ++j) {
        const int s = j % Cfg::kStages;
        mbar_wait(empty(s), ((j / Cfg::kStages) & 1) ^ 1);
        const int i0 = (t_lo + j % n_tiles) * kT;
        for (int r = lane; r < kT; r += 32) {
          const int i = i0 + r;
          const float l2 = i < Sq ? lse_bh[i] * kLog2e : INFINITY;
          const float dl = i < Sq ? delta_bh[i] : 0.f;
          asm volatile("st.shared.f32 [%0], %1;\n"
                       :: "r"(stats(s) + 4 * r), "f"(l2) : "memory");
          asm volatile("st.shared.f32 [%0], %1;\n"
                       :: "r"(stats(s) + 4 * kT + 4 * r), "f"(dl)
                       : "memory");
        }
        mbar_arrive(full(s));
      }
    }
  } else {
    // ---- consumers: 64 keys each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n" ::: "memory");
    const int cw = wg - 1;
    const int tid = threadIdx.x - 128 * wg;
    const int warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t = lane % 4;
    const uint32_t k_wg = k_s + 64 * 128 * cw;     // this warpgroup's keys
    const uint32_t v_wg = v_s + 64 * 128 * cw;
    const int wk_first = k0 + 64 * cw;
    const int key0 = wk_first + 16 * warp + g;     // this lane's two keys

    float st[kT / 2], dpt[kT / 2];   // S^T then P^T; dP^T then dS^T (64 x kT)
    uint32_t pa[kT / 16][4], da[kT / 16][4];

    // Stream tile j in stage s: S^T = K Q^T and, with dp, dP^T = V dO^T
    // (two groups, both K-major); then P^T into st and pa and, with dp,
    // dS^T into dpt and da.
    auto tile = [&](auto dp, int j) {
      constexpr bool kDp = decltype(dp)::value;
      const int s = j % Cfg::kStages;
      const int i0 = (t_lo + j % n_tiles) * kT;
      const uint32_t q_t = stage(s);
      const uint32_t do_t = q_t + Cfg::kRowTile;
      mbar_wait(full(s), (j / Cfg::kStages) & 1);

      fence_regs(st);
      if constexpr (kDp) fence_regs(dpt);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < Cfg::kKSteps; ++ks) {
        wgmma_ss(st, sw128_desc(kstep(k_wg, Cfg::kResChunk, ks), 16, 1024),
                 sw128_desc(kstep(q_t, Cfg::kRowChunk, ks), 16, 1024),
                 ks > 0);
      }
      wgmma_commit();
      if constexpr (kDp) {
#pragma unroll
        for (int ks = 0; ks < Cfg::kKSteps; ++ks) {
          wgmma_ss(dpt, sw128_desc(kstep(v_wg, Cfg::kResChunk, ks), 16,
                                   1024),
                   sw128_desc(kstep(do_t, Cfg::kRowChunk, ks), 16, 1024),
                   ks > 0);
        }
        wgmma_commit();
        // P^T while dP^T runs.
        wgmma_wait_one();
      } else {
        wgmma_wait_all();
      }
      // st[4jj + e]: key key0 + 8 (e >> 1), query i0 + 8 jj + 2t + (e & 1).
      fence_regs(st);
      const bool masked =
          (causal && wk_first + 63 > i0 + shift)
          || (window > 0 && wk_first <= i0 + kT - 1 + shift - window);
#pragma unroll
      for (int jj = 0; jj < kT / 8; ++jj) {
        float2 l2;
        asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                     : "=f"(l2.x), "=f"(l2.y)
                     : "r"(stats(s) + 4 * (8 * jj + 2 * t)));
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = fmaf(st[4 * jj + e], scale_log2, (e & 1) ? -l2.y : -l2.x);
          if (masked) {
            const int key = key0 + 8 * (e >> 1);
            const int pos = i0 + 8 * jj + 2 * t + (e & 1) + shift;
            const bool vis = (!causal || key <= pos)
                             && (window <= 0 || key > pos - window);
            x = vis ? x : -INFINITY;
          }
          st[4 * jj + e] = exp2_fast(x);
        }
      }
      if constexpr (kDp) {
        wgmma_wait_all();
        fence_regs(dpt);
#pragma unroll
        for (int jj = 0; jj < kT / 8; ++jj) {
          float2 dl;
          asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                       : "=f"(dl.x), "=f"(dl.y)
                       : "r"(stats(s) + 4 * kT + 4 * (8 * jj + 2 * t)));
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int i = 4 * jj + e;
            dpt[i] = st[i] * (dpt[i] - ((e & 1) ? dl.y : dl.x));
          }
        }
        pack_a<kT>(dpt, da);
      }
      pack_a<kT>(st, pa);
      return s;
    };
    // acc (times scale) as bf16 over this warpgroup's rows of a resident
    // tile it no longer reads, then out by TMA, rows past Sk clipped.
    auto store = [&](const float (&acc)[Cfg::kN / 2], float by,
                     uint32_t rows, const CUtensorMap* map) {
      store_rows<Cfg::kN>(rows, Cfg::kResChunk, acc, by, warp, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
      if (tid == 0 && wk_first < Sk) {
        for (int c = 0; c < Cfg::kChunks; ++c) {
          tma_store(map, rows + c * Cfg::kResChunk, 64 * c, h, wk_first, b);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    };

    // K and V always land before an epilogue writes over them.
    mbar_wait(kv_full, 0);
    if constexpr (!Cfg::kTwoPass) {
      float dk[Cfg::kN / 2], dv[Cfg::kN / 2];
#pragma unroll
      for (int i = 0; i < Cfg::kN / 2; ++i) {
        dk[i] = 0.f;
        dv[i] = 0.f;
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = tile(std::true_type{}, j);
        const uint32_t q_t = stage(s);
        const uint32_t do_t = q_t + Cfg::kRowTile;
        // dV += P^T dO, dK += dS^T Q: dO and Q MN-major (D contiguous),
        // 64-column chunks kRowChunk apart, 8-row groups 1024 bytes apart.
        fence_regs(dv);
        fence_regs(dk);
        fence_regs(pa);
        fence_regs(da);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {
          wgmma_rs(dv, pa[kk],
                   sw128_desc(do_t + kk * 16 * 128, Cfg::kRowChunk, 1024));
        }
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {
          wgmma_rs(dk, da[kk],
                   sw128_desc(q_t + kk * 16 * 128, Cfg::kRowChunk, 1024));
        }
        wgmma_commit();
        wgmma_wait_all();
        fence_regs(dv);
        fence_regs(dk);
        mbar_arrive(empty(s));
      }
      store(dk, scale, k_wg, &tm_dk);
      store(dv, 1.f, v_wg, &tm_dv);
    } else {
      float acc[Cfg::kN / 2];
#pragma unroll
      for (int i = 0; i < Cfg::kN / 2; ++i) acc[i] = 0.f;
      // The dK pass: dK += dS^T Q.
      for (int j = 0; j < n_tiles; ++j) {
        const int s = tile(std::true_type{}, j);
        accumulate<kT, Cfg::kN>(acc, da, stage(s), Cfg::kRowChunk);
        mbar_arrive(empty(s));
      }
      // V is not read again: dK leaves over this warpgroup's V rows.
      store(acc, scale, v_wg, &tm_dk);
#pragma unroll
      for (int i = 0; i < Cfg::kN / 2; ++i) acc[i] = 0.f;
      // The dV pass: dV += P^T dO.
      for (int j = n_tiles; j < n_stream; ++j) {
        const int s = tile(std::false_type{}, j);
        accumulate<kT, Cfg::kN>(acc, pa, stage(s) + Cfg::kRowTile,
                                Cfg::kRowChunk);
        mbar_arrive(empty(s));
      }
      store(acc, 1.f, k_wg, &tm_dv);
    }
  }
}

template <int kD>
__global__ void __launch_bounds__(kWgThreads, 1)
fa_bwd_dq_wgmma_kernel(__grid_constant__ const CUtensorMap tm_q,
                       __grid_constant__ const CUtensorMap tm_k,
                       __grid_constant__ const CUtensorMap tm_v,
                       __grid_constant__ const CUtensorMap tm_do,
                       __grid_constant__ const CUtensorMap tm_dq,
                       const float* __restrict__ lse,
                       const float* __restrict__ delta, int H, int Sq,
                       int Sk, float scale, float scale_log2, int causal,
                       int window) {
  using Cfg = BwdConfig<kD>;
  constexpr int kT = Cfg::kT;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t q_s = base;                        // Q, then dQ
  const uint32_t do_s = base + Cfg::kResTile;
  auto k_tile = [&](int s) {
    return base + 2u * Cfg::kResTile + 2u * Cfg::kRowTile * s;
  };
  const uint32_t bars = base + Cfg::kDqBars;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8u * (1 + s); };
  auto empty = [&](int s) { return bars + 8u * (1 + Cfg::kStages + s); };

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * 128;
  const int shift = Sk - Sq;
  // The keys this block can see: only the tiles between them are visited.
  const int last_q = min(q0 + 128, Sq) - 1;
  const int k_hi = causal ? min(Sk, last_q + shift + 1) : Sk;
  const int k_lo = window > 0 ? max(0, q0 + shift - window + 1) / kT * kT : 0;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + kT - 1) / kT : 0;

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
      mbar_expect_tx(q_full, 2 * Cfg::kResTile);
      for (int c = 0; c < Cfg::kChunks; ++c) {
        tma_load(q_s + c * Cfg::kResChunk, &tm_q, q_full, 64 * c, h, q0, b);
        tma_load(do_s + c * Cfg::kResChunk, &tm_do, q_full, 64 * c, h, q0,
                 b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % Cfg::kStages;
        mbar_wait(empty(s), ((j / Cfg::kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), 2 * Cfg::kRowTile);
        const int kt = k_lo + j * kT;
        for (int c = 0; c < Cfg::kChunks; ++c) {
          tma_load(k_tile(s) + c * Cfg::kRowChunk, &tm_k, full(s), 64 * c, h,
                   kt, b);
          tma_load(k_tile(s) + Cfg::kRowTile + c * Cfg::kRowChunk, &tm_v,
                   full(s), 64 * c, h, kt, b);
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
    const int wg_first = q0 + 64 * cw;
    const int row0 = wg_first + 16 * warp + g;     // this lane's two rows
    const int pos0 = row0 + shift, pos1 = pos0 + 8;
    const int p_first = wg_first + shift;
    const int p_last = min(wg_first + 63, Sq - 1) + shift;
    const uint32_t q_wg = q_s + 64 * 128 * cw;
    const uint32_t do_wg = do_s + 64 * 128 * cw;
    const float* lse_bh = lse + (long long)bh * Sq;
    const float* delta_bh = delta + (long long)bh * Sq;
    const float l2_0 = row0 < Sq ? lse_bh[row0] * kLog2e : INFINITY;
    const float l2_1 = row0 + 8 < Sq ? lse_bh[row0 + 8] * kLog2e : INFINITY;
    const float dl0 = row0 < Sq ? delta_bh[row0] : 0.f;
    const float dl1 = row0 + 8 < Sq ? delta_bh[row0 + 8] : 0.f;

    float dq[Cfg::kN / 2];
#pragma unroll
    for (int i = 0; i < Cfg::kN / 2; ++i) dq[i] = 0.f;
    float sc[kT / 2], dp[kT / 2];    // S then P; dP then dS (64 x kT)
    uint32_t da[kT / 16][4];

    mbar_wait(q_full, 0);
    for (int j = 0; j < n_tiles; ++j) {
      const int s = j % Cfg::kStages;
      const int kt = k_lo + j * kT;
      const uint32_t k_t = k_tile(s);
      const uint32_t v_t = k_t + Cfg::kRowTile;
      mbar_wait(full(s), (j / Cfg::kStages) & 1);

      fence_regs(sc);
      fence_regs(dp);
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < Cfg::kKSteps; ++ks) {
        wgmma_ss(sc, sw128_desc(kstep(q_wg, Cfg::kResChunk, ks), 16, 1024),
                 sw128_desc(kstep(k_t, Cfg::kRowChunk, ks), 16, 1024),
                 ks > 0);
      }
      wgmma_commit();
#pragma unroll
      for (int ks = 0; ks < Cfg::kKSteps; ++ks) {
        wgmma_ss(dp, sw128_desc(kstep(do_wg, Cfg::kResChunk, ks), 16, 1024),
                 sw128_desc(kstep(v_t, Cfg::kRowChunk, ks), 16, 1024),
                 ks > 0);
      }
      wgmma_commit();

      // P while dP runs.  sc[4jj + e]: key kt + 8 jj + 2t + (e & 1), row
      // pos0 (e < 2) or pos1.
      wgmma_wait_one();
      fence_regs(sc);
      const bool masked = (causal && kt + kT - 1 > p_first)
                          || (window > 0 && kt <= p_last - window);
#pragma unroll
      for (int i = 0; i < kT / 2; ++i) {
        float x = fmaf(sc[i], scale_log2, (i & 2) ? -l2_1 : -l2_0);
        if (masked) {
          const int key = kt + 8 * (i / 4) + 2 * t + (i & 1);
          const int pos = (i & 2) ? pos1 : pos0;
          const bool vis = (!causal || key <= pos)
                           && (window <= 0 || key > pos - window);
          x = vis ? x : -INFINITY;
        }
        sc[i] = exp2_fast(x);
      }
      wgmma_wait_all();
      fence_regs(dp);
#pragma unroll
      for (int i = 0; i < kT / 2; ++i) {
        dp[i] = sc[i] * (dp[i] - ((i & 2) ? dl1 : dl0));
      }
      pack_a<kT>(dp, da);

      // dQ += dS K: K MN-major (D contiguous), 64-column chunks kRowChunk
      // apart, 8-key groups 1024 bytes apart.
      accumulate<kT, Cfg::kN>(dq, da, k_t, Cfg::kRowChunk);
      mbar_arrive(empty(s));
    }

    if (wg_first < Sq) {
      // dQ * scale as bf16 over this warpgroup's Q rows, out by TMA.
      store_rows<Cfg::kN>(q_wg, Cfg::kResChunk, dq, scale, warp, g, t);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      asm volatile("bar.sync %0, 128;\n" :: "r"(1 + cw) : "memory");
      if (tid == 0) {
        for (int c = 0; c < Cfg::kChunks; ++c) {
          tma_store(&tm_dq, q_wg + c * Cfg::kResChunk, 64 * c, h, wg_first,
                    b);
        }
        asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
        asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
      }
    }
  }
}

template <int kD>
cudaError_t launch_wgmma(const void* q, const void* k, const void* v,
                         const void* dO, const float* lse, const float* delta,
                         void* dq, void* dk, void* dv, int B, int H, int Sq,
                         int Sk, float scale, int causal, int window,
                         cudaStream_t stream) {
  using Cfg = BwdConfig<kD>;
  constexpr int kT = Cfg::kT;
  CUtensorMap tq_t, tdo_t, tk128, tv128, tdk, tdv;    // dK/dV's maps
  CUtensorMap tq128, tdo128, tk_t, tv_t, tdq;         // dQ's maps
  if (!make_map(&tq_t, q, B, Sq, H, kD, kT)
      || !make_map(&tdo_t, dO, B, Sq, H, kD, kT)
      || !make_map(&tk128, k, B, Sk, H, kD, 128)
      || !make_map(&tv128, v, B, Sk, H, kD, 128)
      || !make_map(&tdk, dk, B, Sk, H, kD, 64)
      || !make_map(&tdv, dv, B, Sk, H, kD, 64)
      || !make_map(&tq128, q, B, Sq, H, kD, 128)
      || !make_map(&tdo128, dO, B, Sq, H, kD, 128)
      || !make_map(&tk_t, k, B, Sk, H, kD, kT)
      || !make_map(&tv_t, v, B, Sk, H, kD, kT)
      || !make_map(&tdq, dq, B, Sq, H, kD, 64)) {
    return cudaErrorInvalidValue;
  }
  static bool smem_set = false;
  if (!smem_set) {
    cudaError_t err = cudaFuncSetAttribute(
        fa_bwd_dkdv_wgmma_kernel<kD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Cfg::kKvSmem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(fa_bwd_dq_wgmma_kernel<kD>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Cfg::kDqSmem);
    if (err != cudaSuccess) return err;
    smem_set = true;
  }
  const float scale_log2 = scale * kLog2e;
  fa_bwd_dkdv_wgmma_kernel<kD>
      <<<dim3((Sk + 127) / 128, B * H), kWgThreads, Cfg::kKvSmem, stream>>>(
          tq_t, tk128, tv128, tdo_t, tdk, tdv, lse, delta, H, Sq, Sk, scale,
          scale_log2, causal, window);
  const cudaError_t err = counted(kDkdvWgmma + wgmma_index(kD));
  if (err != cudaSuccess) return err;
  fa_bwd_dq_wgmma_kernel<kD>
      <<<dim3((Sq + 127) / 128, B * H), kWgThreads, Cfg::kDqSmem, stream>>>(
          tq128, tk_t, tv_t, tdo128, tdq, lse, delta, H, Sq, Sk, scale,
          scale_log2, causal, window);
  return counted(kDqWgmma + wgmma_index(kD));
}

// ------------------------------------------------ fp32: CUDA cores

constexpr int kTile = 64;                // resident rows
constexpr int kThreads = 256;
constexpr int kMaxD = 256;

struct Geo {
  int H, Sq, Sk, D;
  float scale;
  int causal, window;
};

__device__ __forceinline__ bool visible(const Geo& g, int i, int j) {
  if (i >= g.Sq || j >= g.Sk) return false;
  const int qp = i + g.Sk - g.Sq;
  if (g.causal && j > qp) return false;
  if (g.window > 0 && j <= qp - g.window) return false;
  return true;
}

// Key tiles [lo, hi] of kS keys that the query rows [i0, i0 + kTile) can
// see.
__device__ __forceinline__ void key_tiles(const Geo& g, int i0, int kS,
                                          int* lo, int* hi) {
  const int off = g.Sk - g.Sq;
  const int imax = min(i0 + kTile, g.Sq) - 1;
  const int jlo = g.window > 0 ? max(0, i0 + off - g.window + 1) : 0;
  const int jhi = g.causal ? min(g.Sk - 1, imax + off) : g.Sk - 1;
  *lo = jlo / kS;
  *hi = jhi < jlo ? -1 : jhi / kS;
}

// Query tiles [lo, hi] of kS rows that see some key of [j0, j0 + kTile).
__device__ __forceinline__ void query_tiles(const Geo& g, int j0, int kS,
                                            int* lo, int* hi) {
  const int off = g.Sk - g.Sq;
  const int jmax = min(j0 + kTile, g.Sk) - 1;
  const int ilo = g.causal ? max(0, j0 - off) : 0;
  const int ihi =
      g.window > 0 ? min(g.Sq - 1, jmax + g.window - 1 - off) : g.Sq - 1;
  *lo = ilo / kS;
  *hi = ihi < ilo ? -1 : ihi / kS;
}

// Rows [row0, row0 + n) of one (b, h) slice of a (B, S, H, D) tensor into
// dst (n x ld), zeros past S.
__device__ __forceinline__ void load_tile(float* dst, int ld, int n,
                                          const float* __restrict__ src,
                                          long long base, int row0, int S,
                                          int HD, int D) {
  for (int idx = threadIdx.x; idx < n * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const int s = row0 + r;
    dst[r * ld + c] = s < S ? src[base + (long long)s * HD + c] : 0.f;
  }
}

// acc[r][c] += sum_d A[ty + 16r][d] * B[tx + 16c][d] over the D columns.
template <int NS>
__device__ __forceinline__ void tile_dot(float (&acc)[4][NS], const float* A,
                                         const float* B, int ld, int D,
                                         int ty, int tx) {
  for (int d = 0; d < D; ++d) {
    float a[4], b[NS];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * ld + d];
#pragma unroll
    for (int c = 0; c < NS; ++c) b[c] = B[(tx + 16 * c) * ld + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NS; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

// P and dS of a thread's 4 x NS of one (64 x 16 NS) tile, in place: s
// holds the raw scores, dp the products dO.V.  The tile's first index runs
// over the resident rows: keys when keys_first, else queries; the queries
// start at i_first and the keys at j_first.
template <int NS>
__device__ __forceinline__ void p_and_ds(float (&s)[4][NS],
                                         float (&dp)[4][NS], const Geo& g,
                                         int i_first, int j_first,
                                         bool keys_first, const float* lse_s,
                                         const float* dl_s, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < NS; ++c) {
      const int a = ty + 16 * r, b = tx + 16 * c;
      const int qi = keys_first ? b : a;       // the query's row in its tile
      const int i = i_first + qi;
      const int j = j_first + (keys_first ? a : b);
      const float p =
          visible(g, i, j) ? __expf(s[r][c] * g.scale - lse_s[qi]) : 0.f;
      s[r][c] = p;
      dp[r][c] = p * (dp[r][c] - dl_s[qi]);
    }
}

// NC: 16-column groups of D a thread accumulates; NS: 16-row groups of a
// streamed tile (4, or 2 past D = 192).
template <int NC, int NS>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dO,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, float* __restrict__ dk,
                   float* __restrict__ dv, Geo g) {
  constexpr int kS = 16 * NS, kLdP = kS + 1;
  extern __shared__ float smem[];
  const int ld = g.D + 1, HD = g.H * g.D;
  float* Ks = smem;
  float* Vs = Ks + kTile * ld;
  float* Qs = Vs + kTile * ld;
  float* dOs = Qs + kS * ld;
  float* Ps = dOs + kS * ld;
  float* dSs = Ps + kTile * kLdP;
  float* lse_s = dSs + kTile * kLdP;
  float* dl_s = lse_s + kS;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int j0 = blockIdx.x * kTile;
  const long long qbase = (long long)b * g.Sq * HD + (long long)h * g.D;
  const long long kbase = (long long)b * g.Sk * HD + (long long)h * g.D;

  load_tile(Ks, ld, kTile, k, kbase, j0, g.Sk, HD, g.D);
  load_tile(Vs, ld, kTile, v, kbase, j0, g.Sk, HD, g.D);
  float acc_k[4][NC] = {}, acc_v[4][NC] = {};
  int lo, hi;
  query_tiles(g, j0, kS, &lo, &hi);
  for (int it = lo; it <= hi; ++it) {
    const int i0 = it * kS;
    __syncthreads();
    load_tile(Qs, ld, kS, q, qbase, i0, g.Sq, HD, g.D);
    load_tile(dOs, ld, kS, dO, qbase, i0, g.Sq, HD, g.D);
    if (tid < kS) {
      const int i = i0 + tid;
      lse_s[tid] = i < g.Sq ? lse[(long long)bh * g.Sq + i] : INFINITY;
      dl_s[tid] = i < g.Sq ? delta[(long long)bh * g.Sq + i] : 0.f;
    }
    __syncthreads();
    float s[4][NS] = {}, dp[4][NS] = {};
    tile_dot(s, Ks, Qs, ld, g.D, ty, tx);     // s[j][i] = k_j . q_i
    tile_dot(dp, Vs, dOs, ld, g.D, ty, tx);   // dp[j][i] = v_j . do_i
    p_and_ds(s, dp, g, i0, j0, true, lse_s, dl_s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NS; ++c) {
        Ps[(ty + 16 * r) * kLdP + tx + 16 * c] = s[r][c];
        dSs[(ty + 16 * r) * kLdP + tx + 16 * c] = dp[r][c];
      }
    __syncthreads();
    for (int i = 0; i < kS; ++i) {
      float p[4], ds[4], o_[NC], q_[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        p[r] = Ps[(ty + 16 * r) * kLdP + i];
        ds[r] = dSs[(ty + 16 * r) * kLdP + i];
      }
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        o_[c] = d < g.D ? dOs[i * ld + d] : 0.f;
        q_[c] = d < g.D ? Qs[i * ld + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          acc_v[r][c] = fmaf(p[r], o_[c], acc_v[r][c]);
          acc_k[r][c] = fmaf(ds[r], q_[c], acc_k[r][c]);
        }
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int j = j0 + ty + 16 * r;
    if (j >= g.Sk) continue;
    const long long row = kbase + (long long)j * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < g.D) {
        dk[row + d] = acc_k[r][c] * g.scale;
        dv[row + d] = acc_v[r][c];
      }
    }
  }
}

template <int NC, int NS>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dO,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, float* __restrict__ dq,
                 Geo g) {
  constexpr int kS = 16 * NS, kLdP = kS + 1;
  extern __shared__ float smem[];
  const int ld = g.D + 1, HD = g.H * g.D;
  float* Qs = smem;
  float* dOs = Qs + kTile * ld;
  float* Ks = dOs + kTile * ld;
  float* Vs = Ks + kS * ld;
  float* dSs = Vs + kS * ld;
  float* lse_s = dSs + kTile * kLdP;
  float* dl_s = lse_s + kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int i0 = blockIdx.x * kTile;
  const long long qbase = (long long)b * g.Sq * HD + (long long)h * g.D;
  const long long kbase = (long long)b * g.Sk * HD + (long long)h * g.D;

  load_tile(Qs, ld, kTile, q, qbase, i0, g.Sq, HD, g.D);
  load_tile(dOs, ld, kTile, dO, qbase, i0, g.Sq, HD, g.D);
  if (tid < kTile) {
    const int i = i0 + tid;
    lse_s[tid] = i < g.Sq ? lse[(long long)bh * g.Sq + i] : INFINITY;
    dl_s[tid] = i < g.Sq ? delta[(long long)bh * g.Sq + i] : 0.f;
  }
  float acc[4][NC] = {};
  int lo, hi;
  key_tiles(g, i0, kS, &lo, &hi);
  for (int jt = lo; jt <= hi; ++jt) {
    const int j0 = jt * kS;
    __syncthreads();
    load_tile(Ks, ld, kS, k, kbase, j0, g.Sk, HD, g.D);
    load_tile(Vs, ld, kS, v, kbase, j0, g.Sk, HD, g.D);
    __syncthreads();
    float s[4][NS] = {}, dp[4][NS] = {};
    tile_dot(s, Qs, Ks, ld, g.D, ty, tx);     // s[i][j] = q_i . k_j
    tile_dot(dp, dOs, Vs, ld, g.D, ty, tx);   // dp[i][j] = do_i . v_j
    p_and_ds(s, dp, g, i0, j0, false, lse_s, dl_s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < NS; ++c)
        dSs[(ty + 16 * r) * kLdP + tx + 16 * c] = dp[r][c];
    __syncthreads();
    for (int j = 0; j < kS; ++j) {
      float ds[4], k_[NC];
#pragma unroll
      for (int r = 0; r < 4; ++r) ds[r] = dSs[(ty + 16 * r) * kLdP + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const int d = tx + 16 * c;
        k_[c] = d < g.D ? Ks[j * ld + d] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[r][c] = fmaf(ds[r], k_[c], acc[r][c]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
    if (i >= g.Sq) continue;
    const long long row = qbase + (long long)i * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int d = tx + 16 * c;
      if (d < g.D) dq[row + d] = acc[r][c] * g.scale;
    }
  }
}

template <int NC>
cudaError_t launch_f32(const float* q, const float* k, const float* v,
                       const float* dO, const float* lse, const float* delta,
                       float* dq, float* dk, float* dv, int B, const Geo& g,
                       cudaStream_t stream) {
  // Streamed tiles of 32 rows past D = 192: four tiles of 64 rows of
  // D + 1 floats would pass the 227 KB a block may use.
  constexpr int NS = NC > 12 ? 2 : 4;
  constexpr size_t kS = 16 * NS;
  const size_t ld = g.D + 1;
  const size_t dkdv_smem =
      (2 * kTile * ld + 2 * kS * ld + 2 * kTile * (kS + 1) + 2 * kS)
      * sizeof(float);
  const size_t dq_smem =
      (2 * kTile * ld + 2 * kS * ld + kTile * (kS + 1) + 2 * kTile)
      * sizeof(float);
  cudaError_t err;
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<NC, NS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkdv_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dq_kernel<NC, NS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  const dim3 qgrid((g.Sq + kTile - 1) / kTile, B * g.H);
  const dim3 kgrid((g.Sk + kTile - 1) / kTile, B * g.H);
  fa_bwd_dkdv_kernel<NC, NS><<<kgrid, kThreads, dkdv_smem, stream>>>(
      q, k, v, dO, lse, delta, dk, dv, g);
  err = counted(kDkdvF32);
  if (err != cudaSuccess) return err;
  fa_bwd_dq_kernel<NC, NS><<<qgrid, kThreads, dq_smem, stream>>>(
      q, k, v, dO, lse, delta, dq, g);
  return counted(kDqF32);
}

template <typename T>
cudaError_t launch_delta(const void* o, const void* dO, float* delta, int B,
                         int H, int Sq, int D, cudaStream_t stream) {
  const long long rows = (long long)B * Sq * H;
  fa_bwd_delta_kernel<T><<<(unsigned)((rows + 15) / 16), 256, 0, stream>>>(
      static_cast<const T*>(o), static_cast<const T*>(dO), delta, H, Sq, D,
      rows);
  return counted(0);
}

cudaError_t dispatch_bf16(const void* q, const void* k, const void* v,
                          const void* o, const void* dO, const float* lse,
                          void* dq, void* dk, void* dv, float* delta, int B,
                          const Geo& g, cudaStream_t s) {
  const uintptr_t align =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k)
      | reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)
      | reinterpret_cast<uintptr_t>(dO) | reinterpret_cast<uintptr_t>(dq)
      | reinterpret_cast<uintptr_t>(dk) | reinterpret_cast<uintptr_t>(dv);
  if (align % 16 != 0 || !(g.scale > 0.f) || wgmma_index(g.D) < 0) {
    return cudaErrorInvalidValue;
  }
  const cudaError_t err =
      launch_delta<__nv_bfloat16>(o, dO, delta, B, g.H, g.Sq, g.D, s);
  if (err != cudaSuccess) return err;
#define REPRO_WGMMA_CASE(d)                                                 \
  case d:                                                                   \
    return launch_wgmma<d>(q, k, v, dO, lse, delta, dq, dk, dv, B, g.H,     \
                           g.Sq, g.Sk, g.scale, g.causal, g.window, s);
  switch (g.D) {
    REPRO_WGMMA_CASE(64)
    REPRO_WGMMA_CASE(80)
    REPRO_WGMMA_CASE(128)
    REPRO_WGMMA_CASE(160)
    REPRO_WGMMA_CASE(256)
    default:
      return cudaErrorInvalidValue;
  }
#undef REPRO_WGMMA_CASE
}

cudaError_t dispatch_f32(const void* q, const void* k, const void* v,
                         const void* o, const void* dO, const float* lse,
                         void* dq, void* dk, void* dv, float* delta, int B,
                         const Geo& g, cudaStream_t s) {
  const cudaError_t err =
      launch_delta<float>(o, dO, delta, B, g.H, g.Sq, g.D, s);
  if (err != cudaSuccess) return err;
  const float* q_ = static_cast<const float*>(q);
  const float* k_ = static_cast<const float*>(k);
  const float* v_ = static_cast<const float*>(v);
  const float* do_ = static_cast<const float*>(dO);
  float* dq_ = static_cast<float*>(dq);
  float* dk_ = static_cast<float*>(dk);
  float* dv_ = static_cast<float*>(dv);
#define REPRO_F32_CASE(nc)                                                  \
  case nc:                                                                  \
    return launch_f32<nc>(q_, k_, v_, do_, lse, delta, dq_, dk_, dv_, B, g, \
                          s);
  switch ((g.D + 15) / 16) {
    REPRO_F32_CASE(1) REPRO_F32_CASE(2) REPRO_F32_CASE(3) REPRO_F32_CASE(4)
    REPRO_F32_CASE(5) REPRO_F32_CASE(6) REPRO_F32_CASE(7) REPRO_F32_CASE(8)
    REPRO_F32_CASE(9) REPRO_F32_CASE(10) REPRO_F32_CASE(11)
    REPRO_F32_CASE(12) REPRO_F32_CASE(13) REPRO_F32_CASE(14)
    REPRO_F32_CASE(15) REPRO_F32_CASE(16)
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_F32_CASE
}

}  // namespace

// dtype 0 = fp32 (D % 4 == 0, D <= 256), 1 = bf16 (D in {64, 80, 128,
// 160, 256}, every tensor 16-byte aligned, scale > 0).  lse is the
// forward's (B, H, Sq) fp32 row log-sum-exp; delta is (B, H, Sq) fp32
// scratch.  Returns the first launch error (cudaGetLastError() after each
// launch).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* dq, void* dk, void* dv,
    void* delta, int dtype, int B, int H, int Sq, int Sk, int D, float scale,
    int causal, int window, void* stream) {
  if (B <= 0 || H <= 0 || B * H > 65535 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D % 4 || D > kMaxD || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g{H, Sq, Sk, D, scale, causal, window};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* lse_ = static_cast<const float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  if (dtype == 1) {
    return static_cast<int>(dispatch_bf16(q, k, v, o, dO, lse_, dq, dk, dv,
                                          delta_, B, g, s));
  }
  if (dtype == 0) {
    return static_cast<int>(dispatch_f32(q, k, v, o, dO, lse_, dq, dk, dv,
                                         delta_, B, g, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Copies the launch counts (see g_launches) into out; returns their number.
extern "C" int repro_flash_attention_bwd_kernel_launches(long long* out) {
  for (int i = 0; i < kCountedKernels; ++i) out[i] = g_launches[i];
  return kCountedKernels;
}
