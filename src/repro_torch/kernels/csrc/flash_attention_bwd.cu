// flash_attention_bwd: the backward of causal / sliding-window attention.
//
//   q (B, Sq, H, D), k/v (B, Sk, H, D), o and do (B, Sq, H, D), all bf16
//   or all fp32 -> dq (B, Sq, H, D), dk and dv (B, Sk, H, D) in that dtype,
//   q right-aligned to the end of the keys, heads pre-repeated for GQA.
//
// Replaces no TPU kernel: the reference has no backward Pallas body (its
// models differentiate XLA's inline attention with jax.grad).  It was
// added so that the zoo trains through the hand-written forward
// (flash_attention.cu); its plain version is
// repro_torch/kernels/ref.py::flash_attention_bwd_ref.
//
// What bounds it on the H100: operations.  Five (Sq x Sk x D) products per
// (b, h) against the tensor cores' 989 TFLOP/s in bf16; this first kernel
// runs them as fp32 FMAs on the CUDA cores (67 TFLOP/s) and recomputes
// the scores three times, so it is several times its bound.
//
// Design: three launches, no float atomics, so the gradients are
// deterministic.
//   1. stats, one block per 64 query rows: the row log-sum-exp of the
//      scaled scores (recomputed; the forward keeps none) and
//      delta = rowsum(dO * O), both fp32.
//   2. dK/dV, one block per 64 keys: walks the query tiles that see them,
//      recomputes P = exp(s - lse) and dP = dO V^T, forms
//      dS = P * (dP - delta), and accumulates dV += P^T dO and
//      dK += dS^T Q in registers.
//   3. dQ, one block per 64 query rows: walks the key tiles they see and
//      accumulates dQ += dS K.
// Every tile is staged in shared memory as fp32 with an odd row stride
// (D + 1), so the 16 rows a warp reads at one column fall in 16 banks.
// 256 threads as 16 x 16: a thread owns rows ty + 16r and columns
// tx + 16c of each (64 x 64) score tile and of each (64 x D) accumulator.
// Tiles wholly outside the causal / window band are skipped; a query that
// sees no key gets lse = +inf and adds nothing.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kTile = 64;
constexpr int kThreads = 256;
constexpr int kMaxD = 128;
constexpr int kLdP = kTile + 1;

struct Geo {
  int H, Sq, Sk, D;
  float scale;
  int causal, window;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ bool visible(const Geo& g, int i, int j) {
  if (i >= g.Sq || j >= g.Sk) return false;
  const int qp = i + g.Sk - g.Sq;
  if (g.causal && j > qp) return false;
  if (g.window > 0 && j <= qp - g.window) return false;
  return true;
}

// Key tiles [lo, hi] that the query rows [i0, i0 + kTile) can see.
__device__ __forceinline__ void key_tiles(const Geo& g, int i0, int* lo,
                                          int* hi) {
  const int off = g.Sk - g.Sq;
  const int imax = min(i0 + kTile, g.Sq) - 1;
  const int jlo = g.window > 0 ? max(0, i0 + off - g.window + 1) : 0;
  const int jhi = g.causal ? min(g.Sk - 1, imax + off) : g.Sk - 1;
  *lo = jlo / kTile;
  *hi = jhi < jlo ? -1 : jhi / kTile;
}

// Query tiles [lo, hi] that see some key of [j0, j0 + kTile).
__device__ __forceinline__ void query_tiles(const Geo& g, int j0, int* lo,
                                            int* hi) {
  const int off = g.Sk - g.Sq;
  const int jmax = min(j0 + kTile, g.Sk) - 1;
  const int ilo = g.causal ? max(0, j0 - off) : 0;
  const int ihi =
      g.window > 0 ? min(g.Sq - 1, jmax + g.window - 1 - off) : g.Sq - 1;
  *lo = ilo / kTile;
  *hi = ihi < ilo ? -1 : ihi / kTile;
}

// Rows [row0, row0 + kTile) of one (b, h) slice of a (B, S, H, D) tensor
// into dst (kTile x ld fp32), zeros past S.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld,
                                          const T* __restrict__ src,
                                          long long base, int row0, int S,
                                          int HD, int D) {
  for (int idx = threadIdx.x; idx < kTile * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    const int s = row0 + r;
    dst[r * ld + c] = s < S ? to_f(src[base + (long long)s * HD + c]) : 0.f;
  }
}

// acc[r][c] += sum_d A[ty + 16r][d] * B[tx + 16c][d] over the D columns.
__device__ __forceinline__ void tile_dot(float (&acc)[4][4], const float* A,
                                         const float* B, int ld, int D,
                                         int ty, int tx) {
  for (int d = 0; d < D; ++d) {
    float a[4], b[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) a[r] = A[(ty + 16 * r) * ld + d];
#pragma unroll
    for (int c = 0; c < 4; ++c) b[c] = B[(tx + 16 * c) * ld + d];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[r][c] = fmaf(a[r], b[c], acc[r][c]);
  }
}

__device__ __forceinline__ float max16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float sum16(float x) {
#pragma unroll
  for (int o = 1; o < 16; o <<= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// ---------------------------------------------------------------- stats

template <typename T>
__global__ void __launch_bounds__(kThreads)
fa_bwd_stats_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ o, const T* __restrict__ dO,
                    float* __restrict__ lse, float* __restrict__ delta,
                    Geo g) {
  extern __shared__ float smem[];
  const int ld = g.D + 1, HD = g.H * g.D;
  float* Qs = smem;
  float* Ks = Qs + kTile * ld;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int i0 = blockIdx.x * kTile;
  const long long qbase = (long long)b * g.Sq * HD + (long long)h * g.D;
  const long long kbase = (long long)b * g.Sk * HD + (long long)h * g.D;

  {  // delta: four threads a row
    const int r = tid / 4, part = tid % 4, i = i0 + r;
    float acc = 0.f;
    if (i < g.Sq) {
      const long long row = qbase + (long long)i * HD;
      for (int c = part; c < g.D; c += 4)
        acc = fmaf(to_f(dO[row + c]), to_f(o[row + c]), acc);
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    acc += __shfl_xor_sync(0xffffffffu, acc, 2);
    if (part == 0 && i < g.Sq) delta[(long long)bh * g.Sq + i] = acc;
  }

  load_tile(Qs, ld, q, qbase, i0, g.Sq, HD, g.D);
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
  }
  int lo, hi;
  key_tiles(g, i0, &lo, &hi);
  for (int jt = lo; jt <= hi; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();
    load_tile(Ks, ld, k, kbase, j0, g.Sk, HD, g.D);
    __syncthreads();
    float s[4][4] = {};
    tile_dot(s, Qs, Ks, ld, g.D, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      float tmax = -INFINITY;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = visible(g, i, j0 + tx + 16 * c) ? s[r][c] * g.scale
                                                   : -INFINITY;
        tmax = fmaxf(tmax, s[r][c]);
      }
      const float mnew = fmaxf(m[r], max16(tmax));
      float tsum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        tsum += s[r][c] == -INFINITY ? 0.f : __expf(s[r][c] - mnew);
      tsum = sum16(tsum);
      if (mnew != -INFINITY) {
        l[r] = (m[r] == -INFINITY ? 0.f : l[r] * __expf(m[r] - mnew)) + tsum;
        m[r] = mnew;
      }
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = i0 + ty + 16 * r;
      if (i < g.Sq)
        lse[(long long)bh * g.Sq + i] =
            l[r] > 0.f ? m[r] + logf(l[r]) : INFINITY;
    }
  }
}

// P and dS of a thread's 4 x 4 of one (64 x 64) tile, in place: s holds
// the raw scores, dp the products dO.V.  The tile's first index runs over
// keys when keys_first, else over queries; the queries start at i_first
// and the keys at j_first.
__device__ __forceinline__ void p_and_ds(float (&s)[4][4],
                                         float (&dp)[4][4], const Geo& g,
                                         int i_first, int j_first,
                                         bool keys_first, const float* lse_s,
                                         const float* dl_s, int ty, int tx) {
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
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

// ---------------------------------------------------------------- dK, dV

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const T* __restrict__ dO,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta, T* __restrict__ dk,
                   T* __restrict__ dv, Geo g) {
  extern __shared__ float smem[];
  const int ld = g.D + 1, HD = g.H * g.D;
  float* Ks = smem;
  float* Vs = Ks + kTile * ld;
  float* Qs = Vs + kTile * ld;
  float* dOs = Qs + kTile * ld;
  float* Ps = dOs + kTile * ld;
  float* dSs = Ps + kTile * kLdP;
  float* lse_s = dSs + kTile * kLdP;
  float* dl_s = lse_s + kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int j0 = blockIdx.x * kTile;
  const long long qbase = (long long)b * g.Sq * HD + (long long)h * g.D;
  const long long kbase = (long long)b * g.Sk * HD + (long long)h * g.D;

  load_tile(Ks, ld, k, kbase, j0, g.Sk, HD, g.D);
  load_tile(Vs, ld, v, kbase, j0, g.Sk, HD, g.D);
  float acc_k[4][NC] = {}, acc_v[4][NC] = {};
  int lo, hi;
  query_tiles(g, j0, &lo, &hi);
  for (int it = lo; it <= hi; ++it) {
    const int i0 = it * kTile;
    __syncthreads();
    load_tile(Qs, ld, q, qbase, i0, g.Sq, HD, g.D);
    load_tile(dOs, ld, dO, qbase, i0, g.Sq, HD, g.D);
    if (tid < kTile) {
      const int i = i0 + tid;
      lse_s[tid] = i < g.Sq ? lse[(long long)bh * g.Sq + i] : INFINITY;
      dl_s[tid] = i < g.Sq ? delta[(long long)bh * g.Sq + i] : 0.f;
    }
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot(s, Ks, Qs, ld, g.D, ty, tx);     // s[j][i] = k_j . q_i
    tile_dot(dp, Vs, dOs, ld, g.D, ty, tx);   // dp[j][i] = v_j . do_i
    p_and_ds(s, dp, g, i0, j0, true, lse_s, dl_s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        Ps[(ty + 16 * r) * kLdP + tx + 16 * c] = s[r][c];
        dSs[(ty + 16 * r) * kLdP + tx + 16 * c] = dp[r][c];
      }
    __syncthreads();
    for (int i = 0; i < kTile; ++i) {
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
        dk[row + d] = from_f<T>(acc_k[r][c] * g.scale);
        dv[row + d] = from_f<T>(acc_v[r][c]);
      }
    }
  }
}

// ---------------------------------------------------------------- dQ

template <typename T, int NC>
__global__ void __launch_bounds__(kThreads)
fa_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dO,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta, T* __restrict__ dq, Geo g) {
  extern __shared__ float smem[];
  const int ld = g.D + 1, HD = g.H * g.D;
  float* Qs = smem;
  float* dOs = Qs + kTile * ld;
  float* Ks = dOs + kTile * ld;
  float* Vs = Ks + kTile * ld;
  float* dSs = Vs + kTile * ld;
  float* lse_s = dSs + kTile * kLdP;
  float* dl_s = lse_s + kTile;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const int bh = blockIdx.y, b = bh / g.H, h = bh % g.H;
  const int i0 = blockIdx.x * kTile;
  const long long qbase = (long long)b * g.Sq * HD + (long long)h * g.D;
  const long long kbase = (long long)b * g.Sk * HD + (long long)h * g.D;

  load_tile(Qs, ld, q, qbase, i0, g.Sq, HD, g.D);
  load_tile(dOs, ld, dO, qbase, i0, g.Sq, HD, g.D);
  if (tid < kTile) {
    const int i = i0 + tid;
    lse_s[tid] = i < g.Sq ? lse[(long long)bh * g.Sq + i] : INFINITY;
    dl_s[tid] = i < g.Sq ? delta[(long long)bh * g.Sq + i] : 0.f;
  }
  float acc[4][NC] = {};
  int lo, hi;
  key_tiles(g, i0, &lo, &hi);
  for (int jt = lo; jt <= hi; ++jt) {
    const int j0 = jt * kTile;
    __syncthreads();
    load_tile(Ks, ld, k, kbase, j0, g.Sk, HD, g.D);
    load_tile(Vs, ld, v, kbase, j0, g.Sk, HD, g.D);
    __syncthreads();
    float s[4][4] = {}, dp[4][4] = {};
    tile_dot(s, Qs, Ks, ld, g.D, ty, tx);     // s[i][j] = q_i . k_j
    tile_dot(dp, dOs, Vs, ld, g.D, ty, tx);   // dp[i][j] = do_i . v_j
    p_and_ds(s, dp, g, i0, j0, false, lse_s, dl_s, ty, tx);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dSs[(ty + 16 * r) * kLdP + tx + 16 * c] = dp[r][c];
    __syncthreads();
    for (int j = 0; j < kTile; ++j) {
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
      if (d < g.D) dq[row + d] = from_f<T>(acc[r][c] * g.scale);
    }
  }
}

template <typename T, int NC>
cudaError_t launch(const void* q, const void* k, const void* v,
                   const void* o, const void* dO, void* dq, void* dk,
                   void* dv, float* lse, float* delta, int B, const Geo& g,
                   cudaStream_t stream) {
  const int ld = g.D + 1;
  const size_t stats_smem = 2ull * kTile * ld * sizeof(float);
  const size_t dkdv_smem =
      (4ull * kTile * ld + 2ull * kTile * kLdP + 2ull * kTile) * sizeof(float);
  const size_t dq_smem =
      (4ull * kTile * ld + 1ull * kTile * kLdP + 2ull * kTile) * sizeof(float);
  cudaError_t err;
  err = cudaFuncSetAttribute(fa_bwd_stats_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)stats_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dkdv_kernel<T, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dkdv_smem);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(fa_bwd_dq_kernel<T, NC>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)dq_smem);
  if (err != cudaSuccess) return err;
  const T* q_ = static_cast<const T*>(q);
  const T* k_ = static_cast<const T*>(k);
  const T* v_ = static_cast<const T*>(v);
  const T* o_ = static_cast<const T*>(o);
  const T* do_ = static_cast<const T*>(dO);
  const dim3 qgrid((g.Sq + kTile - 1) / kTile, B * g.H);
  const dim3 kgrid((g.Sk + kTile - 1) / kTile, B * g.H);
  fa_bwd_stats_kernel<T><<<qgrid, kThreads, stats_smem, stream>>>(
      q_, k_, o_, do_, lse, delta, g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dkdv_kernel<T, NC><<<kgrid, kThreads, dkdv_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      g);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fa_bwd_dq_kernel<T, NC><<<qgrid, kThreads, dq_smem, stream>>>(
      q_, k_, v_, do_, lse, delta, static_cast<T*>(dq), g);
  return cudaGetLastError();
}

// bf16 takes D in {64, 80, 128} only (the forward's contract), so only
// those widths are instantiated for it: a shorter build.
template <typename T>
cudaError_t dispatch(int nc, const void* q, const void* k, const void* v,
                     const void* o, const void* dO, void* dq, void* dk,
                     void* dv, float* lse, float* delta, int B, const Geo& g,
                     cudaStream_t s) {
  switch (nc) {
    case 4: return launch<T, 4>(q, k, v, o, dO, dq, dk, dv, lse, delta, B, g, s);
    case 5: return launch<T, 5>(q, k, v, o, dO, dq, dk, dv, lse, delta, B, g, s);
    case 8: return launch<T, 8>(q, k, v, o, dO, dq, dk, dv, lse, delta, B, g, s);
    default: break;
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (nc) {
      case 1: return launch<T, 1>(q, k, v, o, dO, dq, dk, dv, lse, delta, B, g, s);
      case 2: return launch<T, 2>(q, k, v, o, dO, dq, dk, dv, lse, delta, B, g, s);
      case 3: return launch<T, 3>(q, k, v, o, dO, dq, dk, dv, lse, delta, B, g, s);
      case 6: return launch<T, 6>(q, k, v, o, dO, dq, dk, dv, lse, delta, B, g, s);
      case 7: return launch<T, 7>(q, k, v, o, dO, dq, dk, dv, lse, delta, B, g, s);
      default: break;
    }
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype 0 = fp32, 1 = bf16.  lse and delta are (B, H, Sq) fp32 scratch.
// Returns the first launch error (cudaGetLastError() after each launch).
extern "C" int repro_flash_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, void* dq, void* dk, void* dv, void* lse, void* delta,
    int dtype, int B, int H, int Sq, int Sk, int D, float scale, int causal,
    int window, void* stream) {
  if (B <= 0 || H <= 0 || B * H > 65535 || Sq <= 0 || Sk <= 0 || D <= 0 ||
      D % 4 || D > kMaxD || window < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Geo g{H, Sq, Sk, D, scale, causal, window};
  const int nc = (D + 15) / 16;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* lse_ = static_cast<float*>(lse);
  float* delta_ = static_cast<float*>(delta);
  cudaError_t err =
      dtype == 1 ? dispatch<__nv_bfloat16>(nc, q, k, v, o, dO, dq, dk, dv,
                                           lse_, delta_, B, g, s)
                 : dispatch<float>(nc, q, k, v, o, dO, dq, dk, dv, lse_,
                                   delta_, B, g, s);
  return static_cast<int>(err);
}
