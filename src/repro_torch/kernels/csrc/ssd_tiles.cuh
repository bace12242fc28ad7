// ssd_tiles.cuh: what the SSD scan's kernels share -- the tile padding and
// the conflict-free shared-memory strides, cp.async staging, the 3xTF32
// mma.sync products (fp32 operands split into two TF32 halves), C B^T by
// rows, and the launch helpers.  Used by ssd_scan.cu (the forward) and
// ssd_scan_bwd.cu (its backward).  Everything sits in an anonymous
// namespace: each source compiles its own copy.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// Row strides (floats) of tiles with a multiple of 16 columns that keep
// fragment loads conflict-free.  Row-major A and [n][k] B read rows g =
// 0..7 at columns t = 0..3: stride = 4 (mod 8).  Transposed A and [k][n] B
// read rows t at columns g: stride = 8 (mod 16).
__host__ __device__ inline int stride_g(int cols) { return cols + 4; }
__host__ __device__ inline int stride_t(int cols) { return cols + 8; }

// Chunk, P and N rounded up to tiles of 16 (zeros past the edges).
struct Dims {
  int lp, pp, np;
};
__host__ __device__ inline Dims dims(int L, int P, int N) {
  return {round_up(L, 16), round_up(P, 16), round_up(N, 16)};
}

#ifndef REPRO_HOPPER_CUH   // else hopper.cuh's, the same
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
#endif

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_u32(dst)), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most `pending` of this thread's cp.async groups are in flight.
template <int pending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(pending) : "memory");
}

// Stage a (rows_pad x cols_pad) tile into dst (row stride ld) from src (row
// r at src + r * src_ld, contiguous columns), zeros past rows_valid /
// cols_valid.  vec: rows start 16-byte aligned and cols_valid % 4 == 0.
__device__ __forceinline__ void stage_tile(float* dst, int ld,
                                           const float* src, long long src_ld,
                                           int rows_valid, int cols_valid,
                                           int rows_pad, int cols_pad,
                                           bool vec) {
  const int groups = cols_pad / 4;
  for (int e = threadIdx.x; e < rows_pad * groups; e += blockDim.x) {
    const int r = e / groups, c4 = (e - r * groups) * 4;
    float* d = dst + r * ld + c4;
    const float* s = src + r * src_ld + c4;
    if (r < rows_valid && vec && c4 + 4 <= cols_valid) {
      cp_async16(d, s);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if (r < rows_valid && c4 + i < cols_valid) {
          cp_async4(d + i, s + i);
        } else {
          d[i] = 0.f;
        }
      }
    }
  }
}

// x = hi + lo + O(2^-20 |x|) with hi and lo TF32 (10 mantissa bits), cut
// from the bits toward zero: one AND each on the integer pipe (cvt.rna runs
// at a quarter of the rate), and x - hi is exact in fp32.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Fragments of one k-step of 8 (lane: g = lane / 4, t = lane % 4).  An A
// fragment is rows g, g + 8 at columns t, t + 4 of a 16 x 8 tile; a B
// fragment rows t, t + 4 at column g of an 8 x 8 tile.  No mma below runs
// under a condition: ptxas fences every predicated mma.sync with a
// WARPSYNC, so tiles past an edge are computed from zeros (or discarded)
// rather than skipped.

// acc[j] += A x B_j for j < NT in 3xTF32: lo*hi, then hi*lo, then hi*hi,
// each over the n-tiles before the next, so that no mma waits on the one
// just issued.
template <int NT>
__device__ __forceinline__ void step_mma(float (&acc)[NT][4],
                                         const float (&a)[4],
                                         const uint32_t (&bh)[NT][2],
                                         const uint32_t (&bl)[NT][2]) {
  uint32_t ah[4], al[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) split_tf32(a[m], ah[m], al[m]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], al, bh[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bl[j]);
#pragma unroll
  for (int j = 0; j < NT; ++j) mma_tf32(acc[j], ah, bh[j]);
}

template <int NT, class LoadB>
__device__ __forceinline__ void load_b_split(int k, LoadB load_b,
                                             uint32_t (&bh)[NT][2],
                                             uint32_t (&bl)[NT][2]) {
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    float b[2];
    load_b(k, j, b);
    split_tf32(b[0], bh[j][0], bl[j][0]);
    split_tf32(b[1], bh[j][1], bl[j][1]);
  }
}

// One m-tile: acc[j] += A x B_j over k in [kbeg, kend) (multiples of 8).
// load_a(k, a) fills the A fragment at k-step k, load_b(k, j, b) the B
// fragment of n-tile j.
template <int NT, class LoadA, class LoadB>
__device__ __forceinline__ void tile_mma(float (&acc)[NT][4], int kbeg,
                                         int kend, LoadA load_a,
                                         LoadB load_b) {
#pragma unroll 2
  for (int k = kbeg; k < kend; k += 8) {
    uint32_t bh[NT][2], bl[NT][2];
    load_b_split(k, load_b, bh, bl);
    float a[4];
    load_a(k, a);
    step_mma(acc, a, bh, bl);
  }
}

// Two m-tiles sharing the B fragments: both over k in [0, k_both), the
// second alone over [k_both, k_end).  load_a(i, k, a) for m-tile i.
template <int NT, class LoadA, class LoadB>
__device__ __forceinline__ void pair_mma(float (&acc0)[NT][4],
                                         float (&acc1)[NT][4], int k_both,
                                         int k_end, LoadA load_a,
                                         LoadB load_b) {
#pragma unroll 2
  for (int k = 0; k < k_both; k += 8) {
    uint32_t bh[NT][2], bl[NT][2];
    load_b_split(k, load_b, bh, bl);
    float a0[4], a1[4];
    load_a(0, k, a0);
    load_a(1, k, a1);
    step_mma(acc0, a0, bh, bl);
    step_mma(acc1, a1, bh, bl);
  }
  tile_mma(acc1, k_both, k_end,
           [&](int k, float (&f)[4]) { load_a(1, k, f); }, load_b);
}

// C B^T rows [16i, 16i + 16) of one chunk, for i = first, first + step, ...
// (rows below S), in units of 16 columns on and below the diagonal, into
// cbg (row stride lp).  B is in shared memory (row stride ldb, zeros past
// S); the 16 rows of C are staged into cs.
__device__ __forceinline__ void cb_rows(float* cs, const float* bs, int ldb,
                                        const float* cm, float* cbg,
                                        const Dims& d, int N, int lv,
                                        int first, int step) {
  const int sc = stride_g(d.np);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int warps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int i = first; i < d.lp / 16 && 16 * i < lv; i += step) {
    const int q0 = 16 * i;
    __syncthreads();                             // cs is free
    stage_tile(cs, sc, cm + (long long)q0 * N, N, lv - q0, N, 16, d.np,
               N % 4 == 0);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int u = warp; u <= i; u += warps) {
      const int k0 = 16 * u;
      float acc[2][4] = {};
      tile_mma(acc, 0, d.np,
               [&](int k, float (&f)[4]) {
                 const float* r0 = cs + g * sc + k + t;
                 f[0] = r0[0]; f[1] = r0[8 * sc]; f[2] = r0[4];
                 f[3] = r0[8 * sc + 4];
               },
               [&](int k, int j, float (&f)[2]) {
                 const float* r = bs + (k0 + 8 * j + g) * ldb + k + t;
                 f[0] = r[0]; f[1] = r[4];
               });
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        float* o = cbg + (q0 + g) * d.lp + k0 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(o + 8 * d.lp) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
  }
}

// Raise a kernel's dynamic shared-memory limit once per size (not on every
// launch, so that launches inside a CUDA graph capture set nothing).
template <class Kernel>
cudaError_t grant_smem(Kernel kernel, int bytes, int& granted) {
  if (bytes <= granted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) granted = bytes;
  return err;
}

// Heads per block so that about `slots` blocks cover the (head, chunk,
// batch row) grid.
int heads_per_block(int H, int nc, int B, int slots) {
  const long long items = (long long)H * nc * B;
  const long long hpb = (items + slots - 1) / slots;
  return static_cast<int>(hpb < 1 ? 1 : (hpb > H ? H : hpb));
}

int device_attr(cudaDeviceAttr attr, int fallback) {
  int dev = 0, v = 0;
  if (cudaGetDevice(&dev) != cudaSuccess
      || cudaDeviceGetAttribute(&v, attr, dev) != cudaSuccess || v <= 0) {
    return fallback;
  }
  return v;
}

}  // namespace
