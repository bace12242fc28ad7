// ssd_scan_bwd: the backward of the Mamba-2 SSD chunk scan (ssd_scan.cu), on
// the tensor cores.
//
//   Per batch row, chunk (length L) and head, with acum = cumsum(a) over the
//   chunk, acum_L its last entry, h the state entering the chunk (saved by
//   the forward) and D[q][k] = exp(acum_q - acum_k) on k <= q (the exponent
//   masked to -1e30 off the triangle before exp), the forward is
//     W = (C B^T) o D,   y = W X + diag(exp(acum)) C h^T,
//     h_out = exp(acum_L) h + X^T diag(exp(acum_L - acum)) B.
//   From dy it computes, with G the gradient reaching h_out (zero for the
//   last chunk; G_{c-1} = dY_c^T diag(exp(acum^c)) C_c + exp(acum_L^c) G_c),
//   dk = exp(acum_L - acum) and E = sum over heads of (dY X^T) o D:
//     dX = W^T dY + diag(dk) B G^T,
//     dC = E B + sum_h diag(exp(acum)) dY h,
//     dB = E^T C + sum_h diag(dk) X G,
//     dacum = rowsum(dW o W) - colsum(dW o W) + rowsum(dY o y_state)
//             - dk o rowsum((X G) o B) + <G, h_out> at the last row,
//   dW = dY X^T, and da the reverse cumulative sum of dacum in the chunk.
//   Rows past S are zeros and take no gradient.
//
// Replaces no TPU kernel: the reference differentiates its inline XLA
// chunked scan (src/repro/models/ssm.py::_ssd_chunk_scan) with jax.grad;
// no Pallas body computes this backward.
//
// What bounds it on the H100: operations, as for the forward.  At zamba2's
// shape (B, S, H, P, N, chunk) = (1, 4096, 80, 64, 64, 128) it must read
// xh, dy and the entering states and write dxh (302 MB with a, b, c,
// their gradients and the decays: 0.090 ms at 3.35 TB/s); its products (chip_smoke.py's
// _ssd_bwd_flops) are 2.0x the forward's: 16.2 GFLOP, 0.243 ms as fp32
// FMAs at 67 TFLOP/s, 0.098 ms as three TF32 products each at 495.
//
// Design: the forward's state-passing skeleton run backward, five launches,
// no float atomics (two calls give the same bits):
//  1. ssd_bwd_local_kernel, per (chunk, run of heads): each chunk's own term
//     of G, dY^T diag(exp(acum)) C, a (P x L)(L x N) product as the
//     forward's state kernel forms its state; then the chunk's C B^T rows
//     (cb_rows, shared out among the blocks of a chunk).
//  2. ssd_bwd_pass_kernel: the reverse carry over the chunks, which
//     overwrites each local term with the G of its chunk.
//  3. ssd_bwd_intra_kernel, per (chunk, run of heads), 16 warps: W formed
//     per head into shared memory from C B^T (read from L2) as the forward
//     forms it; dX = [W^T | diag(dk) B] [dY ; G^T] written out; dW = dY X^T
//     by 16 x 16 tiles of the triangle, each warp's tiles fixed, so that it
//     accumulates E over the block's heads in registers and writes rowsum
//     and colsum(dW o W) by tile into shared memory, summed in a fixed
//     order; after the heads, the block's E B and E^T C partials.
//  4. ssd_bwd_state_kernel, per (chunk, run of heads), same runs as 3:
//     diag(exp(acum)) dY h and diag(dk) X G per head by units of 16 x 16,
//     their row dots with C and B, <G, h_out>, the reverse scan into da;
//     the per-head products summed over the block's heads in registers and
//     added onto the partials of 3.
//  5. ssd_bwd_reduce_kernel: dB and dC, the partials of a chunk's runs of
//     heads summed in order.
// Every product runs on mma.sync.m16n8k8 in 3xTF32 (ssd_tiles.cuh), tiles
// come in by cp.async, rows past S are zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tiles.cuh"

namespace {

constexpr int kThreads = 256;       // the local-term kernel's block
constexpr int kBigThreads = 512;    // the intra and state kernels' block
constexpr int kBigWarps = kBigThreads / 32;
constexpr int kMaxChunk = 128;
constexpr int kCbRegs = kMaxChunk / kBigWarps;   // W's float4 rows a thread
// Tiles of the 16 x 16 triangle (36 at L = 128) a warp of the intra kernel
// holds E of.
constexpr int kETiles = (kMaxChunk / 16 * (kMaxChunk / 16 + 1) / 2
                         + kBigWarps - 1) / kBigWarps;
// Units of 16 x 16 a warp of the state kernel holds the sums of: 64 units,
// (chunk / 16) (N / 16) <= 32, zamba2's (128, 64) among them.
constexpr int kStateSlots = 4;

// Shared memory of each kernel, in floats.
// local: C, two buffers of dY (which afterwards hold B and 16 rows of C for
// C B^T), two of acum and exp(acum).
__host__ __device__ inline int local_smem_floats(const Dims& d) {
  const int y2 = 2 * d.lp * stride_t(d.pp);
  const int cb = (d.lp + 16) * stride_g(d.np);
  return d.lp * stride_t(d.np) + (y2 > cb ? y2 : cb) + 3 * d.lp;
}
// intra: B, W (then E), X (then C), dY, G, acum, dk and the row and
// column partials of dW o W.
__host__ __device__ inline int intra_smem_floats(const Dims& d) {
  const int x = d.lp * stride_g(d.pp), c = d.lp * stride_t(d.np);
  return d.lp * stride_g(d.np) + d.lp * stride_t(d.lp) + (x > c ? x : c)
         + d.lp * stride_t(d.pp) + d.pp * stride_g(d.np) + 2 * d.lp
         + 2 * (d.lp / 16) * d.lp;
}
// state: B, C, X, dY, h, G, acum, exp(acum), dk, dacum of the intra kernel,
// the row partials of both products and the warp totals.
__host__ __device__ inline int state_smem_floats(const Dims& d) {
  return 2 * d.lp * stride_g(d.np) + 2 * d.lp * stride_g(d.pp)
         + 2 * d.pp * stride_t(d.np) + 4 * d.lp + 2 * (d.np / 16) * d.lp
         + 2 * kBigWarps;
}
// Units of 16 x 16 the state kernel holds, both products.
__host__ __device__ inline int state_units(const Dims& d) {
  return 2 * (d.lp / 16) * (d.np / 16);
}

// Grid (G, nc, B): block (g, c, b) takes heads [g * hpb, (g + 1) * hpb) of
// chunk c in turn, the next head's dY and acum in flight while it works on
// this one; C is staged once.  Per head, the chunk's own term of G,
// dY^T (exp(acum) o C), into gs[(b, c, h)][pp][np] by units of 16 rows by
// 8 NT columns.  Then B is staged and rows [16g, 16g + 16), [16(g + G),
// ...) of the chunk's C B^T go to cbg, as the forward's state kernel.
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_bwd_local_kernel(const float* __restrict__ dy, const float* __restrict__ bm,
                    const float* __restrict__ cm,
                    const float* __restrict__ acum_g, float* __restrict__ gs,
                    float* __restrict__ cbg, int S, int H, int P, int N,
                    int L, int hpb) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = dims(L, P, N);
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int t0 = c * L, lv = min(L, S - t0);
  const long long row0 = (long long)b * S + t0;
  const int h0 = grp * hpb, h1 = min(H, h0 + hpb);
  const int sy = stride_t(d.pp), sc = stride_t(d.np), ysz = d.lp * sy;
  const int y2 = 2 * ysz, cbz = (d.lp + 16) * stride_g(d.np);
  float* cs = smem;                          // C               [lp][sc]
  float* ys = cs + d.lp * sc;                // dY, two buffers [lp][sy]
  float* ac = ys + (y2 > cbz ? y2 : cbz);    // acum, two buffers [lp]
  float* ew = ac + 2 * d.lp;                 // exp(acum)       [lp]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  auto stage_head = [&](int hh, int buf) {
    const long long blk = ((long long)b * nc + c) * H + hh;
    stage_tile(ys + buf * ysz, sy, dy + (row0 * H + hh) * P,
               (long long)H * P, lv, P, d.lp, d.pp, P % 4 == 0);
    stage_tile(ac + buf * d.lp, d.lp, acum_g + blk * d.lp, d.lp, 1, d.lp, 1,
               d.lp, true);
  };
  stage_tile(cs, sc, cm + row0 * N, N, lv, N, d.lp, d.np, N % 4 == 0);
  stage_head(h0, 0);
  cp_async_commit();

  const int ng = d.np / (8 * NT), units = (d.pp / 16) * ng;
  const int kend = round_up(lv, 8);
  for (int hh = h0, buf = 0; hh < h1; ++hh, buf ^= 1) {
    if (hh + 1 < h1) stage_head(hh + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    if (tid < d.lp) ew[tid] = tid < lv ? expf(ac[buf * d.lp + tid]) : 0.f;
    __syncthreads();
    // g_c[p][n] = sum_k dY[k][p] (ew[k] C[k][n]).
    const float* yb = ys + buf * ysz;
    float* out = gs + (((long long)b * nc + c) * H + hh) * d.pp * d.np;
    for (int u = warp; u < units; u += kThreads / 32) {
      const int p0 = (u / ng) * 16, n0 = (u % ng) * 8 * NT;
      float acc[NT][4] = {};
      tile_mma(acc, 0, kend,
               [&](int k, float (&f)[4]) {
                 const float* r0 = yb + (k + t) * sy + p0 + g;
                 f[0] = r0[0]; f[1] = r0[8]; f[2] = r0[4 * sy];
                 f[3] = r0[4 * sy + 8];
               },
               [&](int k, int j, float (&f)[2]) {
                 const float* r = cs + (k + t) * sc + n0 + 8 * j + g;
                 f[0] = r[0] * ew[k + t]; f[1] = r[4 * sc] * ew[k + t + 4];
               });
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float* o = out + (p0 + g) * d.np + n0 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(o + 8 * d.np) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();                             // dY[buf], acum, ew free
  }
  // C B^T: B into the dY buffers, 16 rows of C at a time after it.
  const int sb = stride_g(d.np);
  stage_tile(ys, sb, bm + row0 * N, N, lv, N, d.lp, d.np, N % 4 == 0);
  cp_async_commit();
  cp_async_wait<0>();
  cb_rows(ys + d.lp * sb, ys, sb, cm + row0 * N,
          cbg + ((long long)b * nc + c) * d.lp * d.lp, d, N, lv, grp,
          gridDim.x);
}

// Grid (ceil(pp * np / 4 / 256), H, B).  gs[(b, c, h)] holds chunk c's own
// term on entry and G_c, the gradient reaching the state chunk c leaves, on
// exit: zero for the last chunk, G_{c-1} = g_c + exp(acum_L^c) G_c; four
// chunks' loads in flight.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_pass_kernel(float* __restrict__ gs, const float* __restrict__ acum_g,
                    int S, int H, int L, int lp, int pn, int nc) {
  const int e4 = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (4 * e4 >= pn) return;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = nc - 1; c0 >= 0; c0 -= 4) {
    float4 s[4];
    float tot[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 - i;
      if (c >= 0) {
        const long long blk = ((long long)b * nc + c) * H + h;
        s[i] = reinterpret_cast<const float4*>(gs + blk * pn)[e4];
        tot[i] = acum_g[blk * lp + min(L, S - c * L) - 1];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 - i;
      if (c >= 0) {
        const long long blk = ((long long)b * nc + c) * H + h;
        reinterpret_cast<float4*>(gs + blk * pn)[e4] = carry;
        const float f = expf(tot[i]);
        carry = make_float4(fmaf(f, carry.x, s[i].x), fmaf(f, carry.y, s[i].y),
                            fmaf(f, carry.z, s[i].z), fmaf(f, carry.w, s[i].w));
      }
    }
  }
}

// Tile tau of the lower 16 x 16 triangle, row by row: (i, u), u <= i.
__device__ __forceinline__ void tri_tile(int tau, int& i, int& u) {
  i = 0;
  while ((i + 1) * (i + 2) / 2 <= tau) ++i;
  u = tau - i * (i + 1) / 2;
}

// The partials of a (chunk, run of heads): part[(b, c, grp)][0] is dB's
// and [1] dC's, each [lp][np].
__device__ __forceinline__ float* part_of(float* part, int b, int c, int grp,
                                          const Dims& d) {
  return part + (((long long)b * gridDim.y + c) * gridDim.x + grp) * 2
                    * d.lp * d.np;
}

// Grid (G, nc, B), 16 warps: block (g, c, b) takes heads [g * hpb, (g + 1)
// * hpb) of chunk c in turn.  Per head: W = C B^T o D into shared memory,
// dX into dxh, dW's tiles (E accumulated in registers) and the intra-chunk
// dacum into dag[(b, c, h)][lp].  Then part[(b, c, g)] = (E^T C, E B).
__global__ void __launch_bounds__(kBigThreads, 1)
ssd_bwd_intra_kernel(const float* __restrict__ xh, const float* __restrict__ dy,
                     const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     const float* __restrict__ gs,
                     const float* __restrict__ cbg,
                     const float* __restrict__ acum_g,
                     float* __restrict__ dxh, float* __restrict__ dag,
                     float* __restrict__ part, int S, int H, int P, int N,
                     int L, int hpb) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = dims(L, P, N);
  const int mt = d.lp / 16;
  const int sb = stride_g(d.np), sw = stride_t(d.lp), sx = stride_g(d.pp);
  const int sy = stride_t(d.pp), sg = stride_g(d.np), sc = stride_t(d.np);
  const int xz = max(d.lp * sx, d.lp * sc);
  float* bs = smem;                          // B             [lp][sb]
  float* ws = bs + d.lp * sb;                // W, then E     [lp][sw]
  float* xs = ws + d.lp * sw;                // X, then C     [lp][sx | sc]
  float* ys = xs + xz;                       // dY            [lp][sy]
  float* gm = ys + d.lp * sy;                // G             [pp][sg]
  float* ac = gm + d.pp * sg;                // acum          [lp]
  float* dk = ac + d.lp;                     // exp(acum_L - acum) [lp]
  float* rsum = dk + d.lp;                   // rowsum(dW o W) by tile column
  float* csum = rsum + mt * d.lp;            // colsum(dW o W) by tile row
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int t0 = c * L, lv = min(L, S - t0);
  const long long row0 = (long long)b * S + t0;
  const int h0 = grp * hpb, h1 = min(H, h0 + hpb);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kv = round_up(lv, 8);
  const long long xld = (long long)H * P;
  const float* cbc = cbg + ((long long)b * nc + c) * d.lp * d.lp;
  const int k4 = 4 * lane;

  stage_tile(bs, sb, bm + row0 * N, N, lv, N, d.lp, d.np, N % 4 == 0);
  const int ntri = mt * (mt + 1) / 2;
  float esum[kETiles][2][4] = {};

  for (int hh = h0; hh < h1; ++hh) {
    const long long blk = ((long long)b * nc + c) * H + hh;
    stage_tile(xs, sx, xh + (row0 * H + hh) * P, xld, lv, P, d.lp, d.pp,
               P % 4 == 0);
    stage_tile(ys, sy, dy + (row0 * H + hh) * P, xld, lv, P, d.lp, d.pp,
               P % 4 == 0);
    stage_tile(gm, sg, gs + blk * d.pp * d.np, d.np, d.pp, d.np, d.pp, d.np,
               true);
    stage_tile(ac, d.lp, acum_g + blk * d.lp, d.lp, 1, d.lp, 1, d.lp, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (tid < d.lp) dk[tid] = tid < lv ? expf(ac[lv - 1] - ac[tid]) : 0.f;
    // W[q][k] = (C B^T)[q][k] exp(acum_q - acum_k), masked as the forward
    // masks it; C B^T from L2, rows warp + 16 i at columns 4 lane ...
#pragma unroll
    for (int i = 0; i < kCbRegs; ++i) {
      const int q = warp + 16 * i;
      if (q >= d.lp || k4 >= d.lp) continue;
      const float4 cv =
          q < lv && k4 <= q
              ? *reinterpret_cast<const float4*>(cbc + q * d.lp + k4)
              : make_float4(0.f, 0.f, 0.f, 0.f);
      const float4 ak = *reinterpret_cast<const float4*>(ac + k4);
      const float aq = ac[q];
      const float vv[4] = {cv.x, cv.y, cv.z, cv.w};
      const float kk[4] = {ak.x, ak.y, ak.z, ak.w};
      float w[4];
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        const float rel = k4 + m <= q && q < lv ? aq - kk[m] : -1e30f;
        w[m] = vv[m] * __expf(rel);
      }
      *reinterpret_cast<float4*>(ws + q * sw + k4) =
          make_float4(w[0], w[1], w[2], w[3]);
    }
    __syncthreads();

    // dX rows [16u, 16u + 16) by 16 columns of P: dk o (B G^T), then
    // + W^T dY over q in [16u, lv) (W is zero above the diagonal).
    const int ngp = d.pp / 16;
    for (int v = warp; v < mt * ngp; v += kBigWarps) {
      const int k0 = 16 * (v / ngp), p0 = 16 * (v % ngp);
      if (k0 >= lv) continue;
      float acc[2][4] = {};
      tile_mma(acc, 0, d.np,
               [&](int n, float (&f)[4]) {
                 const float* r0 = bs + (k0 + g) * sb + n + t;
                 f[0] = r0[0]; f[1] = r0[8 * sb]; f[2] = r0[4];
                 f[3] = r0[8 * sb + 4];
               },
               [&](int n, int j, float (&f)[2]) {
                 const float* r = gm + (p0 + 8 * j + g) * sg + n + t;
                 f[0] = r[0]; f[1] = r[4];
               });
      const float d0 = dk[k0 + g], d1 = dk[k0 + g + 8];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        acc[j][0] *= d0; acc[j][1] *= d0; acc[j][2] *= d1; acc[j][3] *= d1;
      }
      tile_mma(acc, k0, kv,
               [&](int q, float (&f)[4]) {
                 const float* r0 = ws + (q + t) * sw + k0 + g;
                 f[0] = r0[0]; f[1] = r0[8]; f[2] = r0[4 * sw];
                 f[3] = r0[4 * sw + 8];
               },
               [&](int q, int j, float (&f)[2]) {
                 const float* r = ys + (q + t) * sy + p0 + 8 * j + g;
                 f[0] = r[0]; f[1] = r[4 * sy];
               });
      float* ob = dxh + (row0 * H + hh) * P;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int p = p0 + 8 * j + 2 * t;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int k = k0 + g + 8 * r;
          if (k >= lv) continue;
          float* o = ob + k * xld + p;
          const float v0 = acc[j][2 * r], v1 = acc[j][2 * r + 1];
          if (p + 1 < P && P % 2 == 0) {
            *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
          } else {
            if (p < P) o[0] = v0;
            if (p + 1 < P) o[1] = v1;
          }
        }
      }
    }

    // dW = dY X^T by tiles (i, u) of the triangle: E += dW o D, and the
    // tile's row and column sums of dW o W.
#pragma unroll
    for (int e = 0; e < kETiles; ++e) {
      const int tau = warp + kBigWarps * e;
      if (tau >= ntri) continue;
      int i, u;
      tri_tile(tau, i, u);
      const int q0 = 16 * i, k0 = 16 * u;
      float acc[2][4] = {};
      tile_mma(acc, 0, d.pp,
               [&](int p, float (&f)[4]) {
                 const float* r0 = ys + (q0 + g) * sy + p + t;
                 f[0] = r0[0]; f[1] = r0[8 * sy]; f[2] = r0[4];
                 f[3] = r0[8 * sy + 4];
               },
               [&](int p, int j, float (&f)[2]) {
                 const float* r = xs + (k0 + 8 * j + g) * sx + p + t;
                 f[0] = r[0]; f[1] = r[4];
               });
      float rp[2] = {0.f, 0.f}, cp[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
#pragma unroll
          for (int x = 0; x < 2; ++x) {
            const int q = q0 + g + 8 * r, k = k0 + 8 * j + 2 * t + x;
            const float dw = acc[j][2 * r + x];
            const float rel = k <= q && q < lv ? ac[q] - ac[k] : -1e30f;
            esum[e][j][2 * r + x] += dw * __expf(rel);
            const float ww = dw * ws[q * sw + k];
            rp[r] += ww;
            cp[j][x] += ww;
          }
        }
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        rp[r] += __shfl_xor_sync(0xffffffffu, rp[r], 1);
        rp[r] += __shfl_xor_sync(0xffffffffu, rp[r], 2);
      }
#pragma unroll
      for (int j = 0; j < 2; ++j) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          cp[j][x] += __shfl_xor_sync(0xffffffffu, cp[j][x], 4);
          cp[j][x] += __shfl_xor_sync(0xffffffffu, cp[j][x], 8);
          cp[j][x] += __shfl_xor_sync(0xffffffffu, cp[j][x], 16);
        }
      }
      if (t == 0) {
        rsum[u * d.lp + q0 + g] = rp[0];
        rsum[u * d.lp + q0 + g + 8] = rp[1];
      }
      if (g == 0) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          csum[i * d.lp + k0 + 8 * j + 2 * t] = cp[j][0];
          csum[i * d.lp + k0 + 8 * j + 2 * t + 1] = cp[j][1];
        }
      }
    }
    __syncthreads();
    if (tid < d.lp) {
      const int blk16 = tid / 16;
      float v = 0.f;
      for (int u = 0; u <= blk16; ++u) v += rsum[u * d.lp + tid];
      for (int i = blk16; i < mt; ++i) v -= csum[i * d.lp + tid];
      dag[blk * d.lp + tid] = v;
    }
    __syncthreads();                             // every buffer free
  }

  // E into shared memory (tiles of the triangle; the rest is never read),
  // C over X.  part[0] = E^T C (dB), part[1] = E B (dC).
#pragma unroll
  for (int e = 0; e < kETiles; ++e) {
    const int tau = warp + kBigWarps * e;
    if (tau >= ntri) continue;
    int i, u;
    tri_tile(tau, i, u);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* o = ws + (16 * i + g) * sw + 16 * u + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(esum[e][j][0], esum[e][j][1]);
      *reinterpret_cast<float2*>(o + 8 * sw) =
          make_float2(esum[e][j][2], esum[e][j][3]);
    }
  }
  stage_tile(xs, sc, cm + row0 * N, N, lv, N, d.lp, d.np, N % 4 == 0);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  float* out = part_of(part, b, c, grp, d);
  const int ngn = d.np / 16;
  for (int v = warp; v < 2 * mt * ngn; v += kBigWarps) {
    const int kind = v / (mt * ngn), rem = v % (mt * ngn);
    const int m0 = 16 * (rem / ngn), n0 = 16 * (rem % ngn);
    float acc[2][4] = {};
    if (kind == 0) {
      // dB[k][n] = sum_{q >= k} E[q][k] C[q][n]
      tile_mma(acc, m0, kv,
               [&](int q, float (&f)[4]) {
                 const float* r0 = ws + (q + t) * sw + m0 + g;
                 f[0] = r0[0]; f[1] = r0[8]; f[2] = r0[4 * sw];
                 f[3] = r0[4 * sw + 8];
               },
               [&](int q, int j, float (&f)[2]) {
                 const float* r = xs + (q + t) * sc + n0 + 8 * j + g;
                 f[0] = r[0]; f[1] = r[4 * sc];
               });
    } else {
      // dC[q][n] = sum_{k <= q} E[q][k] B[k][n]
      tile_mma(acc, 0, min(m0 + 16, kv),
               [&](int k, float (&f)[4]) {
                 const float* r0 = ws + (m0 + g) * sw + k + t;
                 f[0] = r0[0]; f[1] = r0[8 * sw]; f[2] = r0[4];
                 f[3] = r0[8 * sw + 4];
               },
               [&](int k, int j, float (&f)[2]) {
                 const float* r = bs + (k + t) * sb + n0 + 8 * j + g;
                 f[0] = r[0]; f[1] = r[4 * sb];
               });
    }
    float* o0 = out + kind * d.lp * d.np;
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      float* o = o0 + (m0 + g) * d.np + n0 + 8 * j + 2 * t;
      *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
      *reinterpret_cast<float2*>(o + 8 * d.np) =
          make_float2(acc[j][2], acc[j][3]);
    }
  }
}

// Grid (G, nc, B) as the intra kernel's, 16 warps, U units of 16 x 16 a
// warp.  Per head: diag(exp(acum)) dY h (dC's state term) and diag(dk) X G
// (dB's), their row dots with C and B, <G, h_out> and the reverse scan of
// dacum into da.  Then both terms, summed over the heads, onto
// part[(b, c, g)].
template <int U>
__global__ void __launch_bounds__(kBigThreads, 1)
ssd_bwd_state_kernel(const float* __restrict__ xh, const float* __restrict__ dy,
                     const float* __restrict__ bm,
                     const float* __restrict__ cm,
                     const float* __restrict__ st,
                     const float* __restrict__ gs,
                     const float* __restrict__ acum_g,
                     const float* __restrict__ dag, float* __restrict__ da,
                     float* __restrict__ part, int S, int H, int P, int N,
                     int L, int hpb) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = dims(L, P, N);
  const int sb = stride_g(d.np), sx = stride_g(d.pp), sh = stride_t(d.np);
  const int ngn = d.np / 16;
  float* bs = smem;                          // B            [lp][sb]
  float* cs = bs + d.lp * sb;                // C            [lp][sb]
  float* xs = cs + d.lp * sb;                // X            [lp][sx]
  float* ys = xs + d.lp * sx;                // dY           [lp][sx]
  float* hs = ys + d.lp * sx;                // h entering   [pp][sh]
  float* gm = hs + d.pp * sh;                // G            [pp][sh]
  float* ac = gm + d.pp * sh;                // acum         [lp]
  float* ew = ac + d.lp;                     // exp(acum)    [lp]
  float* dk = ew + d.lp;                     // exp(acum_L - acum) [lp]
  float* dg = dk + d.lp;                     // intra dacum  [lp]
  float* rpart = dg + d.lp;                  // row dots [2][ngn][lp]
  float* wsum = rpart + 2 * ngn * d.lp;      // <G, h_out> by warp
  float* stot = wsum + kBigWarps;            // the scan's warp totals
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int t0 = c * L, lv = min(L, S - t0);
  const long long row0 = (long long)b * S + t0;
  const int h0 = grp * hpb, h1 = min(H, h0 + hpb);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long xld = (long long)H * P;
  const int pn = d.pp * d.np;

  stage_tile(bs, sb, bm + row0 * N, N, lv, N, d.lp, d.np, N % 4 == 0);
  stage_tile(cs, sb, cm + row0 * N, N, lv, N, d.lp, d.np, N % 4 == 0);
  const int units = state_units(d), half = units / 2;
  float sum[U][2][4] = {};

  for (int hh = h0; hh < h1; ++hh) {
    const long long blk = ((long long)b * nc + c) * H + hh;
    stage_tile(xs, sx, xh + (row0 * H + hh) * P, xld, lv, P, d.lp, d.pp,
               P % 4 == 0);
    stage_tile(ys, sx, dy + (row0 * H + hh) * P, xld, lv, P, d.lp, d.pp,
               P % 4 == 0);
    stage_tile(hs, sh, st + blk * pn, d.np, d.pp, d.np, d.pp, d.np, true);
    stage_tile(gm, sh, gs + blk * pn, d.np, d.pp, d.np, d.pp, d.np, true);
    stage_tile(ac, d.lp, acum_g + blk * d.lp, d.lp, 1, d.lp, 1, d.lp, true);
    stage_tile(dg, d.lp, dag + blk * d.lp, d.lp, 1, d.lp, 1, d.lp, true);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    if (tid < d.lp) {
      ew[tid] = tid < lv ? expf(ac[tid]) : 0.f;
      dk[tid] = tid < lv ? expf(ac[lv - 1] - ac[tid]) : 0.f;
    }
    __syncthreads();
    // Unit v < half: rows [m0, m0 + 16) of ew o (dY h), columns n0 ..
    // n0 + 15 (dC); v >= half the same of dk o (X G) (dB).
#pragma unroll
    for (int j = 0; j < U; ++j) {
      const int v = warp + kBigWarps * j;
      if (v >= units) continue;
      const int kind = v / half, rem = v % half;
      const int m0 = 16 * (rem / ngn), n0 = 16 * (rem % ngn);
      const float* a_s = kind == 0 ? ys : xs;
      const float* b_s = kind == 0 ? hs : gm;
      const float* scale = kind == 0 ? ew : dk;
      const float* dot = kind == 0 ? cs : bs;
      float acc[2][4] = {};
      tile_mma(acc, 0, d.pp,
               [&](int p, float (&f)[4]) {
                 const float* r0 = a_s + (m0 + g) * sx + p + t;
                 f[0] = r0[0]; f[1] = r0[8 * sx]; f[2] = r0[4];
                 f[3] = r0[8 * sx + 4];
               },
               [&](int p, int jj, float (&f)[2]) {
                 const float* r = b_s + (p + t) * sh + n0 + 8 * jj + g;
                 f[0] = r[0]; f[1] = r[4 * sh];
               });
      float rp[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int m = m0 + g + 8 * r;
        const float sc = scale[m];
        rp[r] = 0.f;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int n = n0 + 8 * jj + 2 * t;
          const float v0 = acc[jj][2 * r] * sc, v1 = acc[jj][2 * r + 1] * sc;
          sum[j][jj][2 * r] += v0;
          sum[j][jj][2 * r + 1] += v1;
          rp[r] += v0 * dot[m * sb + n] + v1 * dot[m * sb + n + 1];
        }
        rp[r] += __shfl_xor_sync(0xffffffffu, rp[r], 1);
        rp[r] += __shfl_xor_sync(0xffffffffu, rp[r], 2);
      }
      if (t == 0) {
        float* o = rpart + (kind * ngn + n0 / 16) * d.lp + m0 + g;
        o[0] = rp[0];
        o[8] = rp[1];
      }
    }
    // <G, h_out>, h_out the state entering the next chunk (G is zero for
    // the last chunk).
    float hg = 0.f;
    if (c + 1 < nc) {
      const float4* hout = reinterpret_cast<const float4*>(
          st + (blk + H) * pn);
      for (int e4 = tid; e4 < pn / 4; e4 += kBigThreads) {
        const int p = 4 * e4 / d.np, n = 4 * e4 % d.np;
        const float4 hv = hout[e4];
        const float* gv = gm + p * sh + n;
        hg += hv.x * gv[0] + hv.y * gv[1] + hv.z * gv[2] + hv.w * gv[3];
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      hg += __shfl_xor_sync(0xffffffffu, hg, off);
    }
    if (lane == 0) wsum[warp] = hg;
    __syncthreads();
    // da[j] = sum_{q >= j} dacum[q]: thread i holds dacum[lv - 1 - i], an
    // inclusive scan over the threads.
    float v = 0.f;
    if (tid < lv) {
      const int q = lv - 1 - tid;
      v = dg[q];
      for (int nb = 0; nb < ngn; ++nb) v += rpart[nb * d.lp + q];
      for (int nb = 0; nb < ngn; ++nb) v -= rpart[(ngn + nb) * d.lp + q];
      if (tid == 0) {
        for (int w = 0; w < kBigWarps; ++w) v += wsum[w];
      }
    }
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    if (lane == 31) stot[warp] = v;
    __syncthreads();
    if (tid < lv) {
      for (int w = 0; w < warp; ++w) v += stot[w];
      da[(row0 + lv - 1 - tid) * H + hh] = v;
    }
    __syncthreads();                             // every buffer free
  }

  float* out = part_of(part, b, c, grp, d);
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int v = warp + kBigWarps * j;
    if (v >= units) continue;
    const int kind = v / half, rem = v % half;
    const int m0 = 16 * (rem / ngn), n0 = 16 * (rem % ngn);
    // dC's term onto part[1], dB's onto part[0].
    float* o0 = out + (1 - kind) * d.lp * d.np;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2* o = reinterpret_cast<float2*>(
            o0 + (m0 + g + 8 * r) * d.np + n0 + 8 * jj + 2 * t);
        const float2 was = *o;
        *o = make_float2(was.x + sum[j][jj][2 * r],
                         was.y + sum[j][jj][2 * r + 1]);
      }
    }
  }
}

// One thread per (b, s, n): db and dc, the G partials of s's chunk summed
// in order.
__global__ void __launch_bounds__(kThreads)
ssd_bwd_reduce_kernel(const float* __restrict__ part, float* __restrict__ db,
                      float* __restrict__ dc, int B, int S, int N, int L,
                      int lp, int np, int nc, int G) {
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= (long long)B * S * N) return;
  const int n = static_cast<int>(e % N);
  const long long bs = e / N;
  const int s = static_cast<int>(bs % S), b = static_cast<int>(bs / S);
  const int c = s / L, q = s - c * L;
  const float* p = part + (((long long)b * nc + c) * G) * 2 * lp * np
                   + q * np + n;
  float vb = 0.f, vc = 0.f;
  for (int grp = 0; grp < G; ++grp) {
    vb += p[0];
    vc += p[lp * np];
    p += 2 * lp * np;
  }
  db[e] = vb;
  dc[e] = vc;
}

int backward_groups(int H, int nc, int B, int sms) {
  const int hpb = heads_per_block(H, nc, B, sms);
  return (H + hpb - 1) / hpb;
}

int sm_count() {
  static const int sms = device_attr(cudaDevAttrMultiProcessorCount, 132);
  return sms;
}

}  // namespace

// Bytes of dynamic shared memory the largest backward kernel needs at
// (chunk L, P, N), or 0 if the tiling does not take the shape (L > 128, or
// (L / 16) (N / 16) > 32 rounded up: N > 64 at L = 128).  The wrapper holds
// it to the card's limit.
extern "C" int repro_ssd_scan_bwd_smem_bytes(int L, int P, int N) {
  if (L < 1 || L > kMaxChunk || P < 1 || N < 1) return 0;
  const Dims d = dims(L, P, N);
  if (state_units(d) > kStateSlots * kBigWarps) return 0;
  int m = local_smem_floats(d);
  m = max(m, intra_smem_floats(d));
  m = max(m, state_smem_floats(d));
  return m * static_cast<int>(sizeof(float));
}

// Runs of heads the intra and state kernels split each chunk into: the
// leading dimension G of the partials' scratch.
extern "C" int repro_ssd_scan_bwd_groups(int H, int nc, int B) {
  return backward_groups(H, nc, B, sm_count());
}

// The five launches.  Inputs xh, dy (B, S, H, P), b, c (B, S, N), the
// forward's entering states st (B, nc, H, pp, np) and acum (B, nc, H, lp);
// scratch gs (B, nc, H, pp, np), cb (B, nc, lp, lp), dag (B, nc, H, lp) and
// part (B, nc, G, 2, lp, np) floats, G from repro_ssd_scan_bwd_groups;
// outputs dxh (B, S, H, P), da (B, S, H), db, dc (B, S, N).  Returns
// cudaGetLastError() after the launches (or the attribute call's error).
extern "C" int repro_ssd_scan_bwd_f32(const void* xh, const void* bm,
                                      const void* cm, const void* dy,
                                      const void* st, const void* acum,
                                      void* gs, void* cb, void* dag,
                                      void* part, void* dxh, void* da,
                                      void* db, void* dc, int B, int S,
                                      int H, int P, int N, int L,
                                      void* stream) {
  const int nc = S > 0 && L > 0 ? (S + L - 1) / L : 0;
  if (repro_ssd_scan_bwd_smem_bytes(L, P, N) == 0 || B <= 0 || B > 65535
      || H <= 0 || S <= 0 || nc > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Dims d = dims(L, P, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(xh);
  const float* bf = static_cast<const float*>(bm);
  const float* cf = static_cast<const float*>(cm);
  const float* yf = static_cast<const float*>(dy);
  const float* sf = static_cast<const float*>(st);
  const float* af = static_cast<const float*>(acum);
  float* gf = static_cast<float*>(gs);
  float* cbf = static_cast<float*>(cb);
  float* dgf = static_cast<float*>(dag);
  float* pf = static_cast<float*>(part);
  const int sms = sm_count(), fsize = static_cast<int>(sizeof(float));
  cudaError_t err;

  const int smem_local = local_smem_floats(d) * fsize;
  const int hpb_local = heads_per_block(H, nc, B, 2 * sms);
  const dim3 grid_local((H + hpb_local - 1) / hpb_local, nc, B);
  if (d.np % 32 == 0) {
    static int granted = 48 * 1024;
    err = grant_smem(ssd_bwd_local_kernel<4>, smem_local, granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_local_kernel<4><<<grid_local, kThreads, smem_local, s>>>(
        yf, bf, cf, af, gf, cbf, S, H, P, N, L, hpb_local);
  } else {
    static int granted = 48 * 1024;
    err = grant_smem(ssd_bwd_local_kernel<2>, smem_local, granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_local_kernel<2><<<grid_local, kThreads, smem_local, s>>>(
        yf, bf, cf, af, gf, cbf, S, H, P, N, L, hpb_local);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int pn = d.pp * d.np;
  ssd_bwd_pass_kernel<<<dim3((pn / 4 + kThreads - 1) / kThreads, H, B),
                        kThreads, 0, s>>>(gf, af, S, H, L, d.lp, pn, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int hpb = heads_per_block(H, nc, B, sms);
  const dim3 grid((H + hpb - 1) / hpb, nc, B);
  {
    static int granted = 48 * 1024;
    const int smem = intra_smem_floats(d) * fsize;
    err = grant_smem(ssd_bwd_intra_kernel, smem, granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_intra_kernel<<<grid, kBigThreads, smem, s>>>(
        xf, yf, bf, cf, gf, cbf, af, static_cast<float*>(dxh), dgf, pf, S, H,
        P, N, L, hpb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  {
    static int granted = 48 * 1024;
    const int smem = state_smem_floats(d) * fsize;
    err = grant_smem(ssd_bwd_state_kernel<kStateSlots>, smem, granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_state_kernel<kStateSlots><<<grid, kBigThreads, smem, s>>>(
        xf, yf, bf, cf, sf, gf, af, dgf, static_cast<float*>(da), pf, S, H,
        P, N, L, hpb);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }

  const long long outs = (long long)B * S * N;
  ssd_bwd_reduce_kernel<<<static_cast<unsigned>((outs + kThreads - 1)
                                                / kThreads),
                          kThreads, 0, s>>>(
      pf, static_cast<float*>(db), static_cast<float*>(dc), B, S, N, L, d.lp,
      d.np, nc, grid.x);
  return static_cast<int>(cudaGetLastError());
}
