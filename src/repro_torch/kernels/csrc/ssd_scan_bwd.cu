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
// their gradients and the decays: 0.090 ms at 3.35 TB/s); its products
// (chip_smoke.py's _ssd_bwd_flops) are 2.0x the forward's: 16.2 GFLOP,
// 0.243 ms as fp32 FMAs at 67 TFLOP/s, 0.098 ms as three TF32 products
// each at 495.  In practice it is bound by the latency of each head's
// chain inside a block: the operands' low halves, the products, the
// epilogue, one after another.
//
// Design: the forward's state-passing skeleton run backward, four launches,
// no atomics (two calls give the same bits):
//  1. per (chunk, run of heads): each chunk's own term of G, dY^T
//     diag(exp(acum)) C, a (P x L)(L x N) product as the forward's state
//     kernel forms its state; then the chunk's C B^T rows (cb_rows, shared
//     out among the blocks of a chunk).  Where the middle launch is the
//     wide one, ssd_bwd_local_wide_kernel: TF32 wgmma m64n64k8, B = C^T
//     split once a block, each warpgroup on every other head with its next
//     head's dY in flight; else ssd_bwd_local_kernel on mma.sync, the next
//     head's dY in flight while it works on this one.
//  2. ssd_bwd_pass_kernel: the reverse carry over the chunks, which
//     overwrites each local term with the G of its chunk.
//  3. The middle launch, per (chunk, run of heads):
//     - chunk 128 and P = N = 64 (zamba2's), two heads or more a block (the
//       "wide" shapes):
//       ssd_bwd_wide_kernel, on TF32 wgmma (tf32_wgmma.cuh).  A producer
//       warpgroup lands each head's tiles by cp.async into one of two
//       stages, K-major as the products read them (dY^T transposed by
//       4-byte copies), while two consumer warpgroups work on the other
//       stage: they write the low TF32 halves beside the landed values
//       (the fp32 value itself is the high half: the tensor cores read a
//       TF32 operand's top 19 bits), so each operand is split once per
//       block and head, and run m64n64k8 products in 3xTF32 (lo*hi, hi*lo,
//       hi*hi a k-step).  A (chunk, run) is four blocks, side by side in
//       the grid so that X and dY are shared through L2: kind 0, dX =
//       W^T dY + diag(dk) B G^T (A from registers: B's rows times dk, W
//       formed from C B^T and the decays; two groups of 4 k-steps in
//       flight); kind 1, dW = dY X^T on the triangle in three 64 x 64
//       blocks, E in registers over the heads, rowsum - colsum(dW o W)
//       (C B^T in registers), then E^T C and E B (mma.sync, once a
//       block); kinds 2 and 3 (twice the heads a block), dY h and X G
//       with h and G transposed, their row dots with C and B, and
//       <G, h_out> as exp(acum_L) <G, h> + the dots' sum (h_out =
//       exp(acum_L) h + X^T diag(dk) B), which spares reading the next
//       chunk's state.
//     - otherwise (another shape, or one head a block, where the wide
//       blocks' set-up outweighs their head): ssd_bwd_tile_kernel, its
//       intra-chunk and state blocks as two kinds of one launch, on
//       mma.sync.m16n8k8 in 3xTF32 (ssd_tiles.cuh), tiles by cp.async;
//       where those would be more than one block an SM, one block a
//       (chunk, run) runs both in turn and adds its state terms onto its
//       own partials of dB and dC.
//     Each block writes its own parts of dacum (three slots) and of dB and
//     dC (four; two where the tile path fuses).
//  4. ssd_bwd_finish_kernel: da, the reverse cumulative sum over the chunk
//     of dacum's parts (a warp per chunk and head), and dB and dC, the
//     partials of a chunk's runs of heads summed in order.
// Rows past S are zeros.
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "ssd_tiles.cuh"
#include "tf32_wgmma.cuh"

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
// dacum's parts a (chunk, head) holds, summed by the finishing launch: the
// wide path's dW, dY h and X G blocks write one each, the tile path's
// intra and state blocks the first two.
constexpr int kDacumSlots = 3;
// Partials a (chunk, run of heads) holds: dB's E^T C and state term, dC's
// E B and state term.
constexpr int kPartSlots = 4;

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
// state: B, C, X, dY, h, G, acum, exp(acum), dk, the row partials of both
// products and the warp sums of <G, h_out>.
__host__ __device__ inline int state_smem_floats(const Dims& d) {
  return 2 * d.lp * stride_g(d.np) + 2 * d.lp * stride_g(d.pp)
         + 2 * d.pp * stride_t(d.np) + 3 * d.lp + 2 * (d.np / 16) * d.lp
         + kBigWarps;
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

// The partials of a (chunk, run of heads grp of G): part[(b, c, grp)][s],
// each [lp][np]: s = 0 E^T C and s = 2 the state term of dB, s = 1 E B and
// s = 3 the state term of dC.
__device__ __forceinline__ float* part_of(float* part, int b, int c, int nc,
                                          int grp, int G, const Dims& d) {
  return part + ((((long long)b * nc + c) * G + grp) * kPartSlots)
                    * d.lp * d.np;
}

// The tile path's intra-chunk block, 16 warps: heads [grp * hpb, (grp + 1)
// * hpb) of chunk c in turn.  Per head: W = C B^T o D into shared memory,
// dX into dxh, dW's tiles (E accumulated in registers) and the intra-chunk
// dacum into slot 0 of dag.  Then part[(b, c, grp)] slots 0 and 1 = (E^T C,
// E B).
__device__ __forceinline__ void tile_intra(
    float* smem, const float* __restrict__ xh, const float* __restrict__ dy,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ gs, const float* __restrict__ cbg,
    const float* __restrict__ acum_g, float* __restrict__ dxh,
    float* __restrict__ dag, float* __restrict__ part, int S, int H, int P,
    int N, int L, int hpb, int grp, int G, int c, int nc, int b) {
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
      dag[(blk * kDacumSlots) * d.lp + tid] = v;
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
  float* out = part_of(part, b, c, nc, grp, G, d);
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

// The tile path's state block, same runs as tile_intra, 16 warps, U units
// of 16 x 16 a warp.  Per head: diag(exp(acum)) dY h (dC's state term) and
// diag(dk) X G (dB's), their row dots with C and B and <G, h_out>, into
// slot 1 of dag.  Then both terms, summed over the heads, into part[(b,
// c, grp)] slots 3 and 2, or, `onto` (the block ran tile_intra first),
// added onto its slots 1 and 0.
template <int U>
__device__ __forceinline__ void tile_state(
    float* smem, const float* __restrict__ xh, const float* __restrict__ dy,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ st, const float* __restrict__ gs,
    const float* __restrict__ acum_g, float* __restrict__ dag,
    float* __restrict__ part, int S, int H, int P, int N, int L, int hpb,
    int grp, int G, int c, int nc, int b, bool onto) {
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
  float* rpart = dk + d.lp;                  // row dots [2][ngn][lp]
  float* wsum = rpart + 2 * ngn * d.lp;      // <G, h_out> by warp
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
    // This head's state part of dacum: the row dots with C less those with
    // B, and <G, h_out> at the chunk's last row.
    if (tid < d.lp) {
      float v = 0.f;
      if (tid < lv) {
        for (int nb = 0; nb < ngn; ++nb) v += rpart[nb * d.lp + tid];
        for (int nb = 0; nb < ngn; ++nb) v -= rpart[(ngn + nb) * d.lp + tid];
        if (tid == lv - 1) {
          for (int w = 0; w < kBigWarps; ++w) v += wsum[w];
        }
      }
      dag[(blk * kDacumSlots + 1) * d.lp + tid] = v;
    }
    __syncthreads();                             // every buffer free
  }

  float* out = part_of(part, b, c, nc, grp, G, d);
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int v = warp + kBigWarps * j;
    if (v >= units) continue;
    const int kind = v / half, rem = v % half;
    const int m0 = 16 * (rem / ngn), n0 = 16 * (rem % ngn);
    // dC's term into slot 3, dB's into slot 2 (onto: slots 1 and 0).
    float* o0 = out + ((onto ? 1 : 3) - kind) * d.lp * d.np;
#pragma unroll
    for (int jj = 0; jj < 2; ++jj) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2* o = reinterpret_cast<float2*>(
            o0 + (m0 + g + 8 * r) * d.np + n0 + 8 * jj + 2 * t);
        float2 v = make_float2(sum[j][jj][2 * r], sum[j][jj][2 * r + 1]);
        if (onto) {
          const float2 e = *o;
          v = make_float2(e.x + v.x, e.y + v.y);
        }
        *o = v;
      }
    }
  }
}

// The tile path's middle launch, 16 warps.  Grid (2 G nc, B): block (kind
// G nc + c G + grp, b) is run grp of chunk c's heads in batch row b,
// tile_intra for kind 0, tile_state for kind 1; a row's intra-chunk blocks
// come first in the grid, so that the lighter state blocks fill in behind
// them.  `fused` (where that grid is more than one block an SM): grid
// (G nc, B), block (c G + grp, b) runs tile_intra and then tile_state,
// which adds its terms onto the block's own partials, so that the
// finishing launch reads two slots a run, not four.
template <int U>
__global__ void __launch_bounds__(kBigThreads, 1)
ssd_bwd_tile_kernel(const float* __restrict__ xh, const float* __restrict__ dy,
                    const float* __restrict__ bm, const float* __restrict__ cm,
                    const float* __restrict__ st, const float* __restrict__ gs,
                    const float* __restrict__ cbg,
                    const float* __restrict__ acum_g,
                    float* __restrict__ dxh, float* __restrict__ dag,
                    float* __restrict__ part, int S, int H, int P, int N,
                    int L, int hpb, int fused) {
  extern __shared__ __align__(16) float smem[];
  const int nc = (S + L - 1) / L, G = gridDim.x / ((fused ? 1 : 2) * nc);
  const int x = blockIdx.x, kind = x / (G * nc), r = x - kind * G * nc;
  const int c = r / G, grp = r - c * G, b = blockIdx.y;
  if (kind == 0) {
    tile_intra(smem, xh, dy, bm, cm, gs, cbg, acum_g, dxh, dag, part, S, H,
               P, N, L, hpb, grp, G, c, nc, b);
    if (!fused) return;
    __syncthreads();                   // shared memory and partials
  }
  tile_state<U>(smem, xh, dy, bm, cm, st, gs, acum_g, dag, part, S, H, P, N,
                L, hpb, grp, G, c, nc, b, fused != 0);
}

// ---------------------------------------------------------------- wide path
// Chunk 128, P = N = 64 (zamba2's): the middle launch on TF32 wgmma.  A
// block is three warpgroups: a producer that lands each head's tiles by
// cp.async into one of two stages, K-major (tf32_wgmma.cuh) as the
// products read them, and two consumers that add the tiles' low TF32
// halves beside them (the landed fp32 value itself is the high half: the
// tensor cores read a TF32 operand's top 19 bits) and run the products,
// while the producer lands the next head.  Each (chunk, run of heads) is
// split four ways by kind.
constexpr int kWL = 128, kWP = 64, kWN = 64;
constexpr int kWideThreads = 256;         // two consumer warpgroups
constexpr int kProducerThreads = 128;     // and a producer
constexpr int kPlane = kWL * kWP;         // an L x 64 plane, floats
constexpr int kPlanePN = kWP * kWN;       // a P x N plane
constexpr int kRowLd = kWP + 4;           // a P x N tile landed by rows
constexpr int kStgPN = kWP * kRowLd;
constexpr int kCbLd = kWL + 8;            // C B^T rows (W^T fragments)
// Floats of a stage and of a block, by kind.  dX: dY^T and G as planes,
// acum; the low planes, C B^T, acum and dk.
constexpr int kDxStage = kPlane + kPlanePN + kWL;
constexpr int kDxFloats = 2 * kDxStage + kPlane + kPlanePN + kWL * kCbLd
                          + 2 * kWL;
// dW: X and dY as planes, acum; the low planes, acum, row sums by
// warpgroup, column sums by (warpgroup, warp).  The tail's E, C and B
// reuse the front.
constexpr int kDwStage = 2 * kPlane + kWL;
constexpr int kDwFloats = 2 * kDwStage + 2 * kPlane + kWL + 2 * kWL + 8 * kWL;
// dY h / X G: dY (X) as a plane, h (G, h) by rows, acum; the low plane,
// the transposed h's (G's) planes, acum, the row scale, row dots, totals.
constexpr int kS4Stage = kPlane + kStgPN + kWL;
constexpr int kS5Stage = kPlane + 2 * kStgPN + kWL;
constexpr int kSFloats = 2 * kS5Stage + kPlane + 2 * kPlanePN + 3 * kWL + 16;
constexpr int kBars = 8;                  // 4 mbarriers before the stages
constexpr int kWideFloats =
    kBars
    + (kDxFloats > kDwFloats ? (kDxFloats > kSFloats ? kDxFloats : kSFloats)
                             : (kDwFloats > kSFloats ? kDwFloats : kSFloats));

struct WideArgs {
  const float *xh, *dy, *bm, *cm, *st, *gs, *cbg, *acum;
  float *dxh, *dag, *part;
  int S, H, hpb, G;
};

// This thread's warpgroup, as a value the compiler knows to be the same
// across the warp: wgmma under a branch on it is not under a divergent
// branch.
__device__ __forceinline__ int warpgroup() {
  return __shfl_sync(0xffffffffu, static_cast<int>(threadIdx.x) >> 7, 0);
}

// What a block of the wide launch works on: chunk c of batch row b, heads
// [h0, h1), lv valid rows.
struct WideBlock {
  int b, c, nc, grp, h0, h1, lv;
  long long row0;
  __device__ WideBlock(const WideArgs& w, int grp_, int hpb) {
    b = blockIdx.z; c = blockIdx.y; nc = gridDim.y; grp = grp_;
    h0 = grp * hpb; h1 = min(w.H, h0 + hpb);
    lv = min(kWL, w.S - c * kWL);
    row0 = (long long)b * w.S + (long long)c * kWL;
  }
  __device__ long long blk(const WideArgs& w, int hh) const {
    return ((long long)b * nc + c) * w.H + hh;
  }
};

// The consumer warpgroups' barrier (the producer's threads are not in it).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
}

// Producer thread p of 128: rows [0, rows) of 64 floats, row r from src + r
// * ld (16-byte aligned), into a K-major (R x 64) plane.  A warp copies 8
// rows by 4 chunks of 16 bytes: 64 contiguous bytes of each row from
// device memory, one 128-byte core matrix column into shared memory.
__device__ __forceinline__ void land_plane(float* dst, const float* src,
                                           long long ld, int rows, int p) {
#pragma unroll 1
  for (int e = p; e < rows * 16; e += kProducerThreads) {
    const int u = e >> 5, lane = e & 31;
    const int r = (u >> 2) * 8 + (lane & 7), c4 = (u & 3) * 4 + (lane >> 3);
    cp_async16(dst + kmajor_at(r, 4 * c4, 64), src + r * ld + 4 * c4);
  }
}

// Producer thread p: a P x N tile (rows of 64 floats, 64 apart) by rows at
// dst + r * kRowLd.
__device__ __forceinline__ void land_rows(float* dst, const float* src,
                                          int p) {
#pragma unroll 1
  for (int e = p; e < kWP * 16; e += kProducerThreads) {
    const int r = e >> 4, c = 4 * (e & 15);
    cp_async16(dst + r * kRowLd + c, src + r * kWN + c);
  }
}

// Producer thread p: the transpose of rows [0, rows) of 64 floats (row r
// at src + r * ld) into a K-major (64 x 128) plane, 4 bytes a copy: a warp
// reads 128 contiguous bytes of a row.
__device__ __forceinline__ void land_plane_t(float* dst, const float* src,
                                             long long ld, int rows, int p) {
#pragma unroll 1
  for (int e = p; e < rows * 64; e += kProducerThreads) {
    const int r = e >> 6, c = e & 63;
    cp_async4(dst + kmajor_at(c, r, kWL), src + r * ld + c);
  }
}

// The low TF32 halves of a K-major (R x K) plane into lo, and zeros into
// both where a row is >= rv or a column >= cv (what the producer did not
// land).
__device__ __forceinline__ void make_lo(float* hi, float* lo, int R, int K,
                                        int rv, int cv) {
  for (int i = 4 * threadIdx.x; i < R * K; i += 4 * kWideThreads) {
    const int band = i / (8 * K), rem = i - band * 8 * K;
    const int r = 8 * band + ((rem & 31) >> 2), c = 4 * (rem >> 5);
    float4 x = *reinterpret_cast<const float4*>(hi + i);
    float v[4] = {x.x, x.y, x.z, x.w};
    uint32_t h, l[4];
    bool zero = false;
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      if (r >= rv || c + m >= cv) {
        v[m] = 0.f;
        zero = true;
      }
      split_tf32(v[m], h, l[m]);
    }
    if (zero) {
      *reinterpret_cast<float4*>(hi + i) = make_float4(v[0], v[1], v[2], v[3]);
    }
    *reinterpret_cast<float4*>(lo + i) =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// The transpose of a landed P x N tile (rows kRowLd apart) into K-major
// (N x P) planes hi and lo.  A thread moves 4 rows of one column into 16
// bytes of a plane row; 8 lanes take 8 neighbouring columns, so that each 8
// write one core matrix (128 contiguous bytes).
__device__ __forceinline__ void split_cols(float* hi, float* lo,
                                           const float* stg) {
  for (int e = threadIdx.x; e < 16 * kWP; e += kWideThreads) {
    const int lane = e & 31, u = e >> 5;
    const int c = 8 * (u & 7) + (lane & 7);
    const int r0 = 4 * (4 * (u >> 3) + (lane >> 3));
    float x[4];
    uint32_t h, l[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      x[i] = stg[(r0 + i) * kRowLd + c];
      split_tf32(x[i], h, l[i]);
    }
    const int o = kmajor_at(c, r0, kWP);
    *reinterpret_cast<float4*>(hi + o) = make_float4(x[0], x[1], x[2], x[3]);
    *reinterpret_cast<float4*>(lo + o) =
        make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]),
                    __uint_as_float(l[2]), __uint_as_float(l[3]));
  }
}

// acc (64 x 64) = A B^T over K = 64 in 3xTF32 (lo*hi, hi*lo, hi*hi a
// k-step), A rows [ra, ra + 64) of the K-major planes (a_hi, a_lo), B rows
// [rb, rb + 64) of (b_hi, b_lo), issued as one group.  The caller waits.
__device__ __forceinline__ void product_ss(float (&acc)[32], const float* a_hi,
                                           const float* a_lo, int ra,
                                           const float* b_hi,
                                           const float* b_lo, int rb) {
  const uint32_t ah = smem_u32(a_hi + kmajor_at(ra, 0, 64));
  const uint32_t al = smem_u32(a_lo + kmajor_at(ra, 0, 64));
  const uint32_t bh = smem_u32(b_hi + kmajor_at(rb, 0, 64));
  const uint32_t bl = smem_u32(b_lo + kmajor_at(rb, 0, 64));
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    wgmma_tf32(acc, kmajor_desc(al, 64, s), kmajor_desc(bh, 64, s));
    wgmma_tf32(acc, kmajor_desc(ah, 64, s), kmajor_desc(bl, 64, s));
    wgmma_tf32(acc, kmajor_desc(ah, 64, s), kmajor_desc(bh, 64, s));
  }
  wgmma_commit();
}

// exp(x) by the SFU, 0 for x = -inf or far below.
__device__ __forceinline__ float exp_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x * 1.4426950408889634f));
  return y;
}

// The stage s of head i (i = hh - h0): its barriers' phases.
__device__ __forceinline__ uint32_t stage_parity(int i) { return (i >> 1) & 1; }

// Kind 0, dX = W^T dY + diag(dk) B G^T.  Warpgroup wg owns dX rows [64 wg,
// 64 wg + 64) (M) and all 64 columns of P (N).  First diag(dk) B G^T over
// n (A: the warpgroup's B rows, held in registers for the block, times dk;
// B operand: G, K = n), then W^T dY over q >= 64 wg (A: W^T formed in
// registers from C B^T and the decays; B operand: dY^T, landed transposed,
// K = q): 4 k-steps a group, two sets of A registers, so that one group
// runs while the next one's A is formed.  wg 0 runs 24 k-steps, wg 1 16.
__device__ __forceinline__ void wide_dx(const WideArgs& w, float* sm,
                                        uint64_t* bars, const WideBlock& k) {
  const int tid = threadIdx.x, wg = warpgroup(), w4 = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long xld = (long long)w.H * kWP;
  float* ytl = sm + 2 * kDxStage;            // dY^T's low plane [P][L]
  float* gpl = ytl + kPlane;                 // G's low plane    [P][N]
  float* cb = gpl + kPlanePN;                // C B^T            [L][kCbLd]
  float* ac = cb + kWL * kCbLd;              // acum             [L]
  float* dk = ac + kWL;                      // exp(acum_L - acum) [L]
  const int lv = k.lv;
  // The chunk's C B^T: rows below lv, the 16-column units the local launch
  // wrote (those at and below the diagonal).
  const float* cbc = w.cbg + ((long long)k.b * k.nc + k.c) * kWL * kWL;
  for (int e = tid; e < kWL * kWL / 4; e += kWideThreads) {
    const int q = e >> 5, k4 = (e & 31) * 4;
    if (q < lv && k4 < (q / 16 + 1) * 16) {
      cp_async16(cb + q * kCbLd + k4, cbc + q * kWL + k4);
    }
  }
  cp_async_commit();
  const int r0 = 64 * wg + 16 * w4;          // this warp's rows of dX
  const int ka = r0 + g, kb = ka + 8;
  float breg[8][4];
#pragma unroll
  for (int s = 0; s < 8; ++s) {
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int r = (m & 1) ? kb : ka, n = 8 * s + t + 4 * (m >> 1);
      breg[s][m] = r < lv ? w.bm[(k.row0 + r) * kWN + n] : 0.f;
    }
  }
  cp_async_wait<0>();
  const int kv8 = (lv + 7) / 8;
  const int nw = kv8 > 8 * wg ? (kv8 - 8 * wg + 3) / 4 : 0;
  for (int hh = k.h0; hh < k.h1; ++hh) {
    const int i = hh - k.h0, s = i & 1;
    float* yth = sm + s * kDxStage;          // dY^T [P][L], then G [P][N]
    float* gph = yth + kPlane;
    const float* sa = gph + kPlanePN;
    mbar_wait(smem_u32(bars + s), stage_parity(i));
    make_lo(yth, ytl, kWP, kWL, kWP, lv);
    make_lo(gph, gpl, kWP, kWN, kWP, kWN);
    if (tid < kWL) {
      const float a = sa[tid];
      ac[tid] = a;
      dk[tid] = tid < lv ? expf(sa[lv - 1] - a) : 0.f;
    }
    fence_async_shared();
    consumer_sync();
    const uint32_t gh = smem_u32(gph), gl = smem_u32(gpl);
    const uint32_t yh = smem_u32(yth), yl = smem_u32(ytl);
    const float dka = dk[ka], dkb = dk[kb], aca = ac[ka], acb = ac[kb];
    float acc[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) acc[j] = 0.f;
    // A group: 4 k-steps from s0 of diag(dk) B G^T (K = n) or, wt, of W^T
    // dY (K = q, steps past lv skipped).
    auto issue = [&](const uint32_t (&h)[4][4], const uint32_t (&l)[4][4],
                     int s0, bool wt) {
      wgmma_fence();
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int st = s0 + j;
        if (!wt || st < kv8) {
          const uint64_t bh = wt ? kmajor_desc(yh, kWL, st)
                                 : kmajor_desc(gh, kWN, st);
          const uint64_t bl = wt ? kmajor_desc(yl, kWL, st)
                                 : kmajor_desc(gl, kWN, st);
          wgmma_tf32(acc, l[j], bh);
          wgmma_tf32(acc, h[j], bl);
          wgmma_tf32(acc, h[j], bh);
        }
      }
      wgmma_commit();
    };
    auto fill_b = [&](int half, uint32_t (&h)[4][4], uint32_t (&l)[4][4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          split_tf32(breg[4 * half + j][m] * ((m & 1) ? dkb : dka), h[j][m],
                     l[j][m]);
        }
      }
    };
    // W^T[k][q] = C B^T[q][k] exp(acum_q - acum_k) on k <= q < lv, the
    // exponent masked to -inf elsewhere (no branch).
    auto fill_w = [&](int s0, uint32_t (&h)[4][4], uint32_t (&l)[4][4]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int kr = (m & 1) ? kb : ka;
          const int q = 8 * (s0 + j) + t + 4 * (m >> 1);
          const bool on = q >= kr && q < lv;
          const float cv = on ? cb[q * kCbLd + kr] : 0.f;
          const float rel = on ? ac[q] - ((m & 1) ? acb : aca) : -INFINITY;
          split_tf32(cv * exp_fast(rel), h[j][m], l[j][m]);
        }
      }
    };
    uint32_t h0[4][4], l0[4][4], h1[4][4], l1[4][4];
    fill_b(0, h0, l0);
    issue(h0, l0, 0, false);
    fill_b(1, h1, l1);
    issue(h1, l1, 4, false);
    for (int wi = 0; wi < nw; wi += 2) {
      wgmma_wait_one();                          // the group before last done
      fill_w(8 * wg + 4 * wi, h0, l0);
      issue(h0, l0, 8 * wg + 4 * wi, true);
      if (wi + 1 < nw) {
        wgmma_wait_one();
        fill_w(8 * wg + 4 * wi + 4, h1, l1);
        issue(h1, l1, 8 * wg + 4 * wi + 4, true);
      }
    }
    wgmma_wait_all();
    fence_regs(acc);
    consumer_sync();                             // stage s and low planes free
    if (tid == 0) mbar_arrive(smem_u32(bars + 2 + s));
    float* ob = w.dxh + k.row0 * xld + hh * kWP;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = r ? kb : ka;
        if (row < lv) {
          *reinterpret_cast<float2*>(ob + row * xld + 8 * j + 2 * t) =
              make_float2(acc[4 * j + 2 * r], acc[4 * j + 2 * r + 1]);
        }
      }
    }
  }
}

// This thread's entries of a 64 x 64 block at rows [q0, q0 + 64), columns
// [k0, k0 + 64) (accumulator order) of the matrix src (row stride ld):
// kTri keeps those on and below the diagonal, rows >= lv are zeros.  The
// same for every head of the block.
template <int kOff, bool kTri>
__device__ __forceinline__ void block_regs(float (&v)[64], const float* src,
                                           int ld, int q0, int k0, int lv) {
  const int tid = threadIdx.x, w4 = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int q = q0 + 16 * w4 + g + 8 * r, kk = k0 + 8 * j + 2 * t + x;
        v[kOff + 4 * j + 2 * r + x] =
            q < lv && (!kTri || kk <= q) ? __ldg(src + q * ld + kk) : 0.f;
      }
    }
  }
}

// The epilogue of one 64 x 64 block of dW = dY X^T at rows [q0, q0 + 64),
// columns [k0, k0 + 64): per element (q, k), E += dW D and the row and
// column sums of dW o W, W = C B^T o D (C B^T from block_regs), D =
// exp(acum_q - acum_k) on k <= q < lv (the exponent masked to -inf
// elsewhere).  Row sums into rs, column sums by warp into cs.
template <int kOff>
__device__ __forceinline__ void dw_epilogue(const float (&acc)[32],
                                            float (&esum)[64],
                                            const float (&cbr)[64],
                                            const float* ac, int q0, int k0,
                                            int lv, float* rs, float* cs) {
  const int tid = threadIdx.x, w4 = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int qa = q0 + 16 * w4 + g, qb = qa + 8;
  const float aqa = ac[qa], aqb = ac[qb];
  float rp[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      const int kk = k0 + 8 * j + 2 * t + x, i0 = 4 * j + x;
      const float ak = ac[kk];
      float cpv = 0.f;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int q = r ? qb : qa, i = i0 + 2 * r;
        const float rel =
            q < lv && kk <= q ? (r ? aqb : aqa) - ak : -INFINITY;
        const float v = acc[i] * exp_fast(rel);
        esum[kOff + i] += v;
        const float ww = v * cbr[kOff + i];
        rp[r] += ww;
        cpv += ww;
      }
      cpv += __shfl_xor_sync(0xffffffffu, cpv, 4);
      cpv += __shfl_xor_sync(0xffffffffu, cpv, 8);
      cpv += __shfl_xor_sync(0xffffffffu, cpv, 16);
      if (g == 0) cs[w4 * kWL + kk] = cpv;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rp[r] += __shfl_xor_sync(0xffffffffu, rp[r], 1);
    rp[r] += __shfl_xor_sync(0xffffffffu, rp[r], 2);
  }
  if (t == 0) {
    rs[qa] = rp[0];
    rs[qb] = rp[1];
  }
}

// Kind 1, dW = dY X^T on the triangle, E = sum_h dW o D and the intra part
// of dacum (rowsum - colsum of dW o W, slot 0).  Both operands in shared
// memory (K = p, 8 k-steps a block): warpgroup 0 takes the two diagonal
// 64 x 64 blocks, warpgroup 1 the one below them, so that both hold 4096
// elements of the triangle.  After the heads, E^T C and E B into partial
// slots 0 and 1 (mma.sync, once a block).
__device__ __forceinline__ void wide_dw(const WideArgs& w, float* sm,
                                        uint64_t* bars, const WideBlock& k) {
  const int tid = threadIdx.x, wg = warpgroup();
  float* xpl = sm + 2 * kDwStage;            // X's low plane  [L][P]
  float* ypl = xpl + kPlane;                 // dY's low plane [L][P]
  float* ac = ypl + kPlane;                  // acum           [L]
  float* rs = ac + kWL;                      // row sums       [2][L]
  float* cs = rs + 2 * kWL;                  // column sums    [8][L]
  const int lv = k.lv;
  const float* cbc = w.cbg + ((long long)k.b * k.nc + k.c) * kWL * kWL;
  for (int i = tid; i < 10 * kWL; i += kWideThreads) rs[i] = 0.f;
  float esum[64], cbr[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) esum[i] = 0.f;
  if (wg == 0) {
    block_regs<0, true>(cbr, cbc, kWL, 0, 0, lv);
    block_regs<32, true>(cbr, cbc, kWL, 64, 64, lv);
  } else {
    block_regs<0, true>(cbr, cbc, kWL, 64, 0, lv);
  }
  for (int hh = k.h0; hh < k.h1; ++hh) {
    const int i = hh - k.h0, s = i & 1;
    float* xph = sm + s * kDwStage;          // X [L][P], dY [L][P], acum
    float* yph = xph + kPlane;
    const float* sa = yph + kPlane;
    mbar_wait(smem_u32(bars + s), stage_parity(i));
    make_lo(xph, xpl, kWL, kWP, lv, kWP);
    make_lo(yph, ypl, kWL, kWP, lv, kWP);
    if (tid < kWL) ac[tid] = sa[tid];
    fence_async_shared();
    consumer_sync();
    float* csw = cs + wg * 4 * kWL;
    if (wg == 0) {
      float acc0[32], acc1[32];
      product_ss(acc0, yph, ypl, 0, xph, xpl, 0);
      product_ss(acc1, yph, ypl, 64, xph, xpl, 64);
      wgmma_wait_all();
      fence_regs(acc0);
      fence_regs(acc1);
      dw_epilogue<0>(acc0, esum, cbr, ac, 0, 0, lv, rs, csw);
      dw_epilogue<32>(acc1, esum, cbr, ac, 64, 64, lv, rs, csw);
    } else {
      float acc[32];
      product_ss(acc, yph, ypl, 64, xph, xpl, 0);
      wgmma_wait_all();
      fence_regs(acc);
      dw_epilogue<0>(acc, esum, cbr, ac, 64, 0, lv, rs + kWL, csw);
    }
    consumer_sync();                             // stage s, planes, sums
    if (tid == 0) mbar_arrive(smem_u32(bars + 2 + s));
    if (tid < kWL) {
      float v = rs[tid] + rs[kWL + tid];
      for (int j = 0; j < 8; ++j) v -= cs[j * kWL + tid];
      w.dag[(k.blk(w, hh) * kDacumSlots) * kWL + tid] = tid < lv ? v : 0.f;
    }
    consumer_sync();                             // sums read
  }
  // E into shared memory over the front (every entry on and below the
  // diagonal that the products read), then C and B.
  const Dims d = dims(kWL, kWP, kWN);
  const int sw = stride_t(d.lp), sc = stride_t(d.np), sb = stride_g(d.np);
  float* ws = sm;
  float* xs = ws + d.lp * sw;
  float* bs = xs + d.lp * sc;
  {
    const int w4 = (tid >> 5) & 3, lane = tid & 31, g = lane >> 2,
              t = lane & 3;
#pragma unroll
    for (int blk = 0; blk < 2; ++blk) {
      if (blk == 0 || wg == 0) {
        const int q0 = wg == 0 ? 64 * blk : 64, k0 = wg == 0 ? 64 * blk : 0;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            *reinterpret_cast<float2*>(
                ws + (q0 + 16 * w4 + g + 8 * r) * sw + k0 + 8 * j + 2 * t) =
                make_float2(esum[32 * blk + 4 * j + 2 * r],
                            esum[32 * blk + 4 * j + 2 * r + 1]);
          }
        }
      }
    }
  }
  for (int e = tid; e < kWL * 16; e += kWideThreads) {
    const int r = e >> 4, c = 4 * (e & 15);
    if (r < lv) {
      cp_async16(xs + r * sc + c, w.cm + (k.row0 + r) * kWN + c);
      cp_async16(bs + r * sb + c, w.bm + (k.row0 + r) * kWN + c);
    } else {
      *reinterpret_cast<float4*>(xs + r * sc + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
      *reinterpret_cast<float4*>(bs + r * sb + c) =
          make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  cp_async_commit();
  cp_async_wait<0>();
  consumer_sync();
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int mt = d.lp / 16, ngn = d.np / 16, kv = round_up(lv, 8);
  float* out = w.part + (((long long)k.b * k.nc + k.c) * w.G + k.grp)
                            * kPartSlots * d.lp * d.np;
  for (int v = warp; v < 2 * mt * ngn; v += kWideThreads / 32) {
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
               [&](int kk, float (&f)[4]) {
                 const float* r0 = ws + (m0 + g) * sw + kk + t;
                 f[0] = r0[0]; f[1] = r0[8 * sw]; f[2] = r0[4];
                 f[3] = r0[8 * sw + 4];
               },
               [&](int kk, int j, float (&f)[2]) {
                 const float* r = bs + (kk + t) * sb + n0 + 8 * j + g;
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

// Kinds 2 (kXG false: dY h) and 3 (kXG true: X G), the terms through the
// states: T = Y A over K = p, Y = dY, A = h (kind 2) or Y = X, A = G (kind
// 3), both operands in shared memory (A^T's planes written transposed from
// the landed rows), warpgroup wg rows [64 wg, 64 wg + 64) of the chunk.
// Row q is scaled by exp(acum_q) (kind 2) or dk_q (kind 3); the scaled T
// summed over the heads goes to partial slot 3 (dC) or 2 (dB), its row
// dots with C (B; this thread's entries held in registers) to dacum slot
// 1 (slot 2, negated, with <G, h_out> = exp(acum_L) <G, h> + the sum of
// the dots at the chunk's last row: h_out = exp(acum_L) h + X^T diag(dk)
// B).
template <bool kXG>
__device__ __forceinline__ void wide_state(const WideArgs& w, float* sm,
                                           uint64_t* bars, const WideBlock& k) {
  const int tid = threadIdx.x, wg = warpgroup(), w4 = (tid >> 5) & 3;
  const int warp = tid >> 5, lane = tid & 31, g = lane >> 2, t = lane & 3;
  constexpr int kStage = kXG ? kS5Stage : kS4Stage;
  float* ypl = sm + 2 * kStage;              // Y's low plane  [L][P]
  float* aph = ypl + kPlane;                 // A^T's planes   [N][P]
  float* apl = aph + kPlanePN;
  float* scl = apl + kPlanePN;               // the row scale  [L]
  float* rd = scl + kWL;                     // the row dots   [L]
  float* ac = rd + kWL;                      // acum           [L]
  float* red = ac + kWL;                     // warp sums, then totals
  const int lv = k.lv;
  float dot[64];
  block_regs<0, false>(dot, (kXG ? w.bm : w.cm) + k.row0 * kWN, kWN,
                       64 * wg, 0, lv);
  float ssum[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) ssum[i] = 0.f;
  const int qa = 64 * wg + 16 * w4 + g, qb = qa + 8;
  for (int hh = k.h0; hh < k.h1; ++hh) {
    const int i = hh - k.h0, s = i & 1;
    float* yph = sm + s * kStage;            // Y [L][P], A by rows, (h), acum
    const float* sr = yph + kPlane;
    const float* sa = yph + kStage - kWL;
    mbar_wait(smem_u32(bars + s), stage_parity(i));
    make_lo(yph, ypl, kWL, kWP, lv, kWP);
    split_cols(aph, apl, sr);
    if (kXG) {
      const float* sh = sr + kStgPN;
      float gh = 0.f;
      for (int e = tid; e < kPlanePN; e += kWideThreads) {
        const int o = (e >> 6) * kRowLd + (e & 63);
        gh += sr[o] * sh[o];
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        gh += __shfl_xor_sync(0xffffffffu, gh, off);
      }
      if (lane == 0) red[warp] = gh;
    }
    if (tid < kWL) {
      const float a = sa[tid];
      ac[tid] = a;
      scl[tid] = tid >= lv ? 0.f : kXG ? expf(sa[lv - 1] - a) : expf(a);
    }
    fence_async_shared();
    consumer_sync();
    float acc[32];
    product_ss(acc, yph, ypl, 64 * wg, aph, apl, 0);
    wgmma_wait_all();
    fence_regs(acc);
    float rp[2] = {0.f, 0.f};
    const float sa_ = scl[qa], sb_ = scl[qb];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float sq = r ? sb_ : sa_;
        const float v0 = acc[4 * j + 2 * r] * sq;
        const float v1 = acc[4 * j + 2 * r + 1] * sq;
        ssum[4 * j + 2 * r] += v0;
        ssum[4 * j + 2 * r + 1] += v1;
        rp[r] += v0 * dot[4 * j + 2 * r] + v1 * dot[4 * j + 2 * r + 1];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      rp[r] += __shfl_xor_sync(0xffffffffu, rp[r], 1);
      rp[r] += __shfl_xor_sync(0xffffffffu, rp[r], 2);
    }
    if (t == 0) {
      rd[qa] = rp[0];
      rd[qb] = rp[1];
    }
    consumer_sync();                             // stage s, planes free
    if (tid == 0) mbar_arrive(smem_u32(bars + 2 + s));
    if (kXG && warp == 0) {
      // The sum of the dots and <G, h>, in a fixed order.
      float v = rd[lane] + rd[lane + 32] + rd[lane + 64] + rd[lane + 96];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        v += __shfl_xor_sync(0xffffffffu, v, off);
      }
      if (lane == 0) {
        float ghs = 0.f;
        for (int j = 0; j < 8; ++j) ghs += red[j];
        red[8] = k.c + 1 < k.nc ? expf(ac[lv - 1]) * ghs + v : 0.f;
      }
    }
    if (kXG) consumer_sync();
    if (tid < kWL) {
      float v = 0.f;
      if (tid < lv) {
        v = kXG ? -rd[tid] : rd[tid];
        if (kXG && tid == lv - 1) v += red[8];
      }
      w.dag[(k.blk(w, hh) * kDacumSlots + (kXG ? 2 : 1)) * kWL + tid] = v;
    }
    consumer_sync();                             // dots and totals read
  }
  // The state term summed over the heads: slot 2 (dB) or 3 (dC).
  float* out = w.part + ((((long long)k.b * k.nc + k.c) * w.G + k.grp)
                             * kPartSlots + (kXG ? 2 : 3)) * kWL * kWN;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      *reinterpret_cast<float2*>(out + (r ? qb : qa) * kWN + 8 * j + 2 * t) =
          make_float2(ssum[4 * j + 2 * r], ssum[4 * j + 2 * r + 1]);
    }
  }
}

// The wide path's first launch, grid (G, nc, B), two warpgroups: block
// (grp, c, b) takes heads [grp hpb, (grp + 1) hpb) of chunk c, warpgroup w
// every other one (h0 + w, h0 + w + 2, ...) on its own: the chunk's own
// term of G, g = dY^T diag(exp(acum)) C, an m64n64 product over the
// chunk's 128 rows (A = (dY o exp(acum))^T formed in registers from the
// landed dY; B = C^T, transposed and split into TF32 halves once a block),
// while the warpgroup's next head lands by cp.async (two stages a
// warpgroup).  Then, as ssd_bwd_local_kernel, the chunk's C B^T rows
// shared out among the blocks of the chunk.
constexpr int kLocLd = kWP + 8;           // dY rows (conflict-free A^T reads)
constexpr int kLocStage = kWL * kLocLd + 2 * kWL;   // dY, acum, exp(acum)
constexpr int kLocFloats = 2 * kPlane + 4 * kLocStage;

__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(1 + wg) : "memory");
}

__global__ void __launch_bounds__(kWideThreads, 1)
ssd_bwd_local_wide_kernel(const float* __restrict__ dy,
                          const float* __restrict__ bm,
                          const float* __restrict__ cm,
                          const float* __restrict__ acum_g,
                          float* __restrict__ gs, float* __restrict__ cbg,
                          int S, int H, int hpb) {
  extern __shared__ __align__(16) float smem[];
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y, lv = min(kWL, S - c * kWL);
  const long long row0 = (long long)b * S + (long long)c * kWL;
  const int h0 = grp * hpb, h1 = min(H, h0 + hpb);
  const int tid = threadIdx.x, wg = warpgroup(), w4 = (tid >> 5) & 3;
  const int wt = tid & 127, lane = tid & 31, g = lane >> 2, t = lane & 3;
  const long long xld = (long long)H * kWP;
  float* cth = smem;                         // C^T's planes [N][L]
  float* ctl = cth + kPlane;
  float* stages = ctl + kPlane;              // 4 x {dY [L][kLocLd], acum, ew}
  auto land = [&](int hh, int st) {          // this warpgroup's threads
    float* s = stages + st * kLocStage;
    const float* src = dy + row0 * xld + hh * kWP;
    for (int e = wt; e < kWL * 16; e += 128) {
      const int r = e >> 4, c4 = 4 * (e & 15);
      float* d = s + r * kLocLd + c4;
      if (r < lv) {
        cp_async16(d, src + r * xld + c4);
      } else {
        *reinterpret_cast<float4*>(d) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
    }
    if (wt < kWL / 4) {
      cp_async16(s + kWL * kLocLd + 4 * wt,
                 acum_g + (((long long)b * nc + c) * H + hh) * kWL + 4 * wt);
    }
  };
  if (h0 + wg < h1) land(h0 + wg, 2 * wg);
  cp_async_commit();
  for (int e = tid; e < kWL * kWN; e += kWideThreads) {
    const int k = e >> 6, n = e & 63;
    const float v = k < lv ? __ldg(cm + (row0 + k) * kWN + n) : 0.f;
    uint32_t hi, lo;
    split_tf32(v, hi, lo);
    const int o = kmajor_at(n, k, kWL);
    cth[o] = v;
    ctl[o] = __uint_as_float(lo);
  }
  fence_async_shared();
  __syncthreads();                           // C^T's planes written
  const uint32_t ch = smem_u32(cth), cl = smem_u32(ctl);
  const int pa = 16 * w4 + g, pb = pa + 8;
  for (int hh = h0 + wg, j = 0; hh < h1; hh += 2, ++j) {
    const int st = 2 * wg + (j & 1);
    if (hh + 2 < h1) land(hh + 2, 2 * wg + ((j + 1) & 1));
    cp_async_commit();
    cp_async_wait<1>();
    warpgroup_sync(wg);
    float* s = stages + st * kLocStage;
    float* ew = s + kWL * kLocLd + kWL;
    if (wt < kWL) ew[wt] = wt < lv ? expf(s[kWL * kLocLd + wt]) : 0.f;
    warpgroup_sync(wg);
    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    uint32_t h0r[4][4], l0r[4][4], h1r[4][4], l1r[4][4];
    // Group gi: k-steps 4 gi .. 4 gi + 3, A[p][k] = dY[k][p] exp(acum_k).
    auto group = [&](int gi, uint32_t (&hr)[4][4], uint32_t (&lr)[4][4]) {
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int p = (m & 1) ? pb : pa;
          const int k = 8 * (4 * gi + jj) + t + 4 * (m >> 1);
          split_tf32(s[k * kLocLd + p] * ew[k], hr[jj][m], lr[jj][m]);
        }
      }
      wgmma_fence();
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int ks = 4 * gi + jj;
        wgmma_tf32(acc, lr[jj], kmajor_desc(ch, kWL, ks));
        wgmma_tf32(acc, hr[jj], kmajor_desc(cl, kWL, ks));
        wgmma_tf32(acc, hr[jj], kmajor_desc(ch, kWL, ks));
      }
      wgmma_commit();
    };
    group(0, h0r, l0r);
    group(1, h1r, l1r);
    wgmma_wait_one();                                // group 0 done
    group(2, h0r, l0r);
    wgmma_wait_one();                                // group 1 done
    group(3, h1r, l1r);
    wgmma_wait_all();
    fence_regs(acc);
    float* out = gs + (((long long)b * nc + c) * H + hh) * kPlanePN;
#pragma unroll
    for (int j8 = 0; j8 < 8; ++j8) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        *reinterpret_cast<float2*>(out + (r ? pb : pa) * kWN + 8 * j8
                                   + 2 * t) =
            make_float2(acc[4 * j8 + 2 * r], acc[4 * j8 + 2 * r + 1]);
      }
    }
    warpgroup_sync(wg);                          // stage st free
  }
  // C B^T: B into the stages, 16 rows of C at a time after it.
  cp_async_wait<0>();
  __syncthreads();
  const Dims d = dims(kWL, kWP, kWN);
  const int sb = stride_g(d.np);
  stage_tile(stages, sb, bm + row0 * kWN, kWN, lv, kWN, d.lp, d.np, true);
  cp_async_commit();
  cp_async_wait<0>();
  cb_rows(stages + d.lp * sb, stages, sb, cm + row0 * kWN,
          cbg + ((long long)b * nc + c) * d.lp * d.lp, d, kWN, lv, grp,
          gridDim.x);
}

// The producer warpgroup: head i into stage i % 2 once the consumers have
// freed it (bars[2 + s]) by cp.async, 16 bytes a thread (dX's dY^T 4 bytes,
// transposed), completing on bars[s] (an arrival per thread when its
// copies have landed).  Rows past lv are not landed: the consumers zero
// them.
__device__ __forceinline__ void wide_produce(const WideArgs& w, float* sm,
                                             uint64_t* bars,
                                             const WideBlock& k, int kind) {
  const int p = threadIdx.x - kWideThreads;
  const long long xld = (long long)w.H * kWP;
  for (int hh = k.h0; hh < k.h1; ++hh) {
    const int i = hh - k.h0, s = i & 1;
    if (i >= 2) mbar_wait(smem_u32(bars + 2 + s), stage_parity(i - 2));
    const long long blk = k.blk(w, hh);
    const float* x = w.xh + k.row0 * xld + hh * kWP;
    const float* y = w.dy + k.row0 * xld + hh * kWP;
    const float* gt = w.gs + blk * kPlanePN;
    const float* ht = w.st + blk * kPlanePN;
    float* acs;
    if (kind == 0) {                             // dY^T, G, acum
      float* st = sm + s * kDxStage;
      land_plane_t(st, y, xld, k.lv, p);
      land_plane(st + kPlane, gt, kWN, kWP, p);
      acs = st + kPlane + kPlanePN;
    } else if (kind == 1) {                      // X, dY, acum
      float* st = sm + s * kDwStage;
      land_plane(st, x, xld, k.lv, p);
      land_plane(st + kPlane, y, xld, k.lv, p);
      acs = st + 2 * kPlane;
    } else {                                     // dY, h or X, G, h; acum
      const int stage = kind == 3 ? kS5Stage : kS4Stage;
      float* st = sm + s * stage;
      land_plane(st, kind == 3 ? x : y, xld, k.lv, p);
      land_rows(st + kPlane, kind == 3 ? gt : ht, p);
      if (kind == 3) land_rows(st + kPlane + kStgPN, ht, p);
      acs = st + stage - kWL;
    }
    if (p < kWL / 4) cp_async16(acs + 4 * p, w.acum + blk * kWL + 4 * p);
    cp_async_mbar_arrive(smem_u32(bars + s));
  }
}

// The wide path's middle launch, grid (2 G + 2 Gs, nc, B), three
// warpgroups: two consumers and a producer.  Block (2 grp + kind, c, b) is
// run grp of chunk c (hpb heads), kind 0 dX, 1 dW and E; block (2 G + 2
// grp + kind - 2, c, b) is run grp of 2 hpb heads (Gs runs), kind 2 dY h,
// 3 X G: about a dX or dW block's time, so that the blocks an SM takes in
// turn cost alike.  A chunk's blocks are neighbours in the grid, so they
// run together and share X and dY through L2.
__global__ void __launch_bounds__(kWideThreads + kProducerThreads, 1)
ssd_bwd_wide_kernel(WideArgs w) {
  extern __shared__ __align__(16) float smem[];
  uint64_t* bars = reinterpret_cast<uint64_t*>(smem);
  if (threadIdx.x == 0) {
    const uint32_t bar = smem_u32(bars);
    mbar_init(bar, kProducerThreads);            // stage 0 landed
    mbar_init(bar + 8, kProducerThreads);        // stage 1 landed
    mbar_init(bar + 16, 1);                      // stage 0 free
    mbar_init(bar + 24, 1);                      // stage 1 free
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const int x = blockIdx.x, xs = x - 2 * w.G;
  const int kind = xs < 0 ? x & 1 : 2 + (xs & 1);
  const WideBlock k(w, xs < 0 ? x >> 1 : xs >> 1,
                    xs < 0 ? w.hpb : 2 * w.hpb);
  float* sm = smem + kBars;
  if (warpgroup() == 2) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    wide_produce(w, sm, bars, k, kind);
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
  if (kind == 0) {
    wide_dx(w, sm, bars, k);
  } else if (kind == 1) {
    wide_dw(w, sm, bars, k);
  } else if (kind == 2) {
    wide_state<false>(w, sm, bars, k);
  } else {
    wide_state<true>(w, sm, bars, k);
  }
}

// The last launch.  Blocks [0, n_da): a warp per (b, c, h), da the reverse
// cumulative sum over the chunk of the `slots` parts of dacum (lane l holds
// rows 4 l .. 4 l + 3).  The rest: a thread per (b, s, n), db and dc, the
// partials of s's chunk summed over the runs of heads in order: slots 0
// and 1 of each of the G runs, and 2 and 3 of the first Gs (the state
// terms, where blocks of their own wrote them).
__global__ void __launch_bounds__(kThreads)
ssd_bwd_finish_kernel(const float* __restrict__ dag,
                      const float* __restrict__ part, float* __restrict__ da,
                      float* __restrict__ db, float* __restrict__ dc, int B,
                      int S, int H, int N, int L, int lp, int np, int nc,
                      int G, int Gs, int slots, int n_da) {
  if (static_cast<int>(blockIdx.x) < n_da) {
    const long long item = (long long)blockIdx.x * (kThreads / 32)
                           + (threadIdx.x >> 5);
    if (item >= (long long)B * nc * H) return;
    const int lane = threadIdx.x & 31;
    const int h = static_cast<int>(item % H);
    const long long bc = item / H;
    const int c = static_cast<int>(bc % nc), b = static_cast<int>(bc / nc);
    const int lv = min(L, S - c * L);
    const float* src = dag + item * kDacumSlots * lp;
    float v[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q = 4 * lane + i;
      v[i] = 0.f;
      if (q < lv) {
        for (int s = 0; s < slots; ++s) v[i] += src[s * lp + q];
      }
    }
    const float tot = v[0] + v[1] + v[2] + v[3];
    float after = tot;                           // sum over lanes >= lane
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_down_sync(0xffffffffu, after, off);
      if (lane + off < 32) after += up;
    }
    float run = after - tot;
    float* out = da + ((long long)b * S + c * L) * H + h;
#pragma unroll
    for (int i = 3; i >= 0; --i) {
      run += v[i];
      const int q = 4 * lane + i;
      if (q < lv) out[(long long)q * H] = run;
    }
    return;
  }
  const long long e = (long long)(blockIdx.x - n_da) * kThreads + threadIdx.x;
  if (e >= (long long)B * S * N) return;
  const int n = static_cast<int>(e % N);
  const long long bs = e / N;
  const int s = static_cast<int>(bs % S), b = static_cast<int>(bs / S);
  const int c = s / L, q = s - c * L;
  const long long slot = (long long)lp * np;
  const float* p = part + (((long long)b * nc + c) * G) * kPartSlots * slot
                   + q * np + n;
  float vb = 0.f, vc = 0.f;
  for (int grp = 0; grp < G; ++grp) {
    vb += p[0];
    vc += p[slot];
    if (grp < Gs) {
      vb += p[2 * slot];
      vc += p[3 * slot];
    }
    p += kPartSlots * slot;
  }
  db[e] = vb;
  dc[e] = vc;
}

// Whether the wide launch takes the shape.
bool wide_path(int L, int P, int N) {
  return L == kWL && P == kWP && N == kWN;
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
  int m = max(local_smem_floats(d), intra_smem_floats(d));
  m = max(m, state_smem_floats(d));
  if (wide_path(L, P, N)) m = max(m, max(kWideFloats, kLocFloats));
  return m * static_cast<int>(sizeof(float));
}

// Runs of heads the middle launch splits each chunk into: the leading
// dimension G of the partials' scratch.
extern "C" int repro_ssd_scan_bwd_groups(int H, int nc, int B) {
  return backward_groups(H, nc, B, sm_count());
}

// The four launches.  Inputs xh, dy (B, S, H, P), b, c (B, S, N), the
// forward's entering states st (B, nc, H, pp, np) and acum (B, nc, H, lp);
// scratch gs (B, nc, H, pp, np), cb (B, nc, lp, lp), dag (B, nc, H, 3, lp)
// and part (B, nc, G, 4, lp, np) floats, G from repro_ssd_scan_bwd_groups;
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

  const int hpb = heads_per_block(H, nc, B, sms);
  const int G = (H + hpb - 1) / hpb;
  // The wide launches where their shape allows and a block has 2 heads or
  // more to spread its set-up over (C B^T, the B and C rows it keeps in
  // registers, the first head's tiles landing, E's products); else the
  // mma.sync ones.
  const bool wide = wide_path(L, P, N) && hpb >= 2;
  // The tile path runs a (chunk, run)'s intra-chunk and state blocks as one
  // where two would be more than one block an SM.
  const bool fused = !wide && 2LL * G * nc * B > sms;
  // Runs whose state terms of dB and dC stand in partial slots 2 and 3:
  // the wide path's state kinds take runs of 2 hpb heads; none if fused.
  const int Gs = wide ? (H + 2 * hpb - 1) / (2 * hpb) : fused ? 0 : G;
  const int smem_local = local_smem_floats(d) * fsize;
  const int hpb_local = heads_per_block(H, nc, B, 2 * sms);
  const dim3 grid_local((H + hpb_local - 1) / hpb_local, nc, B);
  if (wide) {
    static int granted = 48 * 1024;
    const int smem = kLocFloats * fsize;
    err = grant_smem(ssd_bwd_local_wide_kernel, smem, granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_local_wide_kernel<<<dim3(G, nc, B), kWideThreads, smem, s>>>(
        yf, bf, cf, af, gf, cbf, S, H, hpb);
  } else if (d.np % 32 == 0) {
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

  if (wide) {
    static int granted = 48 * 1024;
    const int smem = kWideFloats * fsize;
    err = grant_smem(ssd_bwd_wide_kernel, smem, granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    const WideArgs w{xf, yf, bf, cf, sf, gf, cbf, af,
                     static_cast<float*>(dxh), dgf, pf, S, H, hpb, G};
    ssd_bwd_wide_kernel<<<dim3(2 * G + 2 * Gs, nc, B),
                          kWideThreads + kProducerThreads, smem, s>>>(w);
  } else {
    static int granted = 48 * 1024;
    const int smem = max(intra_smem_floats(d), state_smem_floats(d)) * fsize;
    err = grant_smem(ssd_bwd_tile_kernel<kStateSlots>, smem, granted);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_bwd_tile_kernel<kStateSlots><<<dim3((fused ? 1 : 2) * G * nc, B),
                                       kBigThreads, smem, s>>>(
        xf, yf, bf, cf, sf, gf, cbf, af, static_cast<float*>(dxh), dgf, pf,
        S, H, P, N, L, hpb, fused ? 1 : 0);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long items = (long long)B * nc * H;
  const long long outs = (long long)B * S * N;
  const int n_da = static_cast<int>((items + kThreads / 32 - 1)
                                    / (kThreads / 32));
  const int n_out = static_cast<int>((outs + kThreads - 1) / kThreads);
  ssd_bwd_finish_kernel<<<n_da + n_out, kThreads, 0, s>>>(
      dgf, pf, static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(dc), B, S, H, N, L, d.lp, d.np, nc, G, Gs,
      wide ? 3 : 2, n_da);
  return static_cast<int>(cudaGetLastError());
}
