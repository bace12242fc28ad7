// ssd_scan: the Mamba-2 SSD chunk scan from a zero state, on the tensor cores.
//
//   xh (B, S, H, P), a (B, S, H), b/c (B, S, N), all fp32 -> y (B, S, H, P):
//   h_t[p, n] = exp(a_t) h_{t-1}[p, n] + xh_t[p] b_t[n],
//   y_t[p]    = sum_n c_t[n] h_t[p, n],
//   in the chunked form (length L = chunk) the reference uses:
//   acum = cumsum(a) over the chunk,
//   y[q] = sum_{k<=q} exp(acum_q - acum_k) (c_q . b_k) x_k
//          + exp(acum_q) sum_n c_q[n] h[:, n]        (carried state)
//   h    = exp(acum_L) h + sum_k exp(acum_L - acum_k) b_k x_k.
//   The triangle is masked before the exponential.  A ragged last chunk
//   reads zeros past S, as the reference's padding does.
//
// Replaces the TPU kernel src/repro/kernels/ssd_scan.py::_ssd_kernel (the
// pallas_call in ssd_scan_pallas): a (batch, head-block, seq-chunk) grid
// whose chunk axis runs in order, carrying a (block_h, P, N) state in VMEM.
//
// What bounds it on the H100: bytes, once the products run on the tensor
// cores.  At zamba2's shape (B, S, H, P, N, chunk) = (1, 4096, 80, 64, 64,
// 128) it must read xh and write y (84 MB each) plus a, b and c: 171 MB,
// 0.051 ms at 3.35 TB/s.  Its 8.11 GFLOP would take 0.121 ms as fp32 FMAs
// (67 TFLOP/s); as three TF32 products each (24.3 G TF32 flops at 495
// TFLOP/s) they take 0.049 ms.
//
// Design: SSD's state-passing form, chunks in parallel, three launches.
//  1. ssd_state_kernel: per (chunk, head), acum = cumsum(a) over the chunk
//     (a shuffle scan in each warp), written out for the other launches,
//     and the chunk's own state from zero, s_c = X^T (exp(acum_L - acum_k)
//     o B), a (P x L)(L x N) product.  A block takes one chunk and a run of
//     heads, B staged once and the next head's X in flight while it works
//     on this one; the blocks of a chunk then share out the rows of its
//     C B^T (L x L, depth N, on and below the diagonal), formed once for
//     every head.
//  2. ssd_pass_kernel, per (batch row, head, 4 state elements): the carry
//     over the chunks in order, h_c = exp(acum_L^c) h_{c-1} + s_c, which
//     overwrites each s_c with the state entering its chunk.
//  3. ssd_scan_kernel: per (chunk, head), y = exp(acum_q) (C h^T) +
//     (C B^T o decay-tril) X.  The decayed weights W are formed elementwise
//     per head into shared memory, the exponent masked to -1e30 off the
//     triangle before exp: exp(acum_q - acum_k) is never split into
//     exp(acum_q) exp(-acum_k), which overflows when acum falls hundreds
//     below zero in a chunk.  A block of 16 warps takes one chunk and a run
//     of heads (one block per SM): C and its share of C B^T (in registers)
//     load once, the next head's X, h and acum are in flight while it works
//     on this one.  A warp owns 16 columns of y in two m-tiles of 16 rows,
//     i and L/16 - 1 - i, so that the triangle's short and long rows pair
//     up and every warp does the same work.
// Every product runs on mma.sync.m16n8k8 in 3xTF32: an fp32 operand x is
// split into hi = tf32(x) and lo = tf32(x - hi), both cut from its bits,
// and lo*hi + hi*lo + hi*hi accumulate in fp32 (one TF32 pass keeps 10
// mantissa bits and misses the fp32 bar).  Tiles come in by cp.async;
// shared-memory row strides are padded so that every fragment load is free
// of bank conflicts.
#include <cuda_runtime.h>
#include <stdint.h>

#include "ssd_tiles.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 128;      // the state kernel scans one row a thread
constexpr int kScanThreads = 512;   // the scan kernel's block
constexpr int kScanWarps = kScanThreads / 32;
constexpr int kMaxSlots = 2;        // units a warp of the scan kernel holds
// float4s of C B^T each thread of the scan kernel holds: rows warp + 16 i
// of the chunk, for i < 128 / 16.
constexpr int kCbRegs = kMaxChunk / (kScanThreads / 32);

// Units of one (chunk, head) in the scan kernel: 16 columns of y in the
// rows of two m-tiles of 16, i and lp / 16 - 1 - i, so that the triangle's
// short and long rows pair up.
__host__ __device__ inline int scan_units(const Dims& d) {
  return (d.lp / 16 + 1) / 2 * (d.pp / 16);
}

// Shared memory of each kernel, in floats: the state kernel's B, X (two
// buffers, which also hold 16 rows of C for C B^T), a (two buffers), acum, the
// decays and the warp totals; the scan kernel's C, W, and nbuf buffers each
// of X, h and acum.
__host__ __device__ inline int state_smem_floats(const Dims& d) {
  const int x2 = 2 * d.lp * stride_t(d.pp), c16 = 16 * stride_g(d.np);
  return d.lp * stride_t(d.np) + (x2 > c16 ? x2 : c16) + 4 * d.lp + kWarps;
}
__host__ __device__ inline int scan_smem_floats(const Dims& d, int nbuf) {
  return d.lp * stride_g(d.np) + d.lp * stride_g(d.lp)
         + nbuf * (d.lp * stride_t(d.pp) + d.pp * stride_g(d.np) + d.lp);
}

// Grid (G, nc, B): block (g, c, b) takes heads [g * hpb, (g + 1) * hpb) of
// chunk c in turn, the next head's X and a in flight (cp.async) while it
// works on this one; B is staged once.  Per head: acum into acum_g[(b, c,
// h)][lp] and the chunk's state from zero into st[(b, c, h)][pp][np], in
// units of 16 rows by 8 NT columns.  Then rows [16g, 16g + 16), [16(g + G),
// ...) of the chunk's C B^T into cbg.
template <int NT>
__global__ void __launch_bounds__(kThreads, 2)
ssd_state_kernel(const float* __restrict__ xh, const float* __restrict__ a,
                 const float* __restrict__ bm, const float* __restrict__ cm,
                 float* __restrict__ st, float* __restrict__ cbg,
                 float* __restrict__ acum_g, int S, int H, int P, int N,
                 int L, int hpb) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = dims(L, P, N);
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int t0 = c * L, lv = min(L, S - t0);
  const long long row0 = (long long)b * S + t0;
  const int h0 = grp * hpb, h1 = min(H, h0 + hpb);
  const int sx = stride_t(d.pp), sb = stride_t(d.np), xsz = d.lp * sx;
  const int xreg = max(2 * xsz, 16 * stride_g(d.np));
  float* bs = smem;                       // B               [lp][sb]
  float* xs = bs + d.lp * sb;             // X, two buffers  [lp][sx]
  float* av = xs + xreg;                  // a, two buffers  [lp]
  float* acum = av + 2 * d.lp;
  float* dk = acum + d.lp;
  float* wsum = dk + d.lp;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const long long xld = (long long)H * P;

  auto stage_head = [&](int hh, int buf) {
    stage_tile(xs + buf * xsz, sx, xh + (row0 * H + hh) * P, xld, lv, P,
               d.lp, d.pp, P % 4 == 0);
    float* ab = av + buf * d.lp;
    for (int r = tid; r < d.lp; r += kThreads) {
      if (r < lv) {
        cp_async4(ab + r, a + (row0 + r) * H + hh);
      } else {
        ab[r] = 0.f;
      }
    }
  };
  stage_tile(bs, sb, bm + row0 * N, N, lv, N, d.lp, d.np, N % 4 == 0);
  stage_head(h0, 0);
  cp_async_commit();

  const int ng = d.np / (8 * NT), units = (d.pp / 16) * ng;
  const int kend = round_up(lv, 8);
  for (int hh = h0, buf = 0; hh < h1; ++hh, buf ^= 1) {
    if (hh + 1 < h1) stage_head(hh + 1, buf ^ 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const long long blk = ((long long)b * nc + c) * H + hh;
    // acum = cumsum(a): an inclusive shuffle scan in each warp, then the
    // totals of the warps before.  Rows past S add zeros.
    float v = tid < d.lp ? av[buf * d.lp + tid] : 0.f;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const float up = __shfl_up_sync(0xffffffffu, v, off);
      if (lane >= off) v += up;
    }
    if (lane == 31) wsum[warp] = v;
    __syncthreads();
    if (tid < d.lp) {
      for (int w = 0; w < warp; ++w) v += wsum[w];
      acum[tid] = v;
      acum_g[blk * d.lp + tid] = v;
    }
    __syncthreads();
    if (tid < d.lp) {
      dk[tid] = tid < lv ? expf(acum[lv - 1] - acum[tid]) : 0.f;
    }
    __syncthreads();
    // s_c[p][n] = sum_k X[k][p] (dk[k] B[k][n]).
    const float* x = xs + buf * xsz;
    float* out = st + blk * d.pp * d.np;
    for (int u = warp; u < units; u += kWarps) {
      const int p0 = (u / ng) * 16, n0 = (u % ng) * 8 * NT;
      float acc[NT][4] = {};
      tile_mma(acc, 0, kend,
               [&](int k, float (&f)[4]) {
                 const float* r0 = x + (k + t) * sx + p0 + g;
                 f[0] = r0[0]; f[1] = r0[8]; f[2] = r0[4 * sx];
                 f[3] = r0[4 * sx + 8];
               },
               [&](int k, int j, float (&f)[2]) {
                 const float* r = bs + (k + t) * sb + n0 + 8 * j + g;
                 f[0] = r[0] * dk[k + t]; f[1] = r[4 * sb] * dk[k + t + 4];
               });
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        float* o = out + (p0 + g) * d.np + n0 + 8 * j + 2 * t;
        *reinterpret_cast<float2*>(o) = make_float2(acc[j][0], acc[j][1]);
        *reinterpret_cast<float2*>(o + 8 * d.np) =
            make_float2(acc[j][2], acc[j][3]);
      }
    }
    __syncthreads();                             // X[buf], acum, dk free
  }
  cb_rows(xs, bs, sb, cm + row0 * N,
          cbg + ((long long)b * nc + c) * d.lp * d.lp, d, N, lv, grp,
          gridDim.x);
}

// Grid (ceil(pp * np / 4 / 256), H, B).  st[(b, c, h)] holds s_c on entry
// and the state entering chunk c on exit; four chunks' loads in flight.
__global__ void __launch_bounds__(kThreads)
ssd_pass_kernel(float* __restrict__ st, const float* __restrict__ acum_g,
                int S, int H, int L, int lp, int pn, int nc) {
  const int e4 = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (4 * e4 >= pn) return;
  float4 carry = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int c0 = 0; c0 < nc; c0 += 4) {
    float4 s[4];
    float tot[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i;
      if (c < nc) {
        const long long blk = ((long long)b * nc + c) * H + h;
        s[i] = reinterpret_cast<const float4*>(st + blk * pn)[e4];
        tot[i] = acum_g[blk * lp + min(L, S - c * L) - 1];
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + i;
      if (c < nc) {
        const long long blk = ((long long)b * nc + c) * H + h;
        reinterpret_cast<float4*>(st + blk * pn)[e4] = carry;
        const float f = expf(tot[i]);
        carry = make_float4(fmaf(f, carry.x, s[i].x), fmaf(f, carry.y, s[i].y),
                            fmaf(f, carry.z, s[i].z), fmaf(f, carry.w, s[i].w));
      }
    }
  }
}

// Grid (G, nc, B): block (g, c, b) takes heads [g * hpb, (g + 1) * hpb) of
// chunk c in turn; with nbuf = 2 the next head's X, h and acum are in
// flight while it works on this one.  C and C B^T are loaded once, C B^T
// into registers (U == 1) as the float4s this thread turns into W.  U
// units per warp (scan_units <= kScanWarps * U).
template <int U>
__global__ void __launch_bounds__(kScanThreads, 1)
ssd_scan_kernel(const float* __restrict__ xh, const float* __restrict__ cm,
                const float* __restrict__ st, const float* __restrict__ cbg,
                const float* __restrict__ acum_g, float* __restrict__ y,
                int S, int H, int P, int N, int L, int hpb, int nbuf) {
  extern __shared__ __align__(16) float smem[];
  const Dims d = dims(L, P, N);
  const int sc = stride_g(d.np), sw = stride_g(d.lp), sx = stride_t(d.pp);
  const int xsz = d.lp * sx, hsz = d.pp * sc;
  float* cs = smem;                              // C              [lp][sc]
  float* ws = cs + d.lp * sc;                    // W              [lp][sw]
  float* xs = ws + d.lp * sw;                    // X, nbuf        [lp][sx]
  float* hs = xs + nbuf * xsz;                   // h, nbuf        [pp][sc]
  float* ac = hs + nbuf * hsz;                   // acum, nbuf     [lp]
  const int grp = blockIdx.x, c = blockIdx.y, b = blockIdx.z;
  const int nc = gridDim.y;
  const int t0 = c * L, lv = min(L, S - t0);
  const long long row0 = (long long)b * S + t0;
  const int h0 = grp * hpb, h1 = min(H, h0 + hpb);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  auto stage_head = [&](int hh, int buf) {
    const long long blk = ((long long)b * nc + c) * H + hh;
    stage_tile(xs + buf * xsz, sx, xh + (row0 * H + hh) * P,
               (long long)H * P, lv, P, d.lp, d.pp, P % 4 == 0);
    if (c > 0) {                                 // chunk 0 enters at zero
      stage_tile(hs + buf * hsz, sc, st + blk * d.pp * d.np, d.np, d.pp,
                 d.np, d.pp, d.np, true);
    }
    stage_tile(ac + buf * d.lp, d.lp, acum_g + blk * d.lp, d.lp, 1, d.lp, 1,
               d.lp, true);
  };
  if (c > 0) {
    stage_tile(cs, sc, cm + row0 * N, N, lv, N, d.lp, d.np, N % 4 == 0);
  }
  stage_head(h0, 0);
  cp_async_commit();
  // This thread's float4s of C B^T, row q = warp + 16 i at columns 4 lane
  // .. 4 lane + 3, zeros above the diagonal and past S: the same for every
  // head, held in registers with one unit per warp, read again (from L2) per
  // head with two.
  const float* cbc = cbg + ((long long)b * nc + c) * d.lp * d.lp;
  const int k4 = 4 * lane;
  auto cb_float4 = [&](int i) {
    const int q = warp + 16 * i;
    return q < lv && k4 <= q
               ? *reinterpret_cast<const float4*>(cbc + q * d.lp + k4)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  float4 cbr[U == 1 ? kCbRegs : 1];
  if (U == 1) {
#pragma unroll
    for (int i = 0; i < kCbRegs; ++i) cbr[i] = cb_float4(i);
  }

  // Unit u: 16 columns of P from p0 = 16 (u % ng), in the rows of m-tiles
  // pair = u / ng and mt - 1 - pair.  Slot 1 of a unit holds the longer
  // m-tile (the only one, when the pair is the middle tile or when its
  // second tile lies past S); slot 0 the shorter, if any.
  const int ng = d.pp / 16, units = scan_units(d), mt = d.lp / 16;
  const int kv = round_up(lv, 8);
  const long long ys = (long long)H * P;
  int q1[U], q0[U], p0[U];
  bool two[U], live[U];
#pragma unroll
  for (int j = 0; j < U; ++j) {
    const int u = j * kScanWarps + warp, pair = u / ng;
    const int lo = 16 * pair, hi = 16 * (mt - 1 - pair);
    live[j] = u < units && lo < lv;
    two[j] = hi > lo && hi < lv;
    q1[j] = two[j] ? hi : lo;
    q0[j] = lo;
    p0[j] = 16 * (u % ng);
  }

  for (int hh = h0, it = 0; hh < h1; ++hh, ++it) {
    const int buf = nbuf == 2 ? (it & 1) : 0;
    if (nbuf == 2) {
      if (hh + 1 < h1) stage_head(hh + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      if (hh > h0) {
        stage_head(hh, 0);
        cp_async_commit();
      }
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* acum = ac + buf * d.lp;
    const float* x = xs + buf * xsz;
    const float* hb = hs + buf * hsz;
    float acc[U][2][2][4] = {};
    // Phase 1: acc = exp(acum_q) (C h^T).
    if (c > 0) {
#pragma unroll
      for (int j = 0; j < U; ++j) {
        if (!live[j]) continue;
        const int rows[2] = {q0[j], q1[j]};
        pair_mma(acc[j][0], acc[j][1], two[j] ? d.np : 0, d.np,
                 [&](int i, int k, float (&f)[4]) {
                   const float* r0 = cs + (rows[i] + g) * sc + k + t;
                   f[0] = r0[0]; f[1] = r0[8 * sc]; f[2] = r0[4];
                   f[3] = r0[8 * sc + 4];
                 },
                 [&](int k, int jj, float (&f)[2]) {
                   const float* r = hb + (p0[j] + 8 * jj + g) * sc + k + t;
                   f[0] = r[0]; f[1] = r[4];
                 });
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float e0 = expf(acum[rows[i] + g]);
          const float e1 = expf(acum[rows[i] + g + 8]);
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            acc[j][i][jj][0] *= e0; acc[j][i][jj][1] *= e0;
            acc[j][i][jj][2] *= e1; acc[j][i][jj][3] *= e1;
          }
        }
      }
    }
    // W[q][k] = (C B^T)[q][k] exp(acum_q - acum_k): the exponent masked to
    // -1e30 (exp 0) off k <= q < lv before the exponential, as the
    // reference masks it.
#pragma unroll
    for (int i = 0; i < kCbRegs; ++i) {
      const int q = warp + 16 * i;
      if (q >= d.lp || k4 >= d.lp) continue;
      const float4 cv = U == 1 ? cbr[U == 1 ? i : 0] : cb_float4(i);
      const float4 ak = *reinterpret_cast<const float4*>(acum + k4);
      const float aq = acum[q];
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
    // Phase 2: acc += W X over k < q + 16 (W is zero above the diagonal),
    // then store the rows below S.
    float* yb = y + (row0 * H + hh) * P;
#pragma unroll
    for (int j = 0; j < U; ++j) {
      if (!live[j]) continue;
      const int rows[2] = {q0[j], q1[j]};
      pair_mma(acc[j][0], acc[j][1], two[j] ? min(q0[j] + 16, kv) : 0,
               min(q1[j] + 16, kv),
               [&](int i, int k, float (&f)[4]) {
                 const float* r0 = ws + (rows[i] + g) * sw + k + t;
                 f[0] = r0[0]; f[1] = r0[8 * sw]; f[2] = r0[4];
                 f[3] = r0[8 * sw + 4];
               },
               [&](int k, int jj, float (&f)[2]) {
                 const float* r = x + (k + t) * sx + p0[j] + 8 * jj + g;
                 f[0] = r[0]; f[1] = r[4 * sx];
               });
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        if (i == 0 && !two[j]) continue;
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int p = p0[j] + 8 * jj + 2 * t;
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            const int q = rows[i] + g + 8 * r;
            if (q >= lv) continue;
            float* o = yb + q * ys + p;
            const float v0 = acc[j][i][jj][2 * r];
            const float v1 = acc[j][i][jj][2 * r + 1];
            if (p + 1 < P && P % 2 == 0) {
              *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
            } else {
              if (p < P) o[0] = v0;
              if (p + 1 < P) o[1] = v1;
            }
          }
        }
      }
    }
    __syncthreads();                             // buffers and W free
  }
}

template <int NT>
cudaError_t launch_state(dim3 grid, int smem, cudaStream_t s, const float* xh,
                         const float* a, const float* bm, const float* cm,
                         float* st, float* cbg, float* acum_g, int S, int H,
                         int P, int N, int L, int hpb) {
  static int granted = 48 * 1024;
  const cudaError_t err = grant_smem(ssd_state_kernel<NT>, smem, granted);
  if (err != cudaSuccess) return err;
  ssd_state_kernel<NT><<<grid, kThreads, smem, s>>>(xh, a, bm, cm, st, cbg,
                                                    acum_g, S, H, P, N, L,
                                                    hpb);
  return cudaGetLastError();
}

template <int U>
cudaError_t launch_scan(dim3 grid, int smem, cudaStream_t s, const float* xh,
                        const float* cm, const float* st, const float* cbg,
                        const float* acum_g, float* y, int S, int H, int P,
                        int N, int L, int hpb, int nbuf) {
  static int granted = 48 * 1024;
  const cudaError_t err = grant_smem(ssd_scan_kernel<U>, smem, granted);
  if (err != cudaSuccess) return err;
  ssd_scan_kernel<U><<<grid, kScanThreads, smem, s>>>(
      xh, cm, st, cbg, acum_g, y, S, H, P, N, L, hpb, nbuf);
  return cudaGetLastError();
}

}  // namespace

// Bytes of dynamic shared memory the larger kernel needs at (chunk L, P, N),
// or 0 if the tiling does not take the shape (L > 128, or more than
// kScanWarps * kMaxSlots scan units per (chunk, head): P > 128 at L = 128).
extern "C" int repro_ssd_scan_smem_bytes(int L, int P, int N) {
  if (L < 1 || L > kMaxChunk || P < 1 || N < 1) return 0;
  const Dims d = dims(L, P, N);
  if (scan_units(d) > kScanWarps * kMaxSlots) return 0;
  const int state = state_smem_floats(d), scan = scan_smem_floats(d, 1);
  return (state > scan ? state : scan) * static_cast<int>(sizeof(float));
}

// Scratch the wrapper allocates, with lp, pp, np = L, P, N rounded up to 16
// and nc = ceil(S / L): st B*nc*H*pp*np, cb B*nc*lp*lp and acum
// B*nc*H*lp floats.  Returns cudaGetLastError() after the launches (or the
// attribute call's error).
extern "C" int repro_ssd_scan_f32(const void* xh, const void* a,
                                  const void* bm, const void* cm, void* st,
                                  void* cb, void* acum, void* y, int B, int S,
                                  int H, int P, int N, int L, void* stream) {
  const int smem_max = repro_ssd_scan_smem_bytes(L, P, N);
  const int nc = S > 0 && L > 0 ? (S + L - 1) / L : 0;
  if (smem_max == 0 || B <= 0 || B > 65535 || H <= 0 || S <= 0
      || nc > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Dims d = dims(L, P, N);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(xh);
  const float* af = static_cast<const float*>(a);
  const float* bf = static_cast<const float*>(bm);
  const float* cf = static_cast<const float*>(cm);
  float* stf = static_cast<float*>(st);
  float* cbf = static_cast<float*>(cb);
  float* acf = static_cast<float*>(acum);
  float* yf = static_cast<float*>(y);
  static const int sms = device_attr(cudaDevAttrMultiProcessorCount, 132);
  static const int smem_limit =
      device_attr(cudaDevAttrMaxSharedMemoryPerBlockOptin, 232448);
  const int fsize = static_cast<int>(sizeof(float));

  const int smem_state = state_smem_floats(d) * fsize;
  const int hpb_state = heads_per_block(H, nc, B, 2 * sms);
  const dim3 grid_state((H + hpb_state - 1) / hpb_state, nc, B);
  cudaError_t err =
      d.np % 32 == 0
          ? launch_state<4>(grid_state, smem_state, s, xf, af, bf, cf, stf,
                            cbf, acf, S, H, P, N, L, hpb_state)
          : launch_state<2>(grid_state, smem_state, s, xf, af, bf, cf, stf,
                            cbf, acf, S, H, P, N, L, hpb_state);
  if (err != cudaSuccess) return static_cast<int>(err);

  const int pn = d.pp * d.np;
  ssd_pass_kernel<<<dim3((pn / 4 + kThreads - 1) / kThreads, H, B), kThreads,
                    0, s>>>(stf, acf, S, H, L, d.lp, pn, nc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  const int nbuf = scan_smem_floats(d, 2) * fsize <= smem_limit ? 2 : 1;
  const int smem_scan = scan_smem_floats(d, nbuf) * fsize;
  const int hpb = heads_per_block(H, nc, B, sms);
  const dim3 grid((H + hpb - 1) / hpb, nc, B);
  if (scan_units(d) <= kScanWarps) {
    err = launch_scan<1>(grid, smem_scan, s, xf, cf, stf, cbf, acf, yf, S, H,
                         P, N, L, hpb, nbuf);
  } else {
    err = launch_scan<2>(grid, smem_scan, s, xf, cf, stf, cbf, acf, yf, S, H,
                         P, N, L, hpb, nbuf);
  }
  return static_cast<int>(err);
}
