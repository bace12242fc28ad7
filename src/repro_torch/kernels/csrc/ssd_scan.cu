// ssd_scan: the Mamba-2 SSD chunk scan from a zero state.
//
//   xh (B, S, H, P), a (B, S, H), b/c (B, S, N), all fp32 -> y (B, S, H, P):
//   h_t[p, n] = exp(a_t) h_{t-1}[p, n] + xh_t[p] b_t[n],
//   y_t[p]    = sum_n c_t[n] h_t[p, n],
//   computed chunk by chunk (length L = chunk) as the reference does:
//   acum = cumsum(a) over the chunk,
//   y[q] = sum_{k<=q} exp(acum_q - acum_k) (c_q . b_k) x_k
//          + exp(acum_q) sum_n c_q[n] h[:, n]        (carried state)
//   h    = exp(acum_L) h + sum_k exp(acum_L - acum_k) b_k x_k.
//   The triangle is masked before the exponential.  A ragged last chunk
//   reads zeros past S, as the reference's padding does.
//
// Replaces the TPU kernel repro/kernels/ssd_scan.py::_ssd_kernel (the
// pallas_call in ssd_scan_pallas): a (batch, head-block, seq-chunk) grid
// whose chunk axis runs in order, carrying a (block_h, P, N) state in VMEM.
//
// What bounds it on the H100: operations.  It moves ~8 bytes per element of
// xh/y, but the chunked form spends ~4*N flops per element of y on the
// carried state (its contribution and its update) plus L flops on the
// intra-chunk product.  This version runs them as fp32 FMAs on the CUDA
// cores, no tensor cores (TF32 would miss the fp32 tolerance).
//
// Design.  Two kernels per call.  ssd_cb_kernel forms each chunk's C B^T
// (L x L, lower triangle) once per batch row into a scratch tensor: it is
// shared by every head and every row of P.  ssd_scan_kernel then gives one
// block to (b, h, a tile of 16 rows of P) — zamba2's 80 heads x 4 tiles are
// 320 blocks, not 80 — which walks the chunks in order, its (N, 16) state
// slice in shared memory.  Per chunk it stages b, c, its x tile and a, takes
// the cumulative sum with warp shuffles, forms the decayed weights
// W[q][k] = exp(acum_q - acum_k) (C B^T)[q][k] (k <= q, else 0) and folds
// exp(acum_L - acum_k) into b.  Register tiles keep the shared-memory loads
// below the FMAs: a thread computes y for 2 rows (q, q + L/2, which also
// balances the triangle) x 4 columns of P against float4 loads of x and of
// the state, and the state update for one n x 4 columns.  Rows of c and of
// W are padded by one float (no bank conflicts across the rows a warp
// reads).  Dynamic shared memory: ~145 KB at L = 128, N = 64.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPT = 16;             // rows of P per block
constexpr int kCBT = 16;            // C B^T tile edge

struct Layout {
  int x_off, h_off, b_off, c_off, w_off, acum_off, eq_off, dk_off, total;
};

// Offsets in floats; x and the state come first so their float4 views stay
// 16-byte aligned.
__host__ __device__ inline Layout layout(int L, int N) {
  Layout s;
  s.x_off = 0;                          // x tile   [L][16]
  s.h_off = s.x_off + L * kPT;          // state^T  [N][16]
  s.b_off = s.h_off + N * kPT;          // b        [L][N]
  s.c_off = s.b_off + L * N;            // c        [L][N + 1]
  s.w_off = s.c_off + L * (N + 1);      // W        [L][L + 1]
  s.acum_off = s.w_off + L * (L + 1);
  s.eq_off = s.acum_off + L;
  s.dk_off = s.eq_off + L;
  s.total = s.dk_off + L;
  return s;
}

// cb[(b*nc + ci)*L + q][k] = sum_n c[b, ci*L + q, n] b[b, ci*L + k, n] for
// k <= q (zeros past S); tiles wholly above the diagonal are skipped.
__global__ void __launch_bounds__(kCBT * kCBT)
ssd_cb_kernel(const float* __restrict__ bm, const float* __restrict__ cm,
              float* __restrict__ cb, int S, int N, int L, int nc) {
  extern __shared__ float tile[];     // c rows [16][N + 1], b rows [16][N + 1]
  const int k0 = blockIdx.x * kCBT, q0 = blockIdx.y * kCBT;
  if (k0 > q0 + kCBT - 1) return;
  const int b = blockIdx.z / nc, ci = blockIdx.z - b * nc;
  const int n1 = N + 1;
  float* cs = tile;
  float* bs = tile + kCBT * n1;
  const int tid = threadIdx.y * kCBT + threadIdx.x;
  for (int e = tid; e < kCBT * N; e += kCBT * kCBT) {
    const int r = e / N, n = e - r * N;
    const int tq = ci * L + q0 + r, tk = ci * L + k0 + r;
    cs[r * n1 + n] = (q0 + r < L && tq < S) ? cm[((long long)b * S + tq) * N + n] : 0.f;
    bs[r * n1 + n] = (k0 + r < L && tk < S) ? bm[((long long)b * S + tk) * N + n] : 0.f;
  }
  __syncthreads();
  const int q = q0 + threadIdx.y, k = k0 + threadIdx.x;
  if (q >= L || k >= L || k > q) return;
  const float* cr = cs + threadIdx.y * n1;
  const float* br = bs + threadIdx.x * n1;
  float dot = 0.f;
  for (int n = 0; n < N; ++n) dot += cr[n] * br[n];
  cb[((long long)blockIdx.z * L + q) * L + k] = dot;
}

__global__ void __launch_bounds__(kThreads)
ssd_scan_kernel(const float* __restrict__ xh, const float* __restrict__ a,
                const float* __restrict__ bm, const float* __restrict__ cm,
                const float* __restrict__ cb, float* __restrict__ y, int S,
                int H, int P, int N, int L) {
  extern __shared__ __align__(16) float smem[];
  const Layout lay = layout(L, N);
  float* x_s = smem + lay.x_off;
  float* hT = smem + lay.h_off;
  float* b_s = smem + lay.b_off;
  float* c_s = smem + lay.c_off;
  float* w_s = smem + lay.w_off;
  float* acum = smem + lay.acum_off;
  float* eq = smem + lay.eq_off;
  float* dk = smem + lay.dk_off;
  const float4* x4 = reinterpret_cast<const float4*>(x_s);
  float4* h4 = reinterpret_cast<float4*>(hT);

  const int p0 = blockIdx.x * kPT;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int n1 = N + 1, w1 = L + 1;
  const int nc = (S + L - 1) / L;
  const int half = (L + 1) / 2;

  for (int e = tid; e < N * kPT; e += kThreads) hT[e] = 0.f;

  for (int ci = 0; ci < nc; ++ci) {
    const int t0 = ci * L;
    const int lv = min(L, S - t0);
    __syncthreads();
    // 1. Stage the chunk (zeros past S).
    for (int e = tid; e < L * N; e += kThreads) {
      const int t = e / N, n = e - t * N;
      const long long g = ((long long)b * S + t0 + t) * N + n;
      b_s[e] = t < lv ? bm[g] : 0.f;
      c_s[t * n1 + n] = t < lv ? cm[g] : 0.f;
    }
    for (int e = tid; e < L * kPT; e += kThreads) {
      const int t = e / kPT, pp = e - t * kPT;
      const int p = p0 + pp;
      x_s[e] = (t < lv && p < P)
                   ? xh[(((long long)b * S + t0 + t) * H + h) * P + p]
                   : 0.f;
    }
    for (int t = tid; t < L; t += kThreads) {
      acum[t] = t < lv ? a[((long long)b * S + t0 + t) * H + h] : 0.f;
    }
    __syncthreads();
    // 2. acum = cumsum(a) (warp 0: each lane sums a run, then a shuffle
    //    scan of the run totals), then exp(acum) and the decays to the end.
    if (tid < 32) {
      const int per = (L + 31) / 32;
      const int lo = min(L, lane * per), hi = min(L, lo + per);
      float run = 0.f;
      for (int t = lo; t < hi; ++t) { run += acum[t]; acum[t] = run; }
      float incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, incl, d);
        if (lane >= d) incl += up;
      }
      const float before = incl - run;
      for (int t = lo; t < hi; ++t) acum[t] += before;
      __syncwarp();
      const float last = acum[lv - 1];
      for (int t = lane; t < L; t += 32) {
        eq[t] = expf(acum[t]);
        dk[t] = expf(last - acum[t]);
      }
    }
    __syncthreads();
    // 3. W = decay-tril * C B^T for the valid rows; b *= exp(acum_L - acum_k).
    const float* cbc = cb + ((long long)b * nc + ci) * L * L;
    for (int e = tid; e < L * L; e += kThreads) {
      const int qq = e / L, kk = e - qq * L;
      w_s[qq * w1 + kk] = (kk <= qq && qq < lv)
                              ? cbc[e] * expf(acum[qq] - acum[kk])
                              : 0.f;
    }
    for (int e = tid; e < L * N; e += kThreads) b_s[e] *= dk[e / N];
    __syncthreads();
    // 4. y for rows (qa, qb = qa + L/2) x 4 columns of P per thread.
    for (int e = tid; e < half * (kPT / 4); e += kThreads) {
      const int qa = e / (kPT / 4), pg = e - qa * (kPT / 4);
      const int qb = qa + half;
      const bool has_b = qb < L;
      const int kend = has_b ? qb : qa;
      const float* wa = w_s + qa * w1;
      const float* wb = w_s + (has_b ? qb : qa) * w1;
      float4 ya = make_float4(0.f, 0.f, 0.f, 0.f), yb = ya;
      for (int kk = 0; kk <= kend; ++kk) {
        const float4 xv = x4[kk * (kPT / 4) + pg];
        const float fa = wa[kk], fb = wb[kk];
        ya.x += fa * xv.x; ya.y += fa * xv.y; ya.z += fa * xv.z; ya.w += fa * xv.w;
        yb.x += fb * xv.x; yb.y += fb * xv.y; yb.z += fb * xv.z; yb.w += fb * xv.w;
      }
      const float* ca = c_s + qa * n1;
      const float* cbr = c_s + (has_b ? qb : qa) * n1;
      float4 sa = make_float4(0.f, 0.f, 0.f, 0.f), sb = sa;
      for (int n = 0; n < N; ++n) {
        const float4 hv = h4[n * (kPT / 4) + pg];
        const float fa = ca[n], fb = cbr[n];
        sa.x += fa * hv.x; sa.y += fa * hv.y; sa.z += fa * hv.z; sa.w += fa * hv.w;
        sb.x += fb * hv.x; sb.y += fb * hv.y; sb.z += fb * hv.z; sb.w += fb * hv.w;
      }
      const int p = p0 + 4 * pg;
      const float outa[4] = {ya.x + eq[qa] * sa.x, ya.y + eq[qa] * sa.y,
                             ya.z + eq[qa] * sa.z, ya.w + eq[qa] * sa.w};
      if (qa < lv) {
        float* yr = y + (((long long)b * S + t0 + qa) * H + h) * P;
        for (int i = 0; i < 4; ++i) if (p + i < P) yr[p + i] = outa[i];
      }
      if (has_b && qb < lv) {
        const float eb = eq[qb];
        const float outb[4] = {yb.x + eb * sb.x, yb.y + eb * sb.y,
                               yb.z + eb * sb.z, yb.w + eb * sb.w};
        float* yr = y + (((long long)b * S + t0 + qb) * H + h) * P;
        for (int i = 0; i < 4; ++i) if (p + i < P) yr[p + i] = outb[i];
      }
    }
    __syncthreads();
    // 5. Carry the state past the chunk: one n x 4 columns of P per thread.
    const float tot = eq[lv - 1];
    for (int e = tid; e < N * (kPT / 4); e += kThreads) {
      const int pg = e / N, n = e - pg * N;
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int kk = 0; kk < lv; ++kk) {
        const float bv = b_s[kk * N + n];
        const float4 xv = x4[kk * (kPT / 4) + pg];
        acc.x += bv * xv.x; acc.y += bv * xv.y;
        acc.z += bv * xv.z; acc.w += bv * xv.w;
      }
      const float4 old = h4[n * (kPT / 4) + pg];
      h4[n * (kPT / 4) + pg] = make_float4(
          tot * old.x + acc.x, tot * old.y + acc.y,
          tot * old.z + acc.z, tot * old.w + acc.w);
    }
  }
}

}  // namespace

// Bytes of dynamic shared memory the scan kernel needs at chunk L, state N.
extern "C" int repro_ssd_scan_smem_bytes(int L, int N) {
  return layout(L, N).total * static_cast<int>(sizeof(float));
}

// cb: scratch of B * ceil(S / L) * L * L floats.  Returns cudaGetLastError()
// after the launches (or the attribute call's error).
extern "C" int repro_ssd_scan_f32(const void* xh, const void* a,
                                  const void* bm, const void* cm, void* cb,
                                  void* y, int B, int S, int H, int P, int N,
                                  int L, void* stream) {
  if (B <= 0 || H <= 0 || H > 65535 || S <= 0 || P <= 0 || N <= 0
      || L <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int nc = (S + L - 1) / L;
  if ((long long)B * nc > 65535 || B > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // Raise the kernels' dynamic shared-memory limits once per size (not on
  // every launch, so that launches inside a CUDA graph capture set nothing).
  static int granted_scan = 48 * 1024, granted_cb = 48 * 1024;
  const int smem = repro_ssd_scan_smem_bytes(L, N);
  const int smem_cb = 2 * kCBT * (N + 1) * static_cast<int>(sizeof(float));
  if (smem > granted_scan) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted_scan = smem;
  }
  if (smem_cb > granted_cb) {
    const cudaError_t err = cudaFuncSetAttribute(
        ssd_cb_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_cb);
    if (err != cudaSuccess) return static_cast<int>(err);
    granted_cb = smem_cb;
  }
  const int tiles = (L + kCBT - 1) / kCBT;
  ssd_cb_kernel<<<dim3(tiles, tiles, B * nc), dim3(kCBT, kCBT), smem_cb, s>>>(
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<float*>(cb), S, N, L, nc);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  ssd_scan_kernel<<<dim3((P + kPT - 1) / kPT, H, B), kThreads, smem, s>>>(
      static_cast<const float*>(xh), static_cast<const float*>(a),
      static_cast<const float*>(bm), static_cast<const float*>(cm),
      static_cast<const float*>(cb), static_cast<float*>(y), S, H, P, N, L);
  return static_cast<int>(cudaGetLastError());
}
