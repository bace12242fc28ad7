// dol_bid_scores: the device planner's (M, N) candidate IID distances,
//   out[m, n] = || (a_m psi_m + b_n d_n) / max(a_m + b_n, 1) - U ||_2
// (Eq. 2 then Eq. B.1, the w1_norm metric) for every (model m, client n):
// dol (M, C), chain_size a (M,), dsi (N, C), data_size b (N,) -> (M, N), fp32.
//
// Replaces the TPU kernel repro/kernels/diffusion.py::_bid_kernel (the
// pallas_call in dol_bid_scores_pallas), which contracted centered (BM, C)
// DoL and (BN, C) DSI tiles on the MXU and finished with rank-1 statistics.
//
// The algebra is the reference's (kernels/ref.py::dol_bid_scores_fused_ref
// is its plain twin).  Centering on U, psi_c = psi - u and d_c = d - u with
// u = 1/C, and with s = a + b, sp = max(s, 1), delta = s/sp - 1:
//   dist^2 = (a^2 P_psi + 2ab <psi_c, d_c> + b^2 P_d) / sp^2
//          + 2u delta (a S_psi + b S_d) / sp + C u^2 delta^2,
// P = sum of squares and S = sum of a centered row.  The delta terms live
// only where s < 1 (a never-trained model on an empty client).  No (M, N, C)
// tensor exists, and as DoLs converge to U nothing cancels.
//
// What bounds it on the H100: at the planner's sizes (M, N <= 20, C = 10)
// the launch; at (1024, 1024, 10) the 4 MB output write (about 1.3 us at
// 3.35 TB/s) against 2*M*N*C = 21 MFLOP of fp32.  The contraction depth C is
// 10, useless to wgmma, and TF32 would break the 2e-5 bar: plain fp32 FMAs.
//
// Design: one thread per output.  A block owns a tile of kTM = 8 models by
// kTN = 32 clients (a warp per model row, lanes along clients, so every
// warp stores 128 contiguous bytes).  The block stages the tile's centered
// DoL and DSI rows in shared memory and computes their four row statistics
// there (the centering is done in the kernel, not in the wrapper, so a call
// is one launch with no temporaries); then each thread runs the C-long dot
// product and the epilogue.  C is a runtime argument: the rows live in
// dynamic shared memory, (kTM + kTN) * (C + 2) floats.
#include <cuda_runtime.h>

namespace {

constexpr int kTM = 8;
constexpr int kTN = 32;
constexpr int kThreads = kTM * kTN;

__global__ void __launch_bounds__(kThreads)
dol_bid_scores_kernel(const float* __restrict__ dol,
                      const float* __restrict__ chain,
                      const float* __restrict__ dsi,
                      const float* __restrict__ size,
                      float* __restrict__ out, int M, int N, int C) {
  extern __shared__ float smem[];
  float* psi = smem;                         // (kTM, C) centered DoL rows
  float* dc = psi + kTM * C;                 // (kTN, C) centered DSI rows
  float* p_psi = dc + kTN * C;               // (kTM,)
  float* s_psi = p_psi + kTM;                // (kTM,)
  float* p_d = s_psi + kTM;                  // (kTN,)
  float* s_d = p_d + kTN;                    // (kTN,)

  const int tid = threadIdx.y * kTN + threadIdx.x;
  const int m0 = blockIdx.y * kTM;
  const int n0 = blockIdx.x * kTN;
  const float u = 1.0f / static_cast<float>(C);

  // Stage centered rows; rows past the edge are zero and never stored.
  for (int i = tid; i < kTM * C; i += kThreads) {
    const int r = i / C, c = i % C;
    psi[i] = (m0 + r < M) ? dol[static_cast<size_t>(m0 + r) * C + c] - u : 0.f;
  }
  for (int i = tid; i < kTN * C; i += kThreads) {
    const int r = i / C, c = i % C;
    dc[i] = (n0 + r < N) ? dsi[static_cast<size_t>(n0 + r) * C + c] - u : 0.f;
  }
  __syncthreads();
  if (tid < kTM + kTN) {
    const float* row = tid < kTM ? psi + tid * C : dc + (tid - kTM) * C;
    float p = 0.f, s = 0.f;
    for (int c = 0; c < C; ++c) {
      p = fmaf(row[c], row[c], p);
      s += row[c];
    }
    if (tid < kTM) {
      p_psi[tid] = p;
      s_psi[tid] = s;
    } else {
      p_d[tid - kTM] = p;
      s_d[tid - kTM] = s;
    }
  }
  __syncthreads();

  const int lm = threadIdx.y, ln = threadIdx.x;
  const int m = m0 + lm, n = n0 + ln;
  if (m >= M || n >= N) return;
  const float* pr = psi + lm * C;
  const float* dr = dc + ln * C;
  float cross = 0.f;
  for (int c = 0; c < C; ++c) cross = fmaf(pr[c], dr[c], cross);

  const float a = chain[m];
  const float b = size[n];
  const float s = a + b;
  const float sp = fmaxf(s, 1.0f);
  const float delta = s / sp - 1.0f;
  const float core =
      (a * a * p_psi[lm] + 2.0f * a * b * cross + b * b * p_d[ln]) / (sp * sp);
  const float lin = 2.0f * u * delta * (a * s_psi[lm] + b * s_d[ln]) / sp;
  const float ud = u * delta;
  const float quad = (1.0f / u) * ud * ud;
  out[static_cast<size_t>(m) * N + n] = sqrtf(fmaxf(core + lin + quad, 0.f));
}

}  // namespace

// dol (M, C), chain (M,), dsi (N, C), size (N,), out (M, N): fp32,
// contiguous, on the current device.  Returns cudaGetLastError() after the
// launch (0 on success).
extern "C" int repro_dol_bid_scores_f32(const float* dol, const float* chain,
                                        const float* dsi, const float* size,
                                        float* out, int M, int N, int C,
                                        cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ((kTM + kTN) * (C + 2));
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        dol_bid_scores_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(static_cast<unsigned>((N + kTN - 1) / kTN),
                  static_cast<unsigned>((M + kTM - 1) / kTM));
  const dim3 block(kTN, kTM);
  dol_bid_scores_kernel<<<grid, block, smem, stream>>>(dol, chain, dsi, size,
                                                       out, M, N, C);
  return static_cast<int>(cudaGetLastError());
}
