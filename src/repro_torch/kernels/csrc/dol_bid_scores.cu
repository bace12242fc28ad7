// dol_bid_scores: the device planner's (M, N) candidate IID distances,
//   out[m, n] = || (a_m psi_m + b_n d_n) / max(a_m + b_n, 1) - U ||_2
// (Eq. 2 then Eq. B.1, the w1_norm metric) for every (model m, client n):
// dol (M, C), chain_size a (M,), dsi (N, C), data_size b (N,) -> (M, N), fp32.
// bid_fused: the Eq.-32 bids of one bid round in one launch,
//   bids[m, n] = (iid[m] - out[m, n]) * (1 + w * value[n])
// the value factor only where a learning value is present.
//
// Replaces the TPU kernels repro/kernels/diffusion.py::_bid_kernel (the
// pallas_call in dol_bid_scores_pallas), which contracted centered (BM, C)
// DoL and (BN, C) DSI tiles on the MXU and finished with rank-1 statistics,
// and, in bid_fused, _bid_value_kernel (bid_value_fuse_pallas) with the
// subtraction between them.  The device planner runs bid_fused once per bid
// round; dol_bid_scores and bid_value_fuse.cu stay as standalone ops.
//
// The algebra is the reference's (kernels/ref.py::dol_bid_scores_fused_ref
// is its plain twin, bid_fused_ref bid_fused's).  Centering on U,
// psi_c = psi - u and d_c = d - u with u = 1/C, and with s = a + b,
// sp = max(s, 1), delta = s/sp - 1:
//   dist^2 = (a^2 P_psi + 2ab <psi_c, d_c> + b^2 P_d) / sp^2
//          + 2u delta (a S_psi + b S_d) / sp + C u^2 delta^2,
// P = sum of squares and S = sum of a centered row.  The delta terms live
// only where s < 1 (a never-trained model on an empty client).  No (M, N, C)
// tensor exists, and as DoLs converge to U nothing cancels.
//
// What bounds them on the H100: at the planner's sizes (M, N <= 20,
// C = 10; no FedDif run bids at more than N = 256) the launch and the
// kernel's dependent chain; at (1024, 1024, 10) the 4 MB output write
// (about 1.3 us at 3.35 TB/s) against 2*M*N*C = 21 MFLOP of fp32.  The
// contraction depth C is 10, useless to wgmma, and TF32 would break the
// 2e-5 bar: plain fp32 FMAs.
//
// dol_bid_scores_kernel: one thread per output.  A block owns a tile of
// kTM = 8 models by kTN = 32 clients (a warp per model row, lanes along
// clients, so every warp stores 128 contiguous bytes).  The block stages the
// tile's centered DoL and DSI rows in shared memory and computes their four
// row statistics there (the centering is done in the kernel, not in the
// wrapper, so a call is one launch with no temporaries); then each thread
// runs the C-long dot product and the epilogue.  C is a runtime argument:
// the rows live in dynamic shared memory, (kTM + kTN) * (C + 2) floats.
//
// bid_fused_kernel: one thread per output, built for the launch-bound
// regime.  Lanes run along clients (so stores coalesce) and warps along
// models.  A thread issues every global load it needs at its start, in one
// batch of independent loads (its DoL and DSI rows, chain[m], size[n],
// iid[m], value[n]), then computes the row statistics in registers,
// redundantly per thread (about 40 FMAs at C = 10, cheaper than a
// barrier): no shared memory, no __syncthreads().  The block is sized to
// the problem (8 x 8 threads at (8, 8)).  C = 10 (the tasks' class count)
// is a template parameter, with registers for the rows; any other C takes
// the runtime-C instance, which stages the block's client rows in shared
// memory (up to C = 1815) and reads the model rows through L1.
//
// Bits: bid_fused centers with one rounded subtraction, takes P and the
// dot product as fmaf chains and S as a sum in class order, as
// dol_bid_scores_kernel does, and finishes in bid_distance, which writes
// out with intrinsics the roundings nvcc gives dol_bid_scores_kernel's
// epilogue (its order, and the three fmas nvcc contracts in it, read from
// that kernel's PTX).  It then rounds the subtraction and the value
// factor's multiply, add and multiply one at a time, as PyTorch's
// subtraction and bid_value_fuse_kernel do: it equals that three-launch
// chain bit for bit (chip_smoke.py holds it to the chain on every call).
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


// dist(cand, U) from the centered statistics: dol_bid_scores_kernel's
// epilogue with each rounding written out.
__device__ __forceinline__ float bid_distance(float a, float b, float cross,
                                              float p_psi, float s_psi,
                                              float p_d, float s_d, float u) {
  const float s = __fadd_rn(a, b);
  const float sp = fmaxf(s, 1.0f);
  const float delta = __fadd_rn(__fdiv_rn(s, sp), -1.0f);
  // (a^2 P_psi + 2ab cross + b^2 P_d) / sp^2
  const float core_num = __fmaf_rn(
      __fmul_rn(b, b), p_d,
      __fmaf_rn(cross, __fmul_rn(__fadd_rn(a, a), b),
                __fmul_rn(__fmul_rn(a, a), p_psi)));
  const float core = __fdiv_rn(core_num, __fmul_rn(sp, sp));
  // 2u delta (a S_psi + b S_d) / sp
  const float lin = __fdiv_rn(
      __fmul_rn(__fmul_rn(__fadd_rn(u, u), delta),
                __fmaf_rn(a, s_psi, __fmul_rn(b, s_d))),
      sp);
  // (1/u) (u delta)^2, as ud * ((1/u) ud) + (core + lin)
  const float ud = __fmul_rn(u, delta);
  const float sum = __fmaf_rn(ud, __fmul_rn(__frcp_rn(u), ud),
                              __fadd_rn(core, lin));
  return __fsqrt_rn(fmaxf(sum, 0.f));
}

// The class count with a register-row instance.
constexpr int kStaticC = 10;

// The planner's value-less runs take kValue = false; kC = 0 is runtime C.
template <int kC, bool kValue>
__global__ void __launch_bounds__(256)
bid_fused_kernel(const float* __restrict__ dol,
                 const float* __restrict__ chain,
                 const float* __restrict__ dsi,
                 const float* __restrict__ size,
                 const float* __restrict__ iid,
                 const float* __restrict__ value, float w,
                 float* __restrict__ out, int M, int N, int C_rt) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int m = blockIdx.y * blockDim.y + threadIdx.y;
  const int C = kC > 0 ? kC : C_rt;
  const float u = __frcp_rn(static_cast<float>(C));
  // Runtime C: the block's client rows, centered, staged by coalesced loads
  // (a lane's own row, C floats apart from its neighbour's, would touch 32
  // cache lines per load); an odd row stride keeps the lanes' reads apart
  // in the banks.
  extern __shared__ float d_rows[];
  const int stride = C | 1;
  if constexpr (kC == 0) {
    const int n0 = blockIdx.x * blockDim.x;
    const int rows = min(static_cast<int>(blockDim.x), N - n0);
    const float* src = dsi + static_cast<size_t>(n0) * C;
    for (int i = threadIdx.y * blockDim.x + threadIdx.x; i < rows * C;
         i += blockDim.x * blockDim.y) {
      const int r = i / C;
      d_rows[r * stride + (i - r * C)] = __fsub_rn(__ldg(src + i), u);
    }
    __syncthreads();
  }
  if (n >= N || m >= M) return;

  // Every load up front.
  const float a = __ldg(chain + m);
  const float b = __ldg(size + n);
  const float iv = __ldg(iid + m);
  const float v = kValue ? __ldg(value + n) : 0.f;
  float dist;
  if constexpr (kC > 0) {
    const float* xrow = dol + static_cast<size_t>(m) * kC;
    const float* yrow = dsi + static_cast<size_t>(n) * kC;
    float x[kC], y[kC];
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      x[c] = __ldg(xrow + c);
      y[c] = __ldg(yrow + c);
    }
    float p_psi = 0.f, s_psi = 0.f, p_d = 0.f, s_d = 0.f, cross = 0.f;
#pragma unroll
    for (int c = 0; c < kC; ++c) {
      const float xc = __fsub_rn(x[c], u);
      const float yc = __fsub_rn(y[c], u);
      p_psi = __fmaf_rn(xc, xc, p_psi);
      s_psi = __fadd_rn(s_psi, xc);
      p_d = __fmaf_rn(yc, yc, p_d);
      s_d = __fadd_rn(s_d, yc);
      cross = __fmaf_rn(xc, yc, cross);
    }
    dist = bid_distance(a, b, cross, p_psi, s_psi, p_d, s_d, u);
  } else {
    const float* xrow = dol + static_cast<size_t>(m) * C;
    const float* yrow = d_rows + threadIdx.x * stride;
    float p_psi = 0.f, s_psi = 0.f, p_d = 0.f, s_d = 0.f, cross = 0.f;
#pragma unroll 4
    for (int c = 0; c < C; ++c) {
      const float xc = __fsub_rn(__ldg(xrow + c), u);
      const float yc = yrow[c];
      p_psi = __fmaf_rn(xc, xc, p_psi);
      s_psi = __fadd_rn(s_psi, xc);
      p_d = __fmaf_rn(yc, yc, p_d);
      s_d = __fadd_rn(s_d, yc);
      cross = __fmaf_rn(xc, yc, cross);
    }
    dist = bid_distance(a, b, cross, p_psi, s_psi, p_d, s_d, u);
  }
  // The subtraction, then bid_value_fuse_kernel's three roundings.
  float bid = __fsub_rn(iv, dist);
  if (kValue) bid = __fmul_rn(bid, __fadd_rn(1.0f, __fmul_rn(w, v)));
  out[static_cast<size_t>(m) * N + n] = bid;
}

template <int kC>
cudaError_t launch_bid_fused(const float* dol, const float* chain,
                             const float* dsi, const float* size,
                             const float* iid, const float* value, float w,
                             float* out, int M, int N, int C,
                             cudaStream_t stream) {
  // Lanes along clients (up to a warp), then warps along models, at most
  // 256 threads: one block holds (8, 8) and (20, 20) is three.
  int bx = 1;
  while (bx < N && bx < 32) bx *= 2;
  const int by = M < 256 / bx ? M : 256 / bx;
  const dim3 block(static_cast<unsigned>(bx), static_cast<unsigned>(by));
  const long long gy = (M + by - 1) / by;
  if (gy > 65535) return cudaErrorInvalidConfiguration;
  const dim3 grid(static_cast<unsigned>((N + bx - 1) / bx),
                  static_cast<unsigned>(gy));
  const size_t smem = kC > 0 ? 0 : sizeof(float) * bx * (C | 1);
  auto kernel = value != nullptr ? bid_fused_kernel<kC, true>
                                 : bid_fused_kernel<kC, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, block, smem, stream>>>(dol, chain, dsi, size, iid, value, w,
                                        out, M, N, C);
  return cudaGetLastError();
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

// iid (M,), dol (M, C), chain (M,), dsi (N, C), size (N,), value (N,) or
// null (no learning value: w unused), out (M, N): fp32, contiguous, on the
// current device.  Returns cudaGetLastError() after the launch (0 on
// success).
extern "C" int repro_bid_fused_f32(const float* iid, const float* dol,
                                   const float* chain, const float* dsi,
                                   const float* size, const float* value,
                                   float w, float* out, int M, int N, int C,
                                   cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaSuccess);
  if (C <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t err =
      C == kStaticC
          ? launch_bid_fused<kStaticC>(dol, chain, dsi, size, iid, value, w,
                                       out, M, N, C, stream)
          : launch_bid_fused<0>(dol, chain, dsi, size, iid, value, w, out, M,
                                N, C, stream);
  return static_cast<int>(err);
}
