// mix_aggregate: the Eq.-10/11 weighted reduction of the FL data plane,
//   out[g, f] = sum_c w[g, c] * x[c, f]      x (C, F), w (G, C), out (G, F), fp32
// over the flattened client-stacked fleet (repro_torch.kernels.diffusion
// .stack_ravel).  Eq.-11 aggregation is G = 1 (every round of every
// strategy); a MixOp is G = C.
//
// Replaces the TPU kernel repro/kernels/diffusion.py::_mix_kernel (the
// pallas_call in mix_aggregate_pallas), which streamed (BC, BF) client tiles
// through VMEM into a revolving (G, BF) output block on the MXU.
//
// What bounds it on the H100: memory.  At G = 1 it is a GEMV down the client
// axis over a long feature axis: C*F*4 bytes read for 2*C*F flops, about
// 0.5 flop per byte against the card's ~20 flop/byte fp32 ridge.
//
// Design: a block owns 32 consecutive feature columns and GT output rows.
// Its 8 warps split the client axis (warp k takes rows k, k+8, ...) and
// each lane owns one column, so a warp reads 128 contiguous bytes per row
// (one coalesced transaction) and many independent rows are in flight per
// SM.  Lanes accumulate in fp32 registers with fmaf; w[g, c] is the same
// address for the whole warp (a broadcast through L1).  The 8 per-warp
// partials meet in shared memory and one pass sums them and writes
// coalesced rows of out.  No cross-block carry: the whole client axis lives
// inside the block.  Each x element is read once per GT-row tile, i.e. once
// in all at G <= GT.  Loads are 4 bytes a lane: the main path's F (26122,
// 22554) is not a multiple of 4, so 16-byte loads would not stay aligned
// across rows.  w is read through L1 rather than staged in shared memory.
// Neither choice has been measured against the alternative.
#include <cuda_runtime.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kCols = 32;

template <int GT>
__global__ void __launch_bounds__(kThreads)
mix_aggregate_kernel(const float* __restrict__ x, const float* __restrict__ w,
                     float* __restrict__ out, int C, int F, int G) {
  __shared__ float part[kWarps][GT][kCols];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g0 = blockIdx.y * GT;
  const long long f = static_cast<long long>(blockIdx.x) * kCols + lane;

  float acc[GT];
#pragma unroll
  for (int g = 0; g < GT; ++g) acc[g] = 0.f;

  if (f < F) {
    const float* xp = x + static_cast<size_t>(warp) * F + f;
    const size_t stride = static_cast<size_t>(kWarps) * F;
#pragma unroll 4
    for (int c = warp; c < C; c += kWarps, xp += stride) {
      const float xv = __ldg(xp);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        // Rows past G read row G-1 (a valid address); they are never stored.
        const int gr = min(g0 + g, G - 1);
        acc[g] = fmaf(__ldg(w + static_cast<size_t>(gr) * C + c), xv, acc[g]);
      }
    }
  }

#pragma unroll
  for (int g = 0; g < GT; ++g) part[warp][g][lane] = acc[g];
  __syncthreads();

  for (int i = threadIdx.x; i < GT * kCols; i += kThreads) {
    const int g = i / kCols;
    const int col = i % kCols;
    const long long fc = static_cast<long long>(blockIdx.x) * kCols + col;
    if (g0 + g < G && fc < F) {
      float s = part[0][g][col];
#pragma unroll
      for (int k = 1; k < kWarps; ++k) s += part[k][g][col];
      out[static_cast<size_t>(g0 + g) * F + fc] = s;
    }
  }
}

template <int GT>
void launch(const float* x, const float* w, float* out, int C, int F, int G,
            cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>((F + kCols - 1) / kCols),
                  static_cast<unsigned>((G + GT - 1) / GT));
  mix_aggregate_kernel<GT><<<grid, kThreads, 0, stream>>>(x, w, out, C, F, G);
}

}  // namespace

// x (C, F), w (G, C), out (G, F): fp32, contiguous, on the current device.
// Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_mix_aggregate_f32(const float* x, const float* w,
                                       float* out, int C, int F, int G,
                                       cudaStream_t stream) {
  if (C <= 0 || F <= 0 || G <= 0) return static_cast<int>(cudaSuccess);
  if (G == 1) launch<1>(x, w, out, C, F, G, stream);
  else launch<8>(x, w, out, C, F, G, stream);
  return static_cast<int>(cudaGetLastError());
}
