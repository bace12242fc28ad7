// quant_pack / quant_unpack: the int8 absmax wire format of the adapter hops.
//
//   pack   x (R, B) fp32 -> q (R, B) int8, scale (R,) fp32, per row:
//          scale = max(absmax, 1e-12) * f32(1/127)
//          q     = clip(round_half_even(x / scale), -127, 127)
//   unpack q (R, B) int8, scale (R,) -> out (R, B) fp32,  out = q * scale
//
// Replaces the TPU kernels repro/kernels/quant.py::_pack_kernel (the
// pallas_call in quant_pack_pallas) and ::_unpack_kernel (quant_unpack_pallas),
// one grid step per (1, B) row tile in VMEM.
//
// What bounds them on the H100: memory.  Pack reads 4 bytes and writes 1 per
// element (plus 4 bytes of scale per row), unpack reads 1 and writes 4; a few
// operations per element against 3.35 TB/s.  At the hop plane's sizes
// ((56, 512) for the LoRA adapter at N = 8) the launch alone.
//
// Rounding, so that both equal the reference bit for bit: the scale is a
// multiply by the float32 reciprocal 0x1.020408p-7f, never a division by 127;
// the quotient is the IEEE division __fdiv_rn (no fast-math); rintf rounds
// half to even like jnp.round; __fmul_rn keeps nvcc from contracting the
// unpack into anything else.  fmaxf drops NaNs from the absmax (the reference
// would propagate them); the hop payload is finite.
//
// Design.  Pack: one block per row.  Sweep 1 reads the row (16-byte loads
// when B % 4 == 0 and the row is 16-byte aligned) and takes |x|'s maximum:
// per-thread, then a warp shuffle, then the warps' maxima through shared
// memory.  Sweep 2 reads the row again (a 2 KB row is still in L1) and
// writes the codes, four at a time as a char4 on the vector path.  Unpack:
// a grid-stride elementwise pass, four elements per thread-step as char4 ->
// float4 on the vector path, one scale read per step.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPackThreads = 128;
constexpr int kUnpackThreads = 256;
constexpr float kInv127 = 0x1.020408p-7f;   // float32(1 / 127)
constexpr float kEps = 1e-12f;              // absmax floor: zero rows -> 0

__device__ __forceinline__ signed char encode(float x, float scale) {
  const float r = rintf(__fdiv_rn(x, scale));
  return static_cast<signed char>(fminf(fmaxf(r, -127.0f), 127.0f));
}

template <bool kVec>
__global__ void __launch_bounds__(kPackThreads)
quant_pack_kernel(const float* __restrict__ x, signed char* __restrict__ q,
                  float* __restrict__ scale, int B) {
  const long long row = blockIdx.x;
  const float* xr = x + row * B;
  signed char* qr = q + row * B;

  float m = 0.0f;
  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    for (int i = threadIdx.x; i < B / 4; i += kPackThreads) {
      const float4 v = __ldg(x4 + i);
      m = fmaxf(m, fmaxf(fmaxf(fabsf(v.x), fabsf(v.y)),
                         fmaxf(fabsf(v.z), fabsf(v.w))));
    }
  } else {
    for (int i = threadIdx.x; i < B; i += kPackThreads)
      m = fmaxf(m, fabsf(__ldg(xr + i)));
  }
  for (int off = 16; off > 0; off >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  __shared__ float warp_max[kPackThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_max[threadIdx.x >> 5] = m;
  __syncthreads();
  m = warp_max[0];
#pragma unroll
  for (int w = 1; w < kPackThreads / 32; ++w) m = fmaxf(m, warp_max[w]);

  const float s = __fmul_rn(fmaxf(m, kEps), kInv127);
  if (threadIdx.x == 0) scale[row] = s;

  if (kVec) {
    const float4* x4 = reinterpret_cast<const float4*>(xr);
    char4* q4 = reinterpret_cast<char4*>(qr);
    for (int i = threadIdx.x; i < B / 4; i += kPackThreads) {
      const float4 v = __ldg(x4 + i);
      q4[i] = make_char4(encode(v.x, s), encode(v.y, s), encode(v.z, s),
                         encode(v.w, s));
    }
  } else {
    for (int i = threadIdx.x; i < B; i += kPackThreads)
      qr[i] = encode(__ldg(xr + i), s);
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kUnpackThreads)
quant_unpack_kernel(const signed char* __restrict__ q,
                    const float* __restrict__ scale, float* __restrict__ out,
                    long long total, int B) {
  const long long stride = static_cast<long long>(gridDim.x) * kUnpackThreads;
  long long i = static_cast<long long>(blockIdx.x) * kUnpackThreads +
                threadIdx.x;
  if (kVec) {
    // B % 4 == 0: the four elements of a char4 share one row.
    const char4* q4 = reinterpret_cast<const char4*>(q);
    float4* o4 = reinterpret_cast<float4*>(out);
    for (; i < total / 4; i += stride) {
      const char4 c = q4[i];
      const float s = __ldg(scale + (i * 4) / B);
      o4[i] = make_float4(__fmul_rn(static_cast<float>(c.x), s),
                          __fmul_rn(static_cast<float>(c.y), s),
                          __fmul_rn(static_cast<float>(c.z), s),
                          __fmul_rn(static_cast<float>(c.w), s));
    }
  } else {
    for (; i < total; i += stride)
      out[i] = __fmul_rn(static_cast<float>(q[i]), __ldg(scale + i / B));
  }
}

bool aligned(const void* p, uintptr_t bytes) {
  return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

}  // namespace

// x (R, B) fp32, q (R, B) int8, scale (R,) fp32: contiguous, on the current
// device.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_quant_pack_f32(const float* x, signed char* q,
                                    float* scale, int R, int B,
                                    cudaStream_t stream) {
  if (R <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  const bool vec = B % 4 == 0 && aligned(x, 16) && aligned(q, 4);
  if (vec)
    quant_pack_kernel<true><<<R, kPackThreads, 0, stream>>>(x, q, scale, B);
  else
    quant_pack_kernel<false><<<R, kPackThreads, 0, stream>>>(x, q, scale, B);
  return static_cast<int>(cudaGetLastError());
}

// q (R, B) int8, scale (R,) fp32, out (R, B) fp32: contiguous, on the current
// device.  Returns cudaGetLastError() after the launch (0 on success).
extern "C" int repro_quant_unpack_f32(const signed char* q, const float* scale,
                                      float* out, int R, int B,
                                      cudaStream_t stream) {
  if (R <= 0 || B <= 0) return static_cast<int>(cudaSuccess);
  const long long total = static_cast<long long>(R) * B;
  const bool vec = B % 4 == 0 && aligned(q, 4) && aligned(out, 16);
  const long long work = vec ? total / 4 : total;
  long long blocks = (work + kUnpackThreads - 1) / kUnpackThreads;
  if (blocks > 132LL * 16) blocks = 132LL * 16;   // 16 blocks per SM, strided
  if (vec)
    quant_unpack_kernel<true><<<static_cast<unsigned>(blocks), kUnpackThreads,
                                0, stream>>>(q, scale, out, total, B);
  else
    quant_unpack_kernel<false><<<static_cast<unsigned>(blocks), kUnpackThreads,
                                 0, stream>>>(q, scale, out, total, B);
  return static_cast<int>(cudaGetLastError());
}
