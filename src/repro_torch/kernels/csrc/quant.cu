// quant_pack / quant_unpack: the int8 absmax wire format of the adapter hops,
// and quant_roundtrip: both of them, and the hop's row move, in one launch.
//
//   pack   x (R, B) fp32 -> q (R, B) int8, scale (R,) fp32, per row:
//          scale = max(absmax, 1e-12) * f32(1/127)
//          q     = clip(round_half_even(x / scale), -127, 127)
//   unpack q (R, B) int8, scale (R,) -> out (R, B) fp32,  out = q * scale
//   roundtrip  C rows, each the concatenation of its L leaves (F elements,
//          cut into ceil(F/512) blocks, the last one zero-padded):
//          out row c = unpack(pack(input row src_of_dst[c])) per block,
//          written into fresh leaves of the same shapes; the codes (C, Fp)
//          and scales (C, ceil(F/512)) too when the caller asks for them.
//
// Replaces the TPU kernels repro/kernels/quant.py::_pack_kernel (the
// pallas_call in quant_pack_pallas) and ::_unpack_kernel (quant_unpack_pallas),
// one grid step per (1, B) row tile in VMEM.  quant_roundtrip is the Hopper
// design of the pair as the hop plane runs it (repro/fl/adapters.py::
// quant_roundtrip_rows, then the PermuteOp's row gather): nothing between
// pack and unpack reads the codes, so they stay in registers.
//
// What bounds them on the H100: memory.  Pack reads 4 bytes and writes 1 per
// element (plus 4 bytes of scale per row), unpack reads 1 and writes 4; a few
// operations per element against 3.35 TB/s.  The roundtrip reads 4 and writes
// 4 (plus 1 and 4/512 when codes and scales are asked for).  At the hop
// plane's sizes ((56, 512) for the LoRA adapter at N = 8) the launch alone.
//
// Rounding, so that all three equal the reference bit for bit: the scale is a
// multiply by the float32 reciprocal 0x1.020408p-7f, never a division by 127;
// the quotient is the IEEE division __fdiv_rn (no fast-math); rintf rounds
// half to even like jnp.round; __fmul_rn keeps nvcc from contracting the
// unpack into anything else; the roundtrip decodes from the int8 code, so -0
// and values below half a step come out +0, as in the reference.  fmaxf drops
// NaNs from the absmax (the reference would propagate them); the hop payload
// is finite.
//
// Design.  Pack: one block per row.  Sweep 1 reads the row (16-byte loads
// when B % 4 == 0 and the row is 16-byte aligned) and takes |x|'s maximum:
// per-thread, then a warp shuffle, then the warps' maxima through shared
// memory.  Sweep 2 reads the row again (a 2 KB row is still in L1) and
// writes the codes, four at a time as a char4 on the vector path.  Unpack:
// a grid-stride elementwise pass, four elements per thread-step as char4 ->
// float4 on the vector path, one scale read per step.
// Roundtrip: one warp per 512-element block, 8 warps per 256-thread block,
// one row per grid row (blockIdx.y).  Lane l holds elements 128k + 4l ..
// 128k + 4l + 3 of its block (k = 0..3); the absmax is 5 __shfl_xor_sync
// steps, encode and decode happen in registers, with no shared memory and
// no barrier.  The leaves are read where they lie: a leaf table, passed by
// value as a __grid_constant__ parameter, holds each (row, leaf)'s input
// and output pointer (the input row already permuted by src_of_dst) and
// the leaf offsets of a row.  Each lane finds its four chunks' leaves in
// one warp-uniform pass over the leaf offsets inside its block.  A chunk
// inside one leaf moves as a coalesced float4 where it is 16-byte aligned
// in both rows and as four scalars where not; a chunk across a leaf edge or
// the row's end moves element by element, walking the offsets (the fcn
// leaves straddle blocks at offsets 128, 8320, 8448, 24832 and 24842, the
// last not a multiple of 4).  Elements past F are neither read nor written
// (0 in the absmax, code 0).  A value under a quarter of its block's scale
// (zeros, the padding, subnormals) encodes to 0 without the division:
// __fdiv_rn's slow path, which those take, cost more on an H100 than the
// rest of the kernel (PERF.md §6).  Inputs are
// read-only and outputs never alias them (host-plane slots may alias one
// another).  Two table sizes: up to 200 entries in 3.3 KB of parameters,
// which holds every table the FL runs hop, and up to 1920 in 31 KB (CUDA
// 12.1 and sm_70 or later take 32,764 bytes).  Inside a CUDA graph a
// launch costs the same at either size; launched eagerly, as the FL runs
// launch it, the larger block of parameters costs more host time.  The
// wrapper launches the same kernel over row groups past 1920 entries.
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

constexpr int kBlock = 512;                 // elements per row-block
constexpr int kRtThreads = 256;             // 8 warps, one block each
constexpr int kRtWarps = kRtThreads / 32;

// One launch's leaf table.  in/out are (row, leaf) row-major; off holds the
// leaves' offsets in a row (off[0] = 0, off[leaves] = f).
template <int kEntries, int kLeaves>
struct RoundtripTable {
  const float* in[kEntries];
  float* out[kEntries];
  int off[kLeaves + 1];
  int leaves, f, nb;
  signed char* codes;     // (rows, nb * 512) int8, or nullptr
  float* scales;          // (rows, nb), or nullptr
};
constexpr int kSmallEntries = 200, kSmallLeaves = 32;
constexpr int kLargeEntries = 1920, kLargeLeaves = 256;
static_assert(sizeof(RoundtripTable<kSmallEntries, kSmallLeaves>) <= 4096,
              "the small table fits the classic 4 KB of parameters");
static_assert(sizeof(RoundtripTable<kLargeEntries, kLargeLeaves>) <= 32764,
              "the large table fits 32,764 bytes of parameters");

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// encode() for the roundtrip: |x| < scale / 4 gives q = 0 without the
// division (its true quotient is under 1/4, so the rounded one rounds to
// 0, as in the reference).  Zeros, the padding past F and subnormals land
// here; __fdiv_rn takes a slow path for them that cost the kernel more
// than its whole fast path.  0.25f * scale is exact (scale >= 1e-12/127).
__device__ __forceinline__ signed char encode_rt(float x, float scale) {
  return fabsf(x) < 0.25f * scale ? static_cast<signed char>(0)
                                  : encode(x, scale);
}

template <int kEntries, int kLeaves>
__global__ void __launch_bounds__(kRtThreads)
quant_roundtrip_kernel(const __grid_constant__
                       RoundtripTable<kEntries, kLeaves> t) {
  const int row = blockIdx.y;
  const int leaves = t.leaves;
  const int* off = t.off;
  const float* const* in = t.in + row * leaves;
  float* const* out = t.out + row * leaves;
  const int lane = threadIdx.x & 31;
  const int blk = blockIdx.x * kRtWarps + (threadIdx.x >> 5);
  if (blk >= t.nb) return;                               // whole warps
  const int f = t.f;
  const int e0 = blk * kBlock;
  const int end = min(e0 + kBlock, f);
  // The leaf holding e0: the last leaf whose offset is <= e0 (it is not
  // empty, since the next offset is larger).  Warp-uniform.
  int lo = 0, hi = leaves - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (off[mid] <= e0) lo = mid; else hi = mid - 1;
  }
  // Lane l's chunk k holds elements p .. p + 3, p = e0 + 128k + 4l.  Its
  // leaf is lo plus the leaf offsets inside the block that are <= p: one
  // warp-uniform pass over those few offsets (empty leaves count twice and
  // are skipped).
  int lk[4] = {lo, lo, lo, lo};
  for (int j = lo + 1; j < leaves && off[j] < end; ++j) {
    const int b = off[j];
#pragma unroll
    for (int k = 0; k < 4; ++k) lk[k] += b <= e0 + 128 * k + 4 * lane;
  }

  // A chunk inside one leaf moves as one float4 each way where it is
  // 16-byte aligned in both rows, as four scalars where not (a misaligned
  // leaf); a chunk across a leaf edge or the row's end element by element,
  // each element's leaf found by walking the offsets forward.  Elements
  // past F read as 0.
  float v[16];
  bool inside[4], vec[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = e0 + 128 * k + 4 * lane;
    const int l = lk[k];
    const float* a = in[l] + (p - off[l]);
    inside[k] = p + 4 <= off[l + 1];
    vec[k] = inside[k] && aligned16(a) && aligned16(out[l] + (p - off[l]));
    if (vec[k]) {
      const float4 c = __ldg(reinterpret_cast<const float4*>(a));
      v[4 * k] = c.x; v[4 * k + 1] = c.y; v[4 * k + 2] = c.z;
      v[4 * k + 3] = c.w;
    } else if (inside[k]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) v[4 * k + j] = __ldg(a + j);
    } else {
      int lj = l;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float x = 0.0f;
        if (p + j < f) {
          while (off[lj + 1] <= p + j) ++lj;
          x = __ldg(in[lj] + (p + j - off[lj]));
        }
        v[4 * k + j] = x;
      }
    }
  }

  float m = 0.0f;
#pragma unroll
  for (int i = 0; i < 16; ++i) m = fmaxf(m, fabsf(v[i]));
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
  const float s = __fmul_rn(fmaxf(m, kEps), kInv127);

  signed char q[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    q[i] = encode_rt(v[i], s);
    v[i] = __fmul_rn(static_cast<float>(q[i]), s);
  }
  if (t.codes != nullptr) {
    char4* c4 = reinterpret_cast<char4*>(
        t.codes + static_cast<long long>(row) * t.nb * kBlock + e0);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      c4[32 * k + lane] = make_char4(q[4 * k], q[4 * k + 1], q[4 * k + 2],
                                     q[4 * k + 3]);
  }
  if (t.scales != nullptr && lane == 0)
    t.scales[static_cast<long long>(row) * t.nb + blk] = s;

#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int p = e0 + 128 * k + 4 * lane;
    const int l = lk[k];
    float* a = out[l] + (p - off[l]);
    if (vec[k]) {
      *reinterpret_cast<float4*>(a) =
          make_float4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
    } else if (inside[k]) {
#pragma unroll
      for (int j = 0; j < 4; ++j) a[j] = v[4 * k + j];
    } else {
      int lj = l;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (p + j < f) {
          while (off[lj + 1] <= p + j) ++lj;
          out[lj][p + j - off[lj]] = v[4 * k + j];
        }
      }
    }
  }
}

template <int kEntries, int kLeaves>
int launch_roundtrip(const float* const* in, float* const* out,
                     const int* off, int rows, int leaves, signed char* codes,
                     float* scales, cudaStream_t stream) {
  RoundtripTable<kEntries, kLeaves> t;
  for (int i = 0; i < rows * leaves; ++i) {
    t.in[i] = in[i];
    t.out[i] = out[i];
  }
  for (int l = 0; l <= leaves; ++l) t.off[l] = off[l];
  t.leaves = leaves;
  t.f = off[leaves];
  t.nb = (t.f + kBlock - 1) / kBlock;
  t.codes = codes;
  t.scales = scales;
  const dim3 grid((t.nb + kRtWarps - 1) / kRtWarps, rows);
  quant_roundtrip_kernel<kEntries, kLeaves>
      <<<grid, kRtThreads, 0, stream>>>(t);
  return static_cast<int>(cudaGetLastError());
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

// The most (row, leaf) entries and leaves one quant_roundtrip launch takes;
// the wrapper launches over row groups of at most
// repro_quant_roundtrip_max_entries() / leaves rows.
extern "C" int repro_quant_roundtrip_max_entries() { return kLargeEntries; }
extern "C" int repro_quant_roundtrip_max_leaves() { return kLargeLeaves; }

// in / out: rows * leaves pointers, (row, leaf) row-major, in[] already
// holding the input row each output row reads; fp32, on the current device,
// each leaf contiguous.  off: leaves + 1 host ints, off[0] = 0,
// non-decreasing, off[leaves] = F >= 1.  codes (rows, ceil(F/512) * 512)
// int8 and scales (rows, ceil(F/512)) fp32 are written when not null.
// Returns cudaGetLastError() after the launch (0 on success), or
// cudaErrorInvalidValue for sizes the tables do not take.
extern "C" int repro_quant_roundtrip_f32(const float* const* in,
                                         float* const* out, const int* off,
                                         int rows, int leaves,
                                         signed char* codes, float* scales,
                                         cudaStream_t stream) {
  if (rows <= 0 || rows > 65535 || leaves <= 0 || off[0] != 0 ||
      off[leaves] <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int l = 0; l < leaves; ++l)
    if (off[l + 1] < off[l]) return static_cast<int>(cudaErrorInvalidValue);
  if (rows * leaves <= kSmallEntries && leaves <= kSmallLeaves)
    return launch_roundtrip<kSmallEntries, kSmallLeaves>(
        in, out, off, rows, leaves, codes, scales, stream);
  if (static_cast<long long>(rows) * leaves <= kLargeEntries &&
      leaves <= kLargeLeaves)
    return launch_roundtrip<kLargeEntries, kLargeLeaves>(
        in, out, off, rows, leaves, codes, scales, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
