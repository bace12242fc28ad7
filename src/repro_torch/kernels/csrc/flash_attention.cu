// flash_attention: causal / sliding-window online-softmax attention.
//
//   q (B, Sq, H, D), k/v (B, Sk, H, D), bf16 or fp32 (one type for all
//   three) -> o (B, Sq, H, D) in that type.  Heads are pre-repeated for GQA
//   by the caller.  Query i sits at position i + Sk - Sq (right-aligned to
//   the end of the keys); key j is visible to it when j <= q_pos (causal)
//   and j > q_pos - window (window > 0).  Softmax in fp32 with scale
//   1/sqrt(D) unless given; a row that sees no key returns 0.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py::_attn_kernel
// (the pallas_call in flash_attention_pallas): a (batch*heads, q-block,
// kv-block) grid whose kv axis runs in order, carrying the fp32 (m, l, acc)
// state in VMEM scratch and skipping kv blocks that the mask hides.
//
// What bounds it on the H100: operations.  4*D flops per visible (q, k)
// pair against a few bytes per element of q, k, v and o; at the zoo's
// prefill shapes (S = 4096) that is hundreds of flops per byte.
//
// Two kernels, one per input type.  bf16 runs on the tensor cores with
// mma.sync, for D in {64, 80, 128} (every call the zoo makes) and 16-byte
// aligned k/v (flash_attention_mma_kernel, below); any other bf16 head dim
// or alignment is refused.  wgmma and TMA come later.  fp32 (D % 4 == 0,
// D <= 128) runs as fp32 FMAs on the CUDA cores (flash_attention_kernel):
//
// One block per (64-query tile, b*h); the heaviest (last) causal tiles are
// scheduled first.  Four threads share a query row: each keeps a quarter of
// the head dim of q and of the fp32 accumulator in registers (float4 groups
// g = sub + 4j), so a row's score is four partial dots joined by two warp
// shuffles.  K and V tiles of 32 keys are staged through shared memory; the
// 8 rows of a warp read the same float4s (broadcast).  Only tiles between
// the block's first and last visible key are loaded, so wholly masked tiles
// are skipped.  Per tile: 32 scores in registers, one max, one rescale of
// (l, acc) by exp(m_old - m_new), then p = exp(s - m) accumulated against
// V.  The -1e30 sentinel and the guards on fully masked rows follow the
// reference's _attn_kernel, in both kernels.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;                 // query rows per block
constexpr int kTPR = 4;                 // threads per query row
constexpr int kThreads = kBQ * kTPR;    // 256
constexpr int kBK = 32;                 // keys per shared-memory tile
constexpr int kDMax = 128;              // largest head dim
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// kG4: float4 groups of the head dim per thread, ceil(D / 16).
template <int kG4>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o,
                       int H,
                       int Sq, int Sk, int D, float scale, int causal,
                       int window) {
  __shared__ __align__(16) float k_s[kBK][kDMax];
  __shared__ __align__(16) float v_s[kBK][kDMax];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;
  const int row = threadIdx.x / kTPR;
  const int sub = threadIdx.x % kTPR;
  const int i = q0 + row;
  const bool valid_q = i < Sq;
  const int shift = Sk - Sq;
  const int q_pos = i + shift;
  const int d4 = D / 4;
  const long long row_stride = (long long)H * D;

  float4 qr[kG4], acc[kG4];
  const float* qrow =
      q + ((long long)b * Sq + i) * row_stride + (long long)h * D;
#pragma unroll
  for (int j = 0; j < kG4; ++j) {
    const int g = sub + kTPR * j;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (valid_q && g < d4) {
      x = make_float4(qrow[4 * g], qrow[4 * g + 1], qrow[4 * g + 2],
                      qrow[4 * g + 3]);
    }
    qr[j] = x;
    acc[j] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  float m = kNegInf, l = 0.f;

  // The keys this block can see (block-uniform): tiles outside are skipped.
  const int last_q = min(q0 + kBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, last_q + shift + 1) : Sk;
  int k_lo = window > 0 ? max(0, q0 + shift - window + 1) : 0;
  k_lo = k_lo / kBK * kBK;

  for (int kt = k_lo; kt < k_hi; kt += kBK) {
    __syncthreads();
    for (int e = threadIdx.x; e < kBK * D; e += kThreads) {
      const int r = e / D;
      const int c = e - r * D;
      const int kp = kt + r;
      float kv = 0.f, vv = 0.f;
      if (kp < Sk) {
        const long long off = ((long long)b * Sk + kp) * row_stride
                              + (long long)h * D + c;
        kv = k[off];
        vv = v[off];
      }
      k_s[r][c] = kv;
      v_s[r][c] = vv;
    }
    __syncthreads();

    float s[kBK];
    float m_cur = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      const float4* krow = reinterpret_cast<const float4*>(k_s[jj]);
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < kG4; ++j) {
        const int g = sub + kTPR * j;
        if (g < d4) part += dot4(qr[j], krow[g]);
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      part += __shfl_xor_sync(0xffffffffu, part, 2);
      const int kp = kt + jj;
      const bool vis = valid_q && kp < Sk && (!causal || kp <= q_pos)
                       && (window <= 0 || kp > q_pos - window);
      s[jj] = vis ? part * scale : kNegInf;
      m_cur = fmaxf(m_cur, s[jj]);
    }
    const float m_new = fmaxf(m, m_cur);
    const float safe_m = m_new <= 0.5f * kNegInf ? 0.f : m_new;
    const float alpha = m <= 0.5f * kNegInf ? 0.f : expf(m - safe_m);
    l *= alpha;
#pragma unroll
    for (int j = 0; j < kG4; ++j) {
      acc[j].x *= alpha; acc[j].y *= alpha;
      acc[j].z *= alpha; acc[j].w *= alpha;
    }
#pragma unroll
    for (int jj = 0; jj < kBK; ++jj) {
      const float p = s[jj] <= 0.5f * kNegInf ? 0.f : expf(s[jj] - safe_m);
      l += p;
      const float4* vrow = reinterpret_cast<const float4*>(v_s[jj]);
#pragma unroll
      for (int j = 0; j < kG4; ++j) {
        const int g = sub + kTPR * j;
        if (g < d4) {
          const float4 x = vrow[g];
          acc[j].x += p * x.x; acc[j].y += p * x.y;
          acc[j].z += p * x.z; acc[j].w += p * x.w;
        }
      }
    }
    m = m_new;
  }

  if (!valid_q) return;
  const float inv = 1.f / fmaxf(l, 1e-20f);
  float* orow = o + ((long long)b * Sq + i) * row_stride + (long long)h * D;
#pragma unroll
  for (int j = 0; j < kG4; ++j) {
    const int g = sub + kTPR * j;
    if (g < d4) {
      orow[4 * g] = acc[j].x * inv;
      orow[4 * g + 1] = acc[j].y * inv;
      orow[4 * g + 2] = acc[j].z * inv;
      orow[4 * g + 3] = acc[j].w * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// Tensor-core path: bf16 inputs with D in {64, 80, 128} (the zoo's).
//
// One block per (64-query tile, b*h), four warps of 16 query rows each.  A
// warp keeps its rows' Q as mma A-fragments and its fp32 score tile, output
// accumulator and (m, l) in registers, and runs mma.sync m16n8k16 (bf16 in,
// fp32 accumulate): S = Q K^T over 64-key tiles, then O += P V with P
// rounded to bf16 (as the reference's XLA path rounds p to v's dtype).  The
// accumulator layout of m16n8 is fixed by the PTX ISA: lane l holds rows
// g = l/4 and g + 8, columns 2(l%4) and 2(l%4) + 1 of each 8-wide tile, so
// the online-softmax rescale is per register, row maxima are two shuffles
// over the lane quad, and the score accumulators repack directly into the
// A-fragments of the P V product.  K and V tiles are staged in shared
// memory with rows padded by 8 bf16 (no bank conflicts on either operand's
// fragment loads).  A warp whose rows see none of a tile's keys skips it.
constexpr int kMmaWarps = 4;
constexpr int kMmaThreads = kMmaWarps * 32;
constexpr int kMmaBQ = kMmaWarps * 16;     // 64 query rows per block
constexpr int kMmaBK = 64;                 // keys per tile

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  __nv_bfloat162 v;
  v.x = lo;
  v.y = hi;
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// kD: head dim (a multiple of 16, at most 128).
template <int kD>
__global__ void __launch_bounds__(kMmaThreads)
flash_attention_mma_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           __nv_bfloat16* __restrict__ o, int H, int Sq,
                           int Sk, float scale, int causal, int window) {
  constexpr int kPitch = kD + 8;           // bf16 per staged row
  constexpr int kKS = kD / 16;             // k-steps of Q K^T
  constexpr int kNT = kD / 8;              // 8-wide output tiles
  constexpr int kST = kMmaBK / 8;          // 8-wide score tiles
  __shared__ __align__(16) __nv_bfloat16 k_s[kMmaBK * kPitch];
  __shared__ __align__(16) __nv_bfloat16 v_s[kMmaBK * kPitch];

  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kMmaBQ;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int shift = Sk - Sq;
  const long long row_stride = (long long)H * kD;
  const int r0 = q0 + warp * 16 + g;       // this lane's two query rows
  const int r1 = r0 + 8;
  const int pos0 = r0 + shift, pos1 = r1 + shift;

  // Q A-fragments: rows r0 / r1, columns 16ks + 2t (+1) and + 8 (+1).
  uint32_t qa[kKS][4];
  {
    const __nv_bfloat16 zero = __float2bfloat16_rn(0.f);
    const __nv_bfloat16* q_r0 =
        q + ((long long)b * Sq + r0) * row_stride + (long long)h * kD;
    const __nv_bfloat16* q_r1 = q_r0 + 8 * row_stride;
#pragma unroll
    for (int ks = 0; ks < kKS; ++ks) {
      const int c = 16 * ks + 2 * t;
      const bool ok0 = r0 < Sq, ok1 = r1 < Sq;
      qa[ks][0] = pack_bf16(ok0 ? q_r0[c] : zero, ok0 ? q_r0[c + 1] : zero);
      qa[ks][1] = pack_bf16(ok1 ? q_r1[c] : zero, ok1 ? q_r1[c + 1] : zero);
      qa[ks][2] = pack_bf16(ok0 ? q_r0[c + 8] : zero,
                            ok0 ? q_r0[c + 9] : zero);
      qa[ks][3] = pack_bf16(ok1 ? q_r1[c + 8] : zero,
                            ok1 ? q_r1[c + 9] : zero);
    }
  }
  float acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;   // l: lane partials

  const int last_q = min(q0 + kMmaBQ, Sq) - 1;
  const int k_hi = causal ? min(Sk, last_q + shift + 1) : Sk;
  int k_lo = window > 0 ? max(0, q0 + shift - window + 1) : 0;
  k_lo = k_lo / kMmaBK * kMmaBK;
  // The rows of this warp, for skipping tiles it cannot see.
  const int w_first = q0 + warp * 16 + shift;
  const int w_last = min(q0 + warp * 16 + 15, Sq - 1) + shift;

  for (int kt = k_lo; kt < k_hi; kt += kMmaBK) {
    __syncthreads();
    // Stage K and V tiles (16-byte copies; rows past Sk are zero).
    constexpr int kVec = kD / 8;
    for (int e = threadIdx.x; e < kMmaBK * kVec; e += kMmaThreads) {
      const int r = e / kVec, c = (e - r * kVec) * 8;
      const int kp = kt + r;
      uint4 kv = make_uint4(0, 0, 0, 0), vv = make_uint4(0, 0, 0, 0);
      if (kp < Sk) {
        const long long off = ((long long)b * Sk + kp) * row_stride
                              + (long long)h * kD + c;
        kv = *reinterpret_cast<const uint4*>(k + off);
        vv = *reinterpret_cast<const uint4*>(v + off);
      }
      *reinterpret_cast<uint4*>(k_s + r * kPitch + c) = kv;
      *reinterpret_cast<uint4*>(v_s + r * kPitch + c) = vv;
    }
    __syncthreads();
    if (w_first >= Sq + shift) continue;   // warp entirely past Sq
    if (causal && kt > w_last) continue;
    if (window > 0 && kt + kMmaBK - 1 <= w_first - window) continue;

    // S = Q K^T for this warp's 16 rows x 64 keys.
    float s[kST][4];
#pragma unroll
    for (int j = 0; j < kST; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      const __nv_bfloat16* krow = k_s + (8 * j + g) * kPitch + 2 * t;
#pragma unroll
      for (int ks = 0; ks < kKS; ++ks) {
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(krow + 16 * ks);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(krow + 16 * ks + 8);
        mma_bf16(s[j], qa[ks], b0, b1);
      }
    }
    // Scale, mask, running max over the lane quad.
    float mc0 = kNegInf, mc1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kST; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kt + 8 * j + 2 * t + (e & 1);
        const int pos = e < 2 ? pos0 : pos1;
        const int row = e < 2 ? r0 : r1;
        const bool vis = row < Sq && kp < Sk && (!causal || kp <= pos)
                         && (window <= 0 || kp > pos - window);
        s[j][e] = vis ? s[j][e] * scale : kNegInf;
      }
      mc0 = fmaxf(mc0, fmaxf(s[j][0], s[j][1]));
      mc1 = fmaxf(mc1, fmaxf(s[j][2], s[j][3]));
    }
    mc0 = fmaxf(mc0, __shfl_xor_sync(0xffffffffu, mc0, 1));
    mc0 = fmaxf(mc0, __shfl_xor_sync(0xffffffffu, mc0, 2));
    mc1 = fmaxf(mc1, __shfl_xor_sync(0xffffffffu, mc1, 1));
    mc1 = fmaxf(mc1, __shfl_xor_sync(0xffffffffu, mc1, 2));
    const float mn0 = fmaxf(m0, mc0), mn1 = fmaxf(m1, mc1);
    const float sm0 = mn0 <= 0.5f * kNegInf ? 0.f : mn0;
    const float sm1 = mn1 <= 0.5f * kNegInf ? 0.f : mn1;
    const float al0 = m0 <= 0.5f * kNegInf ? 0.f : expf(m0 - sm0);
    const float al1 = m1 <= 0.5f * kNegInf ? 0.f : expf(m1 - sm1);
    m0 = mn0;
    m1 = mn1;
    l0 *= al0;
    l1 *= al1;
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      acc[j][0] *= al0; acc[j][1] *= al0;
      acc[j][2] *= al1; acc[j][3] *= al1;
    }
    // P = exp(S - m), packed straight into the A-fragments of P V.
    uint32_t pa[kST / 2][4];
#pragma unroll
    for (int j = 0; j < kST; ++j) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float sm = e < 2 ? sm0 : sm1;
        p[e] = s[j][e] <= 0.5f * kNegInf ? 0.f : expf(s[j][e] - sm);
      }
      l0 += p[0] + p[1];
      l1 += p[2] + p[3];
      pa[j / 2][(j & 1) * 2] = pack_bf16(p[0], p[1]);
      pa[j / 2][(j & 1) * 2 + 1] = pack_bf16(p[2], p[3]);
    }
    // O += P V: B-fragments V[key][d] for keys 16kk + 2t (+1) and + 8 (+1).
#pragma unroll
    for (int kk = 0; kk < kST / 2; ++kk) {
      const __nv_bfloat16* vrow = v_s + (16 * kk + 2 * t) * kPitch + g;
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const __nv_bfloat16* vp = vrow + 8 * j;
        const uint32_t b0 = pack_bf16(vp[0], vp[kPitch]);
        const uint32_t b1 = pack_bf16(vp[8 * kPitch], vp[9 * kPitch]);
        mma_bf16(acc[j], pa[kk], b0, b1);
      }
    }
  }

  // Row sums over the lane quad, then O / l (0 for a row that saw nothing).
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
  __nv_bfloat16* o_r0 =
      o + ((long long)b * Sq + r0) * row_stride + (long long)h * kD + 2 * t;
  __nv_bfloat16* o_r1 = o_r0 + 8 * row_stride;
#pragma unroll
  for (int j = 0; j < kNT; ++j) {
    if (r0 < Sq) {
      o_r0[8 * j] = __float2bfloat16_rn(acc[j][0] * inv0);
      o_r0[8 * j + 1] = __float2bfloat16_rn(acc[j][1] * inv0);
    }
    if (r1 < Sq) {
      o_r1[8 * j] = __float2bfloat16_rn(acc[j][2] * inv1);
      o_r1[8 * j + 1] = __float2bfloat16_rn(acc[j][3] * inv1);
    }
  }
}

template <int kD>
void launch_mma(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Sq, int Sk, float scale, int causal, int window,
                cudaStream_t stream) {
  const dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, B * H);
  flash_attention_mma_kernel<kD><<<grid, kMmaThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      H, Sq, Sk, scale, causal, window);
}

// bf16: the tensor-core kernel for D in {64, 80, 128} and 16-byte aligned
// k/v (its 16-byte K/V tile loads); anything else is cudaErrorInvalidValue.
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int Sq, int Sk, int D, float scale, int causal,
                int window, cudaStream_t stream) {
  const uintptr_t align = reinterpret_cast<uintptr_t>(k)
                          | reinterpret_cast<uintptr_t>(v);
  if (align % 16 != 0) return static_cast<int>(cudaErrorInvalidValue);
  switch (D) {
    case 64: launch_mma<64>(q, k, v, o, B, H, Sq, Sk, scale, causal, window, stream); break;
    case 80: launch_mma<80>(q, k, v, o, B, H, Sq, Sk, scale, causal, window, stream); break;
    case 128: launch_mma<128>(q, k, v, o, B, H, Sq, Sk, scale, causal, window, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

template <int kG4>
void launch(const void* q, const void* k, const void* v, void* o, int B,
            int H, int Sq, int Sk, int D, float scale, int causal, int window,
            cudaStream_t stream) {
  const dim3 grid((Sq + kBQ - 1) / kBQ, B * H);
  flash_attention_kernel<kG4><<<grid, kThreads, 0, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), H, Sq, Sk, D,
      scale, causal, window);
}

// fp32: the CUDA-core kernel for D % 4 == 0, D <= 128.
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int Sq, int Sk, int D, float scale, int causal,
               int window, cudaStream_t stream) {
  switch ((D + 15) / 16) {
    case 1: launch<1>(q, k, v, o, B, H, Sq, Sk, D, scale, causal, window, stream); break;
    case 2: launch<2>(q, k, v, o, B, H, Sq, Sk, D, scale, causal, window, stream); break;
    case 3: launch<3>(q, k, v, o, B, H, Sq, Sk, D, scale, causal, window, stream); break;
    case 4: launch<4>(q, k, v, o, B, H, Sq, Sk, D, scale, causal, window, stream); break;
    case 5: launch<5>(q, k, v, o, B, H, Sq, Sk, D, scale, causal, window, stream); break;
    case 6: launch<6>(q, k, v, o, B, H, Sq, Sk, D, scale, causal, window, stream); break;
    case 7: launch<7>(q, k, v, o, B, H, Sq, Sk, D, scale, causal, window, stream); break;
    case 8: launch<8>(q, k, v, o, B, H, Sq, Sk, D, scale, causal, window, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = fp32 (D % 4 == 0, D <= 128), 1 = bf16 (D in {64, 80, 128},
// k/v 16-byte aligned); window <= 0 means no window; causal is 0 or 1.
// Returns cudaGetLastError() after the launch.
extern "C" int repro_flash_attention(const void* q, const void* k,
                                     const void* v, void* o, int dtype, int B,
                                     int H, int Sq, int Sk, int D,
                                     float scale, int causal, int window,
                                     void* stream) {
  if (D <= 0 || D % 4 != 0 || D > kDMax || B * H > 65535 || Sq <= 0
      || Sk <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    return launch_f32(q, k, v, o, B, H, Sq, Sk, D, scale, causal, window, s);
  }
  if (dtype == 1) {
    return launch_bf16(q, k, v, o, B, H, Sq, Sk, D, scale, causal, window, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
