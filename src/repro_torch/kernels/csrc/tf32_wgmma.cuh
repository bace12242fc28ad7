// tf32_wgmma.cuh: warpgroup MMA (wgmma) on TF32 operands for the fp32
// kernels of this package -- m64n64k8 with A in registers or in shared
// memory and B in shared memory, K-major, without swizzle, the proxy
// fence and the cp.async arrival that hand staged tiles to it.  The
// mbarriers and the wgmma fences, commits and waits are hopper.cuh's.
// TF32 wgmma takes only K-major shared-memory operands (the transpose
// flags exist for 16-bit types alone), so a product whose operand is
// stored N-major has its tile written transposed when it is staged.  Used
// by ssd_scan_bwd.cu.  Everything sits in an anonymous namespace: each source
// compiles its own copy.
//
// The K-major, unswizzled layout of an (R x K) fp32 tile, R and K
// multiples of 8: 8 x 4 "core matrices" of 128 contiguous bytes (8 rows of
// 16 bytes), the two of a k-step of 8 side by side (LBO = 128 bytes), a
// row band of 8 after the K / 4 core matrices of the band before (SBO =
// 32 K bytes): element (r, k) at byte
//   (r / 8) * 32 K + (k / 4) * 128 + (r % 8) * 16 + (k % 4) * 4.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

// Float offset of element (r, k) of a K-major (R x K) tile.
__host__ __device__ __forceinline__ int kmajor_at(int r, int k, int K) {
  return (r >> 3) * 8 * K + (k >> 2) * 32 + (r & 7) * 4 + (k & 3);
}

// Descriptor of k-step s of a K-major tile at shared address `base`.
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t base, int K, int s) {
  const uint32_t addr = base + 256u * static_cast<uint32_t>(s);
  const uint32_t lbo = 128u, sbo = 32u * static_cast<uint32_t>(K);
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4)
         | static_cast<uint64_t>((lbo & 0x3FFFF) >> 4) << 16
         | static_cast<uint64_t>((sbo & 0x3FFFF) >> 4) << 32;
}

// Makes this thread's shared-memory writes visible to the async proxy
// (wgmma's operand reads); a barrier between the writers and the issuing
// warpgroup must follow.
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// The A fragment of a 64 x 8 k-step, as mma.m16n8k8's: warp w of the
// warpgroup holds rows 16 w + g and 16 w + g + 8 at columns t and t + 4
// (lane = 4 g + t): a[0] (g, t), a[1] (g + 8, t), a[2] (g, t + 4),
// a[3] (g + 8, t + 4).  The accumulator of an m64nN product holds, for
// each 8 columns j, d[4 j] (g, 8 j + 2 t), d[4 j + 1] (g, 8 j + 2 t + 1),
// d[4 j + 2] (g + 8, 8 j + 2 t), d[4 j + 3] (g + 8, 8 j + 2 t + 1).

// d (64 x 64 fp32) += a (64 x 8 tf32, registers) * b (8 x 64 tf32, shared
// memory, K-major, no swizzle): one k-step of 8.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32],
                                           const uint32_t (&a)[4],
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d (64 x 64 fp32) += a (64 x 8 tf32) * b (8 x 64 tf32), both in shared
// memory, K-major, no swizzle: one k-step of 8.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], uint64_t da,
                                           uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1;\n}\n"
      :
      "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
      "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
      "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
      "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
      "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
      "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
      "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(1));
}

// An arrival on the mbarrier at shared address `bar` once every cp.async
// this thread has issued has landed.
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(bar) : "memory");
}

}  // namespace
