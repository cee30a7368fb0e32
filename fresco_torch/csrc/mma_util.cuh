// Warp-level bf16 tensor-core helpers shared by the fresco_torch kernels.
//
// mma.sync m16n8k16 (row.col, bf16 x bf16 -> f32) fragment layout, with
// lane = 4*g + t (g = lane >> 2, t = lane & 3):
//   A 16x16: a0 = (g, 2t..2t+1)   a1 = (g+8, 2t..2t+1)
//            a2 = (g, 2t+8..2t+9) a3 = (g+8, 2t+8..2t+9)
//   B 16x8:  b0 = (k 2t..2t+1, n g)  b1 = (k 2t+8..2t+9, n g)
//   C 16x8:  c0,c1 = (g, 2t..2t+1)   c2,c3 = (g+8, 2t..2t+1)
// Each 32-bit register holds two bf16, the lower index in the low half.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace fresco {

__device__ __forceinline__ void mma_bf16_16816(float (&c)[4], const uint32_t (&a)[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two consecutive bf16 in memory (4-byte aligned) as one register
__device__ __forceinline__ uint32_t ld_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// two bf16 from separate addresses, `lo` in the low half
__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// round two floats to bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_f32(float lo, float hi) {
  return pack_raw(__float2bfloat16_rn(lo), __float2bfloat16_rn(hi));
}

}  // namespace fresco
