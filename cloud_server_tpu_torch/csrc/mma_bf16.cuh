// Tensor-core fragment helpers shared by the port's attention kernels.
//
// mma.sync m16n8k16, bf16 inputs, f32 accumulators. Fragment layout for
// lane l (g = l / 4, tig = l % 4), from the PTX ISA:
//   A (16x16, row): a0 = (g, 2tig..2tig+1), a1 = (g+8, 2tig..),
//                   a2 = (g, 2tig+8..),     a3 = (g+8, 2tig+8..)
//   B (16x8, col):  b0 = (k 2tig..2tig+1, n g), b1 = (k 2tig+8.., n g)
//   C (16x8):       c0,c1 = (g, 2tig..2tig+1), c2,c3 = (g+8, 2tig..)
// A C fragment of one product is therefore the A fragment of the next
// (two neighbouring n-tiles make one 16-wide k-step), which is what lets
// softmax probabilities stay in registers between the two products.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t pack_floats(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t pack_raw(__nv_bfloat16 lo,
                                             __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// D = A (16x16, row) * B (16x8, col) + D; bf16 inputs, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Reductions over the four lanes of a quad (the lanes that share a
// fragment row).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

}  // namespace
