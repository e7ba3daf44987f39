// Helpers for bfloat16 products on the tensor cores (the bf16 route of
// masked_attention_bwd.cu): ldmatrix from bf16 shared memory, mma.sync
// m16n8k16 with float32 accumulation, and float32 accumulators packed into
// bf16 A fragments.
//
// mma.sync m16n8k16 bf16 fragments (g = lane / 4, t = lane % 4; a register
// holds two bf16, the lower column or k in its low 16 bits):
//   A (16 x 16, row): a0 (g, 2t..2t+1), a1 (g + 8, 2t..2t+1), a2 (g, 2t+8..2t+9), a3 (g + 8, 2t+8..2t+9)
//   B (16 x 8, col):  b0 (k = 2t..2t+1, n = g), b1 (k = 2t+8..2t+9, n = g)
//   C (16 x 8, f32):  c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// So the accumulators of two neighbouring n-tiles (columns 0-7 and 8-15),
// packed pairwise, are the A fragment of the 16 x 16 block they form:
//   a0 = pack(c0, c1) of tile 0, a1 = pack(c2, c3) of tile 0, a2 and a3 the same of tile 1.
// ldmatrix .x4 loads four 8 x 8 matrices of 16-bit values: lanes 8i .. 8i + 7
// give the addresses of matrix i's eight rows (16 bytes each, 16-byte
// aligned), and register i receives matrix i as (row g, columns 2t..2t+1), or
// with .trans as (rows 2t..2t+1, column g), i.e. the fragment of the
// transposed matrix. A product is exact in float32 (8-bit significands), so a
// bf16 mma differs from a float32 dot of the same values only in how the sum
// is rounded.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rgbd {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row)));
}

// d += a @ b for one m16n8k16 step, float32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two float32 values rounded to bf16 (to nearest, ties to even) in one
// register, `lo` in the low half: what __float22bfloat162_rn computes, kept in
// a register (no bf16 struct whose address is taken).
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The two bf16 of a register, widened exactly to float32.
__device__ __forceinline__ float bf16_lo(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float bf16_hi(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

}  // namespace rgbd
