// Helpers shared by the K3 kernels (masked_attention.cu, masked_attention_bwd.cu):
// cp.async staging and float32-accurate products on the tensor cores.
//
// mma.sync m16n8k8 TF32 fragments (g = lane / 4, t = lane % 4):
//   A (16 x 8, row): a0 (g, t), a1 (g + 8, t), a2 (g, t + 4), a3 (g + 8, t + 4)
//   B (8 x 8, col):  b0 (k = t, n = g), b1 (k = t + 4, n = g)
//   C (16 x 8):      c0 (g, 2t), c1 (g, 2t + 1), c2 (g + 8, 2t), c3 (g + 8, 2t + 1)
// A float32 x is split as x = hi + lo, hi = tf32(x), lo = tf32(x - hi), and a
// product is taken as lo*hi + hi*lo + hi*hi (3xTF32), which keeps float32
// accuracy (one TF32 product keeps about three decimal digits).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rgbd {

// cp.async with zero fill: copies `valid ? n : 0` bytes and zeroes the rest.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(valid ? 4 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n"); }

// x = hi + lo with hi, lo in TF32 (round to nearest).
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(x - __uint_as_float(hi)));
}

// The four A values of a fragment, split.
__device__ __forceinline__ void split_tf32(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32(x[e], hi[e], lo[e]);
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a @ b for one m16n8k8 step in about f32 precision: lo*hi + hi*lo + hi*hi.
__device__ __forceinline__ void mma_3xtf32(float (&d)[4], const uint32_t (&ahi)[4], const uint32_t (&alo)[4],
                                           float b0, float b1) {
  uint32_t bh0, bl0, bh1, bl1;
  split_tf32(b0, bh0, bl0);
  split_tf32(b1, bh1, bl1);
  mma_tf32(d, alo, bh0, bh1);
  mma_tf32(d, ahi, bl0, bl1);
  mma_tf32(d, ahi, bh0, bh1);
}

// split_tf32 in integer and float ALU operations instead of conversions, which
// run at a quarter of their rate: rounding to nearest, ties away from zero, is
// adding half of the dropped 13 bits' range to the magnitude and masking them off.
__device__ __forceinline__ uint32_t tf32_rna(float x) { return (__float_as_uint(x) + 0x1000u) & 0xffffe000u; }
__device__ __forceinline__ void split_tf32_alu(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}
__device__ __forceinline__ void split_tf32_alu(const float (&x)[4], uint32_t (&hi)[4], uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) split_tf32_alu(x[e], hi[e], lo[e]);
}

// A B fragment (b0, b1), split.
struct BFrag {
  uint32_t h0, h1, l0, l1;
};
__device__ __forceinline__ BFrag split_b(float b0, float b1) {
  BFrag f;
  split_tf32_alu(b0, f.h0, f.l0);
  split_tf32_alu(b1, f.h1, f.l1);
  return f;
}

// Product `pass` of mma_3xtf32 (0: lo * hi, 1: hi * lo, 2: hi * hi). A loop
// over the passes outside a loop over independent accumulators issues the same
// products per accumulator, in the same order, as mma_3xtf32 does, but
// consecutive mma.sync no longer wait for each other (mma_tf32 is volatile, so
// the compiler keeps the order as written).
__device__ __forceinline__ void mma_pass(int pass, float (&d)[4], const uint32_t (&ahi)[4],
                                         const uint32_t (&alo)[4], const BFrag& b) {
  if (pass == 0)
    mma_tf32(d, alo, b.h0, b.h1);
  else if (pass == 1)
    mma_tf32(d, ahi, b.l0, b.l1);
  else
    mma_tf32(d, ahi, b.h0, b.h1);
}

}  // namespace rgbd
