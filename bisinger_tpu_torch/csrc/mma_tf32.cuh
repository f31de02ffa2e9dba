// Tensor-core building blocks shared by the fp32 kernels (sm_90a): products
// of fp32 operands on the TF32 tensor cores to fp32 accuracy (3xTF32, as
// CUTLASS's "fast accurate" fp32 GEMMs).
//
// Each fp32 operand v splits into hi = tf32(v) and lo = tf32(v - hi), both
// rounded to nearest, ties away from zero (cvt.rna); v - hi is exact in
// fp32, so hi + lo is v to about 2^-22 of |v|. A product a * b is taken as
// a_lo * b_hi + a_hi * b_lo + a_hi * b_hi, the small cross terms first, into
// one fp32 accumulator (`mma3`): the dropped a_lo * b_lo and the rounding of
// lo are about 2^-21 of the product. A single TF32 product keeps 10
// mantissa bits (about 5e-4 of the product), which fp32 callers must never
// get.
//
// Fragment layout of mma.m16n8k8 .tf32 (PTX ISA, "Matrix fragments for
// mma.m16n8k8"), with g = lane / 4 and t = lane % 4:
//   A (16x8, row-major): a0 = A[g][t],  a1 = A[g+8][t],  a2 = A[g][t+4], a3 = A[g+8][t+4]
//   B (8x8, K-major):    b0 = B[t][g],  b1 = B[t+4][g]
//   D (16x8, fp32):      d0,d1 = D[g][2t..2t+1],  d2,d3 = D[g+8][2t..2t+1]
// The kernels permute K inside each step of 8: the product's K index t is
// the operands' 2t and t + 4 is 2t + 1, the same for A and B, so it sums the
// same terms. A lane's a0/a2 (and a1/a3) are then two neighbouring values of
// one row, one 64-bit shared-memory load, and its b0/b1 two neighbouring K
// rows of one column, which the kernels store split, hi and lo of both side
// by side, for one 128-bit load.

#pragma once

#include <cstdint>

#include "mma_bf16.cuh"

namespace mma_tf32 {

using mma_bf16::cp_async_commit;
using mma_bf16::cp_async_wait;
using mma_bf16::cp_async16;

__device__ __forceinline__ uint32_t to_tf32(float v) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(v));
  return r;
}

// hi = tf32(v), lo = tf32(v - hi); hi's low 13 bits are cleared so that
// v - hi is taken from the rounded value
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v) & 0xffffe000u;
  lo = to_tf32(v - __uint_as_float(hi));
}

// d += a * b, one TF32 product with an fp32 sum
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b to fp32 accuracy: a_lo * b_hi + a_hi * b_lo, then a_hi * b_hi
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ahi)[4],
                                     const uint32_t (&alo)[4], uint32_t bhi0, uint32_t bhi1,
                                     uint32_t blo0, uint32_t blo1) {
  mma(d, alo, bhi0, bhi1);
  mma(d, ahi, blo0, blo1);
  mma(d, ahi, bhi0, bhi1);
}

// the four A values of a lane (a0..a3 in the permuted order: row g at
// 2t and 2t + 1 is (v0.x, v0.y), row g + 8 is (v1.x, v1.y)), split
__device__ __forceinline__ void split_a(float2 v0, float2 v1, uint32_t (&hi)[4],
                                       uint32_t (&lo)[4]) {
  split(v0.x, hi[0], lo[0]);
  split(v1.x, hi[1], lo[1]);
  split(v0.y, hi[2], lo[2]);
  split(v1.y, hi[3], lo[3]);
}

}  // namespace mma_tf32
