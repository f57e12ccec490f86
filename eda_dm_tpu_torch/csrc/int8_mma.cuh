// Warp-level tensor-core products (mma.sync) and their fragment loads,
// shared by the tensor-core kernels (quantized_matmul.cu, mma_chain.cu).
//
// Two shapes, one fragment layout in 32-bit words:
//   int8:  mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 (4 codes a word)
//   bf16:  mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 (2 a word)
// Either way one product covers 32 bytes of K: 8 words.  A (16 rows) is
// row-major with K contiguous; B (8 columns) is stored one row per column
// n with K contiguous (the "col" operand).  For lane = 4·g + t:
//   a[0] = A[g][w0 + t]      a[1] = A[g + 8][w0 + t]
//   a[2] = A[g][w0 + 4 + t]  a[3] = A[g + 8][w0 + 4 + t]
//   b[0] = B[n = g][w0 + t]  b[1] = B[n = g][w0 + 4 + t]
// and the 16 x 8 sums land as d[0], d[1] at row g, columns 2t, 2t + 1 and
// d[2], d[3] at row g + 8, the same columns.
//
// Fragments come from shared memory by ldmatrix (16-byte aligned rows).
// Rows whose stride is 16 bytes more than a multiple of 128 (e.g. a
// 64-byte K tile padded to 80 bytes, or K bytes + 16 with K a multiple of
// 128) put the eight rows of each 8 x 16-byte matrix in distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ void mma_s8_16832(int (&d)[4], const uint32_t (&a)[4],
                                             const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ void mma_bf16_16816(float (&d)[4], const uint32_t (&a)[4],
                                               const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// the product of the operand type: int8 codes into int32, bf16 into float32
__device__ __forceinline__ void mma_32bytes(int (&d)[4], const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  mma_s8_16832(d, a, b);
}
__device__ __forceinline__ void mma_32bytes(float (&d)[4], const uint32_t (&a)[4],
                                            const uint32_t (&b)[2]) {
  mma_bf16_16816(d, a, b);
}

// A fragment of rows r0 .. r0 + 15, K words w0 .. w0 + 7, rows ld words
// apart: one ldmatrix.x4, whose four 8 x 16-byte matrices (rows 0-7 and
// 8-15, bytes 0-15 and 16-31) hand each lane exactly a[0..3]
__device__ __forceinline__ void load_a_frag(uint32_t (&a)[4], const uint32_t* s, int ld,
                                            int r0, int w0, int lane) {
  const unsigned p = (unsigned)__cvta_generic_to_shared(
      s + (r0 + (lane & 15)) * ld + w0 + (lane >> 4) * 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(p));
}

// B fragment of columns n0 .. n0 + 7 (one row of s per column): one
// ldmatrix.x2 (rows n0 .. n0 + 7, bytes 0-15 and 16-31)
__device__ __forceinline__ void load_b_frag(uint32_t (&b)[2], const uint32_t* s, int ld,
                                            int n0, int w0, int lane) {
  const unsigned p = (unsigned)__cvta_generic_to_shared(
      s + (n0 + (lane & 7)) * ld + w0 + ((lane >> 3) & 1) * 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(b[0]), "=r"(b[1])
               : "r"(p));
}
