// The CUDA-core int8 GEMM tile of K1 (int8_conv.cu), and the helpers every
// kernel library shares (store_out, pack4, edm_error_string).
//
// One block computes a BM x BN tile of int32 sums.  The K dimension goes
// through shared memory in chunks of BKW 32-bit words (32 int8 values);
// each of the 256 threads owns a TM x TN micro-tile (rows ty + 16*i,
// columns tx + 16*j) and accumulates it with __dp4a: four int8 products
// summed into an int32 per instruction, exact.
//
// Loads: thread tid always loads word kk = tid % 8 of rows tid / 8 + 32*l,
// l = 0..3, of each operand tile.  Shared rows are padded to BM + 4 words,
// so a warp's 32 stores (8 words x 4 rows) hit 32 distinct banks.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define BM 128
#define BN 128
#define BKW 8
#define TM 8
#define TN 8
#define SPAD 4
#define TILE_THREADS 256
#define LOADS_PER_THREAD ((BM * BKW) / TILE_THREADS)

__device__ __forceinline__ void dp4a_tile(int (*As)[BM + SPAD],
                                          int (*Bs)[BN + SPAD],
                                          int (&acc)[TM][TN], int tx, int ty) {
#pragma unroll
  for (int kk = 0; kk < BKW; ++kk) {
    int a[TM], b[TN];
#pragma unroll
    for (int i = 0; i < TM; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
    for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = __dp4a(a[i], b[j], acc[i][j]);
  }
}

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

__device__ __forceinline__ int pack4(int8_t a, int8_t b, int8_t c, int8_t d) {
  return (int)((uint32_t)(uint8_t)a | ((uint32_t)(uint8_t)b << 8) |
               ((uint32_t)(uint8_t)c << 16) | ((uint32_t)(uint8_t)d << 24));
}

extern "C" const char* edm_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
