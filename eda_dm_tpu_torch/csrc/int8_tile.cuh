// Helpers every kernel library shares: store_out (one float32 value to a
// float or bf16 output), pack4 (four int8 codes as a word) and
// edm_error_string (the text of a CUDA error code, for the wrappers).
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

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
