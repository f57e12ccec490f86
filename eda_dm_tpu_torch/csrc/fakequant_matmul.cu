// K7: serving matmul with the activation fake-quant fused into the tile load.
//
// Replaces the Pallas kernel of eda_dm_tpu/ops/pallas_quant.py
// (fakequant_matmul), which the DEPLOY_FUSED mode runs for every 1×1 conv
// and dense:
//
//   xq[m,k]  = w.dtype( clip(rint(x[m,k] / Δ[k]), −zp[k], L−1−zp[k]) · Δ[k] )
//   out[m,n] = x.dtype( Σ_k xq[m,k]·w[k,n]  (float32)  + bias[n] )
//
// The level boundaries and the product q·Δ are IEEE float32 operations
// (__fdiv_rn, rintf, __fmul_rn), then one rounding to w's dtype, as in the
// plain version (eda_dm_tpu_torch/ops/quant_matmul.py::fakequant_rows);
// so with an identity w in float32 the output is the fake-quant itself.
//
// Design: a plain tiled GEMM on the CUDA cores.  One block of 256 threads
// computes a 64 × 64 output tile, each thread 4 × 4 of it; K goes through
// shared memory in chunks of 16.  The x chunk is quantized while it is
// loaded (each thread quantizes 4 of its 64 × 16 elements), so the
// fake-quantized activation never reaches device memory.  w is read
// through its two strides: the port passes its [out, in] weights as the
// transposed (K, N) view, whose loads then run along K.  Ragged M, N and
// K are masked.  Products accumulate in float32 FMAs; the bias add and the
// cast to the output dtype end it.
//
// Bound on this card: at the CIFAR shapes (K = N = 256, M = 128,000) the
// bytes (x read once, the output written once) bound the work on paper:
// 2·M·N·K operations at the tensor cores' bf16 rate take less than half
// the memory time.  This first version runs the products on the CUDA
// cores' float32 FMAs (67 TFLOP/s), which take longer than the bytes; the
// tensor cores are later work.
#include "int8_tile.cuh"

#include <cmath>

#define FQ_BM 64
#define FQ_BN 64
#define FQ_BK 16
#define FQ_THREADS 256

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// a float32 value rounded to the weights' dtype, held as float32
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

template <typename XT, typename WT>
__global__ void __launch_bounds__(FQ_THREADS)
fakequant_matmul_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                        const float* __restrict__ delta,
                        const float* __restrict__ zp,
                        const float* __restrict__ bias, XT* __restrict__ out,
                        int M, int N, int K, long long w_sk, long long w_sn,
                        int n_levels) {
  __shared__ float As[FQ_BK][FQ_BM + 4];
  __shared__ float Bs[FQ_BK][FQ_BN + 4];
  const long long m0 = (long long)blockIdx.x * FQ_BM;
  const int n0 = blockIdx.y * FQ_BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const float top = (float)(n_levels - 1);

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < K; k0 += FQ_BK) {
#pragma unroll
    for (int l = 0; l < (FQ_BM * FQ_BK) / FQ_THREADS; ++l) {
      const int e = tid + FQ_THREADS * l;
      const int kk = e % FQ_BK, r = e / FQ_BK;       // along K: coalesced
      const long long m = m0 + r;
      const int k = k0 + kk;
      float v = 0.0f;
      if (m < M && k < K) {
        const float d = delta[k], z = zp[k];
        const float q = fminf(fmaxf(rintf(__fdiv_rn(to_f32(x[m * K + k]), d)),
                                    -z),
                              __fsub_rn(top, z));
        v = round_to<WT>(__fmul_rn(q, d));
      }
      As[kk][r] = v;
    }
#pragma unroll
    for (int l = 0; l < (FQ_BK * FQ_BN) / FQ_THREADS; ++l) {
      const int e = tid + FQ_THREADS * l;
      int kk, c;
      if (w_sk == 1) {
        kk = e % FQ_BK;
        c = e / FQ_BK;
      } else {
        c = e % FQ_BN;
        kk = e / FQ_BN;
      }
      const int k = k0 + kk, n = n0 + c;
      Bs[kk][c] = (k < K && n < N) ? to_f32(w[k * w_sk + n * w_sn]) : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FQ_BK; ++kk) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = acc[i][j];
      if (bias) v = __fadd_rn(v, bias[n]);
      store_out(out + m * N + n, v);
    }
  }
}

template <typename XT, typename WT>
static int launch(const void* x, const void* w, const void* delta,
                  const void* zp, const void* bias, void* out, int M, int N,
                  int K, long long w_sk, long long w_sn, int n_levels,
                  cudaStream_t stream) {
  dim3 grid((unsigned)((M + FQ_BM - 1) / FQ_BM), (N + FQ_BN - 1) / FQ_BN);
  fakequant_matmul_kernel<XT, WT><<<grid, FQ_THREADS, 0, stream>>>(
      (const XT*)x, (const WT*)w, (const float*)delta, (const float*)zp,
      (const float*)bias, (XT*)out, M, N, K, w_sk, w_sn, n_levels);
  return (int)cudaGetLastError();
}

// x: (M, K) float32 or bfloat16 (x_bf16), contiguous; w: (K, N) float32
// or bfloat16 (w_bf16) at element strides (w_sk, w_sn); delta, zp: (K,)
// float32; bias: (N,) float32 or NULL; out: (M, N) in x's dtype.
extern "C" int edm_fakequant_matmul(const void* x, const void* w,
                                    const void* delta, const void* zp,
                                    const void* bias, void* out, int x_bf16,
                                    int w_bf16, int M, int N, int K, int w_sk,
                                    int w_sn, int n_levels, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define EDM_FQ_ARGS x, w, delta, zp, bias, out, M, N, K, w_sk, w_sn, n_levels, s
  if (x_bf16 && w_bf16) return launch<__nv_bfloat16, __nv_bfloat16>(EDM_FQ_ARGS);
  if (x_bf16) return launch<__nv_bfloat16, float>(EDM_FQ_ARGS);
  if (w_bf16) return launch<float, __nv_bfloat16>(EDM_FQ_ARGS);
  return launch<float, float>(EDM_FQ_ARGS);
#undef EDM_FQ_ARGS
}
