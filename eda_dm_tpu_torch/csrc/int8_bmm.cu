// K2: batched int8 GEMM with the recentering epilogue.
//
// Replaces the XLA int8 einsum of eda_dm_tpu/ops/int8_einsum.py
// (int8_code_einsum, `jnp.einsum(..., preferred_element_type=int32)`) and
// the 2-D int8 QDense matmul of eda_dm_tpu/nn/layers.py (QDense, int8
// branch).  NT form: out[b,m,n] from sum_k A[b,m,k] * B[b,n,k], both
// operands K-contiguous (the wrapper transposes V once for `nij,njc->nic`).
//
// Epilogue, in the JAX operation order, each step rounded on its own:
//   v = float(acc) [+ row_add[b,m]] [+ col_add[b,n]] [+ k_add]
//   v = v * scale[n]  [+ bias[n]]
// The attention einsums pass row/col code sums times the other operand's
// recentering offset and the scalar c_a*c_b*K; the dense passes c*isum as
// col_add and per-channel scale and bias.
//
// Bound on this card: at the CIFAR attention shapes (K = 256) a tile does
// 2*128*128*256 int8 ops per 64 KB read, far above the int8 ridge, so the
// tensor-core int8 rate bounds it.  This first version runs on the CUDA
// cores (__dp4a) with a shared-memory tile: simple and exact; moving it to
// mma/wgmma is later work.
//
// K tail: where K % 4 != 0 (the SD cross-attention's W·V contracts over
// the 77 context tokens) the rows are not word-aligned, so each 32-bit
// word is gathered from bytes and the bytes past K are zero codes; the
// epilogue's terms come from the caller with the true K.
#include "int8_tile.cuh"

// word kw (codes 4·kw .. 4·kw + 3) of one K-contiguous row
template <bool ALIGNED>
__device__ __forceinline__ int row_word(const int8_t* row, int kw, int K) {
  if (ALIGNED) return __ldg(reinterpret_cast<const int*>(row) + kw);
  const int k = 4 * kw;
  return pack4(__ldg(row + k), k + 1 < K ? __ldg(row + k + 1) : (int8_t)0,
               k + 2 < K ? __ldg(row + k + 2) : (int8_t)0,
               k + 3 < K ? __ldg(row + k + 3) : (int8_t)0);
}

template <bool ALIGNED>
__global__ void __launch_bounds__(TILE_THREADS)
int8_bmm_nt_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                   float* __restrict__ out, int M, int N, int K,
                   long long a_bs, long long b_bs,
                   const float* __restrict__ row_add,
                   const float* __restrict__ col_add, long long col_bs,
                   const float* __restrict__ k_add,
                   const float* __restrict__ scale, int scale_stride,
                   const float* __restrict__ bias) {
  __shared__ int As[BKW][BM + SPAD];
  __shared__ int Bs[BKW][BN + SPAD];
  const int b = blockIdx.z;
  const int m0 = blockIdx.x * BM, n0 = blockIdx.y * BN;
  const int Kw = (K + 3) >> 2;
  const int8_t* Ab = A + (long long)b * a_bs;
  const int8_t* Bb = B + (long long)b * b_bs;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kk_ld = tid & 7, r_ld = tid >> 3;

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  for (int k0 = 0; k0 < Kw; k0 += BKW) {
    const int gk = k0 + kk_ld;
#pragma unroll
    for (int l = 0; l < LOADS_PER_THREAD; ++l) {
      const int r = r_ld + 32 * l;
      const int gm = m0 + r, gn = n0 + r;
      As[kk_ld][r] = (gm < M && gk < Kw)
          ? row_word<ALIGNED>(Ab + (long long)gm * K, gk, K) : 0;
      Bs[kk_ld][r] = (gn < N && gk < Kw)
          ? row_word<ALIGNED>(Bb + (long long)gn * K, gk, K) : 0;
    }
    __syncthreads();
    dp4a_tile(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  const float kadd = k_add ? *k_add : 0.f;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const float ra = row_add ? row_add[(long long)b * M + m] : 0.f;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n >= N) continue;
      float v = __int2float_rn(acc[i][j]);
      if (row_add) v = __fadd_rn(v, ra);
      if (col_add) v = __fadd_rn(v, col_add[(long long)b * col_bs + n]);
      if (k_add) v = __fadd_rn(v, kadd);
      v = __fmul_rn(v, scale[(long long)n * scale_stride]);
      if (bias) v = __fadd_rn(v, bias[n]);
      out[((long long)b * M + m) * N + n] = v;
    }
  }
}

extern "C" int edm_int8_bmm_nt(const void* A, const void* B, void* out,
                               int batch, int M, int N, int K,
                               const void* row_add, const void* col_add,
                               int col_batched, const void* k_add,
                               const void* scale, int scale_stride,
                               const void* bias, void* stream) {
  dim3 grid((M + BM - 1) / BM, (N + BN - 1) / BN, batch);
  const bool aligned = K % 4 == 0 && (uintptr_t)A % 4 == 0 && (uintptr_t)B % 4 == 0;
  auto kernel = aligned ? int8_bmm_nt_kernel<true> : int8_bmm_nt_kernel<false>;
  kernel<<<grid, TILE_THREADS, 0, (cudaStream_t)stream>>>(
      (const int8_t*)A, (const int8_t*)B, (float*)out, M, N, K,
      (long long)M * K, (long long)N * K, (const float*)row_add,
      (const float*)col_add, col_batched ? (long long)N : 0LL,
      (const float*)k_add, (const float*)scale, scale_stride,
      (const float*)bias);
  return (int)cudaGetLastError();
}
