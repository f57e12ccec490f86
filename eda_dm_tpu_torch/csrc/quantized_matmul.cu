// K8: int8 quantized matmul, activation quantized in the kernel.
//
// Replaces the Pallas kernel of eda_dm_tpu/ops/pallas_quant.py
// (quantized_matmul) and the rank-1 dequant corrections XLA fused after it:
//
//   xq8[m,k] = clip(rint(x[m,k] / s_x) + z_x, 0, 255) − 128    (int8)
//   acc[m,n] = Σ_k xq8[m,k]·w_q[k,n]                             (int32)
//   row[m]   = Σ_k (xq8[m,k] + 128 − z_x)
//   out[m,n] = s_x·(acc + (128 − z_x)·colsum[n])·s_w[n]
//              + s_x·row[m]·off[n]  (+ bias[n])                 (float32)
//
// cast to x's dtype.  The quantize step is IEEE float32 (__fdiv_rn, rintf,
// x widened from bf16 first); every epilogue step is one IEEE operation in
// this order (__fmul_rn / __fadd_rn, no FMA contraction), as in the plain
// version (eda_dm_tpu_torch/ops/quant_matmul.py::quantized_matmul_plain).
// The row sum is an exact integer: Σ xq8 in int32, then
// + K·(128 − z_x), exact in float32 for K < 65536 and integer z_x.  So the
// card's output equals the plain version's.  With acc_only the kernel
// stores the int32 sums instead of the epilogue.
//
// Design: a plain tiled GEMM on the tensor cores.  One block of 256
// threads (8 warps as 2 x 4) owns a 128 x 128 output tile, each warp
// 64 x 32 of it in 4 x 4 mma.sync m16n8k32 int8 products (int8_mma.cuh).
// K goes through shared memory 64 codes at a time: x is loaded (as float4
// or 4 x bf16 where aligned), quantized and packed four codes a word while
// the block also adds each row's codes; w_q (K, N), N contiguous, is read
// a word of four columns at a time from four rows and transposed by byte
// permutes into the column-per-row layout mma.sync takes.  Tails of M, N
// and K load as code 0 against weight 0.
//
// Bound on this card: at SD's GEGLU dense (32768, 320)·(320, 2560) the
// 2·M·N·K int8 operations at 1,979 TOP/s take 0.027 ms and the bytes (x
// as bf16 once, the output once) 0.056 ms, so the bytes bound it.  This
// first version has no copy pipeline (loads and products alternate behind
// block barriers) and stores the epilogue unvectorised; TMA and wgmma are
// later work.
#include "int8_tile.cuh"
#include "int8_mma.cuh"

#define QM_BM 128
#define QM_BN 128
#define QM_BK 64                  // codes of K per shared-memory tile
#define QM_LDW (QM_BK / 4 + 4)    // words a shared row: 64 bytes + 16
#define QM_THREADS 256

__device__ __forceinline__ float qm_f32(float v) { return v; }
__device__ __forceinline__ float qm_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// four consecutive x values of row m from column k (zero past M or K)
template <typename XT>
__device__ __forceinline__ void load4(const XT* __restrict__ x, long long m, int k,
                                      int M, int K, bool vec, float (&v)[4]) {
  const XT* p = x + m * K + k;
  if (vec && m < M && k + 3 < K) {
    if constexpr (sizeof(XT) == 4) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(p));
      v[0] = f.x; v[1] = f.y; v[2] = f.z; v[3] = f.w;
    } else {
      const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
      const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
      const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
      v[0] = __low2float(lo); v[1] = __high2float(lo);
      v[2] = __low2float(hi); v[3] = __high2float(hi);
    }
    return;
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    v[i] = (m < M && k + i < K) ? qm_f32(p[i]) : 0.0f;
}

// w_q[k .. k+3][n .. n+3] as four words of four columns (zero outside)
__device__ __forceinline__ uint32_t w_word(const int8_t* __restrict__ w, int k, int n,
                                           int N, int K, bool vec) {
  if (k >= K) return 0u;
  const int8_t* p = w + (long long)k * N + n;
  if (vec && n + 3 < N) return __ldg(reinterpret_cast<const unsigned int*>(p));
  uint32_t r = 0u;
#pragma unroll
  for (int j = 0; j < 4; ++j)
    if (n + j < N) r |= (uint32_t)(uint8_t)__ldg(p + j) << (8 * j);
  return r;
}

template <typename XT, bool ACC_ONLY>
__global__ void __launch_bounds__(QM_THREADS)
quantized_matmul_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w,
                        const float* __restrict__ sx_p, const float* __restrict__ zx_p,
                        const float* __restrict__ s_w, const float* __restrict__ colsum,
                        const float* __restrict__ off, const float* __restrict__ bias,
                        void* __restrict__ out, int M, int N, int K, bool x_vec,
                        bool w_vec) {
  __shared__ uint32_t As[QM_BM * QM_LDW];
  __shared__ uint32_t Bs[QM_BN * QM_LDW];
  __shared__ float row_s[QM_BM];
  const long long m0 = (long long)blockIdx.x * QM_BM;
  const int n0 = blockIdx.y * QM_BN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const float sx = *sx_p, zx = *zx_p;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
  int rsum[8];                   // Σ xq8 of rows 16·l + tid / 16, this thread's part
#pragma unroll
  for (int l = 0; l < 8; ++l) rsum[l] = 0;

  const int xr = tid >> 4, xc = (tid & 15) * 4;        // x: 4 codes of a row
  const int ng = tid & 31, kg0 = tid >> 5;             // w: 4 x 4 byte blocks

  for (int k0 = 0; k0 < K; k0 += QM_BK) {
#pragma unroll
    for (int l = 0; l < 8; ++l) {
      const int r = 16 * l + xr;
      float v[4];
      load4(x, m0 + r, k0 + xc, M, K, x_vec, v);
      uint32_t word = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int q = 0;                                      // code 0 past M or K
        if (m0 + r < M && k0 + xc + i < K) {
          const float f = fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(v[i], sx)), zx), 0.0f),
                                255.0f);
          q = __float2int_rn(f) - 128;
        }
        rsum[l] += q;
        word |= (uint32_t)(uint8_t)q << (8 * i);
      }
      As[r * QM_LDW + xc / 4] = word;
    }
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kg = kg0 + 8 * j;                      // words of 4 codes along K
      const int k = k0 + 4 * kg, n = n0 + 4 * ng;
      const uint32_t r0 = w_word(w, k, n, N, K, w_vec), r1 = w_word(w, k + 1, n, N, K, w_vec),
                     r2 = w_word(w, k + 2, n, N, K, w_vec), r3 = w_word(w, k + 3, n, N, K, w_vec);
      // 4 x 4 byte transpose: column n + i's codes at k .. k + 3
      const uint32_t t0 = __byte_perm(r0, r1, 0x5140), t1 = __byte_perm(r2, r3, 0x5140);
      const uint32_t t2 = __byte_perm(r0, r1, 0x7362), t3 = __byte_perm(r2, r3, 0x7362);
      uint32_t* b = Bs + (4 * ng) * QM_LDW + kg;
      b[0] = __byte_perm(t0, t1, 0x5410);
      b[QM_LDW] = __byte_perm(t0, t1, 0x7632);
      b[2 * QM_LDW] = __byte_perm(t2, t3, 0x5410);
      b[3 * QM_LDW] = __byte_perm(t2, t3, 0x7632);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < QM_BK / 32; ++ks) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) load_a_frag(a[i], As, QM_LDW, wm + 16 * i, 8 * ks, lane);
#pragma unroll
      for (int j = 0; j < 4; ++j) load_b_frag(b[j], Bs, QM_LDW, wn + 8 * j, 8 * ks, lane);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8_16832(acc[i][j], a[i], b[j]);
    }
    __syncthreads();
  }

  const int g = lane >> 2, t = lane & 3;
  if constexpr (ACC_ONLY) {
    int* o = static_cast<int*>(out);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const long long m = m0 + wm + 16 * i + g + 8 * (c >> 1);
          const int n = n0 + wn + 8 * j + 2 * t + (c & 1);
          if (m < M && n < N) o[m * N + n] = acc[i][j][c];
        }
    return;
  }
  // row sums: the 16 threads of a half-warp share rows 16·l + tid / 16
  const float kz = __fmul_rn((float)K, __fsub_rn(128.0f, zx));
#pragma unroll
  for (int l = 0; l < 8; ++l) {
    int s = rsum[l];
#pragma unroll
    for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if ((tid & 15) == 0) row_s[16 * l + xr] = __fadd_rn(__int2float_rn(s), kz);
  }
  __syncthreads();
  const float c128 = __fsub_rn(128.0f, zx);
  XT* o = static_cast<XT*>(out);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = wm + 16 * i + g + 8 * (c >> 1);
        const long long m = m0 + r;
        const int n = n0 + wn + 8 * j + 2 * t + (c & 1);
        if (m >= M || n >= N) continue;
        float v = __fadd_rn(__int2float_rn(acc[i][j][c]), __fmul_rn(c128, colsum[n]));
        v = __fmul_rn(__fmul_rn(sx, v), s_w[n]);
        v = __fadd_rn(v, __fmul_rn(__fmul_rn(sx, row_s[r]), off[n]));
        if (bias) v = __fadd_rn(v, bias[n]);
        store_out(o + m * N + n, v);
      }
}

template <typename XT, bool ACC_ONLY>
static int launch(const void* x, const void* w, const void* sx, const void* zx,
                  const void* s_w, const void* colsum, const void* off, const void* bias,
                  void* out, int M, int N, int K, cudaStream_t stream) {
  const bool x_vec = K % 4 == 0 && (uintptr_t)x % (4 * sizeof(XT)) == 0;
  const bool w_vec = N % 4 == 0 && (uintptr_t)w % 4 == 0;
  dim3 grid((unsigned)((M + QM_BM - 1) / QM_BM), (N + QM_BN - 1) / QM_BN);
  quantized_matmul_kernel<XT, ACC_ONLY><<<grid, QM_THREADS, 0, stream>>>(
      (const XT*)x, (const int8_t*)w, (const float*)sx, (const float*)zx,
      (const float*)s_w, (const float*)colsum, (const float*)off, (const float*)bias,
      out, M, N, K, x_vec, w_vec);
  return (int)cudaGetLastError();
}

// x: (M, K) float32 or bfloat16 (x_bf16), contiguous; w: (K, N) int8,
// contiguous; sx, zx: float32 scalars on the card; s_w, colsum, off: (N,)
// float32 (unused with acc_only); bias: (N,) float32 or NULL; out: (M, N)
// in x's dtype, or int32 with acc_only.
extern "C" int edm_quantized_matmul(const void* x, const void* w, const void* sx,
                                    const void* zx, const void* s_w, const void* colsum,
                                    const void* off, const void* bias, void* out,
                                    int x_bf16, int acc_only, int M, int N, int K,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define EDM_QM_ARGS x, w, sx, zx, s_w, colsum, off, bias, out, M, N, K, s
  if (x_bf16)
    return acc_only ? launch<__nv_bfloat16, true>(EDM_QM_ARGS)
                    : launch<__nv_bfloat16, false>(EDM_QM_ARGS);
  return acc_only ? launch<float, true>(EDM_QM_ARGS) : launch<float, false>(EDM_QM_ARGS);
#undef EDM_QM_ARGS
}
