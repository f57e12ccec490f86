// K7: serving matmul with the activation fake-quant fused into the tile load.
//
// Replaces the Pallas kernel of eda_dm_tpu/ops/pallas_quant.py
// (fakequant_matmul), which the DEPLOY_FUSED mode runs for every 1×1 conv
// and dense:
//
//   xq[m,k]  = w.dtype( clip(rint(x[m,k] / Δ[k]), −zp[k], L−1−zp[k]) · Δ[k] )
//   out[m,n] = x.dtype( Σ_k xq[m,k]·w[k,n]  (float32)  + bias[n] )
//
// The level boundaries and the product q·Δ are IEEE float32 operations,
// then one rounding to w's dtype, as in the plain version
// (eda_dm_tpu_torch/ops/quant_matmul.py::fakequant_rows).
//
// Two routes, one entry point:
//
// * bf16 x and bf16 w, the serving carrier: tensor cores.  A bf16 × bf16
//   product is exact in float32, so mma.sync.m16n8k16 with a float32
//   accumulator computes the function's products; only the add order
//   differs from the plain version's.  Bound on this card: bytes (x read
//   once, the output written once: 0.039 ms at (128000, 256)·(256, 256) at
//   3.35 TB/s; the products at P1's measured mma.sync rate, 269 TFLOP/s,
//   take 0.062 ms).  The design:
//   - a block takes 64 rows and BN = 64, 128 or 256 columns (the plan,
//     ops/quant_matmul.py::fq_plan: all of N where N ≤ 256 and the rows
//     fill the card, so each element of x is loaded and fake-quantized
//     once); 8 warps, each 64/WM rows by 32 columns of it;
//   - K goes in chunks of 32 through a ring of 3 stages: w by 16-byte
//     cp.async, either as the port's [out, in] weights seen K-contiguous
//     (fragments by ldmatrix) or as a contiguous (K, N) (ldmatrix.trans);
//   - x goes through registers: the next chunk's 16-byte vectors are
//     loaded before this chunk's products, then each element takes the
//     exact x/Δ[k] (the column's Divisor, from a 3-chunk ring of per-column
//     constants in shared memory; exact_arith.cuh), rint, the clamp,
//     __fmul_rn(q, Δ), __float2bfloat16_rn, and a 16-byte store into the A
//     tile that ldmatrix reads;
//   - epilogue: the bias in float32, the cast, then 16-byte stores staged
//     through shared memory.
//   Ragged M, N and K are zero-filled; operands or rows off 16 bytes go by
//   scalar loads and stores.
// * float32 or mixed operands: a tiled GEMM on the CUDA cores' float32
//   FMAs (64 × 64 tiles, K in chunks of 16, x quantized on load), since
//   bf16 products would break float32's tolerance.
#include "exact_arith.cuh"
#include "int8_mma.cuh"
#include "int8_tile.cuh"

#include <cmath>

#define FQ_BM 64
#define FQ_BN 64
#define FQ_BK 16
#define FQ_THREADS 256

namespace {

constexpr int TC_BM = 64;          // rows a block (tensor-core route)
constexpr int TC_BK = 32;          // K a chunk
constexpr int TC_STAGES = 3;       // chunks of w in flight
constexpr int TC_THREADS = 256;
constexpr int A_LD = TC_BK + 8;    // bf16 a row of the A tile (80 bytes: conflict-free ldmatrix)
constexpr float TINY = 0x1p-80f;   // the fast division's least dividend

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

// a float32 value rounded to the weights' dtype, held as float32
template <typename T>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) { return v; }
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// ---------------------------------------------------------------------------
// The float32 route

template <typename XT, typename WT>
__global__ void __launch_bounds__(FQ_THREADS)
fakequant_matmul_f32_kernel(const XT* __restrict__ x, const WT* __restrict__ w,
                            const float* __restrict__ delta, const float* __restrict__ zp,
                            const float* __restrict__ bias, XT* __restrict__ out, int M, int N,
                            int K, long long w_sk, long long w_sn, int n_levels) {
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
        const float q = fminf(fmaxf(rintf(__fdiv_rn(to_f32(x[m * K + k]), d)), -z),
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
int launch_f32(const void* x, const void* w, const void* delta, const void* zp,
               const void* bias, void* out, int M, int N, int K, long long w_sk,
               long long w_sn, int n_levels, cudaStream_t stream) {
  dim3 grid((unsigned)((M + FQ_BM - 1) / FQ_BM), (N + FQ_BN - 1) / FQ_BN);
  fakequant_matmul_f32_kernel<XT, WT><<<grid, FQ_THREADS, 0, stream>>>(
      (const XT*)x, (const WT*)w, (const float*)delta, (const float*)zp,
      (const float*)bias, (XT*)out, M, N, K, w_sk, w_sn, n_levels);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The tensor-core route (bf16 x, bf16 w)

// w's shared bytes a stage: [BN][A_LD] for K-contiguous weights, [BK][BN + 8]
// for N-contiguous ones (strides that put the 8 rows of an ldmatrix in
// distinct banks)
__host__ __device__ constexpr int b_stage_bytes(int bn, bool kmajor) {
  return kmajor ? bn * A_LD * 2 : TC_BK * (bn + 8) * 2;
}
// the dynamic shared memory: the ring of w | two A tiles | the 3-chunk ring
// of column constants (float4 each) | the bias; the output tile
// [BM][BN + 8] bf16 reuses the ring of w
__host__ __device__ constexpr int tc_smem_bytes(int bn, bool kmajor) {
  return TC_STAGES * b_stage_bytes(bn, kmajor) + 2 * TC_BM * A_LD * 2 + 3 * TC_BK * 16 + bn * 4;
}

// a 16-byte copy into shared memory, the first `bytes` (0–16) from src and
// the rest zero (src unread where bytes is 0)
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// B fragments of columns n0 … n0 + 15 (two n8 blocks) from a [n][k] tile
// (ld words a row): one ldmatrix.x4
__device__ __forceinline__ void load_b_pair(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                            const uint32_t* s, int ld, int n0, int w0,
                                            int lane) {
  const unsigned p = (unsigned)__cvta_generic_to_shared(
      s + (n0 + (lane & 7) + ((lane >> 4) << 3)) * ld + w0 + ((lane >> 3) & 1) * 4);
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
               : "r"(p));
}
// the same from a [k][n] tile (ld bf16 a row), transposed by ldmatrix.trans
__device__ __forceinline__ void load_b_pair_trans(uint32_t (&b0)[2], uint32_t (&b1)[2],
                                                  const __nv_bfloat16* s, int ld, int n0, int k0,
                                                  int lane) {
  const unsigned p = (unsigned)__cvta_generic_to_shared(
      s + (k0 + (lane & 15)) * ld + n0 + ((lane >> 4) << 3));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(b0[0]), "=r"(b0[1]), "=r"(b1[0]), "=r"(b1[1])
               : "r"(p));
}

// w.dtype(fake_quant(x)) of one element with its column's constants c = (Δ,
// the Divisor's reciprocal, −zp, L−1−zp): for Δ in [2⁻²⁰, 2¹¹] the division
// by divide() without branches (|x| < 2⁻⁸⁰: x/Δ < 2⁻⁶⁰ rounds to ±0, as x·0;
// past 2²⁰·Δ the quotient is beyond the clamp, as x·∞), else __fdiv_rn
__device__ __forceinline__ float fq_value(float x, const float4& c) {
  float q;
  if (c.x >= 0x1p-20f && c.x <= 0x1p11f) {
    const float a = fabsf(x);
    q = a >= TINY ? (a <= __fmul_rn(c.x, 0x1p20f) ? divide(x, Divisor{c.x, c.y})
                                                 : __fmul_rn(x, INFINITY))
                  : __fmul_rn(x, 0.0f);
  } else {
    q = __fdiv_rn(x, c.x);
  }
  return __fmul_rn(fminf(fmaxf(rintf(q), c.z), c.w), c.x);
}

__device__ __forceinline__ uint32_t bf16_pair(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(lo)) |
         (uint32_t)__bfloat16_as_ushort(__float2bfloat16_rn(hi)) << 16;
}

template <int BN, bool KMAJOR>
__global__ void __launch_bounds__(TC_THREADS, 2)
fakequant_matmul_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                        const float* __restrict__ delta, const float* __restrict__ zp,
                        const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int M,
                        int N, int K, long long w_sk, long long w_sn, int n_levels, int vec_x,
                        int vec_w, int vec_out) {
  constexpr int WN = BN / 32, WM = 8 / WN, WTM = TC_BM / WM, MI = WTM / 16;
  constexpr int B_LD = KMAJOR ? A_LD : BN + 8;     // bf16 a row of a w stage
  constexpr int B_STAGE = b_stage_bytes(BN, KMAJOR);
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* bring = smem;
  __nv_bfloat16* As = reinterpret_cast<__nv_bfloat16*>(smem + TC_STAGES * B_STAGE);
  float4* cring = reinterpret_cast<float4*>(smem + TC_STAGES * B_STAGE + 2 * TC_BM * A_LD * 2);
  float* bias_s = reinterpret_cast<float*>(cring + 3 * TC_BK);

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp / WN, wn = warp % WN;
  const long long m0 = (long long)blockIdx.x * TC_BM;
  const int n0 = blockIdx.y * BN;
  const int nk = (K + TC_BK - 1) / TC_BK;
  const float top = (float)(n_levels - 1);

  for (int c = tid; c < BN; c += TC_THREADS)
    bias_s[c] = bias != nullptr && n0 + c < N ? bias[n0 + c] : 0.0f;

  // the constants of chunk `kc`'s columns into ring slot kc % 3 (warp 0)
  auto constants = [&](int kc) {
    const int k = kc * TC_BK + lane;
    float4 c = make_float4(1.0f, 1.0f, 0.0f, 0.0f);
    if (k < K) {
      const float d = delta[k], z = zp[k];
      c = make_float4(d, divisor(d).y, -z, __fsub_rn(top, z));
    }
    cring[(kc % 3) * TC_BK + lane] = c;
  };
  // chunk `kc` of w into stage s
  auto load_w = [&](int kc, int s) {
    const int k0 = kc * TC_BK;
    __nv_bfloat16* dst = reinterpret_cast<__nv_bfloat16*>(bring + s * B_STAGE);
    if (KMAJOR) {                                   // [n][k]: 4 vectors a column
      for (int e = tid; e < BN * 4; e += TC_THREADS) {
        const int c = e >> 2, kv = (e & 3) * 8, n = n0 + c, k = k0 + kv;
        if (vec_w) {
          const int bytes = n < N && k < K ? 2 * min(8, K - k) : 0;
          cp_async_zfill(dst + c * B_LD + kv, bytes ? w + n * w_sn + k : w, bytes);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            dst[c * B_LD + kv + j] = n < N && k + j < K ? w[(k + j) * w_sk + n * w_sn]
                                                        : __float2bfloat16_rn(0.0f);
        }
      }
    } else {                                        // [k][n]: BN / 8 vectors a row
      for (int e = tid; e < TC_BK * (BN / 8); e += TC_THREADS) {
        const int kk = e / (BN / 8), nv = (e % (BN / 8)) * 8, n = n0 + nv, k = k0 + kk;
        if (vec_w) {
          const int bytes = n < N && k < K ? 2 * min(8, N - n) : 0;
          cp_async_zfill(dst + kk * B_LD + nv, bytes ? w + k * w_sk + n : w, bytes);
        } else {
#pragma unroll
          for (int j = 0; j < 8; ++j)
            dst[kk * B_LD + nv + j] = n + j < N && k < K ? w[k * w_sk + (n + j) * w_sn]
                                                         : __float2bfloat16_rn(0.0f);
        }
      }
    }
  };
  // this thread's vector of chunk `kc` of x: row tid / 4, columns (tid % 4)·8 …
  const int xr = tid >> 2, xkv = (tid & 3) * 8;
  const long long xm = m0 + xr;
  auto load_x = [&](int kc) {
    const int k = kc * TC_BK + xkv;
    uint4 u = make_uint4(0, 0, 0, 0);
    if (xm < M && k < K) {
      const __nv_bfloat16* p = x + xm * K + k;
      if (vec_x) {
        u = *reinterpret_cast<const uint4*>(p);
      } else {
        uint16_t h[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) h[j] = k + j < K ? __bfloat16_as_ushort(p[j]) : 0;
        u = make_uint4(h[0] | (uint32_t)h[1] << 16, h[2] | (uint32_t)h[3] << 16,
                       h[4] | (uint32_t)h[5] << 16, h[6] | (uint32_t)h[7] << 16);
      }
    }
    return u;
  };
  // the vector fake-quantized into A tile `buf`
  auto quantize = [&](const uint4& u, int kc, int buf) {
    const float4* c = cring + (kc % 3) * TC_BK + xkv;
    const uint32_t wd[4] = {u.x, u.y, u.z, u.w};
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = bf16_pair(fq_value(__uint_as_float(wd[i] << 16), c[2 * i]),
                       fq_value(__uint_as_float(wd[i] & 0xffff0000u), c[2 * i + 1]));
    *reinterpret_cast<uint4*>(As + (buf * TC_BM + xr) * A_LD + xkv) =
        make_uint4(o[0], o[1], o[2], o[3]);
  };

  float acc[MI][4][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[i][j][v] = 0.0f;

  if (warp == 0) {
    constants(0);
    if (nk > 1) constants(1);
  }
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < nk) load_w(s, s);
    cp_async_commit();
  }
  uint4 xv = load_x(0);
  __syncthreads();
  quantize(xv, 0, 0);

  for (int kc = 0; kc < nk; ++kc) {
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    if (kc + TC_STAGES - 1 < nk) load_w(kc + TC_STAGES - 1, (kc + TC_STAGES - 1) % TC_STAGES);
    cp_async_commit();
    if (kc + 1 < nk) xv = load_x(kc + 1);
    if (kc + 2 < nk && warp == 0) constants(kc + 2);

    const uint32_t* Aw = reinterpret_cast<const uint32_t*>(As + (kc & 1) * TC_BM * A_LD);
    const unsigned char* Bs = bring + (kc % TC_STAGES) * B_STAGE;
#pragma unroll
    for (int ks = 0; ks < TC_BK / 16; ++ks) {
      uint32_t a[MI][4], b[4][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) load_a_frag(a[i], Aw, A_LD / 2, wm * WTM + i * 16, ks * 8, lane);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        if (KMAJOR)
          load_b_pair(b[j], b[j + 1], reinterpret_cast<const uint32_t*>(Bs), B_LD / 2,
                      wn * 32 + j * 8, ks * 8, lane);
        else
          load_b_pair_trans(b[j], b[j + 1], reinterpret_cast<const __nv_bfloat16*>(Bs), B_LD,
                            wn * 32 + j * 8, ks * 16, lane);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16_16816(acc[i][j], a[i], b[j]);
    }
    if (kc + 1 < nk) quantize(xv, kc + 1, (kc + 1) & 1);
  }

  // ---- epilogue: bias, cast, staged through shared memory (the ring of w)
  cp_async_wait<0>();
  __syncthreads();
  __nv_bfloat16* Os = reinterpret_cast<__nv_bfloat16*>(bring);
  constexpr int O_LD = BN + 8;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int r = wm * WTM + i * 16 + g, c = wn * 32 + j * 8 + 2 * t;
      const float b0 = bias_s[c], b1 = bias_s[c + 1];
      const float* d = acc[i][j];
      *reinterpret_cast<uint32_t*>(Os + r * O_LD + c) =
          bias ? bf16_pair(__fadd_rn(d[0], b0), __fadd_rn(d[1], b1)) : bf16_pair(d[0], d[1]);
      *reinterpret_cast<uint32_t*>(Os + (r + 8) * O_LD + c) =
          bias ? bf16_pair(__fadd_rn(d[2], b0), __fadd_rn(d[3], b1)) : bf16_pair(d[2], d[3]);
    }
  __syncthreads();
  for (int e = tid; e < TC_BM * (BN / 8); e += TC_THREADS) {
    const int r = e / (BN / 8), cv = (e % (BN / 8)) * 8;
    const long long m = m0 + r;
    const int n = n0 + cv;
    if (m >= M || n >= N) continue;
    if (vec_out && n + 8 <= N) {
      *reinterpret_cast<uint4*>(out + m * N + n) =
          *reinterpret_cast<const uint4*>(Os + r * O_LD + cv);
    } else {
      for (int j = 0; j < 8 && n + j < N; ++j) out[m * N + n + j] = Os[r * O_LD + cv + j];
    }
  }
}

template <int BN, bool KMAJOR>
int launch_tc(const void* x, const void* w, const void* delta, const void* zp, const void* bias,
              void* out, int M, int N, int K, long long w_sk, long long w_sn, int n_levels,
              cudaStream_t stream) {
  auto kern = fakequant_matmul_kernel<BN, KMAJOR>;
  constexpr int smem = tc_smem_bytes(BN, KMAJOR);
  static int set_dev = -1;                        // the attribute once per device
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != set_dev) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess) set_dev = dev;
  }
  if (e != cudaSuccess) return (int)e;
  const uintptr_t px = reinterpret_cast<uintptr_t>(x), pw = reinterpret_cast<uintptr_t>(w);
  const int vec_x = px % 16 == 0 && K % 8 == 0;
  const int vec_w = pw % 16 == 0 && (KMAJOR ? w_sn % 8 == 0 : w_sk % 8 == 0);
  const int vec_out = reinterpret_cast<uintptr_t>(out) % 16 == 0 && N % 8 == 0;
  dim3 grid((unsigned)((M + TC_BM - 1) / TC_BM), (unsigned)((N + BN - 1) / BN));
  kern<<<grid, TC_THREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, (const float*)delta, (const float*)zp,
      (const float*)bias, (__nv_bfloat16*)out, M, N, K, w_sk, w_sn, n_levels, vec_x, vec_w,
      vec_out);
  return (int)cudaGetLastError();
}

template <bool KMAJOR>
int launch_bn(int bn, const void* x, const void* w, const void* delta, const void* zp,
              const void* bias, void* out, int M, int N, int K, long long w_sk, long long w_sn,
              int n_levels, cudaStream_t s) {
  if (bn == 64) return launch_tc<64, KMAJOR>(x, w, delta, zp, bias, out, M, N, K, w_sk, w_sn,
                                             n_levels, s);
  if (bn == 128) return launch_tc<128, KMAJOR>(x, w, delta, zp, bias, out, M, N, K, w_sk, w_sn,
                                               n_levels, s);
  return launch_tc<256, KMAJOR>(x, w, delta, zp, bias, out, M, N, K, w_sk, w_sn, n_levels, s);
}

}  // namespace

// x: (M, K) float32 or bfloat16 (x_bf16), contiguous; w: (K, N) float32
// or bfloat16 (w_bf16) at element strides (w_sk, w_sn); delta, zp: (K,)
// float32; bias: (N,) float32 or NULL; out: (M, N) in x's dtype.  bn
// (ops/quant_matmul.py, fq_plan): the tensor-core route's columns a block,
// 64, 128 or 256; with bf16 x and w, w_sk or w_sn must be 1.  Other dtypes
// take the float32 route and ignore bn.
extern "C" int edm_fakequant_matmul(const void* x, const void* w, const void* delta,
                                    const void* zp, const void* bias, void* out, int x_bf16,
                                    int w_bf16, int M, int N, int K, int w_sk, int w_sn,
                                    int n_levels, int bn, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (x_bf16 && w_bf16) {
    if ((bn != 64 && bn != 128 && bn != 256) || (w_sk != 1 && w_sn != 1) ||
        (N + bn - 1) / bn > 65535)
      return (int)cudaErrorInvalidConfiguration;
    if (w_sk == 1)
      return launch_bn<true>(bn, x, w, delta, zp, bias, out, M, N, K, w_sk, w_sn, n_levels, s);
    return launch_bn<false>(bn, x, w, delta, zp, bias, out, M, N, K, w_sk, w_sn, n_levels, s);
  }
#define EDM_FQ_ARGS x, w, delta, zp, bias, out, M, N, K, w_sk, w_sn, n_levels, s
  if (x_bf16) return launch_f32<__nv_bfloat16, float>(EDM_FQ_ARGS);
  if (w_bf16) return launch_f32<float, __nv_bfloat16>(EDM_FQ_ARGS);
  return launch_f32<float, float>(EDM_FQ_ARGS);
#undef EDM_FQ_ARGS
}
