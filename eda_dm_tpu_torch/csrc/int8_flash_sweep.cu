// K5's sweep route: tiled int8 attention over centered codes, three sweeps.
//
// K5 proper (int8_flash_attention.cu) computes each logit once, holding a
// row tile's logits in the shared memory of a thread-block cluster.  Where
// a shape's logits do not fit there (Skv past what eight blocks hold, or a
// head wider than its 512 columns: ops/int8_attention.py, flash_plan), the
// wrapper launches this kernel instead, which keeps no row of logits and
// sweeps the keys three times.  It is K5 as it stood before that redesign,
// unchanged but for its names; its launches count under int8_flash_sweep.
//
// Replaces the Pallas kernel of eda_dm_tpu/ops/pallas_attention.py
// (int8_flash_attention, `_flash_kernel`; heads front-end
// int8_flash_attention_heads).  Per (b·h) element, Q is (Sq, C) and K/V
// are (Skv, C) int8 codes (Sq ≠ Skv allowed); sc holds K4's seven f32
// scalars [cq, ck, cv, lsc = dq·dk·attn_scale, dw, zw, dwdv = dw·dv].  The
// function is K4's (int8_attention.cu) with Skv keys:
//
//   logits = (((QKᵀ + ck·Σq) + cq·Σk) + (cq·ck)·C) · lsc
//   w      = exp(logits − rowmax) / rowsum
//            (rowsum: the exponentials added in f64, rounded once to f32)
//   W      = clip(rint(w / dw), −zw, L−1−zw) − (L/2 − zw)    (codes)
//   out    = (((W·V + cv·ΣW) + cw·ΣV) + (cw·cv)·Skv) · dwdv
//
// each f32 step rounded on its own (__fadd_rn / __fmul_rn / __fdiv_rn), the
// codes taken after the final division.  The TPU kernel's first pass keeps
// a running f32 max and a rescaled normalizer, whose value depends on the
// tile order; a probability on a rounding tie of its code then takes
// another code, and on a random-weight UNet one such flip cascades.  So
// this kernel sweeps the key/value tiles three times, and each sweep
// computes something that does not depend on the order of the tiles:
//   (a) the row max (exact in any order);
//   (b) the f64 sum of expf(logit − max), rounded once to f32;
//   (c) the codes, W·V accumulated in int32 (|ΣW·V| passes 2²⁴ at
//       Skv = 4096, where an f32 sum is no longer exact) and ΣW.
// The logits never leave the block: each sweep recomputes its tile of
// them from Q and the key tile in shared memory.
//
// Design: one block per (b·h, tile of FQ = 64 query rows, chunk of FCH =
// 64 output columns); blockIdx.x walks b·h × query tiles, so any b·h is
// accepted; blockIdx.y walks the column chunks (one for C ≤ 64; wider
// heads repeat the sweeps per chunk).  The logits' products walk C in
// chunks of at most FCC = 1024 columns, the chunk of the query tile and of
// the key tile resident in shared memory: a head of at most FCC columns
// keeps its query tile for all three sweeps; a wider one reloads its query
// chunks with each key tile and adds Q·Kᵀ, Σq and Σk across the chunks in
// int32, which is exact, so every C gives the same function.  256
// threads: thread (tx, ty) owns
// query rows ty + 16·m (m < 4) and, in the logits tile, keys 4·tx .. +3,
// in W·V output columns 4·tx .. +3.  Key tiles of FJ = 64 rows, stored as
// 32-bit words transposed ([word][key]) so a thread reads its four keys
// as one int4; V tiles transposed with byte permutes ([key word][column])
// so that __dp4a packs four keys.  Row statistics reduce over the 16 lanes
// that share a row.  Σq, Σk, ΣV come from __dp4a against 0x01010101.
//
// Bound on this card, at the SD v1.4 64×64 shape (N = 64, Sq = Skv =
// 4096, C = 40): the Sq·Skv exponentials on the SFUs (16 per clock per SM),
// then the 4·Sq·Skv·C int8 operations; the bytes (Sq·C + 2·Skv·C in, 4·Sq·C
// out per element) are far below both.  This first version runs the
// products on the CUDA cores (__dp4a), computes each logit three times
// and each exponential twice: tensor cores and fewer sweeps are later work.
//
// codes_out (optional, test use): the int8 codes W, (N, Sq, Skv).
#include "int8_tile.cuh"

#include <climits>
#include <cmath>

#define FA_THREADS 256
#define FQ 64          // query rows per block
#define FJ 64          // keys per tile
#define FCH 64         // output columns per block
#define FCC 1024       // columns of Q and K resident a chunk
#define FPAD 4         // words of padding per shared row
#define WROW (FJ / 4 + 1)

__device__ __forceinline__ int ones_dot(int w, int acc) {
  return __dp4a(w, 0x01010101, acc);
}

// sums / maxima over the 16 lanes of a half warp (lanes that share a row)
__device__ __forceinline__ int sum16(int v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ double sum16(double v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v = __dadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}
__device__ __forceinline__ float max16(float v) {
#pragma unroll
  for (int o = 8; o; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__global__ void __launch_bounds__(FA_THREADS)
int8_flash_sweep_kernel(const int8_t* __restrict__ Q, const int8_t* __restrict__ K,
                            const int8_t* __restrict__ V, const float* __restrict__ sc,
                            float* __restrict__ out, int8_t* __restrict__ codes_out,
                            int Sq, int Skv, int C, int n_levels_w, int qtiles) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int Cw = C >> 2;                                    // words of a row
  const int Cs = Cw < FCC / 4 ? Cw : FCC / 4;               // words of a chunk
  const bool resident = Cw == Cs;                           // one chunk: Q loaded once
  int* Qs = reinterpret_cast<int*>(smem);                  // [Cs][FQ + FPAD]
  int* Ks = Qs + Cs * (FQ + FPAD);                          // [Cs][FJ + FPAD]
  int* VT = Ks + Cs * (FJ + FPAD);                          // [FJ/4][FCH + FPAD]
  int* Ws = VT + (FJ / 4) * (FCH + FPAD);                   // [FQ][WROW]
  int* sq = Ws + FQ * WROW;                                 // Σq [FQ]
  int* sk = sq + FQ;                                        // Σk [FJ]
  int* svs = sk + FJ;                                       // ΣV [FCH]

  const long long n = blockIdx.x / qtiles;
  const int i0 = (blockIdx.x % qtiles) * FQ;
  const int c0 = blockIdx.y * FCH;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int* Q32 = reinterpret_cast<const int*>(Q + n * Sq * C);
  const int* K32 = reinterpret_cast<const int*>(K + n * Skv * C);
  const int8_t* Vn = V + n * Skv * C;

  const float cq = sc[0], ck = sc[1], cv = sc[2], lsc = sc[3];
  const float dw = sc[4], zw = sc[5], dwdv = sc[6];
  const float cqckC = __fmul_rn(__fmul_rn(cq, ck), (float)C);

  // words [w0, w0 + cn) of the query tile's rows, and of a key tile's
  auto load_q = [&](int w0, int cn) {
    for (int idx = tid; idx < FQ * cn; idx += FA_THREADS) {
      const int r = idx / cn, w = idx - r * cn;
      Qs[w * (FQ + FPAD) + r] =
          (i0 + r < Sq) ? __ldg(Q32 + (long long)(i0 + r) * Cw + w0 + w) : 0;
    }
  };
  auto load_k = [&](int j0, int w0, int cn) {
    for (int idx = tid; idx < FJ * cn; idx += FA_THREADS) {
      const int r = idx / cn, w = idx - r * cn;
      Ks[w * (FJ + FPAD) + r] =
          (j0 + r < Skv) ? __ldg(K32 + (long long)(j0 + r) * Cw + w0 + w) : 0;
    }
  };

  // Σq, and the query tile resident for all three sweeps where it fits
  {
    int s = 0;
    for (int w0 = 0; w0 < Cw; w0 += Cs) {
      const int cn = Cw - w0 < Cs ? Cw - w0 : Cs;
      __syncthreads();
      load_q(w0, cn);
      __syncthreads();
      if (tid < FQ)
        for (int w = 0; w < cn; ++w) s = ones_dot(Qs[w * (FQ + FPAD) + tid], s);
    }
    if (tid < FQ) sq[tid] = s;
  }
  __syncthreads();
  float qterm[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) qterm[m] = __fmul_rn(ck, __int2float_rn(sq[ty + 16 * m]));

  // one 64 × 64 tile of logits: rows ty + 16·m, keys j0 + 4·tx + k
  auto logits_tile = [&](int j0, float (&lg)[4][4]) {
    int acc[4][4];
#pragma unroll
    for (int m = 0; m < 4; ++m) acc[m][0] = acc[m][1] = acc[m][2] = acc[m][3] = 0;
    int s = 0;
    for (int w0 = 0; w0 < Cw; w0 += Cs) {
      const int cn = Cw - w0 < Cs ? Cw - w0 : Cs;
      __syncthreads();                         // the last chunk's readers are done
      if (!resident) load_q(w0, cn);
      load_k(j0, w0, cn);
      __syncthreads();
      if (tid < FJ)
        for (int w = 0; w < cn; ++w) s = ones_dot(Ks[w * (FJ + FPAD) + tid], s);
      for (int kk = 0; kk < cn; ++kk) {
        const int4 b = *reinterpret_cast<const int4*>(&Ks[kk * (FJ + FPAD) + tx * 4]);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int a = Qs[kk * (FQ + FPAD) + ty + 16 * m];
          acc[m][0] = __dp4a(a, b.x, acc[m][0]);
          acc[m][1] = __dp4a(a, b.y, acc[m][1]);
          acc[m][2] = __dp4a(a, b.z, acc[m][2]);
          acc[m][3] = __dp4a(a, b.w, acc[m][3]);
        }
      }
    }
    if (tid < FJ) sk[tid] = s;                 // its last readers passed the loop's barrier
    __syncthreads();                           // Σk written
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float kterm = __fmul_rn(cq, __int2float_rn(sk[tx * 4 + k]));
#pragma unroll
      for (int m = 0; m < 4; ++m) {
        float l = __fadd_rn(__int2float_rn(acc[m][k]), qterm[m]);
        l = __fadd_rn(l, kterm);
        l = __fadd_rn(l, cqckC);
        lg[m][k] = __fmul_rn(l, lsc);
      }
    }
  };

  float lg[4][4];

  // ---- sweep (a): row max
  float mrow[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};
  for (int j0 = 0; j0 < Skv; j0 += FJ) {
    logits_tile(j0, lg);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (j0 + tx * 4 + k < Skv) {
#pragma unroll
        for (int m = 0; m < 4; ++m) mrow[m] = fmaxf(mrow[m], lg[m][k]);
      }
  }
#pragma unroll
  for (int m = 0; m < 4; ++m) mrow[m] = max16(mrow[m]);

  // ---- sweep (b): the f64 row sum of the exponentials
  double s64[4] = {0.0, 0.0, 0.0, 0.0};
  for (int j0 = 0; j0 < Skv; j0 += FJ) {
    logits_tile(j0, lg);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      if (j0 + tx * 4 + k < Skv) {
#pragma unroll
        for (int m = 0; m < 4; ++m)
          s64[m] = __dadd_rn(s64[m], (double)expf(__fsub_rn(lg[m][k], mrow[m])));
      }
  }
  float srow[4];
#pragma unroll
  for (int m = 0; m < 4; ++m) srow[m] = __double2float_rn(sum16(s64[m]));

  // ---- sweep (c): codes, ΣW and W·V in int32
  const float cw = __fsub_rn(0.5f * (float)n_levels_w, zw);
  const float lo = -zw, hi = __fsub_rn((float)(n_levels_w - 1), zw);
  const int g_ld = tid >> 4, w_ld = tid & 15;      // V loader: column group, key word
  int swrow[4] = {0, 0, 0, 0};
  int sv_run[4] = {0, 0, 0, 0};
  int acc2[4][4];
#pragma unroll
  for (int m = 0; m < 4; ++m) acc2[m][0] = acc2[m][1] = acc2[m][2] = acc2[m][3] = 0;
  const bool write_codes = codes_out != nullptr && blockIdx.y == 0;
  for (int j0 = 0; j0 < Skv; j0 += FJ) {
    logits_tile(j0, lg);
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      int8_t c4[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        int code = 0;
        if (j0 + tx * 4 + k < Skv) {
          const float e = expf(__fsub_rn(lg[m][k], mrow[m]));
          const float w = __fdiv_rn(e, srow[m]);
          const float q = fminf(fmaxf(rintf(__fdiv_rn(w, dw)), lo), hi);
          code = __float2int_rn(__fsub_rn(q, cw));
        }
        swrow[m] += code;
        c4[k] = (int8_t)code;
      }
      const int r = ty + 16 * m;
      Ws[r * WROW + tx] = pack4(c4[0], c4[1], c4[2], c4[3]);
      if (write_codes && i0 + r < Sq) {
        int8_t* crow = codes_out + (n * Sq + i0 + r) * Skv + j0 + tx * 4;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (j0 + tx * 4 + k < Skv) crow[k] = c4[k];
      }
    }
    {   // the V tile, 4 keys × 4 columns per thread, transposed
      const int cg = c0 + 4 * g_ld, jr = j0 + 4 * w_ld;
      int r4[4];
#pragma unroll
      for (int b = 0; b < 4; ++b)
        r4[b] = (cg < C && jr + b < Skv)
            ? __ldg(reinterpret_cast<const int*>(Vn + (long long)(jr + b) * C + cg)) : 0;
      const int t0 = __byte_perm(r4[0], r4[1], 0x5140);
      const int t1 = __byte_perm(r4[2], r4[3], 0x5140);
      const int t2 = __byte_perm(r4[0], r4[1], 0x7362);
      const int t3 = __byte_perm(r4[2], r4[3], 0x7362);
      const int4 col = make_int4(__byte_perm(t0, t1, 0x5410), __byte_perm(t0, t1, 0x7632),
                                 __byte_perm(t2, t3, 0x5410), __byte_perm(t2, t3, 0x7632));
      *reinterpret_cast<int4*>(&VT[w_ld * (FCH + FPAD) + 4 * g_ld]) = col;
      sv_run[0] = ones_dot(col.x, sv_run[0]);
      sv_run[1] = ones_dot(col.y, sv_run[1]);
      sv_run[2] = ones_dot(col.z, sv_run[2]);
      sv_run[3] = ones_dot(col.w, sv_run[3]);
    }
    __syncthreads();
    if (c0 + 4 * tx < C) {
#pragma unroll 4
      for (int kw = 0; kw < FJ / 4; ++kw) {
        const int4 b = *reinterpret_cast<const int4*>(&VT[kw * (FCH + FPAD) + tx * 4]);
#pragma unroll
        for (int m = 0; m < 4; ++m) {
          const int a = Ws[(ty + 16 * m) * WROW + kw];
          acc2[m][0] = __dp4a(a, b.x, acc2[m][0]);
          acc2[m][1] = __dp4a(a, b.y, acc2[m][1]);
          acc2[m][2] = __dp4a(a, b.z, acc2[m][2]);
          acc2[m][3] = __dp4a(a, b.w, acc2[m][3]);
        }
      }
    }
  }

  // ---- epilogue: out = (((W·V + cv·ΣW) + cw·ΣV) + (cw·cv)·Skv) · dwdv
#pragma unroll
  for (int m = 0; m < 4; ++m) swrow[m] = sum16(swrow[m]);
#pragma unroll
  for (int k = 0; k < 4; ++k) sv_run[k] = sum16(sv_run[k]);
  if (w_ld == 0) {
#pragma unroll
    for (int k = 0; k < 4; ++k) svs[4 * g_ld + k] = sv_run[k];
  }
  __syncthreads();
  const float cwcvS = __fmul_rn(__fmul_rn(cw, cv), (float)Skv);
  const int c = c0 + 4 * tx;
  if (c < C) {                                          // C % 4 == 0
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      const int i = i0 + ty + 16 * m;
      if (i >= Sq) continue;
      const float wterm = __fmul_rn(cv, __int2float_rn(swrow[m]));
      float v[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        float o = __fadd_rn(__int2float_rn(acc2[m][k]), wterm);
        o = __fadd_rn(o, __fmul_rn(cw, __int2float_rn(svs[4 * tx + k])));
        o = __fadd_rn(o, cwcvS);
        v[k] = __fmul_rn(o, dwdv);
      }
      *reinterpret_cast<float4*>(out + (n * Sq + i) * C + c) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  }
}

extern "C" int edm_int8_flash_sweep(const void* Q, const void* K, const void* V,
                                        const void* sc, void* out, void* codes,
                                        int N, int Sq, int Skv, int C, int n_levels_w,
                                        void* stream) {
  if (N <= 0 || Sq <= 0 || Skv <= 0 || C <= 0 || C % 4) return (int)cudaErrorInvalidValue;
  const int qtiles = (Sq + FQ - 1) / FQ;
  const long long blocks = (long long)N * qtiles;
  if (blocks > INT_MAX || (C + FCH - 1) / FCH > 65535) return (int)cudaErrorInvalidConfiguration;
  const int Cw = (C < FCC ? C : FCC) / 4;      // words of a resident chunk
  const size_t smem = 4 * ((size_t)Cw * (FQ + FPAD) + (size_t)Cw * (FJ + FPAD)
                           + (FJ / 4) * (FCH + FPAD) + FQ * WROW + FQ + FJ + FCH);
  cudaError_t e = cudaFuncSetAttribute(int8_flash_sweep_kernel,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)blocks, (unsigned)((C + FCH - 1) / FCH));
  int8_flash_sweep_kernel<<<grid, FA_THREADS, smem, (cudaStream_t)stream>>>(
      (const int8_t*)Q, (const int8_t*)K, (const int8_t*)V, (const float*)sc,
      (float*)out, (int8_t*)codes, Sq, Skv, C, n_levels_w, qtiles);
  return (int)cudaGetLastError();
}
