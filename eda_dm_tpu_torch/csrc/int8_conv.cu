// K1: int8 implicit-GEMM convolution with the zero-code-padding epilogue.
//
// Replaces the XLA int8 convolution of eda_dm_tpu/nn/layers.py
// (QConv._int8_forward: `lax.conv_general_dilated` on int8 codes with
// preferred_element_type=int32, and its border correction).
//
// GEMM view: M = N*Ho*Wo output pixels, N = Cout, K = kh*kw*Cin.
//   x : centered int8 activation codes, NHWC, contiguous
//   w : int8 weight codes [Cout, kh, kw, Cin] (K contiguous per channel)
// A tap that falls outside the image reads code 0 (the conv's zero padding
// of the CODE array).  Epilogue per output, in the JAX operation order:
//   corr = c * (isum[co] - border[ho,wo,co])     (c * isum[co] without pads)
//   out  = (float(acc) + corr) * scale[co] + bias[co]     -> f32 or bf16
// where c is the act recentering offset, scale = act delta * weight delta
// and border is the int32 conv of the pad indicator (computed once per
// layer and shape by the wrapper).
//
// Bound on this card: at the CIFAR shapes (K = 1152..4608) the int8 tensor
// rate bounds the work, not the bytes.  This first version runs the
// products on the CUDA cores (__dp4a) from a shared-memory tile; the
// im2col gather happens in the tile load, so no patch matrix is written.
// When Cin is a multiple of 32 a 32-byte K chunk never crosses a tap and is
// loaded as words; otherwise (conv_in, Cin = 3) K is gathered byte by byte.
#include "int8_tile.cuh"

template <bool VEC, typename OutT>
__global__ void __launch_bounds__(TILE_THREADS)
int8_conv_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ w,
                 OutT* __restrict__ out, int Nb, int H, int W, int Cin,
                 int Ho, int Wo, int Cout, int kh, int kw, int sh, int sw,
                 int pt, int pl, const float* __restrict__ isum,
                 const int* __restrict__ border, const float* __restrict__ c_ptr,
                 const float* __restrict__ scale,
                 const float* __restrict__ bias) {
  __shared__ int As[BKW][BM + SPAD];
  __shared__ int Bs[BKW][BN + SPAD];
  const long long M = (long long)Nb * Ho * Wo;
  const int Ktot = kh * kw * Cin;
  const long long m0 = (long long)blockIdx.x * BM;
  const int n0 = blockIdx.y * BN;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int kk_ld = tid & 7, r_ld = tid >> 3;

  // the output pixels whose A rows this thread loads
  int row_n[LOADS_PER_THREAD], row_h[LOADS_PER_THREAD], row_w[LOADS_PER_THREAD];
#pragma unroll
  for (int l = 0; l < LOADS_PER_THREAD; ++l) {
    const long long m = m0 + r_ld + 32 * l;
    if (m < M) {
      const int p = (int)(m % ((long long)Ho * Wo));
      row_n[l] = (int)(m / ((long long)Ho * Wo));
      row_h[l] = (p / Wo) * sh - pt;
      row_w[l] = (p % Wo) * sw - pl;
    } else {
      row_n[l] = -1;
      row_h[l] = row_w[l] = 0;
    }
  }

  int acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0;

  const int n_chunks = (Ktot + 31) / 32;
  const int chunks_per_tap = Cin / 32;        // VEC only
  for (int kc = 0; kc < n_chunks; ++kc) {
    if constexpr (VEC) {
      const int tap = kc / chunks_per_tap;
      const int ci = (kc % chunks_per_tap) * 32 + 4 * kk_ld;
      const int kr = tap / kw, ks = tap % kw;
#pragma unroll
      for (int l = 0; l < LOADS_PER_THREAD; ++l) {
        const int hi = row_h[l] + kr, wi = row_w[l] + ks;
        int v = 0;
        if (row_n[l] >= 0 && hi >= 0 && hi < H && wi >= 0 && wi < W)
          v = __ldg(reinterpret_cast<const int*>(
              x + (((long long)row_n[l] * H + hi) * W + wi) * Cin + ci));
        As[kk_ld][r_ld + 32 * l] = v;
        const int co = n0 + r_ld + 32 * l;
        Bs[kk_ld][r_ld + 32 * l] =
            co < Cout ? __ldg(reinterpret_cast<const int*>(
                            w + (long long)co * Ktot + kc * 32 + 4 * kk_ld))
                      : 0;
      }
    } else {
#pragma unroll
      for (int l = 0; l < LOADS_PER_THREAD; ++l) {
        int8_t av[4], bv[4];
        const int co = n0 + r_ld + 32 * l;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int k = kc * 32 + 4 * kk_ld + e;
          av[e] = 0;
          bv[e] = 0;
          if (k < Ktot) {
            const int tap = k / Cin, ci = k % Cin;
            const int hi = row_h[l] + tap / kw, wi = row_w[l] + tap % kw;
            if (row_n[l] >= 0 && hi >= 0 && hi < H && wi >= 0 && wi < W)
              av[e] = x[(((long long)row_n[l] * H + hi) * W + wi) * Cin + ci];
            if (co < Cout) bv[e] = w[(long long)co * Ktot + k];
          }
        }
        As[kk_ld][r_ld + 32 * l] = pack4(av[0], av[1], av[2], av[3]);
        Bs[kk_ld][r_ld + 32 * l] = pack4(bv[0], bv[1], bv[2], bv[3]);
      }
    }
    __syncthreads();
    dp4a_tile(As, Bs, acc, tx, ty);
    __syncthreads();
  }

  const float c = *c_ptr;
  const int hw = Ho * Wo;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const long long m = m0 + ty + 16 * i;
    if (m >= M) continue;
    const int p = (int)(m % hw);
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int co = n0 + tx + 16 * j;
      if (co >= Cout) continue;
      const float corr =
          border ? __fmul_rn(c, __fsub_rn(isum[co],
                                          __int2float_rn(border[(long long)p * Cout + co])))
                 : __fmul_rn(c, isum[co]);
      float v = __fmul_rn(__fadd_rn(__int2float_rn(acc[i][j]), corr), scale[co]);
      if (bias) v = __fadd_rn(v, bias[co]);
      store_out(out + m * Cout + co, v);
    }
  }
}

template <bool VEC, typename OutT>
static void launch(dim3 grid, cudaStream_t stream, const void* x, const void* w,
                   void* out, int Nb, int H, int W, int Cin, int Ho, int Wo,
                   int Cout, int kh, int kw, int sh, int sw, int pt, int pl,
                   const void* isum, const void* border, const void* c,
                   const void* scale, const void* bias) {
  int8_conv_kernel<VEC, OutT><<<grid, TILE_THREADS, 0, stream>>>(
      (const int8_t*)x, (const int8_t*)w, (OutT*)out, Nb, H, W, Cin, Ho, Wo,
      Cout, kh, kw, sh, sw, pt, pl, (const float*)isum, (const int*)border,
      (const float*)c, (const float*)scale, (const float*)bias);
}

extern "C" int edm_int8_conv(const void* x, const void* w, void* out,
                             int out_bf16, int Nb, int H, int W, int Cin,
                             int Ho, int Wo, int Cout, int kh, int kw, int sh,
                             int sw, int pt, int pl, const void* isum,
                             const void* border, const void* c,
                             const void* scale, const void* bias,
                             void* stream) {
  const long long M = (long long)Nb * Ho * Wo;
  dim3 grid((unsigned)((M + BM - 1) / BM), (Cout + BN - 1) / BN);
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = Cin % 32 == 0;
#define EDM_CONV_ARGS grid, s, x, w, out, Nb, H, W, Cin, Ho, Wo, Cout, kh, kw, \
                      sh, sw, pt, pl, isum, border, c, scale, bias
  if (vec && out_bf16) launch<true, __nv_bfloat16>(EDM_CONV_ARGS);
  else if (vec) launch<true, float>(EDM_CONV_ARGS);
  else if (out_bf16) launch<false, __nv_bfloat16>(EDM_CONV_ARGS);
  else launch<false, float>(EDM_CONV_ARGS);
#undef EDM_CONV_ARGS
  return (int)cudaGetLastError();
}
