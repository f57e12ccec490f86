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
// Bound on this card: at the CIFAR 3x3 convs (K = 1152..4608) the int8
// tensor rate bounds the work, not the bytes (151 GOP against 0.2 GB at
// batch 500); SD's 1x1 convs (K = 320..1280) are bound by their bytes.
//
// Design: the tensor-core mainloop of int8_gemm.cuh (mma.sync m16n8k32
// fed by a cp.async ring), with the weights as its B operand (rows of K
// codes, RowLoader) and A gathered from the NHWC codes as each tile is
// loaded (ConvLoader): no patch matrix is written.  A thread copies the
// same K offset of each step for a few rows of the tile, so it keeps the
// first input pixel of each of its rows (computed once per tile) and one
// cursor (tap row, tap column, channel) of its K offset, moved on by the
// step's bytes with no division.  A tap in the padding, a row past M and
// K past kh*kw*Cin copy zero codes (cp.async's src-size 0), which the
// border term of the epilogue expects.  Routes, fixed per launch by the
// wrapper (ops/int8_conv.py::conv_plan): 16-byte copies where Cin % 16 ==
// 0 (a copy never crosses a tap, though a K step may), 8-byte where Cin %
// 8 == 0, else a byte gather into 32-bit shared stores (conv_in, Cin = 3
// or 4).  The wrapper also picks the tile: 128 pixels by 128 channels on
// 8 warps, or by 64 on 4 where Cout <= 64 (conv_out, Cout = 3 or 4).  One
// step and ring a route: on the 16-byte route 128-byte steps in 2 slots,
// on the H100 level with 3 slots on the 128 x 128 tile and the fastest on
// the 128 x 64 one, among 64/128-byte steps and 2-4 slots
// (probes/conv_plans.py, which rebuilds this file with the K1_* macros
// below set otherwise); the shared header's 64-byte steps in 4 slots on
// the narrow routes.  The epilogue reads a border row only for a pixel
// with a tap in the padding (the rim): elsewhere the row is 0.
#include "int8_tile.cuh"
#include "int8_gemm.cuh"

namespace {

// the 16-byte route's K step (bytes) and ring (slots): probes/conv_plans.py
// builds other values to time them
#ifndef K1_KSTEP
#define K1_KSTEP 128
#endif
#ifndef K1_STAGES
#define K1_STAGES 2
#endif

constexpr int CONV_TILE_M = 128;

// the convolution: NHWC codes x (Nb, H, W, Cin), kh x kw taps, strides,
// top and left pads, output pixels M = Nb*Ho*Wo
struct ConvGeom {
  const int8_t* x;
  int H, W, Cin, Ho, Wo, kh, kw, sh, sw, pt, pl;
  long long M;
};

// The implicit im2col A operand of gemm_loop: row m is output pixel m, K
// runs over (tap row r, tap column s, channel ci) as the weight rows do.
// Thread tid copies bytes kc .. kc + UNIT - 1 of each KS-byte step of rows
// tid / PER_ROW + i * ROW_STEP; load() is called once a step, in K order.
template <int ROWS, int THREADS, int ROUTE, int KS>
struct ConvLoader {
  static constexpr int UNIT = i8gemm::copy_bytes<ROUTE>(), PER_ROW = KS / UNIT;
  static constexpr int ROW_STEP = THREADS / PER_ROW, N_ROWS = ROWS / ROW_STEP;
  static constexpr int LD = i8gemm::row_bytes(KS);
  static_assert(THREADS % PER_ROW == 0 && ROWS % ROW_STEP == 0, "copies must split evenly");

  const int8_t* x;
  int H, W, Cin, kh, kw;
  int pix[N_ROWS];          // input pixel of each row's tap (0, 0), or any
  int hb[N_ROWS], wb[N_ROWS];   // its row and column (hb far negative past M)
  int kc, r, s, ci;         // this thread's K offset of a step, and its cursor
  int dr, ds, dci;          // KS bytes as tap rows, tap columns and channels

  __device__ __forceinline__ ConvLoader(const ConvGeom& g, long long m0, int tid)
      : x(g.x), H(g.H), W(g.W), Cin(g.Cin), kh(g.kh), kw(g.kw) {
    const int hw = g.Ho * g.Wo;
#pragma unroll
    for (int i = 0; i < N_ROWS; ++i) {
      const long long m = m0 + (unsigned)tid / PER_ROW + i * ROW_STEP;
      if (m < g.M) {
        const int n = (int)(m / hw), p = (int)(m - (long long)n * hw);
        const int ho = p / g.Wo, wo = p - ho * g.Wo;
        hb[i] = ho * g.sh - g.pt;
        wb[i] = wo * g.sw - g.pl;
        pix[i] = (n * g.H + hb[i]) * g.W + wb[i];
      } else {
        hb[i] = -(1 << 30);
        wb[i] = pix[i] = 0;
      }
    }
    kc = (int)((unsigned)tid % PER_ROW) * UNIT;
    const int tap = kc / Cin, q = KS / Cin;
    ci = kc - tap * Cin;
    r = tap / kw;
    s = tap - r * kw;
    dci = KS - q * Cin;
    dr = q / kw;
    ds = q - dr * kw;
  }

  // cursor (r, s, c) one step of `dc` channels, `dsc` tap columns and `drr`
  // tap rows on (dc < Cin, dsc < kw)
  __device__ __forceinline__ void step(int& rr, int& sc, int& c, int drr, int dsc,
                                       int dc) const {
    c += dc;
    if (c >= Cin) {
      c -= Cin;
      ++sc;
    }
    sc += dsc;
    if (sc >= kw) {
      sc -= kw;
      ++rr;
    }
    rr += drr;
  }

  // one code of row i at cursor (rr, sc, c): 0 in the padding and past K
  __device__ __forceinline__ bool inside(int i, int rr, int sc) const {
    return rr < kh && (unsigned)(hb[i] + rr) < (unsigned)H && (unsigned)(wb[i] + sc) < (unsigned)W;
  }

  __device__ __forceinline__ void load(uint8_t* st, int /*k0*/, int tid) {
    uint8_t* dst = st + (unsigned)tid / PER_ROW * LD + kc;
    if constexpr (ROUTE == i8gemm::ROUTE_GATHER) {
      // the word's four codes k .. k + 3, each with its own cursor
      int br[4], bs[4], bc[4];
      br[0] = r;
      bs[0] = s;
      bc[0] = ci;
#pragma unroll
      for (int b = 1; b < 4; ++b) {
        br[b] = br[b - 1];
        bs[b] = bs[b - 1];
        bc[b] = bc[b - 1];
        step(br[b], bs[b], bc[b], 0, 0, 1);
      }
#pragma unroll
      for (int i = 0; i < N_ROWS; ++i) {
        uint32_t word = 0u;
#pragma unroll
        for (int b = 0; b < 4; ++b)
          if (inside(i, br[b], bs[b]))
            word |= (uint32_t)(uint8_t)__ldg(
                        x + (long long)(pix[i] + br[b] * W + bs[b]) * Cin + bc[b])
                    << (8 * b);
        *reinterpret_cast<uint32_t*>(dst + i * ROW_STEP * LD) = word;
      }
    } else {
      const int toff = r * W + s;
#pragma unroll
      for (int i = 0; i < N_ROWS; ++i) {
        const bool v = inside(i, r, s);
        const int8_t* src = v ? x + (long long)(pix[i] + toff) * Cin + ci : x;
        uint8_t* d = dst + i * ROW_STEP * LD;
        if constexpr (ROUTE == i8gemm::ROUTE_16) i8gemm::cp_async_16(d, src, v);
        else i8gemm::cp_async_8(d, src, v);
      }
    }
    step(r, s, ci, dr, ds, dci);
  }
};

// two outputs of a row (columns n, n + 1) at p: one float2 / bf16x2 where
// `pair` (an even row length keeps p 8- or 4-byte aligned)
__device__ __forceinline__ void store2(float* p, float a, float b, bool pair) {
  if (pair) *reinterpret_cast<float2*>(p) = make_float2(a, b);
  else { p[0] = a; p[1] = b; }
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b, bool pair) {
  if (pair) {
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  } else {
    p[0] = __float2bfloat16_rn(a);
    p[1] = __float2bfloat16_rn(b);
  }
}

// A lane's four outputs of row m of a row-major (M, N) output: columns n,
// n + 1 (v0, v1) and n + 8, n + 9 (w0, w1), as for_each_pair hands them
// over; rows past M and columns past N are dropped.  A row's columns go
// out as whole 32-byte sectors, as K8's epilogue stores them
// (quantized_matmul.cu): float2 pairs where N is even, and for bf16 where
// N % 4 == 0 four columns a lane, two taken from the neighbouring lane.
// Every lane makes this call.
template <typename T>
__device__ __forceinline__ void store_row(T* out, long long m, long long M, int n, int N,
                                          float v0, float v1, float w0, float w1) {
  if constexpr (sizeof(T) == 2) {
    if ((N & 3) == 0) {
      // the lane of even t keeps columns n, n + 1 and takes its
      // neighbour's n + 2, n + 3; the odd one takes the neighbour's n + 6,
      // n + 7 and keeps n + 8, n + 9
      const bool even = ((threadIdx.x & 1) == 0);
      const float s0 = __shfl_xor_sync(0xffffffffu, even ? w0 : v0, 1);
      const float s1 = __shfl_xor_sync(0xffffffffu, even ? w1 : v1, 1);
      const int n4 = even ? n : n + 6;
      if (m >= M || n4 >= N) return;
      const __nv_bfloat162 lo = even ? __floats2bfloat162_rn(v0, v1)
                                     : __floats2bfloat162_rn(s0, s1);
      const __nv_bfloat162 hi = even ? __floats2bfloat162_rn(s0, s1)
                                     : __floats2bfloat162_rn(w0, w1);
      uint2 u;
      u.x = *reinterpret_cast<const uint32_t*>(&lo);
      u.y = *reinterpret_cast<const uint32_t*>(&hi);
      *reinterpret_cast<uint2*>(out + m * N + n4) = u;
      return;
    }
  }
  if (m >= M) return;
  const bool pair = (N & 1) == 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int c = n + 8 * h;
    const float a = h ? w0 : v0, b = h ? w1 : v1;
    if (c + 1 < N) store2(out + m * N + c, a, b, pair);
    else if (c < N) store_out(out + m * N + c, a);
  }
}

// what the epilogue reads of columns n and n + 1
struct ConvColumns {
  float isum0, isum1, scale0, scale1, bias0, bias1;
};

template <typename OutT>
struct ConvEpilogue {
  OutT* out;
  ConvGeom g;
  int N, hw;                  // Cout, Ho*Wo
  const float* isum;
  const int* border;          // (Ho*Wo, Cout) or null
  float c;
  const float* scale;
  const float* bias;          // or null

  __device__ __forceinline__ ConvColumns columns(int n) const {
    ConvColumns k{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (n < N) {
      k.isum0 = __ldg(isum + n);
      k.scale0 = __ldg(scale + n);
      if (bias) k.bias0 = __ldg(bias + n);
    }
    if (n + 1 < N) {
      k.isum1 = __ldg(isum + n + 1);
      k.scale1 = __ldg(scale + n + 1);
      if (bias) k.bias1 = __ldg(bias + n + 1);
    }
    return k;
  }

  // border row of output row m (M < 2^31, as the wrapper checks), or null
  // where every tap of the pixel lies in the image: border is 0 there, and
  // c * (isum - 0) == c * isum, so the row skips the reads
  __device__ __forceinline__ const int* border_row(long long m) const {
    if (!border || m >= g.M) return nullptr;
    const int p = (int)m % hw, ho = p / g.Wo, wo = p - ho * g.Wo;
    const int h0 = ho * g.sh - g.pt, w0 = wo * g.sw - g.pl;
    const bool rim = h0 < 0 || h0 + g.kh > g.H || w0 < 0 || w0 + g.kw > g.W;
    return rim ? border + (long long)p * N : nullptr;
  }

  // column n of a row whose border row is brow (null: no tap in the pads)
  __device__ __forceinline__ float value(int acc, const int* brow, int n, float is, float sc,
                                         float b) const {
    if (n >= N) return 0.f;
    const float corr = brow ? __fmul_rn(c, __fsub_rn(is, __int2float_rn(__ldg(brow + n))))
                            : __fmul_rn(c, is);
    float v = __fmul_rn(__fadd_rn(__int2float_rn(acc), corr), sc);
    if (bias) v = __fadd_rn(v, b);
    return v;
  }

  __device__ __forceinline__ void operator()(long long m, int n, const ConvColumns& c0, int a0,
                                             int a1, const ConvColumns& c1, int b0,
                                             int b1) const {
    const int* brow = border_row(m);
    const float v0 = value(a0, brow, n, c0.isum0, c0.scale0, c0.bias0);
    const float v1 = value(a1, brow, n + 1, c0.isum1, c0.scale1, c0.bias1);
    const float w0 = value(b0, brow, n + 8, c1.isum0, c1.scale0, c1.bias0);
    const float w1 = value(b1, brow, n + 9, c1.isum1, c1.scale1, c1.bias1);
    store_row(out, m, g.M, n, N, v0, v1, w0, w1);
  }
};

// TILE_N channels a tile on 2 x TILE_N / 32 warps
template <int TILE_N, int KS, int NSTAGE, int ROUTE, typename OutT>
__global__ void __launch_bounds__(2 * TILE_N, 256 / TILE_N)
int8_conv_kernel(ConvGeom g, const int8_t* __restrict__ w, OutT* __restrict__ out, int Cout,
                 const float* __restrict__ isum, const int* __restrict__ border,
                 const float* __restrict__ c_ptr, const float* __restrict__ scale,
                 const float* __restrict__ bias) {
  constexpr int THREADS = 2 * TILE_N;
  extern __shared__ __align__(16) uint8_t smem[];
  const long long m0 = (long long)blockIdx.x * CONV_TILE_M;
  const int n0 = blockIdx.y * TILE_N, K = g.kh * g.kw * g.Cin;
  ConvLoader<CONV_TILE_M, THREADS, ROUTE, KS> la(g, m0, threadIdx.x);
  i8gemm::RowLoader<TILE_N, THREADS, ROUTE, KS> lb{i8gemm::Operand{w, Cout, K}, n0, K};
  const ConvEpilogue<OutT> epi{out, g, Cout, g.Ho * g.Wo, isum, border, *c_ptr, scale, bias};
  i8gemm::gemm_loop<CONV_TILE_M, TILE_N, 2, TILE_N / 32, KS, NSTAGE>(la, lb, K, m0, n0, smem,
                                                                     epi);
}

struct ConvArgs {
  ConvGeom g;
  const void *w, *isum, *border, *c, *scale, *bias;
  void* out;
  int Cout;
  cudaStream_t stream;
};

template <int TILE_N, int KS, int NSTAGE, int ROUTE, typename OutT>
int launch(const ConvArgs& a) {
  auto kernel = int8_conv_kernel<TILE_N, KS, NSTAGE, ROUTE, OutT>;
  constexpr int smem = i8gemm::tile_smem<CONV_TILE_M, TILE_N, KS, NSTAGE>();
  static_assert(smem <= 227 * 1024, "a block's ring must fit an SM's shared memory");
  static int allowed = 48 * 1024;
  const cudaError_t e = i8gemm::allow_smem(kernel, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((unsigned)((a.g.M + CONV_TILE_M - 1) / CONV_TILE_M),
                  (a.Cout + TILE_N - 1) / TILE_N);
  kernel<<<grid, 2 * TILE_N, smem, a.stream>>>(
      a.g, (const int8_t*)a.w, (OutT*)a.out, a.Cout, (const float*)a.isum,
      (const int*)a.border, (const float*)a.c, (const float*)a.scale, (const float*)a.bias);
  return (int)cudaGetLastError();
}

template <int TILE_N, typename OutT>
int launch_route(int route, const ConvArgs& a) {
  constexpr int KS = i8gemm::KSTEP, NS = i8gemm::STAGES;
  switch (route) {
    case i8gemm::ROUTE_16: return launch<TILE_N, K1_KSTEP, K1_STAGES, i8gemm::ROUTE_16, OutT>(a);
    case i8gemm::ROUTE_8: return launch<TILE_N, KS, NS, i8gemm::ROUTE_8, OutT>(a);
    case i8gemm::ROUTE_GATHER: return launch<TILE_N, KS, NS, i8gemm::ROUTE_GATHER, OutT>(a);
    default: return (int)cudaErrorInvalidValue;
  }
}

template <typename OutT>
int launch_tile(int tile, int route, const ConvArgs& a) {
  if (tile == 0) return launch_route<128, OutT>(route, a);
  if (tile == 1) return launch_route<64, OutT>(route, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// tile: 0 = 128 x 128, 1 = 128 x 64; route: 16, 8 or 1 (the gather).  The
// wrapper (ops/int8_conv.py::conv_plan) chooses them, the route by Cin
// and both operands' alignment.
extern "C" int edm_int8_conv(const void* x, const void* w, void* out, int out_bf16, int Nb,
                             int H, int W, int Cin, int Ho, int Wo, int Cout, int kh, int kw,
                             int sh, int sw, int pt, int pl, const void* isum,
                             const void* border, const void* c, const void* scale,
                             const void* bias, int tile, int route, void* stream) {
  const ConvArgs a{ConvGeom{(const int8_t*)x, H, W, Cin, Ho, Wo, kh, kw, sh, sw, pt, pl,
                            (long long)Nb * Ho * Wo},
                   w, isum, border, c, scale, bias, out, Cout, (cudaStream_t)stream};
  return out_bf16 ? launch_tile<__nv_bfloat16>(tile, route, a)
                  : launch_tile<float>(tile, route, a);
}
