// K8: int8 quantized matmul, activation quantized in the kernel.
//
// Replaces the Pallas kernel of eda_dm_tpu/ops/pallas_quant.py
// (quantized_matmul) and the rank-1 dequant corrections XLA fused after it:
//
//   xq8[m,k] = clip(rint(x[m,k] / s_x) + z_x, 0, 255) − 128    (int8)
//   acc[m,n] = Σ_k xq8[m,k]·w_q[k,n]                             (int32)
//   row[m]   = Σ_k (xq8[m,k] + 128 − z_x)
//   out[m,n] = s_x·(acc + (128 − z_x)·colsum[n])·s_w[n]
//              + (s_x·row[m])·off[n]  (+ bias[n])               (float32)
//
// cast to x's dtype.  The quantize step is IEEE float32 (__fdiv_rn, rintf,
// x widened from bf16 first); every epilogue step is one IEEE operation in
// this order (__fmul_rn / __fadd_rn, no FMA contraction), as in the plain
// version (eda_dm_tpu_torch/ops/quant_matmul.py::quantized_matmul_plain).
// The row sum is an exact integer: Σ xq8 in int32, then + K·(128 − z_x),
// exact in float32 for K < 65536 and integer z_x.  So the card's output
// equals the plain version's.  The caller may pass the row term s_x·row
// precomputed (the JAX package's outside pass in bf16, see the wrapper);
// the kernel then reads it in place of its own.  With acc_only the kernel
// stores the int32 sums instead of the epilogue.
//
// Design: the tensor-core mainloop of int8_gemm.cuh, w_q K-major (N, K).
// * Resident stripe (K up to 512): a block of 8 warps owns 128 rows of x.
//   It reads them once, quantizes them once into shared memory (rows of
//   round_up(K, 64) + 16 bytes, bank-conflict free for ldmatrix), takes
//   the row sums once, then walks every 128-column tile of w, starting at
//   a tile of its own: the w tiles stream through the 4-slot cp.async ring
//   as one sequence of (column tile, K step) steps, so the next tile's
//   copies run under this tile's epilogue.  The first w copies are issued
//   before the quantize.
// * Streamed (larger K): a first kernel quantizes x once into int8 codes in
//   device memory (rows padded to 16 bytes) with the row terms, and the
//   GEMM streams both operands through the ring as K2 does.
// The epilogue stores whole 32-byte sectors of a row: float2 / int2 pairs
// where N is even, and for a bf16 output four columns a lane, two of them
// taken from the neighbouring lane, where N % 4 == 0 (bf16 pairs alone
// would fill half sectors, which cost this kernel 0.12 ms of its 0.44 at
// SD's GEGLU dense on the H100).
//
// Bound on this card: at SD's GEGLU dense (32768, 320)·(320, 2560) the
// 2·M·N·K int8 operations at 1,979 TOP/s take 0.027 ms and the bytes (x
// as bf16 once, the output once) 0.057 ms, so the bytes bound it; the
// mma.sync rate a hand-written kernel reaches (P1: 338–590 TOP/s) puts the
// products at 0.09–0.16 ms, above the byte bound.
#include "int8_tile.cuh"
#include "int8_gemm.cuh"

namespace {

constexpr int QM_TILE = 128;                 // rows a stripe, columns a tile
constexpr int QM_THREADS = 256;              // 8 warps as 2 x 4
constexpr int QM_WARPS = QM_THREADS / 32;

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

// Quantize `rows` rows of x from m0 (warp w takes rows w, w + 8, ...) into
// codes (rows ldc bytes apart, zero from K up to kpad) and, where row_out
// is given, their row terms s_x·row (row_in's, where the caller gave them).
template <typename XT>
__device__ __forceinline__ void quantize_rows(const XT* __restrict__ x, long long m0, int rows,
                                              int M, int K, int kpad, bool x_vec, float sx,
                                              float zx, uint8_t* codes, int ldc,
                                              float* row_out, const float* __restrict__ row_in) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float kz = __fmul_rn((float)K, __fsub_rn(128.0f, zx));
  for (int r = warp; r < rows; r += QM_WARPS) {
    const long long m = m0 + r;
    int sum = 0;
    for (int k = 4 * lane; k < kpad; k += 128) {
      float v[4];
      load4(x, m, k, M, K, x_vec, v);
      uint32_t word = 0u;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        int q = 0;                                      // code 0 past M or K
        if (m < M && k + i < K) {
          const float f = fminf(fmaxf(__fadd_rn(rintf(__fdiv_rn(v[i], sx)), zx), 0.0f),
                                255.0f);
          q = __float2int_rn(f) - 128;
        }
        sum += q;
        word |= (uint32_t)(uint8_t)q << (8 * i);
      }
      *reinterpret_cast<uint32_t*>(codes + (long long)r * ldc + k) = word;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    if (lane == 0 && row_out != nullptr)
      row_out[r] = row_in != nullptr ? (m < M ? row_in[m] : 0.0f)
                                     : __fmul_rn(sx, __fadd_rn(__int2float_rn(sum), kz));
  }
}

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

// what the epilogue reads of columns n and n + 1: (128 − z_x)·colsum, s_w,
// the dequant offset and the bias
struct QmColumns {
  float cc0, cc1, sw0, sw1, off0, off1, b0, b1;
};

template <typename XT, bool ACC_ONLY>
struct QmEpilogue {
  void* out;
  int M, N;
  float sx, c128;
  const float* s_w;
  const float* colsum;
  const float* off;
  const float* bias;
  const float* rowt;          // row terms of rows from rbase
  long long rbase;
  bool pair;                  // N even: two columns as one word
  bool quad;                  // N % 4 == 0: four bf16 a lane (see operator())

  __device__ __forceinline__ QmColumns columns(int n) const {
    QmColumns c{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if constexpr (ACC_ONLY) return c;
    if (n < N) {
      c.cc0 = __fmul_rn(c128, __ldg(colsum + n));
      c.sw0 = __ldg(s_w + n);
      c.off0 = __ldg(off + n);
      if (bias) c.b0 = __ldg(bias + n);
    }
    if (n + 1 < N) {
      c.cc1 = __fmul_rn(c128, __ldg(colsum + n + 1));
      c.sw1 = __ldg(s_w + n + 1);
      c.off1 = __ldg(off + n + 1);
      if (bias) c.b1 = __ldg(bias + n + 1);
    }
    return c;
  }

  __device__ __forceinline__ float value(int acc, float t, float cc, float sw, float of,
                                         float b) const {
    float v = __fadd_rn(__int2float_rn(acc), cc);
    v = __fmul_rn(__fmul_rn(sx, v), sw);
    v = __fadd_rn(v, __fmul_rn(t, of));
    if (bias) v = __fadd_rn(v, b);
    return v;
  }

  __device__ __forceinline__ void store_acc(long long m, int n, int a0, int a1) const {
    if (n >= N) return;
    int* o = static_cast<int*>(out) + m * N + n;
    if (n + 1 < N && pair) {
      *reinterpret_cast<int2*>(o) = make_int2(a0, a1);
    } else {
      o[0] = a0;
      if (n + 1 < N) o[1] = a1;
    }
  }

  __device__ __forceinline__ void store(long long m, int n, float v0, float v1) const {
    if (n >= N) return;
    XT* o = static_cast<XT*>(out) + m * N + n;
    if (n + 1 < N) store2(o, v0, v1, pair);
    else store_out(o, v0);
  }

  __device__ __forceinline__ void operator()(long long m, int n, const QmColumns& c0, int a0,
                                             int a1, const QmColumns& c1, int b0,
                                             int b1) const {
    if constexpr (ACC_ONLY) {
      if (m >= M) return;
      store_acc(m, n, a0, a1);
      store_acc(m, n + 8, b0, b1);
    } else {
      const float t = m < M ? rowt[m - rbase] : 0.f;
      const float v0 = value(a0, t, c0.cc0, c0.sw0, c0.off0, c0.b0);
      const float v1 = value(a1, t, c0.cc1, c0.sw1, c0.off1, c0.b1);
      const float w0 = value(b0, t, c1.cc0, c1.sw0, c1.off0, c1.b0);
      const float w1 = value(b1, t, c1.cc1, c1.sw1, c1.off1, c1.b1);
      if constexpr (sizeof(XT) == 2) {
        if (quad) {
          // four bf16 a lane, a row's 16 columns a 32-byte sector: the lane
          // of even t keeps columns n, n + 1 and takes its neighbour's n + 2,
          // n + 3; the odd one takes the neighbour's n + 6, n + 7 and keeps
          // n + 8, n + 9 (every lane makes this call, so all shuffle)
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
          *reinterpret_cast<uint2*>(static_cast<XT*>(out) + m * N + n4) = u;
          return;
        }
      }
      if (m >= M) return;
      store(m, n, v0, v1);
      store(m, n + 8, w0, w1);
    }
  }
};

constexpr int RING_SMEM = i8gemm::STAGES * QM_TILE * i8gemm::LDT;

__host__ __device__ constexpr int round_up(int v, int m) { return (v + m - 1) / m * m; }

// shared memory of the resident kernel at K
__host__ __device__ constexpr int resident_smem(int K) {
  return QM_TILE * (round_up(K, i8gemm::KSTEP) + 16) + RING_SMEM + QM_TILE * 4;
}

template <typename XT, bool ACC_ONLY, int RB>
__global__ void __launch_bounds__(QM_THREADS, 2)
qm_resident_kernel(const XT* __restrict__ x, const int8_t* __restrict__ w_t,
                   const float* __restrict__ sx_p, const float* __restrict__ zx_p,
                   const float* __restrict__ s_w, const float* __restrict__ colsum,
                   const float* __restrict__ off, const float* __restrict__ bias,
                   const float* __restrict__ row_in, void* __restrict__ out, int M, int N,
                   int K, bool x_vec) {
  using namespace i8gemm;
  extern __shared__ __align__(16) uint8_t smem[];
  const int kpad = round_up(K, KSTEP), lda = kpad + 16;
  uint8_t* as = smem;                                   // the stripe's codes
  uint8_t* bs = smem + QM_TILE * lda;                   // the w ring
  float* row_s = reinterpret_cast<float*>(bs + RING_SMEM);
  const long long m0 = (long long)blockIdx.x * QM_TILE;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * 64, wn = (warp & 3) * 32;
  const float sx = *sx_p, zx = *zx_p;
  const Operand wop{w_t, N, K};
  const int KT = kpad / KSTEP, NT = (N + QM_TILE - 1) / QM_TILE, T = KT * NT;
  // the column tile of step s: each block starts at its own tile, so that
  // the blocks, which run in step, do not all read one w tile at once
  const int nt0 = blockIdx.x % NT;
  auto col_tile = [=](int s) { return (s / KT + nt0) % NT; };

  // the first w tiles fly while the stripe is quantized
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < T)
      load_tile<QM_TILE, QM_THREADS, RB>(bs + s * QM_TILE * LDT, wop, col_tile(s) * QM_TILE,
                                         (s % KT) * KSTEP, K, tid);
    cp_async_commit();
  }
  quantize_rows(x, m0, QM_TILE, M, K, kpad, x_vec, sx, zx, as, lda,
                ACC_ONLY ? nullptr : row_s, row_in);

  QmEpilogue<XT, ACC_ONLY> epi{out, M, N, sx, __fsub_rn(128.0f, zx), s_w, colsum, off, bias,
                               row_s, m0, (N & 1) == 0, (N & 3) == 0};
  int acc[4][4][4];
  zero(acc);
  for (int step = 0; step < T; ++step) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pf = step + STAGES - 1;
    if (pf < T)
      load_tile<QM_TILE, QM_THREADS, RB>(bs + (pf % STAGES) * QM_TILE * LDT, wop,
                                         col_tile(pf) * QM_TILE, (pf % KT) * KSTEP, K, tid);
    cp_async_commit();
    const int kt = step % KT, nt = col_tile(step);
    mma_step<4, 4>(acc, reinterpret_cast<const uint32_t*>(as), lda / 4, kt * (KSTEP / 4),
                   reinterpret_cast<const uint32_t*>(bs + (step % STAGES) * QM_TILE * LDT),
                   wm, wn, slices(K, kt * KSTEP), lane);
    if (kt == KT - 1) {
      for_each_pair(acc, m0 + wm, nt * QM_TILE + wn, lane, epi);
      zero(acc);
    }
  }
  cp_async_wait<0>();
}

// the streamed path's first kernel: codes (M, ldc) and, where row_out is
// given, the row terms (M,)
template <typename XT>
__global__ void __launch_bounds__(QM_THREADS)
qm_quantize_kernel(const XT* __restrict__ x, const float* __restrict__ sx_p,
                   const float* __restrict__ zx_p, int8_t* __restrict__ codes,
                   float* __restrict__ row_out, int M, int K, int ldc, bool x_vec) {
  const long long m0 = (long long)blockIdx.x * QM_TILE;
  quantize_rows(x, m0, (int)min((long long)QM_TILE, (long long)M - m0), M, K, ldc, x_vec,
                *sx_p, *zx_p, reinterpret_cast<uint8_t*>(codes + m0 * ldc), ldc,
                row_out ? row_out + m0 : nullptr, nullptr);
}

template <typename XT, bool ACC_ONLY, int RB>
__global__ void __launch_bounds__(QM_THREADS, 2)
qm_streamed_kernel(const int8_t* __restrict__ codes, int ldc, const int8_t* __restrict__ w_t,
                   const float* __restrict__ sx_p, const float* __restrict__ zx_p,
                   const float* __restrict__ s_w, const float* __restrict__ colsum,
                   const float* __restrict__ off, const float* __restrict__ bias,
                   const float* __restrict__ rowt, void* __restrict__ out, int M, int N,
                   int K) {
  extern __shared__ __align__(16) uint8_t smem[];
  const float sx = *sx_p, zx = *zx_p;
  QmEpilogue<XT, ACC_ONLY> epi{out, M, N, sx, __fsub_rn(128.0f, zx), s_w, colsum, off, bias,
                               rowt, 0, (N & 1) == 0, (N & 3) == 0};
  i8gemm::gemm_tile<QM_TILE, QM_TILE, 2, 4, i8gemm::ROUTE_16, RB>(
      i8gemm::Operand{codes, M, ldc}, i8gemm::Operand{w_t, N, K}, K, blockIdx.x * QM_TILE,
      blockIdx.y * QM_TILE, smem, epi);
}

struct QmArgs {
  const void *x, *w_t, *sx, *zx, *s_w, *colsum, *off, *bias, *row_in;
  void *out, *codes, *row_scratch;
  int M, N, K;
  cudaStream_t stream;
};

template <typename XT, bool ACC_ONLY, int RB>
int launch_resident(const QmArgs& a) {
  auto kernel = qm_resident_kernel<XT, ACC_ONLY, RB>;
  const int smem = resident_smem(a.K);
  static int allowed = 48 * 1024;
  const cudaError_t e = i8gemm::allow_smem(kernel, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  const bool x_vec = a.K % 4 == 0 && (uintptr_t)a.x % (4 * sizeof(XT)) == 0;
  kernel<<<(unsigned)((a.M + QM_TILE - 1) / QM_TILE), QM_THREADS, smem, a.stream>>>(
      (const XT*)a.x, (const int8_t*)a.w_t, (const float*)a.sx, (const float*)a.zx,
      (const float*)a.s_w, (const float*)a.colsum, (const float*)a.off,
      (const float*)a.bias, (const float*)a.row_in, a.out, a.M, a.N, a.K, x_vec);
  return (int)cudaGetLastError();
}

template <typename XT, bool ACC_ONLY, int RB>
int launch_streamed(const QmArgs& a) {
  const int ldc = round_up(a.K, 16);
  const bool x_vec = a.K % 4 == 0 && (uintptr_t)a.x % (4 * sizeof(XT)) == 0;
  const bool own_rows = !ACC_ONLY && a.row_in == nullptr;
  qm_quantize_kernel<XT><<<(unsigned)((a.M + QM_TILE - 1) / QM_TILE), QM_THREADS, 0,
                           a.stream>>>(
      (const XT*)a.x, (const float*)a.sx, (const float*)a.zx, (int8_t*)a.codes,
      own_rows ? (float*)a.row_scratch : nullptr, a.M, a.K, ldc, x_vec);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  auto kernel = qm_streamed_kernel<XT, ACC_ONLY, RB>;
  constexpr int smem = i8gemm::tile_smem<QM_TILE, QM_TILE>();
  static int allowed = 48 * 1024;
  e = i8gemm::allow_smem(kernel, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((unsigned)((a.M + QM_TILE - 1) / QM_TILE), (a.N + QM_TILE - 1) / QM_TILE);
  kernel<<<grid, QM_THREADS, smem, a.stream>>>(
      (const int8_t*)a.codes, ldc, (const int8_t*)a.w_t, (const float*)a.sx,
      (const float*)a.zx, (const float*)a.s_w, (const float*)a.colsum, (const float*)a.off,
      (const float*)a.bias, own_rows ? (const float*)a.row_scratch : (const float*)a.row_in,
      a.out, a.M, a.N, a.K);
  return (int)cudaGetLastError();
}

template <typename XT, bool ACC_ONLY, int RB>
int launch_plan(int streamed, const QmArgs& a) {
  return streamed ? launch_streamed<XT, ACC_ONLY, RB>(a) : launch_resident<XT, ACC_ONLY, RB>(a);
}

template <typename XT, bool ACC_ONLY>
int launch_route(int route, int streamed, const QmArgs& a) {
  switch (route) {
    case i8gemm::ROUTE_16: return launch_plan<XT, ACC_ONLY, i8gemm::ROUTE_16>(streamed, a);
    case i8gemm::ROUTE_8: return launch_plan<XT, ACC_ONLY, i8gemm::ROUTE_8>(streamed, a);
    case i8gemm::ROUTE_GATHER:
      return launch_plan<XT, ACC_ONLY, i8gemm::ROUTE_GATHER>(streamed, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// x: (M, K) float32 or bfloat16 (x_bf16), contiguous; w_t: (N, K) int8
// codes, contiguous (w_q transposed); sx, zx: float32 scalars on the card;
// s_w, colsum, off: (N,) float32 (unused with acc_only); bias: (N,) float32
// or NULL; row_in: (M,) float32 row terms or NULL; out: (M, N) in x's
// dtype, or int32 with acc_only.  streamed = 0: the resident stripe;
// streamed = 1: codes (M, round_up(K, 16)) int8 and row_scratch (M,)
// float32 are the wrapper's scratch.  route (16, 8 or 1) is w_t's load
// route; the wrapper (ops/quant_matmul.py::qm_plan) chooses both.
extern "C" int edm_quantized_matmul(const void* x, const void* w_t, const void* sx,
                                    const void* zx, const void* s_w, const void* colsum,
                                    const void* off, const void* bias, const void* row_in,
                                    void* out, void* codes, void* row_scratch, int x_bf16,
                                    int acc_only, int M, int N, int K, int streamed,
                                    int route, void* stream) {
  const QmArgs a{x, w_t, sx, zx, s_w, colsum, off, bias, row_in, out, codes, row_scratch,
                 M, N, K, (cudaStream_t)stream};
  if (!streamed && resident_smem(K) > 227 * 1024) return (int)cudaErrorInvalidValue;
  if (x_bf16)
    return acc_only ? launch_route<__nv_bfloat16, true>(route, streamed, a)
                    : launch_route<__nv_bfloat16, false>(route, streamed, a);
  return acc_only ? launch_route<float, true>(route, streamed, a)
                  : launch_route<float, false>(route, streamed, a);
}
