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
// Design: the shared tensor-core mainloop of int8_gemm.cuh (mma.sync
// m16n8k32 fed by a 4-slot cp.async ring, one barrier a 64-byte K step);
// the batch is grid.z.  Two tiles: 128 x 128 with 8 warps (64 x 32 each),
// and 64 x 64 with 4 warps (32 x 32 each) where N is at most 80 (CIFAR's
// 16-token mid block, SD's 77 context tokens and 40-channel heads), so that
// few columns waste less of the tile.  The load route follows K:
// 16-byte copies where K % 16 == 0, 8-byte where K % 8 == 0 (SD's 40-channel
// heads), else the exact byte gather (the SD cross-attention's W·V, which
// contracts over the 77 context tokens); K pads with zero codes to the next
// 32 in shared memory.  The epilogue stores two columns as one float2
// where N is even.
//
// Bound on this card: at CIFAR's q·k (500, 256, 256)·(500, 256, 256)ᵀ the
// f32 output (131 MB) outweighs the codes (66 MB): 0.059 ms of bytes at
// 3.35 TB/s against 0.017 ms of int8 products at 1,979 TOP/s, so the
// stores bound it as much as the products.
#include "int8_tile.cuh"
#include "int8_gemm.cuh"

namespace {

struct BmmColumns {
  float add0, add1, scale0, scale1, bias0, bias1;
};

struct BmmEpilogue {
  float* out;                 // this batch's (M, N)
  int M, N;
  const float* row_add;       // this batch's (M,) or null
  const float* col_add;       // this batch's (N,) or null
  float kadd;
  bool has_k;
  const float* scale;
  int scale_stride;
  const float* bias;
  bool pair;                  // N even: two columns as one float2

  __device__ __forceinline__ BmmColumns columns(int n) const {
    BmmColumns c{0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    if (n < N) {
      if (col_add) c.add0 = __ldg(col_add + n);
      c.scale0 = __ldg(scale + (long long)n * scale_stride);
      if (bias) c.bias0 = __ldg(bias + n);
    }
    if (n + 1 < N) {
      if (col_add) c.add1 = __ldg(col_add + n + 1);
      c.scale1 = __ldg(scale + (long long)(n + 1) * scale_stride);
      if (bias) c.bias1 = __ldg(bias + n + 1);
    }
    return c;
  }

  __device__ __forceinline__ float value(int acc, float ra, float add, float sc,
                                         float b) const {
    float v = __int2float_rn(acc);
    if (row_add) v = __fadd_rn(v, ra);
    if (col_add) v = __fadd_rn(v, add);
    if (has_k) v = __fadd_rn(v, kadd);
    v = __fmul_rn(v, sc);
    if (bias) v = __fadd_rn(v, b);
    return v;
  }

  // columns n, n + 1 of one row
  __device__ __forceinline__ void store(long long m, int n, float ra, const BmmColumns& c,
                                        int a0, int a1) const {
    if (n >= N) return;
    float* o = out + m * N + n;
    const float v0 = value(a0, ra, c.add0, c.scale0, c.bias0);
    if (n + 1 >= N) {
      *o = v0;
      return;
    }
    const float v1 = value(a1, ra, c.add1, c.scale1, c.bias1);
    if (pair) {
      *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
    } else {
      o[0] = v0;
      o[1] = v1;
    }
  }

  __device__ __forceinline__ void operator()(long long m, int n, const BmmColumns& c0, int a0,
                                             int a1, const BmmColumns& c1, int b0,
                                             int b1) const {
    if (m >= M) return;
    const float ra = row_add ? __ldg(row_add + m) : 0.f;
    store(m, n, ra, c0, a0, a1);
    store(m, n + 8, ra, c1, b0, b1);
  }
};

template <int TILE_M, int TILE_N, int WARPS_M, int WARPS_N, int ROUTE>
__global__ void __launch_bounds__(WARPS_M * WARPS_N * 32, 256 / (WARPS_M * WARPS_N * 16))
int8_bmm_nt_kernel(const int8_t* __restrict__ A, const int8_t* __restrict__ B,
                   float* __restrict__ out, int M, int N, int K,
                   const float* __restrict__ row_add, const float* __restrict__ col_add,
                   long long col_bs, const float* __restrict__ k_add,
                   const float* __restrict__ scale, int scale_stride,
                   const float* __restrict__ bias) {
  extern __shared__ __align__(16) uint8_t smem[];
  const long long b = blockIdx.z;
  const i8gemm::Operand a{A + b * M * K, M, K}, bo{B + b * N * K, N, K};
  BmmEpilogue epi{out + b * M * N, M, N,
                  row_add ? row_add + b * M : nullptr,
                  col_add ? col_add + b * col_bs : nullptr,
                  k_add ? *k_add : 0.f, k_add != nullptr, scale, scale_stride, bias,
                  (N & 1) == 0};
  i8gemm::gemm_tile<TILE_M, TILE_N, WARPS_M, WARPS_N, ROUTE, ROUTE>(
      a, bo, K, blockIdx.x * TILE_M, blockIdx.y * TILE_N, smem, epi);
}

template <int TILE_M, int TILE_N, int WARPS_M, int WARPS_N, int ROUTE>
int launch(const void* A, const void* B, void* out, int batch, int M, int N, int K,
           const void* row_add, const void* col_add, int col_batched, const void* k_add,
           const void* scale, int scale_stride, const void* bias, cudaStream_t stream) {
  auto kernel = int8_bmm_nt_kernel<TILE_M, TILE_N, WARPS_M, WARPS_N, ROUTE>;
  constexpr int smem = i8gemm::tile_smem<TILE_M, TILE_N>();
  static int allowed = 48 * 1024;
  const cudaError_t e = i8gemm::allow_smem(kernel, smem, allowed);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((M + TILE_M - 1) / TILE_M, (N + TILE_N - 1) / TILE_N, batch);
  kernel<<<grid, WARPS_M * WARPS_N * 32, smem, stream>>>(
      (const int8_t*)A, (const int8_t*)B, (float*)out, M, N, K, (const float*)row_add,
      (const float*)col_add, col_batched ? (long long)N : 0LL, (const float*)k_add,
      (const float*)scale, scale_stride, (const float*)bias);
  return (int)cudaGetLastError();
}

template <int TILE_M, int TILE_N, int WARPS_M, int WARPS_N>
int launch_route(int route, const void* A, const void* B, void* out, int batch, int M, int N,
                 int K, const void* row_add, const void* col_add, int col_batched,
                 const void* k_add, const void* scale, int scale_stride, const void* bias,
                 cudaStream_t stream) {
#define EDM_BMM_ARGS A, B, out, batch, M, N, K, row_add, col_add, col_batched, k_add, scale, \
                     scale_stride, bias, stream
  switch (route) {
    case i8gemm::ROUTE_16:
      return launch<TILE_M, TILE_N, WARPS_M, WARPS_N, i8gemm::ROUTE_16>(EDM_BMM_ARGS);
    case i8gemm::ROUTE_8:
      return launch<TILE_M, TILE_N, WARPS_M, WARPS_N, i8gemm::ROUTE_8>(EDM_BMM_ARGS);
    case i8gemm::ROUTE_GATHER:
      return launch<TILE_M, TILE_N, WARPS_M, WARPS_N, i8gemm::ROUTE_GATHER>(EDM_BMM_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef EDM_BMM_ARGS
}

}  // namespace

// tile: 0 = 128 x 128, 1 = 64 x 64; route: 16, 8 or 1 (the gather).  The
// wrapper (ops/int8_einsum.py::bmm_plan) chooses both and checks that the
// route's alignment holds.
extern "C" int edm_int8_bmm_nt(const void* A, const void* B, void* out,
                               int batch, int M, int N, int K,
                               const void* row_add, const void* col_add,
                               int col_batched, const void* k_add,
                               const void* scale, int scale_stride,
                               const void* bias, int tile, int route, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (tile == 0)
    return launch_route<128, 128, 2, 4>(route, A, B, out, batch, M, N, K, row_add, col_add,
                                        col_batched, k_add, scale, scale_stride, bias, s);
  if (tile == 1)
    return launch_route<64, 64, 2, 2>(route, A, B, out, batch, M, N, K, row_add, col_add,
                                      col_batched, k_add, scale, scale_stride, bias, s);
  return (int)cudaErrorInvalidValue;
}
