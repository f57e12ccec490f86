// P1: a chain of dependent tensor-core products kept on chip, the H100's
// counterpart of the TPU probe scripts/probes/mosaic_int8.py (pallas_chain
// with chain_kernel_s8 / chain_kernel_bf16, and main's exact one_mm).
//
//   int8:  a ← int8(wrap)((a·B) >> 8)      a (M, K) int8, B (K, K) int8,
//          int32 sums, an arithmetic shift, a wrapping cast (no saturation)
//   bf16:  a ← bf16_rn(float(a·B) · 0.01f)  a, B bf16, float32 sums
//
// repeated `steps` times; the output is the last a.  With acc_out and one
// step (int8), the int32 sums a·B themselves are written: one_mm.
//
// Design: every product runs on the tensor cores through mma.sync
// (int8_mma.cuh: m16n8k32 for int8, m16n8k16 for bf16).  A block owns ROWS
// rows of a and keeps them in shared memory for all steps, in two slabs
// (the step reads one and writes the other; a block barrier between
// steps, since each output column needs every column of the last step).
// B arrives transposed (one row per output column, K contiguous), so its
// rows are mma.sync's column operand.  Where B fits beside the slabs it is
// loaded once (RESIDENT); otherwise it streams from the L2 (which holds
// all of B) in 128-column x 128-byte tiles, double-buffered with cp.async,
// every step.  8 warps as 2 x 4: a warp computes ROWS/2 rows x 32 columns of
// a 128-column output tile.  Requires K a multiple of 128 and at most 512.
//
// Bound on this card: 2·M·K²·steps operations against 1,979 int8 TOP/s or
// 989 bf16 TFLOP/s; the bytes (a read once, the result written once) are
// negligible at 40 steps.  mma.sync is not the card's fastest path (wgmma
// is); the probe measures how close it comes.
#include "int8_tile.cuh"
#include "int8_mma.cuh"

#include <type_traits>

#define CH_THREADS 256
#define CH_NT 128                      // output columns a tile
#define CH_KT_W 32                     // streamed B tile: 128 bytes of K (32 words)
#define CH_TILE_LDW (CH_KT_W + 4)      // + 16 bytes of padding

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n"); }

// requantize two neighbouring sums into the next slab
__device__ __forceinline__ void requant_store(uint32_t* row, int col, int v0, int v1) {
  const uint16_t p = (uint16_t)((uint8_t)(v0 >> 8) | ((uint16_t)(uint8_t)(v1 >> 8) << 8));
  reinterpret_cast<uint16_t*>(row)[col >> 1] = p;
}
__device__ __forceinline__ void requant_store(uint32_t* row, int col, float v0, float v1) {
  reinterpret_cast<__nv_bfloat162*>(row)[col >> 1] =
      __floats2bfloat162_rn(__fmul_rn(v0, 0.01f), __fmul_rn(v1, 0.01f));
}

template <typename T, int ROWS, bool RESIDENT>
__global__ void __launch_bounds__(CH_THREADS)
mma_chain_kernel(const uint32_t* __restrict__ a, const uint32_t* __restrict__ bt,
                 uint32_t* __restrict__ out, int* __restrict__ acc_out, int M, int K,
                 int steps) {
  using Acc = typename std::conditional<std::is_same<T, int8_t>::value, int, float>::type;
  constexpr int MI = ROWS / 32;                          // m16 tiles a warp
  extern __shared__ uint32_t smem[];
  const int KW = K * (int)sizeof(T) / 4;               // words a row
  const int LDA = KW + 4;
  uint32_t* cur = smem;
  uint32_t* nxt = smem + ROWS * LDA;
  uint32_t* bs = smem + 2 * ROWS * LDA;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp >> 2) * (ROWS / 2), wn = (warp & 3) * 32;
  const long long m0 = (long long)blockIdx.x * ROWS;

  for (int e = tid; e < ROWS * KW; e += CH_THREADS) {
    const int r = e / KW, w = e - r * KW;
    cur[r * LDA + w] = m0 + r < M ? a[(m0 + r) * KW + w] : 0u;
  }
  if (RESIDENT)
    for (int e = tid; e < K * KW; e += CH_THREADS) {
      const int r = e / KW, w = e - r * KW;
      bs[r * LDA + w] = bt[(long long)r * KW + w];
    }
  const int n_tiles = K / CH_NT, k_tiles = KW / CH_KT_W;
  const long long per_step = (long long)n_tiles * k_tiles;
  const long long total = RESIDENT ? 0 : per_step * steps;
  // streamed tile q: columns (q / k_tiles mod n_tiles)·128 .., words (q mod k_tiles)·32 ..
  auto fetch = [&](long long q) {
    if (q < total) {
      const int nt = (int)((q / k_tiles) % n_tiles), kt = (int)(q % k_tiles);
      uint32_t* dst = bs + (q & 1) * CH_NT * CH_TILE_LDW;
      for (int c = tid; c < CH_NT * (CH_KT_W / 4); c += CH_THREADS) {   // 16-byte chunks
        const int r = c / (CH_KT_W / 4), part = c % (CH_KT_W / 4);
        cp_async16(dst + r * CH_TILE_LDW + 4 * part,
                   bt + (long long)(nt * CH_NT + r) * KW + kt * CH_KT_W + 4 * part);
      }
    }
    cp_async_commit();
  };
  if (!RESIDENT) fetch(0);
  __syncthreads();

  long long q = 0;
  for (int s = 0; s < steps; ++s) {
    for (int nt = 0; nt < n_tiles; ++nt) {
      Acc acc[MI][4][4];
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
      for (int kt = 0; kt < k_tiles; ++kt) {
        const uint32_t* b = bs;
        int ldb = LDA, nb = nt * CH_NT, wb = kt * CH_KT_W;
        if (!RESIDENT) {
          fetch(q + 1);
          cp_async_wait1();
          __syncthreads();
          b = bs + (q & 1) * CH_NT * CH_TILE_LDW;
          ldb = CH_TILE_LDW;
          nb = 0;
          wb = 0;
        }
#pragma unroll
        for (int ks = 0; ks < CH_KT_W / 8; ++ks) {
          uint32_t fa[MI][4], fb[4][2];
#pragma unroll
          for (int i = 0; i < MI; ++i)
            load_a_frag(fa[i], cur, LDA, wm + 16 * i, kt * CH_KT_W + 8 * ks, lane);
#pragma unroll
          for (int j = 0; j < 4; ++j) load_b_frag(fb[j], b, ldb, nb + wn + 8 * j, wb + 8 * ks, lane);
#pragma unroll
          for (int i = 0; i < MI; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) mma_32bytes(acc[i][j], fa[i], fb[j]);
        }
        if (!RESIDENT) {
          __syncthreads();                 // the tile's buffer is refilled next
          ++q;
        }
      }
      const int g = lane >> 2, t = lane & 3;
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = wm + 16 * i + g + 8 * h;
            const int col = nt * CH_NT + wn + 8 * j + 2 * t;
            if constexpr (std::is_same<T, int8_t>::value) {
              if (acc_out) {
                if (m0 + r < M) {
                  acc_out[(m0 + r) * K + col] = acc[i][j][2 * h];
                  acc_out[(m0 + r) * K + col + 1] = acc[i][j][2 * h + 1];
                }
                continue;
              }
            }
            requant_store(nxt + r * LDA, col, acc[i][j][2 * h], acc[i][j][2 * h + 1]);
          }
    }
    __syncthreads();                       // the step is complete in nxt
    uint32_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (acc_out) return;
  for (int e = tid; e < ROWS * KW; e += CH_THREADS) {
    const int r = e / KW, w = e - r * KW;
    if (m0 + r < M) out[(m0 + r) * KW + w] = cur[r * LDA + w];
  }
}

template <typename T, int ROWS, bool RESIDENT>
static int launch(const void* a, const void* bt, void* out, void* acc_out, int M, int K,
                  int steps, cudaStream_t stream) {
  const int ldw = K * (int)sizeof(T) / 4 + 4;
  const size_t smem = 4 * ((size_t)2 * ROWS * ldw +
                           (RESIDENT ? (size_t)K * ldw : (size_t)2 * CH_NT * CH_TILE_LDW));
  auto kernel = mma_chain_kernel<T, ROWS, RESIDENT>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<(unsigned)((M + ROWS - 1) / ROWS), CH_THREADS, smem, stream>>>(
      (const uint32_t*)a, (const uint32_t*)bt, (uint32_t*)out, (int*)acc_out, M, K, steps);
  return (int)cudaGetLastError();
}

// the slab height and whether B stays resident, from the shared memory
// (227 KB a block): ROWS = 128 where two slabs take at most 140 KB
template <typename T>
static int dispatch(const void* a, const void* bt, void* out, void* acc_out, int M, int K,
                    int steps, cudaStream_t stream) {
  const size_t row = 4 * ((size_t)K * sizeof(T) / 4 + 4);
  if (2 * 128 * row > 140 * 1024)      // bf16 at K = 384, 512: B streams
    return launch<T, 64, false>(a, bt, out, acc_out, M, K, steps, stream);
  return (2 * 128 + (size_t)K) * row <= 232448
             ? launch<T, 128, true>(a, bt, out, acc_out, M, K, steps, stream)
             : launch<T, 128, false>(a, bt, out, acc_out, M, K, steps, stream);
}

// a: (M, K) int8 or bfloat16 (bf16), contiguous; bt: (K, K) of the same
// type, B transposed (bt[n][k] = B[k][n]), contiguous; out: (M, K) of the
// type, or NULL with acc_out; acc_out: (M, K) int32 (int8, one step) or
// NULL.  K % 128 == 0, K <= 512.
extern "C" int edm_mma_chain(const void* a, const void* bt, void* out, void* acc_out,
                             int M, int K, int steps, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  return bf16 ? dispatch<__nv_bfloat16>(a, bt, out, acc_out, M, K, steps, s)
              : dispatch<int8_t>(a, bt, out, acc_out, M, K, steps, s);
}
