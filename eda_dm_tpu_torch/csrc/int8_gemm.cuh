// The int8 tensor-core GEMM mainloop shared by K1 (int8_conv.cu), K2
// (int8_bmm.cu) and K8 (quantized_matmul.cu): int8 x int8 -> int32 sums of
// two K-major operands, A (M, K) and B (N, K), handed to an epilogue
// functor.  Each operand's tile load is a loader object: RowLoader reads
// rows of a matrix (K2, K8's streamed path, K1's weights); K1's ConvLoader
// (int8_conv.cu) gathers the rows of an implicit im2col matrix.
//
// Design (sm_90a, mma.sync; int8_mma.cuh has the fragment layouts):
// * A block owns a TILE_M x TILE_N output tile.  Its warps sit as
//   WARPS_M x WARPS_N; a warp computes (TILE_M / WARPS_M) x (TILE_N /
//   WARPS_N) of the tile in m16n8k32 products.
// * K goes through shared memory KS bytes a step (64 = KSTEP for K2 and
//   K8, 64 or 128 for K1), in a ring of NSTAGE slots (STAGES = 4 for K2
//   and K8) in dynamic shared memory.  A slot holds TILE_M rows of A and
//   TILE_N rows of B, each row padded from KS to KS + 16 bytes (80 or 144):
//   an odd number of 16-byte units, so the eight rows of every ldmatrix
//   8 x 16-byte matrix fall in distinct banks.
// * Loads take one of three routes, fixed per launch by K and alignment:
//   16-byte cp.async.cg (K % 16 == 0), 8-byte cp.async.ca (K % 8 == 0), or
//   a byte gather through registers into 32-bit shared stores (any K: the
//   77-token context).  Rows past the operand and codes past K load as
//   zero (cp.async's src-size 0 zero-fills), so a ragged tile adds zeros.
// * One barrier a K step: wait for the oldest slot's copies, barrier, issue
//   the copies of the slot read one step earlier (every thread has passed
//   the barrier, so no thread still reads it), then the products.  The
//   ring keeps NSTAGE - 1 steps of copies in flight behind the products.
//   A loader is called once a step, in K order.
// * The epilogue functor gets, for a row, the thread's column pairs n and
//   n + 8 with their int32 sums straight from the accumulator registers,
//   so each kernel keeps its own float32 operation order; what it reads per
//   column it reads once (columns()).  Stores are whole 32-byte sectors a
//   row: two float2 (four floats), or four bf16 gathered from the
//   neighbouring lane (a 2-byte output of one n8 tile fills only half a
//   sector, and on this card such stores cost more than twice the bytes).
//
// Everything lives in namespace i8gemm.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace i8gemm {

constexpr int KSTEP = 64;            // bytes of K a pipeline step (K2, K8)
constexpr int LDT = KSTEP + 16;      // bytes a shared row of a streamed tile
constexpr int STAGES = 4;            // slots in the ring (K2, K8)

// bytes a shared row of a KS-byte step
__host__ __device__ constexpr int row_bytes(int ks) { return ks + 16; }

// load routes
constexpr int ROUTE_16 = 16, ROUTE_8 = 8, ROUTE_GATHER = 1;

__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_8(void* dst, const void* src, bool valid) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 8 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// one K-major operand: `rows` rows of `ld` bytes from `ptr`, K codes valid
struct Operand {
  const int8_t* ptr;
  int rows;
  int ld;
};

// four codes k .. k + 3 of one row as a word (zero past K): the byte gather
__device__ __forceinline__ uint32_t gather4(const int8_t* row, int k, int K) {
  uint32_t w = 0u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (k + i < K) w |= (uint32_t)(uint8_t)__ldg(row + k + i) << (8 * i);
  return w;
}

// log2 of a power of two
__host__ __device__ constexpr int log2i(int v) { return v > 1 ? 1 + log2i(v / 2) : 0; }

// bytes a copy of a route moves (the gather: a 32-bit word)
template <int ROUTE>
__host__ __device__ constexpr int copy_bytes() { return ROUTE == ROUTE_GATHER ? 4 : ROUTE; }

// ROWS rows x KS bytes of `op` from row r0 and byte k0 into the shared
// tile s (rows KS + 16 bytes apart), by THREADS threads.  Thread tid copies
// the bytes kc = (tid % (KS / copy)) * copy of its rows, at every step.
template <int ROWS, int THREADS, int ROUTE, int KS = KSTEP>
__device__ __forceinline__ void load_tile(uint8_t* s, const Operand& op, int r0, int k0,
                                          int K, int tid) {
  constexpr int UNIT = copy_bytes<ROUTE>(), PER_ROW = KS / UNIT, LD = row_bytes(KS);
  constexpr int CH = ROWS * PER_ROW;
  static_assert(CH % THREADS == 0 && (PER_ROW & (PER_ROW - 1)) == 0,
                "copies must split evenly");
#pragma unroll
  for (int i = 0; i < CH / THREADS; ++i) {
    // a shift and a mask: signed / and % by PER_ROW cost instructions and
    // registers that spill in K2's 64 x 64 gather
    const int c = tid + i * THREADS, r = c >> log2i(PER_ROW);
    const int kc = (c & (PER_ROW - 1)) * UNIT;
    if constexpr (ROUTE == ROUTE_GATHER) {
      const uint32_t w = r0 + r < op.rows
          ? gather4(op.ptr + (long long)(r0 + r) * op.ld, k0 + kc, K) : 0u;
      *reinterpret_cast<uint32_t*>(s + r * LD + kc) = w;
    } else {
      const bool v = r0 + r < op.rows && k0 + kc < K;
      const int8_t* src = v ? op.ptr + (long long)(r0 + r) * op.ld + k0 + kc : op.ptr;
      if constexpr (ROUTE == ROUTE_16) cp_async_16(s + r * LD + kc, src, v);
      else cp_async_8(s + r * LD + kc, src, v);
    }
  }
}

// the loader of a row-major K-major operand (`op`'s rows from r0)
template <int ROWS, int THREADS, int ROUTE, int KS = KSTEP>
struct RowLoader {
  Operand op;
  int r0, K;
  __device__ __forceinline__ void load(uint8_t* s, int k0, int tid) const {
    load_tile<ROWS, THREADS, ROUTE, KS>(s, op, r0, k0, K, tid);
  }
};

// the products of one K step: nk32 (1 .. KS / 32) slices of 32 bytes.  A
// rows lda words apart from word aw0; B (a streamed slot) rows KS + 16
// bytes apart
template <int MI, int NI, int KS = KSTEP>
__device__ __forceinline__ void mma_step(int (&acc)[MI][NI][4], const uint32_t* as, int lda,
                                         int aw0, const uint32_t* bs, int wm, int wn,
                                         int nk32, int lane) {
#pragma unroll
  for (int ks = 0; ks < KS / 32; ++ks) {
    if (ks >= nk32) break;
    uint32_t b[NI][2];
#pragma unroll
    for (int j = 0; j < NI; ++j)
      load_b_frag(b[j], bs, row_bytes(KS) / 4, wn + 8 * j, 8 * ks, lane);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      uint32_t a[4];
      load_a_frag(a, as, lda, wm + 16 * i, aw0 + 8 * ks, lane);
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_s8_16832(acc[i][j], a, b[j]);
    }
  }
}

// 32-byte slices of the KS-byte K step that starts at byte k0 which hold
// codes
template <int KS = KSTEP>
__device__ __forceinline__ int slices(int K, int k0) {
  const int left = K - k0;
  return left >= KS ? KS / 32 : (left + 31) >> 5;
}

template <int MI, int NI>
__device__ __forceinline__ void zero(int (&acc)[MI][NI][4]) {
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[i][j][c] = 0;
}

// hand a warp's sums to the epilogue.  A thread holds, for each of its
// rows, column pairs n + 8j (j < NI) of its n8 tiles; they go out two tiles
// at a time: epi.columns(c) reads once what the epilogue needs of columns
// c and c + 1, then epi(row, n, cols(n), sums at n and n + 1, cols(n + 8),
// sums at n + 8 and n + 9) takes each row.  Every lane makes the same
// calls, so an epilogue may trade values between lanes.  Rows from m0 and
// columns from n0 are the warp's tile origin.
template <int MI, int NI, class Epi>
__device__ __forceinline__ void for_each_pair(const int (&acc)[MI][NI][4], long long m0,
                                              int n0, int lane, const Epi& epi) {
  static_assert(NI % 2 == 0, "column tiles go out in pairs");
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NI; j += 2) {
    const int n = n0 + 8 * j + 2 * t;
    const auto c0 = epi.columns(n), c1 = epi.columns(n + 8);
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(m0 + 16 * i + g + 8 * h, n, c0, acc[i][j][2 * h], acc[i][j][2 * h + 1], c1,
            acc[i][j + 1][2 * h], acc[i][j + 1][2 * h + 1]);
  }
}

// dynamic shared memory of gemm_loop
template <int TILE_M, int TILE_N, int KS = KSTEP, int NSTAGE = STAGES>
__host__ __device__ constexpr int tile_smem() {
  return NSTAGE * (TILE_M + TILE_N) * row_bytes(KS);
}

// One TILE_M x TILE_N output tile whose rows start at m0 and columns at
// n0: both operands streamed through the ring by their loaders, KS bytes
// of K a step, NSTAGE slots; the sums go to `epi`.
template <int TILE_M, int TILE_N, int WARPS_M, int WARPS_N, int KS, int NSTAGE, class LoadA,
          class LoadB, class Epi>
__device__ __forceinline__ void gemm_loop(LoadA& la, LoadB& lb, int K, long long m0, int n0,
                                          uint8_t* smem, const Epi& epi) {
  static_assert(NSTAGE >= 2 && KS % 32 == 0, "a ring of KS-byte steps");
  constexpr int LD = row_bytes(KS);
  constexpr int WTM = TILE_M / WARPS_M, WTN = TILE_N / WARPS_N;
  constexpr int MI = WTM / 16, NI = WTN / 8;
  uint8_t* as = smem;
  uint8_t* bs = smem + NSTAGE * TILE_M * LD;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / WARPS_N) * WTM, wn = (warp % WARPS_N) * WTN;
  const int KT = (K + KS - 1) / KS;

  int acc[MI][NI][4];
  zero(acc);
#pragma unroll
  for (int s = 0; s < NSTAGE - 1; ++s) {
    if (s < KT) {
      la.load(as + s * TILE_M * LD, s * KS, tid);
      lb.load(bs + s * TILE_N * LD, s * KS, tid);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<NSTAGE - 2>();
    __syncthreads();
    const int pf = kt + NSTAGE - 1;
    if (pf < KT) {
      const int ps = pf % NSTAGE;
      la.load(as + ps * TILE_M * LD, pf * KS, tid);
      lb.load(bs + ps * TILE_N * LD, pf * KS, tid);
    }
    cp_async_commit();
    const int slot = kt % NSTAGE;
    mma_step<MI, NI, KS>(acc, reinterpret_cast<const uint32_t*>(as + slot * TILE_M * LD),
                         LD / 4, 0, reinterpret_cast<const uint32_t*>(bs + slot * TILE_N * LD),
                         wm, wn, slices<KS>(K, kt * KS), lane);
  }
  cp_async_wait<0>();
  for_each_pair(acc, m0 + wm, n0 + wn, lane, epi);
}

// gemm_loop over two row-major operands with load routes RA and RB (K2, K8)
template <int TILE_M, int TILE_N, int WARPS_M, int WARPS_N, int RA, int RB, class Epi>
__device__ __forceinline__ void gemm_tile(const Operand& A, const Operand& B, int K,
                                          int m0, int n0, uint8_t* smem, const Epi& epi) {
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  RowLoader<TILE_M, THREADS, RA> la{A, m0, K};
  RowLoader<TILE_N, THREADS, RB> lb{B, n0, K};
  gemm_loop<TILE_M, TILE_N, WARPS_M, WARPS_N, KSTEP, STAGES>(la, lb, K, m0, n0, smem, epi);
}

// the largest dynamic shared memory a kernel launches with, raised once
template <class Kernel>
__host__ inline cudaError_t allow_smem(Kernel kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t e =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) allowed = bytes;
  return e;
}

}  // namespace i8gemm
