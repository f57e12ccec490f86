// The int8 tensor-core GEMM mainloop shared by K2 (int8_bmm.cu) and K8
// (quantized_matmul.cu): int8 x int8 -> int32 sums of two K-major operands,
// A (M, K) and B (N, K), handed to an epilogue functor.
//
// Design (sm_90a, mma.sync; int8_mma.cuh has the fragment layouts):
// * A block owns a TILE_M x TILE_N output tile.  Its warps sit as
//   WARPS_M x WARPS_N; a warp computes (TILE_M / WARPS_M) x (TILE_N /
//   WARPS_N) of the tile in m16n8k32 products.
// * K goes through shared memory 64 bytes (KSTEP) at a time, in a ring of
//   STAGES slots in dynamic shared memory.  A slot holds TILE_M rows of A
//   and TILE_N rows of B, each row padded from 64 to 80 bytes (LDT): an odd
//   number of 16-byte units, so the eight rows of every ldmatrix 8 x 16-byte
//   matrix fall in distinct banks.
// * Loads take one of three routes, fixed per launch by K and alignment:
//   16-byte cp.async.cg (K % 16 == 0), 8-byte cp.async.ca (K % 8 == 0), or
//   a byte gather through registers into 32-bit shared stores (any K: the
//   77-token context).  Rows past the operand and codes past K load as
//   zero (cp.async's src-size 0 zero-fills), so a ragged tile adds zeros.
// * One barrier a K step: wait for the oldest slot's copies, barrier, issue
//   the copies of the slot read one step earlier (every thread has passed
//   the barrier, so no thread still reads it), then the products.  The
//   ring keeps STAGES - 1 steps of copies in flight behind the products.
// * The epilogue functor gets, for a row, the thread's column pairs n and
//   n + 8 with their int32 sums straight from the accumulator registers,
//   so each kernel keeps its own float32 operation order; what it reads per
//   column it reads once (columns()).  Stores are whole 32-byte sectors a
//   row: two float2 (four floats), or four bf16 gathered from the
//   neighbouring lane (a 2-byte output of one n8 tile fills only half a
//   sector, and on this card such stores cost more than twice the bytes).
//
// Everything lives in namespace i8gemm: the including .cu files also take
// int8_tile.cuh, whose macros claim the short tile names.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "int8_mma.cuh"

namespace i8gemm {

constexpr int KSTEP = 64;            // bytes of K a pipeline step
constexpr int LDT = KSTEP + 16;      // bytes a shared row of a streamed tile
constexpr int STAGES = 4;            // slots in the ring

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

// ROWS rows x KSTEP bytes of `op` from row r0 and byte k0 into the shared
// tile s (rows LDT bytes apart), by THREADS threads
template <int ROWS, int THREADS, int ROUTE>
__device__ __forceinline__ void load_tile(uint8_t* s, const Operand& op, int r0, int k0,
                                          int K, int tid) {
  if constexpr (ROUTE == ROUTE_16) {
    constexpr int CH = ROWS * (KSTEP / 16);
    static_assert(CH % THREADS == 0, "16-byte chunks must split evenly");
#pragma unroll
    for (int i = 0; i < CH / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c >> 2, kc = (c & 3) * 16;
      const bool v = r0 + r < op.rows && k0 + kc < K;
      const int8_t* src = v ? op.ptr + (long long)(r0 + r) * op.ld + k0 + kc : op.ptr;
      cp_async_16(s + r * LDT + kc, src, v);
    }
  } else if constexpr (ROUTE == ROUTE_8) {
    constexpr int CH = ROWS * (KSTEP / 8);
    static_assert(CH % THREADS == 0, "8-byte chunks must split evenly");
#pragma unroll
    for (int i = 0; i < CH / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c >> 3, kc = (c & 7) * 8;
      const bool v = r0 + r < op.rows && k0 + kc < K;
      const int8_t* src = v ? op.ptr + (long long)(r0 + r) * op.ld + k0 + kc : op.ptr;
      cp_async_8(s + r * LDT + kc, src, v);
    }
  } else {
    constexpr int CH = ROWS * (KSTEP / 4);
    static_assert(CH % THREADS == 0, "words must split evenly");
#pragma unroll
    for (int i = 0; i < CH / THREADS; ++i) {
      const int c = tid + i * THREADS, r = c >> 4, kc = (c & 15) * 4;
      const uint32_t w = r0 + r < op.rows
          ? gather4(op.ptr + (long long)(r0 + r) * op.ld, k0 + kc, K) : 0u;
      *reinterpret_cast<uint32_t*>(s + r * LDT + kc) = w;
    }
  }
}

// the products of one K step: nk32 (1 or 2) slices of 32 bytes.  A rows
// lda words apart from word aw0; B (a streamed slot) rows LDT bytes apart
template <int MI, int NI>
__device__ __forceinline__ void mma_step(int (&acc)[MI][NI][4], const uint32_t* as, int lda,
                                         int aw0, const uint32_t* bs, int wm, int wn,
                                         int nk32, int lane) {
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if (ks >= nk32) break;
    uint32_t b[NI][2];
#pragma unroll
    for (int j = 0; j < NI; ++j) load_b_frag(b[j], bs, LDT / 4, wn + 8 * j, 8 * ks, lane);
#pragma unroll
    for (int i = 0; i < MI; ++i) {
      uint32_t a[4];
      load_a_frag(a, as, lda, wm + 16 * i, aw0 + 8 * ks, lane);
#pragma unroll
      for (int j = 0; j < NI; ++j) mma_s8_16832(acc[i][j], a, b[j]);
    }
  }
}

// 32-byte slices of the K step that starts at byte k0 which hold codes
__device__ __forceinline__ int slices(int K, int k0) {
  const int left = K - k0;
  return left >= KSTEP ? 2 : (left + 31) >> 5;
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

// dynamic shared memory of gemm_tile
template <int TILE_M, int TILE_N>
constexpr int tile_smem() {
  return STAGES * (TILE_M + TILE_N) * LDT;
}

// One TILE_M x TILE_N output tile from row m0 and column n0, both operands
// streamed through the ring; the sums go to `epi`.
template <int TILE_M, int TILE_N, int WARPS_M, int WARPS_N, int RA, int RB, class Epi>
__device__ __forceinline__ void gemm_tile(const Operand& A, const Operand& B, int K,
                                          int m0, int n0, uint8_t* smem, const Epi& epi) {
  constexpr int THREADS = WARPS_M * WARPS_N * 32;
  constexpr int WTM = TILE_M / WARPS_M, WTN = TILE_N / WARPS_N;
  constexpr int MI = WTM / 16, NI = WTN / 8;
  uint8_t* as = smem;
  uint8_t* bs = smem + STAGES * TILE_M * LDT;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = (warp / WARPS_N) * WTM, wn = (warp % WARPS_N) * WTN;
  const int KT = (K + KSTEP - 1) / KSTEP;

  int acc[MI][NI][4];
  zero(acc);
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < KT) {
      load_tile<TILE_M, THREADS, RA>(as + s * TILE_M * LDT, A, m0, s * KSTEP, K, tid);
      load_tile<TILE_N, THREADS, RB>(bs + s * TILE_N * LDT, B, n0, s * KSTEP, K, tid);
    }
    cp_async_commit();
  }
  for (int kt = 0; kt < KT; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    const int pf = kt + STAGES - 1;
    if (pf < KT) {
      const int ps = pf % STAGES;
      load_tile<TILE_M, THREADS, RA>(as + ps * TILE_M * LDT, A, m0, pf * KSTEP, K, tid);
      load_tile<TILE_N, THREADS, RB>(bs + ps * TILE_N * LDT, B, n0, pf * KSTEP, K, tid);
    }
    cp_async_commit();
    const int slot = kt % STAGES;
    mma_step<MI, NI>(acc, reinterpret_cast<const uint32_t*>(as + slot * TILE_M * LDT), LDT / 4,
                     0, reinterpret_cast<const uint32_t*>(bs + slot * TILE_N * LDT), wm, wn,
                     slices(K, kt * KSTEP), lane);
  }
  cp_async_wait<0>();
  for_each_pair(acc, (long long)m0 + wm, n0 + wn, lane, epi);
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
