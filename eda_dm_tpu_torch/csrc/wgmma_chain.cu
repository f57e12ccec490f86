// P1 on wgmma: the chain of dependent tensor-core products of the rate
// probe scripts/probes/mosaic_int8.py (pallas_chain with chain_kernel_s8 /
// chain_kernel_bf16, and main's exact one_mm), redesigned for Hopper.
// mma_chain.cu computes the same function on mma.sync and stays as the
// probe's second route.
//
//   int8:  a ← int8(wrap)((a·B) >> 8)      a (M, K) int8, B (K, K) int8,
//          int32 sums, an arithmetic shift, a wrapping cast
//   bf16:  a ← bf16_rn(float(a·B) · 0.01f)  a, B bf16, float32 sums
//
// repeated `steps` times; the output is the last a.  With acc_out and one
// step (int8), the int32 sums a·B themselves are written: one_mm.
//
// Bound on this card: 2·M·K²·steps operations against 1,979 int8 TOP/s or
// 989 bf16 TFLOP/s; the bytes are negligible at 40 steps.  mma.sync (the
// other route) reaches about 600 TOP/s: every warp loads its operand
// fragments through the register file, and a block barrier stops all
// warps for every step's epilogue.  Here:
//
// * Products on wgmma (m64nNk32 s8 / m64nNk16 bf16), both operands read by
//   the tensor cores from 128-byte-swizzled K-major shared memory through
//   descriptors (sm90_wgmma.cuh); scale-d = 0 on a step's first k-slice.
// * Warpgroup-local steps.  A consumer warpgroup owns 64 whole rows of a
//   and computes every column for them, in passes of NP ≤ 256 columns
//   (K / NP passes).  Row r of step s + 1 needs only row r of step s, so
//   the step boundary is the warpgroup's own named barrier.  With one
//   pass the requantized codes overwrite the warpgroup's slab in place
//   (after wgmma.wait_group 0 its reads are done); with two passes it
//   writes a second slab.  The epilogue stores each pair of codes where
//   the next step's descriptor reads it, then fence.proxy.async and the
//   barrier order those generic stores before the next wgmma.
// * Two consumer warpgroups a block where the slabs fit.  With B resident
//   they take turns issuing (WGC_PINGPONG): one's epilogue runs while the
//   other's products are in flight.
// * B is first packed (wgmma_pack_b, a launch of its own) into the shared
//   layout, swizzle included, in global memory.  It stays resident (one
//   contiguous copy) where it fits beside the slabs; otherwise it streams
//   from the L2 every step in tiles of NP rows x 128 bytes of K through a
//   ring of STAGES slots: one producer lane issues a tile as one bulk copy
//   completing on the slot's `full` mbarrier, and each consumer warp
//   arrives on `empty` once its products of the slot have completed.
// * K is a template constant, so every k-loop unrolls and the warp index
//   is shuffled to a uniform value: ptxas serializes wgmma behind the
//   fences it must add on a path it cannot prove warpgroup-uniform.
//
// The launch plan (warpgroups, pass width, resident or streamed, stages,
// shared bytes) comes from probes/mma_int8.py::chain_plan; the entry point
// checks it against its own instances and shared-memory layout.  K a
// multiple of 128, at most 512; M ≥ 1 (rows past M are zeros, not stored).
#include "int8_tile.cuh"
#include "sm90_wgmma.cuh"

#include <type_traits>

#ifndef WGC_PINGPONG
#define WGC_PINGPONG 1   // resident B, two warpgroups: alternate their issue
#endif
#ifndef WGC_DIAG
#define WGC_DIAG 0       // 1: no epilogue stores (timing only; the output is wrong)
#endif

// shared bytes of a plan: a 1024-byte alignment pad, the slabs (64 rows of
// K elements, one or two a warpgroup), B (resident) or the ring, and the
// ring's mbarriers
static size_t chain_smem(int esize, int nwg, int np, bool resident, int stages, int K) {
  const size_t row = (size_t)K * esize, slab = 64 * row;
  const size_t slabs = (size_t)nwg * (K == np ? 1 : 2) * slab;
  return 1024 + slabs + (resident ? (size_t)K * row : (size_t)stages * np * 128 + 16 * stages);
}

template <typename T, int K, int NWG, int NP, bool RESIDENT, int STAGES>
__global__ void __launch_bounds__(NWG * 128 + (RESIDENT ? 0 : 32), 1)
wgmma_chain_kernel(const uint8_t* __restrict__ a, const uint8_t* __restrict__ bp,
                   uint8_t* __restrict__ out, int* __restrict__ acc_out, int M, int steps) {
  using AccT = typename std::conditional<std::is_same<T, int8_t>::value, int, float>::type;
  constexpr int THREADS = NWG * 128 + (RESIDENT ? 0 : 32);
  constexpr int RB = K * (int)sizeof(T);       // bytes a row
  constexpr int CPR = RB / 16;                 // 16-byte chunks a row
  constexpr int KP = RB / 128;                 // 128-byte panels a row
  constexpr int N_PASS = K / NP;
  constexpr int NSLAB = N_PASS > 1 ? 2 : 1;
  constexpr int SLAB = 64 * RB;                // a panel of a slab: 64 x 128 = 8192 bytes
  constexpr int RING = RESIDENT ? 1 : STAGES;  // (no ring where B is resident)
  constexpr bool PINGPONG = RESIDENT && NWG == 2 && WGC_PINGPONG;
  static_assert(K % NP == 0 && RB % 128 == 0 && NP % 8 == 0 && NP <= 256, "plan");
  static_assert(RESIDENT || STAGES >= 2, "a consumer holds one slot until its next is issued");
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint8_t* bsm = smem + NWG * NSLAB * SLAB;
  uint64_t* full = reinterpret_cast<uint64_t*>(bsm + (RESIDENT ? K * RB : STAGES * NP * 128));
  uint64_t* empty = full + RING;
  const int tid = threadIdx.x, lane = tid & 31, warp = warp_uniform(tid >> 5);
  const long long m0 = (long long)blockIdx.x * (NWG * 64);

  // the block's rows of a into each warpgroup's first slab (zeros past M)
  for (int e = tid; e < NWG * 64 * CPR; e += THREADS) {
    const int r = e / CPR, c = e % CPR;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (m0 + r < M) v = *reinterpret_cast<const uint4*>(a + (m0 + r) * RB + c * 16);
    *reinterpret_cast<uint4*>(smem + (r >> 6) * NSLAB * SLAB + (c >> 3) * 8192 +
                              swz128(r & 63, (c & 7) * 16)) = v;
  }
  if constexpr (RESIDENT) {   // the packed B is the shared layout: one contiguous copy
    for (int e = tid; e < K * CPR; e += THREADS)
      reinterpret_cast<uint4*>(bsm)[e] = reinterpret_cast<const uint4*>(bp)[e];
  } else if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 4 * NWG);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  fence_proxy_async();
  __syncthreads();

  if constexpr (!RESIDENT) {
    if (warp == NWG * 4) {    // the producer warp: one lane walks the tiles
      if (lane == 0)          // tile q: pass (q / KP) mod N_PASS, panel q mod KP
        for (long long q = 0, total = (long long)steps * N_PASS * KP; q < total; ++q) {
          const int st = (int)(q % STAGES);
          mbar_wait(&empty[st], (unsigned)(((q / STAGES) & 1) ^ 1));
          const int p = (int)((q / KP) % N_PASS), kp = (int)(q % KP);
          mbar_arrive_expect_tx(&full[st], NP * 128);
          bulk_copy_g2s(bsm + st * NP * 128, bp + kp * (K * 128) + p * (NP * 128), NP * 128,
                        &full[st]);
        }
      return;
    }
  }

  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t = lane & 3;
  uint8_t* cur = smem + wg * NSLAB * SLAB;
  uint8_t* nxt = cur + (NSLAB - 1) * SLAB;
  const long long row0 = m0 + 64 * wg;           // the warpgroup's first row
  Acc<AccT, NP> acc;
#pragma unroll
  for (int i = 0; i < NP / 2; ++i) acc.r[i] = 0;

  int q = 0;                                     // streamed tiles taken, mod 2·STAGES
  for (int s = 0; s < steps; ++s) {
    if (PINGPONG && (wg == 1 || s > 0))          // the other warpgroup issued before us
      named_bar_sync(wg == 0 ? 4 : 3, 256);
#pragma unroll
    for (int p = 0; p < N_PASS; ++p) {
      fence_acc(acc);
      wgmma_fence();
      const uint64_t da = sw128_desc(smem_u32(cur));
      if constexpr (RESIDENT) {
        const uint64_t db = sw128_desc(smem_u32(bsm + p * NP * 128));
#pragma unroll
        for (int j = 0; j < 4 * KP; ++j)         // 32-byte k-slices: 4 a panel
          wgmma_ss(acc, da + (j >> 2) * (8192 >> 4) + 2 * (j & 3),
                   db + (j >> 2) * (K * 128 >> 4) + 2 * (j & 3), j);
        wgmma_commit();
        if (PINGPONG && p == N_PASS - 1) named_bar_arrive(wg == 0 ? 3 : 4, 256);
        wgmma_wait<0>();
      } else {
        int prev = 0;
#pragma unroll
        for (int kp = 0; kp < KP; ++kp) {
          const int st = q % STAGES;
          mbar_wait(&full[st], (unsigned)(q >= STAGES));
          __syncwarp();
          const uint64_t db = sw128_desc(smem_u32(bsm + st * NP * 128));
#pragma unroll
          for (int i = 0; i < 4; ++i) wgmma_ss(acc, da + kp * (8192 >> 4) + 2 * i, db + 2 * i, kp + i);
          wgmma_commit();
          if (kp > 0) {  // the previous tile's products are done: free its slot
            wgmma_wait<1>();
            if (lane == 0) mbar_arrive(&empty[prev]);
          }
          prev = st;
          q = q + 1 == 2 * STAGES ? 0 : q + 1;
        }
        wgmma_wait<0>();
        if (lane == 0) mbar_arrive(&empty[prev]);
      }
      fence_acc(acc);

      // epilogue: pass p's columns p·NP + 8j + 2t (+1) of rows 16·wl + g (+8)
      if (acc_out) {             // one_mm: the int32 sums themselves
#pragma unroll
        for (int j = 0; j < NP / 8; ++j)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * wl + g + 8 * h, col = p * NP + 8 * j + 2 * t;
            if (row0 + r < M)
              *reinterpret_cast<int2*>(acc_out + (row0 + r) * K + col) =
                  make_int2((int)acc.r[4 * j + 2 * h], (int)acc.r[4 * j + 2 * h + 1]);
          }
        continue;
      }
      if (WGC_DIAG) continue;
#pragma unroll
      for (int j = 0; j < NP / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = 16 * wl + g + 8 * h, col = p * NP + 8 * j + 2 * t;
          const AccT v0 = acc.r[4 * j + 2 * h], v1 = acc.r[4 * j + 2 * h + 1];
          if constexpr (std::is_same<T, int8_t>::value) {
            // (v >> 8) wrapped to int8 is byte 1 of v: one byte permute packs the pair
            *reinterpret_cast<uint16_t*>(nxt + (col >> 7) * 8192 + swz128(r, col & 127)) =
                (uint16_t)__byte_perm(v0, v1, 0x0051);
          } else {
            const int byte = 2 * col;
            *reinterpret_cast<__nv_bfloat162*>(nxt + (byte >> 7) * 8192 + swz128(r, byte & 127)) =
                __floats2bfloat162_rn(__fmul_rn(v0, 0.01f), __fmul_rn(v1, 0.01f));
          }
        }
    }
    fence_proxy_async();                        // the new slab, to the next step's wgmma
    named_bar_sync(1 + wg, 128);
    uint8_t* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }
  if (PINGPONG && wg == 0 && steps > 0) named_bar_sync(4, 256);   // warpgroup 1's last arrival
  if (acc_out) return;
  for (int e = tid & 127; e < 64 * CPR; e += 128) {
    const int r = e / CPR, c = e % CPR;
    if (row0 + r < M)
      *reinterpret_cast<uint4*>(out + (row0 + r) * RB + c * 16) =
          *reinterpret_cast<const uint4*>(cur + (c >> 3) * 8192 + swz128(r, (c & 7) * 16));
  }
}

// B (K, K) row-major into the kernel's layout, in global memory: panel kp
// (bytes kp·128 .. of K) of output column n at kp·K·128 + swz128(n, ·), so
// a resident B is one contiguous copy and a streamed tile (NP columns of
// one panel) one bulk copy, each landing in the swizzle wgmma reads
template <typename T, int K>
__global__ void wgmma_pack_b(const T* __restrict__ b, uint8_t* __restrict__ bp) {
  constexpr int PER = 16 / (int)sizeof(T);
  const int e = blockIdx.x * blockDim.x + threadIdx.x;    // a 16-byte chunk of the packed B
  if (e >= K * K / PER) return;
  const int kp = e / (K * 8), n = (e / 8) % K, c = e % 8;
  const int k0 = (kp * 128 + c * 16) / (int)sizeof(T);
  alignas(16) T v[PER];
#pragma unroll
  for (int i = 0; i < PER; ++i) v[i] = b[(k0 + i) * K + n];
  *reinterpret_cast<uint4*>(bp + kp * (K * 128) + swz128(n, c * 16)) =
      *reinterpret_cast<const uint4*>(v);
}

template <typename T, int K, int NWG, int NP, bool RESIDENT, int STAGES>
static int launch(const void* a, const void* b, void* bp, void* out, void* acc_out, int M,
                  int steps, size_t smem, cudaStream_t stream) {
  if (chain_smem(sizeof(T), NWG, NP, RESIDENT, STAGES, K) != smem)
    return (int)cudaErrorInvalidValue;
  auto kernel = wgmma_chain_kernel<T, K, NWG, NP, RESIDENT, STAGES>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int chunks = K * K * (int)sizeof(T) / 16;
  wgmma_pack_b<T, K><<<(chunks + 255) / 256, 256, 0, stream>>>((const T*)b, (uint8_t*)bp);
  kernel<<<(unsigned)((M + NWG * 64 - 1) / (NWG * 64)), NWG * 128 + (RESIDENT ? 0 : 32), smem,
           stream>>>((const uint8_t*)a, (const uint8_t*)bp, (uint8_t*)out, (int*)acc_out, M,
                     steps);
  return (int)cudaGetLastError();
}

// the instances chain_plan may choose (one line each: type, K, warpgroups,
// pass columns, resident, stages); tests/test_torch_wgmma_plan.py reads
// this table and holds every plan to it
#define WGC_INSTANCES(X)                  \
  X(int8_t, 128, 2, 128, true, 0)         \
  X(int8_t, 256, 2, 256, true, 0)         \
  X(int8_t, 384, 2, 192, false, 4)        \
  X(int8_t, 512, 2, 256, false, 3)        \
  X(__nv_bfloat16, 128, 2, 128, true, 0)  \
  X(__nv_bfloat16, 256, 2, 256, true, 0)  \
  X(__nv_bfloat16, 384, 1, 192, false, 4) \
  X(__nv_bfloat16, 512, 1, 256, false, 3)

// a: (M, K) int8 or bfloat16 (bf16), contiguous, 16-byte aligned; b: (K,
// K) of the same type, contiguous; bp: K·K elements of scratch, 16-byte
// aligned, for B packed (wgmma_pack_b, launched first); out: (M, K) of the
// type, or NULL with acc_out; acc_out: (M, K) int32 (int8, one step) or
// NULL.  The plan: warpgroups, pass columns, resident, stages, shared bytes.
extern "C" int edm_wgmma_chain(const void* a, const void* b, void* bp, void* out, void* acc_out,
                               int M, int K, int steps, int bf16, int wgs, int np, int resident,
                               int stages, long long smem, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
#define WGC_TRY(T, KK, NWG, NP, RES, ST)                                                   \
  if (bf16 == (int)std::is_same<T, __nv_bfloat16>::value && K == KK && wgs == NWG &&      \
      np == NP && resident == (int)RES && stages == ST)                                   \
    return launch<T, KK, NWG, NP, RES, ST>(a, b, bp, out, acc_out, M, steps, (size_t)smem, s);
  WGC_INSTANCES(WGC_TRY)
#undef WGC_TRY
  return (int)cudaErrorInvalidValue;
}
