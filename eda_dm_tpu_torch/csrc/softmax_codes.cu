// K3: softmax over the last axis → centered int8 act codes.
//
// Replaces the Pallas kernel of eda_dm_tpu/ops/pallas_softmax.py
// (softmax_int8_codes), which every int8 einsum attention runs between its
// two code products (CIFAR's 16×16 and 8×8 sites, bedroom's 8×8, SD's
// cross-attentions over the 77 text tokens).  Per row of S logits (float32,
// or bfloat16 upcast in the kernel):
//
//   m = max x            e = expf(x − m)         Σ = f32(Σe in float64)
//   w = e / Σ            q = clip(rint(w / Δ), −zp, L−1−zp)
//   code = q − (L/2 − zp)
//
// Every float32 step is the IEEE operation the plain version
// (eda_dm_tpu_torch/ops/softmax_codes.py::softmax_int8_codes_plain) takes:
// libdevice expf (PyTorch's exp on the card; no fast math), IEEE divisions
// and rint.  The row sum is taken in float64 and rounded once, so it does
// not depend on the add order unless two orders' f64 sums straddle a
// float32 rounding boundary.
//
// Bound on this card: bytes.  At SD's (64·4096, 77) float32 the logits are
// read once and the codes written once, 0.030 ms at 3.35 TB/s; the exact
// function is about 40 instructions an element (an exponential, two
// divisions, the f64 sum), about as much again.  The design:
//
// * A tile is a run of whole rows, one contiguous span of rows·S elements.
//   Its 16-byte aligned body is copied into shared memory by cp.async,
//   whatever the row boundaries (a 77-float row is 308 bytes: no row after
//   the first is 16-byte aligned); the ragged head and tail go by scalar
//   loads.  The tile sits in shared memory shifted by the span's address
//   modulo 16, so the copies are aligned on both sides.
// * The grid is persistent (as many blocks as the SMs hold), each block
//   walking tiles with two tile buffers: the next tile's copies are in
//   flight while this tile's rows are computed, so the loads of a block do
//   not wait for its arithmetic.
// * tpr threads take a row (the plan, ops/softmax_codes.py::softmax_plan),
//   as few as leave each thread about 16 of its elements (4 at least, 256
//   at most; up to 1024 for rows past 8192), so a warp takes 32/tpr rows at
//   once and every instruction works on 32 elements.  Thread t holds
//   elements t, t + tpr, … in registers (nmax of them, a template constant
//   of 1 to 32 that need not be a power of two: 77 = 8 threads × 10), so
//   shared memory is read once.  Float32 rows of whole 16-byte vectors sit
//   in the tile at a stride padded to tpr words past a multiple of 32, so
//   the rows of a warp read distinct banks.
// * Each thread takes its elements' maximum and float64 sum of the
//   exponentials in a fixed pairwise tree, then an xor tree adds the lanes
//   of a row (every lane gets the same bits: each step adds the same two
//   values), then the warps of a row meet in warp order.  The maximum is
//   exact in any order.
// * e/Σ takes divide() with Σ's Divisor made once a row, w/Δ the
//   quantizer's (exact_arith.cuh).  For Δ in [2⁻²⁰, 2¹¹] both run without
//   branches or checks: where e ≥ 2⁻⁸⁰, divide() gives __fdiv_rn's bits
//   (held at every float e in [2⁻⁸⁰, 1] by edm_softmax_check_arith), and
//   so does w/Δ where w ≥ 2⁻⁸⁰ (K6's quotient_fast); below, both the IEEE
//   quotient and divide()'s stay under 2⁻⁶⁰·(1 + ε), so the code is that
//   of 0 either way (the check holds every code of e in [0, 1]).  Other Δs
//   take __fdiv_rn.
// * Every slot of a thread is computed, those past S holding −∞ (an
//   exponential of 0), and its code stored to the row or, past S or past
//   the tile's rows, to a dump byte: no branch an element.
// * The codes are packed in shared memory and stored as 16-byte vectors
//   (the ragged head and tail of the span by bytes).
//
// Probe builds only (probes/softmax_plans.py): K3_STOP_AFTER = 0 leaves
// each tile after its load, 1 after the row maxima and sums (no codes, no
// store).  K3_DIAG builds give wrong codes, for timing only: 1 multiplies
// by the divisors' reciprocals in place of both divisions, 2 takes __expf
// in place of expf, 4 loads nothing (the arithmetic alone), 8 adds in
// float32.  K3_BLOCKS_AN_SM sets the launch bounds' blocks an SM; K3_GRID_ALL
// launches a block a tile.
#include "exact_arith.cuh"
#include "int8_tile.cuh"

#include <cmath>
#include <type_traits>

#ifndef K3_DIAG
#define K3_DIAG 0
#endif
#ifndef K3_BLOCKS_AN_SM
#define K3_BLOCKS_AN_SM 1           // blocks an SM the launch bounds ask (below NMAX_MAX)
#endif

namespace {

constexpr int MAX_THREADS = 1024;            // threads a block
constexpr int WARPS_MAX = MAX_THREADS / 32;
constexpr int NMAX_MAX = 32;                 // elements a thread holds, at most
constexpr int WIDE_THREADS = 256;            // threads a block below NMAX_MAX elements
constexpr float TINY = 0x1p-80f;             // divide() gives IEEE bits from here

// the tile's row stride in elements: S, or for float32 rows of whole 16-byte
// vectors whose threads share a warp, S padded to ≡ tpr (mod 32) words, so
// that the rows of a warp fall in distinct banks
__host__ __device__ inline int k3_stride(int S, int esz, int tpr) {
  return esz == 4 && S % 4 == 0 && tpr < 32 ? S + ((tpr - S) & 31) : S;
}

// the dynamic shared memory: one or two tiles (`buffers`) in the input's
// dtype (P elements a row, each shifted by up to 15 bytes) | the codes
// (rows·S, likewise) | each warp's row maximum f32 | each warp's row sum f64
// | a dump byte for the codes of slots past a row
struct Layout {
  int tile, codes, rmax, rsum, dump, total;
};
__host__ __device__ inline Layout k3_layout(int rows, int P, int S, int esz, int buffers) {
  Layout l;
  l.tile = (rows * P * esz + 16 + 15) / 16 * 16;
  l.codes = buffers * l.tile;
  l.rmax = l.codes + (rows * S + 16 + 15) / 16 * 16;
  l.rsum = l.rmax + WARPS_MAX * 4;
  l.dump = l.rsum + WARPS_MAX * 8;
  l.total = l.dump + 16;
  return l;
}

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_one() {   // all but the last group landed
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The code of one exponential e of a row whose f32 sum is `sum` (Divisor D).
// FASTQ (Δ in [2⁻²⁰, 2¹¹]): both divisions by divide().  Else both by
// __fdiv_rn.
template <bool FASTQ>
__device__ __forceinline__ uint32_t code_of(float e, float sum, const Divisor& D,
                                            const Quant& qz) {
  float q;
  if (K3_DIAG & 1) {
    q = __fmul_rn(__fmul_rn(e, D.y), qz.D.y);
  } else if (FASTQ) {
    q = divide(divide(e, D), qz.D);
  } else {
    q = __fdiv_rn(__fdiv_rn(e, sum), qz.D.b);
  }
  return code_word(q, qz);
}

__device__ __forceinline__ float exp_of(float v) {
  return (K3_DIAG & 2) ? __expf(v) : expf(v);
}

// the rows of one iteration of the block: group `grp` of tpr threads takes
// row `r` of the tile (none where r ≥ nrows; such groups still meet the
// block's barriers).  A thread's elements meet in a fixed pairwise tree,
// the lanes of a row in an xor tree, the warps of a row in warp order.
template <int NMAX, bool FASTQ, typename InT>
__device__ __forceinline__ void rows_pass(const InT* tile, uint8_t* codes, uint8_t* dump, int r,
                                          bool active, int t, int tpr, int P, int S,
                                          const Quant& qz, float* rmax, double* rsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int width = tpr < 32 ? tpr : 32;
  // slots past S hold −∞ (their exponentials are 0); rows past the tile's
  // compute on stale data and store nothing
  const int cnt = (S - t + tpr - 1) / tpr;         // this thread's slots within the row
  const InT* src = tile + r * P + t;
  float v[NMAX], mt[NMAX];
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    v[i] = i < cnt ? to_f32(src[i * tpr]) : -INFINITY;
    mt[i] = v[i];
  }
#pragma unroll
  for (int w = 1; w < NMAX; w *= 2)
#pragma unroll
    for (int i = 0; i + w < NMAX; i += 2 * w) mt[i] = fmaxf(mt[i], mt[i + w]);
  float m = mt[0];
  for (int d = width >> 1; d; d >>= 1) m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, d));
  const int w0 = (threadIdx.x / tpr) * (tpr >> 5), nw = tpr >> 5;
  if (tpr > 32) {                      // the row's warps meet
    if (lane == 0) rmax[warp] = m;
    __syncthreads();
    m = rmax[w0];
    for (int k = 1; k < nw; ++k) m = fmaxf(m, rmax[w0 + k]);
  }
  using Acc = typename std::conditional<(K3_DIAG & 8) != 0, float, double>::type;
  Acc st[NMAX];
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    v[i] = exp_of(__fsub_rn(v[i], m));
    st[i] = (Acc)v[i];
  }
#pragma unroll
  for (int w = 1; w < NMAX; w *= 2)
#pragma unroll
    for (int i = 0; i + w < NMAX; i += 2 * w) st[i] = st[i] + st[i + w];
  double s = st[0];
  for (int d = width >> 1; d; d >>= 1) s = __dadd_rn(s, __shfl_xor_sync(0xffffffffu, s, d));
  if (tpr > 32) {
    if (lane == 0) rsum[warp] = s;
    __syncthreads();
    s = rsum[w0];
    for (int k = 1; k < nw; ++k) s = __dadd_rn(s, rsum[w0 + k]);
  }
  const float sum = __double2float_rn(s);
#if defined(K3_STOP_AFTER)
  // keep the statistics: store on a value no input reaches
  if (sum == 1.2345e-30f) codes[0] = 1;
#else
  // every slot's code, without branches; slots past S and rows past the
  // tile's store to a dump byte
  const Divisor D = divisor(sum);
  const int base = r * S + t;
#pragma unroll
  for (int i = 0; i < NMAX; ++i) {
    const uint32_t c = code_of<FASTQ>(v[i], sum, D, qz);
    *(active && i < cnt ? codes + base + i * tpr : dump) = (uint8_t)c;
  }
#endif
}

// rows·S elements from src (a tile's span) into shared memory at `tile`
// (16-byte aligned modulo src's address): the aligned body by cp.async, the
// ragged head and tail by scalar copies; or, for rows of whole vectors at a
// padded stride P, row by row
template <typename InT>
__device__ __forceinline__ void load_tile(const InT* src, InT* tile, int nrows, int S, int P) {
  constexpr int esz = (int)sizeof(InT), per = 16 / esz;
  const int n = nrows * S;
  if (K3_DIAG & 4) return;
  if (P != S) {
    const int cpr = S / per;                             // vectors a row
    for (int c = threadIdx.x; c < nrows * cpr; c += blockDim.x) {
      const int r = c / cpr, k = c - r * cpr;
      cp_async16(tile + r * P + k * per, src + (long long)r * S + k * per);
    }
    return;
  }
  const int h = (int)(reinterpret_cast<uintptr_t>(src) & 15);
  const int nh = h ? min((16 - h) / esz, n) : 0;         // head elements
  const int nb = (n - nh) / per;                         // body vectors
  const int nt = nh + nb * per;                          // the tail's first element
  for (int c = threadIdx.x; c < nb; c += blockDim.x)
    cp_async16(tile + nh + c * per, src + nh + c * per);
  for (int i = threadIdx.x; i < nh; i += blockDim.x) tile[i] = src[i];
  for (int i = nt + (int)threadIdx.x; i < n; i += blockDim.x) tile[i] = src[i];
}

// A persistent grid: block b takes tiles b, b + gridDim, …; the next
// tile's copies are in flight while this one's rows are computed.
template <int NMAX, typename InT>
__global__ void __launch_bounds__(NMAX == NMAX_MAX ? MAX_THREADS : WIDE_THREADS,
                                  NMAX == NMAX_MAX ? 1 : K3_BLOCKS_AN_SM)
softmax_codes_kernel(const InT* __restrict__ x, const float* __restrict__ delta_p,
                     const float* __restrict__ zp_p, int8_t* __restrict__ out, int R, int S,
                     int n_levels, int tpr, int rows, int buffers) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int esz = (int)sizeof(InT);
  const int ntiles = (int)((R + (long long)rows - 1) / rows);
  // rows of whole vectors at a padded stride where the base is aligned
  // (then so is every tile's span)
  const int P = reinterpret_cast<uintptr_t>(x) & 15 ? S : k3_stride(S, esz, tpr);
  const Layout L = k3_layout(rows, P, S, esz, buffers);
  auto span = [&](int tile_id) { return x + (long long)tile_id * rows * S; };
  auto tile_at = [&](int tile_id, int buf) {
    return reinterpret_cast<InT*>(smem + buf * L.tile +
                                  (reinterpret_cast<uintptr_t>(span(tile_id)) & 15));
  };
  auto rows_of = [&](int tile_id) {
    const long long left = R - (long long)tile_id * rows;
    return left < rows ? (int)left : rows;
  };
  float* rmax = reinterpret_cast<float*>(smem + L.rmax);
  double* rsum = reinterpret_cast<double*>(smem + L.rsum);
  uint8_t* dump = smem + L.dump;
  const Quant qz = quant_consts(*delta_p, *zp_p, n_levels);
  const int rpi = blockDim.x / tpr, grp = threadIdx.x / tpr, t = threadIdx.x % tpr;

  int tile_id = blockIdx.x;
  if (tile_id < ntiles) load_tile(span(tile_id), tile_at(tile_id, 0), rows_of(tile_id), S, P);
  cp_async_commit();
  for (int it = 0; tile_id < ntiles; ++it, tile_id += gridDim.x) {
    const int next = tile_id + gridDim.x;
    if (buffers == 2 && next < ntiles)
      load_tile(span(next), tile_at(next, (it + 1) & 1), rows_of(next), S, P);
    cp_async_commit();
    cp_async_wait_one();                                 // this tile's copies
    __syncthreads();
    const InT* tile = tile_at(tile_id, it & 1);
    const int nrows = rows_of(tile_id), n = nrows * S;
    int8_t* dst = out + (long long)tile_id * rows * S;
    const int ho = (int)(reinterpret_cast<uintptr_t>(dst) & 15);
    uint8_t* codes = smem + L.codes + ho;
#if defined(K3_STOP_AFTER) && K3_STOP_AFTER == 0
    if (to_f32(tile[threadIdx.x % n]) == 1.2345e-30f) dst[0] = 0;
    __syncthreads();
    continue;
#endif
    for (int r = grp; r - grp < rows; r += rpi) {
      if (qz.fast)
        rows_pass<NMAX, true, InT>(tile, codes, dump, r, r < nrows, t, tpr, P, S, qz, rmax,
                                   rsum);
      else
        rows_pass<NMAX, false, InT>(tile, codes, dump, r, r < nrows, t, tpr, P, S, qz, rmax,
                                    rsum);
    }
    __syncthreads();
#if defined(K3_STOP_AFTER)
    if (codes[0] == 1) dst[0] = 0;
#else
    // ---- the codes out: 16-byte vectors, the ragged head and tail by bytes
    const int nh = ho ? min(16 - ho, n) : 0;
    const int nb = (n - nh) / 16, nt = nh + nb * 16;
    for (int c = threadIdx.x; c < nb; c += blockDim.x)
      *reinterpret_cast<uint4*>(dst + nh + 16 * c) =
          *reinterpret_cast<const uint4*>(codes + nh + 16 * c);
    for (int i = threadIdx.x; i < nh; i += blockDim.x) dst[i] = (int8_t)codes[i];
    for (int i = nt + (int)threadIdx.x; i < n; i += blockDim.x) dst[i] = (int8_t)codes[i];
#endif
  }
}

template <int NMAX, typename InT>
int launch(const void* x, const void* delta, const void* zp, void* out, int R, int S,
           int n_levels, int tpr, int rows, int buffers, int threads, int smem,
           cudaStream_t stream) {
  auto kern = softmax_codes_kernel<NMAX, InT>;
  // the attribute and the SM count once per device, the blocks an SM holds
  // once per (threads, shared bytes): each costs host microseconds
  static int set_dev = -1, sms = 0, occ_threads = 0, occ_smem = -1, occ_blocks = 0;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && dev != set_dev) {
    int optin = 0;
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, optin);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (e == cudaSuccess) set_dev = dev, occ_smem = -1;
  }
  if (e != cudaSuccess) return (int)e;
  if (threads != occ_threads || smem != occ_smem) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&occ_blocks, kern, threads, smem);
    if (e != cudaSuccess) return (int)e;
    if (occ_blocks < 1) return (int)cudaErrorInvalidConfiguration;
    occ_threads = threads, occ_smem = smem;
  }
  // one buffer: a block a tile; two: a persistent grid of the blocks the
  // SMs hold
  const long long tiles = (R + (long long)rows - 1) / rows;
  const long long resident = (long long)occ_blocks * sms;
#if defined(K3_GRID_ALL)
  const unsigned blocks = (unsigned)tiles;
#else
  const unsigned blocks = (unsigned)(buffers == 1 || tiles < resident ? tiles : resident);
#endif
  kern<<<blocks, threads, smem, stream>>>((const InT*)x, (const float*)delta,
                                          (const float*)zp, (int8_t*)out, R, S, n_levels,
                                          tpr, rows, buffers);
  return (int)cudaGetLastError();
}

template <typename InT>
int launch_nmax(int nmax, const void* x, const void* delta, const void* zp, void* out, int R,
                int S, int n_levels, int tpr, int rows, int buffers, int threads, int smem,
                cudaStream_t s) {
#define EDM_K3_ARGS x, delta, zp, out, R, S, n_levels, tpr, rows, buffers, threads, smem, s
  switch (nmax) {
    case 1: return launch<1, InT>(EDM_K3_ARGS);
    case 2: return launch<2, InT>(EDM_K3_ARGS);
    case 4: return launch<4, InT>(EDM_K3_ARGS);
    case 6: return launch<6, InT>(EDM_K3_ARGS);
    case 8: return launch<8, InT>(EDM_K3_ARGS);
    case 10: return launch<10, InT>(EDM_K3_ARGS);
    case 12: return launch<12, InT>(EDM_K3_ARGS);
    case 16: return launch<16, InT>(EDM_K3_ARGS);
    case 24: return launch<24, InT>(EDM_K3_ARGS);
    default: return launch<NMAX_MAX, InT>(EDM_K3_ARGS);
  }
#undef EDM_K3_ARGS
}

}  // namespace

// x: (R, S) float32 or bfloat16 (in_bf16), contiguous, its address a
// multiple of its element size; delta, zp: float32 scalars on the card;
// out: (R, S) int8.  plan (ops/softmax_codes.py, softmax_plan): tpr threads
// a row (a power of two; a multiple of 32 past 32), nmax elements a thread
// (1, 2, 4, 6, 8, 10, 12, 16, 24 or 32; tpr·nmax ≥ S), rows a tile,
// buffers (2: a persistent grid, the next tile loading under this one; 1:
// a block a tile), threads a block (a multiple of 32 and of tpr; at most
// 256, or 1024 with 32 elements a thread), smem dynamic shared bytes (at
// least k3_layout's with k3_stride's row stride).
extern "C" int edm_softmax_codes(const void* x, const void* delta, const void* zp, void* out,
                                 int in_bf16, int R, int S, int n_levels, int tpr, int nmax,
                                 int rows, int buffers, int threads, int smem, void* stream) {
  const int esz = in_bf16 ? 2 : 4;
  if (R <= 0 || S <= 0 || n_levels < 2 || n_levels > 256 ||
      reinterpret_cast<uintptr_t>(x) % esz)
    return (int)cudaErrorInvalidValue;
  if (tpr <= 0 || (tpr & (tpr - 1)) || (tpr > 32 && tpr % 32) || threads % 32 ||
      threads > MAX_THREADS || threads < tpr || threads % tpr ||
      (nmax != 1 && nmax != 2 && nmax != 4 && nmax != 6 && nmax != 8 && nmax != 10 &&
       nmax != 12 && nmax != 16 && nmax != 24 && nmax != NMAX_MAX) ||
      (nmax != NMAX_MAX && threads > WIDE_THREADS) || (long long)tpr * nmax < S || rows <= 0 ||
      (buffers != 1 && buffers != 2) || (long long)rows * (S + 32) * esz > (1 << 20) ||
      smem < k3_layout(rows, k3_stride(S, esz, tpr), S, esz, buffers).total ||
      (R + (long long)rows - 1) / rows > INT32_MAX)
    return (int)cudaErrorInvalidConfiguration;
  cudaStream_t s = (cudaStream_t)stream;
  if (in_bf16)
    return launch_nmax<__nv_bfloat16>(nmax, x, delta, zp, out, R, S, n_levels, tpr, rows,
                                      buffers, threads, smem, s);
  return launch_nmax<float>(nmax, x, delta, zp, out, R, S, n_levels, tpr, rows, buffers,
                            threads, smem, s);
}

// ---------------------------------------------------------------------------
// The divisions against IEEE's (test use): at every float e in [0, 1] and a
// row sum `sigma`, divide() against __fdiv_rn where e ≥ 2⁻⁸⁰ (where it
// gives IEEE's bits), and the code of every e against that of __fdiv_rn →
// __fdiv_rn → rintf → __float2int_rn with this quantizer.

namespace {

__global__ void check_kernel(float sigma, float d, float z, int n_levels,
                             unsigned long long* bad) {
  const Quant qz = quant_consts(d, z, n_levels);
  const Divisor D = divisor(sigma);
  const unsigned long long n = 0x3f800000ull + 1;     // [0, 1], 1 included
  unsigned long long quotients = 0, codes = 0;
  for (unsigned long long i = blockIdx.x * (unsigned long long)blockDim.x + threadIdx.x; i < n;
       i += (unsigned long long)gridDim.x * blockDim.x) {
    const float e = __uint_as_float((unsigned)i);
    if (e >= TINY)
      quotients += __float_as_uint(divide(e, D)) != __float_as_uint(__fdiv_rn(e, sigma));
    const uint32_t got = qz.fast ? code_of<true>(e, sigma, D, qz) : code_of<false>(e, sigma, D, qz);
    const float q = fminf(fmaxf(rintf(__fdiv_rn(__fdiv_rn(e, sigma), d)), qz.lo), qz.hi);
    codes += (int)(int8_t)(uint8_t)got != (int)(int8_t)__float2int_rn(__fsub_rn(q, qz.cc));
  }
  if (quotients) atomicAdd(bad, quotients);
  if (codes) atomicAdd(bad + 1, codes);
}

}  // namespace

// bad: two zeroed uint64 counters on the card: quotients e/sigma and codes
// that differ from IEEE's (0 each expected); sigma in [1, 2²⁴], Δ, zp and
// the levels as the quantizer has them.
extern "C" int edm_softmax_check_arith(float sigma, float d, float zp, int n_levels, void* bad,
                                       void* stream) {
  if (!(sigma >= 1.0f) || !(sigma <= 0x1p24f) || !(d > 0.0f) || !(d < 0x1p100f))
    return (int)cudaErrorInvalidValue;
  check_kernel<<<1056, 256, 0, (cudaStream_t)stream>>>(sigma, d, zp, n_levels,
                                                       (unsigned long long*)bad);
  return (int)cudaGetLastError();
}
