// K-mix (B7): the 3-tap temporal linear mix of FFInflatedConv as one tiled
// GEMM, for sm_90a.  Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel _mix_kernel (asva_tpu/ops/pallas_fused.py
// :906), called by _ff_mix_flat (:923); public fused_ff_mix (:955):
//
//   out[b, f] = y[b, f] + y[b, 0] Kh^T + y[b, max(f-1, 0)] Kp^T
//               + y[b, f] Kc^T + bias
//
// on y (B, F, N, C) contiguous, with Kh, Kp, Kc (C, C) in torch Linear
// layout (out, in) and a row stride of their own, so the three column blocks
// [head | prev | curr] of a Linear(3C, C) weight are read in place.  The
// previous frame of frame 0 is frame 0 (the concat-shift of the reference).
//
// It is one product with a contraction of 3C whose A rows come from three
// row maps: for output row m = (b*F + f)*N + i the K range [0, C) reads row
// m - f*N (frame 0), [C, 2C) reads row m - N if f > 0 else m, and [2C, 3C)
// reads row m itself.  As in the Pallas body the three products accumulate
// in fp32 in one accumulator, y and the bias are added in fp32 as
// (y + acc) + bias, and the sum is cast once.  No split-K: a row's bits do
// not depend on M or on the grid (the tile width depends on C alone).
//
// bf16: K-gemm's mainloop (gemm.cu, tma.cuh).  A block owns NWG x 64 rows
// (NWG = 2, or 1 when the grid would not fill the card) and a TN-wide
// column panel (TN = 160 where it divides C, every SD1.5 width; else 64).
// K streams in 64-deep tiles of 128-byte rows, 128-byte swizzled, through a
// STAGES-deep ring of mbarrier-counted stages that thread 0 refills, STAGES
// - 1 tiles in flight, wgmma (m64nTNk16) on each.  A K tile lies in one tap:
//   W by TMA, read in place: one tensor map a tap (a column block of
//     conv_temp.weight is a (C, C) map with the weight's row stride);
//   A by one of two loaders (ops/fused.py `ff_mix_plan` chooses the
//     loader, TN and the rows a block from the shape; asva_ff_mix checks
//     that the shape admits them):
//     FRAME   N % BM == 0: the tile's rows lie in one frame, so each tap's
//             rows are one TMA box (the row itself, the row - N or itself at
//             f = 0, the row - f N);
//     CPASYNC any N (tiles across frames and clips): every thread copies
//             16-byte chunks of its rows with cp.async into the same
//             swizzled layout, in cp.async groups that follow the ring.
//   (8-row TMA boxes across frames, BM / 8 of them a tap, took 2.5-3.2x
//   FRAME's time and 2.8x CPASYNC's at 4x4 on the H100: not kept.)
// The epilogue stages the fp32 accumulators through shared memory and
// writes 16-byte vectors, reading y and the bias the same way.
// fp32: a plain FMA path, 64x64 tile, 256 threads of 4x4 (the check path).
//
// What bounds it on the H100: 2 M 3C C operations against (2 M C + 3 C C)
// elements moved; from C = 320 up it is bound by operations (at 32x32, M =
// 24576, 15 GFLOP against 32 MB).  The three A reads of a row hit L2 (frame
// 0 and the previous frame were just read by neighbouring blocks).  At the
// small levels (8x8, 4x4) the grid is thin (no split-K) and a block's fixed
// costs dominate.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int BM = 64, BN = 64;

// source row of output row m for tap 0 (frame 0), 1 (previous frame,
// clamped at frame 0) and 2 (the row itself)
__device__ __forceinline__ int tap_row(int m, int tap, int F, int N) {
  const int f = (m / N) % F;
  if (tap == 0) return m - f * N;
  if (tap == 1) return f > 0 ? m - N : m;
  return m;
}

// ---------------------------------------------------------------- bf16 ---

enum { A_FRAME = 0, A_CPASYNC = 1 };

constexpr int SMEM_SM = 233472;        // shared memory of an SM
constexpr int SMEM_CTA = 232448;       // ... that one block may use

// Shared-memory plan: the ring of STAGES (A, W) tiles, reused by the
// epilogue's fp32 staging tile, then the mbarriers.  Two blocks an SM, as
// K-gemm's epilogue-2 plan, so one block's epilogue overlaps the other's
// products.
template <int TN, int NWG>
struct Plan {
  static constexpr int CTAS = 2;
  static constexpr int BM = 64 * NWG, NT = 128 * NWG;
  static constexpr int A_BYTES = BM * BK * 2, W_BYTES = TN * BK * 2;
  static constexpr int STAGE = A_BYTES + W_BYTES;
  static constexpr int LDS = TN + 8;   // staging row, conflict-free pairs
  static constexpr int STAGING = BM * LDS * 4;
  static constexpr int BUDGET = (SMEM_SM / CTAS - 1024 < SMEM_CTA
                                     ? SMEM_SM / CTAS - 1024 : SMEM_CTA);
  static constexpr int FIT = (BUDGET - 8 * 5 - 1024) / STAGE;
  static constexpr int STAGES = FIT > 5 ? 5 : FIT;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int AREA = RING > STAGING ? RING : STAGING;
  // + STAGES mbarriers and the slack that aligns the ring
  static constexpr int BYTES = AREA + 8 * STAGES + 1024;
  static_assert(STAGES >= 3, "the ring needs three stages");
  static_assert(BYTES <= BUDGET, "shared memory plan");
};

// One block: rows [m0, m0 + 64 NWG) x columns [n0, n0 + TN) of out.
// Iteration t (K tile t, tap t / (C / 64)): every thread waits for tile t's
// bytes on its mbarrier (and, for CPASYNC, its own copies of the tile),
// meets the others at the block barrier (every warpgroup's products of tile
// t - 1 are done, so its stage may be refilled), the copies of tile t +
// STAGES - 1 start, then each warpgroup issues tile t's products and waits
// for them.  No branch surrounds a wgmma (ptxas C7514 otherwise).
template <int TN, int NWG, int PATH>
__global__ void __launch_bounds__(128 * NWG, (Plan<TN, NWG>::CTAS))
mix_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                 const __grid_constant__ CUtensorMap map_w0,
                 const __grid_constant__ CUtensorMap map_w1,
                 const __grid_constant__ CUtensorMap map_w2,
                 const bf16* __restrict__ y,
                 const bf16* __restrict__ bias, bf16* __restrict__ out,
                 int M, int F, int N, int C) {
  typedef Plan<TN, NWG> P;
  constexpr int BM = P::BM, NT = P::NT, STAGES = P::STAGES;
  constexpr int AHEAD = STAGES - 1;
  constexpr int CPT = BM * 8 / NT;  // CPASYNC: 16-byte chunks a thread
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles want 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023))
                                    & 1023);
  const uint32_t s0 = hop::smem_u32(smem);
  const uint32_t bar0 = s0 + P::AREA;  // STAGES mbarriers

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * BM;
  const int kpt = C / BK, nk = 3 * kpt;
  auto sa = [&](int t) { return s0 + (t % STAGES) * P::STAGE; };
  auto sw = [&](int t) { return sa(t) + P::A_BYTES; };
  auto bar = [&](int t) { return bar0 + (t % STAGES) * 8; };
  auto load = [&](int t) {  // thread 0: W, and A unless CPASYNC
    const int tap = t / kpt, k0 = (t % kpt) * BK;
    mbar_expect_tx(bar(t), PATH == A_CPASYNC ? P::W_BYTES : P::STAGE);
    const CUtensorMap* mw = tap == 0 ? &map_w0 : tap == 1 ? &map_w1
                                                          : &map_w2;
    tma_load(sw(t), mw, k0, n0, bar(t));
    if (PATH == A_FRAME)
      tma_load(sa(t), &map_a, k0, tap_row(m0, tap, F, N), bar(t));
  };
  // CPASYNC: chunk i = tid + j NT of a tile is row i / 8, column chunk i % 8,
  // stored at chunk (i % 8) ^ (row % 8) of its 128-byte row (the swizzle)
  int src[CPT][3];
  if (PATH == A_CPASYNC) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int m = m0 + ((tid + j * NT) >> 3);
#pragma unroll
      for (int tap = 0; tap < 3; ++tap)
        src[j][tap] = m < M ? tap_row(m, tap, F, N) : -1;
    }
  }
  auto copy_a = [&](int t) {  // CPASYNC, every thread
    const int tap = t / kpt, k0 = (t % kpt) * BK;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int i = tid + j * NT, r = i >> 3, c = i & 7;
      const int row = tap == 0 ? src[j][0] : tap == 1 ? src[j][1] : src[j][2];
      hop::cp_async16(sa(t) + r * 128 + ((c ^ (r & 7)) << 4),
                      y + (size_t)(row < 0 ? 0 : row) * C + k0 + c * 8,
                      row >= 0);
    }
  };

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    hop::fence_async_smem();
#pragma unroll 1
    for (int t = 0; t < AHEAD && t < nk; ++t) load(t);
  }
  if (PATH == A_CPASYNC) {
#pragma unroll 1
    for (int t = 0; t < AHEAD; ++t) {
      if (t < nk) copy_a(t);
      hop::cp_commit();
    }
  }
  __syncthreads();  // the mbarriers are initialised

  float acc[TN / 2];
#pragma unroll
  for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
  const uint32_t a_wg = wg * 64 * BK * 2;  // this warpgroup's rows

  for (int t = 0; t < nk; ++t) {
    mbar_wait(bar(t), (t / STAGES) & 1);
    if (PATH == A_CPASYNC) {
      hop::cp_wait<AHEAD - 1>();  // this thread's copies of tile t
      hop::fence_async_smem();
    }
    __syncthreads();  // tile t - 1's stage is free
    if (t + AHEAD < nk) {
      if (tid == 0) load(t + AHEAD);
      if (PATH == A_CPASYNC) copy_a(t + AHEAD);
    }
    if (PATH == A_CPASYNC) hop::cp_commit();
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<TN>::ss(acc, desc_sw128(sa(t) + a_wg + kk * 32),
                    desc_sw128(sw(t) + kk * 32), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
  }
  hop::fence_regs(acc);
  __syncthreads();  // every warpgroup is done with the ring

  // the fp32 accumulators staged per warpgroup: rows r0, r0 + 8 of its 64,
  // columns 8 j + 2 t4 + {0, 1} (the accumulator layout of wgmma.cuh)
  constexpr int LDS = P::LDS;
  float* st = reinterpret_cast<float*>(smem) + wg * 64 * LDS;
  const int r0 = warp * 16 + g;
#pragma unroll
  for (int j = 0; j < TN / 8; ++j) {
    const int col = 8 * j + 2 * t4;
    *reinterpret_cast<float2*>(st + r0 * LDS + col) =
        make_float2(acc[4 * j], acc[4 * j + 1]);
    *reinterpret_cast<float2*>(st + (r0 + 8) * LDS + col) =
        make_float2(acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncthreads();

  // 16-byte chunks of 8 columns, a row's chunks on neighbouring threads:
  // out = (y + acc) + bias in fp32, one cast (mix.cu's order and the
  // Pallas body's)
  constexpr int CPR = TN / 8;
  const int lt = tid & 127;
  for (int i = lt; i < 64 * CPR; i += 128) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int m = m0 + wg * 64 + r;
    if (m >= M) continue;
    const size_t o = (size_t)m * C + n0 + c;
    const float4 x0 = *reinterpret_cast<const float4*>(st + r * LDS + c);
    const float4 x1 = *reinterpret_cast<const float4*>(st + r * LDS + c + 4);
    const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
    uint4 yv = *reinterpret_cast<const uint4*>(y + o);
    const uint4 bv = *reinterpret_cast<const uint4*>(bias + n0 + c);
    bf16* e = reinterpret_cast<bf16*>(&yv);
    const bf16* be = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      e[q] = __float2bfloat16_rn(__bfloat162float(e[q]) + x[q] +
                                 __bfloat162float(be[q]));
    *reinterpret_cast<uint4*>(out + o) = yv;
  }
}

template <int TN, int NWG, int PATH>
int launch_bf16(const void* y, const void* const* w, const int* ld,
                const void* bias, void* out, int M, int F, int N, int C,
                cudaStream_t s) {
  typedef Plan<TN, NWG> P;
  CUtensorMap map_a = {}, map_w[3];
  if (PATH == A_FRAME && !tensor_map(&map_a, y, M, C, P::BM))
    return (int)cudaErrorInvalidValue;
  for (int i = 0; i < 3; ++i)
    if (!tensor_map_ld(&map_w[i], w[i], C, C, ld[i], TN))
      return (int)cudaErrorInvalidValue;
  auto kernel = mix_wgmma_kernel<TN, NWG, PATH>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(C / TN, (M + P::BM - 1) / P::BM);
  kernel<<<grid, P::NT, P::BYTES, s>>>(map_a, map_w[0], map_w[1], map_w[2],
                                       (const bf16*)y, (const bf16*)bias,
                                       (bf16*)out, M, F, N, C);
  return (int)cudaGetLastError();
}

// The plan the caller chose: column tile tn (160 or 64, dividing C), bm
// rows a block (128: two warpgroups, or 64) and the loader of A, which the
// shape must admit (FRAME: every bm-row tile in one frame).
int dispatch_bf16(int tn, int bm, int path, const void* y,
                  const void* const* w, const int* ld, const void* bias,
                  void* out, int M, int F, int N, int C, cudaStream_t s) {
  if (tn < 1 || bm < 1 || C % tn || (path == A_FRAME && N % bm))
    return (int)cudaErrorInvalidValue;
#define ASVA_CASE(T, W, PATH)                                              \
  if (tn == T && bm == 64 * W && path == PATH)                             \
    return launch_bf16<T, W, PATH>(y, w, ld, bias, out, M, F, N, C, s);
#define ASVA_PATHS(T, W) \
  ASVA_CASE(T, W, A_FRAME) ASVA_CASE(T, W, A_CPASYNC)
  ASVA_PATHS(160, 2) ASVA_PATHS(160, 1) ASVA_PATHS(64, 2) ASVA_PATHS(64, 1)
#undef ASVA_PATHS
#undef ASVA_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- fp32 ---

constexpr int BK32 = 16, LDS32 = BM + 4;

__global__ void __launch_bounds__(256)
mix_f32_kernel(const float* __restrict__ y, const float* __restrict__ w0,
               const float* __restrict__ w1, const float* __restrict__ w2,
               int ld0, int ld1, int ld2, const float* __restrict__ bias,
               float* __restrict__ out, int M, int F, int N, int C) {
  // transposed tiles: As[k][m], Bs[k][n]
  __shared__ __align__(16) float As[BK32][LDS32];
  __shared__ __align__(16) float Bs[BK32][LDS32];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;     // 4 cols x 4 rows each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  // a 64x16 tile is 256 float4 chunks: chunk tid -> row tid/4, col (tid%4)*4
  const int lr = tid >> 2, lc = (tid & 3) * 4;
  int src[3];
#pragma unroll
  for (int tap = 0; tap < 3; ++tap)
    src[tap] = m0 + lr < M ? tap_row(m0 + lr, tap, F, N) : -1;
  const int kt_per_tap = C / BK32, nk = 3 * kt_per_tap;
  float4 ra, rb;

  auto load = [&](int kt) {
    const int tap = kt / kt_per_tap, k0 = (kt % kt_per_tap) * BK32;
    const float* w = tap == 0 ? w0 : tap == 1 ? w1 : w2;
    const int ld = tap == 0 ? ld0 : tap == 1 ? ld1 : ld2;
    const int row = tap == 0 ? src[0] : tap == 1 ? src[1] : src[2];
    ra = row >= 0 ? *reinterpret_cast<const float4*>(
                        y + (size_t)row * C + k0 + lc)
                  : make_float4(0.f, 0.f, 0.f, 0.f);
    const int n = n0 + lr;
    rb = n < C ? *reinterpret_cast<const float4*>(
                     w + (size_t)n * ld + k0 + lc)
               : make_float4(0.f, 0.f, 0.f, 0.f);
  };
  auto store = [&]() {
    As[lc + 0][lr] = ra.x;
    As[lc + 1][lr] = ra.y;
    As[lc + 2][lr] = ra.z;
    As[lc + 3][lr] = ra.w;
    Bs[lc + 0][lr] = rb.x;
    Bs[lc + 1][lr] = rb.y;
    Bs[lc + 2][lr] = rb.z;
    Bs[lc + 3][lr] = rb.w;
  };

  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    store();
    __syncthreads();
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int k = 0; k < BK32; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[k][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
      const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int m = m0 + ty * 4 + i, n = n0 + tx * 4 + j;
      if (m < M && n < C) {
        const size_t at = (size_t)m * C + n;
        out[at] = y[at] + acc[i][j] + bias[n];
      }
    }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  y, out (B, F, N, C) contiguous; w0, w1,
// w2 the head / prev / curr matrices (C, C) in (out, in) layout with row
// strides ld0, ld1, ld2 (elements, multiples of 8; 16-byte aligned); bias
// (C).  C must be a multiple of 64 (bf16: the K tile and the narrowest
// column tile) or 16 (fp32).  bf16 launches the plan tn, bm, path (see
// dispatch_bf16; fp32 ignores them).  The Python wrapper checks shapes,
// dtypes and alignment.  Returns cudaGetLastError() after the launch.
extern "C" int asva_ff_mix(int dtype, int B, int F, int N, int C, int tn,
                           int bm, int path, const void* y, const void* w0,
                           const void* w1, const void* w2, int ld0, int ld1,
                           int ld2, const void* bias, void* out,
                           void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * F * N;
  if (B < 1 || F < 1 || N < 1 || C < 1 || ld0 < C || ld1 < C || ld2 < C)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (C % BK || ld0 % 8 || ld1 % 8 || ld2 % 8)
      return (int)cudaErrorInvalidValue;
    const void* w[3] = {w0, w1, w2};
    const int ld[3] = {ld0, ld1, ld2};
    return dispatch_bf16(tn, bm, path, y, w, ld, bias, out, M, F, N, C, s);
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  if (C % BK32) return (int)cudaErrorInvalidValue;
  const dim3 grid((C + BN - 1) / BN, (M + BM - 1) / BM);
  mix_f32_kernel<<<grid, 256, 0, s>>>(
      (const float*)y, (const float*)w0, (const float*)w1, (const float*)w2,
      ld0, ld1, ld2, (const float*)bias, (float*)out, M, F, N, C);
  return (int)cudaGetLastError();
}
