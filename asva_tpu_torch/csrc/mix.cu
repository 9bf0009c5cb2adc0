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
// in fp32, y and the bias are added in fp32, and the sum is cast once.
//
// bf16: mma.sync m16n8k16 (fp32 accumulate), 64x64 block tile, 4 warps of
// 32x32, the next K tile prefetched into registers.  fp32: a plain FMA path,
// 64x64 tile, 256 threads of 4x4.  The tile code is gemm.cu's with another
// loader and epilogue.
//
// What bounds it on the H100: 2*M*3C*C operations against (2*M*C + 3*C*C)
// elements moved is compute-bound from C = 320 up for bf16, so this simple
// design (no wgmma, no TMA, one smem stage) reaches a fraction of the bound;
// the three A reads of a row hit L2 (frame 0 and the previous frame were
// just read by neighbouring blocks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

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

constexpr int BK16 = 32, LDS16 = BK16 + 8;  // +8: conflict-free fragments

__global__ void __launch_bounds__(128)
mix_bf16_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w0,
                const bf16* __restrict__ w1, const bf16* __restrict__ w2,
                int ld0, int ld1, int ld2, const bf16* __restrict__ bias,
                bf16* __restrict__ out, int M, int F, int N, int C) {
  __shared__ __align__(16) bf16 As[BM][LDS16];
  __shared__ __align__(16) bf16 Bs[BN][LDS16];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // a 64x32 tile is 256 chunks of 8 bf16: chunk c -> row c/4, col (c%4)*8
  int src[2][3];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int m = m0 + ((tid + i * 128) >> 2);
#pragma unroll
    for (int tap = 0; tap < 3; ++tap)
      src[i][tap] = m < M ? tap_row(m, tap, F, N) : -1;
  }
  const int kt_per_tap = C / BK16, nk = 3 * kt_per_tap;
  uint4 ra[2], rb[2];

  auto load = [&](int kt) {
    const int tap = kt / kt_per_tap, k0 = (kt % kt_per_tap) * BK16;
    const bf16* w = tap == 0 ? w0 : tap == 1 ? w1 : w2;
    const int ld = tap == 0 ? ld0 : tap == 1 ? ld1 : ld2;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 128, r = c >> 2, col = (c & 3) * 8;
      const int row = tap == 0 ? src[i][0] : tap == 1 ? src[i][1] : src[i][2];
      ra[i] = row >= 0 ? *reinterpret_cast<const uint4*>(
                             y + (size_t)row * C + k0 + col)
                       : make_uint4(0, 0, 0, 0);
      const int n = n0 + r;
      rb[i] = n < C ? *reinterpret_cast<const uint4*>(
                          w + (size_t)n * ld + k0 + col)
                    : make_uint4(0, 0, 0, 0);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 128, r = c >> 2, col = (c & 3) * 8;
      *reinterpret_cast<uint4*>(&As[r][col]) = ra[i];
      *reinterpret_cast<uint4*>(&Bs[r][col]) = rb[i];
    }
  };

  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    store();
    __syncthreads();
    if (kt + 1 < nk) load(kt + 1);
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm + mt * 16 + g;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + t4 * 2]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + t4 * 2]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + t4 * 2 + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + t4 * 2 + 8]);
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int n = wn + nt * 8 + g;
        const uint32_t b0 =
            *reinterpret_cast<const uint32_t*>(&Bs[n][kk + t4 * 2]);
        const uint32_t b1 =
            *reinterpret_cast<const uint32_t*>(&Bs[n][kk + t4 * 2 + 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][nt], af[mt], b0, b1);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r0 = m0 + wm + mt * 16 + g;
      const int c0 = n0 + wn + nt * 8 + t4 * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = r0 + (e >> 1) * 8, n = c0 + (e & 1);
        if (m < M && n < C) {
          const size_t at = (size_t)m * C + n;
          out[at] = __float2bfloat16_rn(__bfloat162float(y[at]) +
                                        acc[mt][nt][e] +
                                        __bfloat162float(bias[n]));
        }
      }
    }
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
// strides ld0, ld1, ld2 (elements, multiples of 8); bias (C).  C must be a
// multiple of 32 (bf16) or 16 (fp32).  The Python wrapper checks shapes,
// dtypes and alignment.  Returns cudaGetLastError() after the launch.
extern "C" int asva_ff_mix(int dtype, int B, int F, int N, int C,
                           const void* y, const void* w0, const void* w1,
                           const void* w2, int ld0, int ld1, int ld2,
                           const void* bias, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int M = B * F * N;
  if (B < 1 || F < 1 || N < 1 || ld0 < C || ld1 < C || ld2 < C)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((C + BN - 1) / BN, (M + BM - 1) / BM);
  if (dtype == 1) {
    if (C % BK16) return (int)cudaErrorInvalidValue;
    mix_bf16_kernel<<<grid, 128, 0, s>>>(
        (const bf16*)y, (const bf16*)w0, (const bf16*)w1, (const bf16*)w2,
        ld0, ld1, ld2, (const bf16*)bias, (bf16*)out, M, F, N, C);
  } else if (dtype == 0) {
    if (C % BK32) return (int)cudaErrorInvalidValue;
    mix_f32_kernel<<<grid, 256, 0, s>>>(
        (const float*)y, (const float*)w0, (const float*)w1,
        (const float*)w2, ld0, ld1, ld2, (const float*)bias, (float*)out, M,
        F, N, C);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
