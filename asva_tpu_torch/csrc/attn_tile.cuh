// Tile code of T1 (attn_variants.cu), the one kernel-tool source still on
// mma.sync: the bf16 m16n8k16 fragments, the 64-row head-tile loader and
// the quad reductions, in the order of the mma.sync forms of attn.cu /
// attn_bwd.cu that preceded their wgmma forms.  T2f (attn_grouped.cu) and
// T2b (attn_bwd_fused.cu) moved to B4's and B5's wgmma tile code
// (hopper.cuh, wgmma.cuh).
//
// Layout conventions: a warp owns 16 rows; lane = 4 * g + t4; an mma
// accumulator c[4] holds rows g (c[0], c[1]) and g + 8 (c[2], c[3]) at
// columns 2 * t4 and 2 * t4 + 1 of its 8-wide tile.
#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace asva {

typedef __nv_bfloat16 bf16;

constexpr float MASK = -1e9f;
constexpr int TILE = 64;  // rows of every bf16 tile (query and K/V)

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_f(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ uint32_t pack_b(bf16 lo, bf16 hi) {
  __nv_bfloat162 p;
  p.x = lo;
  p.y = hi;
  return *reinterpret_cast<uint32_t*>(&p);
}

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// rows [row0, row0 + 64) x cols [0, DP) of a (rows, ld) head slice into
// dst[64][DP + 8]; rows >= nvalid and cols >= D are zero.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          int row0, int nvalid, int ld, int D) {
  constexpr int CPR = DP / 8, LD = DP + 8;
  for (int c = threadIdx.x; c < TILE * CPR; c += blockDim.x) {
    const int r = c / CPR, col = (c % CPR) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < nvalid && col < D)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = v;
  }
}

// The A fragments of this warp's 16 rows x DP columns starting at `a`
// (row stride lda), for a product contracted over those columns.
template <int DP>
__device__ __forceinline__ void load_afrag(uint32_t (&f)[DP / 16][4],
                                           const bf16* a, int lda, int g,
                                           int t4) {
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc) {
    const bf16* ar = a + g * lda + kc * 16 + t4 * 2;
    f[kc][0] = *reinterpret_cast<const uint32_t*>(ar);
    f[kc][1] = *reinterpret_cast<const uint32_t*>(ar + 8 * lda);
    f[kc][2] = *reinterpret_cast<const uint32_t*>(ar + 8);
    f[kc][3] = *reinterpret_cast<const uint32_t*>(ar + 8 * lda + 8);
  }
}

// s (16 x 64) = A (fragments) B[64 x DP]^T, B in shared memory with row
// stride DP + 8.  The loop order (key tile outside, contraction inside) is
// attn.cu's.
template <int DP>
__device__ __forceinline__ void qk_tile(float (&s)[8][4],
                                        const uint32_t (&qf)[DP / 16][4],
                                        const bf16* Ks, int g, int t4) {
  constexpr int LD = DP + 8, KC = DP / 16;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
    const bf16* kr = Ks + (nt * 8 + g) * LD + t4 * 2;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const uint32_t b0 = *reinterpret_cast<const uint32_t*>(kr + kc * 16);
      const uint32_t b1 = *reinterpret_cast<const uint32_t*>(kr + kc * 16 + 8);
      mma_bf16(s[nt], qf[kc], b0, b1);
    }
  }
}

// acc (16 x 8 NT) += round_bf16(p)[16 x 64] B[64 x 8 NT]; p is a product's
// accumulator, b points at B's first column (row stride LD).
template <int LD, int NT>
__device__ __forceinline__ void mma_pb(float (&acc)[NT][4],
                                       const float (&p)[8][4], const bf16* b,
                                       int g, int t4) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = pack_f(p[2 * kk][0], p[2 * kk][1]);
    pa[1] = pack_f(p[2 * kk][2], p[2 * kk][3]);
    pa[2] = pack_f(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    pa[3] = pack_f(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const bf16* br = b + (kk * 16 + t4 * 2) * LD + g;
#pragma unroll
    for (int dt = 0; dt < NT; ++dt) {
      const bf16* bc = br + dt * 8;
      mma_bf16(acc[dt], pa, pack_b(bc[0], bc[LD]),
               pack_b(bc[8 * LD], bc[9 * LD]));
    }
  }
}

template <typename K>
inline int set_smem(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace asva
