// K-attn: multi-head attention over K/V shared per token group, for sm_90a.
// Plain C interface, loaded with ctypes.
//
// Replaces the attention core of the Pallas TPU kernels in
// asva_tpu/ops/pallas_fused.py: _sublayer_attn (:242) inside _attn_kernel /
// _ln_attn_flat (B1 fused_ln_attn) and _attn3_kernel / _ln_attn3_flat (B2
// fused_ln_attn3).  gemm.cu supplies the LN + q projection before it and the
// output projection + residual after it.
//
// q, o: (G, M, H*D); k, v: (G, Sk, H*D), all contiguous; query group g
// attends K/V group g.  Head h occupies columns [h*D, (h+1)*D).  One block
// per (query tile, head, group); K/V are streamed in 64-row tiles with an
// online softmax in fp32, so Sk = 1024 (frame-0 K/V at the 32x32 level)
// never has to fit in shared memory.  The scale is 1/sqrt(D) of the logical
// head dim; key columns >= kv_len are masked to -1e9 (pallas :269) and
// rows past kv_len are never read.  Head dims 40/80/160 (SD1.5) are not
// powers of two: the bf16 path pads the head tile to a multiple of 16 with
// zeros for the QK^T contraction and never stores the padded columns.
// Each head's output is cast to the input dtype (pallas :279).
//
// The same kernels are B4, the flash forward of training (_mha_fwd_kernel,
// pallas_fused.py:649, called by _mha_fwd_flat :759): given a non-null `lse`
// they also write the per-head log-sum-exp lse[g, m, h] = running max +
// log(running sum) in fp32, which the backward (attn_bwd.cu) rebuilds the
// probabilities from.  With lse == nullptr (generation) nothing else changes:
// o is bit-identical either way.
//
// Numerics vs the Pallas body: it normalises P before PV (pallas :276); the
// online form multiplies by 1/l after PV.  In fp32 the two agree to rounding;
// in bf16, P is rounded before normalisation, so results differ at the bf16
// rounding level (tolerance stated in chip_smoke.py).
//
// bf16: mma.sync m16n8k16, 4 warps x 16 query rows; P goes from the QK^T
// accumulator registers straight into the A fragments of the PV product.
// fp32: a plain FMA path, 32 query rows x 4 threads each.
//
// What bounds it on the H100: at d = 40 the QK^T and PV products are short
// (K-dim 48 after padding), so the fp32 softmax (exp, max, rescale per key)
// costs as much as the MMA: the kernel is bound by the softmax, not the
// tensor cores.  This simple design does nothing about that yet (no exp2
// folding of the scale, no packed-head tiles, V fragments read with 16-bit
// shared loads instead of ldmatrix.trans).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr float MASK = -1e9f;

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

// ---------------------------------------------------------------- bf16 ---

constexpr int BQ16 = 64, BKV16 = 64;

// rows [row0, row0 + 64) x cols [0, DP) of a (rows, ld) head slice into
// dst[64][DP + 8]; rows >= nvalid and cols >= D are zero.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          int row0, int nvalid, int ld, int D) {
  constexpr int CPR = DP / 8, LD = DP + 8;
  for (int c = threadIdx.x; c < 64 * CPR; c += blockDim.x) {
    const int r = c / CPR, col = (c % CPR) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < nvalid && col < D)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = v;
  }
}

template <int DP>
__global__ void __launch_bounds__(128)
attn_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int M, int Sk, int kv_len, int H,
                 int D, float scale) {
  constexpr int LD = DP + 8, KC = DP / 16, DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + BQ16 * LD;
  bf16* Vs = Ks + BKV16 * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * BQ16, h = blockIdx.y, grp = blockIdx.z;
  const int C = H * D;
  const bf16* qg = q + (size_t)grp * M * C + h * D;
  const bf16* kg = k + (size_t)grp * Sk * C + h * D;
  const bf16* vg = v + (size_t)grp * Sk * C + h * D;

  load_tile<DP>(Qs, qg, q0, M, C, D);
  __syncthreads();
  uint32_t qf[KC][4];
  {
    const int r = warp * 16 + g;
#pragma unroll
    for (int kc = 0; kc < KC; ++kc) {
      const int c = kc * 16 + t4 * 2;
      qf[kc][0] = *reinterpret_cast<const uint32_t*>(&Qs[r * LD + c]);
      qf[kc][1] = *reinterpret_cast<const uint32_t*>(&Qs[(r + 8) * LD + c]);
      qf[kc][2] = *reinterpret_cast<const uint32_t*>(&Qs[r * LD + c + 8]);
      qf[kc][3] = *reinterpret_cast<const uint32_t*>(&Qs[(r + 8) * LD + c + 8]);
    }
  }

  float oacc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) oacc[dt][e] = 0.f;
  float mrow[2] = {-INFINITY, -INFINITY}, lrow[2] = {0.f, 0.f};

  const int ntiles = (kv_len + BKV16 - 1) / BKV16;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BKV16;
    __syncthreads();  // the previous tile's reads are done
    load_tile<DP>(Ks, kg, k0, kv_len, C, D);
    load_tile<DP>(Vs, vg, k0, kv_len, C, D);
    __syncthreads();

    float s[BKV16 / 8][4];
#pragma unroll
    for (int nt = 0; nt < BKV16 / 8; ++nt) {
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

    float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < BKV16 / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        const float val = col < kv_len ? s[nt][e] * scale : MASK;
        s[nt][e] = val;
        if (e < 2) tm0 = fmaxf(tm0, val);
        else tm1 = fmaxf(tm1, val);
      }
    const float mn0 = fmaxf(mrow[0], quad_max(tm0));
    const float mn1 = fmaxf(mrow[1], quad_max(tm1));
    const float al0 = expf(mrow[0] - mn0), al1 = expf(mrow[1] - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < BKV16 / 8; ++nt) {
      s[nt][0] = expf(s[nt][0] - mn0);
      s[nt][1] = expf(s[nt][1] - mn0);
      s[nt][2] = expf(s[nt][2] - mn1);
      s[nt][3] = expf(s[nt][3] - mn1);
      ps0 += s[nt][0] + s[nt][1];
      ps1 += s[nt][2] + s[nt][3];
    }
    lrow[0] = lrow[0] * al0 + quad_sum(ps0);
    lrow[1] = lrow[1] * al1 + quad_sum(ps1);
    mrow[0] = mn0;
    mrow[1] = mn1;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      oacc[dt][0] *= al0;
      oacc[dt][1] *= al0;
      oacc[dt][2] *= al1;
      oacc[dt][3] *= al1;
    }

#pragma unroll
    for (int kk = 0; kk < BKV16 / 16; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const bf16* vr = Vs + (kk * 16 + t4 * 2) * LD + g;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        const bf16* vc = vr + dt * 8;
        const uint32_t b0 = pack_b(vc[0], vc[LD]);
        const uint32_t b1 = pack_b(vc[8 * LD], vc[9 * LD]);
        mma_bf16(oacc[dt], pa, b0, b1);
      }
    }
  }

  const float inv0 = 1.f / lrow[0], inv1 = 1.f / lrow[1];
  bf16* og = o + (size_t)grp * M * C + h * D;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (col < D) {
      if (r0 < M)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r0 * C + col) =
            __floats2bfloat162_rn(oacc[dt][0] * inv0, oacc[dt][1] * inv0);
      if (r1 < M)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r1 * C + col) =
            __floats2bfloat162_rn(oacc[dt][2] * inv1, oacc[dt][3] * inv1);
    }
  }
  if (lse != nullptr && t4 == 0) {
    float* lg = lse + (size_t)grp * M * H + h;
    if (r0 < M) lg[(size_t)r0 * H] = mrow[0] + logf(lrow[0]);
    if (r1 < M) lg[(size_t)r1 * H] = mrow[1] + logf(lrow[1]);
  }
}

// ---------------------------------------------------------------- fp32 ---

constexpr int BQ32 = 32, BKV32 = 32, DMAX = 160, OPT = DMAX / 4;

__global__ void __launch_bounds__(128)
attn_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                const float* __restrict__ v, float* __restrict__ o,
                float* __restrict__ lse, int M, int Sk, int kv_len, int H,
                int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);     // [BQ32][D]
  float* Ks = Qs + BQ32 * D;                      // [BKV32][D + 1]
  float* Vs = Ks + BKV32 * (D + 1);               // [BKV32][D]
  float* Ps = Vs + BKV32 * D;                     // [BQ32][BKV32 + 1]

  const int tid = threadIdx.x, r = tid >> 2, l4 = tid & 3;
  const int q0 = blockIdx.x * BQ32, h = blockIdx.y, grp = blockIdx.z;
  const int C = H * D;
  const float* qg = q + (size_t)grp * M * C + h * D;
  const float* kg = k + (size_t)grp * Sk * C + h * D;
  const float* vg = v + (size_t)grp * Sk * C + h * D;

  for (int i = tid; i < BQ32 * D; i += blockDim.x) {
    const int rr = i / D, c = i % D;
    Qs[i] = q0 + rr < M ? qg[(size_t)(q0 + rr) * C + c] : 0.f;
  }

  float oacc[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) oacc[i] = 0.f;
  float mrow = -INFINITY, lrow = 0.f;

  const int ntiles = (kv_len + BKV32 - 1) / BKV32;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BKV32;
    __syncthreads();
    for (int i = tid; i < BKV32 * D; i += blockDim.x) {
      const int j = i / D, c = i % D;
      const bool ok = k0 + j < kv_len;
      Ks[j * (D + 1) + c] = ok ? kg[(size_t)(k0 + j) * C + c] : 0.f;
      Vs[j * D + c] = ok ? vg[(size_t)(k0 + j) * C + c] : 0.f;
    }
    __syncthreads();

    float s[BKV32 / 4];
    float tmax = -INFINITY;
#pragma unroll
    for (int i = 0; i < BKV32 / 4; ++i) {
      const int j = l4 + 4 * i;
      float acc = 0.f;
      for (int d = 0; d < D; ++d) acc = fmaf(Qs[r * D + d], Ks[j * (D + 1) + d], acc);
      s[i] = k0 + j < kv_len ? acc * scale : MASK;
      tmax = fmaxf(tmax, s[i]);
    }
    const float mn = fmaxf(mrow, quad_max(tmax));
    const float al = expf(mrow - mn);
    float ps = 0.f;
#pragma unroll
    for (int i = 0; i < BKV32 / 4; ++i) {
      const float p = expf(s[i] - mn);
      ps += p;
      Ps[r * (BKV32 + 1) + l4 + 4 * i] = p;
    }
    lrow = lrow * al + quad_sum(ps);
    mrow = mn;
    __syncwarp();
#pragma unroll
    for (int i = 0; i < OPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) {
        float acc = oacc[i] * al;
        for (int j = 0; j < BKV32; ++j)
          acc = fmaf(Ps[r * (BKV32 + 1) + j], Vs[j * D + d], acc);
        oacc[i] = acc;
      }
    }
  }

  const float inv = 1.f / lrow;
  if (q0 + r < M) {
    float* og = o + (size_t)grp * M * C + (size_t)(q0 + r) * C + h * D;
#pragma unroll
    for (int i = 0; i < OPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) og[d] = oacc[i] * inv;
    }
    if (lse != nullptr && l4 == 0)
      lse[((size_t)grp * M + q0 + r) * H + h] = mrow + logf(lrow);
  }
}

template <int DP>
int launch_bf16(int G, int M, int Sk, int kv_len, int H, int D, float scale,
                const void* q, const void* k, const void* v, void* o,
                float* lse, cudaStream_t s) {
  const int smem = 3 * 64 * (DP + 8) * (int)sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      attn_bf16_kernel<DP>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BQ16 - 1) / BQ16, H, G);
  attn_bf16_kernel<DP><<<grid, 128, smem, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, M, Sk,
      kv_len, H, D, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  D must be a multiple of 8 and at most
// 160; 1 <= kv_len <= Sk.  lse is (G, M, H) fp32, or null (generation: o
// only).  The Python wrapper
// checks shapes, dtypes and contiguity.  Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int asva_mha_fwd(int dtype, int G, int M, int Sk, int kv_len,
                            int H, int D, float scale, const void* q,
                            const void* k, const void* v, void* o, void* lse,
                            void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (D % 8 || D > DMAX || kv_len < 1 || kv_len > Sk)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
#define ASVA_CASE(DP) \
  case DP:            \
    return launch_bf16<DP>(G, M, Sk, kv_len, H, D, scale, q, k, v, o, l, s);
    switch ((D + 15) / 16 * 16) {
      ASVA_CASE(16) ASVA_CASE(32) ASVA_CASE(48) ASVA_CASE(64) ASVA_CASE(80)
      ASVA_CASE(96) ASVA_CASE(112) ASVA_CASE(128) ASVA_CASE(144) ASVA_CASE(160)
      default: return (int)cudaErrorInvalidValue;
    }
#undef ASVA_CASE
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int smem = (BQ32 * D + BKV32 * (D + 1) + BKV32 * D +
                    BQ32 * (BKV32 + 1)) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      attn_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BQ32 - 1) / BQ32, H, G);
  attn_f32_kernel<<<grid, 128, smem, s>>>((const float*)q, (const float*)k,
                                          (const float*)v, (float*)o, l, M,
                                          Sk, kv_len, H, D, scale);
  return (int)cudaGetLastError();
}
