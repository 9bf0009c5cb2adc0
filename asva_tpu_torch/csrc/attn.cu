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
// The same kernels are also B6, the flat one-head-per-program attention of
// asva_tpu/ops/pallas_attn.py (_attn_kernel :25, called by _attention_flat
// :45; public vmem_attention / vmem_cross_attention): q (BH, Sq, D) against
// k/v (BH, Sk, D) is this layout with G = BH groups of H = 1 head, so
// `asva_flat_attn` launches the tile code above with those strides and no
// lse.  The Pallas body keeps the whole K/V of one head on chip; here Sk is
// streamed in 64-row tiles (K/V at Sk = 1024 x D = 160 beside a logits tile
// does not fit the 228 KB of an SM), so the order is again "round P, then
// normalise" where the Pallas body normalises first (pallas_attn.py:38).
// K/V are never padded: rows >= kv_len are neither read nor needed.
//
// bf16 (B4, K-attn, B6): two warpgroups a block, each owning 64 query rows
// of one head; both products on wgmma (m64n64k16 for S = Q K^T with Q and K
// in shared memory, m64nDPk16 for O += P V with P from the S accumulator
// registers and V read MN-major through its descriptor, so no operand is
// transposed by hand); K/V tiles stream through a 3-stage cp.async ring, so
// the next tile's copy overlaps this tile's products; S of the next tile is
// issued before P V of this one, so the softmax of one overlaps the other's
// product; the softmax runs in base 2 with scale * log2(e) folded into one
// FMA before each exp2, and only the last K/V tile is masked (to -inf: the
// same zero weight as -1e9).  lse is stored in natural log.  Shared-memory
// tiles use the unswizzled core-matrix layout of hopper.cuh: a head tile of
// 40 or 80 columns pads to 48 or 80 there with zero-filled copies, never
// reading the next head's columns.
// fp32: a plain FMA path, 32 query rows x 4 threads each (the check path).
//
// What bounds it on the H100: at d = 40 the contraction of Q K^T is 48
// deep, so each 64 x 64 tile costs 3 wgmma steps for S and 4 for P V
// against 4096 exp2 and the row max/sum shuffles: the kernel is bound by
// the softmax's issue slots and the copy latency, not the tensor cores.
// The design keeps the softmax to one FMA + exp2 per element, overlaps it
// with the products of the neighbouring tile inside each warpgroup and with
// other blocks' products (48 KB of shared memory a block at d = 40), and
// keeps copies in flight across each tile.  Two warpgroups share each K/V
// tile, halving its copies; one warpgroup a block (twice the blocks) and a
// warp-specialised form (a producer warp filling the ring) measured slower
// (PERF.md).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr float MASK = -1e9f;
constexpr float LN2 = 0.6931471805599453f;

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------- bf16 ---

// NWG warpgroups (128 threads each) per block own 64 query rows each of one
// head and share the K/V tiles.  Q is copied to shared memory once; K/V
// tiles of 64 rows stream through a STAGES-deep ring filled by cp.async.
// Per tile t, each warpgroup: S = Q K^T (wgmma, both operands from shared
// memory, K-major), the online softmax in base 2 on the accumulator
// registers, O += P V (wgmma, P from registers as the A fragment, V
// MN-major from shared memory).  The products of neighbouring tiles
// overlap the softmax: O is rescaled, S of tile t + 1 and P V of tile t are
// issued, and the softmax of tile t + 1 runs while P V of tile t is in
// flight.  In iteration t the ring holds tile t (V in use), tile t + 1 (K in
// use) and the copy of tile t + STAGES - 1, written into the stage of tile
// t - 1, which every warp has finished with by the barrier that opens the
// iteration.
constexpr int STAGES = 3;  // K/V tiles in the cp.async ring

template <int DP, int NWG>
__global__ void __launch_bounds__(128 * NWG)
attn_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                 const bf16* __restrict__ v, bf16* __restrict__ o,
                 float* __restrict__ lse, int M, int Sk, int kv_len, int H,
                 int D, float scale) {
  constexpr int TILE = 64 * DP * 2;  // bytes of one 64-row tile
  constexpr int NT = 128 * NWG;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sq = hop::smem_u32(smem);  // NWG query tiles, then the ring
  auto sk = [&](int t) { return sq + TILE * (NWG + 2 * (t % STAGES)); };
  auto sv = [&](int t) { return sq + TILE * (NWG + 1 + 2 * (t % STAGES)); };

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * 64 * NWG, h = blockIdx.y, grp = blockIdx.z;
  const int C = H * D;
  const bf16* qg = q + (size_t)grp * M * C + h * D;
  const bf16* kg = k + (size_t)grp * Sk * C + h * D;
  const bf16* vg = v + (size_t)grp * Sk * C + h * D;
  const int ntiles = (kv_len + 63) / 64;
  const uint32_t sqw = sq + wg * TILE;  // this warpgroup's query rows
  auto load_kv = [&](int t) {
    hop::load_tile_async<DP, NT>(sk(t), kg, t * 64, kv_len, C, D, tid);
    hop::load_tile_async<DP, NT>(sv(t), vg, t * 64, kv_len, C, D, tid);
  };

  hop::load_tile_async<DP, NT, 64 * NWG>(sq, qg, q0, M, C, D, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_kv(t);
    hop::cp_commit();
  }
  hop::cp_wait<STAGES - 2>();  // Q and tile 0 (this thread's copies)
  hop::fence_async_smem();
  __syncthreads();             // ... every thread's

  float s[32];
  auto qk = [&](int t) {  // issue S = Q K_t^T into s
    hop::wg_fence();
#pragma unroll
    for (int kc = 0; kc < DP / 16; ++kc)
      Wgmma<64>::ss(s, hop::desc_kmajor<DP>(sqw + kc * 256),
                    hop::desc_kmajor<DP>(sk(t) + kc * 256), kc > 0);
    hop::wg_commit();
  };
  // running max (base-2 units of the scaled logits), this thread's share of
  // the row sum and the factor that rescales O, for rows g and g + 8 of the
  // warp's 16
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, al0, al1;
  const float sl2e = scale * hop::LOG2E;
  auto softmax = [&](int t) {  // s (tile t) -> unnormalised P, in place
    if ((t + 1) * 64 > kv_len) {  // the last tile: columns >= kv_len
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (t * 64 + 8 * j + 2 * t4 + (e & 1) >= kv_len)
            s[4 * j + e] = -INFINITY;
    }
    float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
      x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
    }
    const float mn0 = fmaxf(m0, quad_max(x0) * sl2e);
    const float mn1 = fmaxf(m1, quad_max(x1) * sl2e);
    al0 = hop::ex2(m0 - mn0);
    al1 = hop::ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = hop::ex2(fmaf(s[4 * j], sl2e, -mn0));
      s[4 * j + 1] = hop::ex2(fmaf(s[4 * j + 1], sl2e, -mn0));
      s[4 * j + 2] = hop::ex2(fmaf(s[4 * j + 2], sl2e, -mn1));
      s[4 * j + 3] = hop::ex2(fmaf(s[4 * j + 3], sl2e, -mn1));
      ps0 += s[4 * j] + s[4 * j + 1];
      ps1 += s[4 * j + 2] + s[4 * j + 3];
    }
    l0 = l0 * al0 + ps0;
    l1 = l1 * al1 + ps1;
  };
  uint32_t pa[4][4];
  auto pack = [&]() {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pa[kk][i] = hop::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
  };

  float oacc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) oacc[i] = 0.f;
  auto rescale = [&]() {  // O *= exp2(m_old - m_new), row by row
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      oacc[4 * j] *= al0;
      oacc[4 * j + 1] *= al0;
      oacc[4 * j + 2] *= al1;
      oacc[4 * j + 3] *= al1;
    }
  };
  auto pv = [&](int t) {  // issue O += P V_t
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      Wgmma<DP>::rs(oacc, pa[kk],
                    hop::desc_mnmajor<DP>(sv(t) + kk * 2 * DP * 16), 1);
    hop::wg_commit();
  };

  qk(0);
  hop::wg_wait<0>();
  hop::fence_regs(s);
  softmax(0);
  pack();
  // The last tile is peeled off so that no branch surrounds a wgmma and O
  // is rescaled before the stage opens: ptxas then keeps S of tile t + 1
  // and P V of tile t in flight together (with a branch inside the loop it
  // serializes every wgmma, warning C7514).
  for (int t = 0; t + 1 < ntiles; ++t) {
    hop::cp_wait<STAGES - 3>();  // tile t + 1
    hop::fence_async_smem();
    __syncthreads();             // ... and every warp is done with t - 1
    if (t + STAGES - 1 < ntiles) load_kv(t + STAGES - 1);
    hop::cp_commit();
    rescale();
    hop::fence_regs(oacc);
    qk(t + 1);
    pv(t);
    hop::wg_wait<1>();           // S of tile t + 1; P V of tile t may run on
    hop::fence_regs(s);
    softmax(t + 1);
    hop::wg_wait<0>();
    hop::fence_regs(oacc);
    pack();
  }
  rescale();
  pv(ntiles - 1);
  hop::wg_wait<0>();
  hop::fence_regs(oacc);

  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  bf16* og = o + (size_t)grp * M * C + h * D;
  const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (col < D) {
      if (r0 < M)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r0 * C + col) =
            __floats2bfloat162_rn(oacc[4 * j] * inv0, oacc[4 * j + 1] * inv0);
      if (r1 < M)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r1 * C + col) =
            __floats2bfloat162_rn(oacc[4 * j + 2] * inv1,
                                  oacc[4 * j + 3] * inv1);
    }
  }
  if (lse != nullptr && t4 == 0) {  // natural log, as B5 reads it
    float* lg = lse + (size_t)grp * M * H + h;
    if (r0 < M) lg[(size_t)r0 * H] = m0 * LN2 + logf(l0);
    if (r1 < M) lg[(size_t)r1 * H] = m1 * LN2 + logf(l1);
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
  constexpr int NWG = 2;  // 128 query rows a block share each K/V tile
  const int smem = (NWG + 2 * STAGES) * 64 * DP * (int)sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(
      attn_bf16_kernel<DP, NWG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + 64 * NWG - 1) / (64 * NWG), H, G);
  attn_bf16_kernel<DP, NWG><<<grid, 128 * NWG, smem, s>>>(
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

// B6: q, o (BH, Sq, D); k, v (BH, Sk, D): one head per group.  Same argument
// rules as asva_mha_fwd.
extern "C" int asva_flat_attn(int dtype, int BH, int Sq, int Sk, int kv_len,
                              int D, float scale, const void* q,
                              const void* k, const void* v, void* o,
                              void* stream) {
  return asva_mha_fwd(dtype, BH, Sq, Sk, kv_len, 1, D, scale, q, k, v, o,
                      nullptr, stream);
}
