// T2f: the flash forward with the heads taken `group` at a time, for sm_90a.
// Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel _fwd_kernel (tools/mha_phase_bench.py:42),
// called by fwd_flat (:79): B4's function (attn.cu) on another schedule.
// There one program holds a query tile and loops over the heads, `group`
// heads' logits computed before any softmax.  Here one block owns 64 query
// rows per warpgroup and `group` adjacent heads, on B4's wgmma tile code
// (hopper.cuh, wgmma.cuh): Q of every head once, then K/V tiles of 64 rows
// through a cp.async ring whose stage holds the K and V tiles of all
// `group` heads (one span of group * D columns of each row).
//
//   group 1:  B4's own schedule (attn.cu): S of tile t + 1 is issued before
//             P V of tile t, so one softmax overlaps the other's product;
//   group > 1: per K/V tile each warpgroup first issues the Q K^T wgmma of
//             all its heads, then runs softmax + P V head by head, each
//             head's P V in flight while the next head's softmax runs: the
//             group is the lookahead, and a head's logits are not carried
//             into the next tile (that would cost 32 more registers a head).
//
// Per head the statements are B4's, in B4's order (base-2 softmax of one
// FMA + exp2, only the last K/V tile masked, O rescaled before each P V, the
// products summed in the same k order), so o and lse are bit-equal to B4's
// for every group, the gate of the JAX tool (tools/mha_phase_bench.py:247).
//
// Layout as attn.cu: q, o (G, M, H*D); k, v (G, Sk, H*D); lse (G, M, H) fp32;
// key columns >= kv_len masked, rows past kv_len never read.  When `group`
// does not divide H the last block repeats head H - 1 in its spare slots
// and stores nothing for them (no branch surrounds a wgmma).
//
// What bounds it on the H100: as B4, the softmax's issue slots and the copy
// latency, not the tensor cores (at d = 40 a 64 x 64 tile is 3 + 4 wgmma
// steps against 4096 exp2).  A group keeps more products in flight per
// warpgroup at the price of registers (a head costs a thread 32 words of
// logits, 16 of packed P and DP / 2 of output), and of shared memory: the
// ring holds group x (K + V) tiles a stage, so the stage count (3 or 2) and
// the warpgroups a block (2, or 1 at head tile 160 in group 2) are chosen at
// compile time to fit the 227 KB a block may have.  The instantiations stop
// at group * (32 + DP / 2) <= 256, the rule the Python wrapper states.
// fp32: B4's FMA path (attn.cu), a block walking its `group` heads one after
// the other through the same statements, so fp32 o and lse are B4's bits
// too.

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
constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

// ---------------------------------------------------------------- bf16 ---

// Shared memory of a block: NWG query tiles per head, then STAGES ring
// stages of GROUP K tiles and GROUP V tiles.  Three stages and two
// warpgroups as B4 where they fit; else fewer stages, then one warpgroup.
template <int DP, int GROUP>
struct Plan {
  static constexpr int TILE = 64 * DP * 2;  // bytes of one 64-row tile
  static constexpr int bytes(int nwg, int stages) {
    return (nwg + 2 * stages) * GROUP * TILE;
  }
  static constexpr bool fits(int nwg, int stages) {
    return bytes(nwg, stages) <= SMEM_LIMIT;
  }
  static constexpr int NWG = fits(2, 3) || fits(2, 2) ? 2 : 1;
  static constexpr int STAGES = fits(NWG, 3) ? 3 : 2;
  static constexpr int SMEM = bytes(NWG, STAGES);
};

// One head's running state in a warpgroup (B4's): the running max in
// base-2 units of the scaled logits, this thread's share of the row sum and
// the factor that rescales O, for rows g and g + 8 of the warp's 16.
struct RowState {
  float m0, m1, l0, l1, al0, al1;
};

// issue S = Q K_t^T into s (no fence, no commit)
template <int DP>
__device__ __forceinline__ void qk(float (&s)[32], uint32_t sqw,
                                   uint32_t skt) {
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
    Wgmma<64>::ss(s, hop::desc_kmajor<DP>(sqw + kc * 256),
                  hop::desc_kmajor<DP>(skt + kc * 256), kc > 0);
}

// s (tile t) -> unnormalised P in place, B4's online softmax in base 2
__device__ __forceinline__ void softmax(float (&s)[32], RowState& r, int t,
                                        int kv_len, int t4, float sl2e) {
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
  const float mn0 = fmaxf(r.m0, quad_max(x0) * sl2e);
  const float mn1 = fmaxf(r.m1, quad_max(x1) * sl2e);
  r.al0 = hop::ex2(r.m0 - mn0);
  r.al1 = hop::ex2(r.m1 - mn1);
  r.m0 = mn0;
  r.m1 = mn1;
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
  r.l0 = fmaf(r.l0, r.al0, ps0);  // B4's contracted l * al + ps
  r.l1 = fmaf(r.l1, r.al1, ps1);
}

__device__ __forceinline__ void pack(uint32_t (&pa)[4][4],
                                     const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = hop::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// O *= exp2(m_old - m_new), row by row
template <int DP>
__device__ __forceinline__ void rescale(float (&o)[DP / 2],
                                        const RowState& r) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    o[4 * j] *= r.al0;
    o[4 * j + 1] *= r.al0;
    o[4 * j + 2] *= r.al1;
    o[4 * j + 3] *= r.al1;
  }
}

// issue O += P V_t (fence and commit included)
template <int DP>
__device__ __forceinline__ void pv(float (&o)[DP / 2],
                                   const uint32_t (&pa)[4][4], uint32_t svt) {
  hop::wg_fence();
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<DP>::rs(o, pa[kk], hop::desc_mnmajor<DP>(svt + kk * 2 * DP * 16),
                  1);
  hop::wg_commit();
}

template <int DP, int GROUP>
__global__ void __launch_bounds__(128 * Plan<DP, GROUP>::NWG)
grouped_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int M, int Sk, int kv_len, int H,
                    int D, float scale) {
  using P = Plan<DP, GROUP>;
  constexpr int NWG = P::NWG, STAGES = P::STAGES, TILE = P::TILE;
  constexpr int NT = 128 * NWG;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = hop::smem_u32(smem);
  const uint32_t ring = base + NWG * GROUP * TILE;
  // K tile of head slot hh in the stage of tile t; its V tile GROUP on
  auto sk = [&](int t, int hh) {
    return ring + (t % STAGES) * 2 * GROUP * TILE + hh * TILE;
  };
  auto sv = [&](int t, int hh) { return sk(t, hh) + GROUP * TILE; };

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * 64 * NWG, h0 = blockIdx.y * GROUP;
  const int grp = blockIdx.z;
  const int C = H * D;
  // head slot hh computes head min(h0 + hh, H - 1); only real heads store
  auto head = [&](int hh) { return min(h0 + hh, H - 1); };
  const bf16* qg = q + (size_t)grp * M * C;
  const bf16* kg = k + (size_t)grp * Sk * C;
  const bf16* vg = v + (size_t)grp * Sk * C;
  const int ntiles = (kv_len + 63) / 64;
  auto sqw = [&](int hh) { return base + (hh * NWG + wg) * TILE; };
  auto load_kv = [&](int t) {  // the group's span of K, then of V
#pragma unroll
    for (int hh = 0; hh < GROUP; ++hh)
      hop::load_tile_async<DP, NT>(sk(t, hh), kg + head(hh) * D, t * 64,
                                   kv_len, C, D, tid);
#pragma unroll
    for (int hh = 0; hh < GROUP; ++hh)
      hop::load_tile_async<DP, NT>(sv(t, hh), vg + head(hh) * D, t * 64,
                                   kv_len, C, D, tid);
  };

#pragma unroll
  for (int hh = 0; hh < GROUP; ++hh)
    hop::load_tile_async<DP, NT, 64 * NWG>(base + hh * NWG * TILE,
                                           qg + head(hh) * D, q0, M, C, D,
                                           tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_kv(t);
    hop::cp_commit();
  }
  hop::cp_wait<STAGES - 2>();  // Q and tile 0 (this thread's copies)
  hop::fence_async_smem();
  __syncthreads();             // ... every thread's

  const float sl2e = scale * hop::LOG2E;
  float s[GROUP][32];
  float oacc[GROUP][DP / 2];
  uint32_t pa[GROUP][4][4];
  RowState rs[GROUP];
#pragma unroll
  for (int hh = 0; hh < GROUP; ++hh) {
    rs[hh] = RowState{-INFINITY, -INFINITY, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) oacc[hh][i] = 0.f;
  }

  if constexpr (GROUP == 1) {
    static_assert(STAGES == 3 && NWG == 2, "group 1 is B4's block");
    // B4's loop (attn.cu), the last tile peeled off so that no branch
    // surrounds a wgmma: S of tile t + 1 and P V of tile t in flight
    // together, the softmax of t + 1 under P V of t
    hop::wg_fence();
    qk<DP>(s[0], sqw(0), sk(0, 0));
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(s[0]);
    softmax(s[0], rs[0], 0, kv_len, t4, sl2e);
    pack(pa[0], s[0]);
    for (int t = 0; t + 1 < ntiles; ++t) {
      hop::cp_wait<STAGES - 3>();  // tile t + 1
      hop::fence_async_smem();
      __syncthreads();  // ... and every warp is done with t - 1
      if (t + STAGES - 1 < ntiles) load_kv(t + STAGES - 1);
      hop::cp_commit();
      rescale<DP>(oacc[0], rs[0]);
      hop::fence_regs(oacc[0]);
      hop::wg_fence();
      qk<DP>(s[0], sqw(0), sk(t + 1, 0));
      hop::wg_commit();
      pv<DP>(oacc[0], pa[0], sv(t, 0));
      hop::wg_wait<1>();  // S of tile t + 1; P V of tile t may run on
      hop::fence_regs(s[0]);
      softmax(s[0], rs[0], t + 1, kv_len, t4, sl2e);
      hop::wg_wait<0>();
      hop::fence_regs(oacc[0]);
      pack(pa[0], s[0]);
    }
    rescale<DP>(oacc[0], rs[0]);
    pv<DP>(oacc[0], pa[0], sv(ntiles - 1, 0));
    hop::wg_wait<0>();
    hop::fence_regs(oacc[0]);
  } else {
    for (int t = 0; t < ntiles; ++t) {
      if (t > 0) {
        hop::cp_wait<STAGES - 2>();  // tile t
        hop::fence_async_smem();
        __syncthreads();             // ... and every warp is done with t - 1
      }
      if (t + STAGES - 1 < ntiles) load_kv(t + STAGES - 1);
      hop::cp_commit();
      hop::wg_fence();               // every head's S first ...
#pragma unroll
      for (int hh = 0; hh < GROUP; ++hh) qk<DP>(s[hh], sqw(hh), sk(t, hh));
      hop::wg_commit();
      hop::wg_wait<0>();
#pragma unroll
      for (int hh = 0; hh < GROUP; ++hh) hop::fence_regs(s[hh]);
#pragma unroll
      for (int hh = 0; hh < GROUP; ++hh) {  // ... then B4's statements
        softmax(s[hh], rs[hh], t, kv_len, t4, sl2e);
        pack(pa[hh], s[hh]);
        rescale<DP>(oacc[hh], rs[hh]);
        hop::fence_regs(oacc[hh]);
        pv<DP>(oacc[hh], pa[hh], sv(t, hh));
      }
      hop::wg_wait<0>();
#pragma unroll
      for (int hh = 0; hh < GROUP; ++hh) hop::fence_regs(oacc[hh]);
    }
  }

  const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int hh = 0; hh < GROUP; ++hh) {
    if (h0 + hh >= H) continue;
    const int h = h0 + hh;
    const float l0 = quad_sum(rs[hh].l0), l1 = quad_sum(rs[hh].l1);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    bf16* og = o + (size_t)grp * M * C + h * D;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = j * 8 + t4 * 2;
      if (col < D) {
        if (r0 < M)
          *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r0 * C + col) =
              __floats2bfloat162_rn(oacc[hh][4 * j] * inv0,
                                    oacc[hh][4 * j + 1] * inv0);
        if (r1 < M)
          *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r1 * C + col) =
              __floats2bfloat162_rn(oacc[hh][4 * j + 2] * inv1,
                                    oacc[hh][4 * j + 3] * inv1);
      }
    }
    if (t4 == 0) {  // natural log, as B4 stores it (nvcc contracts B4's
      // m * LN2 + log(l) into one FMA; spelled out here, where a hoisted
      // product would otherwise round apart from it)
      float* lg = lse + (size_t)grp * M * H + h;
      if (r0 < M) lg[(size_t)r0 * H] = fmaf(rs[hh].m0, LN2, logf(l0));
      if (r1 < M) lg[(size_t)r1 * H] = fmaf(rs[hh].m1, LN2, logf(l1));
    }
  }
}

// ---------------------------------------------------------------- fp32 ---

constexpr int BQ32 = 32, BKV32 = 32, DMAX = 160, OPT = DMAX / 4;

__global__ void __launch_bounds__(128)
grouped_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, float* __restrict__ o,
                   float* __restrict__ lse, int M, int Sk, int kv_len, int H,
                   int D, float scale, int group) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);     // [BQ32][D]
  float* Ks = Qs + BQ32 * D;                      // [BKV32][D + 1]
  float* Vs = Ks + BKV32 * (D + 1);               // [BKV32][D]
  float* Ps = Vs + BKV32 * D;                     // [BQ32][BKV32 + 1]

  const int tid = threadIdx.x, r = tid >> 2, l4 = tid & 3;
  const int q0 = blockIdx.x * BQ32, grp = blockIdx.z;
  const int C = H * D;
  for (int h = blockIdx.y * group; h < min((int)(blockIdx.y + 1) * group, H);
       ++h) {
    const float* qg = q + (size_t)grp * M * C + h * D;
    const float* kg = k + (size_t)grp * Sk * C + h * D;
    const float* vg = v + (size_t)grp * Sk * C + h * D;

    __syncthreads();  // the previous head's reads are done
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
        for (int d = 0; d < D; ++d)
          acc = fmaf(Qs[r * D + d], Ks[j * (D + 1) + d], acc);
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
      if (l4 == 0)
        lse[((size_t)grp * M + q0 + r) * H + h] = mrow + logf(lrow);
    }
  }
}


template <int DP, int GROUP>
int launch_bf16(int G, int M, int Sk, int kv_len, int H, int D, float scale,
                const void* q, const void* k, const void* v, void* o,
                float* lse, cudaStream_t s) {
  using P = Plan<DP, GROUP>;
  static_assert(P::SMEM <= SMEM_LIMIT, "no plan fits shared memory");
  cudaError_t e = cudaFuncSetAttribute(
      grouped_bf16_kernel<DP, GROUP>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, P::SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + 64 * P::NWG - 1) / (64 * P::NWG),
                  (H + GROUP - 1) / GROUP, G);
  grouped_bf16_kernel<DP, GROUP><<<grid, 128 * P::NWG, P::SMEM, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, M, Sk,
      kv_len, H, D, scale);
  return (int)cudaGetLastError();
}

template <int DP>
int dispatch_group(int group, int G, int M, int Sk, int kv_len, int H, int D,
                   float scale, const void* q, const void* k, const void* v,
                   void* o, float* lse, cudaStream_t s) {
#define ASVA_GROUP(GR)                                                      \
  if constexpr (GR * (32 + DP / 2) <= 256) {                                \
    if (group == GR)                                                        \
      return launch_bf16<DP, GR>(G, M, Sk, kv_len, H, D, scale, q, k, v, o, \
                                 lse, s);                                   \
  }
  ASVA_GROUP(1) ASVA_GROUP(2) ASVA_GROUP(4)
#undef ASVA_GROUP
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Head dims: multiples of 8 whose width
// padded to 16 is 32, 48, 64, 80 or 160; group 1, 2 or 4 with
// group * (32 + padded / 2) <= 256 (the Python wrapper states the same rule
// and raises before calling); 1 <= kv_len <= Sk; lse (G, M, H) fp32, not
// null.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int asva_mha_fwd_grouped(int dtype, int group, int G, int M,
                                    int Sk, int kv_len, int H, int D,
                                    float scale, const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  float* l = (float*)lse;
  if (D % 8 || D > DMAX || kv_len < 1 || kv_len > Sk || l == nullptr ||
      group < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
#define ASVA_CASE(DP)                                                      \
  case DP:                                                                 \
    return dispatch_group<DP>(group, G, M, Sk, kv_len, H, D, scale, q, k, \
                              v, o, l, s);
    switch ((D + 15) / 16 * 16) {
      ASVA_CASE(32) ASVA_CASE(48) ASVA_CASE(64) ASVA_CASE(80) ASVA_CASE(160)
      default: return (int)cudaErrorInvalidValue;
    }
#undef ASVA_CASE
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int smem = (BQ32 * D + BKV32 * (D + 1) + BKV32 * D +
                    BQ32 * (BKV32 + 1)) * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      grouped_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + BQ32 - 1) / BQ32, (H + group - 1) / group, G);
  grouped_f32_kernel<<<grid, 128, smem, s>>>((const float*)q, (const float*)k,
                                             (const float*)v, (float*)o, l, M,
                                             Sk, kv_len, H, D, scale, group);
  return (int)cudaGetLastError();
}
