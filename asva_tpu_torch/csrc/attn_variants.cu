// T1: the LN + q-projection + attention + out-projection + residual
// sub-layer as ONE launch, in ten variants of softmax arithmetic and
// schedule, for sm_90a.  Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels _k_v0 ... _k_v9 (tools/attn_experiments.py
// :58-294), called by run_variant (:304): B1's function (gemm.cu + attn.cu,
// three launches with q and o through device memory) held in one program from
// the LayerNorm to the residual.  One block owns `block_m` query rows of one
// token group and walks them BM = 64 NWG at a time (NWG = 2 warpgroups when
// block_m is a multiple of 128, else 1); q and o never leave shared memory.
// The stages, on the tile code of K-gemm (gemm.cu, tma.cuh) and B4 (attn.cu,
// hopper.cuh, wgmma.cuh):
//   A. LayerNorm with K-gemm's statistics (fp32 mean and two-pass variance,
//      8 lanes a row, the same reduction order) and K-gemm's normalisation,
//      rounded into an xn tile (unswizzled core-matrix layout);
//   B. q = xn Wq^T: Wgmma<TN>::ss over 64-deep K tiles of Wq that arrive by
//      TMA (128-byte swizzled) through an mbarrier ring, TN = 160 where it
//      divides C, else 64 (K-gemm's tile for the same N), rounded into the
//      q/o tile;
//   C. per head (or pair of heads) the attention on B4's tile code: 64-row
//      K/V tiles through a 3-stage cp.async ring (in the space of the xn
//      tile), zero-filled to the padded head width DP, S = Q K^T by
//      Wgmma<64>::ss, P V by Wgmma<DP>::rs; each head's rounded output
//      overwrites its q columns;
//   D. out = x + (o Wo^T + bo): Wgmma<TN>::ss of o with Wo from the same TMA
//      ring (its first tiles land during stage C), K-gemm's epilogue 2 in
//      fp32 and one cast, staged through shared memory into 16-byte stores.
// A, B and D are K-gemm's arithmetic on the same values and the POST class
// runs B4's statements, so v2_postnorm and v3_both are B1's bits.
//
// Stage C has six arithmetic classes (CLS) and three schedules (ORD):
//   PRE      p = exp(s - m) / l in fp32, rounded, then P V (v0, v1_phased,
//            v6_stacksm, v8_pipe).  With Sk streamed the row's m and l must be
//            known before the first P V: a first sweep over K computes them
//            (online), a second recomputes s.  That second Q K^T is the cost
//            of "divide, then round" on this card.
//   POST     B4's online softmax in base 2 (scale * log2(e) folded into one
//            FMA before each exp2), exp2 rounded, P V in fp32, divided by the
//            fp32 sum of the unrounded p at the end (v2_postnorm, v3_both).
//   POSTR    as POST, but l is the sum of the ROUNDED p, taken by the tensor
//            cores: V's padding column DP - 8 (>= D) holds ones, so that
//            column of P V is the sum (v9_mxusum; the head tile pads D + 1).
//   EXP2     as PRE with scale * log2(e) folded into the logits and exp2
//            (v7_exp2).
//   BF16EXP  exp of (s - m) rounded to bf16, its result rounded to bf16, l
//            their fp32 sum, divided at the end; m is the row's true maximum
//            from a first sweep, as the rounding of s - m depends on it
//            (v5_bf16exp).
//   FLOOR    no softmax: the scaled logits, rounded, times V (v4_mmfloor).
//   SEQ      heads one after the other, each tile's S, then its softmax and
//            P V;
//   PHASED   two heads a sweep, both Q K^T products of a K/V tile issued
//            before either softmax;
//   PIPE     one head, B4's lookahead: S of tile t + 1 issued before P V of
//            tile t, so the softmax of one overlaps the other's product.
// Within a class the orders run the same statements per head and row (the
// products in the same k order, the softmax written with explicit fmaf /
// __fmul_rn so that no order contracts differently), so the orders of a
// class are bit-equal.  v1_phased and v6_stacksm are the same instantiation:
// a softmax stacked over the heads' tiles is row-wise the same arithmetic and
// has no counterpart in registers.
//
// Widths: C a multiple of 64 up to 320; head dims 24, 32, 40 or 48 (padded
// to DP = 32 or 48, POSTR to 32, 48 or 64); block_m a multiple of 64.  A
// head tile reads up to 16 columns past its head (the next head's q, or the
// zero pad of the q/o tile): K's padding is zero, so they add exact zeros.
// fp32: a plain FMA path for the fp32 checks, 32 rows a step, every class in
// two sweeps.
//
// Shared memory of a block (C = 320, NWG = 2): the W ring 3 x 20 KB, the
// q/o tile 128 x 336 bf16 (84 KB), and one region (80 KB) that holds xn in
// stages A-B, the K/V ring in stage C (2 heads x 3 stages x 12 KB for
// PHASED) and the epilogue's fp32 staging (half a column panel) in stage D:
// 225 KB, one block an SM.  The plan picks NWG from block_m at launch; two
// warpgroups share each K/V and W tile.  At the tool's shape (G 2, M 12288,
// block_m 64) that is 384 one-warpgroup blocks for 132 SMs.
//
// What bounds it on the H100: the same as B1's three launches, the
// attention's softmax issue slots and copy latency (at d = 40 a 64 x 64
// tile is 3 + 4 wgmma steps against 4096 exp2), here with one block an SM
// and the stages of a block in sequence: the projections and the LayerNorm
// are not hidden under another block's attention.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "hopper.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum { CLS_PRE = 0, CLS_POST = 1, CLS_POSTR = 2, CLS_EXP2 = 3,
       CLS_BF16EXP = 4, CLS_FLOOR = 5 };
enum { ORD_SEQ = 0, ORD_PHASED = 1, ORD_PIPE = 2 };

constexpr float MASK = -1e9f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int SMEM_CTA = 232448;  // dynamic shared memory a block may have
constexpr int W_STAGES = 3;       // Wq / Wo tiles in the TMA ring
constexpr int KV_STAGES = 3;      // K/V tiles in the cp.async ring
constexpr int LN_CH = 5;          // 16-byte chunks of a row a lane, C <= 320

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float quad_max(float v) {
  v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 1));
  return fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 2));
}

__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v + __shfl_xor_sync(0xffffffffu, v, 2);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// K-gemm's LN reductions (gemm.cu sum8, sqdev8, group8_sum)
__device__ __forceinline__ float sum8(const uint4& v) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) s += to_f(e[j]);
  return s;
}

__device__ __forceinline__ float sqdev8(const uint4& v, float mean) {
  const bf16* e = reinterpret_cast<const bf16*>(&v);
  float s = 0.f;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float d = to_f(e[j]) - mean;
    s += d * d;
  }
  return s;
}

__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// byte offset of 16-byte chunk (r, c8) of a core-matrix tile whose rows
// hold `cols` bf16 (hopper.cuh's layout with DP = cols)
__device__ __forceinline__ uint32_t cm_off(int r, int c8, int cols) {
  return (r >> 3) * cols * 16 + c8 * 128 + (r & 7) * 16;
}

// Offsets (bytes from the 1024-aligned base) of the W ring, the q/o tile,
// the region shared by xn / the K/V ring / the epilogue staging, the
// mbarriers, and the dynamic shared memory to ask for (+ alignment slack).
struct Layout {
  int qo, u, bars, bytes;
};

__host__ __device__ inline Layout plan(int tn, int bm, int c, int dp,
                                       int hp) {
  const int ring = W_STAGES * tn * BK * 2;
  const int qo = bm * (c + 16) * 2;
  const int xn = bm * c * 2, kv = KV_STAGES * hp * 2 * 64 * dp * 2;
  const int staging = bm * (tn / 2 + 8) * 4;
  int u = xn > kv ? xn : kv;
  u = u > staging ? u : staging;
  return Layout{ring, ring + qo, ring + qo + u,
                ring + qo + u + 8 * W_STAGES + 1024};
}

// One head's running state in a warpgroup (B4's): the running max, this
// thread's share of the row sum and the factor that rescales O, for rows g
// and g + 8 of the warp's 16.
struct RowState {
  float m0, m1, l0, l1, al0, al1;
};

template <int CLS>
__device__ __forceinline__ float expo(float v) {
  return CLS == CLS_EXP2 ? exp2f(v) : expf(v);
}

// the columns >= Sk of the last K/V tile are set to `fill`
__device__ __forceinline__ void mask_tail(float (&s)[32], int t, int Sk,
                                          int t4, float fill) {
  if ((t + 1) * 64 > Sk) {
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (t * 64 + 8 * j + 2 * t4 + (e & 1) >= Sk) s[4 * j + e] = fill;
  }
}

// POST, POSTR: s (tile t) -> unnormalised P in place, B4's online softmax
// in base 2 (attn.cu; attn_grouped.cu's statements)
__device__ __forceinline__ void softmax_b4(float (&s)[32], RowState& r,
                                           int t, int Sk, int t4,
                                           float sl2e) {
  mask_tail(s, t, Sk, t4, -INFINITY);
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

// the scaled logits of tile t, the columns >= Sk at -inf
__device__ __forceinline__ void scaled(float (&s)[32], int t, int Sk, int t4,
                                       float sc) {
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = __fmul_rn(s[i], sc);
  mask_tail(s, t, Sk, t4, -INFINITY);
}

// The first sweep of PRE, EXP2 (the row's m and l, online) and BF16EXP (m)
template <int CLS>
__device__ __forceinline__ void stats_tile(float (&s)[32], RowState& r,
                                           int t, int Sk, int t4, float sc) {
  scaled(s, t, Sk, t4, sc);
  float x0 = -INFINITY, x1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    x0 = fmaxf(x0, fmaxf(s[4 * j], s[4 * j + 1]));
    x1 = fmaxf(x1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  const float mn0 = fmaxf(r.m0, quad_max(x0));
  const float mn1 = fmaxf(r.m1, quad_max(x1));
  if (CLS != CLS_BF16EXP) {
    const float al0 = expo<CLS>(r.m0 - mn0), al1 = expo<CLS>(r.m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ps0 += expo<CLS>(s[4 * j] - mn0) + expo<CLS>(s[4 * j + 1] - mn0);
      ps1 += expo<CLS>(s[4 * j + 2] - mn1) + expo<CLS>(s[4 * j + 3] - mn1);
    }
    r.l0 = fmaf(r.l0, al0, quad_sum(ps0));
    r.l1 = fmaf(r.l1, al1, quad_sum(ps1));
  }
  r.m0 = mn0;
  r.m1 = mn1;
}

// The P of tile t in place, every class: the weights P V multiplies
template <int CLS>
__device__ __forceinline__ void probs_tile(float (&s)[32], RowState& r,
                                           int t, int Sk, int t4, float sc) {
  if constexpr (CLS == CLS_POST || CLS == CLS_POSTR) {
    softmax_b4(s, r, t, Sk, t4, sc);
  } else if constexpr (CLS == CLS_FLOOR) {  // the scaled logits, 0 past Sk
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = __fmul_rn(s[i], sc);
    mask_tail(s, t, Sk, t4, 0.f);
  } else if constexpr (CLS == CLS_BF16EXP) {  // m the row's; l this thread's
    scaled(s, t, Sk, t4, sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[4 * j + e] = round_bf16(
            expf(round_bf16(s[4 * j + e] - (e < 2 ? r.m0 : r.m1))));
      r.l0 += s[4 * j] + s[4 * j + 1];
      r.l1 += s[4 * j + 2] + s[4 * j + 3];
    }
  } else {  // PRE, EXP2: m and l are the row's final ones
    scaled(s, t, Sk, t4, sc);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s[4 * j] = expo<CLS>(s[4 * j] - r.m0) / r.l0;
      s[4 * j + 1] = expo<CLS>(s[4 * j + 1] - r.m0) / r.l0;
      s[4 * j + 2] = expo<CLS>(s[4 * j + 2] - r.m1) / r.l1;
      s[4 * j + 3] = expo<CLS>(s[4 * j + 3] - r.m1) / r.l1;
    }
  }
}

__device__ __forceinline__ void pack(uint32_t (&pa)[4][4],
                                     const float (&s)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pa[kk][i] = hop::pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

// O *= exp2(m_old - m_new), row by row (the online classes)
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

// issue S = Q K_t^T into s (no fence, no commit); Q's rows are cp_cols
// bf16 of the q/o tile apart
template <int DP>
__device__ __forceinline__ void qk(float (&s)[32], uint32_t sq, uint32_t skt,
                                   int cp_cols) {
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
    Wgmma<64>::ss(s, hop::desc(sq + kc * 256, 128, cp_cols * 16),
                  hop::desc_kmajor<DP>(skt + kc * 256), kc > 0);
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

// rows [row0, row0 + 64) x cols [0, DP) of a (rows, ld) head slice into a
// hopper.cuh tile at `dst` by nt threads; rows >= nvalid and cols >= D are
// zero; the chunk of column `skip` is left as it is (POSTR's ones)
template <int DP>
__device__ __forceinline__ void load_kv_tile(uint32_t dst,
                                             const bf16* __restrict__ src,
                                             int row0, int nvalid, int ld,
                                             int D, int tid, int nt,
                                             int skip) {
  for (int i = tid; i < 64 * DP / 8; i += nt) {
    const int r = (i / DP) * 8 + (i & 7), c = ((i >> 3) % (DP / 8)) * 8;
    if (c == skip) continue;
    const bool ok = row0 + r < nvalid && c < D;
    hop::cp_async16(dst + i * 16, ok ? src + (size_t)(row0 + r) * ld + c : src,
                    ok);
  }
}

template <int DP, int CLS, int ORD, int TN>
__global__ void __launch_bounds__(256, 1)
variant_wgmma_kernel(const __grid_constant__ CUtensorMap map_wq,
                     const __grid_constant__ CUtensorMap map_wo,
                     const bf16* __restrict__ x, const bf16* __restrict__ lnw,
                     const bf16* __restrict__ lnb, const bf16* __restrict__ bo,
                     const bf16* __restrict__ k, const bf16* __restrict__ v,
                     bf16* __restrict__ out, int M, int Sk, int C, int H,
                     int D, float eps, float scale, int block_m) {
  constexpr int HP = ORD == ORD_PHASED ? 2 : 1;
  constexpr bool TWO = CLS == CLS_PRE || CLS == CLS_EXP2 || CLS == CLS_BF16EXP;
  constexpr bool ONLINE = CLS == CLS_POST || CLS == CLS_POSTR;
  constexpr int AHEAD = W_STAGES - 1;
  constexpr int KVT = 64 * DP * 2;  // bytes of one K or V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023))
                                    & 1023);
  const int NT = blockDim.x, BM = NT / 2, CP = C + 16;
  const Layout L = plan(TN, BM, C, DP, HP);
  const uint32_t s0 = hop::smem_u32(smem);
  const uint32_t sqo = s0 + L.qo, su = s0 + L.u, bar0 = s0 + L.bars;
  unsigned char* qo = smem + L.qo;
  unsigned char* xn = smem + L.u;

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int grp = blockIdx.y;
  const int m_begin = blockIdx.x * block_m;
  const int m_end = min(M, m_begin + block_m);
  const bf16* xg = x + (size_t)grp * M * C;
  const bf16* kg = k + (size_t)grp * Sk * C;
  const bf16* vg = v + (size_t)grp * Sk * C;
  bf16* og = out + (size_t)grp * M * C;
  const int NP = C / TN, NK = C / BK, per_chunk = 2 * NP * NK;
  const int total = (m_end - m_begin + BM - 1) / BM * per_chunk;
  const int r0 = wg * 64 + warp * 16 + g;  // this thread's rows r0, r0 + 8

  // ---- the W ring: Wq's panels, then Wo's, again for every row chunk
  auto sw = [&](int u) { return s0 + (u % W_STAGES) * TN * BK * 2; };
  auto bar = [&](int u) { return bar0 + (u % W_STAGES) * 8; };
  auto wload = [&](int u) {  // thread 0
    const int w = u % per_chunk, kt = w % NK;
    const int panel = (w % (NP * NK)) / NK;
    mbar_expect_tx(bar(u), TN * BK * 2);
    tma_load(sw(u), w < NP * NK ? &map_wq : &map_wo, kt * BK, panel * TN,
             bar(u));
  };
  // acc += A[this warpgroup's 64 rows, K tile kt] W_u^T; A is a
  // core-matrix tile at a0 whose rows hold `cols` bf16
  auto consume = [&](int u, uint32_t a0, int cols, int kt,
                     float (&acc)[TN / 2]) {
    mbar_wait(bar(u), (u / W_STAGES) & 1);
    __syncthreads();  // every warpgroup is done with tile u - 1's stage
    if (tid == 0 && u + AHEAD < total) wload(u + AHEAD);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      Wgmma<TN>::ss(acc, hop::desc(a0 + (kt * 8 + kk * 2) * 128, 128,
                                   cols * 16),
                    desc_sw128(sw(u) + kk * 32), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
  };

  // the pad columns [C, C + 16) of the q/o tile, read by the last head's
  // padded tile, are zero
  for (int i = tid; i < BM * 2; i += NT)
    *reinterpret_cast<uint4*>(qo + cm_off(i >> 1, C / 8 + (i & 1), CP)) =
        make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    for (int i = 0; i < W_STAGES; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    hop::fence_async_smem();
#pragma unroll 1
    for (int u = 0; u < AHEAD && u < total; ++u) wload(u);
  }
  __syncthreads();  // the mbarriers are initialised

  const float sc = CLS == CLS_EXP2 ? scale * LOG2E : scale;
  const float sl2e = scale * hop::LOG2E;
  const int ntiles = (Sk + 63) / 64;
  const uint32_t qw = sqo + wg * 8 * CP * 16;  // this warpgroup's q/o rows
  int u = 0;

  for (int m0 = m_begin; m0 < m_end; m0 += BM) {
    // A. LayerNorm of the BM rows into xn: K-gemm's ln_stats (8 lanes a
    //    row, lane sub holding columns 64 j + 8 sub) and its normalise
    {
      const int sub = tid & 7, nch = C / 64;
      for (int r = tid >> 3; r < BM; r += NT / 8) {
        const int m = m0 + r;
        const bool ok = m < M;
        const bf16* row = xg + (size_t)(ok ? m : 0) * C + 8 * sub;
        uint4 xv[LN_CH];
#pragma unroll
        for (int j = 0; j < LN_CH; ++j)
          xv[j] = ok && j < nch ? *reinterpret_cast<const uint4*>(row + 64 * j)
                                : make_uint4(0, 0, 0, 0);
        float s = 0.f, var = 0.f;
#pragma unroll
        for (int j = 0; j < LN_CH; ++j) s += sum8(xv[j]);
        const float mean = group8_sum(s) / (float)C;
#pragma unroll
        for (int j = 0; j < LN_CH; ++j)
          if (j < nch) var += sqdev8(xv[j], mean);
        const float rstd = rsqrtf(group8_sum(var) / (float)C + eps);
        const float mu = mean, rs = rstd;
#pragma unroll
        for (int j = 0; j < LN_CH; ++j) {
          if (j >= nch) continue;
          const int c = 64 * j + 8 * sub;
          uint4 vv = xv[j];
          const uint4 wv = *reinterpret_cast<const uint4*>(lnw + c);
          const uint4 bv = *reinterpret_cast<const uint4*>(lnb + c);
          bf16* e = reinterpret_cast<bf16*>(&vv);
          const bf16* we = reinterpret_cast<const bf16*>(&wv);
          const bf16* be = reinterpret_cast<const bf16*>(&bv);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            e[q] = __float2bfloat16_rn((to_f(e[q]) - mu) * rs * to_f(we[q]) +
                                       to_f(be[q]));
          *reinterpret_cast<uint4*>(xn + cm_off(r, c / 8, C)) = vv;
        }
      }
      hop::fence_async_smem();  // xn, for the products (async proxy)
    }

    // B. q = xn Wq^T, rounded into the q/o tile (K-gemm's store epilogue)
    for (int p = 0; p < NP; ++p) {
      float acc[TN / 2];
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < NK; ++kt, ++u)
        consume(u, su + wg * 8 * C * 16, C, kt, acc);
      hop::fence_regs(acc);
#pragma unroll
      for (int j = 0; j < TN / 8; ++j) {
        const int col = p * TN + 8 * j + 2 * t4;
        *reinterpret_cast<__nv_bfloat162*>(
            qo + cm_off(r0, col / 8, CP) + (col & 7) * 2) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
        *reinterpret_cast<__nv_bfloat162*>(
            qo + cm_off(r0 + 8, col / 8, CP) + (col & 7) * 2) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
      }
    }
    hop::fence_async_smem();  // q, for Q K^T
    __syncthreads();  // xn is read by no one: its space becomes the K/V ring

    // C. attention, HP heads a pass; the K/V ring reuses xn's space
    auto sk = [&](int t, int hh) {
      return su + ((t % KV_STAGES) * 2 * HP + hh) * KVT;
    };
    auto sv = [&](int t, int hh) { return sk(t, hh) + HP * KVT; };
    for (int h0 = 0; h0 < H; h0 += HP) {
      // head slot hh computes head min(h0 + hh, H - 1); only real heads
      // store (no branch surrounds a wgmma)
      int hd[HP];
      uint32_t qh[HP];
#pragma unroll
      for (int hh = 0; hh < HP; ++hh) {
        hd[hh] = min(h0 + hh, H - 1);
        qh[hh] = qw + (hd[hh] * D / 8) * 128;
      }
      RowState rs[HP];
      float oacc[HP][DP / 2];
#pragma unroll
      for (int hh = 0; hh < HP; ++hh) {
        rs[hh] = RowState{-INFINITY, -INFINITY, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < DP / 2; ++i) oacc[hh][i] = 0.f;
      }
      auto load_kv = [&](int t, bool with_v) {
#pragma unroll
        for (int hh = 0; hh < HP; ++hh)
          load_kv_tile<DP>(sk(t, hh), kg + hd[hh] * D, t * 64, Sk, C, D, tid,
                           NT, -1);
        if (with_v) {
#pragma unroll
          for (int hh = 0; hh < HP; ++hh)
            load_kv_tile<DP>(sv(t, hh), vg + hd[hh] * D, t * 64, Sk, C, D,
                             tid, NT, CLS == CLS_POSTR ? DP - 8 : -1);
        }
      };
      // One sweep over the K/V tiles: the statistics sweep of the two-sweep
      // classes, or the sweep that multiplies P V
      auto sweep = [&](auto stats_tag) {
        constexpr bool STATS = decltype(stats_tag)::value;
        if (!STATS && CLS == CLS_POSTR) {  // V's column DP - 8: ones
          for (int i = tid; i < KV_STAGES * HP * 64; i += NT) {
            const int r = i & 63, slot = i >> 6;
            *reinterpret_cast<uint4*>(
                smem + (sv(slot / HP, slot % HP) - s0) +
                cm_off(r, DP / 8 - 1, DP)) =
                make_uint4(0x3F80u, 0, 0, 0);
          }
        }
#pragma unroll 1
        for (int t = 0; t < KV_STAGES - 1; ++t) {
          if (t < ntiles) load_kv(t, !STATS);
          hop::cp_commit();
        }
        if constexpr (ORD == ORD_PIPE && !STATS) {
          // B4's loop (attn.cu), the last tile peeled off so that no branch
          // surrounds a wgmma: S of tile t + 1 and P V of tile t in flight
          // together, the softmax of t + 1 under P V of t
          float s[32];
          uint32_t pa[4][4];
          hop::cp_wait<KV_STAGES - 2>();  // tile 0
          hop::fence_async_smem();
          __syncthreads();
          hop::wg_fence();
          qk<DP>(s, qh[0], sk(0, 0), CP);
          hop::wg_commit();
          hop::wg_wait<0>();
          hop::fence_regs(s);
          probs_tile<CLS>(s, rs[0], 0, Sk, t4, ONLINE ? sl2e : sc);
          pack(pa, s);
          for (int t = 0; t + 1 < ntiles; ++t) {
            hop::cp_wait<KV_STAGES - 3>();  // tile t + 1
            hop::fence_async_smem();
            __syncthreads();  // ... and every warp is done with t - 1
            if (t + KV_STAGES - 1 < ntiles) load_kv(t + KV_STAGES - 1, true);
            hop::cp_commit();
            if (ONLINE) rescale<DP>(oacc[0], rs[0]);
            hop::fence_regs(oacc[0]);
            hop::wg_fence();
            qk<DP>(s, qh[0], sk(t + 1, 0), CP);
            hop::wg_commit();
            pv<DP>(oacc[0], pa, sv(t, 0));
            hop::wg_wait<1>();  // S of tile t + 1; P V of tile t may run on
            hop::fence_regs(s);
            probs_tile<CLS>(s, rs[0], t + 1, Sk, t4, ONLINE ? sl2e : sc);
            hop::wg_wait<0>();
            hop::fence_regs(oacc[0]);
            pack(pa, s);
          }
          if (ONLINE) rescale<DP>(oacc[0], rs[0]);
          hop::fence_regs(oacc[0]);
          pv<DP>(oacc[0], pa, sv(ntiles - 1, 0));
          hop::wg_wait<0>();
          hop::fence_regs(oacc[0]);
        } else {
          for (int t = 0; t < ntiles; ++t) {
            hop::cp_wait<KV_STAGES - 2>();  // tile t
            hop::fence_async_smem();
            __syncthreads();  // ... and every warp is done with t - 1
            if (t + KV_STAGES - 1 < ntiles)
              load_kv(t + KV_STAGES - 1, !STATS);
            hop::cp_commit();
            float s[HP][32];
            hop::wg_fence();  // every head's S first ...
#pragma unroll
            for (int hh = 0; hh < HP; ++hh)
              qk<DP>(s[hh], qh[hh], sk(t, hh), CP);
            hop::wg_commit();
            hop::wg_wait<0>();
#pragma unroll
            for (int hh = 0; hh < HP; ++hh) hop::fence_regs(s[hh]);
            if constexpr (STATS) {
#pragma unroll
              for (int hh = 0; hh < HP; ++hh)
                stats_tile<CLS>(s[hh], rs[hh], t, Sk, t4, sc);
            } else {
              uint32_t pa[HP][4][4];
#pragma unroll
              for (int hh = 0; hh < HP; ++hh) {  // ... then P V head by head
                probs_tile<CLS>(s[hh], rs[hh], t, Sk, t4,
                                ONLINE ? sl2e : sc);
                pack(pa[hh], s[hh]);
                if (ONLINE) rescale<DP>(oacc[hh], rs[hh]);
                hop::fence_regs(oacc[hh]);
                pv<DP>(oacc[hh], pa[hh], sv(t, hh));
              }
              hop::wg_wait<0>();
#pragma unroll
              for (int hh = 0; hh < HP; ++hh) hop::fence_regs(oacc[hh]);
            }
          }
        }
        hop::cp_wait<0>();
        __syncthreads();  // the ring is free for the next sweep
      };
      if constexpr (TWO) sweep(std::true_type());
      sweep(std::false_type());

      // each head's output, rounded, over its q columns
#pragma unroll
      for (int hh = 0; hh < HP; ++hh) {
        if (h0 + hh >= H) continue;
        float inv0 = 1.f, inv1 = 1.f;
        if (CLS == CLS_POST || CLS == CLS_BF16EXP) {
          inv0 = 1.f / quad_sum(rs[hh].l0);
          inv1 = 1.f / quad_sum(rs[hh].l1);
        } else if (CLS == CLS_POSTR) {  // column DP - 8 of P V: the ones
          constexpr int J = DP / 8 - 1;
          inv0 = 1.f / __shfl_sync(0xffffffffu, oacc[hh][4 * J], lane & ~3);
          inv1 = 1.f / __shfl_sync(0xffffffffu, oacc[hh][4 * J + 2],
                                   lane & ~3);
        }
        const int c0 = (h0 + hh) * D;
#pragma unroll
        for (int j = 0; j < DP / 8; ++j) {
          const int col = j * 8 + t4 * 2;
          if (col < D) {
            const int cc = c0 + col;
            *reinterpret_cast<__nv_bfloat162*>(
                qo + cm_off(r0, cc / 8, CP) + (cc & 7) * 2) =
                __floats2bfloat162_rn(oacc[hh][4 * j] * inv0,
                                      oacc[hh][4 * j + 1] * inv0);
            *reinterpret_cast<__nv_bfloat162*>(
                qo + cm_off(r0 + 8, cc / 8, CP) + (cc & 7) * 2) =
                __floats2bfloat162_rn(oacc[hh][4 * j + 2] * inv1,
                                      oacc[hh][4 * j + 3] * inv1);
          }
        }
      }
      hop::fence_async_smem();  // o, for the out-projection
    }

    // D. out = x + (o Wo^T + bo), K-gemm's epilogue 2: (acc + bias) staged
    //    in fp32, half a panel at a time, then x + it and one cast in
    //    16-byte chunks
    constexpr int HALF = TN / 2, LDS = HALF + 8;
    float* st = reinterpret_cast<float*>(xn) + wg * 64 * LDS;
    const int lr0 = warp * 16 + g;  // r0 within the warpgroup's rows
    for (int p = 0; p < NP; ++p) {
      float acc[TN / 2];
#pragma unroll
      for (int i = 0; i < TN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < NK; ++kt, ++u) consume(u, qw, CP, kt, acc);
      hop::fence_regs(acc);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (half) __syncthreads();  // the first half's reads are done
#pragma unroll
        for (int jj = 0; jj < HALF / 8; ++jj) {
          const int j = half * HALF / 8 + jj, col = 8 * jj + 2 * t4;
          const int n = p * TN + 8 * j + 2 * t4;
          const float b0 = to_f(bo[n]), b1 = to_f(bo[n + 1]);
          *reinterpret_cast<float2*>(st + lr0 * LDS + col) =
              make_float2(acc[4 * j] + b0, acc[4 * j + 1] + b1);
          *reinterpret_cast<float2*>(st + (lr0 + 8) * LDS + col) =
              make_float2(acc[4 * j + 2] + b0, acc[4 * j + 3] + b1);
        }
        __syncthreads();
        constexpr int CPR = HALF / 8;
        for (int i = tid & 127; i < 64 * CPR; i += 128) {
          const int r = i / CPR, c = (i % CPR) * 8;
          const int m = m0 + wg * 64 + r;
          if (m >= M) continue;
          const size_t o = (size_t)m * C + p * TN + half * HALF + c;
          const float4 x0 = *reinterpret_cast<const float4*>(st + r * LDS + c);
          const float4 x1 =
              *reinterpret_cast<const float4*>(st + r * LDS + c + 4);
          const float xs[8] = {x0.x, x0.y, x0.z, x0.w,
                               x1.x, x1.y, x1.z, x1.w};
          uint4 rv = *reinterpret_cast<const uint4*>(xg + o);
          bf16* e = reinterpret_cast<bf16*>(&rv);
#pragma unroll
          for (int q = 0; q < 8; ++q)
            e[q] = __float2bfloat16_rn(to_f(e[q]) + xs[q]);
          *reinterpret_cast<uint4*>(og + o) = rv;
        }
      }
    }
    __syncthreads();  // xn and the q/o tile are rewritten by the next rows
  }
}

// ---------------------------------------------------------------- fp32 ---

constexpr int R32 = 32, DMAX32 = 48, OPT32 = DMAX32 / 4;

__global__ void __launch_bounds__(128)
variant_f32_kernel(const float* __restrict__ x, const float* __restrict__ lnw,
                   const float* __restrict__ lnb, const float* __restrict__ wq,
                   const float* __restrict__ wo, const float* __restrict__ bo,
                   const float* __restrict__ k, const float* __restrict__ v,
                   float* __restrict__ out, int M, int Sk, int C, int H, int D,
                   float eps, float scale, int block_m, int cls) {
  const int LDX = C + 1;
  extern __shared__ __align__(16) unsigned char smem[];
  float* Xn = reinterpret_cast<float*>(smem);  // [R32][LDX]
  float* Qs = Xn + R32 * LDX;                  // [R32][LDX]  q, then o
  float* Ks = Qs + R32 * LDX;                  // [R32][D + 1]
  float* Vs = Ks + R32 * (D + 1);              // [R32][D]
  float* Ps = Vs + R32 * D;                    // [R32][R32 + 1]

  const int tid = threadIdx.x, r = tid >> 2, l4 = tid & 3;
  const int grp = blockIdx.y;
  const int m_begin = blockIdx.x * block_m;
  const int m_end = min(M, m_begin + block_m);
  const float* xg = x + (size_t)grp * M * C;
  const float* kg = k + (size_t)grp * Sk * C;
  const float* vg = v + (size_t)grp * Sk * C;
  float* og = out + (size_t)grp * M * C;
  const bool two = cls != CLS_FLOOR;
  const bool use2 = cls == CLS_EXP2;
  const float sc = use2 ? scale * LOG2E : scale;
  const int ntiles = (Sk + R32 - 1) / R32;

  for (int m0 = m_begin; m0 < m_end; m0 += R32) {
    const int m = m0 + r;
    const bool row_ok = m < M;
    const float* row = xg + (size_t)(row_ok ? m : 0) * C;
    // A. LayerNorm: 4 threads a row
    {
      float s = 0.f;
      for (int kk = l4; kk < C; kk += 4) s += row[kk];
      const float mean = quad_sum(s) / (float)C;
      float var = 0.f;
      for (int kk = l4; kk < C; kk += 4) {
        const float d = row[kk] - mean;
        var += d * d;
      }
      const float rstd = rsqrtf(quad_sum(var) / (float)C + eps);
      for (int kk = l4; kk < C; kk += 4)
        Xn[r * LDX + kk] =
            row_ok ? (row[kk] - mean) * rstd * lnw[kk] + lnb[kk] : 0.f;
    }
    __syncwarp();
    // B. q = xn Wq^T
    for (int n = l4; n < C; n += 4) {
      const float* w = wq + (size_t)n * C;
      float acc = 0.f;
      for (int kk = 0; kk < C; ++kk) acc = fmaf(Xn[r * LDX + kk], w[kk], acc);
      Qs[r * LDX + n] = acc;
    }
    __syncwarp();

    // C. attention, one head after the other
    for (int h = 0; h < H; ++h) {
      const float* qrow = Qs + r * LDX + h * D;
      float oacc[OPT32];
#pragma unroll
      for (int i = 0; i < OPT32; ++i) oacc[i] = 0.f;
      float mrow = -INFINITY, lrow = 0.f, l2 = 0.f;
      for (int pass = two ? 0 : 1; pass < 2; ++pass) {
        for (int t = 0; t < ntiles; ++t) {
          const int k0 = t * R32;
          __syncthreads();
          for (int i = tid; i < R32 * D; i += blockDim.x) {
            const int j = i / D, c = i % D;
            const bool ok = k0 + j < Sk;
            Ks[j * (D + 1) + c] =
                ok ? kg[(size_t)(k0 + j) * C + h * D + c] : 0.f;
            Vs[j * D + c] = ok ? vg[(size_t)(k0 + j) * C + h * D + c] : 0.f;
          }
          __syncthreads();
          float s[R32 / 4];
          float tmax = -INFINITY;
#pragma unroll
          for (int i = 0; i < R32 / 4; ++i) {
            const int j = l4 + 4 * i;
            float acc = 0.f;
            for (int d = 0; d < D; ++d)
              acc = fmaf(qrow[d], Ks[j * (D + 1) + d], acc);
            s[i] = k0 + j < Sk ? acc * sc : (cls == CLS_FLOOR ? 0.f : MASK);
            tmax = fmaxf(tmax, s[i]);
          }
          if (pass == 0) {
            const float mn = fmaxf(mrow, quad_max(tmax));
            const float al = use2 ? exp2f(mrow - mn) : expf(mrow - mn);
            float ps = 0.f;
#pragma unroll
            for (int i = 0; i < R32 / 4; ++i)
              ps += use2 ? exp2f(s[i] - mn) : expf(s[i] - mn);
            lrow = lrow * al + quad_sum(ps);
            mrow = mn;
            continue;
          }
          float ps = 0.f;
#pragma unroll
          for (int i = 0; i < R32 / 4; ++i) {
            float p;
            if (cls == CLS_FLOOR) p = s[i];
            else if (cls == CLS_PRE) p = expf(s[i] - mrow) / lrow;
            else if (cls == CLS_EXP2) p = exp2f(s[i] - mrow) / lrow;
            else if (cls == CLS_BF16EXP)
              p = round_bf16(expf(round_bf16(s[i] - mrow)));
            else p = expf(s[i] - mrow);
            ps += p;
            Ps[r * (R32 + 1) + l4 + 4 * i] = p;
          }
          l2 += quad_sum(ps);
          __syncwarp();
#pragma unroll
          for (int i = 0; i < OPT32; ++i) {
            const int d = l4 + 4 * i;
            if (d < D) {
              float acc = oacc[i];
              for (int j = 0; j < R32; ++j)
                acc = fmaf(Ps[r * (R32 + 1) + j], Vs[j * D + d], acc);
              oacc[i] = acc;
            }
          }
        }
      }
      float inv = 1.f;
      if (cls == CLS_POST || cls == CLS_POSTR) inv = 1.f / lrow;
      else if (cls == CLS_BF16EXP) inv = 1.f / l2;
      __syncwarp();  // the row's q_h reads are done
#pragma unroll
      for (int i = 0; i < OPT32; ++i) {
        const int d = l4 + 4 * i;
        if (d < D) Qs[r * LDX + h * D + d] = oacc[i] * inv;
      }
    }
    __syncwarp();

    // D. out = x + (o Wo^T + bo)
    if (row_ok)
      for (int n = l4; n < C; n += 4) {
        const float* w = wo + (size_t)n * C;
        float acc = 0.f;
        for (int kk = 0; kk < C; ++kk) acc = fmaf(Qs[r * LDX + kk], w[kk], acc);
        og[(size_t)m * C + n] = row[n] + (acc + bo[n]);
      }
    __syncthreads();
  }
}

// ------------------------------------------------------------- launches ---

struct Args {
  int G, M, Sk, C, H, D, block_m;
  float eps, scale;
  const void *x, *lnw, *lnb, *wq, *wo, *bo, *k, *v;
  void* out;
  cudaStream_t s;
};

template <int DP, int CLS, int ORD, int TN>
int launch_bf16(const Args& a) {
  constexpr int HP = ORD == ORD_PHASED ? 2 : 1;
  // two warpgroups (128 rows a step) where block_m allows it
  const int nwg = a.block_m % 128 == 0 ? 2 : 1;
  const int smem = plan(TN, 64 * nwg, a.C, DP, HP).bytes;
  if (smem > SMEM_CTA) return (int)cudaErrorInvalidValue;
  CUtensorMap map_wq, map_wo;
  if (!tensor_map(&map_wq, a.wq, a.C, a.C, TN) ||
      !tensor_map(&map_wo, a.wo, a.C, a.C, TN))
    return (int)cudaErrorInvalidValue;
  auto kernel = variant_wgmma_kernel<DP, CLS, ORD, TN>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.M + a.block_m - 1) / a.block_m, a.G);
  kernel<<<grid, 128 * nwg, smem, a.s>>>(
      map_wq, map_wo, (const bf16*)a.x, (const bf16*)a.lnw,
      (const bf16*)a.lnb, (const bf16*)a.bo, (const bf16*)a.k,
      (const bf16*)a.v, (bf16*)a.out, a.M, a.Sk, a.C, a.H, a.D, a.eps,
      a.scale, a.block_m);
  return (int)cudaGetLastError();
}

// DP: the head dim padded to 16 (POSTR: D + 1 padded, for the ones column);
// TN: K-gemm's tile for N = C (160 where it divides C, else 64).
template <int TN>
int dispatch_bf16(int cls, int ord, const Args& a) {
  const int dp = ((cls == CLS_POSTR ? a.D + 1 : a.D) + 15) / 16 * 16;
#define ASVA_VAR(DP, CLS, ORD)                 \
  if (dp == DP && cls == CLS && ord == ORD)    \
    return launch_bf16<DP, CLS, ORD, TN>(a);
#define ASVA_DP(DP)                                                        \
  ASVA_VAR(DP, CLS_PRE, ORD_SEQ)        /* v0 */                           \
  ASVA_VAR(DP, CLS_PRE, ORD_PHASED)     /* v1_phased, v6_stacksm */        \
  ASVA_VAR(DP, CLS_PRE, ORD_PIPE)       /* v8_pipe */                      \
  ASVA_VAR(DP, CLS_POST, ORD_SEQ)       /* v2_postnorm */                  \
  ASVA_VAR(DP, CLS_POST, ORD_PHASED)    /* v3_both */                      \
  ASVA_VAR(DP, CLS_POSTR, ORD_PHASED)   /* v9_mxusum */                    \
  ASVA_VAR(DP, CLS_EXP2, ORD_PHASED)    /* v7_exp2 */                      \
  ASVA_VAR(DP, CLS_BF16EXP, ORD_PHASED) /* v5_bf16exp */                   \
  ASVA_VAR(DP, CLS_FLOOR, ORD_SEQ)      /* v4_mmfloor */
  ASVA_DP(32)
  ASVA_DP(48)
  // POSTR at head dim 48 (C = 192, the only such width up to 320)
  if constexpr (TN == 64) {
    ASVA_VAR(64, CLS_POSTR, ORD_PHASED)
  }
#undef ASVA_DP
#undef ASVA_VAR
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  cls 0-5 and ord 0-2 as the enums above,
// in the nine pairs the tool's ten names map to (the Python wrapper holds the
// table).  C a multiple of 64 up to 320; D = C / H one of 24, 32, 40, 48;
// block_m a multiple of 64; Sk >= 1.  One launch.  Returns
// cudaGetLastError() after it (0 = success).
extern "C" int asva_ln_attn_variant(int dtype, int cls, int ord, int G, int M,
                                    int Sk, int C, int H, int block_m,
                                    float eps, float scale, const void* x,
                                    const void* lnw, const void* lnb,
                                    const void* wq, const void* wo,
                                    const void* bo, const void* k,
                                    const void* v, void* out, void* stream) {
  if (H < 1 || C % H || C % 64 || C > 320 || block_m < 64 || block_m % 64 ||
      Sk < 1 || cls < 0 || cls > 5)
    return (int)cudaErrorInvalidValue;
  const int D = C / H;
  // the padded head tile may overrun its head by at most 16 columns
  if (D % 8 || D < 24 || D > DMAX32) return (int)cudaErrorInvalidValue;
  const Args a = {G, M, Sk, C, H, D, block_m, eps, scale, x, lnw, lnb, wq, wo,
                  bo, k, v, out, (cudaStream_t)stream};
  if (dtype == 1)
    return C % 160 == 0 ? dispatch_bf16<160>(cls, ord, a)
                        : dispatch_bf16<64>(cls, ord, a);
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int smem = (2 * R32 * (C + 1) + R32 * (D + 1) + R32 * D +
                    R32 * (R32 + 1)) * (int)sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(
      variant_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((M + block_m - 1) / block_m, G);
  variant_f32_kernel<<<grid, 128, smem, a.s>>>(
      (const float*)x, (const float*)lnw, (const float*)lnb, (const float*)wq,
      (const float*)wo, (const float*)bo, (const float*)k, (const float*)v,
      (float*)out, M, Sk, C, H, D, eps, scale, block_m, cls);
  return (int)cudaGetLastError();
}
