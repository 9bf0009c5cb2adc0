// T1: the LN + q-projection + attention + out-projection + residual
// sub-layer as ONE launch, in ten variants of softmax arithmetic and
// schedule, for sm_90a.  Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernels _k_v0 ... _k_v9 (tools/attn_experiments.py
// :58-294), called by run_variant (:304): B1's function (gemm.cu + attn.cu,
// three launches with q and o through device memory) held in one program from
// the LayerNorm to the residual.  One block owns `block_m` query rows of one
// token group and walks them 64 at a time; each of its 4 warps owns 16 rows
// through every stage:
//   A. LayerNorm in fp32 (two-pass variance), rounded into shared memory;
//   B. q = xn Wq^T over 64-column panels of Wq streamed through shared
//      memory, fp32 accumulation, rounded into shared memory;
//   C. per head (or pair of heads) the attention over 64-row K/V tiles
//      streamed through shared memory; each head's output, rounded, overwrites
//      its q columns;
//   D. out = x + (o Wo^T + bo) over panels of Wo, one store.
// The rounding points and the summation order of A, B and D are gemm.cu's, so
// q is B1's bit for bit.
//
// Stage C has six arithmetic classes (CLS) and three schedules (ORD):
//   PRE      p = exp(s - m) / l in fp32, rounded, then P V (v0, v1_phased,
//            v6_stacksm, v8_pipe).  With Sk streamed the row's m and l must be
//            known before the first P V: a first sweep over K computes them
//            (online), a second recomputes s.  That second Q K^T is the cost
//            of "divide, then round" on this card.
//   POST     online softmax, exp(s - m) rounded, P V in fp32, divided by the
//            fp32 sum of the unrounded p at the end (v2_postnorm, v3_both):
//            attn.cu's order, one sweep.
//   POSTR    as POST, but l is the sum of the ROUNDED p, taken by the tensor
//            cores through a block of ones (v9_mxusum).
//   EXP2     as PRE with scale * log2(e) folded into the logits and exp2
//            (v7_exp2).
//   BF16EXP  exp of (s - m) rounded to bf16, its result rounded to bf16, l
//            their fp32 sum, divided at the end; m is the row's true maximum
//            from a first sweep, as the rounding of s - m depends on it
//            (v5_bf16exp).
//   FLOOR    no softmax: the scaled logits, rounded, times V (v4_mmfloor).
//   SEQ      heads one after the other;
//   PHASED   two heads per sweep, both Q K^T products of a K tile started
//            before either softmax (the logits of two heads live at once: the
//            register budget stops there);
//   PIPE     one head, K/V tiles double-buffered, the Q K^T of tile t + 1
//            started before the softmax + P V of tile t.
// v1_phased and v6_stacksm are the same instantiation: a softmax stacked over
// the heads' tiles is row-wise the same arithmetic and has no counterpart in
// registers.
//
// Widths: C a multiple of 64 up to 320 (three C-wide 64-row bf16 tiles and
// the K/V tiles must fit 227 KB of shared memory); head dims that are
// 24, 32, 40 or 48; block_m a multiple of 64.
// fp32: a plain FMA path for the fp32 checks, 32 rows a step, every class in
// two sweeps.
//
// What bounds it on the H100: one block holds 155 KB of shared memory, so one
// block (4 warps) runs per SM, and with block_m = 256 or 512 the tool's shape
// gives 96 or 48 blocks for 132 SMs.  q and o never touch device memory, but
// the products run on mma.sync from 16- and 32-bit shared loads.

#include "attn_tile.cuh"

namespace {

using namespace asva;

enum { CLS_PRE = 0, CLS_POST = 1, CLS_POSTR = 2, CLS_EXP2 = 3,
       CLS_BF16EXP = 4, CLS_FLOOR = 5 };
enum { ORD_SEQ = 0, ORD_PHASED = 1, ORD_PIPE = 2 };

constexpr uint32_t ONES2 = 0x3F803F80u;  // two bf16 ones
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }

template <int DT>
struct HeadState {
  float o[DT][4];
  float m[2], l[2];
  float la[4];  // POSTR: the row sums, as a product with ones
};

template <int CLS>
__device__ __forceinline__ float expo(float v) {
  return CLS == CLS_EXP2 ? exp2f(v) : expf(v);
}

// One K/V tile of one head: `s` holds the raw Q K^T accumulators.
template <int DP, int CLS, bool STATS>
__device__ __forceinline__ void step(float (&s)[8][4], HeadState<DP / 8>& st,
                                     const bf16* Vs, int k0, int Sk, float sc,
                                     int g, int t4) {
  constexpr int LD = DP + 8, DT = DP / 8;
  if (CLS == CLS_FLOOR) {
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        s[nt][e] = col < Sk ? s[nt][e] * sc : 0.f;
      }
    mma_pb<LD, DT>(st.o, s, Vs, g, t4);
    return;
  }
  float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
      const float val = col < Sk ? s[nt][e] * sc : MASK;
      s[nt][e] = val;
      if (e < 2) tm0 = fmaxf(tm0, val);
      else tm1 = fmaxf(tm1, val);
    }
  if (STATS) {
    const float mn0 = fmaxf(st.m[0], quad_max(tm0));
    const float mn1 = fmaxf(st.m[1], quad_max(tm1));
    if (CLS != CLS_BF16EXP) {
      const float al0 = expo<CLS>(st.m[0] - mn0);
      const float al1 = expo<CLS>(st.m[1] - mn1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        ps0 += expo<CLS>(s[nt][0] - mn0) + expo<CLS>(s[nt][1] - mn0);
        ps1 += expo<CLS>(s[nt][2] - mn1) + expo<CLS>(s[nt][3] - mn1);
      }
      st.l[0] = st.l[0] * al0 + quad_sum(ps0);
      st.l[1] = st.l[1] * al1 + quad_sum(ps1);
    }
    st.m[0] = mn0;
    st.m[1] = mn1;
    return;
  }
  if (CLS == CLS_PRE || CLS == CLS_EXP2) {  // m and l are the row's final ones
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = expo<CLS>(s[nt][0] - st.m[0]) / st.l[0];
      s[nt][1] = expo<CLS>(s[nt][1] - st.m[0]) / st.l[0];
      s[nt][2] = expo<CLS>(s[nt][2] - st.m[1]) / st.l[1];
      s[nt][3] = expo<CLS>(s[nt][3] - st.m[1]) / st.l[1];
    }
    mma_pb<LD, DT>(st.o, s, Vs, g, t4);
    return;
  }
  if (CLS == CLS_BF16EXP) {  // m is final; l: this thread's part of the sum
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        s[nt][e] = round_bf16(expf(round_bf16(s[nt][e] - st.m[e >> 1])));
      st.l[0] += s[nt][0] + s[nt][1];
      st.l[1] += s[nt][2] + s[nt][3];
    }
    mma_pb<LD, DT>(st.o, s, Vs, g, t4);
    return;
  }
  // POST, POSTR: the online softmax of attn.cu
  const float mn0 = fmaxf(st.m[0], quad_max(tm0));
  const float mn1 = fmaxf(st.m[1], quad_max(tm1));
  const float al0 = expf(st.m[0] - mn0), al1 = expf(st.m[1] - mn1);
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    s[nt][0] = expf(s[nt][0] - mn0);
    s[nt][1] = expf(s[nt][1] - mn0);
    s[nt][2] = expf(s[nt][2] - mn1);
    s[nt][3] = expf(s[nt][3] - mn1);
    ps0 += s[nt][0] + s[nt][1];
    ps1 += s[nt][2] + s[nt][3];
  }
  if (CLS == CLS_POST) {
    st.l[0] = st.l[0] * al0 + quad_sum(ps0);
    st.l[1] = st.l[1] * al1 + quad_sum(ps1);
  }
  st.m[0] = mn0;
  st.m[1] = mn1;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    st.o[dt][0] *= al0;
    st.o[dt][1] *= al0;
    st.o[dt][2] *= al1;
    st.o[dt][3] *= al1;
  }
  if (CLS == CLS_POSTR) {
    st.la[0] *= al0;
    st.la[1] *= al0;
    st.la[2] *= al1;
    st.la[3] *= al1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = pack_f(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = pack_f(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = pack_f(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = pack_f(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      mma_bf16(st.la, pa, ONES2, ONES2);
    }
  }
  mma_pb<LD, DT>(st.o, s, Vs, g, t4);
}

// One sweep over the K/V tiles for the HP heads starting at h0.  KV holds
// [slot][K, V][64][DP + 8]; a slot is a head (PHASED) or a stage (PIPE).
template <int DP, int CLS, int ORD, bool STATS, int HP>
__device__ __forceinline__ void sweep(HeadState<DP / 8> (&st)[HP],
                                      const uint32_t (&qf)[HP][DP / 16][4],
                                      bf16* KV, const bf16* kg, const bf16* vg,
                                      int h0, int H, int Sk, int C, int D,
                                      float sc, int g, int t4) {
  constexpr int HT = TILE * (DP + 8);
  const int ntiles = (Sk + TILE - 1) / TILE;
  if (ORD != ORD_PIPE) {
    for (int t = 0; t < ntiles; ++t) {
      const int k0 = t * TILE;
      __syncthreads();  // the previous tile's reads are done
#pragma unroll
      for (int hh = 0; hh < HP; ++hh)
        if (h0 + hh < H) {
          load_tile<DP>(KV + hh * 2 * HT, kg + (h0 + hh) * D, k0, Sk, C, D);
          if (!STATS)
            load_tile<DP>(KV + (hh * 2 + 1) * HT, vg + (h0 + hh) * D, k0, Sk,
                          C, D);
        }
      __syncthreads();
      float s[HP][8][4];
#pragma unroll
      for (int hh = 0; hh < HP; ++hh)
        if (h0 + hh < H) qk_tile<DP>(s[hh], qf[hh], KV + hh * 2 * HT, g, t4);
#pragma unroll
      for (int hh = 0; hh < HP; ++hh)
        if (h0 + hh < H)
          step<DP, CLS, STATS>(s[hh], st[hh], KV + (hh * 2 + 1) * HT, k0, Sk,
                               sc, g, t4);
    }
  } else {
    float sc_[8][4], sn[8][4];
    __syncthreads();
    load_tile<DP>(KV, kg + h0 * D, 0, Sk, C, D);
    if (!STATS) load_tile<DP>(KV + HT, vg + h0 * D, 0, Sk, C, D);
    __syncthreads();
    qk_tile<DP>(sc_, qf[0], KV, g, t4);
    for (int t = 0; t < ntiles; ++t) {
      const int nxt = (t + 1) & 1;
      if (t + 1 < ntiles) {
        load_tile<DP>(KV + nxt * 2 * HT, kg + h0 * D, (t + 1) * TILE, Sk, C, D);
        if (!STATS)
          load_tile<DP>(KV + (nxt * 2 + 1) * HT, vg + h0 * D, (t + 1) * TILE,
                        Sk, C, D);
      }
      __syncthreads();
      if (t + 1 < ntiles) qk_tile<DP>(sn, qf[0], KV + nxt * 2 * HT, g, t4);
      step<DP, CLS, STATS>(sc_, st[0], KV + ((t & 1) * 2 + 1) * HT, t * TILE,
                           Sk, sc, g, t4);
      if (t + 1 < ntiles) {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc_[nt][e] = sn[nt][e];
      }
      __syncthreads();  // this stage may be overwritten next iteration
    }
  }
}

// acc (this warp's 16 rows x 64 columns of panel n0) = A[16 x C] W[n0.., C]^T;
// the block loads the panel first.  Contraction in ascending 16-chunks, as
// gemm.cu.
__device__ __forceinline__ void panel_product(float (&acc)[8][4], const bf16* a,
                                              bf16* Wp, const bf16* w, int n0,
                                              int C, int g, int t4) {
  const int LDC = C + 8, cpr = C / 8;
  __syncthreads();  // the previous panel's reads are done
  for (int c = threadIdx.x; c < TILE * cpr; c += blockDim.x) {
    const int r = c / cpr, col = (c % cpr) * 8;
    *reinterpret_cast<uint4*>(Wp + r * LDC + col) =
        *reinterpret_cast<const uint4*>(w + (size_t)(n0 + r) * C + col);
  }
  __syncthreads();
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
  for (int kc = 0; kc < C / 16; ++kc) {
    const bf16* ar = a + g * LDC + kc * 16 + t4 * 2;
    uint32_t af[4];
    af[0] = *reinterpret_cast<const uint32_t*>(ar);
    af[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * LDC);
    af[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
    af[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * LDC + 8);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* br = Wp + (nt * 8 + g) * LDC + kc * 16 + t4 * 2;
      mma_bf16(acc[nt], af, *reinterpret_cast<const uint32_t*>(br),
               *reinterpret_cast<const uint32_t*>(br + 8));
    }
  }
}

template <int DP, int CLS, int ORD>
__global__ void __launch_bounds__(128)
variant_bf16_kernel(const bf16* __restrict__ x, const bf16* __restrict__ lnw,
                    const bf16* __restrict__ lnb, const bf16* __restrict__ wq,
                    const bf16* __restrict__ wo, const bf16* __restrict__ bo,
                    const bf16* __restrict__ k, const bf16* __restrict__ v,
                    bf16* __restrict__ out, int M, int Sk, int C, int H, int D,
                    float eps, float scale, int block_m) {
  constexpr int KC = DP / 16, DT = DP / 8;
  constexpr int HP = ORD == ORD_PHASED ? 2 : 1;
  constexpr bool TWO = CLS == CLS_PRE || CLS == CLS_EXP2 || CLS == CLS_BF16EXP;
  const int LDC = C + 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Xn = reinterpret_cast<bf16*>(smem);  // [64][LDC]
  bf16* Qs = Xn + TILE * LDC;                // [64][LDC]  q, then o
  bf16* Wp = Qs + TILE * LDC;                // [64][LDC]  a panel of Wq / Wo
  bf16* KV = Wp + TILE * LDC;                // [1 or 2][K, V][64][DP + 8]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int grp = blockIdx.y;
  const int m_begin = blockIdx.x * block_m;
  const int m_end = min(M, m_begin + block_m);
  const bf16* xg = x + (size_t)grp * M * C;
  const bf16* kg = k + (size_t)grp * Sk * C;
  const bf16* vg = v + (size_t)grp * Sk * C;
  bf16* og = out + (size_t)grp * M * C;
  const float sc = CLS == CLS_EXP2 ? scale * LOG2E : scale;

  // the pad columns of q are read by the last head's padded fragments
  for (int i = tid; i < TILE * 8; i += blockDim.x)
    Qs[(i / 8) * LDC + C + (i % 8)] = __float2bfloat16_rn(0.f);

  for (int m0 = m_begin; m0 < m_end; m0 += TILE) {
    // A. LayerNorm of this warp's 16 rows (gemm.cu row_stats + store)
    for (int rr = 0; rr < 16; ++rr) {
      const int r = warp * 16 + rr, m = m0 + r;
      bf16* dst = Xn + r * LDC;
      if (m < M) {
        const bf16* row = xg + (size_t)m * C;
        float s = 0.f;
        for (int kk = lane; kk < C; kk += 32) s += to_f(row[kk]);
        const float mean = warp_sum(s) / (float)C;
        float var = 0.f;
        for (int kk = lane; kk < C; kk += 32) {
          const float d = to_f(row[kk]) - mean;
          var += d * d;
        }
        const float rstd = rsqrtf(warp_sum(var) / (float)C + eps);
        for (int kk = lane; kk < C; kk += 32)
          dst[kk] = __float2bfloat16_rn(
              (to_f(row[kk]) - mean) * rstd * to_f(lnw[kk]) + to_f(lnb[kk]));
      } else {
        for (int kk = lane; kk < C; kk += 32) dst[kk] = __float2bfloat16_rn(0.f);
      }
    }

    // B. q = xn Wq^T, rounded
    for (int n0 = 0; n0 < C; n0 += TILE) {
      float acc[8][4];
      panel_product(acc, Xn + warp * 16 * LDC, Wp, wq, n0, C, g, t4);
      bf16* qr = Qs + (warp * 16 + g) * LDC + n0 + t4 * 2;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        *reinterpret_cast<__nv_bfloat162*>(qr + nt * 8) =
            __floats2bfloat162_rn(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<__nv_bfloat162*>(qr + 8 * LDC + nt * 8) =
            __floats2bfloat162_rn(acc[nt][2], acc[nt][3]);
      }
    }
    __syncwarp();

    // C. attention, HP heads a sweep
    for (int h0 = 0; h0 < H; h0 += HP) {
      uint32_t qf[HP][KC][4];
      HeadState<DT> st[HP];
#pragma unroll
      for (int hh = 0; hh < HP; ++hh) {
        if (h0 + hh < H)
          load_afrag<DP>(qf[hh], Qs + warp * 16 * LDC + (h0 + hh) * D, LDC, g,
                         t4);
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
#pragma unroll
          for (int e = 0; e < 4; ++e) st[hh].o[dt][e] = 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e) st[hh].la[e] = 0.f;
        st[hh].m[0] = st[hh].m[1] = -INFINITY;
        st[hh].l[0] = st[hh].l[1] = 0.f;
      }
      if constexpr (TWO)
        sweep<DP, CLS, ORD, true, HP>(st, qf, KV, kg, vg, h0, H, Sk, C, D, sc,
                                      g, t4);
      sweep<DP, CLS, ORD, false, HP>(st, qf, KV, kg, vg, h0, H, Sk, C, D, sc,
                                     g, t4);
      __syncwarp();
#pragma unroll
      for (int hh = 0; hh < HP; ++hh) {
        if (h0 + hh >= H) continue;
        float inv0 = 1.f, inv1 = 1.f;
        if (CLS == CLS_POST) {
          inv0 = 1.f / st[hh].l[0];
          inv1 = 1.f / st[hh].l[1];
        } else if (CLS == CLS_POSTR) {
          inv0 = 1.f / st[hh].la[0];
          inv1 = 1.f / st[hh].la[2];
        } else if (CLS == CLS_BF16EXP) {
          inv0 = 1.f / quad_sum(st[hh].l[0]);
          inv1 = 1.f / quad_sum(st[hh].l[1]);
        }
        bf16* orow = Qs + (warp * 16 + g) * LDC + (h0 + hh) * D + t4 * 2;
#pragma unroll
        for (int dt = 0; dt < DT; ++dt)
          if (dt * 8 + t4 * 2 < D) {
            *reinterpret_cast<__nv_bfloat162*>(orow + dt * 8) =
                __floats2bfloat162_rn(st[hh].o[dt][0] * inv0,
                                      st[hh].o[dt][1] * inv0);
            *reinterpret_cast<__nv_bfloat162*>(orow + 8 * LDC + dt * 8) =
                __floats2bfloat162_rn(st[hh].o[dt][2] * inv1,
                                      st[hh].o[dt][3] * inv1);
          }
      }
      __syncwarp();
    }

    // D. out = x + (o Wo^T + bo), one cast (gemm.cu epilogue 2)
    for (int n0 = 0; n0 < C; n0 += TILE) {
      float acc[8][4];
      panel_product(acc, Qs + warp * 16 * LDC, Wp, wo, n0, C, g, t4);
      const int r0 = m0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const int n = n0 + nt * 8 + t4 * 2;
        const float b0 = to_f(bo[n]), b1 = to_f(bo[n + 1]);
        if (r0 < M) {
          const __nv_bfloat162 xr =
              *reinterpret_cast<const __nv_bfloat162*>(xg + (size_t)r0 * C + n);
          *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r0 * C + n) =
              __floats2bfloat162_rn(to_f(xr.x) + (acc[nt][0] + b0),
                                    to_f(xr.y) + (acc[nt][1] + b1));
        }
        if (r1 < M) {
          const __nv_bfloat162 xr =
              *reinterpret_cast<const __nv_bfloat162*>(xg + (size_t)r1 * C + n);
          *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r1 * C + n) =
              __floats2bfloat162_rn(to_f(xr.x) + (acc[nt][2] + b0),
                                    to_f(xr.y) + (acc[nt][3] + b1));
        }
      }
    }
    __syncthreads();  // Qs and Xn are rewritten by the next 64 rows
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

template <int DP, int CLS, int ORD>
int launch_bf16(const Args& a) {
  constexpr int NKV = ORD == ORD_SEQ ? 1 : 2;
  const int smem = (3 * TILE * (a.C + 8) + NKV * 2 * TILE * (DP + 8)) *
                   (int)sizeof(bf16);
  int e = set_smem(variant_bf16_kernel<DP, CLS, ORD>, smem);
  if (e) return e;
  const dim3 grid((a.M + a.block_m - 1) / a.block_m, a.G);
  variant_bf16_kernel<DP, CLS, ORD><<<grid, 128, smem, a.s>>>(
      (const bf16*)a.x, (const bf16*)a.lnw, (const bf16*)a.lnb,
      (const bf16*)a.wq, (const bf16*)a.wo, (const bf16*)a.bo,
      (const bf16*)a.k, (const bf16*)a.v, (bf16*)a.out, a.M, a.Sk, a.C, a.H,
      a.D, a.eps, a.scale, a.block_m);
  return (int)cudaGetLastError();
}

template <int DP>
int dispatch_bf16(int cls, int ord, const Args& a) {
#define ASVA_VAR(CLS, ORD) \
  if (cls == CLS && ord == ORD) return launch_bf16<DP, CLS, ORD>(a);
  ASVA_VAR(CLS_PRE, ORD_SEQ)        // v0
  ASVA_VAR(CLS_PRE, ORD_PHASED)     // v1_phased, v6_stacksm
  ASVA_VAR(CLS_PRE, ORD_PIPE)       // v8_pipe
  ASVA_VAR(CLS_POST, ORD_SEQ)       // v2_postnorm
  ASVA_VAR(CLS_POST, ORD_PHASED)    // v3_both
  ASVA_VAR(CLS_POSTR, ORD_PHASED)   // v9_mxusum
  ASVA_VAR(CLS_EXP2, ORD_PHASED)    // v7_exp2
  ASVA_VAR(CLS_BF16EXP, ORD_PHASED) // v5_bf16exp
  ASVA_VAR(CLS_FLOOR, ORD_SEQ)      // v4_mmfloor
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
  // the padded head tile may overrun its head by at most the 8 pad columns
  if (D % 8 || D < 24 || D > DMAX32) return (int)cudaErrorInvalidValue;
  const Args a = {G, M, Sk, C, H, D, block_m, eps, scale, x, lnw, lnb, wq, wo,
                  bo, k, v, out, (cudaStream_t)stream};
  if (dtype == 1) {
    switch ((D + 15) / 16 * 16) {
      case 32: return dispatch_bf16<32>(cls, ord, a);
      case 48: return dispatch_bf16<48>(cls, ord, a);
      default: return (int)cudaErrorInvalidValue;
    }
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int smem = (2 * R32 * (C + 1) + R32 * (D + 1) + R32 * D +
                    R32 * (R32 + 1)) * (int)sizeof(float);
  int e = set_smem(variant_f32_kernel, smem);
  if (e) return e;
  const dim3 grid((M + block_m - 1) / block_m, G);
  variant_f32_kernel<<<grid, 128, smem, a.s>>>(
      (const float*)x, (const float*)lnw, (const float*)lnb, (const float*)wq,
      (const float*)wo, (const float*)bo, (const float*)k, (const float*)v,
      (float*)out, M, Sk, C, H, D, eps, scale, block_m, cls);
  return (int)cudaGetLastError();
}
