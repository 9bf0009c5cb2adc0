// T2b: the flash backward as ONE kernel of five products, for sm_90a.
// Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel _bwd_kernel (tools/mha_phase_bench.py:101),
// called by bwd_flat (:181): B5's function (attn_bwd.cu) in one program.
// Per head
//
//   S  = Q K^T * scale          (columns >= kv_len masked: P = 0 there)
//   P  = exp(S - lse)
//   dS = P * (dO V^T - dd) * scale
//   dQ = dS K      dK = dS^T Q      dV = P^T dO
//
// with dS rounded to q's dtype before its products and P to v's dtype
// before dV.  The Pallas grid walks the query tiles in order and adds dK/dV
// into fp32 blocks that stay on chip; B5 avoids that carry with two kernels
// that both recompute S and dO V^T (seven products).  This kernel keeps the
// Pallas count of five, on B5's dK/dV kernel (bwd_dkv_bf16_kernel):
//   * one block owns 64 K/V rows per warpgroup of `HG` adjacent heads (and,
//     for head tiles wider than 96, one of two column slices of dK/dV and dQ,
//     as B5) and walks every query tile through a cp.async ring of Q, dO,
//     lse and dd, its dK and dV accumulators in registers (fp32 over the
//     whole walk, cast once at the store: the Pallas carry);
//   * S^T = K Q^T and (dO V^T)^T are m64n64k16 wgmma with both operands
//     K-major in shared memory; P^T and dS^T go from the accumulators into
//     the A fragments of dV += P^T dO and dK += dS^T Q (wgmma, B MN-major):
//     B5's arithmetic in B5's order, so dK and dV are bit-equal to B5's
//     wherever B5 runs its dK/dV kernel unsplit, and across the orders;
//   * the fifth product: each warpgroup stores its rounded dS^T fragments
//     into shared memory as a [key][query] tile, and dQ_tile = dS K is one
//     wgmma with both operands MN-major (A = that tile, B = the K tile read
//     as B5's dQ kernel reads it); the two warpgroups' 64-key partials are
//     summed in shared memory (fixed order), and the block adds the sum into
//     the wrapper's zeroed fp32 (G, M, H*D) buffer with 16-byte atomic
//     reductions (one per 4 columns).  The wrapper casts it once.  dQ's sum
//     over the K/V blocks has no fixed order.
// Key rows in [kv_len, Sk) get zero dK/dV and are never read.
//
// Orders (template parameters) differ only in when the logit products are
// issued and waited for; per head the statements are the same:
//   b0  SEQ, one head: S^T, wait, P; then (dO V^T)^T, wait, dS;
//   b1  one head: both logit products issued back to back (B5's order);
//   b2 / b4 / b3  two / four / all heads a block, every head's logit
//       products issued before the first exp.
// When HG does not divide H the last block repeats head H - 1 in its spare
// slots and neither stores nor adds anything for them.
//
// What bounds it on the H100: as B5, the exp and elementwise issue slots and
// the copy latency at a short contraction (48 at d = 40), not the tensor
// cores; five products instead of seven, against M * H * D fp32 reductions
// of dQ per K/V block (halved by the in-block sum) and a warpgroup barrier
// and one or two block barriers per head and query tile.  A head costs a
// thread 64 words of S^T and (dO V^T)^T and DS of dK/dV accumulators, so
// HG = 2 reaches 255 registers and HG = 4 spills (ptxas then serializes its
// wgmma); the instantiations stop at HG * (64 + DP) <= 512, the rule the
// Python wrapper states.  Shared memory holds HG heads' K/V tiles, the ring
// of HG heads' Q/dO tiles, the dS^T tiles and the dQ partials: the stage
// count (3, 2 or 1) and the warpgroups a block (2 or 1) are chosen at
// compile time to fit the 227 KB a block may have.
// fp32: a plain FMA path for the fp32 checks; a block walks its heads one
// after the other.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int SMEM_LIMIT = 232448;  // dynamic shared memory a block may have
constexpr int DS_TILE = 64 * 64 * 2;  // one warpgroup's dS^T tile, bytes

// ---------------------------------------------------------------- bf16 ---

// Shared memory of a block: K then V tiles (HG heads x NWG), the ring
// (STAGES stages of HG x (Q, dO, lse[64], dd[64])), NWG dS^T tiles, NWG dQ
// partials of 64 x (DS + 4) fp32.  Three stages and two warpgroups as B5
// where they fit; else fewer stages, then one warpgroup.
template <int DP, int HG>
struct Plan {
  static constexpr int DS = DP > 96 ? DP / 2 : DP;  // B5's head slice
  static constexpr int TILE = 64 * DP * 2;
  static constexpr int HSTAGE = 2 * TILE + 2 * 64 * 4;
  static constexpr int LDP = DS + 4;  // row stride of a dQ partial, floats
  static constexpr int bytes(int nwg, int stages) {
    return 2 * HG * nwg * TILE + stages * HG * HSTAGE +
           nwg * (DS_TILE + 64 * LDP * 4);
  }
  static constexpr bool fits(int nwg, int stages) {
    return bytes(nwg, stages) <= SMEM_LIMIT;
  }
  static constexpr int stages(int nwg) {
    return fits(nwg, 3) ? 3 : fits(nwg, 2) ? 2 : 1;
  }
  static constexpr int NWG = stages(2) > 1 ? 2 : 1;
  static constexpr int STAGES = stages(NWG);
  static constexpr int SMEM = bytes(NWG, STAGES);
};

// P (or dS) accumulator of a 64 x 64 product -> the A fragments of the
// four k16 steps of the next product, rounded to bf16
__device__ __forceinline__ void to_a_frags(uint32_t (&a)[4][4],
                                           const float (&p)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      a[kk][i] = hop::pack_bf16(p[8 * kk + 2 * i], p[8 * kk + 2 * i + 1]);
}

// acc (64 x N) += A (64 x 64, four fragments) B (64 x N): B is a 64-row
// tile read MN-major from column `c0` on
template <int DP, int N>
__device__ __forceinline__ void mma_rows(float (&acc)[N / 2],
                                         const uint32_t (&a)[4][4],
                                         uint32_t tile, int c0) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
    Wgmma<N>::rs(acc, a[kk],
                 hop::desc_mnmajor<DP>(tile + (c0 / 8) * 128 +
                                       kk * 2 * DP * 16), 1);
}

// s (64 x 64) = A B^T over the padded head dim, both 64-row tiles K-major
template <int DP>
__device__ __forceinline__ void mma_abt(float (&s)[32], uint32_t a,
                                        uint32_t b) {
#pragma unroll
  for (int kc = 0; kc < DP / 16; ++kc)
    Wgmma<64>::ss(s, hop::desc_kmajor<DP>(a + kc * 256),
                  hop::desc_kmajor<DP>(b + kc * 256), kc > 0);
}

// the 128 threads of warpgroup `wg` meet (barrier 0 is __syncthreads)
__device__ __forceinline__ void wg_barrier(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(wg + 1) : "memory");
}

// blockIdx.x = K/V row block * (DP / DS) + slice; blockIdx.y = head group;
// blockIdx.z = token group.
template <int DP, int HG, bool SEQ>
__global__ void __launch_bounds__(128 * Plan<DP, HG>::NWG)
bwd_fused_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dd, float* __restrict__ dq,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int M,
                      int Sk, int kv_len, int H, int D, float scale) {
  using P = Plan<DP, HG>;
  constexpr int NWG = P::NWG, STAGES = P::STAGES, DS = P::DS, NS = DP / DS;
  constexpr int TILE = P::TILE, HSTAGE = P::HSTAGE, LDP = P::LDP;
  constexpr int NT = 128 * NWG, RING = 2 * HG * NWG * TILE;
  constexpr int STAGE_END = RING + STAGES * HG * HSTAGE;
  static_assert(!SEQ || HG == 1, "b0 is one head a block");
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t base = hop::smem_u32(smem);
  auto skh = [&](int hh) { return base + hh * NWG * TILE; };
  auto svh = [&](int hh) { return base + (HG + hh) * NWG * TILE; };
  auto sq = [&](int i, int hh) {  // Q of head slot hh, query tile i
    return base + RING + (i % STAGES) * HG * HSTAGE + hh * HSTAGE;
  };
  auto so = [&](int i, int hh) { return sq(i, hh) + TILE; };
  auto sl = [&](int i, int hh) {  // lse[64], then dd[64]
    return reinterpret_cast<const float*>(
        smem + RING + (i % STAGES) * HG * HSTAGE + hh * HSTAGE + 2 * TILE);
  };
  float* part = reinterpret_cast<float*>(smem + STAGE_END + NWG * DS_TILE);

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int k0 = (blockIdx.x / NS) * 64 * NWG, c0 = (blockIdx.x % NS) * DS;
  const int h0 = blockIdx.y * HG, grp = blockIdx.z;
  const int C = H * D;
  // head slot hh computes head min(h0 + hh, H - 1); only real heads write
  auto head = [&](int hh) { return min(h0 + hh, H - 1); };
  const size_t qbase = (size_t)grp * M * C, kbase = (size_t)grp * Sk * C;
  const size_t lbase = (size_t)grp * M * H;
  const int n = (M + 63) / 64;  // query tiles
  const uint32_t kw = wg * TILE;  // this warpgroup's rows in a K/V tile
  const uint32_t sds = base + STAGE_END + wg * DS_TILE;

  auto load_q = [&](int i) {  // query tile i of every head slot into stage i
    const int m0 = i * 64;
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      const size_t off = qbase + head(hh) * D;
      hop::load_tile_async<DP, NT>(sq(i, hh), q + off, m0, M, C, D, tid);
      hop::load_tile_async<DP, NT>(so(i, hh), dout + off, m0, M, C, D, tid);
    }
#pragma unroll
    for (int t = tid; t < 128 * HG; t += NT) {
      const int hh = t >> 7, w = t & 127, r = m0 + (w & 63);
      const float* lg = lse + lbase + head(hh);
      const float* src = (w < 64 ? lg : dd + lbase + head(hh)) + (size_t)r * H;
      hop::cp_async4(sq(i, hh) + 2 * TILE + w * 4, r < M ? src : lg, r < M);
    }
  };

#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    const size_t off = kbase + head(hh) * D;
    hop::load_tile_async<DP, NT, 64 * NWG>(skh(hh), k + off, k0, kv_len, C,
                                           D, tid);
    hop::load_tile_async<DP, NT, 64 * NWG>(svh(hh), v + off, k0, kv_len, C,
                                           D, tid);
  }
  if constexpr (STAGES > 1) {
#pragma unroll
    for (int i = 0; i < STAGES - 1; ++i) {
      if (i < n) load_q(i);
      hop::cp_commit();
    }
    hop::cp_wait<STAGES - 2>();
    hop::fence_async_smem();
    __syncthreads();
  } else {
    hop::cp_commit();  // K/V; the loop waits for it with query tile 0
  }

  // this thread's K/V rows
  const int j0 = k0 + wg * 64 + warp * 16 + g, j1 = j0 + 8;
  const bool rows_edge = k0 + wg * 64 + 64 > kv_len;
  const float sl2e = scale * hop::LOG2E;
  // S^T -> P^T in place (masked past M and past kv_len): B5's statements
  auto probs = [&](float (&s)[32], int i, int hh) {
    const float* ls = sl(i, hh);
    const int m0 = i * 64;
    const bool cols_edge = m0 + 64 > M;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = 8 * j + 2 * t4;
      const float2 lm = *reinterpret_cast<const float2*>(ls + m);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i4 = 4 * j + e;
        float p = hop::ex2(fmaf(s[i4], sl2e,
                                -(e & 1 ? lm.y : lm.x) * hop::LOG2E));
        if ((cols_edge && m0 + m + (e & 1) >= M) ||
            (rows_edge && (e < 2 ? j0 : j1) >= kv_len))
          p = 0.f;
        s[i4] = p;
      }
    }
  };
  // (dO V^T)^T -> dS^T in place, from P^T
  auto dscores = [&](float (&dp)[32], const float (&s)[32], int i, int hh) {
    const float* ds = sl(i, hh) + 64;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 dm = *reinterpret_cast<const float2*>(ds + 8 * j + 2 * t4);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i4 = 4 * j + e;
        dp[i4] = s[i4] * (dp[i4] - (e & 1 ? dm.y : dm.x)) * scale;
      }
    }
  };

  float ak[HG][DS / 2], av[HG][DS / 2];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int i = 0; i < DS / 2; ++i) ak[hh][i] = av[hh][i] = 0.f;
  float s[HG][32], dp[HG][32];
  uint32_t pa[4][4], da[4][4];
  for (int i = 0; i < n; ++i) {
    if constexpr (STAGES > 1) {
      if (i > 0) {
        hop::cp_wait<STAGES - 2>();  // query tile i
        hop::fence_async_smem();
        __syncthreads();             // ... and every warp is done with i - 1
      }
      if (i + STAGES - 1 < n) load_q(i + STAGES - 1);
      hop::cp_commit();
    } else {
      if (i > 0) __syncthreads();    // every warp is done with i - 1
      load_q(i);
      hop::cp_commit();
      hop::cp_wait<0>();
      hop::fence_async_smem();
      __syncthreads();
    }
    if constexpr (SEQ) {  // b0: the exp between the two logit products
      hop::wg_fence();
      mma_abt<DP>(s[0], skh(0) + kw, sq(i, 0));
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(s[0]);
      probs(s[0], i, 0);
      hop::wg_fence();
      mma_abt<DP>(dp[0], svh(0) + kw, so(i, 0));
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(dp[0]);
      dscores(dp[0], s[0], i, 0);
    } else {  // every head's S^T and (dO V^T)^T first
      hop::wg_fence();
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        mma_abt<DP>(s[hh], skh(hh) + kw, sq(i, hh));
        mma_abt<DP>(dp[hh], svh(hh) + kw, so(i, hh));
      }
      hop::wg_commit();
      hop::wg_wait<0>();
#pragma unroll
      for (int hh = 0; hh < HG; ++hh) {
        hop::fence_regs(s[hh]);
        hop::fence_regs(dp[hh]);
      }
    }
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      if constexpr (!SEQ) {
        probs(s[hh], i, hh);
        dscores(dp[hh], s[hh], i, hh);
      }
      to_a_frags(pa, s[hh]);
      to_a_frags(da, dp[hh]);
      // dS^T, rounded, as this warpgroup's [key][query] tile, stored before
      // the products read da (no register of an in-flight wgmma is touched):
      // da[kk][e] holds key row 16 warp + g + 8 (e % 2), query columns
      // 16 kk + 8 (e / 2) + 2 t4 and the next
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = warp * 16 + g + 8 * (e & 1);
          const int c = 16 * kk + 8 * (e >> 1) + 2 * t4;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(
                           sds + (r >> 3) * 1024 + (c >> 3) * 128 +
                           (r & 7) * 16 + (c & 7) * 2),
                       "r"(da[kk][e])
                       : "memory");
        }
      hop::fence_async_smem();
      hop::wg_fence();
      mma_rows<DP, DS>(av[hh], pa, so(i, hh), c0);
      mma_rows<DP, DS>(ak[hh], da, sq(i, hh), c0);
      hop::wg_commit();
      wg_barrier(wg);
      // dQ (64 queries x DS) = dS (queries x this warpgroup's 64 keys) K
      float dqa[DS / 2];
      hop::wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        Wgmma<DS>::ss_mn(dqa, hop::desc_mnmajor<64>(sds + kk * 2 * 1024),
                         hop::desc_mnmajor<DP>(skh(hh) + kw + (c0 / 8) * 128 +
                                               kk * 2 * DP * 16),
                         kk > 0);
      hop::wg_commit();
      hop::wg_wait<0>();
      hop::fence_regs(av[hh]);
      hop::fence_regs(ak[hh]);
      hop::fence_regs(dqa);
      float* pw = part + wg * 64 * LDP;
#pragma unroll
      for (int j = 0; j < DS / 8; ++j) {
        const int r = warp * 16 + g, c = 8 * j + 2 * t4;
        *reinterpret_cast<float2*>(pw + r * LDP + c) =
            make_float2(dqa[4 * j], dqa[4 * j + 1]);
        *reinterpret_cast<float2*>(pw + (r + 8) * LDP + c) =
            make_float2(dqa[4 * j + 2], dqa[4 * j + 3]);
      }
      __syncthreads();
      if (h0 + hh < H) {  // the warpgroups' sum, added into dq
        float* dqh = dq + qbase + (h0 + hh) * D + c0;
#pragma unroll
        for (int t = tid; t < 64 * DS / 4; t += NT) {
          const int r = t / (DS / 4), c = (t % (DS / 4)) * 4;
          if (i * 64 + r < M && c0 + c < D) {
            float4 a = *reinterpret_cast<const float4*>(part + r * LDP + c);
            if (NWG == 2) {
              const float4 b = *reinterpret_cast<const float4*>(
                  part + (64 + r) * LDP + c);
              a.x += b.x;
              a.y += b.y;
              a.z += b.z;
              a.w += b.w;
            }
            // one 16-byte reduction (sm_90; its result unused: RED)
            atomicAdd(reinterpret_cast<float4*>(dqh + (size_t)(i * 64 + r) * C
                                                + c), a);
          }
        }
      }
      if (hh + 1 < HG) __syncthreads();  // the partials are free again
    }
  }

#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    if (h0 + hh >= H) continue;
    const size_t off = kbase + (h0 + hh) * D;
#pragma unroll
    for (int j = 0; j < DS / 8; ++j) {
      const int col = c0 + j * 8 + t4 * 2;
      if (col >= D) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = half ? j1 : j0;
        if (row >= Sk) continue;
        const size_t at = off + (size_t)row * C + col;
        const float* kr = ak[hh] + 4 * j + 2 * half;
        const float* vr = av[hh] + 4 * j + 2 * half;
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(kr[0], kr[1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(vr[0], vr[1]);
      }
    }
  }
}

// ---------------------------------------------------------------- fp32 ---

constexpr int T32 = 32, DMAX = 160, OPT = DMAX / 4;

__global__ void __launch_bounds__(128)
bwd_fused_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const float* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ dd,
                     float* __restrict__ dq, float* __restrict__ dk,
                     float* __restrict__ dv, int M, int Sk, int kv_len, int H,
                     int D, float scale, int hg) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Ks = reinterpret_cast<float*>(smem);     // [T32][D]
  float* Vs = Ks + T32 * D;                       // [T32][D]
  float* Qs = Vs + T32 * D;                       // [T32][D + 1]
  float* Os = Qs + T32 * (D + 1);                 // [T32][D + 1]
  float* Pt = Os + T32 * (D + 1);                 // [T32][T32 + 1]  P^T
  float* St = Pt + T32 * (T32 + 1);               // [T32][T32 + 1]  dS^T
  float* Ls = St + T32 * (T32 + 1);               // [T32]
  float* Ds = Ls + T32;                           // [T32]

  const int tid = threadIdx.x, j = tid >> 2, l4 = tid & 3;
  const int k0 = blockIdx.x * T32, grp = blockIdx.z;
  const int C = H * D;
  const bool row_ok = k0 + j < kv_len;

  for (int h = blockIdx.y * hg; h < min((int)(blockIdx.y + 1) * hg, H); ++h) {
    const size_t qoff = (size_t)grp * M * C + h * D;
    const size_t koff = (size_t)grp * Sk * C + h * D;
    const float* lg = lse + (size_t)grp * M * H + h;
    const float* dg = dd + (size_t)grp * M * H + h;

    __syncthreads();  // the previous head's reads are done
    for (int i = tid; i < T32 * D; i += blockDim.x) {
      const int jj = i / D, c = i % D;
      const bool ok = k0 + jj < kv_len;
      Ks[i] = ok ? k[koff + (size_t)(k0 + jj) * C + c] : 0.f;
      Vs[i] = ok ? v[koff + (size_t)(k0 + jj) * C + c] : 0.f;
    }

    float ak[OPT], av[OPT];
#pragma unroll
    for (int i = 0; i < OPT; ++i) ak[i] = av[i] = 0.f;

    for (int q0 = 0; q0 < M && k0 < kv_len; q0 += T32) {
      __syncthreads();
      for (int i = tid; i < T32 * D; i += blockDim.x) {
        const int m = i / D, c = i % D;
        const bool ok = q0 + m < M;
        Qs[m * (D + 1) + c] = ok ? q[qoff + (size_t)(q0 + m) * C + c] : 0.f;
        Os[m * (D + 1) + c] = ok ? dout[qoff + (size_t)(q0 + m) * C + c] : 0.f;
      }
      if (tid < T32) {
        const bool ok = q0 + tid < M;
        Ls[tid] = ok ? lg[(size_t)(q0 + tid) * H] : 0.f;
        Ds[tid] = ok ? dg[(size_t)(q0 + tid) * H] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int i = 0; i < T32 / 4; ++i) {
        const int m = l4 + 4 * i;
        float s = 0.f, dp = 0.f;
        for (int d = 0; d < D; ++d) {
          s = fmaf(Ks[j * D + d], Qs[m * (D + 1) + d], s);
          dp = fmaf(Vs[j * D + d], Os[m * (D + 1) + d], dp);
        }
        const float p = row_ok && q0 + m < M ? expf(s * scale - Ls[m]) : 0.f;
        Pt[j * (T32 + 1) + m] = p;
        St[j * (T32 + 1) + m] = p * (dp - Ds[m]) * scale;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < OPT; ++i) {
        const int d = l4 + 4 * i;
        if (d < D) {
          float a = ak[i], b = av[i];
          for (int m = 0; m < T32; ++m) {
            a = fmaf(St[j * (T32 + 1) + m], Qs[m * (D + 1) + d], a);
            b = fmaf(Pt[j * (T32 + 1) + m], Os[m * (D + 1) + d], b);
          }
          ak[i] = a;
          av[i] = b;
        }
      }
      // dQ rows of this tile: thread row `j` is query q0 + j here
      if (q0 + j < M) {
        float* og = dq + qoff + (size_t)(q0 + j) * C;
#pragma unroll
        for (int i = 0; i < OPT; ++i) {
          const int d = l4 + 4 * i;
          if (d < D) {
            float a = 0.f;
            for (int jj = 0; jj < T32; ++jj)
              a = fmaf(St[jj * (T32 + 1) + j], Ks[jj * D + d], a);
            atomicAdd(og + d, a);
          }
        }
      }
    }

    if (k0 + j < Sk) {
      float* kg = dk + koff + (size_t)(k0 + j) * C;
      float* vg = dv + koff + (size_t)(k0 + j) * C;
#pragma unroll
      for (int i = 0; i < OPT; ++i) {
        const int d = l4 + 4 * i;
        if (d < D) {
          kg[d] = ak[i];
          vg[d] = av[i];
        }
      }
    }
  }
}

// ------------------------------------------------------------- launches ---

struct Args {
  int G, M, Sk, kv_len, H, D;
  float scale;
  const void *q, *k, *v, *dout;
  const float *lse, *dd;
  float* dq;
  void *dk, *dv;
  cudaStream_t s;
};

template <typename K>
int set_smem(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int DP, int HG, bool SEQ>
int launch_bf16(const Args& a) {
  using P = Plan<DP, HG>;
  static_assert(P::SMEM <= SMEM_LIMIT, "no plan fits shared memory");
  int e = set_smem(bwd_fused_bf16_kernel<DP, HG, SEQ>, P::SMEM);
  if (e) return e;
  bwd_fused_bf16_kernel<DP, HG, SEQ>
      <<<dim3((a.Sk + 64 * P::NWG - 1) / (64 * P::NWG) * (DP / P::DS),
              (a.H + HG - 1) / HG, a.G),
         128 * P::NWG, P::SMEM, a.s>>>(
          (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
          (const bf16*)a.dout, a.lse, a.dd, a.dq, (bf16*)a.dk, (bf16*)a.dv,
          a.M, a.Sk, a.kv_len, a.H, a.D, a.scale);
  return (int)cudaGetLastError();
}

template <int DP>
int dispatch_bf16(int hg, bool seq, const Args& a) {
  if (seq) return hg == 1 ? launch_bf16<DP, 1, true>(a)
                          : (int)cudaErrorInvalidValue;
#define ASVA_HG(N)                                   \
  if constexpr (N * (64 + DP) <= 512) {              \
    if (hg == N) return launch_bf16<DP, N, false>(a); \
  }
  ASVA_HG(1) ASVA_HG(2) ASVA_HG(4)
#undef ASVA_HG
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, dout, dk, dv; lse, dd and the
// dq accumulator are fp32).  dq (G, M, H*D) fp32 must be zero on entry.
// heads: heads per block (1, 2, 4 with heads * (64 + padded head dim) <= 512;
// head dims: multiples of 8 whose width padded to 16 is 32, 48, 64, 80 or
// 160); seq != 0 (only with heads = 1) puts the exp between a head's two
// logit products.  1 <= kv_len <= Sk.  Returns cudaGetLastError() after the
// launch (0 = success).
extern "C" int asva_mha_bwd_fused(int dtype, int heads, int seq, int G, int M,
                                  int Sk, int kv_len, int H, int D,
                                  float scale, const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* dd, void* dq,
                                  void* dk, void* dv, void* stream) {
  if (D % 8 || D > DMAX || kv_len < 1 || kv_len > Sk || heads < 1 ||
      dq == nullptr || dk == nullptr || dv == nullptr)
    return (int)cudaErrorInvalidValue;
  const Args a = {G, M, Sk, kv_len, H, D, scale, q, k, v, dout,
                  (const float*)lse, (const float*)dd, (float*)dq, dk, dv,
                  (cudaStream_t)stream};
  if (dtype == 1) {
#define ASVA_CASE(DP) \
  case DP:            \
    return dispatch_bf16<DP>(heads, seq != 0, a);
    switch ((D + 15) / 16 * 16) {
      ASVA_CASE(32) ASVA_CASE(48) ASVA_CASE(64) ASVA_CASE(80) ASVA_CASE(160)
      default: return (int)cudaErrorInvalidValue;
    }
#undef ASVA_CASE
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  const int smem = (2 * T32 * D + 2 * T32 * (D + 1) + 2 * T32 * (T32 + 1) +
                    2 * T32) * (int)sizeof(float);
  int e = set_smem(bwd_fused_f32_kernel, smem);
  if (e) return e;
  bwd_fused_f32_kernel<<<dim3((Sk + T32 - 1) / T32, (H + heads - 1) / heads, G),
                         128, smem, a.s>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)dout,
      a.lse, a.dd, a.dq, (float*)dk, (float*)dv, M, Sk, kv_len, H, D, scale,
      heads);
  return (int)cudaGetLastError();
}
