// B5: flash backward of multi-head attention over K/V shared per token
// group, for sm_90a.  Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel _mha_bwd_kernel (asva_tpu/ops/
// pallas_fused.py:685), called by _mha_bwd_flat (:785).  Inputs on the flat
// layout of attn.cu: q, dO (G, M, H*D); k, v (G, Sk, H*D); lse, dd (G, M, H)
// fp32, where lse is the forward's log-sum-exp and dd = rowsum(dO * O) per
// head, computed by the caller.  Per head:
//
//   S  = Q K^T * scale          (columns >= kv_len masked: P = 0 there)
//   P  = exp(S - lse)
//   dS = P * (dO V^T - dd) * scale
//   dQ = dS K      dK = dS^T Q      dV = P^T dO
//
// The Pallas grid walks the query tiles in order and accumulates dK/dV in
// VMEM-resident fp32 blocks.  Blocks run in parallel here, so the work is
// split into two kernels and needs no atomics:
//   * dQ:    one block per (query tile, head, group) loops over K/V tiles;
//   * dK/dV: one block per (K/V tile, head, group) loops over query tiles
//            and computes S^T = K Q^T directly, so no transpose is needed.
// Both recompute S and dO V^T; every accumulator is fp32 in registers over
// the whole loop and is cast once at the store (pallas :726, :811).  dS is
// rounded to q's dtype and P to v's dtype before the three products that
// consume them (pallas :722-723).  Rows of dK/dV in [kv_len, Sk) are zero.
//
// bf16: every product on wgmma, each warpgroup (128 threads) owning 64
// rows, two warpgroups a block sharing the streamed tiles (one in a dK/dV
// block when Sk <= 64).  S and dO V^T (or their transposes) are m64n64k16
// with both operands K-major in shared memory; dS and P go from the
// accumulator registers straight into the A fragments of the products that
// consume them, whose B operand (K, Q or dO) is read MN-major through its
// descriptor: no operand is transposed by hand and no 16-bit shared load
// remains.  The streamed operands (K/V in the dQ kernel; Q, dO, lse and dd
// in the dK/dV kernel) come through a 3-stage cp.async ring, so the next
// tiles' copies overlap this tile's products.  P is exp2 of one FMA (scale
// * log2 e folded in, lse converted to base 2 once per row).  Head tiles are
// padded to a multiple of 16 with zero-filled copies and the padding is
// never stored.  For head tiles wider than 96 the dK/dV kernel splits the
// head dim over two blocks (each recomputes S^T) so that its two
// accumulators stay in registers.  With few K/V rows (77 text or 25 audio
// tokens: one or two K/V tiles a head) the dK/dV grid would leave most of
// the 132 SMs idle while each block walks every query tile; the caller then
// asks for `nsplit` query ranges, each block stores fp32 partial sums, and
// a second kernel adds them in a fixed order and casts once (no atomics:
// the result does not depend on timing).
// fp32: a plain FMA path, 32 rows x 4 threads each, for the fp32 checks.
//
// What bounds it on the H100: seven products per tile pair (S and dO V^T
// are computed in both kernels) against the five the algorithm needs, with
// a short contraction (48 at d = 40) beside 4096 exp2 per 64 x 64 tile.  At
// the training attn1 (M 12288, Sk 1024, d 40, 32 heads) the five products
// are 161 GFLOP, 0.163 ms at the bf16 peak: the exp/softmax issue rate and
// the copy latency bound it, not the tensor cores, as in the forward.  The
// two-kernel form stays: five products with dQ atomics only tied seven at
// Sk 1024 and lost at few K/V rows (T2b, PERF.md).  Inside each tile the
// elementwise work waits on two products and feeds the next two; issuing
// the next tile's logit products first keeps two S/dP pairs live, which
// costs the blocks an SM holds more than it overlaps (see the schedule
// below), so the overlap comes from the other blocks and warpgroups on the
// SM, and the split above keeps the SMs full.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

// ---------------------------------------------------------------- bf16 ---

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

// The two kernels share one schedule.  NWG warpgroups (128 threads each) per
// block own 64 rows each (query rows for dQ, K/V rows for dK/dV) and share
// the tiles that stream past them through a STAGES-deep cp.async ring.  Per
// streamed tile i each warpgroup runs the two logit-shaped products (S and
// dO V^T, or their transposes), the elementwise work on their accumulators,
// then the products that consume P and dS.  Iteration i opens with a block
// barrier once tile i has landed; by then every warp is done with tile
// i - 1, whose stage takes the copy of tile i + STAGES - 1, so two tiles'
// copies are in flight during each tile's products.  Issuing tile i + 1's
// logit products before tile i's consuming ones (software pipelining inside
// the warpgroup) was measured slower: it keeps a second S/dP pair live,
// 130 instead of 117 registers in the dQ kernel at d = 40, which halves the
// blocks an SM holds (PERF.md).
constexpr int STAGES = 3;

// dQ: Q and dO stay in shared memory, K/V tiles stream.
template <int DP, int NWG>
__global__ void __launch_bounds__(128 * NWG)
bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dd,
                   bf16* __restrict__ dq, int M, int Sk, int kv_len, int H,
                   int D, float scale) {
  constexpr int TILE = 64 * DP * 2, NT = 128 * NWG;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sq = hop::smem_u32(smem), so = sq + NWG * TILE;
  auto sk = [&](int t) { return sq + TILE * (2 * NWG + 2 * (t % STAGES)); };
  auto sv = [&](int t) { return sk(t) + TILE; };

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * 64 * NWG, h = blockIdx.y, grp = blockIdx.z;
  const int C = H * D;
  const size_t qoff = (size_t)grp * M * C + h * D;
  const size_t koff = (size_t)grp * Sk * C + h * D;
  const int ntiles = (kv_len + 63) / 64;
  const uint32_t sqw = sq + wg * TILE, sow = so + wg * TILE;
  auto load_kv = [&](int t) {
    hop::load_tile_async<DP, NT>(sk(t), k + koff, t * 64, kv_len, C, D, tid);
    hop::load_tile_async<DP, NT>(sv(t), v + koff, t * 64, kv_len, C, D, tid);
  };

  hop::load_tile_async<DP, NT, 64 * NWG>(sq, q + qoff, q0, M, C, D, tid);
  hop::load_tile_async<DP, NT, 64 * NWG>(so, dout + qoff, q0, M, C, D, tid);
#pragma unroll
  for (int t = 0; t < STAGES - 1; ++t) {
    if (t < ntiles) load_kv(t);
    hop::cp_commit();
  }

  const int r0 = q0 + wg * 64 + warp * 16 + g, r1 = r0 + 8;
  const float* lg = lse + (size_t)grp * M * H + h;
  const float* dg = dd + (size_t)grp * M * H + h;
  const float l0 = r0 < M ? lg[(size_t)r0 * H] * hop::LOG2E : 0.f;
  const float l1 = r1 < M ? lg[(size_t)r1 * H] * hop::LOG2E : 0.f;
  const float d0 = r0 < M ? dg[(size_t)r0 * H] : 0.f;
  const float d1 = r1 < M ? dg[(size_t)r1 * H] : 0.f;
  const float sl2e = scale * hop::LOG2E;
  hop::cp_wait<STAGES - 2>();
  hop::fence_async_smem();
  __syncthreads();

  float s[32], dp[32];
  auto grad_s = [&](int t) {  // s, dp (tile t) -> dS in s
    const bool edge = (t + 1) * 64 > kv_len;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * j + e;
        float p = hop::ex2(fmaf(s[i], sl2e, -(e < 2 ? l0 : l1)));
        if (edge && t * 64 + 8 * j + 2 * t4 + (e & 1) >= kv_len) p = 0.f;
        s[i] = p * (dp[i] - (e < 2 ? d0 : d1)) * scale;
      }
  };

  float acc[DP / 2];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  uint32_t a[4][4];
  for (int t = 0; t < ntiles; ++t) {
    if (t > 0) {
      hop::cp_wait<STAGES - 2>();  // tile t
      hop::fence_async_smem();
      __syncthreads();             // ... and every warp is done with t - 1
    }
    if (t + STAGES - 1 < ntiles) load_kv(t + STAGES - 1);
    hop::cp_commit();
    hop::wg_fence();               // S = Q K_t^T, dP = dO V_t^T
    mma_abt<DP>(s, sqw, sk(t));
    mma_abt<DP>(dp, sow, sv(t));
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(s);
    hop::fence_regs(dp);
    grad_s(t);
    to_a_frags(a, s);
    hop::wg_fence();
    mma_rows<DP, DP>(acc, a, sk(t), 0);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(acc);
  }

  bf16* og = dq + qoff;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = j * 8 + t4 * 2;
    if (col < D) {
      if (r0 < M)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r0 * C + col) =
            __floats2bfloat162_rn(acc[4 * j], acc[4 * j + 1]);
      if (r1 < M)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r1 * C + col) =
            __floats2bfloat162_rn(acc[4 * j + 2], acc[4 * j + 3]);
    }
  }
}

// dK/dV: K and V stay in shared memory while Q, dO, lse and dd stream; a
// block's warpgroups own 64 K/V rows each of one head and DS columns of its
// head dim.  blockIdx.x = K/V row block * (DP / DS) + slice; blockIdx.z =
// group * nsplit + split: split s of nsplit walks only its share of the
// query tiles and, when nsplit > 1, stores its fp32 partial dK/dV into
// ws[0 or 1][s] for bwd_dkv_sum_kernel instead of the bf16 dk/dv.
template <int DP, int DS, int NWG>
__global__ void __launch_bounds__(128 * NWG)
bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    bf16* __restrict__ dk, bf16* __restrict__ dv,
                    float* __restrict__ ws, int nsplit, int M, int Sk,
                    int kv_len, int H, int D, float scale) {
  constexpr int TILE = 64 * DP * 2, NS = DP / DS, NT = 128 * NWG;
  constexpr int STAGE = 2 * TILE + 2 * 64 * 4;  // Q, dO, lse, dd
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t sk = hop::smem_u32(smem), sv = sk + NWG * TILE;
  const uint32_t ring = sk + 2 * NWG * TILE;
  auto sq = [&](int i) { return ring + STAGE * (i % STAGES); };
  auto so = [&](int i) { return sq(i) + TILE; };
  auto sl = [&](int i) {  // lse[64], then dd[64], of stage i
    return reinterpret_cast<const float*>(
        smem + 2 * NWG * TILE + STAGE * (i % STAGES) + 2 * TILE);
  };

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int k0 = (blockIdx.x / NS) * 64 * NWG, c0 = (blockIdx.x % NS) * DS;
  const int h = blockIdx.y, grp = blockIdx.z / nsplit;
  const int split = blockIdx.z % nsplit;
  const int C = H * D;
  const size_t qoff = (size_t)grp * M * C + h * D;
  const size_t koff = (size_t)grp * Sk * C + h * D;
  const float* lg = lse + (size_t)grp * M * H + h;
  const float* dg = dd + (size_t)grp * M * H + h;
  const int qtiles = (M + 63) / 64, per = (qtiles + nsplit - 1) / nsplit;
  const int qt0 = min(qtiles, split * per), qt1 = min(qtiles, qt0 + per);
  const int n = qt1 - qt0;
  const uint32_t skw = sk + wg * TILE, svw = sv + wg * TILE;

  auto load_q = [&](int i) {  // query tile qt0 + i into stage i
    const int m0 = (qt0 + i) * 64;
    hop::load_tile_async<DP, NT>(sq(i), q + qoff, m0, M, C, D, tid);
    hop::load_tile_async<DP, NT>(so(i), dout + qoff, m0, M, C, D, tid);
    if (tid < 128) {
      const int r = m0 + (tid & 63);
      const float* src = (tid < 64 ? lg : dg) + (size_t)r * H;
      hop::cp_async4(sq(i) + 2 * TILE + tid * 4, r < M ? src : lg, r < M);
    }
  };

  hop::load_tile_async<DP, NT, 64 * NWG>(sk, k + koff, k0, kv_len, C, D, tid);
  hop::load_tile_async<DP, NT, 64 * NWG>(sv, v + koff, k0, kv_len, C, D, tid);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < n) load_q(i);
    hop::cp_commit();
  }
  hop::cp_wait<STAGES - 2>();
  hop::fence_async_smem();
  __syncthreads();

  // this thread's K/V rows
  const int j0 = k0 + wg * 64 + warp * 16 + g, j1 = j0 + 8;
  const bool rows_edge = k0 + wg * 64 + 64 > kv_len;
  const float sl2e = scale * hop::LOG2E;
  float s[32], dp[32];  // S^T and (dO V^T)^T: rows K/V, columns queries
  auto grad_s = [&](int i) {  // s, dp (tile i) -> P^T in s, dS^T in dp
    const float* ls = sl(i);
    const float* ds = ls + 64;
    const int m0 = (qt0 + i) * 64;
    const bool cols_edge = m0 + 64 > M;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int m = 8 * j + 2 * t4;
      const float2 lm = *reinterpret_cast<const float2*>(ls + m);
      const float2 dm = *reinterpret_cast<const float2*>(ds + m);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i4 = 4 * j + e;
        float p = hop::ex2(fmaf(s[i4], sl2e,
                                -(e & 1 ? lm.y : lm.x) * hop::LOG2E));
        if ((cols_edge && m0 + m + (e & 1) >= M) ||
            (rows_edge && (e < 2 ? j0 : j1) >= kv_len))
          p = 0.f;
        s[i4] = p;
        dp[i4] = p * (dp[i4] - (e & 1 ? dm.y : dm.x)) * scale;
      }
    }
  };

  float ak[DS / 2], av[DS / 2];
#pragma unroll
  for (int i = 0; i < DS / 2; ++i) ak[i] = av[i] = 0.f;
  uint32_t pa[4][4], da[4][4];
  for (int i = 0; i < n; ++i) {
    if (i > 0) {
      hop::cp_wait<STAGES - 2>();  // query tile i
      hop::fence_async_smem();
      __syncthreads();             // ... and every warp is done with i - 1
    }
    if (i + STAGES - 1 < n) load_q(i + STAGES - 1);
    hop::cp_commit();
    hop::wg_fence();               // S^T = K Q_i^T, dP^T = V dO_i^T
    mma_abt<DP>(s, skw, sq(i));
    mma_abt<DP>(dp, svw, so(i));
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(s);
    hop::fence_regs(dp);
    grad_s(i);
    to_a_frags(pa, s);
    to_a_frags(da, dp);
    hop::wg_fence();
    mma_rows<DP, DS>(av, pa, so(i), c0);
    mma_rows<DP, DS>(ak, da, sq(i), c0);
    hop::wg_commit();
    hop::wg_wait<0>();
    hop::fence_regs(av);
    hop::fence_regs(ak);
  }

  const size_t n_all = (size_t)(gridDim.z / nsplit) * Sk * C;
  float* wk = ws + (size_t)split * n_all;
  float* wv = ws + (size_t)(nsplit + split) * n_all;
#pragma unroll
  for (int j = 0; j < DS / 8; ++j) {
    const int col = c0 + j * 8 + t4 * 2;
    if (col >= D) continue;
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = half ? j1 : j0;
      if (row >= Sk) continue;
      const size_t at = koff + (size_t)row * C + col;
      const float* kr = ak + 4 * j + 2 * half;
      const float* vr = av + 4 * j + 2 * half;
      if (nsplit == 1) {
        *reinterpret_cast<__nv_bfloat162*>(dk + at) =
            __floats2bfloat162_rn(kr[0], kr[1]);
        *reinterpret_cast<__nv_bfloat162*>(dv + at) =
            __floats2bfloat162_rn(vr[0], vr[1]);
      } else {
        *reinterpret_cast<float2*>(wk + at) = make_float2(kr[0], kr[1]);
        *reinterpret_cast<float2*>(wv + at) = make_float2(vr[0], vr[1]);
      }
    }
  }
}

// dk, dv (n elements each) = the sums over the nsplit fp32 partials, in
// split order; n is a multiple of 4
__global__ void bwd_dkv_sum_kernel(const float* __restrict__ ws,
                                   bf16* __restrict__ dk,
                                   bf16* __restrict__ dv, int nsplit,
                                   size_t n) {
  for (size_t i = (blockIdx.x * (size_t)blockDim.x + threadIdx.x) * 4; i < n;
       i += (size_t)gridDim.x * blockDim.x * 4) {
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* src = ws + (size_t)which * nsplit * n + i;
      float4 a = *reinterpret_cast<const float4*>(src);
      for (int s = 1; s < nsplit; ++s) {
        const float4 b = *reinterpret_cast<const float4*>(src + s * n);
        a.x += b.x;
        a.y += b.y;
        a.z += b.z;
        a.w += b.w;
      }
      bf16* dst = (which ? dv : dk) + i;
      *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(a.x, a.y);
      *reinterpret_cast<__nv_bfloat162*>(dst + 2) =
          __floats2bfloat162_rn(a.z, a.w);
    }
  }
}

// ---------------------------------------------------------------- fp32 ---

constexpr int T32 = 32, DMAX = 160, OPT = DMAX / 4;

__global__ void __launch_bounds__(128)
bwd_dq_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const float* __restrict__ lse, const float* __restrict__ dd,
                  float* __restrict__ dq, int M, int Sk, int kv_len, int H,
                  int D, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);     // [T32][D]
  float* Os = Qs + T32 * D;                       // [T32][D]
  float* Ks = Os + T32 * D;                       // [T32][D + 1]
  float* Vs = Ks + T32 * (D + 1);                 // [T32][D + 1]
  float* Ps = Vs + T32 * (D + 1);                 // [T32][T32 + 1]

  const int tid = threadIdx.x, r = tid >> 2, l4 = tid & 3;
  const int q0 = blockIdx.x * T32, h = blockIdx.y, grp = blockIdx.z;
  const int C = H * D;
  const size_t qoff = (size_t)grp * M * C + h * D;
  const size_t koff = (size_t)grp * Sk * C + h * D;

  for (int i = tid; i < T32 * D; i += blockDim.x) {
    const int rr = i / D, c = i % D;
    const bool ok = q0 + rr < M;
    Qs[i] = ok ? q[qoff + (size_t)(q0 + rr) * C + c] : 0.f;
    Os[i] = ok ? dout[qoff + (size_t)(q0 + rr) * C + c] : 0.f;
  }
  const bool row_ok = q0 + r < M;
  const size_t sidx = ((size_t)grp * M + q0 + r) * H + h;
  const float lr = row_ok ? lse[sidx] : 0.f;
  const float dr = row_ok ? dd[sidx] : 0.f;

  float acc[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) acc[i] = 0.f;

  const int ntiles = (kv_len + T32 - 1) / T32;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * T32;
    __syncthreads();
    for (int i = tid; i < T32 * D; i += blockDim.x) {
      const int j = i / D, c = i % D;
      const bool ok = k0 + j < kv_len;
      Ks[j * (D + 1) + c] = ok ? k[koff + (size_t)(k0 + j) * C + c] : 0.f;
      Vs[j * (D + 1) + c] = ok ? v[koff + (size_t)(k0 + j) * C + c] : 0.f;
    }
    __syncthreads();

#pragma unroll
    for (int i = 0; i < T32 / 4; ++i) {
      const int j = l4 + 4 * i;
      float s = 0.f, dp = 0.f;
      for (int d = 0; d < D; ++d) {
        s = fmaf(Qs[r * D + d], Ks[j * (D + 1) + d], s);
        dp = fmaf(Os[r * D + d], Vs[j * (D + 1) + d], dp);
      }
      const float p = k0 + j < kv_len ? expf(s * scale - lr) : 0.f;
      Ps[r * (T32 + 1) + j] = p * (dp - dr) * scale;
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < OPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) {
        float a = acc[i];
        for (int j = 0; j < T32; ++j)
          a = fmaf(Ps[r * (T32 + 1) + j], Ks[j * (D + 1) + d], a);
        acc[i] = a;
      }
    }
  }

  if (row_ok) {
    float* og = dq + qoff + (size_t)(q0 + r) * C;
#pragma unroll
    for (int i = 0; i < OPT; ++i) {
      const int d = l4 + 4 * i;
      if (d < D) og[d] = acc[i];
    }
  }
}

__global__ void __launch_bounds__(128)
bwd_dkv_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                   const float* __restrict__ v, const float* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dd,
                   float* __restrict__ dk, float* __restrict__ dv, int M,
                   int Sk, int kv_len, int H, int D, float scale) {
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
  const int k0 = blockIdx.x * T32, h = blockIdx.y, grp = blockIdx.z;
  const int C = H * D;
  const size_t qoff = (size_t)grp * M * C + h * D;
  const size_t koff = (size_t)grp * Sk * C + h * D;
  const float* lg = lse + (size_t)grp * M * H + h;
  const float* dg = dd + (size_t)grp * M * H + h;

  for (int i = tid; i < T32 * D; i += blockDim.x) {
    const int jj = i / D, c = i % D;
    const bool ok = k0 + jj < kv_len;
    Ks[i] = ok ? k[koff + (size_t)(k0 + jj) * C + c] : 0.f;
    Vs[i] = ok ? v[koff + (size_t)(k0 + jj) * C + c] : 0.f;
  }
  const bool row_ok = k0 + j < kv_len;

  float ak[OPT], av[OPT];
#pragma unroll
  for (int i = 0; i < OPT; ++i) ak[i] = av[i] = 0.f;

  for (int q0 = 0; q0 < M; q0 += T32) {
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
    __syncwarp();
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

// ------------------------------------------------------------- launches ---

struct Args {
  int G, M, Sk, kv_len, H, D;
  float scale;
  const void *q, *k, *v, *dout;
  const float *lse, *dd;
  void *dq, *dk, *dv;
  int nsplit;
  float* ws;
  cudaStream_t s;
};

template <typename K>
int set_smem(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

// NWK: warpgroups (64 K/V rows each) of a dK/dV block
template <int DP, int NWK>
int launch_bf16(const Args& a) {
  constexpr int NWG = 2;  // dQ: 128 query rows a block share each K/V tile
  // head tiles wider than 96 keep half the dK/dV accumulators per block
  constexpr int DS = DP > 96 ? DP / 2 : DP;
  static_assert(DS % 8 == 0, "dK/dV head slice must be a multiple of 8");
  const int tile = 64 * DP * (int)sizeof(bf16);
  const int smem_q = (2 * NWG + 2 * STAGES) * tile;
  int e = set_smem(bwd_dq_bf16_kernel<DP, NWG>, smem_q);
  if (e) return e;
  bwd_dq_bf16_kernel<DP, NWG>
      <<<dim3((a.M + 64 * NWG - 1) / (64 * NWG), a.H, a.G), 128 * NWG,
         smem_q, a.s>>>(
          (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
          (const bf16*)a.dout, a.lse, a.dd, (bf16*)a.dq, a.M, a.Sk, a.kv_len,
          a.H, a.D, a.scale);
  e = (int)cudaGetLastError();
  if (e || a.dk == nullptr) return e;
  const int smem_kv = 2 * NWK * tile + STAGES * (2 * tile + 2 * 64 * 4);
  e = set_smem(bwd_dkv_bf16_kernel<DP, DS, NWK>, smem_kv);
  if (e) return e;
  bwd_dkv_bf16_kernel<DP, DS, NWK>
      <<<dim3((a.Sk + 64 * NWK - 1) / (64 * NWK) * (DP / DS), a.H,
              a.G * a.nsplit),
         128 * NWK, smem_kv, a.s>>>(
          (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
          (const bf16*)a.dout, a.lse, a.dd, (bf16*)a.dk, (bf16*)a.dv, a.ws,
          a.nsplit, a.M, a.Sk, a.kv_len, a.H, a.D, a.scale);
  e = (int)cudaGetLastError();
  if (e || a.nsplit == 1) return e;
  const size_t n = (size_t)a.G * a.Sk * a.H * a.D;
  const int blocks = (int)((n / 4 + 255) / 256 < 1024 ? (n / 4 + 255) / 256
                                                      : 1024);
  bwd_dkv_sum_kernel<<<blocks, 256, 0, a.s>>>(a.ws, (bf16*)a.dk,
                                              (bf16*)a.dv, a.nsplit, n);
  return (int)cudaGetLastError();
}

// Two warpgroups share each streamed query tile of a dK/dV block, halving
// its copies; with one K/V tile a head (Sk <= 64: audio, the 8x8 level) the
// second would have no rows, so the block is one warpgroup.
template <int DP>
int launch_bf16(const Args& a) {
  return a.Sk <= 64 ? launch_bf16<DP, 1>(a) : launch_bf16<DP, 2>(a);
}

int launch_f32(const Args& a) {
  const int D = a.D;
  const int smem_q = (2 * T32 * D + 2 * T32 * (D + 1) + T32 * (T32 + 1)) *
                     (int)sizeof(float);
  int e = set_smem(bwd_dq_f32_kernel, smem_q);
  if (e) return e;
  bwd_dq_f32_kernel<<<dim3((a.M + T32 - 1) / T32, a.H, a.G), 128, smem_q,
                      a.s>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, a.lse, a.dd, (float*)a.dq, a.M, a.Sk, a.kv_len,
      a.H, a.D, a.scale);
  e = (int)cudaGetLastError();
  if (e || a.dk == nullptr) return e;
  const int smem_kv = (2 * T32 * D + 2 * T32 * (D + 1) +
                       2 * T32 * (T32 + 1) + 2 * T32) * (int)sizeof(float);
  e = set_smem(bwd_dkv_f32_kernel, smem_kv);
  if (e) return e;
  bwd_dkv_f32_kernel<<<dim3((a.Sk + T32 - 1) / T32, a.H, a.G), 128, smem_kv,
                       a.s>>>(
      (const float*)a.q, (const float*)a.k, (const float*)a.v,
      (const float*)a.dout, a.lse, a.dd, (float*)a.dk, (float*)a.dv, a.M,
      a.Sk, a.kv_len, a.H, a.D, a.scale);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (of q, k, v, dout, dq, dk, dv; lse and dd
// are fp32).  D must be a multiple of 8 and at most 160; 1 <= kv_len <= Sk.
// dk and dv are both null (only dQ is computed) or both given.  nsplit >= 1
// splits the bf16 dK/dV kernel over that many query ranges; with nsplit > 1
// `ws` is fp32 scratch of 2 * nsplit * G * Sk * H * D elements (the fp32
// path ignores both).  The Python wrapper checks shapes, dtypes and
// contiguity and chooses nsplit.  Returns cudaGetLastError() after the
// launches (0 = success).
extern "C" int asva_mha_bwd_split(int dtype, int G, int M, int Sk,
                                  int kv_len, int H, int D, float scale,
                                  const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* dd, void* dq,
                                  void* dk, void* dv, int nsplit, void* ws,
                                  void* stream) {
  if (D % 8 || D > DMAX || kv_len < 1 || kv_len > Sk ||
      (dk == nullptr) != (dv == nullptr) || nsplit < 1 ||
      (dtype == 1 && nsplit > 1 && (ws == nullptr || dk == nullptr)))
    return (int)cudaErrorInvalidValue;
  const Args a = {G, M, Sk, kv_len, H, D, scale, q, k, v, dout,
                  (const float*)lse, (const float*)dd, dq, dk, dv,
                  dtype == 1 ? nsplit : 1, (float*)ws,
                  (cudaStream_t)stream};
  if (dtype == 1) {
#define ASVA_CASE(DP) \
  case DP:            \
    return launch_bf16<DP>(a);
    switch ((D + 15) / 16 * 16) {
      ASVA_CASE(16) ASVA_CASE(32) ASVA_CASE(48) ASVA_CASE(64) ASVA_CASE(80)
      ASVA_CASE(96) ASVA_CASE(112) ASVA_CASE(128) ASVA_CASE(144) ASVA_CASE(160)
      default: return (int)cudaErrorInvalidValue;
    }
#undef ASVA_CASE
  }
  if (dtype != 0) return (int)cudaErrorInvalidValue;
  return launch_f32(a);
}

// The same without the split (nsplit = 1).
extern "C" int asva_mha_bwd(int dtype, int G, int M, int Sk, int kv_len,
                            int H, int D, float scale, const void* q,
                            const void* k, const void* v, const void* dout,
                            const void* lse, const void* dd, void* dq,
                            void* dk, void* dv, void* stream) {
  return asva_mha_bwd_split(dtype, G, M, Sk, kv_len, H, D, scale, q, k, v,
                            dout, lse, dd, dq, dk, dv, 1, nullptr, stream);
}
