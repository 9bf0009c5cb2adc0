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
// bf16: mma.sync m16n8k16, 4 warps x 16 rows, 64 x 64 tiles; dS and P go
// from the accumulator registers straight into the A fragments of the next
// product.  The head tile is padded to a multiple of 16 with zeros and the
// padded columns are never stored.  For head tiles wider than 96 the dK/dV
// kernel splits the head dim over two blocks (each recomputes S^T) so that
// its two accumulators stay in registers.
// fp32: a plain FMA path, 32 rows x 4 threads each, for the fp32 checks.
//
// What bounds it on the H100: five matrix products per tile pair against
// three in the forward, with the same short contraction (K-dim 48 at
// d = 40), so the fp32 exp and the 16-bit shared loads of the transposed
// operands cost as much as the MMAs; with few K/V rows (Sk = 77, 25) the
// dK/dV kernel has few blocks with long loops.  This simple design does
// nothing about either yet.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
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

// ---------------------------------------------------------------- bf16 ---

constexpr int T16 = 64;  // rows of every bf16 tile (query and K/V)

// rows [row0, row0 + 64) x cols [0, DP) of a (rows, ld) head slice into
// dst[64][DP + 8]; rows >= nvalid and cols >= D are zero.
template <int DP>
__device__ __forceinline__ void load_tile(bf16* dst, const bf16* __restrict__ src,
                                          int row0, int nvalid, int ld, int D) {
  constexpr int CPR = DP / 8, LD = DP + 8;
  for (int c = threadIdx.x; c < T16 * CPR; c += blockDim.x) {
    const int r = c / CPR, col = (c % CPR) * 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (row0 + r < nvalid && col < D)
      v = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * ld + col);
    *reinterpret_cast<uint4*>(dst + r * LD + col) = v;
  }
}

// s (16 x 64, this warp's rows) = A[16 x DP] B[64 x DP]^T, both in shared
// memory with row stride DP + 8; `a` points at the warp's first row.
template <int DP>
__device__ __forceinline__ void mma_abt(float (&s)[8][4], const bf16* a,
                                        const bf16* b, int g, int t4) {
  constexpr int LD = DP + 8, KC = DP / 16;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc) {
    const bf16* ar = a + g * LD + kc * 16 + t4 * 2;
    uint32_t af[4];
    af[0] = *reinterpret_cast<const uint32_t*>(ar);
    af[1] = *reinterpret_cast<const uint32_t*>(ar + 8 * LD);
    af[2] = *reinterpret_cast<const uint32_t*>(ar + 8);
    af[3] = *reinterpret_cast<const uint32_t*>(ar + 8 * LD + 8);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* br = b + (nt * 8 + g) * LD + kc * 16 + t4 * 2;
      mma_bf16(s[nt], af, *reinterpret_cast<const uint32_t*>(br),
               *reinterpret_cast<const uint32_t*>(br + 8));
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

template <int DP>
__global__ void __launch_bounds__(128)
bwd_dq_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                   const bf16* __restrict__ v, const bf16* __restrict__ dout,
                   const float* __restrict__ lse, const float* __restrict__ dd,
                   bf16* __restrict__ dq, int M, int Sk, int kv_len, int H,
                   int D, float scale) {
  constexpr int LD = DP + 8, DT = DP / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Os = Qs + T16 * LD;
  bf16* Ks = Os + T16 * LD;
  bf16* Vs = Ks + T16 * LD;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * T16, h = blockIdx.y, grp = blockIdx.z;
  const int C = H * D;
  const size_t qoff = (size_t)grp * M * C + h * D;
  const size_t koff = (size_t)grp * Sk * C + h * D;

  load_tile<DP>(Qs, q + qoff, q0, M, C, D);
  load_tile<DP>(Os, dout + qoff, q0, M, C, D);

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
  const float* lg = lse + (size_t)grp * M * H + h;
  const float* dg = dd + (size_t)grp * M * H + h;
  const float l0 = r0 < M ? lg[(size_t)r0 * H] : 0.f;
  const float l1 = r1 < M ? lg[(size_t)r1 * H] : 0.f;
  const float d0 = r0 < M ? dg[(size_t)r0 * H] : 0.f;
  const float d1 = r1 < M ? dg[(size_t)r1 * H] : 0.f;

  float acc[DT][4];
#pragma unroll
  for (int dt = 0; dt < DT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dt][e] = 0.f;

  const int ntiles = (kv_len + T16 - 1) / T16;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * T16;
    __syncthreads();  // the previous tile's reads are done
    load_tile<DP>(Ks, k + koff, k0, kv_len, C, D);
    load_tile<DP>(Vs, v + koff, k0, kv_len, C, D);
    __syncthreads();

    float s[8][4], dp[8][4];
    mma_abt<DP>(s, Qs + warp * 16 * LD, Ks, g, t4);
    mma_abt<DP>(dp, Os + warp * 16 * LD, Vs, g, t4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
        const float lr = e < 2 ? l0 : l1, dr = e < 2 ? d0 : d1;
        const float p = col < kv_len ? expf(s[nt][e] * scale - lr) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dr) * scale;
      }
    mma_pb<LD, DT>(acc, s, Ks, g, t4);
  }

  bf16* og = dq + qoff;
#pragma unroll
  for (int dt = 0; dt < DT; ++dt) {
    const int col = dt * 8 + t4 * 2;
    if (col < D) {
      if (r0 < M)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r0 * C + col) =
            __floats2bfloat162_rn(acc[dt][0], acc[dt][1]);
      if (r1 < M)
        *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r1 * C + col) =
            __floats2bfloat162_rn(acc[dt][2], acc[dt][3]);
    }
  }
}

// DS: the width of the head-dim slice whose dK/dV this block accumulates;
// blockIdx.x = kv tile * (DP / DS) + slice.
template <int DP, int DS>
__global__ void __launch_bounds__(128)
bwd_dkv_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse, const float* __restrict__ dd,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int M,
                    int Sk, int kv_len, int H, int D, float scale) {
  constexpr int LD = DP + 8, NS = DP / DS, NT = DS / 8;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);
  bf16* Vs = Ks + T16 * LD;
  bf16* Qs = Vs + T16 * LD;
  bf16* Os = Qs + T16 * LD;
  float* Ls = reinterpret_cast<float*>(Os + T16 * LD);
  float* Ds = Ls + T16;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = (blockIdx.x / NS) * T16, c0 = (blockIdx.x % NS) * DS;
  const int h = blockIdx.y, grp = blockIdx.z;
  const int C = H * D;
  const size_t qoff = (size_t)grp * M * C + h * D;
  const size_t koff = (size_t)grp * Sk * C + h * D;
  const float* lg = lse + (size_t)grp * M * H + h;
  const float* dg = dd + (size_t)grp * M * H + h;

  load_tile<DP>(Ks, k + koff, k0, kv_len, C, D);
  load_tile<DP>(Vs, v + koff, k0, kv_len, C, D);

  float ak[NT][4], av[NT][4];
#pragma unroll
  for (int dt = 0; dt < NT; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) ak[dt][e] = av[dt][e] = 0.f;

  const int j0 = k0 + warp * 16 + g, j1 = j0 + 8;  // this thread's K/V rows
  for (int q0 = 0; q0 < M; q0 += T16) {
    __syncthreads();  // the previous tile's reads are done
    load_tile<DP>(Qs, q + qoff, q0, M, C, D);
    load_tile<DP>(Os, dout + qoff, q0, M, C, D);
    if (tid < T16) {
      const bool ok = q0 + tid < M;
      Ls[tid] = ok ? lg[(size_t)(q0 + tid) * H] : 0.f;
      Ds[tid] = ok ? dg[(size_t)(q0 + tid) * H] : 0.f;
    }
    __syncthreads();

    float st[8][4], dpt[8][4];  // S^T and (dO V^T)^T: rows K/V, cols queries
    mma_abt<DP>(st, Ks + warp * 16 * LD, Qs, g, t4);
    mma_abt<DP>(dpt, Vs + warp * 16 * LD, Os, g, t4);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = nt * 8 + t4 * 2 + (e & 1);
        const bool ok = q0 + m < M && (e < 2 ? j0 : j1) < kv_len;
        const float p = ok ? expf(st[nt][e] * scale - Ls[m]) : 0.f;
        st[nt][e] = p;
        dpt[nt][e] = p * (dpt[nt][e] - Ds[m]) * scale;
      }
    mma_pb<LD, NT>(av, st, Os + c0, g, t4);
    mma_pb<LD, NT>(ak, dpt, Qs + c0, g, t4);
  }

  bf16* kg = dk + koff;
  bf16* vg = dv + koff;
#pragma unroll
  for (int dt = 0; dt < NT; ++dt) {
    const int col = c0 + dt * 8 + t4 * 2;
    if (col < D) {
      if (j0 < Sk) {
        *reinterpret_cast<__nv_bfloat162*>(kg + (size_t)j0 * C + col) =
            __floats2bfloat162_rn(ak[dt][0], ak[dt][1]);
        *reinterpret_cast<__nv_bfloat162*>(vg + (size_t)j0 * C + col) =
            __floats2bfloat162_rn(av[dt][0], av[dt][1]);
      }
      if (j1 < Sk) {
        *reinterpret_cast<__nv_bfloat162*>(kg + (size_t)j1 * C + col) =
            __floats2bfloat162_rn(ak[dt][2], ak[dt][3]);
        *reinterpret_cast<__nv_bfloat162*>(vg + (size_t)j1 * C + col) =
            __floats2bfloat162_rn(av[dt][2], av[dt][3]);
      }
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
  cudaStream_t s;
};

template <typename K>
int set_smem(K kernel, int smem) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

template <int DP>
int launch_bf16(const Args& a) {
  // head tiles wider than 96 keep half the dK/dV accumulators per block
  constexpr int DS = DP > 96 ? DP / 2 : DP;
  static_assert(DS % 8 == 0, "dK/dV head slice must be a multiple of 8");
  const int tile = T16 * (DP + 8) * (int)sizeof(bf16);
  const int smem_q = 4 * tile;
  int e = set_smem(bwd_dq_bf16_kernel<DP>, smem_q);
  if (e) return e;
  bwd_dq_bf16_kernel<DP>
      <<<dim3((a.M + T16 - 1) / T16, a.H, a.G), 128, smem_q, a.s>>>(
          (const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
          (const bf16*)a.dout, a.lse, a.dd, (bf16*)a.dq, a.M, a.Sk, a.kv_len,
          a.H, a.D, a.scale);
  e = (int)cudaGetLastError();
  if (e || a.dk == nullptr) return e;
  const int smem_kv = 4 * tile + 2 * T16 * (int)sizeof(float);
  e = set_smem(bwd_dkv_bf16_kernel<DP, DS>, smem_kv);
  if (e) return e;
  bwd_dkv_bf16_kernel<DP, DS>
      <<<dim3((a.Sk + T16 - 1) / T16 * (DP / DS), a.H, a.G), 128, smem_kv,
         a.s>>>((const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
                (const bf16*)a.dout, a.lse, a.dd, (bf16*)a.dk, (bf16*)a.dv,
                a.M, a.Sk, a.kv_len, a.H, a.D, a.scale);
  return (int)cudaGetLastError();
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
// dk and dv are both null (only dQ is computed) or both given.  The Python
// wrapper checks shapes, dtypes and contiguity.  Returns cudaGetLastError()
// after the launches (0 = success).
extern "C" int asva_mha_bwd(int dtype, int G, int M, int Sk, int kv_len,
                            int H, int D, float scale, const void* q,
                            const void* k, const void* v, const void* dout,
                            const void* lse, const void* dd, void* dq,
                            void* dk, void* dv, void* stream) {
  if (D % 8 || D > DMAX || kv_len < 1 || kv_len > Sk ||
      (dk == nullptr) != (dv == nullptr))
    return (int)cudaErrorInvalidValue;
  const Args a = {G, M, Sk, kv_len, H, D, scale, q, k, v, dout,
                  (const float*)lse, (const float*)dd, dq, dk, dv,
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
