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
// with dS rounded to q's dtype before both of its products and P to v's
// dtype before dV.  The Pallas grid walks the query tiles in order and adds
// dK/dV into fp32 blocks that stay on chip; B5 here avoids that carry with
// two kernels that both recompute S and dO V^T (seven products).  This
// kernel keeps the Pallas count of five:
//   * one block per (64-row K/V tile, head group, token group) walks all the
//     query tiles with its dK and dV accumulators in registers (fp32 over the
//     whole walk, cast once at the store: the Pallas carry);
//   * it computes S^T = K Q^T and (dO V^T)^T, so P^T and dS^T come out as
//     the A fragments of dV += P^T dO and dK += dS^T Q without a transpose;
//   * dS^T is also staged through shared memory (rounded, as [query][key]) and
//     read back as the A operand of dQ_tile = dS K; every block adds its
//     dQ tile into an fp32 (G, M, H*D) buffer with atomicAdd.  The wrapper
//     zeroes that buffer and casts it to q's dtype once.
// What that costs: M * H * D atomic adds per K/V tile, and a dQ whose fp32
// sum order over the K/V tiles is not fixed when there are more than two of
// them (dK and dV are summed in a fixed order and are reproducible bit for
// bit).  Key rows in [kv_len, Sk) get zero dK/dV and are never read.
//
// Schedules (template parameters): `HG` heads per block, the S^T and
// (dO V^T)^T products of all of them started before the first exp (tool
// variants b1 = 1, b2 = 2, b4 = 4, b3 = all); `SEQ` (b0) is one head with the
// exp between its two products.  A head costs a thread 64 words of S^T and
// (dO V^T)^T and DP words of dK/dV accumulators, and past 255 registers the
// rest spills to local memory, so the instantiations stop at
// HG * (64 + DP) <= 512; the Python wrapper states the same rule and raises
// before any launch.
// fp32: a plain FMA path for the fp32 checks; a block walks its heads one
// after the other.
//
// What bounds it on the H100: with few K/V rows (kv_len 77, 25 of 128) there
// are few blocks with long walks, as in B5's dK/dV kernel, and the atomics
// of dQ all land on the same M * H * D words.

#include "attn_tile.cuh"

namespace {

using namespace asva;

constexpr int LDS_S = TILE + 8;  // row stride of the staged dS tile

template <int DP, int HG, bool SEQ>
__global__ void __launch_bounds__(128)
bwd_fused_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, const bf16* __restrict__ dout,
                      const float* __restrict__ lse,
                      const float* __restrict__ dd, float* __restrict__ dq,
                      bf16* __restrict__ dk, bf16* __restrict__ dv, int M,
                      int Sk, int kv_len, int H, int D, float scale) {
  constexpr int LD = DP + 8, DT = DP / 8, HT = TILE * LD;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Ks = reinterpret_cast<bf16*>(smem);       // [HG][64][LD]
  bf16* Vs = Ks + HG * HT;
  bf16* Qs = Vs + HG * HT;
  bf16* Os = Qs + HG * HT;
  bf16* Ss = Os + HG * HT;                        // [64 queries][LDS_S]
  float* Ls = reinterpret_cast<float*>(Ss + TILE * LDS_S);  // [HG][64]
  float* Ds = Ls + HG * TILE;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int k0 = blockIdx.x * TILE, h0 = blockIdx.y * HG, grp = blockIdx.z;
  const int C = H * D;
  const size_t qbase = (size_t)grp * M * C;
  const size_t kbase = (size_t)grp * Sk * C;
  const int j0 = k0 + warp * 16 + g, j1 = j0 + 8;  // this thread's K/V rows

  if (k0 >= kv_len) {  // a tile of masked keys: zero gradients, nothing read
#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      if (h0 + hh >= H) continue;
      for (int i = tid; i < TILE * (D / 2); i += blockDim.x) {
        const int r = k0 + i / (D / 2), col = (i % (D / 2)) * 2;
        if (r < Sk) {
          const size_t at = kbase + (size_t)r * C + (h0 + hh) * D + col;
          *reinterpret_cast<__nv_bfloat162*>(dk + at) =
              __floats2bfloat162_rn(0.f, 0.f);
          *reinterpret_cast<__nv_bfloat162*>(dv + at) =
              __floats2bfloat162_rn(0.f, 0.f);
        }
      }
    }
    return;
  }

#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
    if (h0 + hh < H) {
      load_tile<DP>(Ks + hh * HT, k + kbase + (h0 + hh) * D, k0, kv_len, C, D);
      load_tile<DP>(Vs + hh * HT, v + kbase + (h0 + hh) * D, k0, kv_len, C, D);
    }

  float ak[HG][DT][4], av[HG][DT][4];
#pragma unroll
  for (int hh = 0; hh < HG; ++hh)
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) ak[hh][dt][e] = av[hh][dt][e] = 0.f;

  for (int q0 = 0; q0 < M; q0 += TILE) {
    __syncthreads();  // the previous tile's reads are done
#pragma unroll
    for (int hh = 0; hh < HG; ++hh)
      if (h0 + hh < H) {
        const int h = h0 + hh;
        load_tile<DP>(Qs + hh * HT, q + qbase + h * D, q0, M, C, D);
        load_tile<DP>(Os + hh * HT, dout + qbase + h * D, q0, M, C, D);
        if (tid < TILE) {
          const bool ok = q0 + tid < M;
          const size_t at = ((size_t)grp * M + q0 + tid) * H + h;
          Ls[hh * TILE + tid] = ok ? lse[at] : 0.f;
          Ds[hh * TILE + tid] = ok ? dd[at] : 0.f;
        }
      }
    __syncthreads();

    // S^T and (dO V^T)^T: rows K/V, columns queries
    float st[HG][8][4], dpt[HG][8][4];
    if (!SEQ) {
#pragma unroll
      for (int hh = 0; hh < HG; ++hh)
        if (h0 + hh < H)
          mma_abt<DP>(st[hh], Ks + hh * HT + warp * 16 * LD, Qs + hh * HT, g,
                      t4);
#pragma unroll
      for (int hh = 0; hh < HG; ++hh)
        if (h0 + hh < H)
          mma_abt<DP>(dpt[hh], Vs + hh * HT + warp * 16 * LD, Os + hh * HT, g,
                      t4);
    }

#pragma unroll
    for (int hh = 0; hh < HG; ++hh) {
      if (h0 + hh >= H) continue;
      const int h = h0 + hh;
      const float* ls = Ls + hh * TILE;
      const float* ds = Ds + hh * TILE;
      if (SEQ) {
        mma_abt<DP>(st[hh], Ks + hh * HT + warp * 16 * LD, Qs + hh * HT, g, t4);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = nt * 8 + t4 * 2 + (e & 1);
            const bool ok = q0 + m < M && (e < 2 ? j0 : j1) < kv_len;
            st[hh][nt][e] = ok ? expf(st[hh][nt][e] * scale - ls[m]) : 0.f;
          }
        mma_abt<DP>(dpt[hh], Vs + hh * HT + warp * 16 * LD, Os + hh * HT, g,
                    t4);
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = nt * 8 + t4 * 2 + (e & 1);
            dpt[hh][nt][e] = st[hh][nt][e] * (dpt[hh][nt][e] - ds[m]) * scale;
          }
      } else {
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int m = nt * 8 + t4 * 2 + (e & 1);
            const bool ok = q0 + m < M && (e < 2 ? j0 : j1) < kv_len;
            const float p = ok ? expf(st[hh][nt][e] * scale - ls[m]) : 0.f;
            st[hh][nt][e] = p;
            dpt[hh][nt][e] = p * (dpt[hh][nt][e] - ds[m]) * scale;
          }
      }
      mma_pb<LD, DT>(av[hh], st[hh], Os + hh * HT, g, t4);
      mma_pb<LD, DT>(ak[hh], dpt[hh], Qs + hh * HT, g, t4);

      // dS, rounded, as [query][key] for the dQ product
      __syncthreads();  // the previous head's dQ reads are done
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int m = nt * 8 + t4 * 2 + (e & 1);
          const int j = warp * 16 + g + (e < 2 ? 0 : 8);
          Ss[m * LDS_S + j] = __float2bfloat16_rn(dpt[hh][nt][e]);
        }
      __syncthreads();
      uint32_t af[TILE / 16][4];
      load_afrag<TILE>(af, Ss + warp * 16 * LDS_S, LDS_S, g, t4);
      const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
      float* dq0 = dq + qbase + (size_t)r0 * C + h * D;
      float* dq1 = dq + qbase + (size_t)r1 * C + h * D;
      const bf16* kh = Ks + hh * HT;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int kk = 0; kk < TILE / 16; ++kk) {
          const bf16* bc = kh + (kk * 16 + t4 * 2) * LD + g + dt * 8;
          mma_bf16(acc, af[kk], pack_b(bc[0], bc[LD]),
                   pack_b(bc[8 * LD], bc[9 * LD]));
        }
        const int col = dt * 8 + t4 * 2;
        if (col < D) {
          if (r0 < M) {
            atomicAdd(dq0 + col, acc[0]);
            atomicAdd(dq0 + col + 1, acc[1]);
          }
          if (r1 < M) {
            atomicAdd(dq1 + col, acc[2]);
            atomicAdd(dq1 + col + 1, acc[3]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int hh = 0; hh < HG; ++hh) {
    if (h0 + hh >= H) continue;
    bf16* kg = dk + kbase + (h0 + hh) * D;
    bf16* vg = dv + kbase + (h0 + hh) * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + t4 * 2;
      if (col < D) {
        if (j0 < Sk) {
          *reinterpret_cast<__nv_bfloat162*>(kg + (size_t)j0 * C + col) =
              __floats2bfloat162_rn(ak[hh][dt][0], ak[hh][dt][1]);
          *reinterpret_cast<__nv_bfloat162*>(vg + (size_t)j0 * C + col) =
              __floats2bfloat162_rn(av[hh][dt][0], av[hh][dt][1]);
        }
        if (j1 < Sk) {
          *reinterpret_cast<__nv_bfloat162*>(kg + (size_t)j1 * C + col) =
              __floats2bfloat162_rn(ak[hh][dt][2], ak[hh][dt][3]);
          *reinterpret_cast<__nv_bfloat162*>(vg + (size_t)j1 * C + col) =
              __floats2bfloat162_rn(av[hh][dt][2], av[hh][dt][3]);
        }
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

template <int DP, int HG, bool SEQ>
int launch_bf16(const Args& a) {
  const int smem = (4 * HG * TILE * (DP + 8) + TILE * LDS_S) *
                       (int)sizeof(bf16) +
                   2 * HG * TILE * (int)sizeof(float);
  int e = set_smem(bwd_fused_bf16_kernel<DP, HG, SEQ>, smem);
  if (e) return e;
  bwd_fused_bf16_kernel<DP, HG, SEQ>
      <<<dim3((a.Sk + TILE - 1) / TILE, (a.H + HG - 1) / HG, a.G), 128, smem,
         a.s>>>((const bf16*)a.q, (const bf16*)a.k, (const bf16*)a.v,
                (const bf16*)a.dout, a.lse, a.dd, a.dq, (bf16*)a.dk,
                (bf16*)a.dv, a.M, a.Sk, a.kv_len, a.H, a.D, a.scale);
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
  const int D_ = D;
  const int smem = (2 * T32 * D_ + 2 * T32 * (D_ + 1) + 2 * T32 * (T32 + 1) +
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
