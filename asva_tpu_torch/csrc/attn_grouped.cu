// T2f: the flash forward with the heads taken `group` at a time, for sm_90a.
// Plain C interface, loaded with ctypes.
//
// Replaces the Pallas TPU kernel _fwd_kernel (tools/mha_phase_bench.py:42),
// called by fwd_flat (:79): B4's function (attn.cu) on another schedule.
// There one program holds a query tile and loops over the heads,
// `group` heads' logits computed before any softmax.  Here one block owns a
// 64-row query tile and `group` heads; for every 64-row K/V tile each warp
// first starts the QK^T products of all its heads (their logits live in
// registers at once) and then runs softmax + PV head by head.  group = 1 is
// the mma.sync schedule B4 had before it moved to wgmma.  Per head the
// statements are the same, in the same order, so o and lse are bit-equal
// across group sizes, and within rounding of B4's.
//
// Layout as attn.cu: q, o (G, M, H*D); k, v (G, Sk, H*D); lse (G, M, H) fp32;
// columns >= kv_len masked to -1e9, rows past kv_len never read.
//
// What bounds it on the H100: registers.  A head costs each thread 32 words
// of logits and DP / 2 of output accumulator, so the instantiations stop at
// group * (32 + DP / 2) <= 256 (group 4 up to head dim 64, group 2 up to
// 160); beyond that the Python wrapper raises before any launch.  Whether
// the extra products in flight hide the fp32 softmax is what the tool
// measures.
// fp32: the plain FMA path of attn.cu, for the fp32 checks; a block walks
// its `group` heads one after the other.

#include "attn_tile.cuh"

namespace {

using namespace asva;

template <int DP, int GROUP>
__global__ void __launch_bounds__(128)
grouped_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o,
                    float* __restrict__ lse, int M, int Sk, int kv_len, int H,
                    int D, float scale) {
  constexpr int LD = DP + 8, KC = DP / 16, DT = DP / 8, BKV16 = TILE;
  extern __shared__ __align__(16) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);      // [GROUP][64][LD]
  bf16* Ks = Qs + GROUP * TILE * LD;             // [GROUP][64][LD]
  bf16* Vs = Ks + GROUP * TILE * LD;             // [GROUP][64][LD]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = blockIdx.x * TILE, h0 = blockIdx.y * GROUP, grp = blockIdx.z;
  const int C = H * D;
  const bf16* qg = q + (size_t)grp * M * C;
  const bf16* kg = k + (size_t)grp * Sk * C;
  const bf16* vg = v + (size_t)grp * Sk * C;

#pragma unroll
  for (int hh = 0; hh < GROUP; ++hh)
    if (h0 + hh < H)
      load_tile<DP>(Qs + hh * TILE * LD, qg + (h0 + hh) * D, q0, M, C, D);
  __syncthreads();

  uint32_t qf[GROUP][KC][4];
  float oacc[GROUP][DT][4];
  float mrow[GROUP][2], lrow[GROUP][2];
#pragma unroll
  for (int hh = 0; hh < GROUP; ++hh) {
    load_afrag<DP>(qf[hh], Qs + (hh * TILE + warp * 16) * LD, LD, g, t4);
#pragma unroll
    for (int dt = 0; dt < DT; ++dt)
#pragma unroll
      for (int e = 0; e < 4; ++e) oacc[hh][dt][e] = 0.f;
    mrow[hh][0] = mrow[hh][1] = -INFINITY;
    lrow[hh][0] = lrow[hh][1] = 0.f;
  }

  const int ntiles = (kv_len + BKV16 - 1) / BKV16;
  for (int t = 0; t < ntiles; ++t) {
    const int k0 = t * BKV16;
    __syncthreads();  // the previous tile's reads are done
#pragma unroll
    for (int hh = 0; hh < GROUP; ++hh)
      if (h0 + hh < H) {
        load_tile<DP>(Ks + hh * TILE * LD, kg + (h0 + hh) * D, k0, kv_len, C, D);
        load_tile<DP>(Vs + hh * TILE * LD, vg + (h0 + hh) * D, k0, kv_len, C, D);
      }
    __syncthreads();

    // every head's logits first ...
    float s[GROUP][BKV16 / 8][4];
#pragma unroll
    for (int hh = 0; hh < GROUP; ++hh)
      if (h0 + hh < H) qk_tile<DP>(s[hh], qf[hh], Ks + hh * TILE * LD, g, t4);

    // ... then softmax + PV head by head (attn.cu's statements)
#pragma unroll
    for (int hh = 0; hh < GROUP; ++hh) {
      if (h0 + hh >= H) continue;
      float tm0 = -INFINITY, tm1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BKV16 / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = k0 + nt * 8 + t4 * 2 + (e & 1);
          const float val = col < kv_len ? s[hh][nt][e] * scale : MASK;
          s[hh][nt][e] = val;
          if (e < 2) tm0 = fmaxf(tm0, val);
          else tm1 = fmaxf(tm1, val);
        }
      const float mn0 = fmaxf(mrow[hh][0], quad_max(tm0));
      const float mn1 = fmaxf(mrow[hh][1], quad_max(tm1));
      const float al0 = expf(mrow[hh][0] - mn0), al1 = expf(mrow[hh][1] - mn1);
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < BKV16 / 8; ++nt) {
        s[hh][nt][0] = expf(s[hh][nt][0] - mn0);
        s[hh][nt][1] = expf(s[hh][nt][1] - mn0);
        s[hh][nt][2] = expf(s[hh][nt][2] - mn1);
        s[hh][nt][3] = expf(s[hh][nt][3] - mn1);
        ps0 += s[hh][nt][0] + s[hh][nt][1];
        ps1 += s[hh][nt][2] + s[hh][nt][3];
      }
      lrow[hh][0] = lrow[hh][0] * al0 + quad_sum(ps0);
      lrow[hh][1] = lrow[hh][1] * al1 + quad_sum(ps1);
      mrow[hh][0] = mn0;
      mrow[hh][1] = mn1;
#pragma unroll
      for (int dt = 0; dt < DT; ++dt) {
        oacc[hh][dt][0] *= al0;
        oacc[hh][dt][1] *= al0;
        oacc[hh][dt][2] *= al1;
        oacc[hh][dt][3] *= al1;
      }
      mma_pb<LD, DT>(oacc[hh], s[hh], Vs + hh * TILE * LD, g, t4);
    }
  }

  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;
#pragma unroll
  for (int hh = 0; hh < GROUP; ++hh) {
    if (h0 + hh >= H) continue;
    const int h = h0 + hh;
    const float inv0 = 1.f / lrow[hh][0], inv1 = 1.f / lrow[hh][1];
    bf16* og = o + (size_t)grp * M * C + h * D;
#pragma unroll
    for (int dt = 0; dt < DT; ++dt) {
      const int col = dt * 8 + t4 * 2;
      if (col < D) {
        if (r0 < M)
          *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r0 * C + col) =
              __floats2bfloat162_rn(oacc[hh][dt][0] * inv0,
                                    oacc[hh][dt][1] * inv0);
        if (r1 < M)
          *reinterpret_cast<__nv_bfloat162*>(og + (size_t)r1 * C + col) =
              __floats2bfloat162_rn(oacc[hh][dt][2] * inv1,
                                    oacc[hh][dt][3] * inv1);
      }
    }
    if (t4 == 0) {
      float* lg = lse + (size_t)grp * M * H + h;
      if (r0 < M) lg[(size_t)r0 * H] = mrow[hh][0] + logf(lrow[hh][0]);
      if (r1 < M) lg[(size_t)r1 * H] = mrow[hh][1] + logf(lrow[hh][1]);
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
  const int smem = 3 * GROUP * TILE * (DP + 8) * (int)sizeof(bf16);
  int e = set_smem(grouped_bf16_kernel<DP, GROUP>, smem);
  if (e) return e;
  const dim3 grid((M + TILE - 1) / TILE, (H + GROUP - 1) / GROUP, G);
  grouped_bf16_kernel<DP, GROUP><<<grid, 128, smem, s>>>(
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
  int e = set_smem(grouped_f32_kernel, smem);
  if (e) return e;
  const dim3 grid((M + BQ32 - 1) / BQ32, (H + group - 1) / group, G);
  grouped_f32_kernel<<<grid, 128, smem, s>>>((const float*)q, (const float*)k,
                                             (const float*)v, (float*)o, l, M,
                                             Sk, kv_len, H, D, scale, group);
  return (int)cudaGetLastError();
}
