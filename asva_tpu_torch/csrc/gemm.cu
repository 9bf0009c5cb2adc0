// K-gemm: GEMM with an optional LayerNorm prologue and one of three
// epilogues, for sm_90a.  Plain C interface, loaded with ctypes.
//
// Replaces (together with attn.cu) the Pallas TPU kernels of
// asva_tpu/ops/pallas_fused.py:
//   _ff_kernel / _ln_geglu_flat      (B3 fused_ln_geglu)
//       = this kernel with LN prologue + GEGLU epilogue, then this kernel
//         with the bias+residual epilogue;
//   _attn_kernel / _ln_attn_flat and _attn3_kernel / _ln_attn3_flat
//       (B1 fused_ln_attn, B2 fused_ln_attn3): the q projection (LN
//       prologue + plain store) and the output projection (bias+residual).
// The split is rounding-identical to the Pallas bodies: every boundary is
// where the Pallas kernel casts to x.dtype (q at pallas_fused.py:258, the
// GEGLU hidden h at :115).
//
// out(M, N) = epilogue( prologue(A)(M, K) @ W(N, K)^T ), W in torch Linear
// layout (out, in), read in place (K contiguous: wgmma's K-major B).
//   prologue (optional): fp32 row mean / two-pass variance over the full K,
//     the row normalised and cast to the input dtype (pallas _ln_rows :94).
//   epilogue 0: cast and store.
//   epilogue 1 (GEGLU): W holds [value; gate] rows (2N, K) and bias (2N);
//     out = v * gelu_erf(g), v = acc_v + b[n], g = acc_g + b[N + n], with a
//     true erff (the Pallas A&S erf approximation is a Mosaic workaround).
//   epilogue 2: out = res + (acc + bias) in fp32, then cast.
//
// bf16: wgmma fed by bulk tensor copies (TMA).  A block owns NWG x 64 rows
// (one consumer warpgroup of 64 rows each; NWG = 2, or 1 when the grid
// would not fill the card) and a TN-wide column panel: TN = 160 when it
// divides N (every SD1.5 width), GEGLU's value and gate panels 80 wide each,
// else 64.  K streams in 64-deep tiles of 128-byte rows, 128-byte swizzled,
// through a STAGES-deep ring of mbarrier-counted stages that thread 0
// refills, so STAGES - 1 tiles are in flight while one is multiplied.  Two
// blocks share an SM, so one's prologue and epilogue overlap the other's
// products.  The LN statistics of a row are taken once per cluster of
// neighbouring column blocks (up to 4, sharing them through distributed
// shared memory) while the first tiles land; each block normalises its A
// tiles in shared memory before the products read them.  The epilogue
// stages the tile through shared memory and writes 16-byte vectors
// (reading res the same way).  No split-K: every output element is the
// same sequence of k16 products in the same order whatever M, the grid or
// the row's place in its tile (the tile width depends on N and the
// epilogue only), so results repeat bit for bit and a row's bits do not
// depend on the other rows of the launch.
// fp32: a plain FMA path, 64x64 tile, 256 threads of 4x4 (the check path).
//
// What bounds it on the H100: at the level-0 shapes (M = 24576 tokens, C =
// 320) the q and output projections are bound by their bytes (31-47 MB
// against 5 GFLOP), the LN + GEGLU product by operations (40 GFLOP).  The
// tensor cores are not what holds the kernel back: the copies were (TMA
// moved four times the bytes a second that 16-byte cp.async did here), then
// the LN prologue, which every column block of a row repeats, and each
// block's fixed costs (PERF.md).

#include <cuda.h>
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include "hopper.cuh"
#include "tma.cuh"
#include "wgmma.cuh"

namespace {

typedef __nv_bfloat16 bf16;

enum { EPI_STORE = 0, EPI_GEGLU = 1, EPI_BIAS_RES = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// fp32 mean and 1/sqrt(var + eps) of rows [m0, m0 + rows); one warp a row.
template <typename T>
__device__ void row_stats(const T* __restrict__ a, int M, int K, int m0,
                          int rows, float eps, float* mean_s, float* rstd_s) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nw = blockDim.x >> 5;
  for (int r = warp; r < rows; r += nw) {
    const int m = m0 + r;
    float mean = 0.f, rstd = 0.f;
    if (m < M) {
      const T* row = a + (size_t)m * K;
      float s = 0.f;
      for (int k = lane; k < K; k += 32) s += to_f(row[k]);
      mean = warp_sum(s) / (float)K;
      float v = 0.f;
      for (int k = lane; k < K; k += 32) {
        const float d = to_f(row[k]) - mean;
        v += d * d;
      }
      rstd = rsqrtf(warp_sum(v) / (float)K + eps);
    }
    if (lane == 0) {
      mean_s[r] = mean;
      rstd_s[r] = rstd;
    }
  }
}

template <typename T, int EPI>
__device__ __forceinline__ void epilogue(int m, int n, float acc, float acc2,
                                         int M, int N,
                                         const T* __restrict__ bias,
                                         const T* __restrict__ res,
                                         T* __restrict__ out) {
  if (m >= M || n >= N) return;
  float r;
  if (EPI == EPI_STORE) {
    r = acc;
  } else if (EPI == EPI_GEGLU) {
    const float v = acc + to_f(bias[n]);
    const float g = acc2 + to_f(bias[N + n]);
    r = v * gelu_erf(g);
  } else {
    r = to_f(res[(size_t)m * N + n]) + (acc + to_f(bias[n]));
  }
  out[(size_t)m * N + n] = from_f<T>(r);
}

// ---------------------------------------------------------------- bf16 ---

constexpr int SMEM_SM = 233472;        // shared memory of an SM
constexpr int SMEM_CTA = 232448;       // ... that one block may use
constexpr int MAX_CLUSTER = 4;         // blocks that share LN statistics

// Shared-memory plan of one instantiation: the ring of STAGES (A, W...)
// tiles, reused by the epilogue's staging tile, then the LN statistics.
// Two blocks an SM, so one block's prologue and epilogue overlap the
// other's products; GEGLU's two accumulators take 80-wide tiles for that.
template <int EPI, int TN, int NWG>
struct Plan {
  static constexpr int NB = EPI == EPI_GEGLU ? 2 : 1;  // W panels
  static constexpr int CTAS = NB * TN <= 160 ? 2 : 1;
  static constexpr int BM = 64 * NWG, NT = 128 * NWG;
  static constexpr int A_BYTES = BM * BK * 2, W_BYTES = TN * BK * 2;
  static constexpr int STAGE = A_BYTES + NB * W_BYTES;
  static constexpr int LDS = TN + 8;   // staging row, conflict-free pairs
  static constexpr int STAGING = BM * LDS * (EPI == EPI_BIAS_RES ? 4 : 2);
  static constexpr int BUDGET = (SMEM_SM / CTAS - 1024 < SMEM_CTA
                                     ? SMEM_SM / CTAS - 1024 : SMEM_CTA);
  static constexpr int FIT = (BUDGET - 2 * BM * 4 - 8 * 5 - 1024) / STAGE;
  static constexpr int STAGES = FIT > 5 ? 5 : FIT;
  static constexpr int RING = STAGES * STAGE;
  static constexpr int STATS = RING > STAGING ? RING : STAGING;
  // + the statistics, STAGES mbarriers and the slack that aligns the ring
  static constexpr int BYTES = STATS + 2 * BM * 4 + 8 * STAGES + 1024;
  static_assert(STAGES >= 3, "the ring needs three stages");
  static_assert(BYTES <= BUDGET, "shared memory plan");
};

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

__device__ __forceinline__ uint32_t cluster_size() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}

// every thread of every block of the cluster; orders the shared-memory
// writes before it (local and remote) before the reads after it
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// v into the shared-memory word at local address `addr` of block `rank`
__device__ __forceinline__ void st_cluster(uint32_t addr, uint32_t rank,
                                           float v) {
  uint32_t remote;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(remote) : "r"(addr), "r"(rank));
  asm volatile("st.shared::cluster.f32 [%0], %1;\n" ::"r"(remote), "f"(v)
               : "memory");
}

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

// sum over the 8 lanes lane & ~7 .. lane | 7
__device__ __forceinline__ float group8_sum(float v) {
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// fp32 mean and 1/sqrt(var + eps) (the two-pass formula of row_stats) of
// the block's BM rows, each taken once in the cluster: block `rank` of n
// computes rows [rank BM / n, (rank + 1) BM / n), 8 lanes a row and all of
// its rows at once, and writes them into every block's mean_s / rstd_s.
// A row of up to 1280 columns stays in registers between the two passes.
// Rows >= M read nothing and get mean 0 (their products are never stored).
template <int NT, int BM>
__device__ void ln_stats(const bf16* __restrict__ a, int M, int K, int m0,
                         float eps, float* mean_s, float* rstd_s) {
  constexpr int CH = 20;                      // chunks a lane, K <= 1280
  const uint32_t n = cluster_size(), rank = cluster_rank();
  const int rows = BM / n, sub = threadIdx.x & 7;
  const int nch = K / 64;                     // chunks a lane: k = 64 j + 8 sub
  for (int rr = threadIdx.x >> 3; rr < rows; rr += NT / 8) {
    const int r = rank * rows + rr, m = m0 + r;
    const bool ok = m < M;
    const bf16* row = a + (size_t)(ok ? m : 0) * K + 8 * sub;
    float s = 0.f, var = 0.f, mean;
    if (nch <= CH) {
      uint4 x[CH];
#pragma unroll
      for (int j = 0; j < CH; ++j)
        x[j] = ok && j < nch ? *reinterpret_cast<const uint4*>(row + 64 * j)
                             : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < CH; ++j) s += sum8(x[j]);
      mean = group8_sum(s) / (float)K;
#pragma unroll
      for (int j = 0; j < CH; ++j)
        if (j < nch) var += sqdev8(x[j], mean);
    } else {
#pragma unroll 4
      for (int j = 0; j < nch; ++j)
        if (ok) s += sum8(*reinterpret_cast<const uint4*>(row + 64 * j));
      mean = group8_sum(s) / (float)K;
#pragma unroll 4
      for (int j = 0; j < nch; ++j)
        if (ok) var += sqdev8(*reinterpret_cast<const uint4*>(row + 64 * j),
                              mean);
    }
    const float rstd = rsqrtf(group8_sum(var) / (float)K + eps);
    if (sub == 0) {
      for (uint32_t c = 0; c < n; ++c) {
        st_cluster(hop::smem_u32(mean_s + r), c, mean);
        st_cluster(hop::smem_u32(rstd_s + r), c, rstd);
      }
    }
  }
  cluster_sync();
}

// One block: rows [m0, m0 + 64 NWG) x columns [n0, n0 + TN) of out.
// Iteration t: every thread waits for tile t's bytes on its mbarrier,
// normalises its share of the A tile (LN), fences it into the async proxy
// and meets the others at the block barrier (every warpgroup's products of
// tile t - 1 are done, so its stage may be refilled); thread 0 starts the
// bulk copies of tile t + STAGES - 1, then each warpgroup issues tile t's
// products and waits for them.  The copies, not the tensor cores, bound
// these shapes, so the ring keeps STAGES - 1 tiles in flight rather than
// overlapping products of neighbouring tiles.  No branch surrounds a wgmma,
// so ptxas keeps them asynchronous (C7514 otherwise).
template <int EPI, bool LN, int TN, int NWG>
__global__ void __launch_bounds__(128 * NWG, (Plan<EPI, TN, NWG>::CTAS))
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a,
                  const __grid_constant__ CUtensorMap map_w,
                  const bf16* __restrict__ a, const bf16* __restrict__ lnw,
                  const bf16* __restrict__ lnb, float eps,
                  const bf16* __restrict__ bias, const bf16* __restrict__ res,
                  bf16* __restrict__ out, int M, int N, int K) {
  typedef Plan<EPI, TN, NWG> P;
  constexpr int NB = P::NB, BM = P::BM, NT = P::NT, STAGES = P::STAGES;
  constexpr int AHEAD = STAGES - 1;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the swizzled tiles want 1024-byte alignment
  unsigned char* smem = smem_raw + ((1024 - (hop::smem_u32(smem_raw) & 1023))
                                    & 1023);
  float* mean_s = reinterpret_cast<float*>(smem + P::STATS);
  float* rstd_s = mean_s + BM;
  const uint32_t s0 = hop::smem_u32(smem);
  const uint32_t bar0 = hop::smem_u32(rstd_s + BM);  // STAGES mbarriers

  const int tid = threadIdx.x, wg = tid >> 7, warp = (tid >> 5) & 3;
  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int n0 = blockIdx.x * TN, m0 = blockIdx.y * BM;
  const int nk = K / BK;
  auto sa = [&](int t) { return s0 + (t % STAGES) * P::STAGE; };
  auto sw = [&](int t, int nb) { return sa(t) + P::A_BYTES + nb * P::W_BYTES; };
  auto bar = [&](int t) { return bar0 + (t % STAGES) * 8; };
  auto load = [&](int t) {  // thread 0
    mbar_expect_tx(bar(t), P::STAGE);
    tma_load(sa(t), &map_a, t * BK, m0, bar(t));
#pragma unroll
    for (int nb = 0; nb < NB; ++nb)
      tma_load(sw(t, nb), &map_w, t * BK, nb * N + n0, bar(t));
  };
  // (x - mean) * rstd * w + b in fp32, rounded to bf16, on 16-byte chunks
  // of the swizzled A tile: chunk p of row r holds columns 8 (p ^ r % 8)
  auto normalise = [&](int t) {
    const int k0 = t * BK;
    unsigned char* tile = smem + (t % STAGES) * P::STAGE;
#pragma unroll
    for (int j = 0; j < BM * 8 / NT; ++j) {
      const int i = tid + j * NT, r = i >> 3, c = ((i & 7) ^ (r & 7)) * 8;
      uint4* p = reinterpret_cast<uint4*>(tile + i * 16);
      uint4 v = *p;
      const uint4 wv = *reinterpret_cast<const uint4*>(lnw + k0 + c);
      const uint4 bv = *reinterpret_cast<const uint4*>(lnb + k0 + c);
      bf16* e = reinterpret_cast<bf16*>(&v);
      const bf16* we = reinterpret_cast<const bf16*>(&wv);
      const bf16* be = reinterpret_cast<const bf16*>(&bv);
      const float mu = mean_s[r], rs = rstd_s[r];
#pragma unroll
      for (int q = 0; q < 8; ++q)
        e[q] = __float2bfloat16_rn((to_f(e[q]) - mu) * rs * to_f(we[q]) +
                                   to_f(be[q]));
      *p = v;
    }
  };

  if (tid == 0) {
    for (int i = 0; i < STAGES; ++i) mbar_init(bar0 + 8 * i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    hop::fence_async_smem();
#pragma unroll 1
    for (int t = 0; t < AHEAD && t < nk; ++t) load(t);
  }
  if (LN)  // while the first tiles land; ends with a cluster barrier
    ln_stats<NT, BM>(a, M, K, m0, eps, mean_s, rstd_s);
  else
    __syncthreads();  // the mbarriers are initialised

  float acc[NB][TN / 2];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < TN / 2; ++i) acc[nb][i] = 0.f;
  const uint32_t a_wg = wg * 64 * BK * 2;  // this warpgroup's rows

  for (int t = 0; t < nk; ++t) {
    mbar_wait(bar(t), (t / STAGES) & 1);
    if (LN) {
      normalise(t);
      hop::fence_async_smem();
    }
    __syncthreads();  // tile t - 1's stage is free
    if (tid == 0 && t + AHEAD < nk) load(t + AHEAD);
    hop::wg_fence();
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        Wgmma<TN>::ss(acc[nb], desc_sw128(sa(t) + a_wg + kk * 32),
                      desc_sw128(sw(t, nb) + kk * 32), 1);
    hop::wg_commit();
    hop::wg_wait<0>();
  }
#pragma unroll
  for (int nb = 0; nb < NB; ++nb) hop::fence_regs(acc[nb]);
  __syncthreads();              // every warpgroup is done with the ring

  // epilogue in fp32, staged per warpgroup: rows r0, r0 + 8 of its 64,
  // columns 8 j + 2 t4 + {0, 1} (the accumulator layout of wgmma.cuh)
  const int r0 = warp * 16 + g;
  constexpr int LDS = P::LDS;
  if (EPI == EPI_BIAS_RES) {
    float* st = reinterpret_cast<float*>(smem) + wg * 64 * LDS;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      const float b0 = to_f(bias[n0 + col]), b1 = to_f(bias[n0 + col + 1]);
      *reinterpret_cast<float2*>(st + r0 * LDS + col) =
          make_float2(acc[0][4 * j] + b0, acc[0][4 * j + 1] + b1);
      *reinterpret_cast<float2*>(st + (r0 + 8) * LDS + col) =
          make_float2(acc[0][4 * j + 2] + b0, acc[0][4 * j + 3] + b1);
    }
  } else {
    bf16* st = reinterpret_cast<bf16*>(smem) + wg * 64 * LDS;
#pragma unroll
    for (int j = 0; j < TN / 8; ++j) {
      const int col = 8 * j + 2 * t4;
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) v[e] = acc[0][4 * j + e];
      if (EPI == EPI_GEGLU) {
        const float bv[2] = {to_f(bias[n0 + col]), to_f(bias[n0 + col + 1])};
        const float bg[2] = {to_f(bias[N + n0 + col]),
                             to_f(bias[N + n0 + col + 1])};
#pragma unroll
        for (int e = 0; e < 4; ++e)
          v[e] = (v[e] + bv[e & 1]) *
                 gelu_erf(acc[NB - 1][4 * j + e] + bg[e & 1]);
      }
      *reinterpret_cast<__nv_bfloat162*>(st + r0 * LDS + col) =
          __floats2bfloat162_rn(v[0], v[1]);
      *reinterpret_cast<__nv_bfloat162*>(st + (r0 + 8) * LDS + col) =
          __floats2bfloat162_rn(v[2], v[3]);
    }
  }
  __syncthreads();

  // 16-byte chunks of 8 columns, a row's chunks on neighbouring threads
  constexpr int CPR = TN / 8;
  const int lt = tid & 127;
  for (int i = lt; i < 64 * CPR; i += 128) {
    const int r = i / CPR, c = (i % CPR) * 8;
    const int m = m0 + wg * 64 + r;
    if (m >= M) continue;
    const size_t o = (size_t)m * N + n0 + c;
    if (EPI == EPI_BIAS_RES) {
      const float* st = reinterpret_cast<const float*>(smem) + wg * 64 * LDS +
                        r * LDS + c;
      const float4 x0 = *reinterpret_cast<const float4*>(st);
      const float4 x1 = *reinterpret_cast<const float4*>(st + 4);
      const float x[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
      uint4 rv = *reinterpret_cast<const uint4*>(res + o);
      bf16* e = reinterpret_cast<bf16*>(&rv);
#pragma unroll
      for (int j = 0; j < 8; ++j) e[j] = __float2bfloat16_rn(to_f(e[j]) + x[j]);
      *reinterpret_cast<uint4*>(out + o) = rv;
    } else {
      const bf16* st = reinterpret_cast<const bf16*>(smem) + wg * 64 * LDS +
                       r * LDS + c;
      *reinterpret_cast<uint4*>(out + o) = *reinterpret_cast<const uint4*>(st);
    }
  }
}

template <int EPI, bool LN, int TN, int NWG>
int launch_bf16(const void* a, const void* lnw, const void* lnb, float eps,
                const void* w, const void* bias, const void* res, void* out,
                int M, int N, int K, cudaStream_t s) {
  typedef Plan<EPI, TN, NWG> P;
  CUtensorMap map_a, map_w;
  if (!tensor_map(&map_a, a, M, K, P::BM) ||
      !tensor_map(&map_w, w, P::NB * N, K, TN))
    return (int)cudaErrorInvalidValue;
  auto kernel = gemm_wgmma_kernel<EPI, LN, TN, NWG>;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::BYTES);
  if (e != cudaSuccess) return (int)e;
  // neighbouring column tiles of one row block share its LN statistics
  const int tiles = N / TN;
  int cluster = 1;
  if (LN)
    for (int c = MAX_CLUSTER; c > 1; c >>= 1)
      if (tiles % c == 0) {
        cluster = c;
        break;
      }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(tiles, (M + P::BM - 1) / P::BM);
  cfg.blockDim = dim3(P::NT);
  cfg.dynamicSmemBytes = P::BYTES;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const cudaError_t l = cudaLaunchKernelEx(
      &cfg, kernel, map_a, map_w, (const bf16*)a, (const bf16*)lnw,
      (const bf16*)lnb, eps, (const bf16*)bias, (const bf16*)res, (bf16*)out,
      M, N, K);
  if (l != cudaSuccess) return (int)l;
  return (int)cudaGetLastError();
}

// The tile: TN = 160 when it divides N (GEGLU: 80, its value and gate
// panels side by side), else 64 (0: N unsupported).  It depends on N and
// the epilogue alone, so a row's products are the same instructions
// whatever M.  Two warpgroups a block when that still fills the card with
// blocks, else one (the small grids of the 8x8 and 4x4 levels).
int tile_n(int epi, int N) {
  const int wide = epi == EPI_GEGLU ? 80 : 160;
  return N % wide == 0 ? wide : N % 64 == 0 ? 64 : 0;
}

int dispatch_bf16(int epi, bool ln, const void* a, const void* lnw,
                  const void* lnb, float eps, const void* w, const void* bias,
                  const void* res, void* out, int M, int N, int K,
                  cudaStream_t s) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int tn = tile_n(epi, N);
  const bool two = (long long)((M + 127) / 128) * (N / tn) >= sms;
#define ASVA_CASE(E, L, T, W)                                             \
  if (epi == E && ln == L && tn == T && two == (W == 2))                  \
    return launch_bf16<E, L, T, W>(a, lnw, lnb, eps, w, bias, res, out,   \
                                   M, N, K, s);
#define ASVA_TILES(E, L, WIDE) \
  ASVA_CASE(E, L, WIDE, 2) ASVA_CASE(E, L, WIDE, 1) \
  ASVA_CASE(E, L, 64, 2) ASVA_CASE(E, L, 64, 1)
  ASVA_TILES(EPI_STORE, true, 160)
  ASVA_TILES(EPI_STORE, false, 160)
  ASVA_TILES(EPI_GEGLU, true, 80)
  ASVA_TILES(EPI_GEGLU, false, 80)
  ASVA_TILES(EPI_BIAS_RES, true, 160)
  ASVA_TILES(EPI_BIAS_RES, false, 160)
#undef ASVA_TILES
#undef ASVA_CASE
  return (int)cudaErrorInvalidValue;
}

// ---------------------------------------------------------------- fp32 ---

constexpr int BM = 64, BN = 64;
constexpr int BK32 = 16, LDS32 = BM + 4;

template <int EPI, bool LN>
__global__ void __launch_bounds__(256)
gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ lnw,
                const float* __restrict__ lnb, float eps,
                const float* __restrict__ w, const float* __restrict__ bias,
                const float* __restrict__ res, float* __restrict__ out,
                int M, int N, int K) {
  constexpr int NB = (EPI == EPI_GEGLU) ? 2 : 1;
  // transposed tiles: As[k][m], Bs[nb][k][n]
  __shared__ __align__(16) float As[BK32][LDS32];
  __shared__ __align__(16) float Bs[NB][BK32][LDS32];
  __shared__ float mean_s[BM], rstd_s[BM];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;     // 4 cols x 4 rows each
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;

  if (LN) {
    row_stats(a, M, K, m0, BM, eps, mean_s, rstd_s);
    __syncthreads();
  }

  float acc[NB][4][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[nb][i][j] = 0.f;

  // a 64x16 tile is 256 float4 chunks: chunk tid -> row tid/4, col (tid%4)*4
  const int lr = tid >> 2, lc = (tid & 3) * 4;
  float4 ra, rb[NB];
  const int nk = K / BK32;

  auto load = [&](int k0) {
    const int m = m0 + lr;
    ra = m < M ? *reinterpret_cast<const float4*>(a + (size_t)m * K + k0 + lc)
               : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int n = n0 + lr;
      rb[nb] = n < N ? *reinterpret_cast<const float4*>(
                           w + ((size_t)nb * N + n) * K + k0 + lc)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
    }
  };
  auto store = [&](int k0) {
    float v[4] = {ra.x, ra.y, ra.z, ra.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (LN) {
        const int k = k0 + lc + j;
        v[j] = (v[j] - mean_s[lr]) * rstd_s[lr] * lnw[k] + lnb[k];
      }
      As[lc + j][lr] = v[j];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      Bs[nb][lc + 0][lr] = rb[nb].x;
      Bs[nb][lc + 1][lr] = rb[nb].y;
      Bs[nb][lc + 2][lr] = rb[nb].z;
      Bs[nb][lc + 3][lr] = rb[nb].w;
    }
  };

  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    store(kt * BK32);
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * BK32);
#pragma unroll
    for (int k = 0; k < BK32; ++k) {
      const float4 av = *reinterpret_cast<const float4*>(&As[k][ty * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const float4 bv = *reinterpret_cast<const float4*>(&Bs[nb][k][tx * 4]);
        const float br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[nb][i][j] = fmaf(ar[i], br[j], acc[nb][i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      epilogue<float, EPI>(m0 + ty * 4 + i, n0 + tx * 4 + j, acc[0][i][j],
                           acc[NB - 1][i][j], M, N, bias, res, out);
}

template <int EPI, bool LN>
void launch_f32(const void* a, const void* lnw, const void* lnb, float eps,
                const void* w, const void* bias, const void* res, void* out,
                int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gemm_f32_kernel<EPI, LN><<<grid, 256, 0, s>>>(
      (const float*)a, (const float*)lnw, (const float*)lnb, eps,
      (const float*)w, (const float*)bias, (const float*)res, (float*)out,
      M, N, K);
}

void dispatch_f32(int epi, bool ln, const void* a, const void* lnw,
                  const void* lnb, float eps, const void* w, const void* bias,
                  const void* res, void* out, int M, int N, int K,
                  cudaStream_t s) {
#define ASVA_CASE(E, L)                                                   \
  if (epi == E && ln == L) {                                              \
    launch_f32<E, L>(a, lnw, lnb, eps, w, bias, res, out, M, N, K, s);    \
    return;                                                               \
  }
  ASVA_CASE(EPI_STORE, true)
  ASVA_CASE(EPI_STORE, false)
  ASVA_CASE(EPI_GEGLU, true)
  ASVA_CASE(EPI_GEGLU, false)
  ASVA_CASE(EPI_BIAS_RES, true)
  ASVA_CASE(EPI_BIAS_RES, false)
#undef ASVA_CASE
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  bf16: K a multiple of 64 and N a
// multiple of 160 or 64; fp32: K a multiple of 16.  Other shapes return
// cudaErrorInvalidValue; the Python wrapper also checks shapes, dtypes and
// contiguity.  Returns cudaGetLastError() after the launch (0 = success).
extern "C" int asva_ln_gemm(int dtype, int epi, int M, int N, int K,
                            const void* a, const void* lnw, const void* lnb,
                            float eps, const void* w, const void* bias,
                            const void* res, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool ln = lnw != nullptr;
  if (epi < 0 || epi > 2 || M < 1 || N < 1 || K < 1)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (K % BK || tile_n(epi, N) == 0) return (int)cudaErrorInvalidValue;
    return dispatch_bf16(epi, ln, a, lnw, lnb, eps, w, bias, res, out, M, N,
                         K, s);
  }
  if (dtype == 0) {
    if (K % BK32) return (int)cudaErrorInvalidValue;
    dispatch_f32(epi, ln, a, lnw, lnb, eps, w, bias, res, out, M, N, K, s);
    return (int)cudaGetLastError();
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* asva_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
