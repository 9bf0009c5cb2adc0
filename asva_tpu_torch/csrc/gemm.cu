// K-gemm: tiled GEMM with an optional LayerNorm prologue and one of three
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
// layout (out, in), read in place (K contiguous, as mma's "col" operand).
//   prologue (optional): fp32 row mean / two-pass variance over the full K,
//     the row normalised and cast to the input dtype (pallas _ln_rows :94).
//   epilogue 0: cast and store.
//   epilogue 1 (GEGLU): W holds [value; gate] rows (2N, K) and bias (2N);
//     out = v * gelu_erf(g), v = acc_v + b[n], g = acc_g + b[N + n], with a
//     true erff (the Pallas A&S erf approximation is a Mosaic workaround).
//   epilogue 2: out = res + (acc + bias) in fp32, then cast.
// bf16: mma.sync m16n8k16 (fp32 accumulate) from shared-memory tiles, 64x64
// block tile, 4 warps of 32x32, the next K tile prefetched into registers.
// fp32: a plain FMA path, 64x64 tile, 256 threads of 4x4.
//
// What bounds it on the H100: at the FF's M = 24576 tokens (2 clips x 12
// frames x 32x32) the projections are compute-bound (e.g. C=320 ->
// 2560: 2*M*K*N = 40 GFLOP vs 31 MB of traffic).  This simple design does
// nothing about that yet: no wgmma, no TMA, no multi-stage smem ring, so it
// reaches a fraction of the tensor-core peak.  wgmma + TMA is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

enum { EPI_STORE = 0, EPI_GEGLU = 1, EPI_BIAS_RES = 2 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 from_f<bf16>(float v) {
  return __float2bfloat16_rn(v);
}

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

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a,
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------- bf16 ---

constexpr int BM = 64, BN = 64;
constexpr int BK16 = 32, LDS16 = BK16 + 8;  // +8: conflict-free fragments

template <int EPI, bool LN>
__global__ void __launch_bounds__(128)
gemm_bf16_kernel(const bf16* __restrict__ a, const bf16* __restrict__ lnw,
                 const bf16* __restrict__ lnb, float eps,
                 const bf16* __restrict__ w, const bf16* __restrict__ bias,
                 const bf16* __restrict__ res, bf16* __restrict__ out,
                 int M, int N, int K) {
  constexpr int NB = (EPI == EPI_GEGLU) ? 2 : 1;
  __shared__ __align__(16) bf16 As[BM][LDS16];
  __shared__ __align__(16) bf16 Bs[NB][BN][LDS16];
  __shared__ float mean_s[BM], rstd_s[BM];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int wm = (warp >> 1) * 32, wn = (warp & 1) * 32;

  if (LN) {
    row_stats(a, M, K, m0, BM, eps, mean_s, rstd_s);
    __syncthreads();
  }

  float acc[NB][2][4][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][i][j][e] = 0.f;

  // a 64x32 tile is 256 chunks of 8 bf16: chunk c -> row c/4, col (c%4)*8
  uint4 ra[2], rb[NB][2];
  const int nk = K / BK16;

  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 128, r = c >> 2, col = (c & 3) * 8;
      const int m = m0 + r;
      ra[i] = m < M ? *reinterpret_cast<const uint4*>(a + (size_t)m * K + k0 + col)
                    : make_uint4(0, 0, 0, 0);
#pragma unroll
      for (int nb = 0; nb < NB; ++nb) {
        const int n = n0 + r;
        rb[nb][i] = n < N ? *reinterpret_cast<const uint4*>(
                                w + ((size_t)nb * N + n) * K + k0 + col)
                          : make_uint4(0, 0, 0, 0);
      }
    }
  };
  auto store = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int c = tid + i * 128, r = c >> 2, col = (c & 3) * 8;
      uint4 v = ra[i];
      if (LN) {
        bf16* e = reinterpret_cast<bf16*>(&v);
        const float mu = mean_s[r], rs = rstd_s[r];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int k = k0 + col + j;
          e[j] = __float2bfloat16_rn((to_f(e[j]) - mu) * rs * to_f(lnw[k]) +
                                     to_f(lnb[k]));
        }
      }
      *reinterpret_cast<uint4*>(&As[r][col]) = v;
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
        *reinterpret_cast<uint4*>(&Bs[nb][r][col]) = rb[nb][i];
    }
  };

  load(0);
  for (int kt = 0; kt < nk; ++kt) {
    store(kt * BK16);
    __syncthreads();
    if (kt + 1 < nk) load((kt + 1) * BK16);
#pragma unroll
    for (int kk = 0; kk < BK16; kk += 16) {
      uint32_t af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const int r = wm + mt * 16 + g;
        af[mt][0] = *reinterpret_cast<const uint32_t*>(&As[r][kk + t4 * 2]);
        af[mt][1] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + t4 * 2]);
        af[mt][2] = *reinterpret_cast<const uint32_t*>(&As[r][kk + t4 * 2 + 8]);
        af[mt][3] = *reinterpret_cast<const uint32_t*>(&As[r + 8][kk + t4 * 2 + 8]);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int n = wn + nt * 8 + g;
          const uint32_t b0 =
              *reinterpret_cast<const uint32_t*>(&Bs[nb][n][kk + t4 * 2]);
          const uint32_t b1 =
              *reinterpret_cast<const uint32_t*>(&Bs[nb][n][kk + t4 * 2 + 8]);
#pragma unroll
          for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[nb][mt][nt], af[mt], b0, b1);
        }
    }
    __syncthreads();
  }

#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int r0 = m0 + wm + mt * 16 + g;
      const int c0 = n0 + wn + nt * 8 + t4 * 2;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int m = r0 + (e >> 1) * 8, n = c0 + (e & 1);
        epilogue<bf16, EPI>(m, n, acc[0][mt][nt][e],
                            acc[NB - 1][mt][nt][e], M, N, bias, res, out);
      }
    }
}

// ---------------------------------------------------------------- fp32 ---

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

template <typename T, int EPI, bool LN>
void launch(const void* a, const void* lnw, const void* lnb, float eps,
            const void* w, const void* bias, const void* res, void* out,
            int M, int N, int K, cudaStream_t s) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (sizeof(T) == 2) {
    gemm_bf16_kernel<EPI, LN><<<grid, 128, 0, s>>>(
        (const bf16*)a, (const bf16*)lnw, (const bf16*)lnb, eps,
        (const bf16*)w, (const bf16*)bias, (const bf16*)res, (bf16*)out, M, N, K);
  } else {
    gemm_f32_kernel<EPI, LN><<<grid, 256, 0, s>>>(
        (const float*)a, (const float*)lnw, (const float*)lnb, eps,
        (const float*)w, (const float*)bias, (const float*)res, (float*)out,
        M, N, K);
  }
}

template <typename T>
void dispatch(int epi, bool ln, const void* a, const void* lnw,
              const void* lnb, float eps, const void* w, const void* bias,
              const void* res, void* out, int M, int N, int K,
              cudaStream_t s) {
#define ASVA_CASE(E, L)                                                   \
  if (epi == E && ln == L) {                                              \
    launch<T, E, L>(a, lnw, lnb, eps, w, bias, res, out, M, N, K, s);     \
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

// dtype: 0 = float32, 1 = bfloat16.  K must be a multiple of 32 (bf16) or
// 16 (fp32); the Python wrapper checks shapes, dtypes and contiguity.
// Returns cudaGetLastError() after the launch (0 = success).
extern "C" int asva_ln_gemm(int dtype, int epi, int M, int N, int K,
                            const void* a, const void* lnw, const void* lnb,
                            float eps, const void* w, const void* bias,
                            const void* res, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool ln = lnw != nullptr;
  if (epi < 0 || epi > 2) return (int)cudaErrorInvalidValue;
  if (dtype == 1) {
    if (K % BK16) return (int)cudaErrorInvalidValue;
    dispatch<bf16>(epi, ln, a, lnw, lnb, eps, w, bias, res, out, M, N, K, s);
  } else if (dtype == 0) {
    if (K % BK32) return (int)cudaErrorInvalidValue;
    dispatch<float>(epi, ln, a, lnw, lnb, eps, w, bias, res, out, M, N, K, s);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* asva_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
