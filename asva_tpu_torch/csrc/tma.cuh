// Bulk tensor copies (TMA) and mbarriers of the sm_90a kernels that stream
// 64-deep K tiles through a ring of shared-memory stages: K-gemm (gemm.cu),
// K-mix (mix.cu) and T1 (attn_variants.cu).
//
// A tile is `box rows` x 64 bf16 of a row-major 2-D tensor, landed in
// shared memory with the 128-byte swizzle (16-byte chunk p of row r holds
// columns 8 (p ^ r % 8); an 8-row group is one 1024-byte atom, so a stage
// wants 1024-byte alignment).  Thread 0 arms a stage's mbarrier with the
// bytes it expects and starts the copies; every consumer waits on the
// barrier's phase.  The host side encodes the tensor maps with
// cuTensorMapEncodeTiled, looked up through the CUDA runtime (no -lcuda at
// build time).
#pragma once

#include <cuda.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int BK = 64;                 // K tile: 64 bf16, 128 bytes a row

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

// Waits for the phase of the given parity to complete.  A phase that never
// completes (a fault in the ring) traps after about a second instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t spin = 0; !done; ++spin) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spin == (1u << 24)) __trap();
  }
}

// rows [row, row + box rows) x columns [col, col + 64) of the 2-D tensor
// of `map` into shared memory at `dst`, 128-byte swizzled; rows past the
// tensor are zero.  Completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int col, int row, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(col), "r"(row), "r"(bar)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows, 128-byte swizzle:
// 8-row groups 1024 bytes apart; a k16 step is + 32 bytes of the start
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return hop::desc(addr, 16, 1024) | (1ull << 62);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from libcuda, looked up through the runtime (no
// -lcuda at build time)
inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                     cudaEnableDefault, &q);
#else
    cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                            &q);
#endif
    if (q == cudaDriverEntryPointSuccess) fn = (EncodeTiled)p;
  }
  return fn;
}

// the first `cols` columns of a (rows, >= cols) bf16 row-major tensor whose
// rows are `ld` elements apart (ld a multiple of 8: a column block of a
// wider matrix is read in place), in boxes of box_rows x 64, 128-byte
// swizzle, rows past `rows` read as zero
inline bool tensor_map_ld(CUtensorMap* map, const void* ptr, int rows,
                          int cols, int ld, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)BK, (cuuint32_t)box_rows};
  const cuuint32_t step[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, step,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// a contiguous (rows, K) tensor
inline bool tensor_map(CUtensorMap* map, const void* ptr, int rows, int K,
                       int box_rows) {
  return tensor_map_ld(map, ptr, rows, K, K, box_rows);
}

}  // namespace
