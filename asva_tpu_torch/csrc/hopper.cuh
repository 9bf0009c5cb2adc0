// Shared helpers of the sm_90a attention kernels (attn.cu, attn_bwd.cu):
// asynchronous tile copies into the layout that wgmma reads without a
// swizzle, matrix descriptors, wgmma and cp.async fences.
//
// Tile layout in shared memory: a 64-row tile of a head slice, its head dim
// padded to DP (a multiple of 16) with zeros, is stored as "core matrices"
// of 8 rows x 8 bf16 (128 contiguous bytes):
//
//   element (r, c) at byte (r / 8) * DP * 16 + (c / 8) * 128 + (r % 8) * 16
//                         + (c % 8) * 2
//
// Chunk i of 16 bytes lies at byte 16 i, so the copy loop below writes
// shared memory linearly (no bank conflicts) while each 8 consecutive
// threads fetch one 16-byte column chunk of 8 consecutive rows.  The same
// bytes serve both operand roles of wgmma:
//   * K-major (the tile's columns are the contraction, as K in Q K^T):
//     core matrices 128 bytes apart along K, DP * 16 apart along rows;
//   * MN-major (the tile's rows are the contraction, as V in P V): core
//     matrices DP * 16 bytes apart along K (rows), 128 apart along N.
#pragma once
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace hop {

typedef __nv_bfloat16 bf16;

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// wgmma matrix descriptor, no swizzle: start address, leading byte offset
// (between core matrices along K), stride byte offset (along M or N).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

template <int DP>
__device__ __forceinline__ uint64_t desc_kmajor(uint32_t addr) {
  return desc(addr, 128, DP * 16);
}

template <int DP>
__device__ __forceinline__ uint64_t desc_mnmajor(uint32_t addr) {
  return desc(addr, DP * 16, 128);
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// this thread's completed cp.async writes become visible to wgmma (the
// async proxy); a block barrier after it publishes every thread's
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving accesses to registers that an in-flight
// wgmma reads or writes across the fence/commit/wait statements
template <int R>
__device__ __forceinline__ void fence_regs(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&p);
}

// rows [row0, row0 + ROWS) x cols [0, DP) of a (rows, ld) head slice into
// the tile layout at `dst` (ROWS / 64 tiles back to back), by NT threads;
// rows >= nvalid and cols >= D are zero and are not read.
template <int DP, int NT, int ROWS = 64>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const bf16* __restrict__ src,
                                                int row0, int nvalid, int ld,
                                                int D, int tid) {
#pragma unroll
  for (int i = tid; i < ROWS * DP / 8; i += NT) {
    const int r = (i / DP) * 8 + (i & 7), c = ((i >> 3) % (DP / 8)) * 8;
    const bool ok = row0 + r < nvalid && c < D;
    cp_async16(dst + i * 16, ok ? src + (size_t)(row0 + r) * ld + c : src,
               ok);
  }
}

}  // namespace hop
