// The cp.async tile loads and hand-overs that the float32 flash kernels
// share, beside 3xTF32 on mma.sync.m16n8k8 (tf32_mma.cuh):
// csrc/flash_fwd_f32.cu (the forward) and csrc/flash_bwd_f32.cu (dQ and
// dK/dV) include it. Everything here is device code in an anonymous
// namespace, so each source gets its own copy.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32_mma.cuh"

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

// 16 bytes global -> shared, zero-filled when !valid (src is then not read)
__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// every copy this thread issued has landed
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// all but the newest kPending groups of copies this thread committed have
// landed
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// named barrier `id` over the `threads` threads of a group of warps
__device__ __forceinline__ void group_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Rows [row0, row0 + kRows) of a [rows, D] float32 matrix into a shared
// tile with row stride kStride (by default D + 4), by cp.async; rows past
// the end are zero.
template <int D, int kRows, int kThreads, int kStride = D + 4>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int row0, int rows) {
  constexpr int kChunks = D / 4;
#pragma unroll 4
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 4;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * kStride + col, src + (size_t)(ok ? row0 + r : 0) * D + col, ok);
  }
}

// A warp's accumulator tile (kNT n-tiles) to a hand-over tile of its group
// and back, in the registers' layout (a float4 a lane; buf is the lane's
// first).
template <int kNT>
__device__ __forceinline__ void hand_over(float4* buf, const float (*x)[4]) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    buf[nt * 32] = make_float4(x[nt][0], x[nt][1], x[nt][2], x[nt][3]);
  }
}

template <int kNT>
__device__ __forceinline__ void take_over(float (*x)[4], const float4* buf) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    const float4 v = buf[nt * 32];
    x[nt][0] = v.x;
    x[nt][1] = v.y;
    x[nt][2] = v.z;
    x[nt][3] = v.w;
  }
}

}  // namespace
