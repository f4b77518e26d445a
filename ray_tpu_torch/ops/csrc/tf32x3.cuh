// 3xTF32 on mma.sync.m16n8k8 and the cp.async tile loads that the float32
// flash kernels share: csrc/flash_fwd_f32.cu (the forward) and
// csrc/flash_bwd_f32.cu (dQ and dK/dV) include it. Everything here is
// device code in an anonymous namespace, so each source gets its own copy.
//
// Each operand x is split into big = cvt.rna.tf32(x) and small =
// cvt.rna.tf32(x - big), so big + small is x to 2^-22 of |x| (split); a
// product adds small*big', big*small' and big*big' and drops small*small'
// (at most 2^-22 of |x x'|). ops/tf32.py repeats the operand rounding on
// the CPU. The accumulator layout of m16n8k8 is not its A layout; a
// product whose A is an accumulator permutes its k index instead: k slot t
// of an 8-wide step is column 2t of the accumulator tile and slot t + 4
// column 2t + 1, and the caller reads the B operand's rows in the same
// order, which leaves the sum unchanged.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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

// ---------------------------------------------------------------------------
// 3xTF32 on mma.sync.m16n8k8
// ---------------------------------------------------------------------------

// x = big + small for the tensor cores, which read a tf32 operand's top 19
// bits and ignore its low 13. big is x rounded to the nearest tf32, ties
// away from zero, and small is x - big (exact in float32) rounded so too:
// cvt.rna.tf32.f32 of each, for every input but NaN, in integer operations
// ((bits + 0x1000) with the low 13 bits cleared; small's are left for the
// cores to ignore). ptxas lowers cvt.rna to four operations with a NaN test
// (the variant "cvt.rna split" of the variants scripts). For a NaN input
// x - big is NaN, so the product that reads small is NaN too.
__device__ __forceinline__ void split(float x, uint32_t& big, uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;
}

struct FragA {
  uint32_t big[4];
  uint32_t small[4];
};

struct FragB {
  uint32_t big[2];
  uint32_t small[2];
};

__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c = a b + 0: a sum in fresh registers
__device__ __forceinline__ void mma_tf32_fresh(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(c[0]), "=f"(c[1]), "=f"(c[2]), "=f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]), "f"(0.f));
}

// c += a b in 3xTF32: the two small terms first, then big * big
__device__ __forceinline__ void mma3(float* c, const FragA& a, const FragB& b) {
  mma_tf32(c, a.small, b.big);
  mma_tf32(c, a.big, b.small);
  mma_tf32(c, a.big, b.big);
}

// The tensor cores round the sum inside an mma toward zero, relative to the
// largest of its terms and the accumulator, so a long chain of mma into one
// accumulator drifts toward zero: dP summed over gpt_1b's 128 columns of d
// in one chain (48 mma) put 2.3e-4 of a row's norm into the first causal
// rows of dQ on an H100 (their dS is dP - delta, which cancels), against the
// 1e-4 gate. So S and dP (reductions over d) take each 8-column step's
// three products in fresh registers and add them in float32 (round to
// nearest); the long reductions over the streamed axis (dQ over kv, dK and
// dV over q) chain kChunkRows rows (12 mma) before the float32 add.
__device__ __forceinline__ void mma3_add(float* c, const FragA& a, const FragB& b) {
  float t[4];
  mma_tf32_fresh(t, a.small, b.big);
  mma_tf32(t, a.big, b.small);
  mma_tf32(t, a.big, b.big);
#pragma unroll
  for (int e = 0; e < 4; ++e) c[e] += t[e];
}

constexpr int kChunkRows = 32;

// A fragment from an accumulator n-tile (rows g, g + 8; columns 2 tig,
// 2 tig + 1) with the permuted k index: slot tig is column 2 tig, slot
// tig + 4 column 2 tig + 1.
__device__ __forceinline__ void acc_to_a(FragA& f, const float* x) {
  split(x[0], f.big[0], f.small[0]);
  split(x[2], f.big[1], f.small[1]);
  split(x[1], f.big[2], f.small[2]);
  split(x[3], f.big[3], f.small[3]);
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
