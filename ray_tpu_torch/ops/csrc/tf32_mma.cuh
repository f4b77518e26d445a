// 3xTF32 on mma.sync.m16n8k8: the operand split and the products that the
// float32 flash kernels share (tf32x3.cuh, for csrc/flash_fwd_f32.cu and
// csrc/flash_bwd_f32.cu, and dsplit.cuh, for the float32 builds of
// csrc/flash_fwd_dsplit.cu and csrc/flash_bwd_dsplit.cu). Device code only,
// in an anonymous namespace, with no other include than the CUDA runtime's,
// so it sits beside either set of copy helpers.
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

}  // namespace
