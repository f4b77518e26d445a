// Pieces shared by the flash kernels of the "dsplit" design
// (flash_fwd_dsplit.cu, flash_bwd_dsplit.cu): every head_dim d that is a
// multiple of 128, d a runtime argument, in bf16, float16 and float32 (the
// kernels' element type T).
//
// Nothing a CTA keeps grows with d. A CTA owns one column group of
// kGroupCols = 256 output columns (of O, dQ, dK or dV; G = ceil(d / 256)
// groups, the last one narrower where 256 does not divide d: at 896 it has
// 128). Its slice of the output accumulators is [16 x 256] float32 a warp,
// 128 registers a thread. The contractions over d (S = Q K^T and dP = dO
// V^T, or their transposes) run over chunks of kChunkCols<T> columns (128 in
// bf16 and float16, 64 in float32) that stream through a cp.async ring,
// summed in registers over the chunks in order 0, 1, ... in every group, so
// every group of a row computes S (and dP) with the same instructions on the
// same bytes and gets the same bits: the groups agree on the row max, the
// sum, lse and P without talking to each other. Only the products into the
// output (P V, dS K, P^T dO, dS^T Q) read the group's own 256 columns.
//
// A tile in shared memory is a row-major array with rows padded by 16 bytes
// (kChunkRow<T>: 272 bytes a row of a chunk; kGroupRow<T>: 528 in bf16 and
// float16, 1040 in float32, a row of a column group). A 16-bit row is then
// an odd number of 16-byte units, so the 8 rows an ldmatrix phase reads fall
// on 8 distinct 16-byte bank groups, and a float32 row is 4 floats past a
// multiple of 32, so the 3xTF32 fragment loads (rows g, columns tq) touch
// 32 distinct banks.
//
// Arithmetic by T: bf16 and float16 on mma.sync m16n8k16 fed by ldmatrix
// (as wide.cuh), float32 in 3xTF32 on mma.sync m16n8k8 with the operands
// split where they are loaded (tf32_mma.cuh): S and dP take each 8-column
// step's three products in fresh registers and add them in float32, and the
// products into the output chain at most 32 rows before the float32 add, as
// the tf32x3 kernels do. Both accumulators lay out a warp's [16 x N] tile
// alike: element i at row g + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 tq
// + (i & 1), g = lane / 4, tq = lane % 4, so hopper.cuh's online_softmax
// takes either.

#pragma once

#include <type_traits>

#include "tf32_mma.cuh"
#include "wide.cuh"

namespace {

constexpr int kGroupCols = 256;  // output columns a CTA owns

template <typename T>
constexpr bool kF32 = std::is_same<T, float>::value;

// columns of one chunk of a contraction over d
template <typename T>
constexpr int kChunkCols = kF32<T> ? 64 : 128;

// row strides (bytes) of a chunk tile and of a column-group tile
template <typename T>
constexpr int kChunkRow = kChunkCols<T> * (int)sizeof(T) + 16;
template <typename T>
constexpr int kGroupRow = kGroupCols * (int)sizeof(T) + 16;

// Rows [row0, row0 + kRows) of a matrix whose rows are `ld` bytes apart
// (`src` the first byte of the columns wanted), kData bytes of each, into
// a tile with rows kStride bytes apart at `dst`, by cp.async, 16 bytes a
// thread of kThreads: zeros past `rows`, and nothing past the first `bytes`
// of a row (columns past the end of the last group, which no product
// reads). The caller commits the group.
template <int kRows, int kData, int kStride, int kThreads>
__device__ __forceinline__ void dsplit_load(uint32_t dst, const char* src, size_t ld, int row0,
                                            int rows, int bytes) {
  constexpr int kPieces = kData / 16;
#pragma unroll 4
  for (int c = threadIdx.x; c < kRows * kPieces; c += kThreads) {
    const int r = c / kPieces;
    const int piece = c % kPieces;
    if (piece * 16 >= bytes) continue;
    const bool ok = row0 + r < rows;
    cp_async_16(dst + r * kStride + piece * 16,
                src + (size_t)(ok ? row0 + r : 0) * ld + piece * 16, ok ? 16 : 0);
  }
}

// 3xTF32 fragments from float32 tiles with rows kS floats apart (split as
// they are loaded): A rows g, g + 8 and k columns k0 + tq, k0 + tq + 4 of a
// warp's 16 rows at x; B of Y^T for X Y^T (n is Y's row n0 + g); B of Y for
// X Y with the permuted k index (k slots tq and tq + 4 are Y's rows k0 + 2 tq
// and k0 + 2 tq + 1, n is column n0 + g)
template <int kS>
__device__ __forceinline__ void frag_a(FragA& f, const float* x, int k0, int g, int tq) {
  const float* p = x + g * kS + k0 + tq;
  split(p[0], f.big[0], f.small[0]);
  split(p[8 * kS], f.big[1], f.small[1]);
  split(p[4], f.big[2], f.small[2]);
  split(p[8 * kS + 4], f.big[3], f.small[3]);
}

template <int kS>
__device__ __forceinline__ void frag_b_nt(FragB& f, const float* y, int n0, int k0, int g,
                                          int tq) {
  const float* p = y + (n0 + g) * kS + k0 + tq;
  split(p[0], f.big[0], f.small[0]);
  split(p[4], f.big[1], f.small[1]);
}

template <int kS>
__device__ __forceinline__ void frag_b_nn(FragB& f, const float* y, int k0, int n0, int g,
                                          int tq) {
  const float* p = y + (k0 + 2 * tq) * kS + n0 + g;
  split(p[0], f.big[0], f.small[0]);
  split(p[kS], f.big[1], f.small[1]);
}

// s[16 x kN] += A B^T over one chunk (kChunkCols<T> columns): A a warp's 16
// rows of a chunk tile at `a` (rows kA bytes apart), B kN rows at `b` (kB
// bytes apart). The same instructions in the same order whatever the
// column group, so every group's sum has the same bits.
template <typename T, int kA, int kB, int kN>
__device__ __forceinline__ void chunk_nt(float* s, const uint8_t* a, const uint8_t* b, int lane) {
  if constexpr (kF32<T>) {
    const int g = lane >> 2, tq = lane & 3;
    const float* x = reinterpret_cast<const float*>(a);
    const float* y = reinterpret_cast<const float*>(b);
    // one 8-column step at a time: unrolled by 2, the float32 dQ (S and dP
    // beside 128 registers of dQ) spilled 8 bytes
#pragma unroll 1
    for (int k0 = 0; k0 < kChunkCols<T>; k0 += 8) {
      FragA fa;
      frag_a<kA / 4>(fa, x, k0, g, tq);
#pragma unroll
      for (int nt = 0; nt < kN / 8; ++nt) {
        FragB fb;
        frag_b_nt<kB / 4>(fb, y, 8 * nt, k0, g, tq);
        mma3_add(s + 4 * nt, fa, fb);
      }
    }
  } else {
    // lane l reads A row l % 16, 8 columns from 16 kk + 8 (l / 16); B rows
    // 16 np + l % 8 + 8 (l / 16), 8 columns from 16 kk + 8 ((l / 8) % 2)
    const uint32_t at = smem_u32(a) + (lane & 15) * kA + (lane >> 4) * 16;
    const uint32_t bt = smem_u32(b) + ((lane & 7) + ((lane >> 4) << 3)) * kB +
                        ((lane >> 3) & 1) * 16;
#pragma unroll
    for (int kk = 0; kk < kChunkCols<T> / 16; ++kk) {
      uint32_t fa[4];
      ldmatrix_x4(fa, at + kk * 32);
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        uint32_t fb[4];
        ldmatrix_x4(fb, bt + np * 16 * kB + kk * 32);
        mma_16816<T>(s + 8 * np, fa, fb[0], fb[1]);
        mma_16816<T>(s + 8 * np + 4, fa, fb[2], fb[3]);
      }
    }
  }
}

// acc[16 x kGroupCols] += P B over kK rows, the columns below `ncols` only:
// P [16 x kK] a warp's accumulator (rounded to T here, or split into 3xTF32
// fragments), B kK rows of a column-group tile at `b` (rows kB bytes apart).
template <typename T, int kB, int kK>
__device__ __forceinline__ void group_nn(float* acc, const float* p, const uint8_t* b, int ncols,
                                         int lane) {
  if constexpr (kF32<T>) {
    static_assert(kK <= kChunkRows, "a chain of products longer than kChunkRows rows");
    const int g = lane >> 2, tq = lane & 3;
    const float* y = reinterpret_cast<const float*>(b);
    FragA fa[kK / 8];
#pragma unroll
    for (int i = 0; i < kK / 8; ++i) acc_to_a(fa[i], p + 4 * i);
#pragma unroll
    for (int nt = 0; nt < kGroupCols / 8; ++nt) {
      if (8 * nt < ncols) {
        float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
        for (int i = 0; i < kK / 8; ++i) {
          FragB fb;
          frag_b_nn<kB / 4>(fb, y, 8 * i, 8 * nt, g, tq);
          mma3(part, fa[i], fb);
        }
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[4 * nt + e] += part[e];
      }
    }
  } else {
    uint32_t pa[kK / 4];
    to_a<kK, T>(p, pa);
    // lane l reads row 16 kk + l % 8 + 8 ((l / 8) % 2), 8 columns from
    // 16 dp + 8 (l / 16), transposed
    const uint32_t at = smem_u32(b) + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kB +
                        (lane >> 4) * 16;
#pragma unroll
    for (int kk = 0; kk < kK / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kGroupCols / 16; ++dp) {
        if (16 * dp < ncols) {
          uint32_t fb[4];
          ldmatrix_x4_trans(fb, at + kk * 16 * kB + dp * 32);
          mma_16816<T>(acc + 8 * dp, pa + 4 * kk, fb[0], fb[1]);
          mma_16816<T>(acc + 8 * dp + 4, pa + 4 * kk, fb[2], fb[3]);
        }
      }
    }
  }
}

// A warp's accumulator rows (row0 + g and row0 + 8 + g of a matrix whose
// rows are `ld` elements apart, those below `rows`; columns 0 .. ncols of
// the kCols at `dst`) times mul[r], in T, a pair of columns a lane at a time.
template <typename T, int kCols = kGroupCols>
__device__ __forceinline__ void store_group(T* dst, size_t ld, const float* acc, const float* mul,
                                            int row0, int rows, int ncols, int g, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= rows) continue;
    T* out = dst + (size_t)row * ld + 2 * tq;
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      if (8 * nt < ncols) {
        const float x0 = acc[4 * nt + 2 * r] * mul[r], x1 = acc[4 * nt + 2 * r + 1] * mul[r];
        if constexpr (kF32<T>) {
          *reinterpret_cast<float2*>(out + 8 * nt) = make_float2(x0, x1);
        } else {
          *reinterpret_cast<uint32_t*>(out + 8 * nt) = pack2<T>(x0, x1);
        }
      }
    }
  }
}

// The launches of one kernel over bh heads: grid.x is (heads of a launch) x
// `per_head` CTAs, at most 2^31 - 1, so as many heads go in a launch as keep
// it there; launch(h0, heads) launches heads h0 .. h0 + heads - 1 and returns
// its status. kUnsupported where one head's CTAs alone pass the limit.
template <typename F>
int launch_heads(int bh, long long per_head, F launch) {
  constexpr long long kGridX = 0x7fffffffll;
  if (per_head < 1 || per_head > kGridX) return kUnsupported;
  const long long fit = kGridX / per_head;
  const int chunk = fit < bh ? (int)fit : bh;
  for (int h0 = 0; h0 < bh; h0 += chunk) {
    const int err = launch(h0, bh - h0 < chunk ? bh - h0 : chunk);
    if (err != 0) return err;
  }
  return 0;
}

}  // namespace
