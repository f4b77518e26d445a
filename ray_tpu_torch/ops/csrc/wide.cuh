// Pieces shared by the flash kernels of the "wide" design
// (flash_fwd_wide.cu, flash_bwd_wide.cu): bf16 or float16 at head_dim 384,
// 512, 640 and 768 (with_wide_head_dim), every product on mma.sync m16n8k16
// fed by ldmatrix from padded tiles that cp.async fills.
//
// A tile is a row-major [rows, D] array of T in shared memory whose rows lie
// kRowBytes<D> = 2 D + 16 bytes apart: 16-byte chunk c of row r at
// r * kRowBytes + 16 c. An ldmatrix phase reads 8 rows at one column, and
// (2 D + 16) / 16 is odd at every D that is a multiple of 128, so the 8
// chunks fall on 8 distinct 16-byte bank groups.
//
// Each warp owns 16 rows and kWideCols = 128 columns of d: its float32
// accumulator [16 x 128] is 64 registers a thread, where [16 x 512] would be
// 256, past the 255 a thread may hold. A product that sums over d (S = Q
// K^T, dP = dO V^T and their transposes) is summed by each warp over its
// own 128 columns; the D / 128 warps of the same rows hand their partial
// sums over in shared memory (put_partial) and each adds them in one order
// (sum_partials), so all of them hold the same bits.
//
// Element i of a warp's accumulator [16 x N] (a float array of N / 2) sits
// at row g + 8 ((i >> 1) & 1) and column 8 (i >> 2) + 2 tq + (i & 1), g =
// lane / 4, tq = lane % 4: the layout of a wgmma accumulator, so hopper.cuh's
// online_softmax and to_a take it as they are.

#pragma once

#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kWideCols = 128;  // d columns a warp owns

// f(std::integral_constant<int, D>{}) at d == D for each head_dim the design
// takes, `otherwise` at any other d
template <typename F>
int with_wide_head_dim(int d, int otherwise, F f) {
  switch (d) {
    case 384: return f(std::integral_constant<int, 384>{});
    case 512: return f(std::integral_constant<int, 512>{});
    case 640: return f(std::integral_constant<int, 640>{});
    case 768: return f(std::integral_constant<int, 768>{});
  }
  return otherwise;
}

template <int D>
constexpr int kRowBytes = 2 * D + 16;

// Rows [row0, row0 + kRows) of a [rows, D] matrix of T into the padded tile
// at `dst` by cp.async, 16 bytes a thread of kThreads, zeros past `rows`;
// the caller commits the group.
template <int D, int kRows, int kThreads, typename T>
__device__ __forceinline__ void load_rows(uint32_t dst, const T* src, int row0, int rows) {
  constexpr int kChunks = D / 8;  // 16-byte chunks a row
#pragma unroll 4
  for (int c = threadIdx.x; c < kRows * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int chunk = c % kChunks;
    const bool ok = row0 + r < rows;
    cp_async_16(dst + r * kRowBytes<D> + chunk * 16,
                src + (size_t)(ok ? row0 + r : 0) * D + chunk * 8, ok ? 16 : 0);
  }
}

// The A fragments of a warp's 16 rows of a padded tile (`rows` the address
// of the first), over kK columns from c0: k-step kk (columns c0 + 16 kk ..
// + 15) in a[kk]. Lane l reads row l % 16, 8 columns from c0 + 16 kk + 8 (l /
// 16).
template <int D, int kK>
__device__ __forceinline__ void wide_a_frags(uint32_t (*a)[4], uint32_t rows, int c0,
                                             int lane) {
  const uint32_t at = rows + (lane & 15) * kRowBytes<D> + (c0 / 8 + (lane >> 4)) * 16;
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) ldmatrix_x4(a[kk], at + kk * 32);
}

// acc[16 x kN] = A B^T over kK columns from c0: A the warp's fragments
// (wide_a_frags), B kN rows of a padded tile (`rows` the first). n-tiles 2 np
// and 2 np + 1 take B rows 16 np .. 16 np + 15; lane l reads row 16 np + l % 8
// + 8 (l / 16), 8 columns from c0 + 16 kk + 8 ((l / 8) % 2).
template <int D, int kN, int kK, typename T>
__device__ __forceinline__ void wide_nt(float* acc, const uint32_t (*a)[4], uint32_t rows,
                                        int c0, int lane) {
#pragma unroll
  for (int i = 0; i < kN / 2; ++i) acc[i] = 0.f;
  const uint32_t at = rows + ((lane & 7) + ((lane >> 4) << 3)) * kRowBytes<D> +
                      (c0 / 8 + ((lane >> 3) & 1)) * 16;
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
#pragma unroll
    for (int np = 0; np < kN / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, at + np * 16 * kRowBytes<D> + kk * 32);
      mma_16816<T>(acc + 8 * np, a[kk], b[0], b[1]);
      mma_16816<T>(acc + 8 * np + 4, a[kk], b[2], b[3]);
    }
  }
}

// acc[16 x kCols] += A B over kK rows: A [16 x kK] in registers in the
// A-operand layout (to_a), B kK rows of a padded tile from column c0, read
// transposed (ldmatrix .trans). Lane l reads row 16 kk + l % 8 + 8 ((l / 8)
// % 2), 8 columns from c0 + 16 dp + 8 (l / 16).
template <int D, int kK, int kCols, typename T>
__device__ __forceinline__ void wide_nn(float* acc, const uint32_t* a, uint32_t rows, int c0,
                                        int lane) {
  const uint32_t at = rows + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kRowBytes<D> +
                      (c0 / 8 + (lane >> 4)) * 16;
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
#pragma unroll
    for (int dp = 0; dp < kCols / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, at + kk * 16 * kRowBytes<D> + dp * 32);
      mma_16816<T>(acc + 8 * dp, a + 4 * kk, b[0], b[1]);
      mma_16816<T>(acc + 8 * dp + 4, a + 4 * kk, b[2], b[3]);
    }
  }
}

// A warp's partial [16 x kN] accumulator into its hand-over slot, a float4 a
// lane at a time (`slot` the lane's first; the slot's float4s are 32 apart).
template <int kN>
__device__ __forceinline__ void put_partial(float4* slot, const float* x) {
#pragma unroll
  for (int i = 0; i < kN / 8; ++i) {
    slot[32 * i] = make_float4(x[4 * i], x[4 * i + 1], x[4 * i + 2], x[4 * i + 3]);
  }
}

// x = the sum of kParts partials in slots `stride` float4s apart (`slots`
// the lane's first of slot 0), added in order 0, 1, ...
template <int kN, int kParts>
__device__ __forceinline__ void sum_partials(float* x, const float4* slots, int stride) {
#pragma unroll
  for (int i = 0; i < kN / 8; ++i) {
    const float4 v = slots[32 * i];
    x[4 * i] = v.x;
    x[4 * i + 1] = v.y;
    x[4 * i + 2] = v.z;
    x[4 * i + 3] = v.w;
  }
#pragma unroll
  for (int h = 1; h < kParts; ++h) {
#pragma unroll
    for (int i = 0; i < kN / 8; ++i) {
      const float4 v = slots[h * stride + 32 * i];
      x[4 * i] += v.x;
      x[4 * i + 1] += v.y;
      x[4 * i + 2] += v.z;
      x[4 * i + 3] += v.w;
    }
  }
}

// named barrier `id` over the `threads` threads of a group of warps
__device__ __forceinline__ void warps_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A warp's accumulator rows (row0 + g and row0 + 8 + g of a [rows, D]
// matrix, those below `rows`; columns c0 .. c0 + kCols) times `mul`, in T,
// a pair of columns a lane at a time.
template <int D, int kCols, typename T>
__device__ __forceinline__ void store_wide_rows(T* dst, const float* acc, const float* mul,
                                                int row0, int rows, int c0, int g, int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    if (row >= rows) continue;
    uint32_t* out = reinterpret_cast<uint32_t*>(dst + (size_t)row * D + c0 + 2 * tq);
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      out[4 * nt] = pack2<T>(acc[4 * nt + 2 * r] * mul[r], acc[4 * nt + 2 * r + 1] * mul[r]);
    }
  }
}

// The head and the index of the tile among the head's n_tiles of launch
// slot `index`: heads in groups of `group` whose streamed tiles fit in L2
// together, each tile index across the group's heads, tile 0 first.
__device__ __forceinline__ void slot_head_tile(int index, int bh_total, int n_tiles, int group,
                                               int* bh, int* tile) {
  const int per_group = group * n_tiles;
  const int head0 = index / per_group * group;
  const int heads = min(group, bh_total - head0);
  const int rank = index % per_group;
  *bh = head0 + rank % heads;
  *tile = rank / heads;
}

// the CTA's head and tile, a CTA a slot
__device__ __forceinline__ void wide_slot(int bh_total, int n_tiles, int group, int* bh,
                                          int* tile) {
  slot_head_tile(blockIdx.x, bh_total, n_tiles, group, bh, tile);
}

}  // namespace
