// Pieces shared by the flash kernels of the "dcluster" design
// (flash_fwd_dcluster.cu, flash_bwd_dcluster.cu): every head_dim d that is a
// multiple of 128, d a runtime argument, in bf16, float16 and float32 (the
// kernels' element type T).
//
// The CTAs that share one resident tile form a thread-block cluster of C <=
// kMaxCluster CTAs, launched with cudaLaunchKernelEx (ClusterConfig). The
// plan (make_plan; ops/dcluster.py's dcluster_plan in Python) cuts d into G
// groups of kGroupCols = 256 columns, P = ceil(G / 8) passes and C =
// ceil(G / P) CTAs; CTA c owns the columns of groups c P .. c P + P - 1.
// Each CTA computes its partial of a contraction over d (S, dP) over its own
// columns only (partial_smem from resident tiles at one pass, partial_global
// from L2 past it), and pushes it to the CTA that reduces it over
// distributed shared memory (map_cluster, st_async: stores that complete on
// the receiver's mbarrier, so no cluster barrier an item); the reducer sums
// the partials in group order and pushes what it makes back to every CTA,
// which then updates only its own output columns (rows32_nn).
//
// Tiles of a group in shared memory: float32 rows of 256 floats whose
// 16-byte pieces are XOR-swizzled by the row's low three bits, bf16 and
// float16 rows padded by 16 bytes (kTileRow); load_tile fills them by
// cp.async.

#pragma once

#include "dsplit.cuh"

namespace {

constexpr int kClusterThreads = 256;  // 8 warps a CTA
constexpr int kMaxCluster = 8;        // the portable cluster size

// A tile row of a group in shared memory: float32 rows are 256 floats with
// their 16-byte pieces XOR-swizzled by the row's low three bits (column c of
// row r at r * 256 + (c ^ 4 (r % 8))), so the 3xTF32 fragment loads (rows g,
// columns tq, or rows 2 tq, columns g) touch 32 distinct banks with no
// padding; bf16 and float16 rows are padded by 16 bytes for ldmatrix
// (kGroupRow<T>).
template <typename T>
constexpr int kTileRow = kF32<T> ? kGroupCols * 4 : kGroupRow<T>;

// Rows [row0, row0 + kRows) of a matrix whose rows are `ld` bytes apart
// (`src` the first byte of the group's columns), the first `bytes` of each,
// into a tile at `dst` by cp.async, 16 bytes a thread: zeros past `rows`.
// The caller commits the group.
template <typename T, int kRows>
__device__ __forceinline__ void load_tile(uint32_t dst, const char* src, size_t ld, int row0,
                                          int rows, int bytes) {
  constexpr int kPieces = kGroupCols * (int)sizeof(T) / 16;
#pragma unroll 4
  for (int c = threadIdx.x; c < kRows * kPieces; c += kClusterThreads) {
    const int r = c / kPieces;
    const int piece = c % kPieces;
    if (piece * 16 >= bytes) continue;
    const bool ok = row0 + r < rows;
    const int at = kF32<T> ? piece ^ (r & 7) : piece;
    cp_async_16(dst + r * kTileRow<T> + at * 16,
                src + (size_t)(ok ? row0 + r : 0) * ld + piece * 16, ok ? 16 : 0);
  }
}

struct Plan {
  int groups;   // G, column groups of kGroupCols
  int passes;   // P, output groups a CTA writes
  int cluster;  // C, CTAs a cluster
};

inline Plan make_plan(int d) {
  Plan pl;
  pl.groups = (d + kGroupCols - 1) / kGroupCols;
  pl.passes = (pl.groups + kMaxCluster - 1) / kMaxCluster;
  pl.cluster = (pl.groups + pl.passes - 1) / pl.passes;
  return pl;
}

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster: the writes before it are seen by
// the cluster's reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// the shared::cluster address of `addr` (in this CTA's shared memory) in CTA
// `rank` of the cluster
__device__ __forceinline__ uint32_t map_cluster(uint32_t addr, uint32_t rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(out) : "r"(addr), "r"(rank));
  return out;
}

// 16 bytes into the shared memory of a CTA of the cluster, completing on
// that CTA's mbarrier `bar` (both shared::cluster addresses): no release is
// needed, the receiver waits on its mbarrier
__device__ __forceinline__ void st_async(uint32_t addr, float4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar)
      : "memory");
}

// the same, 8 bytes
__device__ __forceinline__ void st_async(uint32_t addr, float2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "f"(v.x), "f"(v.y), "r"(bar)
      : "memory");
}

// s[16 x 16] += A B^T over the first `cols` columns (a multiple of 128) of
// two tiles in shared memory: A a warp's 16 rows at a, B 16 rows at b (each
// the first of 8 rows of its tile, kTileRow<T> apart); chunk by chunk in
// column order.
template <typename T>
__device__ __forceinline__ void partial_smem(float* s, const uint8_t* a, const uint8_t* b, int cols,
                                             int lane) {
  constexpr int kG = kTileRow<T>;
  if constexpr (kF32<T>) {
    const int g = lane >> 2, tq = lane & 3;
    const float* x = reinterpret_cast<const float*>(a);
    const float* y = reinterpret_cast<const float*>(b);
    // the swizzled columns of k-step j of each 32-column block (rows g and
    // g + 8 of a block of 8 share them): so that after unrolling every
    // address is a register plus a constant
    int lo[4], hi[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      lo[j] = (8 * j + tq) ^ (g << 2);
      hi[j] = (8 * j + tq + 4) ^ (g << 2);
    }
    const float* xg = x + g * kGroupCols;
    const float* yg = y + g * kGroupCols;
#pragma unroll 1
    for (int c = 0; c < cols; c += 128) {
#pragma unroll
      for (int k0 = c; k0 < c + 128; k0 += 8) {
        const int blk = k0 & ~31, j = (k0 >> 3) & 3;
        FragA fa;
        split(xg[blk + lo[j]], fa.big[0], fa.small[0]);
        split(xg[8 * kGroupCols + blk + lo[j]], fa.big[1], fa.small[1]);
        split(xg[blk + hi[j]], fa.big[2], fa.small[2]);
        split(xg[8 * kGroupCols + blk + hi[j]], fa.big[3], fa.small[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          FragB fb;
          split(yg[8 * nt * kGroupCols + blk + lo[j]], fb.big[0], fb.small[0]);
          split(yg[8 * nt * kGroupCols + blk + hi[j]], fb.big[1], fb.small[1]);
          mma3_add(s + 4 * nt, fa, fb);
        }
      }
    }
  } else {
#pragma unroll 1
    for (int c = 0; c < cols; c += kChunkCols<T>) {
      chunk_nt<T, kG, kG, 16>(s, a + c * (int)sizeof(T), b + c * (int)sizeof(T), lane);
    }
  }
}

// s[16 x 16] += A B^T over columns [c0, c1) read from global memory (the
// plans of more than one pass): A the 16 rows from a_row0 of a matrix of
// a_rows rows, B the 16 from b_row0 of one of b_rows, both `ld` elements a
// row; rows past the end read as zeros. The fragments are mma.sync's, as
// ldmatrix or frag_a / frag_b_nt give them from a tile.
template <typename T>
__device__ __forceinline__ void partial_global(float* s, const T* a, int a_row0, int a_rows,
                                               const T* b, int b_row0, int b_rows, int ld,
                                               int c0, int c1, int lane) {
  const int g = lane >> 2, tq = lane & 3;
  const T* ar[2];
  const T* br[2];
  bool aok[2], bok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int ra = a_row0 + g + 8 * r, rb = b_row0 + 8 * r + g;
    aok[r] = ra < a_rows;
    bok[r] = rb < b_rows;
    ar[r] = a + (size_t)(aok[r] ? ra : 0) * ld;
    br[r] = b + (size_t)(bok[r] ? rb : 0) * ld;
  }
  if constexpr (kF32<T>) {
    auto at = [](const float* row, bool ok, int col) { return ok ? row[col] : 0.f; };
#pragma unroll 1
    for (int k0 = c0; k0 < c1; k0 += 8) {
      FragA fa;
      split(at(ar[0], aok[0], k0 + tq), fa.big[0], fa.small[0]);
      split(at(ar[1], aok[1], k0 + tq), fa.big[1], fa.small[1]);
      split(at(ar[0], aok[0], k0 + tq + 4), fa.big[2], fa.small[2]);
      split(at(ar[1], aok[1], k0 + tq + 4), fa.big[3], fa.small[3]);
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        FragB fb;
        split(at(br[nt], bok[nt], k0 + tq), fb.big[0], fb.small[0]);
        split(at(br[nt], bok[nt], k0 + tq + 4), fb.big[1], fb.small[1]);
        mma3_add(s + 4 * nt, fa, fb);
      }
    }
  } else {
    auto at = [](const T* row, bool ok, int col) {
      return ok ? *reinterpret_cast<const uint32_t*>(row + col) : 0u;
    };
#pragma unroll 1
    for (int k0 = c0; k0 < c1; k0 += 16) {
      const uint32_t fa[4] = {at(ar[0], aok[0], k0 + 2 * tq), at(ar[1], aok[1], k0 + 2 * tq),
                              at(ar[0], aok[0], k0 + 2 * tq + 8),
                              at(ar[1], aok[1], k0 + 2 * tq + 8)};
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mma_16816<T>(s + 4 * nt, fa, at(br[nt], bok[nt], k0 + 2 * tq),
                     at(br[nt], bok[nt], k0 + 2 * tq + 8));
      }
    }
  }
}

// acc[32 x kCols] += A B over 32 rows: A [32 x 32] as two warp
// accumulators (rows 0-15 at a, rows 16-31 at a + 16; rounded to T, or split
// into 3xTF32 fragments, once), B the 32 rows of a tile (rows kB bytes
// apart), kCols columns from b, a multiple of 32 columns into the row; acc holds rows 0-15 and then rows 16-31,
// kCols / 2 floats each. Each B fragment feeds both halves of A.
template <typename T, int kB, int kCols>
__device__ __forceinline__ void rows32_nn(float* acc, const float* a, const uint8_t* b, int lane) {
  constexpr int kHalf = kCols / 2;
  if constexpr (kF32<T>) {
    const int g = lane >> 2, tq = lane & 3;
    const float* y = reinterpret_cast<const float*>(b);
    FragA fa[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int i = 0; i < 4; ++i) acc_to_a(fa[m][i], a + 16 * m + 4 * i);
    }
    // B's rows 8 i + 2 tq and + 1 (the permuted k index), column 8 nt + g:
    // the swizzled column of n-tile j of each 32-column block, for each row
    int col0[4], col1[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      col0[j] = (8 * j + g) ^ (tq << 3);
      col1[j] = (8 * j + g) ^ ((tq << 3) + 4);
    }
    const float* y0 = y + 2 * tq * kGroupCols;
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      // B's loads hoisted at most two n-tiles ahead: more holds dK/dV's
      // registers past 255
      if (nt % 2 == 0) asm volatile("" ::: "memory");
      const int blk = 8 * nt & ~31, j = nt & 3;
      float part[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        FragB fb;
        split(y0[8 * i * kGroupCols + blk + col0[j]], fb.big[0], fb.small[0]);
        split(y0[(8 * i + 1) * kGroupCols + blk + col1[j]], fb.big[1], fb.small[1]);
        mma3(part[0], fa[0][i], fb);
        mma3(part[1], fa[1][i], fb);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        acc[4 * nt + e] += part[0][e];
        acc[kHalf + 4 * nt + e] += part[1][e];
      }
    }
  } else {
    uint32_t pa[2][8];
    to_a<32, T>(a, pa[0]);
    to_a<32, T>(a + 16, pa[1]);
    // lane l reads row 16 kk + l % 8 + 8 ((l / 8) % 2), 8 columns from
    // 16 dp + 8 (l / 16), transposed
    const uint32_t at = smem_u32(b) + ((lane & 7) + (((lane >> 3) & 1) << 3)) * kB +
                        (lane >> 4) * 16;
#pragma unroll
    for (int kk = 0; kk < 2; ++kk) {
#pragma unroll
      for (int dp = 0; dp < kCols / 16; ++dp) {
        uint32_t fb[4];
        ldmatrix_x4_trans(fb, at + kk * 16 * kB + dp * 32);
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          mma_16816<T>(acc + m * kHalf + 8 * dp, pa[m] + 4 * kk, fb[0], fb[1]);
          mma_16816<T>(acc + m * kHalf + 8 * dp + 4, pa[m] + 4 * kk, fb[2], fb[3]);
        }
      }
    }
  }
}

// cudaLaunchKernelEx's configuration of a grid of `ctas` in clusters of `cluster`
struct ClusterConfig {
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  ClusterConfig(unsigned ctas, int cluster, int bytes, cudaStream_t stream) {
    cfg.gridDim = dim3(ctas, 1, 1);
    cfg.blockDim = dim3(kClusterThreads, 1, 1);
    cfg.dynamicSmemBytes = bytes;
    cfg.stream = stream;
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = cluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// f(T{}) for the dtype code (0 bf16, 1 float32, 2 float16), `otherwise` for
// any other
template <typename F>
int with_dtype(int dtype, int otherwise, F f) {
  switch (dtype) {
    case 0: return f(__nv_bfloat16{});
    case 1: return f(float{});
    case 2: return f(__half{});
  }
  return otherwise;
}

}  // namespace
