// Flash-attention backward for Hopper (sm_90a) in bf16 and float16 at head_dims
// 384, 512, 640 and 768 (it builds for every multiple of 128 from 256 to
// 1024, d a runtime argument): design "dcluster128", the output's columns
// split over the CTAs of a thread-block cluster in groups of 128, every
// product on wgmma with its shared-memory operands brought by TMA.
// Hand-written CUDA C++.
//
// Replaces the two TPU kernels of ray_tpu/ops/attention.py launched by
// _flash_attention_tpu_bwd, in bf16 and float16 at head_dims 384 to 768
// (BWD_DESIGNS in ops/attention.py):
//   * _flash_bwd_dq_kernel  -> flash_bwd_dq_dcluster128_wgmma_kernel  (dQ);
//   * _flash_bwd_dkv_kernel -> flash_bwd_dkv_dcluster128_wgmma_kernel (dK, dV),
// one body (body<T, kDkv>). The arithmetic and its conventions are
// flash_bwd_dcluster128.cu's (the float32 build of the design): P =
// exp(scale * Q K^T - lse) from the forward's row lse, dP = dO V^T, dS = P *
// (dP - delta) with delta = rowsum(dO * O) from the caller, dQ = scale * dS K,
// dK = scale * dS^T Q and dV = P^T dO, the scale in the epilogues; a masked
// score gives P = 0, q rows are the suffix of the kv context under the causal
// mask, tiles wholly above the diagonal are skipped, where causal and t_q >
// t_kv a row whose lse is at most NEG_INF / 2 gets P = 0, and padded rows of
// a ragged tile are zeros. P and dS are rounded to T for the products that
// take them, as the design before did; flash_attention_bwd_plain keeps them
// in float32, and ops/tolerance.py's 16-bit limits hold that rounding.
//
// What bounds them on an H100: the operations, 6 * d per visible (q, k) pair
// for dQ and 8 * d for dK/dV, at 989 TFLOP/s, with q, k, v, dO, lse, delta
// and the gradients read or written once. The design before (wide,
// flash_bwd_wide.cu) ran mma.sync fed by ldmatrix with d cut between the
// warps of a CTA, which handed their partial S and dP over in shared memory
// under a block barrier every stage; at 640 and 768 registers and shared
// memory held it to 16 resident q rows (dQ) and 16 kv rows (dK/dV), so every
// streamed byte was read from L2 by t / 16 tiles.
//
// Design. As flash_bwd_dcluster128.cu: the C = d / 128 CTAs that share one
// resident tile (kResRows q rows for dQ, kResRows kv rows for dK/dV) form a
// cluster, launched with cudaLaunchKernelEx and a cluster dimension; CTA c
// owns columns [128 c, 128 c + 128). Per streamed tile of kStreamRows rows
// that the causal skip leaves (an item):
//   1. each CTA computes the partial S and dP (dK/dV: S^T and dP^T) of the
//      [kResRows x kStreamRows] item over its 128 columns on wgmma, both
//      operands in shared memory (the resident X0, X1 and the streamed Y0,
//      Y1, K-major: d is the product's depth), and pushes each float4 quad
//      of the accumulators by st.async to the CTA that reduces it (CTA r
//      the quads r ceil(Q / C) on, Q = kResRows kStreamRows / 4), completing
//      on that CTA's mbarrier: one source a CTA;
//   2. the reducer sums a quad's C partials in column order, makes P and dS
//      there (masks, lse, delta, the empty-row guard), rounds them to T and
//      pushes them to every CTA of the cluster;
//   3. each CTA updates only its own 128 output columns: dQ += dS Y0 (K),
//      dV += P^T Y1 (dO), dK += dS^T Y0 (Q), with P and dS in registers in
//      the A-operand layout (the RS form) and the streamed tile read
//      MN-major through the descriptor's transpose bit, as the forward's
//      P V (flash_fwd_dcluster128.cu).
// No cluster barrier an item, no atomics: a second run is bit-equal. Item
// i + 1's partials are pushed before item i's output; receive and P/dS
// buffers are double, in the order flash_fwd_dcluster128.cu states.
//
// Roles, by kResRows (two warpgroups, 256 threads):
//   * 64 (as built): warpgroup w computes product w (0: S, 1: dP) over the
//     64 rows; the output: dQ's columns 64 w on (a [64 x 64] accumulator,
//     32 registers a thread), dK/dV's dV (w = 0, from P) or dK (w = 1, from
//     dS) over all 128 columns (64 registers);
//   * 128 (a variant of ops/flash_bwd_variants.py): warpgroup w owns rows
//     64 w on and computes both products and the outputs of its rows (dQ
//     64 registers, dK and dV 128), so both warpgroups share each streamed
//     tile and each round of the exchange, and a cluster makes half as many.
// The streamed tiles arrive by TMA (3-D maps [d, t, heads], 64-column boxes
// at the CTA's columns, 128-byte swizzled, zeros past t) into a ring of
// kStages slots, each with a full mbarrier, and the resident pair once on an
// mbarrier of its own; thread 0 issues. dQ's resident rows' lse and delta
// are read once into shared memory; dK/dV's reducers read their streamed
// rows' from global memory (L2) before they wait for the partials.
//
// The reckoning, in bytes of shared memory (as built: 64 resident rows;
// dK/dV, and dQ at clusters of 2 or 3, 64 streamed rows in three stages):
//   * resident X0 and X1: kResRows rows x 128 columns of T, 16384 each;
//   * the ring: three slots of Y0 and Y1, 64 rows x 128 columns, 32768 a slot;
//   * exchange: two receive buffers of the quads a CTA reduces, C sources x
//     2 products x ceil(Q / C) float4, at most 2 (Q + 7) x 16 = 32992 each
//     (Q = 1024); two of P and dS in T, Q x 16 (dQ: dS, Q x 8); dQ's rows'
//     lse and delta; the mbarriers; 1024 to align the swizzled tiles.
//   230912 bytes for dK/dV and 215040 for dQ: one CTA an SM, 255 registers
//   a thread at most. dQ from clusters of 4 (kDqNarrowFrom) streams 32 rows
//   in two stages, which halves the ring and the exchange buffers: 108536
//   bytes, two CTAs an SM (kMinBlocks), 83 registers a thread. On an H100
//   that read 3-18% faster at 512 to 768 (clusters of 4 to 6, which at one
//   CTA an SM leave 12 to 30 SMs idle) and 16% slower at 384
//   (ops/flash_bwd_variants.py --wide, PERF.md); dK/dV at 32 rows and two
//   stages needs 116224 bytes, past the half of an SM's shared memory.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_bwd_dq_dcluster128_wgmma(q, k, v, dout, lse, delta, dq,
//                                              bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dkv_dcluster128_wgmma(q, k, v, dout, lse, delta, dk, dv,
//                                               bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dcluster128_wgmma_plan(d, dtype, int out[8])
//       (group columns, CTAs a cluster, passes, dQ's and dK/dV's dynamic
//       shared memory, resident rows, dQ's and dK/dV's streamed rows)
//   int ray_tpu_flash_bwd_dcluster128_wgmma_smem_bytes(dkv, d)
//   int ray_tpu_flash_bwd_dcluster128_wgmma_ctas_per_sm(dtype, dkv, d)
//   int ray_tpu_flash_bwd_dcluster128_wgmma_max_clusters(dtype, dkv, d)
// q/dout/dq are [bh, t_q, d], k/v/dk/dv [bh, t_kv, d], contiguous bf16
// (dtype 0) or float16 (2), d a multiple of 128 from 256 to 1024, 16-byte
// aligned; lse and delta [bh, t_q] float32. The grid is (heads of a launch)
// x resident tiles x C on grid.x, at most 2^31 - 1, in clusters of C CTAs:
// each entry launches as many times as that takes, on `stream`, allocates
// nothing, and returns the launch's status, kUnsupported for what it does
// not take, or kTensorMapFailed.

#include "dcluster.cuh"

namespace {

constexpr int kCols = 128;        // a CTA's columns of d
constexpr int kResRows = 64;      // rows of the resident tile: 64 or 128

// A kernel's streamed side: rows of a streamed tile (32 or 64) and slots of
// its ring
template <int kRows_, int kStages_>
struct Stream {
  static constexpr int kRows = kRows_;
  static constexpr int kStages = kStages_;
};
// dK/dV's; dQ's below kDqNarrowFrom CTAs a cluster (one CTA an SM) and from
// it on (32 rows in two stages: two CTAs an SM, so clusters of 4 to 6 fill
// the SMs that one CTA an SM leaves idle)
using DkvStream = Stream<64, 3>;
using DqWide = Stream<64, 3>;
using DqNarrow = Stream<32, 2>;
constexpr int kDqNarrowFrom = 4;
constexpr int kProds = kResRows / 64;  // products a warpgroup computes an item
constexpr int kBoxX = kResRows * 128;  // a 64-column box of a resident tile
constexpr int kTileX = 2 * kBoxX;      // 128 columns
static_assert(kResRows == 64 || kResRows == 128, "one or two warpgroups of resident rows");

// A kernel's streamed tiles and its shared memory, in bytes from a
// 1024-aligned base
template <bool kDkv, class S>
struct Layout {
  static constexpr int kStreamRows = S::kRows;
  static constexpr int kStages = S::kStages;
  static_assert(kStreamRows == 32 || kStreamRows == 64, "wgmma N of 32 or 64");
  static constexpr int kQuads = kResRows * kStreamRows / 4;  // float4 quads of a product
  static constexpr int kQuadsPerRb = 4 * kStreamRows;        // quads of 16 rows of it
  // the most quads a reducing thread takes (C >= 2)
  static constexpr int kMaxU = ((kQuads + 1) / 2 + kClusterThreads - 1) / kClusterThreads;
  static constexpr int kBoxY = kStreamRows * 128;  // a 64-column box of a streamed tile
  static constexpr int kTileY = 2 * kBoxY;
  static constexpr int kX = 0;                      // X0, then X1
  static constexpr int kRing = kX + 2 * kTileX;     // kStages slots: Y0, then Y1
  static constexpr int kSlot = 2 * kTileY;
  // a CTA's quads' partials from every source: [source][S, dP][share] float4
  static constexpr int kRecv = kRing + kStages * kSlot;
  static constexpr int kRecvBytes = 2 * (kQuads + kMaxCluster - 1) * 16;
  // P and dS of every quad in T (dQ: dS only): [quad] 16 (8) bytes
  static constexpr int kPdQuad = kDkv ? 16 : 8;
  static constexpr int kPd = kRecv + 2 * kRecvBytes;
  static constexpr int kPdBytes = kQuads * kPdQuad;
  // dQ: the resident rows' lse in log2 units, then their delta
  static constexpr int kRowStats = kPd + 2 * kPdBytes;
  // two receive, two P/dS, a full one a slot and the resident pair's
  static constexpr int kBars = kRowStats + (kDkv ? 0 : 2 * kResRows * 4);
  static constexpr int kBytes = kBars + (5 + kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align
  static_assert(kAlloc <= 232448, "shared memory over the 227 KB a block may use");
  static_assert(kTileX % 1024 == 0 && kBoxY % 1024 == 0, "aligned tiles");
};

// CTAs an SM each kernel is built for: two where their shared memory fits
template <bool kDkv, class S>
constexpr int kMinBlocks = 2 * (Layout<kDkv, S>::kAlloc + 1024) <= 233472 ? 2 : 1;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  const void* dout;
  const float* lse;
  const float* delta;
  void* dq;
  void* dk;
  void* dv;
  int bh;       // heads of this launch
  int n_tiles;  // resident tiles per head
  int l2;       // heads per L2 group
  int cluster;  // C = d / 128
  int t_q;
  int t_kv;
  int d;
  int off;      // t_kv - t_q
  int causal;
  int guard;    // causal && t_q > t_kv: the empty-row guard is on
  float scale;
  float scale_log2;  // scale * log2(e)
};

__device__ __forceinline__ bool sees_no_key(const Params& p, float lse) {
  return p.guard && !(lse > kNegInf * 0.5f);
}

// 16 or 8 bytes into the shared memory of a CTA of the cluster, completing
// on that CTA's mbarrier `bar` (dcluster.cuh's st_async, for packed T)
__device__ __forceinline__ void st_async_b32(uint32_t addr, uint4 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, "
      "[%5];\n" ::"r"(addr),
      "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar)
      : "memory");
}
__device__ __forceinline__ void st_async_b32(uint32_t addr, uint2 v, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n" ::"r"(
          addr),
      "r"(v.x), "r"(v.y), "r"(bar)
      : "memory");
}

// D[64 x N] (+)= A[64 x 16] B[16 x N], A and B K-major in shared memory, of
// type T: hopper.cuh's wgmma_ss, and N = 32, which it does not take
template <int N, typename T>
__device__ __forceinline__ void wgmma_ss_n(float* d, uint64_t da, uint64_t db, int accumulate) {
  if constexpr (N == 32) {
#define SS_32(TY)                                                                             \
  asm volatile(                                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "              \
      "%16, %17, p, 1, 1, 0, 0;\n}\n"                                                         \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                                                 \
      : "l"(da), "l"(db), "r"(accumulate));
    if constexpr (kHalf<T>) {
      SS_32("f16");
    } else {
      SS_32("bf16");
    }
#undef SS_32
  } else {
    wgmma_ss<N, T>(d, da, db, accumulate);
  }
}

// ---------------------------------------------------------------------------
// the kernels: dQ (kDkv false) or dK/dV (kDkv true), one body
// ---------------------------------------------------------------------------

template <typename T, bool kDkv, class S>
__device__ __forceinline__ void body(const CUtensorMap* tm_x0, const CUtensorMap* tm_x1,
                                     const CUtensorMap* tm_y0, const CUtensorMap* tm_y1,
                                     const Params& p) {
  using L = Layout<kDkv, S>;
  constexpr int kStreamRows = L::kStreamRows, kStages = L::kStages, kQuads = L::kQuads;
  constexpr int kMaxU = L::kMaxU, kBoxY = L::kBoxY, kTileY = L::kTileY;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int wg = warp >> 2;  // the warpgroup
  const int wi = warp & 3;   // the warp in it: its 16 rows
  const int rank = (int)cluster_ctarank();  // the CTA's columns
  int bh, tile;
  slot_head_tile(blockIdx.x / p.cluster, p.bh, p.n_tiles, p.l2, &bh, &tile);  // a cluster a slot
  const float* lse = p.lse + (size_t)bh * p.t_q;
  const float* delta = p.delta + (size_t)bh * p.t_q;
  // the resident side (X0, X1: rows t_x) and the streamed one (Y0, Y1: rows
  // t_y); S (or S^T) = X0 Y0^T, dP (or dP^T) = X1 Y1^T
  const int t_x = kDkv ? p.t_kv : p.t_q, t_y = kDkv ? p.t_q : p.t_kv;

  // the resident rows and the streamed tiles they run: the causal skip as
  // loop bounds (dQ: the heaviest q tiles first; dK/dV: from the first q
  // tile that sees the kv tile's first key)
  const int n_y = (t_y + kStreamRows - 1) / kStreamRows;
  int r0, first = 0, n_items;
  if constexpr (kDkv) {
    r0 = tile * kResRows;
    if (p.causal) {
      const int q_first = r0 - p.off;
      first = q_first <= 0 ? 0 : (q_first >= p.t_q ? n_y : q_first / kStreamRows);
    }
    n_items = n_y - first;
  } else {
    r0 = (p.n_tiles - 1 - tile) * kResRows;
    const int last = min(r0 + kResRows, p.t_q) - 1 + p.off;
    n_items = !p.causal ? n_y : (last < 0 ? 0 : min(n_y, last / kStreamRows + 1));
  }
  const int own0 = rank * kCols;  // the CTA's columns [own0, own0 + 128)
  auto first_row = [&](int i) { return (first + i) * kStreamRows; };  // item i's streamed rows

  // The exchange: a CTA's partial quads go to the CTA that reduces each (its
  // receive buffer i % 2), P and dS from there to every CTA (its P/dS buffer
  // i % 2), each store completing on the receiver's mbarrier.
  const int share = (kQuads + p.cluster - 1) / p.cluster;  // quads a CTA reduces
  const int n_share = min(share, kQuads - rank * share);
  const uint32_t recv_bytes = (uint32_t)(p.cluster * 2 * n_share * 16);
  const uint32_t bars = smem_u32(smem + L::kBars);
  auto recv_bar = [&](int i) { return bars + 8 * (i & 1); };
  auto pd_bar = [&](int i) { return bars + 16 + 8 * (i & 1); };
  auto full_bar = [&](int i) { return bars + 32 + 8 * (i % kStages); };
  const uint32_t x_bar = bars + 32 + 8 * kStages;
  float* const row_stats = reinterpret_cast<float*>(smem + L::kRowStats);
  if constexpr (!kDkv) {
    // the resident q rows' lse in log2 units and delta: +inf and 0 (P = 0)
    // past t_q and where the empty-row guard drops the row
    for (int r = threadIdx.x; r < kResRows; r += kClusterThreads) {
      const int row = r0 + r;
      float l2 = INFINITY, dl = 0.f;
      if (row < p.t_q) {
        const float l = lse[row];
        if (!sees_no_key(p, l)) {
          l2 = l * kLog2e;
          dl = delta[row];
        }
      }
      row_stats[r] = l2;
      row_stats[kResRows + r] = dl;
    }
  }
  if (threadIdx.x == 0 && n_items > 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(recv_bar(b), 1);
      mbar_init(pd_bar(b), 1);
    }
    for (int s = 0; s < kStages; ++s) mbar_init(full_bar(s), 1);
    mbar_init(x_bar, 1);
    for (int i = 0; i < min(2, n_items); ++i) {  // armed for items 0 and 1
      mbar_arrive_expect_tx(recv_bar(i), recv_bytes);
      mbar_arrive_expect_tx(pd_bar(i), L::kPdBytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // every peer's mbarriers are ready before the first push, and dQ's row
  // statistics are seen by every thread
  if (n_items > 0) cluster_sync();

  // the resident X0 and X1 (the CTA's columns of rows r0 on) and item i's
  // Y0 and Y1 into slot i % kStages, by TMA from thread 0
  const uint32_t x_tile = smem_u32(smem + L::kX);
  auto slot = [&](int i) { return smem_u32(smem + L::kRing) + (i % kStages) * L::kSlot; };
  auto issue = [&](int i) {
    if (threadIdx.x == 0 && i < n_items) {
      const uint32_t dst = slot(i), bar = full_bar(i);
      mbar_arrive_expect_tx(bar, L::kSlot);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        tma_load_3d(dst + c * kBoxY, tm_y0, bar, own0 + 64 * c, first_row(i), bh);
        tma_load_3d(dst + kTileY + c * kBoxY, tm_y1, bar, own0 + 64 * c, first_row(i), bh);
      }
    }
  };
  if (threadIdx.x == 0 && n_items > 0) {
    mbar_arrive_expect_tx(x_bar, 2 * kTileX);
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      tma_load_3d(x_tile + c * kBoxX, tm_x0, x_bar, own0 + 64 * c, r0, bh);
      tma_load_3d(x_tile + kTileX + c * kBoxX, tm_x1, x_bar, own0 + 64 * c, r0, bh);
    }
  }
  for (int i = 0; i < kStages; ++i) issue(i);

  // step 1 of item i: the warpgroup's products (j: S or dP of its rows),
  // [64 x kStreamRows] each over the CTA's 128 columns, both operands K-major
  // in shared memory; then (push) each quad of them to its reducer
  auto prod_of = [&](int j) { return kProds == 1 ? wg : j; };
  const int rows64 = kProds == 1 ? 0 : wg;  // the warpgroup's 64 resident rows
  float s[kProds][kStreamRows / 2];
  auto partial = [&](int i) {
#pragma unroll
    for (int j = 0; j < kProds; ++j) {
#pragma unroll
      for (int e = 0; e < kStreamRows / 2; ++e) s[j][e] = 0.f;
      fence_regs<kStreamRows / 2>(s[j]);
    }
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kProds; ++j) {
      const uint32_t a = x_tile + prod_of(j) * kTileX + rows64 * 64 * 128;
      const uint32_t b = slot(i) + prod_of(j) * kTileY;
#pragma unroll
      for (int kk = 0; kk < kCols / 16; ++kk) {
        const uint32_t col_bytes = (kk % 4) * 32;  // 16 columns within a 64-column box
        wgmma_ss_n<kStreamRows, T>(s[j], kmajor_desc(a + (kk / 4) * kBoxX + col_bytes),
                                   kmajor_desc(b + (kk / 4) * kBoxY + col_bytes), kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int j = 0; j < kProds; ++j) fence_regs<kStreamRows / 2>(s[j]);
  };
  auto push = [&](int i) {
    const uint32_t recv = smem_u32(smem + L::kRecv + (i & 1) * L::kRecvBytes);
#pragma unroll
    for (int j = 0; j < kProds; ++j) {
#pragma unroll
      for (int nt = 0; nt < kStreamRows / 8; ++nt) {
        // quad [16-row block][n-tile][lane]: rows 16 rb + g (+ 8), columns
        // 8 nt + 2 tq (+ 1) of the item
        const int quad = ((4 * rows64 + wi) * (kStreamRows / 8) + nt) * 32 + lane;
        const int to = quad / share, at = quad - to * share;
        const uint32_t dst = recv + ((rank * 2 + prod_of(j)) * share + at) * 16;
        st_async(map_cluster(dst, to),
                 make_float4(s[j][4 * nt], s[j][4 * nt + 1], s[j][4 * nt + 2], s[j][4 * nt + 3]),
                 map_cluster(recv_bar(i), to));
      }
    }
  };

  // steps 2 of item i: this CTA's share of the quads, up to kMaxU a thread,
  // once every source's partials of them are in: summed in column order, P
  // and dS made, rounded to T and pushed to every CTA
  const bool reduces = (int)threadIdx.x < n_share;
  auto reduce = [&](int i) {
    if (!reduces) return;
    const int y0 = first_row(i);
    // dK/dV: the quads' q rows' lse and delta, read before the wait
    float lq[kMaxU][2], dlq[kMaxU][2];
#pragma unroll
    for (int u = 0; u < kMaxU; ++u) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        lq[u][c] = 0.f;
        dlq[u][c] = 0.f;
      }
      const int at = (int)threadIdx.x + u * kClusterThreads;
      if (kDkv && at < n_share) {
        const int quad = rank * share + at;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qr = y0 + 8 * ((quad >> 5) % (kStreamRows / 8)) + 2 * (quad & 3) + c;
          if (qr < p.t_q) {
            lq[u][c] = lse[qr];
            dlq[u][c] = delta[qr];
          }
        }
      }
    }
    mbar_wait(recv_bar(i), (i >> 1) & 1);
    if (threadIdx.x == 0 && i + 2 < n_items) mbar_arrive_expect_tx(recv_bar(i), recv_bytes);
    const float4* in = reinterpret_cast<const float4*>(smem + L::kRecv + (i & 1) * L::kRecvBytes);
    const uint32_t out = smem_u32(smem + L::kPd + (i & 1) * L::kPdBytes);
    const uint32_t bar = pd_bar(i);
#pragma unroll
    for (int u = 0; u < kMaxU; ++u) {
      const int at = (int)threadIdx.x + u * kClusterThreads;
      if (at >= n_share) break;
      const int quad = rank * share + at;
      float sx[4] = {0.f, 0.f, 0.f, 0.f}, dx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 2
      for (int c = 0; c < p.cluster; ++c) {  // in column order
        const float4 a = in[2 * c * share + at], b = in[(2 * c + 1) * share + at];
        sx[0] += a.x;
        sx[1] += a.y;
        sx[2] += a.z;
        sx[3] += a.w;
        dx[0] += b.x;
        dx[1] += b.y;
        dx[2] += b.z;
        dx[3] += b.w;
      }
      const int rb = quad / L::kQuadsPerRb, nt = (quad >> 5) % (kStreamRows / 8);
      const int qg = (quad & 31) >> 2, qtq = quad & 3;
      float pe[4], ds[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * rb + qg + 8 * (e >> 1);    // in the resident tile
        const int col = 8 * nt + 2 * qtq + (e & 1);     // in the streamed tile
        if constexpr (kDkv) {
          const int kv = r0 + row, qr = y0 + col;
          const float l = lq[u][e & 1];
          float pv = fast_exp2(fmaf(sx[e], p.scale_log2, -l * kLog2e));
          if (qr >= p.t_q || sees_no_key(p, l) || kv >= p.t_kv ||
              (p.causal && qr + p.off < kv)) {
            pv = 0.f;
          }
          pe[e] = pv;
          ds[e] = pv * (dx[e] - dlq[u][e & 1]);
        } else {
          const int qr = r0 + row, kv = y0 + col;
          float pv = fast_exp2(fmaf(sx[e], p.scale_log2, -row_stats[row]));
          if (kv >= p.t_kv || (p.causal && qr + p.off < kv)) pv = 0.f;
          pe[e] = pv;
          ds[e] = pv * (dx[e] - row_stats[kResRows + row]);
        }
      }
      const uint32_t dst = out + quad * L::kPdQuad;
#pragma unroll 1
      for (int c = 0; c < p.cluster; ++c) {
        const uint32_t o = map_cluster(dst, c), b = map_cluster(bar, c);
        if constexpr (kDkv) {
          st_async_b32(o,
                       make_uint4(pack2<T>(pe[0], pe[1]), pack2<T>(pe[2], pe[3]),
                                  pack2<T>(ds[0], ds[1]), pack2<T>(ds[2], ds[3])),
                       b);
        } else {
          st_async_b32(o, make_uint2(pack2<T>(ds[0], ds[1]), pack2<T>(ds[2], ds[3])), b);
        }
      }
    }
  };

  // step 3 of item i, once P and dS are in: the warpgroup's outputs (o), of
  // its rows 64 rows64 on, kOutCols of the CTA's columns from col0, each an
  // accumulator of kOutCols / 2 floats a thread; `which` 0 is dV (from P and
  // Y1), 1 dK (dS and Y0) or dQ (dS and Y0). Stored after the last item.
  constexpr int kOutCols = (kProds == 1 && !kDkv) ? 64 : 128;
  constexpr int kOuts = (kProds == 2 && kDkv) ? 2 : 1;
  auto which_of = [&](int o) { return kDkv ? (kOuts == 2 ? o : wg) : 1; };
  const int col0 = kOutCols == 64 ? 64 * wg : 0;
  float acc[kOuts][kOutCols / 2];
#pragma unroll
  for (int o = 0; o < kOuts; ++o) {
#pragma unroll
    for (int e = 0; e < kOutCols / 2; ++e) acc[o][e] = 0.f;
  }
  auto output = [&](int i) {
    const uint8_t* buf = smem + L::kPd + (i & 1) * L::kPdBytes;
#pragma unroll
    for (int o = 0; o < kOuts; ++o) {
      const int which = which_of(o);
      // the warp's 16 rows of P or dS in T, the A-operand layout: register
      // 2 nt + h holds rows g + 8 h, columns 8 nt + 2 tq (+ 1)
      uint32_t pa[kStreamRows / 4];
#pragma unroll
      for (int nt = 0; nt < kStreamRows / 8; ++nt) {
        const int quad = ((4 * rows64 + wi) * (kStreamRows / 8) + nt) * 32 + lane;
        if constexpr (kDkv) {
          const uint4 f = reinterpret_cast<const uint4*>(buf)[quad];
          pa[2 * nt] = which ? f.z : f.x;
          pa[2 * nt + 1] = which ? f.w : f.y;
        } else {
          const uint2 f = reinterpret_cast<const uint2*>(buf)[quad];
          pa[2 * nt] = f.x;
          pa[2 * nt + 1] = f.y;
        }
      }
      fence_regs<kOutCols / 2>(acc[o]);
      fence_regs<kStreamRows / 4>(pa);
      wgmma_fence();
      issue_nn<kOutCols, kStreamRows, T>(
          acc[o], pa, slot(i) + (which ? 0 : kTileY) + (col0 / 64) * kBoxY);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kOutCols / 2>(acc[o]);
      fence_regs<kStreamRows / 4>(pa);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int o = 0; o < kOuts; ++o) {
      const int which = which_of(o);
      void* const out = kDkv ? (which ? p.dk : p.dv) : p.dq;
      const float mul[2] = {which ? p.scale : 1.f, which ? p.scale : 1.f};
      store_group<T, kOutCols>(static_cast<T*>(out) + (size_t)bh * t_x * p.d + own0 + col0,
                               p.d, acc[o], mul, r0 + 64 * rows64 + 16 * wi, t_x, kOutCols, g,
                               tq);
    }
  };

  // The pipeline, as flash_fwd_dcluster128.cu's: item i + 1's partials are
  // pushed before item i's output, both exchange buffers are double, and
  // the mbarriers are armed for item i + 2 once item i's phase is seen
  // complete; a CTA exits once P and dS of its last item are in. The ring
  // runs kStages items ahead; the block barrier after item i's output frees
  // its slot for item i + kStages.
  if (n_items > 0) {
    mbar_wait(x_bar, 0);
    mbar_wait(full_bar(0), 0);
    partial(0);
    push(0);
  }
#pragma unroll 1
  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) mbar_wait(full_bar(i + 1), ((i + 1) / kStages) & 1);
    reduce(i);
    __syncwarp();
    if (i + 1 < n_items) {
      partial(i + 1);
      push(i + 1);
    }
    mbar_wait(pd_bar(i), (i >> 1) & 1);  // P and dS of item i are in
    if (threadIdx.x == 0 && i + 2 < n_items) mbar_arrive_expect_tx(pd_bar(i), L::kPdBytes);
    output(i);
    __syncthreads();  // item i's slot is free
    issue(i + kStages);
  }
  store();  // no streamed tile: zeros
}

template <typename T, class S>
__global__ void __launch_bounds__(kClusterThreads, (kMinBlocks<false, S>))
    flash_bwd_dq_dcluster128_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x0,
                                          const __grid_constant__ CUtensorMap tm_x1,
                                          const __grid_constant__ CUtensorMap tm_y0,
                                          const __grid_constant__ CUtensorMap tm_y1,
                                          const Params p) {
  body<T, false, S>(&tm_x0, &tm_x1, &tm_y0, &tm_y1, p);
}

template <typename T, class S>
__global__ void __launch_bounds__(kClusterThreads, (kMinBlocks<true, S>))
    flash_bwd_dkv_dcluster128_wgmma_kernel(const __grid_constant__ CUtensorMap tm_x0,
                                           const __grid_constant__ CUtensorMap tm_x1,
                                           const __grid_constant__ CUtensorMap tm_y0,
                                           const __grid_constant__ CUtensorMap tm_y1,
                                           const Params p) {
  body<T, true, S>(&tm_x0, &tm_x1, &tm_y0, &tm_y1, p);
}

// the dQ or the dK/dV kernel
template <typename T, bool kDkv, class S>
auto kernel_of() {
  if constexpr (kDkv) {
    return flash_bwd_dkv_dcluster128_wgmma_kernel<T, S>;
  } else {
    return flash_bwd_dq_dcluster128_wgmma_kernel<T, S>;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, bool kDkv, class S>
int smem_attribute() {
  return (int)cudaFuncSetAttribute(kernel_of<T, kDkv, S>(),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Layout<kDkv, S>::kAlloc);
}

// the plan's CTAs a cluster at head_dim d (one 128-column group each), 0
// where d is none it takes: a reducing thread takes at most kMaxU quads,
// which needs C >= 2
int cluster_of(int d) {
  return d > 0 && d % kCols == 0 && d / kCols >= 2 && d / kCols <= kMaxCluster ? d / kCols : 0;
}

// f(S{}) for the kernel's streamed side at clusters of `cluster` CTAs
template <bool kDkv, typename F>
int with_stream(int cluster, F f) {
  if constexpr (kDkv) {
    return f(DkvStream{});
  } else {
    return cluster >= kDqNarrowFrom ? f(DqNarrow{}) : f(DqWide{});
  }
}

template <typename T, bool kDkv, class S>
int launch(const Params& all, cudaStream_t stream) {
  const int err = smem_attribute<T, kDkv, S>();
  if (err != 0) return err;
  Params p = all;
  p.cluster = cluster_of(p.d);
  const int t_x = kDkv ? p.t_kv : p.t_q, t_y = kDkv ? p.t_q : p.t_kv;
  p.n_tiles = (t_x + kResRows - 1) / kResRows;
  constexpr int kStreamRows = S::kRows;
  const size_t ld = (size_t)p.d * sizeof(T);
  // the streamed side of one head (Q and dO for dK/dV, K and V for dQ)
  const long long head_bytes = 2ll * (long long)ld * t_y;
  return launch_heads(p.bh, (long long)p.n_tiles * p.cluster, [&](int h0, int heads) {
    Params c = p;
    const size_t qs = (size_t)h0 * p.t_q * ld, ks = (size_t)h0 * p.t_kv * ld;
    c.q = static_cast<const char*>(p.q) + qs;
    c.dout = static_cast<const char*>(p.dout) + qs;
    c.k = static_cast<const char*>(p.k) + ks;
    c.v = static_cast<const char*>(p.v) + ks;
    c.lse = p.lse + (size_t)h0 * p.t_q;
    c.delta = p.delta + (size_t)h0 * p.t_q;
    c.bh = heads;
    c.l2 = l2_group(head_bytes, heads);
    if (kDkv) {
      c.dk = static_cast<char*>(p.dk) + ks;
      c.dv = static_cast<char*>(p.dv) + ks;
    } else {
      c.dq = static_cast<char*>(p.dq) + qs;
    }
    // X0, X1 resident (kResRows-row boxes), Y0, Y1 streamed (kStreamRows)
    const void* x0 = kDkv ? c.k : c.q;
    const void* x1 = kDkv ? c.v : c.dout;
    const void* y0 = kDkv ? c.q : c.k;
    const void* y1 = kDkv ? c.dout : c.v;
    CUtensorMap tm_x0 = {}, tm_x1 = {}, tm_y0 = {}, tm_y1 = {};
    if (make_map<T>(&tm_x0, x0, p.d, t_x, heads, kResRows) ||
        make_map<T>(&tm_x1, x1, p.d, t_x, heads, kResRows) ||
        make_map<T>(&tm_y0, y0, p.d, t_y, heads, kStreamRows) ||
        make_map<T>(&tm_y1, y1, p.d, t_y, heads, kStreamRows)) {
      return kTensorMapFailed;
    }
    ClusterConfig cc((unsigned)((long long)heads * p.n_tiles * p.cluster), p.cluster,
                     Layout<kDkv, S>::kAlloc, stream);
    const cudaError_t e =
        cudaLaunchKernelEx(&cc.cfg, kernel_of<T, kDkv, S>(), tm_x0, tm_x1, tm_y0, tm_y1, c);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  });
}

template <typename T, bool kDkv, class S>
int max_clusters(int cluster) {
  if (smem_attribute<T, kDkv, S>() != 0) return -1;
  ClusterConfig cc((unsigned)cluster, cluster, Layout<kDkv, S>::kAlloc, nullptr);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel_of<T, kDkv, S>(), &cc.cfg);
  return err == cudaSuccess ? n : -1;
}

template <typename T, bool kDkv, class S>
int ctas_per_sm() {
  if (smem_attribute<T, kDkv, S>() != 0) return -1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, kernel_of<T, kDkv, S>(), kClusterThreads, Layout<kDkv, S>::kAlloc);
  return err == cudaSuccess ? n : -1;
}

// a kernel's shared memory at clusters of `cluster` CTAs
template <bool kDkv>
int smem_bytes(int cluster) {
  return with_stream<kDkv>(cluster, [](auto s) { return Layout<kDkv, decltype(s)>::kAlloc; });
}

// f(T{}) for the 16-bit dtype codes (0 bf16, 2 float16), `otherwise` for any
// other
template <typename F>
int with_half(int dtype, int otherwise, F f) {
  switch (dtype) {
    case 0: return f(__nv_bfloat16{});
    case 2: return f(__half{});
  }
  return otherwise;
}

int dispatch(bool dkv, const Params& p, int dtype, void* stream) {
  if (p.bh <= 0 || p.t_q <= 0 || p.t_kv <= 0 || cluster_of(p.d) == 0) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_half(dtype, kUnsupported, [&](auto t) {
    using T = decltype(t);
    const int c = cluster_of(p.d);
    return dkv ? with_stream<true>(c, [&](auto s) { return launch<T, true, decltype(s)>(p, st); })
               : with_stream<false>(c, [&](auto s) { return launch<T, false, decltype(s)>(p, st); });
  });
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, int bh, int t_q, int t_kv, int d,
                   int causal, float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.bh = bh;
  p.t_q = t_q;
  p.t_kv = t_kv;
  p.d = d;
  p.off = t_kv - t_q;
  p.causal = causal;
  p.guard = causal && t_q > t_kv;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

}  // namespace

extern "C" int ray_tpu_flash_bwd_dq_dcluster128_wgmma(const void* q, const void* k, const void* v,
                                                      const void* dout, const void* lse,
                                                      const void* delta, void* dq, int bh,
                                                      int t_q, int t_kv, int d, int dtype,
                                                      int causal, float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, bh, t_q, t_kv, d, causal, scale);
  p.dq = dq;
  return dispatch(false, p, dtype, stream);
}

extern "C" int ray_tpu_flash_bwd_dkv_dcluster128_wgmma(const void* q, const void* k,
                                                       const void* v, const void* dout,
                                                       const void* lse, const void* delta,
                                                       void* dk, void* dv, int bh, int t_q,
                                                       int t_kv, int d, int dtype, int causal,
                                                       float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, bh, t_q, t_kv, d, causal, scale);
  p.dk = dk;
  p.dv = dv;
  return dispatch(true, p, dtype, stream);
}

extern "C" int ray_tpu_flash_bwd_dcluster128_wgmma_plan(int d, int dtype, int* out) {
  if (cluster_of(d) == 0) return kUnsupported;
  return with_half(dtype, kUnsupported, [&](auto) {
    out[0] = kCols;
    out[1] = cluster_of(d);
    out[2] = 1;
    const int c = cluster_of(d);
    out[3] = smem_bytes<false>(c);
    out[4] = smem_bytes<true>(c);
    out[5] = kResRows;
    out[6] = with_stream<false>(c, [](auto s) { return decltype(s)::kRows; });
    out[7] = DkvStream::kRows;
    return 0;
  });
}

// the kernel's dynamic shared memory, CTAs an SM and clusters resident at
// once at head_dim d (the build it launches there), -1 for what it does not
// take
extern "C" int ray_tpu_flash_bwd_dcluster128_wgmma_smem_bytes(int dkv, int d) {
  const int c = cluster_of(d);
  if (c == 0) return -1;
  return dkv ? smem_bytes<true>(c) : smem_bytes<false>(c);
}

extern "C" int ray_tpu_flash_bwd_dcluster128_wgmma_ctas_per_sm(int dtype, int dkv, int d) {
  const int c = cluster_of(d);
  if (c == 0) return -1;
  return with_half(dtype, -1, [&](auto t) {
    using T = decltype(t);
    return dkv ? with_stream<true>(c, [](auto s) { return ctas_per_sm<T, true, decltype(s)>(); })
               : with_stream<false>(c, [](auto s) { return ctas_per_sm<T, false, decltype(s)>(); });
  });
}

extern "C" int ray_tpu_flash_bwd_dcluster128_wgmma_max_clusters(int dtype, int dkv, int d) {
  const int c = cluster_of(d);
  if (c == 0) return -1;
  return with_half(dtype, -1, [&](auto t) {
    using T = decltype(t);
    return dkv ? with_stream<true>(c, [&](auto s) { return max_clusters<T, true, decltype(s)>(c); })
               : with_stream<false>(c, [&](auto s) { return max_clusters<T, false, decltype(s)>(c); });
  });
}

extern "C" const char* ray_tpu_flash_bwd_dcluster128_wgmma_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype or shape";
  if (err == kTensorMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
