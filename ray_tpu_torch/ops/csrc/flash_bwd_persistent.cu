// Flash-attention backward for Hopper (sm_90a) at head_dim 16 and 32, bf16:
// the dQ and dK/dV kernels, each a persistent grid over (64-row tile,
// batch*head) items with its streamed operands through a TMA ring.
// Hand-written CUDA C++.
//
// Replaces the two TPU kernels of ray_tpu/ops/attention.py launched by
// _flash_attention_tpu_bwd there, for bf16 at head_dim 16 and 32, as the
// dispatch table in ops/attention.py (BWD_DESIGNS, design "persistent")
// says; bf16 at 64, 128 and 256 runs csrc/flash_bwd_wgmma.cu, float32
// csrc/flash_bwd_f32.cu, and csrc/flash_bwd.cu (these head_dims' kernels
// before) is on no path:
//   * _flash_bwd_dq_kernel  (ray_tpu/ops/attention.py:324) -> dQ;
//   * _flash_bwd_dkv_kernel (ray_tpu/ops/attention.py:394) -> dK and dV.
// Both recompute P = exp(scale * Q K^T - lse) from the forward's row lse,
// then dP = dO V^T and dS = P * (dP - delta) * scale with delta =
// rowsum(dO * O) (computed by the caller, as the reference computes it
// outside its kernels), and accumulate dQ = dS K, dK = dS^T Q and dV =
// P^T dO, with the reference's conventions:
//   * NEG_INF = -1e30 is a finite mask value; a masked score gives P = 0;
//   * under the causal mask q rows are the suffix of the kv context:
//     q_pos = q_idx + (t_kv - t_q), and key k is visible when q_pos >= k;
//   * tiles wholly above the causal diagonal are skipped (a loop bound);
//   * where causal and t_q > t_kv, a row that sees no key (its lse <=
//     NEG_INF / 2) gets P = 0: its dQ is 0 and it adds nothing to dK and dV.
//     Every score of such a row is masked, and every tile that holds one is
//     a masked tile here, so the mask gives it;
//   * padded kv columns and q rows of a ragged last tile add nothing: TMA
//     fills K, V, Q and dO rows past the end with zeros and the row copies
//     lse and delta rows past t_q with zeros; padded kv columns are masked
//     in dQ, and a padded q row's P (ex2(0) = 1) meets dO = 0 and dP -
//     delta = 0 in dK/dV.
// P and dS are rounded to bf16 where they feed a product, as before; the
// plain version in ops/attention.py (flash_attention_bwd_plain) is the
// arithmetic in float32 over the whole score matrix, and
// ops/persistent_bwd.py repeats this file's rounding on the CPU.
//
// What bounds it on an H100: at the working shapes (gpt_nano's 4 heads x
// 16 at t=128, the tiny flagship's 8 x 32 at t=256, 65536 tokens a launch)
// device memory: q, k, v, dO and the gradients are each read or written
// once, 2 bytes an element, and lse and delta 8 bytes a row, against 6 * d
// (dQ) or 8 * d (dK/dV) tensor-core operations per visible pair, far under
// the tensor cores' rate. Next come the exponentials (one ex2 per visible
// pair in each kernel, 16 a clock on each SM: 30% of dQ's memory bound at
// gpt_nano's shape) and the instruction stream around them. Measured
// (ops/flash_bwd_variants.py --small-d, an H100 at 700 W), the kernels run
// at 61% (d=16) and 71-72% (d=32) of the memory bound and within 3-11% of
// their own copies alone (the probe that does no math); the exponentials
// and the piece skip move them by under 3%. So the design keeps the
// copies in flight and off the consumers' path and spends few issue slots
// on each score; it is the forward's (flash_fwd_persistent.cu):
//   * Persistent CTAs, several on each SM, walk the items blockIdx.x,
//     blockIdx.x + gridDim.x, ...: a CTA's set-up is paid once and the next
//     item's loads overlap this item's math. Items go in groups of heads
//     whose streamed tiles fit in L2 together (kL2GroupBytes, as the
//     forward), heaviest first within a group under the causal mask: for
//     dQ the last q tiles (they see the most kv tiles), for dK/dV the first
//     kv tiles (they see the most q tiles). A global heaviest-first order
//     re-read each head's tiles from device memory once per item in the
//     forward (1.8x the memory bound at the tiny flagship's shape).
//   * A producer warp streams what the item loops over through a ring of
//     kStagesAt<D> stages that runs on across items, each on a full
//     mbarrier with its byte count; the consumer warps release a stage on
//     its empty mbarrier. dQ streams K and V tiles and takes Q, dO and the rows' lse
//     and delta once an item (double buffered); dK/dV streams Q and dO
//     tiles with their 64 rows' lse and delta, and takes K and V once an
//     item. Rows are 32 or 64 bytes, so TMA swizzles them with the 32- or
//     64-byte pattern (hopper.cuh, narrow tiles) and the ldmatrix reads hit
//     distinct banks. The producer's lanes copy lse and delta with cp.async,
//     which arrives on the buffer's full mbarrier when the rows land: the
//     warp never waits for a global load, so the next TMA goes out at once.
//   * One consumer warpgroup owns the item's 64 rows, 16 a warp. The
//     resident operands are read once into registers as mma.sync m16n8k16
//     A fragments (dQ: Q and dO; dK/dV: K and V) and their buffer released
//     at once; the streamed ones are read by ldmatrix, .trans for the B
//     operand of dQ += dS K, dV += P^T dO and dK += dS^T Q (hopper.cuh
//     narrow_nt, narrow_nn_step). dK/dV computes S^T = K Q^T and dP^T =
//     V dO^T, so that P^T and dS^T come out of the accumulators in the A
//     operand's layout.
//   * A tile runs in chunks of kChunk 8-column pieces: S and dP
//     of a chunk, its P and dS, and its k-steps of the products, so that a
//     chunk's scores are all a warp holds (at d=32 the whole tile's S and
//     dP spill at 3 CTAs an SM). On a masked tile a warp runs only the
//     chunks that hold a score one of its rows sees (dQ: up to its last
//     visible column; dK/dV: from its first), their products included.
//   * Per score: P = ex2(s * scale * log2(e) - lse * log2(e)), one FFMA and
//     one ex2.approx; dS without the scale (it moves to the dQ and dK
//     epilogues); masks only on tiles that cross the diagonal or the end
//     of kv, one compare with a constant and one select a score.
//   * Each CTA owns its item's output rows: each warp writes its 16 rows
//     into a swizzled staging tile and one lane hands them to a TMA store,
//     which the warp waits for only when it next writes that tile. No
//     atomics and no split sums, so equal inputs give equal bits.
// The producer's waits trap after kWaitLimitNs, so a pipeline fault ends
// the kernel with an error instead of hanging the card; it ends by waiting
// for the consumers' last release of each stage and item buffer.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py; the
// argument lists of flash_bwd.cu's):
//   int ray_tpu_flash_bwd_dq_persistent(q, k, v, dout, lse, delta, dq,
//                                       bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dkv_persistent(q, k, v, dout, lse, delta, dk, dv,
//                                        bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_persistent_smem_bytes(d, dkv)
//   int ray_tpu_flash_bwd_persistent_ctas_per_sm(d, dkv)
// q/dout/dq are [bh, t_q, d], k/v/dk/dv [bh, t_kv, d], contiguous bf16
// (dtype 0), 16-byte aligned; lse and delta [bh, t_q] float32. Each launches
// one kernel on `stream`, allocates nothing, and returns cudaGetLastError()
// after the launch, kUnsupported for what it does not take, or
// kTensorMapFailed.

#include "hopper.cuh"

namespace {

constexpr int kBlock = 64;     // rows of an item's tile and of a streamed tile
constexpr int kItemBufs = 2;   // buffers of the item's tiles (and dQ's lse and delta)
constexpr int kWarpRows = 16;  // a consumer warp's rows of an item
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // and one producer warp
// arrivals on a barrier of a buffer that holds lse and delta: the producer's
// lane 0 with the TMA bytes, then each of its 32 lanes' row copies
constexpr int kStatsArrivals = 33;

// The CTAs an SM the register budget is set for (128 registers a thread at
// 3: 15 warps, 4 on each of an SM's quarters), the 8-column pieces a chunk
// of a tile's scores, and the ring's stages by head_dim (4 at d=32 read
// ~3% faster than 2 in four of five turns, and slower at d=16); the
// variants script (ops/flash_bwd_variants.py --small-d) times the others
constexpr int kMinBlocks = 3;
constexpr int kChunk = 4;
template <int D> constexpr int kStagesAt = D == 16 ? 2 : 4;

// shared memory, in bytes from a 1024-aligned base. dQ: kItemBufs buffers
// of Q and of dO, kStages K and V tiles, each warp's staging rows of dq, the
// item buffers' lse and delta, the barriers. dK/dV: kItemBufs buffers of K
// and of V, kStages Q and dO tiles, each warp's staging rows of dk and of
// dv, each stage's lse and delta, the barriers. Every tile starts on a
// multiple of 1024 bytes and every staging tile on a multiple of its size,
// as the swizzle pattern wants.
template <int D, bool kDkv>
struct Smem {
  static constexpr int kStages = kStagesAt<D>;
  static constexpr int kRow = 2 * D;           // bytes a row: 32 or 64
  static constexpr int kTile = kBlock * kRow;  // one tile
  static constexpr int kOutTile = kWarpRows * kRow;  // a warp's staging rows of one output
  static constexpr int kStats = 2 * kBlock * 4;  // lse and delta of 64 rows, float32
  static constexpr int kItem0 = 0;             // Q (dQ) or K (dK/dV)
  static constexpr int kItem1 = kItemBufs * kTile;      // dO (dQ) or V (dK/dV)
  static constexpr int kRing0 = 2 * kItemBufs * kTile;  // K (dQ) or Q (dK/dV), kStages tiles
  static constexpr int kRing1 = kRing0 + kStages * kTile;  // V (dQ) or dO (dK/dV)
  static constexpr int kOut = kRing1 + kStages * kTile;    // dq, or dk then dv, a warp each
  static constexpr int kRowStats = kOut + (kDkv ? 2 : 1) * (kConsumers / 32) * kOutTile;
  // item full and item empty for each buffer, then ring full and empty a stage
  static constexpr int kBar = kRowStats + (kDkv ? kStages : kItemBufs) * kStats;
  static constexpr int kItemEmpty = kBar + 8 * kItemBufs;
  static constexpr int kRingFull = kItemEmpty + 8 * kItemBufs;
  static constexpr int kRingEmpty = kRingFull + 8 * kStages;
  static constexpr int kBytes = kRingEmpty + 8 * kStages;
  static constexpr int kAlloc = kBytes + 1024;  // room to align
  static_assert(kAlloc <= 232448, "shared memory over the 227 KB a block may use");
};

struct Params {
  const float* lse;
  const float* delta;
  int bh;          // batch * heads
  int n_tiles;     // item tiles a head: q tiles (dQ) or kv tiles (dK/dV)
  int n_items;     // n_tiles * bh
  int group;       // heads an L2 group
  int t_q;
  int t_kv;
  int off;         // t_kv - t_q
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// item -> (head, first row of its tile): heads in groups of p.group, and
// within a group the tiles heaviest first, each tile index across the
// group's heads; the heaviest are the last q tiles (dQ) or the first kv
// tiles (dK/dV)
template <bool kDkv>
__device__ __forceinline__ void item_at(const Params& p, int item, int& bh, int& row0) {
  const int per_group = p.group * p.n_tiles;
  const int head0 = item / per_group * p.group;
  const int heads = min(p.group, p.bh - head0);
  const int rank = item % per_group;
  bh = head0 + rank % heads;
  row0 = (kDkv ? rank / heads : p.n_tiles - 1 - rank / heads) * kBlock;
}

// kv tiles a q tile at q0 runs in the dQ pass: the causal skip as a loop
// bound
__device__ __forceinline__ int dq_kv_tiles(const Params& p, int q0) {
  const int n_kv = (p.t_kv + kBlock - 1) / kBlock;
  if (!p.causal) return n_kv;
  const int last = min(q0 + kBlock, p.t_q) - 1 + p.off;
  if (last < 0) return 0;
  return min(n_kv, last / kBlock + 1);
}

// first q tile a kv tile at k0 runs in the dK/dV pass: earlier q tiles lie
// wholly above the causal diagonal
__device__ __forceinline__ int dkv_first_q_tile(const Params& p, int k0) {
  const int n_q = (p.t_q + kBlock - 1) / kBlock;
  if (!p.causal) return 0;
  const int r0 = k0 - p.off;  // the first q row that sees key k0
  if (r0 <= 0) return 0;
  return r0 >= p.t_q ? n_q : r0 / kBlock;
}

// One producer lane's share of the lse and delta of q rows q0 .. q0 + 63,
// copied to `stats` (64 lse values, then 64 deltas) by cp.async, zeros for
// rows past t_q, arriving on `bar` when they have landed
__device__ __forceinline__ void copy_row_stats(const Params& p, uint32_t stats, uint32_t bar,
                                               int bh, int q0, int lane) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = lane + 32 * h;
    const int row = q0 + r;
    const size_t at = (size_t)bh * p.t_q + min(row, p.t_q - 1);
    const int bytes = row < p.t_q ? 4 : 0;
    cp_async_4(stats + 4 * r, p.lse + at, bytes);
    cp_async_4(stats + 4 * (kBlock + r), p.delta + at, bytes);
  }
  cp_async_arrive(bar);
}

// A warp's accumulator [16 x D] times mul, in bf16, into its swizzled
// staging rows `rows` (generic address of a kOutTile tile); element i sits
// at row g + 8 ((i >> 1) & 1), column 8 (i >> 2) + 2 tq + (i & 1), so the
// lane's two columns of n-tile nt are 4 bytes at 16-byte chunk nt
template <int D>
__device__ __forceinline__ void stage_rows(uint8_t* rows, const float* acc, float mul, int g,
                                           int tq) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      *reinterpret_cast<uint32_t*>(rows + narrow_offset<2 * D>(g + 8 * r, nt) + 4 * tq) =
          pack_bf16(acc[4 * nt + 2 * r] * mul, acc[4 * nt + 2 * r + 1] * mul);
    }
  }
}

// ---------------------------------------------------------------------------
// one chunk of a tile: kC 8-column pieces from piece kC * ch, for one warp's
// 16 rows
// ---------------------------------------------------------------------------

// dQ: S and dP over the chunk's pieces, P and dS / scale, and dq += dS K over
// the k-steps the chunk fills. With kMasked, columns past lim[r] (the last
// one row r sees: causal mask, end of kv) get P = 0: column 8 piece + 2 tq
// + (i & 1) of the tile is visible while 8 piece + (i & 1) <= last[r]. l2
// and dl are the two rows' lse * log2(e) and delta.
template <int D, int kC, bool kMasked>
__device__ __forceinline__ void dq_chunk(float* dq, const uint32_t (*qa)[4],
                                         const uint32_t (*da)[4], uint32_t k_tile,
                                         uint32_t v_tile, const float* l2, const float* dl,
                                         const int* last, int ch, float scale_log2, int lane) {
  float s[4 * kC], dp[4 * kC];
  narrow_nt<D, kC / 2>(s, qa, k_tile, ch * kC / 2, lane);
  narrow_nt<D, kC / 2>(dp, da, v_tile, ch * kC / 2, lane);
#pragma unroll
  for (int i = 0; i < 4 * kC; ++i) {
    const int r = (i >> 1) & 1;
    float pe = fast_exp2(fmaf(s[i], scale_log2, -l2[r]));
    if constexpr (kMasked) {
      if (8 * (kC * ch + (i >> 2)) + (i & 1) > last[r]) pe = 0.f;
    }
    s[i] = pe * (dp[i] - dl[r]);
  }
  // k-step kk: dS's columns 16 kk .. 16 kk + 15 of the chunk in bf16 (the
  // accumulator's own order is the A fragment's) times K's rows there
#pragma unroll
  for (int kk = 0; kk < kC / 2; ++kk) {
    uint32_t a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    narrow_nn_step<D>(dq, a, k_tile, ch * kC / 2 + kk, lane);
  }
}

// dK/dV: S^T and dP^T over the chunk's pieces, P^T and dS^T / scale, and
// dv += P^T dO and dk += dS^T Q over the k-steps the chunk fills. With
// kMasked, q column c of kv row r is visible from first[r] on (causal
// mask): column 8 piece + 2 tq + (i & 1) of the tile is visible while
// 8 piece + (i & 1) >= first[r]. stats holds the q tile's 64 lse values,
// then its 64 deltas.
template <int D, int kC, bool kMasked>
__device__ __forceinline__ void dkv_chunk(float* dk, float* dv, const uint32_t (*ka)[4],
                                          const uint32_t (*va)[4], uint32_t q_tile,
                                          uint32_t do_tile, const float* stats,
                                          const int* first, int ch, float scale_log2,
                                          int lane) {
  const int tq = lane & 3;
  float s[4 * kC], dp[4 * kC];
  narrow_nt<D, kC / 2>(s, ka, q_tile, ch * kC / 2, lane);
  narrow_nt<D, kC / 2>(dp, va, do_tile, ch * kC / 2, lane);
#pragma unroll
  for (int j = 0; j < kC; ++j) {
    // the piece's two columns of this lane: 8 piece + 2 tq and the next
    const int col = 8 * (kC * ch + j) + 2 * tq;
    const float2 l = *reinterpret_cast<const float2*>(stats + col);
    const float2 dl = *reinterpret_cast<const float2*>(stats + kBlock + col);
    const float l2[2] = {l.x * kLog2e, l.y * kLog2e};
    const float dl2[2] = {dl.x, dl.y};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * j + e;
      float pe = fast_exp2(fmaf(s[i], scale_log2, -l2[e & 1]));
      if constexpr (kMasked) {
        if (8 * (kC * ch + j) + (e & 1) < first[e >> 1]) pe = 0.f;
      }
      s[i] = pe;
      dp[i] = pe * (dp[i] - dl2[e & 1]);
    }
  }
  // k-step kk: P^T's (dS^T's) columns 16 kk .. 16 kk + 15 of the chunk in
  // bf16 times dO's (Q's) rows there
#pragma unroll
  for (int kk = 0; kk < kC / 2; ++kk) {
    uint32_t a[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = pack_bf16(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
    narrow_nn_step<D>(dv, a, do_tile, ch * kC / 2 + kk, lane);
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = pack_bf16(dp[8 * kk + 2 * i], dp[8 * kk + 2 * i + 1]);
    narrow_nn_step<D>(dk, a, q_tile, ch * kC / 2 + kk, lane);
  }
}

// ---------------------------------------------------------------------------
// the kernels
// ---------------------------------------------------------------------------

// The producer warp: walks the items' loads in the consumers' order. Each
// item's two tiles (tm_item0, tm_item1 at the item's rows) go to item
// buffer n % kItemBufs; the streamed tiles (tm_ring0, tm_ring1) through the ring,
// whose position c runs on across items. The lse and delta of 64 q rows go
// beside the item's tiles (dQ) or each stage's (dK/dV), copied by the
// warp's lanes.
template <int D, bool kDkv>
__device__ __forceinline__ void produce(const CUtensorMap* tm_item0, const CUtensorMap* tm_item1,
                                        const CUtensorMap* tm_ring0, const CUtensorMap* tm_ring1,
                                        const Params& p, uint32_t base, int lane) {
  using S = Smem<D, kDkv>;
  constexpr int kStages = S::kStages;
  const uint32_t bar_item_full = base + S::kBar;  // + 8 * buffer, likewise below
  const uint32_t bar_item_empty = base + S::kItemEmpty;
  const uint32_t bar_ring_full = base + S::kRingFull;  // + 8 * stage, likewise below
  const uint32_t bar_ring_empty = base + S::kRingEmpty;
  const int n_q = (p.t_q + kBlock - 1) / kBlock;
  int c = 0, n = 0;
#pragma unroll 1
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++n) {
    int bh, row0;
    item_at<kDkv>(p, item, bh, row0);
    const int ib = n % kItemBufs;
    if (n >= kItemBufs) mbar_wait_or_trap(bar_item_empty + 8 * ib, (n / kItemBufs - 1) & 1);
    if (lane == 0) {
      mbar_arrive_expect_tx(bar_item_full + 8 * ib, 2 * S::kTile);
      tma_load_3d(base + S::kItem0 + ib * S::kTile, tm_item0, bar_item_full + 8 * ib, 0, row0, bh);
      tma_load_3d(base + S::kItem1 + ib * S::kTile, tm_item1, bar_item_full + 8 * ib, 0, row0, bh);
    }
    if constexpr (!kDkv) {
      copy_row_stats(p, base + S::kRowStats + ib * S::kStats, bar_item_full + 8 * ib, bh, row0,
                     lane);
    }
    const int j0 = kDkv ? dkv_first_q_tile(p, row0) : 0;
    const int j1 = kDkv ? n_q : dq_kv_tiles(p, row0);
#pragma unroll 1
    for (int j = j0; j < j1; ++j, ++c) {
      const int s = c % kStages;
      if (c >= kStages) mbar_wait_or_trap(bar_ring_empty + 8 * s, (c / kStages - 1) & 1);
      if (lane == 0) {
        mbar_arrive_expect_tx(bar_ring_full + 8 * s, 2 * S::kTile);
        tma_load_3d(base + S::kRing0 + s * S::kTile, tm_ring0, bar_ring_full + 8 * s, 0,
                    j * kBlock, bh);
        tma_load_3d(base + S::kRing1 + s * S::kTile, tm_ring1, bar_ring_full + 8 * s, 0,
                    j * kBlock, bh);
      }
      if constexpr (kDkv) {
        copy_row_stats(p, base + S::kRowStats + s * S::kStats, bar_ring_full + 8 * s, bh,
                       j * kBlock, lane);
      }
    }
  }
  // the consumers' last release of each stage and buffer: a stalled
  // pipeline traps here
  if (lane == 0) {
#pragma unroll 1
    for (int cc = max(0, c - kStages); cc < c; ++cc) {
      mbar_wait_or_trap(bar_ring_empty + 8 * (cc % kStages), (cc / kStages) & 1);
    }
#pragma unroll 1
    for (int nn = max(0, n - kItemBufs); nn < n; ++nn) {
      mbar_wait_or_trap(bar_item_empty + 8 * (nn % kItemBufs), (nn / kItemBufs) & 1);
    }
  }
}

// barriers: item full (kStatsArrivals for dQ, whose item buffers carry lse
// and delta, else 1) and empty (one arrival a consumer warp) for each
// buffer, then ring full (kStatsArrivals for dK/dV, else 1) and empty a
// stage
template <int D, bool kDkv>
__device__ __forceinline__ void init_barriers(uint32_t base) {
  using S = Smem<D, kDkv>;
  if (threadIdx.x == 0) {
    for (int b = 0; b < kItemBufs; ++b) {
      mbar_init(base + S::kBar + 8 * b, kDkv ? 1 : kStatsArrivals);
      mbar_init(base + S::kItemEmpty + 8 * b, kConsumers / 32);
    }
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(base + S::kRingFull + 8 * s, kDkv ? kStatsArrivals : 1);
      mbar_init(base + S::kRingEmpty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// A warp's rows of its outputs (acc0, and acc1 unless null), from registers
// through its staging tiles (at off0, off1) to TMA stores at rows row0 ..
// row0 + 15 of head bh (rows past `rows` are clipped). The warp first waits
// for its previous stores to have read the staging tiles.
template <int D>
__device__ __forceinline__ void store_warp_rows(const CUtensorMap* tm0, const CUtensorMap* tm1,
                                                uint8_t* gbase, uint32_t base, int off0,
                                                int off1, const float* acc0, const float* acc1,
                                                float mul0, int row0, int rows, int bh,
                                                int lane) {
  if (lane == 0) bulk_wait_all<true>();
  __syncwarp();
  stage_rows<D>(gbase + off0, acc0, mul0, lane >> 2, lane & 3);
  if (acc1 != nullptr) stage_rows<D>(gbase + off1, acc1, 1.f, lane >> 2, lane & 3);
  fence_async_shared();
  __syncwarp();
  if (lane == 0 && row0 < rows) {
    tma_store_3d(tm0, base + off0, 0, row0, bh);
    if (acc1 != nullptr) tma_store_3d(tm1, base + off1, 0, row0, bh);
    bulk_commit();
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_bwd_dq_persistent_kernel(const __grid_constant__ CUtensorMap tm_q,
                                   const __grid_constant__ CUtensorMap tm_do,
                                   const __grid_constant__ CUtensorMap tm_k,
                                   const __grid_constant__ CUtensorMap tm_v,
                                   const __grid_constant__ CUtensorMap tm_dq, const Params p) {
  using S = Smem<D, false>;
  constexpr int kC = kChunk;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bar_item_full = base + S::kBar;
  const uint32_t bar_item_empty = base + S::kItemEmpty;
  const uint32_t bar_kv_full = base + S::kRingFull;
  const uint32_t bar_kv_empty = base + S::kRingEmpty;
  init_barriers<D, false>(base);

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= kConsumers) {
    produce<D, false>(&tm_q, &tm_do, &tm_k, &tm_v, p, base, lane);
    return;
  }

  // ---- consumers: warp w owns rows 16 w .. 16 w + 15 of each item's q tile
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int tq = lane & 3;  // column pair within an 8-column piece
  const int out = S::kOut + warp * S::kOutTile;
  int c = 0, n = 0;
#pragma unroll 1
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++n) {
    int bh, q0;
    item_at<false>(p, item, bh, q0);
    const int n_run = dq_kv_tiles(p, q0);
    const int ib = n % kItemBufs;
    const int row0 = q0 + kWarpRows * warp + g;  // rows row0 and row0 + 8
    // the last column each of the two rows sees, and any of the warp's rows
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lim[r] = p.causal ? min(row0 + 8 * r + p.off, p.t_kv - 1) : p.t_kv - 1;
    }
    const int warp_lim =
        p.causal ? min(q0 + kWarpRows * warp + 15 + p.off, p.t_kv - 1) : p.t_kv - 1;
    const bool warp_live = q0 + kWarpRows * warp < p.t_q;  // a row of the warp is a q row

    mbar_wait(bar_item_full + 8 * ib, (n / kItemBufs) & 1);
    uint32_t qa[D / 16][4], da[D / 16][4];
    narrow_a_frags<D>(qa, base + S::kItem0 + ib * S::kTile, kWarpRows * warp, lane);
    narrow_a_frags<D>(da, base + S::kItem1 + ib * S::kTile, kWarpRows * warp, lane);
    const float* stats = reinterpret_cast<const float*>(gbase + S::kRowStats + ib * S::kStats);
    const int at = kWarpRows * warp + g;
    const float l2[2] = {stats[at] * kLog2e, stats[at + 8] * kLog2e};
    const float dl[2] = {stats[kBlock + at], stats[kBlock + at + 8]};
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_item_empty + 8 * ib);

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
#pragma unroll 1
    for (int j = 0; j < n_run; ++j, ++c) {
      const int s = c % kStages;
      const int k0 = j * kBlock;
      const uint32_t k_tile = base + S::kRing0 + s * S::kTile;
      const uint32_t v_tile = base + S::kRing1 + s * S::kTile;
      mbar_wait(bar_kv_full + 8 * s, (c / kStages) & 1);
      // masks where the tile crosses the diagonal of this warp's rows or the
      // end of kv; there, only the chunks up to the warp's last visible
      // column run
      const bool masked =
          (p.causal && q0 + kWarpRows * warp + p.off < k0 + kBlock - 1) || k0 + kBlock > p.t_kv;
      if (masked || !warp_live) {
        const int chunks = !warp_live || warp_lim < k0 ? 0 : (warp_lim - k0) / (8 * kC) + 1;
        const int last[2] = {lim[0] - k0 - 2 * tq, lim[1] - k0 - 2 * tq};
#pragma unroll
        for (int ch = 0; ch < 8 / kC; ++ch) {
          if (ch < chunks) {
            dq_chunk<D, kC, true>(dq, qa, da, k_tile, v_tile, l2, dl, last, ch, p.scale_log2,
                                  lane);
          }
        }
      } else {
#pragma unroll
        for (int ch = 0; ch < 8 / kC; ++ch) {
          dq_chunk<D, kC, false>(dq, qa, da, k_tile, v_tile, l2, dl, lim, ch, p.scale_log2,
                                 lane);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_kv_empty + 8 * s);
    }
    // ---- epilogue: dq = scale * sum of dS / scale K
    store_warp_rows<D>(&tm_dq, nullptr, gbase, base, out, 0, dq, nullptr, p.scale,
                       q0 + kWarpRows * warp, p.t_q, bh, lane);
  }
  if (lane == 0) bulk_wait_all<false>();
}

template <int D>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    flash_bwd_dkv_persistent_kernel(const __grid_constant__ CUtensorMap tm_k,
                                    const __grid_constant__ CUtensorMap tm_v,
                                    const __grid_constant__ CUtensorMap tm_q,
                                    const __grid_constant__ CUtensorMap tm_do,
                                    const __grid_constant__ CUtensorMap tm_dk,
                                    const __grid_constant__ CUtensorMap tm_dv, const Params p) {
  using S = Smem<D, true>;
  constexpr int kC = kChunk;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - raw);
  const uint32_t bar_item_full = base + S::kBar;
  const uint32_t bar_item_empty = base + S::kItemEmpty;
  const uint32_t bar_q_full = base + S::kRingFull;
  const uint32_t bar_q_empty = base + S::kRingEmpty;
  init_barriers<D, true>(base);

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= kConsumers) {
    produce<D, true>(&tm_k, &tm_v, &tm_q, &tm_do, p, base, lane);
    return;
  }

  // ---- consumers: warp w owns kv rows 16 w .. 16 w + 15 of each item's tile
  const int warp = threadIdx.x / 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int out_dk = S::kOut + warp * S::kOutTile;
  const int out_dv = out_dk + (kConsumers / 32) * S::kOutTile;
  const int n_q = (p.t_q + kBlock - 1) / kBlock;
  int c = 0, n = 0;
#pragma unroll 1
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++n) {
    int bh, k0;
    item_at<true>(p, item, bh, k0);
    const int ib = n % kItemBufs;
    const int kr0 = k0 + kWarpRows * warp;  // the warp's first kv row
    const bool warp_live = kr0 < p.t_kv;    // a row of the warp is a kv row

    mbar_wait(bar_item_full + 8 * ib, (n / kItemBufs) & 1);
    uint32_t ka[D / 16][4], va[D / 16][4];
    narrow_a_frags<D>(ka, base + S::kItem0 + ib * S::kTile, kWarpRows * warp, lane);
    narrow_a_frags<D>(va, base + S::kItem1 + ib * S::kTile, kWarpRows * warp, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_item_empty + 8 * ib);

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;
#pragma unroll 1
    for (int qt = dkv_first_q_tile(p, k0); qt < n_q; ++qt, ++c) {
      const int s = c % kStages;
      const int q0 = qt * kBlock;
      const uint32_t q_tile = base + S::kRing0 + s * S::kTile;
      const uint32_t do_tile = base + S::kRing1 + s * S::kTile;
      const float* stats = reinterpret_cast<const float*>(gbase + S::kRowStats + s * S::kStats);
      mbar_wait(bar_q_full + 8 * s, (c / kStages) & 1);
      // q column fc of the tile is the first that kv row kr0 sees; masks
      // where the tile crosses the diagonal of this warp's rows, and there
      // only the chunks from the warp's first visible column on run
      const int fc = kr0 - p.off - q0;
      const bool masked = p.causal && fc + 15 > 0;
      const int first[2] = {fc + g - 2 * tq, fc + g + 8 - 2 * tq};
      if (masked || !warp_live) {
        const int first_chunk = !warp_live || fc >= kBlock ? 8 / kC : max(fc, 0) / (8 * kC);
#pragma unroll
        for (int ch = 0; ch < 8 / kC; ++ch) {
          if (ch >= first_chunk) {
            dkv_chunk<D, kC, true>(dk, dv, ka, va, q_tile, do_tile, stats, first, ch,
                                   p.scale_log2, lane);
          }
        }
      } else {
#pragma unroll
        for (int ch = 0; ch < 8 / kC; ++ch) {
          dkv_chunk<D, kC, false>(dk, dv, ka, va, q_tile, do_tile, stats, first, ch,
                                  p.scale_log2, lane);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_q_empty + 8 * s);
    }
    // ---- epilogue: dk = scale * sum of dS^T / scale Q, and dv
    store_warp_rows<D>(&tm_dk, &tm_dv, gbase, base, out_dk, out_dv, dk, dv, p.scale, kr0,
                       p.t_kv, bh, lane);
  }
  if (lane == 0) bulk_wait_all<false>();
}

template <int D, bool kDkv>
auto kernel_of() {
  if constexpr (kDkv) {
    return flash_bwd_dkv_persistent_kernel<D>;
  } else {
    return flash_bwd_dq_persistent_kernel<D>;
  }
}

// CTAs of the kernel resident on an SM and the card's SMs, for the current
// device (asked once a device)
template <int D, bool kDkv>
int grid_size(int* ctas_per_sm, int* sms) {
  static int device = -1, per_sm = 0, n_sm = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != device) {
    auto kernel = kernel_of<D, kDkv>();
    constexpr int kAlloc = Smem<D, kDkv>::kAlloc;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kAlloc);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, kAlloc);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    device = dev;
  }
  *ctas_per_sm = per_sm;
  *sms = n_sm;
  return 0;
}

// The tensor maps: dQ's item tiles are Q and dO, its streamed tiles K and
// V; dK/dV's the reverse; 64 rows by d. The outputs' are a warp's 16 rows.
// All with the 32- or 64-byte swizzle.
template <int D, bool kDkv>
int launch(const void* q, const void* k, const void* v, const void* dout, void* out0,
           void* out1, const Params& p, cudaStream_t stream) {
  constexpr CUtensorMapSwizzle kSwizzle =
      D == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B;
  const int out_rows = kDkv ? p.t_kv : p.t_q;
  CUtensorMap tm_q, tm_do, tm_k, tm_v, tm_out0, tm_out1;
  if (make_map(&tm_q, q, D, p.t_q, p.bh, kBlock, D, kSwizzle) ||
      make_map(&tm_do, dout, D, p.t_q, p.bh, kBlock, D, kSwizzle) ||
      make_map(&tm_k, k, D, p.t_kv, p.bh, kBlock, D, kSwizzle) ||
      make_map(&tm_v, v, D, p.t_kv, p.bh, kBlock, D, kSwizzle) ||
      make_map(&tm_out0, out0, D, out_rows, p.bh, kWarpRows, D, kSwizzle) ||
      (kDkv && make_map(&tm_out1, out1, D, out_rows, p.bh, kWarpRows, D, kSwizzle))) {
    return kTensorMapFailed;
  }
  int per_sm = 0, sms = 0;
  const int err = grid_size<D, kDkv>(&per_sm, &sms);
  if (err != 0) return err;
  if (per_sm < 1) return kUnsupported;
  const int grid = min(p.n_items, per_sm * sms);
  constexpr int kAlloc = Smem<D, kDkv>::kAlloc;
  if constexpr (kDkv) {
    flash_bwd_dkv_persistent_kernel<D><<<grid, kThreads, kAlloc, stream>>>(
        tm_k, tm_v, tm_q, tm_do, tm_out0, tm_out1, p);
  } else {
    flash_bwd_dq_persistent_kernel<D><<<grid, kThreads, kAlloc, stream>>>(tm_q, tm_do, tm_k,
                                                                           tm_v, tm_out0, p);
  }
  return (int)cudaGetLastError();
}

int dispatch(bool dkv, const void* q, const void* k, const void* v, const void* dout,
             const void* lse, const void* delta, void* out0, void* out1, int bh, int t_q,
             int t_kv, int d, int dtype, int causal, float scale, void* stream) {
  const int rows = dkv ? t_kv : t_q;
  if (bh <= 0 || t_q <= 0 || t_kv <= 0 || dtype != 0 || (d != 16 && d != 32) ||
      (long long)bh * ((rows + kBlock - 1) / kBlock) > 0x7fffffffll) {
    return kUnsupported;
  }
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.bh = bh;
  p.n_tiles = (rows + kBlock - 1) / kBlock;
  p.n_items = p.n_tiles * bh;
  // the streamed tiles of one head, bf16 (and dK/dV's lse and delta)
  p.group = l2_group(dkv ? 4ll * t_q * d + 8ll * t_q : 4ll * t_kv * d, bh);
  p.t_q = t_q;
  p.t_kv = t_kv;
  p.off = t_kv - t_q;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dkv) {
    return d == 16 ? launch<16, true>(q, k, v, dout, out0, out1, p, st)
                   : launch<32, true>(q, k, v, dout, out0, out1, p, st);
  }
  return d == 16 ? launch<16, false>(q, k, v, dout, out0, out1, p, st)
                 : launch<32, false>(q, k, v, dout, out0, out1, p, st);
}

}  // namespace

extern "C" int ray_tpu_flash_bwd_persistent_smem_bytes(int d, int dkv) {
  switch (d) {
    case 16: return dkv ? Smem<16, true>::kAlloc : Smem<16, false>::kAlloc;
    case 32: return dkv ? Smem<32, true>::kAlloc : Smem<32, false>::kAlloc;
  }
  return 0;
}

extern "C" int ray_tpu_flash_bwd_persistent_ctas_per_sm(int d, int dkv) {
  int per_sm = 0, sms = 0, err = -1;
  if (d == 16) {
    err = dkv ? grid_size<16, true>(&per_sm, &sms) : grid_size<16, false>(&per_sm, &sms);
  } else if (d == 32) {
    err = dkv ? grid_size<32, true>(&per_sm, &sms) : grid_size<32, false>(&per_sm, &sms);
  }
  return err == 0 ? per_sm : -1;
}

extern "C" int ray_tpu_flash_bwd_dq_persistent(const void* q, const void* k, const void* v,
                                               const void* dout, const void* lse,
                                               const void* delta, void* dq, int bh, int t_q,
                                               int t_kv, int d, int dtype, int causal,
                                               float scale, void* stream) {
  return dispatch(false, q, k, v, dout, lse, delta, dq, nullptr, bh, t_q, t_kv, d, dtype,
                  causal, scale, stream);
}

extern "C" int ray_tpu_flash_bwd_dkv_persistent(const void* q, const void* k, const void* v,
                                                const void* dout, const void* lse,
                                                const void* delta, void* dk, void* dv, int bh,
                                                int t_q, int t_kv, int d, int dtype, int causal,
                                                float scale, void* stream) {
  return dispatch(true, q, k, v, dout, lse, delta, dk, dv, bh, t_q, t_kv, d, dtype, causal,
                  scale, stream);
}

extern "C" const char* ray_tpu_flash_bwd_persistent_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype or shape";
  if (err == kTensorMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
