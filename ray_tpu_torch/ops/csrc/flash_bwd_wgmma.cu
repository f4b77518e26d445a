// Flash-attention backward for Hopper (sm_90a): TMA loads into an mbarrier
// ring, every product on wgmma, warp-specialised. Hand-written CUDA C++.
// Its inputs are bf16 or float16 (the kernels' T; the comments say bf16
// for either).
//
// Replaces the two TPU kernels of ray_tpu/ops/attention.py launched by
// _flash_attention_tpu_bwd, for bf16 and float16 at head_dim 64, 128 and 256
// (at 64 dK/dV is csrc/flash_bwd_d64.cu's, and this one the variants
// script's "before"):
//   * _flash_bwd_dkv_kernel -> flash_bwd_dkv_wgmma_kernel (dK and dV at 64
//     and 128) and flash_bwd_dkv_wgmma_split_kernel (at 256);
//   * _flash_bwd_dq_kernel  -> flash_bwd_dq_wgmma_kernel (dQ).
// csrc/flash_bwd_persistent.cu takes bf16 at head_dim 16 and 32 and
// csrc/flash_bwd_f32.cu float32, as the dispatch table in ops/attention.py
// (BWD_DESIGNS) says. All three kernels
// recompute P = exp(scale * Q K^T - lse) from the forward's row lse,
// then dP = dO V^T and dS = P * (dP - delta) * scale with delta =
// rowsum(dO * O) (computed by the caller, as the reference computes it
// outside its kernels), and accumulate dV = P^T dO, dK = dS^T Q, dQ = dS K.
// The conventions are the reference's:
//   * a masked score gives P = exp(NEG_INF - lse) = 0: here P is set to 0;
//   * under the causal mask q rows are the suffix of the kv context:
//     q_pos = q_idx + (t_kv - t_q), and key k is visible when q_pos >= k;
//   * tiles wholly above the causal diagonal are skipped (loop bounds);
//   * where causal and t_q > t_kv, a row whose lse <= NEG_INF / 2 (it sees
//     no key) gets P = 0: its dQ is 0 and it adds nothing to dK and dV;
//   * padded rows of a ragged last tile read zeros (TMA fills rows past t)
//     and get P = 0 (lse is taken as +inf there), so they add nothing; the
//     outputs' padded rows are clipped by the TMA store.
// Each CTA owns its output tile: there are no atomics and no split
// reduction, so equal inputs give equal bits. The plain version in
// ops/attention.py (flash_attention_bwd_plain) is the same arithmetic in
// float32 over the whole score matrix; the result does not depend on tiles.
//
// What bounds them on an H100: the tensor-core operations, 8 * d per visible
// (q, k) pair for dK/dV (S, dP, dV, dK) and 6 * d for dQ (S, dP, dQ), at 989
// TFLOP/s in bf16. S and dP are computed in both kernels (14 * d a pair
// against a fused backward's 10 * d), the price of owning every output tile
// without atomics. Each kernel reads its resident tiles once and streams the
// other side's through L2: the launch order below keeps each head's streamed
// tiles in L2 for all the CTAs that read them.
//
// Design, both kernels: one CTA of 384 threads per (128-row tile, batch *
// head). Warpgroup 0 is the producer (setmaxnreg 24); its thread 0 issues
// every TMA load: the CTA's resident 128-row tiles once, then the streamed
// tiles into a ring of kStages stages with full and empty mbarriers (the 8
// consumer warps arrive on a stage's empty barrier when they are done with
// it). Warpgroups 1 and 2 are the consumers (setmaxnreg 240), each owning 64
// of the CTA's rows; every tile is 64-column boxes of 128-byte swizzled rows,
// and the products use hopper.cuh's descriptors:
//   * dK/dV (kv tile resident: K and V, 128 rows; Q and dO stream in tiles
//     of 64 rows, with their 64 rows of lse (in log2 units) and delta, which
//     warp 1 of the producer writes into the stage and arrives on its full
//     barrier for):
//       S^T = K Q^T and dP^T = V dO^T, all operands K-major;
//       P^T and dS^T in registers, rounded to bf16 in the A-operand layout;
//       dV += P^T dO and dK += dS^T Q, A from registers, dO and Q read
//       MN-major through the transpose bit, as the forward reads V.
//     The q loop starts at the first q tile that sees the CTA's first key.
//   * dQ (q tile resident: Q and dO, 128 rows; K and V stream in tiles of
//     kDqBlockK rows, as in the forward; each consumer thread keeps the lse and
//     delta of its two rows in registers):
//       S = Q K^T and dP = dO V^T, K-major;
//       P = exp2(S * scale * log2 e - lse * log2 e), dS in registers, bf16;
//       dQ += dS K, A from registers, K read MN-major.
//     The kv loop ends at the last kv tile the CTA's last row sees.
//   * dK/dV at head_dim 256 (the split kernel): a [64 x 256] float32
//     accumulator takes 128 registers a consumer thread, so dK and dV of
//     the same rows (256) would not fit in 240. A CTA owns 64 kv rows and
//     its two consumer warpgroups split the work by output, not by rows:
//     warpgroup 0 computes S^T = K Q^T, P^T and dV += P^T dO; warpgroup 1
//     dP^T = V dO^T, dS^T = P^T * (dP^T - delta) * scale and dK += dS^T Q.
//     P^T crosses in float32 through one [64 x 64] shared tile (16 KiB;
//     both warpgroups hold a 64 x 64 accumulator in the same layout, so
//     each thread reads the slots its twin wrote) under two named
//     barriers, full and empty, so neither recomputes the other's product
//     (8 * d a pair, as at 64 and 128) and only warpgroup 0 applies the
//     masks. Shared memory: K and V (64 rows, 64 KiB), two stages of Q and
//     dO (128 KiB), the P^T tile and the stages' lse and delta. Its
//     epilogue writes dV through K's buffer and dK through V's: the tile
//     that only the writing warpgroup read.
//   * dQ at head_dim 256: the same kernel with kv tiles of 48 rows, since Q
//     and dO (128 rows, 128 KiB) leave 96 KiB for two stages of K and V; a
//     consumer thread holds dQ (128 floats), S and dP (24 each) and dS in
//     bf16 (12). S and dP are m64n48 products.
//   * Within a warpgroup, the products of tile j + 1 are issued right behind
//     the accumulating products of tile j, so the tensor cores have work
//     queued while the warpgroup waits: S and dP behind dQ; S^T behind dV
//     and dK, and dP^T once those complete (all six in flight would not fit
//     in 240 registers at head_dim 128). The other warpgroup's elementwise
//     work overlaps this one's products. Masks apply only on tiles that
//     cross the diagonal or the ragged end.
//   * The outputs go back through the CTA's resident tiles (each warpgroup's
//     own 64 rows are read by no one else) and a TMA store that clips rows
//     past t.
//   * Launch order: heads go in groups whose streamed tiles fit in L2
//     together (kL2GroupBytes); within a group the heaviest tiles run first
//     under the causal mask, each tile index across the group's heads: the
//     first kv tiles for dK/dV, the last q tiles for dQ.
// Only the producer's waits trap after kWaitLimitNs (hopper.cuh), so a
// pipeline fault ends the kernel with an error instead of hanging the card;
// thread 0 ends by waiting for the consumers' last release of each stage, so
// every stall reaches one of its waits.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_bwd_dq_wgmma(q, k, v, dout, lse, delta, dq,
//                                  bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dkv_wgmma(q, k, v, dout, lse, delta, dk, dv,
//                                   bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_wgmma_smem_bytes(d, dkv)  (dynamic shared memory per CTA)
// q/dout/dq are [bh, t_q, d], k/v/dk/dv [bh, t_kv, d], contiguous bf16 (dtype
// 0) or float16 (dtype 2), d 64, 128 or 256, 16-byte aligned; lse and delta [bh, t_q] float32. Each launches one
// kernel on `stream`, allocates nothing, and returns cudaGetLastError() after
// the launch, kUnsupported for what it does not take, or kTensorMapFailed.

#include "hopper.cuh"

namespace {

constexpr int kTileRows = 128;  // rows a CTA owns: two consumer warpgroups of 64
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kConsumerWarps = 8;
constexpr int kEpilogueBar = 1;  // named barriers 1, 2: each consumer warpgroup's epilogue
constexpr int kPFullBar = 3;     // the split kernel's P^T tile: written
constexpr int kPEmptyBar = 4;    // and read
constexpr int kBlockQ = 64;      // q rows per streamed tile of the dK/dV kernel
constexpr int kRowStatBytes = 2 * kBlockQ * 4;  // a stage's lse and delta

// Ring depths, and the dQ kernel's kv rows per K/V tile. At head_dim 128 a
// dQ consumer thread holds dQ (64 floats), S and dP (kDqBlockK / 2 each)
// and dS in bf16 (kDqBlockK / 4): 224 registers at 128 rows, which fit; at
// b=12 t=2048 causal they ran 2.7% faster than 64 rows in turns on an H100
// (ops/flash_bwd_variants.py). A third stage in dK/dV's ring made no
// difference there.
constexpr int kDkvStages = 2;
constexpr int kDqBlockK = 128;
constexpr int kDqStages = 2;
// head_dim 256: the kv rows of a dK/dV CTA and its ring depth (a stage of
// Q and dO is 64 KiB), the dQ kernel's kv rows per tile
constexpr int kSplitRows = 64;
constexpr int kSplitStages = 2;
constexpr int kDqBlockK256 = 48;

// shared memory, in bytes from a 1024-aligned base (the swizzle's period)
template <int D>
struct DkvSmem {
  static constexpr int kStages = D == 256 ? kSplitStages : kDkvStages;
  static constexpr int kKVRows = D == 256 ? kSplitRows : kTileRows;  // the CTA's kv rows
  static constexpr int kBoxes = D / 64;             // 64-column boxes per row
  static constexpr int kKVBox = kKVRows * 128;      // one box of K or V (and dK, dV)
  static constexpr int kQBox = kBlockQ * 128;       // one box of a Q or dO tile
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;                 // kStages Q tiles
  static constexpr int kDO = kQ + kStages * kQBytes;       // kStages dO tiles
  static constexpr int kRows = kDO + kStages * kQBytes;    // kStages lse, delta
  static constexpr int kP = kRows + kStages * kRowStatBytes;  // the split kernel's P^T
  static constexpr int kPBytes = D == 256 ? kSplitRows * kBlockQ * 4 : 0;
  static constexpr int kBar = kP + kPBytes;  // barriers, 8 bytes
  // each: K and V full, then kStages full and kStages empty
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align
  static_assert(kAlloc <= 232448, "shared memory over the 227 KB a block may use");
};

template <int D>
struct DqSmem {
  static constexpr int kBN = D == 256 ? kDqBlockK256 : kDqBlockK;
  static constexpr int kStages = kDqStages;
  static constexpr int kBoxes = D / 64;
  static constexpr int kQBox = kTileRows * 128;     // one box of Q or dO (and dQ)
  static constexpr int kKVBox = kBN * 128;          // one box of a K or V tile
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kQ = 0;
  static constexpr int kDO = kQ + kQBytes;
  static constexpr int kK = kDO + kQBytes;               // kStages K tiles
  static constexpr int kV = kK + kStages * kKVBytes;     // kStages V tiles
  static constexpr int kBar = kV + kStages * kKVBytes;   // barriers, 8 bytes each:
  // Q and dO full, then kStages each of K full, V full, K empty and V empty
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages);
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 232448, "shared memory over the 227 KB a block may use");
};

struct Params {
  const float* lse;
  const float* delta;
  int bh;        // batch * heads
  int n_tiles;   // the CTA's own tiles per head (kv for dK/dV, q for dQ)
  int group;     // heads per launch group
  int t_q;
  int t_kv;
  int off;       // t_kv - t_q
  int causal;
  int guard;     // causal && t_q > t_kv: the empty-row guard is on
  float scale;
  float scale_log2;  // scale * log2(e)
};

// The CTA's head and the index of its tile among the head's n_tiles, in
// launch order: heads in groups of p.group, each tile index across the
// group's heads, tile 0 first.
__device__ __forceinline__ void launch_slot(const Params& p, int* bh, int* tile) {
  const int per_group = p.group * p.n_tiles;
  const int head0 = blockIdx.x / per_group * p.group;
  const int heads = min(p.group, p.bh - head0);
  const int rank = blockIdx.x % per_group;
  *bh = head0 + rank % heads;
  *tile = rank / heads;
}

// lse in log2 units and delta of q row `row`: +inf and 0 (P = 0) past t_q
// and where the empty-row guard drops the row
__device__ __forceinline__ void row_stats(const Params& p, int bh, int row, float* lse2,
                                          float* dl) {
  *lse2 = INFINITY;
  *dl = 0.f;
  if (row < p.t_q) {
    const float l = p.lse[(size_t)bh * p.t_q + row];
    if (!(p.guard && !(l > kNegInf * 0.5f))) {
      *lse2 = l * kLog2e;
      *dl = p.delta[(size_t)bh * p.t_q + row];
    }
  }
}

// ---------------------------------------------------------------------------
// dK and dV
// ---------------------------------------------------------------------------

// First 64-row q tile that the kv tile at k0 runs: earlier q tiles lie wholly
// above the causal diagonal.
__device__ __forceinline__ int dkv_first_q_tile(const Params& p, int k0) {
  if (!p.causal) return 0;
  const int r0 = k0 - p.off;  // the first q row that sees key k0
  if (r0 <= 0) return 0;
  if (r0 >= p.t_q) return (p.t_q + kBlockQ - 1) / kBlockQ;
  return r0 / kBlockQ;
}

// P^T and dS^T of one [64 kv x 64 q] tile from S^T (s) and dP^T (dp), in
// bf16 in the A-operand layout (pa, dsa), a pair of columns at a time so
// that s and dp die as they go. Element i sits at kv row kv0 + 8 * ((i >> 1)
// & 1) and q column q0 + c, c = 8 * (i >> 2) + 2 * tq + (i & 1); `rows`
// holds the tile's lse (log2 units) at [c] and delta at [64 + c]. Masks
// (causal, past t_kv) only where `masked`.
template <typename T>
__device__ __forceinline__ void dkv_grads(const float* s, const float* dp, uint32_t* pa,
                                          uint32_t* dsa, const float* rows, const Params& p,
                                          int q0, int kv0, int tq, bool masked) {
#pragma unroll
  for (int i = 0; i < kBlockQ / 2; i += 2) {
    const int c = 8 * (i >> 2) + 2 * tq;  // columns c, c + 1
    const int kv = kv0 + 8 * ((i >> 1) & 1);
    const float2 lse2 = *reinterpret_cast<const float2*>(rows + c);
    const float2 dl = *reinterpret_cast<const float2*>(rows + kBlockQ + c);
    float p0 = fast_exp2(fmaf(s[i], p.scale_log2, -lse2.x));
    float p1 = fast_exp2(fmaf(s[i + 1], p.scale_log2, -lse2.y));
    if (masked) {
      const bool out = kv >= p.t_kv;
      if (out || (p.causal && q0 + c + p.off < kv)) p0 = 0.f;
      if (out || (p.causal && q0 + c + 1 + p.off < kv)) p1 = 0.f;
    }
    pa[i / 2] = pack2<T>(p0, p1);
    dsa[i / 2] = pack2<T>(p0 * (dp[i] - dl.x) * p.scale, p1 * (dp[i + 1] - dl.y) * p.scale);
  }
}

// The dK/dV kernels' start: the CTA's head, first kv row, first q tile and
// count of q tiles, and the barriers initialised. Under the causal mask the
// first kv tiles see the most q tiles: tile 0 of each head runs first.
template <int D>
__device__ __forceinline__ void dkv_start(const Params& p, uint32_t base, int* bh, int* k0,
                                          int* first, int* n_run) {
  using S = DkvSmem<D>;
  int tile;
  launch_slot(p, bh, &tile);
  *k0 = tile * S::kKVRows;
  *first = dkv_first_q_tile(p, *k0);
  *n_run = (p.t_q + kBlockQ - 1) / kBlockQ - *first;
  const uint32_t bar_kv = base + S::kBar;
  const uint32_t bar_full = bar_kv + 8;
  const uint32_t bar_empty = bar_full + 8 * S::kStages;
  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < S::kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1 + 32);  // thread 0's TMA and warp 1's row stats
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
}

// The dK/dV kernels' producer warpgroup: thread 0 loads the CTA's K and V
// once and keeps the ring of Q and dO tiles full, warp 1 writes each
// stage's lse and delta; the paths never meet.
template <int D>
__device__ __forceinline__ void dkv_producer(const Params& p, const CUtensorMap* tm_q,
                                             const CUtensorMap* tm_k, const CUtensorMap* tm_v,
                                             const CUtensorMap* tm_do, uint32_t base,
                                             uint8_t* gbase, int bh, int k0, int first,
                                             int n_run) {
  using S = DkvSmem<D>;
  constexpr int kStages = S::kStages;
  const uint32_t bar_kv = base + S::kBar;
  const uint32_t bar_full = bar_kv + 8;  // + 8 * stage, likewise below
  const uint32_t bar_empty = bar_full + 8 * kStages;
  if (threadIdx.x == 0 && n_run > 0) {
    mbar_arrive_expect_tx(bar_kv, 2 * S::kKVBytes);
#pragma unroll
    for (int c = 0; c < S::kBoxes; ++c) {
      tma_load_3d(base + S::kK + c * S::kKVBox, tm_k, bar_kv, c * 64, k0, bh);
      tma_load_3d(base + S::kV + c * S::kKVBox, tm_v, bar_kv, c * 64, k0, bh);
    }
#pragma unroll 1
    for (int j = 0; j < n_run; ++j) {
      const int stage = j % kStages;
      const int round = j / kStages;
      // a stage is free once both warpgroups' dV and dK of its last tile
      // have completed
      if (round > 0) mbar_wait_or_trap(bar_empty + 8 * stage, (round - 1) & 1);
      const int q0 = (first + j) * kBlockQ;
      const uint32_t full = bar_full + 8 * stage;
      mbar_arrive_expect_tx(full, 2 * S::kQBytes);
#pragma unroll
      for (int c = 0; c < S::kBoxes; ++c) {
        tma_load_3d(base + S::kQ + stage * S::kQBytes + c * S::kQBox, tm_q, full, c * 64, q0,
                    bh);
        tma_load_3d(base + S::kDO + stage * S::kQBytes + c * S::kQBox, tm_do, full, c * 64,
                    q0, bh);
      }
    }
    // the consumers' last release of each stage: a stalled pipeline traps here
#pragma unroll 1
    for (int j = max(0, n_run - kStages); j < n_run; ++j) {
      mbar_wait_or_trap(bar_empty + 8 * (j % kStages), (j / kStages) & 1);
    }
  } else if (threadIdx.x / 32 == 1) {
    const int lane = threadIdx.x % 32;
#pragma unroll 1
    for (int j = 0; j < n_run; ++j) {
      const int stage = j % kStages;
      const int round = j / kStages;
      if (round > 0) mbar_wait_or_trap(bar_empty + 8 * stage, (round - 1) & 1);
      const int q0 = (first + j) * kBlockQ;
      float* rows = reinterpret_cast<float*>(gbase + S::kRows + stage * kRowStatBytes);
#pragma unroll
      for (int h = 0; h < kBlockQ / 32; ++h) {
        const int r = lane + 32 * h;
        row_stats(p, bh, q0 + r, &rows[r], &rows[kBlockQ + r]);
      }
      mbar_arrive(bar_full + 8 * stage);
    }
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                               const __grid_constant__ CUtensorMap tm_k,
                               const __grid_constant__ CUtensorMap tm_v,
                               const __grid_constant__ CUtensorMap tm_do,
                               const __grid_constant__ CUtensorMap tm_dk,
                               const __grid_constant__ CUtensorMap tm_dv, const Params p) {
  using S = DkvSmem<D>;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_kv = base + S::kBar;
  const uint32_t bar_full = bar_kv + 8;  // + 8 * stage, likewise below
  const uint32_t bar_empty = bar_full + 8 * kStages;

  static_assert(S::kKVRows == kTileRows, "head_dim 256 runs the split kernel");
  int bh, k0, first, n_run;
  dkv_start<D>(p, base, &bh, &k0, &first, &n_run);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    dkv_producer<D>(p, &tm_q, &tm_k, &tm_v, &tm_do, base, gbase, bh, k0, first, n_run);
  } else {
    // ---- consumers: warpgroup cw owns kv rows [k0 + 64 cw, k0 + 64 cw + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    const int wtid = threadIdx.x % 128;
    const int warp = wtid / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;  // row within the warp's 8-row half
    const int tq = lane & 3;  // column pair within an 8-column group
    const int k_wg = k0 + 64 * cw;          // the warpgroup's first kv row
    const int kv0 = k_wg + 16 * warp + g;   // kv rows kv0 and kv0 + 8
    const uint32_t k_rows = base + S::kK + cw * 64 * 128;
    const uint32_t v_rows = base + S::kV + cw * 64 * 128;
    auto q_tile = [&](int stage) { return base + S::kQ + stage * S::kQBytes; };
    auto do_tile = [&](int stage) { return base + S::kDO + stage * S::kQBytes; };

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    if (n_run > 0) {
      float s[kBlockQ / 2];     // S^T
      float dp[kBlockQ / 2];    // dP^T
      uint32_t pa[kBlockQ / 4];   // P^T in bf16, the A operand of dV += P^T dO
      uint32_t dsa[kBlockQ / 4];  // dS^T in bf16, the A operand of dK += dS^T Q
      // P^T and dS^T of tile j in bf16, then dV and dK of it issued
      auto accumulate = [&](int j) {
        const int stage = j % kStages;
        const int q0 = (first + j) * kBlockQ;
        const bool masked = (p.causal && q0 + p.off < k_wg + 63) || k_wg + 64 > p.t_kv;
        dkv_grads<T>(s, dp, pa, dsa,
                  reinterpret_cast<const float*>(gbase + S::kRows + stage * kRowStatBytes), p,
                  q0, kv0, tq, masked);
        fence_regs<kBlockQ / 4>(pa);
        fence_regs<kBlockQ / 4>(dsa);
        fence_regs<D / 2>(dv);
        fence_regs<D / 2>(dk);
        wgmma_fence();
        issue_nn<D, kBlockQ, T>(dv, pa, do_tile(stage));
        issue_nn<D, kBlockQ, T>(dk, dsa, q_tile(stage));
        wgmma_commit();
      };
      auto release = [&](int j) {
        fence_regs<D / 2>(dv);
        fence_regs<D / 2>(dk);
        fence_regs<kBlockQ / 4>(pa);
        fence_regs<kBlockQ / 4>(dsa);
        if (lane == 0) mbar_arrive(bar_empty + 8 * (j % kStages));
      };

      mbar_wait(bar_kv, 0);
      mbar_wait(bar_full, 0);
      fence_regs<kBlockQ / 2>(s);
      fence_regs<kBlockQ / 2>(dp);
      wgmma_fence();
      issue_nt<D, kBlockQ, T>(s, k_rows, q_tile(0));
      issue_nt<D, kBlockQ, T>(dp, v_rows, do_tile(0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kBlockQ / 2>(s);
      fence_regs<kBlockQ / 2>(dp);

      // S^T of tile j + 1 is queued behind dV and dK of tile j, dP^T of it
      // once they have completed: S^T, dP^T, P^T, dS^T, dK and dV all in
      // flight at once would not fit in 240 registers at head_dim 128
#pragma unroll 1
      for (int j = 0; j + 1 < n_run; ++j) {
        const int next = (j + 1) % kStages;
        accumulate(j);
        mbar_wait(bar_full + 8 * next, ((j + 1) / kStages) & 1);
        fence_regs<kBlockQ / 2>(s);
        wgmma_fence();
        issue_nt<D, kBlockQ, T>(s, k_rows, q_tile(next));
        wgmma_commit();
        wgmma_wait<1>();  // dV and dK of tile j
        release(j);
        fence_regs<kBlockQ / 2>(dp);
        wgmma_fence();
        issue_nt<D, kBlockQ, T>(dp, v_rows, do_tile(next));
        wgmma_commit();
        wgmma_wait<0>();  // S^T and dP^T of tile j + 1
        fence_regs<kBlockQ / 2>(s);
        fence_regs<kBlockQ / 2>(dp);
      }
      accumulate(n_run - 1);
      wgmma_wait<0>();
      release(n_run - 1);
    }

    // ---- epilogue: dK and dV through this warpgroup's rows of K's and V's
    // buffers, which its last products have finished reading (or which were
    // never loaded, when no q tile sees these keys)
    const float one[2] = {1.f, 1.f};
    write_rows<D, T>(gbase + S::kK + cw * 64 * 128, S::kKVBox, dk, one, warp, g, tq);
    write_rows<D, T>(gbase + S::kV + cw * 64 * 128, S::kKVBox, dv, one, warp, g, tq);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(kEpilogueBar + cw) : "memory");
    if (wtid == 0) {
#pragma unroll
      for (int c = 0; c < S::kBoxes; ++c) {
        tma_store_3d(&tm_dk, k_rows + c * S::kKVBox, c * 64, k_wg, bh);
        tma_store_3d(&tm_dv, v_rows + c * S::kKVBox, c * 64, k_wg, bh);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// P^T of one [64 kv x 64 q] tile from S^T (s), in place in s (float32) and
// in bf16 in the A-operand layout (pa); the layout, masks and `rows` as in
// dkv_grads.
template <typename T>
__device__ __forceinline__ void dkv_probs(float* s, uint32_t* pa, const float* rows,
                                          const Params& p, int q0, int kv0, int tq,
                                          bool masked) {
#pragma unroll
  for (int i = 0; i < kBlockQ / 2; i += 2) {
    const int c = 8 * (i >> 2) + 2 * tq;  // columns c, c + 1
    const int kv = kv0 + 8 * ((i >> 1) & 1);
    const float2 lse2 = *reinterpret_cast<const float2*>(rows + c);
    float p0 = fast_exp2(fmaf(s[i], p.scale_log2, -lse2.x));
    float p1 = fast_exp2(fmaf(s[i + 1], p.scale_log2, -lse2.y));
    if (masked) {
      const bool out = kv >= p.t_kv;
      if (out || (p.causal && q0 + c + p.off < kv)) p0 = 0.f;
      if (out || (p.causal && q0 + c + 1 + p.off < kv)) p1 = 0.f;
    }
    s[i] = p0;
    s[i + 1] = p1;
    pa[i / 2] = pack2<T>(p0, p1);
  }
}

// dS^T of the tile from dP^T (dp) and P^T, which the other warpgroup wrote
// as float4 (elements i .. i + 3 of its thread wtid at ptile[(i / 4) * 128 +
// wtid]), in bf16 in the A-operand layout (dsa). Elements i, i + 1 and i + 2,
// i + 3 (i % 4 == 0) share their q columns, so their delta.
template <typename T>
__device__ __forceinline__ void dkv_dscores(const float* dp, uint32_t* dsa, const float4* ptile,
                                            const float* rows, const Params& p, int wtid,
                                            int tq) {
#pragma unroll
  for (int i = 0; i < kBlockQ / 2; i += 4) {
    const float4 pr = ptile[(i / 4) * 128 + wtid];
    const float2 dl = *reinterpret_cast<const float2*>(rows + kBlockQ + 8 * (i >> 2) + 2 * tq);
    dsa[i / 2] = pack2<T>(pr.x * (dp[i] - dl.x) * p.scale, pr.y * (dp[i + 1] - dl.y) * p.scale);
    dsa[i / 2 + 1] =
        pack2<T>(pr.z * (dp[i + 2] - dl.x) * p.scale, pr.w * (dp[i + 3] - dl.y) * p.scale);
  }
}

// dK and dV at head_dim 256: warpgroup 0 accumulates dV, warpgroup 1 dK,
// over the CTA's 64 kv rows (the header's design).
template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_wgmma_split_kernel(const __grid_constant__ CUtensorMap tm_q,
                                     const __grid_constant__ CUtensorMap tm_k,
                                     const __grid_constant__ CUtensorMap tm_v,
                                     const __grid_constant__ CUtensorMap tm_do,
                                     const __grid_constant__ CUtensorMap tm_dk,
                                     const __grid_constant__ CUtensorMap tm_dv,
                                     const Params p) {
  using S = DkvSmem<D>;
  constexpr int kStages = S::kStages;
  static_assert(S::kKVRows == 64, "one 64-row warpgroup tile per output");
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_kv = base + S::kBar;
  const uint32_t bar_full = bar_kv + 8;  // + 8 * stage, likewise below
  const uint32_t bar_empty = bar_full + 8 * kStages;

  int bh, k0, first, n_run;
  dkv_start<D>(p, base, &bh, &k0, &first, &n_run);

  if (threadIdx.x < 128) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    dkv_producer<D>(p, &tm_q, &tm_k, &tm_v, &tm_do, base, gbase, bh, k0, first, n_run);
  } else {
    // ---- consumers: warpgroup 0 takes S^T = K Q^T, P^T, dV += P^T dO;
    // warpgroup 1 dP^T = V dO^T, dS^T, dK += dS^T Q; both over all 64 rows
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    const int wtid = threadIdx.x % 128;
    const int warp = wtid / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;  // row within the warp's 8-row half
    const int tq = lane & 3;  // column pair within an 8-column group
    const int kv0 = k0 + 16 * warp + g;  // kv rows kv0 and kv0 + 8
    // the warpgroup's resident operand (K or V), the stage's tile it is
    // multiplied with (Q or dO) and the one its accumulator takes (dO or Q)
    const uint32_t a_rows = base + (cw == 0 ? S::kK : S::kV);
    const uint32_t b_tiles = base + (cw == 0 ? S::kQ : S::kDO);
    const uint32_t c_tiles = base + (cw == 0 ? S::kDO : S::kQ);
    float4* const ptile = reinterpret_cast<float4*>(gbase + S::kP);

    float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;

    if (n_run > 0) {
      float x[kBlockQ / 2];      // S^T, then P^T (warpgroup 0); dP^T (1)
      uint32_t xa[kBlockQ / 4];  // P^T or dS^T in bf16, the A operand
      // x = A B^T of tile j
      auto issue_x = [&](int j) {
        fence_regs<kBlockQ / 2>(x);
        wgmma_fence();
        issue_nt<D, kBlockQ, T, kSplitRows>(x, a_rows, b_tiles + (j % kStages) * S::kQBytes);
        wgmma_commit();
      };
      // P^T or dS^T of tile j in bf16 (P^T handed over through ptile), then
      // the accumulator's product of it issued
      auto accumulate = [&](int j) {
        const int q0 = (first + j) * kBlockQ;
        const float* rows =
            reinterpret_cast<const float*>(gbase + S::kRows + (j % kStages) * kRowStatBytes);
        if (cw == 0) {
          const bool masked = (p.causal && q0 + p.off < k0 + 63) || k0 + 64 > p.t_kv;
          dkv_probs<T>(x, xa, rows, p, q0, kv0, tq, masked);
          if (j > 0) named_sync(kPEmptyBar);  // warpgroup 1 has read P^T of tile j - 1
#pragma unroll
          for (int i = 0; i < kBlockQ / 2; i += 4) {
            ptile[(i / 4) * 128 + wtid] = make_float4(x[i], x[i + 1], x[i + 2], x[i + 3]);
          }
          named_arrive(kPFullBar);
        } else {
          named_sync(kPFullBar);
          dkv_dscores<T>(x, xa, ptile, rows, p, wtid, tq);
          if (j + 1 < n_run) named_arrive(kPEmptyBar);
        }
        fence_regs<kBlockQ / 4>(xa);
        fence_regs<D / 2>(acc);
        wgmma_fence();
        issue_nn<D, kBlockQ, T>(acc, xa, c_tiles + (j % kStages) * S::kQBytes);
        wgmma_commit();
      };
      auto release = [&](int j) {
        fence_regs<D / 2>(acc);
        fence_regs<kBlockQ / 4>(xa);
        if (lane == 0) mbar_arrive(bar_empty + 8 * (j % kStages));
      };

      mbar_wait(bar_kv, 0);
      mbar_wait(bar_full, 0);
      issue_x(0);
      wgmma_wait<0>();
      fence_regs<kBlockQ / 2>(x);
      // x of tile j + 1 is queued behind the accumulator's product of tile j
#pragma unroll 1
      for (int j = 0; j + 1 < n_run; ++j) {
        accumulate(j);
        mbar_wait(bar_full + 8 * ((j + 1) % kStages), ((j + 1) / kStages) & 1);
        issue_x(j + 1);
        wgmma_wait<1>();  // dV or dK of tile j
        release(j);
        wgmma_wait<0>();  // x of tile j + 1
        fence_regs<kBlockQ / 2>(x);
      }
      accumulate(n_run - 1);
      wgmma_wait<0>();
      release(n_run - 1);
    }

    // ---- epilogue: dV through K's buffer, dK through V's: each warpgroup
    // writes the tile that only it read, once its last products completed
    // (or which was never loaded, when no q tile sees these keys)
    const float one[2] = {1.f, 1.f};
    write_rows<D, T>(gbase + (a_rows - base), S::kKVBox, acc, one, warp, g, tq);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(kEpilogueBar + cw) : "memory");
    if (wtid == 0) {
      const CUtensorMap* out = cw == 0 ? &tm_dv : &tm_dk;
#pragma unroll
      for (int c = 0; c < S::kBoxes; ++c) {
        tma_store_3d(out, a_rows + c * S::kKVBox, c * 64, k0, bh);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// Number of kv tiles the q tile at q0 runs: the causal skip as a loop bound.
template <int BN>
__device__ __forceinline__ int dq_kv_tiles(const Params& p, int q0) {
  const int n_kv = (p.t_kv + BN - 1) / BN;
  if (!p.causal) return n_kv;
  const int last = min(q0 + kTileRows, p.t_q) - 1 + p.off;
  if (last < 0) return 0;
  return min(n_kv, last / BN + 1);
}

// dS of one [64 q x BN kv] tile from S (s) and dP (dp), in bf16 in the
// A-operand layout (dsa), from the thread's two rows' lse (log2 units) and
// delta. Element i sits at q row row0 + 8 * r, r = (i >> 1) & 1, and kv
// column k0 + 8 * (i >> 2) + 2 * tq + (i & 1). Masks (causal, past t_kv)
// only where `masked`.
template <int BN, typename T>
__device__ __forceinline__ void dq_grads(const float* s, const float* dp, uint32_t* dsa,
                                         const float* lse2, const float* dl, const Params& p,
                                         int k0, int row0, int tq, bool masked) {
#pragma unroll
  for (int i = 0; i < BN / 2; i += 2) {
    const int r = (i >> 1) & 1;
    float p0 = fast_exp2(fmaf(s[i], p.scale_log2, -lse2[r]));
    float p1 = fast_exp2(fmaf(s[i + 1], p.scale_log2, -lse2[r]));
    if (masked) {
      const int col = k0 + 8 * (i >> 2) + 2 * tq;  // columns col, col + 1
      const int row = row0 + 8 * r;
      if (col >= p.t_kv || (p.causal && row + p.off < col)) p0 = 0.f;
      if (col + 1 >= p.t_kv || (p.causal && row + p.off < col + 1)) p1 = 0.f;
    }
    dsa[i / 2] = pack2<T>(p0 * (dp[i] - dl[r]) * p.scale, p1 * (dp[i + 1] - dl[r]) * p.scale);
  }
}

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                              const __grid_constant__ CUtensorMap tm_k,
                              const __grid_constant__ CUtensorMap tm_v,
                              const __grid_constant__ CUtensorMap tm_do,
                              const __grid_constant__ CUtensorMap tm_dq, const Params p) {
  using S = DqSmem<D>;
  constexpr int BN = S::kBN;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + S::kBar;
  const uint32_t bar_k = bar_q + 8;  // + 8 * stage, likewise below
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_k_empty = bar_v + 8 * kStages;
  const uint32_t bar_v_empty = bar_k_empty + 8 * kStages;

  // under the causal mask the last q tiles see the most kv tiles: they run
  // first
  int bh, tile;
  launch_slot(p, &bh, &tile);
  const int q0 = (p.n_tiles - 1 - tile) * kTileRows;
  const int n_run = dq_kv_tiles<BN>(p, q0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_k_empty + 8 * s, kConsumerWarps);
      mbar_init(bar_v_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: one thread keeps the ring full; the paths never meet
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_run > 0) {
      mbar_arrive_expect_tx(bar_q, 2 * S::kQBytes);
#pragma unroll
      for (int c = 0; c < S::kBoxes; ++c) {
        tma_load_3d(base + S::kQ + c * S::kQBox, &tm_q, bar_q, c * 64, q0, bh);
        tma_load_3d(base + S::kDO + c * S::kQBox, &tm_do, bar_q, c * 64, q0, bh);
      }
#pragma unroll 1
      for (int j = 0; j < n_run; ++j) {
        const int stage = j % kStages;
        const int round = j / kStages;
        // a stage's K is free once both warpgroups' dQ of its last tile has
        // completed, its V once their dP has
        if (round > 0) mbar_wait_or_trap(bar_k_empty + 8 * stage, (round - 1) & 1);
        const uint32_t k_tile = base + S::kK + stage * S::kKVBytes;
        mbar_arrive_expect_tx(bar_k + 8 * stage, S::kKVBytes);
#pragma unroll
        for (int c = 0; c < S::kBoxes; ++c) {
          tma_load_3d(k_tile + c * S::kKVBox, &tm_k, bar_k + 8 * stage, c * 64, j * BN, bh);
        }
        if (round > 0) mbar_wait_or_trap(bar_v_empty + 8 * stage, (round - 1) & 1);
        const uint32_t v_tile = base + S::kV + stage * S::kKVBytes;
        mbar_arrive_expect_tx(bar_v + 8 * stage, S::kKVBytes);
#pragma unroll
        for (int c = 0; c < S::kBoxes; ++c) {
          tma_load_3d(v_tile + c * S::kKVBox, &tm_v, bar_v + 8 * stage, c * 64, j * BN, bh);
        }
      }
      // the consumers' last release of each stage: a stalled pipeline traps here
#pragma unroll 1
      for (int j = max(0, n_run - kStages); j < n_run; ++j) {
        const int stage = j % kStages;
        const int round = j / kStages;
        mbar_wait_or_trap(bar_k_empty + 8 * stage, round & 1);
        mbar_wait_or_trap(bar_v_empty + 8 * stage, round & 1);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows [q0 + 64 cw, q0 + 64 cw + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    const int wtid = threadIdx.x % 128;
    const int warp = wtid / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int tq = lane & 3;
    const int q_wg = q0 + 64 * cw;          // the warpgroup's first q row
    const int row0 = q_wg + 16 * warp + g;  // q rows row0 and row0 + 8
    const uint32_t q_rows = base + S::kQ + cw * 64 * 128;
    const uint32_t do_rows = base + S::kDO + cw * 64 * 128;
    auto k_tile = [&](int stage) { return base + S::kK + stage * S::kKVBytes; };
    auto v_tile = [&](int stage) { return base + S::kV + stage * S::kKVBytes; };
    // masks are needed where the tile crosses the diagonal of this
    // warpgroup's rows or the end of kv
    auto masked = [&](int k0) {
      return (p.causal && q_wg + p.off < k0 + BN - 1) || k0 + BN > p.t_kv;
    };

    float dq[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;

    if (n_run > 0) {
      float lse2[2], dl[2];
      row_stats(p, bh, row0, &lse2[0], &dl[0]);
      row_stats(p, bh, row0 + 8, &lse2[1], &dl[1]);
      float s[BN / 2];       // S, which gives P
      float dp[BN / 2];      // dP
      uint32_t dsa[BN / 4];  // dS in bf16, the A operand of dQ += dS K
      // dS of tile j in bf16, then dQ += dS K of it issued
      auto accumulate = [&](int j) {
        dq_grads<BN, T>(s, dp, dsa, lse2, dl, p, j * BN, row0, tq, masked(j * BN));
        fence_regs<BN / 4>(dsa);
        fence_regs<D / 2>(dq);
        wgmma_fence();
        issue_nn<D, BN, T>(dq, dsa, k_tile(j % kStages));
        wgmma_commit();
      };
      auto release_k = [&](int j) {
        fence_regs<D / 2>(dq);
        fence_regs<BN / 4>(dsa);
        if (lane == 0) mbar_arrive(bar_k_empty + 8 * (j % kStages));
      };
      // S and dP of tile j; V's stage is released once they complete
      auto issue_s_dp = [&](int j) {
        const int stage = j % kStages;
        const int phase = (j / kStages) & 1;
        mbar_wait(bar_k + 8 * stage, phase);
        mbar_wait(bar_v + 8 * stage, phase);
        fence_regs<BN / 2>(s);
        fence_regs<BN / 2>(dp);
        wgmma_fence();
        issue_nt<D, BN, T>(s, q_rows, k_tile(stage));
        issue_nt<D, BN, T>(dp, do_rows, v_tile(stage));
        wgmma_commit();
      };
      auto release_v = [&](int j) {
        fence_regs<BN / 2>(s);
        fence_regs<BN / 2>(dp);
        if (lane == 0) mbar_arrive(bar_v_empty + 8 * (j % kStages));
      };

      mbar_wait(bar_q, 0);
      issue_s_dp(0);
      wgmma_wait<0>();
      release_v(0);
      // S and dP of tile j + 1 are queued behind dQ of tile j
#pragma unroll 1
      for (int j = 0; j + 1 < n_run; ++j) {
        accumulate(j);
        issue_s_dp(j + 1);
        wgmma_wait<1>();  // dQ of tile j
        release_k(j);
        wgmma_wait<0>();  // S and dP of tile j + 1
        release_v(j + 1);
      }
      accumulate(n_run - 1);
      wgmma_wait<0>();
      release_k(n_run - 1);
    }

    // ---- epilogue: dQ through this warpgroup's rows of Q's buffer, which
    // its last S has finished reading (or which was never loaded, when the
    // q tile sees no key)
    const float one[2] = {1.f, 1.f};
    write_rows<D, T>(smem_raw + (q_rows - smem_u32(smem_raw)), S::kQBox, dq, one, warp, g,
                       tq);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(kEpilogueBar + cw) : "memory");
    if (wtid == 0) {
#pragma unroll
      for (int c = 0; c < S::kBoxes; ++c) {
        tma_store_3d(&tm_dq, q_rows + c * S::kQBox, c * 64, q_wg, bh);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int D, typename T>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout, void* dk,
               void* dv, Params p, cudaStream_t stream) {
  using S = DkvSmem<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv;
  if (make_map<T>(&tm_q, q, D, p.t_q, p.bh, kBlockQ) ||
      make_map<T>(&tm_do, dout, D, p.t_q, p.bh, kBlockQ) ||
      make_map<T>(&tm_k, k, D, p.t_kv, p.bh, S::kKVRows) ||
      make_map<T>(&tm_v, v, D, p.t_kv, p.bh, S::kKVRows) ||
      make_map<T>(&tm_dk, dk, D, p.t_kv, p.bh, 64) || make_map<T>(&tm_dv, dv, D, p.t_kv, p.bh, 64)) {
    return kTensorMapFailed;
  }
  p.n_tiles = (p.t_kv + S::kKVRows - 1) / S::kKVRows;
  p.group = l2_group(4ll * p.t_q * D, p.bh);  // Q and dO of one head, 2 bytes an element
  auto kernel = [] {
    if constexpr (D == 256) {
      return flash_bwd_dkv_wgmma_split_kernel<D, T>;
    } else {
      return flash_bwd_dkv_wgmma_kernel<D, T>;
    }
  }();
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kAlloc);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.n_tiles * p.bh, kThreads, S::kAlloc, stream>>>(tm_q, tm_k, tm_v, tm_do, tm_dk,
                                                           tm_dv, p);
  return (int)cudaGetLastError();
}

template <int D, typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, void* dq,
              Params p, cudaStream_t stream) {
  using S = DqSmem<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  if (make_map<T>(&tm_q, q, D, p.t_q, p.bh, kTileRows) ||
      make_map<T>(&tm_do, dout, D, p.t_q, p.bh, kTileRows) ||
      make_map<T>(&tm_k, k, D, p.t_kv, p.bh, S::kBN) ||
      make_map<T>(&tm_v, v, D, p.t_kv, p.bh, S::kBN) || make_map<T>(&tm_dq, dq, D, p.t_q, p.bh, 64)) {
    return kTensorMapFailed;
  }
  p.n_tiles = (p.t_q + kTileRows - 1) / kTileRows;
  p.group = l2_group(4ll * p.t_kv * D, p.bh);  // K and V of one head, 2 bytes an element
  auto kernel = flash_bwd_dq_wgmma_kernel<D, T>;
  const cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kAlloc);
  if (err != cudaSuccess) return (int)err;
  kernel<<<p.n_tiles * p.bh, kThreads, S::kAlloc, stream>>>(tm_q, tm_k, tm_v, tm_do, tm_dq, p);
  return (int)cudaGetLastError();
}

// Params of a launch, or false for what the kernels do not take.
bool make_params(Params* p, const void* lse, const void* delta, int bh, int t_q, int t_kv,
                 int d, int dtype, int causal, float scale) {
  const long long rows = t_q > t_kv ? t_q : t_kv;
  if (bh <= 0 || t_q <= 0 || t_kv <= 0 || (dtype != 0 && dtype != 2) ||
      (d != 64 && d != 128 && d != 256) ||
      (long long)bh * ((rows + kSplitRows - 1) / kSplitRows) > 0x7fffffffll) {
    return false;
  }
  p->lse = static_cast<const float*>(lse);
  p->delta = static_cast<const float*>(delta);
  p->bh = bh;
  p->t_q = t_q;
  p->t_kv = t_kv;
  p->off = t_kv - t_q;
  p->causal = causal;
  p->guard = causal && t_q > t_kv;
  p->scale = scale;
  p->scale_log2 = scale * kLog2e;
  return true;
}

}  // namespace

extern "C" int ray_tpu_flash_bwd_dkv_wgmma(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse,
                                           const void* delta, void* dk, void* dv, int bh,
                                           int t_q, int t_kv, int d, int dtype, int causal,
                                           float scale, void* stream) {
  Params p;
  if (!make_params(&p, lse, delta, bh, t_q, t_kv, d, dtype, causal, scale)) {
    return kUnsupported;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2) {
    switch (d) {
      case 64: return launch_dkv<64, __half>(q, k, v, dout, dk, dv, p, st);
      case 128: return launch_dkv<128, __half>(q, k, v, dout, dk, dv, p, st);
    }
    return launch_dkv<256, __half>(q, k, v, dout, dk, dv, p, st);
  }
  switch (d) {
    case 64: return launch_dkv<64, __nv_bfloat16>(q, k, v, dout, dk, dv, p, st);
    case 128: return launch_dkv<128, __nv_bfloat16>(q, k, v, dout, dk, dv, p, st);
  }
  return launch_dkv<256, __nv_bfloat16>(q, k, v, dout, dk, dv, p, st);
}

extern "C" int ray_tpu_flash_bwd_dq_wgmma(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse,
                                          const void* delta, void* dq, int bh, int t_q,
                                          int t_kv, int d, int dtype, int causal,
                                          float scale, void* stream) {
  Params p;
  if (!make_params(&p, lse, delta, bh, t_q, t_kv, d, dtype, causal, scale)) {
    return kUnsupported;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 2) {
    switch (d) {
      case 64: return launch_dq<64, __half>(q, k, v, dout, dq, p, st);
      case 128: return launch_dq<128, __half>(q, k, v, dout, dq, p, st);
    }
    return launch_dq<256, __half>(q, k, v, dout, dq, p, st);
  }
  switch (d) {
    case 64: return launch_dq<64, __nv_bfloat16>(q, k, v, dout, dq, p, st);
    case 128: return launch_dq<128, __nv_bfloat16>(q, k, v, dout, dq, p, st);
  }
  return launch_dq<256, __nv_bfloat16>(q, k, v, dout, dq, p, st);
}

extern "C" int ray_tpu_flash_bwd_wgmma_smem_bytes(int d, int dkv) {
  switch (d) {
    case 64: return dkv ? DkvSmem<64>::kAlloc : DqSmem<64>::kAlloc;
    case 128: return dkv ? DkvSmem<128>::kAlloc : DqSmem<128>::kAlloc;
    case 256: return dkv ? DkvSmem<256>::kAlloc : DqSmem<256>::kAlloc;
  }
  return 0;
}

extern "C" const char* ray_tpu_flash_bwd_wgmma_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype or shape";
  if (err == kTensorMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
