// Flash-attention forward for Hopper (sm_90a) at head_dim 16 and 32, bf16:
// a persistent grid over (q tile, batch*head) items, K and V through a TMA
// ring. Hand-written CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_attention_tpu) for bf16 at head_dim 16 and 32, as the
// dispatch table in ops/attention.py (FWD_DESIGNS, design "persistent")
// says; bf16 at 64, 128 and 256 runs csrc/flash_fwd_wgmma.cu and float32
// csrc/flash_fwd_f32.cu. It computes what the TPU kernel computes,
// O = softmax(scale * Q K^T) V and the row logsumexp, with the same
// conventions:
//   * NEG_INF = -1e30 is a finite mask value, not -inf;
//   * under the causal mask q rows are the suffix of the kv context:
//     q_pos = q_idx + (t_kv - t_q), and key k is visible when q_pos >= k;
//   * kv tiles wholly above the diagonal of the q tile are skipped (the
//     loop bound);
//   * in a ragged last kv tile the padded columns are masked and V is zero
//     (TMA fills rows past t_kv with zeros);
//   * a row whose processed columns are all masked gets p = 1 on each of
//     them (the online-softmax max stays at NEG_INF), at this kernel's tiles;
//   * denominator 1 where l == 0, lse = m + log(denom), natural log, float32.
// Tiles: 64 q rows by 64 kv rows (block_q = min(64, t_q), block_k =
// min(64, t_kv) in the reference's terms); flash_attention_fwd_plain at the
// same tiles is the same algorithm.
//
// What bounds it on an H100: at the working shapes (gpt_nano's 4 heads x 16
// at t=128, the tiny flagship's 8 x 32 at t=256, 65536 tokens a launch)
// device memory: q, k, v and o are each read or written once, 8 bytes a
// token and head per 4 of d, against 4 * d operations per visible (q, k)
// pair, far under the tensor cores' rate. Next comes the exponential: the
// card computes 16 ex2 a clock on each SM, and one per visible pair costs
// 40% of the memory bound at these shapes, and more than the tensor cores'
// bound at long t. Measured (ops/flash_fwd_variants.py --small-d), the
// copies alone reach 77% of the memory bound at gpt_nano's shape and the
// instruction stream of the softmax is what holds the kernel: so the design
// keeps copies in flight all the time and spends as few issue slots as it
// can on each score:
//   * Persistent CTAs, 3 on each SM: each walks the items blockIdx.x,
//     blockIdx.x + gridDim.x, ..., so a CTA's set-up is paid once and the
//     next item's loads overlap this item's math. Items go in groups of
//     heads whose K and V fit in L2 together (kL2GroupBytes, as
//     flash_fwd_wgmma.cu orders its blocks), and within a group the q tiles
//     run heaviest first under the causal mask, each tile index across the
//     group's heads. A global heaviest-first order reads a head's K and V
//     from device memory once per q tile: at the tiny flagship's shape
//     (2048 heads x 32 KB of K and V) that made the copies alone take 1.8x
//     the memory bound.
//   * A producer warp: one thread issues every TMA load, Q (64 rows, double
//     buffered across items) and K and V (64-row tiles through a ring of
//     kStages stages that runs on across items), each on a full mbarrier
//     with its byte count; the four consumer warps release a stage or a Q
//     buffer on its empty mbarrier when done with it. Rows are 32 or 64
//     bytes, so TMA swizzles them with the 32- or 64-byte pattern
//     (hopper.cuh, narrow tiles) and the fragment reads hit distinct banks.
//   * One consumer warpgroup owns the item's 64 q rows, 16 a warp. It reads
//     its Q fragments into registers (ldmatrix) as soon as Q lands and
//     releases the buffer at once. The online softmax runs in registers in
//     log2 units: scale * log2(e) is folded into one FFMA, so each score
//     costs that FFMA and one ex2.approx (no expf sequence); masks only on
//     tiles that cross the diagonal or the end of kv, one compare and one
//     select a score; and on a masked tile a warp computes only the 8-column
//     pieces up to its last visible column, in pairs (the upper triangle of
//     the diagonal tile is 3/8 of its work: 9% of the kernel at t=128).
//   * Tensor cores, two routes over the same tiles (Config<D>::kWgmma):
//     mma.sync m16n8k16 with K and V fragments from ldmatrix (.trans for V)
//     on the swizzled tiles (hopper.cuh: narrow_nt, narrow_nn_step), each
//     warp on its own, so a warp that skips pieces skips their products
//     too; or wgmma (S = Q K^T m64n64k16 with Q from registers and K from
//     shared memory; O += P V m64nDk16 with P from registers and V read
//     MN-major through the descriptor's transpose bit), where the
//     warpgroup's four warps meet at each product. The
//     m64 wgmma A operand in registers, the mma.sync A fragment and both
//     accumulators lay a warp's 16 rows out alike, so the Q fragments, the
//     softmax and the epilogue are shared. mma.sync is the faster at 32
//     and as fast at 16 (the variants script times both), so both head_dims
//     build it.
//   * O is normalised in registers and stored from them, 4 bytes a lane;
//     lse per row.
// The producer's waits trap after kWaitLimitNs, so a pipeline fault ends
// the kernel with an error instead of hanging the card; it ends by waiting
// for the consumers' last release of each stage and Q buffer.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_fwd_persistent(q, k, v, o, lse, bh, t_q, t_kv, d,
//                                    dtype, causal, scale, stream)
//   int ray_tpu_flash_fwd_persistent_tiles(d, &block_q, &block_k)
//   int ray_tpu_flash_fwd_persistent_smem_bytes(d)
//   int ray_tpu_flash_fwd_persistent_ctas_per_sm(d)
// q/o are [bh, t_q, d], k/v [bh, t_kv, d], contiguous bf16 (dtype 0), 16-byte
// aligned; lse [bh, t_q] f32; scale > 0. The kernel launches on `stream`,
// allocates nothing, and the function returns cudaGetLastError() after the
// launch, kUnsupported for what it does not take, or kTensorMapFailed.

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 64;    // q rows an item: one consumer warpgroup, 16 a warp
constexpr int kBlockN = 64;    // kv rows a tile
constexpr int kStages = 2;     // K/V ring depth (4 read no faster)
constexpr int kConsumers = 128;
constexpr int kThreads = kConsumers + 32;  // and one producer warp

// Per head_dim: the tensor-core route (kWgmma: wgmma, else mma.sync fed by
// ldmatrix; ops/flash_fwd_variants.py times both) and the CTAs an SM the
// register budget is set for (136 registers a thread at 3; at 4, 96
// registers, both routes spill at 32 and mma.sync at 16, and 2 or 4 read
// no faster)
template <int D> struct Config;
template <> struct Config<16> { static constexpr bool kWgmma = false; static constexpr int kMinBlocks = 3; };
template <> struct Config<32> { static constexpr bool kWgmma = false; static constexpr int kMinBlocks = 3; };

// shared memory, in bytes from a 1024-aligned base: two Q buffers, then
// kStages K tiles and kStages V tiles, then the barriers
template <int D>
struct Smem {
  static constexpr int kRow = 2 * D;            // bytes a row: 32 or 64
  static constexpr int kTile = kBlockN * kRow;  // a K or V tile, and a Q buffer
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kTile;
  static constexpr int kV = kK + kStages * kTile;
  // Q full and Q empty for each buffer, then K/V full and empty a stage
  static constexpr int kBar = kV + kStages * kTile;
  static constexpr int kBytes = kBar + 8 * (4 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align
  static_assert(kBlockM == kBlockN, "a Q buffer is one tile");
  static_assert(kAlloc <= 232448, "shared memory over the 227 KB a block may use");
};

struct Params {
  uint16_t* o;
  float* lse;
  int bh;        // batch * heads
  int n_q;       // q tiles a head
  int n_items;   // n_q * bh
  int group;     // heads an L2 group
  int t_q;
  int t_kv;
  int off;       // t_kv - t_q
  int bq_eff;    // min(64, t_q): the reference's block_q
  int bk_eff;    // min(64, t_kv): the reference's block_k
  int causal;
  float scale_log2;  // scale * log2(e)
};

// item -> (head, first q row): heads in groups of p.group, and within a
// group the q tiles heaviest first, each tile index across the group's heads
__device__ __forceinline__ void item_at(const Params& p, int item, int& bh, int& q0) {
  const int per_group = p.group * p.n_q;
  const int head0 = item / per_group * p.group;
  const int heads = min(p.group, p.bh - head0);
  const int rank = item % per_group;
  bh = head0 + rank % heads;
  q0 = (p.n_q - 1 - rank / heads) * kBlockM;
}

// Number of kv tiles the q tile at q0 processes: the reference's causal skip
// ((qi * bq + bq - 1 + off) < ki * bk skips tile ki) as a loop bound.
__device__ __forceinline__ int kv_tiles_to_run(const Params& p, int q0) {
  const int n_kv = (p.t_kv + kBlockN - 1) / kBlockN;
  if (!p.causal) return n_kv;
  const int last = q0 + p.bq_eff - 1 + p.off;
  if (last < 0) return 0;
  return min(n_kv, last / kBlockN + 1);
}

// S[64 x 64] (+)= A[64 x 16] B^T: A in registers (the warp's mma.sync A
// fragment, which is the m64 wgmma A layout), B a K-major [64, 16] piece of
// a tile in shared memory (transpose bit clear)
__device__ __forceinline__ void wgmma_rs_nt64(float* d, const uint32_t* a, uint64_t db,
                                              int accumulate) {
#define F8(o)                                                                  \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : F8(0), F8(8), F8(16), F8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
#undef F8
}

// The online softmax of one S tile in log2 units: updates the running max m
// and this thread's share of the row sums l, returns the factor alpha that
// rescales O, and leaves P in s. Element i of the tile sits at row row0 +
// 8 * ((i >> 1) & 1) and column k0 + 8 * (i >> 2) + 2 * tq + (i & 1), in the
// 8-column piece i >> 2. With kMasked, columns past lim[r], the last column
// row r sees (causal mask, end of kv), are masked: one compare with a
// constant and one select a score. Only the first kPieces pieces are
// computed; the rest, which hold no column this warp's rows see, get p = 0
// without an exponential (kPieces < 8 only where no row can be empty).
// Maxima and sums run in two chains a row.
template <bool kMasked, int kPieces>
__device__ __forceinline__ void softmax_tile(float* s, float* m, float* l, float* alpha,
                                             const Params& p, int k0, const int* lim,
                                             int tq) {
  constexpr int kN = 4 * kPieces;  // elements computed
  if constexpr (kMasked) {
    // column k0 + 2 tq + c is visible while c <= last[r]
    const int last[2] = {lim[0] - k0 - 2 * tq, lim[1] - k0 - 2 * tq};
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      if (8 * (i >> 2) + (i & 1) > last[(i >> 1) & 1]) s[i] = -INFINITY;
    }
  }
  float mx[4] = {-INFINITY, -INFINITY, -INFINITY, -INFINITY};  // row r: 2 r, 2 r + 1
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const int c = 2 * ((i >> 1) & 1) + ((i >> 2) & 1);
    mx[c] = fmaxf(mx[c], s[i]);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float x = fmaxf(mx[2 * r], mx[2 * r + 1]);
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
    const float m_cur = x == -INFINITY ? kNegInf : x * p.scale_log2;
    const float m_new = fmaxf(m[r], m_cur);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
  }
  float rs[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    const float pe = fast_exp2(fmaf(s[i], p.scale_log2, -m[(i >> 1) & 1]));
    s[i] = pe;
    rs[2 * ((i >> 1) & 1) + ((i >> 2) & 1)] += pe;
  }
#pragma unroll
  for (int i = kN; i < kBlockN / 2; ++i) s[i] = 0.f;
  if constexpr (kMasked && kPieces == kBlockN / 8) {
    // a row whose processed columns are all masked keeps m at NEG_INF and
    // gets p = exp(0) = 1 on each column of the reference's tile (rows that
    // see no key: rare, so off the common path)
    const bool empty[2] = {m[0] == kNegInf, m[1] == kNegInf};
    if (__any_sync(0xffffffffu, empty[0] || empty[1])) {
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) {
        const int r = (i >> 1) & 1;
        if (empty[r]) {
          const float pe = 8 * (i >> 2) + 2 * tq + (i & 1) < p.bk_eff ? 1.f : 0.f;
          s[i] = pe;
          rs[2 * r + ((i >> 2) & 1)] += pe;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + (rs[2 * r] + rs[2 * r + 1]);
}

// One kv tile of a warp's 16 rows after S is in sc (wgmma) or with S (mma.sync):
// the online softmax over the first kPieces 8-column pieces, O rescaled, and
// on the mma.sync route P V over the k-steps those pieces fill. On the wgmma
// route P V is the warpgroup's, issued after this.
template <int D, bool kMasked, int kPieces>
__device__ __forceinline__ void tile_math(float* sc, float* o, float* m, float* l,
                                          uint32_t (*qa)[4], uint32_t k_tile,
                                          uint32_t v_tile, const Params& p, int k0,
                                          const int* lim, int lane) {
  const int tq = lane & 3;
  if constexpr (!Config<D>::kWgmma) narrow_nt<D, kPieces / 2>(sc, qa, k_tile, 0, lane);
  float alpha[2];
  softmax_tile<kMasked, kPieces>(sc, m, l, alpha, p, k0, lim, tq);
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
  if constexpr (!Config<D>::kWgmma) {
    // k-step kk: P's columns 16 kk .. 16 kk + 15 in bf16 (the accumulator's
    // own order is the A fragment's) times V rows 16 kk .. 16 kk + 15
#pragma unroll
    for (int kk = 0; kk < kPieces / 2; ++kk) {
      uint32_t pa[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);
      narrow_nn_step<D>(o, pa, v_tile, kk, lane);
    }
  }
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(kThreads, Config<D>::kMinBlocks)
    flash_fwd_persistent_kernel(const __grid_constant__ CUtensorMap tm_q,
                                const __grid_constant__ CUtensorMap tm_k,
                                const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using S = Smem<D>;
  constexpr int kRow = S::kRow;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q_full = base + S::kBar;  // + 8 * buffer, likewise below
  const uint32_t bar_q_empty = bar_q_full + 16;
  const uint32_t bar_kv_full = bar_q_empty + 16;  // + 8 * stage, likewise below
  const uint32_t bar_kv_empty = bar_kv_full + 8 * kStages;

  if (threadIdx.x == 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(bar_q_full + 8 * b, 1);
      mbar_init(bar_q_empty + 8 * b, kConsumers / 32);
    }
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_kv_full + 8 * s, 1);
      mbar_init(bar_kv_empty + 8 * s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // ---- producer: one thread walks the items' loads in the consumers'
    // order; the ring's position c and the Q buffer's n run on across items
    if (threadIdx.x == kConsumers) {
      int c = 0, n = 0;
#pragma unroll 1
      for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++n) {
        int bh, q0;
        item_at(p, item, bh, q0);
        const int qb = n & 1;
        if (n >= 2) mbar_wait_or_trap(bar_q_empty + 8 * qb, ((n >> 1) - 1) & 1);
        mbar_arrive_expect_tx(bar_q_full + 8 * qb, S::kTile);
        tma_load_3d(base + S::kQ + qb * S::kTile, &tm_q, bar_q_full + 8 * qb, 0, q0, bh);
        const int n_run = kv_tiles_to_run(p, q0);
#pragma unroll 1
        for (int j = 0; j < n_run; ++j, ++c) {
          const int s = c % kStages;
          if (c >= kStages) mbar_wait_or_trap(bar_kv_empty + 8 * s, (c / kStages - 1) & 1);
          mbar_arrive_expect_tx(bar_kv_full + 8 * s, 2 * S::kTile);
          tma_load_3d(base + S::kK + s * S::kTile, &tm_k, bar_kv_full + 8 * s, 0,
                      j * kBlockN, bh);
          tma_load_3d(base + S::kV + s * S::kTile, &tm_v, bar_kv_full + 8 * s, 0,
                      j * kBlockN, bh);
        }
      }
      // the consumers' last release of each stage and buffer: a stalled
      // pipeline traps here
#pragma unroll 1
      for (int cc = max(0, c - kStages); cc < c; ++cc) {
        mbar_wait_or_trap(bar_kv_empty + 8 * (cc % kStages), (cc / kStages) & 1);
      }
#pragma unroll 1
      for (int nn = max(0, n - 2); nn < n; ++nn) {
        mbar_wait_or_trap(bar_q_empty + 8 * (nn & 1), (nn >> 1) & 1);
      }
    }
    return;
  }

  // ---- consumers: warp w owns rows 16 w .. 16 w + 15 of each item's q tile
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int tq = lane & 3;  // column pair within an 8-column piece
  int c = 0, n = 0;
#pragma unroll 1
  for (int item = blockIdx.x; item < p.n_items; item += gridDim.x, ++n) {
    int bh, q0;
    item_at(p, item, bh, q0);
    const int n_run = kv_tiles_to_run(p, q0);
    const int qb = n & 1;
    const uint32_t q_tile = base + S::kQ + qb * S::kTile;
    const int row0 = q0 + 16 * warp + g;  // rows row0 and row0 + 8
    // the last column each of the two rows sees, and any of the warp's 16
    // rows; a row can see no key only under the causal mask with t_q > t_kv
    int lim[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      lim[r] = p.causal ? min(row0 + 8 * r + p.off, p.t_kv - 1) : p.t_kv - 1;
    }
    const int warp_lim = p.causal ? min(q0 + 16 * warp + 15 + p.off, p.t_kv - 1) : p.t_kv - 1;
    const bool maybe_empty = p.causal && p.off < 0;
    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max, in log2 units
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums
    uint32_t qa[D / 16][4];           // this warp's Q fragments, k-step kk

    mbar_wait(bar_q_full + 8 * qb, (n >> 1) & 1);
    narrow_a_frags<D>(qa, q_tile, 16 * warp, lane);
    __syncwarp();
    if (lane == 0) mbar_arrive(bar_q_empty + 8 * qb);

#pragma unroll 1
    for (int j = 0; j < n_run; ++j, ++c) {
      const int s = c % kStages;
      const int k0 = j * kBlockN;
      const uint32_t k_tile = base + S::kK + s * S::kTile;
      const uint32_t v_tile = base + S::kV + s * S::kTile;
      mbar_wait(bar_kv_full + 8 * s, (c / kStages) & 1);

      float sc[kBlockN / 2];  // S, then P in float32
      if constexpr (Config<D>::kWgmma) {
        fence_regs<kBlockN / 2>(sc);
        fence_regs<4 * (D / 16)>(&qa[0][0]);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < D / 16; ++kk) {
          wgmma_rs_nt64(sc, qa[kk], narrow_desc<kRow>(k_tile + 32 * kk), kk > 0);
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<kBlockN / 2>(sc);
      }
      // masks where the tile crosses the diagonal of this warp's rows or the
      // end of kv
      const bool masked =
          (p.causal && q0 + 16 * warp + p.off < k0 + kBlockN - 1) || k0 + kBlockN > p.t_kv;
      if (masked) {
        // the tile's 8-column pieces that hold a column this warp's rows
        // see, in pairs: 2, 4, 6 or all 8 are computed
        int live = kBlockN / 8;
        if (!maybe_empty) live = warp_lim < k0 ? 0 : min(kBlockN / 8, (warp_lim - k0) / 8 + 1);
        switch ((live + 1) / 2) {
          case 0:
          case 1: tile_math<D, true, 2>(sc, o, m, l, qa, k_tile, v_tile, p, k0, lim, lane); break;
          case 2: tile_math<D, true, 4>(sc, o, m, l, qa, k_tile, v_tile, p, k0, lim, lane); break;
          case 3: tile_math<D, true, 6>(sc, o, m, l, qa, k_tile, v_tile, p, k0, lim, lane); break;
          default: tile_math<D, true, 8>(sc, o, m, l, qa, k_tile, v_tile, p, k0, lim, lane);
        }
      } else {
        tile_math<D, false, kBlockN / 8>(sc, o, m, l, qa, k_tile, v_tile, p, k0, lim, lane);
      }
      if constexpr (Config<D>::kWgmma) {
        // P in bf16 in the A-operand layout: k-step kk (kv columns 16 kk ..
        // 16 kk + 15) takes pa[4 kk .. 4 kk + 3], the accumulator's own order
        uint32_t pa[kBlockN / 4];
#pragma unroll
        for (int i = 0; i < kBlockN / 4; ++i) pa[i] = pack_bf16(sc[2 * i], sc[2 * i + 1]);
        fence_regs<D / 2>(o);
        fence_regs<kBlockN / 4>(pa);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          wgmma_rs<D>(o, pa + 4 * kk, narrow_desc<kRow>(v_tile + kk * 16 * kRow));
        }
        wgmma_commit();
        wgmma_wait<0>();
        fence_regs<D / 2>(o);
        fence_regs<kBlockN / 4>(pa);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_kv_empty + 8 * s);
    }

    // ---- epilogue: row sums, lse, O / denominator from registers
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      const float denom = l[r] == 0.f ? 1.f : l[r];
      const float inv = __fdividef(1.f, denom);
      const int row = row0 + 8 * r;
      if (row < p.t_q) {
        const size_t at = (size_t)bh * p.t_q + row;
        uint16_t* orow = p.o + at * D + 2 * tq;
#pragma unroll
        for (int nt = 0; nt < D / 8; ++nt) {
          *reinterpret_cast<uint32_t*>(orow + 8 * nt) =
              pack_bf16(o[4 * nt + 2 * r] * inv, o[4 * nt + 2 * r + 1] * inv);
        }
        if (tq == 0) {
          // NEG_INF + log(denom) is NEG_INF in float32
          p.lse[at] = m[r] == kNegInf ? kNegInf : (m[r] + __log2f(denom)) * kLn2;
        }
      }
    }
  }
}

// CTAs of the kernel resident on an SM and the card's SMs, for the current
// device (asked once a device)
template <int D>
int grid_size(int* ctas_per_sm, int* sms) {
  static int device = -1, per_sm = 0, n_sm = 0;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev != device) {
    auto kernel = flash_fwd_persistent_kernel<D>;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Smem<D>::kAlloc);
    if (err != cudaSuccess) return (int)err;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                        Smem<D>::kAlloc);
    if (err != cudaSuccess) return (int)err;
    err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return (int)err;
    device = dev;
  }
  *ctas_per_sm = per_sm;
  *sms = n_sm;
  return 0;
}

template <int D>
int launch(const void* q, const void* k, const void* v, const Params& p, cudaStream_t stream) {
  constexpr CUtensorMapSwizzle kSwizzle =
      D == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tm_q, tm_k, tm_v;
  if (make_map(&tm_q, q, D, p.t_q, p.bh, kBlockM, D, kSwizzle) ||
      make_map(&tm_k, k, D, p.t_kv, p.bh, kBlockN, D, kSwizzle) ||
      make_map(&tm_v, v, D, p.t_kv, p.bh, kBlockN, D, kSwizzle)) {
    return kTensorMapFailed;
  }
  int per_sm = 0, sms = 0;
  const int err = grid_size<D>(&per_sm, &sms);
  if (err != 0) return err;
  if (per_sm < 1) return kUnsupported;
  const int grid = min(p.n_items, per_sm * sms);
  flash_fwd_persistent_kernel<D><<<grid, kThreads, Smem<D>::kAlloc, stream>>>(tm_q, tm_k, tm_v, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ray_tpu_flash_fwd_persistent_tiles(int d, int* block_q, int* block_k) {
  if (d != 16 && d != 32) return kUnsupported;
  *block_q = kBlockM;
  *block_k = kBlockN;
  return 0;
}

extern "C" int ray_tpu_flash_fwd_persistent_smem_bytes(int d) {
  switch (d) {
    case 16: return Smem<16>::kAlloc;
    case 32: return Smem<32>::kAlloc;
  }
  return 0;
}

extern "C" int ray_tpu_flash_fwd_persistent_ctas_per_sm(int d) {
  int per_sm = 0, sms = 0;
  switch (d) {
    case 16: return grid_size<16>(&per_sm, &sms) == 0 ? per_sm : -1;
    case 32: return grid_size<32>(&per_sm, &sms) == 0 ? per_sm : -1;
  }
  return -1;
}

extern "C" int ray_tpu_flash_fwd_persistent(const void* q, const void* k, const void* v,
                                            void* o, void* lse, int bh, int t_q, int t_kv,
                                            int d, int dtype, int causal, float scale,
                                            void* stream) {
  if (bh <= 0 || t_q <= 0 || t_kv <= 0 || dtype != 0 || !(scale > 0.f) ||
      (d != 16 && d != 32) ||
      (long long)bh * ((t_q + kBlockM - 1) / kBlockM) > 0x7fffffffll) {
    return kUnsupported;
  }
  Params p;
  p.o = static_cast<uint16_t*>(o);
  p.lse = static_cast<float*>(lse);
  p.bh = bh;
  p.n_q = (t_q + kBlockM - 1) / kBlockM;
  p.n_items = p.n_q * bh;
  p.group = l2_group(4ll * t_kv * d, bh);  // K and V of one head, bf16
  p.t_q = t_q;
  p.t_kv = t_kv;
  p.off = t_kv - t_q;
  p.bq_eff = t_q < kBlockM ? t_q : kBlockM;
  p.bk_eff = t_kv < kBlockN ? t_kv : kBlockN;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return d == 16 ? launch<16>(q, k, v, p, st) : launch<32>(q, k, v, p, st);
}

extern "C" const char* ray_tpu_flash_fwd_persistent_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype, scale or shape";
  if (err == kTensorMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
