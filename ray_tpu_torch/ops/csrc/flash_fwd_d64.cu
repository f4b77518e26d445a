// Flash-attention forward for Hopper (sm_90a) at head_dim 64, bf16 or float16
// (the kernel's T; the comments say bf16 for either): a persistent grid over
// (q tile, head) items, TMA loads into an mbarrier ring that runs on across
// items, both products on wgmma, warp-specialised. Hand-written CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_attention_tpu) for bf16 and float16 at head_dim 64, as
// the dispatch table in ops/attention.py (FWD_DESIGNS, design "d64") says; the
// kernel it took over from, flash_fwd_wgmma.cu at head_dim 64, stays built
// for the variants script (ops/flash_fwd_variants.py --d64). It computes
// O = softmax(scale * Q K^T) V and the row logsumexp with the TPU kernel's
// conventions (flash_fwd_wgmma.cu's header lists them), at the table's tiles:
// 128 q rows by 128 kv rows (the reference's block_q = min(128, t_q),
// block_k = min(128, t_kv)). Each consumer warpgroup's 64 rows lie inside one
// 128-row tile of the table and run exactly that tile's kv tiles, so rows
// that see no key get what flash_attention_fwd_plain gives them at 128 x 128.
//
// What bounds it on an H100: the tensor-core operations, 4 * d per visible
// (q, k) pair at 989 TFLOP/s in bf16; the ex2 of every visible pair takes
// 92% of that time on MUFU at d = 64. By the probes of
// ops/flash_fwd_variants.py --d64 on an H100, neither MUFU (no ex2 at all:
// 3-6% faster) nor the copies alone (38-45% of the kernel's time) is what
// holds it near a third of that bound. What the persistent grid removes: at
// gpt_125m's b=16 the one-CTA-an-item kernel (flash_fwd_wgmma.cu) runs 23
// CTAs on each SM one after another, each paying its barriers' set-up, its
// Q load and first K/V load with nothing to overlap them, and its O store
// before the next CTA starts.

// Design (one persistent CTA of 384 threads on each SM):
//   * The CTA takes items one after another from the launch's own counter in
//     device memory (Params::schedule, which the launcher zeroes on the
//     launch's stream, so launches on other streams never share it), in the
//     launch order (heads in groups whose K and V fit in L2 together,
//     kL2GroupBytes; within a group the heaviest q tiles first under the
//     causal mask), so its set-up is paid once and the CTA
//     that is free first takes the next item. The producer hands each item
//     to the consumers beside its Q buffer, and -1 after the last.
//   * Warpgroup 0 is the producer (setmaxnreg 24); one thread issues every
//     TMA load. Q (128 x 64, one 128-byte swizzled box) goes into one of
//     kQBufs buffers, so the next item's Q lands while the consumers finish
//     the current one; K and V tiles go into a ring of kStages stages whose
//     count runs on across items, so the next item's first tiles land as
//     soon as the current item's last stages are released.
//   * Warpgroups 1 and 2 are consumers (setmaxnreg 240), each owning 64 q
//     rows of the item. S of tile j is issued together with P V of tile j -
//     1, so the softmax of tile j overlaps that P V, and the warpgroups take
//     turns to issue (named barriers kTurnBar + w), so one's softmax runs
//     while the other's products hold the tensor cores.
//   * The online softmax runs in registers in log2 units (scale * log2 e
//     folded into one FMA; online_softmax in hopper.cuh, the wgmma
//     kernel's). A share of the exponentials on the FMA pipe (a Cody-Waite
//     split and a polynomial) read no faster on the card; masks only on
//     tiles that cross the diagonal of the warpgroup's rows or the ragged
//     end.
//   * O is normalised in registers, written into the warpgroup's own rows of
//     the item's Q buffer and stored by TMA (rows past t_q clipped); lse per
//     row. The buffer goes back to the producer once the store has read it.
//     Waiting for that one item later (a third buffer), or storing O from
//     registers a bf16 pair at a time, read no faster (the latter 5% slower).
//   * kConsumerWGs = 3 (192-row items, 160 registers a consumer thread) is
//     the variants script's "three consumer warpgroups": at the 512-thread
//     launch's 128 registers it spilled, and S over 64-column sub-tiles,
//     which did not spill, ran slower still.
// The producer's waits trap after kWaitLimitNs (hopper.cuh), so a pipeline
// fault ends the kernel with an error instead of hanging the card; it ends by
// waiting for the consumers' last release of each stage and buffer.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_fwd_d64(q, k, v, o, lse, schedule, bh, t_q, t_kv, d,
//                             dtype, causal, scale, stream)
//   int ray_tpu_flash_fwd_d64_tiles(d, &block_q, &block_k)
//   int ray_tpu_flash_fwd_d64_smem_bytes(d)   (dynamic shared memory per CTA)
//   int ray_tpu_flash_fwd_d64_ctas_per_sm(d)  (CTAs resident on an SM)
// q/o are [bh, t_q, 64], k/v [bh, t_kv, 64], contiguous bf16 (dtype 0) or
// float16 (dtype 2), 16-byte aligned; lse [bh, t_q] f32; schedule one int32
// of device memory that no other launch uses while this one runs; scale > 0
// (the wrapper hands a non-positive scale's sign to q). The function zeroes
// the schedule and launches the kernel on `stream`, allocates nothing, and
// returns cudaGetLastError() after the launch, kUnsupported for what it does
// not take, or kTensorMapFailed.

#include "hopper.cuh"

namespace {

constexpr int kD = 64;
constexpr int kConsumerWGs = 2;                 // consumer warpgroups, 64 q rows each
constexpr int kBlockM = 64 * kConsumerWGs;      // q rows per item
constexpr int kRefBlockQ = 128;                 // the table's q tile
constexpr int kBN = 128;                        // kv rows per tile: the table's block_k
constexpr int kStages = 2;                      // K/V ring depth
// Q (and O) buffers: the current item's and the next item's (loading)
constexpr int kQBufs = 2;
constexpr int kThreads = 128 * (1 + kConsumerWGs);
constexpr int kProducerRegs = 24;
// the register file (64K) shared out: 128 x 24 + 256 x 240 = 64512 (three
// consumer warpgroups: 128 x 24 + 384 x 160)
constexpr int kConsumerRegs = kConsumerWGs == 3 ? 160 : 240;
constexpr int kConsumerWarps = 4 * kConsumerWGs;
constexpr int kEpilogueBar = 1;  // named barriers 1..kConsumerWGs: each warpgroup's epilogue
// named barriers kTurnBar + w: warpgroup w's turn to issue its products
constexpr int kTurnBar = kEpilogueBar + kConsumerWGs;
// whether the consumer warpgroups take turns to issue their products
constexpr bool kTurns = true;

// shared memory, in bytes from a 1024-aligned base (the swizzle's period)
struct Smem {
  static constexpr int kQBytes = kBlockM * 128;  // Q (and O): one 64-column box
  static constexpr int kKVBytes = kBN * 128;     // one K or V tile
  static constexpr int kQ = 0;                           // kQBufs Q tiles
  static constexpr int kK = kQ + kQBufs * kQBytes;       // kStages K tiles
  static constexpr int kV = kK + kStages * kKVBytes;     // kStages V tiles
  static constexpr int kBar = kV + kStages * kKVBytes;   // barriers, 8 bytes each:
  // kQBufs each of Q full and Q empty, then kStages each of K full, V full,
  // K empty and V empty
  static constexpr int kItems = kBar + 8 * (2 * kQBufs + 4 * kStages);
  // each buffer's item, -1 after the last
  static constexpr int kBytes = kItems + 4 * kQBufs;
  static constexpr int kAlloc = kBytes + 1024;           // room to align
  static_assert(kQBytes % 1024 == 0, "every tile starts on the swizzle's period");
  static_assert(kAlloc <= 232448, "shared memory over the 227 KB a block may use");
};

struct Params {
  float* lse;
  // the next item to hand out, zeroed before the launch: CTAs take items as
  // they free up (a static share, blockIdx.x, blockIdx.x + gridDim.x, ...,
  // left the CTAs with the light items idle at gpt_125m's b=4: 15% slower)
  int* schedule;
  int bh;        // batch * heads
  int n_q;       // q tiles (items) per head
  int n_items;   // n_q * bh
  int group;     // heads per launch group
  int t_q;
  int t_kv;
  int off;       // t_kv - t_q
  int bq_eff;    // min(128, t_q): the reference's block_q
  int bk_eff;    // min(128, t_kv): the reference's block_k
  int causal;
  float scale_log2;  // scale * log2(e)
};

// The item's head and first q row in launch order: heads go in groups of
// p.group, whose K and V fit in L2 together; within a group the q tiles run
// heaviest first (under the causal mask), each tile index across the
// group's heads, so the light tiles fill the tail.
__device__ __forceinline__ void item_at(const Params& p, int item, int* bh, int* q0) {
  const int per_group = p.group * p.n_q;
  const int head0 = item / per_group * p.group;
  const int heads = min(p.group, p.bh - head0);
  const int rank = item % per_group;
  *bh = head0 + rank % heads;
  *q0 = (p.n_q - 1 - rank / heads) * kBlockM;
}

// Number of kv tiles a warpgroup whose rows start at q_wg processes: those
// of the table's 128-row q tile that holds its rows (the reference's causal
// skip, (qi * bq + bq - 1 + off) < ki * bk skips tile ki, as a loop bound);
// 0 for a warpgroup with no rows.
__device__ __forceinline__ int wg_kv_tiles(const Params& p, int q_wg) {
  if (q_wg >= p.t_q) return 0;
  const int n_kv = (p.t_kv + kBN - 1) / kBN;
  if (!p.causal) return n_kv;
  const int last = q_wg / kRefBlockQ * kRefBlockQ + p.bq_eff - 1 + p.off;
  if (last < 0) return 0;
  return min(n_kv, last / kBN + 1);
}

// The item's kv tiles: those of its last warpgroup with rows, which runs the
// most.
__device__ __forceinline__ int item_kv_tiles(const Params& p, int q0) {
  int n = 0;
#pragma unroll
  for (int w = 0; w < kConsumerWGs; ++w) n = max(n, wg_kv_tiles(p, q0 + 64 * w));
  return n;
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_d64_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_o, const Params p) {
  using S = Smem;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + S::kBar;             // + 8 * buffer, likewise below
  const uint32_t bar_q_empty = bar_q + 8 * kQBufs;
  const uint32_t bar_k = bar_q_empty + 8 * kQBufs;   // + 8 * stage, likewise below
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_k_empty = bar_v + 8 * kStages;
  const uint32_t bar_v_empty = bar_k_empty + 8 * kStages;

  if (threadIdx.x == 0) {
    for (int b = 0; b < kQBufs; ++b) {
      mbar_init(bar_q + 8 * b, 1);
      mbar_init(bar_q_empty + 8 * b, kConsumerWGs);
    }
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
    // ---- producer: one thread keeps the buffers and the ring full; the
    // paths never meet
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0) {
      int c = 0;  // K/V tiles loaded so far, over all items
      int n = 0;  // items so far
      volatile int* items = reinterpret_cast<volatile int*>(
          smem_raw + (base - smem_u32(smem_raw)) + S::kItems);
      int item = atomicAdd(p.schedule, 1);
#pragma unroll 1
      for (;; ++n) {
        const int b = n % kQBufs;
        // a buffer is free once every warpgroup's O store of its last item
        // has read it
        if (n >= kQBufs) mbar_wait_or_trap(bar_q_empty + 8 * b, (n / kQBufs - 1) & 1);
        if (item >= p.n_items) {
          items[b] = -1;  // the consumers' last item was the one before
          mbar_arrive(bar_q + 8 * b);
          break;
        }
        items[b] = item;
        int bh, q0;
        item_at(p, item, &bh, &q0);
        const int n_cta = item_kv_tiles(p, q0);
        mbar_arrive_expect_tx(bar_q + 8 * b, S::kQBytes);
        tma_load_3d(base + S::kQ + b * S::kQBytes, &tm_q, bar_q + 8 * b, 0, q0, bh);
#pragma unroll 1
        for (int j = 0; j < n_cta; ++j, ++c) {
          const int stage = c % kStages;
          const int round = c / kStages;
          // a stage's K is free once every warpgroup's S of its last tile
          // has completed, its V once their P V has
          if (round > 0) mbar_wait_or_trap(bar_k_empty + 8 * stage, (round - 1) & 1);
          mbar_arrive_expect_tx(bar_k + 8 * stage, S::kKVBytes);
          tma_load_3d(base + S::kK + stage * S::kKVBytes, &tm_k, bar_k + 8 * stage, 0,
                      j * kBN, bh);
          if (round > 0) mbar_wait_or_trap(bar_v_empty + 8 * stage, (round - 1) & 1);
          mbar_arrive_expect_tx(bar_v + 8 * stage, S::kKVBytes);
          tma_load_3d(base + S::kV + stage * S::kKVBytes, &tm_v, bar_v + 8 * stage, 0,
                      j * kBN, bh);
        }
        item = atomicAdd(p.schedule, 1);
      }
      // the consumers' last release of each stage and buffer: a stalled
      // pipeline traps here
#pragma unroll 1
      for (int cc = max(0, c - kStages); cc < c; ++cc) {
        mbar_wait_or_trap(bar_k_empty + 8 * (cc % kStages), (cc / kStages) & 1);
        mbar_wait_or_trap(bar_v_empty + 8 * (cc % kStages), (cc / kStages) & 1);
      }
#pragma unroll 1
      for (int nn = max(0, n - kQBufs); nn < n; ++nn) {
        mbar_wait_or_trap(bar_q_empty + 8 * (nn % kQBufs), (nn / kQBufs) & 1);
      }
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows [q0 + 64 cw, q0 + 64 cw + 64)
    // of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    const int wtid = threadIdx.x % 128;
    const int warp = wtid / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;   // row within the warp's 8-row half
    const int tq = lane & 3;   // column pair within an 8-column group
    auto k_tile = [&](int stage) { return base + S::kK + stage * S::kKVBytes; };
    auto v_tile = [&](int stage) { return base + S::kV + stage * S::kKVBytes; };
    // Turns, round robin (kTurns): warpgroup cw waits for its turn (kTurnBar
    // + cw), issues, and hands the turn to the next; in each item the last
    // warpgroup gives warpgroup 0 its first turn, and its own last turn
    // hands over nothing. Each takes n_cta + 1 turns an item: n_run + 1
    // with products, then the `idle` turns of the tiles it does not run
    // (one more when it runs none).
    auto take_turn = [&]() {
      if constexpr (kTurns) named_sync(kTurnBar + cw);
    };
    auto pass_turn = [&](bool final_turn) {
      if (kTurns && (!final_turn || cw != kConsumerWGs - 1)) {
        named_arrive(kTurnBar + (cw + 1) % kConsumerWGs);
      }
    };

    int c = 0;  // K/V tiles consumed so far, over all items
    const volatile int* items = reinterpret_cast<const volatile int*>(
        smem_raw + (base - smem_u32(smem_raw)) + S::kItems);
#pragma unroll 1
    for (int n = 0;; ++n) {
      const int b = n % kQBufs;
      // the producer's store of the item happens before its arrival on the
      // buffer's barrier, which this wait acquires
      mbar_wait(bar_q + 8 * b, (n / kQBufs) & 1);
      const int item = items[b];
      if (item < 0) break;
      int bh, q0;
      item_at(p, item, &bh, &q0);
      const int n_cta = item_kv_tiles(p, q0);
      const int q_wg = q0 + 64 * cw;            // the warpgroup's first row
      const int row0 = q_wg + 16 * warp + g;    // rows row0 and row0 + 8
      const int n_run = wg_kv_tiles(p, q_wg);
      const int idle = n_cta - n_run + (n_run == 0);
      const uint32_t q_rows = base + S::kQ + b * S::kQBytes + cw * 64 * 128;
      // masks are needed where the tile crosses the diagonal of this
      // warpgroup's rows or the end of kv
      auto masked = [&](int k0) {
        return (p.causal && q_wg + p.off < k0 + kBN - 1) || k0 + kBN > p.t_kv;
      };

      float o[kD / 2];
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) o[i] = 0.f;
      float m[2] = {kNegInf, kNegInf};  // running max, in log2 units
      float l[2] = {0.f, 0.f};          // this thread's share of the row sums
      float alpha[2];
      float s[kBN / 2];                 // S, then P in float32
      uint32_t pa[kBN / 4];             // P in bf16, the A operand of P V

      if (kTurns && cw == kConsumerWGs - 1) named_arrive(kTurnBar);
      if (n_run > 0) {
        mbar_wait(bar_k + 8 * (c % kStages), (c / kStages) & 1);
        take_turn();
        fence_regs<kBN / 2>(s);
        wgmma_fence();
        issue_nt<kD, kBN, T>(s, q_rows, k_tile(c % kStages));
        wgmma_commit();
        pass_turn(false);
        wgmma_wait<0>();
        fence_regs<kBN / 2>(s);
        if (lane == 0) mbar_arrive(bar_k_empty + 8 * (c % kStages));
        online_softmax<kBN>(s, m, l, alpha, p, 0, row0, tq, masked(0));
        to_a<kBN, T>(s, pa);

#pragma unroll 1
        for (int j = 1; j < n_run; ++j) {
          const int stage = (c + j) % kStages;
          const int prev = (c + j - 1) % kStages;
          mbar_wait(bar_k + 8 * stage, ((c + j) / kStages) & 1);
          mbar_wait(bar_v + 8 * prev, ((c + j - 1) / kStages) & 1);
          take_turn();
          fence_regs<kBN / 2>(s);
          fence_regs<kD / 2>(o);
          fence_regs<kBN / 4>(pa);
          wgmma_fence();
          issue_nt<kD, kBN, T>(s, q_rows, k_tile(stage));
          wgmma_commit();
          issue_nn<kD, kBN, T>(o, pa, v_tile(prev));
          wgmma_commit();
          pass_turn(false);
          wgmma_wait<1>();  // S of tile j
          fence_regs<kBN / 2>(s);
          if (lane == 0) mbar_arrive(bar_k_empty + 8 * stage);
          online_softmax<kBN>(s, m, l, alpha, p, j * kBN, row0, tq, masked(j * kBN));
          wgmma_wait<0>();  // P V of tile j - 1
          fence_regs<kD / 2>(o);
          fence_regs<kBN / 4>(pa);
          if (lane == 0) mbar_arrive(bar_v_empty + 8 * prev);
#pragma unroll
          for (int i = 0; i < kD / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
          to_a<kBN, T>(s, pa);
        }

        const int last = (c + n_run - 1) % kStages;
        mbar_wait(bar_v + 8 * last, ((c + n_run - 1) / kStages) & 1);
        take_turn();
        fence_regs<kD / 2>(o);
        fence_regs<kBN / 4>(pa);
        wgmma_fence();
        issue_nn<kD, kBN, T>(o, pa, v_tile(last));
        wgmma_commit();
        pass_turn(idle == 0);
        wgmma_wait<0>();
        fence_regs<kD / 2>(o);
        fence_regs<kBN / 4>(pa);
        if (lane == 0) mbar_arrive(bar_v_empty + 8 * last);
      }
      // the item's turns left, one a kv tile past this warpgroup's (its rows
      // lie above their diagonal, or it has none), the tile released in it
      // as it lands, then one more if the warpgroup ran nothing
#pragma unroll 1
      for (int i = 0; i < idle; ++i) {
        const int j = n_run + i;
        take_turn();
        if (j < n_cta) {
          const int stage = (c + j) % kStages;
          const int phase = ((c + j) / kStages) & 1;
          mbar_wait(bar_k + 8 * stage, phase);
          if (lane == 0) mbar_arrive(bar_k_empty + 8 * stage);
          mbar_wait(bar_v + 8 * stage, phase);
          if (lane == 0) mbar_arrive(bar_v_empty + 8 * stage);
        }
        pass_turn(i == idle - 1);
      }
      c += n_cta;

      // ---- epilogue: row sums, lse, O / denominator through the item's Q
      // buffer, released once the store has read it
      if (q_wg < p.t_q) {
        float inv[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
          l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
          const float denom = l[r] == 0.f ? 1.f : l[r];
          inv[r] = 1.f / denom;
          const int row = row0 + 8 * r;
          if (tq == 0 && row < p.t_q) {
            p.lse[(size_t)bh * p.t_q + row] =
                m[r] == kNegInf ? kNegInf + logf(denom) : (m[r] + log2f(denom)) * kLn2;
          }
        }
        // this warpgroup's 64 rows of the buffer are free: its last S wgmma
        // has completed and no other warpgroup reads them
        write_rows<kD, T>(smem_raw + (q_rows - smem_u32(smem_raw)), S::kQBytes, o, inv,
                            warp, g, tq);
        fence_async_shared();
        asm volatile("bar.sync %0, 128;\n" ::"r"(kEpilogueBar + cw) : "memory");
        if (wtid == 0) {
          tma_store_3d(&tm_o, q_rows, 0, q_wg, bh);
          bulk_commit();
          bulk_wait_all<true>();
        }
      }
      if (wtid == 0) mbar_arrive(bar_q_empty + 8 * b);
    }
    if (wtid == 0) bulk_wait_all<false>();
  }
}

template <typename T>
int smem_attribute() {
  return (int)cudaFuncSetAttribute(flash_fwd_d64_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::kAlloc);
}

// CTAs resident on an SM and the SMs of the current device
template <typename T>
int occupancy(int* per_sm, int* sms) {
  int err = smem_attribute<T>();
  if (err != 0) return err;
  int dev = 0;
  err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  err = (int)cudaDeviceGetAttribute(sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(per_sm, flash_fwd_d64_kernel<T>,
                                                            kThreads, Smem::kAlloc);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, void* o, const Params& p,
           cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (make_map<T>(&tm_q, q, kD, p.t_q, p.bh, kBlockM) ||
      make_map<T>(&tm_k, k, kD, p.t_kv, p.bh, kBN) ||
      make_map<T>(&tm_v, v, kD, p.t_kv, p.bh, kBN) ||
      make_map<T>(&tm_o, o, kD, p.t_q, p.bh, 64)) {
    return kTensorMapFailed;
  }
  int per_sm = 0, sms = 0;
  const int err = occupancy<T>(&per_sm, &sms);
  if (err != 0) return err;
  if (per_sm < 1) return kUnsupported;
  const int grid = min(p.n_items, per_sm * sms);
  flash_fwd_d64_kernel<T><<<grid, kThreads, Smem::kAlloc, stream>>>(tm_q, tm_k, tm_v, tm_o, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ray_tpu_flash_fwd_d64_tiles(int d, int* block_q, int* block_k) {
  if (d != kD) return kUnsupported;
  *block_q = kRefBlockQ;
  *block_k = kBN;
  return 0;
}

extern "C" int ray_tpu_flash_fwd_d64_smem_bytes(int d) { return d == kD ? Smem::kAlloc : 0; }

extern "C" int ray_tpu_flash_fwd_d64_ctas_per_sm(int d) {
  int per_sm = 0, sms = 0;
  if (d != kD || occupancy<__nv_bfloat16>(&per_sm, &sms) != 0) return -1;
  return per_sm;
}

extern "C" int ray_tpu_flash_fwd_d64(const void* q, const void* k, const void* v, void* o,
                                     void* lse, void* schedule, int bh, int t_q, int t_kv,
                                     int d, int dtype, int causal, float scale, void* stream) {
  if (bh <= 0 || t_q <= 0 || t_kv <= 0 || d != kD || (dtype != 0 && dtype != 2) ||
      !(scale > 0.f) || (long long)bh * ((t_q + kBlockM - 1) / kBlockM) > 0x7fffffffll) {
    return kUnsupported;
  }
  Params p;
  p.lse = static_cast<float*>(lse);
  p.schedule = static_cast<int*>(schedule);
  p.bh = bh;
  p.n_q = (t_q + kBlockM - 1) / kBlockM;
  p.n_items = p.n_q * bh;
  p.group = l2_group(4ll * t_kv * kD, bh);  // K and V of one head, 2 bytes an element
  p.t_q = t_q;
  p.t_kv = t_kv;
  p.off = t_kv - t_q;
  p.bq_eff = t_q < kRefBlockQ ? t_q : kRefBlockQ;
  p.bk_eff = t_kv < kBN ? t_kv : kBN;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = (int)cudaMemsetAsync(schedule, 0, sizeof(int), st);
  if (err != 0) return err;
  return dtype == 2 ? launch<__half>(q, k, v, o, p, st)
                    : launch<__nv_bfloat16>(q, k, v, o, p, st);
}

extern "C" const char* ray_tpu_flash_fwd_d64_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype, scale or shape";
  if (err == kTensorMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
