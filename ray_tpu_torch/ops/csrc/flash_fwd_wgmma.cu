// Flash-attention forward for Hopper (sm_90a): TMA loads into an mbarrier
// ring, both products on wgmma, warp-specialised. Hand-written CUDA C++.
// Its inputs are bf16 or float16 (the kernel's T; the comments say bf16 for
// either).
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_attention_tpu) for bf16 and float16 at head_dim 128 and
// 256 (and at 64, where csrc/flash_fwd_d64.cu took over and this one is the
// variants script's "before"); csrc/flash_fwd_persistent.cu takes bf16 at
// head_dim 16 and 32 and csrc/flash_fwd_f32.cu float32, as the dispatch
// table in ops/attention.py (FWD_DESIGNS) says. It computes what
// the TPU kernel computes, O = softmax(scale * Q K^T) V and the row
// logsumexp, with the same conventions:
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
// Tiles: 128 q rows by kBlockN kv rows (128 at head_dim 64 and 128, 80 at
// 256); the reference's block_q = min(128, t_q), block_k = min(kBlockN,
// t_kv). flash_attention_fwd_plain at the same tiles is the same algorithm.
//
// What bounds it on an H100: the tensor-core operations, 4 * d per visible
// (q, k) pair (about half of t_q * t_kv under the causal mask), at 989
// TFLOP/s in bf16; q, k, v and o are read or written once from device
// memory, which at t = 2048 is ~1/20 of that time, as long as the K and V of
// a head are read from L2 by all its q tiles (see the launch order below).
//
// Design (one CTA of 384 threads per (128-row q tile, batch*head)):
//   * Warpgroup 0 is the producer: it gives its registers away (setmaxnreg
//     24) and one thread issues every TMA load. Q (128 x d) is loaded once;
//     K and V tiles go into a ring of kStages stages, each with a full
//     barrier for K and one for V (arrive + expected bytes) and an empty
//     barrier for each, on which the 8 consumer warps arrive when they are
//     done with it.
//   * Warpgroups 1 and 2 are consumers (setmaxnreg 240), each owning 64 q
//     rows. S = Q K^T runs on wgmma with both operands in shared memory (Q
//     and K stored [row, d] are K-major). The online softmax runs in
//     registers with exp2 (scale * log2 e folded into one FMA; masks only on
//     tiles that cross the diagonal or the ragged end; online_softmax in
//     hopper.cuh, shared with flash_fwd_d64.cu). P is rounded to the inputs'
//     type in registers, in the A-operand layout, and O += P V runs on wgmma with
//     A from registers and V read from shared memory through the
//     descriptor's transpose bit (V stored [kv, d] is MN-major), so V is
//     never transposed.
//   * Overlap: a warpgroup issues S of tile j together with P V of tile
//     j - 1, so its softmax of tile j runs while that P V is on the tensor
//     cores; and the two warpgroups take turns to issue (named barriers), so
//     one's softmax runs while the other's products do.
//   * Every tile is a row-major [rows, d] array cut into 64-column boxes of
//     128-byte rows, 128-byte swizzled by TMA; the wgmma descriptors name the
//     same swizzle. Tensor maps are 3-D [d, t, b*h], so a box never reads the
//     next head's rows.
//   * O is normalised in registers, written into the consumer's own rows of
//     Q's buffer in the same swizzled layout and stored by TMA (which clips
//     rows past t_q); lse is stored per row.
//   * Launch order: heads go in groups whose K and V fit in L2 together
//     (kL2GroupBytes), and within a group the q tiles run heaviest first
//     under the causal mask, so the light tiles fill the tail. A global
//     heaviest-first order re-reads every head's K and V from device memory
//     once per q tile, which at b=12 made the kernel bound by bytes.
// The producer's waits trap after kWaitLimitNs, so a pipeline fault ends
// the kernel with an error instead of hanging the card; it ends by waiting
// for the consumers' last release of each stage, so every stall reaches one
// of its waits. The consumers' waits have no such limit: a trap in their
// loop makes ptxas spill their accumulators.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_fwd_wgmma(q, k, v, o, lse, bh, t_q, t_kv, d, dtype,
//                               causal, scale, stream)
//   int ray_tpu_flash_fwd_wgmma_tiles(d, &block_q, &block_k)
//   int ray_tpu_flash_fwd_wgmma_smem_bytes(d)  (dynamic shared memory per CTA)
// q/o are [bh, t_q, d], k/v [bh, t_kv, d], contiguous bf16 (dtype 0) or
// float16 (dtype 2), 16-byte aligned; lse [bh, t_q] f32; scale > 0 (the
// wrapper hands a non-positive scale's sign to q: flash_attention_fwd). The kernel launches on `stream`,
// allocates nothing, and the function returns cudaGetLastError() after the
// launch, kUnsupported for what it does not take, or kTensorMapFailed.
// cuTensorMapEncodeTiled is the driver API's: the library links -lcuda.
// The barrier, TMA, descriptor and wgmma helpers, and the products issue_nt
// (S = Q K^T) and issue_nn (O += P V), are in hopper.cuh, shared with the
// backward (flash_bwd_wgmma.cu).

#include "hopper.cuh"

namespace {

constexpr int kBlockM = 128;   // q rows per CTA: two consumer warpgroups of 64
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kConsumerWarps = 8;
constexpr int kEpilogueBar = 1;  // named barriers 1, 2: each consumer warpgroup's epilogue
constexpr int kTurnBar = 3;      // named barriers 3, 4: each consumer warpgroup's turn to issue

// kv rows per tile and K/V ring depth for each head_dim: at 256 the O
// accumulator (128 floats a thread) leaves room for an S tile of 80 columns,
// and two stages of K and V fit beside Q in 227 KB
template <int D> struct Config;
template <> struct Config<64> { static constexpr int kBN = 128, kStages = 2; };
template <> struct Config<128> { static constexpr int kBN = 128, kStages = 2; };
template <> struct Config<256> { static constexpr int kBN = 80, kStages = 2; };

// shared memory, in bytes from a 1024-aligned base (the swizzle's period)
template <int D>
struct Smem {
  static constexpr int kBN = Config<D>::kBN;
  static constexpr int kStages = Config<D>::kStages;
  static constexpr int kBoxes = D / 64;         // 64-column boxes per row
  static constexpr int kQBox = kBlockM * 128;   // one box of Q (and of O)
  static constexpr int kKVBox = kBN * 128;      // one box of a K or V tile
  static constexpr int kQBytes = kBoxes * kQBox;
  static constexpr int kKVBytes = kBoxes * kKVBox;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kQBytes;                // kStages K tiles
  static constexpr int kV = kK + kStages * kKVBytes;     // kStages V tiles
  static constexpr int kBar = kV + kStages * kKVBytes;   // barriers, 8 bytes each:
  // Q full, then kStages each of K full, V full, K empty and V empty
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages);
  static constexpr int kAlloc = kBytes + 1024;           // room to align
  static_assert(kAlloc <= 232448, "shared memory over the 227 KB a block may use");
};

struct Params {
  float* lse;
  int bh;        // batch * heads
  int n_q;       // q tiles per head
  int group;     // heads per launch group
  int t_q;
  int t_kv;
  int off;       // t_kv - t_q
  int bq_eff;    // min(128, t_q): the reference's block_q
  int bk_eff;    // min(kBlockN, t_kv): the reference's block_k
  int causal;
  float scale_log2;  // scale * log2(e)
};

// Number of kv tiles the q tile at q0 processes: the reference's causal skip
// ((qi * bq + bq - 1 + off) < ki * bk skips tile ki) as a loop bound.
template <int BN>
__device__ __forceinline__ int kv_tiles_to_run(const Params& p, int q0) {
  const int n_kv = (p.t_kv + BN - 1) / BN;
  if (!p.causal) return n_kv;
  const int last = q0 + p.bq_eff - 1 + p.off;
  if (last < 0) return 0;
  return min(n_kv, last / BN + 1);
}

// ---------------------------------------------------------------------------
// the kernel
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tm_q,
                           const __grid_constant__ CUtensorMap tm_k,
                           const __grid_constant__ CUtensorMap tm_v,
                           const __grid_constant__ CUtensorMap tm_o, const Params p) {
  using S = Smem<D>;
  constexpr int BN = S::kBN;
  constexpr int kStages = S::kStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t bar_q = base + S::kBar;
  const uint32_t bar_k = bar_q + 8;                  // + 8 * stage, likewise below
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_k_empty = bar_v + 8 * kStages;
  const uint32_t bar_v_empty = bar_k_empty + 8 * kStages;

  // Blocks start in the order of blockIdx.x. Heads go in groups of
  // p.group, whose K and V fit in L2 together; within a group the q tiles
  // run heaviest first (under the causal mask), each tile index across the
  // group's heads, so the light tiles fill the tail.
  const int per_group = p.group * p.n_q;
  const int head0 = blockIdx.x / per_group * p.group;
  const int heads = min(p.group, p.bh - head0);
  const int rank = blockIdx.x % per_group;
  const int bh = head0 + rank % heads;
  const int q0 = (p.n_q - 1 - rank / heads) * kBlockM;
  const int n_run = kv_tiles_to_run<BN>(p, q0);

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
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(bar_q, S::kQBytes);
#pragma unroll
      for (int c = 0; c < S::kBoxes; ++c) {
        tma_load_3d(base + S::kQ + c * S::kQBox, &tm_q, bar_q, c * 64, q0, bh);
      }
#pragma unroll 1
      for (int j = 0; j < n_run; ++j) {
        const int stage = j % kStages;
        const int round = j / kStages;
        // a stage's K is free once both warpgroups' S of its last tile has
        // completed, its V once their P V has
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
    const int g = lane >> 2;   // row within the warp's 8-row half
    const int tq = lane & 3;   // column pair within an 8-column group
    const int q_wg = q0 + 64 * cw;            // the warpgroup's first row
    const int row0 = q_wg + 16 * warp + g;    // rows row0 and row0 + 8
    // accumulator element i of an m64nN tile: row 16 * warp + g + 8 * ((i >> 1) & 1),
    // column 8 * (i >> 2) + 2 * tq + (i & 1)
    const uint32_t q_rows = base + S::kQ + cw * 64 * 128;
    auto k_tile = [&](int stage) { return base + S::kK + stage * S::kKVBytes; };
    auto v_tile = [&](int stage) { return base + S::kV + stage * S::kKVBytes; };
    // masks are needed where the tile crosses the diagonal of this
    // warpgroup's rows or the end of kv
    auto masked = [&](int k0) {
      return (p.causal && q_wg + p.off < k0 + BN - 1) || k0 + BN > p.t_kv;
    };

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m[2] = {kNegInf, kNegInf};  // running max, in log2 units
    float l[2] = {0.f, 0.f};          // this thread's share of the row sums
    float alpha[2];
    float s[BN / 2];                  // S, then P in float32
    uint32_t pa[BN / 4];              // P in bf16, the A operand of P V

    mbar_wait(bar_q, 0);
    if (n_run > 0) {
      // The two warpgroups take turns to issue their products (named
      // barriers kTurnBar + cw): one's softmax runs while the other's
      // wgmmas use the tensor cores. Each waits for its turn before it
      // issues and hands the turn over after; warpgroup 0 goes first.
      // Within a warpgroup, S of tile j is issued together with P V of
      // tile j - 1, so the softmax of tile j overlaps that P V.
      const int my_turn = kTurnBar + cw;
      const int their_turn = kTurnBar + 1 - cw;
      if (cw == 1) named_arrive(kTurnBar);

      mbar_wait(bar_k, 0);
      named_sync(my_turn);
      fence_regs<BN / 2>(s);
      wgmma_fence();
      issue_nt<D, BN, T>(s, q_rows, k_tile(0));
      wgmma_commit();
      named_arrive(their_turn);
      wgmma_wait<0>();
      fence_regs<BN / 2>(s);
      if (lane == 0) mbar_arrive(bar_k_empty);
      online_softmax<BN>(s, m, l, alpha, p, 0, row0, tq, masked(0));
      to_a<BN, T>(s, pa);

#pragma unroll 1
      for (int j = 1; j < n_run; ++j) {
        const int stage = j % kStages;
        const int prev = (j - 1) % kStages;
        mbar_wait(bar_k + 8 * stage, (j / kStages) & 1);
        mbar_wait(bar_v + 8 * prev, ((j - 1) / kStages) & 1);
        named_sync(my_turn);
        fence_regs<BN / 2>(s);
        fence_regs<D / 2>(o);
        fence_regs<BN / 4>(pa);
        wgmma_fence();
        issue_nt<D, BN, T>(s, q_rows, k_tile(stage));
        wgmma_commit();
        issue_nn<D, BN, T>(o, pa, v_tile(prev));
        wgmma_commit();
        named_arrive(their_turn);
        wgmma_wait<1>();  // S of tile j
        fence_regs<BN / 2>(s);
        if (lane == 0) mbar_arrive(bar_k_empty + 8 * stage);
        online_softmax<BN>(s, m, l, alpha, p, j * BN, row0, tq, masked(j * BN));
        wgmma_wait<0>();  // P V of tile j - 1
        fence_regs<D / 2>(o);
        fence_regs<BN / 4>(pa);
        if (lane == 0) mbar_arrive(bar_v_empty + 8 * prev);
#pragma unroll
        for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
        to_a<BN, T>(s, pa);
      }

      const int last = (n_run - 1) % kStages;
      mbar_wait(bar_v + 8 * last, ((n_run - 1) / kStages) & 1);
      named_sync(my_turn);
      fence_regs<D / 2>(o);
      fence_regs<BN / 4>(pa);
      wgmma_fence();
      issue_nn<D, BN, T>(o, pa, v_tile(last));
      wgmma_commit();
      if (cw == 0) named_arrive(their_turn);  // warpgroup 1's last turn
      wgmma_wait<0>();
      fence_regs<D / 2>(o);
      fence_regs<BN / 4>(pa);
      if (lane == 0) mbar_arrive(bar_v_empty + 8 * last);
    }

    // ---- epilogue: row sums, lse, O / denominator through shared memory
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
    // this warpgroup's 64 rows of Q's buffer are free: its last S wgmma has
    // completed and no other warpgroup reads them
    write_rows<D, T>(smem_raw + (q_rows - smem_u32(smem_raw)), S::kQBox, o, inv, warp, g,
                       tq);
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    asm volatile("bar.sync %0, 128;\n" ::"r"(kEpilogueBar + cw) : "memory");
    if (wtid == 0) {
#pragma unroll
      for (int c = 0; c < S::kBoxes; ++c) {
        tma_store_3d(&tm_o, q_rows + c * S::kQBox, c * 64, q_wg, bh);
      }
      asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
      asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
    }
  }
}

template <int D, typename T>
int launch(const void* q, const void* k, const void* v, void* o, const Params& p,
           int bh, cudaStream_t stream) {
  using S = Smem<D>;
  CUtensorMap tm_q, tm_k, tm_v, tm_o;
  if (make_map<T>(&tm_q, q, D, p.t_q, bh, kBlockM) ||
      make_map<T>(&tm_k, k, D, p.t_kv, bh, S::kBN) ||
      make_map<T>(&tm_v, v, D, p.t_kv, bh, S::kBN) || make_map<T>(&tm_o, o, D, p.t_q, bh, 64)) {
    return kTensorMapFailed;
  }
  auto kernel = flash_fwd_wgmma_kernel<D, T>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kAlloc);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.n_q * bh);
  kernel<<<grid, kThreads, S::kAlloc, stream>>>(tm_q, tm_k, tm_v, tm_o, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ray_tpu_flash_fwd_wgmma_tiles(int d, int* block_q, int* block_k) {
  switch (d) {
    case 64: *block_k = Config<64>::kBN; break;
    case 128: *block_k = Config<128>::kBN; break;
    case 256: *block_k = Config<256>::kBN; break;
    default: return kUnsupported;
  }
  *block_q = kBlockM;
  return 0;
}

extern "C" int ray_tpu_flash_fwd_wgmma_smem_bytes(int d) {
  switch (d) {
    case 64: return Smem<64>::kAlloc;
    case 128: return Smem<128>::kAlloc;
    case 256: return Smem<256>::kAlloc;
  }
  return 0;
}

extern "C" int ray_tpu_flash_fwd_wgmma(const void* q, const void* k, const void* v,
                                       void* o, void* lse, int bh, int t_q, int t_kv,
                                       int d, int dtype, int causal, float scale,
                                       void* stream) {
  if (bh <= 0 || t_q <= 0 || t_kv <= 0 || (dtype != 0 && dtype != 2) || !(scale > 0.f) ||
      (long long)bh * ((t_q + kBlockM - 1) / kBlockM) > 0x7fffffffll) {
    return kUnsupported;
  }
  int block_q = 0, block_k = 0;
  if (ray_tpu_flash_fwd_wgmma_tiles(d, &block_q, &block_k) != 0) return kUnsupported;
  Params p;
  p.lse = static_cast<float*>(lse);
  p.bh = bh;
  p.n_q = (t_q + block_q - 1) / block_q;
  p.group = l2_group(4ll * t_kv * d, bh);  // K and V of one head, 2 bytes an element
  p.t_q = t_q;
  p.t_kv = t_kv;
  p.off = t_kv - t_q;
  p.bq_eff = t_q < block_q ? t_q : block_q;
  p.bk_eff = t_kv < block_k ? t_kv : block_k;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool half = dtype == 2;
  switch (d) {
    case 64:
      return half ? launch<64, __half>(q, k, v, o, p, bh, st)
                  : launch<64, __nv_bfloat16>(q, k, v, o, p, bh, st);
    case 128:
      return half ? launch<128, __half>(q, k, v, o, p, bh, st)
                  : launch<128, __nv_bfloat16>(q, k, v, o, p, bh, st);
    case 256:
      return half ? launch<256, __half>(q, k, v, o, p, bh, st)
                  : launch<256, __nv_bfloat16>(q, k, v, o, p, bh, st);
  }
  return kUnsupported;
}

extern "C" const char* ray_tpu_flash_fwd_wgmma_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype, scale or shape";
  if (err == kTensorMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
