// Flash-attention backward for Hopper (sm_90a) at head_dim 64, bf16 or
// float16 (the kernels' T; the comments say bf16 for either): TMA loads into
// mbarrier rings, the rows' lse and delta by cp.async arriving on the same
// barriers, every product on wgmma, warp-specialised. Hand-written CUDA C++.
//
// Replaces the TPU kernels ray_tpu/ops/attention.py:_flash_bwd_dkv_kernel
// and _flash_bwd_dq_kernel (launched by _flash_attention_tpu_bwd) for bf16
// and float16 at head_dim 64, as the dispatch table in ops/attention.py
// (BWD_DESIGNS: design "d64" for both) says; the kernels they took over from,
// flash_bwd_wgmma.cu's dQ and dK/dV at head_dim 64, stay built for the
// variants script (ops/flash_bwd_variants.py --d64).
//
// dK/dV (flash_bwd_dkv_d64_kernel) recomputes P = exp(scale *
// Q K^T - lse) from the forward's row lse, dP = dO V^T and dS = P * (dP -
// delta) with delta = rowsum(dO * O) (computed by the caller), and
// accumulates dV = P^T dO and dK = scale * dS^T Q, with the conventions of
// flash_bwd_wgmma.cu (its header lists them). A row that sees no key (causal,
// t_q > t_kv) lies on masked tiles only, so the masks give it P = 0; a q row
// past t_q reads Q = dO = 0 and lse = delta = 0 and adds nothing. Each CTA
// owns its output tile: no atomics and no split reduction, so equal inputs
// give equal bits. flash_attention_bwd_plain is the same arithmetic in float32.
//
// What bounds it on an H100: the tensor-core operations, 8 * d per visible
// (q, k) pair (S^T, dP^T, dV, dK) at 989 TFLOP/s in bf16; its one ex2 a pair
// is a quarter of that time at d = 64. At head_dim 64 a product of a 64-row
// Q tile is m64n64k64, 0.5 MFLOP, so a stage of 64 rows (flash_bwd_wgmma.cu)
// pays the ring's waits, fences and arrivals for little work; and a
// producer that loads lse and delta with plain loads waits one memory
// latency a stage.
//
// dK/dV's design (one CTA of 384 threads per (128-row kv tile, batch * head)):
//   * Warpgroup 0 is the producer (setmaxnreg 24). Its thread 0 loads the
//     CTA's K and V (128 rows) once and streams Q and dO in 128-row tiles
//     into a ring of kStages stages; its warp 1's lanes copy each stage's
//     128 lse and delta values with cp.async (zeros past t_q), arriving on
//     the stage's full barrier (cp.async.mbarrier.arrive.noinc), so no
//     thread waits on a load.
//   * Warpgroups 1 and 2 are consumers (setmaxnreg 240), each owning 64 kv
//     rows: S^T = K Q^T and dP^T = V dO^T (m64n128k16, K-major), P^T and
//     dS^T in registers, rounded to bf16 in the A-operand layout, dV += P^T
//     dO and dK += dS^T Q with dO and Q read MN-major through the transpose
//     bit (8 k-steps of 16 q rows). The scale goes into dK's epilogue.
//   * S^T of tile j + 1 is queued behind dV and dK of tile j, dP^T of it once
//     those complete (all six in flight would not fit in 240 registers).
//   * The q loop starts at the first 128-row q tile that sees the CTA's
//     first key; masks only on tiles that cross the diagonal of the
//     warpgroup's rows or the ragged end.
//   * dK and dV go back through the warpgroup's rows of K's and V's buffers
//     and a TMA store that clips rows past t_kv.
//   * Launch order: heads in groups whose Q, dO, lse and delta fit in L2
//     together, kv tile 0 (the heaviest under the causal mask) first.
//
// dQ (flash_bwd_dq_d64_kernel) recomputes P and dS the same way, from each
// row's lse and delta, and accumulates dQ = scale * dS K. Its predecessor
// (flash_bwd_wgmma.cu's dQ at 64, one CTA a 128-row q tile, two stages)
// reads about 40% of the bound at gpt_125m's shapes on an H100. At d = 64
// each 128-row K/V tile (32 KB from L2) feeds only 128 q rows, so the
// stream of K and V alone runs near L2's rate (the variants script's probe
// "copies only": ~40% of this kernel's time), and the ex2 of every visible
// pair is 62% of the tensor-core time (without MUFU the kernel reads only
// 2-3% faster). Its design (one persistent CTA of 384 threads on each SM):
//   * The CTA takes (128-row q tile, head) items from the launch's own
//     counter (Params::schedule, zeroed by the launcher on the launch's
//     stream), in the order of flash_fwd_d64.cu: heads in groups whose K and
//     V fit in L2, the heaviest (last) q tiles first.
//   * Producer warp 0: lane 0 fetches the item and issues TMA loads of its Q
//     and dO (128 rows each) into one of kDqBufs buffers, every lane copies
//     the item's lse and delta beside them by cp.async arriving on the
//     buffer's barrier (copy_row_stats, which dK/dV's producer shares), and
//     lane 0 streams K and V in 128-row tiles through a ring of kDqStages
//     (4: the ring hides L2's latency; 2 read 2-11% slower) whose count runs
//     on across items.
//   * Consumer warpgroups 1 and 2 own 64 q rows each. A step issues dQ +=
//     dS K of tile j - 1 and S = Q K^T, dP = dO V^T of tile j together, then
//     forms dS of tile j; the two warpgroups run unsynchronised, so one's
//     exponentials and dS overlap the other's products. dS = P * (dP -
//     delta) in bf16; the scale goes into dQ's epilogue (in dS it read 4-7%
//     slower).
//   * Measured and not kept (ops/flash_bwd_variants.py --d64; PERF.md):
//     warpgroups taking turns to issue their products read 1.3% slower at
//     b = 16 causal (gpt_125m's train step), the same at b = 4 and 7%
//     faster only non-causal; two 64-row blocks a warpgroup against 64-row
//     K/V tiles (a tile feeding 256 q rows) read 12-46% slower; one CTA an
//     item instead of the persistent grid read twice as slow.
//   * dQ goes back through the warpgroup's rows of the item's Q buffer and a
//     TMA store that clips rows past t_q; the buffer goes back to the
//     producer once the store has read it.
// Only the producers' waits trap after kWaitLimitNs (hopper.cuh).
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_bwd_dkv_d64(q, k, v, dout, lse, delta, dk, dv,
//                                 bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dq_d64(q, k, v, dout, lse, delta, dq, schedule,
//                                bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_d64_smem_bytes(d, dkv)   (dynamic shared memory per CTA)
//   int ray_tpu_flash_bwd_d64_ctas_per_sm(d, dkv)  (CTAs resident on an SM)
// q/dout/dq are [bh, t_q, 64], k/v/dk/dv [bh, t_kv, 64], contiguous bf16
// (dtype 0) or float16 (dtype 2), 16-byte aligned; lse and delta [bh, t_q]
// float32; schedule one int32 of device memory that no other launch uses
// while this one runs. Each launches one kernel on `stream` (dQ after
// zeroing its schedule), allocates nothing, and returns cudaGetLastError()
// after the launch, kUnsupported for what it does not take, or
// kTensorMapFailed.

#include "hopper.cuh"

namespace {

constexpr int kD = 64;
constexpr int kKVRows = 128;    // kv rows a CTA owns: two consumer warpgroups of 64
constexpr int kBlockQ = 128;    // q rows per streamed tile
// ring depth: 3 read 2-4% faster than 2 at both of gpt_125m's cases and
// non-causal (ops/flash_bwd_variants.py --d64)
constexpr int kStages = 3;      // ring depth
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kConsumerWarps = 8;
constexpr int kEpilogueBar = 1;  // named barriers 1, 2: each consumer warpgroup's epilogue
// arrivals on a barrier that lse and delta land on: one thread with the TMA
// bytes, then each of a producer warp's 32 lanes when its copies have landed
constexpr int kFullArrivals = 33;
constexpr int kRowStatBytes = 2 * kBlockQ * 4;  // a stage's (or item's) lse and delta
// dQ: the kv rows of a K or V tile, the K/V ring's depth and the Q/dO
// buffers (the current item's and the next one's); an item is 128 q rows,
// 64 a consumer warpgroup
constexpr int kDqBN = 128;
constexpr int kDqStages = 4;
constexpr int kDqBufs = 2;
constexpr int kDqWGRows = 64;                // q rows of a consumer warpgroup
constexpr int kDqItemRows = 2 * kDqWGRows;   // q rows of an item
constexpr int kDqRowStatBytes = 2 * kDqItemRows * 4;  // an item's lse and delta

// dK/dV's shared memory, in bytes from a 1024-aligned base (the swizzle's
// period)
struct Smem {
  static constexpr int kKVBytes = kKVRows * 128;  // K or V (and dK, dV): one box
  static constexpr int kQBytes = kBlockQ * 128;   // a Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;                    // kStages Q tiles
  static constexpr int kDO = kQ + kStages * kQBytes;          // kStages dO tiles
  static constexpr int kRows = kDO + kStages * kQBytes;       // kStages lse, delta
  static constexpr int kBar = kRows + kStages * kRowStatBytes;  // barriers, 8 bytes
  // each: K and V full, then kStages full and kStages empty
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align
  static_assert(kAlloc <= 232448, "shared memory over the 227 KB a block may use");
};

// dQ's shared memory, in bytes from a 1024-aligned base
struct DqSmem {
  static constexpr int kQBytes = kDqItemRows * 128;  // a Q or dO tile (and dQ): one box
  static constexpr int kKVBytes = kDqBN * 128;       // a K or V tile
  static constexpr int kQ = 0;                            // kDqBufs Q tiles
  static constexpr int kDO = kQ + kDqBufs * kQBytes;      // kDqBufs dO tiles
  static constexpr int kK = kDO + kDqBufs * kQBytes;      // kDqStages K tiles
  static constexpr int kV = kK + kDqStages * kKVBytes;    // kDqStages V tiles
  static constexpr int kRows = kV + kDqStages * kKVBytes;  // kDqBufs lse, delta
  static constexpr int kBar = kRows + kDqBufs * kDqRowStatBytes;  // barriers, 8 bytes each:
  // kDqBufs each of item full and item empty, then kDqStages each of K full,
  // V full, K empty and V empty
  static constexpr int kItems = kBar + 8 * (2 * kDqBufs + 4 * kDqStages);
  static constexpr int kBytes = kItems + 4 * kDqBufs;  // each buffer's item, -1 after the last
  static constexpr int kAlloc = kBytes + 1024;
  static_assert(kAlloc <= 232448, "shared memory over the 227 KB a block may use");
};

struct Params {
  const float* lse;
  const float* delta;
  int* schedule;  // dQ: the next item to hand out, zeroed before the launch
  int bh;        // batch * heads
  int n_tiles;   // tiles per head (kv tiles for dK/dV, q tiles for dQ)
  int n_items;   // dQ: n_tiles * bh
  int group;     // heads per launch group
  int t_q;
  int t_kv;
  int off;       // t_kv - t_q
  int causal;
  int guard;     // causal && t_q > t_kv: the empty-row guard is on
  float scale;
  float scale_log2;  // scale * log2(e)
};

// The lse and delta of q rows [q0, q0 + kRows) of head bh (zeros past t_q)
// into `rows` (lse at [r], delta at [kRows + r]) by cp.async from a
// producer warp's 32 lanes, each arriving on `bar` when its copies have
// landed, so no thread waits on them.
template <int kRows>
__device__ __forceinline__ void copy_row_stats(uint32_t rows, const Params& p, int bh, int q0,
                                               int lane, uint32_t bar) {
#pragma unroll
  for (int h = 0; h < kRows / 32; ++h) {
    const int r = lane + 32 * h;
    const int row = q0 + r;
    const size_t at = (size_t)bh * p.t_q + min(row, p.t_q - 1);
    const int bytes = row < p.t_q ? 4 : 0;
    cp_async_4(rows + 4 * r, p.lse + at, bytes);
    cp_async_4(rows + 4 * (kRows + r), p.delta + at, bytes);
  }
  cp_async_arrive(bar);
}

// First 128-row q tile that the kv tile at k0 runs: earlier q tiles lie
// wholly above the causal diagonal.
__device__ __forceinline__ int first_q_tile(const Params& p, int k0) {
  if (!p.causal) return 0;
  const int r0 = k0 - p.off;  // the first q row that sees key k0
  if (r0 <= 0) return 0;
  if (r0 >= p.t_q) return (p.t_q + kBlockQ - 1) / kBlockQ;
  return r0 / kBlockQ;
}

// P^T and dS^T / scale of one [64 kv x 128 q] tile from S^T (s) and dP^T
// (dp), in bf16 in the A-operand layout (pa, dsa), four elements at a time
// so that s and dp die as they go. Element i sits at kv row kv0 + 8 * ((i
// >> 1) & 1) and q column q0 + c, c = 8 * (i >> 2) + 2 * tq + (i & 1);
// `rows` holds the tile's lse at [c] and delta at [kBlockQ + c]. Masks
// (causal, past t_kv) only where `masked`.
template <typename T>
__device__ __forceinline__ void dkv_grads(const float* s, const float* dp, uint32_t* pa,
                                          uint32_t* dsa, const float* rows, const Params& p,
                                          int q0, int kv0, int tq, bool masked) {
#pragma unroll
  for (int i = 0; i < kBlockQ / 2; i += 4) {
    const int c = 8 * (i >> 2) + 2 * tq;  // columns c, c + 1 of both rows
    const float2 lse = *reinterpret_cast<const float2*>(rows + c);
    const float2 dl = *reinterpret_cast<const float2*>(rows + kBlockQ + c);
    const float l0 = lse.x * kLog2e, l1 = lse.y * kLog2e;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // kv rows kv0 and kv0 + 8
      const int e = i + 2 * h;
      const int kv = kv0 + 8 * h;
      float p0 = fast_exp2(fmaf(s[e], p.scale_log2, -l0));
      float p1 = fast_exp2(fmaf(s[e + 1], p.scale_log2, -l1));
      if (masked) {
        const bool out = kv >= p.t_kv;
        if (out || (p.causal && q0 + c + p.off < kv)) p0 = 0.f;
        if (out || (p.causal && q0 + c + 1 + p.off < kv)) p1 = 0.f;
      }
      pa[e / 2] = pack2<T>(p0, p1);
      dsa[e / 2] = pack2<T>(p0 * (dp[e] - dl.x), p1 * (dp[e + 1] - dl.y));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_d64_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_dk,
                             const __grid_constant__ CUtensorMap tm_dv, const Params p) {
  using S = Smem;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_kv = base + S::kBar;
  const uint32_t bar_full = bar_kv + 8;  // + 8 * stage, likewise below
  const uint32_t bar_empty = bar_full + 8 * kStages;

  // the CTA's head and kv tile in launch order: heads in groups of p.group,
  // each tile index across the group's heads, tile 0 (the heaviest under
  // the causal mask) first
  const int per_group = p.group * p.n_tiles;
  const int head0 = blockIdx.x / per_group * p.group;
  const int heads = min(p.group, p.bh - head0);
  const int rank = blockIdx.x % per_group;
  const int bh = head0 + rank % heads;
  const int k0 = rank / heads * kKVRows;
  const int first = first_q_tile(p, k0);
  const int n_run = (p.t_q + kBlockQ - 1) / kBlockQ - first;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, kFullArrivals);
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: thread 0 keeps the ring of Q and dO full, warp 1's
    // lanes copy each stage's lse and delta; the paths never meet
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_run > 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * S::kKVBytes);
      tma_load_3d(base + S::kK, &tm_k, bar_kv, 0, k0, bh);
      tma_load_3d(base + S::kV, &tm_v, bar_kv, 0, k0, bh);
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
        tma_load_3d(base + S::kQ + stage * S::kQBytes, &tm_q, full, 0, q0, bh);
        tma_load_3d(base + S::kDO + stage * S::kQBytes, &tm_do, full, 0, q0, bh);
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
        copy_row_stats<kBlockQ>(base + S::kRows + stage * kRowStatBytes, p, bh,
                                (first + j) * kBlockQ, lane, bar_full + 8 * stage);
      }
      // this lane's copies have all landed before the warp exits
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
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

    float dk[kD / 2], dv[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;

    if (n_run > 0) {
      float s[kBlockQ / 2];       // S^T
      float dp[kBlockQ / 2];      // dP^T
      uint32_t pa[kBlockQ / 4];   // P^T in bf16, the A operand of dV += P^T dO
      uint32_t dsa[kBlockQ / 4];  // dS^T / scale in bf16, the A operand of dK += dS^T Q
      // P^T and dS^T of tile j in bf16, then dV and dK of it issued
      auto accumulate = [&](int j) {
        const int stage = j % kStages;
        const int q0 = (first + j) * kBlockQ;
        const bool masked =
            (p.causal && q0 + p.off < k_wg + 63) || k_wg + 64 > p.t_kv;
        dkv_grads<T>(s, dp, pa, dsa,
                  reinterpret_cast<const float*>(gbase + S::kRows + stage * kRowStatBytes), p,
                  q0, kv0, tq, masked);
        fence_regs<kBlockQ / 4>(pa);
        fence_regs<kBlockQ / 4>(dsa);
        fence_regs<kD / 2>(dv);
        fence_regs<kD / 2>(dk);
        wgmma_fence();
        issue_nn<kD, kBlockQ, T>(dv, pa, do_tile(stage));
        issue_nn<kD, kBlockQ, T>(dk, dsa, q_tile(stage));
        wgmma_commit();
      };
      auto release = [&](int j) {
        fence_regs<kD / 2>(dv);
        fence_regs<kD / 2>(dk);
        fence_regs<kBlockQ / 4>(pa);
        fence_regs<kBlockQ / 4>(dsa);
        if (lane == 0) mbar_arrive(bar_empty + 8 * (j % kStages));
      };

      mbar_wait(bar_kv, 0);
      mbar_wait(bar_full, 0);
      fence_regs<kBlockQ / 2>(s);
      fence_regs<kBlockQ / 2>(dp);
      wgmma_fence();
      issue_nt<kD, kBlockQ, T>(s, k_rows, q_tile(0));
      issue_nt<kD, kBlockQ, T>(dp, v_rows, do_tile(0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kBlockQ / 2>(s);
      fence_regs<kBlockQ / 2>(dp);

      // S^T of tile j + 1 is queued behind dV and dK of tile j, dP^T of it
      // once they have completed
#pragma unroll 1
      for (int j = 0; j + 1 < n_run; ++j) {
        const int next = (j + 1) % kStages;
        accumulate(j);
        mbar_wait(bar_full + 8 * next, ((j + 1) / kStages) & 1);
        fence_regs<kBlockQ / 2>(s);
        wgmma_fence();
        issue_nt<kD, kBlockQ, T>(s, k_rows, q_tile(next));
        wgmma_commit();
        wgmma_wait<1>();  // dV and dK of tile j
        release(j);
        fence_regs<kBlockQ / 2>(dp);
        wgmma_fence();
        issue_nt<kD, kBlockQ, T>(dp, v_rows, do_tile(next));
        wgmma_commit();
        wgmma_wait<0>();  // S^T and dP^T of tile j + 1
        fence_regs<kBlockQ / 2>(s);
        fence_regs<kBlockQ / 2>(dp);
      }
      accumulate(n_run - 1);
      wgmma_wait<0>();
      release(n_run - 1);
    }

    // ---- epilogue: dK (times the scale) and dV through this warpgroup's
    // rows of K's and V's buffers, which its last products have finished
    // reading (or which were never loaded, when no q tile sees these keys)
    const float scale[2] = {p.scale, p.scale};
    const float one[2] = {1.f, 1.f};
    write_rows<kD, T>(gbase + S::kK + cw * 64 * 128, S::kKVBytes, dk, scale, warp, g, tq);
    write_rows<kD, T>(gbase + S::kV + cw * 64 * 128, S::kKVBytes, dv, one, warp, g, tq);
    fence_async_shared();
    asm volatile("bar.sync %0, 128;\n" ::"r"(kEpilogueBar + cw) : "memory");
    if (wtid == 0) {
      tma_store_3d(&tm_dk, k_rows, 0, k_wg, bh);
      tma_store_3d(&tm_dv, v_rows, 0, k_wg, bh);
      bulk_commit();
      bulk_wait_all<true>();
    }
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

// The item's head and first q row in launch order: heads in groups of
// p.group, whose K and V fit in L2 together; within a group the q tiles run
// heaviest first (under the causal mask), each tile index across the group's
// heads.
__device__ __forceinline__ void dq_item(const Params& p, int item, int* bh, int* q0) {
  const int per_group = p.group * p.n_tiles;
  const int head0 = item / per_group * p.group;
  const int heads = min(p.group, p.bh - head0);
  const int rank = item % per_group;
  *bh = head0 + rank % heads;
  *q0 = (p.n_tiles - 1 - rank / heads) * kDqItemRows;
}

// kv tiles the item at q0 runs: the causal skip of its last row as a loop
// bound
__device__ __forceinline__ int dq_kv_tiles(const Params& p, int q0) {
  const int n_kv = (p.t_kv + kDqBN - 1) / kDqBN;
  if (!p.causal) return n_kv;
  const int last = min(q0 + kDqItemRows, p.t_q) - 1 + p.off;
  if (last < 0) return 0;
  return min(n_kv, last / kDqBN + 1);
}

// dS of one [64 q x kDqBN kv] tile from S (s) and dP (dp), in bf16 in the
// A-operand layout (dsa), from the thread's two rows' lse (log2 units) and
// delta. Element i sits at q row row0 + 8 * r, r = (i >> 1) & 1, and kv
// column k0 + 8 * (i >> 2) + 2 * tq + (i & 1). Masks (causal, past t_kv)
// only where `masked`. The scale is left to the epilogue.
template <typename T>
__device__ __forceinline__ void dq_grads(const float* s, const float* dp, uint32_t* dsa,
                                         const float* lse2, const float* dl, const Params& p,
                                         int k0, int row0, int tq, bool masked) {
#pragma unroll
  for (int i = 0; i < kDqBN / 2; i += 2) {
    const int r = (i >> 1) & 1;
    float p0 = fast_exp2(fmaf(s[i], p.scale_log2, -lse2[r]));
    float p1 = fast_exp2(fmaf(s[i + 1], p.scale_log2, -lse2[r]));
    if (masked) {
      const int col = k0 + 8 * (i >> 2) + 2 * tq;  // columns col, col + 1
      const int row = row0 + 8 * r;
      if (col >= p.t_kv || (p.causal && row + p.off < col)) p0 = 0.f;
      if (col + 1 >= p.t_kv || (p.causal && row + p.off < col + 1)) p1 = 0.f;
    }
    dsa[i / 2] = pack2<T>(p0 * (dp[i] - dl[r]), p1 * (dp[i + 1] - dl[r]));
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_d64_kernel(const __grid_constant__ CUtensorMap tm_q,
                            const __grid_constant__ CUtensorMap tm_k,
                            const __grid_constant__ CUtensorMap tm_v,
                            const __grid_constant__ CUtensorMap tm_do,
                            const __grid_constant__ CUtensorMap tm_dq, const Params p) {
  using S = DqSmem;
  constexpr int kStages = kDqStages;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_q = base + S::kBar;             // + 8 * buffer, likewise below
  const uint32_t bar_q_empty = bar_q + 8 * kDqBufs;
  const uint32_t bar_k = bar_q_empty + 8 * kDqBufs;  // + 8 * stage, likewise below
  const uint32_t bar_v = bar_k + 8 * kStages;
  const uint32_t bar_k_empty = bar_v + 8 * kStages;
  const uint32_t bar_v_empty = bar_k_empty + 8 * kStages;
  volatile int* items = reinterpret_cast<volatile int*>(gbase + S::kItems);

  if (threadIdx.x == 0) {
    for (int b = 0; b < kDqBufs; ++b) {
      mbar_init(bar_q + 8 * b, kFullArrivals);
      mbar_init(bar_q_empty + 8 * b, 2);
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
    // ---- producer: warp 0; lane 0 takes the items and issues every TMA
    // load, all lanes copy each item's lse and delta
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      int c = 0;  // K/V tiles loaded so far, over all items
      int n = 0;  // items so far
      // the CTA's next item, from the launch's counter
      auto take = [&]() {
        int item = 0;
        if (lane == 0) item = atomicAdd(p.schedule, 1);
        return __shfl_sync(0xffffffffu, item, 0);
      };
      int item = take();
#pragma unroll 1
      for (;; ++n) {
        const int b = n % kDqBufs;
        // a buffer is free once both warpgroups' dQ store of its last item
        // has read it
        if (n >= kDqBufs) mbar_wait_or_trap(bar_q_empty + 8 * b, (n / kDqBufs - 1) & 1);
        const uint32_t full = bar_q + 8 * b;
        if (item >= p.n_items) {
          if (lane == 0) {
            items[b] = -1;  // the consumers' last item was the one before
            mbar_arrive_expect_tx(full, 0);
          }
          cp_async_arrive(full);
          break;
        }
        int bh, q0;
        dq_item(p, item, &bh, &q0);
        const int n_cta = dq_kv_tiles(p, q0);
        if (lane == 0) {
          items[b] = item;
          mbar_arrive_expect_tx(full, 2 * S::kQBytes);
          tma_load_3d(base + S::kQ + b * S::kQBytes, &tm_q, full, 0, q0, bh);
          tma_load_3d(base + S::kDO + b * S::kQBytes, &tm_do, full, 0, q0, bh);
        }
        copy_row_stats<kDqItemRows>(base + S::kRows + b * kDqRowStatBytes, p, bh, q0, lane,
                                    full);
#pragma unroll 1
        for (int j = 0; j < n_cta; ++j, ++c) {
          const int stage = c % kStages;
          const int round = c / kStages;
          // a stage's V is free once both warpgroups' dP of its last tile
          // has completed, its K once their dQ has
          if (round > 0) mbar_wait_or_trap(bar_k_empty + 8 * stage, (round - 1) & 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(bar_k + 8 * stage, S::kKVBytes);
            tma_load_3d(base + S::kK + stage * S::kKVBytes, &tm_k, bar_k + 8 * stage, 0,
                        j * kDqBN, bh);
          }
          if (round > 0) mbar_wait_or_trap(bar_v_empty + 8 * stage, (round - 1) & 1);
          if (lane == 0) {
            mbar_arrive_expect_tx(bar_v + 8 * stage, S::kKVBytes);
            tma_load_3d(base + S::kV + stage * S::kKVBytes, &tm_v, bar_v + 8 * stage, 0,
                        j * kDqBN, bh);
          }
        }
        item = take();
      }
      // the consumers' last release of each stage and buffer: a stalled
      // pipeline traps here
#pragma unroll 1
      for (int cc = max(0, c - kStages); cc < c; ++cc) {
        mbar_wait_or_trap(bar_k_empty + 8 * (cc % kStages), (cc / kStages) & 1);
        mbar_wait_or_trap(bar_v_empty + 8 * (cc % kStages), (cc / kStages) & 1);
      }
#pragma unroll 1
      for (int nn = max(0, n - kDqBufs); nn < n; ++nn) {
        mbar_wait_or_trap(bar_q_empty + 8 * (nn % kDqBufs), (nn / kDqBufs) & 1);
      }
      // this lane's copies have all landed before the warp exits
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  } else {
    // ---- consumers: warpgroup cw owns q rows [q0 + kDqWGRows cw, + kDqWGRows)
    // of each item
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    const int wtid = threadIdx.x % 128;
    const int warp = wtid / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;
    const int tq = lane & 3;
    auto k_tile = [&](int stage) { return base + S::kK + stage * S::kKVBytes; };
    auto v_tile = [&](int stage) { return base + S::kV + stage * S::kKVBytes; };

    int c = 0;  // K/V tiles consumed so far, over all items
#pragma unroll 1
    for (int n = 0;; ++n) {
      const int b = n % kDqBufs;
      // the producer's store of the item happens before its arrival on the
      // buffer's barrier, which this wait acquires
      mbar_wait(bar_q + 8 * b, (n / kDqBufs) & 1);
      const int item = items[b];
      if (item < 0) break;
      int bh, q0;
      dq_item(p, item, &bh, &q0);
      const int n_cta = dq_kv_tiles(p, q0);
      const int q_wg = q0 + kDqWGRows * cw;  // the warpgroup's first row
      const int row0 = q_wg + 16 * warp + g;  // the thread's rows: row0 and row0 + 8
      // the warpgroup's rows of the item's Q and dO buffers
      const uint32_t q_rows = base + S::kQ + b * S::kQBytes + kDqWGRows * cw * 128;
      const uint32_t do_rows = base + S::kDO + b * S::kQBytes + kDqWGRows * cw * 128;
      // masks are needed where the tile crosses the diagonal of the
      // warpgroup's rows or the end of kv
      auto masked = [&](int k0) {
        return (p.causal && q_wg + p.off < k0 + kDqBN - 1) || k0 + kDqBN > p.t_kv;
      };
      // lse in log2 units and delta of the thread's rows: +inf and 0 (P = 0)
      // past t_q and where the empty-row guard drops the row
      const float* rows = reinterpret_cast<const float*>(gbase + S::kRows + b * kDqRowStatBytes);
      float lse2[2], dl[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = row0 + 8 * r;
        const float l = rows[row - q0];
        const bool dead = row >= p.t_q || (p.guard && !(l > kNegInf * 0.5f));
        lse2[r] = dead ? INFINITY : l * kLog2e;
        dl[r] = dead ? 0.f : rows[kDqItemRows + row - q0];
      }

      float dq[kD / 2];
#pragma unroll
      for (int i = 0; i < kD / 2; ++i) dq[i] = 0.f;
      if (n_cta > 0) {
        float s[kDqBN / 2];       // S, which gives P
        float dp[kDqBN / 2];      // dP
        uint32_t dsa[kDqBN / 4];  // dS in bf16, the A operand of dQ += dS K
        auto release_k = [&](int j) {
          if (lane == 0) mbar_arrive(bar_k_empty + 8 * ((c + j) % kStages));
        };
        auto release_v = [&](int j) {
          if (lane == 0) mbar_arrive(bar_v_empty + 8 * ((c + j) % kStages));
        };
        // S and dP against tile j issued, after its K and V land
        auto issue_s_dp = [&](int j) {
          const int stage = (c + j) % kStages;
          const int phase = ((c + j) / kStages) & 1;
          mbar_wait(bar_k + 8 * stage, phase);
          mbar_wait(bar_v + 8 * stage, phase);
          fence_regs<kDqBN / 2>(s);
          fence_regs<kDqBN / 2>(dp);
          wgmma_fence();
          issue_nt<kD, kDqBN, T>(s, q_rows, k_tile(stage));
          issue_nt<kD, kDqBN, T>(dp, do_rows, v_tile(stage));
          wgmma_commit();
        };
        // dS of tile j once its S and dP complete; V of tile j goes back then
        auto grads = [&](int j) {
          wgmma_wait<0>();
          fence_regs<kDqBN / 2>(s);
          fence_regs<kDqBN / 2>(dp);
          release_v(j);
          dq_grads<T>(s, dp, dsa, lse2, dl, p, j * kDqBN, row0, tq, masked(j * kDqBN));
        };
        // dQ += dS K of tile j issued
        auto issue_dq = [&](int j) {
          fence_regs<kDqBN / 4>(dsa);
          fence_regs<kD / 2>(dq);
          wgmma_fence();
          issue_nn<kD, kDqBN, T>(dq, dsa, k_tile((c + j) % kStages));
          wgmma_commit();
        };

        issue_s_dp(0);
        grads(0);
        // a step: dQ of tile j - 1 and S and dP of tile j in flight together;
        // K of tile j - 1 goes back once its dQ completes
#pragma unroll 1
        for (int j = 1; j < n_cta; ++j) {
          issue_dq(j - 1);
          issue_s_dp(j);
          wgmma_wait<1>();
          fence_regs<kD / 2>(dq);
          fence_regs<kDqBN / 4>(dsa);
          release_k(j - 1);
          grads(j);
        }
        // the last tile's dQ
        issue_dq(n_cta - 1);
        wgmma_wait<0>();
        fence_regs<kD / 2>(dq);
        fence_regs<kDqBN / 4>(dsa);
        release_k(n_cta - 1);
      }
      c += n_cta;

      // ---- epilogue: dQ (times the scale) through this warpgroup's rows of
      // the item's Q buffer, which its last S has finished reading; the
      // buffer goes back to the producer once the store has read it
      if (q_wg < p.t_q) {
        const float scale[2] = {p.scale, p.scale};
        write_rows<kD, T>(gbase + (q_rows - base), S::kQBytes, dq, scale, warp, g, tq);
        fence_async_shared();
        asm volatile("bar.sync %0, 128;\n" ::"r"(kEpilogueBar + cw) : "memory");
        if (wtid == 0) {
          tma_store_3d(&tm_dq, q_rows, 0, q_wg, bh);
          bulk_commit();
          bulk_wait_all<true>();
        }
      }
      if (wtid == 0) mbar_arrive(bar_q_empty + 8 * b);
    }
    if (wtid == 0) bulk_wait_all<false>();
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T>
int smem_attribute(bool dkv) {
  return dkv ? (int)cudaFuncSetAttribute(flash_bwd_dkv_d64_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem::kAlloc)
             : (int)cudaFuncSetAttribute(flash_bwd_dq_d64_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         DqSmem::kAlloc);
}

// CTAs of one kernel resident on an SM, or -1
int ctas_per_sm(bool dkv) {
  if (smem_attribute<__nv_bfloat16>(dkv) != 0) return -1;
  int per_sm = 0;
  const cudaError_t err =
      dkv ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, flash_bwd_dkv_d64_kernel<__nv_bfloat16>, kThreads, Smem::kAlloc)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, flash_bwd_dq_d64_kernel<__nv_bfloat16>, kThreads, DqSmem::kAlloc);
  return err == cudaSuccess ? per_sm : -1;
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dk, void* dv,
           const Params& p, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv;
  if (make_map<T>(&tm_q, q, kD, p.t_q, p.bh, kBlockQ) ||
      make_map<T>(&tm_do, dout, kD, p.t_q, p.bh, kBlockQ) ||
      make_map<T>(&tm_k, k, kD, p.t_kv, p.bh, kKVRows) ||
      make_map<T>(&tm_v, v, kD, p.t_kv, p.bh, kKVRows) ||
      make_map<T>(&tm_dk, dk, kD, p.t_kv, p.bh, 64) ||
      make_map<T>(&tm_dv, dv, kD, p.t_kv, p.bh, 64)) {
    return kTensorMapFailed;
  }
  const int err = smem_attribute<T>(true);
  if (err != 0) return err;
  flash_bwd_dkv_d64_kernel<T><<<p.n_tiles * p.bh, kThreads, Smem::kAlloc, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, p);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_dq(const void* q, const void* k, const void* v, const void* dout, void* dq,
              const Params& p, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dq;
  if (make_map<T>(&tm_q, q, kD, p.t_q, p.bh, kDqItemRows) ||
      make_map<T>(&tm_do, dout, kD, p.t_q, p.bh, kDqItemRows) ||
      make_map<T>(&tm_k, k, kD, p.t_kv, p.bh, kDqBN) ||
      make_map<T>(&tm_v, v, kD, p.t_kv, p.bh, kDqBN) ||
      make_map<T>(&tm_dq, dq, kD, p.t_q, p.bh, 64)) {
    return kTensorMapFailed;
  }
  int err = smem_attribute<T>(false);
  if (err != 0) return err;
  int dev = 0, sms = 0, per_sm = 0;
  err = (int)cudaGetDevice(&dev);
  if (err != 0) return err;
  err = (int)cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != 0) return err;
  err = (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, flash_bwd_dq_d64_kernel<T>, kThreads, DqSmem::kAlloc);
  if (err != 0) return err;
  if (per_sm < 1) return kUnsupported;
  const int grid = min(p.n_items, per_sm * sms);  // persistent: the CTAs take items
  flash_bwd_dq_d64_kernel<T><<<grid, kThreads, DqSmem::kAlloc, stream>>>(tm_q, tm_k, tm_v,
                                                                       tm_do, tm_dq, p);
  return (int)cudaGetLastError();
}

// Params of a launch (the kernel's own tiles, launch group and schedule are
// the caller's), or false for what the kernels do not take.
bool make_params(Params* p, const void* lse, const void* delta, int bh, int t_q, int t_kv,
                 int d, int dtype, int causal, float scale) {
  const long long rows = t_q > t_kv ? t_q : t_kv;
  if (bh <= 0 || t_q <= 0 || t_kv <= 0 || d != kD || (dtype != 0 && dtype != 2) ||
      (long long)bh * ((rows + kBlockQ - 1) / kBlockQ) > 0x7fffffffll) {
    return false;
  }
  *p = Params{};
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

extern "C" int ray_tpu_flash_bwd_d64_smem_bytes(int d, int dkv) {
  if (d != kD) return 0;
  return dkv ? Smem::kAlloc : DqSmem::kAlloc;
}

extern "C" int ray_tpu_flash_bwd_d64_ctas_per_sm(int d, int dkv) {
  return d == kD ? ctas_per_sm(dkv != 0) : -1;
}

extern "C" int ray_tpu_flash_bwd_dkv_d64(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dk, void* dv, int bh, int t_q, int t_kv, int d,
                                         int dtype, int causal, float scale, void* stream) {
  Params p;
  if (!make_params(&p, lse, delta, bh, t_q, t_kv, d, dtype, causal, scale)) {
    return kUnsupported;
  }
  p.n_tiles = (t_kv + kKVRows - 1) / kKVRows;
  // Q and dO of one head, 2 bytes an element, and its lse and delta
  p.group = l2_group(4ll * t_q * kD + 8ll * t_q, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 2 ? launch<__half>(q, k, v, dout, dk, dv, p, st)
                    : launch<__nv_bfloat16>(q, k, v, dout, dk, dv, p, st);
}

extern "C" int ray_tpu_flash_bwd_dq_d64(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dq, void* schedule, int bh, int t_q, int t_kv,
                                        int d, int dtype, int causal, float scale,
                                        void* stream) {
  Params p;
  if (!make_params(&p, lse, delta, bh, t_q, t_kv, d, dtype, causal, scale)) {
    return kUnsupported;
  }
  p.schedule = static_cast<int*>(schedule);
  p.n_tiles = (t_q + kDqItemRows - 1) / kDqItemRows;
  p.n_items = p.n_tiles * bh;
  p.group = l2_group(4ll * t_kv * kD, bh);  // K and V of one head, 2 bytes an element
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int err = (int)cudaMemsetAsync(schedule, 0, sizeof(int), st);
  if (err != 0) return err;
  return dtype == 2 ? launch_dq<__half>(q, k, v, dout, dq, p, st)
                    : launch_dq<__nv_bfloat16>(q, k, v, dout, dq, p, st);
}

extern "C" const char* ray_tpu_flash_bwd_d64_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype or shape";
  if (err == kTensorMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
