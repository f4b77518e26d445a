// Flash-attention backward for Hopper (sm_90a) at every head_dim that is a
// multiple of 128, d a runtime argument, in bf16, float16 and float32 (the
// kernels' T): design "dsplit", the output's columns split over CTAs.
// Hand-written CUDA C++.
//
// Replaces the two TPU kernels of ray_tpu/ops/attention.py launched by
// _flash_attention_tpu_bwd, at head_dim 896 and up (BWD_DESIGNS in
// ops/attention.py, by its rule DSPLIT_MIN_D):
//   * _flash_bwd_dq_kernel  -> flash_bwd_dq_dsplit_kernel  (dQ);
//   * _flash_bwd_dkv_kernel -> flash_bwd_dkv_dsplit_kernel (dK and dV).
// Both recompute P = exp(scale * Q K^T - lse) from the forward's row lse,
// dP = dO V^T and dS = P * (dP - delta) with delta = rowsum(dO * O) from the
// caller (flash_bwd_delta in ops/attention.py, as the reference computes it
// outside its kernels), and accumulate dQ = scale * dS K, dK = scale * dS^T Q
// and dV = P^T dO, the scale in the epilogues. The conventions are the
// reference's (flash_bwd_wgmma.cu's header lists them): a masked score gives
// P = 0; q rows are the suffix of the kv context under the causal mask;
// tiles wholly above the diagonal are skipped; where causal and t_q > t_kv a
// row whose lse is at most NEG_INF / 2 gets P = 0; padded rows of a ragged
// tile are zero-filled and add nothing. flash_attention_bwd_plain is the
// same arithmetic in float32.
//
// What bounds them on an H100: the operations, 6 * d per visible (q, k)
// pair for dQ (S, dP, dQ) and 8 * d for dK/dV (S^T, dP^T, dV, dK), at 989
// TFLOP/s in bf16 and float16 and 164.9 in float32 (3xTF32), with q, k, v,
// dO, lse, delta and the gradients read or written once. This design does
// more than that work: every one of the G = ceil(d / 256) column groups
// recomputes S and dP over all of d, so a visible pair costs (4 G + 2) d
// operations in dQ instead of 6 d and (4 G + 4) d in dK/dV instead of 8 d:
// at d = 1024 (G = 4) 3 and 2.5 times the function's own work, at 2048
// (G = 8) 5.67 and 4.5 times. Q, dO, K and V chunks are read again for
// every tile pair (from L2). Both run on mma.sync. A first design that is
// right; PERF.md has their times beside the bound.
//
// The reckoning that sets the tiles (rows padded to kChunkRow<T> = 272
// bytes for a chunk, kGroupRow<T> = 528 or 1040 for a column group):
//   * dQ: 64 resident q rows, a warp a 16 rows owning dQ's 256 group
//     columns (128 registers a thread) beside S and dP of a 32-row kv tile
//     (16 each); per kv tile the chunks of Q, dO, K and V (52224 bytes an
//     item) and then K's group columns (16896 or 33280) through a ring of
//     two stages: 104448 bytes, two CTAs an SM;
//   * dK/dV: 32 resident kv rows, two warps a side: the P side computes
//     S^T = K Q^T over the chunks and dV += P^T dO, the dS side dP^T = V
//     dO^T and dK += dS^T Q, each owning one output's 256 group columns
//     (128 registers); S^T goes over to the dS side through shared memory
//     (a [16 x 32] float32 tile a warp), so both sides hold the same P^T.
//     Streamed q tiles of 32 rows in bf16 and float16, 16 in float32 (a
//     float32 row of a group is 1040 bytes): per q tile the chunks of K, V,
//     Q and dO (34816 or 26112 bytes) and then Q's and dO's group columns
//     with the rows' lse and delta (34048 or 33408) through three stages:
//     108544 or 102272 bytes with the hand-over, two CTAs an SM.
//
// Design, both kernels: one CTA per (resident tile, column group, batch *
// head), heads in L2 groups, the G groups of a tile together. The loop over
// the streamed tiles takes the place of the TPU grid's sequential innermost
// axis and skips the tiles wholly above the causal diagonal. Each CTA owns
// its output elements: no atomics and no split reduction, so equal inputs
// give equal bits.
//   * dQ: heaviest q tiles (the last, under the causal mask) first; per kv
//     tile S and dP over the chunks, P and dS in registers, dQ_g += dS K_g.
//   * dK/dV: kv tile 0 (the heaviest) first; the q loop starts at the first
//     q tile that sees the CTA's first key.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_bwd_dq_dsplit(q, k, v, dout, lse, delta, dq,
//                                   bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dkv_dsplit(q, k, v, dout, lse, delta, dk, dv,
//                                    bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dsplit_smem_bytes(dtype, dkv)   (dynamic shared memory per CTA)
//   int ray_tpu_flash_bwd_dsplit_ctas_per_sm(dtype, dkv)  (CTAs resident on an SM)
// q/dout/dq are [bh, t_q, d], k/v/dk/dv [bh, t_kv, d], contiguous bf16
// (dtype 0), float32 (1) or float16 (2), d a positive multiple of 128,
// 16-byte aligned; lse and delta [bh, t_q] float32. The grid is (heads of a
// launch) x resident tiles x column groups on grid.x, at most 2^31 - 1:
// each launches as many times as that takes, on `stream`, allocates
// nothing, and returns cudaGetLastError() after each launch, or
// kUnsupported for what it does not take.

#include "dsplit.cuh"

namespace {

// dQ: kBlockQ resident q rows (a warp a 16), kBlockK streamed kv rows
template <typename T>
struct Dq {
  static constexpr int kBlockQ = 64;
  static constexpr int kBlockK = 32;
  static constexpr int kThreads = kBlockQ / 16 * 32;
  static constexpr int kStages = 2;
  static constexpr int kA = kChunkRow<T>;
  static constexpr int kG = kGroupRow<T>;
  static constexpr int kDO = kBlockQ * kA;       // Q's chunk first, then dO's,
  static constexpr int kK = 2 * kBlockQ * kA;    // K's
  static constexpr int kV = kK + kBlockK * kA;   // and V's
  static constexpr int kChunkItem = kV + kBlockK * kA;
  static constexpr int kSlot = kChunkItem > kBlockK * kG ? kChunkItem : kBlockK * kG;
  static constexpr int kBytes = kStages * kSlot;
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block may use");
};

// dK/dV: kBlockK resident kv rows (two warps a side), kBlockQ streamed q rows
template <typename T>
struct Dkv {
  static constexpr int kBlockK = 32;
  static constexpr int kBlockQ = kF32<T> ? 16 : 32;
  static constexpr int kThreads = 2 * kBlockK / 16 * 32;
  static constexpr int kStages = 3;
  static constexpr int kA = kChunkRow<T>;
  static constexpr int kG = kGroupRow<T>;
  static constexpr int kV = kBlockK * kA;       // K's chunk first, then V's,
  static constexpr int kQ = 2 * kBlockK * kA;   // Q's
  static constexpr int kDO = kQ + kBlockQ * kA;  // and dO's
  static constexpr int kChunkItem = kDO + kBlockQ * kA;
  static constexpr int kDOg = kBlockQ * kG;     // Q's group columns first, then dO's,
  static constexpr int kStats = 2 * kBlockQ * kG;  // the rows' lse and delta
  static constexpr int kGroupItem = kStats + 2 * kBlockQ * 4;
  static constexpr int kSlot = kChunkItem > kGroupItem ? kChunkItem : kGroupItem;
  static constexpr int kHand = kStages * kSlot;  // S^T, a [16 x kBlockQ] tile a P-side warp
  static constexpr int kBytes = kHand + 2 * 16 * kBlockQ * 4;
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block may use");
};

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
  int n_tiles;  // the CTA's own tiles per head (q for dQ, kv for dK/dV)
  int groups;   // column groups per row
  int l2;       // heads per L2 group
  int t_q;
  int t_kv;
  int d;
  int off;      // t_kv - t_q
  int causal;
  int guard;    // causal && t_q > t_kv: the empty-row guard is on
  float scale;
  float scale_log2;  // scale * log2(e)
};

// True where the empty-row guard drops a row (its lse is the sentinel).
__device__ __forceinline__ bool sees_no_key(const Params& p, float lse) {
  return p.guard && !(lse > kNegInf * 0.5f);
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(Dq<T>::kThreads, 1) flash_bwd_dq_dsplit_kernel(const Params p) {
  using L = Dq<T>;
  constexpr int kBlockQ = L::kBlockQ, kBlockK = L::kBlockK, kThreads = L::kThreads;
  constexpr int kStages = L::kStages, kA = L::kA, kC = kChunkCols<T>;
  constexpr int kCBytes = kC * (int)sizeof(T);
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  int bh, item;
  wide_slot(p.bh, p.n_tiles * p.groups, p.l2, &bh, &item);
  const int tile = item / p.groups;
  const int cg = item % p.groups;
  const int q0 = (p.n_tiles - 1 - tile) * kBlockQ;  // the heaviest q tiles first
  const int row0 = q0 + 16 * warp;  // the warp's rows: row0 + g, row0 + g + 8
  const int c0 = cg * kGroupCols;
  const int ncols = min(kGroupCols, p.d - c0);
  const size_t ld = (size_t)p.d * sizeof(T);
  const char* q = static_cast<const char*>(p.q) + (size_t)bh * p.t_q * ld;
  const char* dout = static_cast<const char*>(p.dout) + (size_t)bh * p.t_q * ld;
  const char* k = static_cast<const char*>(p.k) + (size_t)bh * p.t_kv * ld;
  const char* v = static_cast<const char*>(p.v) + (size_t)bh * p.t_kv * ld;

  // kv tiles the q tile runs: the causal skip as a loop bound
  const int n_kv = (p.t_kv + kBlockK - 1) / kBlockK;
  const int last = min(q0 + kBlockQ, p.t_q) - 1 + p.off;
  const int n_run = !p.causal ? n_kv : (last < 0 ? 0 : min(n_kv, last / kBlockK + 1));
  const int nc = p.d / kC;
  const int n_items = n_run * (nc + 1);  // per kv tile: nc chunk items, then K's group
  auto slot = [&](int i) { return smem + (i % kStages) * L::kSlot; };
  auto issue = [&](int i) {
    if (i < n_items) {
      const int j = i / (nc + 1), c = i % (nc + 1);
      const uint32_t dst = smem_u32(slot(i));
      if (c < nc) {
        const int cb = c * kCBytes;  // the chunk's first byte in a row
        dsplit_load<kBlockQ, kCBytes, kA, kThreads>(dst, q + cb, ld, q0, p.t_q, kCBytes);
        dsplit_load<kBlockQ, kCBytes, kA, kThreads>(dst + L::kDO, dout + cb, ld, q0, p.t_q,
                                                    kCBytes);
        dsplit_load<kBlockK, kCBytes, kA, kThreads>(dst + L::kK, k + cb, ld, j * kBlockK, p.t_kv,
                                                    kCBytes);
        dsplit_load<kBlockK, kCBytes, kA, kThreads>(dst + L::kV, v + cb, ld, j * kBlockK, p.t_kv,
                                                    kCBytes);
      } else {
        dsplit_load<kBlockK, kGroupCols * (int)sizeof(T), L::kG, kThreads>(
            dst, k + (size_t)c0 * sizeof(T), ld, j * kBlockK, p.t_kv, ncols * (int)sizeof(T));
      }
    }
    cp_async_commit();
  };
  int at = 0;
  auto next = [&]() {
    cp_async_wait<kStages - 2>();  // the item has landed
    __syncthreads();  // for every warp, and every warp is done with the one before
    issue(at + kStages - 1);
    return slot(at++);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  // lse in log2 units and delta of the thread's two rows: +inf and 0 (P =
  // 0) past t_q and where the empty-row guard drops the row
  float lse2[2], dl[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + g + 8 * r;
    lse2[r] = INFINITY;
    dl[r] = 0.f;
    if (row < p.t_q) {
      const float l = p.lse[(size_t)bh * p.t_q + row];
      if (!sees_no_key(p, l)) {
        lse2[r] = l * kLog2e;
        dl[r] = p.delta[(size_t)bh * p.t_q + row];
      }
    }
  }

  float dq[kGroupCols / 2];
#pragma unroll
  for (int i = 0; i < kGroupCols / 2; ++i) dq[i] = 0.f;

#pragma unroll 1
  for (int j = 0; j < n_run; ++j) {
    float s[kBlockK / 2], dp[kBlockK / 2];
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) s[i] = dp[i] = 0.f;
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      const uint8_t* t = next();
      chunk_nt<T, kA, kA, kBlockK>(s, t + 16 * warp * kA, t + L::kK, lane);
      chunk_nt<T, kA, kA, kBlockK>(dp, t + L::kDO + 16 * warp * kA, t + L::kV, lane);
    }
    // P = exp2(S * scale * log2 e - lse * log2 e), dS = P * (dP - delta);
    // masks (causal, past t_kv) where the tile crosses them
    const int k0 = j * kBlockK;
    const bool masked = (p.causal && q0 + p.off < k0 + kBlockK - 1) || k0 + kBlockK > p.t_kv;
#pragma unroll
    for (int i = 0; i < kBlockK / 2; i += 2) {
      const int r = (i >> 1) & 1;
      float p0 = fast_exp2(fmaf(s[i], p.scale_log2, -lse2[r]));
      float p1 = fast_exp2(fmaf(s[i + 1], p.scale_log2, -lse2[r]));
      if (masked) {
        const int col = k0 + 8 * (i >> 2) + 2 * tq;  // columns col, col + 1
        const int row = row0 + g + 8 * r;
        if (col >= p.t_kv || (p.causal && row + p.off < col)) p0 = 0.f;
        if (col + 1 >= p.t_kv || (p.causal && row + p.off < col + 1)) p1 = 0.f;
      }
      s[i] = p0 * (dp[i] - dl[r]);
      s[i + 1] = p1 * (dp[i + 1] - dl[r]);
    }
    group_nn<T, L::kG, kBlockK>(dq, s, next(), ncols, lane);  // dQ_g += dS K_g
  }
  cp_async_wait<0>();
  const float scale[2] = {p.scale, p.scale};
  store_group<T>(static_cast<T*>(p.dq) + (size_t)bh * p.t_q * p.d + c0, p.d, dq, scale, row0,
                 p.t_q, ncols, g, tq);
}

// ---------------------------------------------------------------------------
// dK/dV
// ---------------------------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(Dkv<T>::kThreads, 1) flash_bwd_dkv_dsplit_kernel(const Params p) {
  using L = Dkv<T>;
  constexpr int kBlockQ = L::kBlockQ, kBlockK = L::kBlockK, kThreads = L::kThreads;
  constexpr int kStages = L::kStages, kA = L::kA, kC = kChunkCols<T>;
  constexpr int kCBytes = kC * (int)sizeof(T);
  constexpr int kSlotF4 = kBlockQ / 8 * 32;  // float4s of one warp's S^T
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const bool p_side = warp < 2;  // S^T, P^T, dV; the other side dP^T, dS^T, dK
  const int sub = warp & 1;      // the warp's 16 kv rows of the tile
  int bh, item;
  wide_slot(p.bh, p.n_tiles * p.groups, p.l2, &bh, &item);
  const int tile = item / p.groups;
  const int cg = item % p.groups;
  const int k0 = tile * kBlockK;  // kv tile 0, the heaviest under the causal mask, first
  const int c0 = cg * kGroupCols;
  const int ncols = min(kGroupCols, p.d - c0);
  const size_t ld = (size_t)p.d * sizeof(T);
  const char* q = static_cast<const char*>(p.q) + (size_t)bh * p.t_q * ld;
  const char* dout = static_cast<const char*>(p.dout) + (size_t)bh * p.t_q * ld;
  const char* k = static_cast<const char*>(p.k) + (size_t)bh * p.t_kv * ld;
  const char* v = static_cast<const char*>(p.v) + (size_t)bh * p.t_kv * ld;

  // the first q tile that sees key k0: earlier ones lie wholly above the
  // causal diagonal
  const int n_q = (p.t_q + kBlockQ - 1) / kBlockQ;
  int first = 0;
  if (p.causal) {
    const int r0 = k0 - p.off;  // the first q row that sees key k0
    first = r0 <= 0 ? 0 : (r0 >= p.t_q ? n_q : r0 / kBlockQ);
  }
  const int nc = p.d / kC;
  const int n_items = (n_q - first) * (nc + 1);  // per q tile: nc chunk items, then the groups'
  auto slot = [&](int i) { return smem + (i % kStages) * L::kSlot; };
  auto issue = [&](int i) {
    if (i < n_items) {
      const int qt = first + i / (nc + 1), c = i % (nc + 1);
      const uint32_t dst = smem_u32(slot(i));
      if (c < nc) {
        const int cb = c * kCBytes;
        dsplit_load<kBlockK, kCBytes, kA, kThreads>(dst, k + cb, ld, k0, p.t_kv, kCBytes);
        dsplit_load<kBlockK, kCBytes, kA, kThreads>(dst + L::kV, v + cb, ld, k0, p.t_kv, kCBytes);
        dsplit_load<kBlockQ, kCBytes, kA, kThreads>(dst + L::kQ, q + cb, ld, qt * kBlockQ, p.t_q,
                                                    kCBytes);
        dsplit_load<kBlockQ, kCBytes, kA, kThreads>(dst + L::kDO, dout + cb, ld, qt * kBlockQ,
                                                    p.t_q, kCBytes);
      } else {
        const size_t gb = (size_t)c0 * sizeof(T);  // the group's first byte in a row
        const int bytes = ncols * (int)sizeof(T);
        dsplit_load<kBlockQ, kGroupCols * (int)sizeof(T), L::kG, kThreads>(
            dst, q + gb, ld, qt * kBlockQ, p.t_q, bytes);
        dsplit_load<kBlockQ, kGroupCols * (int)sizeof(T), L::kG, kThreads>(
            dst + L::kDOg, dout + gb, ld, qt * kBlockQ, p.t_q, bytes);
        // the rows' lse and delta (zeros past t_q)
        for (int i = threadIdx.x; i < kBlockQ; i += kThreads) {
          const int row = qt * kBlockQ + i;
          const size_t stat = (size_t)bh * p.t_q + min(row, p.t_q - 1);
          const int n = row < p.t_q ? 4 : 0;
          cp_async_4(dst + L::kStats + 4 * i, p.lse + stat, n);
          cp_async_4(dst + L::kStats + 4 * (kBlockQ + i), p.delta + stat, n);
        }
      }
    }
    cp_async_commit();
  };
  int at = 0;
  auto next = [&]() {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(at + kStages - 1);
    return slot(at++);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float acc[kGroupCols / 2];  // dV_g on the P side, dK_g / scale on the other
#pragma unroll
  for (int i = 0; i < kGroupCols / 2; ++i) acc[i] = 0.f;
  float4* const hand = reinterpret_cast<float4*>(smem + L::kHand) + sub * kSlotF4 + lane;
  const int kv0 = k0 + 16 * sub + g;  // the thread's kv rows: kv0 and kv0 + 8

#pragma unroll 1
  for (int qt = first; qt < n_q; ++qt) {
    // rows are kv, columns q: S^T = K Q^T (P side) or dP^T = V dO^T over d
    float x[kBlockQ / 2];
#pragma unroll
    for (int i = 0; i < kBlockQ / 2; ++i) x[i] = 0.f;
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      const uint8_t* t = next();
      if (p_side) {
        chunk_nt<T, kA, kA, kBlockQ>(x, t + 16 * sub * kA, t + L::kQ, lane);
      } else {
        chunk_nt<T, kA, kA, kBlockQ>(x, t + L::kV + 16 * sub * kA, t + L::kDO, lane);
      }
    }
    if (p_side) put_partial<kBlockQ>(hand, x);  // S^T for the dS side's warp of the same rows
    const uint8_t* t = next();  // the group columns of Q and dO, lse and delta
    const float* rows = reinterpret_cast<const float*>(t + L::kStats);
    float pt[kBlockQ / 2];
    if (p_side) {
#pragma unroll
      for (int i = 0; i < kBlockQ / 2; ++i) pt[i] = x[i];
    } else {
      sum_partials<kBlockQ, 1>(pt, hand, 0);
    }
    // P^T = exp2(S^T * scale * log2 e - lse * log2 e); masks where the tile
    // crosses the diagonal or the ragged end of kv
    const int q0 = qt * kBlockQ;
    const bool masked = (p.causal && q0 + p.off < k0 + kBlockK - 1) || k0 + kBlockK > p.t_kv;
#pragma unroll
    for (int i = 0; i < kBlockQ / 2; ++i) {
      const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
      const int kv = kv0 + 8 * ((i >> 1) & 1);
      const float l = rows[col];
      float pe = fast_exp2(fmaf(pt[i], p.scale_log2, -l * kLog2e));
      if (q0 + col >= p.t_q || sees_no_key(p, l)) pe = 0.f;
      if (masked && (kv >= p.t_kv || (p.causal && q0 + col + p.off < kv))) pe = 0.f;
      pt[i] = pe;
    }
    if (p_side) {
      group_nn<T, L::kG, kBlockQ>(acc, pt, t + L::kDOg, ncols, lane);  // dV_g += P^T dO_g
    } else {
#pragma unroll
      for (int i = 0; i < kBlockQ / 2; ++i) {
        const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
        x[i] = pt[i] * (x[i] - rows[kBlockQ + col]);  // dS^T
      }
      group_nn<T, L::kG, kBlockQ>(acc, x, t, ncols, lane);  // dK_g += dS^T Q_g
    }
  }
  cp_async_wait<0>();
  const float mul[2] = {p_side ? 1.f : p.scale, p_side ? 1.f : p.scale};
  const size_t head = (size_t)bh * p.t_kv * p.d + c0;
  store_group<T>(static_cast<T*>(p_side ? p.dv : p.dk) + head, p.d, acc, mul, k0 + 16 * sub,
                 p.t_kv, ncols, g, tq);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T>
int smem_attribute(bool dkv) {
  return dkv ? (int)cudaFuncSetAttribute(flash_bwd_dkv_dsplit_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Dkv<T>::kBytes)
             : (int)cudaFuncSetAttribute(flash_bwd_dq_dsplit_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Dq<T>::kBytes);
}

template <typename T>
int launch(bool dkv, const Params& all, cudaStream_t stream) {
  const int err = smem_attribute<T>(dkv);
  if (err != 0) return err;
  Params p = all;
  p.groups = (p.d + kGroupCols - 1) / kGroupCols;
  p.n_tiles = dkv ? (p.t_kv + Dkv<T>::kBlockK - 1) / Dkv<T>::kBlockK
                  : (p.t_q + Dq<T>::kBlockQ - 1) / Dq<T>::kBlockQ;
  const size_t ld = (size_t)p.d * sizeof(T);
  // Q, dO, K and V of one head stream through each tile's CTAs
  const long long head_bytes = 2ll * (long long)ld * (p.t_q + p.t_kv);
  return launch_heads(p.bh, (long long)p.n_tiles * p.groups, [&](int h0, int heads) {
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
    const unsigned grid = (unsigned)((long long)heads * p.n_tiles * p.groups);
    if (dkv) {
      c.dk = static_cast<char*>(p.dk) + ks;
      c.dv = static_cast<char*>(p.dv) + ks;
      flash_bwd_dkv_dsplit_kernel<T><<<grid, Dkv<T>::kThreads, Dkv<T>::kBytes, stream>>>(c);
    } else {
      c.dq = static_cast<char*>(p.dq) + qs;
      flash_bwd_dq_dsplit_kernel<T><<<grid, Dq<T>::kThreads, Dq<T>::kBytes, stream>>>(c);
    }
    return (int)cudaGetLastError();
  });
}

template <typename T>
int ctas_per_sm(bool dkv) {
  if (smem_attribute<T>(dkv) != 0) return -1;
  int per_sm = 0;
  const cudaError_t err =
      dkv ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, flash_bwd_dkv_dsplit_kernel<T>, Dkv<T>::kThreads, Dkv<T>::kBytes)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, flash_bwd_dq_dsplit_kernel<T>, Dq<T>::kThreads, Dq<T>::kBytes);
  return err == cudaSuccess ? per_sm : -1;
}

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

int dispatch(bool dkv, const Params& p, int dtype, void* stream) {
  if (p.bh <= 0 || p.t_q <= 0 || p.t_kv <= 0 || p.d <= 0 || p.d % 128 != 0) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, kUnsupported,
                    [&](auto t) { return launch<decltype(t)>(dkv, p, st); });
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

extern "C" int ray_tpu_flash_bwd_dq_dsplit(const void* q, const void* k, const void* v,
                                           const void* dout, const void* lse, const void* delta,
                                           void* dq, int bh, int t_q, int t_kv, int d, int dtype,
                                           int causal, float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, bh, t_q, t_kv, d, causal, scale);
  p.dq = dq;
  return dispatch(false, p, dtype, stream);
}

extern "C" int ray_tpu_flash_bwd_dkv_dsplit(const void* q, const void* k, const void* v,
                                            const void* dout, const void* lse, const void* delta,
                                            void* dk, void* dv, int bh, int t_q, int t_kv, int d,
                                            int dtype, int causal, float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, bh, t_q, t_kv, d, causal, scale);
  p.dk = dk;
  p.dv = dv;
  return dispatch(true, p, dtype, stream);
}

extern "C" int ray_tpu_flash_bwd_dsplit_smem_bytes(int dtype, int dkv) {
  return with_dtype(dtype, -1, [&](auto t) {
    using T = decltype(t);
    return dkv ? Dkv<T>::kBytes : Dq<T>::kBytes;
  });
}

extern "C" int ray_tpu_flash_bwd_dsplit_ctas_per_sm(int dtype, int dkv) {
  return with_dtype(dtype, -1, [&](auto t) { return ctas_per_sm<decltype(t)>(dkv != 0); });
}

extern "C" const char* ray_tpu_flash_bwd_dsplit_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
