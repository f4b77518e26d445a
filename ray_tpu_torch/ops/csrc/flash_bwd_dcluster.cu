// Flash-attention backward for Hopper (sm_90a) at every head_dim that is a
// multiple of 128, d a runtime argument, in bf16, float16 and float32 (the
// kernels' T): design "dcluster", the output's columns split over the CTAs
// of a thread-block cluster that compute S and dP once between them.
// Hand-written CUDA C++.
//
// Replaces the two TPU kernels of ray_tpu/ops/attention.py launched by
// _flash_attention_tpu_bwd, at head_dim 896 and up (BWD_DESIGNS in
// ops/attention.py, by its rule DSPLIT_MIN_D):
//   * _flash_bwd_dq_kernel  -> flash_bwd_dq_dcluster_kernel  (dQ);
//   * _flash_bwd_dkv_kernel -> flash_bwd_dkv_dcluster_kernel (dK and dV),
// one body over T (dcluster_body<T, kDkv>).
// Both recompute P = exp(scale * Q K^T - lse) from the forward's row lse,
// dP = dO V^T and dS = P * (dP - delta) with delta = rowsum(dO * O) from the
// caller (flash_bwd_delta in ops/attention.py), and accumulate dQ = scale *
// dS K, dK = scale * dS^T Q and dV = P^T dO, the scale in the epilogues. The
// conventions are flash_bwd_dsplit.cu's: a masked score gives P = 0; q rows
// are the suffix of the kv context under the causal mask; tiles wholly above
// the diagonal are skipped; where causal and t_q > t_kv a row whose lse is at
// most NEG_INF / 2 gets P = 0; padded rows of a ragged tile are zero-filled
// and add nothing. flash_attention_bwd_plain is the same arithmetic in
// float32.
//
// What bounds them on an H100: the operations, 6 * d per visible (q, k) pair
// for dQ (S, dP, dQ) and 8 * d for dK/dV (S^T, dP^T, dV, dK), at 164.9
// TFLOP/s in float32 (3xTF32) and 989 in bf16 and float16, with q, k, v, dO,
// lse, delta and the gradients read or written once. flash_bwd_dsplit.cu
// (the design before, on no path now) reached 5% of it in float32 because
// each of its G = ceil(d / 256) column groups recomputed S and dP over all of
// d: (4 G + 2) d and (4 G + 4) d a visible pair.
//
// Design. The CTAs that share one resident tile (32 q rows for dQ, 32 kv
// rows for dK/dV) form a cluster, launched with cudaLaunchKernelEx and a
// cluster dimension, since d is a runtime argument. The plan (make_plan, and
// ops/dcluster.py's dcluster_plan, which the wrapper checks against
// ray_tpu_flash_bwd_dcluster_plan): G groups of kGroupCols = 256 columns
// (the last narrower where 256 does not divide d), P = ceil(G / 8) passes
// (the portable cluster holds at most 8 CTAs) and C = ceil(G / P) CTAs a
// cluster; CTA c owns the columns of groups c P .. c P + P - 1 (those below
// d) and, in pass p, writes group c P + p (none past d). Per item (a
// streamed tile of 32 rows in a pass):
//   1. each CTA computes the partial S and dP over its own columns only:
//      S = Q_c K_c^T and dP = dO_c V_c^T (for dK/dV S^T = K_c Q_c^T and dP^T
//      = V_c dO_c^T), a [16 x 16] piece of S or dP a warp (8 warps cover the
//      [32 x 32] S and dP), and pushes each of its 256 positions (a float4
//      of S or dP in the accumulator layout) to the CTA that reduces it:
//      CTA r reduces positions r ceil(256 / C) and on;
//   2. the reducing thread sums a position's C partials in group order 0 ..
//      C - 1, so the sum has one set of bits, makes P and dS there (the
//      masks, lse, delta), and pushes them to every CTA; P and dS then agree
//      across the cluster with no further exchange;
//   3. each CTA updates only its pass's output columns from P and dS: dQ_g
//      += dS K_g (8 warps of [32 x 32]), or dV_g += P^T dO_g and dK_g += dS^T
//      Q_g (8 warps of [32 x 64]), reading its own columns of the streamed
//      tile once. No atomics, no split reduction across launches: a second
//      run is bit-equal.
// Every push is st.async, 16 bytes completing on the receiver's mbarrier, so
// the exchange needs no cluster barrier an item (whose release waits for the
// thread's memory operations in flight; such a design read slower) and runs
// behind the products: item i + 1's partials are pushed before item i's
// output.
// Receive and P/dS buffers are double; the order that makes them safe is
// stated at the pipeline. Work a visible pair: 6 d for dQ and 8 d for
// dK/dV at one pass (d up to 8 x 256 = 2048), with no recompute. Past 2048
// each CTA walks its resident tile P times, one output group a pass, so S
// and dP are computed P times instead of G; those passes read the partials'
// operands from global memory (L2), since the CTA's P groups of a resident
// tile do not fit in shared memory.
//
// The reckoning (float32; bf16 and float16 rows are 528 bytes, 126688 and
// 134624 bytes in all): a float32 tile row of a group is 1024 bytes (256
// floats, their 16-byte pieces XOR-swizzled by the row's low three bits, so
// the 3xTF32 fragment loads touch 32 distinct banks with no padding); a
// 32-row tile is 32768 bytes.
//   * resident: the two tiles of the resident side (Q_g, dO_g for dQ; K_g,
//     V_g for dK/dV), 65536 bytes, loaded once (at one pass);
//   * streamed: the two tiles of the other side (K_g, V_g or Q_g, dO_g),
//     65536 bytes a stage, two stages through a cp.async ring: 131072;
//   * exchange: two receive buffers of the positions a CTA reduces, C x
//     ceil(256 / C) x 2 float4 at most, 8416 bytes each; two of P and dS
//     [32 x 32] float32 (dQ: dS only), 8192 (4096) bytes each; the resident
//     rows' lse and delta (dQ): 256; four mbarriers.
//   229856 bytes for dK/dV and 221920 for dQ of the 232448 a block may use:
//   one CTA an SM, 256 threads, each thread's output slice [32 x 32] or [32
//   x 64] float32 (32 or 64 registers). A cluster of C CTAs takes C SMs of
//   one GPC; ray_tpu_flash_bwd_dcluster_max_clusters reports how many are
//   resident at once (on an H100: 30 of 4, 22 of 5, 15 of 7 or 8).
// Products on mma.sync: bf16 and float16 m16n8k16 fed by ldmatrix, float32
// 3xTF32 m16n8k8 with the operands split where they are loaded (dsplit.cuh,
// tf32_mma.cuh). The cluster helpers, the plan, the tile loads and the
// products are dcluster.cuh's, which the forward (flash_fwd_dcluster.cu)
// shares.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_bwd_dq_dcluster(q, k, v, dout, lse, delta, dq,
//                                     bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dkv_dcluster(q, k, v, dout, lse, delta, dk, dv,
//                                      bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dcluster_plan(d, dtype, int out[5])
//       (group columns, CTAs a cluster, passes, dQ's and dK/dV's dynamic
//       shared memory)
//   int ray_tpu_flash_bwd_dcluster_smem_bytes(dtype, dkv)
//   int ray_tpu_flash_bwd_dcluster_max_clusters(dtype, dkv, cluster)
// q/dout/dq are [bh, t_q, d], k/v/dk/dv [bh, t_kv, d], contiguous bf16
// (dtype 0), float32 (1) or float16 (2), d a positive multiple of 128,
// 16-byte aligned; lse and delta [bh, t_q] float32. The grid is (heads of a
// launch) x resident tiles x C on grid.x, at most 2^31 - 1, in clusters of
// C <= 8 CTAs: each launches as many times as that takes, on `stream`,
// allocates nothing, and returns the launch's status, or kUnsupported for
// what it does not take.

#include "dcluster.cuh"

namespace {

constexpr int kRows = 32;        // rows of the resident tile and of a streamed tile
constexpr int kStages = 2;

// Shared memory, in bytes from the start
template <typename T, bool kDkv>
struct Layout {
  static constexpr int kG = kTileRow<T>;   // a tile row
  static constexpr int kTile = kRows * kG;  // a 32-row tile
  static constexpr int kX = 0;              // the resident side's two tiles
  static constexpr int kRing = 2 * kTile;   // the streamed side's, kStages slots
  static constexpr int kSlot = 2 * kTile;
  // a CTA's share of the positions' partials from every CTA: [source][S, dP]
  // [share] float4, share = ceil(256 / C), so at most 256 + 7 of each
  static constexpr int kRecv = kRing + kStages * kSlot;
  static constexpr int kRecvBytes = 2 * (256 + kMaxCluster - 1) * 16;
  static constexpr int kPd = kRecv + 2 * kRecvBytes;      // [P, dS] (dQ: dS), 256 float4 each
  static constexpr int kPdBytes = (kDkv ? 2 : 1) * 256 * 16;
  static constexpr int kRowStats = kPd + 2 * kPdBytes;    // dQ: the resident rows' lse, delta
  static constexpr int kBars = kRowStats + (kDkv ? 0 : 2 * kRows * 4);  // the mbarriers
  static constexpr int kBytes = kBars + 4 * 8;
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block may use");
  static_assert(kTile % 16 == 0, "16-byte aligned tiles");
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
  int n_tiles;  // resident tiles per head
  int l2;       // heads per L2 group
  int passes;
  int cluster;
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


// ---------------------------------------------------------------------------
// the kernels: dQ (kDkv false) or dK/dV (kDkv true), one body
// ---------------------------------------------------------------------------

template <typename T, bool kDkv>
__device__ __forceinline__ void dcluster_body(const Params& p) {
  using L = Layout<T, kDkv>;
  constexpr int kG = L::kG, kTile = L::kTile;
  constexpr int kOutCols = kDkv ? 64 : 32;  // output columns a warp owns, all 32 rows
  static_assert(128 % kOutCols == 0, "a warp's output columns lie in one 128-column half");
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int rank = (int)cluster_ctarank();  // the CTA's columns
  int bh, tile;
  slot_head_tile(blockIdx.x / p.cluster, p.bh, p.n_tiles, p.l2, &bh, &tile);  // a cluster a slot
  const size_t ld = (size_t)p.d * sizeof(T);
  const char* q = static_cast<const char*>(p.q) + (size_t)bh * p.t_q * ld;
  const char* dout = static_cast<const char*>(p.dout) + (size_t)bh * p.t_q * ld;
  const char* k = static_cast<const char*>(p.k) + (size_t)bh * p.t_kv * ld;
  const char* v = static_cast<const char*>(p.v) + (size_t)bh * p.t_kv * ld;
  const float* lse = p.lse + (size_t)bh * p.t_q;
  const float* delta = p.delta + (size_t)bh * p.t_q;
  // the resident side (X0, X1: rows t_x) and the streamed one (Y0, Y1:
  // rows t_y); S (or S^T) = X0 Y0^T, dP (or dP^T) = X1 Y1^T
  const char* const x0 = kDkv ? k : q;
  const char* const x1 = kDkv ? v : dout;
  const char* const y0p = kDkv ? q : k;
  const char* const y1p = kDkv ? dout : v;
  const int t_x = kDkv ? p.t_kv : p.t_q, t_y = kDkv ? p.t_q : p.t_kv;

  // the resident rows and the streamed tiles they run: the causal skip as
  // loop bounds (dQ: the heaviest q tiles first; dK/dV: kv tile 0 first,
  // from the first q tile that sees its first key)
  const int n_y = (t_y + kRows - 1) / kRows;
  int r0, first = 0, n_run;
  if constexpr (kDkv) {
    r0 = tile * kRows;
    if (p.causal) {
      const int q_first = r0 - p.off;
      first = q_first <= 0 ? 0 : (q_first >= p.t_q ? n_y : q_first / kRows);
    }
    n_run = n_y - first;
  } else {
    r0 = (p.n_tiles - 1 - tile) * kRows;
    const int last = min(r0 + kRows, p.t_q) - 1 + p.off;
    n_run = !p.causal ? n_y : (last < 0 ? 0 : min(n_y, last / kRows + 1));
  }
  // the CTA's columns [own0, own1): groups rank P .. rank P + P - 1
  const int own0 = rank * p.passes * kGroupCols;
  const int own1 = min(own0 + p.passes * kGroupCols, p.d);
  const int n_items = p.passes * n_run;  // a streamed tile a pass
  auto first_row = [&](int i) { return (first + i % n_run) * kRows; };  // item i's streamed rows

  // The exchange is pushed, by st.async, each 16 bytes completing on the
  // receiver's mbarrier: a CTA's partials go to the CTA that reduces each
  // position (its receive buffer i % 2), P and dS from there to every CTA
  // (its P and dS buffer i % 2). No cluster barrier an item, so no release.
  const int share = (256 + p.cluster - 1) / p.cluster;  // positions a CTA reduces
  const int n_share = min(share, 256 - rank * share);
  const uint32_t recv_bytes = (uint32_t)(p.cluster * 2 * n_share * 16);
  const uint32_t bars = smem_u32(smem + L::kBars);
  auto recv_bar = [&](int i) { return bars + 8 * (i & 1); };
  auto pd_bar = [&](int i) { return bars + 16 + 8 * (i & 1); };
  if (threadIdx.x == 0 && n_items > 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(recv_bar(b), 1);
      mbar_init(pd_bar(b), 1);
    }
    for (int i = 0; i < min(2, n_items); ++i) {  // armed for items 0 and 1
      mbar_arrive_expect_tx(recv_bar(i), recv_bytes);
      mbar_arrive_expect_tx(pd_bar(i), L::kPdBytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n_items > 0) cluster_sync();  // every peer's mbarriers are ready before the first push
  // the streamed tiles of item i (the pass's output group's columns of Y0
  // and Y1) into slot i % 2, by cp.async
  auto slot = [&](int i) { return smem + L::kRing + (i % kStages) * L::kSlot; };
  auto issue = [&](int i) {
    if (i < n_items) {
      const int c0 = own0 + i / n_run * kGroupCols;  // the pass's output group
      const int bytes = (min(c0 + kGroupCols, p.d) - c0) * (int)sizeof(T);
      const uint32_t dst = smem_u32(slot(i));
      load_tile<T, kRows>(dst, y0p + (size_t)c0 * sizeof(T), ld, first_row(i), t_y, bytes);
      load_tile<T, kRows>(dst + kTile, y1p + (size_t)c0 * sizeof(T), ld, first_row(i), t_y, bytes);
    }
    cp_async_commit();
  };
  if (p.passes == 1 && n_items > 0) {  // the resident tiles, with item 0
    const int bytes = (own1 - own0) * (int)sizeof(T);
    load_tile<T, kRows>(smem_u32(smem + L::kX), x0 + (size_t)own0 * sizeof(T), ld, r0, t_x, bytes);
    load_tile<T, kRows>(smem_u32(smem + L::kX + kTile), x1 + (size_t)own0 * sizeof(T), ld, r0, t_x,
                 bytes);
  }
  issue(0);
  issue(1);
  float* const row_stats = reinterpret_cast<float*>(smem + L::kRowStats);
  if constexpr (!kDkv) {
    // the resident q rows' lse in log2 units and delta: +inf and 0 (P = 0)
    // past t_q and where the empty-row guard drops the row
    for (int r = threadIdx.x; r < kRows; r += kClusterThreads) {
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
      row_stats[kRows + r] = dl;
    }
  }

  // step 1 of item i: the warp's piece of the partials, product `prod` (0:
  // S, 1: dP) on resident rows 16 prb against streamed rows 16 nh, pushed to
  // the CTAs that reduce its positions
  const int prod = warp >> 2, prb = (warp >> 1) & 1, nh = warp & 1;
  auto partial = [&](int i) {
    float s[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = 0.f;
    if (p.passes == 1) {
      partial_smem<T>(s, smem + L::kX + prod * kTile + 16 * prb * kG,
                      slot(i) + prod * kTile + 16 * nh * kG, own1 - own0, lane);
    } else {
      partial_global<T>(s, reinterpret_cast<const T*>(prod ? x1 : x0), r0 + 16 * prb, t_x,
                        reinterpret_cast<const T*>(prod ? y1p : y0p), first_row(i) + 16 * nh,
                        t_y, p.d, own0, own1, lane);
    }
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int pos = (prb * 4 + 2 * nh + t) * 32 + lane;  // [rb][n-tile][lane]
      const int to = pos / share, j = pos - to * share;
      const uint32_t at = smem_u32(smem + L::kRecv + (i & 1) * L::kRecvBytes) +
                          ((rank * 2 + prod) * share + j) * 16;
      st_async(map_cluster(at, to), make_float4(s[4 * t], s[4 * t + 1], s[4 * t + 2], s[4 * t + 3]),
               map_cluster(recv_bar(i), to));
    }
  };

  // step 3 of item i: this CTA's share of the [32 x 32] positions (a float4
  // of S and one of dP each, in the accumulator layout: resident row 16 rb +
  // g (+ 8), streamed row 8 nt + 2 tq (+ 1)), one a thread, once every
  // CTA's partials of them are in. The thread sums them in group order,
  // makes P and dS, and pushes them to every CTA (reduce-scatter, then
  // all-gather).
  const int pos = rank * share + (int)threadIdx.x;
  const bool reduces = (int)threadIdx.x < n_share;
  const int rrb = pos >> 7, rnt = (pos >> 5) & 3, rg = (pos & 31) >> 2, rtq = pos & 3;
  float l_pos[2] = {0.f, 0.f}, d_pos[2] = {0.f, 0.f};  // dK/dV: the position's q rows
  auto stats = [&](int i) {  // loaded before the partials are waited for
    if constexpr (kDkv) {
      if (reduces) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int qr = first_row(i) + 8 * rnt + 2 * rtq + c;
          l_pos[c] = qr < p.t_q ? lse[qr] : 0.f;
          d_pos[c] = qr < p.t_q ? delta[qr] : 0.f;
        }
      }
    }
  };
  auto reduce = [&](int i) {
    if (!reduces) return;
    mbar_wait(recv_bar(i), (i >> 1) & 1);
    if (threadIdx.x == 0 && i + 2 < n_items) mbar_arrive_expect_tx(recv_bar(i), recv_bytes);
    const float4* in =
        reinterpret_cast<const float4*>(smem + L::kRecv + (i & 1) * L::kRecvBytes) + threadIdx.x;
    float sx[4] = {0.f, 0.f, 0.f, 0.f}, dx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {  // in group order
      if (c < p.cluster) {
        const float4 a = in[2 * c * share], b = in[(2 * c + 1) * share];
        sx[0] += a.x;
        sx[1] += a.y;
        sx[2] += a.z;
        sx[3] += a.w;
        dx[0] += b.x;
        dx[1] += b.y;
        dx[2] += b.z;
        dx[3] += b.w;
      }
    }
    const int y0 = first_row(i);
    float pe[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = 16 * rrb + rg + 8 * (e >> 1);  // in the resident tile
      const int col = 8 * rnt + 2 * rtq + (e & 1);   // in the streamed tile
      if constexpr (kDkv) {
        const int kv = r0 + row, qr = y0 + col;
        const float l = l_pos[e & 1];
        float pv = fast_exp2(fmaf(sx[e], p.scale_log2, -l * kLog2e));
        if (qr >= p.t_q || sees_no_key(p, l) || kv >= p.t_kv || (p.causal && qr + p.off < kv)) {
          pv = 0.f;
        }
        pe[e] = pv;
        ds[e] = pv * (dx[e] - d_pos[e & 1]);
      } else {
        const int qr = r0 + row, kv = y0 + col;
        float pv = fast_exp2(fmaf(sx[e], p.scale_log2, -row_stats[row]));
        if (kv >= p.t_kv || (p.causal && qr + p.off < kv)) pv = 0.f;
        pe[e] = pv;
        ds[e] = pv * (dx[e] - row_stats[kRows + row]);
      }
    }
    const uint32_t out = smem_u32(smem + L::kPd + (i & 1) * L::kPdBytes) + 16 * pos;
    const uint32_t bar = pd_bar(i);
    const float4 pv4 = make_float4(pe[0], pe[1], pe[2], pe[3]);
    const float4 ds4 = make_float4(ds[0], ds[1], ds[2], ds[3]);
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {
      if (c < p.cluster) {
        const uint32_t o = map_cluster(out, c), b = map_cluster(bar, c);
        if constexpr (kDkv) {
          st_async(o, pv4, b);
          st_async(o + 4096, ds4, b);
        } else {
          st_async(o, ds4, b);
        }
      }
    }
  };

  // step 4 of item i, once P and dS are in: the warp's output, all 32 rows
  // of the resident tile and kOutCols columns: dQ columns 32 ocol of the
  // pass's group; dK/dV: dV (which 0, from P^T and dO) or dK (which 1, from
  // dS^T and Q), columns 64 ocol; stored after the pass's last item
  const int which = kDkv ? warp >> 2 : 1;
  const int ocol = kDkv ? warp & 3 : warp;
  float acc[kOutCols];
#pragma unroll
  for (int e = 0; e < kOutCols; ++e) acc[e] = 0.f;
  auto store = [&](int pass) {
    const int oc0 = own0 + pass * kGroupCols + ocol * kOutCols;  // the warp's first column
    if (oc0 < p.d) {
      const float mul[2] = {which ? p.scale : 1.f, which ? p.scale : 1.f};
      T* out = static_cast<T*>(kDkv ? (which ? p.dk : p.dv) : p.dq);
      const int t_out = kDkv ? p.t_kv : p.t_q;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        store_group<T, kOutCols>(out + (size_t)bh * t_out * p.d + oc0, p.d, acc + m * kOutCols / 2,
                                 mul, r0 + 16 * m, t_out, kOutCols, g, tq);
      }
    }
#pragma unroll
    for (int e = 0; e < kOutCols; ++e) acc[e] = 0.f;
  };
  auto output = [&](int i) {
    const int pass = i / n_run;
    const int oc0 = own0 + pass * kGroupCols + ocol * kOutCols;
    const float4* in = reinterpret_cast<const float4*>(smem + L::kPd + (i & 1) * L::kPdBytes) +
                       (kDkv ? which * 256 : 0) + lane;
    float a[32];  // P^T or dS, [32 x 32], as two accumulators
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {  // rows 16 (nt / 4), n-tile nt % 4
      const float4 f = in[32 * nt];
      a[4 * nt] = f.x;
      a[4 * nt + 1] = f.y;
      a[4 * nt + 2] = f.z;
      a[4 * nt + 3] = f.w;
    }
    // dQ_g += dS K_g; dV_g += P^T dO_g; dK_g += dS^T Q_g. A group is a
    // multiple of 128 columns wide, so a warp's columns are all below d or
    // none is, and the product runs with no test of a column
    const uint8_t* b =
        slot(i) + (kDkv && which == 0 ? kTile : 0) + ocol * kOutCols * (int)sizeof(T);
    if (oc0 < p.d) rows32_nn<T, kG, kOutCols>(acc, a, b, lane);
    if (i % n_run == n_run - 1) store(pass);
  };

  // The pipeline: item i + 1's partials are pushed before item i's output,
  // so that the exchange of each item runs while the CTA computes. Both
  // buffers are double. A CTA pushes partials i + 2 once P and dS of item i
  // are in from every CTA, each of which had by then read its partials of
  // item i; its peers push P and dS of item i + 2 into it only after its
  // partials of item i + 2, which it pushes after reading item i's in its
  // output. The mbarriers are armed for item i + 2 once item i's phase is
  // seen complete. A CTA exits once P and dS of its last item are in, and
  // nothing is pushed to it after.
  if (n_items > 0) {
    cp_async_wait<1>();  // item 0 and the resident tiles
    __syncthreads();
    partial(0);
  }
#pragma unroll 1
  for (int i = 0; i < n_items; ++i) {
    stats(i);
    reduce(i);
    if (i + 1 < n_items) {
      cp_async_wait<0>();  // item i + 1 has landed
      __syncthreads();
      partial(i + 1);
    }
    mbar_wait(pd_bar(i), (i >> 1) & 1);  // P and dS of item i are in
    if (threadIdx.x == 0 && i + 2 < n_items) mbar_arrive_expect_tx(pd_bar(i), L::kPdBytes);
    output(i);
    __syncthreads();  // item i's slot is free
    issue(i + 2);
  }
  if (n_items == 0) {
    for (int pass = 0; pass < p.passes; ++pass) store(pass);  // no streamed tile: zeros
  }
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 1) flash_bwd_dq_dcluster_kernel(const Params p) {
  dcluster_body<T, false>(p);
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 1) flash_bwd_dkv_dcluster_kernel(const Params p) {
  dcluster_body<T, true>(p);
}

// the dQ or the dK/dV kernel of T
template <typename T, bool kDkv>
auto kernel_of() {
  if constexpr (kDkv) {
    return flash_bwd_dkv_dcluster_kernel<T>;
  } else {
    return flash_bwd_dq_dcluster_kernel<T>;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T, bool kDkv>
int smem_attribute() {
  return (int)cudaFuncSetAttribute(kernel_of<T, kDkv>(),
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Layout<T, kDkv>::kBytes);
}


template <typename T, bool kDkv>
int launch(const Params& all, cudaStream_t stream) {
  const int err = smem_attribute<T, kDkv>();
  if (err != 0) return err;
  Params p = all;
  const Plan plan = make_plan(p.d);
  if (plan.cluster < 1 || plan.cluster > kMaxCluster) return kUnsupported;
  p.passes = plan.passes;
  p.cluster = plan.cluster;
  p.n_tiles = ((kDkv ? p.t_kv : p.t_q) + kRows - 1) / kRows;
  const size_t ld = (size_t)p.d * sizeof(T);
  // the streamed side of one head (Q and dO for dK/dV, K and V for dQ)
  const long long head_bytes = 2ll * (long long)ld * (kDkv ? p.t_q : p.t_kv);
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
    ClusterConfig cc((unsigned)((long long)heads * p.n_tiles * p.cluster), p.cluster,
                     Layout<T, kDkv>::kBytes, stream);
    const cudaError_t e = cudaLaunchKernelEx(&cc.cfg, kernel_of<T, kDkv>(), c);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  });
}

template <typename T, bool kDkv>
int max_clusters(int cluster) {
  if (cluster < 1 || cluster > kMaxCluster || smem_attribute<T, kDkv>() != 0) return -1;
  ClusterConfig cc((unsigned)cluster, cluster, Layout<T, kDkv>::kBytes, nullptr);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, kernel_of<T, kDkv>(), &cc.cfg);
  return err == cudaSuccess ? n : -1;
}


int dispatch(bool dkv, const Params& p, int dtype, void* stream) {
  if (p.bh <= 0 || p.t_q <= 0 || p.t_kv <= 0 || p.d <= 0 || p.d % 128 != 0) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, kUnsupported, [&](auto t) {
    using T = decltype(t);
    return dkv ? launch<T, true>(p, st) : launch<T, false>(p, st);
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

extern "C" int ray_tpu_flash_bwd_dq_dcluster(const void* q, const void* k, const void* v,
                                             const void* dout, const void* lse,
                                             const void* delta, void* dq, int bh, int t_q,
                                             int t_kv, int d, int dtype, int causal, float scale,
                                             void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, bh, t_q, t_kv, d, causal, scale);
  p.dq = dq;
  return dispatch(false, p, dtype, stream);
}

extern "C" int ray_tpu_flash_bwd_dkv_dcluster(const void* q, const void* k, const void* v,
                                              const void* dout, const void* lse,
                                              const void* delta, void* dk, void* dv, int bh,
                                              int t_q, int t_kv, int d, int dtype, int causal,
                                              float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, bh, t_q, t_kv, d, causal, scale);
  p.dk = dk;
  p.dv = dv;
  return dispatch(true, p, dtype, stream);
}

extern "C" int ray_tpu_flash_bwd_dcluster_plan(int d, int dtype, int* out) {
  if (d <= 0 || d % 128 != 0) return kUnsupported;
  return with_dtype(dtype, kUnsupported, [&](auto t) {
    const Plan plan = make_plan(d);
    out[0] = kGroupCols;
    out[1] = plan.cluster;
    out[2] = plan.passes;
    out[3] = Layout<decltype(t), false>::kBytes;
    out[4] = Layout<decltype(t), true>::kBytes;
    return 0;
  });
}

extern "C" int ray_tpu_flash_bwd_dcluster_smem_bytes(int dtype, int dkv) {
  return with_dtype(dtype, -1, [&](auto t) {
    using T = decltype(t);
    return dkv ? Layout<T, true>::kBytes : Layout<T, false>::kBytes;
  });
}

extern "C" int ray_tpu_flash_bwd_dcluster_max_clusters(int dtype, int dkv, int cluster) {
  return with_dtype(dtype, -1, [&](auto t) {
    using T = decltype(t);
    return dkv ? max_clusters<T, true>(cluster) : max_clusters<T, false>(cluster);
  });
}

extern "C" const char* ray_tpu_flash_bwd_dcluster_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype, shape or cluster";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
