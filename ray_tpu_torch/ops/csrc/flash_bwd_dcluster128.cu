// Flash-attention backward for Hopper (sm_90a) in float32 at head_dims 384,
// 512, 640 and 768 (it builds for every multiple of 128 up to 1024, d a
// runtime argument): design "dcluster128", the output's columns split over
// the CTAs of a thread-block cluster in groups of 128, the resident side's
// operands split into TF32 big and small once. Hand-written CUDA C++.
//
// Replaces the two TPU kernels of ray_tpu/ops/attention.py launched by
// _flash_attention_tpu_bwd, in float32 at head_dims 384 to 768 (BWD_DESIGNS
// in ops/attention.py):
//   * _flash_bwd_dq_kernel  -> flash_bwd_dq_dcluster128_kernel  (dQ);
//   * _flash_bwd_dkv_kernel -> flash_bwd_dkv_dcluster128_kernel (dK and dV),
// one body (dcluster128_body<kDkv>). The arithmetic and its conventions are
// flash_bwd_dcluster.cu's: P = exp(scale * Q K^T - lse) from the forward's
// row lse, dP = dO V^T, dS = P * (dP - delta) with delta = rowsum(dO * O)
// from the caller, dQ = scale * dS K, dK = scale * dS^T Q and dV = P^T dO,
// the scale in the epilogues; a masked score gives P = 0, q rows are the
// suffix of the kv context under the causal mask, tiles wholly above the
// diagonal are skipped, where causal and t_q > t_kv a row whose lse is at
// most NEG_INF / 2 gets P = 0, and padded rows of a ragged tile are zeros.
// flash_attention_bwd_plain is the same arithmetic in float32.
//
// What bounds them on an H100: the operations, 6 * d per visible (q, k) pair
// for dQ and 8 * d for dK/dV, at 164.9 TFLOP/s (3xTF32: a third of dense
// TF32), with q, k, v, dO, lse, delta and the gradients read or written
// once. The design before (tf32x3, flash_bwd_f32.cu) cut each 16 rows into
// d / 128 warps that summed their partial S and dP through shared memory
// under a named barrier every 8 or 16 streamed rows, ran 5 to 12 warps an SM
// and split every operand into big and small at every fragment load. The
// dcluster design from 896 up (flash_bwd_dcluster.cu, 256-column groups)
// also splits at every load: its [16 x 16] warp pieces of S and dP load and
// split each resident element twice an item.
//
// Design. As dcluster: the C = d / 128 CTAs that share one resident tile
// (32 q rows for dQ, 32 kv rows for dK/dV) form a cluster, launched with
// cudaLaunchKernelEx and a cluster dimension; CTA c owns columns [128 c,
// 128 c + 128), computes the partial S and dP over them, and pushes each
// position by st.async to the CTA that reduces it (CTA r reduces positions
// r ceil(256 / C) on), which sums the partials in column order, makes P and
// dS there and pushes them to every CTA; each CTA then updates its own 128
// output columns. One pass (d <= 8 x 128). No atomics: a second run is
// bit-equal. Per item (a streamed tile of 32 rows) what differs:
//   1. the resident rows are split once, when they are loaded: each warp
//      keeps its part of the resident side in registers as 3xTF32 fragments
//      (64 registers), read from global memory once;
//   2. a warp computes a [16 x 32] piece of S or dP over 64 of the CTA's
//      128 columns (warp = product, resident row block, column half)
//      against those registers, so no resident element is loaded or split
//      an item; the two column halves are pushed as two sources, so the
//      reducer sums 2 C partials in column order;
//   3. the output products: dQ 8 warps of [32 x 16], dK/dV 8 warps of
//      [32 x 32] (four on dV, four on dK), each 8-row step's three products
//      in fresh registers (no chain of dependent products longer than
//      three);
//   4. the streamed tiles come through a ring of three raw stages, and the
//      block barrier that publishes item i + 1's slot comes before item i's
//      reduce, so that only the warps holding reducing threads wait for the
//      peers' partials. (A ninth warp that reduces beside the products read
//      slower: nine warps cap a thread at 168 registers, PERF.md.)
// The streamed operands are split where they are loaded. Splitting them
// once too, where they land (kSplitStreamed: each thread splits the pieces
// it copied into a big and a small plane), read slower on the card: every
// B fragment then loads two planes, and the ring holds two stages
// (PERF.md). kSplitResident = false (a probe of ops/flash_bwd_variants.py)
// keeps the resident fragments raw and splits them at each use.
//
// The reckoning, in bytes of shared memory: a plane is 32 rows of 128
// floats, 16384, its 16-byte pieces XOR-swizzled by the row's low three bits
// (column c of row r at r * 128 + (c ^ 4 (r % 8))), so the fragment loads of
// both the NT products (S, dP: rows g, columns tq) and the NN ones (rows
// 2 tq, columns g) touch 32 distinct banks with no padding.
//   * streamed: the two tiles of the other side (K, V or Q, dO), 32768 a
//     stage, three stages: 98304 (kSplitStreamed: two planes a tile, two
//     stages, 131072);
//   * resident: none (registers);
//   * exchange: two receive buffers of the positions a CTA reduces, 2 C
//     sources x 2 products x ceil(256 / C) float4, at most 16832 bytes each;
//     two of P and dS [32 x 32] float32 (dQ: dS only), 8192 (4096) each; the
//     resident rows' lse and delta (dQ): 256; four mbarriers.
//   148384 bytes for dK/dV and 140448 for dQ (181152 and 173216 split) of
//   the 232448 a block may use: one CTA an SM (255 and 243 registers a
//   thread), 256 threads. The resident pair split in shared memory beside
//   the split ring would need another 65536 and pass the limit by 14240
//   bytes.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_bwd_dq_dcluster128(q, k, v, dout, lse, delta, dq,
//                                        bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dkv_dcluster128(q, k, v, dout, lse, delta, dk, dv,
//                                         bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dcluster128_plan(d, dtype, int out[5])
//       (group columns, CTAs a cluster, passes, dQ's and dK/dV's dynamic
//       shared memory)
//   int ray_tpu_flash_bwd_dcluster128_smem_bytes(dkv)
//   int ray_tpu_flash_bwd_dcluster128_max_clusters(dkv, cluster)
// q/dout/dq are [bh, t_q, d], k/v/dk/dv [bh, t_kv, d], contiguous float32
// (dtype 1 only), d a multiple of 128 from 128 to 1024, 16-byte aligned; lse
// and delta [bh, t_q] float32. The grid is (heads of a launch) x resident
// tiles x C on grid.x, at most 2^31 - 1, in clusters of C CTAs: each entry
// launches as many times as that takes, on `stream`, allocates nothing, and
// returns the launch's status, or kUnsupported for what it does not take.

#include "dcluster.cuh"

namespace {

constexpr int kCols = 128;   // a CTA's columns of d
constexpr int kRows = 32;    // rows of the resident tile and of a streamed tile
// where the operands are split into TF32 big and small once: the resident
// side's fragments in registers (as built); the streamed tiles in shared
// memory planes (a probe: off as built, since the second plane's loads cost
// more than the splits they save)
constexpr bool kSplitResident = true;
constexpr bool kSplitStreamed = false;
// stages of the streamed ring: three raw ones, or two split ones (which
// fill shared memory)
constexpr int kStages = kSplitStreamed ? 2 : 3;

constexpr int kPlane = kRows * kCols * 4;  // a plane of a tile: 16384 bytes
// a tile: one raw plane, or (kSplitStreamed) the big plane, then the small
constexpr int kTile = (kSplitStreamed ? 2 : 1) * kPlane;
constexpr int kRawAt = kTile - kPlane;     // where a tile lands raw
constexpr int kSlot = 2 * kTile;           // a stage: Y0 and Y1

// Shared memory, in bytes from the start
template <bool kDkv>
struct Layout {
  static constexpr int kRing = 0;  // the streamed side, kStages slots
  // a CTA's share of the positions' partials from every source (a CTA's
  // column half): [source][S, dP][share] float4, share = ceil(256 / C)
  static constexpr int kRecv = kRing + kStages * kSlot;
  static constexpr int kRecvBytes = 2 * 2 * (256 + kMaxCluster - 1) * 16;
  static constexpr int kPd = kRecv + 2 * kRecvBytes;    // [P, dS] (dQ: dS), 256 float4 each
  static constexpr int kPdBytes = (kDkv ? 2 : 1) * 256 * 16;
  static constexpr int kRowStats = kPd + 2 * kPdBytes;  // dQ: the resident rows' lse, delta
  static constexpr int kBars = kRowStats + (kDkv ? 0 : 2 * kRows * 4);  // the mbarriers
  static constexpr int kBytes = kBars + 4 * 8;
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block may use");
};

struct Params {
  const float* q;
  const float* k;
  const float* v;
  const float* dout;
  const float* lse;
  const float* delta;
  float* dq;
  float* dk;
  float* dv;
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

// the 16-byte pieces of a tile that thread t copies and splits: t + 256 k
// for k < 4 (32 pieces a row), at their swizzled place in a plane
__device__ __forceinline__ int piece_offset(int k) {
  const int c = (int)threadIdx.x + k * kClusterThreads;
  const int r = c >> 5, piece = c & 31;
  return r * kCols * 4 + ((piece ^ (r & 7)) << 4);
}

// Rows [row0, row0 + 32) of a matrix of `rows` rows, `ld` bytes apart (src
// the first byte of the CTA's columns), raw into the tile at `tile` (its
// small plane where kSplitStreamed), by cp.async: zeros past `rows`. The
// caller commits the group.
__device__ __forceinline__ void load_raw(uint32_t tile, const char* src, size_t ld, int row0,
                                         int rows) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int c = (int)threadIdx.x + k * kClusterThreads;
    const int r = c >> 5, piece = c & 31;
    const bool ok = row0 + r < rows;
    cp_async_16(tile + kRawAt + piece_offset(k),
                src + (size_t)(ok ? row0 + r : 0) * ld + piece * 16, ok ? 16 : 0);
  }
}

// The pieces this thread copied into the tile at `tile`, split: big into the
// big plane, small over the raw. Only the copying thread touches them, so
// its own wait for its copies is enough before, and a block barrier after.
// (A template, so that a build without kSplitStreamed does not instantiate
// it.)
template <int = 0>
__device__ __forceinline__ void split_own(uint8_t* tile) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int at = piece_offset(k);
    const float4 x = *reinterpret_cast<const float4*>(tile + kPlane + at);
    uint4 big, small;
    split(x.x, big.x, small.x);
    split(x.y, big.y, small.y);
    split(x.z, big.z, small.z);
    split(x.w, big.w, small.w);
    *reinterpret_cast<uint4*>(tile + at) = big;
    *reinterpret_cast<uint4*>(tile + kPlane + at) = small;
  }
}

// One operand of a B fragment at float index `at` of the tile at `y`: the
// raw value split here, or (kSplitStreamed) the two plain loads of its big
// and small planes
__device__ __forceinline__ void load_b(const uint32_t* y, int at, uint32_t& big,
                                       uint32_t& small) {
  if constexpr (kSplitStreamed) {
    big = y[at];
    small = y[kPlane / 4 + at];
  } else {
    split(__uint_as_float(y[at]), big, small);
  }
}

// A warp's resident A operand of S or dP: 8 k-steps of 3xTF32 fragments,
// split once (kSplitResident) or kept raw and split at each use
struct Resident {
  FragA frag[kSplitResident ? 8 : 1];
  float raw[kSplitResident ? 1 : 8][4];

  __device__ __forceinline__ void fragment(int ks, FragA& f) const {
    if constexpr (kSplitResident) {
      f = frag[ks];
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) split(raw[ks][e], f.big[e], f.small[e]);
    }
  }
};

// ---------------------------------------------------------------------------
// the kernels: dQ (kDkv false) or dK/dV (kDkv true), one body
// ---------------------------------------------------------------------------

template <bool kDkv>
__device__ __forceinline__ void dcluster128_body(const Params& p) {
  using L = Layout<kDkv>;
  constexpr int kOut = kDkv ? 32 : 16;  // output columns a warp owns, all 32 rows
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int rank = (int)cluster_ctarank();  // the CTA's columns
  int bh, tile;
  slot_head_tile(blockIdx.x / p.cluster, p.bh, p.n_tiles, p.l2, &bh, &tile);  // a cluster a slot
  const size_t ld = (size_t)p.d * 4;
  const float* q = p.q + (size_t)bh * p.t_q * p.d;
  const float* dout = p.dout + (size_t)bh * p.t_q * p.d;
  const float* k = p.k + (size_t)bh * p.t_kv * p.d;
  const float* v = p.v + (size_t)bh * p.t_kv * p.d;
  const float* lse = p.lse + (size_t)bh * p.t_q;
  const float* delta = p.delta + (size_t)bh * p.t_q;
  // the resident side (X0, X1: rows t_x) and the streamed one (Y0, Y1:
  // rows t_y); S (or S^T) = X0 Y0^T, dP (or dP^T) = X1 Y1^T
  const float* const x0 = kDkv ? k : q;
  const float* const x1 = kDkv ? v : dout;
  const float* const y0p = kDkv ? q : k;
  const float* const y1p = kDkv ? dout : v;
  const int t_x = kDkv ? p.t_kv : p.t_q, t_y = kDkv ? p.t_q : p.t_kv;

  // the resident rows and the streamed tiles they run: the causal skip as
  // loop bounds (dQ: the heaviest q tiles first; dK/dV: kv tile 0 first,
  // from the first q tile that sees its first key)
  const int n_y = (t_y + kRows - 1) / kRows;
  int r0, first = 0, n_items;
  if constexpr (kDkv) {
    r0 = tile * kRows;
    if (p.causal) {
      const int q_first = r0 - p.off;
      first = q_first <= 0 ? 0 : (q_first >= p.t_q ? n_y : q_first / kRows);
    }
    n_items = n_y - first;
  } else {
    r0 = (p.n_tiles - 1 - tile) * kRows;
    const int last = min(r0 + kRows, p.t_q) - 1 + p.off;
    n_items = !p.causal ? n_y : (last < 0 ? 0 : min(n_y, last / kRows + 1));
  }
  const int own0 = rank * kCols;  // the CTA's columns [own0, own0 + 128)
  auto first_row = [&](int i) { return (first + i) * kRows; };  // item i's streamed rows

  // The exchange, as flash_bwd_dcluster.cu's: pushed by st.async, each 16
  // bytes completing on the receiver's mbarrier; a CTA's partials (two
  // sources, its column halves) go to the CTA that reduces each position
  // (its receive buffer i % 2), P and dS from there to every CTA (its P and
  // dS buffer i % 2).
  const int share = (256 + p.cluster - 1) / p.cluster;  // positions a CTA reduces
  const int n_share = min(share, 256 - rank * share);
  const uint32_t recv_bytes = (uint32_t)(2 * p.cluster * 2 * n_share * 16);
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
  // the streamed tiles of item i (the CTA's columns of Y0 and Y1) raw into
  // slot i % kStages, by cp.async
  auto slot = [&](int i) { return smem + L::kRing + (i % kStages) * kSlot; };
  auto issue = [&](int i) {
    if (i < n_items) {
      const uint32_t dst = smem_u32(slot(i));
      load_raw(dst, reinterpret_cast<const char*>(y0p + own0), ld, first_row(i), t_y);
      load_raw(dst + kTile, reinterpret_cast<const char*>(y1p + own0), ld, first_row(i), t_y);
    }
    cp_async_commit();
  };
  auto split_item = [&](int i) {
    if constexpr (kSplitStreamed) {
      split_own(slot(i));
      split_own(slot(i) + kTile);
    }
  };
  for (int i = 0; i < kStages; ++i) issue(i);

  // step 1's roles: the warp's product `prod` (0: S, 1: dP) on resident rows
  // 16 prb, over the CTA's columns 64 kh to 64 kh + 63, against all 32
  // streamed rows
  const int prod = warp >> 2, prb = (warp >> 1) & 1, kh = warp & 1;
  // the warp's resident A fragments, read from global memory once: rows
  // r0 + 16 prb + g (+ 8), columns own0 + 64 kh + 8 ks + tq (+ 4); zeros
  // past t_x
  Resident xa;
  {
    const int ra = r0 + 16 * prb + g;
    const float* xp = (prod ? x1 : x0) + own0 + 64 * kh + tq;
    const bool ok0 = ra < t_x, ok1 = ra + 8 < t_x;
    const float* x_lo = xp + (size_t)(ok0 ? ra : 0) * p.d;
    const float* x_hi = xp + (size_t)(ok1 ? ra + 8 : 0) * p.d;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const float e[4] = {ok0 ? x_lo[8 * ks] : 0.f, ok1 ? x_hi[8 * ks] : 0.f,
                          ok0 ? x_lo[8 * ks + 4] : 0.f, ok1 ? x_hi[8 * ks + 4] : 0.f};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if constexpr (kSplitResident) {
          split(e[j], xa.frag[ks].big[j], xa.frag[ks].small[j]);
        } else {
          xa.raw[ks][j] = e[j];
        }
      }
    }
  }
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

  // step 1 of item i: the warp's [16 x 32] piece of S or dP over its 64
  // columns, pushed to the CTAs that reduce its positions as source
  // 2 rank + kh (the sources in column order)
  // the swizzled column of k-step j of each 32-column block, for rows g
  int lo[4], hi[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    lo[j] = (8 * j + tq) ^ (g << 2);
    hi[j] = (8 * j + tq + 4) ^ (g << 2);
  }
  const int src = 2 * rank + kh;
  auto partial = [&](int i) {
    float s[16];
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = 0.f;
    const uint32_t* y = reinterpret_cast<const uint32_t*>(slot(i) + prod * kTile) +
                        g * kCols + 64 * kh;
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) {
      const int blk = 32 * (ks >> 2), j = ks & 3;
      FragA fa;
      xa.fragment(ks, fa);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        FragB fb;
        load_b(y, 8 * nt * kCols + blk + lo[j], fb.big[0], fb.small[0]);
        load_b(y, 8 * nt * kCols + blk + hi[j], fb.big[1], fb.small[1]);
        mma3_add(s + 4 * nt, fa, fb);
      }
    }
    const uint32_t recv = smem_u32(smem + L::kRecv + (i & 1) * L::kRecvBytes);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int pos = (prb * 4 + nt) * 32 + lane;  // [rb][n-tile][lane]
      const int to = pos / share, j = pos - to * share;
      const uint32_t at = recv + ((src * 2 + prod) * share + j) * 16;
      st_async(map_cluster(at, to),
               make_float4(s[4 * nt], s[4 * nt + 1], s[4 * nt + 2], s[4 * nt + 3]),
               map_cluster(recv_bar(i), to));
    }
  };

  // step 2 of item i: this CTA's share of the [32 x 32] positions (a float4
  // of S and one of dP each, in the accumulator layout: resident row 16 rb +
  // g (+ 8), streamed row 8 nt + 2 tq (+ 1)), one a thread, once every
  // source's partials of them are in: summed in column order, P and dS made
  // and pushed to every CTA
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
    for (int c = 0; c < 2 * kMaxCluster; ++c) {  // in column order
      if (c < 2 * p.cluster) {
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

  // step 3 of item i, once P and dS are in: the warp's output, all 32 rows
  // of the resident tile and kOut columns of the CTA's: dQ columns 16 ocol;
  // dK/dV: dV (which 0, from P^T and dO) or dK (which 1, from dS^T and Q),
  // columns 32 ocol; stored after the last item
  const int which = kDkv ? warp >> 2 : 1;
  const int ocol = kDkv ? warp & 3 : warp;
  // B's rows 8 kk + 2 tq and + 1 (the permuted k index), column ocol kOut +
  // 8 nt + g: its swizzled place in each row
  int col0[kOut / 8], col1[kOut / 8];
#pragma unroll
  for (int nt = 0; nt < kOut / 8; ++nt) {
    const int c = ocol * kOut + 8 * nt + g;
    col0[nt] = c ^ (tq << 3);
    col1[nt] = c ^ ((tq << 3) + 4);
  }
  float acc[kOut];  // rows 0-15, then rows 16-31
#pragma unroll
  for (int e = 0; e < kOut; ++e) acc[e] = 0.f;
  auto store = [&]() {
    const int oc0 = own0 + ocol * kOut;  // the warp's first column
    const float mul[2] = {which ? p.scale : 1.f, which ? p.scale : 1.f};
    float* out = kDkv ? (which ? p.dk : p.dv) : p.dq;
    const int t_out = kDkv ? p.t_kv : p.t_q;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      store_group<float, kOut>(out + (size_t)bh * t_out * p.d + oc0, p.d, acc + m * kOut / 2,
                               mul, r0 + 16 * m, t_out, kOut, g, tq);
    }
  };
  auto output = [&](int i) {
    const float4* in = reinterpret_cast<const float4*>(smem + L::kPd + (i & 1) * L::kPdBytes) +
                       (kDkv ? which * 256 : 0) + lane;
    FragA fa[2][4];  // P^T or dS, [32 x 32], as two accumulators split once
    {
      float a[32];
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {  // rows 16 (nt / 4), n-tile nt % 4
        const float4 f = in[32 * nt];
        a[4 * nt] = f.x;
        a[4 * nt + 1] = f.y;
        a[4 * nt + 2] = f.z;
        a[4 * nt + 3] = f.w;
      }
#pragma unroll
      for (int m = 0; m < 2; ++m) {
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a(fa[m][kk], a + 16 * m + 4 * kk);
      }
    }
    // dQ += dS K; dV += P^T dO; dK += dS^T Q, over the CTA's columns;
    // each 8-row step's three products in fresh registers, added in
    // float32, so that no chain of dependent products is longer than three
    const uint32_t* y = reinterpret_cast<const uint32_t*>(
                            slot(i) + (kDkv && which == 0 ? kTile : 0)) + 2 * tq * kCols;
#pragma unroll
    for (int nt = 0; nt < kOut / 8; ++nt) {
      // B's loads hoisted at most two n-tiles ahead, as flash_bwd_dcluster.cu
      if (nt % 2 == 0) asm volatile("" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        FragB fb;
        load_b(y, 8 * kk * kCols + col0[nt], fb.big[0], fb.small[0]);
        load_b(y, (8 * kk + 1) * kCols + col1[nt], fb.big[1], fb.small[1]);
        mma3_add(acc + 4 * nt, fa[0][kk], fb);
        mma3_add(acc + kOut / 2 + 4 * nt, fa[1][kk], fb);
      }
    }
  };

  // The pipeline, as flash_bwd_dcluster.cu's: item i + 1's partials are
  // pushed before item i's output, both exchange buffers are double, and
  // the mbarriers are armed for item i + 2 once item i's phase is seen
  // complete; a CTA exits once P and dS of its last item are in. What
  // differs: the streamed ring runs kStages items ahead, and the block
  // barrier that publishes item i + 1's slot comes before item i's reduce,
  // so that only the warps that hold reducing threads wait for the peers'
  // partials before partial(i + 1). Where kSplitStreamed, every thread
  // splits the pieces it copied into a slot after its own wait for them,
  // and that barrier publishes both planes.
  if (n_items > 0) {
    cp_async_wait<kStages - 1>();  // item 0
    split_item(0);
    __syncthreads();
    partial(0);
  }
#pragma unroll 1
  for (int i = 0; i < n_items; ++i) {
    stats(i);
    if (i + 1 < n_items) {
      cp_async_wait<kStages - 2>();  // item i + 1 has landed
      split_item(i + 1);
      __syncthreads();
    }
    reduce(i);
    if (i + 1 < n_items) partial(i + 1);
    mbar_wait(pd_bar(i), (i >> 1) & 1);  // P and dS of item i are in
    if (threadIdx.x == 0 && i + 2 < n_items) mbar_arrive_expect_tx(pd_bar(i), L::kPdBytes);
    output(i);
    __syncthreads();  // item i's slot is free
    issue(i + kStages);
  }
  store();  // no streamed tile: zeros
}

__global__ void __launch_bounds__(kClusterThreads, 1)
    flash_bwd_dq_dcluster128_kernel(const Params p) {
  dcluster128_body<false>(p);
}

__global__ void __launch_bounds__(kClusterThreads, 1)
    flash_bwd_dkv_dcluster128_kernel(const Params p) {
  dcluster128_body<true>(p);
}

// the dQ or the dK/dV kernel
template <bool kDkv>
auto kernel_of() {
  if constexpr (kDkv) {
    return flash_bwd_dkv_dcluster128_kernel;
  } else {
    return flash_bwd_dq_dcluster128_kernel;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <bool kDkv>
int smem_attribute() {
  return (int)cudaFuncSetAttribute(kernel_of<kDkv>(), cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Layout<kDkv>::kBytes);
}

// the plan's CTAs a cluster at head_dim d, 0 where d is none it takes
int cluster_of(int d) {
  return d > 0 && d % kCols == 0 && d / kCols <= kMaxCluster ? d / kCols : 0;
}

template <bool kDkv>
int launch(const Params& all, cudaStream_t stream) {
  const int err = smem_attribute<kDkv>();
  if (err != 0) return err;
  Params p = all;
  p.cluster = cluster_of(p.d);
  p.n_tiles = ((kDkv ? p.t_kv : p.t_q) + kRows - 1) / kRows;
  const size_t ld = (size_t)p.d * 4;
  // the streamed side of one head (Q and dO for dK/dV, K and V for dQ)
  const long long head_bytes = 2ll * (long long)ld * (kDkv ? p.t_q : p.t_kv);
  return launch_heads(p.bh, (long long)p.n_tiles * p.cluster, [&](int h0, int heads) {
    Params c = p;
    const size_t qs = (size_t)h0 * p.t_q * p.d, ks = (size_t)h0 * p.t_kv * p.d;
    c.q = p.q + qs;
    c.dout = p.dout + qs;
    c.k = p.k + ks;
    c.v = p.v + ks;
    c.lse = p.lse + (size_t)h0 * p.t_q;
    c.delta = p.delta + (size_t)h0 * p.t_q;
    c.bh = heads;
    c.l2 = l2_group(head_bytes, heads);
    if (kDkv) {
      c.dk = p.dk + ks;
      c.dv = p.dv + ks;
    } else {
      c.dq = p.dq + qs;
    }
    ClusterConfig cc((unsigned)((long long)heads * p.n_tiles * p.cluster), p.cluster,
                     Layout<kDkv>::kBytes, stream);
    const cudaError_t e = cudaLaunchKernelEx(&cc.cfg, kernel_of<kDkv>(), c);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  });
}

template <bool kDkv>
int max_clusters(int cluster) {
  if (cluster < 1 || cluster > kMaxCluster || smem_attribute<kDkv>() != 0) return -1;
  ClusterConfig cc((unsigned)cluster, cluster, Layout<kDkv>::kBytes, nullptr);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, kernel_of<kDkv>(), &cc.cfg);
  return err == cudaSuccess ? n : -1;
}

int dispatch(bool dkv, const Params& p, int dtype, void* stream) {
  if (dtype != 1 || p.bh <= 0 || p.t_q <= 0 || p.t_kv <= 0 || cluster_of(p.d) == 0) {
    return kUnsupported;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dkv ? launch<true>(p, st) : launch<false>(p, st);
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, int bh, int t_q, int t_kv, int d,
                   int causal, float scale) {
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
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

extern "C" int ray_tpu_flash_bwd_dq_dcluster128(const void* q, const void* k, const void* v,
                                                const void* dout, const void* lse,
                                                const void* delta, void* dq, int bh, int t_q,
                                                int t_kv, int d, int dtype, int causal,
                                                float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, bh, t_q, t_kv, d, causal, scale);
  p.dq = static_cast<float*>(dq);
  return dispatch(false, p, dtype, stream);
}

extern "C" int ray_tpu_flash_bwd_dkv_dcluster128(const void* q, const void* k, const void* v,
                                                 const void* dout, const void* lse,
                                                 const void* delta, void* dk, void* dv, int bh,
                                                 int t_q, int t_kv, int d, int dtype, int causal,
                                                 float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, bh, t_q, t_kv, d, causal, scale);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  return dispatch(true, p, dtype, stream);
}

extern "C" int ray_tpu_flash_bwd_dcluster128_plan(int d, int dtype, int* out) {
  if (dtype != 1 || cluster_of(d) == 0) return kUnsupported;
  out[0] = kCols;
  out[1] = cluster_of(d);
  out[2] = 1;
  out[3] = Layout<false>::kBytes;
  out[4] = Layout<true>::kBytes;
  return 0;
}

extern "C" int ray_tpu_flash_bwd_dcluster128_smem_bytes(int dkv) {
  return dkv ? Layout<true>::kBytes : Layout<false>::kBytes;
}

extern "C" int ray_tpu_flash_bwd_dcluster128_max_clusters(int dkv, int cluster) {
  return dkv ? max_clusters<true>(cluster) : max_clusters<false>(cluster);
}

extern "C" const char* ray_tpu_flash_bwd_dcluster128_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
