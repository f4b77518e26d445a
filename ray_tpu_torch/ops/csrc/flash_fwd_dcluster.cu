// Flash-attention forward for Hopper (sm_90a) at every head_dim that is a
// multiple of 128, d a runtime argument, in bf16, float16 and float32 (the
// kernel's T): design "dcluster", the output's columns split over the CTAs
// of a thread-block cluster that compute S once between them. Hand-written
// CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_attention_tpu) at head_dim 896 and up, where the
// reference's dispatcher runs it (a multiple of 128, both lengths multiples
// of 8) and the dispatch table in ops/attention.py (FWD_DESIGNS, by its rule
// DSPLIT_MIN_D) names this design. It computes O = softmax(scale * Q K^T) V
// in T and the row logsumexp in float32 with the TPU kernel's conventions
// (flash_fwd_wgmma.cu's header lists them) at this design's tiles, 64 q rows
// by 32 kv rows (the reference's block_q = min(64, t_q), block_k = min(32,
// t_kv)); flash_attention_fwd_plain in ops/attention.py is the same
// algorithm at the same tiles, so a row that sees no key gets what the
// reference's kernel gives it at these tiles: 0 and NEG_INF where its q tile
// skips every kv tile, the mean of V over the processed tiles' valid rows
// where its q tile runs some.
//
// What bounds it on an H100: the operations, 4 * d per visible (q, k) pair,
// at 989 TFLOP/s in bf16 and float16 and 494.7 / 3 = 164.9 TFLOP/s in
// float32 (3xTF32), with q, k, v and o read or written once.
// flash_fwd_dsplit.cu (the design before, on no path now) gave each of the
// G = ceil(d / 256) column groups of a q tile its own CTA, every one of which
// recomputed S over all of d: (2 G + 2) d operations a visible pair, 2.5
// times the function's own at 896 and 1024 and 4.5 times at 2048, with Q's
// chunks read again from L2 for every kv tile.
//
// Design. The C CTAs of one (q tile, head) form a cluster (dcluster.cuh;
// the plan is ops/dcluster.py's dcluster_plan, which the wrapper checks
// against ray_tpu_flash_fwd_dcluster_plan): CTA c owns the columns of groups
// c P .. c P + P - 1, and at one pass (d up to 8 x 256 = 2048) its 64 rows of
// Q over those columns stay resident, loaded once. K and V of each 32-row kv
// tile stream over the CTA's columns only, through a two-stage cp.async
// ring. Per kv tile that the causal skip leaves (an item):
//   1. each CTA computes the partial S = Q_c K_c^T over its own columns, a
//      [16 x 16] piece a warp (8 warps cover the [64 x 32] tile), and pushes
//      each row's 32 partials, as 8 float4 "quads" (columns 16 p + 2 tq + {0,
//      1, 8, 9}), to the CTA that reduces the row: CTA r reduces rows r R ..
//      r R + R - 1, R = ceil(64 / C), whole rows;
//   2. the reducing CTA sums a row's C partials in group order 0 .. C - 1,
//      so S has one set of bits, and runs the masks and the online softmax
//      (running max m, sum l, rescale alpha) once for the row, 8 threads a
//      row, a quad each;
//   3. it pushes P and alpha (and, at the last kv tile, 1 / l) to every CTA
//      of the cluster: the cluster agrees on them bit for bit with no
//      further exchange;
//   4. each CTA rescales and updates only its own columns, O_c = alpha O_c +
//      P V_c, 8 warps of [32 x 64].
// That is 4 d operations a visible pair across the cluster, with no
// recompute, and Q read once. At the last kv tile the reducer of each row
// writes lse, and each CTA writes its own columns of O times 1 / l. Past
// 2048 (G > 8) each CTA writes one output group a pass: a pass runs the kv
// tiles again, S recomputed over the CTA's columns from Q and K in global
// memory (L2), since the CTA's P groups of Q do not fit in shared memory;
// the reducer restarts its softmax at each pass and gets the same bits.
// Every push is st.async, completing on the receiver's mbarrier, so the
// exchange needs no cluster barrier an item and runs behind the products:
// item i + 1's partials are pushed before item i's output. Receive and P
// buffers are double; the order that makes them safe is stated at the
// pipeline. No atomics and no split reduction across launches: a second run
// is bit-equal.
//
// The reckoning (float32; bf16 and float16 rows are 528 bytes, 136736 bytes
// in all): a float32 tile row of a group is 1024 bytes (256 floats,
// swizzled); a 32-row tile 32768 bytes.
//   * resident Q_c: 64 rows, 65536 bytes (at one pass);
//   * streamed K_c and V_c: 65536 bytes a stage, two stages: 131072;
//   * exchange: two receive buffers of a CTA's rows' partials from every
//     CTA, C ceil(64 / C) rows of 8 float4, at most 8960 bytes (C = 7)
//     each; two of P ([64 x 8] float4) and the rows' alpha and 1 / l (64
//     float2), 8704 bytes each; four mbarriers.
//   231968 bytes of the 232448 a block may use: one CTA an SM, 256 threads,
//   each thread's output slice [32 x 64] float32 (64 registers).
// Products on mma.sync: bf16 and float16 m16n8k16 fed by ldmatrix, float32
// 3xTF32 m16n8k8 with the operands split where they are loaded (dsplit.cuh,
// tf32_mma.cuh, dcluster.cuh).
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_fwd_dcluster(q, k, v, o, lse, bh, t_q, t_kv, d, dtype,
//                                  causal, scale, stream)
//   int ray_tpu_flash_fwd_dcluster_tiles(d, &block_q, &block_k)
//   int ray_tpu_flash_fwd_dcluster_plan(d, dtype, int out[4])
//       (group columns, CTAs a cluster, passes, dynamic shared memory)
//   int ray_tpu_flash_fwd_dcluster_smem_bytes(dtype)
//   int ray_tpu_flash_fwd_dcluster_max_clusters(dtype, cluster)
// q/o are [bh, t_q, d], k/v [bh, t_kv, d], contiguous bf16 (dtype 0),
// float32 (1) or float16 (2), d a positive multiple of 128, 16-byte aligned;
// lse [bh, t_q] float32; scale > 0 (the wrapper hands a non-positive one's
// sign to q). The grid is (heads of a launch) x q tiles x C on grid.x, at
// most 2^31 - 1, in clusters of C <= 8 CTAs: it launches as many times as
// that takes, on `stream`, allocates nothing, and returns the launch's
// status, or kUnsupported for what it does not take.

#include "dcluster.cuh"

namespace {

constexpr int kBlockQ = 64;  // q rows of a cluster's tile
constexpr int kBlockK = 32;  // kv rows of a streamed tile
constexpr int kStages = 2;
constexpr int kQuads = kBlockK / 4;  // float4s of a row of S or P

// the most rows' partials a CTA receives: C ceil(64 / C) over the cluster
// sizes
constexpr int max_recv_rows() {
  int most = 0;
  for (int c = 1; c <= kMaxCluster; ++c) {
    const int rows = c * ((kBlockQ + c - 1) / c);
    most = rows > most ? rows : most;
  }
  return most;
}

// Shared memory, in bytes from the start
template <typename T>
struct Layout {
  static constexpr int kG = kTileRow<T>;          // a tile row
  static constexpr int kKv = kBlockK * kG;          // a 32-row tile
  static constexpr int kQ = 0;                      // resident Q_c, 64 rows
  static constexpr int kRing = kBlockQ * kG;        // kStages slots of [K_c, V_g]
  static constexpr int kSlot = 2 * kKv;
  // a CTA's rows' partials from every CTA: [source][row][quad] float4
  static constexpr int kRecv = kRing + kStages * kSlot;
  static constexpr int kRecvBytes = max_recv_rows() * kQuads * 16;
  // P [row][quad] float4 (quads swizzled by the row's parity), then the rows'
  // (alpha, 1 / l) float2
  static constexpr int kP = kRecv + 2 * kRecvBytes;
  static constexpr int kPQuads = kBlockQ * kQuads * 16;
  static constexpr int kPBytes = kPQuads + kBlockQ * 8;
  static constexpr int kBars = kP + 2 * kPBytes;  // four mbarriers
  static constexpr int kBytes = kBars + 4 * 8;
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block may use");
  static_assert(kKv % 16 == 0 && kRecvBytes % 16 == 0, "16-byte aligned tiles");
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int bh;       // heads of this launch
  int n_tiles;  // q tiles per head
  int l2;       // heads per L2 group
  int passes;
  int cluster;
  int t_q;
  int t_kv;
  int d;
  int off;      // t_kv - t_q
  int bq_eff;   // min(block_q, t_q): the reference's block_q
  int bk_eff;   // min(block_k, t_kv): the reference's block_k
  int causal;
  float scale_log2;  // scale * log2(e)
};

// where quad `quad` of row `row` of P lies: the quads of odd rows swapped by
// halves, so that the 8 lanes of a phase of the output's float4 loads (rows
// g and g + 1, quads tq and 4 + tq) fall on distinct banks
__device__ __forceinline__ int p_at(int row, int quad) {
  return row * kQuads + (quad ^ ((row & 1) << 2));
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads, 1) flash_fwd_dcluster_kernel(const Params p) {
  using L = Layout<T>;
  constexpr int kG = L::kG;
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int rank = (int)cluster_ctarank();  // the CTA's columns
  int bh, tile;
  slot_head_tile(blockIdx.x / p.cluster, p.bh, p.n_tiles, p.l2, &bh, &tile);  // a cluster a slot
  const int q0 = (p.n_tiles - 1 - tile) * kBlockQ;  // the heaviest q tiles first
  const size_t ld = (size_t)p.d * sizeof(T);
  const char* q = static_cast<const char*>(p.q) + (size_t)bh * p.t_q * ld;
  const char* k = static_cast<const char*>(p.k) + (size_t)bh * p.t_kv * ld;
  const char* v = static_cast<const char*>(p.v) + (size_t)bh * p.t_kv * ld;

  // the kv tiles the q tile runs: the reference's causal skip ((qi * bq + bq
  // - 1 + off) < ki * bk skips tile ki) as a loop bound
  const int n_kv = (p.t_kv + kBlockK - 1) / kBlockK;
  int n_run = n_kv;
  if (p.causal) {
    const int last = q0 + p.bq_eff - 1 + p.off;
    n_run = last < 0 ? 0 : min(n_kv, last / kBlockK + 1);
  }
  // the CTA's columns [own0, own1): groups rank P .. rank P + P - 1
  const int own0 = rank * p.passes * kGroupCols;
  const int own1 = min(own0 + p.passes * kGroupCols, p.d);
  const int n_items = p.passes * n_run;  // a kv tile a pass

  // The exchange is pushed, by st.async, each store completing on the
  // receiver's mbarrier: a CTA's partials of each row go to the CTA that
  // reduces the row (its receive buffer i % 2), P and the row statistics
  // from there to every CTA (its P buffer i % 2). No cluster barrier an item.
  const int per = (kBlockQ + p.cluster - 1) / p.cluster;  // rows a CTA reduces, R
  const int n_rows = min(per, kBlockQ - rank * per);       // this CTA's (at least 1)
  const uint32_t recv_bytes = (uint32_t)(p.cluster * n_rows * kQuads * 16);
  const uint32_t p_bytes = L::kPBytes;  // P and the statistics of all 64 rows
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
      mbar_arrive_expect_tx(pd_bar(i), p_bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n_items > 0) cluster_sync();  // every peer's mbarriers are ready before the first push
  // item i's streamed tiles into slot i % 2, by cp.async: K over the CTA's
  // columns (at one pass; past it the partials read K from global memory)
  // and V over the pass's output group
  auto slot = [&](int i) { return smem + L::kRing + (i % kStages) * L::kSlot; };
  auto issue = [&](int i) {
    if (i < n_items) {
      const int row0 = i % n_run * kBlockK;
      const int c0 = own0 + i / n_run * kGroupCols;  // the pass's output group
      const uint32_t dst = smem_u32(slot(i));
      if (p.passes == 1) {
        load_tile<T, kBlockK>(dst, k + (size_t)own0 * sizeof(T), ld, row0, p.t_kv,
                              (own1 - own0) * (int)sizeof(T));
      }
      if (c0 < p.d) {
        load_tile<T, kBlockK>(dst + L::kKv, v + (size_t)c0 * sizeof(T), ld, row0, p.t_kv,
                              (min(c0 + kGroupCols, p.d) - c0) * (int)sizeof(T));
      }
    }
    cp_async_commit();
  };
  if (p.passes == 1 && n_items > 0) {  // the resident Q_c, with item 0
    load_tile<T, kBlockQ>(smem_u32(smem + L::kQ), q + (size_t)own0 * sizeof(T), ld, q0, p.t_q,
                          (own1 - own0) * (int)sizeof(T));
  }
  issue(0);
  issue(1);

  // step 1 of item i: the warp's [16 x 16] piece of the partial S (q rows 16
  // prb, kv columns 16 pnh), its two rows' quads pushed to their reducers
  const int prb = warp >> 1, pnh = warp & 1;
  auto partial = [&](int i) {
    float s[8];
#pragma unroll
    for (int e = 0; e < 8; ++e) s[e] = 0.f;
    if (p.passes == 1) {
      partial_smem<T>(s, smem + L::kQ + 16 * prb * kG, slot(i) + 16 * pnh * kG, own1 - own0,
                      lane);
    } else {
      partial_global<T>(s, reinterpret_cast<const T*>(q), q0 + 16 * prb, p.t_q,
                        reinterpret_cast<const T*>(k), i % n_run * kBlockK + 16 * pnh, p.t_kv,
                        p.d, own0, own1, lane);
    }
    const uint32_t base = smem_u32(smem + L::kRecv + (i & 1) * L::kRecvBytes);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the piece
      const int row = 16 * prb + g + 8 * h;
      const int to = row / per, lr = row - to * per;
      const uint32_t at = base + ((rank * per + lr) * kQuads + 4 * pnh + tq) * 16;
      st_async(map_cluster(at, to),
               make_float4(s[2 * h], s[2 * h + 1], s[4 + 2 * h], s[5 + 2 * h]),
               map_cluster(recv_bar(i), to));
    }
  };

  // steps 2 and 3 of item i: the CTA's rows, 8 threads a row (a quad each),
  // once every CTA's partials of them are in. The warps that hold reducing
  // threads run it whole (the row's shuffles), the others skip it.
  const bool reduces = (int)threadIdx.x < n_rows * kQuads;
  const bool reduce_warp = 32 * warp < n_rows * kQuads;
  const int rlr = reduces ? (int)threadIdx.x / kQuads : 0;  // the thread's row of the CTA's
  const int rquad = threadIdx.x % kQuads;
  const int rrow = rank * per + rlr;  // in the q tile
  const int rq = q0 + rrow;           // in q
  float m_run = kNegInf, l_run = 0.f;  // running max (log2 units), the quad's share of the sum
  auto reduce = [&](int i) {
    if (!reduce_warp) return;
    mbar_wait(recv_bar(i), (i >> 1) & 1);
    if (threadIdx.x == 0 && i + 2 < n_items) mbar_arrive_expect_tx(recv_bar(i), recv_bytes);
    const float4* in =
        reinterpret_cast<const float4*>(smem + L::kRecv + (i & 1) * L::kRecvBytes) +
        rlr * kQuads + rquad;
    float sx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int c = 0; c < kMaxCluster; ++c) {  // in group order
      if (c < p.cluster) {
        const float4 a = in[c * per * kQuads];
        sx[0] += a.x;
        sx[1] += a.y;
        sx[2] += a.z;
        sx[3] += a.w;
      }
    }
    const int j = i % n_run;
    if (j == 0) {  // a pass starts the row's softmax again
      m_run = kNegInf;
      l_run = 0.f;
    }
    // the online softmax in log2 units, as hopper.cuh's online_softmax: a
    // masked score is -inf; a row whose processed columns are all masked
    // keeps m at NEG_INF and takes p = 1 on each column of the reference's
    // tile
    const int k0 = j * kBlockK;
    float mx = -INFINITY;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = k0 + 16 * (rquad >> 2) + 8 * (e >> 1) + 2 * (rquad & 3) + (e & 1);
      if (col >= p.t_kv || (p.causal && rq + p.off < col)) sx[e] = -INFINITY;
      mx = fmaxf(mx, sx[e]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
    const float m_cur = mx == -INFINITY ? kNegInf : mx * p.scale_log2;
    const float m_new = fmaxf(m_run, m_cur);
    const float alpha = fast_exp2(m_run - m_new);
    m_run = m_new;
    const bool empty = m_new == kNegInf;  // no visible column so far
    float pe[4], rs = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      pe[e] = fast_exp2(fmaf(sx[e], p.scale_log2, -m_run));
      if (empty) {
        const int col = 16 * (rquad >> 2) + 8 * (e >> 1) + 2 * (rquad & 3) + (e & 1);
        pe[e] = col < p.bk_eff ? 1.f : 0.f;
      }
      rs += pe[e];
    }
    l_run = l_run * alpha + rs;
    float inv = 0.f;
    if (j == n_run - 1) {  // the pass's last kv tile: the row's sum and lse
      float sum = l_run + __shfl_xor_sync(0xffffffffu, l_run, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float denom = sum == 0.f ? 1.f : sum;
      inv = 1.f / denom;
      if (i < n_run && reduces && rquad == 0 && rq < p.t_q) {
        p.lse[(size_t)bh * p.t_q + rq] =
            m_run == kNegInf ? kNegInf + logf(denom) : (m_run + log2f(denom)) * kLn2;
      }
    }
    if (reduces) {
      const uint32_t buf = smem_u32(smem + L::kP + (i & 1) * L::kPBytes);
      const uint32_t out = buf + 16 * p_at(rrow, rquad);
      const uint32_t stat = buf + L::kPQuads + 8 * rrow;
      const float4 p4 = make_float4(pe[0], pe[1], pe[2], pe[3]);
#pragma unroll
      for (int c = 0; c < kMaxCluster; ++c) {
        if (c < p.cluster) {
          const uint32_t b = map_cluster(pd_bar(i), c);
          st_async(map_cluster(out, c), p4, b);
          if (rquad == 0) st_async(map_cluster(stat, c), make_float2(alpha, inv), b);
        }
      }
    }
  };

  // step 4 of item i, once P and the row statistics are in: the warp's
  // output, q rows 32 orb .. 32 orb + 31 and columns 64 ocol of the pass's
  // group; stored, times 1 / l, after the pass's last kv tile
  const int orb = warp >> 2, ocol = warp & 3;
  float acc[64];
#pragma unroll
  for (int e = 0; e < 64; ++e) acc[e] = 0.f;
  auto output = [&](int i) {
    const int pass = i / n_run;
    const int oc0 = own0 + pass * kGroupCols + ocol * 64;  // the warp's first column
    const uint8_t* buf = smem + L::kP + (i & 1) * L::kPBytes;
    const float4* pin = reinterpret_cast<const float4*>(buf);
    const float2* stat = reinterpret_cast<const float2*>(buf + L::kPQuads);
    float a[32];     // P, rows 0-15 and 16-31 of the warp's, as two accumulators
    float alpha[4];  // rows g, g + 8, 16 + g, 24 + g
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 32 * orb + 16 * m + g + 8 * h;
        alpha[2 * m + h] = stat[row].x;
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {  // quad (pp, tq): n-tiles 2 pp and 2 pp + 1
          const float4 f = pin[p_at(row, 4 * pp + tq)];
          a[16 * m + 8 * pp + 2 * h] = f.x;
          a[16 * m + 8 * pp + 2 * h + 1] = f.y;
          a[16 * m + 8 * pp + 4 + 2 * h] = f.z;
          a[16 * m + 8 * pp + 5 + 2 * h] = f.w;
        }
      }
    }
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[32 * m + e] *= alpha[2 * m + ((e >> 1) & 1)];
    }
    // O_g += P V_g. A group is a multiple of 128 columns wide, so a warp's
    // columns are all below d or none is
    if (oc0 < p.d) {
      rows32_nn<T, kG, 64>(acc, a, slot(i) + L::kKv + ocol * 64 * (int)sizeof(T), lane);
    }
    if (i % n_run == n_run - 1) {
      if (oc0 < p.d) {
#pragma unroll
        for (int m = 0; m < 2; ++m) {
          // 1 / l, read again: the buffer holds it until this CTA's partials
          // of item i + 2 are out
          const int row = 32 * orb + 16 * m + g;
          const float mul[2] = {stat[row].y, stat[row + 8].y};
          store_group<T, 64>(static_cast<T*>(p.o) + (size_t)bh * p.t_q * p.d + oc0, p.d,
                             acc + 32 * m, mul, q0 + 32 * orb + 16 * m, p.t_q, 64, g, tq);
        }
      }
#pragma unroll
      for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    }
  };

  // The pipeline: item i + 1's partials are pushed before item i's output,
  // so that the exchange of each item runs while the CTA computes. Both
  // buffers are double. A CTA pushes partials i + 2 once P of item i is in
  // from every CTA, each of which had by then read its partials of item i;
  // its peers push P of item i + 2 into it only after its partials of item
  // i + 2, which it pushes after every warp has read item i's P in its
  // output. The mbarriers are armed for item i + 2 once item i's phase is
  // seen complete (thread 0 reduces and arms before it pushes). A CTA exits
  // once P of its last item is in, and nothing is pushed to it after.
  if (n_items > 0) {
    cp_async_wait<1>();  // item 0 and the resident Q_c
    __syncthreads();
    partial(0);
  }
#pragma unroll 1
  for (int i = 0; i < n_items; ++i) {
    reduce(i);
    if (i + 1 < n_items) {
      cp_async_wait<0>();  // item i + 1 has landed
      __syncthreads();
      partial(i + 1);
    }
    mbar_wait(pd_bar(i), (i >> 1) & 1);  // P of item i is in
    if (threadIdx.x == 0 && i + 2 < n_items) mbar_arrive_expect_tx(pd_bar(i), p_bytes);
    output(i);
    __syncthreads();  // item i's slot is free
    issue(i + 2);
  }
  if (n_items == 0) {  // a q tile that skips every kv tile: O = 0, lse = NEG_INF
    for (int pass = 0; pass < p.passes; ++pass) {
      const int oc0 = own0 + pass * kGroupCols + ocol * 64;
      if (oc0 < p.d) {
        const float mul[2] = {1.f, 1.f};
        for (int m = 0; m < 2; ++m) {
          store_group<T, 64>(static_cast<T*>(p.o) + (size_t)bh * p.t_q * p.d + oc0, p.d,
                             acc + 32 * m, mul, q0 + 32 * orb + 16 * m, p.t_q, 64, g, tq);
        }
      }
    }
    if (reduces && rquad == 0 && rq < p.t_q) p.lse[(size_t)bh * p.t_q + rq] = kNegInf;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T>
int smem_attribute() {
  return (int)cudaFuncSetAttribute(flash_fwd_dcluster_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Layout<T>::kBytes);
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  const int err = smem_attribute<T>();
  if (err != 0) return err;
  const Plan plan = make_plan(p.d);
  if (plan.cluster < 1 || plan.cluster > kMaxCluster) return kUnsupported;
  p.passes = plan.passes;
  p.cluster = plan.cluster;
  p.n_tiles = (p.t_q + kBlockQ - 1) / kBlockQ;
  p.bq_eff = p.t_q < kBlockQ ? p.t_q : kBlockQ;
  p.bk_eff = p.t_kv < kBlockK ? p.t_kv : kBlockK;
  const size_t ld = (size_t)p.d * sizeof(T);
  // the streamed side of one head: K and V
  const long long head_bytes = 2ll * (long long)ld * p.t_kv;
  const Params all = p;
  return launch_heads(all.bh, (long long)all.n_tiles * all.cluster, [&](int h0, int heads) {
    Params c = all;
    c.q = static_cast<const char*>(all.q) + (size_t)h0 * all.t_q * ld;
    c.k = static_cast<const char*>(all.k) + (size_t)h0 * all.t_kv * ld;
    c.v = static_cast<const char*>(all.v) + (size_t)h0 * all.t_kv * ld;
    c.o = static_cast<char*>(all.o) + (size_t)h0 * all.t_q * ld;
    c.lse = all.lse + (size_t)h0 * all.t_q;
    c.bh = heads;
    c.l2 = l2_group(head_bytes, heads);
    ClusterConfig cc((unsigned)((long long)heads * all.n_tiles * all.cluster), all.cluster,
                     Layout<T>::kBytes, stream);
    const cudaError_t e = cudaLaunchKernelEx(&cc.cfg, flash_fwd_dcluster_kernel<T>, c);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  });
}

template <typename T>
int max_clusters(int cluster) {
  if (cluster < 1 || cluster > kMaxCluster || smem_attribute<T>() != 0) return -1;
  ClusterConfig cc((unsigned)cluster, cluster, Layout<T>::kBytes, nullptr);
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveClusters(&n, flash_fwd_dcluster_kernel<T>,
                                                         &cc.cfg);
  return err == cudaSuccess ? n : -1;
}

}  // namespace

extern "C" int ray_tpu_flash_fwd_dcluster(const void* q, const void* k, const void* v, void* o,
                                          void* lse, int bh, int t_q, int t_kv, int d,
                                          int dtype, int causal, float scale, void* stream) {
  if (bh <= 0 || t_q <= 0 || t_kv <= 0 || d <= 0 || d % 128 != 0 || !(scale > 0.f)) {
    return kUnsupported;
  }
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.bh = bh;
  p.t_q = t_q;
  p.t_kv = t_kv;
  p.d = d;
  p.off = t_kv - t_q;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_dtype(dtype, kUnsupported, [&](auto t) { return launch<decltype(t)>(p, st); });
}

// the tiles the kernel computes with at head_dim d (in every dtype): 0, or
// kUnsupported for a head_dim it does not take
extern "C" int ray_tpu_flash_fwd_dcluster_tiles(int d, int* block_q, int* block_k) {
  if (d <= 0 || d % 128 != 0) return kUnsupported;
  *block_q = kBlockQ;
  *block_k = kBlockK;
  return 0;
}

extern "C" int ray_tpu_flash_fwd_dcluster_plan(int d, int dtype, int* out) {
  if (d <= 0 || d % 128 != 0) return kUnsupported;
  return with_dtype(dtype, kUnsupported, [&](auto t) {
    const Plan plan = make_plan(d);
    out[0] = kGroupCols;
    out[1] = plan.cluster;
    out[2] = plan.passes;
    out[3] = Layout<decltype(t)>::kBytes;
    return 0;
  });
}

extern "C" int ray_tpu_flash_fwd_dcluster_smem_bytes(int dtype) {
  return with_dtype(dtype, -1, [](auto t) { return Layout<decltype(t)>::kBytes; });
}

extern "C" int ray_tpu_flash_fwd_dcluster_max_clusters(int dtype, int cluster) {
  return with_dtype(dtype, -1, [&](auto t) { return max_clusters<decltype(t)>(cluster); });
}

extern "C" const char* ray_tpu_flash_fwd_dcluster_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype, scale, shape or cluster";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
