// Flash-attention forward for Hopper (sm_90a) at head_dims 384, 512, 640 and
// 768 in bf16, float16 and float32 (the kernel's T; it builds for every
// multiple of 128 from 256 to 1024, d a runtime argument): design
// "dcluster128", the output's columns split over the CTAs of a thread-block
// cluster in groups of 128, so that one 64-row q tile covers the whole width.
// Hand-written CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_attention_tpu) at head_dims 384 to 768 where the
// dispatch table in ops/attention.py (FWD_DESIGNS) names this design. It
// computes O = softmax(scale * Q K^T) V in T and the row logsumexp in
// float32 with the TPU kernel's conventions (flash_fwd_wgmma.cu's header
// lists them) at this design's tiles, 64 q rows by 32 kv rows, as
// flash_fwd_dcluster.cu does; flash_attention_fwd_plain at the same tiles is
// the same algorithm, so a row that sees no key gets what the reference's
// kernel gives it at these tiles.
//
// What bounds it on an H100: the operations, 4 * d per visible (q, k) pair,
// at 989 TFLOP/s in bf16 and float16 and 494.7 / 3 = 164.9 TFLOP/s in
// float32 (3xTF32), with q, k, v and o read or written once. The designs
// before (flash_fwd_wide.cu and, in float32, flash_fwd_f32.cu) held 16 or 32
// q rows a CTA, so every K and V byte was read from L2 by t / 16 or t / 32
// tiles (5.4 GB a launch in bf16 at 2 x 8 heads x 2048^2 and d = 640), ran 5
// to 8 warps an SM and handed the partial S of each kv tile between the
// warps of a row through shared memory under a named barrier; bf16 ran on
// mma.sync.
//
// Design. As flash_fwd_dcluster.cu (dcluster.cuh): the C = d / 128 CTAs of
// one (64-row q tile, head) form a cluster, launched with cudaLaunchKernelEx
// and a cluster dimension; CTA c owns columns [128 c, 128 c + 128). Per 32-row
// kv tile that the causal skip leaves (an item):
//   1. each CTA computes its partial S over its columns as two sources of 64
//      columns each (column order 2 c, 2 c + 1), and pushes each row's 32
//      partials of a source as 8 float4 quads (columns 16 p + 2 tq + {0, 1,
//      8, 9}) by st.async to the CTA that reduces the row (rows r ceil(64 /
//      C) on), completing on its mbarrier;
//   2. the reducing CTA sums a row's 2 C partials in column order, so S has
//      one set of bits, runs the masks and the online softmax once, 8
//      threads a row, a quad each;
//   3. it pushes P and the row's (alpha, 1 / l) to every CTA of the cluster;
//   4. each CTA rescales and updates only its own columns, O_c = alpha O_c +
//      P V_c, and writes them times 1 / l after the last item.
// No cluster barrier an item, no atomics: a second run is bit-equal. Item
// i + 1's partials are pushed before item i's output, so the exchange runs
// behind the products; receive and P buffers are double (the order that
// makes them safe is stated at the pipeline).
//
// The products, by T:
//   * bf16 and float16, on wgmma: warpgroup w owns source w (its 64 columns
//     of the CTA's 128). S_w [64 x 32] = Q_w K_w^T is m64n32k16 with A, Q's 64
//     rows over those columns, resident in registers (16 a thread, read from
//     global memory once) and B, K's tile, K-major in shared memory. O_w
//     [64 x 64] += P V_w is m64n64k16 with P rounded to T in registers (the
//     A-operand layout, read from the pushed P) and V read MN-major through
//     the descriptor's transpose bit. K and V tiles arrive by TMA (3-D maps
//     [d, t_kv, heads], 64-column boxes at the CTA's columns, 128-byte
//     swizzled, zeros past t_kv) into a ring of kStages slots, each with a
//     full mbarrier; thread 0 issues. S from registers rather than from Q in
//     shared memory: an m64n32k16 with both operands in shared memory reads
//     3 KB there for 65536 operations, 24 cycles of the SM's 128 bytes a
//     cycle against 15 of the tensor cores, where B alone takes 8.
//   * float32, in 3xTF32 on mma.sync m16n8k8 (tf32_mma.cuh): warp (rb, h)
//     owns the [16 x 32] piece of S of q rows 16 rb over source h, Q_c
//     resident in shared memory and K's tile, both split where they are
//     loaded; O_c is 8 warps of [32 x 32], a 16-row half of P split once at
//     a time, V split at load. Q (once) and K and V (a ring of kStages raw
//     slots) arrive by cp.async as rows of 128 floats whose 16-byte pieces
//     are XOR-swizzled by the row's low three bits, so both fragment loads
//     (rows g, columns tq; rows 2 tq, columns g) touch 32 distinct banks.
//     Q's fragments held split in registers (64 a thread, as
//     flash_bwd_dcluster128.cu holds its resident side) leave the compiler
//     no room at 255 and it spills; the streamed tiles split once into big
//     and small planes read 10-13% slower in flash_bwd_dcluster128.cu.
//
// The reckoning, in bytes of shared memory:
//   * float32's resident Q_c: 64 rows x 128 columns, 32768;
//   * the ring: kStages = 3 slots of K_c and V_c, 32 rows x 128 columns:
//     2 x 8192 a slot in bf16 and float16, 2 x 16384 in float32;
//   * exchange: two receive buffers of a CTA's rows' partials from the 2 C
//     sources, 2 C ceil(64 / C) rows of 8 float4, at most 17920 bytes (C =
//     7) each; two of P ([64 x 8] float4) with the rows' (alpha, 1 / l), 8704
//     each; the mbarriers; 1024 to align the swizzled tiles.
//   103480 bytes in bf16 and float16: two CTAs an SM (16 warps, 128
//   registers a thread), so clusters of 5 and 6 no longer leave a fifth of
//   the SMs idle; 185400 in float32: one CTA an SM, 256 threads.
// Why 128 columns and not dcluster's 256: uniform clusters of C = d / 128 =
// 3 to 6 at every head_dim of the table (256 gives 2, 2, 3, 3 groups with
// the last one half empty at 640), a [64 x 128] float32 O_c of 32 registers
// a thread in bf16 (64 at 256), and CTAs small enough for two an SM. The
// price is the exchange: a (row, kv) position sends 4 bytes of partial S a
// source and receives 4 of P, against 2 x 128 multiply-adds of the CTA's
// products; at 2 C sources a position the reducer reads 8 C bytes.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_fwd_dcluster128(q, k, v, o, lse, bh, t_q, t_kv, d,
//                                     dtype, causal, scale, stream)
//   int ray_tpu_flash_fwd_dcluster128_tiles(d, &block_q, &block_k)
//   int ray_tpu_flash_fwd_dcluster128_plan(d, dtype, int out[4])
//       (group columns, CTAs a cluster, passes, dynamic shared memory)
//   int ray_tpu_flash_fwd_dcluster128_smem_bytes(dtype)
//   int ray_tpu_flash_fwd_dcluster128_max_clusters(dtype, cluster)
//   int ray_tpu_flash_fwd_dcluster128_ctas_per_sm(dtype)
// q/o are [bh, t_q, d], k/v [bh, t_kv, d], contiguous bf16 (dtype 0),
// float32 (1) or float16 (2), d a multiple of 128 from 256 to 1024, 16-byte
// aligned; lse [bh, t_q] float32; scale > 0 (the wrapper hands a non-positive
// one's sign to q). The grid is (heads of a launch) x q tiles x C on grid.x,
// at most 2^31 - 1, in clusters of C CTAs: it launches as many times as that
// takes, on `stream`, allocates nothing, and returns the launch's status,
// kUnsupported for what it does not take, or kTensorMapFailed.

#include "dcluster.cuh"

namespace {

constexpr int kCols = 128;   // a CTA's columns of d
constexpr int kBlockQ = 64;  // q rows of a cluster's tile
constexpr int kBlockK = 32;  // kv rows of a streamed tile
constexpr int kStages = 3;
constexpr int kQuads = kBlockK / 4;  // float4s of a row of S or P
constexpr int kSources = 2;          // partial sources a CTA: its 64-column halves

// CTAs an SM each build is made for
template <typename T>
constexpr int kMinBlocks = kF32<T> ? 1 : 2;

// the most rows' partials a CTA receives: 2 C ceil(64 / C) over the cluster
// sizes
constexpr int max_recv_rows() {
  int most = 0;
  for (int c = 1; c <= kMaxCluster; ++c) {
    const int rows = kSources * c * ((kBlockQ + c - 1) / c);
    most = rows > most ? rows : most;
  }
  return most;
}

// Shared memory, in bytes from a 1024-aligned base
template <typename T>
struct Layout {
  static constexpr int kTile = kBlockK * kCols * (int)sizeof(T);  // K_c or V_c
  static constexpr int kBox = kBlockK * 128;  // a 64-column box of a 16-bit tile
  static constexpr int kSlot = 2 * kTile;     // K_c, then V_c
  // float32: the resident Q_c, 64 rows (bf16 and float16 keep it in
  // registers)
  static constexpr int kQ = 0;
  static constexpr int kQBytes = kF32<T> ? kBlockQ * kCols * 4 : 0;
  static constexpr int kRing = kQ + kQBytes;
  // a CTA's rows' partials from every source: [source][row][quad] float4
  static constexpr int kRecv = kRing + kStages * kSlot;
  static constexpr int kRecvBytes = max_recv_rows() * kQuads * 16;
  // P [row][quad] float4 (quads swizzled by the row's parity), then the rows'
  // (alpha, 1 / l) float2
  static constexpr int kP = kRecv + 2 * kRecvBytes;
  static constexpr int kPQuads = kBlockQ * kQuads * 16;
  static constexpr int kPBytes = kPQuads + kBlockQ * 8;
  // two receive and two P mbarriers, then a full one a slot (TMA)
  static constexpr int kBars = kP + 2 * kPBytes;
  static constexpr int kBytes = kBars + (4 + kStages) * 8;
  static constexpr int kAlloc = kBytes + 1024;  // room to align
  static_assert(kAlloc <= 232448, "shared memory over the 227 KB a block may use");
  static_assert(kMinBlocks<T> == 1 || kMinBlocks<T> * (kAlloc + 1024) <= 233472,
                "two CTAs an SM do not fit");
  static_assert(kTile % 1024 == 0 && kRecvBytes % 16 == 0, "aligned tiles");
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
  int cluster;  // C = d / 128
  int t_q;
  int t_kv;
  int d;
  int off;      // t_kv - t_q
  int bq_eff;   // min(block_q, t_q): the reference's block_q
  int bk_eff;   // min(block_k, t_kv): the reference's block_k
  int causal;
  float scale_log2;  // scale * log2(e)
};

// x, opaque to the compiler: what is computed from it is computed where it
// is used (at the last item) and not held from the kernel's start in
// registers, which float32 has none to spare for
__device__ __forceinline__ int opaque(int x) {
  asm volatile("" : "+r"(x));
  return x;
}

// where quad `quad` of row `row` of P lies: the quads of odd rows swapped by
// halves (flash_fwd_dcluster.cu's p_at)
__device__ __forceinline__ int p_at(int row, int quad) {
  return row * kQuads + (quad ^ ((row & 1) << 2));
}

// D[64 x 32] (+)= A[64 x 16] B[16 x 32], A in registers (the A-operand
// layout), B K-major in shared memory (no transpose), of type T
template <typename T>
__device__ __forceinline__ void wgmma_rs_n32_nt(float* d, const uint32_t* a, uint64_t db,
                                                int accumulate) {
#define RS_NT(TY)                                                                             \
  asm volatile(                                                                               \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                            \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " "                            \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "              \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"                                          \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),   \
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),            \
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                                                 \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
  if constexpr (kHalf<T>) {
    RS_NT("f16");
  } else {
    RS_NT("bf16");
  }
#undef RS_NT
}

// Rows [row0, row0 + kRows) of a float32 matrix of `rows` rows, `ld` bytes
// apart (src the first byte of the CTA's columns), into the tile at `tile`
// by cp.async, thread t copying 16-byte pieces t + 256 k (32 a row) to
// their swizzled place: zeros past `rows`. The caller commits the group.
template <int kRows>
__device__ __forceinline__ void load_f32(uint32_t tile, const char* src, size_t ld, int row0,
                                         int rows) {
#pragma unroll
  for (int k = 0; k < kRows * 32 / kClusterThreads; ++k) {
    const int c = (int)threadIdx.x + k * kClusterThreads;
    const int r = c >> 5, piece = c & 31;
    const bool ok = row0 + r < rows;
    cp_async_16(tile + r * kCols * 4 + ((piece ^ (r & 7)) << 4),
                src + (size_t)(ok ? row0 + r : 0) * ld + piece * 16, ok ? 16 : 0);
  }
}

template <typename T>
__global__ void __launch_bounds__(kClusterThreads, kMinBlocks<T>)
    flash_fwd_dcluster128_kernel(const __grid_constant__ CUtensorMap tm_k,
                                 const __grid_constant__ CUtensorMap tm_v, const Params p) {
  using L = Layout<T>;
  constexpr bool kTma = !kF32<T>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  uint8_t* const smem = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int rank = (int)cluster_ctarank();  // the CTA's columns
  int bh, tile;
  slot_head_tile(blockIdx.x / p.cluster, p.bh, p.n_tiles, p.l2, &bh, &tile);  // a cluster a slot
  const int q0 = (p.n_tiles - 1 - tile) * kBlockQ;  // the heaviest q tiles first
  const T* q = static_cast<const T*>(p.q) + (size_t)bh * p.t_q * p.d;
  const size_t ld = (size_t)p.d * sizeof(T);
  const char* k = static_cast<const char*>(p.k) + (size_t)bh * p.t_kv * ld;
  const char* v = static_cast<const char*>(p.v) + (size_t)bh * p.t_kv * ld;

  // the kv tiles the q tile runs: the reference's causal skip as a loop bound
  const int n_kv = (p.t_kv + kBlockK - 1) / kBlockK;
  int n_items = n_kv;
  if (p.causal) {
    const int last = q0 + p.bq_eff - 1 + p.off;
    n_items = last < 0 ? 0 : min(n_kv, last / kBlockK + 1);
  }
  const int own0 = rank * kCols;  // the CTA's columns [own0, own0 + 128)

  // The exchange, as flash_fwd_dcluster.cu's: a CTA's partials of each row
  // go to the CTA that reduces the row (its receive buffer i % 2), P and the
  // row statistics from there to every CTA (its P buffer i % 2), each store
  // completing on the receiver's mbarrier.
  const int per = (kBlockQ + p.cluster - 1) / p.cluster;  // rows a CTA reduces, R
  const int n_rows = min(per, kBlockQ - rank * per);       // this CTA's (at least 1)
  const uint32_t recv_bytes = (uint32_t)(kSources * p.cluster * n_rows * kQuads * 16);
  const uint32_t p_bytes = L::kPBytes;  // P and the statistics of all 64 rows
  const uint32_t bars = smem_u32(smem + L::kBars);
  auto recv_bar = [&](int i) { return bars + 8 * (i & 1); };
  auto pd_bar = [&](int i) { return bars + 16 + 8 * (i & 1); };
  auto full_bar = [&](int i) { return bars + 32 + 8 * (i % kStages); };
  if (threadIdx.x == 0 && n_items > 0) {
    for (int b = 0; b < 2; ++b) {
      mbar_init(recv_bar(b), 1);
      mbar_init(pd_bar(b), 1);
    }
    if constexpr (kTma) {
      for (int s = 0; s < kStages; ++s) mbar_init(full_bar(s), 1);
    }
    for (int i = 0; i < min(2, n_items); ++i) {  // armed for items 0 and 1
      mbar_arrive_expect_tx(recv_bar(i), recv_bytes);
      mbar_arrive_expect_tx(pd_bar(i), p_bytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (n_items > 0) cluster_sync();  // every peer's mbarriers are ready before the first push

  // item i's K_c and V_c into slot i % kStages: by TMA from thread 0 onto the
  // slot's full mbarrier (bf16, float16), or by cp.async from every thread in
  // a commit group of its own (float32)
  auto slot = [&](int i) { return smem + L::kRing + (i % kStages) * L::kSlot; };
  auto issue = [&](int i) {
    if constexpr (kTma) {
      if (threadIdx.x == 0 && i < n_items) {
        const uint32_t dst = smem_u32(slot(i)), bar = full_bar(i);
        mbar_arrive_expect_tx(bar, L::kSlot);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          tma_load_3d(dst + c * L::kBox, &tm_k, bar, own0 + 64 * c, i * kBlockK, bh);
          tma_load_3d(dst + L::kTile + c * L::kBox, &tm_v, bar, own0 + 64 * c, i * kBlockK, bh);
        }
      }
    } else {
      if (i < n_items) {
        const uint32_t dst = smem_u32(slot(i));
        load_f32<kBlockK>(dst, k + (size_t)own0 * 4, ld, i * kBlockK, p.t_kv);
        load_f32<kBlockK>(dst + L::kTile, v + (size_t)own0 * 4, ld, i * kBlockK, p.t_kv);
      }
      cp_async_commit();
    }
  };
  // waits until item i's slot has landed (this thread's view; the block
  // barrier after it publishes the cp.async copies)
  auto landed = [&](int i, bool first) {
    if constexpr (kTma) {
      mbar_wait(full_bar(i), (i / kStages) & 1);
    } else if (first) {
      cp_async_wait<kStages - 1>();
    } else {
      cp_async_wait<kStages - 2>();
    }
  };
  if constexpr (!kTma) {  // float32: the resident Q_c, in item 0's commit group
    if (n_items > 0) {
      load_f32<kBlockQ>(smem_u32(smem + L::kQ), reinterpret_cast<const char*>(q + own0), ld, q0,
                        p.t_q);
    }
  }
  for (int i = 0; i < kStages; ++i) issue(i);

  // step 1's roles. bf16, float16: warpgroup kh owns source kh, warp prb of
  // it q rows 16 prb. float32: warp (prb, kh) = (warp / 2, warp % 2)
  const int prb = kTma ? warp & 3 : warp >> 1;
  const int kh = kTma ? warp >> 2 : warp & 1;
  const int src = kSources * rank + kh;  // the sources in column order
  // bf16, float16: the warp's resident A operand of S, read from global
  // memory once: rows q0 + 16 prb + g (+ 8), columns own0 + 64 kh on, 4
  // k-steps of 16 columns as packed pairs; zeros past t_q
  uint32_t qa[kTma ? 16 : 1];
  if constexpr (kTma) {
    const int ra = q0 + 16 * prb + g;
    const bool ok0 = ra < p.t_q, ok1 = ra + 8 < p.t_q;
    const T* x_lo = q + (size_t)(ok0 ? ra : 0) * p.d + own0 + 64 * kh;
    const T* x_hi = q + (size_t)(ok1 ? ra + 8 : 0) * p.d + own0 + 64 * kh;
    auto pair = [](const T* x, bool ok, int col) {
      return ok ? *reinterpret_cast<const uint32_t*>(x + col) : 0u;
    };
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const int c = 16 * kk + 2 * tq;
      qa[4 * kk] = pair(x_lo, ok0, c);
      qa[4 * kk + 1] = pair(x_hi, ok1, c);
      qa[4 * kk + 2] = pair(x_lo, ok0, c + 8);
      qa[4 * kk + 3] = pair(x_hi, ok1, c + 8);
    }
  }

  // step 1 of item i: the warp's [16 x 32] piece of the partial S (q rows 16
  // prb, source kh) into s, then (push) its two rows' quads pushed to their
  // reducers
  float s[16];
  auto partial = [&](int i) {
#pragma unroll
    for (int e = 0; e < 16; ++e) s[e] = 0.f;
    if constexpr (kTma) {
      const uint32_t k_box = smem_u32(slot(i)) + kh * L::kBox;
      fence_regs<16>(s);
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        wgmma_rs_n32_nt<T>(s, qa + 4 * kk, kmajor_desc(k_box + kk * 32), kk > 0);
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<16>(s);
    } else {
      // Q's rows 16 prb + g (+ 8) and K's rows g + 8 nt, column 64 kh +
      // 8 ks + tq (+ 4), at their swizzled place (the 16-byte piece XOR the
      // row's low three bits, g for both); split as they are loaded
      const uint32_t* x =
          reinterpret_cast<const uint32_t*>(smem + L::kQ) + (16 * prb + g) * kCols + 64 * kh;
      const uint32_t* y = reinterpret_cast<const uint32_t*>(slot(i)) + g * kCols + 64 * kh;
      const int sw = g << 2;
#pragma unroll
      for (int ks = 0; ks < 8; ++ks) {
        // the loads hoisted at most two k-steps ahead
        if (ks % 2 == 0) asm volatile("" ::: "memory");
        const int blk = 32 * (ks >> 2), j = ks & 3;
        const int lo = blk + ((8 * j + tq) ^ sw), hi = blk + ((8 * j + tq + 4) ^ sw);
        FragA fa;
        split(__uint_as_float(x[lo]), fa.big[0], fa.small[0]);
        split(__uint_as_float(x[8 * kCols + lo]), fa.big[1], fa.small[1]);
        split(__uint_as_float(x[hi]), fa.big[2], fa.small[2]);
        split(__uint_as_float(x[8 * kCols + hi]), fa.big[3], fa.small[3]);
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          FragB fb;
          split(__uint_as_float(y[8 * nt * kCols + lo]), fb.big[0], fb.small[0]);
          split(__uint_as_float(y[8 * nt * kCols + hi]), fb.big[1], fb.small[1]);
          mma3_add(s + 4 * nt, fa, fb);
        }
      }
    }
  };
  auto push = [&](int i) {
    const uint32_t base = smem_u32(smem + L::kRecv + (i & 1) * L::kRecvBytes);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // rows g and g + 8 of the piece
      const int row = 16 * prb + g + 8 * h;
      const int to = row / per, lr = row - to * per;
#pragma unroll
      for (int pp = 0; pp < 2; ++pp) {  // quad (pp, tq): n-tiles 2 pp and 2 pp + 1
        const uint32_t at = base + ((src * per + lr) * kQuads + 4 * pp + tq) * 16;
        st_async(map_cluster(at, to),
                 make_float4(s[8 * pp + 2 * h], s[8 * pp + 2 * h + 1], s[8 * pp + 4 + 2 * h],
                             s[8 * pp + 5 + 2 * h]),
                 map_cluster(recv_bar(i), to));
      }
    }
  };

  // steps 2 and 3 of item i: the CTA's rows, 8 threads a row (a quad each),
  // once every source's partials of them are in. The warps that hold
  // reducing threads run it whole (the row's shuffles), the others skip it.
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
    // the 2 C sources in column order, a loop of the cluster's length:
    // unrolled over the 16 a cluster may have, the compiler holds their
    // offsets across the item loop, and float32 spills
    float sx[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
    for (int c = 0; c < kSources * p.cluster; ++c) {
      const float4 a = in[c * per * kQuads];
      sx[0] += a.x;
      sx[1] += a.y;
      sx[2] += a.z;
      sx[3] += a.w;
    }
    // the online softmax in log2 units, as flash_fwd_dcluster.cu's: a masked
    // score is -inf; a row whose processed columns are all masked keeps m at
    // NEG_INF and takes p = 1 on each column of the reference's tile
    const int k0 = i * kBlockK;
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
    if (i == n_items - 1) {  // the last kv tile: the row's sum and lse
      float sum = l_run + __shfl_xor_sync(0xffffffffu, l_run, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      const float denom = sum == 0.f ? 1.f : sum;
      inv = 1.f / denom;
      if (reduces && rquad == 0 && rq < p.t_q) {
        p.lse[(size_t)opaque(bh) * p.t_q + rq] =
            m_run == kNegInf ? kNegInf + logf(denom) : (m_run + log2f(denom)) * kLn2;
      }
    }
    if (reduces) {
      const uint32_t buf = smem_u32(smem + L::kP + (i & 1) * L::kPBytes);
      const uint32_t out = buf + 16 * p_at(rrow, rquad);
      const uint32_t stat = buf + L::kPQuads + 8 * rrow;
      const float4 p4 = make_float4(pe[0], pe[1], pe[2], pe[3]);
#pragma unroll 1
      for (int c = 0; c < p.cluster; ++c) {
        const uint32_t b = map_cluster(pd_bar(i), c);
        st_async(map_cluster(out, c), p4, b);
        if (rquad == 0) st_async(map_cluster(stat, c), make_float2(alpha, inv), b);
      }
    }
  };

  // step 4 of item i, once P and the row statistics are in. bf16, float16:
  // warpgroup kh's O over its 64 columns, warp prb its rows 16 prb (an
  // m64n64 accumulator, 32 floats). float32: warp (orb, ocol) = (warp / 4,
  // warp % 4), q rows 32 orb, columns 32 ocol of the CTA's (rows 0-15 of the
  // warp's, then 16-31, 16 floats each). Stored, times 1 / l, after the last
  // item.
  const int orb = warp >> 2, ocol = warp & 3;
  constexpr int kAcc = 32;
  float acc[kAcc];
#pragma unroll
  for (int e = 0; e < kAcc; ++e) acc[e] = 0.f;
  auto store = [&](const float2* stat) {
    T* o = static_cast<T*>(p.o) + (size_t)opaque(bh) * p.t_q * p.d + own0;
    if constexpr (kTma) {
      const int row = 16 * prb + g;
      const float mul[2] = {stat ? stat[row].y : 1.f, stat ? stat[row + 8].y : 1.f};
      store_group<T, 64>(o + 64 * kh, p.d, acc, mul, q0 + 16 * prb, p.t_q, 64, g, tq);
    } else {
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const int row = 32 * orb + 16 * m + g;
        const float mul[2] = {stat ? stat[row].y : 1.f, stat ? stat[row + 8].y : 1.f};
        store_group<T, 32>(o + 32 * ocol, p.d, acc + 16 * m, mul, q0 + 32 * orb + 16 * m,
                           p.t_q, 32, g, tq);
      }
    }
  };
  auto output = [&](int i) {
    const uint8_t* buf = smem + L::kP + (i & 1) * L::kPBytes;
    const float4* pin = reinterpret_cast<const float4*>(buf);
    const float2* stat = reinterpret_cast<const float2*>(buf + L::kPQuads);
    if constexpr (kTma) {
      float a[16];  // P of rows 16 prb + g (+ 8), the [16 x 32] accumulator layout
      float alpha[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = 16 * prb + g + 8 * h;
        alpha[h] = stat[row].x;
#pragma unroll
        for (int pp = 0; pp < 2; ++pp) {
          const float4 f = pin[p_at(row, 4 * pp + tq)];
          a[8 * pp + 2 * h] = f.x;
          a[8 * pp + 2 * h + 1] = f.y;
          a[8 * pp + 4 + 2 * h] = f.z;
          a[8 * pp + 5 + 2 * h] = f.w;
        }
      }
      uint32_t pa[8];
      to_a<32, T>(a, pa);
#pragma unroll
      for (int e = 0; e < kAcc; ++e) acc[e] *= alpha[(e >> 1) & 1];
      fence_regs<kAcc>(acc);
      fence_regs<8>(pa);
      wgmma_fence();
      issue_nn<64, kBlockK, T>(acc, pa, smem_u32(slot(i)) + L::kTile + kh * L::kBox);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kAcc>(acc);
      fence_regs<8>(pa);
    } else {
      // O_c += P V_c over the warp's 32 columns, its rows 0-15 and then
      // 16-31: each half's P split once (32 registers; both halves at once
      // spill at 255), V's fragments read again for the second; each 8-row
      // step's three products in fresh registers, added in float32. V's rows
      // 8 kk + 2 tq and + 1 (the permuted k index), column 32 ocol + 8 nt + g
      // at its swizzled place in each row
      const uint32_t* y = reinterpret_cast<const uint32_t*>(slot(i) + L::kTile) + 2 * tq * kCols;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        float a[16];  // P of rows 32 orb + 16 m + g (+ 8), an accumulator's layout
        float alpha[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = 32 * orb + 16 * m + g + 8 * h;
          alpha[h] = stat[row].x;
#pragma unroll
          for (int pp = 0; pp < 2; ++pp) {
            const float4 f = pin[p_at(row, 4 * pp + tq)];
            a[8 * pp + 2 * h] = f.x;
            a[8 * pp + 2 * h + 1] = f.y;
            a[8 * pp + 4 + 2 * h] = f.z;
            a[8 * pp + 5 + 2 * h] = f.w;
          }
        }
        FragA fa[4];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) acc_to_a(fa[kk], a + 4 * kk);
        float* const o = acc + 16 * m;
#pragma unroll
        for (int e = 0; e < 16; ++e) o[e] *= alpha[(e >> 1) & 1];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int c = 32 * ocol + 8 * nt + g;
#pragma unroll
          for (int kk = 0; kk < 4; ++kk) {
            FragB fb;
            split(__uint_as_float(y[8 * kk * kCols + (c ^ (tq << 3))]), fb.big[0], fb.small[0]);
            split(__uint_as_float(y[(8 * kk + 1) * kCols + (c ^ ((tq << 3) + 4))]), fb.big[1],
                  fb.small[1]);
            mma3_add(o + 4 * nt, fa[kk], fb);
          }
        }
      }
    }
    // 1 / l, from the buffer of the last item, which nothing writes again
    if (i == n_items - 1) store(stat);
  };

  // The pipeline, as flash_bwd_dcluster128.cu's: item i + 1's partials are
  // pushed before item i's output, both exchange buffers are double, and
  // the mbarriers are armed for item i + 2 once item i's phase is seen
  // complete. A CTA pushes partials i + 2 once P of item i is in from every
  // CTA, each of which had by then read its partials of item i; its peers
  // push P of item i + 2 into it only after its partials of item i + 2,
  // which it pushes after every warp has read item i's P in its output. A
  // CTA exits once P of its last item is in, and nothing is pushed to it
  // after. The ring runs kStages items ahead; the block barrier after item
  // i's output frees its slot for item i + kStages. In float32 a block
  // barrier publishes item i + 1's slot (the cp.async copies of every
  // thread) before item i's reduce; TMA's full mbarrier does that in bf16
  // and float16.
  // waits until P of item i is in, and arms its buffer's mbarrier for item i + 2
  auto p_in = [&](int i) {
    mbar_wait(pd_bar(i), (i >> 1) & 1);
    if (threadIdx.x == 0 && i + 2 < n_items) mbar_arrive_expect_tx(pd_bar(i), p_bytes);
  };
  if (n_items > 0) {
    landed(0, true);
    if constexpr (!kTma) __syncthreads();
    partial(0);
    push(0);
  }
#pragma unroll 1
  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) {
      landed(i + 1, false);
      if constexpr (!kTma) __syncthreads();
    }
    reduce(i);
    __syncwarp();
    if (i + 1 < n_items) {
      partial(i + 1);
      push(i + 1);
    }
    p_in(i);
    output(i);
    __syncthreads();  // item i's slot is free
    issue(i + kStages);
  }
  if (n_items == 0) {  // a q tile that skips every kv tile: O = 0, lse = NEG_INF
    store(nullptr);
    if (reduces && rquad == 0 && rq < p.t_q) p.lse[(size_t)opaque(bh) * p.t_q + rq] = kNegInf;
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T>
int smem_attribute() {
  return (int)cudaFuncSetAttribute(flash_fwd_dcluster128_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                   Layout<T>::kAlloc);
}

// the plan's CTAs a cluster at head_dim d (one 128-column group each), 0
// where d is none it takes: the reducer's 8 threads a row need C >= 2
int cluster_of(int d) {
  return d > 0 && d % kCols == 0 && d / kCols >= 2 && d / kCols <= kMaxCluster ? d / kCols : 0;
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  const int err = smem_attribute<T>();
  if (err != 0) return err;
  p.cluster = cluster_of(p.d);
  p.n_tiles = (p.t_q + kBlockQ - 1) / kBlockQ;
  p.bq_eff = p.t_q < kBlockQ ? p.t_q : kBlockQ;
  p.bk_eff = p.t_kv < kBlockK ? p.t_kv : kBlockK;
  const size_t ld = (size_t)p.d * sizeof(T);
  const long long head_bytes = 2ll * (long long)ld * p.t_kv;  // K and V of one head
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
    CUtensorMap tm_k = {}, tm_v = {};
    if constexpr (!kF32<T>) {
      if (make_map<T>(&tm_k, c.k, all.d, all.t_kv, heads, kBlockK) ||
          make_map<T>(&tm_v, c.v, all.d, all.t_kv, heads, kBlockK)) {
        return kTensorMapFailed;
      }
    }
    ClusterConfig cc((unsigned)((long long)heads * all.n_tiles * all.cluster), all.cluster,
                     Layout<T>::kAlloc, stream);
    const cudaError_t e =
        cudaLaunchKernelEx(&cc.cfg, flash_fwd_dcluster128_kernel<T>, tm_k, tm_v, c);
    return e != cudaSuccess ? (int)e : (int)cudaGetLastError();
  });
}

template <typename T>
int max_clusters(int cluster) {
  if (cluster < 1 || cluster > kMaxCluster || smem_attribute<T>() != 0) return -1;
  ClusterConfig cc((unsigned)cluster, cluster, Layout<T>::kAlloc, nullptr);
  int n = 0;
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, flash_fwd_dcluster128_kernel<T>, &cc.cfg);
  return err == cudaSuccess ? n : -1;
}

template <typename T>
int ctas_per_sm() {
  if (smem_attribute<T>() != 0) return -1;
  int n = 0;
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, flash_fwd_dcluster128_kernel<T>, kClusterThreads, Layout<T>::kAlloc);
  return err == cudaSuccess ? n : -1;
}

}  // namespace

extern "C" int ray_tpu_flash_fwd_dcluster128(const void* q, const void* k, const void* v,
                                             void* o, void* lse, int bh, int t_q, int t_kv,
                                             int d, int dtype, int causal, float scale,
                                             void* stream) {
  if (bh <= 0 || t_q <= 0 || t_kv <= 0 || cluster_of(d) == 0 || !(scale > 0.f)) {
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
extern "C" int ray_tpu_flash_fwd_dcluster128_tiles(int d, int* block_q, int* block_k) {
  if (cluster_of(d) == 0) return kUnsupported;
  *block_q = kBlockQ;
  *block_k = kBlockK;
  return 0;
}

extern "C" int ray_tpu_flash_fwd_dcluster128_plan(int d, int dtype, int* out) {
  if (cluster_of(d) == 0) return kUnsupported;
  return with_dtype(dtype, kUnsupported, [&](auto t) {
    out[0] = kCols;
    out[1] = cluster_of(d);
    out[2] = 1;
    out[3] = Layout<decltype(t)>::kAlloc;
    return 0;
  });
}

extern "C" int ray_tpu_flash_fwd_dcluster128_smem_bytes(int dtype) {
  return with_dtype(dtype, -1, [](auto t) { return Layout<decltype(t)>::kAlloc; });
}

extern "C" int ray_tpu_flash_fwd_dcluster128_max_clusters(int dtype, int cluster) {
  return with_dtype(dtype, -1, [&](auto t) { return max_clusters<decltype(t)>(cluster); });
}

extern "C" int ray_tpu_flash_fwd_dcluster128_ctas_per_sm(int dtype) {
  return with_dtype(dtype, -1, [](auto t) { return ctas_per_sm<decltype(t)>(); });
}

extern "C" const char* ray_tpu_flash_fwd_dcluster128_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype, scale or shape";
  if (err == kTensorMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
