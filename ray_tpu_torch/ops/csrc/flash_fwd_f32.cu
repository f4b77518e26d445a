// Flash-attention forward for float32 on the tensor cores (sm_90a),
// hand-written CUDA C++: 3xTF32 on mma.sync. The dispatch table in
// ops/attention.py (FWD_DESIGNS, design "tf32x3") sends every float32 input
// here, at head_dim 16, 32, 64, 128 and 256.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_attention_tpu) for float32. It computes what that
// kernel computes, O = softmax(scale * Q K^T) V and the row logsumexp, with
// the conventions of csrc/flash_fwd.cu:
//   * NEG_INF = -1e30 is a finite mask value, not -inf;
//   * under the causal mask q rows are the suffix of the kv context:
//     q_pos = q_idx + (t_kv - t_q), and key k is visible when q_pos >= k;
//   * kv tiles wholly above the diagonal of the q tile are skipped (the
//     loop bound kv_tiles_to_run);
//   * in a ragged last kv tile the padded columns are masked and V is zero;
//   * a row whose processed columns are all masked gets p = exp(0) = 1 on
//     each of them (the online-softmax max stays at NEG_INF);
//   * denominator 1 where l == 0, lse = m + log(denom) in float32.
// Tiles are 64 x 64 (block_q = min(64, t_q), block_k = min(64, t_kv) in the
// reference's terms): the running max is updated once per 64-column kv
// tile, as flash_attention_fwd_plain in ops/attention.py does at the tiles
// FWD_DESIGNS names.
//
// Arithmetic: both products are 3xTF32 on mma.sync.m16n8k8 (csrc/tf32x3.cuh,
// shared with the float32 backward): every operand is split into a big and
// a small tf32 part with integer operations as it is loaded, and a product
// adds small*big', big*small' and big*big'. One TF32 product keeps 11 bits
// and would miss the float32 gate (1e-4 of each row's norm).
//   * S = Q K^T (gemm_s) sums each 8-column step of d in fresh registers
//     and adds it in float32 (mma3_add): the tensor cores round an mma's sum
//     toward zero against its accumulator, and one chain of 48 mma over
//     d = 128 would drift toward the lse gate.
//   * O += P V (gemm_pv) takes P, the softmax of S, from its accumulator
//     registers as the A operand with the permuted k index (slot t is
//     column 2t, slot t + 4 column 2t + 1) and reads V's rows in the same
//     order; it chains 32 kv rows (12 mma) before the float32 add.
// The softmax uses expf, as the plain version's torch.exp. ops/tf32.py's
// flash_fwd_3xtf32 repeats this arithmetic on the CPU.
//
// What bounds it on an H100: at long t the operations, 4 * d per visible
// (q, k) pair at a third of the card's dense TF32 rate (494.7 / 3 = 164.9
// TFLOP/s, the fastest float32-accurate rate); at short t the bytes of q,
// k, v, o and lse. mma.sync in tf32 alone reaches about two thirds of the
// dense TF32 rate (flash_bwd_f32_variants measures it), which caps this
// design near 0.65 of that bound; the splits, shared-memory loads and
// float32 adds around the products take issue slots besides.
//
// Design: one CTA per (64-row q tile, batch*head), 4 warps of 16 q rows
// each (8 at d = 256), the heaviest q tiles (the last, under the causal
// mask) first. Q stays in shared memory for the CTA's life; each warp keeps
// its rows' O, m and l in float32 registers. K and V stream through a ring
// of kStages pieces of kP rows (cp.async, 16 bytes a thread, zero-filled
// past t_kv), in the order K then V of each 64-row kv tile: S is formed
// from the K pieces, then the softmax, then O += P V from the V pieces, and
// the next piece's copy overlaps each piece's work. Every piece is read by
// every warp and each warp splits its own fragments. A lane reads shared
// memory 16 bytes at a time: for S the k index of each 16 columns of d is
// permuted so that a lane's four neighbouring columns of a Q or K row are
// its k slots (gemm_s), and for P V the n index, so that a lane's four
// neighbouring columns of a V row are its B operands of four n-tiles; O is
// stored in that column order (store_o). The strides keep every such read
// free of bank conflicts (kStrideQK, kStrideV). Only a tile on the causal
// diagonal or at the end of kv is masked (softmax_tile). At d = 256 a 16 x 256
// float32 O (128 registers a thread) would spill, so each 16 rows have two
// warps, each holding O over one half of d; each computes S over its half
// of d, the two partials are exchanged through shared memory under a named
// barrier of the pair and summed in one order, so both warps hold the same
// S and P. There are no atomics: equal inputs give equal bits.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_fwd_f32(q, k, v, o, lse, bh, t_q, t_kv, d, dtype,
//                             causal, scale, stream)
//   int ray_tpu_flash_fwd_f32_smem_bytes(d)  (dynamic shared memory per CTA)
//   int ray_tpu_flash_fwd_f32_tiles(d, &block_q, &block_k)  (the tiles it
//                                                            computes with)
// q/o are [bh, t_q, d], k/v [bh, t_kv, d], float32, contiguous, 16-byte
// aligned; lse [bh, t_q] float32; dtype must be 1 (float32). It launches one
// kernel on `stream`, allocates nothing, and returns cudaGetLastError() after
// the launch (or kUnsupported for a head_dim, dtype or shape it does not
// take).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kUnsupported = 100000;
constexpr int kBlockQ = 64;
constexpr int kMaxGridY = 65535;  // the most heads a launch's grid.y holds
constexpr int kBlockK = 64;

// kP kv rows a piece of the ring, kStages pieces, d cut into kHalves (two
// warps per 16 q rows at 256), at least kMinBlocks CTAs an SM (the
// registers a thread may take follow from it), and kVec columns of a V row
// a lane reads at once in P V (4, or 2 where 4 needs more registers than a
// thread has: at d = 128 they spilled 24 bytes, which cost nothing in time
// but fail the build's gate; 2 runs 2% slower on an H100). Shared memory:
// Q, the ring and, where d is cut, the pairs' hand-over tiles of S.
template <int P, int Stages, int Halves, int MinBlocks, int Vec>
struct Tiles {
  static constexpr int kP = P, kStages = Stages, kHalves = Halves, kMinBlocks = MinBlocks;
  static constexpr int kVec = Vec;
  static constexpr int kThreads = kBlockQ / 16 * Halves * 32;
};
template <int D> struct FwdTiles;
template <> struct FwdTiles<16> : Tiles<64, 2, 1, 1, 2> {};
template <> struct FwdTiles<32> : Tiles<64, 2, 1, 1, 4> {};
template <> struct FwdTiles<64> : Tiles<64, 2, 1, 1, 4> {};
template <> struct FwdTiles<128> : Tiles<64, 2, 1, 1, 2> {};
template <> struct FwdTiles<256> : Tiles<32, 2, 2, 1, 4> {};

// Row strides in shared memory, in floats. Q and K are read 16 bytes a
// lane, rows g and g + 1 of a quarter warp side by side: a stride of 16
// (mod 32) floats keeps them on distinct banks. V is read 16 bytes a lane
// from rows 2 tig and 2 tig + 1: a stride of 4 (mod 32) does.
template <int D>
constexpr int kStrideQK = D + ((16 - D % 32) % 32 + 32) % 32;
template <int D>
constexpr int kStrideV = D + 4;
template <int D>
constexpr int kSlot = FwdTiles<D>::kP * (kStrideQK<D> > kStrideV<D> ? kStrideQK<D> : kStrideV<D>);

struct Params {
  const float* q;
  const float* k;
  const float* v;
  float* o;
  float* lse;
  int t_q;
  int t_kv;
  int bq_eff;  // min(64, t_q): the reference's block_q
  int bk_eff;  // min(64, t_kv): the reference's block_k
  int causal;
  float scale;
};

template <int D>
constexpr size_t smem_bytes() {
  using T = FwdTiles<D>;
  const size_t tiles = (size_t)kBlockQ * kStrideQK<D> + (size_t)T::kStages * kSlot<D>;
  const size_t hand_over = T::kHalves > 1 ? (size_t)T::kHalves * kBlockQ * kBlockK : 0;
  return (tiles + hand_over) * sizeof(float);
}

// Number of kv tiles a q tile processes: the causal skip of the reference
// ((qi * bq + bq - 1 + off) < ki * bk skips tile ki) as a loop bound.
__device__ __forceinline__ int kv_tiles_to_run(const Params& p, int q0) {
  const int n_kv = (p.t_kv + kBlockK - 1) / kBlockK;
  if (!p.causal) return n_kv;
  const int last = q0 + p.bq_eff - 1 + (p.t_kv - p.t_q);
  if (last < 0) return 0;
  return min(n_kv, last / kBlockK + 1);
}

// acc[kNT][4] = X Y^T for a warp over kK columns: X its 16 shared rows
// (stride SX), Y kNT * 8 shared rows (stride SY). Each lane reads 16 bytes
// of a row, columns c + 4 tig .. c + 4 tig + 3 of a 16-column block, so the
// block's two 8-column k-steps take their k slots in that order: step one's
// slot tig is column c + 4 tig and slot tig + 4 column c + 4 tig + 1, step
// two's c + 4 tig + 2 and c + 4 tig + 3 (a dot product does not depend on
// the order of its terms). Each step's three products are summed in fresh
// registers (mma3_add). Element e of n-tile nt is row g + 8 * (e >> 1),
// column nt * 8 + 2 * tig + (e & 1), as for gemm_nt.
template <int kNT, int kK, int SX, int SY>
__device__ __forceinline__ void gemm_s(float (*acc)[4], const float* x, const float* y, int g,
                                       int tig) {
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
#pragma unroll 2
  for (int c = 0; c < kK; c += 16) {
    const float4 lo = *reinterpret_cast<const float4*>(x + g * SX + c + 4 * tig);
    const float4 hi = *reinterpret_cast<const float4*>(x + (g + 8) * SX + c + 4 * tig);
    FragA a0, a1;
    split(lo.x, a0.big[0], a0.small[0]);
    split(hi.x, a0.big[1], a0.small[1]);
    split(lo.y, a0.big[2], a0.small[2]);
    split(hi.y, a0.big[3], a0.small[3]);
    split(lo.z, a1.big[0], a1.small[0]);
    split(hi.z, a1.big[1], a1.small[1]);
    split(lo.w, a1.big[2], a1.small[2]);
    split(hi.w, a1.big[3], a1.small[3]);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      const float4 yv = *reinterpret_cast<const float4*>(y + (nt * 8 + g) * SY + c + 4 * tig);
      FragB b0, b1;
      split(yv.x, b0.big[0], b0.small[0]);
      split(yv.y, b0.big[1], b0.small[1]);
      split(yv.z, b1.big[0], b1.small[0]);
      split(yv.w, b1.big[1], b1.small[1]);
      mma3_add(acc[nt], a0, b0);
      mma3_add(acc[nt], a1, b1);
    }
  }
}

template <int kV> struct VecOf;
template <> struct VecOf<4> { using T = float4; };
template <> struct VecOf<2> { using T = float2; };

__device__ __forceinline__ float lane_of(const float4& x, int u) {
  return u == 0 ? x.x : u == 1 ? x.y : u == 2 ? x.z : x.w;
}
__device__ __forceinline__ float lane_of(const float2& x, int u) { return u == 0 ? x.x : x.y; }

// out[kCols / 8][4] += P V[:, c0:c0 + kCols] for a warp: P [16 x K] in the
// accumulator layout of gemm_s (the A operand with the permuted k index of
// acc_to_a, so V's rows are read as 2 tig and 2 tig + 1 of each 8-row
// step), V K shared rows (stride SY) from column c0. The n index is
// permuted too, so that a lane reads kVec neighbouring columns of a V row at
// once: n-tile V * m + u takes, at its n index j, V's column
// V * (8 m + j) + u, and O's column of accumulator element e of that
// n-tile is V * (8 m + 2 tig + (e & 1)) + u (store_o). The sum chains
// kChunkRows rows (12 mma) before the float32 add, as gemm_acc_nn.
template <int kCols, int K, int SY, int V>
__device__ __forceinline__ void gemm_pv(float (*out)[4], const float (*x)[4], const float* y,
                                        int c0, int g, int tig) {
  using Vec = typename VecOf<V>::T;
  constexpr int kSteps = K / 8;
  constexpr int kChunk = kSteps < kChunkRows / 8 ? kSteps : kChunkRows / 8;
#pragma unroll
  for (int s0 = 0; s0 < kSteps; s0 += kChunk) {
    FragA a[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) acc_to_a(a[i], x[s0 + i]);
#pragma unroll
    for (int m = 0; m < kCols / (8 * V); ++m) {
      float part[V][4] = {};
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const float* row = y + ((s0 + i) * 8 + 2 * tig) * SY + c0 + V * (8 * m + g);
        const Vec lo = *reinterpret_cast<const Vec*>(row);
        const Vec hi = *reinterpret_cast<const Vec*>(row + SY);
#pragma unroll
        for (int u = 0; u < V; ++u) {
          FragB b;
          split(lane_of(lo, u), b.big[0], b.small[0]);
          split(lane_of(hi, u), b.big[1], b.small[1]);
          mma3(part[u], a[i], b);
        }
      }
#pragma unroll
      for (int u = 0; u < V; ++u) {
#pragma unroll
        for (int e = 0; e < 4; ++e) out[V * m + u][e] += part[u][e];
      }
    }
  }
}

// A warp's O row (accumulator elements 2 i, 2 i + 1) divided by denom,
// in gemm_pv's column order: a lane holds 2 * V neighbouring columns of
// each 8 * V.
template <int kCols, int V>
__device__ __forceinline__ void store_o(float* dst, const float (*acc)[4], int i, int c0,
                                        int tig, float denom) {
#pragma unroll
  for (int m = 0; m < kCols / (8 * V); ++m) {
    float vals[2 * V];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int u = 0; u < V; ++u) vals[e * V + u] = acc[V * m + u][2 * i + e] / denom;
    }
    float* out = dst + c0 + V * (8 * m + 2 * tig);
#pragma unroll
    for (int w = 0; w < 2 * V; w += 4) {
      *reinterpret_cast<float4*>(out + w) = make_float4(vals[w], vals[w + 1], vals[w + 2],
                                                        vals[w + 3]);
    }
  }
}

// The online softmax of one kv tile for a warp's two rows a lane (the
// accumulator layout of gemm_s): s holds the tile's scores and becomes P;
// m_r and l_r are updated and O rescaled. kMask: the tile crosses the
// causal diagonal or the end of kv, so columns are masked to NEG_INF, and
// columns >= bk_eff, which do not exist in the reference's tile (t_kv < 64),
// take no part in the max or the sum; other tiles need neither.
template <bool kMask, int kNT, int kOutNT>
__device__ __forceinline__ void softmax_tile(float (*s)[4], float (*acc)[4], float* m_r,
                                             float* l_r, const Params& p, int row0, int k0,
                                             int tig) {
  float m_cur[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + tig * 2 + (e & 1);
      float x = s[nt][e] * p.scale;
      if (kMask) {
        const int kp = k0 + col;
        if (p.causal && row0 + (e >> 1) * 8 < kp) x = kNegInf;
        if (kp >= p.t_kv) x = kNegInf;
      }
      s[nt][e] = x;
      if (!kMask || col < p.bk_eff) m_cur[e >> 1] = fmaxf(m_cur[e >> 1], x);
    }
  }
  float alpha[2], m_new[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 1));
    m_cur[r] = fmaxf(m_cur[r], __shfl_xor_sync(0xffffffffu, m_cur[r], 2));
    m_new[r] = fmaxf(m_r[r], m_cur[r]);
    alpha[r] = expf(m_r[r] - m_new[r]);
    m_r[r] = m_new[r];
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = nt * 8 + tig * 2 + (e & 1);
      const float pe = !kMask || col < p.bk_eff ? expf(s[nt][e] - m_new[e >> 1]) : 0.f;
      s[nt][e] = pe;
      rs[e >> 1] += pe;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 1);
    rs[r] += __shfl_xor_sync(0xffffffffu, rs[r], 2);
    l_r[r] = alpha[r] * l_r[r] + rs[r];
  }
#pragma unroll
  for (int nt = 0; nt < kOutNT; ++nt) {
    acc[nt][0] *= alpha[0];
    acc[nt][1] *= alpha[0];
    acc[nt][2] *= alpha[1];
    acc[nt][3] *= alpha[1];
  }
}

template <int D>
__global__ void __launch_bounds__(FwdTiles<D>::kThreads, FwdTiles<D>::kMinBlocks)
    flash_fwd_f32x3_kernel(const Params p) {
  using T = FwdTiles<D>;
  constexpr int kP = T::kP, kStages = T::kStages, kHalves = T::kHalves;
  constexpr int kThreads = T::kThreads;
  constexpr int SQK = kStrideQK<D>, SV = kStrideV<D>;
  constexpr int kDc = D / kHalves;     // d columns a warp sums S over and owns of O
  constexpr int kSub = kBlockK / kP;   // pieces of K, then of V, a kv tile
  constexpr int kPNT = kP / 8;         // n-tiles of S a piece
  constexpr int kNT = kBlockK / 8;     // n-tiles of S a kv tile
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* ring = Qs + kBlockQ * SQK;
  float* slot_s = ring + kStages * kSlot<D>;  // d cut: groups x halves x 16 x 64

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // mma group: row within the 8-row half
  const int tig = lane & 3;  // thread in group
  const int group = warp % (kBlockQ / 16);
  const int half = warp / (kBlockQ / 16);
  const int c0 = half * kDc;  // the warp's d columns: c0..c0 + kDc
  const int r0 = group * 16;  // the warp's tile rows: r0 + g, r0 + g + 8
  // the heaviest q tiles (the last, under the causal mask) launch first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const size_t bh = blockIdx.y;
  const float* k = p.k + bh * p.t_kv * D;
  const float* v = p.v + bh * p.t_kv * D;
  const int off = p.t_kv - p.t_q;

  const int n_run = kv_tiles_to_run(p, q0);
  const int n_pieces = n_run * 2 * kSub;
  // piece i of the stream into its slot: kv tile i / (2 kSub), whose first
  // kSub pieces are K and the rest V; one commit group a piece, empty past
  // the end, so that the wait below counts the same at every step
  const auto issue = [&](int i) {
    if (i < n_pieces) {
      const int r = i % (2 * kSub);
      const int row0 = i / (2 * kSub) * kBlockK + (r % kSub) * kP;
      float* slot = ring + (i % kStages) * kSlot<D>;
      if (r < kSub) {
        load_tile<D, kP, kThreads, SQK>(slot, k, row0, p.t_kv);
      } else {
        load_tile<D, kP, kThreads, SV>(slot, v, row0, p.t_kv);
      }
    }
    cp_async_commit();
  };
  // piece i has landed for every thread and every warp is done with piece
  // i - 1, whose slot takes piece i + kStages - 1
  const auto next = [&](int i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(i + kStages - 1);
    return static_cast<const float*>(ring + (i % kStages) * kSlot<D>);
  };

  // Q lands with piece 0
  load_tile<D, kBlockQ, kThreads, SQK>(Qs, p.q + bh * p.t_q * D, q0, p.t_q);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float acc[kDc / 8][4];
#pragma unroll
  for (int nt = 0; nt < kDc / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};

  int i = 0;
  for (int j = 0; j < n_run; ++j) {
    const int k0 = j * kBlockK;
    // S = Q K^T over the warp's d columns: 16 rows x 64 kv columns
    float s[kNT][4];
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub, ++i) {
      const float* Kp = next(i);
      gemm_s<kPNT, kDc, SQK, SQK>(s + sub * kPNT, Qs + r0 * SQK + c0, Kp + c0, g, tig);
    }
    if constexpr (kHalves > 1) {
      // the pair's partials of S, summed in one order by both warps
      float4* slots = reinterpret_cast<float4*>(slot_s) + group * kHalves * kNT * 32 + lane;
      hand_over<kNT>(slots + half * kNT * 32, s);
      group_sync(1 + group, kHalves * 32);
      take_over<kNT>(s, slots);
#pragma unroll
      for (int h = 1; h < kHalves; ++h) {
        float more[kNT][4];
        take_over<kNT>(more, slots + h * kNT * 32);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) s[nt][e] += more[nt][e];
        }
      }
    }
    // P = the online softmax of S; only a tile on the causal diagonal or at
    // the end of kv is masked
    const int row0 = q0 + r0 + g + off;  // the lane's first row's position
    if ((p.causal && q0 + off < k0 + kBlockK - 1) || k0 + kBlockK > p.t_kv) {
      softmax_tile<true, kNT, kDc / 8>(s, acc, m_r, l_r, p, row0, k0, tig);
    } else {
      softmax_tile<false, kNT, kDc / 8>(s, acc, m_r, l_r, p, row0, k0, tig);
    }
    // O[:, c0:] += P V[:, c0:], a piece of kP kv rows at a time
#pragma unroll
    for (int sub = 0; sub < kSub; ++sub, ++i) {
      const float* Vp = next(i);
      gemm_pv<kDc, kP, SV, T::kVec>(acc, s + sub * kPNT, Vp, c0, g, tig);
    }
  }
  cp_async_wait_all();

  float* o = p.o + bh * p.t_q * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + r0 + g + r * 8;
    if (row < p.t_q) {
      const float denom = l_r[r] == 0.f ? 1.f : l_r[r];
      store_o<kDc, T::kVec>(o + (size_t)row * D, acc, r, c0, tig, denom);
      if (half == 0 && tig == 0) p.lse[bh * p.t_q + row] = m_r[r] + logf(denom);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int D>
int launch_d(int bh, cudaStream_t stream, const Params& p) {
  const size_t smem = smem_bytes<D>();
  const auto kernel = flash_fwd_f32x3_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  // b * h on grid.y, at most 65535 heads a launch: more heads launch in
  // chunks, each with its tensors moved on to its first head (a 1-D grid of
  // tiles and heads held bh in a register and spilled at head_dim 128)
  const size_t q_head = (size_t)p.t_q * D, kv_head = (size_t)p.t_kv * D;
  for (int h0 = 0; h0 < bh; h0 += kMaxGridY) {
    Params c = p;
    c.q += h0 * q_head;
    c.k += h0 * kv_head;
    c.v += h0 * kv_head;
    c.o += h0 * q_head;
    c.lse += (size_t)h0 * p.t_q;
    const dim3 grid((p.t_q + kBlockQ - 1) / kBlockQ, min(kMaxGridY, bh - h0));
    kernel<<<grid, FwdTiles<D>::kThreads, smem, stream>>>(c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

extern "C" int ray_tpu_flash_fwd_f32(const void* q, const void* k, const void* v, void* o,
                                     void* lse, int bh, int t_q, int t_kv, int d, int dtype,
                                     int causal, float scale, void* stream) {
  if (bh <= 0 || t_q <= 0 || t_kv <= 0 || dtype != 1) return kUnsupported;
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.o = static_cast<float*>(o);
  p.lse = static_cast<float*>(lse);
  p.t_q = t_q;
  p.t_kv = t_kv;
  p.bq_eff = t_q < kBlockQ ? t_q : kBlockQ;
  p.bk_eff = t_kv < kBlockK ? t_kv : kBlockK;
  p.causal = causal;
  p.scale = scale;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_d<16>(bh, st, p);
    case 32: return launch_d<32>(bh, st, p);
    case 64: return launch_d<64>(bh, st, p);
    case 128: return launch_d<128>(bh, st, p);
    case 256: return launch_d<256>(bh, st, p);
  }
  return kUnsupported;
}

extern "C" int ray_tpu_flash_fwd_f32_smem_bytes(int d) {
  switch (d) {
    case 16: return (int)smem_bytes<16>();
    case 32: return (int)smem_bytes<32>();
    case 64: return (int)smem_bytes<64>();
    case 128: return (int)smem_bytes<128>();
    case 256: return (int)smem_bytes<256>();
  }
  return -1;
}

// the tiles the kernel computes with (the online softmax's q and kv tiles)
// at head_dim d: 0, or kUnsupported for a head_dim it does not take
extern "C" int ray_tpu_flash_fwd_f32_tiles(int d, int* block_q, int* block_k) {
  if (ray_tpu_flash_fwd_f32_smem_bytes(d) < 0) return kUnsupported;
  *block_q = kBlockQ;
  *block_k = kBlockK;
  return 0;
}

extern "C" const char* ray_tpu_flash_fwd_f32_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
