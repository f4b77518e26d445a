// Flash-attention backward for float32 on the tensor cores (sm_90a),
// hand-written CUDA C++: 3xTF32 on mma.sync. The dispatch table in
// ops/attention.py (BWD_DESIGNS) sends every float32 input here, at
// head_dim 16, 32, 64, 128 and 256.
//
// Replaces the two TPU kernels of ray_tpu/ops/attention.py launched by
// _flash_attention_tpu_bwd there, for float32:
//   * _flash_bwd_dq_kernel  -> flash_bwd_dq_f32x3_kernel  (dQ, kv tiles
//     innermost);
//   * _flash_bwd_dkv_kernel -> flash_bwd_dkv_f32x3_kernel (dK and dV, q
//     tiles innermost).
// Both recompute P = exp(scale * Q K^T - lse) from the forward's row lse,
// then dP = dO V^T and dS = P * (dP - delta) * scale with delta =
// rowsum(dO * O) from the caller (flash_bwd_delta in ops/attention.py, as
// the reference computes it outside its kernels), and accumulate dQ = dS K,
// dK = dS^T Q and dV = P^T dO. The conventions are the reference's, as in
// csrc/flash_bwd.cu:
//   * NEG_INF = -1e30 is a finite mask value; a masked score gives
//     P = exp(NEG_INF - lse) = 0;
//   * under the causal mask q rows are the suffix of the kv context:
//     q_pos = q_idx + (t_kv - t_q), and key k is visible when q_pos >= k;
//   * tiles wholly above the causal diagonal are skipped (a loop bound);
//   * where causal and t_q > t_kv, a row whose lse <= NEG_INF / 2 (it sees
//     no key) gets P = 0: its dQ is 0 and it adds nothing to dK and dV;
//   * padded rows of a ragged last tile are zero-filled and masked.
// The plain version is flash_attention_bwd_plain in ops/attention.py.
//
// Arithmetic: every product is 3xTF32 on mma.sync.m16n8k8 (tf32 in, f32
// accumulate). Each operand x is split into big = cvt.rna.tf32(x) and
// small = cvt.rna.tf32(x - big), so big + small is x to 2^-22 of |x|; a
// product adds small*big', big*small' and big*big' and drops small*small'
// (at most 2^-22 of |x x'|). One TF32 product keeps 11 bits and would miss
// the float32 gate (1e-4 of each row's norm), so float32 asks for three.
// The split and the chained sums (split, mma3_add) are in csrc/tf32x3.cuh,
// which the float32 forward shares. ops/tf32.py repeats the operand
// rounding on the CPU.
//
// What bounds it on an H100: at long t the operations, 6 * d per visible
// (q, k) pair for dQ (S, dP, dQ) and 8 * d for dK/dV (S, dP, dV, dK), at a
// third of the card's dense TF32 rate (494.7 / 3 = 164.9 TFLOP/s); at
// short t the bytes of q, k, v, dO, lse, delta and the gradients.
// Recomputing P from lse keeps the t_q x t_kv matrices out of device
// memory. mma.sync alone reaches about two thirds of the dense TF32 rate
// (flash_bwd_f32_variants measures it), which caps this design at about
// 0.65 of that bound; the splits, loads and float32 adds around the
// products take issue slots besides.
//
// Design: one CTA per (resident tile, batch*head); the other axis's tiles
// are streamed through a two-stage ring of cp.async copies (16 bytes a
// thread, zero-filled past the end), so the next tile's copy overlaps this
// tile's work; the loop over the streamed tiles takes the place of the TPU
// grid's sequential innermost axis. Tiles are float32 in shared memory with
// rows padded by 4 floats, so every fragment load below is free of bank
// conflicts, and each warp splits its fragments as it loads them (a split
// tile in shared memory takes twice the bytes: beside dQ's resident Q and
// dO it fits 64 rows only, which ran slower, and it gained dK/dV little on
// an H100). The accumulator layout of m16n8k8 is not its A layout; a
// product whose A is an accumulator (dS K, P^T dO, dS^T Q) permutes its k
// index instead: k slot t of an 8-wide step is column 2t of the accumulator
// tile and slot t + 4 column 2t + 1, and the B operand's rows are read in
// the same order, which leaves the sum unchanged.
//   * dQ: each warp owns 16 q rows of the resident Q and dO tiles and
//     keeps their dQ in registers; per kv tile it computes S and dP, then
//     dS, then dQ += dS K. Heaviest q tiles (the last, under the causal
//     mask) launch first.
//   * dK/dV: each 16 resident kv rows have two warps (four at d = 256,
//     each pair taking one half of d). The first computes S^T = K Q^T and
//     hands it over in shared memory (in its registers' layout, a float4 a
//     lane) under a named barrier of the group; the second computes
//     dP^T = V dO^T. Both then form P^T; the first accumulates dV += P^T dO,
//     the second dS^T and dK += dS^T Q. At d = 256 both products' halves are
//     handed over and summed in one order, so every warp holds the same P^T,
//     and a warp's accumulator is 16 x 128.
// The rows of each tile shrink with head_dim (DqTiles, DkvTiles) so that
// dynamic shared memory stays within 232448 bytes. Each CTA owns its
// output rows: no atomics and no split reduction, so equal inputs give
// equal bits.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_bwd_dq_f32(q, k, v, dout, lse, delta, dq,
//                                bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dkv_f32(q, k, v, dout, lse, delta, dk, dv,
//                                 bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_f32_smem_bytes(d, dkv)  (dynamic shared memory per CTA)
// q/dout/dq are [bh, t_q, d], k/v/dk/dv [bh, t_kv, d], float32, contiguous,
// 16-byte aligned; lse and delta [bh, t_q] float32; dtype must be 1
// (float32). Each launches one kernel on `stream`, allocates nothing, and
// returns cudaGetLastError() after the launch (or kUnsupported for a
// head_dim, dtype or shape it does not take).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kUnsupported = 100000;
constexpr int kStages = 2;

// A kernel's tiles: kM resident rows and kN streamed rows a stage of the
// ring.
template <int M, int N>
struct Tiles {
  static constexpr int kM = M, kN = N;
};

// dQ: a warp per 16 resident q rows (kM / 16 warps).
template <int D> struct DqTiles;
template <> struct DqTiles<16> : Tiles<64, 64> {};
template <> struct DqTiles<32> : Tiles<64, 64> {};
template <> struct DqTiles<64> : Tiles<64, 64> {};
template <> struct DqTiles<128> : Tiles<128, 32> {};
template <> struct DqTiles<256> : Tiles<64, 16> {};

// dK/dV: two warps per 16 resident kv rows and part of d
// (kM / 8 * kDkvHalves<D> warps). At 256 each warp takes half of d, so that
// its accumulator is 16 x 128 (64 registers) and not 16 x 256 (128, which
// spilled).
template <int D> struct DkvTiles;
template <int D>
constexpr int kDkvHalves = D == 256 ? 2 : 1;
template <> struct DkvTiles<16> : Tiles<64, 64> {};
template <> struct DkvTiles<32> : Tiles<64, 64> {};
template <> struct DkvTiles<64> : Tiles<64, 32> {};
template <> struct DkvTiles<128> : Tiles<64, 32> {};
template <> struct DkvTiles<256> : Tiles<32, 32> {};

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
  int t_q;
  int t_kv;
  int causal;
  int guard;  // causal && t_q > t_kv: the empty-row guard is on
  float scale;
};

// Shared memory: the two resident tiles and kStages stages of the two
// streamed tiles (float32, row stride D + 4); dK/dV adds its hand-over
// tiles (16 x kN each) and each stage's lse and delta.
template <int D>
constexpr size_t dq_smem_bytes() {
  constexpr int kM = DqTiles<D>::kM, kN = DqTiles<D>::kN;
  return (2 * kM + kStages * 2 * kN) * (D + 4) * sizeof(float);
}

// the 16 x kN tiles each 16 dK/dV rows hand over: S^T and, where d is cut,
// both products' parts
template <int kHalves>
constexpr int kHandOverSlots = kHalves == 1 ? 1 : 2 * kHalves;

template <int D>
constexpr size_t dkv_smem_bytes() {
  constexpr int kM = DkvTiles<D>::kM, kN = DkvTiles<D>::kN;
  constexpr int kSlots = kHandOverSlots<kDkvHalves<D>>;
  return ((2 * kM + kStages * 2 * kN) * (D + 4) + kSlots * kM * kN + 2 * kStages * kN) *
         sizeof(float);
}

// kv tiles a q tile runs in the dQ pass: the causal skip as a loop bound.
__device__ __forceinline__ int dq_kv_tiles(const Params& p, int q0, int block_q, int block_k) {
  const int n_kv = (p.t_kv + block_k - 1) / block_k;
  if (!p.causal) return n_kv;
  const int last = min(q0 + block_q, p.t_q) - 1 + (p.t_kv - p.t_q);
  if (last < 0) return 0;
  return min(n_kv, last / block_k + 1);
}

// First q tile a kv tile runs in the dK/dV pass: earlier q tiles lie wholly
// above the causal diagonal.
__device__ __forceinline__ int dkv_first_q_tile(const Params& p, int k0, int block_q) {
  if (!p.causal) return 0;
  const int r0 = k0 - (p.t_kv - p.t_q);  // the first q row that sees key k0
  if (r0 <= 0) return 0;
  if (r0 >= p.t_q) return (p.t_q + block_q - 1) / block_q;
  return r0 / block_q;
}

// e^x as 2^(x log2 e): exp2f is one special-function instruction and a
// scaling, against expf's dozen (3% of dQ and dK/dV on an H100); within
// 2 ulp, and 2^-24 |x| for the scaling, against the gates' 1e-4
__device__ __forceinline__ float exp_of(float x) {
  return exp2f(x * 1.44269504f);
}

// True where the empty-row guard drops a row (its lse is the sentinel).
__device__ __forceinline__ bool sees_no_key(const Params& p, float lse) {
  return p.guard && !(lse > kNegInf * 0.5f);
}

// A fragment (rows g, g + 8; k columns k0 + tig, k0 + tig + 4) of the
// warp's 16 float32 shared rows at `x` (row stride S), split here.
template <int S>
__device__ __forceinline__ void load_a(FragA& f, const float* x, int k0, int g, int tig) {
  const float* p = x + g * S + k0 + tig;
  split(p[0], f.big[0], f.small[0]);
  split(p[8 * S], f.big[1], f.small[1]);
  split(p[4], f.big[2], f.small[2]);
  split(p[8 * S + 4], f.big[3], f.small[3]);
}

// B fragment of Y^T for X Y^T: n is Y's row n0 + g, k its columns k0 + tig
// and k0 + tig + 4.
template <int S>
__device__ __forceinline__ void load_b_nt(FragB& f, const float* y, int n0, int k0, int g,
                                          int tig) {
  const float* p = y + (n0 + g) * S + k0 + tig;
  split(p[0], f.big[0], f.small[0]);
  split(p[4], f.big[1], f.small[1]);
}

// B fragment of Y for X Y with the permuted k index: k slots tig and
// tig + 4 are Y's rows k0 + 2 tig and k0 + 2 tig + 1; n is column n0 + g.
template <int S>
__device__ __forceinline__ void load_b_nn(FragB& f, const float* y, int k0, int n0, int g,
                                          int tig) {
  const float* p = y + (k0 + 2 * tig) * S + n0 + g;
  split(p[0], f.big[0], f.small[0]);
  split(p[S], f.big[1], f.small[1]);
}

// acc[kNT][4] = X Y^T for a warp, summed over kK columns: X its 16 shared
// rows, Y kNT * 8 shared rows, both with row stride D + 4. Element e of n-tile nt is row g + 8 * (e >> 1),
// column nt * 8 + 2 * tig + (e & 1). The loop over k runs unrolled by
// kUnroll (2 or 4; the dQ kernel, which holds two such products, ran 4%
// faster at 2 on an H100, dK/dV 4% slower).
template <int D, int kNT, int kK = D, int kUnroll = 4>
__device__ __forceinline__ void gemm_nt(float (*acc)[4], const float* x, const float* y, int g,
                                        int tig) {
  constexpr int S = D + 4;
#pragma unroll
  for (int nt = 0; nt < kNT; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
  const auto step = [&](int k0) {
    FragA a;
    load_a<S>(a, x, k0, g, tig);
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
      FragB b;
      load_b_nt<S>(b, y, nt * 8, k0, g, tig);
      mma3_add(acc[nt], a, b);
    }
  };
  if constexpr (kUnroll == 2) {
#pragma unroll 2
    for (int k0 = 0; k0 < kK; k0 += 8) step(k0);
  } else {
#pragma unroll 4
    for (int k0 = 0; k0 < kK; k0 += 8) step(k0);
  }
}

// out[kCols / 8][4] += X Y[:, c0:c0 + kCols] for a warp: X [16 x K] in the
// accumulator layout of gemm_nt (x[K / 8][4]), Y K shared rows [K, D] with
// row stride D + 4, from column c0.
template <int D, int kCols, int K>
__device__ __forceinline__ void gemm_acc_nn(float (*out)[4], const float (*x)[4], const float* y,
                                            int c0, int g, int tig) {
  constexpr int S = D + 4;
  constexpr int kSteps = K / 8;
  constexpr int kChunk = kSteps < kChunkRows / 8 ? kSteps : kChunkRows / 8;
#pragma unroll
  for (int s0 = 0; s0 < kSteps; s0 += kChunk) {
    FragA a[kChunk];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) acc_to_a(a[i], x[s0 + i]);
#pragma unroll
    for (int nt = 0; nt < kCols / 8; ++nt) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        FragB b;
        load_b_nn<S>(b, y, (s0 + i) * 8, c0 + nt * 8, g, tig);
        mma3(part, a[i], b);
      }
#pragma unroll
      for (int e = 0; e < 4; ++e) out[nt][e] += part[e];
    }
  }
}

// Writes a warp's accumulator rows (tile rows r, r + 8, global row0 + r;
// columns c0..) as float32, rows past `rows` dropped.
template <int D, int kCols>
__device__ __forceinline__ void store_rows(float* dst, const float (*acc)[4], int row0, int r,
                                           int c0, int rows, int tig) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + r + i * 8;
    if (row < rows) {
      float* out = dst + (size_t)row * D + c0 + tig * 2;
#pragma unroll
      for (int nt = 0; nt < kCols / 8; ++nt) {
        *reinterpret_cast<float2*>(out + nt * 8) = make_float2(acc[nt][2 * i], acc[nt][2 * i + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D>
__global__ void __launch_bounds__(DqTiles<D>::kM * 2)
    flash_bwd_dq_f32x3_kernel(const Params p) {
  constexpr int kM = DqTiles<D>::kM, kN = DqTiles<D>::kN, S = D + 4;
  constexpr int kThreads = kM * 2;  // a warp per 16 rows
  constexpr int kTile = kN * S;     // one streamed tile of a stage
  constexpr int kNT = kN / 8;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kM * S;
  float* stages = dOs + kM * S;  // kStages x (K, V)

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // mma group: row within the 8-row half
  const int tig = lane & 3;  // thread in group
  const int r0 = warp * 16;  // the warp's tile rows: r0 + g, r0 + g + 8
  // the heaviest q tiles (the last, under the causal mask) launch first
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kM;
  const size_t bh = blockIdx.y;
  const float* k = p.k + bh * p.t_kv * D;
  const float* v = p.v + bh * p.t_kv * D;
  const int off = p.t_kv - p.t_q;

  load_tile<D, kM, kThreads>(Qs, p.q + bh * p.t_q * D, q0, p.t_q);
  load_tile<D, kM, kThreads>(dOs, p.dout + bh * p.t_q * D, q0, p.t_q);
  const int n_run = dq_kv_tiles(p, q0, kM, kN);
  if (n_run > 0) {
    load_tile<D, kN, kThreads>(stages, k, 0, p.t_kv);
    load_tile<D, kN, kThreads>(stages + kTile, v, 0, p.t_kv);
  }
  cp_async_commit();

  float lse_r[2], delta_r[2];
  bool dead[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + g + i * 8;
    const bool live = row < p.t_q;
    lse_r[i] = live ? p.lse[bh * p.t_q + row] : 0.f;
    delta_r[i] = live ? p.delta[bh * p.t_q + row] : 0.f;
    dead[i] = !live || sees_no_key(p, lse_r[i]);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }

  for (int j = 0; j < n_run; ++j) {
    cp_async_wait_all();  // tile j has landed
    __syncthreads();      // for every warp, and every warp is done with tile j - 1
    if (j + 1 < n_run) {  // tile j + 1 lands under tile j's work
      float* next = stages + ((j + 1) % kStages) * 2 * kTile;
      load_tile<D, kN, kThreads>(next, k, (j + 1) * kN, p.t_kv);
      load_tile<D, kN, kThreads>(next + kTile, v, (j + 1) * kN, p.t_kv);
    }
    cp_async_commit();
    const float* Kt = stages + (j % kStages) * 2 * kTile;
    const float* Vt = Kt + kTile;
    const int k0 = j * kN;

    float s[kNT][4];
    float dp[kNT][4];
    gemm_nt<D, kNT, D, 2>(s, Qs + r0 * S, Kt, g, tig);
    gemm_nt<D, kNT, D, 2>(dp, dOs + r0 * S, Vt, g, tig);
    // P = exp(scale * S - lse), then dS = P * (dP - delta) * scale in s
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        const int kp = k0 + nt * 8 + tig * 2 + (e & 1);
        float x = s[nt][e] * p.scale;
        if (p.causal && q0 + r0 + g + i * 8 + off < kp) x = kNegInf;
        if (kp >= p.t_kv) x = kNegInf;
        const float pe = dead[i] ? 0.f : exp_of(x - lse_r[i]);
        s[nt][e] = pe * (dp[nt][e] - delta_r[i]) * p.scale;
      }
    }
    // dQ += dS K
    gemm_acc_nn<D, D, kN>(acc, s, Kt, 0, g, tig);
  }
  cp_async_wait_all();
  store_rows<D, D>(p.dq + bh * p.t_q * D, acc, q0, r0 + g, 0, p.t_q, tig);
}

// ---------------------------------------------------------------------------
// dK/dV
// ---------------------------------------------------------------------------

// One streamed q tile (rows q0..q0 + kN) into a stage: Q and dO, lse and
// delta beside them.
template <int D, int kN, int kThreads>
__device__ __forceinline__ void load_q_stage(const Params& p, size_t bh, int q0, float* stage,
                                             float* lse_s, float* delta_s) {
  load_tile<D, kN, kThreads>(stage, p.q + bh * p.t_q * D, q0, p.t_q);
  load_tile<D, kN, kThreads>(stage + kN * (D + 4), p.dout + bh * p.t_q * D, q0, p.t_q);
  for (int i = threadIdx.x; i < kN; i += kThreads) {
    const int row = q0 + i;
    const bool ok = row < p.t_q;
    const size_t src = bh * p.t_q + (ok ? row : 0);
    cp_async4(lse_s + i, p.lse + src, ok);
    cp_async4(delta_s + i, p.delta + src, ok);
  }
}

template <int D>
__global__ void __launch_bounds__(DkvTiles<D>::kM * 4 * kDkvHalves<D>)
    flash_bwd_dkv_f32x3_kernel(const Params p) {
  constexpr int kM = DkvTiles<D>::kM, kN = DkvTiles<D>::kN, S = D + 4;
  constexpr int kHalves = kDkvHalves<D>;
  constexpr int kDc = D / kHalves;    // d columns a warp sums over and owns
  constexpr int kGroups = kM / 16;
  constexpr int kGroupThreads = 2 * kHalves * 32;
  constexpr int kThreads = kGroups * kGroupThreads;
  constexpr int kSlots = kHandOverSlots<kHalves>;
  constexpr int kTile = kN * S;  // one streamed tile of a stage
  constexpr int kNT = kN / 8;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kM * S;
  float* stages = Vs + kM * S;                    // kStages x (Q, dO)
  float* slot_s = stages + kStages * 2 * kTile;   // kGroups x kSlots x 16 x kN
  float* lse_s = slot_s + kSlots * kM * kN;       // kStages x kN
  float* delta_s = lse_s + kStages * kN;          // kStages x kN

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int group = warp % kGroups;
  const int role = warp / kGroups;
  // even roles: S^T, P^T, dV; odd: dP^T, dS^T, dK; over d columns c0..
  const bool p_side = (role & 1) == 0;
  const int c0 = (role >> 1) * kDc;
  const int r0 = group * 16;  // the group's kv rows: r0 + g, r0 + g + 8
  const int k0 = blockIdx.x * kM;
  const size_t bh = blockIdx.y;
  const int off = p.t_kv - p.t_q;
  // the group's hand-over tiles, at this lane's first float4: role r's
  // product (S^T or dP^T over its d columns) in slot r; with d whole, only
  // S^T (slot 0)
  float4* slots = reinterpret_cast<float4*>(slot_s) + group * kSlots * kNT * 32 + lane;

  load_tile<D, kM, kThreads>(Ks, p.k + bh * p.t_kv * D, k0, p.t_kv);
  load_tile<D, kM, kThreads>(Vs, p.v + bh * p.t_kv * D, k0, p.t_kv);
  const int first = dkv_first_q_tile(p, k0, kN);
  const int n_q = (p.t_q + kN - 1) / kN;
  if (first < n_q) {
    load_q_stage<D, kN, kThreads>(p, bh, first * kN, stages, lse_s, delta_s);
  }
  cp_async_commit();

  float acc[kDc / 8][4];  // dV on the P^T side, dK on the dS^T side
#pragma unroll
  for (int nt = 0; nt < kDc / 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }

  for (int qt = first, j = 0; qt < n_q; ++qt, ++j) {
    cp_async_wait_all();  // tile j has landed
    __syncthreads();      // for every warp, and every warp is done with tile j - 1
    if (qt + 1 < n_q) {   // tile j + 1 lands under tile j's work
      const int nx = (j + 1) % kStages;
      load_q_stage<D, kN, kThreads>(p, bh, (qt + 1) * kN, stages + nx * 2 * kTile,
                                    lse_s + nx * kN, delta_s + nx * kN);
    }
    cp_async_commit();
    const int st = j % kStages;
    const float* Qt = stages + st * 2 * kTile;
    const float* dOt = Qt + kTile;
    const float* lse_t = lse_s + st * kN;
    const float* delta_t = delta_s + st * kN;
    const int q0 = qt * kN;

    // rows are kv, columns q: element e of n-tile nt is kv row
    // r0 + g + 8 * (e >> 1), q column nt * 8 + 2 * tig + (e & 1).
    // S^T = K Q^T or dP^T = V dO^T over the warp's d columns
    float s[kNT][4];
    gemm_nt<D, kNT, kDc>(s, (p_side ? Ks : Vs) + r0 * S + c0, (p_side ? Qt : dOt) + c0, g,
                         tig);
    if (p_side || kHalves > 1) hand_over<kNT>(slots + role * kNT * 32, s);
    group_sync(1 + group, kGroupThreads);
    // S^T, then P^T = exp(scale * S^T - lse) in pt; the halves of d summed
    // in order, so that every warp of the group holds the same bits
    float pt[kNT][4];
    if (kHalves == 1 && p_side) {
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) pt[nt][e] = s[nt][e];
      }
    } else {
      take_over<kNT>(pt, slots);
#pragma unroll
      for (int h = 1; h < kHalves; ++h) {
        float more[kNT][4];
        take_over<kNT>(more, slots + 2 * h * kNT * 32);
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
          for (int e = 0; e < 4; ++e) pt[nt][e] += more[nt][e];
        }
      }
    }
#pragma unroll
    for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        const int kp = k0 + r0 + g + (e >> 1) * 8;
        const float l = lse_t[col];
        float x = pt[nt][e] * p.scale;
        if (p.causal && q0 + col + off < kp) x = kNegInf;
        if (kp >= p.t_kv) x = kNegInf;
        const bool dead = q0 + col >= p.t_q || sees_no_key(p, l);
        pt[nt][e] = dead ? 0.f : exp_of(x - l);
      }
    }
    if (p_side) {
      // dV[:, c0:] += P^T dO[:, c0:]
      gemm_acc_nn<D, kDc, kN>(acc, pt, dOt, c0, g, tig);
    } else {
      // dS^T = P^T * (dP^T - delta) * scale, dP^T's halves summed in order
      if constexpr (kHalves > 1) {
        take_over<kNT>(s, slots + kNT * 32);
#pragma unroll
        for (int h = 1; h < kHalves; ++h) {
          float more[kNT][4];
          take_over<kNT>(more, slots + (2 * h + 1) * kNT * 32);
#pragma unroll
          for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] += more[nt][e];
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < kNT; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = nt * 8 + tig * 2 + (e & 1);
          pt[nt][e] = pt[nt][e] * (s[nt][e] - delta_t[col]) * p.scale;
        }
      }
      // dK[:, c0:] += dS^T Q[:, c0:]
      gemm_acc_nn<D, kDc, kN>(acc, pt, Qt, c0, g, tig);
    }
  }
  cp_async_wait_all();
  store_rows<D, kDc>((p_side ? p.dv : p.dk) + bh * p.t_kv * D, acc, k0, r0 + g, c0, p.t_kv,
                     tig);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// b * h on grid.y, at most 65535 heads a launch: more heads launch in
// chunks of the grid's tiles (grid.x) by kMaxGridY heads, each with its
// tensors moved on to its first head (a 1-D grid of tiles and heads held bh
// in a register, which the float32 forward's kernel had none to spare for)
constexpr int kMaxGridY = 65535;

template <int D, typename Kernel>
int launch(Kernel kernel, int tiles, int bh, int threads, size_t smem, cudaStream_t stream,
           const Params& p) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const size_t q_head = (size_t)p.t_q * D, kv_head = (size_t)p.t_kv * D;
  for (int h0 = 0; h0 < bh; h0 += kMaxGridY) {
    Params c = p;
    c.q += h0 * q_head;
    c.k += h0 * kv_head;
    c.v += h0 * kv_head;
    c.dout += h0 * q_head;
    c.lse += (size_t)h0 * p.t_q;
    c.delta += (size_t)h0 * p.t_q;
    if (c.dq != nullptr) c.dq += h0 * q_head;
    if (c.dk != nullptr) c.dk += h0 * kv_head;
    if (c.dv != nullptr) c.dv += h0 * kv_head;
    kernel<<<dim3(tiles, min(kMaxGridY, bh - h0)), threads, smem, stream>>>(c);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int D>
int launch_d(bool dkv, int bh, cudaStream_t st, const Params& p) {
  if (dkv) {
    constexpr int kM = DkvTiles<D>::kM;
    return launch<D>(flash_bwd_dkv_f32x3_kernel<D>, (p.t_kv + kM - 1) / kM, bh,
                     kM * 4 * kDkvHalves<D>, dkv_smem_bytes<D>(), st, p);
  }
  constexpr int kM = DqTiles<D>::kM;
  return launch<D>(flash_bwd_dq_f32x3_kernel<D>, (p.t_q + kM - 1) / kM, bh, kM * 2,
                   dq_smem_bytes<D>(), st, p);
}

int dispatch(bool dkv, const Params& p, int bh, int d, int dtype, void* stream) {
  if (bh <= 0 || p.t_q <= 0 || p.t_kv <= 0 || dtype != 1) return kUnsupported;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_d<16>(dkv, bh, st, p);
    case 32: return launch_d<32>(dkv, bh, st, p);
    case 64: return launch_d<64>(dkv, bh, st, p);
    case 128: return launch_d<128>(dkv, bh, st, p);
    case 256: return launch_d<256>(dkv, bh, st, p);
  }
  return kUnsupported;
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, int t_q, int t_kv, int causal,
                   float scale) {
  Params p = {};
  p.q = static_cast<const float*>(q);
  p.k = static_cast<const float*>(k);
  p.v = static_cast<const float*>(v);
  p.dout = static_cast<const float*>(dout);
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.t_q = t_q;
  p.t_kv = t_kv;
  p.causal = causal;
  p.guard = causal && t_q > t_kv;
  p.scale = scale;
  return p;
}

}  // namespace

extern "C" int ray_tpu_flash_bwd_dq_f32(const void* q, const void* k, const void* v,
                                        const void* dout, const void* lse, const void* delta,
                                        void* dq, int bh, int t_q, int t_kv, int d, int dtype,
                                        int causal, float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, t_q, t_kv, causal, scale);
  p.dq = static_cast<float*>(dq);
  return dispatch(false, p, bh, d, dtype, stream);
}

extern "C" int ray_tpu_flash_bwd_dkv_f32(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dk, void* dv, int bh, int t_q, int t_kv, int d,
                                         int dtype, int causal, float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, t_q, t_kv, causal, scale);
  p.dk = static_cast<float*>(dk);
  p.dv = static_cast<float*>(dv);
  return dispatch(true, p, bh, d, dtype, stream);
}

extern "C" int ray_tpu_flash_bwd_f32_smem_bytes(int d, int dkv) {
  switch (d) {
    case 16: return (int)(dkv ? dkv_smem_bytes<16>() : dq_smem_bytes<16>());
    case 32: return (int)(dkv ? dkv_smem_bytes<32>() : dq_smem_bytes<32>());
    case 64: return (int)(dkv ? dkv_smem_bytes<64>() : dq_smem_bytes<64>());
    case 128: return (int)(dkv ? dkv_smem_bytes<128>() : dq_smem_bytes<128>());
    case 256: return (int)(dkv ? dkv_smem_bytes<256>() : dq_smem_bytes<256>());
  }
  return -1;
}

extern "C" const char* ray_tpu_flash_bwd_f32_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
