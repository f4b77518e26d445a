// Flash-attention backward for Hopper (sm_90a) at head_dim 384, 512, 640 and 768,
// bf16 or float16 (the kernels' T; the comments say bf16 for either): design
// "wide", mma.sync m16n8k16 fed by ldmatrix from cp.async tiles, d cut
// between warps. Hand-written CUDA C++.
//
// Replaces the two TPU kernels of ray_tpu/ops/attention.py launched by
// _flash_attention_tpu_bwd, for bf16 and float16 at head_dim 384, 512, 640 and 768
// (BWD_DESIGNS in ops/attention.py):
//   * _flash_bwd_dq_kernel  -> flash_bwd_dq_wide_kernel  (dQ);
//   * _flash_bwd_dkv_kernel -> flash_bwd_dkv_wide_kernel (dK and dV).
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
// What bounds them on an H100: the tensor-core operations, 6 * d per visible
// (q, k) pair for dQ (S, dP, dQ) and 8 * d for dK/dV (S^T, dP^T, dV, dK) at
// 989 TFLOP/s in bf16. These first kernels run on mma.sync, which reaches
// about half of the wgmma rate, and read every operand through ldmatrix; on
// an H100 they read about a tenth of the bound, shared memory first, as the
// forward (flash_fwd_wide.cu).
//
// The reckoning that sets the tiles (rows of 2 d + 16 bytes, 1040 at 512):
//   * registers: an accumulator of 16 rows by 512 columns in float32 is 256
//     registers a thread, above the 255 cap, so each warp owns 128 columns of
//     d (64 registers) and the fragments of its resident tile over them
//     (32); the D / 128 warps of the same rows sum S and dP (or S^T and dP^T)
//     over their columns and hand the partial sums over in shared memory
//     (wide.cuh), so every warp holds the same P and dS. An SM's 65536
//     registers bound the warps of a CTA: dQ's threads take about 240 at
//     384 and 512 (the build's report), so it keeps 8 warps or fewer;
//   * dQ: at 384 and 512 two row groups (Q and dO resident, 32 rows each),
//     from 640 on one (16 rows, 5 or 6 warps). At 512 Q and dO (67 KB), two
//     stages of K and V of 16 rows (67 KB) and the partials of S and dP
//     (16 KB) take 150 KB; at 384 stages of 32 rows: 175 KB; at 640 and 768
//     16-row stages: 135 and 161 KB. 32-row stages at 512 would take exactly
//     the 232448 bytes a block may use, with nothing to spare;
//   * dK/dV: K and V resident, 16 rows each (33 KB at 512), two stages of Q
//     and dO with their lse and delta, 32 rows at 384 and 512 and 16 from
//     640 on, the partials of S^T and dP^T: 138, 183, 135 and 162 KB at 384,
//     512, 640 and 768; a warp per 128 columns on each side (S^T, P^T, dV;
//     dP^T, dS^T, dK), 2 d / 128 warps: 12 at 768 leave 168 registers a
//     thread, in which the build fits it without a spill;
//   * at 896 dK/dV's 14 warps leave at most 146 registers a thread; the
//     build takes 128 and spills (48 bytes stored, 84 loaded; 32 and 64 at
//     1024), while dQ and the forward do not: the design stops at 768.
//
// Design, both kernels: one CTA per (resident tile, batch * head), heads in
// L2 groups; the other side's tiles stream through a two-stage cp.async ring
// (16 bytes a thread, zero-filled past the end), so the next stage's copy
// overlaps this stage's products. The loop over the streamed tiles takes the
// place of the TPU grid's sequential innermost axis and skips the tiles
// wholly above the causal diagonal. Each CTA owns its output rows: no
// atomics and no split reduction, so equal inputs give equal bits.
//   * dQ (32 or 16 q rows, row groups of D / 128 warps): per stage each warp's
//     partial S and dP, summed; P and dS in registers, dS rounded to bf16 in
//     the A-operand layout; dQ += dS K over the warp's columns. Heaviest q
//     tiles (the last, under the causal mask) first.
//   * dK/dV (16 kv rows, D / 128 warps a side): per stage the P side's warps
//     form S^T = K Q^T and the dS side's dP^T = V dO^T over their columns,
//     one barrier, every warp sums the partials of S^T (and the dS side
//     those of dP^T); P^T and dS^T in registers; dV += P^T dO on the P side,
//     dK += dS^T Q on the other. The q loop starts at the first q tile that
//     sees the CTA's first key; kv tile 0 (the heaviest) first.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_bwd_dq_wide(q, k, v, dout, lse, delta, dq,
//                                 bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dkv_wide(q, k, v, dout, lse, delta, dk, dv,
//                                  bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_wide_smem_bytes(d, dkv)   (dynamic shared memory per CTA)
//   int ray_tpu_flash_bwd_wide_ctas_per_sm(d, dkv)  (CTAs resident on an SM)
// q/dout/dq are [bh, t_q, d], k/v/dk/dv [bh, t_kv, d], contiguous bf16 (dtype
// 0) or float16 (dtype 2), d 384, 512, 640 or 768, 16-byte aligned; lse and delta
// [bh, t_q] float32. Each launches one kernel on `stream`, allocates nothing,
// and returns cudaGetLastError() after the launch, or kUnsupported for what
// it does not take.

#include "wide.cuh"

namespace {

constexpr int kStages = 2;

// dQ: kM resident q rows (two row groups), kN streamed kv rows a stage
template <int D>
struct Dq {
  static constexpr int kHalves = D / kWideCols;
  static constexpr int kM = D <= 512 ? 32 : 16;
  static constexpr int kN = D == 384 ? 32 : 16;
  static constexpr int kGroups = kM / 16;
  static constexpr int kThreads = kGroups * kHalves * 32;
  static constexpr int kDO = kM * kRowBytes<D>;              // Q first
  static constexpr int kRing = kDO + kM * kRowBytes<D>;      // kStages x (K, V)
  static constexpr int kTile = kN * kRowBytes<D>;
  static constexpr int kSlots = kRing + kStages * 2 * kTile;  // S's and dP's partials
  static constexpr int kBytes = kSlots + kGroups * 2 * kHalves * 16 * kN * 4;
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block may use");
};

// dK/dV: kM resident kv rows, kN streamed q rows a stage
template <int D>
struct Dkv {
  static constexpr int kHalves = D / kWideCols;
  static constexpr int kM = 16;
  static constexpr int kN = D <= 512 ? 32 : 16;
  static constexpr int kThreads = 2 * kHalves * 32;
  static constexpr int kV = kM * kRowBytes<D>;               // K first
  static constexpr int kRing = kV + kM * kRowBytes<D>;       // kStages x (Q, dO)
  static constexpr int kTile = kN * kRowBytes<D>;
  static constexpr int kStats = kRing + kStages * 2 * kTile;  // kStages x (lse, delta)
  static constexpr int kSlots = kStats + kStages * 2 * kN * 4;  // S^T's and dP^T's partials
  static constexpr int kBytes = kSlots + 2 * kHalves * 16 * kN * 4;
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
  int bh;       // batch * heads
  int n_tiles;  // the CTA's own tiles per head (q for dQ, kv for dK/dV)
  int group;    // heads per launch group
  int t_q;
  int t_kv;
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

template <int D, typename T>
__global__ void __launch_bounds__(Dq<D>::kThreads, 1) flash_bwd_dq_wide_kernel(const Params p) {
  using L = Dq<D>;
  constexpr int kHalves = L::kHalves, kThreads = L::kThreads, kM = L::kM, kN = L::kN;
  constexpr int kSlotF4 = kN / 8 * 32;  // float4s of one warp's partial
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_u32(smem);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int group = warp % L::kGroups;
  const int half = warp / L::kGroups;
  const int c0 = half * kWideCols;
  int bh, tile;
  wide_slot(p.bh, p.n_tiles, p.group, &bh, &tile);
  const int q0 = (p.n_tiles - 1 - tile) * kM;  // the heaviest q tiles first
  const int row0 = q0 + 16 * group;           // the warp's rows: row0 + g, row0 + g + 8
  const size_t q_head = (size_t)bh * p.t_q * D, kv_head = (size_t)bh * p.t_kv * D;
  const T* k = static_cast<const T*>(p.k) + kv_head;
  const T* v = static_cast<const T*>(p.v) + kv_head;

  // kv tiles the q tile runs: the causal skip as a loop bound
  const int n_kv = (p.t_kv + kN - 1) / kN;
  const int last = min(q0 + kM, p.t_q) - 1 + p.off;
  const int n_run = !p.causal ? n_kv : (last < 0 ? 0 : min(n_kv, last / kN + 1));
  auto stage = [&](int j) { return base + L::kRing + (j % kStages) * 2 * L::kTile; };
  auto issue = [&](int j) {
    if (j < n_run) {
      load_rows<D, kN, kThreads>(stage(j), k, j * kN, p.t_kv);
      load_rows<D, kN, kThreads>(stage(j) + L::kTile, v, j * kN, p.t_kv);
    }
    cp_async_commit();
  };
  load_rows<D, kM, kThreads>(base, static_cast<const T*>(p.q) + q_head, q0, p.t_q);
  load_rows<D, kM, kThreads>(base + L::kDO, static_cast<const T*>(p.dout) + q_head, q0, p.t_q);
  issue(0);

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

  float dq[kWideCols / 2];
#pragma unroll
  for (int i = 0; i < kWideCols / 2; ++i) dq[i] = 0.f;
  uint32_t qa[kWideCols / 16][4], da[kWideCols / 16][4];  // Q's and dO's fragments
  float4* const slots =
      reinterpret_cast<float4*>(smem + L::kSlots) + group * 2 * kHalves * kSlotF4 + lane;

#pragma unroll 1
  for (int j = 0; j < n_run; ++j) {
    cp_async_wait<0>();  // stage j has landed
    __syncthreads();     // for every warp, and every warp is done with stage j - 1
    issue(j + 1);        // stage j + 1 lands under stage j's work
    const uint32_t kt = stage(j), vt = kt + L::kTile;
    if (j == 0) {
      wide_a_frags<D, kWideCols>(qa, base + 16 * group * kRowBytes<D>, c0, lane);
      wide_a_frags<D, kWideCols>(da, base + L::kDO + 16 * group * kRowBytes<D>, c0, lane);
    }
    float s[kN / 2], dp[kN / 2];
    wide_nt<D, kN, kWideCols, T>(s, qa, kt, c0, lane);
    wide_nt<D, kN, kWideCols, T>(dp, da, vt, c0, lane);
    // the row group's partials: slot 2 h is half h's S, 2 h + 1 its dP
    put_partial<kN>(slots + 2 * half * kSlotF4, s);
    put_partial<kN>(slots + (2 * half + 1) * kSlotF4, dp);
    warps_sync(1 + group, kHalves * 32);
    sum_partials<kN, kHalves>(s, slots, 2 * kSlotF4);
    sum_partials<kN, kHalves>(dp, slots + kSlotF4, 2 * kSlotF4);
    // P = exp2(S * scale * log2 e - lse * log2 e), dS = P * (dP - delta) in
    // T; masks (causal, past t_kv) where the tile crosses them
    const int k0 = j * kN;
    const bool masked = (p.causal && q0 + p.off < k0 + kN - 1) || k0 + kN > p.t_kv;
    uint32_t dsa[kN / 4];
#pragma unroll
    for (int i = 0; i < kN / 2; i += 2) {
      const int r = (i >> 1) & 1;
      float p0 = fast_exp2(fmaf(s[i], p.scale_log2, -lse2[r]));
      float p1 = fast_exp2(fmaf(s[i + 1], p.scale_log2, -lse2[r]));
      if (masked) {
        const int col = k0 + 8 * (i >> 2) + 2 * tq;  // columns col, col + 1
        const int row = row0 + g + 8 * r;
        if (col >= p.t_kv || (p.causal && row + p.off < col)) p0 = 0.f;
        if (col + 1 >= p.t_kv || (p.causal && row + p.off < col + 1)) p1 = 0.f;
      }
      dsa[i / 2] = pack2<T>(p0 * (dp[i] - dl[r]), p1 * (dp[i + 1] - dl[r]));
    }
    wide_nn<D, kN, kWideCols, T>(dq, dsa, kt, c0, lane);
  }
  cp_async_wait<0>();
  const float scale[2] = {p.scale, p.scale};
  store_wide_rows<D, kWideCols, T>(static_cast<T*>(p.dq) + q_head, dq, scale, row0, p.t_q, c0,
                                   g, tq);
}

// ---------------------------------------------------------------------------
// dK/dV
// ---------------------------------------------------------------------------

template <int D, typename T>
__global__ void __launch_bounds__(Dkv<D>::kThreads, 1) flash_bwd_dkv_wide_kernel(const Params p) {
  using L = Dkv<D>;
  constexpr int kHalves = L::kHalves, kThreads = L::kThreads, kM = L::kM, kN = L::kN;
  constexpr int kSlotF4 = kN / 8 * 32;  // float4s of one warp's partial
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_u32(smem);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tq = lane & 3;
  const int half = warp % kHalves;
  const bool p_side = warp < kHalves;  // S^T, P^T, dV; the other side dP^T, dS^T, dK
  const int c0 = half * kWideCols;
  int bh, tile;
  wide_slot(p.bh, p.n_tiles, p.group, &bh, &tile);
  const int k0 = tile * kM;  // kv tile 0, the heaviest under the causal mask, first
  const size_t q_head = (size_t)bh * p.t_q * D, kv_head = (size_t)bh * p.t_kv * D;
  const T* q = static_cast<const T*>(p.q) + q_head;
  const T* dout = static_cast<const T*>(p.dout) + q_head;

  // the first q tile that sees key k0: earlier ones lie wholly above the
  // causal diagonal
  const int n_q = (p.t_q + kN - 1) / kN;
  int first = 0;
  if (p.causal) {
    const int r0 = k0 - p.off;  // the first q row that sees key k0
    first = r0 <= 0 ? 0 : (r0 >= p.t_q ? n_q : r0 / kN);
  }
  auto stage = [&](int j) { return base + L::kRing + (j % kStages) * 2 * L::kTile; };
  auto stats = [&](int j) { return base + L::kStats + (j % kStages) * 2 * kN * 4; };
  // q tile qt (the loop's j-th) into its stage: Q, dO, and their rows' lse
  // and delta (zeros past t_q)
  auto issue = [&](int qt, int j) {
    if (qt < n_q) {
      load_rows<D, kN, kThreads>(stage(j), q, qt * kN, p.t_q);
      load_rows<D, kN, kThreads>(stage(j) + L::kTile, dout, qt * kN, p.t_q);
      for (int i = threadIdx.x; i < kN; i += kThreads) {
        const int row = qt * kN + i;
        const size_t at = (size_t)bh * p.t_q + min(row, p.t_q - 1);
        const int bytes = row < p.t_q ? 4 : 0;
        cp_async_4(stats(j) + 4 * i, p.lse + at, bytes);
        cp_async_4(stats(j) + 4 * (kN + i), p.delta + at, bytes);
      }
    }
    cp_async_commit();
  };
  load_rows<D, kM, kThreads>(base, static_cast<const T*>(p.k) + kv_head, k0, p.t_kv);
  load_rows<D, kM, kThreads>(base + L::kV, static_cast<const T*>(p.v) + kv_head, k0, p.t_kv);
  issue(first, 0);

  float acc[kWideCols / 2];  // dV on the P side, dK / scale on the other
#pragma unroll
  for (int i = 0; i < kWideCols / 2; ++i) acc[i] = 0.f;
  uint32_t ka[kWideCols / 16][4];  // K's fragments on the P side, V's on the other
  float4* const slots = reinterpret_cast<float4*>(smem + L::kSlots) + lane;
  const int kv0 = k0 + g;  // the thread's kv rows: kv0 and kv0 + 8

#pragma unroll 1
  for (int qt = first, j = 0; qt < n_q; ++qt, ++j) {
    cp_async_wait<0>();  // stage j has landed
    __syncthreads();     // for every warp, and every warp is done with stage j - 1
    issue(qt + 1, j + 1);
    const uint32_t qtile = stage(j), dotile = qtile + L::kTile;
    const float* rows = reinterpret_cast<const float*>(smem + (stats(j) - base));
    if (j == 0) wide_a_frags<D, kWideCols>(ka, p_side ? base : base + L::kV, c0, lane);
    // rows are kv, columns q: S^T = K Q^T or dP^T = V dO^T over the warp's
    // columns; slot 2 h is half h's S^T, 2 h + 1 its dP^T
    float x[kN / 2];
    wide_nt<D, kN, kWideCols, T>(x, ka, p_side ? qtile : dotile, c0, lane);
    put_partial<kN>(slots + (2 * half + (p_side ? 0 : 1)) * kSlotF4, x);
    __syncthreads();
    float pt[kN / 2];
    sum_partials<kN, kHalves>(pt, slots, 2 * kSlotF4);
    // P^T = exp2(S^T * scale * log2 e - lse * log2 e); masks where the tile
    // crosses the diagonal or the ragged end of kv
    const int q0 = qt * kN;
    const bool masked = (p.causal && q0 + p.off < k0 + kM - 1) || k0 + kM > p.t_kv;
#pragma unroll
    for (int i = 0; i < kN / 2; ++i) {
      const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
      const int kv = kv0 + 8 * ((i >> 1) & 1);
      const float l = rows[col];
      float pe = fast_exp2(fmaf(pt[i], p.scale_log2, -l * kLog2e));
      if (q0 + col >= p.t_q || sees_no_key(p, l)) pe = 0.f;
      if (masked && (kv >= p.t_kv || (p.causal && q0 + col + p.off < kv))) pe = 0.f;
      pt[i] = pe;
    }
    uint32_t a[kN / 4];
    if (p_side) {
      to_a<kN, T>(pt, a);
      wide_nn<D, kN, kWideCols, T>(acc, a, dotile, c0, lane);  // dV += P^T dO
    } else {
      sum_partials<kN, kHalves>(x, slots + kSlotF4, 2 * kSlotF4);  // dP^T
#pragma unroll
      for (int i = 0; i < kN / 2; ++i) {
        const int col = 8 * (i >> 2) + 2 * tq + (i & 1);
        x[i] = pt[i] * (x[i] - rows[kN + col]);
      }
      to_a<kN, T>(x, a);
      wide_nn<D, kN, kWideCols, T>(acc, a, qtile, c0, lane);  // dK += dS^T Q
    }
  }
  cp_async_wait<0>();
  const float mul[2] = {p_side ? 1.f : p.scale, p_side ? 1.f : p.scale};
  store_wide_rows<D, kWideCols, T>(static_cast<T*>(p_side ? p.dv : p.dk) + kv_head, acc, mul,
                                   k0, p.t_kv, c0, g, tq);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int D, typename T>
int smem_attribute(bool dkv) {
  return dkv ? (int)cudaFuncSetAttribute(flash_bwd_dkv_wide_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Dkv<D>::kBytes)
             : (int)cudaFuncSetAttribute(flash_bwd_dq_wide_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Dq<D>::kBytes);
}

template <int D, typename T>
int launch(bool dkv, Params p, cudaStream_t stream) {
  const int err = smem_attribute<D, T>(dkv);
  if (err != 0) return err;
  if (dkv) {
    p.n_tiles = (p.t_kv + Dkv<D>::kM - 1) / Dkv<D>::kM;
    p.group = l2_group(4ll * p.t_q * D, p.bh);  // Q and dO of one head, 2 bytes an element
    flash_bwd_dkv_wide_kernel<D, T>
        <<<p.n_tiles * p.bh, Dkv<D>::kThreads, Dkv<D>::kBytes, stream>>>(p);
  } else {
    p.n_tiles = (p.t_q + Dq<D>::kM - 1) / Dq<D>::kM;
    p.group = l2_group(4ll * p.t_kv * D, p.bh);  // K and V of one head
    flash_bwd_dq_wide_kernel<D, T><<<p.n_tiles * p.bh, Dq<D>::kThreads, Dq<D>::kBytes, stream>>>(p);
  }
  return (int)cudaGetLastError();
}

template <int D>
int ctas_per_sm(bool dkv) {
  if (smem_attribute<D, __nv_bfloat16>(dkv) != 0) return -1;
  int per_sm = 0;
  const cudaError_t err =
      dkv ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, flash_bwd_dkv_wide_kernel<D, __nv_bfloat16>, Dkv<D>::kThreads,
                Dkv<D>::kBytes)
          : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                &per_sm, flash_bwd_dq_wide_kernel<D, __nv_bfloat16>, Dq<D>::kThreads,
                Dq<D>::kBytes);
  return err == cudaSuccess ? per_sm : -1;
}

int dispatch(bool dkv, const Params& p, int d, int dtype, void* stream) {
  const long long rows = p.t_q > p.t_kv ? p.t_q : p.t_kv;
  if (p.bh <= 0 || p.t_q <= 0 || p.t_kv <= 0 || (dtype != 0 && dtype != 2) ||
      (long long)p.bh * ((rows + 15) / 16) > 0x7fffffffll) {
    return kUnsupported;
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_wide_head_dim(d, kUnsupported, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return dtype == 2 ? launch<D, __half>(dkv, p, st) : launch<D, __nv_bfloat16>(dkv, p, st);
  });
}

Params make_params(const void* q, const void* k, const void* v, const void* dout,
                   const void* lse, const void* delta, int bh, int t_q, int t_kv, int causal,
                   float scale) {
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
  p.off = t_kv - t_q;
  p.causal = causal;
  p.guard = causal && t_q > t_kv;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  return p;
}

}  // namespace

extern "C" int ray_tpu_flash_bwd_dq_wide(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dq, int bh, int t_q, int t_kv, int d, int dtype,
                                         int causal, float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, bh, t_q, t_kv, causal, scale);
  p.dq = dq;
  return dispatch(false, p, d, dtype, stream);
}

extern "C" int ray_tpu_flash_bwd_dkv_wide(const void* q, const void* k, const void* v,
                                          const void* dout, const void* lse, const void* delta,
                                          void* dk, void* dv, int bh, int t_q, int t_kv, int d,
                                          int dtype, int causal, float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, bh, t_q, t_kv, causal, scale);
  p.dk = dk;
  p.dv = dv;
  return dispatch(true, p, d, dtype, stream);
}

extern "C" int ray_tpu_flash_bwd_wide_smem_bytes(int d, int dkv) {
  return with_wide_head_dim(d, -1, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return dkv ? Dkv<D>::kBytes : Dq<D>::kBytes;
  });
}

extern "C" int ray_tpu_flash_bwd_wide_ctas_per_sm(int d, int dkv) {
  return with_wide_head_dim(d, -1,
                            [&](auto dc) { return ctas_per_sm<decltype(dc)::value>(dkv != 0); });
}

extern "C" const char* ray_tpu_flash_bwd_wide_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
