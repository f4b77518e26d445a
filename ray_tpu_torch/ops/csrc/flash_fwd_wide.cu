// Flash-attention forward for Hopper (sm_90a) at head_dim 384, 512, 640 and
// 768, bf16 or float16 (the kernel's T; the comments say bf16 for either):
// design "wide", mma.sync m16n8k16 fed by ldmatrix from cp.async tiles, d
// cut between warps. Hand-written CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_attention_tpu) for bf16 and float16 at head_dim 384,
// 512, 640 and 768, where the reference's dispatcher runs it (head_dim a
// multiple of 128) and the dispatch table in ops/attention.py (FWD_DESIGNS) names this
// design. It computes O = softmax(scale * Q K^T) V and the row logsumexp with
// the TPU kernel's conventions (flash_fwd_wgmma.cu's header lists them) at
// the table's tiles, 32 q rows by 64 kv rows at 384 and 512, 16 by 64 at 640
// and 16 by 32 at 768 (the reference's block_q = min(block_q, t_q), block_k
// = min(block_k, t_kv)); flash_attention_fwd_plain in ops/attention.py is
// the same algorithm at the same tiles.
//
// What bounds it on an H100: the tensor-core operations, 4 * d per visible
// (q, k) pair at 989 TFLOP/s in bf16; the ex2 of a pair is an eighth of that
// at d = 512. This first design is on mma.sync, which reaches about half of
// the wgmma rate, and reads every operand through ldmatrix: on an H100 it
// reads about a tenth of the bound, since per kv tile a warp's ldmatrix of K
// and V and its share of the partial-S hand-over (64 ldmatrix.x4 and 40
// 16-byte accesses for 128 mma) take more shared-memory cycles than its
// products take tensor cycles, with 8 warps an SM to hide them.
//
// The reckoning that sets the tiles:
//   * registers: O of 16 rows by 512 columns in float32 is 256 registers a
//     thread, above the 255 cap, so each warp owns 128 columns of d (64
//     registers), with Q's fragments over them (32) and S (32) and P (16);
//     the D / 128 warps of the same rows each sum S over their 128 columns
//     and hand the partial sums over in shared memory (wide.cuh). A thread
//     takes about 236 registers (the build's report at 384 and 512), so an
//     SM's 65536 hold 8 warps of them: 2 row groups of 16 q rows at 384 and
//     512, one from 640 on (5 or 6 warps);
//   * shared memory (rows of 2 d + 16 bytes): at 512 Q 32 rows (33 KB), a
//     ring of two 64-row K or V pieces (133 KB) and the hand-over of S's
//     partials (32 KB), 199 KB of the 227 KB; at 640 Q 16 rows, the same
//     ring and hand-over, 207 KB; at 768 64-row pieces would take 248 KB, so
//     kv tiles are 32 rows: 136 KB;
//   * one CTA an SM;
//   * the design stops at 768 with its backward (flash_bwd_wide.cu: dK/dV
//     spills at 896); this kernel builds without a spill at 896 and 1024.
//
// Design: one CTA per (q tile, batch * head), heads in L2 groups and
// the heaviest q tiles (the last, under the causal mask) first. Q lands once;
// K then V of each kv tile stream through a two-stage cp.async ring,
// so each piece's copy overlaps the previous piece's products. Per kv tile a
// warp forms its partial S, the warps of its rows sum them (one named
// barrier a row group), each takes the online softmax in log2 units
// (hopper.cuh's online_softmax, so the scale must be positive: the wrapper
// hands a non-positive one's sign to q), rescales its O and adds P V over its
// columns. Only a tile that crosses the causal diagonal or the end of kv is
// masked. Each CTA owns its output rows: no atomics and no split reduction,
// so equal inputs give equal bits.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_fwd_wide(q, k, v, o, lse, bh, t_q, t_kv, d, dtype,
//                              causal, scale, stream)
//   int ray_tpu_flash_fwd_wide_tiles(d, &block_q, &block_k)  (the tiles it
//                                                             computes with)
//   int ray_tpu_flash_fwd_wide_smem_bytes(d)   (dynamic shared memory per CTA)
//   int ray_tpu_flash_fwd_wide_ctas_per_sm(d)  (CTAs resident on an SM)
// q/o are [bh, t_q, d], k/v [bh, t_kv, d], contiguous bf16 (dtype 0) or
// float16 (dtype 2), d 384, 512, 640 or 768, 16-byte aligned; lse [bh, t_q]
// float32; scale > 0. It launches one kernel on `stream`, allocates nothing, and
// returns cudaGetLastError() after the launch, or kUnsupported for what it
// does not take.

#include "wide.cuh"

namespace {

constexpr int kStages = 2;   // ring of pieces: K, then V, of each kv tile

// q rows (row groups of 16) and kv rows of a tile, threads and shared memory
// (bytes) of the kernel at head_dim D
template <int D>
struct Fwd {
  static constexpr int kBlockQ = D <= 512 ? 32 : 16;
  static constexpr int kBlockK = D <= 640 ? 64 : 32;
  static constexpr int kGroups = kBlockQ / 16;
  static constexpr int kHalves = D / kWideCols;  // warps a row group
  static constexpr int kThreads = kGroups * kHalves * 32;
  static constexpr int kRing = kBlockQ * kRowBytes<D>;  // Q first
  static constexpr int kPiece = kBlockK * kRowBytes<D>;  // a K or V piece
  static constexpr int kSlots = kRing + kStages * kPiece;  // S's partials
  static constexpr int kBytes = kSlots + kGroups * kHalves * 16 * kBlockK * 4;
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block may use");
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int bh;       // batch * heads
  int n_q;      // q tiles per head
  int group;    // heads per launch group
  int t_q;
  int t_kv;
  int off;      // t_kv - t_q
  int bq_eff;   // min(block_q, t_q): the reference's block_q
  int bk_eff;   // min(block_k, t_kv): the reference's block_k
  int causal;
  float scale_log2;  // scale * log2(e)
};

// Number of kv tiles the q tile at q0 processes: the reference's causal skip
// ((qi * bq + bq - 1 + off) < ki * bk skips tile ki) as a loop bound.
template <int kBlockK>
__device__ __forceinline__ int kv_tiles_to_run(const Params& p, int q0) {
  const int n_kv = (p.t_kv + kBlockK - 1) / kBlockK;
  if (!p.causal) return n_kv;
  const int last = q0 + p.bq_eff - 1 + p.off;
  if (last < 0) return 0;
  return min(n_kv, last / kBlockK + 1);
}

template <int D, typename T>
__global__ void __launch_bounds__(Fwd<D>::kThreads, 1) flash_fwd_wide_kernel(const Params p) {
  using L = Fwd<D>;
  constexpr int kHalves = L::kHalves, kThreads = L::kThreads;
  constexpr int kBlockQ = L::kBlockQ, kBlockK = L::kBlockK, kGroups = L::kGroups;
  constexpr int kSlotF4 = kBlockK / 8 * 32;  // float4s of one warp's partial of S
  extern __shared__ __align__(16) uint8_t smem[];
  const uint32_t base = smem_u32(smem);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // row within the warp's 8-row half
  const int tq = lane & 3;   // column pair within an 8-column group
  const int group = warp % kGroups;
  const int half = warp / kGroups;
  const int c0 = half * kWideCols;  // the warp's d columns
  int bh, tile;
  wide_slot(p.bh, p.n_q, p.group, &bh, &tile);
  const int q0 = (p.n_q - 1 - tile) * kBlockQ;  // the heaviest q tiles first
  const int row0 = q0 + 16 * group;            // the warp's rows: row0 + g, row0 + g + 8
  const T* k = static_cast<const T*>(p.k) + (size_t)bh * p.t_kv * D;
  const T* v = static_cast<const T*>(p.v) + (size_t)bh * p.t_kv * D;

  const int n_run = kv_tiles_to_run<kBlockK>(p, q0);
  const int n_pieces = 2 * n_run;
  auto piece = [&](int i) { return base + L::kRing + (i % kStages) * L::kPiece; };
  // piece i of the stream into its slot (even: K, odd: V of kv tile i / 2),
  // one commit group a piece, empty past the end
  auto issue = [&](int i) {
    if (i < n_pieces) {
      load_rows<D, kBlockK, kThreads>(piece(i), i % 2 ? v : k, i / 2 * kBlockK, p.t_kv);
    }
    cp_async_commit();
  };
  // piece i has landed for every thread and every warp is done with piece
  // i - 1, whose slot takes piece i + 1
  auto next = [&](int i) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(i + kStages - 1);
    return piece(i);
  };

  // Q lands with piece 0
  load_rows<D, kBlockQ, kThreads>(base, static_cast<const T*>(p.q) + (size_t)bh * p.t_q * D,
                                  q0, p.t_q);
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float o[kWideCols / 2];
#pragma unroll
  for (int i = 0; i < kWideCols / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, in log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float alpha[2];
  uint32_t qa[kWideCols / 16][4];   // Q's fragments over the warp's columns
  float s[kBlockK / 2];             // S (the partial, then the sum), then P
  uint32_t pa[kBlockK / 4];         // P in T, the A operand of P V
  float4* const slots =
      reinterpret_cast<float4*>(smem + L::kSlots) + group * kHalves * kSlotF4 + lane;

#pragma unroll 1
  for (int j = 0; j < n_run; ++j) {
    const int k0 = j * kBlockK;
    const uint32_t kt = next(2 * j);
    if (j == 0) wide_a_frags<D, kWideCols>(qa, base + 16 * group * kRowBytes<D>, c0, lane);
    wide_nt<D, kBlockK, kWideCols, T>(s, qa, kt, c0, lane);
    put_partial<kBlockK>(slots + half * kSlotF4, s);
    warps_sync(1 + group, kHalves * 32);
    sum_partials<kBlockK, kHalves>(s, slots, kSlotF4);
    const bool masked = (p.causal && q0 + p.off < k0 + kBlockK - 1) || k0 + kBlockK > p.t_kv;
    online_softmax<kBlockK>(s, m, l, alpha, p, k0, row0 + g, tq, masked);
#pragma unroll
    for (int i = 0; i < kWideCols / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    to_a<kBlockK, T>(s, pa);
    wide_nn<D, kBlockK, kWideCols, T>(o, pa, next(2 * j + 1), c0, lane);
  }
  cp_async_wait<0>();

  // row sums, lse and O / denominator
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float denom = l[r] == 0.f ? 1.f : l[r];
    inv[r] = 1.f / denom;
    const int row = row0 + g + 8 * r;
    if (half == 0 && tq == 0 && row < p.t_q) {
      p.lse[(size_t)bh * p.t_q + row] =
          m[r] == kNegInf ? kNegInf + logf(denom) : (m[r] + log2f(denom)) * kLn2;
    }
  }
  store_wide_rows<D, kWideCols, T>(static_cast<T*>(p.o) + (size_t)bh * p.t_q * D, o, inv, row0,
                                   p.t_q, c0, g, tq);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <int D, typename T>
int smem_attribute() {
  return (int)cudaFuncSetAttribute(flash_fwd_wide_kernel<D, T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, Fwd<D>::kBytes);
}

template <int D, typename T>
int launch(Params p, cudaStream_t stream) {
  const int err = smem_attribute<D, T>();
  if (err != 0) return err;
  p.n_q = (p.t_q + Fwd<D>::kBlockQ - 1) / Fwd<D>::kBlockQ;
  p.bq_eff = p.t_q < Fwd<D>::kBlockQ ? p.t_q : Fwd<D>::kBlockQ;
  p.bk_eff = p.t_kv < Fwd<D>::kBlockK ? p.t_kv : Fwd<D>::kBlockK;
  flash_fwd_wide_kernel<D, T><<<p.n_q * p.bh, Fwd<D>::kThreads, Fwd<D>::kBytes, stream>>>(p);
  return (int)cudaGetLastError();
}

template <int D>
int ctas_per_sm() {
  if (smem_attribute<D, __nv_bfloat16>() != 0) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, flash_fwd_wide_kernel<D, __nv_bfloat16>, Fwd<D>::kThreads,
          Fwd<D>::kBytes) != cudaSuccess) {
    return -1;
  }
  return per_sm;
}

}  // namespace

extern "C" int ray_tpu_flash_fwd_wide_smem_bytes(int d) {
  return with_wide_head_dim(d, -1, [](auto dc) { return Fwd<decltype(dc)::value>::kBytes; });
}

extern "C" int ray_tpu_flash_fwd_wide_ctas_per_sm(int d) {
  return with_wide_head_dim(d, -1, [](auto dc) { return ctas_per_sm<decltype(dc)::value>(); });
}

// the tiles the kernel computes with at head_dim d: 0, or kUnsupported for a
// head_dim it does not take
extern "C" int ray_tpu_flash_fwd_wide_tiles(int d, int* block_q, int* block_k) {
  return with_wide_head_dim(d, kUnsupported, [&](auto dc) {
    *block_q = Fwd<decltype(dc)::value>::kBlockQ;
    *block_k = Fwd<decltype(dc)::value>::kBlockK;
    return 0;
  });
}

extern "C" int ray_tpu_flash_fwd_wide(const void* q, const void* k, const void* v, void* o,
                                      void* lse, int bh, int t_q, int t_kv, int d, int dtype,
                                      int causal, float scale, void* stream) {
  if (bh <= 0 || t_q <= 0 || t_kv <= 0 || (dtype != 0 && dtype != 2) || !(scale > 0.f) ||
      (long long)bh * ((t_q + 15) / 16) > 0x7fffffffll) {
    return kUnsupported;
  }
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.bh = bh;
  p.group = l2_group(4ll * t_kv * d, bh);  // K and V of one head, 2 bytes an element
  p.t_q = t_q;
  p.t_kv = t_kv;
  p.off = t_kv - t_q;
  p.causal = causal;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return with_wide_head_dim(d, kUnsupported, [&](auto dc) {
    constexpr int D = decltype(dc)::value;
    return dtype == 2 ? launch<D, __half>(p, st) : launch<D, __nv_bfloat16>(p, st);
  });
}

extern "C" const char* ray_tpu_flash_fwd_wide_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype, scale or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
