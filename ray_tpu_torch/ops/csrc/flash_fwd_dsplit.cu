// Flash-attention forward for Hopper (sm_90a) at every head_dim that is a
// multiple of 128, d a runtime argument, in bf16, float16 and float32 (the
// kernel's T): design "dsplit", the output's columns split over CTAs.
// Hand-written CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_attention_tpu) at head_dim 896 and up, where the
// reference's dispatcher runs it (a multiple of 128, both lengths multiples
// of 8) and the dispatch table in ops/attention.py (FWD_DESIGNS, by its rule
// DSPLIT_MIN_D) names this design. It computes O = softmax(scale * Q K^T) V
// and the row logsumexp with the TPU kernel's conventions
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
// float32 (3xTF32), with q, k, v and o read or written once. This design
// does more than that work: every one of the G = ceil(d / 256) column groups
// of a row recomputes S, so a visible pair costs (2 G + 2) d operations
// instead of 4 d: at d = 1024 (G = 4) 2.5 times the function's own, at 896
// (G = 4, the last group 128 columns wide) 2.5 times, at 2048 (G = 8) 4.5
// times. It reads Q's chunks again for every kv tile (from L2). It runs on
// mma.sync, which reaches about half of the wgmma rate. A first design that
// is right; PERF.md has its times beside the bound.
//
// The reckoning that sets the tiles:
//   * registers: a warp owns 16 q rows and one group's 256 columns of O in
//     float32 (128 registers a thread), with S of a 32-row kv tile (16) and
//     P (8 in bf16, 32 of 3xTF32 fragments in float32); Q is not kept: its
//     chunks stream with K's, so nothing grows with d;
//   * shared memory: a ring of three stages, each holding either the chunk
//     pair (Q's 64 rows and K's 32 rows of kChunkCols<T> columns: 26112
//     bytes) or V's 32 rows of the group's 256 columns (16896 bytes in bf16,
//     33280 in float32): 78336 bytes in bf16 and float16, 99840 in float32,
//     two CTAs an SM;
//   * four warps, one CTA per (q tile, column group, batch * head).
//
// Design: CTAs in L2 groups of heads (wide.cuh's wide_slot), the heaviest q
// tiles (the last, under the causal mask) first, the G groups of a q tile
// together (they read the same Q and K chunks). For each kv tile that the
// causal mask leaves visible: S over the d / kChunkCols<T> chunk pairs,
// streamed through the ring, in order; the online softmax in log2 units
// (hopper.cuh's online_softmax: the scale must be positive, and the wrapper
// hands a non-positive one's sign to q); O_g = alpha O_g + P V[:, g]. Group
// 0 alone writes lse; every group writes its columns of O. Only a tile that
// crosses the causal diagonal or the end of kv is masked. Each CTA owns its
// output elements: no atomics and no split reduction, so equal inputs give
// equal bits.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_fwd_dsplit(q, k, v, o, lse, bh, t_q, t_kv, d, dtype,
//                                causal, scale, stream)
//   int ray_tpu_flash_fwd_dsplit_tiles(d, &block_q, &block_k)  (the tiles it
//                                                               computes with)
//   int ray_tpu_flash_fwd_dsplit_smem_bytes(dtype)   (dynamic shared memory per CTA)
//   int ray_tpu_flash_fwd_dsplit_ctas_per_sm(dtype)  (CTAs resident on an SM)
// q/o are [bh, t_q, d], k/v [bh, t_kv, d], contiguous bf16 (dtype 0),
// float32 (1) or float16 (2), d a positive multiple of 128, 16-byte aligned;
// lse [bh, t_q] float32; scale > 0. The grid is (heads of a launch) x q
// tiles x column groups on grid.x, at most 2^31 - 1: it launches as many
// times as that takes, on `stream`, allocates nothing, and returns
// cudaGetLastError() after each launch, or kUnsupported for what it does not
// take.

#include "dsplit.cuh"

namespace {

template <typename T>
struct Fwd {
  static constexpr int kBlockQ = 64;
  static constexpr int kBlockK = 32;
  static constexpr int kThreads = kBlockQ / 16 * 32;
  static constexpr int kStages = 3;
  static constexpr int kA = kChunkRow<T>;  // Q and K chunk rows
  static constexpr int kV = kGroupRow<T>;  // V group rows
  static constexpr int kPair = (kBlockQ + kBlockK) * kA;
  static constexpr int kSlot = kPair > kBlockK * kV ? kPair : kBlockK * kV;
  static constexpr int kBytes = kStages * kSlot;
  static_assert(kBytes <= 232448, "shared memory over the 227 KB a block may use");
};

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int bh;       // heads of this launch
  int n_tiles;  // q tiles per head
  int groups;   // column groups per row
  int l2;       // heads per L2 group
  int t_q;
  int t_kv;
  int d;
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

template <typename T>
__global__ void __launch_bounds__(Fwd<T>::kThreads, 1) flash_fwd_dsplit_kernel(const Params p) {
  using L = Fwd<T>;
  constexpr int kBlockQ = L::kBlockQ, kBlockK = L::kBlockK, kThreads = L::kThreads;
  constexpr int kStages = L::kStages, kA = L::kA, kC = kChunkCols<T>;
  constexpr int kCBytes = kC * (int)sizeof(T);
  extern __shared__ __align__(16) uint8_t smem[];

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;  // row within the warp's 8-row half
  const int tq = lane & 3;  // column pair within an 8-column group
  int bh, item;
  wide_slot(p.bh, p.n_tiles * p.groups, p.l2, &bh, &item);
  const int tile = item / p.groups;
  const int cg = item % p.groups;
  const int q0 = (p.n_tiles - 1 - tile) * kBlockQ;  // the heaviest q tiles first
  const int row0 = q0 + 16 * warp;  // the warp's rows: row0 + g, row0 + g + 8
  const int c0 = cg * kGroupCols;   // the group's columns: c0 .. c0 + ncols
  const int ncols = min(kGroupCols, p.d - c0);
  const size_t ld = (size_t)p.d * sizeof(T);
  const char* q = static_cast<const char*>(p.q) + (size_t)bh * p.t_q * ld;
  const char* k = static_cast<const char*>(p.k) + (size_t)bh * p.t_kv * ld;
  const char* v = static_cast<const char*>(p.v) + (size_t)bh * p.t_kv * ld;

  const int n_run = kv_tiles_to_run<kBlockK>(p, q0);
  const int nc = p.d / kC;              // chunks of the contraction over d
  const int n_items = n_run * (nc + 1);  // per kv tile: nc chunk pairs, then V
  auto slot = [&](int i) { return smem + (i % kStages) * L::kSlot; };
  // item i into its slot: chunk c of Q and K of kv tile j, or V's group
  // columns of kv tile j (c == nc); one commit group an item, empty past the
  // end
  auto issue = [&](int i) {
    if (i < n_items) {
      const int j = i / (nc + 1), c = i % (nc + 1);
      const uint32_t dst = smem_u32(slot(i));
      if (c < nc) {
        dsplit_load<kBlockQ, kCBytes, kA, kThreads>(dst, q + c * kCBytes, ld, q0, p.t_q, kCBytes);
        dsplit_load<kBlockK, kCBytes, kA, kThreads>(dst + kBlockQ * kA, k + c * kCBytes, ld,
                                                    j * kBlockK, p.t_kv, kCBytes);
      } else {
        dsplit_load<kBlockK, kGroupCols * (int)sizeof(T), L::kV, kThreads>(
            dst, v + (size_t)c0 * sizeof(T), ld, j * kBlockK, p.t_kv, ncols * (int)sizeof(T));
      }
    }
    cp_async_commit();
  };
  // the next item has landed for every thread and every warp is done with
  // the one before it, whose slot takes the item kStages - 1 ahead
  int at = 0;
  auto next = [&]() {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    issue(at + kStages - 1);
    return slot(at++);
  };
#pragma unroll
  for (int i = 0; i < kStages - 1; ++i) issue(i);

  float o[kGroupCols / 2];
#pragma unroll
  for (int i = 0; i < kGroupCols / 2; ++i) o[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};  // running max, in log2 units
  float l[2] = {0.f, 0.f};          // this thread's share of the row sums
  float alpha[2];

#pragma unroll 1
  for (int j = 0; j < n_run; ++j) {
    float s[kBlockK / 2];  // S, summed over the chunks, then P
#pragma unroll
    for (int i = 0; i < kBlockK / 2; ++i) s[i] = 0.f;
#pragma unroll 1
    for (int c = 0; c < nc; ++c) {
      const uint8_t* pair = next();
      chunk_nt<T, kA, kA, kBlockK>(s, pair + 16 * warp * kA, pair + kBlockQ * kA, lane);
    }
    const int k0 = j * kBlockK;
    const bool masked = (p.causal && q0 + p.off < k0 + kBlockK - 1) || k0 + kBlockK > p.t_kv;
    online_softmax<kBlockK>(s, m, l, alpha, p, k0, row0 + g, tq, masked);
#pragma unroll
    for (int i = 0; i < kGroupCols / 2; ++i) o[i] *= alpha[(i >> 1) & 1];
    group_nn<T, L::kV, kBlockK>(o, s, next(), ncols, lane);
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
    if (cg == 0 && tq == 0 && row < p.t_q) {
      p.lse[(size_t)bh * p.t_q + row] =
          m[r] == kNegInf ? kNegInf + logf(denom) : (m[r] + log2f(denom)) * kLn2;
    }
  }
  store_group<T>(static_cast<T*>(p.o) + (size_t)bh * p.t_q * p.d + c0, p.d, o, inv, row0, p.t_q,
                 ncols, g, tq);
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

template <typename T>
int smem_attribute() {
  return (int)cudaFuncSetAttribute(flash_fwd_dsplit_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, Fwd<T>::kBytes);
}

template <typename T>
int launch(Params p, cudaStream_t stream) {
  using L = Fwd<T>;
  const int err = smem_attribute<T>();
  if (err != 0) return err;
  p.n_tiles = (p.t_q + L::kBlockQ - 1) / L::kBlockQ;
  p.groups = (p.d + kGroupCols - 1) / kGroupCols;
  p.bq_eff = p.t_q < L::kBlockQ ? p.t_q : L::kBlockQ;
  p.bk_eff = p.t_kv < L::kBlockK ? p.t_kv : L::kBlockK;
  const size_t ld = (size_t)p.d * sizeof(T);
  // Q, K and V of one head stream through each q tile's CTAs
  const long long head_bytes = (long long)ld * (p.t_q + 2ll * p.t_kv);
  const Params all = p;
  return launch_heads(all.bh, (long long)p.n_tiles * p.groups, [&](int h0, int heads) {
    Params c = all;
    c.q = static_cast<const char*>(all.q) + (size_t)h0 * all.t_q * ld;
    c.k = static_cast<const char*>(all.k) + (size_t)h0 * all.t_kv * ld;
    c.v = static_cast<const char*>(all.v) + (size_t)h0 * all.t_kv * ld;
    c.o = static_cast<char*>(all.o) + (size_t)h0 * all.t_q * ld;
    c.lse = all.lse + (size_t)h0 * all.t_q;
    c.bh = heads;
    c.l2 = l2_group(head_bytes, heads);
    const unsigned grid = (unsigned)((long long)heads * c.n_tiles * c.groups);
    flash_fwd_dsplit_kernel<T><<<grid, L::kThreads, L::kBytes, stream>>>(c);
    return (int)cudaGetLastError();
  });
}

template <typename T>
int ctas_per_sm() {
  if (smem_attribute<T>() != 0) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, flash_fwd_dsplit_kernel<T>,
                                                    Fwd<T>::kThreads,
                                                    Fwd<T>::kBytes) != cudaSuccess) {
    return -1;
  }
  return per_sm;
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

}  // namespace

extern "C" int ray_tpu_flash_fwd_dsplit_smem_bytes(int dtype) {
  return with_dtype(dtype, -1, [](auto t) { return Fwd<decltype(t)>::kBytes; });
}

extern "C" int ray_tpu_flash_fwd_dsplit_ctas_per_sm(int dtype) {
  return with_dtype(dtype, -1, [](auto t) { return ctas_per_sm<decltype(t)>(); });
}

// the tiles the kernel computes with at head_dim d (in every dtype): 0, or
// kUnsupported for a head_dim it does not take
extern "C" int ray_tpu_flash_fwd_dsplit_tiles(int d, int* block_q, int* block_k) {
  if (d <= 0 || d % 128 != 0) return kUnsupported;
  *block_q = Fwd<float>::kBlockQ;
  *block_k = Fwd<float>::kBlockK;
  return 0;
}

extern "C" int ray_tpu_flash_fwd_dsplit(const void* q, const void* k, const void* v, void* o,
                                        void* lse, int bh, int t_q, int t_kv, int d, int dtype,
                                        int causal, float scale, void* stream) {
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

extern "C" const char* ray_tpu_flash_fwd_dsplit_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype, scale or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
