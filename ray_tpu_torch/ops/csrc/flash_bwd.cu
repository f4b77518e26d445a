// Flash-attention backward on mma.sync (sm_90a), hand-written CUDA C++. No
// kernel of this file is on a path: the dispatch table in ops/attention.py
// (BWD_DESIGNS) sends bf16 at head_dim 16 and 32 to
// csrc/flash_bwd_persistent.cu, bf16 at 64, 128 and 256 to
// csrc/flash_bwd_wgmma.cu (this file builds no bf16 kernel at 256), and
// float32 to csrc/flash_bwd_f32.cu (3xTF32 on the tensor cores). Only the
// variants scripts launch these kernels, to time them beside their
// successors: ops/flash_bwd_variants.py --small-d the bf16 ones (mma.sync),
// ops/flash_bwd_f32_variants.py the float32 ones (CUDA cores).
//
// Replaces the two TPU kernels of ray_tpu/ops/attention.py launched by
// _flash_attention_tpu_bwd there:
//   * _flash_bwd_dq_kernel  -> flash_bwd_dq_*  (dQ, kv tiles innermost);
//   * _flash_bwd_dkv_kernel -> flash_bwd_dkv_* (dK and dV, q tiles innermost).
// Both recompute P = exp(scale * Q K^T - lse) from the forward's row lse,
// then dP = dO V^T and dS = P * (dP - delta) * scale with
// delta = rowsum(dO * O) (computed by the caller, as the reference computes
// it outside its kernels), and accumulate dQ = dS K, dK = dS^T Q and
// dV = P^T dO. The conventions are the reference's:
//   * NEG_INF = -1e30 is a finite mask value; a masked score gives
//     P = exp(NEG_INF - lse) = 0;
//   * under the causal mask q rows are the suffix of the kv context:
//     q_pos = q_idx + (t_kv - t_q), and key k is visible when q_pos >= k;
//   * tiles wholly above the causal diagonal are skipped (a loop bound);
//   * where causal and t_q > t_kv, a row whose lse <= NEG_INF / 2 (it sees
//     no key) gets P = 0: its dQ is 0 and it adds nothing to dK and dV;
//   * padded kv columns of a ragged last tile are masked and K, V there are
//     zero; padded q rows of a ragged last tile add nothing and read no lse
//     or delta.
// The plain version in ops/attention.py (flash_attention_bwd_plain) is the
// same arithmetic in float32 over the whole score matrix.
//
// What bounds it on an H100: at long t the tensor-core operations, 6 * d
// per visible (q, k) pair for dQ (S, dP, dQ) and 8 * d for dK/dV (S, dP,
// dV, dK); at short t the bytes of q, k, v, dO, lse, delta and the
// gradients. Recomputing P from lse keeps the t_q x t_kv matrices out of
// device memory, which is what makes the operations, not the bytes, the
// bound.
//
// Design: one CTA per (64-row tile, batch*head); the loop over the other
// axis's 64-row tiles runs inside the CTA and takes the place of the TPU
// grid's sequential innermost axis. Each CTA owns its output tile, so there
// are no atomics and no split reduction: equal inputs give equal bits. Each
// warp owns 16 rows; all products run on mma.sync m16n8k16 (bf16 in, f32
// accumulate), with the accumulators in registers. The dK/dV kernel
// computes S^T = K Q^T and dP^T = V dO^T directly, so that P^T and dS^T come
// out in the accumulator layout, which is the A-operand layout of
// dV += P^T dO and dK += dS^T Q (the forward's trick for P V). P and dS are
// rounded to bf16 before they feed an mma. Tiles sit in shared memory with rows padded by 16 bytes. There is no
// cp.async pipelining, ldmatrix or wgmma/TMA. The float32 kernels here take
// a CUDA-core path with the same tiles (one thread per row); they are not
// tuned and spill.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_bwd_dq(q, k, v, dout, lse, delta, dq,
//                            bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_dkv(q, k, v, dout, lse, delta, dk, dv,
//                             bh, t_q, t_kv, d, dtype, causal, scale, stream)
// q/dout/dq are [bh, t_q, d], k/v/dk/dv [bh, t_kv, d], contiguous; lse and
// delta [bh, t_q] float32; dtype 0 = bf16, 1 = float32. Each launches one
// kernel on `stream`, allocates nothing, and returns cudaGetLastError()
// after the launch (or kUnsupported for a head_dim/dtype it does not take:
// bf16 at 256 among them).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsBf16 = 128;  // four warps, one 16-row group each
constexpr int kThreadsF32 = 64;    // one thread per row
constexpr float kNegInf = -1e30f;
constexpr int kUnsupported = 100000;

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
  int t_q;
  int t_kv;
  int causal;
  int guard;  // causal && t_q > t_kv: the empty-row guard is on
  float scale;
};

// kv tiles a q tile runs in the dQ pass: the causal skip as a loop bound.
__device__ __forceinline__ int dq_kv_tiles(const Params& p, int q0) {
  const int n_kv = (p.t_kv + kBlockK - 1) / kBlockK;
  if (!p.causal) return n_kv;
  const int last = min(q0 + kBlockQ, p.t_q) - 1 + (p.t_kv - p.t_q);
  if (last < 0) return 0;
  return min(n_kv, last / kBlockK + 1);
}

// First q tile a kv tile runs in the dK/dV pass: earlier q tiles lie wholly
// above the causal diagonal.
__device__ __forceinline__ int dkv_first_q_tile(const Params& p, int k0) {
  if (!p.causal) return 0;
  const int r0 = k0 - (p.t_kv - p.t_q);  // the first q row that sees key k0
  if (r0 <= 0) return 0;
  if (r0 >= p.t_q) return (p.t_q + kBlockQ - 1) / kBlockQ;
  return r0 / kBlockQ;
}

// True where the empty-row guard drops a row (its lse is the sentinel).
__device__ __forceinline__ bool sees_no_key(const Params& p, float lse) {
  return p.guard && !(lse > kNegInf * 0.5f);
}

__device__ __forceinline__ void mma_bf16_16816(float* c, uint32_t a0,
                                               uint32_t a1, uint32_t a2,
                                               uint32_t a3, uint32_t b0,
                                               uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ uint32_t ld_u32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Two bf16 of one column from two consecutive shared rows (a B operand
// whose k runs down the rows).
__device__ __forceinline__ uint32_t ld_col_pair(const uint16_t* p, int stride) {
  return uint32_t(p[0]) | (uint32_t(p[stride]) << 16);
}

// Copies rows [row0, row0 + 64) of a [rows, D] bf16 matrix into a shared
// tile with row stride D + 8, 16 bytes per thread per step; rows past the
// end are zero.
template <int D, int kThreads>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst,
                                               const uint16_t* src, int row0,
                                               int rows) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < 64 * kChunks; c += kThreads) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + col) = val;
  }
}

// acc[8][4] = A B^T for a warp: A is 16 shared rows (a_row, a_row + 8) and
// B is 64 shared rows, both [*, D] with row stride S (m16 x n64 x kD).
template <int D>
__device__ __forceinline__ void gemm_rows_nt(float (*acc)[4],
                                             const uint16_t* A, int a_row,
                                             const uint16_t* B, int g,
                                             int tig) {
  constexpr int S = D + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  }
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int c = kk * 16 + tig * 2;
    const uint32_t a0 = ld_u32(A + a_row * S + c);
    const uint32_t a1 = ld_u32(A + (a_row + 8) * S + c);
    const uint32_t a2 = ld_u32(A + a_row * S + c + 8);
    const uint32_t a3 = ld_u32(A + (a_row + 8) * S + c + 8);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const uint16_t* br = B + (nt * 8 + g) * S + c;
      mma_bf16_16816(acc[nt], a0, a1, a2, a3, ld_u32(br), ld_u32(br + 8));
    }
  }
}

// out[D/8][4] += X B for a warp: X [16 x 64] is in the accumulator layout
// of gemm_rows_nt (rounded to bf16 here), B is 64 shared rows [64, D].
template <int D>
__device__ __forceinline__ void gemm_acc_nn(float (*out)[4], float (*x)[4],
                                            const uint16_t* B, int g, int tig) {
  constexpr int S = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t a0 = pack_bf16(x[2 * kk][0], x[2 * kk][1]);
    const uint32_t a1 = pack_bf16(x[2 * kk][2], x[2 * kk][3]);
    const uint32_t a2 = pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    const uint32_t a3 = pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3]);
    const uint16_t* b = B + (kk * 16 + tig * 2) * S + g;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const uint16_t* bp = b + dt * 8;
      mma_bf16_16816(out[dt], a0, a1, a2, a3, ld_col_pair(bp, S),
                     ld_col_pair(bp + 8 * S, S));
    }
  }
}

// Writes a warp's accumulator rows (row, row + 8 of a tile at global row
// row0) as bf16, rows past `rows` dropped.
template <int D>
__device__ __forceinline__ void store_rows_bf16(uint16_t* dst, float (*acc)[4],
                                                int row0, int row, int rows,
                                                int tig) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = row0 + row + i * 8;
    if (r < rows) {
      uint16_t* out = dst + (size_t)r * D + tig * 2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(out + dt * 8) =
            pack_bf16(acc[dt][2 * i], acc[dt][2 * i + 1]);
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16)
    flash_bwd_dq_bf16_kernel(const Params p) {
  constexpr int S = D + 8;  // shared row stride, bf16 elements
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Qs = smem;
  uint16_t* dOs = Qs + kBlockQ * S;
  uint16_t* Ks = dOs + kBlockQ * S;
  uint16_t* Vs = Ks + kBlockK * S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // mma group: row within the 8-row half
  const int tig = lane & 3;  // thread in group: column pair
  const int r_lo = warp * 16 + g;  // tile rows owned: r_lo, r_lo + 8
  const int q0 = blockIdx.x * kBlockQ;
  const size_t bh = blockIdx.y;
  const uint16_t* q = static_cast<const uint16_t*>(p.q) + bh * p.t_q * D;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + bh * p.t_kv * D;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + bh * p.t_kv * D;
  const uint16_t* dout = static_cast<const uint16_t*>(p.dout) + bh * p.t_q * D;
  uint16_t* dq = static_cast<uint16_t*>(p.dq) + bh * p.t_q * D;
  const int off = p.t_kv - p.t_q;

  load_tile_bf16<D, kThreadsBf16>(Qs, q, q0, p.t_q);
  load_tile_bf16<D, kThreadsBf16>(dOs, dout, q0, p.t_q);
  float lse_r[2], delta_r[2];
  bool dead[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r_lo + i * 8;
    const bool live = row < p.t_q;
    lse_r[i] = live ? p.lse[bh * p.t_q + row] : 0.f;
    delta_r[i] = live ? p.delta[bh * p.t_q + row] : 0.f;
    dead[i] = !live || sees_no_key(p, lse_r[i]);
  }

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }

  const int n_run = dq_kv_tiles(p, q0);
  for (int kt = 0; kt < n_run; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D, kThreadsBf16>(Ks, k, k0, p.t_kv);
    load_tile_bf16<D, kThreadsBf16>(Vs, v, k0, p.t_kv);
    __syncthreads();

    // P = exp(scale * Q K^T - lse); element e of n-tile nt sits at row
    // r_lo + 8*(e>>1), column nt*8 + tig*2 + (e&1)
    float s[8][4];
    gemm_rows_nt<D>(s, Qs, r_lo, Ks, g, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = r_lo + (e >> 1) * 8;
        const int kp = k0 + nt * 8 + tig * 2 + (e & 1);
        float x = s[nt][e] * p.scale;
        if (p.causal && q0 + row + off < kp) x = kNegInf;
        if (kp >= p.t_kv) x = kNegInf;
        s[nt][e] = dead[e >> 1] ? 0.f : expf(x - lse_r[e >> 1]);
      }
    }
    // dS = P * (dO V^T - delta) * scale
    float ds[8][4];
    gemm_rows_nt<D>(ds, dOs, r_lo, Vs, g, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        ds[nt][e] = s[nt][e] * (ds[nt][e] - delta_r[e >> 1]) * p.scale;
      }
    }
    // dQ += dS K
    gemm_acc_nn<D>(acc, ds, Ks, g, tig);
  }
  store_rows_bf16<D>(dq, acc, q0, r_lo, p.t_q, tig);
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16)
    flash_bwd_dkv_bf16_kernel(const Params p) {
  constexpr int S = D + 8;  // shared row stride, bf16 elements
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Ks = smem;
  uint16_t* Vs = Ks + kBlockK * S;
  uint16_t* Qs = Vs + kBlockK * S;
  uint16_t* dOs = Qs + kBlockQ * S;
  float* lse_s = reinterpret_cast<float*>(dOs + kBlockQ * S);
  float* delta_s = lse_s + kBlockQ;
  bool* dead_s = reinterpret_cast<bool*>(delta_s + kBlockQ);

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;
  const int tig = lane & 3;
  const int r_lo = warp * 16 + g;  // kv rows owned: r_lo, r_lo + 8
  const int k0 = blockIdx.x * kBlockK;
  const size_t bh = blockIdx.y;
  const uint16_t* q = static_cast<const uint16_t*>(p.q) + bh * p.t_q * D;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + bh * p.t_kv * D;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + bh * p.t_kv * D;
  const uint16_t* dout = static_cast<const uint16_t*>(p.dout) + bh * p.t_q * D;
  uint16_t* dk = static_cast<uint16_t*>(p.dk) + bh * p.t_kv * D;
  uint16_t* dv = static_cast<uint16_t*>(p.dv) + bh * p.t_kv * D;
  const int off = p.t_kv - p.t_q;

  load_tile_bf16<D, kThreadsBf16>(Ks, k, k0, p.t_kv);
  load_tile_bf16<D, kThreadsBf16>(Vs, v, k0, p.t_kv);

  float dk_acc[D / 8][4];
  float dv_acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) dk_acc[dt][e] = dv_acc[dt][e] = 0.f;
  }

  const int n_q = (p.t_q + kBlockQ - 1) / kBlockQ;
  for (int qt = dkv_first_q_tile(p, k0); qt < n_q; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();  // every warp is done with the previous Q/dO tile
    load_tile_bf16<D, kThreadsBf16>(Qs, q, q0, p.t_q);
    load_tile_bf16<D, kThreadsBf16>(dOs, dout, q0, p.t_q);
    for (int i = threadIdx.x; i < kBlockQ; i += kThreadsBf16) {
      const int row = q0 + i;
      const bool live = row < p.t_q;
      const float l = live ? p.lse[bh * p.t_q + row] : 0.f;
      lse_s[i] = l;
      delta_s[i] = live ? p.delta[bh * p.t_q + row] : 0.f;
      dead_s[i] = !live || sees_no_key(p, l);
    }
    __syncthreads();

    // P^T = exp(scale * K Q^T - lse): rows are kv, columns q; element e of
    // n-tile nt sits at kv row r_lo + 8*(e>>1), q column nt*8 + tig*2 + (e&1)
    float s[8][4];
    gemm_rows_nt<D>(s, Ks, r_lo, Qs, g, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        const int kp = k0 + r_lo + (e >> 1) * 8;
        float x = s[nt][e] * p.scale;
        if (p.causal && q0 + col + off < kp) x = kNegInf;
        if (kp >= p.t_kv) x = kNegInf;
        s[nt][e] = dead_s[col] ? 0.f : expf(x - lse_s[col]);
      }
    }
    // dV += P^T dO
    gemm_acc_nn<D>(dv_acc, s, dOs, g, tig);
    // dS^T = P^T * (V dO^T - delta) * scale
    float ds[8][4];
    gemm_rows_nt<D>(ds, Vs, r_lo, dOs, g, tig);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        ds[nt][e] = s[nt][e] * (ds[nt][e] - delta_s[col]) * p.scale;
      }
    }
    // dK += dS^T Q
    gemm_acc_nn<D>(dk_acc, ds, Qs, g, tig);
  }
  store_rows_bf16<D>(dk, dk_acc, k0, r_lo, p.t_kv, tig);
  store_rows_bf16<D>(dv, dv_acc, k0, r_lo, p.t_kv, tig);
}

// float32 on the CUDA cores: one thread per q row, K and V tiles in shared
// memory, the same tiles, skip, masking and guard as the bf16 kernel.
template <int D>
__global__ void __launch_bounds__(kThreadsF32)
    flash_bwd_dq_f32_kernel(const Params p) {
  extern __shared__ __align__(16) float fsmem[];
  float* Ks = fsmem;
  float* Vs = fsmem + kBlockK * D;

  const int q0 = blockIdx.x * kBlockQ;
  const size_t bh = blockIdx.y;
  const int qrow = q0 + threadIdx.x;
  const bool live = qrow < p.t_q;
  const float* qr = static_cast<const float*>(p.q) + (bh * p.t_q + qrow) * D;
  const float* dor = static_cast<const float*>(p.dout) + (bh * p.t_q + qrow) * D;
  const float* k = static_cast<const float*>(p.k) + bh * p.t_kv * D;
  const float* v = static_cast<const float*>(p.v) + bh * p.t_kv * D;
  float* dq = static_cast<float*>(p.dq) + (bh * p.t_q + qrow) * D;
  const float lse = live ? p.lse[bh * p.t_q + qrow] : 0.f;
  const float delta = live ? p.delta[bh * p.t_q + qrow] : 0.f;
  const bool dead = !live || sees_no_key(p, lse);
  const int qp = qrow + p.t_kv - p.t_q;

  float acc[D];
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  const int n_run = dq_kv_tiles(p, q0);
  for (int kt = 0; kt < n_run; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockK * D; i += kThreadsF32) {
      const int r = i / D;
      const bool ok = k0 + r < p.t_kv;
      const size_t src = (size_t)(k0 + r) * D + (i % D);
      Ks[i] = ok ? k[src] : 0.f;
      Vs[i] = ok ? v[src] : 0.f;
    }
    __syncthreads();
    if (dead) continue;
    for (int c = 0; c < kBlockK; ++c) {
      float sd = 0.f;
      float pd = 0.f;
      for (int d = 0; d < D; ++d) {
        sd = fmaf(qr[d], Ks[c * D + d], sd);
        pd = fmaf(dor[d], Vs[c * D + d], pd);
      }
      const int kp = k0 + c;
      float x = sd * p.scale;
      if (p.causal && qp < kp) x = kNegInf;
      if (kp >= p.t_kv) x = kNegInf;
      const float pe = expf(x - lse);
      const float ds = pe * (pd - delta) * p.scale;
      for (int d = 0; d < D; ++d) acc[d] = fmaf(ds, Ks[c * D + d], acc[d]);
    }
  }
  if (live) {
    for (int d = 0; d < D; ++d) dq[d] = acc[d];
  }
}

// float32 dK/dV: one thread per kv row, Q and dO tiles in shared memory.
template <int D>
__global__ void __launch_bounds__(kThreadsF32)
    flash_bwd_dkv_f32_kernel(const Params p) {
  extern __shared__ __align__(16) float fsmem[];
  float* Qs = fsmem;
  float* dOs = Qs + kBlockQ * D;
  float* lse_s = dOs + kBlockQ * D;
  float* delta_s = lse_s + kBlockQ;
  bool* dead_s = reinterpret_cast<bool*>(delta_s + kBlockQ);

  const int k0 = blockIdx.x * kBlockK;
  const size_t bh = blockIdx.y;
  const int kvrow = k0 + threadIdx.x;
  const bool live = kvrow < p.t_kv;
  const float* kr = static_cast<const float*>(p.k) + (bh * p.t_kv + kvrow) * D;
  const float* vr = static_cast<const float*>(p.v) + (bh * p.t_kv + kvrow) * D;
  const float* q = static_cast<const float*>(p.q) + bh * p.t_q * D;
  const float* dout = static_cast<const float*>(p.dout) + bh * p.t_q * D;
  float* dk = static_cast<float*>(p.dk) + (bh * p.t_kv + kvrow) * D;
  float* dv = static_cast<float*>(p.dv) + (bh * p.t_kv + kvrow) * D;
  const int off = p.t_kv - p.t_q;

  float dk_acc[D];
  float dv_acc[D];
  for (int d = 0; d < D; ++d) dk_acc[d] = dv_acc[d] = 0.f;

  const int n_q = (p.t_q + kBlockQ - 1) / kBlockQ;
  for (int qt = dkv_first_q_tile(p, k0); qt < n_q; ++qt) {
    const int q0 = qt * kBlockQ;
    __syncthreads();
    for (int i = threadIdx.x; i < kBlockQ * D; i += kThreadsF32) {
      const int r = i / D;
      const bool ok = q0 + r < p.t_q;
      const size_t src = (size_t)(q0 + r) * D + (i % D);
      Qs[i] = ok ? q[src] : 0.f;
      dOs[i] = ok ? dout[src] : 0.f;
    }
    {
      const int row = q0 + threadIdx.x;
      const bool ok = row < p.t_q;
      const float l = ok ? p.lse[bh * p.t_q + row] : 0.f;
      lse_s[threadIdx.x] = l;
      delta_s[threadIdx.x] = ok ? p.delta[bh * p.t_q + row] : 0.f;
      dead_s[threadIdx.x] = !ok || sees_no_key(p, l);
    }
    __syncthreads();
    if (!live) continue;
    for (int r = 0; r < kBlockQ; ++r) {
      if (dead_s[r]) continue;
      float sd = 0.f;
      float pd = 0.f;
      for (int d = 0; d < D; ++d) {
        sd = fmaf(Qs[r * D + d], kr[d], sd);
        pd = fmaf(dOs[r * D + d], vr[d], pd);
      }
      float x = sd * p.scale;
      if (p.causal && q0 + r + off < kvrow) x = kNegInf;
      const float pe = expf(x - lse_s[r]);
      const float ds = pe * (pd - delta_s[r]) * p.scale;
      for (int d = 0; d < D; ++d) {
        dv_acc[d] = fmaf(pe, dOs[r * D + d], dv_acc[d]);
        dk_acc[d] = fmaf(ds, Qs[r * D + d], dk_acc[d]);
      }
    }
  }
  if (live) {
    for (int d = 0; d < D; ++d) {
      dk[d] = dk_acc[d];
      dv[d] = dv_acc[d];
    }
  }
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int threads, size_t smem,
           cudaStream_t stream, const Params& p) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Shared memory: four bf16 tiles (Q, dO, K, V) and, for dK/dV, the q tile's
// lse, delta and dropped-row flags; float32: two tiles of the streamed side.
constexpr size_t kRowStats = kBlockQ * (2 * sizeof(float) + sizeof(bool));

template <int D>
int launch_d(bool dkv, int dtype, dim3 grid, cudaStream_t st, const Params& p) {
  if (dtype == 0) {
    if constexpr (D == 256) {
      return kUnsupported;  // bf16 at 256 runs flash_bwd_wgmma.cu
    } else {
      const size_t smem = 4 * 64 * (D + 8) * sizeof(uint16_t);
      if (dkv) {
        return launch(flash_bwd_dkv_bf16_kernel<D>, grid, kThreadsBf16,
                      smem + kRowStats, st, p);
      }
      return launch(flash_bwd_dq_bf16_kernel<D>, grid, kThreadsBf16, smem, st,
                    p);
    }
  }
  const size_t smem = 2 * 64 * D * sizeof(float);
  if (dkv) {
    return launch(flash_bwd_dkv_f32_kernel<D>, grid, kThreadsF32,
                  smem + kRowStats, st, p);
  }
  return launch(flash_bwd_dq_f32_kernel<D>, grid, kThreadsF32, smem, st, p);
}

int dispatch(bool dkv, const Params& p, int bh, int d, int dtype,
             void* stream) {
  if (bh <= 0 || p.t_q <= 0 || p.t_kv <= 0) return kUnsupported;
  if (dtype != 0 && dtype != 1) return kUnsupported;
  const int rows = dkv ? p.t_kv : p.t_q;
  const dim3 grid((rows + 63) / 64, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (d) {
    case 16: return launch_d<16>(dkv, dtype, grid, st, p);
    case 32: return launch_d<32>(dkv, dtype, grid, st, p);
    case 64: return launch_d<64>(dkv, dtype, grid, st, p);
    case 128: return launch_d<128>(dkv, dtype, grid, st, p);
    case 256: return launch_d<256>(dkv, dtype, grid, st, p);
  }
  return kUnsupported;
}

Params make_params(const void* q, const void* k, const void* v,
                   const void* dout, const void* lse, const void* delta,
                   int t_q, int t_kv, int causal, float scale) {
  Params p = {};
  p.q = q;
  p.k = k;
  p.v = v;
  p.dout = dout;
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

extern "C" int ray_tpu_flash_bwd_dq(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq, int bh, int t_q, int t_kv,
                                    int d, int dtype, int causal, float scale,
                                    void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, t_q, t_kv, causal, scale);
  p.dq = dq;
  return dispatch(false, p, bh, d, dtype, stream);
}

extern "C" int ray_tpu_flash_bwd_dkv(const void* q, const void* k,
                                     const void* v, const void* dout,
                                     const void* lse, const void* delta,
                                     void* dk, void* dv, int bh, int t_q,
                                     int t_kv, int d, int dtype, int causal,
                                     float scale, void* stream) {
  Params p = make_params(q, k, v, dout, lse, delta, t_q, t_kv, causal, scale);
  p.dk = dk;
  p.dv = dv;
  return dispatch(true, p, bh, d, dtype, stream);
}

extern "C" const char* ray_tpu_flash_bwd_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
