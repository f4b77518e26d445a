// Flash-attention forward on mma.sync (sm_90a), hand-written CUDA C++: the
// design the dispatch table in ops/attention.py (FWD_DESIGNS) sends bf16 at
// head_dim 16 and 32 to; bf16 at 64, 128 and 256 runs
// csrc/flash_fwd_wgmma.cu and float32 csrc/flash_fwd_f32.cu (3xTF32 on the
// tensor cores).
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_fwd_kernel
// (launched by _flash_attention_tpu) there. It computes what that kernel computes:
// O = softmax(scale * Q K^T) V and the row logsumexp, with the same
// conventions:
//   * NEG_INF = -1e30 is a finite mask value, not -inf;
//   * under the causal mask q rows are the suffix of the kv context:
//     q_pos = q_idx + (t_kv - t_q), and key k is visible when q_pos >= k;
//   * kv tiles wholly above the diagonal of the q tile are skipped;
//   * in a ragged last kv tile the padded columns are masked and V is zero;
//   * a row whose processed columns are all masked gets p = exp(0) = 1 on
//     each of them (the online-softmax max stays at NEG_INF), exactly as the
//     TPU kernel does;
//   * denominator 1 where l == 0, lse = m + log(denom) in float32.
// Tiles are 64 x 64 (block_q = min(64, t_q), block_k = min(64, t_kv) in the
// reference's terms); the plain version in ops/attention.py
// (flash_attention_fwd_plain) is the same algorithm at the same tiles.
//
// What bounds it on an H100: at the head_dims it serves, the launch and the
// bytes of q, k, v and o; the tensor-core operations only at long t.
//
// Design: one CTA of 4 warps per (64-row q tile, batch*head). The loop over
// 64-row kv tiles runs inside the CTA: it takes the place of the TPU grid's
// sequential innermost axis, and the causal tile skip is its upper bound.
// Each warp owns 16 q rows. S = Q K^T and O += P V run on mma.sync
// m16n8k16 (bf16 in, f32 accumulate); the running max m, the denominator l
// and the O accumulator stay in registers in float32. Q, K and V tiles sit
// in shared memory, rows padded by 16 bytes so that fragment loads hit
// distinct banks. The float32 kernel here (CUDA cores, one thread per q
// row, the same tiles) is on no path: only ops/flash_fwd_f32_variants.py
// launches it, to time it beside the 3xTF32 design that replaced it.
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_fwd(q, k, v, o, lse, bh, t_q, t_kv, d, dtype, causal,
//                         scale, stream)
// q/o are [bh, t_q, d], k/v [bh, t_kv, d], contiguous, lse [bh, t_q] f32;
// dtype 0 = bf16 (head_dim 16, 32), 1 = float32 (16 to 256; on no path).
// The kernel launches on `stream`, allocates nothing, and the function
// returns cudaGetLastError() after the launch (or kUnsupported for a
// head_dim/dtype it does not take).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreadsBf16 = 128;  // 4 warps x 16 q rows
constexpr int kThreadsF32 = 64;    // one thread per q row
constexpr float kNegInf = -1e30f;
constexpr int kUnsupported = 100000;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;
  int t_q;
  int t_kv;
  int bq_eff;  // min(64, t_q): the reference's block_q
  int bk_eff;  // min(64, t_kv): the reference's block_k
  int causal;
  float scale;
};

// Number of kv tiles a q tile processes: the causal skip of the reference
// ((qi * bq + bq - 1 + off) < ki * bk skips tile ki) as a loop bound.
__device__ __forceinline__ int kv_tiles_to_run(const Params& p, int q0) {
  const int n_kv = (p.t_kv + kBlockK - 1) / kBlockK;
  if (!p.causal) return n_kv;
  const int last = q0 + p.bq_eff - 1 + (p.t_kv - p.t_q);
  if (last < 0) return 0;
  return min(n_kv, last / kBlockK + 1);
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

// Copies rows [row0, row0 + 64) of a [rows, D] bf16 matrix into a shared
// tile with row stride D + 8, 16 bytes per thread per step; rows past the
// end are zero (the reference's zeroed V in a ragged tile).
template <int D>
__device__ __forceinline__ void load_tile_bf16(uint16_t* dst,
                                               const uint16_t* src, int row0,
                                               int rows) {
  constexpr int kChunks = D / 8;
  for (int c = threadIdx.x; c < 64 * kChunks; c += kThreadsBf16) {
    const int r = c / kChunks;
    const int col = (c % kChunks) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < rows) {
      val = *reinterpret_cast<const uint4*>(src + (size_t)(row0 + r) * D + col);
    }
    *reinterpret_cast<uint4*>(dst + r * (D + 8) + col) = val;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreadsBf16)
    flash_fwd_bf16_kernel(const Params p) {
  constexpr int S = D + 8;  // shared row stride, in bf16 elements
  extern __shared__ __align__(16) uint16_t smem[];
  uint16_t* Qs = smem;
  uint16_t* Ks = Qs + kBlockQ * S;
  uint16_t* Vs = Ks + kBlockK * S;

  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2;   // mma group: row within the 8-row half
  const int tig = lane & 3;  // thread in group: column pair
  const int q0 = blockIdx.x * kBlockQ;
  const size_t bh = blockIdx.y;
  const uint16_t* q = static_cast<const uint16_t*>(p.q) + bh * p.t_q * D;
  const uint16_t* k = static_cast<const uint16_t*>(p.k) + bh * p.t_kv * D;
  const uint16_t* v = static_cast<const uint16_t*>(p.v) + bh * p.t_kv * D;
  uint16_t* o = static_cast<uint16_t*>(p.o) + bh * p.t_q * D;
  float* lse = p.lse + bh * p.t_q;
  const int off = p.t_kv - p.t_q;
  const int r_lo = warp * 16 + g;  // tile rows owned: r_lo and r_lo + 8

  load_tile_bf16<D>(Qs, q, q0, p.t_q);

  float acc[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt) {
    acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  }
  float m_r[2] = {kNegInf, kNegInf};
  float l_r[2] = {0.f, 0.f};

  const int n_run = kv_tiles_to_run(p, q0);
  for (int kt = 0; kt < n_run; ++kt) {
    const int k0 = kt * kBlockK;
    __syncthreads();  // every warp is done with the previous K/V tile
    load_tile_bf16<D>(Ks, k, k0, p.t_kv);
    load_tile_bf16<D>(Vs, v, k0, p.t_kv);
    __syncthreads();

    // S = Q K^T for this warp's 16 rows x 64 kv columns (8 n-tiles of 8)
    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
    }
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const int c = kk * 16 + tig * 2;
      const uint32_t a0 = ld_u32(Qs + r_lo * S + c);
      const uint32_t a1 = ld_u32(Qs + (r_lo + 8) * S + c);
      const uint32_t a2 = ld_u32(Qs + r_lo * S + c + 8);
      const uint32_t a3 = ld_u32(Qs + (r_lo + 8) * S + c + 8);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const uint16_t* kr = Ks + (nt * 8 + g) * S + c;
        mma_bf16_16816(s[nt], a0, a1, a2, a3, ld_u32(kr), ld_u32(kr + 8));
      }
    }

    // scale and mask; element e of n-tile nt sits at row r_lo + 8*(e>>1),
    // column nt*8 + tig*2 + (e&1). Columns >= bk_eff do not exist in the
    // reference's tile (t_kv < 64) and take no part in max or sum.
    float m_cur[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        const int row = r_lo + (e >> 1) * 8;
        const int kp = k0 + col;
        float x = s[nt][e] * p.scale;
        if (p.causal && q0 + row + off < kp) x = kNegInf;
        if (kp >= p.t_kv) x = kNegInf;
        s[nt][e] = x;
        if (col < p.bk_eff) m_cur[e >> 1] = fmaxf(m_cur[e >> 1], x);
      }
    }
    float alpha[2];
    float m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m_cur[i] = fmaxf(m_cur[i], __shfl_xor_sync(0xffffffffu, m_cur[i], 1));
      m_cur[i] = fmaxf(m_cur[i], __shfl_xor_sync(0xffffffffu, m_cur[i], 2));
      m_new[i] = fmaxf(m_r[i], m_cur[i]);
      alpha[i] = expf(m_r[i] - m_new[i]);
      m_r[i] = m_new[i];
    }
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = nt * 8 + tig * 2 + (e & 1);
        const float pe =
            col < p.bk_eff ? expf(s[nt][e] - m_new[e >> 1]) : 0.f;
        s[nt][e] = pe;
        rs[e >> 1] += pe;
      }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 1);
      rs[i] += __shfl_xor_sync(0xffffffffu, rs[i], 2);
      l_r[i] = alpha[i] * l_r[i] + rs[i];
    }
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      acc[dt][0] *= alpha[0];
      acc[dt][1] *= alpha[0];
      acc[dt][2] *= alpha[1];
      acc[dt][3] *= alpha[1];
    }

    // O += P V: P's accumulator layout is the A-fragment layout of the next
    // product, 16 kv columns (two n-tiles) per k-step
#pragma unroll
    for (int kk = 0; kk < kBlockK / 16; ++kk) {
      const uint32_t a0 = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      const uint32_t a1 = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      const uint32_t a2 = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      const uint32_t a3 = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
      const uint16_t* v0 = Vs + (kk * 16 + tig * 2) * S + g;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        const uint16_t* vp = v0 + dt * 8;
        const uint32_t b0 = uint32_t(vp[0]) | (uint32_t(vp[S]) << 16);
        const uint32_t b1 = uint32_t(vp[8 * S]) | (uint32_t(vp[9 * S]) << 16);
        mma_bf16_16816(acc[dt], a0, a1, a2, a3, b0, b1);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int qrow = q0 + r_lo + i * 8;
    if (qrow < p.t_q) {
      const float denom = l_r[i] == 0.f ? 1.f : l_r[i];
      uint16_t* orow = o + (size_t)qrow * D + tig * 2;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        *reinterpret_cast<uint32_t*>(orow + dt * 8) =
            pack_bf16(acc[dt][2 * i] / denom, acc[dt][2 * i + 1] / denom);
      }
      if (tig == 0) lse[qrow] = m_r[i] + logf(denom);
    }
  }
}

// float32 on the CUDA cores: one thread per q row, K and V tiles in shared
// memory, the same tiles, skip and masking as the bf16 kernel.
template <int D>
__global__ void __launch_bounds__(kThreadsF32)
    flash_fwd_f32_kernel(const Params p) {
  extern __shared__ __align__(16) float fsmem[];
  float* Ks = fsmem;
  float* Vs = fsmem + kBlockK * D;

  const int q0 = blockIdx.x * kBlockQ;
  const size_t bh = blockIdx.y;
  const float* q = static_cast<const float*>(p.q) + bh * p.t_q * D;
  const float* k = static_cast<const float*>(p.k) + bh * p.t_kv * D;
  const float* v = static_cast<const float*>(p.v) + bh * p.t_kv * D;
  float* o = static_cast<float*>(p.o) + bh * p.t_q * D;
  float* lse = p.lse + bh * p.t_q;
  const int off = p.t_kv - p.t_q;
  const int qrow = q0 + threadIdx.x;
  const bool live = qrow < p.t_q;

  float qr[D];
  float acc[D];
  for (int d = 0; d < D; ++d) {
    qr[d] = live ? q[(size_t)qrow * D + d] : 0.f;
    acc[d] = 0.f;
  }
  float m = kNegInf;
  float l = 0.f;

  const int n_run = kv_tiles_to_run(p, q0);
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

    float s[kBlockK];
    float m_cur = -INFINITY;
    for (int c = 0; c < kBlockK; ++c) {
      float dot = 0.f;
      for (int d = 0; d < D; ++d) dot = fmaf(qr[d], Ks[c * D + d], dot);
      float x = dot * p.scale;
      const int kp = k0 + c;
      if (p.causal && qrow + off < kp) x = kNegInf;
      if (kp >= p.t_kv) x = kNegInf;
      s[c] = x;
      if (c < p.bk_eff) m_cur = fmaxf(m_cur, x);
    }
    const float m_new = fmaxf(m, m_cur);
    const float alpha = expf(m - m_new);
    float rs = 0.f;
    for (int c = 0; c < kBlockK; ++c) {
      s[c] = c < p.bk_eff ? expf(s[c] - m_new) : 0.f;
      rs += s[c];
    }
    l = alpha * l + rs;
    m = m_new;
    for (int d = 0; d < D; ++d) {
      float a = acc[d] * alpha;
      for (int c = 0; c < kBlockK; ++c) a = fmaf(s[c], Vs[c * D + d], a);
      acc[d] = a;
    }
  }

  if (live) {
    const float denom = l == 0.f ? 1.f : l;
    for (int d = 0; d < D; ++d) o[(size_t)qrow * D + d] = acc[d] / denom;
    lse[qrow] = m + logf(denom);
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

template <int D>
int launch_bf16(dim3 grid, cudaStream_t stream, const Params& p) {
  const size_t smem = 3 * 64 * (D + 8) * sizeof(uint16_t);
  return launch(flash_fwd_bf16_kernel<D>, grid, kThreadsBf16, smem, stream, p);
}

template <int D>
int launch_f32(dim3 grid, cudaStream_t stream, const Params& p) {
  const size_t smem = 2 * 64 * D * sizeof(float);
  return launch(flash_fwd_f32_kernel<D>, grid, kThreadsF32, smem, stream, p);
}

}  // namespace

extern "C" int ray_tpu_flash_fwd(const void* q, const void* k, const void* v,
                                 void* o, void* lse, int bh, int t_q, int t_kv,
                                 int d, int dtype, int causal, float scale,
                                 void* stream) {
  if (bh <= 0 || t_q <= 0 || t_kv <= 0) return kUnsupported;
  Params p;
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.lse = static_cast<float*>(lse);
  p.t_q = t_q;
  p.t_kv = t_kv;
  p.bq_eff = t_q < kBlockQ ? t_q : kBlockQ;
  p.bk_eff = t_kv < kBlockK ? t_kv : kBlockK;
  p.causal = causal;
  p.scale = scale;
  const dim3 grid((t_q + kBlockQ - 1) / kBlockQ, bh);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    switch (d) {
      case 16: return launch_bf16<16>(grid, st, p);
      case 32: return launch_bf16<32>(grid, st, p);
    }
  } else if (dtype == 1) {
    switch (d) {
      case 16: return launch_f32<16>(grid, st, p);
      case 32: return launch_f32<32>(grid, st, p);
      case 64: return launch_f32<64>(grid, st, p);
      case 128: return launch_f32<128>(grid, st, p);
      case 256: return launch_f32<256>(grid, st, p);
    }
  }
  return kUnsupported;
}

extern "C" const char* ray_tpu_cuda_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype or shape";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
