// Flash-attention dK/dV for Hopper (sm_90a) at head_dim 64, bf16 or float16
// (the kernel's T; the comments say bf16 for either): TMA loads of 128-row Q
// and dO tiles into an mbarrier ring, the rows' lse and delta by cp.async
// arriving on the same barrier, every product on wgmma, warp-specialised.
// Hand-written CUDA C++.
//
// Replaces the TPU kernel ray_tpu/ops/attention.py:_flash_bwd_dkv_kernel
// (launched by _flash_attention_tpu_bwd) for bf16 and float16 at head_dim
// 64, as the dispatch table in ops/attention.py (BWD_DESIGNS: dK/dV design
// "d64", dQ on flash_bwd_wgmma.cu) says; the kernel it took over from,
// flash_bwd_wgmma.cu's dK/dV at head_dim 64, stays built for the variants
// script (ops/flash_bwd_variants.py --d64). It recomputes P = exp(scale *
// Q K^T - lse) from the forward's row lse, dP = dO V^T and dS = P * (dP -
// delta) with delta = rowsum(dO * O) (computed by the caller), and
// accumulates dV = P^T dO and dK = scale * dS^T Q, with the conventions of
// flash_bwd_wgmma.cu (its header lists them). A row that sees no key (causal,
// t_q > t_kv) lies on masked tiles only, so the masks give it P = 0; a q row
// past t_q reads Q = dO = 0 and lse = delta = 0 and adds nothing. Each CTA
// owns its output tile: no atomics and no split reduction, so equal inputs
// give equal bits. flash_attention_bwd_plain is the same arithmetic in float32.
//
// What bounds it on an H100: the tensor-core operations, 8 * d per visible
// (q, k) pair (S^T, dP^T, dV, dK) at 989 TFLOP/s in bf16; its one ex2 a pair
// is a quarter of that time at d = 64. At head_dim 64 a product of a 64-row
// Q tile is m64n64k64, 0.5 MFLOP, so a stage of 64 rows (flash_bwd_wgmma.cu)
// pays the ring's waits, fences and arrivals for little work; and a
// producer that loads lse and delta with plain loads waits one memory
// latency a stage.
//
// Design (one CTA of 384 threads per (128-row kv tile, batch * head)):
//   * Warpgroup 0 is the producer (setmaxnreg 24). Its thread 0 loads the
//     CTA's K and V (128 rows) once and streams Q and dO in 128-row tiles
//     into a ring of kStages stages; its warp 1's lanes copy each stage's
//     128 lse and delta values with cp.async (zeros past t_q), arriving on
//     the stage's full barrier (cp.async.mbarrier.arrive.noinc), so no
//     thread waits on a load.
//   * Warpgroups 1 and 2 are consumers (setmaxnreg 240), each owning 64 kv
//     rows: S^T = K Q^T and dP^T = V dO^T (m64n128k16, K-major), P^T and
//     dS^T in registers, rounded to bf16 in the A-operand layout, dV += P^T
//     dO and dK += dS^T Q with dO and Q read MN-major through the transpose
//     bit (8 k-steps of 16 q rows). The scale goes into dK's epilogue.
//   * S^T of tile j + 1 is queued behind dV and dK of tile j, dP^T of it once
//     those complete (all six in flight would not fit in 240 registers).
//   * The q loop starts at the first 128-row q tile that sees the CTA's
//     first key; masks only on tiles that cross the diagonal of the
//     warpgroup's rows or the ragged end.
//   * dK and dV go back through the warpgroup's rows of K's and V's buffers
//     and a TMA store that clips rows past t_kv.
//   * Launch order: heads in groups whose Q, dO, lse and delta fit in L2
//     together, kv tile 0 (the heaviest under the causal mask) first.
// Only the producer's waits trap after kWaitLimitNs (hopper.cuh).
//
// C interface (bound with ctypes by ray_tpu_torch/ops/attention.py):
//   int ray_tpu_flash_bwd_dkv_d64(q, k, v, dout, lse, delta, dk, dv,
//                                 bh, t_q, t_kv, d, dtype, causal, scale, stream)
//   int ray_tpu_flash_bwd_d64_smem_bytes(d)   (dynamic shared memory per CTA)
//   int ray_tpu_flash_bwd_d64_ctas_per_sm(d)  (CTAs resident on an SM)
// q/dout are [bh, t_q, 64], k/v/dk/dv [bh, t_kv, 64], contiguous bf16 (dtype
// 0) or float16 (dtype 2), 16-byte aligned; lse and delta [bh, t_q] float32.
// It launches one kernel on `stream`, allocates nothing, and returns cudaGetLastError()
// after the launch, kUnsupported for what it does not take, or
// kTensorMapFailed.

#include "hopper.cuh"

namespace {

constexpr int kD = 64;
constexpr int kKVRows = 128;    // kv rows a CTA owns: two consumer warpgroups of 64
constexpr int kBlockQ = 128;    // q rows per streamed tile
// ring depth: 3 read 2-4% faster than 2 at both of gpt_125m's cases and
// non-causal (ops/flash_bwd_variants.py --d64)
constexpr int kStages = 3;      // ring depth
constexpr int kThreads = 384;   // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 24;
constexpr int kConsumerRegs = 240;
constexpr int kConsumerWarps = 8;
constexpr int kEpilogueBar = 1;  // named barriers 1, 2: each consumer warpgroup's epilogue
// arrivals on a stage's full barrier: thread 0 with the TMA bytes, then each
// of warp 1's 32 lanes when its lse and delta copies have landed
constexpr int kFullArrivals = 33;
constexpr int kRowStatBytes = 2 * kBlockQ * 4;  // a stage's lse and delta

// shared memory, in bytes from a 1024-aligned base (the swizzle's period)
struct Smem {
  static constexpr int kKVBytes = kKVRows * 128;  // K or V (and dK, dV): one box
  static constexpr int kQBytes = kBlockQ * 128;   // a Q or dO tile
  static constexpr int kK = 0;
  static constexpr int kV = kK + kKVBytes;
  static constexpr int kQ = kV + kKVBytes;                    // kStages Q tiles
  static constexpr int kDO = kQ + kStages * kQBytes;          // kStages dO tiles
  static constexpr int kRows = kDO + kStages * kQBytes;       // kStages lse, delta
  static constexpr int kBar = kRows + kStages * kRowStatBytes;  // barriers, 8 bytes
  // each: K and V full, then kStages full and kStages empty
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages);
  static constexpr int kAlloc = kBytes + 1024;  // room to align
  static_assert(kAlloc <= 232448, "shared memory over the 227 KB a block may use");
};

struct Params {
  const float* lse;
  const float* delta;
  int bh;        // batch * heads
  int n_tiles;   // kv tiles per head
  int group;     // heads per launch group
  int t_q;
  int t_kv;
  int off;       // t_kv - t_q
  int causal;
  float scale;
  float scale_log2;  // scale * log2(e)
};

// First 128-row q tile that the kv tile at k0 runs: earlier q tiles lie
// wholly above the causal diagonal.
__device__ __forceinline__ int first_q_tile(const Params& p, int k0) {
  if (!p.causal) return 0;
  const int r0 = k0 - p.off;  // the first q row that sees key k0
  if (r0 <= 0) return 0;
  if (r0 >= p.t_q) return (p.t_q + kBlockQ - 1) / kBlockQ;
  return r0 / kBlockQ;
}

// P^T and dS^T / scale of one [64 kv x 128 q] tile from S^T (s) and dP^T
// (dp), in bf16 in the A-operand layout (pa, dsa), four elements at a time
// so that s and dp die as they go. Element i sits at kv row kv0 + 8 * ((i
// >> 1) & 1) and q column q0 + c, c = 8 * (i >> 2) + 2 * tq + (i & 1);
// `rows` holds the tile's lse at [c] and delta at [kBlockQ + c]. Masks
// (causal, past t_kv) only where `masked`.
template <typename T>
__device__ __forceinline__ void dkv_grads(const float* s, const float* dp, uint32_t* pa,
                                          uint32_t* dsa, const float* rows, const Params& p,
                                          int q0, int kv0, int tq, bool masked) {
#pragma unroll
  for (int i = 0; i < kBlockQ / 2; i += 4) {
    const int c = 8 * (i >> 2) + 2 * tq;  // columns c, c + 1 of both rows
    const float2 lse = *reinterpret_cast<const float2*>(rows + c);
    const float2 dl = *reinterpret_cast<const float2*>(rows + kBlockQ + c);
    const float l0 = lse.x * kLog2e, l1 = lse.y * kLog2e;
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // kv rows kv0 and kv0 + 8
      const int e = i + 2 * h;
      const int kv = kv0 + 8 * h;
      float p0 = fast_exp2(fmaf(s[e], p.scale_log2, -l0));
      float p1 = fast_exp2(fmaf(s[e + 1], p.scale_log2, -l1));
      if (masked) {
        const bool out = kv >= p.t_kv;
        if (out || (p.causal && q0 + c + p.off < kv)) p0 = 0.f;
        if (out || (p.causal && q0 + c + 1 + p.off < kv)) p1 = 0.f;
      }
      pa[e / 2] = pack2<T>(p0, p1);
      dsa[e / 2] = pack2<T>(p0 * (dp[e] - dl.x), p1 * (dp[e + 1] - dl.y));
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_d64_kernel(const __grid_constant__ CUtensorMap tm_q,
                             const __grid_constant__ CUtensorMap tm_k,
                             const __grid_constant__ CUtensorMap tm_v,
                             const __grid_constant__ CUtensorMap tm_do,
                             const __grid_constant__ CUtensorMap tm_dk,
                             const __grid_constant__ CUtensorMap tm_dv, const Params p) {
  using S = Smem;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  uint8_t* const gbase = smem_raw + (base - smem_u32(smem_raw));
  const uint32_t bar_kv = base + S::kBar;
  const uint32_t bar_full = bar_kv + 8;  // + 8 * stage, likewise below
  const uint32_t bar_empty = bar_full + 8 * kStages;

  // the CTA's head and kv tile in launch order: heads in groups of p.group,
  // each tile index across the group's heads, tile 0 (the heaviest under
  // the causal mask) first
  const int per_group = p.group * p.n_tiles;
  const int head0 = blockIdx.x / per_group * p.group;
  const int heads = min(p.group, p.bh - head0);
  const int rank = blockIdx.x % per_group;
  const int bh = head0 + rank % heads;
  const int k0 = rank / heads * kKVRows;
  const int first = first_q_tile(p, k0);
  const int n_run = (p.t_q + kBlockQ - 1) / kBlockQ - first;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, kFullArrivals);
      mbar_init(bar_empty + 8 * s, kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: thread 0 keeps the ring of Q and dO full, warp 1's
    // lanes copy each stage's lse and delta; the paths never meet
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x == 0 && n_run > 0) {
      mbar_arrive_expect_tx(bar_kv, 2 * S::kKVBytes);
      tma_load_3d(base + S::kK, &tm_k, bar_kv, 0, k0, bh);
      tma_load_3d(base + S::kV, &tm_v, bar_kv, 0, k0, bh);
#pragma unroll 1
      for (int j = 0; j < n_run; ++j) {
        const int stage = j % kStages;
        const int round = j / kStages;
        // a stage is free once both warpgroups' dV and dK of its last tile
        // have completed
        if (round > 0) mbar_wait_or_trap(bar_empty + 8 * stage, (round - 1) & 1);
        const int q0 = (first + j) * kBlockQ;
        const uint32_t full = bar_full + 8 * stage;
        mbar_arrive_expect_tx(full, 2 * S::kQBytes);
        tma_load_3d(base + S::kQ + stage * S::kQBytes, &tm_q, full, 0, q0, bh);
        tma_load_3d(base + S::kDO + stage * S::kQBytes, &tm_do, full, 0, q0, bh);
      }
      // the consumers' last release of each stage: a stalled pipeline traps here
#pragma unroll 1
      for (int j = max(0, n_run - kStages); j < n_run; ++j) {
        mbar_wait_or_trap(bar_empty + 8 * (j % kStages), (j / kStages) & 1);
      }
    } else if (threadIdx.x / 32 == 1) {
      const int lane = threadIdx.x % 32;
#pragma unroll 1
      for (int j = 0; j < n_run; ++j) {
        const int stage = j % kStages;
        const int round = j / kStages;
        if (round > 0) mbar_wait_or_trap(bar_empty + 8 * stage, (round - 1) & 1);
        const int q0 = (first + j) * kBlockQ;
        const uint32_t rows = base + S::kRows + stage * kRowStatBytes;
#pragma unroll
        for (int h = 0; h < kBlockQ / 32; ++h) {
          const int r = lane + 32 * h;
          const int row = q0 + r;
          const size_t at = (size_t)bh * p.t_q + min(row, p.t_q - 1);
          const int bytes = row < p.t_q ? 4 : 0;
          cp_async_4(rows + 4 * r, p.lse + at, bytes);
          cp_async_4(rows + 4 * (kBlockQ + r), p.delta + at, bytes);
        }
        cp_async_arrive(bar_full + 8 * stage);
      }
      // this lane's copies have all landed before the warp exits
      asm volatile("cp.async.wait_all;\n" ::: "memory");
    }
  } else {
    // ---- consumers: warpgroup cw owns kv rows [k0 + 64 cw, k0 + 64 cw + 64)
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
    const int cw = threadIdx.x / 128 - 1;
    const int wtid = threadIdx.x % 128;
    const int warp = wtid / 32;
    const int lane = threadIdx.x % 32;
    const int g = lane >> 2;  // row within the warp's 8-row half
    const int tq = lane & 3;  // column pair within an 8-column group
    const int k_wg = k0 + 64 * cw;          // the warpgroup's first kv row
    const int kv0 = k_wg + 16 * warp + g;   // kv rows kv0 and kv0 + 8
    const uint32_t k_rows = base + S::kK + cw * 64 * 128;
    const uint32_t v_rows = base + S::kV + cw * 64 * 128;
    auto q_tile = [&](int stage) { return base + S::kQ + stage * S::kQBytes; };
    auto do_tile = [&](int stage) { return base + S::kDO + stage * S::kQBytes; };

    float dk[kD / 2], dv[kD / 2];
#pragma unroll
    for (int i = 0; i < kD / 2; ++i) dk[i] = dv[i] = 0.f;

    if (n_run > 0) {
      float s[kBlockQ / 2];       // S^T
      float dp[kBlockQ / 2];      // dP^T
      uint32_t pa[kBlockQ / 4];   // P^T in bf16, the A operand of dV += P^T dO
      uint32_t dsa[kBlockQ / 4];  // dS^T / scale in bf16, the A operand of dK += dS^T Q
      // P^T and dS^T of tile j in bf16, then dV and dK of it issued
      auto accumulate = [&](int j) {
        const int stage = j % kStages;
        const int q0 = (first + j) * kBlockQ;
        const bool masked =
            (p.causal && q0 + p.off < k_wg + 63) || k_wg + 64 > p.t_kv;
        dkv_grads<T>(s, dp, pa, dsa,
                  reinterpret_cast<const float*>(gbase + S::kRows + stage * kRowStatBytes), p,
                  q0, kv0, tq, masked);
        fence_regs<kBlockQ / 4>(pa);
        fence_regs<kBlockQ / 4>(dsa);
        fence_regs<kD / 2>(dv);
        fence_regs<kD / 2>(dk);
        wgmma_fence();
        issue_nn<kD, kBlockQ, T>(dv, pa, do_tile(stage));
        issue_nn<kD, kBlockQ, T>(dk, dsa, q_tile(stage));
        wgmma_commit();
      };
      auto release = [&](int j) {
        fence_regs<kD / 2>(dv);
        fence_regs<kD / 2>(dk);
        fence_regs<kBlockQ / 4>(pa);
        fence_regs<kBlockQ / 4>(dsa);
        if (lane == 0) mbar_arrive(bar_empty + 8 * (j % kStages));
      };

      mbar_wait(bar_kv, 0);
      mbar_wait(bar_full, 0);
      fence_regs<kBlockQ / 2>(s);
      fence_regs<kBlockQ / 2>(dp);
      wgmma_fence();
      issue_nt<kD, kBlockQ, T>(s, k_rows, q_tile(0));
      issue_nt<kD, kBlockQ, T>(dp, v_rows, do_tile(0));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs<kBlockQ / 2>(s);
      fence_regs<kBlockQ / 2>(dp);

      // S^T of tile j + 1 is queued behind dV and dK of tile j, dP^T of it
      // once they have completed
#pragma unroll 1
      for (int j = 0; j + 1 < n_run; ++j) {
        const int next = (j + 1) % kStages;
        accumulate(j);
        mbar_wait(bar_full + 8 * next, ((j + 1) / kStages) & 1);
        fence_regs<kBlockQ / 2>(s);
        wgmma_fence();
        issue_nt<kD, kBlockQ, T>(s, k_rows, q_tile(next));
        wgmma_commit();
        wgmma_wait<1>();  // dV and dK of tile j
        release(j);
        fence_regs<kBlockQ / 2>(dp);
        wgmma_fence();
        issue_nt<kD, kBlockQ, T>(dp, v_rows, do_tile(next));
        wgmma_commit();
        wgmma_wait<0>();  // S^T and dP^T of tile j + 1
        fence_regs<kBlockQ / 2>(s);
        fence_regs<kBlockQ / 2>(dp);
      }
      accumulate(n_run - 1);
      wgmma_wait<0>();
      release(n_run - 1);
    }

    // ---- epilogue: dK (times the scale) and dV through this warpgroup's
    // rows of K's and V's buffers, which its last products have finished
    // reading (or which were never loaded, when no q tile sees these keys)
    const float scale[2] = {p.scale, p.scale};
    const float one[2] = {1.f, 1.f};
    write_rows<kD, T>(gbase + S::kK + cw * 64 * 128, S::kKVBytes, dk, scale, warp, g, tq);
    write_rows<kD, T>(gbase + S::kV + cw * 64 * 128, S::kKVBytes, dv, one, warp, g, tq);
    fence_async_shared();
    asm volatile("bar.sync %0, 128;\n" ::"r"(kEpilogueBar + cw) : "memory");
    if (wtid == 0) {
      tma_store_3d(&tm_dk, k_rows, 0, k_wg, bh);
      tma_store_3d(&tm_dv, v_rows, 0, k_wg, bh);
      bulk_commit();
      bulk_wait_all<true>();
    }
  }
}

template <typename T>
int smem_attribute() {
  return (int)cudaFuncSetAttribute(flash_bwd_dkv_d64_kernel<T>,
                                   cudaFuncAttributeMaxDynamicSharedMemorySize, Smem::kAlloc);
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout, void* dk, void* dv,
           const Params& p, cudaStream_t stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv;
  if (make_map<T>(&tm_q, q, kD, p.t_q, p.bh, kBlockQ) ||
      make_map<T>(&tm_do, dout, kD, p.t_q, p.bh, kBlockQ) ||
      make_map<T>(&tm_k, k, kD, p.t_kv, p.bh, kKVRows) ||
      make_map<T>(&tm_v, v, kD, p.t_kv, p.bh, kKVRows) ||
      make_map<T>(&tm_dk, dk, kD, p.t_kv, p.bh, 64) ||
      make_map<T>(&tm_dv, dv, kD, p.t_kv, p.bh, 64)) {
    return kTensorMapFailed;
  }
  const int err = smem_attribute<T>();
  if (err != 0) return err;
  flash_bwd_dkv_d64_kernel<T><<<p.n_tiles * p.bh, kThreads, Smem::kAlloc, stream>>>(
      tm_q, tm_k, tm_v, tm_do, tm_dk, tm_dv, p);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ray_tpu_flash_bwd_d64_smem_bytes(int d) { return d == kD ? Smem::kAlloc : 0; }

extern "C" int ray_tpu_flash_bwd_d64_ctas_per_sm(int d) {
  if (d != kD || smem_attribute<__nv_bfloat16>() != 0) return -1;
  int per_sm = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm,
                                                    flash_bwd_dkv_d64_kernel<__nv_bfloat16>,
                                                    kThreads, Smem::kAlloc) != cudaSuccess) {
    return -1;
  }
  return per_sm;
}

extern "C" int ray_tpu_flash_bwd_dkv_d64(const void* q, const void* k, const void* v,
                                         const void* dout, const void* lse, const void* delta,
                                         void* dk, void* dv, int bh, int t_q, int t_kv, int d,
                                         int dtype, int causal, float scale, void* stream) {
  if (bh <= 0 || t_q <= 0 || t_kv <= 0 || d != kD || (dtype != 0 && dtype != 2) ||
      (long long)bh * ((t_kv + kKVRows - 1) / kKVRows) > 0x7fffffffll) {
    return kUnsupported;
  }
  Params p;
  p.lse = static_cast<const float*>(lse);
  p.delta = static_cast<const float*>(delta);
  p.bh = bh;
  p.n_tiles = (t_kv + kKVRows - 1) / kKVRows;
  // Q and dO of one head, 2 bytes an element, and its lse and delta
  p.group = l2_group(4ll * t_q * kD + 8ll * t_q, bh);
  p.t_q = t_q;
  p.t_kv = t_kv;
  p.off = t_kv - t_q;
  p.causal = causal;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return dtype == 2 ? launch<__half>(q, k, v, dout, dk, dv, p, st)
                    : launch<__nv_bfloat16>(q, k, v, dout, dk, dv, p, st);
}

extern "C" const char* ray_tpu_flash_bwd_d64_error_string(int err) {
  if (err == kUnsupported) return "unsupported head_dim, dtype or shape";
  if (err == kTensorMapFailed) return "cuTensorMapEncodeTiled refused a tensor map";
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
