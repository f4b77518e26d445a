// Hopper (sm_90a) pieces shared by the port's TMA flash kernels
// (flash_fwd_wgmma.cu, flash_bwd_wgmma.cu, flash_fwd_persistent.cu,
// flash_bwd_persistent.cu): mbarriers, 3-D TMA loads and stores, swizzled
// wgmma descriptors, wgmma with A from shared memory or from registers,
// named barriers, a warp's mma.sync products on narrow tiles through
// ldmatrix, and the tensor maps of their tiles.
//
// At head_dim 64 and up, every tile is a row-major [rows, d] bf16 array cut
// into 64-column boxes of 128-byte rows that TMA swizzles with the 128-byte
// pattern; a box holds all the tile's rows, so box c of a tile of R rows
// starts at c * R * 128 bytes. A tile stored so is a K-major wgmma operand
// when d is the product's depth (Q, K of S = Q K^T) and an MN-major one,
// read through the descriptor's transpose bit, when its rows are the depth
// (V of O += P V). At head_dim 16 and 32 a row is 32 or 64 bytes, one box
// spans it, and TMA swizzles it with the pattern of that span (narrow
// tiles, below): 16-byte chunk c of row r sits at chunk c ^ ((r >> 2) & 1)
// (32 bytes) or c ^ ((r >> 1) & 3) (64 bytes), which the XOR of address
// bits [4, 4 + n) with bits [7, 7 + n) gives on a tile that starts on a
// multiple of 8 rows' bytes.
//
// Everything here is in an anonymous namespace: each source that includes
// it is its own library.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;
constexpr unsigned long long kWaitLimitNs = 4000000000ull;
// bytes of the streamed tiles that the heads of one launch group may hold in
// L2 (of the H100's 50 MB)
constexpr long long kL2GroupBytes = 16ll << 20;
constexpr int kUnsupported = 100000;
constexpr int kTensorMapFailed = 100001;

// The 16-bit input type T of the tensor-core kernels at head_dim 64 and up:
// bf16 (__nv_bfloat16), or float16 (__half). The products add in float32
// either way and both types lay out their operands alike, so a kernel takes
// either by its T alone. The entry points name T by the dtype code 0 (bf16)
// or 2 (float16).
template <typename T>
constexpr bool kHalf = std::is_same<T, __half>::value;

// ---------------------------------------------------------------------------
// PTX wrappers
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ unsigned long long global_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// Waits until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  while (!mbar_try_wait(bar, parity)) {
  }
}

// The same, ending the kernel with an error after kWaitLimitNs. Only a
// kernel's producer waits so: a trap in the consumers' loop costs them
// registers (ptxas spills there), and every stall of the pipeline reaches
// one of the producer's waits, since it ends by waiting for the last
// release of each stage.
__device__ __forceinline__ void mbar_wait_or_trap(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const unsigned long long t0 = global_ns();
  while (!mbar_try_wait(bar, parity)) {
    if (global_ns() - t0 > kWaitLimitNs) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, uint32_t src,
                                             int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group [%0, {%2, %3, %4}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// the bulk stores (tma_store_3d) this thread committed: all read out of
// shared memory (kRead) or all done
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
template <bool kRead>
__device__ __forceinline__ void bulk_wait_all() {
  if constexpr (kRead) {
    asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
  } else {
    asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
  }
}

// this thread's writes to shared memory, made visible to the async proxy
// (a TMA store that reads them)
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// 4 bytes from global to shared memory without holding the thread: src_bytes
// of them read (4 or 0), the rest zero; cp_async_arrive then arrives on an
// mbarrier when this thread's copies have landed (its expected count holds
// that arrival)
__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(bar) : "memory");
}

// wgmma shared-memory descriptor of a 128-byte-swizzled operand: start
// address, leading and stride byte offsets (in 16-byte units), layout 1
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo_bytes,
                                               uint32_t sbo_bytes) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFF) << 32) |
         (1ull << 62);
}

// K-major operand (rows of 64 bf16 = 128 bytes, 8-row groups 1024 bytes
// apart; the leading offset is unused)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr) {
  return sw128_desc(addr, 16, 1024);
}

// MN-major operand: 64-column boxes `box_bytes` apart, 8 k-rows 1024 apart
__device__ __forceinline__ uint64_t mnmajor_desc(uint32_t addr, uint32_t box_bytes) {
  return sw128_desc(addr, box_bytes, 1024);
}

// wgmma shared-memory descriptor of a narrow tile (kRowBytes = 32 or 64
// bytes a row, swizzled with the pattern of that span; layout 3 or 2), K-
// or MN-major alike: 8-row groups 8 * kRowBytes apart. The leading offset is
// unused: along the contiguous dimension one swizzle atom spans the operand
// (K-major: 16 of d at a time; MN-major: N = d). It holds the same value as
// the stride, so either reading of the two fields finds 8-row groups there.
template <int kRowBytes>
__device__ __forceinline__ uint64_t narrow_desc(uint32_t addr) {
  static_assert(kRowBytes == 32 || kRowBytes == 64, "narrow tiles have 32- or 64-byte rows");
  constexpr uint64_t kGroup = (8 * kRowBytes) >> 4;
  constexpr uint64_t kLayout = kRowBytes == 32 ? 3 : 2;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (kGroup << 16) | (kGroup << 32) |
         (kLayout << 62);
}

// byte offset of 16-byte chunk `chunk` of row `row` in a narrow tile
template <int kRowBytes>
__device__ __forceinline__ uint32_t narrow_offset(int row, int chunk) {
  const int swz = kRowBytes == 32 ? (row >> 2) & 1 : (row >> 1) & 3;
  return static_cast<uint32_t>(row * kRowBytes + ((chunk ^ swz) << 4));
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// named barrier `id` over the two consumer warpgroups (256 threads): one
// side's bar.arrive releases what it wrote to shared memory to the other
// side's bar.sync
__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(id) : "memory");
}
__device__ __forceinline__ void named_arrive(int id) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(id) : "memory");
}

// Keeps the compiler from moving reads or writes of these registers across
// the asynchronous wgmma that owns them.
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define F8(o)                                                                  \
  "+f"(d[o]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]), \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])

// D[64 x N] (+)= A[64 x 16] B[16 x N], A and B K-major in shared memory, of
// type T (bf16, or float16 where a kernel is built for it)
#define WGMMA_SS_48(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %26, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n48k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23}, " \
      "%24, %25, p, 1, 1, 0, 0;\n}\n" \
      : F8(0), F8(8), F8(16) \
      : "l"(da), "l"(db), "r"(accumulate));
#define WGMMA_SS_64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31}, " \
      "%32, %33, p, 1, 1, 0, 0;\n}\n" \
      : F8(0), F8(8), F8(16), F8(24) \
      : "l"(da), "l"(db), "r"(accumulate));
#define WGMMA_SS_80(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %42, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n80k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, " \
      "%40, %41, p, 1, 1, 0, 0;\n}\n" \
      : F8(0), F8(8), F8(16), F8(24), F8(32) \
      : "l"(da), "l"(db), "r"(accumulate));
#define WGMMA_SS_128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
      "%58, %59, %60, %61, %62, %63}, " \
      "%64, %65, p, 1, 1, 0, 0;\n}\n" \
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56) \
      : "l"(da), "l"(db), "r"(accumulate));

template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_ss(float* d, uint64_t da, uint64_t db, int accumulate) {
  static_assert(N == 48 || N == 64 || N == 80 || N == 128, "wgmma_ss takes N = 48, 64, 80, 128");
  if constexpr (N == 48) {
    if constexpr (kHalf<T>) {
      WGMMA_SS_48("f16");
    } else {
      WGMMA_SS_48("bf16");
    }
  } else if constexpr (N == 64) {
    if constexpr (kHalf<T>) {
      WGMMA_SS_64("f16");
    } else {
      WGMMA_SS_64("bf16");
    }
  } else if constexpr (N == 80) {
    if constexpr (kHalf<T>) {
      WGMMA_SS_80("f16");
    } else {
      WGMMA_SS_80("bf16");
    }
  } else if constexpr (N == 128) {
    if constexpr (kHalf<T>) {
      WGMMA_SS_128("f16");
    } else {
      WGMMA_SS_128("bf16");
    }
  }
}

#undef WGMMA_SS_48
#undef WGMMA_SS_64
#undef WGMMA_SS_80
#undef WGMMA_SS_128

// D[64 x N] += A[64 x 16] B[16 x N], A in registers (the accumulator layout
// of a product rounded to T, bf16 or float16), B MN-major in shared memory
// (transpose bit set)
#define WGMMA_RS_16(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7}, " \
      "{%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n" \
      : F8(0) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
#define WGMMA_RS_32(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, " \
      "{%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n" \
      : F8(0), F8(8) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
#define WGMMA_RS_64(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31}, " \
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n" \
      : F8(0), F8(8), F8(16), F8(24) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
#define WGMMA_RS_128(TY) \
  asm volatile( \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n" \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " " \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
      "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, " \
      "%58, %59, %60, %61, %62, %63}, " \
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n" \
      : F8(0), F8(8), F8(16), F8(24), F8(32), F8(40), F8(48), F8(56) \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));

template <int N, typename T = __nv_bfloat16>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a, uint64_t db) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma_rs takes N = 16, 32, 64, 128");
  if constexpr (N == 16) {
    if constexpr (kHalf<T>) {
      WGMMA_RS_16("f16");
    } else {
      WGMMA_RS_16("bf16");
    }
  } else if constexpr (N == 32) {
    if constexpr (kHalf<T>) {
      WGMMA_RS_32("f16");
    } else {
      WGMMA_RS_32("bf16");
    }
  } else if constexpr (N == 64) {
    if constexpr (kHalf<T>) {
      WGMMA_RS_64("f16");
    } else {
      WGMMA_RS_64("bf16");
    }
  } else if constexpr (N == 128) {
    if constexpr (kHalf<T>) {
      WGMMA_RS_128("f16");
    } else {
      WGMMA_RS_128("bf16");
    }
  }
}

#undef WGMMA_RS_16
#undef WGMMA_RS_32
#undef WGMMA_RS_64
#undef WGMMA_RS_128

#undef F8

__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// two floats rounded to T, packed lo first
template <typename T>
__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  if constexpr (kHalf<T>) {
    __half2 v = __floats2half2_rn(lo, hi);
    return *reinterpret_cast<uint32_t*>(&v);
  } else {
    return pack_bf16(lo, hi);
  }
}

// ---------------------------------------------------------------------------
// one warp's products on narrow tiles (head_dim 16 and 32): mma.sync
// m16n8k16 (bf16 in, float32 sums) fed by ldmatrix from the swizzled tiles
// ---------------------------------------------------------------------------

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void mma_16816(float* c, const uint32_t* a, uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The A fragments of rows row0 .. row0 + 15 of a narrow [*, D] tile, k-step
// kk (columns 16 kk .. 16 kk + 15) in a[kk]: lane l reads row row0 + l % 16,
// 8 columns from 16 kk + 8 (l / 16)
template <int D>
__device__ __forceinline__ void narrow_a_frags(uint32_t (*a)[4], uint32_t tile, int row0,
                                               int lane) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    ldmatrix_x4(a[kk], tile + narrow_offset<2 * D>(row0 + (lane & 15), 2 * kk + (lane >> 4)));
  }
}

// acc = A B^T over kNp pairs of 8-column pieces of a warp's 16 x 64 scores,
// the pairs from np0 on: piece 2 (np0 + j) + h (h = 0, 1) lands at
// acc[8 j + 4 h .. 8 j + 4 h + 3], element i of the pieces at acc[i]. A is
// the warp's D / 16 fragments, B rows of a narrow [64, D] tile, each piece
// 8 of them. n-tiles 2 np and 2 np + 1 take B rows 16 np .. 16 np + 15;
// lane l reads row 16 np + l % 8 + 8 (l / 16), 8 columns from 16 kk + 8
// ((l / 8) % 2)
template <int D, int kNp>
__device__ __forceinline__ void narrow_nt(float* acc, const uint32_t (*a)[4], uint32_t tile,
                                          int np0, int lane) {
#pragma unroll
  for (int j = 0; j < kNp; ++j) {
    const int np = np0 + j;
    float* c0 = acc + 8 * j;
#pragma unroll
    for (int i = 0; i < 8; ++i) c0[i] = 0.f;
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      uint32_t b[4];
      ldmatrix_x4(b, tile + narrow_offset<2 * D>(16 * np + (lane & 7) + ((lane >> 4) << 3),
                                                 2 * kk + ((lane >> 3) & 1)));
      mma_16816(c0, a[kk], b[0], b[1]);
      mma_16816(c0 + 4, a[kk], b[2], b[3]);
    }
  }
}

// acc[16 x D] += A B for one k-step: A the A fragment of 16 columns (the
// k-step kk of a 16 x 64 operand), B rows 16 kk .. 16 kk + 15 of a narrow
// [64, D] tile, read transposed (n-tiles 2 dp and 2 dp + 1 of d); lane l
// reads row 16 kk + l % 8 + 8 ((l / 8) % 2), 8 columns from 16 dp + 8 (l / 16)
template <int D>
__device__ __forceinline__ void narrow_nn_step(float* acc, const uint32_t* a, uint32_t tile,
                                               int kk, int lane) {
#pragma unroll
  for (int dp = 0; dp < D / 16; ++dp) {
    uint32_t b[4];
    ldmatrix_x4_trans(b, tile + narrow_offset<2 * D>(16 * kk + (lane & 7) +
                                                         (((lane >> 3) & 1) << 3),
                                                     2 * dp + (lane >> 4)));
    mma_16816(acc + 8 * dp, a, b[0], b[1]);
    mma_16816(acc + 8 * dp + 4, a, b[2], b[3]);
  }
}

// ---------------------------------------------------------------------------
// the products of the flash kernels, for one warpgroup's 64 rows
// ---------------------------------------------------------------------------

// acc[64 x BN] = A B^T: A is the warpgroup's 64 rows of a [kARows, D] tile
// (`a_rows` points at its first row in box 0), B a [BN, D] tile; both
// K-major, of type T. D / 16 wgmmas, 16 columns of d each.
template <int D, int BN, typename T = __nv_bfloat16, int kARows = 128>
__device__ __forceinline__ void issue_nt(float* acc, uint32_t a_rows, uint32_t b_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t col_bytes = (kk % 4) * 32;  // 16 columns within a 64-column box
    wgmma_ss<BN, T>(acc, kmajor_desc(a_rows + (kk / 4) * (kARows * 128) + col_bytes),
                 kmajor_desc(b_tile + (kk / 4) * (BN * 128) + col_bytes), kk > 0);
  }
}

// acc[64 x D] += A B: A [64 x BN] in registers in the A-operand layout
// (to_a), B a [BN, D] tile read MN-major, both of type T. BN / 16 k-steps of
// 16 rows of B, each over D in wgmmas of at most 128 columns (two 64-column
// boxes).
template <int D, int BN, typename T = __nv_bfloat16>
__device__ __forceinline__ void issue_nn(float* acc, const uint32_t* a, uint32_t b_tile) {
  constexpr int kOn = D < 128 ? D : 128;
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk) {
#pragma unroll
    for (int h = 0; h < D / kOn; ++h) {
      wgmma_rs<kOn, T>(acc + h * (kOn / 2), a + 4 * kk,
                    mnmajor_desc(b_tile + kk * 16 * 128 + h * (kOn / 64) * (BN * 128),
                                 BN * 128));
    }
  }
}

// An accumulator [64 x BN] in T in the A-operand layout: k-step kk takes
// registers 4 kk .. 4 kk + 3 (columns 16 kk .. 16 kk + 15), which is the
// accumulator's own order
template <int BN, typename T = __nv_bfloat16>
__device__ __forceinline__ void to_a(const float* s, uint32_t* pa) {
#pragma unroll
  for (int i = 0; i < BN / 4; ++i) pa[i] = pack2<T>(s[2 * i], s[2 * i + 1]);
}

// Writes a warpgroup's accumulator [64 x D], times mul[r] on its rows
// (element i of the accumulator sits at row 16 * warp + g + 8 * r, r =
// (i >> 1) & 1, column 8 * (i >> 2) + 2 * tq + (i & 1)), in T into its 64
// rows of a swizzled tile whose boxes are `box_bytes` apart, `rows` pointing
// at the first of them in box 0; a TMA store then takes them.
template <int D, typename T = __nv_bfloat16>
__device__ __forceinline__ void write_rows(uint8_t* rows, int box_bytes, const float* acc,
                                                const float* mul, int warp, int g, int tq) {
#pragma unroll
  for (int i = 0; i < D / 2; i += 2) {
    const int col = 8 * (i >> 2) + 2 * tq;  // columns col, col + 1
    const int r = (i >> 1) & 1;
    const int row = 16 * warp + g + 8 * r;  // within the warpgroup's rows
    const int chunk = ((col % 64) / 8) ^ (row % 8);
    const uint32_t off = (col / 64) * box_bytes + row * 128 + chunk * 16 + (col % 8) * 2;
    *reinterpret_cast<uint32_t*>(rows + off) = pack2<T>(acc[i] * mul[r], acc[i + 1] * mul[r]);
  }
}

// The flash forward's online softmax of one S tile (64 rows by BN columns
// of a warpgroup's accumulator) in log2 units: updates the running max m and
// this thread's share of the row sums l, returns the factor alpha that
// rescales O, and leaves P in s. Masks (causal, past t_kv) only where
// `masked`. Element i of the tile sits at row row0 + 8 * ((i >> 1) & 1) and
// column k0 + 8 * (i >> 2) + 2 * tq + (i & 1). The max is of the raw scores,
// the scale (p.scale_log2 = scale * log2 e, P's t_kv, causal, off and bk_eff
// as the forward kernels' Params name them) folded in after it, so the scale
// must be positive.
template <int BN, class P>
__device__ __forceinline__ void online_softmax(float* s, float* m, float* l, float* alpha,
                                               const P& p, int k0, int row0, int tq,
                                               bool masked) {
  float mx[2] = {-INFINITY, -INFINITY};
  if (masked) {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) {
      const int col = k0 + 8 * (i >> 2) + 2 * tq + (i & 1);
      const int row = row0 + 8 * ((i >> 1) & 1);
      const bool visible = col < p.t_kv && (!p.causal || row + p.off >= col);
      if (!visible) s[i] = -INFINITY;
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < BN / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
  }
  bool empty[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_cur = mx[r] == -INFINITY ? kNegInf : mx[r] * p.scale_log2;
    const float m_new = fmaxf(m[r], m_cur);
    alpha[r] = fast_exp2(m[r] - m_new);
    m[r] = m_new;
    empty[r] = m_new == kNegInf;  // no visible column so far
  }
  float rs[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) {
    const int r = (i >> 1) & 1;
    float pe = fast_exp2(fmaf(s[i], p.scale_log2, -m[r]));
    if (masked && empty[r]) {
      // every processed column of the row is masked: p = exp(0) = 1 on each
      // column of the reference's tile
      pe = 8 * (i >> 2) + 2 * tq + (i & 1) < p.bk_eff ? 1.f : 0.f;
    }
    s[i] = pe;
    rs[r] += pe;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------

// A 3-D tensor map [d, rows, bh] of T (bf16 or float16) with boxes of
// box_cols columns by box_rows rows, by default 64 columns with the 128-byte
// swizzle (a narrow tile: box_cols = d = 16 or 32 with the 32- or 64-byte
// swizzle); reads past `rows` fill zeros, writes are clipped.
template <typename T = __nv_bfloat16>
int make_map(CUtensorMap* map, const void* ptr, int d, int rows, int bh, int box_rows,
             int box_cols = 64, CUtensorMapSwizzle swizzle = CU_TENSOR_MAP_SWIZZLE_128B) {
  cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows, (cuuint64_t)bh};
  cuuint64_t strides[2] = {(cuuint64_t)d * 2, (cuuint64_t)rows * d * 2};
  cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = cuTensorMapEncodeTiled(
      map, kHalf<T> ? CU_TENSOR_MAP_DATA_TYPE_FLOAT16 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides,
      box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : kTensorMapFailed;
}

// Heads per launch group: as many as hold `head_bytes` each of streamed
// tiles within kL2GroupBytes, at least one, at most bh.
inline int l2_group(long long head_bytes, int bh) {
  const long long fit = kL2GroupBytes / head_bytes;
  return fit < 1 ? 1 : (fit > bh ? bh : (int)fit);
}

}  // namespace
