"""Variants of the float32 flash backward, built and timed on the card.

    python -m ray_tpu_torch.ops.flash_bwd_f32_variants [--out results.json] [--sass]

The float32 backward's kernels (``csrc/flash_bwd_f32.cu``, 3xTF32 on
``mma.sync``) beside:

* ``cuda cores``: the float32 kernels of ``csrc/flash_bwd.cu`` (one thread
  per row on the CUDA cores), which ``BWD_DESIGNS`` sent float32 to before
  the tensor-core design and which no path launches now;
* ``cvt.rna split``: the split by ``cvt.rna.tf32.f32`` (the same values
  but for NaN), which ptxas lowers with a NaN test;
* ``one chain for S and dP``: S and dP summed in one accumulator over d,
  without the fresh per-step sums (``mma3_add``), which misses the gate;
* ``1xTF32``: only the big * big product of each 3xTF32 step (the small
  terms dropped), which prices the other two; it misses the float32 gate
  and is no candidate.

A variant of the source is one piece of its text replaced, built with
``flash_fwd_variants.build_variant``. The script first measures the rate of
``mma.sync`` in tf32 alone (``mma_peak_tflops``), then prints each build's
spills, checks each against the plain backward (worst-row error,
``ops/tolerance.py``, and the three worst rows of dq, dk and dv), and times
the dQ and dK/dV kernels in turns (in order, then in reverse; the lesser of
the two) beside the backward of ``scaled_dot_product_attention`` in float32
at the shapes of ``SHAPES``. ``--sass`` prints the opcode counts of each
build's head_dim-128 kernels (``cuobjdump -sass``). It needs a card and
``nvcc``; nothing else of the port calls it.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.ops.flash_fwd_variants import build_variant, ms
from ray_tpu_torch.ops.tolerance import BWD_TOL, ROW_FLOOR, row_err

SOURCE = _build.CSRC_DIR / "flash_bwd_f32.cu"
_SPLIT = ("  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;\n"
          "  small = __float_as_uint(x - __uint_as_float(big)) + 0x1000u;")
VARIANTS = {
    "as built": [],
    "cvt.rna split": [(_SPLIT, '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(big) : "f"(x));\n'
                               '  asm("cvt.rna.tf32.f32 %0, %1;\\n" : "=r"(small) '
                               ': "f"(x - __uint_as_float(big)));')],
    "one chain for S and dP": [("      mma3_add(acc[nt], a, b);", "      mma3(acc[nt], a, b);")],
    "1xTF32": [("  mma_tf32(c, a.small, b.big);\n  mma_tf32(c, a.big, b.small);\n", ""),
               ("  mma_tf32_fresh(t, a.small, b.big);\n  mma_tf32(t, a.big, b.small);\n"
                "  mma_tf32(t, a.big, b.big);", "  mma_tf32_fresh(t, a.big, b.big);")],
}
# the CUDA-core kernels of flash_bwd.cu, by their entry points' dtype 1
CUDA_CORES = "cuda cores"
# b, h, t_q, t_kv, d, causal: train_f32's attention (gpt_1b at b=4), gpt_125m's
# head_dim 64 and gpt_j_6b's 256
SHAPES = [(4, 16, 2048, 2048, 128, True), (4, 12, 2048, 2048, 64, True),
          (1, 16, 2048, 2048, 256, True)]


def _entries(lib, dq_name: str, dkv_name: str):
    fns = []
    for name, n_ptr in ((dq_name, 7), (dkv_name, 8)):
        fn = getattr(lib, name)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def _build_variant(name: str):
    """(dQ function, dK/dV function, library path, spill bytes by kernel)."""
    if name == CUDA_CORES:
        path = _build.build("flash_bwd")
        lib = ctypes.CDLL(str(path))
        dq, dkv = _entries(lib, "ray_tpu_flash_bwd_dq", "ray_tpu_flash_bwd_dkv")
        return dq, dkv, path, {}
    lib, by_kernel = build_variant(SOURCE, name, VARIANTS[name])
    dq, dkv = _entries(lib, "ray_tpu_flash_bwd_dq_f32", "ray_tpu_flash_bwd_dkv_f32")
    spills = {f"{kernel} d={d}": sum(v for k, v in by_kernel.items()
                                     if f"{kernel}_f32x3" in k and f"ILi{d}E" in k)
              for kernel in ("dq", "dkv") for d in (64, 128, 256)}
    return dq, dkv, Path(lib._name), spills


def sass_opcodes(library: Path, kernel: str):
    """{opcode: count} of the SASS of ``kernel`` in ``library``
    (``cuobjdump -sass``)."""
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    text = subprocess.run([str(cuobjdump), "-sass", str(library)], capture_output=True,
                          text=True, check=True).stdout
    counts, inside = collections.Counter(), False
    for line in text.splitlines():
        if "Function :" in line:
            inside = kernel in line
        elif inside:
            m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", line)
            if m:
                counts[m.group(1).split(".")[0]] += 1
    return dict(counts.most_common())


# the tensor cores' rate for mma.sync.m16n8k8 in tf32: each warp issues 8
# independent products per step into its own accumulators, so only the
# tensor pipe bounds it
MMA_PEAK_SOURCE = r"""
#include <stdint.h>
__device__ __forceinline__ void mma_tf32(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__global__ void mma_peak_kernel(float* out, int iters) {
  uint32_t a[4], b[2];
  for (int i = 0; i < 4; ++i) a[i] = (threadIdx.x + i) << 13;
  for (int i = 0; i < 2; ++i) b[i] = (threadIdx.x * 3 + i) << 13;
  float c[8][4] = {};
  for (int it = 0; it < iters; ++it) {
#pragma unroll
    for (int j = 0; j < 8; ++j) mma_tf32(c[j], a, b);
  }
  float s = 0.f;
  for (int j = 0; j < 8; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  out[blockIdx.x * blockDim.x + threadIdx.x] = s;
}
extern "C" int ray_tpu_mma_peak(float* out, int blocks, int threads, int iters, void* stream) {
  mma_peak_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(out, iters);
  return (int)cudaGetLastError();
}
"""


def mma_peak_tflops(blocks_per_sm: int = 4, threads: int = 256, iters: int = 4096) -> float:
    """The card's mma.sync.m16n8k8 tf32 rate (TFLOP/s) from a kernel that
    issues nothing else (``MMA_PEAK_SOURCE``)."""
    out_dir = _build.BUILD_DIR / "variants" / "mma_peak"
    out_dir.mkdir(parents=True, exist_ok=True)
    src, lib_path = out_dir / "mma_peak.cu", out_dir / "libmma_peak.so"
    src.write_text(MMA_PEAK_SOURCE)
    subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib_path), str(src)],
                   capture_output=True, text=True, check=True)
    fn = ctypes.CDLL(str(lib_path)).ray_tpu_mma_peak
    fn.argtypes = [ctypes.c_void_p] + [ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    blocks = sms * blocks_per_sm
    out = torch.empty(blocks * threads, device="cuda")

    def run():
        if fn(out.data_ptr(), blocks, threads, iters, torch.cuda.current_stream().cuda_stream):
            raise SystemExit("mma_peak launch failed")

    t = ms(run, iters=5)
    flops = blocks * (threads // 32) * iters * 8 * 2 * 16 * 8 * 8
    return flops / (t / 1e3) / 1e12


def worst_rows(x, ref, n: int = 3):
    """The ``n`` rows of ``x`` [b, h, t, d] farthest from ``ref`` by
    ``row_err``'s measure: [(b, h, row, error), ...]."""
    diff = torch.linalg.vector_norm(x.float() - ref.float(), dim=-1)
    norm = torch.linalg.vector_norm(ref.float(), dim=-1)
    floor = (ROW_FLOOR * norm.square().mean().sqrt()).clamp(min=torch.finfo(torch.float32).tiny)
    err = (diff / torch.maximum(norm, floor)).flatten()
    top = torch.topk(err, n)
    b, h, t = x.shape[:3]
    return [(int(i) // (h * t), int(i) // t % h, int(i) % t, float(e))
            for e, i in zip(top.values, top.indices)]


def _call(fn, tensors, q, t_kv, causal, scale):
    b, h, t_q, d = q.shape
    err = fn(*(t.data_ptr() for t in tensors), b * h, t_q, t_kv, d, 1, int(causal), scale,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"variant launch failed ({err})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results to this JSON file")
    ap.add_argument("--sass", action="store_true",
                    help="print the opcode counts of each build's head_dim-128 kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_f32_variants needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    peak = mma_peak_tflops()
    print(f"[mma] mma.sync.m16n8k8 tf32 alone: {peak:.1f} TFLOP/s (a third of it is the "
          f"ceiling of 3xTF32 on mma.sync: {peak / 3:.1f})")
    names = [CUDA_CORES, *VARIANTS]
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per variant
        built = dict(zip(names, pool.map(_build_variant, names)))
    sass = {}
    for name, (_, _, path, spills) in built.items():
        print(f"[variant] {name:<22} spill bytes {spills}")
        if args.sass and name != CUDA_CORES:
            for kernel in ("flash_bwd_dq_f32x3_kernelILi128E", "flash_bwd_dkv_f32x3_kernelILi128E"):
                sass[name, kernel] = sass_opcodes(path, kernel)
                top = list(sass[name, kernel].items())[:14]
                print(f"[sass] {name:<14} {kernel}: {sum(sass[name, kernel].values())} "
                      f"instructions; {top}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, t_q, t_kv, d, causal in SHAPES:
        q, k, v, do = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                       for t in (t_q, t_kv, t_kv, t_q))
        scale = d ** -0.5
        o, lse = attn.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        delta = attn.flash_bwd_delta(o, do)
        want = attn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        runs = {}
        for name, (dq_fn, dkv_fn, _, _) in built.items():
            runs[name, "dq"] = lambda fn=dq_fn: _call(fn, (q, k, v, do, lse, delta, dq), q,
                                                      t_kv, causal, scale)
            runs[name, "dkv"] = lambda fn=dkv_fn: _call(
                fn, (q, k, v, do, lse, delta, dk, dv), q, t_kv, causal, scale)
        errs, worst = {}, {}
        for name in built:
            runs[name, "dq"]()
            runs[name, "dkv"]()
            torch.cuda.synchronize()
            errs[name] = max(row_err(x, ref) for x, ref in zip((dq, dk, dv), want))
            worst[name] = {g_name: worst_rows(x, ref) for g_name, x, ref
                           in zip(("dq", "dk", "dv"), (dq, dk, dv), want)}
            print(f"[rows] {name:<22} {[b, h, t_q, t_kv, d]}: worst rows (b, h, row, "
                  f"row_err) {worst[name]}", flush=True)
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, scale=scale)
        runs["sdpa", "bwd"] = lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                          retain_graph=True)
        times = {key: [] for key in runs}
        for key in list(runs) + list(runs)[::-1]:
            times[key].append(ms(runs[key], iters=2 if key[0] == CUDA_CORES else 10))
        row = dict(shape=[b, h, t_q, t_kv, d], causal=causal,
                   dq_ms={n: min(times[n, "dq"]) for n in built},
                   dkv_ms={n: min(times[n, "dkv"]) for n in built},
                   sdpa_bwd_ms=min(times["sdpa", "bwd"]), row_err=errs, worst_rows=worst,
                   ok={n: e <= BWD_TOL[torch.float32] for n, e in errs.items()})
        rows.append(row)
        print(f"[time] {row['shape']} causal={causal}: SDPA backward "
              f"{row['sdpa_bwd_ms']:.4f} ms | "
              + " | ".join(f"{n} dQ {row['dq_ms'][n]:.4f} ms dK/dV {row['dkv_ms'][n]:.4f} ms "
                           f"(worst row {errs[n]:.2e}{'' if row['ok'][n] else ', over the gate'})"
                           for n in built), flush=True)
        del want, lib_out
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, mma_sync_tf32_tflops=peak, spills={n: s for n, (*_, s) in built.items()},
                           sass={f"{n} {k}": v for (n, k), v in sass.items()},
                           shapes=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
