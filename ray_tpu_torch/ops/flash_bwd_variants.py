"""Variants of the bf16 flash backward kernels, built and timed on the card.

    python -m ray_tpu_torch.ops.flash_bwd_variants [--small-d | --d64] [--out results.json]

Each variant is ``csrc/flash_bwd_wgmma.cu`` and ``csrc/hopper.cuh`` with one
piece of text replaced (``flash_fwd_variants.build_variant``):

* ``as built``: the sources unchanged;
* ``dQ kv tile 64``: the dQ kernel's K/V tiles of 64 rows instead of 128
  (fewer registers, twice the barrier rounds);
* ``dK/dV 3 stages``: a third stage of Q and dO in the dK/dV kernel's ring;
* ``L2 group 32 MiB``: launch groups of heads whose streamed tiles fill
  32 MiB of L2 instead of 16 (at gpt_j_6b's b=1 every head in one group, so
  the heaviest tiles of all heads run first).

It prints each variant's spills from the compiler's report, checks each
kernel against the plain backward (worst-row error, ``ops/tolerance.py``),
and times the dQ and dK/dV kernels in turns (the variants in order, then in
reverse; the lesser of the two) at the shapes of ``SHAPES``.

With ``--small-d`` the variants are of ``csrc/flash_bwd_persistent.cu``,
the design of bf16 at head_dim 16 and 32 (``SMALL_D_VARIANTS``), timed
beside the mma.sync pair of ``csrc/flash_bwd.cu`` that it replaced
(``mma.sync before``, launched directly) and beside the library's whole
backward (autograd through ``scaled_dot_product_attention``) at gpt_nano's
and the tiny flagship's working shapes and at long t (``SMALL_D_SHAPES``):

* ``as built``: the source unchanged;
* ``three item buffers``: the item's tiles triple buffered, so the
  producer runs two items ahead;
* ``one CTA an SM fewer``, ``one CTA an SM more``: the register budget
  set for 2 or 4 CTAs an SM instead of 3;
* ``chunks of 2 pieces``, ``chunks of 8 pieces``: a tile's scores in
  chunks of 16 or 64 columns instead of 32 (the grain of the piece skip,
  and the scores a warp holds at once);
* ``two stages``, ``four stages``: the ring's depth at both head_dims
  (the source takes 2 at 16 and 4 at 32);
* probes, wrong by design (the check marks them WRONG): ``probe: copies
  only`` (the consumers release each streamed stage as it lands and do no
  math; the item's tiles are read and the outputs written as before),
  ``probe: no ex2`` (P is the exponential's argument), ``probe: no
  epilogue`` (no dq, dk or dv staged or stored, behind a test the compiler
  cannot decide, so the math stays) and ``probe: no piece skip`` (every
  chunk of every masked tile computed), which say what the copies, the
  exponentials, the stores and the skip cost.

With ``--d64`` the variants are of ``csrc/flash_bwd_d64.cu``'s dK/dV
kernel, the design of bf16 at head_dim 64 (``D64_VARIANTS``), timed beside
the wgmma dK/dV of ``csrc/flash_bwd_wgmma.cu`` that it took over from there
(``wgmma before``), with the wgmma dQ (which stays on that path) and the
library's whole backward at gpt_125m's heads at b=4 and b=16, causal, and
b=4 non-causal (``flash_fwd_variants.D64_SHAPES``):

* ``as built``: the source unchanged;
* ``two stages``: two stages of Q and dO in the ring instead of three
  (the design's first run);
* probes, wrong by design: ``probe: copies only`` (the consumers release
  each stage as it lands and do no math; K and V are read and dK, dV
  written as before), ``probe: no ex2`` (P is the exponential's argument)
  and ``probe: no epilogue`` (no dK or dV written, behind a test of a
  kernel argument, so the math stays).

There each time is the median and the spread of five alternating turns, as
``flash_fwd_variants --d64`` takes them.

Each ``--small-d`` time is the kernel's device time per call from torch.profiler,
the least of five turns after half a second of load to settle the clocks,
since at these shapes the host's launches take about as long as the
kernel. It needs a card and ``nvcc``; nothing else of the port calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.ops.flash_fwd_variants import (D64_SHAPES, build_variant, device_ms, ms,
                                                   turn_order)
from ray_tpu_torch.ops.tolerance import BWD_TOL, row_err

SOURCE = _build.CSRC_DIR / "flash_bwd_wgmma.cu"
VARIANTS = {
    "as built": [],
    "dQ kv tile 64": [("constexpr int kDqBlockK = 128;", "constexpr int kDqBlockK = 64;")],
    "dK/dV 3 stages": [("constexpr int kDkvStages = 2;", "constexpr int kDkvStages = 3;")],
    "L2 group 32 MiB": [("constexpr long long kL2GroupBytes = 16ll << 20;",
                         "constexpr long long kL2GroupBytes = 32ll << 20;")],
}
# b, h, t_q, t_kv, d, causal: gpt_1b's train step (b=12), b=4, non-causal;
# gpt_j_6b's (b=1, head_dim 256)
SHAPES = [(12, 16, 2048, 2048, 128, True), (4, 16, 2048, 2048, 128, True),
          (4, 16, 2048, 2048, 128, False), (1, 16, 2048, 2048, 256, True)]


def _bind(lib, dq_entry: str, dkv_entry: str):
    """The dQ and dK/dV entry points of a built library, their types set."""
    fns = []
    for entry, n_ptr in ((dq_entry, 7), (dkv_entry, 8)):
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


def _build_variant(name: str):
    """(dQ function, dK/dV function, spill bytes of each kernel by head_dim)
    of one variant."""
    lib, by_kernel = build_variant(SOURCE, name, VARIANTS[name])
    dq, dkv = _bind(lib, "ray_tpu_flash_bwd_dq_wgmma", "ray_tpu_flash_bwd_dkv_wgmma")
    spills = {f"{kernel} d={d}": sum(v for k, v in by_kernel.items()
                                     if kernel in k and f"ILi{d}E" in k)
              for kernel in ("dq_wgmma", "dkv_wgmma") for d in (64, 128, 256)}
    return dq, dkv, spills


def _call(fn, tensors, q, t_kv, causal, scale):
    b, h, t_q, d = q.shape
    err = fn(*(t.data_ptr() for t in tensors), b * h, t_q, t_kv, d, 0, int(causal), scale,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"variant launch failed ({err})")


SMALL_D_SOURCE = _build.CSRC_DIR / "flash_bwd_persistent.cu"
_DQ_WAIT = "      mbar_wait(bar_kv_full + 8 * s, (c / kStages) & 1);\n"
_DKV_WAIT = "      mbar_wait(bar_q_full + 8 * s, (c / kStages) & 1);\n"


def _release_at_once(wait: str, empty: str) -> str:
    return (f"{wait}      if (true) {{\n        __syncwarp();\n"
            f"        if (lane == 0) mbar_arrive({empty} + 8 * s);\n        continue;\n      }}\n")


_BLOCKS = "constexpr int kMinBlocks = 3;"
_CHUNK = "constexpr int kChunk = 4;"
_STAGES = "template <int D> constexpr int kStagesAt = D == 16 ? 2 : 4;"
SMALL_D_VARIANTS = {
    "as built": [],
    "three item buffers": [("constexpr int kItemBufs = 2;", "constexpr int kItemBufs = 3;")],
    "one CTA an SM fewer": [(_BLOCKS, "constexpr int kMinBlocks = 2;")],
    "one CTA an SM more": [(_BLOCKS, "constexpr int kMinBlocks = 4;")],
    "chunks of 2 pieces": [(_CHUNK, "constexpr int kChunk = 2;")],
    "chunks of 8 pieces": [(_CHUNK, "constexpr int kChunk = 8;")],
    "two stages": [(_STAGES, "template <int D> constexpr int kStagesAt = 2;")],
    "four stages": [(_STAGES, "template <int D> constexpr int kStagesAt = 4;")],
    # probes, wrong by design: what the copies alone cost, the exponentials,
    # the stores and the piece skip
    "probe: copies only": [(_DQ_WAIT, _release_at_once(_DQ_WAIT, "bar_kv_empty")),
                           (_DKV_WAIT, _release_at_once(_DKV_WAIT, "bar_q_empty"))],
    "probe: no ex2": [
        ("float pe = fast_exp2(fmaf(s[i], scale_log2, -l2[r]));",
         "float pe = fmaf(s[i], scale_log2, -l2[r]);"),
        ("float pe = fast_exp2(fmaf(s[i], scale_log2, -l2[e & 1]));",
         "float pe = fmaf(s[i], scale_log2, -l2[e & 1]);")],
    # the stores skipped by a test the compiler cannot decide (rows > 0 at
    # every call), so that the math that feeds them stays
    "probe: no epilogue": [("  if (lane == 0) bulk_wait_all<true>();\n",
                            "  if (rows > 0) return;\n  if (lane == 0) bulk_wait_all<true>();\n")],
    "probe: no piece skip": [
        ("const int chunks = !warp_live || warp_lim < k0 ? 0 : (warp_lim - k0) / (8 * kC) + 1;",
         "const int chunks = 8 / kC;"),
        ("const int first_chunk = !warp_live || fc >= kBlock ? 8 / kC : max(fc, 0) / (8 * kC);",
         "const int first_chunk = 0;")],
}
# gpt_nano's working case (4g: b=512, 4 x 16, t=128), the tiny flagship's
# (b=256, 8 x 32, t=256), and long t at both head_dims
SMALL_D_SHAPES = [(512, 4, 128, 128, 16, True), (256, 8, 256, 256, 32, True),
                  (16, 4, 2048, 2048, 16, True), (8, 8, 2048, 2048, 32, True)]


D64_SOURCE = _build.CSRC_DIR / "flash_bwd_d64.cu"
D64_VARIANTS = {
    "as built": [],
    "two stages": [("constexpr int kStages = 3;      // ring depth",
                    "constexpr int kStages = 2;      // ring depth")],
    # probes, wrong by design: the copies alone, the math without MUFU, the
    # math without the epilogue
    "probe: copies only": [("    if (n_run > 0) {\n      float s[kBlockQ / 2];       // S^T\n",
                            "    for (int j = 0; j < n_run; ++j) {\n"
                            "      if (j == 0) mbar_wait(bar_kv, 0);\n"
                            "      mbar_wait(bar_full + 8 * (j % kStages), (j / kStages) & 1);\n"
                            "      if (lane == 0) mbar_arrive(bar_empty + 8 * (j % kStages));\n"
                            "    }\n"
                            "    if (false) {\n      float s[kBlockQ / 2];       // S^T\n")],
    "probe: no ex2": [("float p0 = fast_exp2(fmaf(s[e], p.scale_log2, -l0));",
                       "float p0 = fmaf(s[e], p.scale_log2, -l0);"),
                      ("float p1 = fast_exp2(fmaf(s[e + 1], p.scale_log2, -l1));",
                       "float p1 = fmaf(s[e + 1], p.scale_log2, -l1);")],
    # a test the compiler cannot decide (bh > 0 at every call)
    "probe: no epilogue": [("    const float scale[2] = {p.scale, p.scale};\n",
                            "    if (p.bh > 0) return;\n"
                            "    const float scale[2] = {p.scale, p.scale};\n")],
}


def _build_d64(name: str):
    """(dK/dV function, spill bytes) of one head_dim-64 variant."""
    lib, by_kernel = build_variant(D64_SOURCE, name, D64_VARIANTS[name])
    fn = lib.ray_tpu_flash_bwd_dkv_d64
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, sum(by_kernel.values())


def main_d64(smi: str, out: str | None) -> int:
    """The d64 dK/dV's variants beside the wgmma dK/dV, the wgmma dQ and the
    library's whole backward, device time per call, median and spread of
    five alternating turns."""
    with ThreadPoolExecutor(len(D64_VARIANTS)) as pool:  # one nvcc per variant
        built = dict(zip(D64_VARIANTS, pool.map(_build_d64, D64_VARIANTS)))
    dq_fn, old_dkv = _bind(attn._kernel_lib("flash_bwd_wgmma"), "ray_tpu_flash_bwd_dq_wgmma",
                           "ray_tpu_flash_bwd_dkv_wgmma")
    built["wgmma before"] = (old_dkv, None)
    for name, (_, spills) in built.items():
        print(f"[variant] {name:<22} spill bytes {spills}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, t_q, t_kv, d, causal in D64_SHAPES:
        q, k, v, do = (torch.randn(b, h, t, d, device="cuda", dtype=torch.bfloat16,
                                   generator=gen) for t in (t_q, t_kv, t_kv, t_q))
        scale = d ** -0.5
        o, lse = attn.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        delta = attn.flash_bwd_delta(o, do)
        _, want_dk, want_dv = attn.flash_attention_bwd_plain(q, k, v, o, lse, do,
                                                             causal=causal, scale=scale)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        runs = {name: (lambda fn=fn: _call(fn, (q, k, v, do, lse, delta, dk, dv), q, t_kv,
                                           causal, scale))
                for name, (fn, _) in built.items()}
        errs = {}
        for name, run in runs.items():
            dk.fill_(float("nan"))
            dv.fill_(float("nan"))
            run()
            torch.cuda.synchronize()
            errs[name] = {"dk": row_err(dk, want_dk), "dv": row_err(dv, want_dv)}
        t_end = time.monotonic() + 0.5
        while time.monotonic() < t_end:
            runs["as built"]()
        torch.cuda.synchronize()
        times = {name: [] for name in built}
        for name in turn_order(built):
            times[name].append(device_ms(runs[name]))
        dq_ms = device_ms(lambda: _call(dq_fn, (q, k, v, do, lse, delta, dq), q, t_kv, causal,
                                        scale))
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, scale=scale)
        sdpa = device_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                     retain_graph=True), per_call=None)
        med = {n: statistics.median(t) for n, t in times.items()}
        tol = BWD_TOL[torch.bfloat16]
        row = dict(shape=[b, h, t_q, t_kv, d], causal=causal, sdpa_bwd_ms=sdpa,
                   wgmma_dq_ms=dq_ms, dkv_ms=med, turns=times, row_err=errs,
                   ok={n: max(e.values()) <= tol for n, e in errs.items()})
        rows.append(row)
        print(f"[time] {row['shape']} causal={causal}: dK/dV "
              + " | ".join(f"{n} {med[n]:.4f} ms ({min(times[n]):.4f}-{max(times[n]):.4f})"
                           + ("" if row["ok"][n] else " (WRONG)") for n in built)
              + f" | wgmma dQ {dq_ms:.4f} ms | sdpa whole backward {sdpa:.4f} ms", flush=True)
        print(f"[err] {row['shape']}: " + " | ".join(
            f"{n} " + " ".join(f"{g} {e:.2e}" for g, e in errs[n].items()) for n in built))
        del want_dk, want_dv, lib_out
    if out:
        with open(out, "w") as f:
            json.dump(dict(card=smi, spills={n: s for n, (_, s) in built.items()},
                           times="device time (torch.profiler), median of five turns",
                           shapes=rows), f, indent=1)
    return 0


def _build_small_d(name: str):
    """(dQ function, dK/dV function, spill bytes of each kernel by head_dim)
    of one small-d variant."""
    lib, by_kernel = build_variant(SMALL_D_SOURCE, name, SMALL_D_VARIANTS[name])
    dq, dkv = _bind(lib, "ray_tpu_flash_bwd_dq_persistent", "ray_tpu_flash_bwd_dkv_persistent")
    spills = {f"{kernel} d={d}": sum(v for k, v in by_kernel.items()
                                     if f"{kernel}_persistent" in k and f"ILi{d}E" in k)
              for kernel in ("dq", "dkv") for d in (16, 32)}
    return dq, dkv, spills


def main_small_d(smi: str, out: str | None) -> int:
    """The persistent pair's variants beside the mma.sync pair and the
    library's backward, device time per call."""
    with ThreadPoolExecutor(len(SMALL_D_VARIANTS)) as pool:  # one nvcc per variant
        built = dict(zip(SMALL_D_VARIANTS, pool.map(_build_small_d, SMALL_D_VARIANTS)))
    # the pair this design replaced, from the port's own build
    built["mma.sync before"] = (*_bind(attn._kernel_lib("flash_bwd"), "ray_tpu_flash_bwd_dq",
                                       "ray_tpu_flash_bwd_dkv"), {})
    for name, (*_, spills) in built.items():
        print(f"[variant] {name:<22} spill bytes {spills}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, t_q, t_kv, d, causal in SMALL_D_SHAPES:
        q, k, v, do = (torch.randn(b, h, t, d, device="cuda", dtype=torch.bfloat16,
                                   generator=gen) for t in (t_q, t_kv, t_kv, t_q))
        scale = d ** -0.5
        o, lse = attn.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        delta = attn.flash_bwd_delta(o, do)
        want = attn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        runs = {}
        for name, (dq_fn, dkv_fn, _) in built.items():
            runs[name, "dq"] = lambda fn=dq_fn: _call(fn, (q, k, v, do, lse, delta, dq), q,
                                                      t_kv, causal, scale)
            runs[name, "dkv"] = lambda fn=dkv_fn: _call(
                fn, (q, k, v, do, lse, delta, dk, dv), q, t_kv, causal, scale)
        errs = {}
        for name in built:
            for x in (dq, dk, dv):
                x.fill_(float("nan"))
            runs[name, "dq"]()
            runs[name, "dkv"]()
            torch.cuda.synchronize()
            errs[name] = {g: row_err(x, ref) for g, x, ref in zip(("dq", "dk", "dv"),
                                                                    (dq, dk, dv), want)}
        # the card's clocks settle under load before the first turn
        t_end = time.monotonic() + 0.5
        while time.monotonic() < t_end:
            runs["as built", "dq"]()
            runs["as built", "dkv"]()
        torch.cuda.synchronize()
        times = {key: [] for key in runs}
        for name in (list(built) + list(built)[::-1]) * 2 + list(built):
            for kernel in ("dq", "dkv"):
                times[name, kernel].append(device_ms(runs[name, kernel]))
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, scale=scale)
        sdpa = device_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                     retain_graph=True), per_call=None)
        tol = BWD_TOL[torch.bfloat16]
        row = dict(shape=[b, h, t_q, t_kv, d], causal=causal, sdpa_bwd_ms=sdpa,
                   dq_ms={n: min(times[n, "dq"]) for n in built},
                   dkv_ms={n: min(times[n, "dkv"]) for n in built}, row_err=errs,
                   ok={n: max(e.values()) <= tol for n, e in errs.items()})
        rows.append(row)
        print(f"[time] {row['shape']} causal={causal}: "
              + " | ".join(f"{n} dQ {row['dq_ms'][n]:.4f} ms dK/dV {row['dkv_ms'][n]:.4f} ms"
                           + ("" if row["ok"][n] else " (WRONG)") for n in built)
              + f" | sdpa whole backward {sdpa:.4f} ms", flush=True)
        print(f"[err] {row['shape']}: " + " | ".join(
            f"{n} " + " ".join(f"{g} {e:.2e}" for g, e in errs[n].items()) for n in built))
        del want, lib_out
    if out:
        with open(out, "w") as f:
            json.dump(dict(card=smi, spills={n: s for n, (*_, s) in built.items()},
                           times="device time (torch.profiler)", shapes=rows), f, indent=1)
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results to this JSON file")
    ap.add_argument("--small-d", action="store_true",
                    help="the head_dim 16/32 design's variants beside the mma.sync pair")
    ap.add_argument("--d64", action="store_true",
                    help="the head_dim 64 dK/dV design's variants beside the wgmma kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    if args.small_d:
        return main_small_d(smi, args.out)
    if args.d64:
        return main_d64(smi, args.out)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc per variant
        built = dict(zip(VARIANTS, pool.map(_build_variant, VARIANTS)))
    for name, (_, _, spills) in built.items():
        print(f"[variant] {name:<20} spill bytes {spills}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, t_q, t_kv, d, causal in SHAPES:
        q, k, v, do = (torch.randn(b, h, t, d, device="cuda", dtype=torch.bfloat16,
                                   generator=gen) for t in (t_q, t_kv, t_kv, t_q))
        scale = d ** -0.5
        o, lse = attn.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        delta = attn.flash_bwd_delta(o, do)
        want = attn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        runs = {}
        for name, (dq_fn, dkv_fn, _) in built.items():
            runs[name, "dq"] = lambda fn=dq_fn: _call(fn, (q, k, v, do, lse, delta, dq), q,
                                                      t_kv, causal, scale)
            runs[name, "dkv"] = lambda fn=dkv_fn: _call(
                fn, (q, k, v, do, lse, delta, dk, dv), q, t_kv, causal, scale)
        errs = {}
        for name in built:
            runs[name, "dq"]()
            runs[name, "dkv"]()
            torch.cuda.synchronize()
            errs[name] = max(row_err(x, ref) for x, ref in zip((dq, dk, dv), want))
        times = {key: [] for key in runs}
        for name in list(built) + list(built)[::-1]:
            for kernel in ("dq", "dkv"):
                times[name, kernel].append(ms(runs[name, kernel], iters=10))
        row = dict(shape=[b, h, t_q, t_kv, d], causal=causal,
                   dq_ms={n: min(times[n, "dq"]) for n in built},
                   dkv_ms={n: min(times[n, "dkv"]) for n in built}, row_err=errs,
                   ok={n: e <= BWD_TOL[torch.bfloat16] for n, e in errs.items()})
        rows.append(row)
        print(f"[time] {row['shape']} causal={causal}: "
              + " | ".join(f"{n} dQ {row['dq_ms'][n]:.4f} ms dK/dV {row['dkv_ms'][n]:.4f} ms"
                           + ("" if row["ok"][n] else " (WRONG)") for n in built), flush=True)
        del want
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, spills={n: s for n, (_, _, s) in built.items()},
                           shapes=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
