"""Variants of the bf16 flash backward kernels, built and timed on the card.

    python -m ray_tpu_torch.ops.flash_bwd_variants [--small-d | --d64 | --dsplit | --wide
        | --wide-f32 | --designs] [--dtype float32|bfloat16|float16] [--out results.json]

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

With ``--d64`` the variants are of ``csrc/flash_bwd_d64.cu``, the design of
bf16 at head_dim 64 (``D64_VARIANTS``; ``--only dq`` or ``--only dkv`` for
one kernel's), each timed beside the kernel of ``csrc/flash_bwd_wgmma.cu``
that it took over from (``wgmma before``) and the library's whole backward
at gpt_125m's heads at b=4 and b=16, causal, and b=4 non-causal
(``flash_fwd_variants.D64_SHAPES``):

* ``as built``: the source unchanged;
* dQ: ``64-row kv tiles``, ``two stages`` (of K and V, instead of four),
  ``scale in dS`` (the scale multiplied into every dS element instead of
  dQ's epilogue), and probes,
  wrong by design: ``probe: copies only`` (the consumers release each K/V
  tile as it lands and do no math), ``probe: no ex2`` (P is the
  exponential's argument);
* dK/dV: ``two stages`` (of Q and dO, instead of three), and probes:
  ``probe: copies only``, ``probe: no ex2`` and ``probe: no epilogue`` (no
  dK or dV written, behind a test of a kernel argument, so the math
  stays).

There each time is the median and the spread of five alternating turns, as
``flash_fwd_variants --d64`` takes them.

With ``--dsplit`` it times, at head_dims from 896 up, the pair of
``csrc/flash_bwd_dcluster.cu`` (design ``dcluster``, the port's backward
there) beside the pair of ``csrc/flash_bwd_dsplit.cu`` that it took over
from (``dsplit before``, launched directly: it is on no path) and the
library's whole backward, at ``DSPLIT_SHAPES`` (2 x 8 heads x 2048^2,
causal, d 896, 1024 and 2048) in float32 and bf16 (``--dtype`` for one):
both pairs held to the plain backward (float64 for float32), each time the
device time per call, median and spread of five alternating turns, beside
the bound (operations: 6 d a visible pair for dQ, 8 d for dK/dV, at 164.9
TFLOP/s in float32 and 989 in bf16) and its share. ``--probes`` adds
builds of ``flash_bwd_dcluster.cu`` that are wrong by design
(``DCLUSTER_PROBES``): ``probe: no streamed loads`` (no streamed tile is
copied, so the products read what the slot held), ``probe: no exchange``
(each CTA reduces every position from its own partials alone, so S and dP
cover its columns only), ``probe: no partial math`` and ``probe: no output
math`` (the products skipped behind a test of a kernel argument, so the
rest stays), which say what the loads, the exchange between the CTAs and
the two products cost.

With ``--wide-f32`` it times the float32 backward at 384, 512, 640 and 768
(``WIDE_SHAPES``: 2 x 8 heads x 2048^2, causal, chip_smoke.py's timed
cases): the pair of ``csrc/flash_bwd_dcluster128.cu`` (design
``dcluster128``, the port's there) beside the pair of
``csrc/flash_bwd_f32.cu`` it took over from (``tf32x3 before``, launched
directly), the pair of ``csrc/flash_bwd_dcluster.cu`` at its own
256-column plan (``dcluster 256``, launched directly: what the cluster alone
buys) and the library's whole backward, as ``--dsplit`` times them, after
dcluster128's registers, spills and clusters resident at 3 to 6 CTAs.
``--probes`` adds the builds that price the split-once: ``probe: split at
every load`` (``kSplitResident`` false: the resident fragments kept raw and
split at each use, so no operand is split once) and ``probe: streamed split
once`` (``kSplitStreamed`` true: the streamed tiles split where they land
into a big and a small plane, two stages instead of three). Neither is
wrong: both are held to the plain backward.

With ``--wide`` it times the bf16 backward at 384, 512, 640 and 768
(``WIDE_SHAPES``): the pair of ``csrc/flash_bwd_dcluster128_wgmma.cu``
(design ``dcluster128``, the port's there) beside the pair of
``csrc/flash_bwd_wide.cu`` it took over from (``wide before``, launched
directly), the pair of ``csrc/flash_bwd_dcluster.cu`` at its own 256-column
plan (``dcluster 256``) and the library's whole backward, as ``--wide-f32``
does, after the registers, spills, CTAs an SM and clusters resident at 3
to 6 CTAs of each kernel, and beside builds of other tiles
(``DCLUSTER128_WGMMA_VARIANTS``: ``dQ 64 rows at every d`` and ``dQ 32
rows at every d``, dQ's streamed side of clusters of 2 and 3 (64 kv rows,
three stages, one CTA an SM) or of clusters from 4 (32 rows in a ring of
two, two CTAs an SM) at every cluster size; ``32 streamed rows`` for both
kernels in three stages; ``128 resident rows``, two warpgroups of resident
rows sharing each streamed tile of 32 rows and each exchange round), each
held to the plain backward. ``--probes`` adds ``probe: copies only`` (the
streamed tiles land and nothing else runs) and ``probe: no exchange``
(each CTA reduces every position from its own partials alone, so S and dP
cover its columns only), wrong by design, which say what the copies and
the exchange cost.

With ``--designs`` it times no variant: the port's dQ and dK/dV as built,
through their wrappers (the design ``BWD_DESIGNS`` names), at
``DESIGN_SHAPES`` (``flash_fwd_variants``': the timed 16-bit cases of
``PERF.md``'s table) in bf16 and float16 (``--dtype`` for one), the dtypes
alternating in five turns, each held to the plain backward and timed beside
the library's whole backward in the same dtype and each kernel's bound.
``--dtype float16`` also runs ``--dsplit`` on the float16 builds.

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
from ray_tpu_torch.ops.flash_fwd_variants import (D64_SHAPES, DESIGN_SHAPES, build_variant,
                                                   device_ms, ms, turn_order)
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
    err = fn(*(t.data_ptr() for t in tensors), b * h, t_q, t_kv, d,
             attn._DTYPE_CODES[q.dtype], int(causal), scale,
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
_DQ_MATH = "      if (n_cta > 0) {\n        float s[kDqBN / 2];       // S, which gives P\n"
# each variant's kernel (the one it changes, timed beside its "as built" and
# its wgmma predecessor: "dq", "dkv", or "both" for "as built") and its edits
D64_VARIANTS = {
    "as built": ("both", []),
    "dQ: 64-row kv tiles": ("dq", [("constexpr int kDqBN = 128;", "constexpr int kDqBN = 64;")]),
    "dQ: two stages": ("dq", [("constexpr int kDqStages = 4;", "constexpr int kDqStages = 2;")]),
    "dQ: scale in dS": ("dq", [
        ("dsa[i / 2] = pack2<T>(p0 * (dp[i] - dl[r]), p1 * (dp[i + 1] - dl[r]));",
         "dsa[i / 2] = pack2<T>(p0 * (dp[i] - dl[r]) * p.scale, "
         "p1 * (dp[i + 1] - dl[r]) * p.scale);"),
        ("        const float scale[2] = {p.scale, p.scale};\n"
         "        write_rows<kD, T>(gbase + (q_rows - base)",
         "        const float scale[2] = {1.f, 1.f};\n"
         "        write_rows<kD, T>(gbase + (q_rows - base)")]),
    # probes, wrong by design: the dQ consumers releasing each K/V tile as it
    # lands with no math (the items' Q, dO, lse and delta are read and dQ
    # written as before), and the math without MUFU
    "dQ probe: copies only": ("dq", [(_DQ_MATH, (
        "      for (int j = 0; j < n_cta; ++j) {\n"
        "        const int stage = (c + j) % kStages, phase = ((c + j) / kStages) & 1;\n"
        "        mbar_wait(bar_k + 8 * stage, phase);\n"
        "        mbar_wait(bar_v + 8 * stage, phase);\n"
        "        if (lane == 0) mbar_arrive(bar_k_empty + 8 * stage);\n"
        "        if (lane == 0) mbar_arrive(bar_v_empty + 8 * stage);\n"
        "      }\n"
        "      if (false) {\n        float s[kDqBN / 2];       // S, which gives P\n"))]),
    "dQ probe: no ex2": ("dq", [
        ("float p0 = fast_exp2(fmaf(s[i], p.scale_log2, -lse2[r]));",
         "float p0 = fmaf(s[i], p.scale_log2, -lse2[r]);"),
        ("float p1 = fast_exp2(fmaf(s[i + 1], p.scale_log2, -lse2[r]));",
         "float p1 = fmaf(s[i + 1], p.scale_log2, -lse2[r]);")]),
    "dK/dV: two stages": ("dkv", [("constexpr int kStages = 3;      // ring depth",
                                   "constexpr int kStages = 2;      // ring depth")]),
    # probes, wrong by design: the copies alone, the math without MUFU, the
    # math without the epilogue
    "dK/dV probe: copies only": ("dkv", [(
        "    if (n_run > 0) {\n      float s[kBlockQ / 2];       // S^T\n",
        "    for (int j = 0; j < n_run; ++j) {\n"
        "      if (j == 0) mbar_wait(bar_kv, 0);\n"
        "      mbar_wait(bar_full + 8 * (j % kStages), (j / kStages) & 1);\n"
        "      if (lane == 0) mbar_arrive(bar_empty + 8 * (j % kStages));\n"
        "    }\n"
        "    if (false) {\n      float s[kBlockQ / 2];       // S^T\n")]),
    "dK/dV probe: no ex2": ("dkv", [
        ("float p0 = fast_exp2(fmaf(s[e], p.scale_log2, -l0));",
         "float p0 = fmaf(s[e], p.scale_log2, -l0);"),
        ("float p1 = fast_exp2(fmaf(s[e + 1], p.scale_log2, -l1));",
         "float p1 = fmaf(s[e + 1], p.scale_log2, -l1);")]),
    # a test the compiler cannot decide (bh > 0 at every call)
    "dK/dV probe: no epilogue": ("dkv", [("    const float scale[2] = {p.scale, p.scale};\n"
                                          "    const float one[2] = {1.f, 1.f};\n",
                                          "    if (p.bh > 0) return;\n"
                                          "    const float scale[2] = {p.scale, p.scale};\n"
                                          "    const float one[2] = {1.f, 1.f};\n")]),
}


def _build_d64(name: str):
    """(dQ function, dK/dV function, spill bytes by kernel) of one head_dim-64
    variant."""
    lib, by_kernel = build_variant(D64_SOURCE, name, D64_VARIANTS[name][1])
    fns = []
    for entry in ("ray_tpu_flash_bwd_dq_d64", "ray_tpu_flash_bwd_dkv_d64"):
        fn = getattr(lib, entry)
        fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                     ctypes.c_void_p]
        fn.restype = ctypes.c_int
        fns.append(fn)
    spills = {kernel: sum(v for k, v in by_kernel.items() if f"flash_bwd_{kernel}_d64" in k)
              for kernel in ("dq", "dkv")}
    return (*fns, spills)


def main_d64(smi: str, out: str | None, only: str | None = None) -> int:
    """The d64 pair's variants (``only``: those of one kernel) beside the
    wgmma pair they took over from and the library's whole backward, device
    time per call, median and spread of five alternating turns."""
    names = [n for n, (kernel, _) in D64_VARIANTS.items()
             if only is None or kernel in (only, "both")]
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per variant
        built = dict(zip(names, pool.map(_build_d64, names)))
    old_dq, old_dkv = _bind(attn._kernel_lib("flash_bwd_wgmma"), "ray_tpu_flash_bwd_dq_wgmma",
                            "ray_tpu_flash_bwd_dkv_wgmma")
    for name, (*_, spills) in built.items():
        print(f"[variant] {name:<26} spill bytes {spills}")
    kernels = [k for k in ("dq", "dkv") if only in (None, k)]
    # each kernel's contenders: its variants and "as built", then its
    # predecessor
    timed_names = {k: [n for n in built if D64_VARIANTS[n][0] in (k, "both")] + ["wgmma before"]
                   for k in kernels}
    gen = torch.Generator(device="cuda").manual_seed(0)
    schedule = torch.empty(1, dtype=torch.int32, device="cuda")
    rows = []
    for b, h, t_q, t_kv, d, causal in D64_SHAPES:
        q, k, v, do = (torch.randn(b, h, t, d, device="cuda", dtype=torch.bfloat16,
                                   generator=gen) for t in (t_q, t_kv, t_kv, t_q))
        scale = d ** -0.5
        o, lse = attn.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
        delta = attn.flash_bwd_delta(o, do)
        want = attn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale)
        dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
        outs = {"dq": (q, k, v, do, lse, delta, dq, schedule),
                "dkv": (q, k, v, do, lse, delta, dk, dv)}
        runs = {}
        for name, (dq_fn, dkv_fn, _) in built.items():
            for kernel, fn in (("dq", dq_fn), ("dkv", dkv_fn)):
                runs[name, kernel] = lambda fn=fn, t=outs[kernel]: _call(fn, t, q, t_kv, causal,
                                                                         scale)
        runs["wgmma before", "dq"] = lambda: _call(old_dq, outs["dq"][:7], q, t_kv, causal,
                                                   scale)
        runs["wgmma before", "dkv"] = lambda: _call(old_dkv, outs["dkv"], q, t_kv, causal, scale)
        errs = {}
        for kernel in kernels:
            got = (dq,) if kernel == "dq" else (dk, dv)
            ref = want[:1] if kernel == "dq" else want[1:]
            for name in timed_names[kernel]:
                for x in got:
                    x.fill_(float("nan"))
                runs[name, kernel]()
                torch.cuda.synchronize()
                errs[name, kernel] = max(row_err(x, r) for x, r in zip(got, ref))
        t_end = time.monotonic() + 0.5
        while time.monotonic() < t_end:
            for kernel in kernels:
                runs["as built", kernel]()
        torch.cuda.synchronize()
        times = {}
        for kernel in kernels:
            for name in turn_order(timed_names[kernel]):
                times.setdefault((name, kernel), []).append(device_ms(runs[name, kernel]))
        ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
        lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, scale=scale)
        sdpa = device_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                     retain_graph=True), per_call=None)
        tol = BWD_TOL[torch.bfloat16]
        row = dict(shape=[b, h, t_q, t_kv, d], causal=causal, sdpa_bwd_ms=sdpa,
                   ms={f"{n} ({kn})": statistics.median(t) for (n, kn), t in times.items()},
                   turns={f"{n} ({kn})": t for (n, kn), t in times.items()},
                   row_err={f"{n} ({kn})": e for (n, kn), e in errs.items()},
                   ok={f"{n} ({kn})": e <= tol for (n, kn), e in errs.items()})
        rows.append(row)
        for kernel in kernels:
            label = "dQ" if kernel == "dq" else "dK/dV"
            print(f"[time] {row['shape']} causal={causal}: {label} " + " | ".join(
                f"{n} {statistics.median(times[n, kernel]):.4f} ms "
                f"({min(times[n, kernel]):.4f}-{max(times[n, kernel]):.4f})"
                + ("" if errs[n, kernel] <= tol else " (WRONG)")
                for n in timed_names[kernel]), flush=True)
        print(f"[err] {row['shape']}: " + " | ".join(
            f"{key} {e:.2e}" for key, e in row["row_err"].items())
            + f" | sdpa whole backward {sdpa:.4f} ms")
        del want, lib_out
    if out:
        with open(out, "w") as f:
            json.dump(dict(card=smi, spills={n: s for n, (*_, s) in built.items()},
                           times="device time (torch.profiler), median of five turns",
                           shapes=rows), f, indent=1)
    return 0


# b, h, t_q, t_kv, d, causal: the timed cases of head_dims from 896 up
# (chip_smoke.py's d896_b2, d1024_b2 and d2048_b2)
DSPLIT_SHAPES = [(2, 8, 2048, 2048, d, True) for d in (896, 1024, 2048)]
DCLUSTER_SOURCE = _build.CSRC_DIR / "flash_bwd_dcluster.cu"
# probes, wrong by design: what the streamed loads, the exchange and the two
# products cost (the products and the loads skipped behind a test of a
# kernel argument that is never true, bh < 0, so the rest stays)
DCLUSTER_PROBES = {
    "probe: no streamed loads": [
        ("    if (i < n_items) {\n      const int c0 = own0",
         "    if (i < n_items && p.bh < 0) {\n      const int c0 = own0")],
    "probe: no exchange": [
        ("const int share = (256 + p.cluster - 1) / p.cluster;", "const int share = 256;"),
        ("const int n_share = min(share, 256 - rank * share);", "const int n_share = 256;"),
        ("const uint32_t recv_bytes = (uint32_t)(p.cluster * 2 * n_share * 16);",
         "const uint32_t recv_bytes = (uint32_t)(2 * n_share * 16);"),
        ("((rank * 2 + prod) * share + j) * 16;", "(prod * share + j) * 16;"),
        ("st_async(map_cluster(at, to),", "st_async(map_cluster(at, rank),"),
        ("map_cluster(recv_bar(i), to));", "map_cluster(recv_bar(i), rank));"),
        ("const int pos = rank * share + (int)threadIdx.x;", "const int pos = (int)threadIdx.x;"),
        ("      if (c < p.cluster) {\n        const float4 a = in[2 * c * share]",
         "      if (c < 1) {\n        const float4 a = in[2 * c * share]"),
        ("      if (c < p.cluster) {\n        const uint32_t o = map_cluster(out, c), "
         "b = map_cluster(bar, c);",
         "      if (c < 1) {\n        const uint32_t o = map_cluster(out, rank), "
         "b = map_cluster(bar, rank);")],
    "probe: no partial math": [("      partial_smem<T>(s, smem + L::kX",
                                "      if (p.bh < 0) partial_smem<T>(s, smem + L::kX")],
    "probe: no output math": [("    if (oc0 < p.d) rows32_nn<T",
                               "    if (oc0 < p.d && p.bh < 0) rows32_nn<T")],
}
# the dtypes' peak rates for the bound: bf16 on the tensor cores, float32 a
# third of dense TF32 (3xTF32), as chip_smoke.py's PEAK_FLOPS
_PEAK = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 494.7e12 / 3}


def _bwd_bound_ms(b, h, t_q, t_kv, d, causal, dtype, per_pair):
    """The least time of one backward kernel: ``per_pair`` * d operations a
    visible (q, k) pair over the dtype's peak (q, k, v, dO and the outputs
    read or written once take less at these shapes)."""
    off = t_kv - t_q
    pairs = (sum(min(max(r + off + 1, 0), t_kv) for r in range(t_q)) if causal
             else t_q * t_kv)
    return per_pair * d * b * h * pairs / _PEAK[dtype] * 1e3


def _bind_source(source: str):
    """The dQ and dK/dV entry points of ``csrc/<source>.cu`` as the port
    builds it."""
    dq, dkv = attn._SOURCES[source][0]
    return _bind(attn._kernel_lib(source), dq, dkv)


def _build_probes(source, probes, entries, pairs) -> None:
    """Build ``probes`` of ``source`` (one nvcc each, at once), print their
    spills and add their pairs (entry points ``entries``) to ``pairs``."""
    names = list(probes)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: build_variant(source, n, probes[n]), names)))
    for name, (lib, spills) in built.items():
        print(f"[variant] {name:<26} spill bytes {sum(spills.values())}")
        pairs[name] = _bind(lib, *entries)


def main_dsplit(smi: str, out: str | None, dtypes, probes: bool) -> int:
    """dcluster's pair beside dsplit's (the design before) and the
    library's whole backward, and with ``probes`` DCLUSTER_PROBES, device
    time per call, median and spread of five alternating turns, at
    DSPLIT_SHAPES in each of ``dtypes``."""
    pairs = {"dcluster": _bind_source("flash_bwd_dcluster"),
             "dsplit before": _bind_source("flash_bwd_dsplit")}
    if probes:
        _build_probes(DCLUSTER_SOURCE, DCLUSTER_PROBES,
                      ("ray_tpu_flash_bwd_dq_dcluster", "ray_tpu_flash_bwd_dkv_dcluster"), pairs)
    return _time_pairs(smi, out, pairs, DSPLIT_SHAPES, dtypes, ("dcluster", "dsplit before"))


# b, h, t_q, t_kv, d, causal: chip_smoke.py's timed cases at 384 to 768
WIDE_SHAPES = [(2, 8, 2048, 2048, d, True) for d in attn.WIDE_HEAD_DIMS]
DCLUSTER128_SOURCE = _build.CSRC_DIR / "flash_bwd_dcluster128.cu"
# what the split-once buys: the resident fragments split at every use too
# (no operand split once, as the designs before), and the streamed tiles
# split once as well, where they land (two planes a tile, two stages)
DCLUSTER128_PROBES = {
    "probe: split at every load": [("constexpr bool kSplitResident = true;",
                                    "constexpr bool kSplitResident = false;")],
    "probe: streamed split once": [("constexpr bool kSplitStreamed = false;",
                                    "constexpr bool kSplitStreamed = true;")]}


DCLUSTER128_WGMMA_SOURCE = _build.CSRC_DIR / "flash_bwd_dcluster128_wgmma.cu"
_STREAM_32 = [("using DkvStream = Stream<64, 3>;", "using DkvStream = Stream<32, 3>;"),
              ("using DqWide = Stream<64, 3>;", "using DqWide = Stream<32, 3>;"),
              ("using DqNarrow = Stream<32, 2>;", "using DqNarrow = Stream<32, 3>;")]
DCLUSTER128_WGMMA_VARIANTS = {
    "dQ 64 rows at every d": [("constexpr int kDqNarrowFrom = 4;",
                               "constexpr int kDqNarrowFrom = 9;")],
    "dQ 32 rows at every d": [("constexpr int kDqNarrowFrom = 4;",
                               "constexpr int kDqNarrowFrom = 2;")],
    "32 streamed rows": _STREAM_32,
    "128 resident rows": [("constexpr int kResRows = 64;", "constexpr int kResRows = 128;"),
                          *_STREAM_32],
}
# wrong by design: the streamed tiles' copies alone, and no exchange (each
# CTA's own partials reduced as if they were the cluster's)
DCLUSTER128_WGMMA_PROBES = {
    "probe: copies only": [(
        """  if (n_items > 0) {
    mbar_wait(x_bar, 0);
    mbar_wait(full_bar(0), 0);
    partial(0);
    push(0);
  }
#pragma unroll 1
  for (int i = 0; i < n_items; ++i) {
    if (i + 1 < n_items) mbar_wait(full_bar(i + 1), ((i + 1) / kStages) & 1);
    reduce(i);
    __syncwarp();
    if (i + 1 < n_items) {
      partial(i + 1);
      push(i + 1);
    }
    mbar_wait(pd_bar(i), (i >> 1) & 1);  // P and dS of item i are in
    if (threadIdx.x == 0 && i + 2 < n_items) mbar_arrive_expect_tx(pd_bar(i), L::kPdBytes);
    output(i);
    __syncthreads();  // item i's slot is free""",
        """  if (n_items > 0) mbar_wait(x_bar, 0);
#pragma unroll 1
  for (int i = 0; i < n_items; ++i) {
    mbar_wait(full_bar(i), (i / kStages) & 1);
    __syncthreads();  // item i's slot is free""")],
    "probe: no exchange": [
        ("  static constexpr int kMaxU = ((kQuads + 1) / 2 + kClusterThreads - 1) / kClusterThreads;",
         "  static constexpr int kMaxU = (kQuads + kClusterThreads - 1) / kClusterThreads;"),
        ("  const int share = (kQuads + p.cluster - 1) / p.cluster;  // quads a CTA reduces",
         "  const int share = kQuads;"),
        ("  const int n_share = min(share, kQuads - rank * share);", "  const int n_share = kQuads;"),
        ("(uint32_t)(p.cluster * 2 * n_share * 16);", "(uint32_t)(2 * n_share * 16);"),
        ("        const int to = quad / share, at = quad - to * share;\n"
         "        const uint32_t dst = recv + ((rank * 2 + prod_of(j)) * share + at) * 16;",
         "        const int to = rank, at = quad;\n"
         "        const uint32_t dst = recv + (prod_of(j) * share + at) * 16;"),
        ("        const int quad = rank * share + at;\n#pragma unroll",
         "        const int quad = at;\n#pragma unroll"),
        ("      const int quad = rank * share + at;\n      float sx[4]",
         "      const int quad = at;\n      float sx[4]"),
        ("      for (int c = 0; c < p.cluster; ++c) {  // in column order",
         "      for (int c = 0; c < 1; ++c) {  // in column order"),
        ("      for (int c = 0; c < p.cluster; ++c) {\n        const uint32_t o = map_cluster(dst, c)",
         "      for (int c = rank; c < rank + 1; ++c) {\n        const uint32_t o = map_cluster(dst, c)")],
}


def main_wide(smi: str, out: str | None, probes: bool) -> int:
    """The bf16 backward at 384 to 768: dcluster128's wgmma pair (the
    port's) beside wide's (the design before, launched directly),
    dcluster's 256-column plan as built (launched directly) and the
    library's whole backward, and the builds of DCLUSTER128_WGMMA_VARIANTS
    and, with ``probes``, DCLUSTER128_WGMMA_PROBES, at WIDE_SHAPES; each
    kernel's registers, spills, CTAs an SM and clusters resident first."""
    source = "flash_bwd_dcluster128_wgmma"
    log = _build.library_path(source).with_name(_build.library_path(source).name + ".log")
    pairs = {"dcluster128": _bind_source(source),
             "wide before": _bind_source("flash_bwd_wide"),
             "dcluster 256": _bind_source("flash_bwd_dcluster")}
    print("[build] " + " | ".join(line.strip() for line in log.read_text().splitlines()
                                  if "dcluster128" in line or "registers" in line
                                  or "spill" in line))
    lib = attn._kernel_lib(source)
    for fn in ("ctas_per_sm", "max_clusters"):
        getattr(lib, f"ray_tpu_{source}_{fn}").argtypes = [ctypes.c_int] * 3
    for dkv, name in enumerate(("dQ", "dK/dV")):
        print(f"[build] dcluster128 bf16 {name} by head_dim: CTAs an SM, clusters resident "
              + ", ".join(f"{d}: {lib.ray_tpu_flash_bwd_dcluster128_wgmma_ctas_per_sm(0, dkv, d)}, "
                          f"{lib.ray_tpu_flash_bwd_dcluster128_wgmma_max_clusters(0, dkv, d)}"
                          for d in attn.WIDE_HEAD_DIMS))
    builds = dict(DCLUSTER128_WGMMA_VARIANTS, **(DCLUSTER128_WGMMA_PROBES if probes else {}))
    _build_probes(DCLUSTER128_WGMMA_SOURCE, builds, attn._SOURCES[source][0], pairs)
    return _time_pairs(smi, out, pairs, WIDE_SHAPES, (torch.bfloat16,),
                       ("dcluster128", "wide before", "dcluster 256",
                        *DCLUSTER128_WGMMA_VARIANTS))


def main_wide_f32(smi: str, out: str | None, probes: bool) -> int:
    """The float32 backward at 384 to 768: dcluster128's pair (the port's)
    beside tf32x3's (the design before, launched directly), dcluster's
    256-column plan as built (launched directly: it is the design from 896
    up) and the library's whole backward, and with ``probes``
    DCLUSTER128_PROBES, at WIDE_SHAPES; each kernel's registers and spills
    and the clusters resident at dcluster128's cluster sizes first."""
    log = _build.library_path("flash_bwd_dcluster128").with_name(
        _build.library_path("flash_bwd_dcluster128").name + ".log")
    pairs = {"dcluster128": _bind_source("flash_bwd_dcluster128"),
             "tf32x3 before": _bind_source("flash_bwd_f32"),
             "dcluster 256": _bind_source("flash_bwd_dcluster")}
    print("[build] " + " | ".join(line.strip() for line in log.read_text().splitlines()
                                  if "dcluster128" in line or "registers" in line
                                  or "spill" in line))
    lib = attn._kernel_lib("flash_bwd_dcluster128")
    lib.ray_tpu_flash_bwd_dcluster128_max_clusters.argtypes = [ctypes.c_int] * 2
    print("[build] dcluster128 clusters resident (dQ, dK/dV) by cluster size: " + ", ".join(
        f"{c}: {lib.ray_tpu_flash_bwd_dcluster128_max_clusters(0, c)} / "
        f"{lib.ray_tpu_flash_bwd_dcluster128_max_clusters(1, c)}" for c in (3, 4, 5, 6)))
    if probes:
        _build_probes(DCLUSTER128_SOURCE, DCLUSTER128_PROBES,
                      attn._SOURCES["flash_bwd_dcluster128"][0], pairs)
    return _time_pairs(smi, out, pairs, WIDE_SHAPES, (torch.float32,),
                       ("dcluster128", "tf32x3 before", "dcluster 256"))


def _time_pairs(smi: str, out: str | None, pairs, shapes, dtypes, checked) -> int:
    """Each pair of ``pairs`` held to the plain backward (float64 for
    float32) and timed beside the library's whole backward, device time
    per call, median and spread of five alternating turns, at ``shapes`` in
    each of ``dtypes``; 0 where every pair of ``checked`` is within its
    limit."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for dtype in dtypes:
        for b, h, t_q, t_kv, d, causal in shapes:
            q, k, v, do = (torch.randn(b, h, t, d, device="cuda", dtype=dtype, generator=gen)
                           for t in (t_q, t_kv, t_kv, t_q))
            scale = d ** -0.5
            o, lse = attn.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
            delta = attn.flash_bwd_delta(o, do)
            exact = torch.float64 if dtype == torch.float32 else dtype
            want = attn.flash_attention_bwd_plain(*(x.to(exact) for x in (q, k, v, o)), lse,
                                                  do.to(exact), causal=causal, scale=scale)
            dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
            runs = {}
            for name, (dq_fn, dkv_fn) in pairs.items():
                runs[name, "dq"] = lambda fn=dq_fn: _call(fn, (q, k, v, do, lse, delta, dq), q,
                                                          t_kv, causal, scale)
                runs[name, "dkv"] = lambda fn=dkv_fn: _call(
                    fn, (q, k, v, do, lse, delta, dk, dv), q, t_kv, causal, scale)
            errs = {}
            for name in pairs:
                for x in (dq, dk, dv):
                    x.fill_(float("nan"))
                runs[name, "dq"]()
                runs[name, "dkv"]()
                torch.cuda.synchronize()
                errs[name] = {g: row_err(x, w) for g, x, w in zip(("dq", "dk", "dv"),
                                                                    (dq, dk, dv), want)}
            del want
            t_end = time.monotonic() + 0.5  # the card's clocks settle under load
            while time.monotonic() < t_end:
                runs[checked[0], "dq"]()
                runs[checked[0], "dkv"]()
            torch.cuda.synchronize()
            times = {}
            for name in turn_order(pairs):
                for kernel in ("dq", "dkv"):
                    times.setdefault((name, kernel), []).append(
                        device_ms(runs[name, kernel], iters=3))
            ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, scale=scale)
            sdpa = device_ms(lambda: torch.autograd.grad(lib_out, (ql, kl, vl), do,
                                                         retain_graph=True), iters=3, per_call=None)
            bound = {"dq": _bwd_bound_ms(b, h, t_q, t_kv, d, causal, dtype, 6),
                     "dkv": _bwd_bound_ms(b, h, t_q, t_kv, d, causal, dtype, 8)}
            tol = BWD_TOL[dtype]
            med = {f"{n} ({kn})": statistics.median(t) for (n, kn), t in times.items()}
            row = dict(shape=[b, h, t_q, t_kv, d], causal=causal,
                       dtype=str(dtype).replace("torch.", ""), sdpa_bwd_ms=sdpa,
                       bound_ms=bound, ms=med, turns={f"{n} ({kn})": t for (n, kn), t in
                                                      times.items()},
                       bound_share={key: bound[key.split("(")[1][:-1]] / ms
                                    for key, ms in med.items()},
                       row_err=errs, ok={n: max(e.values()) <= tol for n, e in errs.items()})
            rows.append(row)
            label = f"d{d}_b{b} {row['dtype']}"
            for name in pairs:
                pair = sum(statistics.median(times[name, kn]) for kn in ("dq", "dkv"))
                probe = name.startswith("probe")
                print(f"[time] {label}: {name:<13} dQ {statistics.median(times[name, 'dq']):.4f} "
                      f"({min(times[name, 'dq']):.4f}-{max(times[name, 'dq']):.4f}) dK/dV "
                      f"{statistics.median(times[name, 'dkv']):.4f} "
                      f"({min(times[name, 'dkv']):.4f}-{max(times[name, 'dkv']):.4f}) pair "
                      f"{pair:.4f} ms; share of bound dQ {row['bound_share'][f'{name} (dq)']:.3f} "
                      f"dK/dV {row['bound_share'][f'{name} (dkv)']:.3f}; worst row "
                      + " ".join(f"{g} {e:.2e}" for g, e in errs[name].items())
                      + ("" if row["ok"][name] else " (wrong by design)" if probe
                         else " (WRONG)"), flush=True)
            print(f"[time] {label}: bound dQ {bound['dq']:.4f} dK/dV {bound['dkv']:.4f} ms, "
                  f"sdpa whole backward {sdpa:.4f} ms", flush=True)
            del lib_out
    if out:
        with open(out, "w") as f:
            json.dump(dict(card=smi, times="device time (torch.profiler), median of five turns",
                           shapes=rows), f, indent=1)
    return 0 if all(r["ok"][n] for r in rows for n in checked) else 1


def main_designs(smi: str, out: str | None, dtypes) -> int:
    """The port's dQ and dK/dV as built, through their wrappers, at
    DESIGN_SHAPES in each of ``dtypes``: held to the plain backward, device
    time per call, median and spread of five turns alternating the dtypes,
    beside the library's whole backward in the same dtype and each kernel's
    bound."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, t_q, t_kv, d, causal in DESIGN_SHAPES:
        scale = d ** -0.5
        base = [torch.randn(b, h, t, d, device="cuda", generator=gen)
                for t in (t_q, t_kv, t_kv, t_q)]
        runs, sdpa_runs, errs = {}, {}, {}
        for dtype in dtypes:
            q, k, v, do = (x.to(dtype) for x in base)
            o, lse = attn.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
            delta = attn.flash_bwd_delta(o, do)
            want = attn.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                                  scale=scale)
            args = (q, k, v, do, lse, delta)
            got = (attn.flash_bwd_dq(*args, causal=causal, scale=scale),
                   *attn.flash_bwd_dkv(*args, causal=causal, scale=scale))
            errs[dtype] = {g: row_err(x, w) for g, x, w in zip(("dq", "dk", "dv"), got, want)}
            del o, want, got
            runs[dtype, "dq"] = lambda a=args: attn.flash_bwd_dq(*a, causal=causal, scale=scale)
            runs[dtype, "dkv"] = lambda a=args: attn.flash_bwd_dkv(*a, causal=causal,
                                                                   scale=scale)
            ql, kl, vl = (t.detach().clone().requires_grad_() for t in (q, k, v))
            lib_out = F.scaled_dot_product_attention(ql, kl, vl, is_causal=causal, scale=scale)
            sdpa_runs[dtype] = lambda o=lib_out, xs=(ql, kl, vl), g=do: torch.autograd.grad(
                o, xs, g, retain_graph=True)
        del base
        t_end = time.monotonic() + 0.5  # the card's clocks settle under load
        while time.monotonic() < t_end:
            runs[dtypes[0], "dq"]()
            runs[dtypes[0], "dkv"]()
        torch.cuda.synchronize()
        times = {}
        for dtype in turn_order(dtypes):
            for kernel in ("dq", "dkv"):
                times.setdefault((dtype, kernel), []).append(
                    device_ms(runs[dtype, kernel], iters=3))
        for dtype in dtypes:
            bound = {"dq": _bwd_bound_ms(b, h, t_q, t_kv, d, causal, dtype, 6),
                     "dkv": _bwd_bound_ms(b, h, t_q, t_kv, d, causal, dtype, 8)}
            design = attn.BWD_DESIGNS[(d, dtype)].dq.name
            med = {kn: statistics.median(times[dtype, kn]) for kn in ("dq", "dkv")}
            sdpa = device_ms(sdpa_runs[dtype], iters=3, per_call=None)
            ok = max(errs[dtype].values()) <= BWD_TOL[dtype]
            row = dict(shape=[b, h, t_q, t_kv, d], causal=causal,
                       dtype=str(dtype).replace("torch.", ""), design=design, ms=med,
                       turns={kn: times[dtype, kn] for kn in med}, sdpa_bwd_ms=sdpa,
                       bound_ms=bound, bound_share={kn: bound[kn] / t for kn, t in med.items()},
                       row_err=errs[dtype], ok=ok)
            rows.append(row)
            print(f"[time] d{d}_b{b} {row['dtype']}: {design} " + " ".join(
                f"{label} {med[kn]:.4f} ({min(times[dtype, kn]):.4f}-"
                f"{max(times[dtype, kn]):.4f}) bound {bound[kn]:.4f} (share "
                f"{row['bound_share'][kn]:.3f})" for kn, label in (("dq", "dQ"),
                                                                    ("dkv", "dK/dV")))
                + f" ms; pair {med['dq'] + med['dkv']:.4f} ms, sdpa whole backward "
                f"{sdpa:.4f} ms; worst row " + " ".join(f"{g} {e:.2e}"
                                                       for g, e in errs[dtype].items())
                + ("" if ok else " (WRONG)"), flush=True)
        del runs, sdpa_runs
    if out:
        with open(out, "w") as f:
            json.dump(dict(card=smi, times="device time (torch.profiler), median of five turns",
                           shapes=rows), f, indent=1)
    return 0 if all(r["ok"] for r in rows) else 1


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
                    help="the head_dim 64 design's variants beside the wgmma kernels")
    ap.add_argument("--only", choices=("dq", "dkv"),
                    help="with --d64: the variants of one kernel")
    ap.add_argument("--dsplit", action="store_true",
                    help="head_dims from 896 up: dcluster's pair beside dsplit's")
    ap.add_argument("--designs", action="store_true",
                    help="the port's dQ and dK/dV as built at the timed 16-bit cases, bf16 "
                         "beside float16")
    ap.add_argument("--dtype", choices=("float32", "bfloat16", "float16"),
                    help="with --dsplit: one dtype (default float32 and bfloat16); with "
                         "--designs: one 16-bit dtype (default both)")
    ap.add_argument("--wide", action="store_true",
                    help="bf16 at 384 to 768: dcluster128's wgmma pair beside wide's, "
                         "dcluster's 256-column plan and other tiles")
    ap.add_argument("--wide-f32", action="store_true",
                    help="float32 at 384 to 768: dcluster128's pair beside tf32x3's and "
                         "dcluster's 256-column plan")
    ap.add_argument("--probes", action="store_true",
                    help="with --dsplit, --wide or --wide-f32: the probes of the design beside it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    if args.small_d:
        return main_small_d(smi, args.out)
    if args.designs:
        dtypes = ((getattr(torch, args.dtype),) if args.dtype else
                  (torch.bfloat16, torch.float16))
        return main_designs(smi, args.out, dtypes)
    if args.d64:
        return main_d64(smi, args.out, args.only)
    if args.wide:
        return main_wide(smi, args.out, args.probes)
    if args.wide_f32:
        return main_wide_f32(smi, args.out, args.probes)
    if args.dsplit:
        dtypes = ((getattr(torch, args.dtype),) if args.dtype else
                  (torch.float32, torch.bfloat16))
        return main_dsplit(smi, args.out, dtypes, args.probes)
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
