"""Variants of the bf16 flash forwards, built and timed on the card.

    python -m ray_tpu_torch.ops.flash_fwd_variants [--small-d | --d64 | --dsplit | --wide
        | --designs] [--dtype float32|bfloat16|float16] [--probes] [--out results.json]

Each variant is ``csrc/flash_fwd_wgmma.cu`` and the headers beside it
(``csrc/*.cuh``) with one piece of text replaced, built with the port's
nvcc flags under ``build/ray_tpu_torch/variants/<variant>/``:

* ``as built``: the source unchanged;
* ``one head per group``: the launch order's L2 budget cut to one head, so
  each head's q tiles run together, heaviest first;
* ``heaviest first overall``: the budget raised past every head, so the
  heaviest q tiles of all heads run first;
* ``no turns``: the consumer warpgroups issue their products without
  taking turns;
* ``consumer waits trap``: the consumers' barrier waits end the kernel
  after a time limit, as the producer's do.

With ``--small-d`` the variants are of ``csrc/flash_fwd_persistent.cu``,
the design of bf16 at head_dim 16 and 32 (``SMALL_D_VARIANTS``), timed
beside the mma.sync kernel of ``csrc/flash_fwd.cu`` that it replaced
(``mma.sync before``) at gpt_nano's and the tiny flagship's working shapes
and at long t (``SMALL_D_SHAPES``):

* ``as built``: the source unchanged;
* ``other route``: at each head_dim the tensor-core route the source does
  not take there (kWgmma flipped: mma.sync fed by ldmatrix where it runs
  wgmma, or the reverse), at that route's CTAs an SM
  (``OTHER_ROUTE_BLOCKS``);
* ``four stages``: a K/V ring of 4 stages instead of 2;
* ``no piece skip``: every 8-column piece of every masked tile computed,
  those wholly above a warp's rows too;
* ``heaviest first overall``: the L2 budget raised past every head, so the
  heaviest q tiles of all heads run first;
* ``one CTA an SM fewer``, ``one CTA an SM more``: each head_dim's
  register budget set for one CTA an SM fewer or more;
* probes, wrong by design (the check marks them WRONG): ``probe:
  copies only`` (the consumers release each K/V stage as it lands and do
  no math; Q, K and V are read and O and lse written as before), ``probe:
  no K/V copies`` (the math on whatever the ring holds, no K or V read)
  and ``probe: no epilogue`` (no O or lse written, nor the row sums'
  reduction), which say what the copies, the math and the epilogue cost;
  ``probe: P truncated by PRMT`` (P packed to bf16 by a byte permute, not
  a conversion) and ``probe: half the exponentials`` (every other one a
  multiply), which say what the conversions and the ex2 pipe cost.

With ``--d64`` the variants are of ``csrc/flash_fwd_d64.cu``, the design of
bf16 at head_dim 64 (``D64_VARIANTS``), timed beside the wgmma kernel of
``csrc/flash_fwd_wgmma.cu`` that it took over from there (``wgmma before``,
the port's own build launched at head_dim 64) and ``scaled_dot_product_attention``
at gpt_125m's heads (12 x 64, t=2048) at b=4 and b=16, causal, and b=4
non-causal, whose runs are long (``D64_SHAPES``):

* ``as built``: the source unchanged (a persistent grid taking items from
  a counter, two consumer warpgroups with turns);
* ``three consumer warpgroups``: 192-row items of three consumer
  warpgroups at 160 registers (512 threads, whose launch caps them at 128);
* ``no turns``: the consumer warpgroups issue without taking turns;
* ``three stages``: a K/V ring of 3 stages instead of 2;
* ``split softmax``: a tile whose rows have all seen a key takes its
  exponentials in a loop of their own, with no select of the value of a
  row that saw none (``online_softmax`` in ``hopper.cuh``);
* probes, wrong by design: ``probe: copies only`` (no math: each K/V
  stage released as it lands, O written as zeros), ``probe: no ex2`` (an
  FMA in place of every MUFU exponential), ``probe: no epilogue`` (no O
  or lse written, behind a test of a kernel argument that the compiler
  cannot decide, so the math stays) and ``probe: no softmax`` (after the
  first kv tile S goes to P V as it is: the products and copies alone).

Each time there is the kernel's device time per call from torch.profiler,
the median and the spread of five turns that alternate the variants (in
order, in reverse, in order, in reverse, in order) after half a second of
load to settle the clocks.

With ``--dsplit`` it times, at head_dims from 896 up, the forward of
``csrc/flash_fwd_dcluster.cu`` (design ``dcluster``, the port's forward
there) beside the kernel of ``csrc/flash_fwd_dsplit.cu`` that it took over
from (``dsplit before``, launched directly: it is on no path) and
``scaled_dot_product_attention``, at ``DSPLIT_SHAPES`` (2 x 8 heads x
2048^2, causal, d 896, 1024 and 2048) in float32 and bf16 (``--dtype`` for
one): each held to the plain forward (worst-row error of out, lse), each
time the device time per call, median and spread of five alternating
turns, beside the bound (operations: 4 d a visible pair, at 164.9 TFLOP/s
in float32 and 989 in bf16) and its share. ``--probes`` adds builds of
``flash_fwd_dcluster.cu`` that are wrong by design (``DCLUSTER_PROBES``):
``probe: no streamed loads`` (no K or V tile is copied, so the products
read what the slot held), ``probe: no exchange`` (each CTA keeps its own
partials of the rows it reduces and its own P of them: no store to a peer
and no wait on one) and ``probe: no P.V products`` (the output's products
skipped behind a test of a kernel argument, so the rest stays), which say
what the loads, the exchange between the CTAs and the output products
cost.

With ``--wide`` it times, at head_dims 384 to 768, the forward of
``csrc/flash_fwd_dcluster128.cu`` (design ``dcluster128``) beside the
designs before it there, launched directly (``wide before``,
``csrc/flash_fwd_wide.cu``, in bf16; ``tf32x3 before``,
``csrc/flash_fwd_f32.cu``, in float32), beside ``flash_fwd_dcluster.cu`` at
its own 256-column plan there (``dcluster 256``: G = 2, 2, 3, 3 groups in
clusters of as many CTAs, one pass) and ``scaled_dot_product_attention``,
at ``WIDE_SHAPES`` (2 x 8 heads x 2048^2, causal), as ``--dsplit`` does.
``--probes`` adds builds of ``flash_fwd_dcluster128.cu`` that are wrong by
design (``DCLUSTER128_PROBES``): ``probe: copies only`` (the K and V tiles
stream through the ring under its barriers, with no product, exchange,
softmax or store of O) and ``probe: no exchange`` (each CTA keeps its own
partials of the rows it reduces and its own P of them: no store to a peer
and no wait on one), which say what the K and V traffic and the exchange
cost.

With ``--designs`` it times no variant: the port's forward as built,
through its wrapper (the design ``FWD_DESIGNS`` names), at
``DESIGN_SHAPES`` (the timed 16-bit cases of ``PERF.md``'s table: gpt_1b's
train step, b=12, and gpt_j_6b's head_dim 256, b=1, on ``wgmma``;
gpt_125m's at b=16 on ``d64``; ``WIDE_SHAPES`` on ``dcluster128``;
``DSPLIT_SHAPES`` on ``dcluster``) in bf16 and float16 (``--dtype`` for
one), the dtypes alternating in five turns, each held to the plain forward
and timed beside ``scaled_dot_product_attention`` in the same dtype and the
bound.

``--dtype float16`` also runs ``--dsplit`` and ``--wide`` on the float16
builds (``wide before`` is the wide kernel's float16 build).

It prints each variant's spills from the compiler's report, checks each
against the plain version (worst-row error, ``ops/tolerance.py``), and,
after half a second of the first variant to settle the clocks, times them
in five turns (in order, in reverse, twice, then in order; the least of the
five) beside
``scaled_dot_product_attention`` at the shapes of ``SHAPES``.
With ``--small-d`` each time is the kernels' device time per call from
torch.profiler, since at these shapes the host's launches take about as
long as the kernel. It needs a card and ``nvcc``; nothing else of the port
calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import statistics
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.ops.tolerance import FWD_LSE_TOL, FWD_ROW_TOL, row_err

SOURCE = _build.CSRC_DIR / "flash_fwd_wgmma.cu"
OUT_DIR = _build.BUILD_DIR / "variants"
_GROUP = "constexpr long long kL2GroupBytes = 16ll << 20;"
_WAIT = ("  while (!mbar_try_wait(bar, parity)) {\n  }\n}")
VARIANTS = {
    "as built": [],
    "one head per group": [(_GROUP, "constexpr long long kL2GroupBytes = 1;")],
    "heaviest first overall": [(_GROUP, "constexpr long long kL2GroupBytes = 1ll << 62;")],
    "no turns": [('asm volatile("bar.sync %0, 256;\\n" ::"r"(id) : "memory");', ""),
                 ('asm volatile("bar.arrive %0, 256;\\n" ::"r"(id) : "memory");', "")],
    "consumer waits trap": [(_WAIT, "  const unsigned long long t0 = global_ns();\n"
                                    "  while (!mbar_try_wait(bar, parity)) {\n"
                                    "    if (global_ns() - t0 > kWaitLimitNs) __trap();\n"
                                    "  }\n}")],
}
# b, h, t_q, t_kv, d, causal: gpt_1b's forward (b=4) and train step (b=12),
# non-causal, gpt_125m's head_dim 64 and gpt_j's 256
SHAPES = [(4, 16, 2048, 2048, 128, True), (12, 16, 2048, 2048, 128, True),
          (4, 16, 2048, 2048, 128, False), (4, 12, 2048, 2048, 64, True),
          (1, 16, 2048, 2048, 256, True)]

SMALL_D_SOURCE = _build.CSRC_DIR / "flash_fwd_persistent.cu"
# each head_dim's line of the source's Config: its route and its CTAs an SM
_CONFIG = re.compile(r"template <> struct Config<(\d+)> \{ static constexpr bool kWgmma = "
                     r"(true|false); static constexpr int kMinBlocks = (\d+); \};")
SMALL_D_VARIANTS = {
    "as built": [],
    "other route": None,  # kWgmma flipped at each head_dim
    "four stages": [("constexpr int kStages = 2;", "constexpr int kStages = 4;")],
    "no piece skip": [("if (!maybe_empty) live = ", "if (false) live = ")],
    "heaviest first overall": [(_GROUP, "constexpr long long kL2GroupBytes = 1ll << 62;")],
    "one CTA an SM fewer": None,  # each head_dim's kMinBlocks less one
    "one CTA an SM more": None,  # and one more
    # probes, wrong by design: what the copies alone cost, the math alone,
    # and the epilogue
    "probe: copies only": [("      mbar_wait(bar_kv_full + 8 * s, (c / kStages) & 1);\n",
                            "      mbar_wait(bar_kv_full + 8 * s, (c / kStages) & 1);\n"
                            "      if (true) {\n        __syncwarp();\n"
                            "        if (lane == 0) mbar_arrive(bar_kv_empty + 8 * s);\n"
                            "        continue;\n      }\n")],
    "probe: no K/V copies": [
        ("mbar_arrive_expect_tx(bar_kv_full + 8 * s, 2 * S::kTile);",
         "mbar_arrive_expect_tx(bar_kv_full + 8 * s, 0);"),
        ("""          tma_load_3d(base + S::kK + s * S::kTile, &tm_k, bar_kv_full + 8 * s, 0,
                      j * kBlockN, bh);
          tma_load_3d(base + S::kV + s * S::kTile, &tm_v, bar_kv_full + 8 * s, 0,
                      j * kBlockN, bh);
""", "")],
    "probe: no epilogue": [("      if (row < p.t_q) {", "      if (row < 0) {")],
    "probe: P truncated by PRMT": [
        ("pa[i] = pack_bf16(sc[8 * kk + 2 * i], sc[8 * kk + 2 * i + 1]);",
         "pa[i] = __byte_perm(__float_as_uint(sc[8 * kk + 2 * i]), "
         "__float_as_uint(sc[8 * kk + 2 * i + 1]), 0x7632);")],
    "probe: half the exponentials": [
        ("const float pe = fast_exp2(fmaf(s[i], p.scale_log2, -m[(i >> 1) & 1]));",
         "const float pe = (i & 1) ? fmaf(s[i], p.scale_log2, -m[(i >> 1) & 1]) * 0.5f "
         ": fast_exp2(fmaf(s[i], p.scale_log2, -m[(i >> 1) & 1]));")],
}
# gpt_nano's working case (4g: b=512, 4 x 16, t=128), the tiny flagship's
# (b=256, 8 x 32, t=256), and long t at both head_dims
SMALL_D_SHAPES = [(512, 4, 128, 128, 16, True), (256, 8, 256, 256, 32, True),
                  (16, 4, 2048, 2048, 16, True), (8, 8, 2048, 2048, 32, True)]


D64_SOURCE = _build.CSRC_DIR / "flash_fwd_d64.cu"
D64_VARIANTS = {
    "as built": [],
    "three consumer warpgroups": [("constexpr int kConsumerWGs = 2;",
                                   "constexpr int kConsumerWGs = 3;")],
    "no turns": [("constexpr bool kTurns = true;", "constexpr bool kTurns = false;")],
    "three stages": [("constexpr int kStages = 2;                      // K/V ring depth",
                      "constexpr int kStages = 3;                      // K/V ring depth")],
    # the exponentials of a tile with no row that saw no key in a loop of
    # their own, with no select of the empty-row value
    "split softmax": [("  float rs[2] = {0.f, 0.f};\n#pragma unroll\n  for (int i = 0; i < BN / 2; ++i) {\n",
                       "  float rs[2] = {0.f, 0.f};\n"
                       "  if (!(masked && (empty[0] || empty[1]))) {\n"
                       "#pragma unroll\n"
                       "    for (int i = 0; i < BN / 2; ++i) {\n"
                       "      s[i] = fast_exp2(fmaf(s[i], p.scale_log2, -m[(i >> 1) & 1]));\n"
                       "      rs[(i >> 1) & 1] += s[i];\n"
                       "    }\n"
                       "#pragma unroll\n"
                       "    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];\n"
                       "    return;\n"
                       "  }\n"
                       "#pragma unroll\n  for (int i = 0; i < BN / 2; ++i) {\n")],
    # probes, wrong by design: the copies alone, the math without MUFU, the
    # math without the epilogue
    "probe: copies only": [("      const int n_run = wg_kv_tiles(p, q_wg);\n",
                            "      const int n_run = 0 * wg_kv_tiles(p, q_wg);\n")],
    "probe: no ex2": [("    float pe = fast_exp2(fmaf(s[i], p.scale_log2, -m[r]));",
                       "    float pe = fmaf(s[i], p.scale_log2, -m[r]) * 0.0625f + 1.f;")],
    # a test the compiler cannot decide (bh > 0 at every call)
    "probe: no epilogue": [("      if (q_wg < p.t_q) {\n", "      if (q_wg < p.t_q && p.bh < 0) {\n")],
    # S taken as P after the first tile: the products and the copies, no
    # softmax (max, exponentials, sums) between them
    "probe: no softmax": [(
        "          online_softmax<kBN>(s, m, l, alpha, p, j * kBN, row0, tq, masked(j * kBN));\n",
        "          alpha[0] = alpha[1] = 1.f;\n")],
}
# b, h, t_q, t_kv, d, causal: gpt_125m's heads at b=4 and at 4h's b=16, and
# b=4 non-causal (every q tile runs every kv tile)
D64_SHAPES = [(4, 12, 2048, 2048, 64, True), (16, 12, 2048, 2048, 64, True),
              (4, 12, 2048, 2048, 64, False)]
D64_TURNS = 5

# b, h, t_q, t_kv, d, causal: the timed cases of head_dims from 896 up
# (chip_smoke.py's d896_b2, d1024_b2 and d2048_b2)
DSPLIT_SHAPES = [(2, 8, 2048, 2048, d, True) for d in (896, 1024, 2048)]
DCLUSTER_SOURCE = _build.CSRC_DIR / "flash_fwd_dcluster.cu"
# probes, wrong by design: what the streamed loads, the exchange and the
# output products cost (the loads and the products skipped behind a test of
# a kernel argument that is never true, bh < 0, so the rest stays)
DCLUSTER_PROBES = {
    "probe: no streamed loads": [
        ("    if (i < n_items) {\n      const int row0 = i % n_run * kBlockK;",
         "    if (i < n_items && p.bh < 0) {\n      const int row0 = i % n_run * kBlockK;")],
    "probe: no exchange": [
        ("const uint32_t recv_bytes = (uint32_t)(p.cluster * n_rows * kQuads * 16);",
         "const uint32_t recv_bytes = (uint32_t)(n_rows * kQuads * 16);"),
        ("const uint32_t p_bytes = L::kPBytes;",
         "const uint32_t p_bytes = (uint32_t)(n_rows * (kQuads * 16 + 8));"),
        ("      st_async(map_cluster(at, to),", "      if (to == rank) st_async(map_cluster(at, to),"),
        ("      if (c < p.cluster) {\n        const float4 a = in[c * per * kQuads];",
         "      if (c == rank) {\n        const float4 a = in[c * per * kQuads];"),
        ("        if (c < p.cluster) {\n          const uint32_t b = map_cluster(pd_bar(i), c);",
         "        if (c == rank) {\n          const uint32_t b = map_cluster(pd_bar(i), c);")],
    "probe: no P.V products": [("    if (oc0 < p.d) {\n      rows32_nn<T, kG, 64>",
                                "    if (oc0 < p.d && p.bh < 0) {\n      rows32_nn<T, kG, 64>")],
}
# b, h, t_q, t_kv, d, causal: the timed cases of head_dims 384 to 768
# (chip_smoke.py's d384_b2 ... d768_b2)
WIDE_SHAPES = [(2, 8, 2048, 2048, d, True) for d in (384, 512, 640, 768)]
DCLUSTER128_SOURCE = _build.CSRC_DIR / "flash_fwd_dcluster128.cu"
# probes, wrong by design: what the K and V traffic alone (every step but
# the loads and the barriers skipped behind a test of a kernel argument that
# is never false, bh >= 0) and the exchange between the CTAs cost
DCLUSTER128_PROBES = {
    "probe: copies only": [
        (f"auto {step} = [&](int i) {{\n", f"auto {step} = [&](int i) {{\n    if (p.bh >= 0) return;\n")
        for step in ("partial", "push", "reduce", "output", "p_in")],
    "probe: no exchange": [
        ("const uint32_t recv_bytes = (uint32_t)(kSources * p.cluster * n_rows * kQuads * 16);",
         "const uint32_t recv_bytes = (uint32_t)(kSources * n_rows * kQuads * 16);"),
        ("const uint32_t p_bytes = L::kPBytes;",
         "const uint32_t p_bytes = (uint32_t)(n_rows * (kQuads * 16 + 8));"),
        ("        st_async(map_cluster(at, to),\n                 make_float4(s[8 * pp",
         "        if (to == rank) st_async(map_cluster(at, to),\n                 make_float4(s[8 * pp"),
        ("    for (int c = 0; c < kSources * p.cluster; ++c) {",
         "    for (int c = kSources * rank; c < kSources * (rank + 1); ++c) {"),
        ("      for (int c = 0; c < p.cluster; ++c) {\n        const uint32_t b",
         "      for (int c = rank; c <= rank; ++c) {\n        const uint32_t b")],
}
# the dtypes' peak rates for the bound: bf16 on the tensor cores, float32 a
# third of dense TF32 (3xTF32), as chip_smoke.py's PEAK_FLOPS
_PEAK = {torch.bfloat16: 989e12, torch.float16: 989e12, torch.float32: 494.7e12 / 3}


def turn_order(names):
    """The order of ``D64_TURNS`` turns over ``names``: in order, in
    reverse, and so on, so that each variant's readings straddle the
    others'."""
    names = list(names)
    return [n for t in range(D64_TURNS) for n in (names if t % 2 == 0 else names[::-1])]


def build_variant(source, name: str, edits):
    """(library, {kernel name: spill bytes}) of ``source`` and the headers of
    ``csrc/`` with ``edits`` applied, each edit's text found once in one of
    those files."""
    files = {f.name: f.read_text()
             for f in (source, *sorted(_build.CSRC_DIR.glob("*.cuh")))}
    for old, new in edits:
        holders = [f for f, text in files.items() if old in text]
        if len(holders) != 1 or files[holders[0]].count(old) != 1:
            raise SystemExit(f"{source.name} and the headers no longer hold {old!r} once")
        files[holders[0]] = files[holders[0]].replace(old, new)
    out = OUT_DIR / source.stem / re.sub(r"\W+", "_", name)
    out.mkdir(parents=True, exist_ok=True)
    for f, text in files.items():
        (out / f).write_text(text)
    lib = out / f"lib{source.stem}.so"
    proc = subprocess.run([_build.nvcc_path(), *_build.NVCC_FLAGS, "-o", str(lib),
                           str(out / source.name), *_build.LINK_FLAGS],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed on variant {name!r}:\n{proc.stderr[-4000:]}")
    spills, current = {}, None
    for line in (proc.stdout + proc.stderr).splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            current = m.group(1)
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and current is not None:
            spills[current] = int(m.group(1)) + int(m.group(2))
    return ctypes.CDLL(str(lib)), spills


def _bind(fn):
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


# the CTAs an SM each route runs at, by head_dim, where the other route is
# the variant: the most that do not spill
OTHER_ROUTE_BLOCKS = {True: {16: 4, 32: 3}, False: {16: 3, 32: 3}}


def _small_d_edits(name: str):
    """The edits of a small-d variant; ``other route`` and ``one CTA an SM
    fewer`` / ``more`` rewrite each head_dim's Config line."""
    if SMALL_D_VARIANTS[name] is not None:
        return SMALL_D_VARIANTS[name]
    edits = []
    for m in _CONFIG.finditer(SMALL_D_SOURCE.read_text()):
        d, route, blocks = m.group(1), m.group(2) == "true", int(m.group(3))
        if name == "other route":
            # the wgmma route's register budget: its S tile takes 32
            # registers a thread, the mma.sync route's half tiles 16
            route, blocks = not route, OTHER_ROUTE_BLOCKS[not route][int(d)]
        else:
            blocks += 1 if name == "one CTA an SM more" else -1
        edits.append((m.group(0), f"template <> struct Config<{d}> {{ static constexpr bool "
                                  f"kWgmma = {str(route).lower()}; static constexpr int "
                                  f"kMinBlocks = {blocks}; }};"))
    return edits


def _routes() -> dict:
    """{head_dim: "wgmma" or "mma.sync"} as the source has it."""
    return {int(m.group(1)): "wgmma" if m.group(2) == "true" else "mma.sync"
            for m in _CONFIG.finditer(SMALL_D_SOURCE.read_text())}


def _build_variant(name: str, small_d: bool = False):
    """(launch function, spill bytes by head_dim) of one variant."""
    source, edits = ((SMALL_D_SOURCE, _small_d_edits(name)) if small_d
                     else (SOURCE, VARIANTS[name]))
    lib, by_kernel = build_variant(source, name, edits)
    spills = {int(re.search(r"ILi(\d+)E", k).group(1)): v for k, v in by_kernel.items()
              if re.search(r"ILi(\d+)E", k)}
    entry = "ray_tpu_flash_fwd_persistent" if small_d else "ray_tpu_flash_fwd_wgmma"
    return _bind(getattr(lib, entry)), spills


def _bind_d64(fn):
    """The d64 entry, which takes the launch's own item counter after lse,
    as a function of the other entries' arguments: each call passes a
    counter of its own (the launcher zeroes it on the stream)."""
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def call(q, k, v, o, lse, *rest):
        schedule = torch.empty(1, dtype=torch.int32, device="cuda")
        return fn(q, k, v, o, lse, schedule.data_ptr(), *rest)

    return call


def _build_d64(name: str):
    """(launch function, spill bytes) of one head_dim-64 variant."""
    lib, by_kernel = build_variant(D64_SOURCE, name, D64_VARIANTS[name])
    return _bind_d64(lib.ray_tpu_flash_fwd_d64), sum(by_kernel.values())


def main_d64(smi: str, out: str | None) -> int:
    """The d64 forward's variants beside the wgmma kernel and the library,
    device time per call, median and spread of five alternating turns."""
    with ThreadPoolExecutor(len(D64_VARIANTS)) as pool:  # one nvcc per variant
        built = dict(zip(D64_VARIANTS, pool.map(_build_d64, D64_VARIANTS)))
    # the kernel this design took over from, from the port's own build
    built["wgmma before"] = (_bind(attn._kernel_lib("flash_fwd_wgmma").ray_tpu_flash_fwd_wgmma),
                             None)
    for name, (_, spills) in built.items():
        print(f"[variant] {name:<30} spill bytes {spills}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, t_q, t_kv, d, causal in D64_SHAPES:
        q, k, v = (torch.randn(b, h, t, d, device="cuda", dtype=torch.bfloat16,
                               generator=gen) for t in (t_q, t_kv, t_kv))
        scale = d ** -0.5
        ref, ref_lse = attn.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
        errs, lse_errs = {}, {}
        for name, (fn, _) in built.items():
            got = torch.full_like(q, float("nan"))
            lse = torch.full(q.shape[:3], float("nan"), device="cuda")
            err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), got.data_ptr(), lse.data_ptr(),
                     b * h, t_q, t_kv, d, 0, int(causal), scale,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise SystemExit(f"variant {name!r} launch failed ({err})")
            torch.cuda.synchronize()
            errs[name] = row_err(got, ref)
            lse_errs[name] = float((lse - ref_lse).abs().max())
        t_end = time.monotonic() + 0.5
        while time.monotonic() < t_end:
            _run(built["as built"][0], q, k, v, causal, scale)
        torch.cuda.synchronize()
        times = {name: [] for name in built}
        memset = []
        for name in turn_order(built):
            fn = built[name][0]
            times[name].append(device_ms(lambda: _run(fn, q, k, v, causal, scale)))
            if name == "as built":
                memset.append(MEMSET_MS[0])
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                                scale=scale), per_call=None)
        med = {n: statistics.median(t) for n, t in times.items()}
        row = dict(shape=[b, h, t_q, t_kv, d], causal=causal, sdpa_ms=sdpa, ms=med,
                   counter_memset_ms=statistics.median(memset),
                   turns=times, row_err=errs, lse_err=lse_errs,
                   ok={n: errs[n] <= FWD_ROW_TOL[torch.bfloat16]
                       and lse_errs[n] <= FWD_LSE_TOL[torch.bfloat16] for n in built})
        rows.append(row)
        print(f"[time] {row['shape']} causal={causal}: "
              + " | ".join(f"{n} {med[n]:.4f} ms ({min(times[n]):.4f}-{max(times[n]):.4f})"
                           + ("" if row["ok"][n] else " (WRONG)") for n in built)
              + f" | sdpa {sdpa:.4f} ms | as built's counter memset "
              f"{row['counter_memset_ms']:.4f} ms a call", flush=True)
        print(f"[err] {row['shape']}: " + " | ".join(
            f"{n} {errs[n]:.2e} lse {lse_errs[n]:.2e}" for n in built))
    if out:
        with open(out, "w") as f:
            json.dump(dict(card=smi, spills={n: s for n, (_, s) in built.items()},
                           times="device time (torch.profiler), median of five turns",
                           shapes=rows), f, indent=1)
    return 0


def _run_with_lse(fn, q, k, v, causal, scale):
    """(out, lse) of one launch of the forward entry point ``fn`` in q's
    dtype."""
    b, h, t_q, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t_q, device=q.device, dtype=torch.float32)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             b * h, t_q, k.shape[2], d, attn._DTYPE_CODES[q.dtype], int(causal), scale,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"variant launch failed ({err})")
    return out, lse


def _run(fn, q, k, v, causal, scale):
    return _run_with_lse(fn, q, k, v, causal, scale)[0]


def ms(fn, iters: int = 30) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


#: device time per call of the memsets of the last ``device_ms`` window
MEMSET_MS = [0.0]


def device_ms(fn, iters: int = 30, per_call: int | None = 1) -> float:
    """Mean device time per call of the kernels ``fn`` launches, from
    torch.profiler over ``iters`` back-to-back calls after a warm-up. Some
    windows lose kernel records: with ``per_call`` (kernels a call) the mean
    is taken over the kernels recorded; without, each kernel counts its mean
    as often as it launches a call (its records over the calls, rounded), and
    one that launches less than every other call its total over the calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        # the d64 forward's launcher zeroes its item counter (a 4-byte
        # memset) before each launch: kept apart from a kernel's time (a
        # library call's, without per_call, keeps all it runs)
        memsets = [e for e in events if per_call and e.key.startswith("Memset")]
        events = [e for e in events if e not in memsets]
        MEMSET_MS[0] = sum(e.self_device_time_total for e in memsets) / iters / 1e3
        kernels = sum(e.count for e in events)
        device_us = sum(e.self_device_time_total for e in events)
        if kernels < iters // 2:
            continue
        if per_call:
            return device_us / kernels * per_call / 1e3
        return sum(e.self_device_time_total / e.count * round(e.count / iters)
                   if round(e.count / iters) else e.self_device_time_total / iters
                   for e in events if e.count) / 1e3
    raise SystemExit(f"torch.profiler recorded {kernels} kernels over {iters} calls, "
                     f"three times")


def _fwd_bound_ms(b, h, t_q, t_kv, d, causal, dtype):
    """The least time of the forward: 4 d operations a visible (q, k) pair
    over the dtype's peak (q, k, v and o read or written once take less at
    these shapes)."""
    off = t_kv - t_q
    pairs = (sum(min(max(r + off + 1, 0), t_kv) for r in range(t_q)) if causal
             else t_q * t_kv)
    return 4 * d * b * h * pairs / _PEAK[dtype] * 1e3


def _time_designs(kernels, shapes, dtype, first: str):
    """Rows of ``kernels`` ({name: entry point}) at ``shapes`` in ``dtype``:
    each held to the plain forward (worst-row error of out, lse), each the
    device time per call, median and spread of five alternating turns after
    half a second of ``first``, beside the bound, its share and
    scaled_dot_product_attention."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, t_q, t_kv, d, causal in shapes:
        q, k, v = (torch.randn(b, h, t, d, device="cuda", dtype=dtype, generator=gen)
                   for t in (t_q, t_kv, t_kv))
        scale = d ** -0.5
        ref, ref_lse = attn.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
        errs = {}
        for name, fn in kernels.items():
            o, lse = _run_with_lse(fn, q, k, v, causal, scale)
            torch.cuda.synchronize()
            errs[name] = {"out": row_err(o, ref), "lse": float((lse - ref_lse).abs().max())}
        del ref, ref_lse
        runs = {name: (lambda fn=fn: _run(fn, q, k, v, causal, scale))
                for name, fn in kernels.items()}
        t_end = time.monotonic() + 0.5  # the card's clocks settle under load
        while time.monotonic() < t_end:
            runs[first]()
        torch.cuda.synchronize()
        times = {}
        for name in turn_order(kernels):
            times.setdefault(name, []).append(device_ms(runs[name], iters=3))
        sdpa = device_ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                                scale=scale),
                         iters=3, per_call=None)
        bound = _fwd_bound_ms(b, h, t_q, t_kv, d, causal, dtype)
        med = {n: statistics.median(t) for n, t in times.items()}
        row = dict(shape=[b, h, t_q, t_kv, d], causal=causal,
                   dtype=str(dtype).replace("torch.", ""), sdpa_ms=sdpa, bound_ms=bound,
                   ms=med, turns=times, bound_share={n: bound / t for n, t in med.items()},
                   row_err=errs,
                   ok={n: e["out"] <= FWD_ROW_TOL[dtype] and e["lse"] <= FWD_LSE_TOL[dtype]
                       for n, e in errs.items()})
        rows.append(row)
        label = f"d{d}_b{b} {row['dtype']}"
        for name in kernels:
            probe = name.startswith("probe")
            print(f"[time] {label}: {name:<24} {med[name]:.4f} ms "
                  f"({min(times[name]):.4f}-{max(times[name]):.4f}); share of bound "
                  f"{row['bound_share'][name]:.3f}; sdpa / this {sdpa / med[name]:.3f}; "
                  f"worst row {errs[name]['out']:.2e} lse {errs[name]['lse']:.2e}"
                  + ("" if row["ok"][name] else " (wrong by design)" if probe
                     else " (WRONG)"), flush=True)
        print(f"[time] {label}: bound {bound:.4f} ms, sdpa {sdpa:.4f} ms", flush=True)
    return rows


def _probes(source, edits, entry):
    """{name: bound entry point} of the probe builds of ``source``, one nvcc
    each, in parallel; their spills printed."""
    names = list(edits)
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(lambda n: build_variant(source, n, edits[n]), names)))
    out = {}
    for name, (lib, spills) in built.items():
        print(f"[variant] {name:<26} spill bytes {sum(spills.values())}")
        out[name] = _bind(getattr(lib, entry))
    return out


def _write(out, smi, rows):
    if out:
        with open(out, "w") as f:
            json.dump(dict(card=smi, times="device time (torch.profiler), median of five turns",
                           shapes=rows), f, indent=1)


def main_dsplit(smi: str, out: str | None, dtypes, probes: bool) -> int:
    """dcluster's forward beside dsplit's (the design before) and
    scaled_dot_product_attention, and with ``probes`` DCLUSTER_PROBES,
    device time per call, median and spread of five alternating turns, at
    DSPLIT_SHAPES in each of ``dtypes``."""
    kernels = {
        "dcluster": _bind(attn._kernel_lib("flash_fwd_dcluster").ray_tpu_flash_fwd_dcluster),
        "dsplit before": _bind(attn._kernel_lib("flash_fwd_dsplit").ray_tpu_flash_fwd_dsplit)}
    if probes:
        kernels.update(_probes(DCLUSTER_SOURCE, DCLUSTER_PROBES, "ray_tpu_flash_fwd_dcluster"))
    rows = [r for dtype in dtypes for r in _time_designs(kernels, DSPLIT_SHAPES, dtype,
                                                         "dcluster")]
    _write(out, smi, rows)
    return 0 if all(r["ok"][n] for r in rows for n in ("dcluster", "dsplit before")) else 1


def main_wide(smi: str, out: str | None, dtypes, probes: bool) -> int:
    """dcluster128's forward beside the designs before it (wide in bf16,
    tf32x3 in float32), dcluster's 256-column plan and
    scaled_dot_product_attention, and with ``probes`` DCLUSTER128_PROBES,
    device time per call, median and spread of five alternating turns, at
    WIDE_SHAPES in each of ``dtypes``."""
    new = {"dcluster128": _bind(
        attn._kernel_lib("flash_fwd_dcluster128").ray_tpu_flash_fwd_dcluster128),
        "dcluster 256": _bind(attn._kernel_lib("flash_fwd_dcluster").ray_tpu_flash_fwd_dcluster)}
    if probes:
        new.update(_probes(DCLUSTER128_SOURCE, DCLUSTER128_PROBES,
                           "ray_tpu_flash_fwd_dcluster128"))
    before = {torch.bfloat16: ("wide before", "flash_fwd_wide", "ray_tpu_flash_fwd_wide"),
              torch.float16: ("wide before", "flash_fwd_wide", "ray_tpu_flash_fwd_wide"),
              torch.float32: ("tf32x3 before", "flash_fwd_f32", "ray_tpu_flash_fwd_f32")}
    rows, named = [], ("dcluster128", "dcluster 256")
    for dtype in dtypes:
        name, source, entry = before[dtype]
        kernels = {**new, name: _bind(getattr(attn._kernel_lib(source), entry))}
        rows += _time_designs(kernels, WIDE_SHAPES, dtype, "dcluster128")
        named += (name,)
    _write(out, smi, rows)
    return 0 if all(r["ok"][n] for r in rows for n in named if n in r["ok"]) else 1


# b, h, t_q, t_kv, d, causal: the timed 16-bit cases of PERF.md's table:
# gpt_1b's train step (b=12) and gpt_j_6b's head_dim 256 (b=1), gpt_125m's
# at bench.py's b=16, then WIDE_SHAPES and DSPLIT_SHAPES
DESIGN_SHAPES = [(12, 16, 2048, 2048, 128, True), (1, 16, 2048, 2048, 256, True),
                 (16, 12, 2048, 2048, 64, True), *WIDE_SHAPES, *DSPLIT_SHAPES]


def main_designs(smi: str, out: str | None, dtypes) -> int:
    """The port's forward as built, through its wrapper, at DESIGN_SHAPES in
    each of ``dtypes``: held to the plain forward, device time per call,
    median and spread of five turns alternating the dtypes, beside
    scaled_dot_product_attention in the same dtype and the bound."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, t_q, t_kv, d, causal in DESIGN_SHAPES:
        scale = d ** -0.5
        base = [torch.randn(b, h, t, d, device="cuda", generator=gen)
                for t in (t_q, t_kv, t_kv)]
        runs, sdpa_runs, errs = {}, {}, {}
        for dtype in dtypes:
            q, k, v = (x.to(dtype) for x in base)
            o, lse = attn.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
            ref, ref_lse = attn.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
            errs[dtype] = {"out": row_err(o, ref), "lse": float((lse - ref_lse).abs().max())}
            del o, lse, ref, ref_lse
            runs[dtype] = lambda q=q, k=k, v=v: attn.flash_attention_fwd(q, k, v, causal=causal,
                                                                         scale=scale)
            sdpa_runs[dtype] = lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                q, k, v, is_causal=causal, scale=scale)
        del base
        t_end = time.monotonic() + 0.5  # the card's clocks settle under load
        while time.monotonic() < t_end:
            runs[dtypes[0]]()
        torch.cuda.synchronize()
        times = {}
        for dtype in turn_order(dtypes):
            times.setdefault(dtype, []).append(device_ms(runs[dtype], iters=3))
        for dtype in dtypes:
            design = attn.FWD_DESIGNS[(d, dtype)].name
            med = statistics.median(times[dtype])
            sdpa = device_ms(sdpa_runs[dtype], iters=3, per_call=None)
            bound = _fwd_bound_ms(b, h, t_q, t_kv, d, causal, dtype)
            ok = (errs[dtype]["out"] <= FWD_ROW_TOL[dtype]
                  and errs[dtype]["lse"] <= FWD_LSE_TOL[dtype])
            row = dict(shape=[b, h, t_q, t_kv, d], causal=causal,
                       dtype=str(dtype).replace("torch.", ""), design=design, ms=med,
                       turns=times[dtype], sdpa_ms=sdpa, bound_ms=bound,
                       bound_share=bound / med, row_err=errs[dtype], ok=ok)
            rows.append(row)
            print(f"[time] d{d}_b{b} {row['dtype']}: {design} {med:.4f} ms "
                  f"({min(times[dtype]):.4f}-{max(times[dtype]):.4f}); bound {bound:.4f} ms "
                  f"(share {bound / med:.3f}); sdpa {sdpa:.4f} ms (this / sdpa "
                  f"{med / sdpa:.3f}); worst row {errs[dtype]['out']:.2e} lse "
                  f"{errs[dtype]['lse']:.2e}" + ("" if ok else " (WRONG)"), flush=True)
        del runs, sdpa_runs
    _write(out, smi, rows)
    return 0 if all(r["ok"] for r in rows) else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results to this JSON file")
    ap.add_argument("--small-d", action="store_true",
                    help="the head_dim 16/32 design's variants beside the mma.sync kernel")
    ap.add_argument("--d64", action="store_true",
                    help="the head_dim 64 design's variants beside the wgmma kernel")
    ap.add_argument("--dsplit", action="store_true",
                    help="head_dims from 896 up: dcluster's forward beside dsplit's")
    ap.add_argument("--wide", action="store_true",
                    help="head_dims 384 to 768: dcluster128's forward beside the designs "
                         "before and dcluster's 256-column plan")
    ap.add_argument("--designs", action="store_true",
                    help="the port's forward as built at the timed 16-bit cases, bf16 "
                         "beside float16")
    ap.add_argument("--dtype", choices=("float32", "bfloat16", "float16"),
                    help="with --dsplit or --wide: one dtype (default float32 and "
                         "bfloat16); with --designs: one 16-bit dtype (default both)")
    ap.add_argument("--probes", action="store_true",
                    help="with --dsplit or --wide: the probes of the design beside it")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_variants needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    if args.d64:
        return main_d64(smi, args.out)
    if args.designs:
        dtypes = ((getattr(torch, args.dtype),) if args.dtype else
                  (torch.bfloat16, torch.float16))
        return main_designs(smi, args.out, dtypes)
    if args.dsplit or args.wide:
        dtypes = ((getattr(torch, args.dtype),) if args.dtype else
                  (torch.float32, torch.bfloat16))
        main_cluster = main_wide if args.wide else main_dsplit
        return main_cluster(smi, args.out, dtypes, args.probes)
    variants, shapes, timer = ((SMALL_D_VARIANTS, SMALL_D_SHAPES, device_ms) if args.small_d
                               else (VARIANTS, SHAPES, ms))
    with ThreadPoolExecutor(len(variants)) as pool:  # one nvcc per variant
        built = dict(zip(variants, pool.map(lambda n: _build_variant(n, args.small_d),
                                            variants)))
    if args.small_d:
        print(f"[variant] as built: routes by head_dim {_routes()}")
        # the kernel this design replaced, from the port's own build
        built["mma.sync before"] = (_bind(attn._kernel_lib("flash_fwd").ray_tpu_flash_fwd),
                                    {})
    for name, (_, spills) in built.items():
        print(f"[variant] {name:<24} spill bytes by head_dim {spills}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, t_q, t_kv, d, causal in shapes:
        q, k, v = (torch.randn(b, h, t, d, device="cuda", dtype=torch.bfloat16,
                               generator=gen) for t in (t_q, t_kv, t_kv))
        scale = d ** -0.5
        ref, _ = attn.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
        errs = {name: row_err(_run(fn, q, k, v, causal, scale), ref)
                for name, (fn, _) in built.items()}
        times = {name: [] for name in built}
        # the card's clocks settle under load before the first turn
        warm = built["as built"][0]
        t_end = time.monotonic() + 0.5
        while time.monotonic() < t_end:
            _run(warm, q, k, v, causal, scale)
        torch.cuda.synchronize()
        for name in (list(built) + list(built)[::-1]) * 2 + list(built):
            fn = built[name][0]
            times[name].append(timer(lambda: _run(fn, q, k, v, causal, scale)))
        sdpa_fn = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,  # noqa: E731
                                                         scale=scale)
        sdpa = device_ms(sdpa_fn, per_call=None) if args.small_d else ms(sdpa_fn)
        row = dict(shape=[b, h, t_q, t_kv, d], causal=causal, sdpa_ms=sdpa,
                   ms={n: min(t) for n, t in times.items()}, row_err=errs,
                   ok={n: e <= FWD_ROW_TOL[torch.bfloat16] for n, e in errs.items()})
        rows.append(row)
        print(f"[time] {row['shape']} causal={causal}: "
              + " | ".join(f"{n} {row['ms'][n]:.4f} ms"
                           + ("" if row["ok"][n] else " (WRONG)") for n in built)
              + f" | sdpa {sdpa:.4f} ms", flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, spills={n: s for n, (_, s) in built.items()},
                           times="device time (torch.profiler)" if args.small_d
                           else "CUDA events", shapes=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
