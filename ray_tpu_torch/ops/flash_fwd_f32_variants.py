"""Variants of the float32 flash forward, built and timed on the card.

    python -m ray_tpu_torch.ops.flash_fwd_f32_variants [--out results.json] [--sass]

The float32 forward's kernel (``csrc/flash_fwd_f32.cu``, 3xTF32 on
``mma.sync``) beside:

* ``cuda cores``: the float32 kernel of ``csrc/flash_fwd.cu`` (one thread
  per q row on the CUDA cores), which ``FWD_DESIGNS`` sent float32 to before
  the tensor-core design and which no path launches now;
* ``one chain for S``: S summed in one accumulator over d, without the
  fresh per-step sums (``mma3_add``), which the design keeps for lse's
  accuracy;
* ``1xTF32``: only the big * big product of each 3xTF32 step (the small
  terms dropped), which prices the other two; it misses the float32 gate
  and is no candidate;
* ``S loop not unrolled``: fewer registers in the S product (no unrolling
  of its 16-column blocks);
* ``d64 ...``, ``d128 ...``, ``d256 ...``: other tiles at one head_dim
  (rows a piece of the K/V ring, stages, CTAs an SM, columns of a V row a
  lane reads at once), candidates for ``FwdTiles``; ``d128 P V four
  columns a lane`` spills;
* ``sdpa``: ``scaled_dot_product_attention`` in float32, the yardstick.

A variant of the source is one piece of its text (or of the shared header
``csrc/tf32x3.cuh``) replaced, built with ``flash_fwd_variants.build_variant``.
The script prints each build's spills, checks each against the plain
forward (worst-row error of out and lse's largest error,
``ops/tolerance.py``, and the three worst rows of out), and times them in
turns (in order, then in reverse; the lesser of the two) at the shapes of
``SHAPES``. ``--sass`` prints the opcode counts of each build's
head_dim-128 kernel (``cuobjdump -sass``). It needs a card and ``nvcc``;
nothing else of the port calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.ops.flash_bwd_f32_variants import VARIANTS as BWD_VARIANTS
from ray_tpu_torch.ops.flash_bwd_f32_variants import sass_opcodes, worst_rows
from ray_tpu_torch.ops.flash_fwd_variants import build_variant, ms
from ray_tpu_torch.ops.tolerance import FWD_LSE_TOL, FWD_ROW_TOL, row_err

SOURCE = _build.CSRC_DIR / "flash_fwd_f32.cu"


def _tiles(d: int, tiles: str):
    """An edit of ``FwdTiles<d>`` to ``Tiles<tiles>`` (piece rows, stages,
    halves, CTAs an SM, V columns a lane reads)."""
    text = (SOURCE.read_text().split(f"template <> struct FwdTiles<{d}> : ")[1]
            .split(" {};")[0])
    return [(f"struct FwdTiles<{d}> : {text} {{}};", f"struct FwdTiles<{d}> : Tiles<{tiles}> {{}};")]


VARIANTS = {
    "as built": [],
    "one chain for S": [("      mma3_add(acc[nt], a0, b0);\n      mma3_add(acc[nt], a1, b1);",
                         "      mma3(acc[nt], a0, b0);\n      mma3(acc[nt], a1, b1);")],
    # mma3 and mma3_add are tf32x3.cuh's, shared with the backward
    "1xTF32": BWD_VARIANTS["1xTF32"],
    "S loop not unrolled": [("#pragma unroll 2\n  for (int c = 0; c < kK; c += 16) {",
                             "#pragma unroll 1\n  for (int c = 0; c < kK; c += 16) {")],
    "d128 P V four columns a lane": _tiles(128, "64, 2, 1, 1, 4"),
    "d128 pieces of 32": _tiles(128, "32, 2, 1, 1, 4"),
    "d128 pieces of 32, 3 stages": _tiles(128, "32, 3, 1, 2, 4"),
    "d64 3 CTAs an SM": _tiles(64, "64, 2, 1, 3, 4"),
    "d256 3 stages": _tiles(256, "32, 3, 2, 1, 4"),
}
# the float32 kernel of flash_fwd.cu, by its entry point's dtype 1
CUDA_CORES = "cuda cores"
# b, h, t_q, t_kv, d, causal: train_f32's attention (gpt_1b at b=4), gpt_125m's
# head_dim 64 and gpt_j_6b's 256
SHAPES = [(4, 16, 2048, 2048, 128, True), (4, 12, 2048, 2048, 64, True),
          (1, 16, 2048, 2048, 256, True)]


def _entry(lib, name: str):
    fn = getattr(lib, name)
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def _build_variant(name: str):
    """(launch function, library path, spill bytes by head_dim)."""
    if name == CUDA_CORES:
        path = _build.build("flash_fwd")
        return _entry(ctypes.CDLL(str(path)), "ray_tpu_flash_fwd"), path, {}
    lib, by_kernel = build_variant(SOURCE, name, VARIANTS[name])
    spills = {d: sum(v for k, v in by_kernel.items() if f"f32x3_kernelILi{d}E" in k)
              for d in (64, 128, 256)}
    return _entry(lib, "ray_tpu_flash_fwd_f32"), Path(lib._name), spills


def _run(fn, q, k, v, out, lse, causal, scale):
    b, h, t_q, d = q.shape
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             b * h, t_q, k.shape[2], d, 1, int(causal), scale,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"variant launch failed ({err})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results to this JSON file")
    ap.add_argument("--sass", action="store_true",
                    help="print the opcode counts of each build's head_dim-128 kernel")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_f32_variants needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    names = [CUDA_CORES, *VARIANTS]
    with ThreadPoolExecutor(len(names)) as pool:  # one nvcc per variant
        built = dict(zip(names, pool.map(_build_variant, names)))
    sass = {}
    kernel = "flash_fwd_f32x3_kernelILi128E"
    for name, (_, path, spills) in built.items():
        print(f"[variant] {name:<28} spill bytes by head_dim {spills}")
        if args.sass and name != CUDA_CORES:
            sass[name] = sass_opcodes(path, kernel)
            top = list(sass[name].items())[:14]
            print(f"[sass] {name:<28} {kernel}: {sum(sass[name].values())} instructions; "
                  f"{top}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, t_q, t_kv, d, causal in SHAPES:
        q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                   for t in (t_q, t_kv, t_kv))
        scale = d ** -0.5
        want_o, want_lse = attn.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
        out, lse = torch.empty_like(q), torch.empty(b, h, t_q, device="cuda")
        runs = {name: (lambda fn=fn: _run(fn, q, k, v, out, lse, causal, scale))
                for name, (fn, _, _) in built.items()}
        errs, lse_errs, worst = {}, {}, {}
        for name, run in runs.items():
            out.fill_(float("nan"))
            lse.fill_(float("nan"))
            run()
            torch.cuda.synchronize()
            errs[name] = row_err(out, want_o)
            lse_errs[name] = float((lse - want_lse).abs().max())
            worst[name] = worst_rows(out, want_o)
            print(f"[rows] {name:<28} {[b, h, t_q, t_kv, d]}: worst rows of out (b, h, row, "
                  f"row_err) {worst[name]}, lse {lse_errs[name]:.2e}", flush=True)
        runs["sdpa"] = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                                scale=scale)
        times = {name: [] for name in runs}
        for name in list(runs) + list(runs)[::-1]:
            times[name].append(ms(runs[name], iters=3 if name == CUDA_CORES else 20))
        ok = {n: errs[n] <= FWD_ROW_TOL[torch.float32] and lse_errs[n] <= FWD_LSE_TOL[torch.float32]
              for n in errs}
        row = dict(shape=[b, h, t_q, t_kv, d], causal=causal,
                   ms={n: min(t) for n, t in times.items()}, row_err=errs, lse_err=lse_errs,
                   worst_rows=worst, ok=ok)
        rows.append(row)
        print(f"[time] {row['shape']} causal={causal}: "
              + " | ".join(f"{n} {row['ms'][n]:.4f} ms"
                           + ("" if n == "sdpa" or ok[n] else " (over the gate)")
                           for n in runs), flush=True)
        del want_o, want_lse
    if args.out:
        with open(args.out, "w") as f:
            json.dump(dict(card=smi, spills={n: s for n, (*_, s) in built.items()},
                           sass={f"{n} {kernel}": v for n, v in sass.items()},
                           shapes=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
