"""Variants of the wgmma flash backward kernels, built and timed on the card.

    python -m ray_tpu_torch.ops.flash_bwd_variants [--out results.json]

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
reverse; the lesser of the two) at the shapes of ``SHAPES``. It needs a card
and ``nvcc``; nothing else of the port calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.ops.flash_fwd_variants import build_variant, ms
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


def _build_variant(name: str):
    """(dQ function, dK/dV function, spill bytes of each kernel by head_dim)
    of one variant."""
    lib, by_kernel = build_variant(SOURCE, name, VARIANTS[name])
    fns = []
    for entry, n_ptr in (("ray_tpu_flash_bwd_dq_wgmma", 7), ("ray_tpu_flash_bwd_dkv_wgmma", 8)):
        fn = getattr(lib, entry)
        fn.argtypes = ([ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
        fns.append(fn)
    spills = {f"{kernel} d={d}": sum(v for k, v in by_kernel.items()
                                     if kernel in k and f"ILi{d}E" in k)
              for kernel in ("dq_wgmma", "dkv_wgmma") for d in (64, 128, 256)}
    return fns[0], fns[1], spills


def _call(fn, tensors, q, t_kv, causal, scale):
    b, h, t_q, d = q.shape
    err = fn(*(t.data_ptr() for t in tensors), b * h, t_q, t_kv, d, 0, int(causal), scale,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"variant launch failed ({err})")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_bwd_variants needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
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
