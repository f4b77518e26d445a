"""Variants of the wgmma flash forward, built and timed on the card.

    python -m ray_tpu_torch.ops.flash_fwd_variants [--out results.json]

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

It prints each variant's spills from the compiler's report, checks each
against the plain version (worst-row error, ``ops/tolerance.py``), and times
them in turns (the variants in order, then in reverse; the lesser of the
two) beside ``scaled_dot_product_attention`` at the shapes of ``SHAPES``.
It needs a card and ``nvcc``; nothing else of the port calls it.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
from concurrent.futures import ThreadPoolExecutor

import torch
import torch.nn.functional as F

from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import attention as attn
from ray_tpu_torch.ops.tolerance import FWD_ROW_TOL, row_err

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


def _build_variant(name: str):
    """(launch function, spill bytes by head_dim) of one variant."""
    lib, by_kernel = build_variant(SOURCE, name, VARIANTS[name])
    spills = {int(re.search(r"ILi(\d+)E", k).group(1)): v for k, v in by_kernel.items()}
    fn = lib.ray_tpu_flash_fwd_wgmma
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_float,
                                                                 ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn, spills


def _run(fn, q, k, v, causal, scale):
    b, h, t_q, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty(b, h, t_q, device=q.device, dtype=torch.float32)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), lse.data_ptr(),
             b * h, t_q, k.shape[2], d, 0, int(causal), scale,
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise SystemExit(f"variant launch failed ({err})")
    return out


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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the results to this JSON file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("flash_fwd_variants needs a card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print(smi)
    with ThreadPoolExecutor(len(VARIANTS)) as pool:  # one nvcc per variant
        built = dict(zip(VARIANTS, pool.map(_build_variant, VARIANTS)))
    for name, (_, spills) in built.items():
        print(f"[variant] {name:<24} spill bytes by head_dim {spills}")
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    for b, h, t_q, t_kv, d, causal in SHAPES:
        q, k, v = (torch.randn(b, h, t, d, device="cuda", dtype=torch.bfloat16,
                               generator=gen) for t in (t_q, t_kv, t_kv))
        scale = d ** -0.5
        ref, _ = attn.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
        errs = {name: row_err(_run(fn, q, k, v, causal, scale), ref)
                for name, (fn, _) in built.items()}
        times = {name: [] for name in built}
        for name in list(built) + list(built)[::-1]:
            fn = built[name][0]
            times[name].append(ms(lambda: _run(fn, q, k, v, causal, scale)))
        sdpa = ms(lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal,
                                                          scale=scale))
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
                           shapes=rows), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
