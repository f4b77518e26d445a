"""How the port's kernels are held to their plain PyTorch versions: the
tolerances and the error reading that ``chip_smoke.py`` and the card tests
(``tests/test_torch_port_kernels.py``) share.
"""

from __future__ import annotations

import torch

# forward, a limit on ``row_err`` of out. bf16: the kernel rounds P to bf16
# before the PV product (2^-9 relative each, random in sign, so a row's sum
# keeps about that share; the plain version keeps float32) and both round O
# to bf16 (at most 2^-9 of each element). At b=1 h=2 t=2048 d=128, causal,
# that rounding reads ~2e-3, while half of V in one kv tile, seen only by the
# last q tile, reads ~0.18 and a box of a tile read from the wrong place
# 0.3-1 (tests/test_torch_port_kernels.py holds the first two). A limit on
# the largest element cannot tell the V fault from rounding: an element of
# the last rows has a root mean square of ~0.04, and the fault moves the
# largest error by about as much as rounding does. float32: summation order
# only. float16 (the wgmma and d64 kernels at head_dim 64, 128 and 256
# against their plain version, and the plain design on the card against the
# same function on the CPU): P and O rounded to float16 on one side or both
# (2^-11 relative each, a quarter of bf16's), so a row differs by ~1e-3.
FWD_ROW_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4, torch.float16: 5e-3}

# forward, lse atol: float32 scores in both, summation order only (the bf16
# and float16 kernels' scores come from q and k in their dtype, as the plain
# version's do).
FWD_LSE_TOL = {torch.bfloat16: 2e-3, torch.float32: 1e-4, torch.float16: 2e-3}

# backward, a limit on ``row_err`` of dq, dk and dv. bf16: the kernels round
# P and dS to bf16 before they feed a product (2^-9 relative each, random in
# sign, so a row's sum keeps about that share) and round dq, dk, dv to bf16
# (at most 2^-9 of each element), where the plain version keeps float32 until
# the end: a few 1e-3 per row. float32: summation order only. float16: the
# kernels round P and dS to float16 (2^-11 relative, a quarter of bf16's),
# and the plain design on the card and on the CPU keep float32 sums, rounded
# to float16 at the end: ~1e-3 a row.
BWD_TOL = {torch.bfloat16: 2e-2, torch.float32: 1e-4, torch.float16: 5e-3}

# a row's norm counts for at least this share of the root mean square of the
# reference's row norms, so that a row whose exact value is 0 (dq of the
# first causal row: its one term has dP = delta) and which both sides give as
# rounding noise does not count as a relative error of order 1
ROW_FLOOR = 1 / 8


def row_err(x: torch.Tensor, ref: torch.Tensor) -> float:
    """The worst row's relative error of ``x`` against ``ref``: the largest,
    over rows (vectors along the last dimension), of ||x_r - ref_r|| over
    max(||ref_r||, ROW_FLOOR * rms), rms being the root mean square of the
    reference's row norms.

    Each row is held to its own norm. A gradient's largest elements sit in
    its first causal rows, and rows further on are smaller by about the
    square root of their position, so a limit taken from the largest element
    would let a whole missing tile of the later rows pass."""
    diff = torch.linalg.vector_norm(x.float() - ref.float(), dim=-1)
    norm = torch.linalg.vector_norm(ref.float(), dim=-1)
    floor = ROW_FLOOR * norm.square().mean().sqrt()
    floor = torch.clamp(floor, min=torch.finfo(torch.float32).tiny)
    return float((diff / torch.maximum(norm, floor)).max())
