"""The float32 flash kernels' TF32 arithmetic, repeated on the CPU.

``csrc/flash_bwd_f32.cu`` and ``csrc/flash_fwd_f32.cu`` form every float32
product on the tensor cores as 3xTF32: each operand x is split into
big = cvt.rna.tf32.f32(x) and small = cvt.rna.tf32.f32(x - big), and a
product x y is taken as
small_x big_y + big_x small_y + big_x big_y (small_x small_y, at most 2^-22
of |x y|, is dropped). The functions here do the same to torch tensors, so
that a test can hold the kernels' numerics to the reference on a machine
without a card:

* ``round_tf32``: cvt.rna.tf32.f32 on float32 bit patterns (round to the
  nearest value with 10 mantissa bits, ties away from zero; inf and NaN
  stay what they are; subnormals round alike, a carry landing in the
  exponent);
* ``split_tf32``: (big, small) of a float32 tensor;
* ``mm_3xtf32``: ``a @ b`` from the three products of the split operands.
  Each product of two tf32 values is exact in float32; the products are
  summed in float32 by ``torch.matmul`` (the tensor cores sum in another
  order, which the card's run measures, not this);
* ``flash_bwd_3xtf32``: ``flash_attention_bwd_plain``'s arithmetic with
  every product (S, dP, dQ, dK, dV) through ``mm_3xtf32``;
* ``flash_fwd_3xtf32``: ``flash_attention_fwd_plain``'s algorithm at the
  float32 design's tiles (64 x 64) with S and P V through ``mm_3xtf32``,
  the numerics of ``csrc/flash_fwd_f32.cu``.

Only the tests call it; no path of the port does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops.attention import NEG_INF, _causal_mask, _flash_fwd_tiled

_HALF_ULP = 0x1000  # half of a tf32 ulp, in float32 bits
_KEEP = 0xFFFFE000  # sign, exponent and the top 10 mantissa bits


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """cvt.rna.tf32.f32 of each element of a float32 tensor, as float32."""
    x = x.to(torch.float32)
    bits = x.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    rounded = (bits + _HALF_ULP) & _KEEP
    rounded = torch.where(rounded >= 2 ** 31, rounded - 2 ** 32, rounded)
    out = rounded.to(torch.int32).view(torch.float32)
    return torch.where(torch.isnan(x), x, out)


def split_tf32(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(big, small) with big = round_tf32(x) and small = round_tf32(x -
    big): x = big + small to 2^-22 of |x| for a normal x."""
    x = x.to(torch.float32)
    big = round_tf32(x)
    return big, round_tf32(x - big)


def mm_3xtf32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` (batched as ``torch.matmul``) in 3xTF32, float32."""
    a_big, a_small = split_tf32(a)
    b_big, b_small = split_tf32(b)
    return (a_small @ b_big + a_big @ b_small) + a_big @ b_big


def flash_bwd_3xtf32(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    o: torch.Tensor,
    lse: torch.Tensor,
    do: torch.Tensor,
    *,
    causal: bool,
    scale: float,
    dlse: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in float32 as ``flash_attention_bwd_plain`` computes
    them (the same masking, lse guard and delta), every product in
    3xTF32."""
    t_q, t_kv = q.shape[-2], k.shape[-2]
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    delta = (dof * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    s = mm_3xtf32(qf, kf.transpose(-1, -2)) * scale
    if causal:
        s = torch.where(_causal_mask(t_q, t_kv, q.device), s, NEG_INF)
    p = torch.exp(s - lse[..., None])
    if causal and t_q > t_kv:
        p = torch.where(lse[..., None] > NEG_INF / 2, p, 0.0)
    dp = mm_3xtf32(dof, vf.transpose(-1, -2))
    ds = p * (dp - delta[..., None]) * scale
    dq = mm_3xtf32(ds, kf)
    dk = mm_3xtf32(ds.transpose(-1, -2), qf)
    dv = mm_3xtf32(p.transpose(-1, -2), dof)
    return dq, dk, dv


def flash_fwd_3xtf32(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    scale: float,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) in float32 as ``flash_attention_fwd_plain`` computes them
    (the same tiles, skips, masks and rows that see no key; by default the
    tiles ``FWD_DESIGNS`` names), with S = Q K^T and P V in 3xTF32."""
    return _flash_fwd_tiled(
        q.float(), k.float(), v.float(), causal=causal, scale=scale, block_q=block_q,
        block_k=block_k, qk=lambda x, y: mm_3xtf32(x, y.transpose(-1, -2)), pv=mm_3xtf32)
