"""The bf16 head_dim-16/32 backward kernels' arithmetic, repeated on the CPU.

``csrc/flash_bwd_persistent.cu`` (``BWD_DESIGNS`` design ``persistent``)
computes the flash backward's dq, dk and dv with its own rounding and its
own placement of the constants. ``flash_bwd_persistent`` does the same to
torch tensors, so that a test can hold the kernels' numerics to the
reference on a machine without a card:

* P = exp2(S * (scale * log2 e) - lse * log2 e): scale * log2(e) is one
  float32 constant, so a score costs one FFMA and one ex2 on the card;
* a masked score (causal, q the suffix of kv) gets P = 0, whatever its
  lse. That is also what drops a row that sees no key (causal, t_q > t_kv,
  lse about NEG_INF): every one of its scores is masked, so it needs no
  test of its lse;
* dS / scale = P * (dP - delta): the scale moves to the dq and dk
  epilogues, dq = scale * (dS / scale) K and dk = scale * (dS / scale)^T Q;
* P and dS / scale are rounded to bf16 where they feed a product (dv +=
  P^T dO, dq and dk), and dq, dk, dv to bf16 at the end; S, dP and every
  sum stay float32.

The sums run over whole rows here and by 16-column mma steps and 64-row
tiles on the card: summation order only. Only the tests call it; no path
of the port does.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ray_tpu_torch.ops.attention import _causal_mask

LOG2E = 1.4426950408889634


def flash_bwd_persistent(
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
    """(dq, dk, dv) in bf16 as ``flash_bwd_persistent.cu`` computes them
    from bf16 q, k, v, o, do and the forward's float32 lse, with
    delta = rowsum(dO * O) (minus ``dlse``) as the wrapper passes it."""
    t_q, t_kv = q.shape[-2], k.shape[-2]
    qf, kf, vf, dof = (x.float() for x in (q, k, v, do))
    delta = (dof * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    scale32 = torch.tensor(scale, dtype=torch.float32)
    scale_log2 = scale32 * torch.tensor(LOG2E, dtype=torch.float32)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf)
    lse2 = lse.float() * torch.tensor(LOG2E, dtype=torch.float32)
    p = torch.exp2(s * scale_log2 - lse2[..., None])
    if causal:
        p = torch.where(_causal_mask(t_q, t_kv, q.device), p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = (p * (dp - delta[..., None])).to(torch.bfloat16).float()
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf) * scale32
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf) * scale32
    dv = torch.einsum("bhqk,bhqd->bhkd", p.to(torch.bfloat16).float(), dof)
    return tuple(x.to(torch.bfloat16) for x in (dq, dk, dv))
