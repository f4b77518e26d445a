"""The plan of the ``dcluster`` backward kernels, and their schedule in float64.

``csrc/flash_bwd_dcluster.cu`` (``BWD_DESIGNS``' design for float32 from
head_dim 896 up) splits d into groups of ``GROUP_COLS`` output columns and
gives each group to one CTA of a thread-block cluster; the CTAs of a
cluster share one resident tile (32 q rows for dQ, 32 kv rows for dK/dV).
Per tile pair each CTA computes S and dP over its own columns only, the
cluster sums the partials in group order over distributed shared memory,
and each CTA updates only its own output columns from the same P and dS.
A portable cluster holds at most ``MAX_CLUSTER`` CTAs, so past 8 groups a
CTA owns several groups and writes one a pass (``passes``).

``dcluster_plan`` is that plan as the wrapper checks it against the built
kernel (``ray_tpu_flash_bwd_dcluster_plan``), and
``flash_bwd_dcluster_model`` walks the same tiles, groups and passes in
float64 on torch tensors, so that a test can hold the schedule (every
column covered once, the partials summed over the whole cluster, each
CTA's output its own columns) to ``flash_attention_bwd_plain`` on a
machine without a card. Only the tests call the model; the wrapper calls
the plan.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

#: output columns of a group (a CTA's pass)
GROUP_COLS = 256
#: the portable cluster size
MAX_CLUSTER = 8
#: rows of the resident tile and of a streamed tile
ROWS = 32
NEG_INF = -1e30
_ITEMSIZE = {torch.bfloat16: 2, torch.float16: 2, torch.float32: 4}


@dataclasses.dataclass(frozen=True)
class DclusterPlan:
    """The launch plan at one head_dim: ``groups`` groups of ``group_cols``
    columns (the last narrower where they do not divide d), ``cluster`` CTAs
    a cluster, ``passes`` output groups a CTA, and the dynamic shared memory
    of a CTA of the dQ and of the dK/dV kernel."""

    head_dim: int
    group_cols: int
    groups: int
    cluster: int
    passes: int
    smem_dq: int
    smem_dkv: int

    def cta_columns(self, rank: int) -> Tuple[int, int]:
        """[start, stop) of the columns whose partial S and dP CTA ``rank``
        computes: its groups rank * passes .. rank * passes + passes - 1."""
        start = rank * self.passes * self.group_cols
        return start, min(start + self.passes * self.group_cols, self.head_dim)

    def output_columns(self, rank: int, pass_: int) -> Tuple[int, int]:
        """[start, stop) of the output columns CTA ``rank`` writes in pass
        ``pass_``: group rank * passes + pass_, empty past d."""
        start = min((rank * self.passes + pass_) * self.group_cols, self.head_dim)
        return start, min(start + self.group_cols, self.head_dim)


def smem_bytes(dtype: torch.dtype, dkv: bool) -> int:
    """A CTA's dynamic shared memory (``Layout<T, kDkv>::kBytes``): the two
    resident tiles, two stages of the two streamed tiles (float32 rows of
    256 floats, swizzled; bf16 and float16 rows padded by 16 bytes), two
    receive buffers of the partials of the positions the CTA reduces, two of
    P and dS (dQ: dS only), for dQ the resident rows' lse and delta, and
    four mbarriers."""
    row = GROUP_COLS * 4 if dtype == torch.float32 else GROUP_COLS * _ITEMSIZE[dtype] + 16
    tile = ROWS * row
    recv = 2 * (256 + MAX_CLUSTER - 1) * 16
    pd = (2 if dkv else 1) * 256 * 16
    return (2 * tile + 2 * (2 * tile) + 2 * recv + 2 * pd + (0 if dkv else 2 * ROWS * 4)
            + 4 * 8)


def dcluster_plan(head_dim: int, dtype: torch.dtype) -> DclusterPlan:
    """The plan at ``head_dim`` (a positive multiple of 128) in ``dtype``:
    G = ceil(d / 256) groups, P = ceil(G / 8) passes, C = ceil(G / P) CTAs
    a cluster, so that no CTA of a cluster is left without columns."""
    if head_dim <= 0 or head_dim % 128 or dtype not in _ITEMSIZE:
        raise ValueError(f"dcluster takes a positive multiple of 128 in "
                         f"{list(_ITEMSIZE)}, not head_dim {head_dim} {dtype}")
    groups = math.ceil(head_dim / GROUP_COLS)
    passes = math.ceil(groups / MAX_CLUSTER)
    return DclusterPlan(head_dim, GROUP_COLS, groups, math.ceil(groups / passes), passes,
                        smem_bytes(dtype, False), smem_bytes(dtype, True))


def _tiles(n: int) -> List[Tuple[int, int]]:
    return [(r, min(r + ROWS, n)) for r in range(0, n, ROWS)]


def flash_bwd_dcluster_model(
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
    """(dq, dk, dv) in float64 as the dcluster kernels schedule them: dQ
    over resident 32-row q tiles and dK/dV over resident 32-row kv tiles,
    each against the streamed tiles the causal skip leaves, pass by pass;
    per tile pair each CTA's partial S and dP over its own columns, their
    sum in group order, P = exp(scale S - lse) with the masks and the
    empty-row guard, dS = P (dP - delta), and each CTA's update of its own
    output columns only; the scale in the epilogues."""
    t_q, t_kv, d = q.shape[-2], k.shape[-2], q.shape[-1]
    plan = dcluster_plan(d, q.dtype)
    qf, kf, vf, dof = (x.to(torch.float64) for x in (q, k, v, do))
    delta = (dof * o.to(torch.float64)).sum(-1)
    if dlse is not None:
        delta = delta - dlse.to(torch.float64)
    lse64 = lse.to(torch.float64)
    off = t_kv - t_q
    guard = causal and t_q > t_kv

    def p_and_ds(qs, ks):
        """P and dS of q rows qs against kv rows ks, S and dP summed over
        the cluster's partials in group order."""
        s = dp = 0
        for rank in range(plan.cluster):
            c0, c1 = plan.cta_columns(rank)
            s = s + qf[..., qs[0]:qs[1], c0:c1] @ kf[..., ks[0]:ks[1], c0:c1].transpose(-1, -2)
            dp = dp + dof[..., qs[0]:qs[1], c0:c1] @ vf[..., ks[0]:ks[1], c0:c1].transpose(-1, -2)
        lse_t = lse64[..., qs[0]:qs[1], None]
        p = torch.exp(s * scale - lse_t)
        q_pos = torch.arange(qs[0], qs[1])[:, None] + off
        keep = torch.ones(qs[1] - qs[0], ks[1] - ks[0], dtype=torch.bool)
        if causal:
            keep = q_pos >= torch.arange(ks[0], ks[1])[None, :]
        if guard:
            keep = keep & (lse_t > NEG_INF / 2)
        p = torch.where(keep, p, 0.0)
        return p, p * (dp - delta[..., qs[0]:qs[1], None])

    dq, dk, dv = (torch.zeros_like(x) for x in (qf, kf, vf))
    for qs in _tiles(t_q):  # dQ: the resident q tile, the kv tiles it sees
        last = qs[1] - 1 + off
        ks_all = [ks for ks in _tiles(t_kv) if not causal or ks[0] <= last]
        for pass_ in range(plan.passes):
            for ks in ks_all:
                _, ds = p_and_ds(qs, ks)
                for rank in range(plan.cluster):
                    o0, o1 = plan.output_columns(rank, pass_)
                    dq[..., qs[0]:qs[1], o0:o1] += ds @ kf[..., ks[0]:ks[1], o0:o1]
    for ks in _tiles(t_kv):  # dK/dV: the resident kv tile, the q tiles that see it
        qs_all = [qs for qs in _tiles(t_q) if not causal or qs[1] - 1 + off >= ks[0]]
        for pass_ in range(plan.passes):
            for qs in qs_all:
                p, ds = p_and_ds(qs, ks)
                for rank in range(plan.cluster):
                    o0, o1 = plan.output_columns(rank, pass_)
                    dv[..., ks[0]:ks[1], o0:o1] += p.transpose(-1, -2) @ dof[..., qs[0]:qs[1], o0:o1]
                    dk[..., ks[0]:ks[1], o0:o1] += ds.transpose(-1, -2) @ qf[..., qs[0]:qs[1], o0:o1]
    return dq * scale, dk * scale, dv
