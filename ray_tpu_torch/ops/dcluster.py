"""The plan of the ``dcluster`` kernels, and their schedules in float64.

``csrc/flash_fwd_dcluster.cu`` and ``csrc/flash_bwd_dcluster.cu``
(``FWD_DESIGNS``' and ``BWD_DESIGNS``' design from head_dim 896 up) split d
into groups of ``GROUP_COLS`` output columns and give each group to one CTA
of a thread-block cluster; the CTAs of a cluster share one resident tile
(the forward's 64 q rows, 32 q rows for dQ, 32 kv rows for dK/dV). Per
tile pair each CTA computes S (and dP) over its own columns only, the
cluster sums the partials in group order over distributed shared memory,
and each CTA updates only its own output columns from the same P (and dS).
In the forward CTA r reduces whole rows of the q tile (``reducer_rows``),
runs the online softmax for them and hands every CTA P and the rows'
rescale. A portable cluster holds at most ``MAX_CLUSTER`` CTAs, so past 8
groups a CTA owns several groups and writes one a pass (``passes``).

``dcluster_plan`` is that plan as the wrapper checks it against the built
kernels (``ray_tpu_flash_fwd_dcluster_plan``,
``ray_tpu_flash_bwd_dcluster_plan``), and ``flash_fwd_dcluster_model`` and
``flash_bwd_dcluster_model`` walk the same tiles, groups and passes in
float64 on torch tensors, so that a test can hold the schedules (every
column covered once, the partials summed over the whole cluster, each
CTA's output its own columns) to ``flash_attention_fwd_plain`` and
``flash_attention_bwd_plain`` on a machine without a card. Only the tests
call the models; the wrapper calls the plan.

``csrc/flash_bwd_dcluster128.cu`` (design ``dcluster128``, the float32
backward at head_dims 384 to 768) is the same exchange with groups of
``GROUP_COLS_128`` columns, one group a CTA, C = d / 128 CTAs a cluster and
one pass, each CTA's partials pushed as two sources (its two 64-column
halves), the resident side in registers: ``dcluster128_plan`` and
``flash_bwd_dcluster128_model``. ``csrc/flash_bwd_dcluster128_wgmma.cu`` is
the same design in bf16 and float16, its products on wgmma: one source a
CTA (its 128 columns), a resident tile of ``RESIDENT_ROWS_16`` rows against
streamed tiles (``stream_16``: by kernel and cluster size), P and dS
rounded to the dtype for the output products; ``dcluster128_plan`` gives its plan by dtype, and the
model walks its tiles and sources. ``csrc/flash_fwd_dcluster128.cu`` is the
forward of that plan in bf16, float16 and float32 (``FWD_DESIGNS``' design
at 384 to 768): a cluster's 64-row q tile against 32-row kv tiles, two
sources a CTA, the forward's reducing rows (``reducer_rows``), its shared
memory by dtype: ``dcluster128_fwd_plan`` and
``flash_fwd_dcluster128_model``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Optional, Tuple

import torch

#: output columns of a group (a CTA's pass)
GROUP_COLS = 256
#: the dcluster128 design's group (a CTA's columns) and the columns of each
#: of the two partial sources a CTA pushes
GROUP_COLS_128 = 128
SOURCE_COLS_128 = 64
#: the portable cluster size
MAX_CLUSTER = 8
#: rows of the backward's resident tile and of a streamed tile
ROWS = 32
#: the forward's tiles: 64 q rows (a cluster's), 32 kv rows streamed
FWD_BLOCK_Q = 64
FWD_BLOCK_K = 32
NEG_INF = -1e30
_ITEMSIZE = {torch.bfloat16: 2, torch.float16: 2, torch.float32: 4}


@dataclasses.dataclass(frozen=True)
class DclusterPlan:
    """The launch plan at one head_dim: ``groups`` groups of ``group_cols``
    columns (the last narrower where they do not divide d), ``cluster`` CTAs
    a cluster, ``passes`` output groups a CTA, and the dynamic shared memory
    of a CTA of the forward, the dQ and the dK/dV kernel."""

    head_dim: int
    group_cols: int
    groups: int
    cluster: int
    passes: int
    smem_dq: int
    smem_dkv: int
    smem_fwd: int
    #: the backward's resident rows (dQ's q tile, dK/dV's kv tile) and each
    #: kernel's rows of a streamed tile
    resident_rows: int = ROWS
    streamed_rows_dq: int = ROWS
    streamed_rows_dkv: int = ROWS

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

    def reducer_rows(self, rank: int) -> Tuple[int, int]:
        """[start, stop) of the forward's q-tile rows whose partials CTA
        ``rank`` sums and whose softmax it runs: ceil(64 / C) whole rows
        each, the last CTA's fewer where C does not divide 64."""
        per = math.ceil(FWD_BLOCK_Q / self.cluster)
        return min(rank * per, FWD_BLOCK_Q), min((rank + 1) * per, FWD_BLOCK_Q)


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


def _max_recv_rows(sources: int = 1) -> int:
    """The most q rows' partials a forward CTA receives, ``sources`` C
    ceil(64 / C) over the cluster sizes: 70 at one source a CTA
    (``dcluster``), 140 at two (``dcluster128``), both at C = 7."""
    return max(sources * c * math.ceil(FWD_BLOCK_Q / c) for c in range(1, MAX_CLUSTER + 1))


def fwd_smem_bytes(dtype: torch.dtype) -> int:
    """A forward CTA's dynamic shared memory (``Layout<T>::kBytes`` of
    ``flash_fwd_dcluster.cu``): the resident 64 rows of Q, two stages of the
    streamed K and V tiles (rows as the backward's), two receive buffers of
    the partials of the rows the CTA reduces (8 float4 a row), two of P
    ([64 x 8] float4) with each row's rescale and 1 / l (a float2), and four
    mbarriers."""
    row = GROUP_COLS * 4 if dtype == torch.float32 else GROUP_COLS * _ITEMSIZE[dtype] + 16
    recv = _max_recv_rows() * 8 * 16
    p = FWD_BLOCK_Q * 8 * 16 + FWD_BLOCK_Q * 8
    return FWD_BLOCK_Q * row + 2 * (2 * FWD_BLOCK_K * row) + 2 * recv + 2 * p + 4 * 8


#: stages of the dcluster128 kernels' streamed ring
STAGES_128 = 3


def smem_bytes_128(dkv: bool) -> int:
    """A dcluster128 CTA's dynamic shared memory (``Layout<kDkv>::kBytes``
    of ``flash_bwd_dcluster128.cu``): three stages of the two streamed
    tiles, 32 raw rows of 128 floats each, two receive buffers of the
    partials of the positions the CTA reduces from 2 C sources, two of P
    and dS (dQ: dS only), for dQ the resident rows' lse and delta, and four
    mbarriers; the resident side lives in registers."""
    tile = ROWS * GROUP_COLS_128 * 4
    recv = 2 * 2 * (256 + MAX_CLUSTER - 1) * 16
    pd = (2 if dkv else 1) * 256 * 16
    return (STAGES_128 * 2 * tile + 2 * recv + 2 * pd + (0 if dkv else 2 * ROWS * 4)
            + 4 * 8)


#: the 16-bit dcluster128 backward's resident rows (``kResRows`` of
#: ``flash_bwd_dcluster128_wgmma.cu``), and each kernel's streamed side
#: (rows of a streamed tile, stages of its ring): dK/dV's (``DkvStream``),
#: dQ's below ``DQ_NARROW_FROM`` CTAs a cluster (``DqWide``) and from it on
#: (``DqNarrow``: two CTAs an SM)
RESIDENT_ROWS_16 = 64
DKV_STREAM_16 = (64, 3)
DQ_WIDE_16 = (64, 3)
DQ_NARROW_16 = (32, 2)
DQ_NARROW_FROM = 4


def stream_16(dkv: bool, cluster: int) -> Tuple[int, int]:
    """(streamed rows, stages) of the 16-bit dcluster128 dQ (``dkv`` False)
    or dK/dV kernel at clusters of ``cluster`` CTAs."""
    if dkv:
        return DKV_STREAM_16
    return DQ_NARROW_16 if cluster >= DQ_NARROW_FROM else DQ_WIDE_16


def smem_bytes_128_16(dkv: bool, cluster: int) -> int:
    """A 16-bit dcluster128 CTA's dynamic shared memory (``Layout<kDkv,
    S>::kAlloc`` of ``flash_bwd_dcluster128_wgmma.cu``) at clusters of
    ``cluster`` CTAs: the resident pair (two tiles of ``RESIDENT_ROWS_16``
    rows of 128 two-byte columns), the stages of the streamed pair
    (``stream_16``), two receive buffers of the quads (float4) a CTA
    reduces from C sources and two products, C ceil(Q / C) of each at most
    Q + 7 (Q the quads of one product), two of P and dS in the dtype (dQ:
    dS), for dQ the resident rows' lse and delta, the mbarriers (two
    receive, two P/dS, a full one a stage, the resident pair's), and 1024
    bytes to align the swizzled tiles."""
    rows, stages = stream_16(dkv, cluster)
    quads = RESIDENT_ROWS_16 * rows // 4
    resident = 2 * RESIDENT_ROWS_16 * GROUP_COLS_128 * 2
    ring = stages * 2 * rows * GROUP_COLS_128 * 2
    recv = 2 * (quads + MAX_CLUSTER - 1) * 16
    pd = quads * (16 if dkv else 8)
    stats = 0 if dkv else 2 * RESIDENT_ROWS_16 * 4
    return resident + ring + 2 * recv + 2 * pd + stats + (5 + stages) * 8 + 1024


def dcluster128_plan(head_dim: int, dtype: torch.dtype) -> DclusterPlan:
    """The dcluster128 backward's plan at ``head_dim``: one group of 128
    columns a CTA, C = d / 128 CTAs a cluster, one pass. float32
    (``flash_bwd_dcluster128.cu``) takes every multiple of 128 up to 1024,
    with 32-row resident and streamed tiles; bf16 and float16
    (``flash_bwd_dcluster128_wgmma.cu``) every multiple of 128 from 256 to
    1024 (a reducing thread takes at most two quads, so C >= 2), with
    ``RESIDENT_ROWS_16`` resident rows, each kernel's streamed side at C
    (``stream_16``) and their own shared memory. The forward's is ``dcluster128_fwd_plan`` (``smem_fwd`` 0
    here)."""
    groups = head_dim // GROUP_COLS_128 if head_dim > 0 and head_dim % 128 == 0 else 0
    if dtype == torch.float32:
        if not 1 <= groups <= MAX_CLUSTER:
            raise ValueError(f"dcluster128 takes a multiple of 128 up to "
                             f"{MAX_CLUSTER * GROUP_COLS_128} in torch.float32, not head_dim "
                             f"{head_dim}")
        return DclusterPlan(head_dim, GROUP_COLS_128, groups, groups, 1, smem_bytes_128(False),
                            smem_bytes_128(True), 0)
    if dtype not in (torch.bfloat16, torch.float16) or not 2 <= groups <= MAX_CLUSTER:
        raise ValueError(f"dcluster128 takes a multiple of 128 up to "
                         f"{MAX_CLUSTER * GROUP_COLS_128} in torch.float32, and from 256 in "
                         f"torch.bfloat16 and torch.float16, not head_dim {head_dim} {dtype}")
    return DclusterPlan(head_dim, GROUP_COLS_128, groups, groups, 1,
                        smem_bytes_128_16(False, groups), smem_bytes_128_16(True, groups), 0,
                        RESIDENT_ROWS_16, stream_16(False, groups)[0], stream_16(True, groups)[0])


#: stages of the dcluster128 forward's ring of K and V tiles
FWD_STAGES_128 = 3


def fwd_smem_bytes_128(dtype: torch.dtype) -> int:
    """A dcluster128 forward CTA's dynamic shared memory (``Layout<T>::kAlloc``
    of ``flash_fwd_dcluster128.cu``): in float32 the resident Q (64 swizzled
    rows of 128 floats; bf16 and float16 keep it in registers), three
    stages of the K and V tiles (32 rows of 128 columns: 128-byte swizzled
    boxes in bf16 and float16, swizzled 512-byte rows in float32), two
    receive buffers of the partials of the rows the CTA reduces from 2 C
    sources (8 float4 a row), two of P ([64 x 8] float4) with each row's
    rescale and 1 / l, two receive and two P mbarriers and a full one a
    stage, and 1024 bytes to align the swizzled tiles: 103480 in bf16 and
    float16 (two CTAs an SM), 185400 in float32."""
    tile = FWD_BLOCK_K * GROUP_COLS_128 * _ITEMSIZE[dtype]
    q = FWD_BLOCK_Q * GROUP_COLS_128 * 4 if dtype == torch.float32 else 0
    recv = _max_recv_rows(2) * 8 * 16
    p = FWD_BLOCK_Q * 8 * 16 + FWD_BLOCK_Q * 8
    return (q + FWD_STAGES_128 * 2 * tile + 2 * recv + 2 * p + (4 + FWD_STAGES_128) * 8
            + 1024)


def dcluster128_fwd_plan(head_dim: int, dtype: torch.dtype) -> DclusterPlan:
    """The dcluster128 forward's plan at ``head_dim`` (a multiple of 128
    from 256 to 1024: the reducer's 8 threads a row need C >= 2) in bf16,
    float16 or float32: one group of 128 columns a CTA, C = d / 128 CTAs a
    cluster, one pass, each CTA's partial S pushed as two sources of
    ``SOURCE_COLS_128`` columns. It has no backward (``smem_dq`` and
    ``smem_dkv`` 0)."""
    groups = head_dim // GROUP_COLS_128 if head_dim > 0 and head_dim % 128 == 0 else 0
    if not 2 <= groups <= MAX_CLUSTER or dtype not in _ITEMSIZE:
        raise ValueError(f"the dcluster128 forward takes a multiple of 128 from 256 to "
                         f"{MAX_CLUSTER * GROUP_COLS_128} in {list(_ITEMSIZE)}, not head_dim "
                         f"{head_dim} {dtype}")
    return DclusterPlan(head_dim, GROUP_COLS_128, groups, groups, 1, 0, 0,
                        fwd_smem_bytes_128(dtype))


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
                        smem_bytes(dtype, False), smem_bytes(dtype, True),
                        fwd_smem_bytes(dtype))


def _tiles(n: int, rows: int = ROWS) -> List[Tuple[int, int]]:
    return [(r, min(r + rows, n)) for r in range(0, n, rows)]


def flash_fwd_dcluster_model(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) in float64 as the dcluster forward schedules them: 64-row
    q tiles against the 32-row kv tiles the causal skip leaves (the
    reference's test, with block_q = min(64, t_q)), pass by pass; per kv
    tile each CTA's partial S over its own columns, the partials summed in
    group order, the masks and the online softmax by rows of the reducing
    CTAs (a row that has seen no visible key takes p = 1 on each column of
    the reference's tile, min(32, t_kv) wide), and each CTA's update of its
    own output columns of the pass only; a q tile that runs no kv tile gets
    0 and NEG_INF."""
    plan = dcluster_plan(q.shape[-1], q.dtype)
    sources = [plan.cta_columns(rank) for rank in range(plan.cluster)]
    return _fwd_model(q, k, v, plan, sources, causal=causal, scale=scale)


def flash_fwd_dcluster128_model(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    scale: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) in float64 as the dcluster128 forward schedules them: the
    dcluster schedule at ``dcluster128_fwd_plan``'s one pass, the partial S
    summed over 2 C sources of 64 columns each (CTA r's halves [128 r,
    128 r + 64) and [128 r + 64, 128 r + 128)) in column order, each CTA's
    update of its own 128 output columns."""
    plan = dcluster128_fwd_plan(q.shape[-1], q.dtype)
    sources = [(c, c + SOURCE_COLS_128) for c in range(0, plan.head_dim, SOURCE_COLS_128)]
    return _fwd_model(q, k, v, plan, sources, causal=causal, scale=scale)


def _fwd_model(q, k, v, plan: DclusterPlan, sources: List[Tuple[int, int]], *, causal: bool,
               scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The forward's schedule under ``plan``, the partial S over the column
    ranges ``sources`` summed in their order."""
    t_q, t_kv, d = q.shape[-2], k.shape[-2], q.shape[-1]
    bq, bk = min(FWD_BLOCK_Q, t_q), min(FWD_BLOCK_K, t_kv)
    n_kv = math.ceil(t_kv / FWD_BLOCK_K)
    pad = n_kv * FWD_BLOCK_K - t_kv  # the last tile's rows past t_kv read zeros
    qf = q.to(torch.float64)
    kf, vf = (torch.nn.functional.pad(x.to(torch.float64), (0, 0, 0, pad)) for x in (k, v))
    off = t_kv - t_q
    out = torch.zeros(*q.shape, dtype=torch.float64)
    lse = torch.full(q.shape[:-1], NEG_INF, dtype=torch.float64)
    col_t = torch.arange(FWD_BLOCK_K)
    for qs in _tiles(t_q, FWD_BLOCK_Q):
        last = qs[0] + bq - 1 + off
        n_run = n_kv if not causal else (0 if last < 0 else min(n_kv, last // FWD_BLOCK_K + 1))
        q_pos = torch.arange(qs[0], qs[1])[:, None] + off
        rows = slice(qs[0], qs[1])
        for pass_ in range(plan.passes if n_run else 0):
            m = torch.full((*q.shape[:-2], qs[1] - qs[0]), NEG_INF, dtype=torch.float64)
            l = torch.zeros_like(m)
            acc = torch.zeros(*q.shape[:-2], qs[1] - qs[0], d, dtype=torch.float64)
            for j in range(n_run):
                ks = slice(j * FWD_BLOCK_K, (j + 1) * FWD_BLOCK_K)
                s = 0
                for c0, c1 in sources:  # the partials, in their order
                    s = s + qf[..., rows, c0:c1] @ kf[..., ks, c0:c1].transpose(-1, -2)
                k_pos = j * FWD_BLOCK_K + col_t
                visible = (k_pos < t_kv)[None, :].expand(qs[1] - qs[0], -1)
                if causal:
                    visible = visible & (q_pos >= k_pos[None, :])
                s = torch.where(visible, s * scale, -math.inf)
                mx = s.amax(dim=-1)
                m_new = torch.maximum(m, torch.where(mx == -math.inf, NEG_INF, mx))
                alpha = torch.exp(m - m_new)
                p = torch.exp(s - m_new[..., None])
                empty = (m_new == NEG_INF)[..., None]
                p = torch.where(empty, (col_t < bk).to(torch.float64), p)
                l = l * alpha + p.sum(-1)
                for rank in range(plan.cluster):  # each CTA its own columns
                    o0, o1 = plan.output_columns(rank, pass_)
                    acc[..., o0:o1] = (acc[..., o0:o1] * alpha[..., None]
                                       + p @ vf[..., ks, o0:o1])
                m = m_new
            denom = torch.where(l == 0.0, 1.0, l)
            for rank in range(plan.cluster):
                o0, o1 = plan.output_columns(rank, pass_)
                out[..., rows, o0:o1] = acc[..., o0:o1] / denom[..., None]
            lse[..., rows] = m + torch.log(denom)
    return out, lse


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
    plan = dcluster_plan(q.shape[-1], q.dtype)
    sources = [plan.cta_columns(rank) for rank in range(plan.cluster)]
    return _bwd_model(q, k, v, o, lse, do, plan, sources, causal=causal, scale=scale, dlse=dlse)


def flash_bwd_dcluster128_model(
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
    """(dq, dk, dv) in float64 as the dcluster128 kernels schedule them:
    the dcluster schedule at ``dcluster128_plan``'s one pass and tiles,
    each CTA's update of its own 128 output columns. float32: the partial S
    and dP summed over 2 C sources of 64 columns each (CTA r's halves
    [128 r, 128 r + 64) and [128 r + 64, 128 r + 128)) in column order.
    bf16 and float16: over C sources, a CTA's 128 columns, in column order,
    and P and dS rounded to the dtype before the products that take them,
    as the wgmma kernels round them."""
    plan = dcluster128_plan(q.shape[-1], q.dtype)
    if q.dtype == torch.float32:
        sources = [(c, c + SOURCE_COLS_128) for c in range(0, plan.head_dim, SOURCE_COLS_128)]
        round_to = None
    else:
        sources = [plan.cta_columns(rank) for rank in range(plan.cluster)]
        round_to = q.dtype
    return _bwd_model(q, k, v, o, lse, do, plan, sources, causal=causal, scale=scale, dlse=dlse,
                      round_to=round_to)


def _bwd_model(q, k, v, o, lse, do, plan: DclusterPlan, sources: List[Tuple[int, int]], *,
               causal: bool, scale: float, dlse: Optional[torch.Tensor],
               round_to: Optional[torch.dtype] = None
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The backward's schedule under ``plan`` (its resident rows and each
    kernel's streamed rows), the partials over the column ranges ``sources`` summed in their
    order; P and dS rounded to ``round_to`` for the output products where
    it is given."""
    t_q, t_kv = q.shape[-2], k.shape[-2]
    qf, kf, vf, dof = (x.to(torch.float64) for x in (q, k, v, do))
    delta = (dof * o.to(torch.float64)).sum(-1)
    if dlse is not None:
        delta = delta - dlse.to(torch.float64)
    lse64 = lse.to(torch.float64)
    off = t_kv - t_q
    guard = causal and t_q > t_kv

    def p_and_ds(qs, ks):
        """P and dS of q rows qs against kv rows ks, S and dP summed over
        the partials of ``sources`` in their order."""
        s = dp = 0
        for c0, c1 in sources:
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
        ds = p * (dp - delta[..., qs[0]:qs[1], None])
        if round_to is not None:
            p, ds = (x.to(round_to).to(torch.float64) for x in (p, ds))
        return p, ds

    dq, dk, dv = (torch.zeros_like(x) for x in (qf, kf, vf))
    res = plan.resident_rows
    for qs in _tiles(t_q, res):  # dQ: the resident q tile, the kv tiles it sees
        last = qs[1] - 1 + off
        ks_all = [ks for ks in _tiles(t_kv, plan.streamed_rows_dq)
                  if not causal or ks[0] <= last]
        for pass_ in range(plan.passes):
            for ks in ks_all:
                _, ds = p_and_ds(qs, ks)
                for rank in range(plan.cluster):
                    o0, o1 = plan.output_columns(rank, pass_)
                    dq[..., qs[0]:qs[1], o0:o1] += ds @ kf[..., ks[0]:ks[1], o0:o1]
    for ks in _tiles(t_kv, res):  # dK/dV: the resident kv tile, the q tiles that see it
        qs_all = [qs for qs in _tiles(t_q, plan.streamed_rows_dkv)
                  if not causal or qs[1] - 1 + off >= ks[0]]
        for pass_ in range(plan.passes):
            for qs in qs_all:
                p, ds = p_and_ds(qs, ks)
                for rank in range(plan.cluster):
                    o0, o1 = plan.output_columns(rank, pass_)
                    dv[..., ks[0]:ks[1], o0:o1] += p.transpose(-1, -2) @ dof[..., qs[0]:qs[1], o0:o1]
                    dk[..., ks[0]:ks[1], o0:o1] += ds.transpose(-1, -2) @ qf[..., qs[0]:qs[1], o0:o1]
    return dq * scale, dk * scale, dv
