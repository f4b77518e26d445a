"""Attention for the port: plain PyTorch versions and the flash dispatcher.

Counterpart of ``ray_tpu/ops/attention.py``. Layout [batch, heads, seq,
head_dim]; ``NEG_INF = -1e30`` is a finite mask value; under the causal mask
a shorter q is the suffix of the kv context (``q_pos = q_idx + t_kv - t_q``).

* ``_attention_plain``, ``attention_with_lse``, ``merge_attention`` and
  ``blockwise_attention`` are the plain versions of the reference's XLA
  functions of the same role.
* ``flash_attention_fwd_plain`` repeats the TPU flash kernel's algorithm
  (``_flash_fwd_kernel``) tile for tile, including what it does to rows that
  see no key, at the tiles of the card's kernel for the input's head_dim and
  dtype (``fwd_tiles``). Only the tests and the smoke script's comparison
  call it directly; the kernel's wrapper takes it for tensors on the CPU.
* ``flash_attention_bwd_plain`` repeats the arithmetic of the TPU backward
  kernels (``_flash_bwd_dq_kernel``, ``_flash_bwd_dkv_kernel``), edge rules
  included.
* ``flash_attention_fwd``, the forward kernel's wrapper, launches on CUDA
  tensors the hand-written Hopper kernel that the dispatch table
  ``FWD_DESIGNS`` names for (head_dim, dtype): ``csrc/flash_fwd_wgmma.cu``
  (TMA, wgmma, warp-specialised; bf16 and float16 at head_dim 128, 256),
  ``csrc/flash_fwd_d64.cu`` (the same machinery in a persistent grid whose
  CTAs take (q tile, head) items from the launch's own counter; bf16 and
  float16 at 64),
  ``csrc/flash_fwd_persistent.cu`` (a persistent grid of several CTAs an
  SM, a TMA ring; bf16 at head_dim 16, 32), ``csrc/flash_fwd_f32.cu`` (3xTF32
  on mma.sync; float32 at head_dims 16 to 256),
  ``csrc/flash_fwd_dcluster128.cu`` (design ``dcluster128``, bf16, float16
  and float32 at 384, 512, 640 and 768: the d / 128 CTAs of a thread-block
  cluster share a 64-row q tile, each computes S over its own 128 columns
  as two 64-column sources, bf16 and float16 on wgmma with K and V by TMA,
  float32 in 3xTF32 on mma.sync; plan ``ops/dcluster.py``'s
  ``dcluster128_fwd_plan``) or ``csrc/flash_fwd_dcluster.cu`` (design
  ``dcluster``, d a runtime argument: the CTAs of a thread-block cluster
  share a 64-row q tile, each computes S over its own columns, the cluster
  sums them over distributed shared memory into one P, and each CTA writes
  its own columns of O; bf16, float16 and float32 at every multiple of 128
  from ``DSPLIT_MIN_D`` = 896 up); ``csrc/flash_fwd.cu`` (mma.sync), bf16
  16/32's kernel before, is on no path, and neither is
  ``csrc/flash_fwd_dsplit.cu``, the design before ``dcluster``, which
  ``ops/flash_fwd_variants.py --dsplit`` times beside it, nor, at 384 to
  768, ``csrc/flash_fwd_wide.cu`` and ``flash_fwd_f32.cu``'s builds there,
  the designs before ``dcluster128``, which ``--wide`` times beside it.
  ``flash_attention_bwd`` launches the dQ and dK/dV kernels
  (``flash_bwd_dq``, ``flash_bwd_dkv``) that the dispatch table
  ``BWD_DESIGNS`` names: ``csrc/flash_bwd_wgmma.cu`` (TMA, wgmma,
  warp-specialised; bf16 and float16 at head_dim 128 and 256),
  ``csrc/flash_bwd_d64.cu`` (dQ and dK/dV at bf16 and float16 64),
  ``csrc/flash_bwd_persistent.cu`` (a persistent grid of several CTAs an
  SM, a TMA ring; bf16 at head_dim 16 and 32), ``csrc/flash_bwd_wide.cu``
  (mma.sync, d cut between warps; bf16 and float16 at 384, 512, 640 and 768),
  ``csrc/flash_bwd_f32.cu`` (3xTF32 on mma.sync; float32 at head_dims 16 to
  256), ``csrc/flash_bwd_dcluster128.cu`` (design ``dcluster128``, float32
  at 384, 512, 640 and 768: ``dcluster``'s exchange over clusters of d / 128
  CTAs of 128 columns, the resident side's operands split into TF32 big and
  small once, in registers, and a warp of its own that reduces; plan
  ``ops/dcluster.py``'s ``dcluster128_plan``) or
  ``csrc/flash_bwd_dcluster.cu`` (design ``dcluster``,
  bf16, float16 and float32 from 896 up: the CTAs of a thread-block cluster
  share a resident tile, each computes S and dP over its own columns, the
  cluster sums them over distributed shared memory, and each CTA writes its
  own output columns; the plan is ``ops/dcluster.py``'s);
  ``csrc/flash_bwd.cu`` (mma.sync), bf16 16/32's kernels before, is on no
  path, and neither is ``csrc/flash_bwd_dsplit.cu``, the design before
  ``dcluster``, which ``ops/flash_bwd_variants.py --dsplit`` times beside it.
* Both tables hold rows (``HEAD_DIMS``) and a rule (``dsplit_takes``: every
  multiple of 128 from ``DSPLIT_MIN_D`` up, in bf16, float16 and float32).
  A key the rule takes runs its design (``dcluster`` in both) where the
  reference runs its Pallas kernel (both lengths multiples of 8,
  ``reference_takes_kernel``) and the reference's own route, ``plain``,
  where it does not (``_design``), so every input the reference sends to
  its kernel has a Hopper kernel.
* Every other (head_dim, dtype) (the head_dims outside ``HEAD_DIMS`` that
  the rule does not take, float16 at 16 and 32) goes to both tables'
  ``plain`` design: the reference's own route for the input,
  ``plain_attention_with_lse`` and its gradient ``plain_attention_bwd``.
  On CUDA tensors it computes only where that route is the reference's
  ``_attention_xla`` (``_attention_plain``: head_dims that are neither 64
  nor a multiple of 128, or lengths that are not multiples of 8), which is
  every input the dispatcher hands it in bf16, float16 and float32;
  another dtype where the reference takes its kernel raises
  (``_check_plain_inputs``). On CPU tensors it computes either route
  (``flash_attention_fwd_plain`` at the reference's tiles on the kernel
  route).
* The wgmma, d64, persistent, dcluster and dcluster128 forward kernels take the row
  max of the raw scores and fold the scale in after it, so they take a
  positive scale; the wrapper gives them any other as the same scores,
  exactly: -q and
  -scale for a negative one, zeros and 1 for 0 (``_positive_scale``). The
  backward kernels take any scale.
* Launches count in ``flash_fwd_launches``, ``flash_bwd_dq_launches`` and
  ``flash_bwd_dkv_launches``, in the design's
  ``flash_fwd_<design>_launches`` and ``flash_bwd_{dq,dkv}_<design>_launches``
  and, by head_dim, in ``launches_by_head_dim`` (``plain`` included: its
  computation on a CUDA tensor counts as its launch). On CPU tensors the wrappers take the plain versions and count
  nothing. On a CUDA tensor they launch or raise: the ``plain`` design is a
  table row with its counters, and runs on the card only where the
  reference runs no kernel either.
* ``flash_fwd_op`` is the forward wrapper as the operator
  ``ray_tpu_torch::flash_fwd`` (``FLASH_FWD``), which the remat policy
  "attn" names; ``FlashAttention`` is the autograd Function over it and the
  backward wrapper, giving (out, lse) with a gradient for both;
  ``flash_attention_with_lse`` calls it (ring attention's block); and
  ``dot_product_attention`` the public entry, in the [b, h, t, d] layout,
  over the Function; with ``segment_ids`` it takes ``_attention_plain`` on
  any device, as the reference's dispatcher takes its XLA path.
"""

from __future__ import annotations

import collections
import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops import _build, dcluster

NEG_INF = -1e30
#: the head_dims past 256 that the tables' rows take: the forward's
#: ``dcluster128`` (a CTA of a cluster owns 128 columns of d) in bf16,
#: float16 and float32; the backward's ``wide`` in bf16 and float16 (a warp
#: owns 128 columns) and ``dcluster128`` in float32
WIDE_HEAD_DIMS = (384, 512, 640, 768)
#: the head_dims of the tables' rows (the rule, ``dsplit_takes``, takes
#: every multiple of 128 from ``DSPLIT_MIN_D`` up besides)
HEAD_DIMS = (16, 32, 64, 128, 256) + WIDE_HEAD_DIMS
#: the least head_dim of the tables' rule: the forward's and the backward's
#: ``dcluster`` design (d a runtime argument, the output's columns split over
#: the CTAs of a cluster) take every multiple of 128 from here up in bf16,
#: float16 and float32
DSPLIT_MIN_D = 896
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}
#: the reference's default flash tiles (``ray_tpu/ops/attention.py``'s
#: ``dot_product_attention``: block_q = block_k = 512), which the plain
#: design repeats where the reference takes its kernel
REF_BLOCK = 512


@dataclasses.dataclass(frozen=True)
class FwdDesign:
    """One flash forward design: its name, its source ``csrc/<source>.cu``
    and entry point, its tiles (q rows and kv rows per tile), which are the
    semantics of rows that see no key, and whether its entry takes an int32
    item counter of its own after lse (``schedule``). Each launcher states
    the grid it takes and refuses a larger one. The ``plain`` design
    launches no kernel: no source."""

    name: str
    source: Optional[str]
    entry: Optional[str]
    block_q: int
    block_k: int
    schedule: bool = False


@dataclasses.dataclass(frozen=True)
class BwdKernel:
    """One flash backward kernel: the design whose counter it carries, its
    source ``csrc/<source>.cu`` and its entry point, and whether the entry
    takes an int32 item counter of its own after its outputs (``schedule``);
    the ``plain`` design's has neither source nor entry."""

    name: str
    source: Optional[str]
    entry: Optional[str]
    schedule: bool = False


@dataclasses.dataclass(frozen=True)
class BwdDesign:
    """The dQ and dK/dV kernels of one (head_dim, dtype). The backward's
    result does not depend on tiles (``flash_attention_bwd_plain``), so the
    design names none."""

    dq: BwdKernel
    dkv: BwdKernel


class DesignTable(dict):
    """A dispatch table keyed on (head_dim, dtype): the hand-written design
    of each key it holds as a row, the design ``by_rule`` of each other key
    that ``rule(head_dim, dtype)`` takes, and its ``plain`` design for every
    other key (``table[key]`` gives it). ``in`` answers True for every key
    that a kernel takes, by row or by rule; iteration sees the rows only."""

    def __init__(self, rows, plain, rule=None, by_rule=None):
        super().__init__(rows)
        self.plain = plain
        self.rule, self.by_rule = rule, by_rule

    def takes_by_rule(self, key) -> bool:
        """Whether the rule, and not a row, gives ``key`` its design."""
        return (self.rule is not None and not dict.__contains__(self, key)
                and self.rule(*key))

    def __missing__(self, key):
        return self.by_rule if self.takes_by_rule(key) else self.plain

    def __contains__(self, key):
        return dict.__contains__(self, key) or self.takes_by_rule(key)


_PERSISTENT = FwdDesign("persistent", "flash_fwd_persistent",
                        "ray_tpu_flash_fwd_persistent", 64, 64)
_TF32X3 = FwdDesign("tf32x3", "flash_fwd_f32", "ray_tpu_flash_fwd_f32", 64, 64)
_D64 = FwdDesign("d64", "flash_fwd_d64", "ray_tpu_flash_fwd_d64", 128, 128, schedule=True)
#: d a runtime argument: 64 q rows by 32 kv rows in every dtype
_DCLUSTER = FwdDesign("dcluster", "flash_fwd_dcluster", "ray_tpu_flash_fwd_dcluster", 64, 32)
#: head_dims 384 to 768 in every dtype: dcluster's exchange over clusters of
#: d / 128 CTAs, the same 64 x 32 tiles. It read fastest at every one of
#: those rows in bf16 and float32, against ``dcluster`` at its own
#: 256-column plan and the designs before (``flash_fwd_wide.cu``,
#: ``flash_fwd_f32.cu``), in one alternating run of
#: ``ops/flash_fwd_variants.py --wide`` on an H100 (PERF.md §6); float16
#: takes bf16's
_DCLUSTER128 = FwdDesign("dcluster128", "flash_fwd_dcluster128",
                         "ray_tpu_flash_fwd_dcluster128", 64, 32)
#: no kernel: the reference's own route for the input (``plain_attention_with_lse``),
#: at the reference's tiles where it takes its kernel
_PLAIN = FwdDesign("plain", None, None, REF_BLOCK, REF_BLOCK)


def dsplit_takes(head_dim: int, dtype: torch.dtype) -> bool:
    """The rule of both dispatch tables: it takes every head_dim that is a
    multiple of 128 from ``DSPLIT_MIN_D`` up, in bf16, float16 and float32,
    to the forward's and the backward's ``dcluster``."""
    return head_dim >= DSPLIT_MIN_D and head_dim % 128 == 0 and dtype in _DTYPE_CODES


def _wgmma(block_k: int) -> FwdDesign:
    return FwdDesign("wgmma", "flash_fwd_wgmma", "ray_tpu_flash_fwd_wgmma", 128, block_k)


#: the forward's dispatch table, keyed on (head_dim, dtype): the kernel each
#: input launches on the card and the tiles the plain version repeats. Every
#: design but ``plain`` is a hand-written kernel; a launch that the kernel
#: refuses raises. float32 runs 3xTF32 on the tensor cores
#: (``flash_fwd_f32.cu`` up to 256),
#: bf16 and float16 at head_dim 64 ``flash_fwd_d64.cu`` (a persistent grid;
#: the wgmma kernel it took over from is timed beside it by
#: ``ops/flash_fwd_variants.py --d64``), at 128 and 256 ``flash_fwd_wgmma.cu``;
#: all three dtypes at 384, 512, 640 and 768 ``flash_fwd_dcluster128.cu``
#: (``flash_fwd_variants --wide`` times it beside ``flash_fwd_wide.cu`` and
#: ``flash_fwd_f32.cu``, the designs before, and ``flash_fwd_dcluster.cu``'s
#: 256-column plan); by the rule
#: (``dsplit_takes``) every multiple of 128 from 896 up, in all three
#: dtypes, ``flash_fwd_dcluster.cu`` (``flash_fwd_variants --dsplit`` times
#: it beside ``flash_fwd_dsplit.cu``, the design before). Every other key,
#: the other head_dims outside ``HEAD_DIMS`` and float16 at 16 and 32 among
#: them, takes ``plain``. Neither kernel of ``flash_fwd.cu`` is on a path:
#: its float32 one (CUDA cores) ``ops/flash_fwd_f32_variants.py`` times
#: beside ``flash_fwd_f32.cu``, its bf16 one (mma.sync)
#: ``ops/flash_fwd_variants.py --small-d`` beside ``flash_fwd_persistent.cu``.
FWD_DESIGNS = DesignTable({
    **{(d, torch.float32): _TF32X3 for d in HEAD_DIMS if d not in WIDE_HEAD_DIMS},
    (16, torch.bfloat16): _PERSISTENT,
    (32, torch.bfloat16): _PERSISTENT,
    **{(64, dt): _D64 for dt in (torch.bfloat16, torch.float16)},
    **{(128, dt): _wgmma(128) for dt in (torch.bfloat16, torch.float16)},
    **{(256, dt): _wgmma(80) for dt in (torch.bfloat16, torch.float16)},
    **{(d, dt): _DCLUSTER128 for d in WIDE_HEAD_DIMS for dt in _DTYPE_CODES},
}, _PLAIN, dsplit_takes, _DCLUSTER)

_BWD_PERSISTENT = BwdDesign(
    BwdKernel("persistent", "flash_bwd_persistent", "ray_tpu_flash_bwd_dq_persistent"),
    BwdKernel("persistent", "flash_bwd_persistent", "ray_tpu_flash_bwd_dkv_persistent"))
_BWD_WGMMA = BwdDesign(BwdKernel("wgmma", "flash_bwd_wgmma", "ray_tpu_flash_bwd_dq_wgmma"),
                       BwdKernel("wgmma", "flash_bwd_wgmma", "ray_tpu_flash_bwd_dkv_wgmma"))
_BWD_D64 = BwdDesign(BwdKernel("d64", "flash_bwd_d64", "ray_tpu_flash_bwd_dq_d64", schedule=True),
                     BwdKernel("d64", "flash_bwd_d64", "ray_tpu_flash_bwd_dkv_d64"))
_BWD_WIDE = BwdDesign(BwdKernel("wide", "flash_bwd_wide", "ray_tpu_flash_bwd_dq_wide"),
                      BwdKernel("wide", "flash_bwd_wide", "ray_tpu_flash_bwd_dkv_wide"))
_BWD_TF32X3 = BwdDesign(BwdKernel("tf32x3", "flash_bwd_f32", "ray_tpu_flash_bwd_dq_f32"),
                        BwdKernel("tf32x3", "flash_bwd_f32", "ray_tpu_flash_bwd_dkv_f32"))
_BWD_DCLUSTER = BwdDesign(
    BwdKernel("dcluster", "flash_bwd_dcluster", "ray_tpu_flash_bwd_dq_dcluster"),
    BwdKernel("dcluster", "flash_bwd_dcluster", "ray_tpu_flash_bwd_dkv_dcluster"))
#: float32 at 384 to 768: dcluster's exchange over 128-column groups, the
#: operands split into TF32 big and small once
_BWD_DCLUSTER128 = BwdDesign(
    BwdKernel("dcluster128", "flash_bwd_dcluster128", "ray_tpu_flash_bwd_dq_dcluster128"),
    BwdKernel("dcluster128", "flash_bwd_dcluster128", "ray_tpu_flash_bwd_dkv_dcluster128"))
_BWD_PLAIN = BwdDesign(BwdKernel("plain", None, None), BwdKernel("plain", None, None))

#: the backward's dispatch table, keyed on (head_dim, dtype): the kernels each
#: input launches on the card. bf16 and float16 at 128 and 256 run
#: ``flash_bwd_wgmma.cu`` (at 256 its dK/dV kernel splits dV and dK between
#: its warpgroups); at 64 ``flash_bwd_d64.cu``'s dQ (a persistent grid over
#: 128-row q tiles) and dK/dV (128-row Q and dO tiles; the
#: wgmma pair they took over from is timed beside them by
#: ``ops/flash_bwd_variants.py --d64``); bf16 at 16 and 32 runs
#: ``flash_bwd_persistent.cu``; bf16 and float16 at 384, 512, 640 and 768
#: ``flash_bwd_wide.cu``; float32 runs 3xTF32 on the tensor cores
#: (``flash_bwd_f32.cu``), at 384, 512, 640 and 768 ``flash_bwd_dcluster128.cu``
#: (``flash_bwd_variants --wide-f32`` times it beside ``flash_bwd_f32.cu``,
#: the design before, and ``flash_bwd_dcluster.cu``'s 256-column plan); by
#: the rule every multiple of 128 from 896 up, in
#: all three dtypes, ``flash_bwd_dcluster.cu`` (``flash_bwd_variants
#: --dsplit`` times it beside ``flash_bwd_dsplit.cu``, the design before,
#: in float32 and bf16). Every other key takes
#: ``plain``: the gradient of the reference's own route. No kernel of
#: ``flash_bwd.cu`` is on a path:
#: ``ops/flash_bwd_f32_variants.py`` times its float32 ones (CUDA cores)
#: beside ``flash_bwd_f32.cu``, ``ops/flash_bwd_variants.py --small-d`` its
#: bf16 ones (mma.sync) beside ``flash_bwd_persistent.cu``.
BWD_DESIGNS = DesignTable({
    **{(d, torch.float32): _BWD_TF32X3 for d in HEAD_DIMS},
    **{(d, torch.float32): _BWD_DCLUSTER128 for d in WIDE_HEAD_DIMS},
    **{(d, torch.bfloat16): _BWD_PERSISTENT for d in (16, 32)},
    **{(64, dt): _BWD_D64 for dt in (torch.bfloat16, torch.float16)},
    **{(d, dt): _BWD_WGMMA for d in (128, 256) for dt in (torch.bfloat16, torch.float16)},
    **{(d, dt): _BWD_WIDE for d in WIDE_HEAD_DIMS for dt in (torch.bfloat16, torch.float16)},
}, _BWD_PLAIN, dsplit_takes, _BWD_DCLUSTER)

#: launches of each kernel, counted where it is launched; a launch counts in
#: its kernel's total (flash_fwd, flash_bwd_dq, flash_bwd_dkv) and in its
#: design's count (the plain design's "launch" is its computation on a CUDA
#: tensor)
flash_fwd_launches = 0
flash_fwd_wgmma_launches = 0
flash_fwd_d64_launches = 0
flash_fwd_persistent_launches = 0
flash_fwd_tf32x3_launches = 0
flash_fwd_dcluster_launches = 0
flash_fwd_dcluster128_launches = 0
flash_fwd_plain_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dq_wgmma_launches = 0
flash_bwd_dq_d64_launches = 0
flash_bwd_dq_persistent_launches = 0
flash_bwd_dq_wide_launches = 0
flash_bwd_dq_tf32x3_launches = 0
flash_bwd_dq_dcluster_launches = 0
flash_bwd_dq_dcluster128_launches = 0
flash_bwd_dq_plain_launches = 0
flash_bwd_dkv_launches = 0
flash_bwd_dkv_wgmma_launches = 0
flash_bwd_dkv_d64_launches = 0
flash_bwd_dkv_persistent_launches = 0
flash_bwd_dkv_wide_launches = 0
flash_bwd_dkv_tf32x3_launches = 0
flash_bwd_dkv_dcluster_launches = 0
flash_bwd_dkv_dcluster128_launches = 0
flash_bwd_dkv_plain_launches = 0
#: the same launches by head_dim: "<kernel>_<design>_d<head_dim>" -> launches,
#: counted with the design's count
launches_by_head_dim: collections.Counter = collections.Counter()


def fwd_tiles(head_dim: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(block_q, block_k) of the forward design that ``FWD_DESIGNS`` names
    for this head_dim and dtype: the one source of the tiles, read by the
    wrapper, the CPU path and the plain version (``dcluster``'s 64 x 32 for
    every key of the rule). A (head_dim, dtype) that no kernel takes gets
    the plain design's, the reference's 512 x 512."""
    design = FWD_DESIGNS[(head_dim, dtype)]
    return design.block_q, design.block_k


# the forward designs that take the row max of the raw scores and fold the
# scale into exp2 after it, so take a positive scale (``_positive_scale``)
_POSITIVE_SCALE = ("wgmma", "persistent", "d64", "dcluster", "dcluster128")


def _positive_scale(q: torch.Tensor, scale: float) -> Tuple[torch.Tensor, float]:
    """(q', scale') with scale' > 0 and scale' * q' K^T = scale * q K^T
    exactly, for the forward kernels that take a positive scale: (-q, -scale)
    for a negative scale, (zeros, 1) for 0 (a NaN scale stays, and the
    kernel refuses it)."""
    if scale > 0 or scale != scale:
        return q, scale
    if scale == 0:
        return torch.zeros_like(q), 1.0
    return torch.neg(q), -scale


def reference_takes_kernel(head_dim: int, t_q: int, t_kv: int) -> bool:
    """Whether the reference's dispatcher, on its accelerator, sends these
    inputs to its Pallas kernel (head_dim a multiple of 128 or 64, both
    lengths multiples of 8; ``ray_tpu/ops/attention.py:575-581``) rather
    than to ``_attention_xla``."""
    return (head_dim % 128 == 0 or head_dim == 64) and t_q % 8 == 0 and t_kv % 8 == 0


def _design(table: DesignTable, q: torch.Tensor, t_kv: int):
    """The design of ``table`` that runs q [b, h, t_q, d] against t_kv keys:
    the table's for (d, q's dtype), except that a key of the rule runs its
    kernel only where the reference runs its Pallas kernel
    (``reference_takes_kernel``) and elsewhere the reference's own route,
    the ``plain`` design's ``_attention_plain``, as the reference does."""
    d, t_q = q.shape[-1], q.shape[-2]
    key = (d, q.dtype)
    if table.takes_by_rule(key) and not reference_takes_kernel(d, t_q, t_kv):
        return table.plain
    return table[key]


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _causal_mask(t_q: int, t_kv: int, device) -> torch.Tensor:
    q_pos = torch.arange(t_q, device=device)[:, None] + (t_kv - t_q)
    return q_pos >= torch.arange(t_kv, device=device)[None, :]


def _plain_scores(q, k, causal: bool, scale: float, segment_ids=None) -> torch.Tensor:
    """The float32 scores scale * Q K^T [b, h, t_q, t_kv], masked to NEG_INF
    under the causal mask (q the suffix of kv) and across segments."""
    t_q, t_kv = q.shape[-2], k.shape[-2]
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _causal_mask(t_q, t_kv, q.device)[None, None] if causal else None
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    return logits


def _attention_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Softmax attention over the whole [t_q, t_kv] score matrix (the
    reference's ``_attention_xla``). Scores are float32; a row that sees no
    key gets uniform weights, as the reference's softmax gives it."""
    scale = scale if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    logits = _plain_scores(q, k, causal, scale, segment_ids)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


def plain_attention_with_lse(q, k, v, *, causal: bool, scale: float,
                             block_q: Optional[int] = None,
                             block_k: Optional[int] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out in q's dtype, lse [b, h, t_q] float32) of the plain design: the
    reference's own route for these inputs, in plain PyTorch on the tensors'
    device. Where the reference takes its kernel (``reference_takes_kernel``)
    it is ``flash_attention_fwd_plain`` at the reference's tiles
    (``block_q``/``block_k``, by default ``REF_BLOCK``); elsewhere it is
    ``_attention_plain`` (the reference's ``_attention_xla``), with lse the
    logsumexp of its masked scores."""
    d, t_q, t_kv = q.shape[-1], q.shape[-2], k.shape[-2]
    if reference_takes_kernel(d, t_q, t_kv):
        return _flash_fwd_tiled(
            q, k, v, causal=causal, scale=scale,
            block_q=REF_BLOCK if block_q is None else block_q,
            block_k=REF_BLOCK if block_k is None else block_k)
    logits = _plain_scores(q, k, causal, scale)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, v)
    return out, torch.logsumexp(logits, dim=-1)


def plain_attention_bwd(q, k, v, o, lse, do, *, causal: bool, scale: float,
                        dlse: Optional[torch.Tensor] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of ``plain_attention_with_lse`` under the cotangents
    ``do`` of out and ``dlse`` of lse: ``flash_attention_bwd_plain`` where
    the reference takes its kernel, else autograd through the recomputed
    ``_attention_plain`` route (the gradient the reference's autodiff takes
    through ``_attention_xla``)."""
    if reference_takes_kernel(q.shape[-1], q.shape[-2], k.shape[-2]):
        return flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale,
                                         dlse=dlse)
    with torch.enable_grad():
        qg, kg, vg = (t.detach().requires_grad_() for t in (q, k, v))
        out, lse_g = plain_attention_with_lse(qg, kg, vg, causal=causal, scale=scale)
        outs, grads = (out,), (do,)
        if dlse is not None:
            outs, grads = (out, lse_g), (do, dlse)
        return torch.autograd.grad(outs, (qg, kg, vg), grads)


def attention_with_lse(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = False,
    scale: Optional[float] = None,
    kv_offset=0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, logsumexp) over [b, h, t_q, d], the merge-ready block primitive.
    ``kv_offset`` is the global position of k/v's first row when the block is
    a slice of a longer sequence; with the default, a shorter q is the
    suffix of the context (chunked-prefill layout)."""
    t_q, d = q.shape[-2:]
    t_kv = k.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    if causal:
        if isinstance(kv_offset, int) and kv_offset == 0:
            q_pos = torch.arange(t_q, device=q.device)[:, None] + (t_kv - t_q)
        else:
            q_pos = torch.arange(t_q, device=q.device)[:, None]
        k_pos = kv_offset + torch.arange(t_kv, device=q.device)[None, :]
        logits = torch.where((q_pos >= k_pos)[None, None], logits, NEG_INF)
    lse = torch.logsumexp(logits, dim=-1)
    out = torch.einsum(
        "bhqk,bhkd->bhqd", torch.exp(logits - lse[..., None]).to(v.dtype), v
    )
    return out, lse


def merge_attention(o, lse, o_new, lse_new, valid=True):
    """Online-softmax merge of two normalized partial attentions (o in f32,
    lse from ``attention_with_lse``): the one logaddexp rule that ring and
    blockwise attention share."""
    valid = torch.as_tensor(valid, device=lse.device)
    lse_out = torch.where(valid, torch.logaddexp(lse, lse_new), lse)
    w_old = torch.exp(lse - lse_out)[..., None]
    w_new = torch.where(valid, torch.exp(lse_new - lse_out), 0.0)[..., None]
    return o * w_old + o_new.float() * w_new, lse_out


def _chunk_update(o, lse, q, k_c, v_c, kv_offset, causal: bool, scale: float):
    o_c, lse_c = attention_with_lse(q, k_c, v_c, causal=causal, scale=scale,
                                    kv_offset=kv_offset)
    return merge_attention(o, lse, o_c, lse_c)


def blockwise_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    chunk: int = 512,
) -> torch.Tensor:
    """Attention without a kernel and without the full [b, h, t_q, t_kv]
    logits (the reference's XLA-only ``blockwise_attention``): a loop over
    kv chunks of ``chunk`` rows with the online-softmax carry
    (``attention_with_lse`` and ``merge_attention``), each chunk recomputed
    in the backward (``torch.utils.checkpoint``) while grad is enabled, so
    one [b, h, t_q, chunk] block lives at a time. q rows are the suffix of
    the context. Where ``t_kv % chunk != 0 or t_kv <= chunk`` it computes
    ``_attention_plain``, as the reference does. Plain PyTorch on every
    device."""
    b, h, t_q, d = q.shape
    t_kv = k.shape[-2]
    scale_val = float(scale) if scale is not None else 1.0 / math.sqrt(d)
    if t_kv % chunk != 0 or t_kv <= chunk:
        return _attention_plain(q, k, v, causal=causal, scale=scale_val)
    q_off = t_kv - t_q
    o = torch.zeros(b, h, t_q, d, dtype=torch.float32, device=q.device)
    lse = torch.full((b, h, t_q), NEG_INF, dtype=torch.float32, device=q.device)
    for c0 in range(0, t_kv, chunk):
        # a tensor offset: the chunk's rows are global positions, never the
        # suffix rule that attention_with_lse takes for an int offset of 0
        args = (o, lse, q, k[:, :, c0:c0 + chunk], v[:, :, c0:c0 + chunk],
                torch.tensor(c0 - q_off, device=q.device), causal, scale_val)
        if torch.is_grad_enabled():
            o, lse = checkpoint(_chunk_update, *args, use_reentrant=False,
                                preserve_rng_state=False)
        else:
            o, lse = _chunk_update(*args)
    return o.to(q.dtype)


def flash_attention_fwd_plain(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    scale: float,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The TPU flash forward's algorithm in plain PyTorch: (out in q's dtype,
    lse [b, h, t_q] float32).

    Tiles are ``min(block_q, t_q)`` by ``min(block_k, t_kv)``; by default
    ``block_q`` and ``block_k`` are the card kernel's (``fwd_tiles`` of q's
    head_dim and dtype). For each kv
    tile, every q row updates its running max m, denominator l and float32
    accumulator, unless the row's q tile skips the kv tile (causal, wholly
    above the diagonal). Padded kv columns of a ragged last tile are masked
    and V there is zero. A row whose processed columns are all masked keeps
    m at NEG_INF, so each of those columns gets p = exp(0) = 1: its output
    is the mean of V over the processed tiles' valid rows, divided by the
    count of processed columns, and its lse is about NEG_INF. Only tiles that
    are skipped wholly contribute nothing; a row of a q tile that processes
    nothing gets 0 and NEG_INF (denominator 1 where l == 0)."""
    return _flash_fwd_tiled(q, k, v, causal=causal, scale=scale, block_q=block_q,
                            block_k=block_k)


def _qk(q: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhqd,bhkd->bhqk", q, k)


def _pv(p: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return torch.einsum("bhqk,bhkd->bhqd", p, v)


def _flash_fwd_tiled(q, k, v, *, causal: bool, scale: float, block_q: Optional[int] = None,
                     block_k: Optional[int] = None, qk=_qk, pv=_pv
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd_plain``'s algorithm with its two products
    given: ``qk(q, k)`` for each tile's scores Q K^T and ``pv(p, v)`` for
    P V, both over float32 [b, h, rows, d] tiles (by default float32
    einsums; ``ops/tf32.py`` passes 3xTF32 products)."""
    b, h, t_q, d = q.shape
    t_kv = k.shape[-2]
    tiles = fwd_tiles(d, q.dtype)
    block_q = tiles[0] if block_q is None else block_q
    block_k = tiles[1] if block_k is None else block_k
    bq, bk = min(block_q, t_q), min(block_k, t_kv)
    nq, nk = -(-t_q // bq), -(-t_kv // bk)
    rows = nq * bq
    qf = torch.zeros(b, h, rows, d, dtype=torch.float32, device=q.device)
    qf[:, :, :t_q] = q.float()
    kf = torch.zeros(b, h, nk * bk, d, dtype=torch.float32, device=q.device)
    vf = torch.zeros_like(kf)
    kf[:, :, :t_kv] = k.float()
    vf[:, :, :t_kv] = v.float()
    off = t_kv - t_q
    row = torch.arange(rows, device=q.device)
    q_pos = row + off
    tile_last = (row // bq) * bq + bq - 1 + off  # the skip test's left side
    m = torch.full((b, h, rows), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros_like(qf)
    for ki in range(nk):
        ks = kf[:, :, ki * bk:(ki + 1) * bk]
        vs = vf[:, :, ki * bk:(ki + 1) * bk]
        s = qk(qf, ks) * scale
        k_pos = ki * bk + torch.arange(bk, device=q.device)
        if causal:
            s = torch.where(q_pos[:, None] >= k_pos[None, :], s, NEG_INF)
        if t_kv % bk:
            s = torch.where(k_pos < t_kv, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        alpha = torch.exp(m - m_new)
        p = torch.exp(s - m_new[..., None])
        l_new = alpha * l + p.sum(dim=-1)
        acc_new = acc * alpha[..., None] + pv(p, vs)
        if causal:
            run = tile_last >= ki * bk  # [rows]: the row's q tile runs ki
            m = torch.where(run, m_new, m)
            l = torch.where(run, l_new, l)
            acc = torch.where(run[:, None], acc_new, acc)
        else:
            m, l, acc = m_new, l_new, acc_new
    denom = torch.where(l == 0.0, 1.0, l)
    out = (acc / denom[..., None])[:, :, :t_q].to(q.dtype)
    lse = (m + torch.log(denom))[:, :, :t_q]
    return out, lse


def flash_attention_bwd_plain(
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
    """(dq, dk, dv) of the flash forward, in the dtypes of q, k and v: the
    arithmetic of the TPU backward kernels (``_flash_bwd_dq_kernel`` and
    ``_flash_bwd_dkv_kernel``) in float32 (float64 for float64 inputs), over
    the whole score matrix.

    P = exp(S - lse) is recomputed from the forward's lse, with S masked to
    NEG_INF under the causal mask (q the suffix of kv); delta = rowsum(dO * O);
    dP = dO V^T, dS = P * (dP - delta) * scale; dq = dS K, dk = dS^T Q,
    dv = P^T dO. With ``dlse``, the gradient of lse [b, h, t_q], delta is
    rowsum(dO * O) - dlse: since d lse / dS = P, dS = P * (dP - delta + dlse)
    (the kernels take it the same way, through their delta input). Where ``causal and t_q > t_kv``, rows whose lse is at most
    NEG_INF / 2 (rows that see no key) get P = 0: they add nothing to dk and
    dv, and their dq is 0, whatever the forward gave them.

    The kernels' other edge rules leave nothing to do here. A masked column
    has P = exp(NEG_INF - lse) = 0 on every row the guard keeps, so a causal
    tile that is skipped, a padded kv column of a ragged last tile (where the
    dQ pass zeroes K and V) and a padded q row of a ragged last tile (where
    the dK/dV pass zeroes Q, dO, P and dS) add exactly 0 in the tiled
    kernels as well. Under that guard the result does not depend on the tile
    size, apart from the order of summation."""
    t_q, t_kv = q.shape[-2], k.shape[-2]
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qf, kf, vf, dof = (x.to(acc) for x in (q, k, v, do))
    delta = (dof * o.to(acc)).sum(-1)
    if dlse is not None:
        delta = delta - dlse.to(acc)
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        s = torch.where(_causal_mask(t_q, t_kv, q.device), s, NEG_INF)
    p = torch.exp(s - lse.to(acc)[..., None])
    if causal and t_q > t_kv:
        p = torch.where(lse[..., None] > NEG_INF / 2, p, 0.0)
    dp = torch.einsum("bhqd,bhkd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None]) * scale
    dq = torch.einsum("bhqk,bhkd->bhqd", ds, kf)
    dk = torch.einsum("bhqk,bhqd->bhkd", ds, qf)
    dv = torch.einsum("bhqk,bhqd->bhkd", p, dof)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


# ---------------------------------------------------------------------------
# the Hopper kernels
# ---------------------------------------------------------------------------


# each source's entry points, with their count of leading pointers, and its
# error-string function; every entry point then takes bh, t_q, t_kv, d,
# dtype, causal, scale and the stream (the d64 forward's sixth pointer and
# the d64 dQ's eighth are their item counters)
_SOURCES = {
    "flash_fwd": ({"ray_tpu_flash_fwd": 5}, "ray_tpu_cuda_error_string"),
    "flash_fwd_wgmma": ({"ray_tpu_flash_fwd_wgmma": 5},
                        "ray_tpu_flash_fwd_wgmma_error_string"),
    "flash_fwd_d64": ({"ray_tpu_flash_fwd_d64": 6}, "ray_tpu_flash_fwd_d64_error_string"),
    "flash_fwd_persistent": ({"ray_tpu_flash_fwd_persistent": 5},
                             "ray_tpu_flash_fwd_persistent_error_string"),
    "flash_fwd_f32": ({"ray_tpu_flash_fwd_f32": 5}, "ray_tpu_flash_fwd_f32_error_string"),
    "flash_fwd_wide": ({"ray_tpu_flash_fwd_wide": 5}, "ray_tpu_flash_fwd_wide_error_string"),
    "flash_bwd": ({"ray_tpu_flash_bwd_dq": 7, "ray_tpu_flash_bwd_dkv": 8},
                  "ray_tpu_flash_bwd_error_string"),
    "flash_bwd_wgmma": ({"ray_tpu_flash_bwd_dq_wgmma": 7, "ray_tpu_flash_bwd_dkv_wgmma": 8},
                        "ray_tpu_flash_bwd_wgmma_error_string"),
    "flash_bwd_d64": ({"ray_tpu_flash_bwd_dq_d64": 8, "ray_tpu_flash_bwd_dkv_d64": 8},
                      "ray_tpu_flash_bwd_d64_error_string"),
    "flash_bwd_persistent": ({"ray_tpu_flash_bwd_dq_persistent": 7,
                              "ray_tpu_flash_bwd_dkv_persistent": 8},
                             "ray_tpu_flash_bwd_persistent_error_string"),
    "flash_bwd_f32": ({"ray_tpu_flash_bwd_dq_f32": 7, "ray_tpu_flash_bwd_dkv_f32": 8},
                      "ray_tpu_flash_bwd_f32_error_string"),
    "flash_bwd_wide": ({"ray_tpu_flash_bwd_dq_wide": 7, "ray_tpu_flash_bwd_dkv_wide": 8},
                       "ray_tpu_flash_bwd_wide_error_string"),
    "flash_fwd_dsplit": ({"ray_tpu_flash_fwd_dsplit": 5}, "ray_tpu_flash_fwd_dsplit_error_string"),
    "flash_fwd_dcluster": ({"ray_tpu_flash_fwd_dcluster": 5},
                           "ray_tpu_flash_fwd_dcluster_error_string"),
    "flash_fwd_dcluster128": ({"ray_tpu_flash_fwd_dcluster128": 5},
                              "ray_tpu_flash_fwd_dcluster128_error_string"),
    "flash_bwd_dsplit": ({"ray_tpu_flash_bwd_dq_dsplit": 7, "ray_tpu_flash_bwd_dkv_dsplit": 8},
                         "ray_tpu_flash_bwd_dsplit_error_string"),
    "flash_bwd_dcluster": ({"ray_tpu_flash_bwd_dq_dcluster": 7,
                            "ray_tpu_flash_bwd_dkv_dcluster": 8},
                           "ray_tpu_flash_bwd_dcluster_error_string"),
    "flash_bwd_dcluster128": ({"ray_tpu_flash_bwd_dq_dcluster128": 7,
                               "ray_tpu_flash_bwd_dkv_dcluster128": 8},
                              "ray_tpu_flash_bwd_dcluster128_error_string"),
}
_C_TAIL = [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]


def _kernel_lib(name: str) -> ctypes.CDLL:
    """``csrc/<name>.cu`` built and loaded, its functions' types set."""
    entries, error_fn = _SOURCES[name]
    lib = _build.load(name)
    for fn_name, n_ptr in entries.items():
        fn = getattr(lib, fn_name)
        if fn.argtypes is None:
            fn.argtypes = [ctypes.c_void_p] * n_ptr + _C_TAIL
            fn.restype = ctypes.c_int
    err = getattr(lib, error_fn)
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return lib


def _launch(name: str, entry: str, tensors, q, t_kv: int, causal: bool,
            scale: float) -> None:
    """Launch ``entry`` of ``csrc/<name>.cu`` on the current stream over
    ``tensors`` (pointers in the C function's order) and raise if the launch
    was refused."""
    lib = _kernel_lib(name)
    b, h, t_q, d = q.shape
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = getattr(lib, entry)(
            *(t.data_ptr() for t in tensors), b * h, t_q, t_kv, d,
            _DTYPE_CODES[q.dtype], int(bool(causal)), float(scale), stream,
        )
    if err != 0:
        msg = getattr(lib, _SOURCES[name][1])(err).decode()
        raise RuntimeError(f"{entry} launch failed ({err}): {msg}")


def _check_kernel_inputs(q, k, v, *same_as_q, rows=()) -> None:
    """Raise ``ValueError`` unless the kernels take these tensors: plain
    tensors (not DTensors) on CUDA, contiguous, 16-byte aligned; q [b, h, t_q, d] and k, v [b, h, t_kv, d]
    of one dtype (bfloat16, float32 or float16), t_q and t_kv not 0; each of
    ``same_as_q`` (o, do) like q; each of ``rows`` (lse, delta) float32
    [b, h, t_q]. The head_dim is the dispatch table's to take or leave, and
    the grid each launcher's."""
    named = [("q", q), ("k", k), ("v", v)] + list(same_as_q) + list(rows)
    for name, t in named:
        if type(t) is not torch.Tensor:
            # a DTensor (or another subclass) has no storage of its own: the
            # kernel would read raw pointers of memory it does not describe
            raise ValueError(f"{name} is a {type(t).__name__}; the kernel takes a "
                             f"plain tensor (a DTensor's to_local())")
        if t.device.type != "cuda":
            raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.data_ptr() % 16:
            raise ValueError(f"{name} must be 16-byte aligned")
    for name, t in named[:3] + list(same_as_q):
        if t.dim() != 4:
            raise ValueError(f"{name} must be a [b, h, t, d] tensor")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise ValueError(
                f"q, k, v must share a dtype in {list(_DTYPE_CODES)}; "
                f"{name} is {t.dtype}"
            )
    b, h, t_q, d = q.shape
    t_kv = k.shape[2]
    if k.shape != (b, h, t_kv, d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {q.shape} k {k.shape} v {v.shape}")
    for name, t in same_as_q:
        if t.shape != q.shape:
            raise ValueError(f"{name} {tuple(t.shape)} must match q {tuple(q.shape)}")
    for name, t in rows:
        if t.dtype != torch.float32 or t.shape != (b, h, t_q):
            raise ValueError(f"{name} must be float32 [b, h, t_q] = {(b, h, t_q)}")
    if t_q == 0 or t_kv == 0:
        raise ValueError(f"unsupported shape q {tuple(q.shape)} k {tuple(k.shape)}")


def _check_tiles(design: FwdDesign, head_dim: int, block_q, block_k) -> None:
    """Raise ``ValueError`` unless ``block_q`` and ``block_k`` (None for
    the design's own) are the design's tiles."""
    asked = (design.block_q if block_q is None else block_q,
             design.block_k if block_k is None else block_k)
    if asked != (design.block_q, design.block_k):
        raise ValueError(
            f"the {design.name} flash kernel's tiles at head_dim {head_dim} are "
            f"{design.block_q}x{design.block_k}, got {asked[0]}x{asked[1]}")


# each design's entry point that reports the tiles its built kernel
# computes with
_TILES_ENTRIES = {"wgmma": "ray_tpu_flash_fwd_wgmma_tiles",
                  "d64": "ray_tpu_flash_fwd_d64_tiles",
                  "persistent": "ray_tpu_flash_fwd_persistent_tiles",
                  "tf32x3": "ray_tpu_flash_fwd_f32_tiles",
                  "dcluster": "ray_tpu_flash_fwd_dcluster_tiles",
                  "dcluster128": "ray_tpu_flash_fwd_dcluster128_tiles"}


def _check_design(design: FwdDesign, head_dim: int) -> None:
    """Raise ``RuntimeError`` unless the built kernel computes with the
    table's tiles at this head_dim."""
    tiles_fn = getattr(_kernel_lib(design.source), _TILES_ENTRIES[design.name])
    tiles_fn.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_int),
                         ctypes.POINTER(ctypes.c_int)]
    tiles_fn.restype = ctypes.c_int
    bq, bk = ctypes.c_int(), ctypes.c_int()
    err = tiles_fn(head_dim, ctypes.byref(bq), ctypes.byref(bk))
    if err != 0 or (bq.value, bk.value) != (design.block_q, design.block_k):
        raise RuntimeError(
            f"{design.source}.cu computes with {bq.value}x{bk.value} tiles at "
            f"head_dim {head_dim} (status {err}); FWD_DESIGNS says "
            f"{design.block_q}x{design.block_k}")


# each cluster source's plan entry point and the shared memory it reports
# after (group columns, CTAs a cluster, passes): the plan's fields
_PLAN_ENTRIES = {"flash_fwd_dcluster": ("ray_tpu_flash_fwd_dcluster_plan", ("smem_fwd",)),
                 "flash_fwd_dcluster128": ("ray_tpu_flash_fwd_dcluster128_plan",
                                           ("smem_fwd",)),
                 "flash_bwd_dcluster": ("ray_tpu_flash_bwd_dcluster_plan",
                                        ("smem_dq", "smem_dkv")),
                 "flash_bwd_dcluster128": ("ray_tpu_flash_bwd_dcluster128_plan",
                                           ("smem_dq", "smem_dkv"))}
# each cluster source's plan in ops/dcluster.py (dcluster_plan where not named)
_PLAN_OF = {"flash_bwd_dcluster128": dcluster.dcluster128_plan,
            "flash_fwd_dcluster128": dcluster.dcluster128_fwd_plan}


def _check_dcluster_plan(source: str, head_dim: int, dtype: torch.dtype) -> None:
    """Raise ``RuntimeError`` unless the cluster kernels built from
    ``csrc/<source>.cu`` launch with their plan in ``ops/dcluster.py`` at
    this head_dim and dtype (group columns, CTAs a cluster, passes, shared
    memory: the forward's, or dQ's and dK/dV's)."""
    plan_of = _PLAN_OF.get(source, dcluster.dcluster_plan)
    plan = plan_of(head_dim, dtype)
    entry, smem = _PLAN_ENTRIES[source]
    want = (plan.group_cols, plan.cluster, plan.passes, *(getattr(plan, n) for n in smem))
    fn = getattr(_kernel_lib(source), entry)
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(want))()
    err = fn(head_dim, _DTYPE_CODES[dtype], out)
    if err != 0 or tuple(out) != want:
        raise RuntimeError(
            f"{source}.cu plans {tuple(out)} (group columns, cluster, passes, shared memory "
            f"{', '.join(smem)}) at head_dim {head_dim} {dtype} (status {err}); "
            f"{plan_of.__name__} says {want}")


def _on_cpu(*tensors) -> bool:
    return all(t.device.type == "cpu" for t in tensors)


def _check_plain_inputs(q, k, v, *more) -> None:
    """Raise ``ValueError`` unless the plain design takes these tensors: q,
    k, v and ``more`` on one device, q [b, h, t_q, d] and k, v [b, h, t_kv,
    d] of one floating dtype, and, on the card, no input that the reference
    sends to its Pallas kernel while no Hopper kernel takes its (head_dim,
    dtype): every head_dim the reference's kernel takes has a Hopper kernel
    in bf16, float16 and float32, so that leaves the other dtypes, for
    which the plain version does not stand in on the card."""
    if len({t.device for t in (q, k, v, *more)}) != 1:
        raise ValueError("q, k, v and the rest must lie on one device")
    if q.dim() != 4 or not q.is_floating_point() or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"q, k, v must be [b, h, t, d] of one floating dtype; got "
                         f"{q.dtype} {k.dtype} {v.dtype}")
    b, h, t_q, d = q.shape
    if k.shape != (b, h, k.shape[2], d) or v.shape != k.shape:
        raise ValueError(f"shape mismatch: q {q.shape} k {k.shape} v {v.shape}")
    if (not _on_cpu(q) and reference_takes_kernel(d, t_q, k.shape[2])
            and (d, q.dtype) not in FWD_DESIGNS):
        raise ValueError(f"no Hopper kernel takes {q.dtype} (the kernels take "
                         f"{', '.join(map(str, _DTYPE_CODES))}); the reference runs its "
                         f"Pallas kernel at head_dim {d} with these lengths")


def flash_attention_fwd(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool,
    scale: float,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, lse) of the flash forward: [b, h, t_q, d] in q's dtype and
    [b, h, t_q] float32, through the design ``FWD_DESIGNS`` names.

    The ``plain`` design (every (head_dim, dtype) without a hand-written
    kernel) computes ``plain_attention_with_lse``, at ``block_q`` x
    ``block_k`` where it takes the flash route, on the CPU or, where the
    reference's route is ``_attention_xla``, on the card, where it counts in
    ``flash_fwd_plain_launches`` (``_check_plain_inputs``). Otherwise CPU
    tensors take ``flash_attention_fwd_plain`` (at ``block_q`` x ``block_k``,
    by default the card kernel's tiles) and launch nothing, and CUDA tensors
    launch the design's hand-written Hopper kernel: contiguous q
    [b, h, t_q, d] and k, v [b, h, t_kv, d] of one dtype, the design's tiles
    (``block_q`` and ``block_k`` left at None or equal to them), any scale
    (``_positive_scale``) and a grid that the launcher takes. Anything else
    raises."""
    global flash_fwd_launches
    d = q.shape[-1]
    design = _design(FWD_DESIGNS, q, k.shape[2])
    on_cpu = _on_cpu(q, k, v)
    if design is _PLAIN:
        _check_plain_inputs(q, k, v)
        out, lse = plain_attention_with_lse(q, k, v, causal=causal, scale=scale,
                                            block_q=block_q, block_k=block_k)
        if not on_cpu:
            flash_fwd_launches += 1
            _count_design("flash_fwd", design.name, d)
        return out, lse
    if on_cpu:
        return flash_attention_fwd_plain(
            q, k, v, causal=causal, scale=scale, block_q=block_q, block_k=block_k)
    _check_tiles(design, d, block_q, block_k)
    _check_kernel_inputs(q, k, v)
    _check_design(design, d)
    if design.source in _PLAN_ENTRIES:
        _check_dcluster_plan(design.source, d, q.dtype)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    q_k, scale_k = _positive_scale(q, scale) if design.name in _POSITIVE_SCALE else (q, scale)
    tensors = (q_k, k, v, out, lse)
    if design.schedule:
        tensors += (torch.empty(1, dtype=torch.int32, device=q.device),)
    _launch(design.source, design.entry, tensors, q, k.shape[2], causal, scale_k)
    flash_fwd_launches += 1
    _count_design("flash_fwd", design.name, d)
    return out, lse


def flash_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32 [b, h, t_q], as the reference
    computes it outside its kernels; a ``flash_bwd_delta`` range for
    ``torch.profiler``."""
    with torch.profiler.record_function("flash_bwd_delta"):
        return (do.float() * o.float()).sum(-1)


def _bwd_kernel(kernel: str, q, k, v, do, lse, delta) -> BwdKernel:
    """The ``kernel`` ("dq" or "dkv") of the ``BWD_DESIGNS`` design for these
    inputs, after the checks every backward kernel needs; raises for inputs
    that no kernel takes."""
    _check_kernel_inputs(q, k, v, ("do", do), rows=(("lse", lse), ("delta", delta)))
    chosen = getattr(_design(BWD_DESIGNS, q, k.shape[2]), kernel)
    if chosen.source is None:
        raise ValueError(f"no {kernel} kernel takes head_dim {q.shape[-1]} {q.dtype}: the "
                         f"plain design computes it (flash_attention_bwd)")
    if chosen.source in _PLAN_ENTRIES:
        _check_dcluster_plan(chosen.source, q.shape[-1], q.dtype)
    return chosen


def _count_design(kernel: str, design: str, head_dim: int) -> None:
    """One more launch in ``<kernel>_<design>_launches`` and in
    ``launches_by_head_dim``."""
    globals()[f"{kernel}_{design}_launches"] += 1
    launches_by_head_dim[f"{kernel}_{design}_d{head_dim}"] += 1


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float
                 ) -> torch.Tensor:
    """dq from the dQ kernel of the design ``BWD_DESIGNS`` names (CUDA
    tensors only), counted in ``flash_bwd_dq_launches`` and the kernel's
    ``flash_bwd_dq_<design>_launches``."""
    global flash_bwd_dq_launches
    kernel = _bwd_kernel("dq", q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    tensors = (q, k, v, do, lse, delta, dq)
    if kernel.schedule:
        tensors += (torch.empty(1, dtype=torch.int32, device=q.device),)
    _launch(kernel.source, kernel.entry, tensors, q, k.shape[2], causal, scale)
    flash_bwd_dq_launches += 1
    _count_design("flash_bwd_dq", kernel.name, q.shape[-1])
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the dK/dV kernel of the design ``BWD_DESIGNS`` names
    (CUDA tensors only), counted in ``flash_bwd_dkv_launches`` and the
    kernel's ``flash_bwd_dkv_<design>_launches``."""
    global flash_bwd_dkv_launches
    kernel = _bwd_kernel("dkv", q, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(kernel.source, kernel.entry, (q, k, v, do, lse, delta, dk, dv),
            q, k.shape[2], causal, scale)
    flash_bwd_dkv_launches += 1
    _count_design("flash_bwd_dkv", kernel.name, q.shape[-1])
    return dk, dv


def flash_attention_bwd(
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
    """(dq, dk, dv) of the flash forward, given its out ``o``, its ``lse``,
    the gradient ``do`` of out and, where lse has one too, its gradient
    ``dlse`` (float32 [b, h, t_q]), through the design ``BWD_DESIGNS`` names.

    The ``plain`` design (wherever the forward takes it) computes
    ``plain_attention_bwd`` where the forward's plain design computes, and
    counts one dQ and one dK/dV launch of ``plain`` on CUDA tensors.
    Otherwise CPU tensors take
    ``flash_attention_bwd_plain`` and launch nothing, and CUDA tensors
    launch the design's two hand-written Hopper kernels, dQ then dK/dV,
    after delta = rowsum(dO * O) (minus ``dlse``): the inputs the forward
    kernel takes, with o and do like q (contiguous) and lse float32
    [b, h, t_q]. Anything else raises."""
    global flash_bwd_dq_launches, flash_bwd_dkv_launches
    design = _design(BWD_DESIGNS, q, k.shape[2])
    on_cpu = _on_cpu(q, k, v, o, lse, do)
    if design is _BWD_PLAIN:
        _check_plain_inputs(q, k, v, o, lse, do)
        grads = plain_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale,
                                    dlse=dlse)
        if not on_cpu:
            flash_bwd_dq_launches += 1
            flash_bwd_dkv_launches += 1
            _count_design("flash_bwd_dq", design.dq.name, q.shape[-1])
            _count_design("flash_bwd_dkv", design.dkv.name, q.shape[-1])
        return grads
    if on_cpu:
        return flash_attention_bwd_plain(
            q, k, v, o, lse, do, causal=causal, scale=scale, dlse=dlse)
    rows = (("lse", lse),) if dlse is None else (("lse", lse), ("dlse", dlse))
    _check_kernel_inputs(q, k, v, ("o", o), ("do", do), rows=rows)
    delta = flash_bwd_delta(o, do)
    if dlse is not None:
        delta = delta - dlse
    dq = flash_bwd_dq(q, k, v, do, lse, delta, causal=causal, scale=scale)
    dk, dv = flash_bwd_dkv(q, k, v, do, lse, delta, causal=causal, scale=scale)
    return dq, dk, dv


@torch.library.custom_op("ray_tpu_torch::flash_fwd", mutates_args=())
def flash_fwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
                 scale: float, block_q: Optional[int], block_k: Optional[int]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flash_attention_fwd`` as one operator, ``ray_tpu_torch.flash_fwd``,
    so that a selective-checkpoint policy can name it (``FLASH_FWD``) and
    keep its (out, lse): the op allocates both, so the cache holds the
    finished tensors and a recomputation that finds them launches nothing."""
    return flash_attention_fwd(
        q, k, v, causal=causal, scale=scale, block_q=block_q, block_k=block_k)


@flash_fwd_op.register_fake
def _flash_fwd_fake(q, k, v, causal, scale, block_q, block_k):
    return torch.empty_like(q), q.new_empty(q.shape[:3], dtype=torch.float32)


#: the forward's operator as a dispatch mode sees it
FLASH_FWD = torch.ops.ray_tpu_torch.flash_fwd.default


class FlashAttention(torch.autograd.Function):
    """Flash attention with its flash backward: the counterpart of the
    reference's ``flash_attention`` custom_vjp, and of its
    ``attention_with_lse`` differentiated in both outputs.

    ``FlashAttention.apply(q, k, v, causal, scale, block_q, block_k)`` gives
    ``(out, lse)``, the tiles None for the kernel's own (``fwd_tiles``). The
    forward is ``flash_fwd_op`` (``flash_attention_fwd``) and saves
    (q, k, v, out, lse); the backward is ``flash_attention_bwd`` on a
    contiguous copy of out's gradient and, where lse was used, lse's
    gradient, which the dQ and dK/dV kernels take through delta
    (delta - dlse). Both take the plain versions on CPU tensors and the
    Hopper kernels on CUDA tensors."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, scale: float,
                block_q: Optional[int] = None, block_k: Optional[int] = None):
        out, lse = flash_fwd_op(q, k, v, causal, scale, block_q, block_k)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale = causal, scale
        ctx.set_materialize_grads(False)
        return out, lse

    @staticmethod
    def backward(ctx, do, dlse):
        q, k, v, out, lse = ctx.saved_tensors
        do = torch.zeros_like(out) if do is None else do.contiguous()
        dq, dk, dv = flash_attention_bwd(
            q, k, v, out, lse, do, causal=ctx.causal, scale=ctx.scale,
            dlse=None if dlse is None else dlse.contiguous())
        return dq, dk, dv, None, None, None, None


def flash_attention_with_lse(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                             causal: bool, scale: Optional[float] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out [b, h, t_q, d] in q's dtype, lse [b, h, t_q] float32) of flash
    attention, with gradients for both (``FlashAttention``): the plain
    versions on CPU tensors, the Hopper kernels on CUDA tensors. It
    computes the function of ``attention_with_lse`` (q the suffix of kv
    under the causal mask) without the [b, h, t_q, t_kv] float32 scores."""
    scale_val = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    return FlashAttention.apply(q, k, v, causal, scale_val, None, None)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------


def dot_product_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    scale: Optional[float] = None,
    segment_ids: Optional[torch.Tensor] = None,
    block_q: Optional[int] = None,
    block_k: Optional[int] = None,
) -> torch.Tensor:
    """Attention over [batch, heads, seq, head_dim] inputs, differentiable.

    Goes through ``FlashAttention``: the plain versions on CPU tensors, the
    hand-written forward and backward kernels on CUDA tensors, at the
    kernel's tiles unless ``block_q``/``block_k`` say otherwise (the CPU
    path takes any; the card's kernel raises for other tiles), at any
    scale (every head_dim that the reference sends to its Pallas kernel has
    one in bf16, float16 and float32: ``HEAD_DIMS`` and, by the tables'
    rule, every multiple of 128 from ``DSPLIT_MIN_D`` up); every input that
    no kernel takes (another head_dim, float16 at 16 and 32) through the
    counted ``plain`` design, the reference's own route (on the card only
    where that route is ``_attention_xla``). With
    ``segment_ids`` it computes ``_attention_plain`` on the tensors' device,
    differentiable through autograd and launching no flash kernel: the
    reference's dispatcher takes its XLA path there, since no kernel has a
    segment mask."""
    scale_val = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    if segment_ids is not None:
        return _attention_plain(
            q, k, v, causal=causal, scale=scale_val, segment_ids=segment_ids
        )
    return FlashAttention.apply(q, k, v, causal, scale_val, block_q, block_k)[0]
