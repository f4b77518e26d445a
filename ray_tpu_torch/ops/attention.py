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
  (TMA, wgmma, warp-specialised; bf16 at head_dim 64, 128, 256),
  ``csrc/flash_fwd_persistent.cu`` (a persistent grid of several CTAs an
  SM, a TMA ring; bf16 at head_dim 16, 32) or ``csrc/flash_fwd_f32.cu``
  (3xTF32 on mma.sync; float32 at every head_dim); ``csrc/flash_fwd.cu``
  (mma.sync), bf16 16/32's kernel before, is on no path.
  It counts every launch in ``flash_fwd_launches`` and each design's in
  ``flash_fwd_{wgmma,persistent,tf32x3}_launches``;
  ``flash_attention_bwd`` launches the dQ and dK/dV kernels
  (``flash_bwd_dq``, ``flash_bwd_dkv``) of the design that the dispatch
  table ``BWD_DESIGNS`` names: ``csrc/flash_bwd_wgmma.cu`` (TMA, wgmma,
  warp-specialised; bf16 at head_dim 64, 128 and 256), ``csrc/flash_bwd.cu``
  (mma.sync; bf16 at head_dim 16 and 32) or ``csrc/flash_bwd_f32.cu``
  (3xTF32 on mma.sync; float32 at every head_dim), counted in
  ``flash_bwd_dq_launches`` and ``flash_bwd_dkv_launches`` and in the
  design's ``flash_bwd_{dq,dkv}_{wgmma,mma_sync,tf32x3}_launches``. On CPU
  tensors the wrappers take the plain versions and count nothing. On a CUDA
  tensor they launch or raise: they never fall back quietly.
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

import ctypes
import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.ops import _build

NEG_INF = -1e30
HEAD_DIMS = (16, 32, 64, 128, 256)
_DTYPE_CODES = {torch.bfloat16: 0, torch.float32: 1}


@dataclasses.dataclass(frozen=True)
class FwdDesign:
    """One hand-written flash forward kernel: its name, its source
    ``csrc/<source>.cu`` and entry point, and its tiles (q rows and kv rows
    per tile), which are the semantics of rows that see no key."""

    name: str
    source: str
    entry: str
    block_q: int
    block_k: int


_PERSISTENT = FwdDesign("persistent", "flash_fwd_persistent",
                        "ray_tpu_flash_fwd_persistent", 64, 64)
_TF32X3 = FwdDesign("tf32x3", "flash_fwd_f32", "ray_tpu_flash_fwd_f32", 64, 64)


def _wgmma(block_k: int) -> FwdDesign:
    return FwdDesign("wgmma", "flash_fwd_wgmma", "ray_tpu_flash_fwd_wgmma", 128, block_k)


#: the forward's dispatch table, keyed on (head_dim, dtype): the kernel each
#: input launches on the card and the tiles the plain version repeats. Every
#: design is a hand-written kernel; a launch that the kernel refuses raises.
#: float32 runs 3xTF32 on the tensor cores (``flash_fwd_f32.cu``). Neither
#: kernel of ``flash_fwd.cu`` is on a path: its float32 one (CUDA cores)
#: ``ops/flash_fwd_f32_variants.py`` times beside ``flash_fwd_f32.cu``, its
#: bf16 one (mma.sync) ``ops/flash_fwd_variants.py --small-d`` beside
#: ``flash_fwd_persistent.cu``.
FWD_DESIGNS = {
    **{(d, torch.float32): _TF32X3 for d in HEAD_DIMS},
    (16, torch.bfloat16): _PERSISTENT,
    (32, torch.bfloat16): _PERSISTENT,
    (64, torch.bfloat16): _wgmma(128),
    (128, torch.bfloat16): _wgmma(128),
    (256, torch.bfloat16): _wgmma(80),
}


@dataclasses.dataclass(frozen=True)
class BwdDesign:
    """One pair of hand-written flash backward kernels: its name, its
    source ``csrc/<source>.cu`` and the entry points of its dQ and dK/dV
    kernels. The backward's result does not depend on its tiles
    (``flash_attention_bwd_plain``), so the design names none."""

    name: str
    source: str
    dq_entry: str
    dkv_entry: str


_BWD_MMA_SYNC = BwdDesign("mma_sync", "flash_bwd", "ray_tpu_flash_bwd_dq",
                          "ray_tpu_flash_bwd_dkv")
_BWD_WGMMA = BwdDesign("wgmma", "flash_bwd_wgmma", "ray_tpu_flash_bwd_dq_wgmma",
                       "ray_tpu_flash_bwd_dkv_wgmma")
_BWD_TF32X3 = BwdDesign("tf32x3", "flash_bwd_f32", "ray_tpu_flash_bwd_dq_f32",
                        "ray_tpu_flash_bwd_dkv_f32")

#: the backward's dispatch table, keyed on (head_dim, dtype): the kernels each
#: input launches on the card. At head_dim 256 the wgmma design's dK/dV
#: kernel splits dV and dK between its warpgroups (``flash_bwd_wgmma.cu``);
#: float32 runs 3xTF32 on the tensor cores (``flash_bwd_f32.cu``). The
#: float32 kernels of ``flash_bwd.cu`` (CUDA cores) are on no path:
#: ``ops/flash_bwd_f32_variants.py`` times them beside these.
BWD_DESIGNS = {
    **{(d, torch.float32): _BWD_TF32X3 for d in HEAD_DIMS},
    **{(d, torch.bfloat16): _BWD_MMA_SYNC for d in (16, 32)},
    **{(d, torch.bfloat16): _BWD_WGMMA for d in (64, 128, 256)},
}

#: launches of each kernel, counted where it is launched; a launch counts in
#: its kernel's total (flash_fwd, flash_bwd_dq, flash_bwd_dkv) and in its
#: design's count
flash_fwd_launches = 0
flash_fwd_wgmma_launches = 0
flash_fwd_persistent_launches = 0
flash_fwd_tf32x3_launches = 0
flash_bwd_dq_launches = 0
flash_bwd_dq_wgmma_launches = 0
flash_bwd_dq_mma_sync_launches = 0
flash_bwd_dq_tf32x3_launches = 0
flash_bwd_dkv_launches = 0
flash_bwd_dkv_wgmma_launches = 0
flash_bwd_dkv_mma_sync_launches = 0
flash_bwd_dkv_tf32x3_launches = 0


def fwd_tiles(head_dim: int, dtype: torch.dtype) -> Tuple[int, int]:
    """(block_q, block_k) of the forward kernel that ``FWD_DESIGNS`` names
    for this head_dim and dtype: the one source of the tiles, read by the
    wrapper, the CPU path and the plain version. A (head_dim, dtype) that no
    kernel takes, which only the CPU path runs, gets 64 x 64."""
    design = FWD_DESIGNS.get((head_dim, dtype))
    return (64, 64) if design is None else (design.block_q, design.block_k)


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------


def _causal_mask(t_q: int, t_kv: int, device) -> torch.Tensor:
    q_pos = torch.arange(t_q, device=device)[:, None] + (t_kv - t_q)
    return q_pos >= torch.arange(t_kv, device=device)[None, :]


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
    t_q, d = q.shape[-2:]
    t_kv = k.shape[-2]
    scale = scale if scale is not None else 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), k.float()) * scale
    mask = _causal_mask(t_q, t_kv, q.device)[None, None] if causal else None
    if segment_ids is not None:
        seg = segment_ids[:, None, :, None] == segment_ids[:, None, None, :]
        mask = seg if mask is None else (mask & seg)
    if mask is not None:
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.einsum("bhqk,bhkd->bhqd", probs, v)


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
    ``_flash_bwd_dkv_kernel``) in float32, over the whole score matrix.

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
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    delta = (dof * o.float()).sum(-1)
    if dlse is not None:
        delta = delta - dlse.float()
    s = torch.einsum("bhqd,bhkd->bhqk", qf, kf) * scale
    if causal:
        s = torch.where(_causal_mask(t_q, t_kv, q.device), s, NEG_INF)
    p = torch.exp(s - lse[..., None])
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
# dtype, causal, scale and the stream
_SOURCES = {
    "flash_fwd": ({"ray_tpu_flash_fwd": 5}, "ray_tpu_cuda_error_string"),
    "flash_fwd_wgmma": ({"ray_tpu_flash_fwd_wgmma": 5},
                        "ray_tpu_flash_fwd_wgmma_error_string"),
    "flash_fwd_persistent": ({"ray_tpu_flash_fwd_persistent": 5},
                             "ray_tpu_flash_fwd_persistent_error_string"),
    "flash_fwd_f32": ({"ray_tpu_flash_fwd_f32": 5}, "ray_tpu_flash_fwd_f32_error_string"),
    "flash_bwd": ({"ray_tpu_flash_bwd_dq": 7, "ray_tpu_flash_bwd_dkv": 8},
                  "ray_tpu_flash_bwd_error_string"),
    "flash_bwd_wgmma": ({"ray_tpu_flash_bwd_dq_wgmma": 7, "ray_tpu_flash_bwd_dkv_wgmma": 8},
                        "ray_tpu_flash_bwd_wgmma_error_string"),
    "flash_bwd_f32": ({"ray_tpu_flash_bwd_dq_f32": 7, "ray_tpu_flash_bwd_dkv_f32": 8},
                      "ray_tpu_flash_bwd_f32_error_string"),
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
    of one dtype (bfloat16 or float32), d in ``HEAD_DIMS``; each of
    ``same_as_q`` (o, do) like q; each of ``rows`` (lse, delta) float32
    [b, h, t_q]."""
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
    if d not in HEAD_DIMS:
        raise ValueError(f"head_dim {d} not in {HEAD_DIMS}")
    if t_q == 0 or t_kv == 0 or b * h > 65535:
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
                  "persistent": "ray_tpu_flash_fwd_persistent_tiles",
                  "tf32x3": "ray_tpu_flash_fwd_f32_tiles"}
# the designs that take the row max of the raw scores and fold the scale
# into exp2 after it, so take a positive scale only
_POSITIVE_SCALE = ("wgmma", "persistent")


def _check_design(design: FwdDesign, head_dim: int, scale: float) -> None:
    """Raise ``ValueError`` unless the design takes this scale (the wgmma
    and persistent kernels take a positive one only), and ``RuntimeError``
    unless the built kernel computes with the table's tiles at this
    head_dim."""
    if design.name in _POSITIVE_SCALE and not scale > 0:
        raise ValueError(f"the {design.name} flash kernel takes a positive scale, "
                         f"got {scale}")
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
    [b, h, t_q] float32.

    CPU tensors take ``flash_attention_fwd_plain`` (at ``block_q`` x
    ``block_k``, by default the card kernel's tiles) and launch nothing.
    CUDA tensors launch the hand-written Hopper kernel that ``FWD_DESIGNS``
    names for (head_dim, dtype): contiguous q [b, h, t_q, d] and k, v
    [b, h, t_kv, d] of one dtype (bfloat16, or float32 in 3xTF32, both on
    the tensor cores), d in ``HEAD_DIMS``, the design's tiles (``block_q`` and
    ``block_k`` left at None or equal to them) and, in bf16 (the wgmma and
    persistent designs), a positive scale. Anything else raises."""
    global flash_fwd_launches
    if all(t.device.type == "cpu" for t in (q, k, v)):
        return flash_attention_fwd_plain(
            q, k, v, causal=causal, scale=scale, block_q=block_q, block_k=block_k)
    d = q.shape[-1]
    design = FWD_DESIGNS.get((d, q.dtype))
    if design is not None:
        _check_tiles(design, d, block_q, block_k)
    _check_kernel_inputs(q, k, v)  # raises for a (d, dtype) not in the table
    _check_design(design, d, scale)
    out = torch.empty_like(q)
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    _launch(design.source, design.entry, (q, k, v, out, lse), q, k.shape[2],
            causal, scale)
    flash_fwd_launches += 1
    _count_design("flash_fwd", design)
    return out, lse


def flash_bwd_delta(o: torch.Tensor, do: torch.Tensor) -> torch.Tensor:
    """delta = rowsum(dO * O) in float32 [b, h, t_q], as the reference
    computes it outside its kernels; a ``flash_bwd_delta`` range for
    ``torch.profiler``."""
    with torch.profiler.record_function("flash_bwd_delta"):
        return (do.float() * o.float()).sum(-1)


def _bwd_design(q, k, v, do, lse, delta) -> BwdDesign:
    """The ``BWD_DESIGNS`` entry for these inputs, after the checks every
    backward kernel needs; raises for inputs that no kernel takes."""
    _check_kernel_inputs(q, k, v, ("do", do), rows=(("lse", lse), ("delta", delta)))
    return BWD_DESIGNS[(q.shape[-1], q.dtype)]


def _count_design(kernel: str, design: FwdDesign | BwdDesign) -> None:
    """One more launch in ``<kernel>_<design>_launches``."""
    name = f"{kernel}_{design.name}_launches"
    globals()[name] += 1


def flash_bwd_dq(q, k, v, do, lse, delta, *, causal: bool, scale: float
                 ) -> torch.Tensor:
    """dq from the dQ kernel of the design ``BWD_DESIGNS`` names (CUDA
    tensors only), counted in ``flash_bwd_dq_launches`` and the design's
    ``flash_bwd_dq_<design>_launches``."""
    global flash_bwd_dq_launches
    design = _bwd_design(q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    _launch(design.source, design.dq_entry, (q, k, v, do, lse, delta, dq), q,
            k.shape[2], causal, scale)
    flash_bwd_dq_launches += 1
    _count_design("flash_bwd_dq", design)
    return dq


def flash_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool, scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) from the dK/dV kernel of the design ``BWD_DESIGNS`` names
    (CUDA tensors only), counted in ``flash_bwd_dkv_launches`` and the
    design's ``flash_bwd_dkv_<design>_launches``."""
    global flash_bwd_dkv_launches
    design = _bwd_design(q, k, v, do, lse, delta)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    _launch(design.source, design.dkv_entry, (q, k, v, do, lse, delta, dk, dv),
            q, k.shape[2], causal, scale)
    flash_bwd_dkv_launches += 1
    _count_design("flash_bwd_dkv", design)
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
    ``dlse`` (float32 [b, h, t_q]).

    CPU tensors take ``flash_attention_bwd_plain`` and launch nothing. CUDA
    tensors launch the two hand-written Hopper kernels of the design that
    ``BWD_DESIGNS`` names for (head_dim, dtype), dQ then dK/dV, after
    delta = rowsum(dO * O) (minus ``dlse``): the inputs the forward kernel
    takes, with o and do like q (contiguous) and lse float32 [b, h, t_q].
    Anything else raises."""
    if all(t.device.type == "cpu" for t in (q, k, v, o, lse, do)):
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
    path takes any; the card's kernel raises for other tiles). With
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
