"""Sequence parallelism: ring attention and Ulysses over the sp axis
(counterpart of ``ray_tpu/ops/ring.py``).

Each rank holds a contiguous chunk of the sequence: rank i of the sp group
holds positions [i * t_loc, (i + 1) * t_loc). The functions here take the
rank's local blocks, [b_loc, h_loc, t_loc, d] (the batch cut over dp and
fsdp, the heads over tp, as the caller's shards are; the reference's
``shard_map`` body), and run the exchange over the mesh's sp group.

- **Ring**: K/V chunks move one rank on per hop (``comm.ppermute``, whose
  gradient goes back the other way); each hop's block is
  ``flash_attention_with_lse`` (the Hopper kernels on CUDA, differentiable
  in lse as well as out) against the local Q, merged with the online-softmax
  rule (``merge_attention``). Step 0 is the local causal block; after j hops
  a rank holds chunk (my - j) mod sp, which it sees wholly iff my >= j and
  not at all otherwise. Every rank computes every hop and masks the future
  ones in the merge, as the reference does, so all ranks build the same
  autograd graph and run the same collectives in the backward (and in a
  remat recompute). Q never moves; peak activation memory is one K/V chunk
  more per rank, and no [b, h, t_loc, t_loc] float32 scores.
- **Ulysses**: ``comm.all_to_all`` trades heads for sequence, so each rank
  holds every position of h_loc / sp heads, runs ``dot_product_attention``
  (the flash forward and both backward kernels) on the full sequence and
  trades back. Needs h_loc % sp == 0.

With sp == 1 ``sequence_parallel_attention`` is ``dot_product_attention``.
``use_pallas`` goes through to it there and to Ulysses, as in the
reference; ring hops stay on ``flash_attention_with_lse``.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist

from ray_tpu_torch.ops.attention import (
    dot_product_attention,
    flash_attention_with_lse,
    merge_attention,
)
from ray_tpu_torch.parallel import comm


def ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                         group: dist.ProcessGroup, causal: bool = True,
                         scale: Optional[float] = None) -> torch.Tensor:
    """Ring attention of the local chunk [b, h_loc, t_loc, d] over the sp
    ``group``; returns the local chunk's output in q's dtype."""
    scale_val = float(scale) if scale is not None else 1.0 / math.sqrt(q.shape[-1])
    sp, my = dist.get_world_size(group), dist.get_rank(group)
    o, lse = flash_attention_with_lse(q, k, v, causal, scale_val)
    o = o.float()
    k_blk, v_blk = k, v
    for j in range(1, sp):
        k_blk = comm.ppermute(k_blk, group)
        v_blk = comm.ppermute(v_blk, group)
        o_j, lse_j = flash_attention_with_lse(q, k_blk, v_blk, False, scale_val)
        # after j hops this rank holds chunk (my - j) mod sp: an earlier
        # chunk, seen wholly, iff my >= j; otherwise a later one, masked out
        o, lse = merge_attention(o, lse, o_j, lse_j, (my >= j) if causal else True)
    return o.to(q.dtype)


def _heads_to_seq(x: torch.Tensor, sp: int, group) -> torch.Tensor:
    """[b, h_loc, t_loc, d] -> [b, h_loc / sp, sp * t_loc, d]: head group j
    to rank j, the sequence chunks of the received blocks in rank order."""
    b, h, t, d = x.shape
    x = x.reshape(b, sp, h // sp, t, d).permute(1, 0, 2, 3, 4)
    x = comm.all_to_all(x.contiguous(), group)          # [sp(chunk), b, h/sp, t, d]
    # the flash kernels take contiguous tensors only
    return x.permute(1, 2, 0, 3, 4).reshape(b, h // sp, sp * t, d).contiguous()


def _seq_to_heads(x: torch.Tensor, sp: int, group) -> torch.Tensor:
    """The inverse of ``_heads_to_seq``."""
    b, hs, t_full, d = x.shape
    t = t_full // sp
    x = x.reshape(b, hs, sp, t, d).permute(2, 0, 1, 3, 4)
    x = comm.all_to_all(x.contiguous(), group)          # [sp(head group), b, h/sp, t, d]
    return x.permute(1, 0, 2, 3, 4).reshape(b, sp * hs, t, d)


def ulysses_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                            group: dist.ProcessGroup, causal: bool = True,
                            scale: Optional[float] = None,
                            use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Ulysses attention of the local chunk [b, h_loc, t_loc, d] over the sp
    ``group``: all-to-all to [b, h_loc / sp, t, d], ``dot_product_attention``
    over the whole sequence (``use_pallas`` passed on: the flash kernels, or
    with False the plain route), all-to-all back. Requires h_loc % sp ==
    0."""
    sp = dist.get_world_size(group)
    h_loc = q.shape[1]
    if h_loc % sp != 0:
        raise ValueError(f"ulysses needs local heads ({h_loc}) divisible by sp ({sp})")
    out = dot_product_attention(
        *(_heads_to_seq(x, sp, group) for x in (q, k, v)), causal=causal, scale=scale,
        use_pallas=use_pallas)
    return _seq_to_heads(out, sp, group)


def sequence_parallel_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                mesh, *, impl: str = "ring", sp_axis: str = "sp",
                                causal: bool = True, scale: Optional[float] = None,
                                use_pallas: Optional[bool] = None) -> torch.Tensor:
    """Context-parallel attention of this rank's blocks [b_loc, h_loc, t_loc,
    d], whose sequence is cut over the ``sp_axis`` of ``mesh`` (a
    ``DeviceMesh``). With sp == 1 this is ``dot_product_attention`` (the
    flash kernels, or with ``use_pallas=False`` the plain route); otherwise
    ``impl`` "ring" or "ulysses" runs over the mesh's sp group. Ulysses
    passes ``use_pallas`` on; the ring's hops are ``flash_attention_with_lse``
    whatever it says, as the reference's ring takes no ``use_pallas``."""
    if impl not in ("ring", "ulysses"):
        raise ValueError(f"unknown sequence-parallel impl {impl!r}")
    if mesh.size(mesh.mesh_dim_names.index(sp_axis)) == 1:
        return dot_product_attention(q, k, v, causal=causal, scale=scale,
                                     use_pallas=use_pallas)
    group = mesh.get_group(sp_axis)
    if impl == "ring":
        return ring_attention_local(q, k, v, group=group, causal=causal, scale=scale)
    return ulysses_attention_local(q, k, v, group=group, causal=causal, scale=scale,
                                   use_pallas=use_pallas)
