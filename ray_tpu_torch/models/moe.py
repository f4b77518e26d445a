"""Mixture-of-experts MLP, in PyTorch (counterpart of ``ray_tpu/models/moe.py``).

Top-k routing with a static per-expert capacity and the Switch
load-balancing aux loss, on one device. The reference dispatches and
combines with dense one-hot einsums over [tokens, experts, capacity]; this
module computes the same function by index: each kept assignment gets its
(expert, slot), the token rows are gathered into an [experts, capacity,
embed] buffer, the experts run as two batched products, and each token
gathers its rows back. At gpt_1b width and b=8, t=2048 the reference's
[k * tokens, experts, capacity] float32 dispatch tensor alone would be
5.4 GB per layer; the index form holds [k * tokens] integers. Both
directions of both moves are gathers (``gather_rows``): no atomics, no
accumulation into repeated indices, the same bits on every run.

Parameters keep the reference's names and layouts: ``router`` [embed,
experts], ``wi`` [experts, embed, mlp], ``wo`` [experts, mlp, embed], in
``cfg.param_dtype``, no biases.

On a mesh (``groups``) the layer routes over the global batch, as the
reference does: the capacity counts every data rank's tokens, and each
assignment's position in its expert counts the assignments before it in the
reference's global order (slot-major, then token), from a small all-gather
of per-rank counts (``global_slot_base``), so the kept set is the one the
reference keeps on any mesh. Routing and the combine are replicated over ep
and tp; each ep rank gathers and runs its own experts' slots (tp cutting
their mlp dim), and the experts' outputs are gathered over ep before the
combine. The aux loss is this rank's share of the global one (means over
the global tokens).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ray_tpu_torch.models.gpt import _gelu
from ray_tpu_torch.parallel import comm
from ray_tpu_torch.parallel.mesh import MeshGroups


def assign_slots(gate_idx: torch.Tensor, num_experts: int, capacity: int,
                 base: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, keep) of each of the k * s assignments of ``gate_idx`` [s, k],
    in slot-major order (every token's first choice, then every second
    choice, as the reference's ``flat``): an assignment takes the next free
    position of its expert, and is kept while that position is below
    ``capacity``. ``slot`` is ``expert * capacity + position`` for a kept
    assignment and ``num_experts * capacity`` (one past the last slot) for a
    dropped one. ``base`` [k * rows, E] (``global_slot_base``), where given,
    is added to the positions of each segment's assignments (a segment: one
    slot of one of ``rows`` equal runs of tokens). Runs on the device, with
    no host round trip."""
    flat = gate_idx.t().reshape(-1)                       # [k*s], slot-major
    experts = torch.arange(num_experts, device=flat.device)
    onehot = flat[None, :] == experts[:, None]            # [E, k*s]
    # one scan over the experts' rows laid end to end (a scan down the
    # columns of [k*s, E] runs one thread per column); an assignment's
    # position is the count of its expert's earlier assignments
    count = onehot.reshape(-1).cumsum(0).view(num_experts, -1)
    before = count[:, -1:] - onehot.sum(1, keepdim=True)  # ones in earlier rows
    pos = (count - before).gather(0, flat[None, :])[0] - 1
    if base is not None:
        seg = torch.arange(flat.numel(), device=flat.device) // (flat.numel() // base.shape[0])
        pos = pos + base[seg, flat]
    keep = pos < capacity
    slot = torch.where(keep, flat * capacity + pos, num_experts * capacity)
    return slot, keep


def _pad_row(x: torch.Tensor) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(1, x.shape[1])])


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, src, index, inverse):
        ctx.save_for_backward(inverse)
        return _pad_row(src).index_select(0, index)

    @staticmethod
    def backward(ctx, grad):
        (inverse,) = ctx.saved_tensors
        rows = _pad_row(grad.contiguous()).index_select(0, inverse.reshape(-1))
        return rows.view(*inverse.shape, grad.shape[1]).sum(0), None, None


def gather_rows(src: torch.Tensor, index: torch.Tensor, inverse: torch.Tensor
                ) -> torch.Tensor:
    """``out[i] = src[index[i]]`` over the rows of a 2-D ``src``, where an
    index of ``len(src)`` reads a row of zeros; differentiable in ``src``.
    ``inverse`` [R, len(src)] names, for each row of src, the (at most R)
    rows of out that read it, ``len(out)`` for none, so the backward is a
    gather too: ``grad_src[j] = sum_r grad_out[inverse[r, j]]``."""
    return _GatherRows.apply(src, index, inverse)


def expert_capacity(cfg, tokens: int) -> int:
    """Slots per expert for ``tokens`` routed tokens:
    ``max(1, ceil(k * tokens / E * moe_capacity_factor))``, the reference's
    expression, so both sides round it alike."""
    return max(1, int(math.ceil(cfg.moe_top_k * tokens / cfg.moe_num_experts
                                * cfg.moe_capacity_factor)))


def global_slot_base(gate_idx: torch.Tensor, num_experts: int, rows: int,
                     groups: MeshGroups) -> torch.Tensor:
    """[k * rows, E]: what to add to a local position (``assign_slots``) to
    make it global, for each (slot, row) segment of this rank's tokens
    ``gate_idx`` [rows * cols, k] (rows of the batch, each a chunk of the
    sequence).

    The reference's order runs over slots, then the global batch's rows,
    then positions; with the sequence cut over sp, a row's chunks sit on sp
    ranks in turn. Each rank counts its assignments per (slot, row, expert);
    the counts are gathered over the data group, laid out in that global
    order, and their exclusive prefix sum gives each segment's count of
    earlier assignments to each expert. The base is that global prefix
    minus the local one."""
    s, k = gate_idx.shape
    experts = torch.arange(num_experts, device=gate_idx.device)
    segs = gate_idx.t().reshape(k * rows, s // rows)
    counts = (segs[..., None] == experts).sum(1)                     # [k*rows, E]
    local_before = counts.cumsum(0) - counts
    every = comm.all_gather(counts[None], groups.data)               # [data, k*rows, E]
    blocks, sp = groups.batch_blocks, groups.sizes["sp"]
    # data rank = batch block * sp + sp index; the global order is (slot,
    # block, row, chunk)
    every = every.view(blocks, sp, k, rows, num_experts).permute(2, 0, 3, 1, 4)
    flat = every.reshape(-1, num_experts)
    before = (flat.cumsum(0) - flat).view(k, blocks, rows, sp, num_experts)
    mine = before[:, groups.batch_index, :, groups.coord["sp"]]      # [k, rows, E]
    return mine.reshape(k * rows, num_experts) - local_before


def route(xs: torch.Tensor, router: torch.Tensor, top_k: int, capacity: int,
          rows: int = 1, groups: Optional[MeshGroups] = None
          ) -> Tuple[torch.Tensor, ...]:
    """``(probs [s, E], gate_vals [s, k], gate_idx [s, k], slot, keep)`` of
    the token rows ``xs`` [s, d]: float32 logits ``xs @ router``, softmax,
    top ``top_k``, gates renormalised by ``max(sum, 1e-9)``, and each
    assignment's ``(slot, keep)`` from ``assign_slots``. ``slot`` fixes the
    kept set and every kept assignment's place in its expert's buffer. With
    ``groups`` whose data group has more than one rank, ``xs`` is this
    rank's ``rows`` batch rows (each a chunk of the sequence) and the
    positions are global (``global_slot_base``)."""
    probs = torch.softmax(xs.float() @ router.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    base = None
    if groups is not None and groups.data is not None:
        base = global_slot_base(gate_idx, router.shape[1], rows, groups)
    slot, keep = assign_slots(gate_idx, router.shape[1], capacity, base)
    return probs, gate_vals, gate_idx, slot, keep


class MoeMlp(nn.Module):
    """``forward(x [b, t, embed]) -> (y [b, t, embed], aux, dropped)``: the
    drop-in for the dense ``Mlp`` when ``cfg.moe_num_experts > 0``.

    Routing in float32 (``route``): logits ``x @ router``, softmax, top
    ``moe_top_k``, gates renormalised by ``max(sum, 1e-9)``. Static capacity
    ``expert_capacity`` slots per expert; assignments past it are dropped
    (``assign_slots``) and add 0. Experts:
    ``gelu(expert_in @ wi) @ wo`` in ``cfg.dtype`` (``torch.bmm``). Each
    token's output is the sum over its k kept rows, each weighted by its gate
    cast to ``cfg.dtype``, accumulated in float32 and rounded once.

    ``aux`` is the Switch loss ``E * sum_e f_e * P_e`` in float32 (f_e the
    share of tokens whose first choice is e, without gradient; P_e the mean
    router probability): 1 for uniform routing. ``dropped`` is the share of
    the k * s assignments dropped for capacity, a diagnostic without
    gradient. Both go to the caller; the module keeps no state.

    With ``groups`` (a mesh): ``x`` is this rank's tokens, the router its
    whole weight, ``wi`` and ``wo`` its experts (cut over ep, their mlp
    dim over tp). Capacity and positions are global; ``aux`` is this rank's
    share (f_e over the global tokens, P_e's sum over its tokens divided by
    the global count), which sums to the global loss over the data ranks,
    and ``dropped`` this rank's share.

    ``PARAM_AXES``: each parameter's logical axes and the ones it keeps cut
    while computing (``models.gpt.param_logical_axes``)."""

    PARAM_AXES = {
        "router": (("embed", "expert"), ()),
        "wi": (("expert", "embed", "mlp"), ("expert", "mlp")),
        "wo": (("expert", "mlp", "embed"), ("expert", "mlp")),
    }

    def __init__(self, cfg, device=None, groups: Optional[MeshGroups] = None):
        super().__init__()
        self.cfg = cfg
        self.groups = groups
        e, d, f = cfg.moe_num_experts, cfg.embed_dim, cfg.mlp_dim
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.router = nn.Parameter(torch.empty(d, e, **kw))
        self.wi = nn.Parameter(torch.empty(e, d, f, **kw))
        self.wo = nn.Parameter(torch.empty(e, f, d, **kw))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        g = self.groups
        dtype = cfg.dtype
        n_exp, k = cfg.moe_num_experts, cfg.moe_top_k
        b, t, d = x.shape
        s = b * t
        xs = x.reshape(s, d).to(dtype)
        data = None if g is None else g.data
        n_data = 1 if data is None else g.data_size
        capacity = expert_capacity(cfg, s * n_data)
        n_slots = n_exp * capacity
        ep = None if g is None else g.group("ep")
        tp = None if g is None else g.group("tp")
        n_local = self.wi.shape[0] * capacity                          # this rank's slots

        with record_function("moe_router"):
            probs, gate_vals, gate_idx, slot, keep = route(xs, self.router, k, capacity,
                                                           rows=b, groups=g)

        with record_function("moe_dispatch"):
            # the assignment that fills each slot (k*s where none does; every
            # dropped assignment writes one slot past the end, cut off), and
            # its token (s, a row of zeros, for an empty slot)
            filled = torch.full((n_slots + 1,), k * s, dtype=torch.long, device=x.device)
            filled = filled.scatter(0, slot, torch.arange(k * s, device=x.device))[:n_slots]
            slot_token = torch.where(filled < k * s, filled % s, s)
            if ep is None:
                expert_in = gather_rows(xs, slot_token, slot.view(k, s))
            else:
                # this ep rank's experts' slots; the other assignments read none
                lo = g.coord["ep"] * n_local
                mine = (slot >= lo) & (slot < lo + n_local)
                expert_in = gather_rows(comm.copy_to(xs, ep), slot_token[lo:lo + n_local],
                                        torch.where(mine, slot - lo, n_local).view(k, s))
            expert_in = comm.copy_to(expert_in.view(-1, capacity, d), tp)

        with record_function("moe_experts"):
            h = _gelu(torch.bmm(expert_in, self.wi.to(dtype)))
            expert_out = comm.reduce_from(torch.bmm(h, self.wo.to(dtype)), tp)
            expert_out = comm.gather_from(expert_out, ep)              # [E, C, d]

        with record_function("moe_combine"):
            # a dropped assignment reads the zero row past the last slot
            rows = gather_rows(expert_out.view(n_slots, d), slot,
                               filled.view(1, n_slots)).view(k, s, d)
            gates = gate_vals.t().to(dtype).float()                    # [k, s]
            y = (rows.float() * gates[..., None]).sum(0).to(dtype)

        first = F.one_hot(gate_idx[:, 0], n_exp).float()
        if data is None:
            aux = (first.mean(0) * probs.mean(0)).sum() * n_exp
        else:
            tokens = s * n_data
            aux = (comm.all_reduce(first.sum(0), data) / tokens
                   * (probs.sum(0) / tokens)).sum() * n_exp
        dropped = 1.0 - keep.float().mean()
        return y.view(b, t, d), aux, dropped
