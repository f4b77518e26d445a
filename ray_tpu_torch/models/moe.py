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
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.profiler import record_function

from ray_tpu_torch.models.gpt import _gelu


def assign_slots(gate_idx: torch.Tensor, num_experts: int, capacity: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(slot, keep) of each of the k * s assignments of ``gate_idx`` [s, k],
    in slot-major order (every token's first choice, then every second
    choice, as the reference's ``flat``): an assignment takes the next free
    position of its expert, and is kept while that position is below
    ``capacity``. ``slot`` is ``expert * capacity + position`` for a kept
    assignment and ``num_experts * capacity`` (one past the last slot) for a
    dropped one. Runs on the device, with no host round trip."""
    flat = gate_idx.t().reshape(-1)                       # [k*s], slot-major
    experts = torch.arange(num_experts, device=flat.device)
    onehot = flat[None, :] == experts[:, None]            # [E, k*s]
    # one scan over the experts' rows laid end to end (a scan down the
    # columns of [k*s, E] runs one thread per column); an assignment's
    # position is the count of its expert's earlier assignments
    count = onehot.reshape(-1).cumsum(0).view(num_experts, -1)
    before = count[:, -1:] - onehot.sum(1, keepdim=True)  # ones in earlier rows
    pos = (count - before).gather(0, flat[None, :])[0] - 1
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


def route(xs: torch.Tensor, router: torch.Tensor, top_k: int, capacity: int
          ) -> Tuple[torch.Tensor, ...]:
    """``(probs [s, E], gate_vals [s, k], gate_idx [s, k], slot, keep)`` of
    the token rows ``xs`` [s, d]: float32 logits ``xs @ router``, softmax,
    top ``top_k``, gates renormalised by ``max(sum, 1e-9)``, and each
    assignment's ``(slot, keep)`` from ``assign_slots``. ``slot`` fixes the
    kept set and every kept assignment's place in its expert's buffer."""
    probs = torch.softmax(xs.float() @ router.float(), dim=-1)
    gate_vals, gate_idx = torch.topk(probs, top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    slot, keep = assign_slots(gate_idx, router.shape[1], capacity)
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
    gradient. Both go to the caller; the module keeps no state."""

    def __init__(self, cfg, device=None):
        super().__init__()
        self.cfg = cfg
        e, d, f = cfg.moe_num_experts, cfg.embed_dim, cfg.mlp_dim
        kw = dict(dtype=cfg.param_dtype, device=device)
        self.router = nn.Parameter(torch.empty(d, e, **kw))
        self.wi = nn.Parameter(torch.empty(e, d, f, **kw))
        self.wo = nn.Parameter(torch.empty(e, f, d, **kw))

    def forward(self, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        dtype = cfg.dtype
        n_exp, k = cfg.moe_num_experts, cfg.moe_top_k
        b, t, d = x.shape
        s = b * t
        xs = x.reshape(s, d).to(dtype)
        capacity = expert_capacity(cfg, s)
        n_slots = n_exp * capacity

        with record_function("moe_router"):
            probs, gate_vals, gate_idx, slot, keep = route(xs, self.router, k, capacity)

        with record_function("moe_dispatch"):
            # the assignment that fills each slot (k*s where none does; every
            # dropped assignment writes one slot past the end, cut off), and
            # its token (s, a row of zeros, for an empty slot)
            filled = torch.full((n_slots + 1,), k * s, dtype=torch.long, device=x.device)
            filled = filled.scatter(0, slot, torch.arange(k * s, device=x.device))[:n_slots]
            slot_token = torch.where(filled < k * s, filled % s, s)
            expert_in = gather_rows(xs, slot_token, slot.view(k, s)).view(n_exp, capacity, d)

        with record_function("moe_experts"):
            h = _gelu(torch.bmm(expert_in, self.wi.to(dtype)))
            expert_out = torch.bmm(h, self.wo.to(dtype))               # [E, C, d]

        with record_function("moe_combine"):
            # a dropped assignment reads the zero row past the last slot
            rows = gather_rows(expert_out.view(n_slots, d), slot,
                               filled.view(1, n_slots)).view(k, s, d)
            gates = gate_vals.t().to(dtype).float()                    # [k, s]
            y = (rows.float() * gates[..., None]).sum(0).to(dtype)

        first = F.one_hot(gate_idx[:, 0], n_exp).float().mean(0)
        aux = (first * probs.mean(0)).sum() * n_exp
        dropped = 1.0 - keep.float().mean()
        return y.view(b, t, d), aux, dropped
