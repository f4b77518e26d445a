"""Collectives of the sharded model, differentiable where the model needs a
gradient through them.

Every function takes a process group, or None for a group of one rank, where
it returns its input and calls nothing. The differentiable ones follow the
rule that a computation replicated over a group (every rank holds the same
tensors) gets the same gradient on every rank of it:

* ``copy_to``: identity forward, all-reduce (sum) of the gradient: where a
  replicated tensor enters a computation that the ranks split (Megatron's
  "f": the column-parallel products, the local experts);
* ``reduce_from``: all-reduce (sum) forward, identity backward: where the
  ranks' partial results become one replicated tensor (Megatron's "g");
* ``gather_from``: all-gather along a dim forward, this rank's block of the
  gradient backward, for a result that a replicated computation reads
  whole (the local experts' outputs before the combine);
* ``gather_summed``: all-gather along a dim forward, reduce-scatter (sum)
  of the gradient backward, where the group's ranks compute on different
  data (a parameter's fsdp shards, gathered where a block uses them);
* ``ppermute``: each rank sends to the rank ``shift`` places on and
  receives from the one ``shift`` places back; the gradient goes the other
  way (the reference's ``lax.ppermute``);
* ``all_to_all``: equal blocks of dim 0, block j to rank j; its own inverse,
  so the gradient takes the same exchange.

``all_gather``, ``all_reduce`` and ``reduce_scatter`` carry no gradient.
"""

from __future__ import annotations

from typing import List, Optional

import torch
import torch.distributed as dist

Group = Optional[dist.ProcessGroup]


def all_gather(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """The group's tensors concatenated along ``dim`` in group-rank order."""
    if group is None:
        return x
    x = x.contiguous()
    parts: List[torch.Tensor] = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def all_reduce(x: torch.Tensor, group: Group) -> torch.Tensor:
    """The sum over the group, in a new tensor."""
    if group is None:
        return x
    out = x.clone()
    dist.all_reduce(out, group=group)
    return out


# torch renamed reduce_scatter_tensor; either takes (output, input, op, group)
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def reduce_scatter(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    """This rank's block along ``dim`` of the sum over the group."""
    if group is None:
        return x
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // dist.get_world_size(group), *x.shape[1:]))
    _reduce_scatter(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def _block(x: torch.Tensor, group: dist.ProcessGroup, dim: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    return x.chunk(n, dim=dim)[r].contiguous()


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return all_reduce(grad.contiguous(), ctx.group), None


class _ReduceFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return all_reduce(x.contiguous(), group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return _block(grad, ctx.group, ctx.dim), None, None


class _GatherSummed(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim):
        ctx.group, ctx.dim = group, dim
        return all_gather(x, group, dim)

    @staticmethod
    def backward(ctx, grad):
        return reduce_scatter(grad, ctx.group, ctx.dim), None, None


def _permute(x: torch.Tensor, group: dist.ProcessGroup, shift: int) -> torch.Tensor:
    n, r = dist.get_world_size(group), dist.get_rank(group)
    x = x.contiguous()
    out = torch.empty_like(x)
    ops = [dist.P2POp(dist.isend, x, dist.get_global_rank(group, (r + shift) % n), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, (r - shift) % n), group)]
    for work in dist.batch_isend_irecv(ops):
        work.wait()
    return out


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, shift):
        ctx.group, ctx.shift = group, shift
        return _permute(x, group, shift)

    @staticmethod
    def backward(ctx, grad):
        return _permute(grad, ctx.group, -ctx.shift), None, None


def _exchange(x: torch.Tensor, group: dist.ProcessGroup) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _exchange(x, group)

    @staticmethod
    def backward(ctx, grad):
        return _exchange(grad, ctx.group), None


def copy_to(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else _CopyTo.apply(x, group)


def reduce_from(x: torch.Tensor, group: Group) -> torch.Tensor:
    return x if group is None else _ReduceFrom.apply(x, group)


def gather_from(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    return x if group is None else _GatherFrom.apply(x, group, dim)


def gather_summed(x: torch.Tensor, group: Group, dim: int = 0) -> torch.Tensor:
    return x if group is None else _GatherSummed.apply(x, group, dim)


def ppermute(x: torch.Tensor, group: Group, shift: int = 1) -> torch.Tensor:
    return x if group is None else _Permute.apply(x, group, shift)


def all_to_all(x: torch.Tensor, group: Group) -> torch.Tensor:
    """Dim 0 cut into one equal block per rank; block j goes to rank j, and
    the result holds the blocks received, in source-rank order."""
    return x if group is None else _AllToAll.apply(x, group)
