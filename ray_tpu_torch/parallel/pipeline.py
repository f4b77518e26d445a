"""Pipeline parallelism: GPipe-style microbatching over the ``pp`` mesh axis
(counterpart of ``ray_tpu/parallel/pipeline.py``).

The transformer layers are split into S contiguous stages, the stacked layer
parameters ``[num_layers, ...]`` are cut over ``pp`` along their leading
axis (``sharding.pp_rules``: "layers" -> pp), and ``pipeline_apply`` streams
M microbatches through the stages with ``comm.ppermute`` hops between
neighbouring pp ranks. Autograd through the hops is the backward pipeline
(the gradient of a hop is the inverse hop), so one forward definition gives
the whole GPipe schedule, with (S-1)/(M+S-1) of each stage's ticks spent in
the bubble. The pipelined train step is ``models.training.make_pp_train_step``.
"""

from __future__ import annotations

from typing import Any, Callable, Tuple, Union

import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.utils._pytree import tree_flatten, tree_map, tree_unflatten
from torch.utils.checkpoint import checkpoint

from ray_tpu_torch.parallel import comm
from ray_tpu_torch.parallel.mesh import MeshGroups


def stage_split(tree: Any, num_stages: int) -> Any:
    """Reshape stacked-layer parameters [num_layers, ...] -> [S, L/S, ...]
    (every leaf of a tensor or a pytree of them). Raises ``ValueError``
    where num_layers does not divide by ``num_stages``."""

    def _split(p: torch.Tensor) -> torch.Tensor:
        n = p.shape[0]
        if n % num_stages:
            raise ValueError(f"num_layers={n} not divisible by pp={num_stages}")
        return p.reshape((num_stages, n // num_stages) + tuple(p.shape[1:]))

    return tree_map(_split, tree)


def _pp_place(mesh: Union[DeviceMesh, MeshGroups]) -> Tuple[int, int, Any]:
    """(S, this rank's stage, the pp group or None at S == 1)."""
    if isinstance(mesh, MeshGroups):
        return mesh.sizes["pp"], mesh.coord["pp"], mesh.group("pp")
    size = mesh.size(list(mesh.mesh_dim_names).index("pp"))
    return size, mesh.get_local_rank("pp"), (mesh.get_group("pp") if size > 1 else None)


def pipeline_apply(mesh: Union[DeviceMesh, MeshGroups],
                   layer_apply: Callable[[Any, Any], Any], stage_params: Any, x_mb: Any,
                   *, remat: bool = True) -> Any:
    """Stream microbatches through the pipeline stages on the ``pp`` axis.

    Every rank of the pp group calls this alike.

    Args:
      mesh: a ``DeviceMesh`` over ``AXIS_ORDER`` or its ``MeshGroups``; its
        ``pp`` size is the stage count S, this rank's pp index its stage.
      layer_apply: ``(layer_params, x) -> x`` for ONE layer (the leaves of
        ``stage_params`` less their two leading [1, L/S] axes).
      stage_params: this rank's block of ``stage_split``'s output: a tensor
        or pytree whose leaves are [1, L/S, ...], its own stage's layers.
      x_mb: the microbatched activations, replicated over pp: a tensor or
        pytree of them, every leaf [M, mb, ...].
    Returns:
      The same pytree: the last stage's outputs, [M, mb, ...], on every pp
      rank.

    The reference's tick schedule (``ray_tpu/parallel/pipeline.py:146-181``):
    M + S - 1 ticks; on tick t the previous tick's output hops one stage on
    (``comm.ppermute``; the last stage's hop to stage 0 is discarded there),
    stage 0 takes microbatch ``min(t, M - 1)`` instead, every stage runs its
    L/S layers, and the last stage's output is microbatch t - (S - 1) once
    that is >= 0. The result is the last stage's outputs, masked to 0 on the
    other stages and summed over pp (``comm.reduce_from``: the gradient
    enters every rank's copy, and the mask keeps the last stage's). The
    input enters through ``comm.copy_to``: stage 0 alone reads it, and its
    gradient is summed over pp, so every rank gets the input's whole
    gradient (the reference's replicated input, whose gradient JAX sums
    over the manual axis).

    Every stage computes on every tick, bubbles included, and selects by a
    mask tensor (``torch.where``), never by a branch on its stage: every
    rank builds the same autograd graph, so the backward's hops and the
    layers' collectives pair up across ranks. Under ``remat`` each layer
    runs under ``torch.utils.checkpoint`` (the reference's
    ``jax.checkpoint(layer_apply)``, ``:110-111``): its input is kept and
    the rest recomputed in the backward.

    One schedule for every S: the reference's shortcut at S == 1
    (``:101-108``: the layers scanned over the whole [M, mb, ...] batch,
    without remat) is not taken. At S == 1 the loop runs M ticks, the hop
    and the masked sum are the identity (``comm`` passes a group of one
    through) and ``remat`` is as given. Every row goes through the same
    layers, so the values are the reference's; only the launch order (a
    microbatch at a time) and the memory differ. That is what lets one card
    drive the schedule at world size 1.
    """
    S, stage, group = _pp_place(mesh)
    # the stage's layers and the microbatches by unbind, whose backward
    # stacks the parts' gradients in one pass (indexing a part at a time
    # would write a whole zero-filled stack per part)
    leaves, spec = tree_flatten(stage_params)
    per_leaf = [p.squeeze(0).unbind(0) for p in leaves]
    layers = [tree_unflatten([parts[j] for parts in per_leaf], spec)
              for j in range(len(per_leaf[0]))]

    def run_layer(lp: Any, x: Any) -> Any:
        if remat:
            return checkpoint(layer_apply, lp, x, use_reentrant=False,
                              preserve_rng_state=False)
        return layer_apply(lp, x)

    x_leaves, x_spec = tree_flatten(x_mb)
    micro = [comm.copy_to(a, group).unbind(0) for a in x_leaves]
    M = len(micro[0])
    dev = x_leaves[0].device
    is_first = torch.tensor(stage == 0, device=dev)
    is_last = torch.tensor(stage == S - 1, device=dev)
    prev = tree_unflatten([torch.zeros_like(m[0]) for m in micro], x_spec)
    outs = [None] * M
    for t in range(M + S - 1):
        arriving = tree_map(lambda a: comm.ppermute(a, group), prev)
        first_in = tree_unflatten([m[min(t, M - 1)] for m in micro], x_spec)
        h = tree_map(lambda a, b: torch.where(is_first, a, b), first_in, arriving)
        for lp in layers:
            h = run_layer(lp, h)
        if t >= S - 1:
            outs[t - (S - 1)] = h
        prev = h
    out = tree_map(lambda *ys: torch.stack(ys), *outs)
    return tree_map(lambda b: comm.reduce_from(torch.where(is_last, b, 0), group), out)
