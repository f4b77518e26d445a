"""Logical-axis sharding rules (counterpart of ``ray_tpu/parallel/sharding.py``).

Parameters and activations carry *logical* axis names once; a rule table
maps those names onto mesh axes. Changing the parallel strategy changes the
rule table, not the model.

A spec (``logical_to_spec``) gives, per tensor dim, the mesh axes that shard
it: None (replicated), one axis name, or a tuple of axes (major to minor),
trailing Nones dropped, as the reference's ``PartitionSpec``.
``placements`` turns a spec into DTensor placements, one per mesh dim: a
dim sharded over two axes (the batch over ("dp", "fsdp")) becomes
``Shard(d)`` on both, which DTensor splits in mesh-dim order, major to
minor, as the reference does. ``local_slices`` is the block one rank holds.
"""

from __future__ import annotations

import math
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.placement_types import Placement

from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshLike, mesh_sizes

# logical name -> mesh axis (or tuple of axes, or None for replicated)
Rules = Sequence[Tuple[str, Any]]
#: per tensor dim: None, a mesh axis, or a tuple of mesh axes (major first)
Spec = Tuple[Any, ...]

# The reference's default rules: FSDP shards weights along the embed
# dimension, TP shards the head/mlp/vocab dimensions, batch splits over
# (dp, fsdp), sequence over sp. Activation dims get their own names
# ("act_*") so one spec never uses a mesh axis twice.
DEFAULT_RULES: Rules = (
    ("batch", ("dp", "fsdp")),
    ("seq", "sp"),
    ("embed", "fsdp"),
    ("mlp", "tp"),
    ("heads", "tp"),
    ("kv", None),
    ("vocab", "tp"),
    ("expert", "ep"),
    ("layers", None),
    ("stage", "pp"),
    ("act_embed", None),
    ("act_mlp", "tp"),
    ("act_heads", "tp"),
    ("act_vocab", "tp"),
)


def rules_dict(rules: Optional[Rules] = None) -> Dict[str, Any]:
    return dict(rules if rules is not None else DEFAULT_RULES)


def pp_rules(rules: Optional[Rules] = None) -> Rules:
    """Rule table for pipeline-parallel training: the layer axis maps onto
    ``pp``, so the pipelined step's stacked layer leaves
    (``models.training.make_pp_train_step``) are cut over the stages."""
    table = rules_dict(rules)
    table["layers"] = "pp"
    return tuple(table.items())


def logical_to_spec(
    logical_axes: Sequence[Optional[str]],
    rules: Optional[Rules] = None,
    mesh: Optional[MeshLike] = None,
) -> Spec:
    """Map a tuple of logical axis names to a spec.

    Mesh axes of size 1 resolve to None so specs stay valid on small
    meshes (only when ``mesh`` is given); a mesh axis is used by one dim
    only; trailing Nones are dropped."""
    table = rules_dict(rules)
    sizes = mesh_sizes(mesh) if mesh is not None else None
    used: set = set()
    out: List[Any] = []
    for name in logical_axes:
        mapped = table.get(name) if name is not None else None
        if mapped is None:
            out.append(None)
            continue
        axes = (mapped,) if isinstance(mapped, str) else tuple(mapped)
        kept = []
        for ax in axes:
            if ax in used:
                continue
            if sizes is not None and sizes.get(ax, 1) == 1:
                continue
            kept.append(ax)
            used.add(ax)
        if not kept:
            out.append(None)
        elif len(kept) == 1:
            out.append(kept[0])
        else:
            out.append(tuple(kept))
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def spec_axes(entry: Any) -> Tuple[str, ...]:
    """The mesh axes of one spec entry, major first."""
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(mesh: MeshLike, spec: Spec) -> Tuple[Placement, ...]:
    """DTensor placements of ``spec``, one per mesh dim in ``AXIS_ORDER``:
    ``Shard(d)`` on each axis that shards dim d, ``Replicate()`` elsewhere.
    Raises where a dim's axes are not in mesh order (DTensor would split
    them in another order than the spec says)."""
    mesh_sizes(mesh)  # raises for a mesh whose axes are not AXIS_ORDER's
    where: Dict[str, int] = {}
    for d, entry in enumerate(spec):
        axes = spec_axes(entry)
        if list(axes) != sorted(axes, key=AXIS_ORDER.index):
            raise ValueError(f"dim {d} is sharded over {axes}, not in mesh order "
                             f"{AXIS_ORDER}")
        for ax in axes:
            where[ax] = d
    return tuple(Shard(where[a]) if a in where else Replicate() for a in AXIS_ORDER)


def spec_of(placements_: Sequence[Placement], ndim: int) -> Spec:
    """The spec that ``placements`` (one per mesh dim in ``AXIS_ORDER``)
    express for a tensor of ``ndim`` dims."""
    dims: List[List[str]] = [[] for _ in range(ndim)]
    for ax, p in zip(AXIS_ORDER, placements_):
        if isinstance(p, Shard):
            dims[p.dim].append(ax)
        elif not isinstance(p, Replicate):
            raise ValueError(f"unsupported placement {p} on {ax}")
    out = [None if not a else (a[0] if len(a) == 1 else tuple(a)) for a in dims]
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def local_slices(shape: Sequence[int], spec: Spec, mesh: MeshLike,
                 coord: Mapping[str, int]) -> Tuple[slice, ...]:
    """The block of a tensor of ``shape`` that the rank at ``coord`` ({axis:
    index}) holds under ``spec``: along a dim sharded over axes (a1, ..., an),
    major first, block ``((c1 * s2 + c2) * s3 + ...)`` of ``s1 * ... * sn``
    equal blocks. Raises where a dim does not divide evenly."""
    sizes = mesh_sizes(mesh)
    out = []
    for d, n in enumerate(shape):
        axes = spec_axes(spec[d]) if d < len(spec) else ()
        parts = math.prod(sizes[a] for a in axes)
        if n % parts:
            raise ValueError(f"dim {d} of size {n} does not split into {parts} "
                             f"blocks over {axes}")
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coord[a]
        step = n // parts
        out.append(slice(idx * step, (idx + 1) * step))
    return tuple(out)


def tree_shardings(mesh: MeshLike, logical_tree: Any,
                   rules: Optional[Rules] = None) -> Any:
    """Map a (nested dict or list of) logical-axis tuples to placements on
    ``mesh``."""
    if isinstance(logical_tree, Mapping):
        return {k: tree_shardings(mesh, v, rules) for k, v in logical_tree.items()}
    if isinstance(logical_tree, list):
        return [tree_shardings(mesh, v, rules) for v in logical_tree]
    return placements(mesh, logical_to_spec(logical_tree, rules, mesh))


def params_shardings(mesh: MeshLike, logical_axes: Mapping[str, Tuple],
                     rules: Optional[Rules] = None) -> Dict[str, Tuple[Placement, ...]]:
    """Placements of each parameter, from the model's table of logical axes
    (``models.gpt.param_logical_axes``: parameter name -> logical axes in the
    port's layout)."""
    return {name: placements(mesh, logical_to_spec(axes, rules, mesh))
            for name, axes in logical_axes.items()}


def batch_sharding(mesh: MeshLike, ndim: int = 2,
                   rules: Optional[Rules] = None) -> Tuple[Placement, ...]:
    """Placements of a [batch, seq, ...] input."""
    axes: List[Optional[str]] = ["batch", "seq"] + [None] * (ndim - 2)
    return placements(mesh, logical_to_spec(axes[:ndim], rules, mesh))


def replicated(mesh: MeshLike) -> Tuple[Placement, ...]:
    mesh_sizes(mesh)
    return tuple(Replicate() for _ in AXIS_ORDER)
