"""Device meshes over ``torch.distributed`` (counterpart of
``ray_tpu/parallel/mesh.py``).

One ``DeviceMesh`` whose named dimensions carry every parallel strategy:
data ("dp"), fully-sharded data ("fsdp"), pipeline ("pp"), expert ("ep"),
sequence ("sp") and tensor ("tp"), in ``AXIS_ORDER``. Ranks are laid out
row-major in that order, so tp is innermost (neighbouring ranks, the
fastest links) and dp outermost (the rarer gradient reductions, which may
cross hosts).

A mesh needs a process group first: ``parallel.launch.spawn`` starts one
over local processes (gloo on the CPU, NCCL on cards), or the caller runs
``torch.distributed.init_process_group`` itself. The world size must equal
the mesh's product.

``MeshGroups`` adds what the sharded model and train step need beyond the
mesh's one group per axis: each rank's coordinates and the group over the
data axes (dp, fsdp and sp together), built once, collectively.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from ray_tpu_torch import resolve_device

# Canonical axis order: outermost (cross-host tolerant) -> innermost.
AXIS_ORDER: Tuple[str, ...] = ("dp", "pp", "fsdp", "ep", "sp", "tp")

#: a DeviceMesh, or {axis: size} where no process group is needed (the
#: sharding rules only read sizes)
MeshLike = Union[DeviceMesh, Mapping[str, int]]


@dataclasses.dataclass(frozen=True)
class MeshSpec:
    """Declarative mesh shape. Size -1 on at most one axis means "absorb all
    remaining ranks" (like a numpy reshape).

    Example::

        MeshSpec(dp=-1, fsdp=2, tp=4).build()   # on 64 ranks -> (8, 2, 4)
    """

    dp: int = 1
    pp: int = 1
    fsdp: int = 1
    ep: int = 1
    sp: int = 1
    tp: int = 1
    # number of slices (hosts) the dp axis spans; 1 means one host
    num_slices: int = 1

    def axis_sizes(self) -> Dict[str, int]:
        return {a: getattr(self, a) for a in AXIS_ORDER}

    def resolve(self, n_devices: int) -> Dict[str, int]:
        """Fill in a single -1 axis so the product equals ``n_devices``."""
        sizes = self.axis_sizes()
        wild = [a for a, s in sizes.items() if s == -1]
        if len(wild) > 1:
            raise ValueError(f"at most one axis may be -1, got {wild}")
        fixed = math.prod(s for s in sizes.values() if s != -1)
        if wild:
            if n_devices % fixed != 0:
                raise ValueError(
                    f"{n_devices} devices not divisible by fixed axes product {fixed}"
                )
            sizes[wild[0]] = n_devices // fixed
        elif fixed != n_devices:
            raise ValueError(
                f"mesh {sizes} wants {fixed} devices but {n_devices} are present"
            )
        return sizes

    def build(self, device=None) -> DeviceMesh:
        return make_mesh(self, device)


def make_mesh(spec: MeshSpec, device=None) -> DeviceMesh:
    """A ``DeviceMesh`` over the current process group's ranks, with
    ``mesh_dim_names == AXIS_ORDER`` and the ranks laid out row-major in that
    order. ``device`` (default CUDA) gives the mesh's device type; on CUDA
    each rank uses its current device.

    With ``num_slices > 1`` the dp axis spans the slices: dp must divide by
    ``num_slices``, and the layout stays the plain row-major reshape, dp
    outermost, so the cross-slice hops are the dp reductions (the
    reference's rule for meshes without a physical slice topology)."""
    dev = resolve_device(device)
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs a process group: start ranks with "
            "ray_tpu_torch.parallel.launch.spawn or call "
            "torch.distributed.init_process_group first")
    sizes = spec.resolve(dist.get_world_size())
    if spec.num_slices > 1 and sizes["dp"] % spec.num_slices != 0:
        raise ValueError(
            f"dp={sizes['dp']} must be divisible by num_slices={spec.num_slices}")
    return init_device_mesh(dev.type, tuple(sizes[a] for a in AXIS_ORDER),
                            mesh_dim_names=AXIS_ORDER)


def single_device_mesh(device=None) -> DeviceMesh:
    return MeshSpec().build(device)


def data_axes() -> Tuple[str, ...]:
    """Mesh axes across which the global batch is split."""
    return ("dp", "fsdp")


def mesh_sizes(mesh: MeshLike) -> Dict[str, int]:
    """{axis: size} of a DeviceMesh or of such a mapping, every axis of
    ``AXIS_ORDER`` present (absent ones are 1); raises for an axis that
    ``AXIS_ORDER`` does not name."""
    if isinstance(mesh, Mapping):
        got = dict(mesh)
    else:
        got = {name: mesh.size(i) for i, name in enumerate(mesh.mesh_dim_names)}
    unknown = sorted(set(got) - set(AXIS_ORDER))
    if unknown:
        raise ValueError(f"mesh axes {unknown} are not in {AXIS_ORDER}")
    return {a: int(got.get(a, 1)) for a in AXIS_ORDER}


def mesh_summary(mesh: MeshLike) -> Dict[str, int]:
    return {a: s for a, s in mesh_sizes(mesh).items() if s > 1} or {"dp": 1}


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's blocks live on: the current card on a CUDA
    mesh, else the mesh's device type."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def subgroup(mesh: DeviceMesh, axes: Sequence[str]) -> Optional[dist.ProcessGroup]:
    """The process group of the ranks that share this rank's coordinates on
    every axis but ``axes``, its ranks ordered row-major over ``axes`` in
    ``AXIS_ORDER``; None when that group is this rank alone. Collective:
    every rank creates every such group, in the same order."""
    names = list(mesh.mesh_dim_names)
    keep = [names.index(a) for a in AXIS_ORDER if a in axes]
    size = math.prod(mesh.size(i) for i in keep)
    if size == 1:
        return None
    other = [i for i in range(len(names)) if i not in keep]
    grid = mesh.mesh.permute(*other, *keep).reshape(-1, size)
    me, mine = dist.get_rank(), None
    for row in grid.tolist():
        # new_group sorts its ranks; row-major over `keep` in AXIS_ORDER is
        # ascending global rank, so the group's ranks keep that order
        group = dist.new_group(row)
        if me in row:
            mine = group
    return mine


#: the axes over which ranks hold different tokens
DATA_AXES = ("dp", "fsdp", "sp")


@dataclasses.dataclass
class MeshGroups:
    """This rank's place in a mesh and the groups the sharded model uses.

    ``sizes`` and ``coord`` map each axis of ``AXIS_ORDER`` to its size and
    this rank's index. ``group(axis)`` is the mesh's group of one axis (None
    where the axis has size 1). ``data`` is the group over (dp, fsdp, sp),
    the axes over which ranks hold different tokens, ordered so that its
    rank is ``batch_index * sp + sp_index``; None at size 1."""

    mesh: DeviceMesh
    sizes: Dict[str, int]
    coord: Dict[str, int]
    data: Optional[dist.ProcessGroup]

    @classmethod
    def build(cls, mesh: DeviceMesh) -> "MeshGroups":
        if tuple(mesh.mesh_dim_names) != AXIS_ORDER:
            raise ValueError(f"the mesh's dims must be {AXIS_ORDER}, got "
                             f"{mesh.mesh_dim_names}")
        coord = dict(zip(AXIS_ORDER, mesh.get_coordinate()))
        return cls(mesh, mesh_sizes(mesh), coord, subgroup(mesh, DATA_AXES))

    def group(self, axis: str) -> Optional[dist.ProcessGroup]:
        return self.mesh.get_group(axis) if self.sizes[axis] > 1 else None

    @property
    def device(self) -> torch.device:
        return mesh_device(self.mesh)

    @property
    def batch_blocks(self) -> int:
        """The blocks the global batch is cut into: dp * fsdp."""
        return self.sizes["dp"] * self.sizes["fsdp"]

    @property
    def batch_index(self) -> int:
        """This rank's block of the batch (dp major, fsdp minor)."""
        return self.coord["dp"] * self.sizes["fsdp"] + self.coord["fsdp"]

    @property
    def data_size(self) -> int:
        return self.batch_blocks * self.sizes["sp"]
