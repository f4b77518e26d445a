"""Parallelism for the port: device meshes, sharding rules, collectives,
the GPipe pipeline over ``pp`` and local process groups (counterpart of
``ray_tpu/parallel``)."""

from ray_tpu_torch.parallel.mesh import (
    AXIS_ORDER,
    MeshSpec,
    data_axes,
    make_mesh,
    mesh_summary,
    single_device_mesh,
)
from ray_tpu_torch.parallel.sharding import (
    DEFAULT_RULES,
    batch_sharding,
    logical_to_spec,
    params_shardings,
    replicated,
    tree_shardings,
)

__all__ = [
    "AXIS_ORDER",
    "MeshSpec",
    "data_axes",
    "make_mesh",
    "mesh_summary",
    "single_device_mesh",
    "DEFAULT_RULES",
    "batch_sharding",
    "logical_to_spec",
    "params_shardings",
    "replicated",
    "tree_shardings",
]
