"""ray_tpu_torch.parallel's meshes and sharding rules against ray_tpu's.

The rules are compared in this process against JAX's on its virtual 8-device
CPU mesh: ``logical_to_spec`` on the same mesh shapes, and every parameter's
blocks under the port's placements against the blocks of JAX's
``params_shardings`` (each element of the reference's tree numbered, carried
into the port's layout by ``params_from_jax``, so the comparison follows the
converter's transposes). The DeviceMesh, DTensor's layout of those blocks and
the batch's split over two axes are checked on 8 gloo ranks
(``launch.spawn``), whose functions live in this module: it imports no JAX
at its top, so the ranks do not load it.
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import gpt, training
from ray_tpu_torch.parallel import launch, sharding
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec

MESH_SHAPES = {
    "dp2_fsdp2_tp2": dict(dp=2, fsdp=2, tp=2),
    "fsdp4_tp2": dict(fsdp=4, tp=2),
    "dp2_ep2_tp2": dict(dp=2, ep=2, tp=2),
    "fsdp2_ep2_sp2": dict(fsdp=2, ep=2, sp=2),
}
LOGICAL = [("batch", "seq", "embed"), ("embed", "mlp"), ("vocab", "embed"),
           ("batch", "seq", "act_heads", None), ("expert", "embed", "mlp"),
           ("embed", "heads", "kv"), ("heads", "kv", "embed"), ("layers", "embed")]
MOE = dict(moe_num_experts=4, moe_top_k=2)


def _jax_mesh(sizes):
    import jax

    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec

    return JMeshSpec(**sizes).build(jax.devices()[:8])


def _sizes(shape):
    return {a: shape.get(a, 1) for a in AXIS_ORDER}


def test_mesh_spec_resolve():
    spec = MeshSpec(dp=-1, tp=2)
    sizes = spec.resolve(8)
    assert sizes["dp"] == 4 and sizes["tp"] == 2
    assert MeshSpec(fsdp=-1).resolve(1) == {a: 1 for a in AXIS_ORDER}


def test_mesh_spec_errors():
    with pytest.raises(ValueError):
        MeshSpec(dp=-1, tp=-1).resolve(8)
    with pytest.raises(ValueError):
        MeshSpec(dp=3).resolve(8)
    with pytest.raises(ValueError):
        MeshSpec(dp=-1, tp=3).resolve(8)
    with pytest.raises(RuntimeError, match="process group"):
        MeshSpec().build("cpu")


@pytest.mark.parametrize("shape", sorted(MESH_SHAPES))
def test_logical_to_spec_matches_jax(shape):
    from ray_tpu.parallel import sharding as jshd

    mesh = _jax_mesh(MESH_SHAPES[shape])
    for axes in LOGICAL:
        want = tuple(jshd.logical_to_spec(axes, jshd.DEFAULT_RULES, mesh))
        got = sharding.logical_to_spec(axes, sharding.DEFAULT_RULES, _sizes(MESH_SHAPES[shape]))
        assert got == want, (axes, got, want)
    assert sharding.logical_to_spec(("batch", "seq")) == (("dp", "fsdp"), "sp")


def _jax_tree_and_shardings(jcfg, mesh):
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import sharding as jshd

    abstract = jax.eval_shape(lambda r: jgpt.GPT(jcfg).init(r, jnp.zeros((1, 8), jnp.int32)),
                              jax.random.PRNGKey(0))["params"]
    shardings = jshd.params_shardings(mesh, abstract)
    shapes = nn.meta.unbox(abstract)
    return shapes, shardings


@pytest.mark.parametrize("moe", [False, True], ids=["dense", "moe"])
@pytest.mark.parametrize("shape", ["dp2_fsdp2_tp2", "fsdp2_ep2_sp2", "dp2_ep2_tp2"])
def test_params_shardings_match_jax(shape, moe):
    """Every element of every parameter sits on the same mesh coordinates
    under the port's placements as under JAX's ``params_shardings``."""
    import jax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu_torch.models import convert

    jcfg = jgpt.gpt_nano(**(MOE if moe else {}))
    pcfg = gpt.gpt_nano(**(MOE if moe else {}))
    sizes = _sizes(MESH_SHAPES[shape])
    mesh = _jax_mesh(MESH_SHAPES[shape])
    shapes, shardings = _jax_tree_and_shardings(jcfg, mesh)
    # number every element of the reference's tree
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    offset, ids = 0, []
    for leaf in leaves:
        n = int(np.prod(leaf.shape))
        ids.append(np.arange(offset, offset + n, dtype=np.float64).reshape(leaf.shape))
        offset += n
    id_tree = jax.tree_util.tree_unflatten(treedef, ids)
    port_ids = {k: v.numpy().astype(np.int64)
                for k, v in convert.params_from_jax(id_tree, pcfg, device="cpu").items()}
    # which element ids each mesh coordinate holds under JAX's shardings
    held = {}
    shard_leaves = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    for c in np.ndindex(mesh.devices.shape):
        mask = np.zeros(offset, bool)
        for leaf_ids, sh in zip(ids, shard_leaves):
            index = sh.devices_indices_map(leaf_ids.shape)[mesh.devices[c]]
            mask[leaf_ids[index].astype(np.int64).ravel()] = True
        held[c] = mask
    place = sharding.params_shardings(sizes, gpt.param_logical_axes(pcfg))
    assert set(place) == set(port_ids)
    for name, pids in port_ids.items():
        spec = sharding.spec_of(place[name], pids.ndim)
        for c, mask in held.items():
            coord = dict(zip(AXIS_ORDER, c))
            block = pids[sharding.local_slices(pids.shape, spec, sizes, coord)].ravel()
            assert mask[block].all() and mask[pids.ravel()].sum() == block.size, (name, c)


def test_param_tables_cover_the_model():
    for cfg in (gpt.gpt_nano(), gpt.gpt_nano(**MOE), gpt.gpt_nano(parallel_residual=False,
                                                                  tie_embeddings=True)):
        shapes = {n: p.shape for n, p in gpt.GPT(cfg, device="meta").named_parameters()}
        axes = gpt.param_logical_axes(cfg)
        assert set(axes) == set(shapes) == set(gpt.param_compute_axes(cfg))
        assert all(len(axes[n]) == len(s) for n, s in shapes.items())


def test_batch_sharding_matches_jax_index_map():
    """The batch over ("dp", "fsdp"): JAX's NamedSharding index of each
    device against ``local_slices`` of the port's spec (major dp, minor
    fsdp); DTensor's own layout of it is checked on the ranks below."""
    from ray_tpu.parallel import sharding as jshd

    sizes = MESH_SHAPES["dp2_fsdp2_tp2"]
    mesh = _jax_mesh(sizes)
    want = jshd.batch_sharding(mesh).devices_indices_map((8, 16))
    spec = sharding.spec_of(sharding.batch_sharding(_sizes(sizes)), 2)
    assert spec == (("dp", "fsdp"),)
    for c in np.ndindex(mesh.devices.shape):
        got = sharding.local_slices((8, 16), spec, _sizes(sizes), dict(zip(AXIS_ORDER, c)))
        assert got == tuple(slice(s.start or 0, s.stop or n) for s, n in
                            zip(want[mesh.devices[c]], (8, 16))), c


def _mesh_worker(rank, world, full_params):
    """On each of 8 ranks: the mesh's layout, DTensor's blocks against
    ``local_slices``, the nested batch split, and a DTensor at the kernel's
    input check."""
    from torch.distributed.tensor import DTensor

    from ray_tpu_torch.ops import attention
    from ray_tpu_torch.parallel.mesh import MeshGroups

    out = {}
    mesh = MeshSpec(dp=2, fsdp=2, tp=2).build("cpu")
    out["names"] = tuple(mesh.mesh_dim_names)
    out["layout"] = mesh.mesh.numpy()
    out["slices"] = MeshSpec(dp=4, fsdp=-1, num_slices=2).build("cpu").mesh.numpy()
    try:
        MeshSpec(dp=2, fsdp=-1, num_slices=4).build("cpu")
        out["bad_slices_raise"] = False
    except ValueError:
        out["bad_slices_raise"] = True
    groups = MeshGroups.build(mesh)
    out["data_rank"] = torch.distributed.get_rank(groups.data)
    out["expected_data_rank"] = groups.batch_index * groups.sizes["sp"] + groups.coord["sp"]
    # init_sharded_state from full weights: every DTensor gathers back to them
    ok = {}
    for label, cfg, params in (("dense", gpt.gpt_nano(), full_params[0]),
                               ("moe", gpt.gpt_nano(**MOE), full_params[1])):
        state, sh = training.init_sharded_state(
            cfg, mesh, training.default_optimizer(), params={
                k: torch.from_numpy(v) for k, v in params.items()})
        ok[label] = all(
            np.array_equal(p.full_tensor().numpy(), params[n])
            and tuple(p.placements) == tuple(sh.params[n]) for n, p in state.params.items())
    out["full_tensor_equal"] = ok
    # the batch over (dp, fsdp): DTensor of local_slices' blocks gathers
    # back to the global batch
    tokens = torch.arange(8 * 16).view(8, 16)
    place = sharding.batch_sharding(mesh)
    coord = dict(zip(AXIS_ORDER, mesh.get_coordinate()))
    block = tokens[sharding.local_slices((8, 16), sharding.spec_of(place, 2), mesh, coord)]
    dt = DTensor.from_local(block.contiguous(), mesh, place, run_check=False,
                            shape=(8, 16), stride=(16, 1))
    out["batch_equal"] = bool(torch.equal(dt.full_tensor(), tokens))
    out["batch_block_rows"] = block[:, 0].tolist()
    q = torch.zeros(1, 1, 8, 16)
    qd = DTensor.from_local(q, mesh, sharding.replicated(mesh), run_check=False)
    try:
        attention._check_kernel_inputs(qd, q, q)
        out["dtensor_refused"] = False
    except ValueError as e:
        out["dtensor_refused"] = "DTensor" in str(e)
    return out


def test_device_mesh_and_dtensor_blocks_on_8_ranks():
    import jax

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtr
    from ray_tpu_torch.models import convert

    full = []
    for kw in ({}, MOE):
        tree = jtr.init_params(jgpt.gpt_nano(**kw), jax.random.PRNGKey(0), (1, 8))
        tree = jax.tree_util.tree_map(np.asarray, tree)
        full.append({k: v.numpy() for k, v in convert.params_from_jax(
            tree, gpt.gpt_nano(**kw), device="cpu").items()})
    res = launch.spawn(functools.partial(_mesh_worker, full_params=full), 8, device="cpu", timeout=240)
    for rank, r in enumerate(res):
        assert r["names"] == AXIS_ORDER
        assert np.array_equal(r["layout"].ravel(), np.arange(8))
        assert r["layout"].shape == (2, 1, 2, 1, 1, 2)
        assert r["slices"].shape == (4, 1, 2, 1, 1, 1)
        assert np.array_equal(r["slices"].ravel(), np.arange(8))
        assert r["bad_slices_raise"]
        assert r["data_rank"] == r["expected_data_rank"]
        assert r["full_tensor_equal"] == {"dense": True, "moe": True}
        assert r["batch_equal"]
        # rank = (dp * 2 + fsdp) * 2 + tp: batch block dp * 2 + fsdp of 2 rows
        block = rank // 2
        assert r["batch_block_rows"] == [16 * (2 * block), 16 * (2 * block + 1)]
        assert r["dtensor_refused"]
