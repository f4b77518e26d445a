"""Device batches and columns of the port against the reference's, on the
CPU: ``train.session.iter_device_batches`` against
tests/test_data_train_ingest.py's checks of ``DataShard.iter_device_batches``,
its mesh cut against the sharded steps' own cut (bitwise, and the same step
fed either way), and ``data.to_torch`` / ``from_torch`` against
``Dataset.to_jax`` / ``read_api.from_jax``. Every ``get`` and spawn has its
own time limit.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu
from ray_tpu import data as rt_data
from ray_tpu.data.read_api import from_jax
from ray_tpu.train.session import DataShard
from ray_tpu_torch.data import from_torch, to_torch
from ray_tpu_torch.parallel import launch
from ray_tpu_torch.train.session import iter_device_batches


@pytest.fixture(scope="module")
def ray_small():
    ray_tpu.init(num_cpus=4, log_level="ERROR")
    try:
        yield
    finally:
        ray_tpu.shutdown()


def test_iter_device_batches_matches_the_reference(ray_small):
    """The reference's test: 64 rows in batches of 16, prefetch 2, each
    batch on the device; the port's batches are tensors of the same values
    as the reference's jax arrays, and the feeder keeps ``prefetch`` uploads
    ahead of the consumer."""
    import jax

    ds = rt_data.range(64, parallelism=4).map_batches(
        lambda b, **_: {"v": b["id"].astype("float32")}
    )
    ref = [np.asarray(b["v"]) for b in DataShard(ds).iter_device_batches(batch_size=16,
                                                                          prefetch=2)]
    pulled = []

    def source():
        for batch in ds.iter_batches(batch_size=16, batch_format="numpy"):
            pulled.append(len(pulled))
            yield batch

    seen, ahead = [], []
    for batch in iter_device_batches(source(), device="cpu", prefetch=2):
        assert isinstance(batch["v"], torch.Tensor) and batch["v"].device.type == "cpu"
        ahead.append(len(pulled) - len(seen))
        seen.append(batch["v"].numpy().copy())
    assert len(seen) == len(ref) == 4
    for a, b in zip(seen, ref):
        np.testing.assert_array_equal(a, b)
    assert sum(float(s.sum()) for s in seen) == float(np.arange(64, dtype=np.float32).sum())
    # the first batch is yielded once prefetch + 1 are uploaded; the last
    # ones drain what is left
    assert ahead == [3, 3, 2, 1]
    assert isinstance(jax.numpy.asarray(ref[0]), jax.Array)


def test_iter_device_batches_copies_and_checks():
    """On the CPU a batch is a copy (not a view of the source array), a
    batch that is not a dict raises, and a mesh allows only a token
    column."""
    arr = np.arange(6, dtype=np.int64).reshape(2, 3)
    (out,) = list(iter_device_batches([{"x": arr}], device="cpu"))
    arr[0, 0] = 99
    assert int(out["x"][0, 0]) == 0
    with pytest.raises(TypeError):
        list(iter_device_batches([arr], device="cpu"))


def _cut_worker(spec: dict, microbatches: int, rank: int, world: int):
    """On each rank: the feeder's LocalBatch against the step's own cut of
    the global batch (bitwise), and one step fed either way."""
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel.mesh import MeshGroups, MeshSpec
    from ray_tpu_torch.parallel.sharding import pp_rules

    mesh = MeshSpec(**spec).build("cpu")
    groups = MeshGroups.build(mesh)
    cfg = dataclasses.replace(gpt.gpt_nano(ce_chunk=16), num_layers=2, max_seq_len=32)
    tokens = np.random.RandomState(5).randint(0, cfg.vocab_size, (8, 32))
    (fed,) = list(iter_device_batches([{"tokens": tokens}], mesh=mesh,
                                      num_microbatches=microbatches))
    lb = fed["tokens"]
    own, positions = training._local_batch(torch.from_numpy(tokens), groups,
                                           torch.device("cpu"), microbatches)
    same_cut = (all(torch.equal(a, b) for a, b in zip(lb.tensors(), own.tensors()))
                and (lb.t0, lb.global_shape) == (own.t0, own.global_shape))
    with pytest.raises(ValueError, match="only a 'tokens' column"):
        list(iter_device_batches([{"tokens": tokens, "mask": tokens}], mesh=mesh))
    opt = training.default_optimizer(1e-3)
    pipelined = microbatches > 1
    rules = pp_rules() if pipelined else None
    losses = []
    for batch in (torch.from_numpy(tokens), lb):
        state, sh = training.init_sharded_state(cfg, mesh, opt, seed=0, rules=rules,
                                                stacked=pipelined)
        if pipelined:
            step = training.make_pp_train_step(cfg, opt, mesh, num_microbatches=microbatches,
                                               rules=rules, state_shardings_tree=sh)
        else:
            step = training.make_train_step(cfg, opt, mesh=mesh, state_shardings_tree=sh)
        _, m = step(state, batch)
        losses.append((float(m["loss"]), float(m["grad_norm"])))
    return same_cut, losses


@pytest.mark.parametrize("spec,microbatches", [({"dp": 2, "sp": 2}, 1),
                                                ({"dp": 2, "pp": 2}, 2)],
                         ids=["dp2_sp2", "dp2_pp2_m2"])
def test_mesh_cut_is_the_steps_cut(spec, microbatches):
    import functools

    res = launch.spawn(functools.partial(_cut_worker, spec, microbatches), 4, device="cpu",
                       timeout=240)
    for same_cut, (global_fed, local_fed) in res:
        assert same_cut
        assert global_fed == local_fed  # bitwise: the step saw the same block
    assert len({r[1][0] for r in res}) == 1  # the metrics are global


def test_to_torch_matches_to_jax(ray_small):
    ds = rt_data.from_numpy({"x": np.arange(40, dtype=np.float32).reshape(20, 2),
                             "y": np.arange(20, dtype=np.int64)}, parallelism=4)
    want = ds.to_jax()
    got = to_torch(ds.iter_batches(batch_size=None, batch_format="numpy"), device="cpu")
    assert set(got) == set(want) == {"x", "y"}
    for name in want:
        assert got[name].device.type == "cpu"
        np.testing.assert_array_equal(got[name].numpy(), np.asarray(want[name]))
    only = to_torch(ds.iter_batches(batch_size=None, batch_format="numpy"), columns=["y"],
                    device="cpu")
    assert list(only) == ["y"]
    assert to_torch([], device="cpu") == {}


def test_from_torch_matches_from_jax(ray_small):
    values = np.arange(24, dtype=np.float32).reshape(12, 2)
    want = from_jax({"a": jnp.asarray(values)}, parallelism=3).take_all()
    got = rt_data.from_numpy(from_torch({"a": torch.from_numpy(values.copy())}),
                             parallelism=3).take_all()
    assert len(got) == len(want) == 12
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g["a"]), np.asarray(w["a"]))
    # a bare tensor is the column "data"; bf16 crosses as float32
    bare = from_torch(torch.arange(4, dtype=torch.bfloat16))
    assert list(bare) == ["data"] and bare["data"].dtype == np.float32
