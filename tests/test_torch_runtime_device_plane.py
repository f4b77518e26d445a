"""The port's device plane inside ray_tpu's object plane, on the CPU: each
test of tests/test_device_plane.py on torch tensors, through ray_tpu's own
serializer with the port's reducer installed in its pickler's dispatch
table (scripts/port_runtime_smoke.py's ``install_device_plane``).

Also: a jax.Array and a tensor of the same values count the same bytes in
the transfer metrics; ``torch.save`` gives the same bytes before and after
``install`` and multiprocessing keeps torch's reducer; a CUDA tensor reaching a process
without a card raises. Every ``get`` has its own time limit.
"""

import copyreg
import io
import multiprocessing.reduction

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Replicate, Shard

from ray_tpu._private import internal_metrics, serialization
from ray_tpu_torch._private import device_plane
from scripts.port_runtime_smoke import install_device_plane


@pytest.fixture
def plane():
    yield install_device_plane()
    device_plane.uninstall(serialization._Pickler.dispatch_table)


def _roundtrip(obj):
    so = serialization.serialize(obj)
    return serialization.deserialize_from(memoryview(so.to_bytes())), so


def _one_rank_mesh(*names):
    shape = (1,) * len(names)
    return DeviceMesh("cpu", torch.zeros(shape, dtype=torch.int), mesh_dim_names=names,
                      _init_backend=False, _rank=0)


def test_single_tensor_roundtrip(plane):
    x = torch.arange(1024, dtype=torch.float32).reshape(32, 32)
    y, so = _roundtrip(x)
    assert type(y) is torch.Tensor and y.device.type == "cpu"
    # the data rides out of band (one buffer, written at write_to), not in
    # the pickle stream
    assert len(so.buffers) == 1 and isinstance(so.buffers[0], serialization.LazyBuffer)
    assert len(so.meta) < 1024
    assert torch.equal(x, y)


def test_one_rank_dtensor_keeps_its_placements(plane):
    mesh = _one_rank_mesh("dp", "tp")
    x = DTensor.from_local(torch.arange(64 * 64, dtype=torch.float32).reshape(64, 64), mesh,
                           [Shard(0), Shard(1)], run_check=False)
    y, so = _roundtrip(x)
    assert len(so.buffers) == 1
    assert isinstance(y, DTensor)
    assert tuple(y.placements) == (Shard(0), Shard(1))
    assert tuple(y.device_mesh.mesh_dim_names) == ("dp", "tp")
    assert torch.equal(x.to_local(), y.to_local())


def test_multi_rank_dtensor_raises(plane):
    """A rank holds only its block (the reference raises for an array that
    is not fully addressable)."""
    mesh = DeviceMesh("cpu", torch.arange(2), mesh_dim_names=("fsdp",), _init_backend=False,
                      _rank=0)
    x = DTensor.from_local(torch.ones(4, 2), mesh, [Shard(0)], run_check=False)
    with pytest.raises(ValueError, match="spans 2 ranks"):
        serialization.serialize(x)


def test_bfloat16_and_replicated(plane):
    b = torch.arange(256, dtype=torch.bfloat16).reshape(16, 16)
    y, _ = _roundtrip(b)
    assert y.dtype == torch.bfloat16 and torch.equal(b, y)
    r = DTensor.from_local(b, _one_rank_mesh("dp"), [Replicate()], run_check=False)
    y, _ = _roundtrip(r)
    assert y.dtype == torch.bfloat16 and tuple(y.placements) == (Replicate(),)
    assert torch.equal(b, y.to_local())


def test_state_dict_tree(plane):
    w = torch.nn.Parameter(torch.ones((64, 8), dtype=torch.bfloat16))
    tree = {"w": w, "b": torch.zeros(8), "step": 7}
    out, so = _roundtrip(tree)
    assert out["step"] == 7
    assert isinstance(out["w"], torch.nn.Parameter) and out["w"].requires_grad
    assert out["w"].dtype == torch.bfloat16 and torch.equal(out["w"], w)
    assert torch.equal(out["b"], tree["b"])
    # the large leaf's bytes are not duplicated into the meta stream
    assert len(so.meta) < 4096


def test_meta_is_compact_for_large_tensors(plane):
    x = torch.zeros((1024, 1024), dtype=torch.float32)  # 4 MB
    so = serialization.serialize(x)
    assert sum(b.nbytes for b in so.buffers) >= 4 * 1024 * 1024
    assert len(so.meta) < 1024


def test_put_get_through_runtime(ray_start_regular, plane):
    import ray_tpu

    x = torch.arange(128 * 64, dtype=torch.float32).reshape(128, 64)
    ref = ray_tpu.put(x)
    y = ray_tpu.get(ref, timeout=30)
    assert type(y) is torch.Tensor and torch.equal(x, y)


def test_worker_consumes_and_returns_tensors(ray_start_regular, plane):
    """A worker gets the tensor from plasma and computes on it; a worker
    that installs the plane itself returns its tensor out of band."""
    import ray_tpu

    x = torch.arange(4096, dtype=torch.float32)
    ref = ray_tpu.put(x)

    @ray_tpu.remote
    def consume(t):
        return float(t.sum())

    @ray_tpu.remote
    def double(t):
        from ray_tpu._private import serialization as ser
        from scripts.port_runtime_smoke import install_device_plane as install

        install()
        so = ser.serialize(t * 2)
        return t * 2, len(so.buffers)

    total = ray_tpu.get(consume.remote(ref), timeout=60)
    assert total == float(np.arange(4096, dtype=np.float32).sum())
    doubled, n_buffers = ray_tpu.get(double.remote(ref), timeout=60)
    assert n_buffers == 1
    assert torch.equal(doubled, x * 2)


def test_large_arg_promoted_to_plasma(ray_start_regular, plane):
    """A large tensor argument rides the object plane, not the control RPC
    (reference: put_arg_in_object_store for >100KB args)."""
    import ray_tpu
    from ray_tpu._private.worker import get_global_worker

    x = torch.ones((1024, 1024), dtype=torch.float32)  # 4 MB

    @ray_tpu.remote
    def consume(t):
        return float(t.sum())

    core = get_global_worker().core
    spec_payloads = []
    orig = core._serialize_args

    def spy(args, kwargs):
        payload, deps, nested = orig(args, kwargs)
        spec_payloads.append((len(payload), len(deps)))
        return payload, deps, nested

    core._serialize_args = spy
    try:
        total = ray_tpu.get(consume.remote(x), timeout=60)
    finally:
        core._serialize_args = orig
    assert total == float(1024 * 1024)
    payload_len, n_deps = spec_payloads[0]
    assert payload_len < 100 * 1024  # the 4 MB rode plasma, not the RPC
    assert n_deps == 1


def _transfer_bytes():
    series = internal_metrics.get("ray_tpu_device_transfer_bytes_total")._snapshot()["series"]
    return {dict(k)["direction"]: v for k, v in series.items()}


def test_transfer_metrics_count_jax_and_torch_alike(plane):
    """The same values as a jax.Array and as a tensor: the same bytes in
    each direction of ray_tpu_device_transfer_bytes_total."""
    values = np.arange(32 * 48, dtype=np.float32).reshape(32, 48)
    deltas = []
    for obj in (jnp.asarray(values), torch.from_numpy(values.copy())):
        before = _transfer_bytes()
        _roundtrip(obj)
        after = _transfer_bytes()
        deltas.append({d: after[d] - before.get(d, 0.0) for d in after})
    assert deltas[0] == deltas[1] == {"device_to_host": values.nbytes,
                                      "host_to_device": values.nbytes}


def test_other_picklers_unchanged_by_install():
    """The plane goes into the runtime pickler's dispatch table only:
    torch.save gives the same bytes before and after install,
    multiprocessing's pickle still goes through torch's shared-memory
    reducer, and copyreg holds no entry for a tensor."""
    x = torch.arange(100, dtype=torch.float32)

    def saved():
        buf = io.BytesIO()
        torch.save(x, buf)
        return buf.getvalue()

    before = saved()
    install_device_plane()
    try:
        after = saved()
        forked = bytes(multiprocessing.reduction.ForkingPickler.dumps(x))
        assert torch.Tensor not in copyreg.dispatch_table
        assert serialization._Pickler.dispatch_table[torch.Tensor] is not None
    finally:
        device_plane.uninstall(serialization._Pickler.dispatch_table)
    assert torch.Tensor not in serialization._Pickler.dispatch_table
    assert before == after
    assert b"torch.multiprocessing.reductions" in forked and b"ray_tpu_torch" not in forked


def test_cuda_tensor_without_a_card_raises(monkeypatch):
    """A CUDA tensor reaching a process with no card raises: it does not
    land on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    meta = {"shape": (2,), "dtype": "float32", "device": "cuda", "requires_grad": False,
            "kind": "tensor"}
    with pytest.raises(RuntimeError, match="no card"):
        device_plane.rebuild_tensor(meta, np.zeros(2, np.float32).view(np.uint8))
