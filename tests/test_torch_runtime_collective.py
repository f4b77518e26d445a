"""The port's collective marshalling (ray_tpu_torch.util.collective) over
ray_tpu.util.collective's host and ring backends, on the CPU: torch tensors
through each wrapper against the same call on numpy arrays and on
jax.Arrays, in two actor ranks of one group.

float32 results must equal the numpy call's bit for bit (the same host
arrays go through the same collective); bf16 tensors are widened to float32
on the host and narrowed once, so their result must equal the float32 sum
of the bf16 values rounded once to bf16. Tensors are 128 KiB so that the
ring backend runs its ring (it sends smaller ones through the store). Every
``get`` has its own time limit.
"""

import numpy as np
import pytest
import torch

import ray_tpu

N = 32768  # float32 elements: 128 KiB, above collective_ring_min_bytes
WORLD = 2


def _values(rank: int, seed: int) -> np.ndarray:
    return np.random.RandomState(seed * 10 + rank).randn(N).astype(np.float32)


def _rank_class():
    """The actor class, defined in a function so that it travels by value
    (the workers cannot import this test module)."""

    @ray_tpu.remote(num_cpus=0)
    class Rank:
        def __init__(self, world, rank, backend, group):
            from ray_tpu.util import collective as col

            col.init_collective_group(world, rank, backend=backend, group_name=group)
            self.rank, self.group = rank, group

        def ready(self):
            return self.rank

        def run(self, op: str, seed: int, n: int):
            """The op on numpy, jax, a float32 tensor and a bf16 tensor, in that
            order on every rank; results as numpy (bf16 widened) with the
            tensors' dtypes and types."""
            import jax.numpy as jnp

            from ray_tpu.util import collective as col

            def host(x):
                # copied at once: on the CPU a result (a restored jax.Array,
                # a numpy array from the store) may alias the received
                # buffer, which a later collective can reuse
                return np.array(x, copy=True)
            from ray_tpu_torch.util import collective as tc

            # _values(rank, seed), written out: the class travels by value
            v = np.random.RandomState(seed * 10 + self.rank).randn(n).astype(np.float32)
            g = self.group
            out = {}
            if op == "allreduce":
                out["np"] = host(col.allreduce(v.copy(), g))
                out["jax"] = host(col.allreduce(jnp.asarray(v), g))
                t = tc.allreduce(col.allreduce, torch.from_numpy(v.copy()), g)
                b = tc.allreduce(col.allreduce, torch.from_numpy(v.copy()).bfloat16(), g)
            elif op == "reducescatter":
                out["np"] = host(col.reducescatter(v.copy(), g))
                out["jax"] = host(col.reducescatter(jnp.asarray(v), g))
                t = tc.reducescatter(col.reducescatter, torch.from_numpy(v.copy()), g)
                b = tc.reducescatter(col.reducescatter, torch.from_numpy(v.copy()).bfloat16(), g)
            elif op == "allgather":
                out["np"] = np.stack([host(p) for p in col.allgather(v.copy(), g)])
                out["jax"] = np.stack([host(p) for p in col.allgather(jnp.asarray(v), g)])
                t = torch.stack(tc.allgather(col.allgather, torch.from_numpy(v.copy()), g))
                b = torch.stack(tc.allgather(col.allgather, torch.from_numpy(v.copy()).bfloat16(), g))
            elif op == "broadcast":
                out["np"] = host(col.broadcast(v.copy(), src_rank=1, group_name=g))
                out["jax"] = host(col.broadcast(jnp.asarray(v), src_rank=1, group_name=g))
                t = tc.broadcast(col.broadcast, torch.from_numpy(v.copy()), src_rank=1, group_name=g)
                b = tc.broadcast(col.broadcast, torch.from_numpy(v.copy()).bfloat16(), src_rank=1,
                                 group_name=g)
            elif op == "sendrecv":
                like = torch.zeros(n, dtype=torch.bfloat16)
                if self.rank == 0:
                    col.send(v.copy(), 1, g)
                    tc.send(col.send, torch.from_numpy(v.copy()), 1, g)
                    tc.send(col.send, torch.from_numpy(v.copy()).bfloat16(), 1, g)
                    return None
                out["np"] = host(col.recv(0, g))
                out["jax"] = out["np"]
                t = tc.recv(col.recv, torch.zeros(n), 0, g)
                b = tc.recv(col.recv, like, 0, g)
            else:
                raise ValueError(op)
            out.update(torch=t.numpy(), torch_type=type(t).__name__, torch_dtype=str(t.dtype),
                       bf16=b.float().numpy(), bf16_dtype=str(b.dtype))
            return out

    return Rank


@pytest.fixture(scope="module")
def groups():
    ray_tpu.init(num_cpus=4, log_level="WARNING")
    try:
        Rank = _rank_class()
        ranks = {backend: [Rank.remote(WORLD, r, backend, f"port-{backend}")
                           for r in range(WORLD)] for backend in ("host", "ring")}
        ray_tpu.get([a.ready.remote() for rs in ranks.values() for a in rs], timeout=90)
        yield ranks
    finally:
        ray_tpu.shutdown()


def _bf16(a: np.ndarray) -> np.ndarray:
    return torch.from_numpy(np.ascontiguousarray(a, np.float32)).bfloat16().float().numpy()


def _expected_bf16(op: str, seed: int, rank: int) -> np.ndarray:
    """The float32 result of the op on the bf16-rounded inputs, rounded
    once to bf16."""
    vals = [_bf16(_values(r, seed)) for r in range(WORLD)]
    if op == "allreduce":
        return _bf16(np.sum(np.stack(vals), axis=0))
    if op == "reducescatter":
        return _bf16(np.split(np.sum(np.stack(vals), axis=0), WORLD)[rank])
    if op == "allgather":
        return np.stack(vals)
    if op == "broadcast":
        return vals[1]
    return vals[0]  # sendrecv: rank 0's value at rank 1


@pytest.mark.parametrize("backend", ["host", "ring"])
@pytest.mark.parametrize("op", ["allreduce", "reducescatter", "allgather", "broadcast",
                                "sendrecv"])
def test_tensor_collective_matches_numpy_and_jax(groups, backend, op):
    seed = 7 * len(backend) + len(op)
    outs = ray_tpu.get([a.run.remote(op, seed, N) for a in groups[backend]], timeout=120)
    for rank, out in enumerate(outs):
        if out is None:  # the sender
            continue
        assert out["torch_type"] == "Tensor" and out["torch_dtype"] == "torch.float32"
        np.testing.assert_array_equal(out["torch"], out["np"])
        np.testing.assert_array_equal(out["jax"], out["np"])
        assert out["bf16_dtype"] == "torch.bfloat16"
        np.testing.assert_array_equal(out["bf16"], _expected_bf16(op, seed, rank))


def test_to_host_restores_device_and_dtype():
    from ray_tpu_torch.util.collective import to_host

    x = torch.arange(6, dtype=torch.bfloat16).reshape(2, 3)
    host, restore = to_host(x)
    assert host.dtype == np.float32 and host.shape == (2, 3)
    back = restore(host * 2)
    assert back.dtype == torch.bfloat16 and back.device == x.device
    assert torch.equal(back, x * 2)
    arr = np.ones(3)
    same, ident = to_host(arr)
    assert ident(same) is same
