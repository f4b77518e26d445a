"""Device batches for a train loop (counterpart of
``DataShard.iter_device_batches`` in ``ray_tpu/train/session.py``).

``iter_device_batches(batches)`` turns any iterable of numpy dicts (a
dataset shard's ``iter_batches``, a generator) into batches of tensors on the
device, ``prefetch`` uploads ahead of the consumer. On a card each batch is
staged in pinned host memory and copied with ``non_blocking`` copies on a
side stream; the consumer's stream waits on the copy's event and the
tensors are marked as used on it (``record_stream``), so batch k+1 uploads
while batch k computes and the allocator never hands a batch's memory out
while the consumer may still read it. On the CPU the batches are copied.

With a ``mesh``, each rank uploads only its block: the ``"tokens"`` column
[B, T] becomes this rank's ``training.LocalBatch`` (its rows over dp and
fsdp, its sequence chunk over sp, the rows ordered for ``num_microbatches``
as the pipelined step orders them), the cut the sharded steps make of a
global batch, so a step gets the same block either way.
"""

from __future__ import annotations

import collections
from typing import Any, Dict, Iterable, Iterator

import numpy as np
import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models.training import LocalBatch, local_batch
from ray_tpu_torch.parallel.mesh import mesh_device

__all__ = ["iter_device_batches"]


def _apply(v, fn):
    """``fn`` of a tensor, or of each tensor of a ``LocalBatch``."""
    if isinstance(v, LocalBatch):
        return LocalBatch(*(fn(t) for t in v.tensors()), v.t0, v.global_shape,
                          v.num_microbatches)
    return fn(v)


def _host(batch: Dict[str, Any], mesh, num_microbatches: int) -> Dict[str, Any]:
    """The batch's host tensors (views of its arrays), cut for ``mesh``."""
    if not isinstance(batch, dict):
        raise TypeError(f"a batch must be a dict of numpy arrays, got {type(batch).__name__}")
    out: Dict[str, Any] = {}
    for name, value in batch.items():
        # a dataset's arrays may be read-only views of the object store
        t = torch.from_numpy(np.require(value, requirements=["C", "W"]))
        if mesh is not None:
            if name != "tokens":
                raise ValueError(f"with a mesh only a 'tokens' column is cut; got {name!r}")
            t = local_batch(t, mesh, num_microbatches)
        out[name] = t
    return out


def iter_device_batches(batches: Iterable[Dict[str, Any]], *, device: DeviceLike = None,
                        prefetch: int = 2, mesh=None,
                        num_microbatches: int = 1) -> Iterator[Dict[str, Any]]:
    """Yield each numpy dict of ``batches`` as tensors on ``device``
    (default CUDA; a mesh's device where ``mesh`` is given), keeping up to
    ``prefetch`` uploads ahead of the consumer (see the module). With
    ``mesh``, ``"tokens"`` is this rank's ``LocalBatch`` and no other column
    is allowed."""
    if mesh is not None:
        dev = mesh_device(mesh)
        if device is not None and resolve_device(device).type != dev.type:
            raise ValueError(f"device {device} is not the mesh's ({mesh.device_type})")
    else:
        dev = resolve_device(device)
    if prefetch < 0:
        raise ValueError(f"prefetch must be >= 0, got {prefetch}")
    cuda = dev.type == "cuda"
    copy_stream = torch.cuda.Stream(dev) if cuda else None
    pending: "collections.deque" = collections.deque()

    def upload(batch):
        host = _host(batch, mesh, num_microbatches)
        if not cuda:
            return {n: _apply(v, torch.clone) for n, v in host.items()}, None
        host = {n: _apply(v, torch.Tensor.pin_memory) for n, v in host.items()}
        # the copies run beside the consumer's queued work; the allocator
        # reuses no block the consumer may still read (record_stream below)
        with torch.cuda.stream(copy_stream):
            out = {n: _apply(v, lambda t: t.to(dev, non_blocking=True))
                   for n, v in host.items()}
            done = torch.cuda.Event()
            done.record(copy_stream)
        return out, done

    def ready(entry):
        out, done = entry
        if done is not None:
            consumer = torch.cuda.current_stream(dev)
            consumer.wait_event(done)
            for v in out.values():
                _apply(v, lambda t: t.record_stream(consumer))
        return out

    for batch in batches:
        pending.append(upload(batch))
        if len(pending) > prefetch:
            yield ready(pending.popleft())
    while pending:
        yield ready(pending.popleft())
