"""Tensor marshalling around a host collective library (counterpart of
``_to_host`` in ``ray_tpu/util/collective/collective.py``).

A host collective (ray_tpu's ``host`` and ``ring`` backends) moves numpy
arrays. ``to_host(tensor)`` gives the array and a ``restore`` that puts a
result back on the tensor's device and dtype; the wrappers below take the
collective function itself as their first argument, so the port calls
``ray_tpu.util.collective.allreduce`` without importing it::

    out = collective.allreduce(rt_collective.allreduce, grad, group_name="g")

bf16 (and the float8 types), which numpy lacks, is widened to float32 on the
host: the collective reduces in float32, and ``restore`` narrows the result
to the tensor's dtype once. The reference's bf16 host sum instead adds
``ml_dtypes.bfloat16`` arrays, rounding to bf16 as it adds, so the two can
differ by a few bf16 ulps: the port's is the float32 sum rounded once. A
numpy array (or anything else) passes through as the reference's does.
"""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import numpy as np
import torch

__all__ = ["to_host", "allreduce", "allgather", "broadcast", "reducescatter", "send", "recv"]

#: torch dtypes numpy has no type for; they cross the host in float32
WIDENED = (torch.bfloat16, torch.float8_e4m3fn, torch.float8_e5m2)


def to_host(tensor: Any) -> Tuple[np.ndarray, Callable[[Any], Any]]:
    """``(numpy value, restore)``: a tensor's host copy (float32 for the
    dtypes in ``WIDENED``) and a function giving a host result back as a
    tensor on the tensor's device, in its dtype; for anything else
    ``np.asarray`` and the identity."""
    if not isinstance(tensor, torch.Tensor):
        return np.asarray(tensor), lambda out: out
    device, dtype = tensor.device, tensor.dtype
    host = tensor.detach().to("cpu", torch.float32 if dtype in WIDENED else dtype)
    return host.contiguous().numpy(), lambda out: _restore(out, device, dtype)


def _restore(out: Any, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    # a copy: a received array may be a read-only view of the runtime's
    # buffer, which the runtime reuses once the view is gone
    return torch.tensor(np.asarray(out), device=device).to(dtype)


def allreduce(fn: Callable, tensor: Any, *args, **kwargs):
    """``fn(host value, *args, **kwargs)`` restored: an all-reduce, a
    broadcast or a reduce-scatter (this rank's shard)."""
    value, restore = to_host(tensor)
    return restore(fn(value, *args, **kwargs))


broadcast = reducescatter = allreduce


def allgather(fn: Callable, tensor: Any, *args, **kwargs) -> List[Any]:
    """``fn``'s list of every rank's value, each restored."""
    value, restore = to_host(tensor)
    return [restore(part) for part in fn(value, *args, **kwargs)]


def send(fn: Callable, tensor: Any, *args, **kwargs) -> None:
    fn(to_host(tensor)[0], *args, **kwargs)


def recv(fn: Callable, like: torch.Tensor, *args, **kwargs) -> torch.Tensor:
    """``fn(*args, **kwargs)``'s value on ``like``'s device and dtype (a
    received value carries neither)."""
    return _restore(fn(*args, **kwargs), like.device, like.dtype)
