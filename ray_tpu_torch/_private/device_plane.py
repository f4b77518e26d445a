"""Device object plane for torch tensors (counterpart of
``ray_tpu/_private/device_plane.py``).

A tensor on any device pickles as its raw bytes plus compact metadata
(shape, dtype name, device type, ``requires_grad``, the kind of tensor and,
for a DTensor, its mesh's axis names and its placements). The bytes travel
out of band:

* inside the runtime's serialize call (``RuntimeHooks.in_serialize_scope``)
  they are a lazy buffer (``RuntimeHooks.lazy_buffer``) appended to the
  object's buffers; the device->host copy runs when the object is written
  out, straight into the destination (the object store's reserved region),
  and the receiver finds the bytes by index (``get_indexed_buffer``);
* elsewhere (a plain pickle with a ``buffer_callback``) they are a
  ``PickleBuffer`` of a host copy, taken at once.

The receiver rebuilds the tensor from a view of the received bytes with no
intermediate copy: ``torch.frombuffer`` of the view, then one copy onto the
device type the tensor left (a CUDA tensor lands on the receiver's current
card, and raises where the receiver has none; a CPU tensor is copied out of
the view, which belongs to the object store). bf16 and the other dtypes
numpy lacks travel as bytes too: the dtype is a name in the metadata.

Registration goes into a pickler's dispatch table (``install``), never into
``copyreg``: a ``copyreg`` entry for ``torch.Tensor`` would reroute
``torch.save`` and multiprocessing's pickles as well. A dispatch table is
consulted by exact type, so ``install`` registers ``torch.Tensor``,
``torch.nn.Parameter`` and ``DTensor``; a tensor of another subclass, a
sparse or quantized layout, or on the meta device keeps torch's own
reducer. Each process that pickles tensors installs the plane itself
(a worker included); rebuilding needs no installation.

Transfers are accounted as the reference accounts them, through the hooks'
metrics sink: ``ray_tpu_device_transfer_bytes_total{direction}``,
``ray_tpu_device_transfer_seconds_total{direction}`` (direction
``device_to_host`` or ``host_to_device``) and ``ray_tpu_device_duty_cycle``
(the time in transfers over the time since the previous transfer ended).

``pin=True`` registers each host region with the CUDA driver
(``cudaHostRegister``) for the length of its copy, so the copy runs as a
pinned transfer instead of staging through the driver's bounce buffer; it
costs a registration per copy. The default is pageable.
"""

from __future__ import annotations

import pickle
import threading
import time
import warnings
from typing import Any, Dict, List, Optional

import torch

from ray_tpu_torch.runtime import RuntimeHooks

__all__ = ["DevicePlane", "install", "uninstall", "rebuild_tensor", "rebuild_tensor_indexed"]


def _dtensor_type():
    from torch.distributed.tensor import DTensor

    return DTensor


def _placement_desc(p) -> tuple:
    from torch.distributed.tensor import Partial, Replicate, Shard

    if isinstance(p, Shard):
        return ("shard", int(p.dim))
    if isinstance(p, Replicate):
        return ("replicate",)
    if isinstance(p, Partial):
        return ("partial", str(p.reduce_op))
    raise ValueError(f"placement {p!r} has no descriptor")


def _placement(desc: tuple):
    from torch.distributed.tensor import Partial, Replicate, Shard

    if desc[0] == "shard":
        return Shard(desc[1])
    if desc[0] == "replicate":
        return Replicate()
    return Partial(desc[1])


def _host_bytes(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bytes, flat uint8 (a view where it is contiguous)."""
    return t.detach().contiguous().reshape(-1).view(torch.uint8)


class _Registered:
    """``cudaHostRegister`` of a host region for the length of a ``with``."""

    def __init__(self, host: torch.Tensor, enabled: bool):
        self.host = host
        self.enabled = enabled and host.numel() > 0

    def __enter__(self):
        if self.enabled:
            rt = torch.cuda.cudart()
            err = rt.cudaHostRegister(self.host.data_ptr(), self.host.numel(), 0)
            if int(err) != 0:
                raise RuntimeError(f"cudaHostRegister failed with {err}")
        return self.host

    def __exit__(self, *exc):
        if self.enabled:
            torch.cuda.cudart().cudaHostUnregister(self.host.data_ptr())
        return False


def _frombuffer(view) -> torch.Tensor:
    """uint8 tensor over ``view`` (no copy). The object store hands out
    read-only views; torch warns about those, and nothing writes to them."""
    if len(view) == 0:
        return torch.empty(0, dtype=torch.uint8)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", UserWarning)
        return torch.frombuffer(view, dtype=torch.uint8)


class DevicePlane:
    """The reducer and the transfer accounting of one process.

    ``reduce(tensor)`` is the dispatch-table entry (``install`` registers
    it); ``hooks`` gives the out-of-band buffer calls and the metrics sink;
    ``pin`` registers host regions for their copies (see the module)."""

    def __init__(self, hooks: Optional[RuntimeHooks] = None, *, pin: bool = False):
        self.hooks = hooks or RuntimeHooks()
        self.pin = bool(pin)
        self._lock = threading.Lock()
        self._last_transfer_end = 0.0

    # -- accounting -----------------------------------------------------------

    def record_transfer(self, direction: str, nbytes: int, seconds: float) -> None:
        m = self.hooks.metrics
        tags = {"direction": direction}
        m.inc("ray_tpu_device_transfer_bytes_total", float(nbytes), tags)
        m.inc("ray_tpu_device_transfer_seconds_total", float(seconds), tags)
        with self._lock:
            now = time.monotonic()
            gap = now - self._last_transfer_end
            self._last_transfer_end = now
        if gap > 0:
            m.set_gauge("ray_tpu_device_duty_cycle", min(1.0, seconds / gap))

    # -- device -> host ---------------------------------------------------------

    def _writer(self, tensor: torch.Tensor):
        """The lazy buffer's write: the tensor's bytes into ``dest``."""

        def write(dest: memoryview) -> None:
            t0 = time.perf_counter()
            host = _frombuffer(dest)
            with _Registered(host, self.pin and tensor.is_cuda):
                host.copy_(_host_bytes(tensor))
            self.record_transfer("device_to_host", host.numel(), time.perf_counter() - t0)

        return write

    def reduce(self, tensor: torch.Tensor):
        """``__reduce__`` of a tensor, a ``Parameter`` or a one-rank
        ``DTensor`` (see the module); torch's own for anything else."""
        kind, local, extra = "tensor", tensor, {}
        if isinstance(tensor, torch.nn.Parameter):
            kind = "parameter"
        elif type(tensor) is not torch.Tensor and isinstance(tensor, _dtensor_type()):
            mesh = tensor.device_mesh
            if mesh.size() != 1:
                # a rank holds only its block: the whole is a collective's
                # work (training.gather_state), not a pickle's
                raise ValueError(
                    f"cannot serialize a DTensor whose mesh spans {mesh.size()} ranks; "
                    "gather it first (models.training.gather_state)")
            kind, local = "dtensor", tensor.to_local()
            extra = {"mesh_dim_names": tuple(mesh.mesh_dim_names or ()),
                     "mesh_shape": tuple(mesh.shape),
                     "placements": tuple(_placement_desc(p) for p in tensor.placements)}
        if local.layout != torch.strided or local.is_quantized or local.device.type == "meta":
            return tensor.__reduce_ex__(pickle.HIGHEST_PROTOCOL)
        meta = {"shape": tuple(local.shape), "dtype": str(local.dtype).removeprefix("torch."),
                "device": local.device.type, "requires_grad": bool(tensor.requires_grad),
                "kind": kind, **extra}
        nbytes = local.numel() * local.element_size()
        hooks = self.hooks
        if hooks.in_serialize_scope():
            index = hooks.append_oob_buffer(hooks.lazy_buffer(nbytes, self._writer(local)))
            return rebuild_tensor_indexed, (meta, index, hooks.get_indexed_buffer)
        t0 = time.perf_counter()
        host = _host_bytes(local).cpu() if local.is_cuda else _host_bytes(local).clone()
        self.record_transfer("device_to_host", nbytes, time.perf_counter() - t0)
        return rebuild_tensor, (meta, pickle.PickleBuffer(host.numpy()))

    # -- host -> device ---------------------------------------------------------

    def rebuild(self, meta: Dict[str, Any], view) -> torch.Tensor:
        dtype = getattr(torch, meta["dtype"])
        dev_type = meta["device"]
        if dev_type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError(
                    "a CUDA tensor reached a process with no card; it does not land on "
                    "the CPU by itself (move it there before it is sent)")
            device = torch.device("cuda", torch.cuda.current_device())
        elif dev_type == "cpu":
            device = torch.device("cpu")
        else:
            raise RuntimeError(f"cannot rebuild a tensor of device type {dev_type!r}")
        t0 = time.perf_counter()
        host = _frombuffer(view)
        with _Registered(host, self.pin and device.type == "cuda"):
            data = host.to(device, copy=True)
        if device.type == "cuda":
            torch.cuda.current_stream(device).synchronize()  # the view may go
        out = data.view(dtype).reshape(meta["shape"])
        self.record_transfer("host_to_device", host.numel(), time.perf_counter() - t0)
        if meta["kind"] == "parameter":
            return torch.nn.Parameter(out, requires_grad=meta["requires_grad"])
        if meta["kind"] == "dtensor":
            return _rebuild_dtensor(meta, out)
        return out.requires_grad_(meta["requires_grad"])


def _rebuild_dtensor(meta: Dict[str, Any], local: torch.Tensor):
    """A one-rank DTensor over this process's rank (no process group
    needed: the mesh makes none)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    rank = dist.get_rank() if dist.is_initialized() else 0
    shape = meta["mesh_shape"]
    mesh = DeviceMesh(local.device.type, torch.full(shape, rank, dtype=torch.int),
                      mesh_dim_names=meta["mesh_dim_names"] or None, _init_backend=False,
                      _rank=rank)
    out = _dtensor_type().from_local(local, mesh, [_placement(p) for p in meta["placements"]],
                                     run_check=False)
    return out.requires_grad_(meta["requires_grad"])


# the receiving process's accounting: the plane ``install`` made here, else
# one that accounts to no sink
_installed: Optional[DevicePlane] = None
_fallback = DevicePlane()


def rebuild_tensor(meta: Dict[str, Any], buffer) -> torch.Tensor:
    """Rebuild from an eager out-of-band buffer (``PickleBuffer``)."""
    return (_installed or _fallback).rebuild(meta, memoryview(buffer).cast("B"))


def rebuild_tensor_indexed(meta: Dict[str, Any], index: int, get_indexed_buffer):
    """Rebuild from buffer ``index`` of the object being deserialized
    (``get_indexed_buffer`` is the runtime's, pickled by reference)."""
    return (_installed or _fallback).rebuild(meta, get_indexed_buffer(index))


def _types() -> List[type]:
    return [torch.Tensor, torch.nn.Parameter, _dtensor_type()]


def install(dispatch_table, hooks: Optional[RuntimeHooks] = None, *,
            pin: bool = False) -> DevicePlane:
    """Register the plane's reducer for ``torch.Tensor``, ``Parameter`` and
    ``DTensor`` in ``dispatch_table`` (a pickler class's: cloudpickle's,
    which the runtime's pickler shares, or a ``pickle.Pickler`` subclass's
    own dict) and make it this process's receiving plane. Returns the
    plane. ``uninstall`` removes it."""
    global _installed
    plane = DevicePlane(hooks, pin=pin)
    for t in _types():
        dispatch_table[t] = plane.reduce
    _installed = plane
    return plane


def uninstall(dispatch_table) -> None:
    """Remove the entries ``install`` made in ``dispatch_table``."""
    global _installed
    for t in _types():
        dispatch_table.pop(t, None)
    _installed = None

