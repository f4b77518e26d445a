"""Run a function on every rank of a local process group (the port's
counterpart of the reference's virtual CPU mesh, ``ray_tpu/_private/
virtual_mesh.py``: shape multi-rank logic on one host).

``spawn(fn, world_size)`` starts ``world_size`` processes (the ``spawn``
start method), joins them in one process group that rendezvouses through a
``FileStore`` in a fresh temporary directory (no network port, so runs in
parallel do not collide), calls ``fn(rank, world_size)`` on each and
returns their results in rank order. NCCL on CUDA, one card per rank (the
default, as for every entry point of the port); gloo with ``device="cpu"``. A worker's exception is raised again
in the caller with its traceback; the join has its own time limit.

``fn`` and its result are pickled: a function at a module's top level (or a
``functools.partial`` of one), and numpy arrays or Python values back.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue
import tempfile
import time
import traceback
from datetime import timedelta
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist

from ray_tpu_torch import DeviceLike, resolve_device


class WorkerError(RuntimeError):
    """A rank raised; the message carries its traceback."""


def _worker(rank: int, world_size: int, backend: str, device: str,
            store_path: str, timeout: float, jobs, results) -> None:
    joined = False
    try:
        fn = jobs.get()
        if device == "cuda":
            torch.cuda.set_device(rank)
        else:
            # the ranks share the host's cores; one intra-op pool each of the
            # default size would oversubscribe them world_size times
            torch.set_num_threads(max(1, (os.cpu_count() or 1) // world_size))
        dist.init_process_group(
            backend, store=dist.FileStore(store_path, world_size), rank=rank,
            world_size=world_size, timeout=timedelta(seconds=timeout))
        joined = True
        result = (rank, True, fn(rank, world_size))
    except BaseException:  # noqa: BLE001 — handed to the caller, which raises
        result = (rank, False, traceback.format_exc())
    # the result is in the caller's pipe before the group's teardown, which
    # can fail or stall once a peer has exited: a rank that then dies still
    # reports what its function did
    results.put(result)
    results.close()
    results.join_thread()
    if joined:
        dist.destroy_process_group()


# how long the caller still drains the queue once a rank has exited with a
# non-zero code, for a result the rank put before it died
_DRAIN_S = 2.0


def spawn(fn: Callable[[int, int], Any], world_size: int, *, backend: Optional[str] = None,
          device: DeviceLike = None, timeout: float = 120.0) -> List[Any]:
    """``[fn(0, world_size), ..., fn(world_size - 1, world_size)]``, each
    on its own process of one process group. ``device`` defaults to CUDA
    (rank r on card r; raises where there is no card), ``backend`` to NCCL
    on CUDA and gloo on the CPU. Raises ``WorkerError`` with the first
    failing rank's traceback, and ``TimeoutError`` when the ranks have not
    all returned within ``timeout`` seconds; either way every process is
    ended."""
    device = resolve_device(device).type
    if device not in ("cpu", "cuda"):
        raise ValueError(f"device must be the CPU or CUDA, got {device!r}")
    if device == "cuda" and torch.cuda.device_count() < world_size:
        raise RuntimeError(f"{world_size} ranks need {world_size} cards, "
                           f"{torch.cuda.device_count()} present")
    backend = backend or ("nccl" if device == "cuda" else "gloo")
    ctx = mp.get_context("spawn")
    jobs, results = ctx.Queue(), ctx.Queue()
    deadline = time.monotonic() + timeout
    with tempfile.TemporaryDirectory(prefix="ray_tpu_torch_spawn_") as tmp:
        procs = [ctx.Process(target=_worker, daemon=True,
                             args=(rank, world_size, backend, device,
                                   os.path.join(tmp, "store"), timeout, jobs, results))
                 for rank in range(world_size)]
        for p in procs:
            p.start()
        # fn goes through a queue, not the processes' arguments: a start
        # waits until the child has read its arguments, which it does after
        # importing the main module, so large arguments would start the
        # ranks one after another
        for _ in procs:
            jobs.put(fn)
        out: List[Any] = [None] * world_size
        reported = set()
        try:
            # drain the queue before joining: a worker blocks on a full pipe
            for _ in range(world_size):
                while True:
                    try:
                        rank, ok, value = results.get(timeout=0.5)
                        break
                    except queue.Empty:
                        pass
                    # a rank that died before it could report (it could not
                    # unpickle fn, or was killed) never puts a result; one
                    # that died after it did may have left it in the pipe
                    dead = [(r, p.exitcode) for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0) and r not in reported]
                    if dead:
                        try:
                            rank, ok, value = results.get(timeout=_DRAIN_S)
                            break
                        except queue.Empty:
                            raise WorkerError(f"rank {dead[0][0]} of {world_size} exited "
                                              f"with code {dead[0][1]} without a result"
                                              ) from None
                    if time.monotonic() > deadline:
                        raise TimeoutError(
                            f"{world_size} ranks did not all return within {timeout} s")
                if not ok:
                    raise WorkerError(f"rank {rank} of {world_size} failed:\n{value}")
                reported.add(rank)
                out[rank] = value
            for p in procs:
                p.join(max(deadline - time.monotonic(), 1.0))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5.0)
    return out
