"""The port's sharded GPT train loop, the body of a runtime trainer's
``train_loop_per_worker`` (counterpart of what ``JaxTrainer``
(``ray_tpu/train/trainer.py``) and ``worker_group.init_jax_distributed``
give the reference's loops).

``gpt_train_loop(config, session=..., hooks=...)`` runs on every rank of a
process group the trainer already made (ray_tpu's ``TorchTrainer`` with
``TorchConfig("nccl")`` on cards, ``"gloo"`` on the CPU):

1. builds the port's mesh over that group (``config["mesh"]``, dp absorbing
   the ranks the other axes leave);
2. builds the sharded state from seed 0, or restores it from the session's
   checkpoint (``training.restore_sharded_state`` of the tree that
   ``training.gather_state`` saved), resuming at the step after it;
3. feeds ``make_train_step`` (``make_pp_train_step`` where the mesh has
   pp > 1) from ``iter_device_batches``:
   over the session's dataset shard ``config["dataset"]`` (each rank reads
   ``batch / world`` rows of its shard a step, the ranks' rows gathered in
   rank order into the global batch, each rank uploading only its block),
   or over seeded token batches (``config["data_seed"] + step``) that differ
   each step;
4. reports ``loss``, ``grad_norm``, ``step`` and ``step_ms`` (the wall time
   since the previous report) each step, with a checkpoint every
   ``config["checkpoint_every"]`` steps (the gathered state; every rank
   gathers, rank 0 reports it). A step's report comes once the next step
   is queued (its metrics travel to the host behind it), so the card is
   not idle while the host reads them; a checkpoint's step reports at
   once, after its gather.

``session`` is any object with ``report(metrics, checkpoint=None)``,
``get_checkpoint()``, ``get_dataset_shard(name)``, ``get_world_rank()``,
``get_world_size()`` and a ``Checkpoint`` class with ``from_dict`` and
``to_dict`` (``ray_tpu.train`` is one). ``hooks.metrics`` gets the rank's
optimizer state bytes (``ray_tpu_train_optimizer_state_bytes{mode}``).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from ray_tpu_torch.models import gpt, training
from ray_tpu_torch.parallel.mesh import MeshSpec, mesh_sizes
from ray_tpu_torch.parallel.sharding import pp_rules
from ray_tpu_torch.runtime import RuntimeHooks
from ray_tpu_torch.train.session import iter_device_batches

__all__ = ["DEFAULTS", "gpt_train_loop", "model_config"]

#: the loop's config keys and their defaults
DEFAULTS: Dict[str, Any] = {
    "model": "gpt_nano",        # a config function of models.gpt
    "model_overrides": {},      # GPTConfig fields (dtypes by name, "bfloat16")
    "mesh": {},                 # MeshSpec sizes; dp absorbs the rest
    "num_microbatches": 4,      # the pipelined step's (pp > 1)
    "batch": 4,                 # global batch rows
    "seq": 32,
    "steps": 4,                 # the step count to reach (resumed runs too)
    "lr": 1e-3,
    "data_seed": 1,             # seeded batches' (batch k: data_seed + k)
    "dataset": None,            # a session dataset shard's name, else seeded
    "checkpoint_every": 0,      # 0: never
    "device": None,             # None: CUDA
}


def model_config(config: Dict[str, Any]) -> gpt.GPTConfig:
    """The loop's GPTConfig: ``config["model"]`` with its overrides."""
    over = {k: getattr(torch, v) if k in ("dtype", "param_dtype") and isinstance(v, str) else v
            for k, v in config["model_overrides"].items()}
    return dataclasses.replace(getattr(gpt, config["model"])(), **over)


def _seeded(cfg: gpt.GPTConfig, c: Dict[str, Any], start: int) -> Iterator[Dict[str, Any]]:
    for k in itertools.count(start):
        rng = np.random.RandomState(c["data_seed"] + k)
        yield {"tokens": rng.randint(0, cfg.vocab_size, (c["batch"], c["seq"]))}


def _from_shard(shard, c: Dict[str, Any], world: int, start: int) -> Iterator[Dict[str, Any]]:
    """Global batches from each rank's shard: ``batch / world`` rows of it a
    step, gathered over the world in rank order; the first ``start``
    consumed and dropped, so a resumed run sees the batches it would have."""
    if c["batch"] % world:
        raise ValueError(f"batch {c['batch']} does not split over {world} ranks")
    rows = c["batch"] // world
    mine = shard.iter_batches(batch_size=rows, batch_format="numpy")
    for k, batch in enumerate(mine):
        local = np.ascontiguousarray(batch["tokens"])
        if local.shape[0] != rows:
            return  # a short last batch: the step needs whole ones
        if world > 1:
            parts = [None] * world
            dist.all_gather_object(parts, local)
            local = np.concatenate(parts)
        if k >= start:
            yield {"tokens": local}


def _metrics_to_host(metrics: Dict[str, torch.Tensor], device: torch.device):
    """(loss and grad norm in host memory, an event at their arrival): on a
    card a copy into pinned memory queued behind the step, else the values
    (None for the event)."""
    vals = torch.stack([metrics["loss"].float(), metrics["grad_norm"].float()])
    if device.type != "cuda":
        return vals, None
    host = torch.empty(2, dtype=torch.float32, pin_memory=True)
    host.copy_(vals, non_blocking=True)
    arrived = torch.cuda.Event()
    arrived.record()
    return host, arrived


def gpt_train_loop(config: Dict[str, Any], *, session,
                   hooks: Optional[RuntimeHooks] = None) -> None:
    """Train on every rank of the current process group (see the module):
    from the session's checkpoint, if it has one, to ``config["steps"]``."""
    c = {**DEFAULTS, **config}
    unknown = set(config) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"unknown loop config keys {sorted(unknown)}")
    hooks = hooks or RuntimeHooks()
    if not dist.is_initialized():
        raise RuntimeError("gpt_train_loop needs the trainer's process group "
                           "(TorchConfig(backend)) or torch.distributed.init_process_group")
    world, rank = session.get_world_size(), session.get_world_rank()
    if (world, rank) != (dist.get_world_size(), dist.get_rank()):
        raise RuntimeError(f"the session's rank {rank} of {world} is not the process "
                           f"group's {dist.get_rank()} of {dist.get_world_size()}")
    device = torch.device("cuda" if c["device"] is None else c["device"])
    if device.type == "cpu":
        # the ranks share the host's cores (as parallel.launch.spawn does)
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // world))
    cfg = model_config(c)
    spec = MeshSpec(**{"dp": -1, **c["mesh"]})
    mesh = spec.build(device)
    pipelined = mesh_sizes(mesh)["pp"] > 1
    rules = pp_rules() if pipelined else None
    m = c["num_microbatches"] if pipelined else 1
    opt = training.default_optimizer(c["lr"])

    ck = session.get_checkpoint()
    if ck is not None:
        state, shardings = training.restore_sharded_state(
            ck.to_dict()["state"], cfg, mesh, opt, rules=rules, stacked=pipelined)
    else:
        state, shardings = training.init_sharded_state(cfg, mesh, opt, seed=0, rules=rules,
                                                       stacked=pipelined)
    start = state.step
    if pipelined:
        step_fn = training.make_pp_train_step(cfg, opt, mesh, num_microbatches=m, rules=rules,
                                              state_shardings_tree=shardings)
    else:
        step_fn = training.make_train_step(cfg, opt, mesh=mesh, state_shardings_tree=shardings)
    hooks.metrics.set_gauge(
        "ray_tpu_train_optimizer_state_bytes",
        float(sum(t.to_local().numel() * t.element_size()
                  for t in (*state.opt_state.mu, *state.opt_state.nu))),
        {"mode": "sharded"})

    if c["dataset"] is not None:
        shard = session.get_dataset_shard(c["dataset"])
        if shard is None:
            raise ValueError(f"the session has no dataset shard {c['dataset']!r}")
        source = _from_shard(shard, c, world, start)
    else:
        source = _seeded(cfg, c, start)
    batches = iter_device_batches(itertools.islice(source, c["steps"] - start), mesh=mesh,
                                  num_microbatches=m)
    reported = 0
    last = time.monotonic()
    every = c["checkpoint_every"]
    pending = None  # the step whose metrics are on their way to the host

    def report(entry, checkpoint=None):
        nonlocal last, reported
        s, host, arrived = entry
        if arrived is not None:
            arrived.synchronize()  # that step's end, not the one queued after it
        loss, norm = float(host[0]), float(host[1])
        reported += 1
        now = time.monotonic()
        session.report({"loss": loss, "grad_norm": norm, "step": s,
                        "step_ms": (now - last) * 1e3}, checkpoint=checkpoint)
        last = now

    for batch in batches:
        state, metrics = step_fn(state, batch["tokens"])
        s = state.step - 1  # the step just taken, from 0
        # copy the metrics behind the step and report the previous step's
        # now: the card keeps one step queued while the host reads a report
        # (a read right after the step would leave it idle while the host
        # launches the next step's first operators)
        host, arrived = _metrics_to_host(metrics, device)
        if pending is not None:
            report(pending)
        pending = (s, host, arrived)
        if every and (s + 1) % every == 0:
            tree = training.gather_state(state, mesh)  # collective: every rank
            report(pending, session.Checkpoint.from_dict({"state": tree}) if rank == 0 else None)
            pending = None
    if pending is not None:
        report(pending)
    if reported != c["steps"] - start:
        raise RuntimeError(f"the data ran out after {reported} of {c['steps'] - start} steps")

