"""Multi-rank dry runs of the sharded train step (counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``, which ``ray_tpu_torch.entry``
names the same, ``_dryrun_pp``,
``_dryrun_ep`` and ``_dryrun_multislice``) and the GPT-J-6B per-card
sizing (counterpart of its ``_aot_gpt_j_6b``):

    python -m ray_tpu_torch.parallel.dryrun N [--device cpu|cuda]

starts N ranks (``launch.spawn``: gloo on the CPU, NCCL with one card per
rank on CUDA) and runs one train step of the reference's tiny flagship
configuration (``tiny_config``) on each mesh:

* dp / fsdp / tp / sp: tp 2 where N is even, sp 2 where 4 divides N, dp 2
  where 8 does, fsdp the rest (the reference's factoring);
* pp (N even): the pipelined step (``make_pp_train_step``, 2 microbatches,
  ``sharding.pp_rules``) over ``MeshSpec(dp=-1, pp=2, fsdp=..., tp=...)``,
  tp 2 where 4 divides N and fsdp 2 where 8 does (the reference's
  factoring), batch 2 * dp * fsdp;
* ep (N even): 4 experts, top 2, capacity factor 2, over ``MeshSpec(dp=-1,
  ep=2)``;
* multi-slice (N even): ``MeshSpec(dp=2, fsdp=-1, num_slices=2)``.

Each prints its mesh and loss; a loss that is not finite and positive
raises. The weights are drawn on the CPU, so ``--device cpu`` and
``--device cuda`` start from the same ones. The default device is CUDA,
which needs N cards.

Then it prints ``gpt_j_6b_sizing()``: the state each card holds at rest
when gpt_j_6b (bf16 parameters) trains on 64 cards as ``fsdp8 x tp8`` and
as ``pp4 x fsdp8 x tp2`` under ``pp_rules``, from shapes alone. PyTorch has
no ahead-of-time lowering for a TPU, so this is what the reference's
lowering reports, less the lowering.
"""

from __future__ import annotations

import argparse
import functools
import itertools
import math
import sys
from typing import Dict

import torch

from ray_tpu_torch.parallel import launch


def tiny_config(**kw):
    """The reference's tiny flagship (``__graft_entry__.py``
    ``_flagship_config(tiny=True)``): gpt structure, float32."""
    from ray_tpu_torch.models.gpt import GPTConfig

    return GPTConfig(vocab_size=512, num_layers=4, num_heads=8, head_dim=32,
                     embed_dim=256, mlp_dim=1024, max_seq_len=256, rotary_dim=16,
                     dtype=torch.float32, **kw)


def _run_step(spec_kw: Dict[str, int], cfg_kw: Dict, batch: int, seq: int,
              device: str, microbatches: int = 0) -> Dict:
    """One train step on this rank; (mesh sizes, loss). With
    ``microbatches`` the pipelined step, over that many microbatches, under
    ``pp_rules``."""
    from ray_tpu_torch.models import training
    from ray_tpu_torch.models.inference import init_params
    from ray_tpu_torch.parallel.mesh import MeshSpec, mesh_summary
    from ray_tpu_torch.parallel.sharding import pp_rules

    mesh = MeshSpec(**spec_kw).build(device)
    cfg = tiny_config(**cfg_kw)
    opt = training.default_optimizer(1e-3)
    rules = pp_rules() if microbatches else None
    # drawn on the CPU, so every device type starts from the same weights
    state, shardings = training.init_sharded_state(
        cfg, mesh, opt, params=init_params(cfg, device="cpu", seed=0), rules=rules,
        stacked=bool(microbatches))
    if microbatches:
        step = training.make_pp_train_step(cfg, opt, mesh, num_microbatches=microbatches,
                                           rules=rules, state_shardings_tree=shardings)
    else:
        step = training.make_train_step(cfg, opt, mesh=mesh, state_shardings_tree=shardings)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    state, metrics = step(state, tokens)
    return {"mesh": mesh_summary(mesh), "loss": float(metrics["loss"]),
            "step": state.step}


def run_pp(rank: int, world: int, device: str) -> Dict:
    """The pp dry run on this rank (``world`` even)."""
    tp = 2 if world % 4 == 0 else 1
    fsdp = 2 if world % (2 * tp * 2) == 0 else 1
    dp = world // (2 * fsdp * tp)
    return _run_step(dict(dp=-1, pp=2, fsdp=fsdp, tp=tp), {}, 2 * dp * fsdp, 64, device,
                     microbatches=2)


def _worker(rank: int, world: int, device: str):
    out = {}
    tp = 2 if world % 2 == 0 else 1
    sp = 2 if world % (tp * 2) == 0 else 1
    dp = 2 if world % (tp * sp * 2) == 0 else 1
    fsdp = world // (dp * sp * tp)
    out["dp_fsdp_tp_sp"] = _run_step(dict(dp=dp, fsdp=-1, sp=sp, tp=tp), {},
                                     max(2, dp * fsdp), 64 * sp, device)
    if world % 2 == 0:
        out["pp"] = run_pp(rank, world, device)
        out["ep"] = _run_step(dict(dp=-1, ep=2),
                              dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=2.0),
                              4, 64, device)
        out["multislice"] = _run_step(dict(dp=2, fsdp=-1, num_slices=2), {},
                                      2 * (world // 2) * 2, 64, device)
    return out


#: the reference's two 64-card layouts of gpt_j_6b (``_aot_gpt_j_6b``):
#: (label, mesh sizes, pipelined under pp_rules)
GPT_J_LAYOUTS = (("fsdp8 x tp8", {"fsdp": 8, "tp": 8}, False),
                 ("pp4 x fsdp8 x tp2", {"pp": 4, "fsdp": 8, "tp": 2}, True))


def gpt_j_6b_sizing() -> Dict[str, Dict]:
    """The state each of 64 cards holds at rest when gpt_j_6b (bf16
    parameters) trains as ``GPT_J_LAYOUTS`` say (b=16, t=2048 in the
    reference; the state does not depend on them), from shapes alone, with
    no process group: every parameter's placements (``state_shardings``;
    the pipelined layout under ``pp_rules``), each rank's blocks by
    ``local_slices`` at every coordinate, and the largest rank's bytes.
    Parameters, gradients and both Adam moments are in ``cfg.param_dtype``
    (the port's optimizer keeps the moments in the parameters' dtype).
    Per layout: the mesh, each parameter's block on the largest rank
    (``local_shapes``) and its GiB by part and dtype. Activations are not
    counted."""
    from ray_tpu_torch.models import gpt, training
    from ray_tpu_torch.parallel.mesh import AXIS_ORDER, mesh_sizes
    from ray_tpu_torch.parallel.sharding import local_slices, pp_rules, spec_of

    cfg = gpt.gpt_j_6b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)
    per_layer = dict(gpt.GPT(cfg, device="meta").named_parameters())
    elem = torch.tensor([], dtype=cfg.param_dtype).element_size()
    dtype = str(cfg.param_dtype).replace("torch.", "")
    out = {}
    for label, sizes, pipelined in GPT_J_LAYOUTS:
        shapes = gpt.stack_layers(per_layer, cfg) if pipelined else per_layer
        place = training.state_shardings(sizes, cfg, pp_rules() if pipelined else None,
                                         stacked=pipelined).params
        specs = {n: spec_of(place[n], p.ndim) for n, p in shapes.items()}
        full = mesh_sizes(sizes)
        largest, local_shapes = -1, None
        for c in itertools.product(*(range(full[a]) for a in AXIS_ORDER)):
            coord = dict(zip(AXIS_ORDER, c))
            blocks = {n: tuple(s.stop - s.start for s in
                               local_slices(p.shape, specs[n], sizes, coord))
                      for n, p in shapes.items()}
            n_bytes = elem * sum(math.prod(b) for b in blocks.values())
            if n_bytes > largest:
                largest, local_shapes = n_bytes, blocks
        gib = {dtype: largest / 2 ** 30}
        out[label] = {"mesh": full, "num_params": cfg.num_params(),
                      "local_shapes": local_shapes,
                      "gib": {part: gib for part in ("params", "grads", "adam_mu", "adam_nu")}}
    return out


def dryrun(n: int, device: str = "cuda", timeout: float = 600.0) -> Dict:
    """Every dry run on ``n`` ranks; rank 0's results. Raises where a loss is
    not finite and positive, and on CUDA where fewer than ``n`` cards are
    present."""
    if device == "cuda" and torch.cuda.device_count() < n:
        raise RuntimeError(
            f"the dry run on {n} ranks needs {n} cards on CUDA, "
            f"{torch.cuda.device_count()} present; pass --device cpu to run it "
            f"over gloo on the CPU")
    results = launch.spawn(functools.partial(_worker, device=device), n,
                           device=device, timeout=timeout)
    for name, res in results[0].items():
        if not (res["loss"] > 0 and math.isfinite(res["loss"])):
            raise RuntimeError(f"dry run {name}: bad loss {res['loss']}")
    return results[0]


def report(n: int, device: str = "cuda") -> Dict:
    """``dryrun(n, device)``, each run's mesh and loss printed, then
    ``gpt_j_6b_sizing()`` printed; rank 0's results."""
    results = dryrun(n, device)
    for name, res in results.items():
        print(f"dryrun {name} ok: mesh={res['mesh']} loss={res['loss']!r} "
              f"step={res['step']}")
    for label, res in gpt_j_6b_sizing().items():
        gib = res["gib"]
        parts = ", ".join(f"{part} " + ", ".join(f"{v:.4f} GiB {d}" for d, v in by.items())
                          for part, by in gib.items())
        total = sum(v for by in gib.values() for v in by.values())
        print(f"gpt-j-6b sizing [{label}]: {res['num_params'] / 1e9:.2f}B parameters; the "
              f"largest of 64 ranks holds {parts}: {total:.4f} GiB of state at rest "
              f"(from shapes; activations not counted)")
    return results


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    report(args.n, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
