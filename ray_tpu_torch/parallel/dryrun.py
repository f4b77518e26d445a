"""Multi-rank dry runs of the sharded train step (counterpart of
``__graft_entry__.py``'s ``dryrun_multichip``, ``_dryrun_ep`` and
``_dryrun_multislice``):

    python -m ray_tpu_torch.parallel.dryrun N [--device cpu|cuda]

starts N ranks (``launch.spawn``: gloo on the CPU, NCCL with one card per
rank on CUDA) and runs one train step of the reference's tiny flagship
configuration (``tiny_config``) on each mesh:

* dp / fsdp / tp / sp: tp 2 where N is even, sp 2 where 4 divides N, dp 2
  where 8 does, fsdp the rest (the reference's factoring);
* ep (N even): 4 experts, top 2, capacity factor 2, over ``MeshSpec(dp=-1,
  ep=2)``;
* multi-slice (N even): ``MeshSpec(dp=2, fsdp=-1, num_slices=2)``.

Each prints its mesh and loss; a loss that is not finite and positive
raises. The weights are drawn on the CPU, so ``--device cpu`` and
``--device cuda`` start from the same ones. The pipeline's dry run (``_dryrun_pp``) and the GPT-J-6B lowering
are not ported. The default device is CUDA, which needs N cards.
"""

from __future__ import annotations

import argparse
import functools
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
              device: str) -> Dict:
    """One train step on this rank; (mesh sizes, loss)."""
    from ray_tpu_torch.models import training
    from ray_tpu_torch.models.inference import init_params
    from ray_tpu_torch.parallel.mesh import MeshSpec, mesh_summary

    mesh = MeshSpec(**spec_kw).build(device)
    cfg = tiny_config(**cfg_kw)
    opt = training.default_optimizer(1e-3)
    # drawn on the CPU, so every device type starts from the same weights
    state, shardings = training.init_sharded_state(
        cfg, mesh, opt, params=init_params(cfg, device="cpu", seed=0))
    step = training.make_train_step(cfg, opt, mesh=mesh, state_shardings_tree=shardings)
    gen = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen)
    state, metrics = step(state, tokens)
    return {"mesh": mesh_summary(mesh), "loss": float(metrics["loss"]),
            "step": state.step}


def _worker(rank: int, world: int, device: str):
    out = {}
    tp = 2 if world % 2 == 0 else 1
    sp = 2 if world % (tp * 2) == 0 else 1
    dp = 2 if world % (tp * sp * 2) == 0 else 1
    fsdp = world // (dp * sp * tp)
    out["dp_fsdp_tp_sp"] = _run_step(dict(dp=dp, fsdp=-1, sp=sp, tp=tp), {},
                                     max(2, dp * fsdp), 64 * sp, device)
    if world % 2 == 0:
        out["ep"] = _run_step(dict(dp=-1, ep=2),
                              dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=2.0),
                              4, 64, device)
        out["multislice"] = _run_step(dict(dp=2, fsdp=-1, num_slices=2), {},
                                      2 * (world // 2) * 2, 64, device)
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, help="ranks")
    ap.add_argument("--device", default="cuda", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    for name, res in dryrun(args.n, args.device).items():
        print(f"dryrun {name} ok: mesh={res['mesh']} loss={res['loss']!r} "
              f"step={res['step']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
