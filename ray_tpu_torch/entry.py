"""The port's driver entry points (counterpart of ``__graft_entry__.py``).

- ``flagship_config(tiny)``: the flagship GPT configuration, gpt_1b with
  bf16 compute and parameters, or the tiny flagship (the same structure
  scaled to run anywhere: vocab 512, 4 layers, 8 heads x 32, embed 256, mlp
  1024, max_seq 256, rotary 16, float32).
- ``entry(device=None)`` returns ``(forward, (params, tokens))``: the
  forward step of ``models.inference.make_forward`` and its example
  arguments, seed-0 parameters and zero tokens at batch 1 and seq 512 (or
  ``max_seq_len`` where that is shorter). The reference picks the tiny
  flagship by the platform it finds; the port by the device asked: the
  tiny flagship where the caller asks for the CPU, gpt_1b in bf16
  everywhere else. ``None`` is CUDA (``resolve_device``), which raises
  with no card present.
- ``dryrun_multichip(n, device=None)``: one train step of each sharded
  layout on ``n`` ranks (``parallel.dryrun``), printed as the reference's.

    python -m ray_tpu_torch.entry [N] [--device cpu|cuda]

runs the forward once and prints its logits' shape and dtype, or with N
the dry run on N ranks.
"""

from __future__ import annotations

import argparse
import sys
from typing import Callable, Dict, Tuple

import torch

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.models.gpt import GPTConfig, gpt_1b
from ray_tpu_torch.models.inference import init_params, make_forward
from ray_tpu_torch.parallel import dryrun


def flagship_config(tiny: bool = False) -> GPTConfig:
    """gpt_1b with bf16 compute and parameters, or with ``tiny`` the tiny
    flagship (``parallel.dryrun.tiny_config``): the reference's
    ``_flagship_config``."""
    if tiny:
        return dryrun.tiny_config()
    return gpt_1b(dtype=torch.bfloat16, param_dtype=torch.bfloat16)


def entry(device: DeviceLike = None) -> Tuple[Callable, Tuple[Dict[str, torch.Tensor],
                                                             torch.Tensor]]:
    """``(forward, (params, tokens))`` for one forward of the flagship on
    ``device``: ``forward(params, tokens) -> logits [1, seq, vocab]``
    float32, ``params`` drawn from seed 0 on the device, ``tokens`` zeros
    [1, seq] with seq 512 or the config's ``max_seq_len`` where shorter."""
    dev = resolve_device(device)
    cfg = flagship_config(tiny=dev.type == "cpu")
    batch, seq = 1, min(512, cfg.max_seq_len)
    params = init_params(cfg, device=dev, seed=0)
    tokens = torch.zeros((batch, seq), dtype=torch.long, device=dev)
    return make_forward(cfg, dev), (params, tokens)


def dryrun_multichip(n: int, device: DeviceLike = None) -> Dict:
    """Every dry run of ``parallel.dryrun`` on ``n`` ranks of ``device``'s
    type (CUDA by default, one card a rank; the CPU over gloo), printed;
    rank 0's results. Raises where a loss is not finite and positive."""
    return dryrun.report(n, resolve_device(device).type)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n", type=int, nargs="?", help="ranks of the dry run")
    ap.add_argument("--device", choices=("cpu", "cuda"))
    args = ap.parse_args(argv)
    if args.n is not None:
        dryrun_multichip(args.n, args.device)
        return 0
    fn, fn_args = entry(args.device)
    out = fn(*fn_args)
    print("entry ok:", tuple(out.shape), out.dtype)
    return 0


if __name__ == "__main__":
    sys.exit(main())
