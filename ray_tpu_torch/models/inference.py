"""Forward entry and initialisation for the port's GPT (counterparts of
``ray_tpu/models/training.py``'s ``make_forward`` and ``init_params``; the
train step is in ``models/training.py``)."""

from __future__ import annotations

from typing import Callable, Dict, Iterator, Tuple

import torch
from torch.func import functional_call

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.gpt import GPT, GPTConfig, LayerNorm


def make_forward(cfg: GPTConfig, device=None) -> Callable:
    """``forward(params, tokens) -> logits [b, t, vocab]`` float32, under
    ``torch.inference_mode``. ``params`` is the port's ``state_dict`` on
    ``device``; the module skeleton lives on the meta device, so the only
    weights in memory are the caller's."""
    dev = resolve_device(device)
    model = GPT(cfg, device="meta")

    def forward(params: Dict[str, torch.Tensor], tokens: torch.Tensor) -> torch.Tensor:
        with torch.inference_mode():
            return functional_call(model, params, (tokens.to(dev),))

    return forward


def init_draws(cfg: GPTConfig, device=None, seed: int = 0
               ) -> Iterator[Tuple[str, torch.Tensor]]:
    """``(name, tensor)`` for each parameter in turn, as ``init_params``
    draws them (the sharded init keeps a block of each and drops the rest)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    skeleton = GPT(cfg, device="meta")
    ln_scales = {
        f"{name}.weight" for name, mod in skeleton.named_modules()
        if isinstance(mod, LayerNorm)
    }
    with torch.no_grad():
        for name, p in skeleton.named_parameters():
            t = torch.empty(p.shape, dtype=cfg.param_dtype, device=dev)
            if name in ln_scales:
                t.fill_(1.0)
            elif name.endswith(".bias"):
                t.zero_()
            else:
                t.normal_(0.0, 0.02, generator=gen)
            yield name, t


def init_params(cfg: GPTConfig, device=None, seed: int = 0) -> Dict[str, torch.Tensor]:
    """A fresh ``state_dict`` in ``cfg.param_dtype`` on ``device``, drawn
    from a ``torch.Generator`` seeded with ``seed``: normal with std 0.02 for
    kernels and embeddings, zeros for biases, ones for LayerNorm scales. (The
    draws differ from the reference's ``jax.random``; carry weights across
    with ``models.convert`` to compare the two.)"""
    return dict(init_draws(cfg, device, seed))
