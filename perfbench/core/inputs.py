"""Inputs made from ``--seed``: the weights and the token batches, on the
device, in a few large calls. The same seed gives the same tensors, so the
reference draws its own copy of the weights instead of reading the
program's."""

from __future__ import annotations

import hashlib
from typing import Dict, Iterable, Tuple

import torch

DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def stream_seed(seed: int, stream: str) -> int:
    """A 63-bit generator seed for one stream of draws from ``seed`` (any
    whole number)."""
    digest = hashlib.sha256(f"{int(seed)}/{stream}".encode()).digest()
    return int.from_bytes(digest[:8], "little") & (2 ** 63 - 1)


def generator(seed: int, stream: str, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(stream_seed(seed, stream))


def make_weights(table: Iterable[Tuple[str, Tuple[int, ...], str]], dtype: torch.dtype,
                 seed: int, device, std: float) -> Dict[str, torch.Tensor]:
    """{name: tensor} for ``table``'s (name, shape, kind) rows, in ``dtype``
    on ``device``: every "matrix" normal(0, std) from one draw of one buffer,
    every "scale" 1, every "bias" 0. Each tensor is a view of its kind's
    buffer."""
    rows = list(table)
    out = {}
    for kind in ("matrix", "scale", "bias"):
        mine = [(n, shape) for n, shape, k in rows if k == kind]
        sizes = [torch.Size(shape).numel() for _, shape in mine]
        buf = torch.empty(sum(sizes), dtype=dtype, device=device)
        if kind == "matrix":
            buf.normal_(0.0, std, generator=generator(seed, "weights", device))
        else:
            buf.fill_(1.0 if kind == "scale" else 0.0)
        for (name, shape), part in zip(mine, torch.split(buf, sizes)):
            out[name] = part.view(shape)
    return {n: out[n] for n, _, _ in rows}


def token_pool(seed: int, vocab: int, pool: int, batch: int, seq: int,
               device) -> torch.Tensor:
    """[pool, batch, seq] int64 token ids, uniform over the vocabulary."""
    return torch.randint(0, vocab, (pool, batch, seq), dtype=torch.int64, device=device,
                         generator=generator(seed, "tokens", device))
