"""Carry GPT weights between the reference's flax tree and the port.

``params_from_jax`` takes the unboxed flax ``params`` tree as numpy arrays
(``ray_tpu.models.gpt.unboxed_params`` of an init, mapped through
``np.asarray``) and returns the port's ``state_dict``; ``params_to_jax``
goes back. Both per-layer layouts of the reference are handled: stacked
``blocks/layers/...`` with a leading ``num_layers`` axis (``scan_layers=True``)
and ``blocks/layer_{i}/...`` (``scan_layers=False``): ``params_from_jax``
reads either, ``params_to_jax`` writes the one ``cfg.scan_layers`` names.

Axis map (flax kernel -> port weight; every port weight is ``[out, in]``,
the ``nn.Linear`` convention):

=========================  ======================  ===========================
flax leaf                  flax shape              port key, shape
=========================  ======================  ===========================
wte/embedding              [vocab, embed]          wte.weight [vocab, embed]
attn/{q,k,v}/kernel        [embed, heads, hd]      attn.{q,k,v}.weight [heads*hd, embed]
attn/o/kernel              [heads, hd, embed]      attn.o.weight [embed, heads*hd]
mlp/wi/kernel, bias        [embed, mlp], [mlp]     mlp.wi.weight [mlp, embed], .bias
mlp/wo/kernel, bias        [mlp, embed], [embed]   mlp.wo.weight [embed, mlp], .bias
mlp/router (MoE)           [embed, experts]        mlp.router, the same
mlp/wi, mlp/wo (MoE)       [experts, embed, mlp],  mlp.wi, mlp.wo, the same
                           [experts, mlp, embed]
ln*/scale, bias            [embed]                 ln*.weight, ln*.bias
lm_head/kernel, bias       [embed, vocab]          lm_head.weight [vocab, embed], .bias
=========================  ======================  ===========================

Per-layer keys are prefixed ``blocks.{i}.``. ``heads*hd`` is head-major
(feature ``j`` is head ``j // hd``, dim ``j % hd``), as a row-major reshape
of the flax kernel gives it.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.models.gpt import GPTConfig


def _tensor(arr: Any) -> torch.Tensor:
    a = np.array(arr)  # a writable copy, C-contiguous
    if a.dtype.name == "bfloat16":  # ml_dtypes bf16, as jax hands it over
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _numpy(t: torch.Tensor) -> np.ndarray:
    """float32 numpy (bf16 has no numpy dtype without ml_dtypes)."""
    return t.detach().to("cpu", torch.float32).numpy()


def _layer_names(cfg: GPTConfig):
    return ("ln",) if cfg.parallel_residual else ("ln1", "ln2")


def params_from_jax(tree: Dict[str, Any], cfg: GPTConfig, device=None
                    ) -> Dict[str, torch.Tensor]:
    """The port's ``state_dict`` from a flax ``params`` tree, in
    ``cfg.param_dtype`` on ``device``."""
    dev = resolve_device(device)
    d, hq = cfg.embed_dim, cfg.qkv_dim
    out: Dict[str, torch.Tensor] = {}

    def put(name, t):
        out[name] = t.to(device=dev, dtype=cfg.param_dtype).contiguous()

    put("wte.weight", _tensor(tree["wte"]["embedding"]))
    blocks = tree["blocks"]
    stacked = "layers" in blocks
    for i in range(cfg.num_layers):
        def leaf(*path):
            node = blocks["layers"] if stacked else blocks[f"layer_{i}"]
            for p in path:
                node = node[p]
            return _tensor(node[i] if stacked else node)

        pre = f"blocks.{i}."
        for ln in _layer_names(cfg):
            put(pre + ln + ".weight", leaf(ln, "scale"))
            put(pre + ln + ".bias", leaf(ln, "bias"))
        for n in "qkv":
            put(pre + f"attn.{n}.weight", leaf("attn", n, "kernel").reshape(d, hq).T)
        put(pre + "attn.o.weight", leaf("attn", "o", "kernel").reshape(hq, d).T)
        if cfg.moe_num_experts:
            for n in ("router", "wi", "wo"):
                put(pre + f"mlp.{n}", leaf("mlp", n))
        else:
            for n in ("wi", "wo"):
                put(pre + f"mlp.{n}.weight", leaf("mlp", n, "kernel").T)
                put(pre + f"mlp.{n}.bias", leaf("mlp", n, "bias"))
    put("ln_f.weight", _tensor(tree["ln_f"]["scale"]))
    put("ln_f.bias", _tensor(tree["ln_f"]["bias"]))
    if not cfg.tie_embeddings:
        put("lm_head.weight", _tensor(tree["lm_head"]["kernel"]).T)
        put("lm_head.bias", _tensor(tree["lm_head"]["bias"]))
    return out


def params_to_jax(params: Dict[str, torch.Tensor], cfg: GPTConfig,
                  stacked: Optional[bool] = None) -> Dict[str, Any]:
    """The flax ``params`` tree (float32 numpy leaves) from the port's
    ``state_dict``; ``stacked`` picks the ``blocks/layers`` layout, else
    ``blocks/layer_{i}``, and defaults to ``cfg.scan_layers``: the tree the
    reference builds for ``cfg``."""
    d, h, hd = cfg.embed_dim, cfg.num_heads, cfg.head_dim
    if stacked is None:
        stacked = cfg.scan_layers

    def layer(i):
        pre = f"blocks.{i}."
        tree: Dict[str, Any] = {
            ln: {"scale": _numpy(params[pre + ln + ".weight"]),
                 "bias": _numpy(params[pre + ln + ".bias"])}
            for ln in _layer_names(cfg)
        }
        attn = {
            n: {"kernel": _numpy(params[pre + f"attn.{n}.weight"].T).reshape(d, h, hd)}
            for n in "qkv"
        }
        attn["o"] = {"kernel": _numpy(params[pre + "attn.o.weight"].T).reshape(h, hd, d)}
        tree["attn"] = attn
        if cfg.moe_num_experts:
            tree["mlp"] = {n: _numpy(params[pre + f"mlp.{n}"])
                           for n in ("router", "wi", "wo")}
        else:
            tree["mlp"] = {
                n: {"kernel": _numpy(params[pre + f"mlp.{n}.weight"].T),
                    "bias": _numpy(params[pre + f"mlp.{n}.bias"])}
                for n in ("wi", "wo")
            }
        return tree

    layers = [layer(i) for i in range(cfg.num_layers)]
    if stacked:
        def stack(*xs):
            if isinstance(xs[0], dict):
                return {k: stack(*(x[k] for x in xs)) for k in xs[0]}
            return np.stack(xs)

        blocks = {"layers": stack(*layers)}
    else:
        blocks = {f"layer_{i}": t for i, t in enumerate(layers)}
    tree = {
        "wte": {"embedding": _numpy(params["wte.weight"])},
        "blocks": blocks,
        "ln_f": {"scale": _numpy(params["ln_f.weight"]),
                 "bias": _numpy(params["ln_f.bias"])},
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = {"kernel": _numpy(params["lm_head.weight"].T),
                           "bias": _numpy(params["lm_head.bias"])}
    return tree
