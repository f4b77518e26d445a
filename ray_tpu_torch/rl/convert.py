"""Weights carried between the reference's RL networks and the port's.

``params_to_state_dict(tree)`` takes a flax parameter tree as numpy arrays
(what ``jax.device_get`` gives) of ``DiscretePolicyModule``, of
``CatalogPolicy`` under any encoder, of ``QNetwork`` under every knob, of
``GaussianPolicy``, ``TwinQ`` or ``DeterministicPolicy``, and gives the
state dict of the port's module of the same name; ``state_dict_to_params`` goes back, so a
port learner's weights can be held to the reference's leaf by leaf.

The layouts:
- a Dense kernel ``[in, out]`` is a Linear weight ``[out, in]``;
- an attention ``query``/``key``/``value`` kernel ``[d, heads, head_dim]``
  is a weight ``[heads * head_dim, d]``, its bias ``[heads, head_dim]`` a
  bias ``[heads * head_dim]``; ``out``'s kernel ``[heads, head_dim, d]`` a
  weight ``[d, heads * head_dim]``;
- the LSTM's ``ii/if/ig/io`` kernels stack (in that order) into
  ``lstm.ih.weight``, ``hi/hf/hg/ho`` into ``lstm.hh.weight`` and their
  biases into ``lstm.hh.bias``;
- a LayerNorm's ``scale`` is its ``weight``;
- ``NoisyDense``'s ``w_mu``, ``b_mu``, ``w_sigma`` and ``b_sigma`` keep
  flax's names and layout (``[in, out]`` weights).

The values are copied exactly, in float32 as they come.
"""

from __future__ import annotations

from typing import Any, Dict, Mapping

import numpy as np
import torch

__all__ = ["params_to_state_dict", "state_dict_to_params"]

GATES = ("i", "f", "g", "o")
NOISY = ("w_mu", "b_mu", "w_sigma", "b_sigma")


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    for name, value in tree.items():
        path = f"{prefix}{name}"
        if isinstance(value, Mapping):
            out.update(_flatten(value, path + "."))
        else:
            out[path] = np.asarray(value)
    return out


def _nest(flat: Mapping[str, np.ndarray]) -> Dict[str, Any]:
    tree: Dict[str, Any] = {}
    for path, value in flat.items():
        *parents, leaf = path.split(".")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return tree


def params_to_state_dict(tree: Mapping[str, Any]) -> Dict[str, torch.Tensor]:
    """The port's state dict of the reference's parameter tree."""
    flat = _flatten(tree)
    out: Dict[str, np.ndarray] = {}
    lstm_prefixes = sorted({p[:-len(".ii.kernel")] for p in flat if p.endswith(".ii.kernel")})
    for prefix in lstm_prefixes:
        out[f"{prefix}.ih.weight"] = np.concatenate(
            [flat.pop(f"{prefix}.i{g}.kernel") for g in GATES], axis=1).T
        out[f"{prefix}.hh.weight"] = np.concatenate(
            [flat.pop(f"{prefix}.h{g}.kernel") for g in GATES], axis=1).T
        out[f"{prefix}.hh.bias"] = np.concatenate(
            [flat.pop(f"{prefix}.h{g}.bias") for g in GATES], axis=0)
    for path, value in flat.items():
        module, leaf = path.rsplit(".", 1)
        if leaf == "scale":
            out[f"{module}.weight"] = value
        elif leaf in NOISY:
            out[path] = value
        elif leaf == "bias":
            out[path] = value.reshape(-1)
        elif leaf == "kernel" and value.ndim == 3 and module.endswith(".out"):
            out[f"{module}.weight"] = value.reshape(-1, value.shape[-1]).T
        elif leaf == "kernel" and value.ndim == 3:
            out[f"{module}.weight"] = value.reshape(value.shape[0], -1).T
        elif leaf == "kernel":
            out[f"{module}.weight"] = value.T
        else:
            raise ValueError(f"no rule for the parameter {path!r} of shape {value.shape}")
    return {k: torch.tensor(np.ascontiguousarray(v)) for k, v in out.items()}


def state_dict_to_params(state_dict: Mapping[str, torch.Tensor], *,
                         num_heads: int = 0) -> Dict[str, Any]:
    """The reference's parameter tree (numpy) of the port's state dict.
    ``num_heads`` is the attention encoder's head count, which the port's
    flat weights do not record (needed only when the dict has one)."""
    flat = {k: v.detach().cpu().numpy() for k, v in state_dict.items()}
    out: Dict[str, np.ndarray] = {}
    for prefix in sorted({k[:-len(".ih.weight")] for k in flat if k.endswith(".ih.weight")}):
        ih, hh = flat.pop(f"{prefix}.ih.weight").T, flat.pop(f"{prefix}.hh.weight").T
        hb = flat.pop(f"{prefix}.hh.bias")
        for k, g in enumerate(GATES):
            n = hh.shape[0]
            out[f"{prefix}.i{g}.kernel"] = ih[:, k * n:(k + 1) * n]
            out[f"{prefix}.h{g}.kernel"] = hh[:, k * n:(k + 1) * n]
            out[f"{prefix}.h{g}.bias"] = hb[k * n:(k + 1) * n]
    for path, value in flat.items():
        module, leaf = path.rsplit(".", 1)
        parent, _, name = module.rpartition(".")
        in_attention = parent.endswith("attn") and name in ("query", "key", "value", "out")
        if in_attention and not num_heads:
            raise ValueError(f"{path!r} is an attention weight: pass num_heads")
        if leaf == "weight" and value.ndim == 1:  # a LayerNorm's
            out[f"{module}.scale"] = value
        elif in_attention and name == "out" and leaf == "weight":
            out[f"{module}.kernel"] = value.T.reshape(num_heads, -1, value.shape[0])
        elif in_attention and name != "out" and leaf == "weight":
            out[f"{module}.kernel"] = value.T.reshape(value.shape[1], num_heads, -1)
        elif in_attention and name != "out":
            out[path] = value.reshape(num_heads, -1)
        elif leaf == "weight":
            out[f"{module}.kernel"] = value.T
        else:
            out[path] = value
    return _nest({k: np.ascontiguousarray(v) for k, v in out.items()})
