"""Model catalog: config-driven policy/value network construction
(counterpart of ``ray_tpu/rl/catalog.py``).

Reference surface: rllib/models/catalog.py (MODEL_DEFAULTS +
ModelCatalog.get_model_v2 building fcnet/conv/LSTM/attention torsos from a
model config dict) and rllib/models/torch/attention_net.py (GTrXL-style
episodic attention). Recurrent state is an explicit carry, as in the
reference, rather than hidden module state.

Each layer computes what its flax counterpart computes, which is not
always torch's default: ``gelu`` is the tanh approximation; the LSTM cell
is flax's ``OptimizedLSTMCell`` (carry ``(c, h)``, input kernels without a
bias, hidden kernels with one, gates i, f, g, o, orthogonal hidden
kernels); attention is flax's ``SelfAttention`` (per-head query, key and
value with biases, q scaled by 1/sqrt(head_dim), a float32 softmax with no
mask, an output projection); LayerNorm's epsilon is 1e-6. The attention is
plain PyTorch, as the reference's runs through XLA and no kernel: its
softmax over a 5-step window has nothing to gain from the flash kernels.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.rl.rl_module import flax_init_

__all__ = ["AttentionEncoder", "CatalogPolicy", "LSTMCell", "LSTMEncoder", "MLPEncoder",
           "ModelConfig", "get_model"]

_ACTIVATIONS = {
    "tanh": torch.tanh,
    "relu": F.relu,
    "gelu": lambda x: F.gelu(x, approximate="tanh"),  # flax's nn.gelu
    "silu": F.silu,
}

#: flax nn.LayerNorm's epsilon
LN_EPS = 1e-6


@dataclasses.dataclass
class ModelConfig:
    """The MODEL_DEFAULTS analogue (reference: catalog.py MODEL_DEFAULTS)."""

    fcnet_hiddens: Tuple[int, ...] = (64, 64)
    fcnet_activation: str = "tanh"
    use_lstm: bool = False
    lstm_cell_size: int = 64
    use_attention: bool = False
    attention_dim: int = 64
    attention_num_heads: int = 2


class MLPEncoder(nn.Module):
    """``fc_i`` Linear layers, each followed by the activation."""

    def __init__(self, in_features: int, hiddens: Sequence[int], activation: str = "tanh"):
        super().__init__()
        self.act = _ACTIVATIONS[activation]
        self.hiddens = tuple(hiddens)
        sizes = (in_features, *self.hiddens)
        for i, (n_in, n_out) in enumerate(zip(sizes, sizes[1:])):
            self.add_module(f"fc_{i}", nn.Linear(n_in, n_out))
        self.out_features = sizes[-1]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.hiddens)):
            x = self.act(getattr(self, f"fc_{i}")(x))
        return x


class LSTMCell(nn.Module):
    """flax's ``OptimizedLSTMCell``: ``ih`` holds the input kernels
    ii/if/ig/io (no bias), ``hh`` the hidden kernels hi/hf/hg/ho and their
    biases, both stacked in gate order i, f, g, o along the output."""

    def __init__(self, in_features: int, cell_size: int):
        super().__init__()
        self.cell_size = cell_size
        self.ih = nn.Linear(in_features, 4 * cell_size, bias=False)
        self.hh = nn.Linear(cell_size, 4 * cell_size)

    def init_recurrent_(self, generator: torch.Generator) -> None:
        """flax's ``orthogonal()`` for each hidden kernel, gate by gate."""
        n = self.cell_size
        with torch.no_grad():
            for k in range(4):
                q = torch.empty(n, n)
                nn.init.orthogonal_(q, generator=generator)
                self.hh.weight[k * n:(k + 1) * n].copy_(q)

    def forward(self, carry: Tuple[torch.Tensor, torch.Tensor], x: torch.Tensor):
        c, h = carry
        i, f, g, o = (self.hh(h) + self.ih(x)).chunk(4, dim=-1)
        new_c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
        new_h = torch.sigmoid(o) * torch.tanh(new_c)
        return (new_c, new_h), new_h


class LSTMEncoder(nn.Module):
    """MLP torso + LSTM cell with EXPLICIT carry (functional recurrence).

    ``forward(x, carry)`` consumes one timestep [B, obs] and returns
    (features, new_carry), the carry flax's ``(c, h)``;
    ``initial_carry(batch)`` builds zeros."""

    def __init__(self, in_features: int, hiddens: Sequence[int], cell_size: int = 64,
                 activation: str = "tanh"):
        super().__init__()
        self.torso = MLPEncoder(in_features, hiddens, activation)
        self.lstm = LSTMCell(self.torso.out_features, cell_size)
        self.cell_size = cell_size
        self.out_features = cell_size

    def forward(self, x: torch.Tensor, carry):
        carry, out = self.lstm(carry, self.torso(x))
        return out, carry

    def initial_carry(self, batch: int):
        zeros = torch.zeros(batch, self.cell_size, device=self.lstm.hh.weight.device)
        return (zeros, zeros)


class SelfAttention(nn.Module):
    """flax's ``SelfAttention(num_heads, qkv_features=dim)`` over [B, M, d]
    with out_features d: ``query``/``key``/``value`` Linear d -> heads x
    head_dim (flax's [d, heads, head_dim] kernels, [heads, head_dim]
    biases), ``out`` heads x head_dim -> d."""

    def __init__(self, in_features: int, qkv_features: int, num_heads: int):
        super().__init__()
        if qkv_features % num_heads:
            raise ValueError(f"qkv_features {qkv_features} is not a multiple of "
                             f"num_heads {num_heads}")
        self.num_heads, self.head_dim = num_heads, qkv_features // num_heads
        self.query = nn.Linear(in_features, qkv_features)
        self.key = nn.Linear(in_features, qkv_features)
        self.value = nn.Linear(in_features, qkv_features)
        self.out = nn.Linear(qkv_features, in_features)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, m, _ = x.shape
        split = lambda t: t.view(b, m, self.num_heads, self.head_dim)  # noqa: E731
        q = split(self.query(x)) / math.sqrt(self.head_dim)
        k, v = split(self.key(x)), split(self.value(x))
        weights = torch.softmax(torch.einsum("bqhd,bkhd->bhqk", q, k).float(), dim=-1)
        y = torch.einsum("bhqk,bkhd->bqhd", weights.to(v.dtype), v)
        return self.out(y.reshape(b, m, self.num_heads * self.head_dim))


class AttentionEncoder(nn.Module):
    """GTrXL-flavored episodic attention over a trailing memory window
    (reference: models/torch/attention_net.py:37). Input is the stacked
    window [B, M, obs]; the newest step's features come out."""

    def __init__(self, in_features: int, hiddens: Sequence[int], dim: int = 64,
                 num_heads: int = 2, activation: str = "tanh"):
        super().__init__()
        self.torso = MLPEncoder(in_features, hiddens, activation)
        self.proj = nn.Linear(self.torso.out_features, dim)
        self.attn = SelfAttention(dim, dim, num_heads)
        self.ln = nn.LayerNorm(dim, eps=LN_EPS)
        self.out_features = dim

    def forward(self, window: torch.Tensor) -> torch.Tensor:
        x = self.proj(self.torso(window))
        x = self.ln(x + self.attn(x))  # GTrXL-ish residual gate
        return x[:, -1, :]  # newest timestep's representation


class CatalogPolicy(nn.Module):
    """Encoder (from config) + categorical-policy and value heads."""

    def __init__(self, observation_size: int, num_actions: int, config: ModelConfig):
        super().__init__()
        self.config = cfg = config
        if cfg.use_lstm:
            self.encoder = LSTMEncoder(observation_size, cfg.fcnet_hiddens,
                                       cfg.lstm_cell_size, cfg.fcnet_activation)
        elif cfg.use_attention:
            self.encoder = AttentionEncoder(observation_size, cfg.fcnet_hiddens,
                                            cfg.attention_dim, cfg.attention_num_heads,
                                            cfg.fcnet_activation)
        else:
            self.encoder = MLPEncoder(observation_size, cfg.fcnet_hiddens,
                                      cfg.fcnet_activation)
        self.policy_head = nn.Linear(self.encoder.out_features, num_actions)
        self.value_head = nn.Linear(self.encoder.out_features, 1)

    def forward(self, obs: torch.Tensor, carry: Any = None):
        if self.config.use_lstm:
            feats, carry = self.encoder(obs, carry)
        else:
            feats = self.encoder(obs)
        logits = self.policy_head(feats)
        value = self.value_head(feats)[..., 0]
        if self.config.use_lstm:
            return logits, value, carry
        return logits, value


def get_model(num_actions: int, config: Optional[ModelConfig] = None, *,
              observation_size: int, seed: int = 0,
              device: DeviceLike = None) -> CatalogPolicy:
    """The ModelCatalog.get_model_v2 analogue: config dict/dataclass in, a
    policy out, initialised as flax initialises it (from ``seed``, on the
    CPU) and moved to ``device``. Unlike flax, torch needs the input width
    up front: ``observation_size``."""
    if isinstance(config, dict):
        config = ModelConfig(**config)
    dev = resolve_device(device)
    policy = CatalogPolicy(observation_size, num_actions, config or ModelConfig())
    return flax_init_(policy, seed).to(dev)
