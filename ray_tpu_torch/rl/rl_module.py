"""RLModule: the neural policy/value container (counterpart of
``ray_tpu/rl/rl_module.py``).

Reference: rllib/core/rl_module/rl_module.py — a framework-specific module
exposing forward_inference / forward_train. Here it is one ``nn.Module``
with policy logits + value head on a device; its weights are a state dict
that travels to rollout workers (on the host, as ``get_weights`` gives it).

The layers start as the reference's do: ``flax_init`` fills a network
with exactly what flax's ``init(jax.random.PRNGKey(seed), ...)`` gives the
reference's module of the same structure (``rl.prng`` computes JAX's and
flax's random streams in numpy), so a seed gives the reference's weights
on every device.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.rl import prng

__all__ = ["DiscretePolicyModule", "RLModule", "drawn", "flax_init"]


def _dense_init_(linear: nn.Linear, key: np.ndarray, path: Tuple[str, ...]) -> None:
    """flax's Dense at ``path``: the ``[in, out]`` kernel from lecun_normal
    (the scope's first draw), the bias zero (its second)."""
    kernel = prng.lecun_normal(prng.param_key(key, path, 1), (linear.in_features,
                                                               linear.out_features))
    linear.weight.copy_(torch.from_numpy(kernel.T))
    if linear.bias is not None:
        linear.bias.zero_()


def _init_scope_(module: nn.Module, key: np.ndarray, path: Tuple[str, ...]) -> None:
    if hasattr(module, "flax_init_"):
        module.flax_init_(key, path)
        return
    if isinstance(module, nn.Linear):
        _dense_init_(module, key, path)
    elif isinstance(module, nn.LayerNorm):
        module.weight.fill_(1.0)
        module.bias.zero_()
    for name, child in module.named_children():
        _init_scope_(child, key, (*path, name))


def flax_init(module: nn.Module, key: np.ndarray) -> nn.Module:
    """Fill ``module`` (on any device) with what flax's ``init(key, ...)``
    gives the reference's module whose submodules carry the same names: a
    ``nn.Linear`` is a Dense (lecun-normal kernel, zero bias), a
    ``nn.LayerNorm`` ones and zeros, and a module with
    ``flax_init_(key, path)`` (the LSTM cell, ``NoisyDense``) draws its own.
    ``key`` is a ``rl.prng`` key (``prng.PRNGKey(seed)``)."""
    with torch.no_grad():
        _init_scope_(module, np.asarray(key, np.uint32), ())
    return module


def drawn(module: nn.Module, seed: int, device: DeviceLike) -> nn.Module:
    """``module`` with the reference's ``init(jax.random.PRNGKey(seed),
    ...)`` weights, moved to ``device``."""
    return flax_init(module, prng.PRNGKey(seed)).to(device)


class DiscretePolicyModule(nn.Module):
    """MLP torso with categorical-policy and value heads: ``torso_i``
    (Linear + tanh), ``policy_head``, ``value_head``."""

    def __init__(self, observation_size: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64)):
        super().__init__()
        self.hidden = tuple(hidden)
        sizes = (observation_size, *self.hidden)
        for i, (n_in, n_out) in enumerate(zip(sizes, sizes[1:])):
            self.add_module(f"torso_{i}", nn.Linear(n_in, n_out))
        self.policy_head = nn.Linear(sizes[-1], num_actions)
        self.value_head = nn.Linear(sizes[-1], 1)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = obs
        for i in range(len(self.hidden)):
            x = torch.tanh(getattr(self, f"torso_{i}")(x))
        return self.policy_head(x), self.value_head(x)[..., 0]


def make_policy(observation_size: int, num_actions: int, hidden: Sequence[int],
                seed: int, device: torch.device) -> DiscretePolicyModule:
    """A ``DiscretePolicyModule`` on ``device`` with the reference's
    weights for ``seed`` (``init(jax.random.PRNGKey(seed), ...)``)."""
    return drawn(DiscretePolicyModule(observation_size, num_actions, hidden), seed, device)


def host_state_dict(module: nn.Module):
    """The module's weights as CPU tensors (the reference's
    ``jax.device_get`` of its params): copies, never views of live
    parameters."""
    return {k: v.detach().to("cpu", copy=True) for k, v in module.state_dict().items()}


class RLModule:
    """Bundles the policy network, on ``device``, with the RLModule forward
    surface."""

    def __init__(self, observation_size: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64), seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.observation_size = observation_size
        self.num_actions = num_actions
        self.net = make_policy(observation_size, num_actions, hidden, seed, self.device)

    def forward(self, obs: torch.Tensor):
        return self.net(obs)

    def forward_inference(self, obs: np.ndarray, rng: np.random.Generator):
        """Sample actions for rollout (numpy in/out): the forward on the
        device, logits and values back on the host, then Gumbel-max with
        ``rng`` and the log-probability from the host's log-sum-exp, as the
        reference samples, so a seed draws the same actions."""
        with torch.no_grad():
            x = torch.from_numpy(np.asarray(obs, np.float32)).to(self.device)
            logits, value = self.net(x)
            logits = logits.cpu().numpy()
            value = value.cpu().numpy()
        # Gumbel-max categorical sampling
        g = rng.gumbel(size=logits.shape)
        actions = np.argmax(logits + g, axis=-1)
        logp_all = logits - _logsumexp(logits)
        logp = np.take_along_axis(logp_all, actions[:, None], axis=-1)[:, 0]
        return actions.astype(np.int32), logp.astype(np.float32), value.astype(np.float32)

    def set_params(self, state_dict) -> None:
        """Load a state dict (host or device tensors) onto the module's
        device."""
        self.net.load_state_dict(state_dict)

    def get_params(self):
        return host_state_dict(self.net)


def _logsumexp(x: np.ndarray) -> np.ndarray:
    m = x.max(axis=-1, keepdims=True)
    return m + np.log(np.exp(x - m).sum(axis=-1, keepdims=True))
