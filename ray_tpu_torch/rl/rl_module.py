"""RLModule: the neural policy/value container (counterpart of
``ray_tpu/rl/rl_module.py``).

Reference: rllib/core/rl_module/rl_module.py — a framework-specific module
exposing forward_inference / forward_train. Here it is one ``nn.Module``
with policy logits + value head on a device; its weights are a state dict
that travels to rollout workers (on the host, as ``get_weights`` gives it).

The layers start as flax's do, not as ``nn.Linear``'s: kernels from
``lecun_normal`` (a normal truncated at two standard deviations, scaled to
variance 1 / fan_in), biases zero. The draws come from a ``torch.Generator``
on the CPU, so a seed gives the same weights on every device.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch import DeviceLike, resolve_device

__all__ = ["DiscretePolicyModule", "RLModule", "flax_init_", "lecun_normal_"]

#: the standard deviation of a unit normal truncated to [-2, 2], by which
#: flax's variance_scaling divides so that the truncated draw keeps its
#: variance
TRUNC_STD = 0.87962566103423978


def lecun_normal_(weight: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``lecun_normal`` in place on a ``[out, in]`` weight: a unit
    normal truncated to [-2, 2], times sqrt(1 / in) / TRUNC_STD."""
    with torch.no_grad():
        nn.init.trunc_normal_(weight, 0.0, 1.0, -2.0, 2.0, generator=generator)
        return weight.mul_(math.sqrt(1.0 / weight.shape[1]) / TRUNC_STD)


def flax_init_(module: nn.Module, seed: int) -> nn.Module:
    """Every ``nn.Linear`` of ``module`` (in the order of ``modules()``)
    from ``lecun_normal_`` with a zero bias, every ``nn.LayerNorm`` to
    ones and zeros, then each module's own ``init_recurrent_(generator)``
    (the LSTM's orthogonal hidden kernels). Draws from one CPU generator
    seeded with ``seed``; ``module`` must be on the CPU."""
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, nn.Linear):
                lecun_normal_(m.weight, gen)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
        for m in module.modules():
            if hasattr(m, "init_recurrent_"):
                m.init_recurrent_(gen)
    return module


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
    """A ``DiscretePolicyModule`` drawn from ``seed`` on the CPU, moved to
    ``device``."""
    net = DiscretePolicyModule(observation_size, num_actions, hidden)
    return flax_init_(net, seed).to(device)


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
