"""MARWIL / BC: offline policy learning from logged SampleBatches
(counterpart of ``ray_tpu/rl/bc.py``).

Reference surface: rllib/algorithms/marwil/ (marwil.py config + the
advantage-weighted loss in marwil_torch_policy.py) and rllib/algorithms/bc/
(bc.py: MARWIL with ``beta=0`` — plain behavior cloning). Same relationship
here: ``BCConfig`` is ``MARWILConfig(beta=0)``.

The loss per (s, a, R): ``-exp(beta * (R - V(s))/norm) * log pi(a|s)`` with
a squared-error value head; at beta=0 the weight is 1 and the value head
still trains (harmless) but cannot influence the policy. The data comes
from an offline dataset (``rl.offline``, read through ``config.hooks``);
the policy, its optimizer state (optax's ``adam``, no clip) and the moving
advantage normaliser live on ``config.device``.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rl import offline
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.learner import AdamParams, Tensors, host_metrics, log_probs
from ray_tpu_torch.rl.rl_module import host_state_dict, make_policy
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.runtime import RuntimeHooks

__all__ = ["BC", "BCConfig", "MARWIL", "MARWILConfig", "monte_carlo_returns"]


def monte_carlo_returns(
    rewards: np.ndarray, dones: np.ndarray, gamma: float
) -> np.ndarray:
    """Per-step discounted return-to-go, cut at episode boundaries."""
    out = np.zeros_like(rewards, dtype=np.float32)
    acc = 0.0
    for t in range(len(rewards) - 1, -1, -1):
        if dones[t]:
            acc = 0.0
        acc = rewards[t] + gamma * acc
        out[t] = acc
    return out


@dataclasses.dataclass
class MARWILConfig:
    input_path: str = ""               # offline dataset (offline.write_sample_batches)
    beta: float = 1.0                  # 0 = plain behavior cloning
    lr: float = 1e-3
    gamma: float = 0.99
    vf_coeff: float = 1.0
    batch_size: int = 512
    hidden: tuple = (64, 64)
    seed: int = 0
    # moving normalizer for the advantage exponent (marwil_torch_policy.py
    # keeps a running average of squared advantages)
    norm_momentum: float = 0.99
    device: Any = None
    hooks: RuntimeHooks = dataclasses.field(default_factory=RuntimeHooks)

    def build(self) -> "MARWIL":
        return MARWIL(self)


@dataclasses.dataclass
class BCConfig(MARWILConfig):
    beta: float = 0.0

    def build(self) -> "BC":
        return BC(self)  # type: ignore[return-value]


class MARWIL:
    def __init__(self, config: MARWILConfig):
        self.config = config
        self.device = resolve_device(config.device)
        cols = self._load(config.input_path, config.hooks)
        self.obs = np.asarray(cols["obs"], np.float32)
        self.actions = np.asarray(cols["actions"]).astype(np.int32)
        if "returns" in cols:
            # rollout workers postprocess GAE returns onto the batch; prefer
            # them — the flat storage order interleaves envs, so stream-order
            # monte-carlo would mix trajectories
            self.returns = np.asarray(cols["returns"], np.float32)
        else:
            self.returns = monte_carlo_returns(
                np.asarray(cols["rewards"], np.float32),
                np.asarray(cols["dones"]),
                config.gamma,
            )
        obs_size = self.obs.shape[-1]
        num_actions = int(self.actions.max()) + 1
        self.net = make_policy(obs_size, num_actions, config.hidden, config.seed, self.device)
        self.opt = AdamParams(self.net, config.lr)
        self._adv_norm = torch.ones((), device=self.device)  # running E[adv^2]
        self._rng = np.random.default_rng(config.seed)
        self._iteration = 0

    @staticmethod
    def _load(path: str, hooks: RuntimeHooks) -> SampleBatch:
        batches: List[SampleBatch] = list(offline.read_sample_batches(path, hooks=hooks))
        if not batches:
            raise ValueError(f"no offline sample batches under {path!r}")
        return SampleBatch.concat(batches)

    def loss(self, batch: Tensors, adv_norm: torch.Tensor
             ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
        """(total, (policy loss, value loss, the new normaliser))."""
        cfg = self.config
        logits, values = self.net(batch["obs"])
        _, logp = log_probs(logits, batch["actions"])
        adv = batch["returns"] - values
        vf_loss = torch.mean(adv ** 2)
        new_norm = (cfg.norm_momentum * adv_norm
                    + (1 - cfg.norm_momentum) * torch.mean(adv.detach() ** 2))
        weight = (torch.exp(cfg.beta * adv.detach() / torch.sqrt(new_norm + 1e-8))
                  if cfg.beta != 0.0 else torch.ones_like(logp))
        policy_loss = -torch.mean(weight * logp)
        total = policy_loss + cfg.vf_coeff * vf_loss
        return total, (policy_loss.detach(), vf_loss.detach(), new_norm)

    def step(self, batch: Tensors) -> Dict[str, torch.Tensor]:
        """One optimizer step over ``batch``; the metrics stay on the
        device."""
        total, (pl, vl, norm) = self.loss(batch, self._adv_norm)
        self.opt.step(self.opt.grads(total))
        self._adv_norm = norm
        return {"total_loss": total.detach(), "policy_loss": pl, "vf_loss": vl}

    def train(self, epochs: int = 1) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        n = len(self.obs)
        metrics: Dict[str, torch.Tensor] = {}
        # a dataset smaller than batch_size still trains (one short batch
        # per epoch) instead of silently running zero update steps
        bs = min(cfg.batch_size, n)
        for _ in range(epochs):
            order = self._rng.permutation(n)
            for lo in range(0, n - bs + 1, bs):
                idx = order[lo: lo + bs]
                metrics = self.step({
                    "obs": torch.from_numpy(self.obs[idx]).to(self.device),
                    "actions": torch.from_numpy(self.actions[idx]).to(self.device),
                    "returns": torch.from_numpy(self.returns[idx]).to(self.device),
                })
        self._iteration += 1
        out = {"training_iteration": self._iteration,
               "time_this_iter_s": time.perf_counter() - t0}
        out.update(host_metrics(metrics) if metrics else {})
        return out

    def get_weights(self):
        return host_state_dict(self.net)

    def set_weights(self, state_dict) -> None:
        self.net.load_state_dict(state_dict)

    @torch.no_grad()
    def evaluate(self, env_name: str, episodes: int = 4, seed: int = 0) -> float:
        """Greedy rollout return of the learned policy (no exploration)."""
        total = 0.0
        for ep in range(episodes):
            env = make_env(env_name)
            obs, _ = env.reset(seed=seed + ep)
            done = False
            while not done:
                logits, _ = self.net(torch.as_tensor(np.asarray(obs, np.float32)[None],
                                                     device=self.device))
                obs, r, term, trunc, _ = env.step(int(torch.argmax(logits[0], -1)))
                total += r
                done = term or trunc
        return total / episodes


class BC(MARWIL):
    """Behavior cloning == MARWIL with beta=0 (reference: bc.py)."""

    def __init__(self, config: MARWILConfig):
        if config.beta != 0.0:
            config = dataclasses.replace(config, beta=0.0)
        super().__init__(config)
