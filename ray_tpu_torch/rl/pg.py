"""Vanilla policy gradient (REINFORCE with a batch-mean baseline);
counterpart of ``ray_tpu/rl/pg.py``.

Reference: rllib/algorithms/pg — the minimal on-policy algorithm: collect
full-trajectory discounted returns, ascend logp-weighted returns. No
critic is trained; the variance-reduction baseline is the batch mean
(classic REINFORCE-with-baseline). Shares the generic RolloutWorker
(rollout_worker.py), whose discounted "returns" column is exactly what PG
consumes (its GAE advantages are ignored).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Sequence

import numpy as np

from ray_tpu_torch import DeviceLike
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.learner import PolicyLearner, log_probs, mean_entropy
from ray_tpu_torch.rl.rollout_worker import RolloutWorker
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.runtime import RuntimeHooks


class PGLearner(PolicyLearner):
    def __init__(self, observation_size: int, num_actions: int, *,
                 hidden: Sequence[int] = (64, 64), lr: float = 1e-3,
                 entropy_coeff: float = 0.0, grad_clip: float = 10.0,
                 seed: int = 0, device: DeviceLike = None):
        super().__init__(observation_size, num_actions, hidden=hidden, lr=lr,
                         grad_clip=grad_clip, seed=seed, device=device)
        self.entropy_coeff = entropy_coeff

    def loss(self, batch):
        logits, _values = self.net(batch["obs"])
        logp_all, logp = log_probs(logits, batch["actions"])
        returns = batch["returns"]
        # batch-mean baseline: unbiased, no trained critic
        centered = returns - returns.mean()
        policy_loss = -(logp * centered).mean()
        entropy = mean_entropy(logp_all)
        total = policy_loss - self.entropy_coeff * entropy
        return total, {"policy_loss": policy_loss.detach(), "entropy": entropy.detach()}


@dataclasses.dataclass
class PGConfig:
    env: str = "CartPole-v1"
    num_rollout_workers: int = 2
    num_envs_per_worker: int = 4
    rollout_fragment_length: int = 64
    lr: float = 2e-3
    gamma: float = 0.99
    entropy_coeff: float = 0.0
    hidden: tuple = (64, 64)
    seed: int = 0
    device: Any = None
    rollout_device: Any = None
    hooks: RuntimeHooks = dataclasses.field(default_factory=RuntimeHooks)

    def build(self) -> "PG":
        return PG(self)


class PG:
    """Iteration loop: sample -> single gradient step -> broadcast."""

    def __init__(self, config: PGConfig):
        self.config = config
        self.hooks = config.hooks
        probe = make_env(config.env)
        worker = self.hooks.remote(RolloutWorker)
        self.workers = [
            worker.remote(
                config.env,
                num_envs=config.num_envs_per_worker,
                seed=config.seed + 1000 * i,
                gamma=config.gamma,
                lam=1.0,  # plain discounted returns
                device=config.rollout_device,
            )
            for i in range(config.num_rollout_workers)
        ]
        self.learner = PGLearner(
            probe.observation_size, probe.num_actions,
            hidden=config.hidden, lr=config.lr,
            entropy_coeff=config.entropy_coeff, seed=config.seed,
            device=config.device,
        )
        self._iteration = 0
        self._env_steps = 0
        self._broadcast()

    def _broadcast(self):
        weights = self.learner.get_weights()
        self.hooks.get([w.set_weights.remote(weights) for w in self.workers], timeout=120)

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        cfg = self.config
        batches = self.hooks.get(
            [w.sample.remote(cfg.rollout_fragment_length) for w in self.workers],
            timeout=600,
        )
        batch = SampleBatch.concat(batches)
        self._env_steps += len(batch)
        metrics = self.learner.update(batch)
        self._broadcast()
        episode_returns: List[float] = []
        for w in self.workers:
            episode_returns.extend(self.hooks.get(w.episode_returns.remote(), timeout=60))
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "env_steps": self._env_steps,
            **metrics,
            "episode_return_mean": float(np.mean(episode_returns))
            if episode_returns else float("nan"),
            "episodes_this_iter": len(episode_returns),
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def stop(self):
        for w in self.workers:
            self.hooks.kill(w)
