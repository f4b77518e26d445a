"""A2C: synchronous advantage actor-critic (counterpart of
``ray_tpu/rl/a2c.py``).

Reference surface: rllib/algorithms/a2c/ (a2c.py: sync sampling +
single-pass policy-gradient update on GAE advantages — PPO's machinery
minus the clipped surrogate and the SGD epochs). Shares this package's
rollout workers and GAE postprocessing; the learner is one policy-gradient
step per sampled batch.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Sequence

import numpy as np

from ray_tpu_torch import DeviceLike
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.learner import PolicyLearner, log_probs, mean_entropy, normalized
from ray_tpu_torch.rl.rollout_worker import RolloutWorker
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.runtime import RuntimeHooks


class A2CLearner(PolicyLearner):
    def __init__(self, observation_size: int, num_actions: int, *,
                 hidden: Sequence[int] = (64, 64), lr: float = 1e-3,
                 vf_coeff: float = 0.5, entropy_coeff: float = 0.01,
                 grad_clip: float = 10.0, seed: int = 0, device: DeviceLike = None):
        super().__init__(observation_size, num_actions, hidden=hidden, lr=lr,
                         grad_clip=grad_clip, seed=seed, device=device)
        self.vf_coeff, self.entropy_coeff = vf_coeff, entropy_coeff

    def loss(self, batch):
        logits, values = self.net(batch["obs"])
        logp_all, logp = log_probs(logits, batch["actions"])
        adv = normalized(batch["advantages"])
        policy_loss = -(logp * adv).mean()
        vf_loss = 0.5 * ((batch["returns"] - values) ** 2).mean()
        entropy = mean_entropy(logp_all)
        total = policy_loss + self.vf_coeff * vf_loss - self.entropy_coeff * entropy
        return total, {"policy_loss": policy_loss.detach(), "vf_loss": vf_loss.detach(),
                       "entropy": entropy.detach()}


@dataclasses.dataclass
class A2CConfig:
    env: str = "CartPole-v1"
    num_rollout_workers: int = 2
    num_envs_per_worker: int = 4
    rollout_fragment_length: int = 32
    lr: float = 1e-3
    gamma: float = 0.99
    lam: float = 1.0      # A2C classically uses plain returns (lambda=1)
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    hidden: tuple = (64, 64)
    seed: int = 0
    device: Any = None
    rollout_device: Any = None
    hooks: RuntimeHooks = dataclasses.field(default_factory=RuntimeHooks)

    def build(self) -> "A2C":
        return A2C(self)


class A2C:
    """Synchronous algorithm: sample from all workers, one update, broadcast."""

    def __init__(self, config: A2CConfig):
        self.config = config
        self.hooks = config.hooks
        probe = make_env(config.env)
        module_config = {
            "observation_size": probe.observation_size,
            "num_actions": probe.num_actions,
            "hidden": config.hidden,
        }
        worker = self.hooks.remote(RolloutWorker)
        self.workers = [
            worker.remote(
                config.env,
                num_envs=config.num_envs_per_worker,
                seed=config.seed + 1000 * i,
                module_config=module_config,
                gamma=config.gamma,
                lam=config.lam,
                device=config.rollout_device,
            )
            for i in range(config.num_rollout_workers)
        ]
        self.learner = A2CLearner(
            probe.observation_size, probe.num_actions,
            hidden=config.hidden, lr=config.lr,
            vf_coeff=config.vf_coeff, entropy_coeff=config.entropy_coeff,
            seed=config.seed, device=config.device,
        )
        self._iteration = 0
        self._env_steps = 0
        self._broadcast()

    def _broadcast(self):
        w = self.learner.get_weights()
        self.hooks.get([x.set_weights.remote(w) for x in self.workers], timeout=120)

    def train(self) -> Dict[str, Any]:
        t0 = time.perf_counter()
        cfg = self.config
        batches = self.hooks.get(
            [w.sample.remote(cfg.rollout_fragment_length) for w in self.workers],
            timeout=300,
        )
        batch = SampleBatch.concat(batches)
        metrics = self.learner.update(batch)
        self._broadcast()
        self._env_steps += len(batch)
        returns: List[float] = []
        for w in self.workers:
            returns.extend(self.hooks.get(w.episode_returns.remote(), timeout=60))
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "env_steps_total": self._env_steps,
            "episode_return_mean": float(np.mean(returns)) if returns else float("nan"),
            "time_this_iter_s": time.perf_counter() - t0,
            **metrics,
        }

    def stop(self):
        for w in self.workers:
            self.hooks.kill(w)
