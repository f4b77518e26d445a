"""PPO Algorithm: the iteration loop (sample → learn → broadcast);
counterpart of ``ray_tpu/rl/algorithm.py``.

Reference: rllib/algorithms/algorithm.py:149 (step:755), ppo/ppo.py:408
training_step, execution/rollout_ops.py:21 synchronous_parallel_sample,
train_ops.py:26. One train() call = parallel sampling on rollout-worker
actors, GAE postprocessing (worker-side), minibatch PPO epochs on the
learner group, weight broadcast back to workers. The actors are started
and called through ``config.hooks`` (by default, in this process); the
learners run on ``config.device``, the workers' policies on
``config.rollout_device`` (both CUDA by default).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List

import numpy as np

from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.learner import LearnerGroup, PPOLossConfig
from ray_tpu_torch.rl.rollout_worker import RolloutWorker
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.runtime import RuntimeHooks


@dataclasses.dataclass
class PPOConfig:
    env: str = "CartPole-v1"
    num_rollout_workers: int = 2
    num_envs_per_worker: int = 4
    rollout_fragment_length: int = 64
    num_learners: int = 1
    lr: float = 3e-4
    gamma: float = 0.99
    lam: float = 0.95
    minibatch_size: int = 128
    num_epochs: int = 6
    hidden: tuple = (64, 64)
    loss: PPOLossConfig = dataclasses.field(default_factory=PPOLossConfig)
    seed: int = 0
    device: Any = None
    rollout_device: Any = None
    hooks: RuntimeHooks = dataclasses.field(default_factory=RuntimeHooks)

    def build(self) -> "PPO":
        return PPO(self)


class PPO:
    def __init__(self, config: PPOConfig):
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
        self.learners = LearnerGroup(
            {
                "observation_size": probe.observation_size,
                "num_actions": probe.num_actions,
                "hidden": config.hidden,
                "lr": config.lr,
                "loss_config": config.loss,
                "seed": config.seed,
                "device": config.device,
            },
            num_learners=config.num_learners,
            hooks=self.hooks,
        )
        self._iteration = 0
        self._broadcast_weights()

    def _broadcast_weights(self):
        weights = self.learners.get_weights()
        self.hooks.get([w.set_weights.remote(weights) for w in self.workers], timeout=120)

    def train(self) -> Dict[str, Any]:
        """One training iteration (reference: Algorithm.step:755)."""
        t0 = time.perf_counter()
        cfg = self.config
        # synchronous_parallel_sample (rollout_ops.py:21)
        batches = self.hooks.get(
            [w.sample.remote(cfg.rollout_fragment_length) for w in self.workers],
            timeout=600,
        )
        batch = SampleBatch.concat(batches)
        metrics = self.learners.update(
            batch,
            minibatch_size=cfg.minibatch_size,
            num_epochs=cfg.num_epochs,
            seed=cfg.seed + self._iteration,
        )
        self._broadcast_weights()
        episode_returns: List[float] = []
        for w in self.workers:
            episode_returns.extend(self.hooks.get(w.episode_returns.remote(), timeout=60))
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "env_steps_this_iter": len(batch),
            "episode_return_mean": float(np.mean(episode_returns))
            if episode_returns
            else float("nan"),
            "episodes_this_iter": len(episode_returns),
            "time_this_iter_s": time.perf_counter() - t0,
            **metrics,
        }

    def stop(self):
        for w in self.workers:
            self.hooks.kill(w)
        self.learners.shutdown()
