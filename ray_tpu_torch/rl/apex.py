"""Ape-X DQN: distributed prioritized replay with decoupled sampling
(counterpart of ``ray_tpu/rl/apex.py``).

Reference: rllib/algorithms/apex_dqn/apex_dqn.py (Horgan et al., "Distributed
Prioritized Experience Replay"): rollout workers compute INITIAL priorities
locally and push transitions straight into sharded replay ACTORS (never
through the driver); the learner pulls minibatches from the shards while
sampling continues. The actors come from ``config.hooks`` (by default,
in this process, each call run at once); the driver pipelines through
``hooks.wait``. The learner runs on ``config.device``, the workers'
forwards (and their TD errors) on ``config.rollout_device``.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ray_tpu_torch.rl.dqn import DQNConfig, DQNLearner, DQNRolloutWorker
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.replay_buffers import PrioritizedReplayBuffer
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.runtime import RuntimeHooks

__all__ = ["ApexDQN", "ApexDQNConfig", "ApexRolloutWorker", "ReplayShardActor"]

logger = logging.getLogger(__name__)


class ReplayShardActor:
    """One shard of the distributed replay memory (reference:
    apex_dqn.py's replay actor set). Holds a PrioritizedReplayBuffer;
    workers add with worker-computed initial priorities, the learner
    samples and writes trained TD priorities back."""

    def __init__(self, capacity: int, alpha: float, seed: int):
        self.buffer = PrioritizedReplayBuffer(capacity, alpha=alpha, seed=seed)

    def add(self, batch: SampleBatch, priorities) -> int:
        idx = self.buffer.add(batch)
        if priorities is not None:
            self.buffer.update_priorities(idx, np.asarray(priorities))
        return len(self.buffer)

    def sample(self, n: int, beta: float):
        if len(self.buffer) < n:
            return None
        return self.buffer.sample(n, beta=beta)

    def update_priorities(self, indexes, td) -> bool:
        self.buffer.update_priorities(indexes, td)
        return True

    def size(self) -> int:
        return len(self.buffer)


class ApexRolloutWorker(DQNRolloutWorker):
    """DQN rollout worker that pushes straight to replay shards with
    locally-computed initial TD priorities (the Ape-X worker contract).
    ``hooks`` is how it reaches a shard actor."""

    def __init__(self, env_name: str, *, gamma: float = 0.99,
                 hooks: Optional[RuntimeHooks] = None, **kw):
        super().__init__(env_name, gamma=gamma, **kw)
        self.hooks = hooks or RuntimeHooks()
        # n-step batches fold intermediate rewards into `rewards`, so the
        # worker-side initial-priority TD bootstraps with gamma^n too
        self.gamma_boot = gamma ** self.n_step

    @torch.no_grad()
    def td_error(self, batch: SampleBatch) -> np.ndarray:
        """Q(s, a) - (r + gamma^n (1 - done) max_a' Q(s', a')) under the
        mean weights (no noise: deterministic priority estimates)."""
        t = lambda k, dtype=torch.float32: torch.as_tensor(  # noqa: E731
            np.asarray(batch[k]), device=self.device).to(dtype)
        q = self.net(t("obs"))
        q_taken = q.gather(-1, t("actions", torch.long)[:, None])[:, 0]
        best = self.net(t("new_obs")).max(dim=-1).values
        target = t("rewards") + self.gamma_boot * (1.0 - t("dones")) * best
        return (q_taken - target).cpu().numpy()

    def sample_to_replay(self, num_steps: int, epsilon: float, shard,
                         steps_before: int) -> Tuple[int, int]:
        """Collect, compute initial priorities, push to the given shard.
        Returns (env steps collected, shard size after the push)."""
        batch = self.sample(num_steps, epsilon)
        size = self.hooks.get(shard.add.remote(batch, self.td_error(batch)), timeout=120)
        return len(batch), size


@dataclasses.dataclass
class ApexDQNConfig(DQNConfig):
    num_replay_shards: int = 2
    # how many sample_to_replay futures stay in flight per worker
    max_inflight_per_worker: int = 2
    weight_sync_interval_s: float = 2.0

    def build(self) -> "ApexDQN":
        return ApexDQN(self)


class ApexDQN:
    """Driver: pipelined sampling into shards + continuous learner pulls."""

    def __init__(self, config: ApexDQNConfig):
        if getattr(config, "num_atoms", 1) > 1:
            raise ValueError(
                "ApexDQN does not support distributional (num_atoms>1) "
                "learning: worker-side initial TD priorities assume scalar "
                "Q targets"
            )
        if config.rollout_fragment_length < config.n_step:
            raise ValueError(
                f"rollout_fragment_length ({config.rollout_fragment_length}) "
                f"must be >= n_step ({config.n_step})"
            )
        self.config = config
        self.hooks = config.hooks
        probe = make_env(config.env)
        self.learner = DQNLearner(
            probe.observation_size, probe.num_actions,
            hidden=config.hidden, lr=config.lr, gamma=config.gamma,
            seed=config.seed, dueling=config.dueling, noisy=config.noisy,
            n_step=config.n_step, device=config.device,
        )
        shard = self.hooks.remote(ReplayShardActor)
        self.shards = [
            shard.remote(max(1, config.buffer_size // config.num_replay_shards),
                         config.per_alpha, config.seed + 7 * i)
            for i in range(config.num_replay_shards)
        ]
        worker = self.hooks.remote(ApexRolloutWorker)
        self.workers = [
            worker.remote(
                config.env,
                gamma=config.gamma,
                hooks=self.hooks,
                num_envs=config.num_envs_per_worker,
                seed=config.seed + 1000 * i,
                hidden=config.hidden,
                dueling=config.dueling,
                noisy=config.noisy,
                n_step=config.n_step,
                device=config.rollout_device,
            )
            for i in range(config.num_rollout_workers)
        ]
        self._env_steps = 0
        self._updates = 0
        self._iteration = 0
        # sample_to_replay calls that raised (a dead worker): the rest of
        # the fleet keeps sampling, as in the reference; counted, not hidden
        self.worker_failures = 0
        self._inflight: Dict[Any, Any] = {}  # future -> worker
        self._shard_rr = 0
        self._last_sync = 0.0
        self._broadcast_weights()

    def _broadcast_weights(self):
        weights = self.learner.get_weights()
        self.hooks.get([w.set_weights.remote(weights) for w in self.workers], timeout=120)
        self._last_sync = time.monotonic()

    def _kick_workers(self):
        cfg = self.config
        counts: Dict[Any, int] = {id(w): 0 for w in self.workers}
        for worker in self._inflight.values():
            counts[id(worker)] += 1
        for worker in self.workers:
            while counts[id(worker)] < cfg.max_inflight_per_worker:
                shard = self.shards[self._shard_rr % len(self.shards)]
                self._shard_rr += 1
                fut = worker.sample_to_replay.remote(
                    cfg.rollout_fragment_length, self.epsilon, shard, self._env_steps)
                self._inflight[fut] = worker
                counts[id(worker)] += 1

    def _reap_workers(self, timeout: float = 0.0):
        if not self._inflight:
            return
        done, _ = self.hooks.wait(list(self._inflight), num_returns=len(self._inflight),
                                  timeout=timeout)
        for fut in done:
            self._inflight.pop(fut, None)
            try:
                steps, _size = self.hooks.get(fut, timeout=60)
                self._env_steps += steps
            except Exception:  # noqa: BLE001 - a dead worker; the fleet goes on
                self.worker_failures += 1
                logger.warning("ApexDQN: a sample_to_replay call failed", exc_info=True)

    @property
    def epsilon(self) -> float:
        cfg = self.config
        frac = min(1.0, self._env_steps / max(1, cfg.epsilon_decay_steps))
        return cfg.epsilon_start + frac * (cfg.epsilon_end - cfg.epsilon_start)

    def train(self) -> Dict[str, Any]:
        """One iteration: keep the sampling pipeline full, run
        ``updates_per_iteration`` learner updates against the shards."""
        t0 = time.perf_counter()
        cfg = self.config
        losses: List[float] = []
        self._kick_workers()
        while len(losses) < cfg.updates_per_iteration:
            # hard per-iteration bailout: shards that can NEVER serve a
            # batch (capacity < train_batch_size, dead worker fleet) must
            # end the iteration, not spin train() forever
            if time.perf_counter() - t0 > 60:
                break
            self._reap_workers(timeout=0.0)
            self._kick_workers()
            shard = self.shards[self._shard_rr % len(self.shards)]
            self._shard_rr += 1
            mb = self.hooks.get(shard.sample.remote(cfg.train_batch_size, cfg.per_beta),
                                timeout=120)
            if mb is None:
                # shard not warm yet: give sampling the core for a moment
                self._reap_workers(timeout=0.25)
                continue
            loss, td = self.learner.update(mb)
            shard.update_priorities.remote(mb["batch_indexes"], td)
            losses.append(loss)
            self._updates += 1
            if self._updates % cfg.target_update_interval == 0:
                self.learner.sync_target()
            if time.monotonic() - self._last_sync > cfg.weight_sync_interval_s:
                self._broadcast_weights()
        self._reap_workers(timeout=0.0)

        episode_returns: List[float] = []
        for w in self.workers:
            episode_returns.extend(self.hooks.get(w.episode_returns.remote(), timeout=60))
        self._iteration += 1
        shard_sizes = self.hooks.get([s.size.remote() for s in self.shards], timeout=60)
        return {
            "training_iteration": self._iteration,
            "env_steps_total": self._env_steps,
            "num_updates": self._updates,
            "epsilon": self.epsilon,
            "replay_shard_sizes": shard_sizes,
            "buffer_size": int(sum(shard_sizes)),
            "mean_loss": float(np.mean(losses)) if losses else float("nan"),
            "episode_return_mean": float(np.mean(episode_returns))
            if episode_returns else float("nan"),
            "episodes_this_iter": len(episode_returns),
            "worker_failures": self.worker_failures,
            "time_this_iter_s": time.perf_counter() - t0,
        }

    def stop(self):
        self._inflight.clear()
        for actor in (*self.workers, *self.shards):
            self.hooks.kill(actor)
