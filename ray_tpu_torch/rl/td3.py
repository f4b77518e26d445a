"""TD3: twin-delayed deterministic policy gradients for continuous control
(counterpart of ``ray_tpu/rl/td3.py``).

Reference surface: rllib/algorithms/td3/ (td3.py: DDPG config with
``twin_q=True``, ``policy_delay=2``, ``smooth_target_policy=True``) and
rllib/algorithms/ddpg/ddpg_torch_policy.py (deterministic actor,
exploration via additive gaussian noise, polyak targets). The update runs
on ``config.device``: twin critics with target-policy smoothing (the
reference's normal draw, from ``rl.prng``), then, on every
``policy_delay``-th update, the actor over the updated critics and the
polyak sync of both target networks. On the other updates both targets
stay as they are, as under the reference's ``lax.cond``. Rollout workers
add exploration noise on the host.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.rl import prng
from ray_tpu_torch.rl.env import EpisodeReturnTracker, VectorEnv, make_env
from ray_tpu_torch.rl.learner import (AdamParams, Tensors, host_draws_to, host_metrics, polyak_,
                                      to_device)
from ray_tpu_torch.rl.replay_buffers import ReplayBuffer
from ray_tpu_torch.rl.rl_module import drawn, host_state_dict
from ray_tpu_torch.rl.sac import TwinQ, _MLP
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.runtime import RuntimeHooks

__all__ = ["DDPG", "DDPGConfig", "DeterministicPolicy", "TD3", "TD3Config",
           "TD3RolloutWorker"]


class DeterministicPolicy(_MLP):
    """mu(s): tanh-bounded deterministic actor (``torso_i``, ``mu``)."""

    def __init__(self, observation_size: int, action_size: int,
                 hidden: Sequence[int] = (128, 128)):
        super().__init__()
        self.action_size = action_size
        self.mu = nn.Linear(self._torso(observation_size, hidden), action_size)

    def forward(self, obs: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.mu(self.torso(obs)))


class TD3RolloutWorker:
    """Deterministic policy + additive exploration noise on a vector env."""

    def __init__(self, env_name: str, *, num_envs: int = 4, seed: int = 0,
                 hidden: Tuple[int, ...] = (128, 128),
                 exploration_noise: float = 0.1, device: DeviceLike = None):
        self.device = resolve_device(device)
        self.envs = VectorEnv(lambda: make_env(env_name), num_envs, seed=seed)
        probe = make_env(env_name)
        self.scale = float(probe.action_high)
        self.noise = exploration_noise * self.scale
        self.policy = drawn(DeterministicPolicy(probe.observation_size, probe.action_size,
                                                hidden), seed, self.device)
        self._np_rng = np.random.default_rng(seed + 1)
        self._episodes = EpisodeReturnTracker(num_envs)

    def set_weights(self, state_dict) -> bool:
        self.policy.load_state_dict(state_dict)
        return True

    @torch.no_grad()
    def _act(self, obs: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(obs, np.float32)).to(self.device)
        return (self.policy(x) * self.scale).cpu().numpy()

    def sample(self, num_steps: int, random_actions: bool = False) -> SampleBatch:
        obs_l, act_l, rew_l, next_l, done_l = [], [], [], [], []
        n = self.envs.num_envs
        a_dim = self.policy.action_size
        for _ in range(num_steps):
            obs = self.envs.observations
            if random_actions:
                actions = self._np_rng.uniform(
                    -self.scale, self.scale, (n, a_dim)
                ).astype(np.float32)
            else:
                mu = self._act(obs)
                noise = self._np_rng.normal(0.0, self.noise, mu.shape)
                actions = np.clip(mu + noise, -self.scale, self.scale).astype(np.float32)
            next_obs, rewards, terms, truncs, finals = self.envs.step(actions)
            obs_l.append(obs)
            act_l.append(actions)
            rew_l.append(rewards)
            next_l.append(finals)  # bootstrap through truncation
            done_l.append(terms)
            self._episodes.track(rewards, terms | truncs)
        return SampleBatch(
            obs=np.concatenate(obs_l).astype(np.float32),
            actions=np.concatenate(act_l).astype(np.float32),
            rewards=np.concatenate(rew_l).astype(np.float32),
            next_obs=np.concatenate(next_l).astype(np.float32),
            dones=np.concatenate(done_l).astype(np.float32),
        )

    def episode_returns(self) -> List[float]:
        return self._episodes.drain()


@dataclasses.dataclass
class TD3Config:
    env: str = "Pendulum-v1"
    num_rollout_workers: int = 1
    num_envs_per_worker: int = 4
    rollout_fragment_length: int = 64
    buffer_capacity: int = 100_000
    warmup_steps: int = 1_000
    batch_size: int = 256
    updates_per_iteration: int = 64
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    policy_delay: int = 2              # critic updates per actor update
    target_noise: float = 0.2          # target-policy smoothing stddev
    target_noise_clip: float = 0.5
    exploration_noise: float = 0.1
    hidden: tuple = (128, 128)
    seed: int = 0
    device: Any = None
    rollout_device: Any = None
    hooks: RuntimeHooks = dataclasses.field(default_factory=RuntimeHooks)

    def build(self) -> "TD3":
        return TD3(self)


class TD3:
    def __init__(self, config: TD3Config):
        self.config = config
        self.hooks = config.hooks
        self.device = dev = resolve_device(config.device)
        probe = make_env(config.env)
        self.scale = float(probe.action_high)
        obs_size, act_size = probe.observation_size, probe.action_size
        self.policy = drawn(DeterministicPolicy(obs_size, act_size, config.hidden),
                            config.seed, dev)
        self.qnet = drawn(TwinQ(obs_size, act_size, config.hidden), config.seed, dev)
        self.pi_target = copy.deepcopy(self.policy).requires_grad_(False)
        self.q_target = copy.deepcopy(self.qnet).requires_grad_(False)
        self.pi_opt = AdamParams(self.policy, config.actor_lr)
        self.q_opt = AdamParams(self.qnet, config.critic_lr)
        self.buffer = ReplayBuffer(config.buffer_capacity)
        worker = self.hooks.remote(TD3RolloutWorker)
        self.workers = [
            worker.remote(config.env, num_envs=config.num_envs_per_worker,
                          seed=config.seed + 1000 * i, hidden=tuple(config.hidden),
                          exploration_noise=config.exploration_noise,
                          device=config.rollout_device)
            for i in range(config.num_rollout_workers)
        ]
        self._rng = prng.PRNGKey(config.seed + 7)
        self._env_steps = 0
        self._updates = 0
        self._iteration = 0

    def update(self, batch: Tensors, key: np.ndarray, step: int) -> Tensors:
        """One TD3 update over a device batch with the update key ``key``
        at update count ``step``; the metrics stay on the device."""
        cfg = self.config
        policy, qnet, scale = self.policy, self.qnet, self.scale
        # -- critic: clipped double-Q with target-policy smoothing -----
        eps, = host_draws_to(self.device, prng.normal(key, tuple(batch["actions"].shape)))
        with torch.no_grad():
            noise = torch.clamp(eps * cfg.target_noise * scale,
                                -cfg.target_noise_clip * scale, cfg.target_noise_clip * scale)
            next_a = torch.clamp(self.pi_target(batch["next_obs"]) * scale + noise,
                                 -scale, scale)
            tq1, tq2 = self.q_target(batch["next_obs"], next_a)
            target_q = batch["rewards"] + cfg.gamma * (1.0 - batch["dones"]) * torch.minimum(
                tq1, tq2)
        q1, q2 = qnet(batch["obs"], batch["actions"])
        q_loss = ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()
        self.q_opt.step(self.q_opt.grads(q_loss))

        # -- delayed deterministic actor over the updated critics ------
        if step % cfg.policy_delay == 0:
            q1, _ = qnet(batch["obs"], policy(batch["obs"]) * scale)
            pi_loss = -q1.mean()
            self.pi_opt.step(self.pi_opt.grads(pi_loss))
            polyak_(self.pi_target, policy, cfg.tau)
            polyak_(self.q_target, qnet, cfg.tau)
            pi_loss = pi_loss.detach()
        else:
            pi_loss = torch.zeros((), device=self.device)
        return {"q_loss": q_loss.detach(), "pi_loss": pi_loss}

    def train(self) -> Dict[str, Any]:
        cfg = self.config
        t0 = time.perf_counter()
        random_phase = self._env_steps < cfg.warmup_steps
        batches = self.hooks.get(
            [w.sample.remote(cfg.rollout_fragment_length, random_phase) for w in self.workers],
            timeout=300,
        )
        for b in batches:
            self.buffer.add(b)
            self._env_steps += len(b)
        metrics: Tensors = {}
        if len(self.buffer) >= max(cfg.batch_size, cfg.warmup_steps):
            for _ in range(cfg.updates_per_iteration):
                batch = self.buffer.sample(cfg.batch_size)
                self._rng, sub = prng.split(self._rng)
                metrics = self.update(to_device(batch, self.device), sub, self._updates)
                self._updates += 1
            weights = host_state_dict(self.policy)
            self.hooks.get([w.set_weights.remote(weights) for w in self.workers], timeout=120)
        self._iteration += 1
        returns = [r for w in self.workers
                   for r in self.hooks.get(w.episode_returns.remote(), timeout=60)]
        out = {
            "iteration": self._iteration,
            "env_steps": self._env_steps,
            "episode_return_mean": float(np.mean(returns)) if returns else None,
            "time_s": round(time.perf_counter() - t0, 2),
        }
        out.update(host_metrics(metrics) if metrics else {})
        return out

    def stop(self):
        for w in self.workers:
            self.hooks.kill(w)


@dataclasses.dataclass
class DDPGConfig(TD3Config):
    """DDPG (reference: rllib/algorithms/ddpg/) — the deterministic
    policy-gradient ancestor of TD3: no delayed actor, no target-policy
    smoothing. Twin critics are kept (strictly better, same machinery);
    the three TD3 additions are disabled so the update IS Lillicrap et
    al.'s algorithm."""

    policy_delay: int = 1
    target_noise: float = 0.0
    target_noise_clip: float = 0.0

    def build(self) -> "DDPG":
        return DDPG(self)


class DDPG(TD3):
    pass
