"""SAC: maximum-entropy off-policy actor-critic for continuous control
(counterpart of ``ray_tpu/rl/sac.py``).

Reference surface: rllib/algorithms/sac/ (sac.py config + training_step,
sac_torch_policy.py twin-Q and squashed-gaussian policy, auto-tuned
temperature). The update (twin critics, actor, temperature, polyak
target sync) runs on ``config.device`` in the reference's order: the
actor reads the critics after their step and the temperature from before
its own. Its noise is the reference's: the JAX keys it splits are
followed by ``rl.prng`` on the host, and the two normal draws of an update
go to the device in one copy. Rollout workers sample tanh-gaussian
actions with the policy's forward on their device.
"""

from __future__ import annotations

import copy
import dataclasses
import math
import time
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ray_tpu_torch import DeviceLike, resolve_device
from ray_tpu_torch.rl import prng
from ray_tpu_torch.rl.env import EpisodeReturnTracker, VectorEnv, make_env
from ray_tpu_torch.rl.learner import (AdamParams, Tensors, host_draws_to, host_metrics, polyak_,
                                      to_device)
from ray_tpu_torch.rl.replay_buffers import ReplayBuffer
from ray_tpu_torch.rl.rl_module import drawn, host_state_dict
from ray_tpu_torch.rl.sample_batch import SampleBatch
from ray_tpu_torch.runtime import RuntimeHooks

__all__ = ["GaussianPolicy", "SAC", "SACConfig", "SACRolloutWorker", "TwinQ",
           "sample_action"]

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
LOG_2PI = math.log(2 * math.pi)


class _MLP(nn.Module):
    """``torso_i`` Linear + relu layers."""

    def _torso(self, in_features: int, hidden: Sequence[int]) -> int:
        self.hidden = tuple(hidden)
        sizes = (in_features, *self.hidden)
        for i, (n_in, n_out) in enumerate(zip(sizes, sizes[1:])):
            self.add_module(f"torso_{i}", nn.Linear(n_in, n_out))
        return sizes[-1]

    def torso(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(len(self.hidden)):
            x = F.relu(getattr(self, f"torso_{i}")(x))
        return x


class GaussianPolicy(_MLP):
    """Squashed-gaussian actor: outputs mean/log_std; actions are
    tanh(sample) scaled to the env's bounds."""

    def __init__(self, observation_size: int, action_size: int,
                 hidden: Sequence[int] = (128, 128)):
        super().__init__()
        self.action_size = action_size
        width = self._torso(observation_size, hidden)
        self.mean = nn.Linear(width, action_size)
        self.log_std = nn.Linear(width, action_size)

    def forward(self, obs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = self.torso(obs)
        return self.mean(x), torch.clamp(self.log_std(x), LOG_STD_MIN, LOG_STD_MAX)


class TwinQ(nn.Module):
    """Two independent Q(s, a) heads (clipped double-Q): ``q1_l{i}``,
    ``q1_out``, ``q2_l{i}``, ``q2_out``."""

    def __init__(self, observation_size: int, action_size: int,
                 hidden: Sequence[int] = (128, 128)):
        super().__init__()
        self.hidden = tuple(hidden)
        sizes = (observation_size + action_size, *self.hidden)
        for head in ("q1", "q2"):
            for i, (n_in, n_out) in enumerate(zip(sizes, sizes[1:])):
                self.add_module(f"{head}_l{i}", nn.Linear(n_in, n_out))
            self.add_module(f"{head}_out", nn.Linear(sizes[-1], 1))

    def forward(self, obs: torch.Tensor, act: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        x = torch.cat([obs, act], dim=-1)
        outs = []
        for head in ("q1", "q2"):
            h = x
            for i in range(len(self.hidden)):
                h = F.relu(getattr(self, f"{head}_l{i}")(h))
            outs.append(getattr(self, f"{head}_out")(h).squeeze(-1))
        return outs[0], outs[1]


def sample_action(policy: GaussianPolicy, obs: torch.Tensor, eps: torch.Tensor,
                  scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_sample_action`` for its normal draw ``eps``
    (``prng.normal(key, mean.shape)``): tanh(mean + std * eps) * scale and
    its log-probability with the tanh change-of-variables correction."""
    mean, log_std = policy(obs)
    pre = mean + torch.exp(log_std) * eps
    squashed = torch.tanh(pre)
    logp = (
        -0.5 * (eps ** 2 + 2 * log_std + LOG_2PI)
        - torch.log(1 - squashed ** 2 + 1e-6)
    ).sum(-1)
    return squashed * scale, logp


class SACRolloutWorker:
    """Stochastic-policy transition collection on a vectorized env."""

    def __init__(self, env_name: str, *, num_envs: int = 4, seed: int = 0,
                 hidden: Tuple[int, ...] = (128, 128), device: DeviceLike = None):
        self.device = resolve_device(device)
        self.envs = VectorEnv(lambda: make_env(env_name), num_envs, seed=seed)
        probe = make_env(env_name)
        self.scale = float(probe.action_high)
        self.policy = drawn(GaussianPolicy(probe.observation_size, probe.action_size,
                                           hidden), seed, self.device)
        self._rng = prng.PRNGKey(seed + 1)
        self._episodes = EpisodeReturnTracker(num_envs)

    def set_weights(self, state_dict) -> bool:
        self.policy.load_state_dict(state_dict)
        return True

    @torch.no_grad()
    def _act(self, obs: np.ndarray, key: np.ndarray) -> np.ndarray:
        x = torch.from_numpy(np.asarray(obs, np.float32)).to(self.device)
        eps, = host_draws_to(self.device, prng.normal(key, (len(obs), self.policy.action_size)))
        return sample_action(self.policy, x, eps, self.scale)[0].cpu().numpy()

    def sample(self, num_steps: int, random_actions: bool = False) -> SampleBatch:
        obs_l, act_l, rew_l, next_l, done_l = [], [], [], [], []
        n = self.envs.num_envs
        # the reference seeds this from the key's first word: 0 until the
        # first policy step splits the key
        rng = np.random.default_rng(int(self._rng[0]))
        for _ in range(num_steps):
            obs = self.envs.observations
            if random_actions:
                actions = rng.uniform(
                    -self.scale, self.scale, (n, self.policy.action_size),
                ).astype(np.float32)
            else:
                self._rng, sub = prng.split(self._rng)
                actions = self._act(obs, sub)
            next_obs, rewards, terms, truncs, finals = self.envs.step(actions)
            obs_l.append(obs)
            act_l.append(actions)
            rew_l.append(rewards)
            # bootstrap through truncation: done only on true termination
            next_l.append(finals)
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


class _Temperature(nn.Module):
    """The entropy temperature's one 0-d parameter, log(alpha), from 0."""

    def __init__(self):
        super().__init__()
        self.log_alpha = nn.Parameter(torch.zeros(()))


@dataclasses.dataclass
class SACConfig:
    env: str = "Pendulum-v1"
    num_rollout_workers: int = 1
    num_envs_per_worker: int = 4
    rollout_fragment_length: int = 64
    buffer_capacity: int = 100_000
    warmup_steps: int = 1_000
    batch_size: int = 256
    updates_per_iteration: int = 64
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005  # polyak target rate
    hidden: tuple = (128, 128)
    seed: int = 0
    # None = auto-tune temperature toward -action_size target entropy
    fixed_alpha: Optional[float] = None
    device: Any = None
    rollout_device: Any = None
    hooks: RuntimeHooks = dataclasses.field(default_factory=RuntimeHooks)

    def build(self) -> "SAC":
        return SAC(self)


class SAC:
    def __init__(self, config: SACConfig):
        self.config = config
        self.hooks = config.hooks
        self.device = dev = resolve_device(config.device)
        probe = make_env(config.env)
        self.scale = float(probe.action_high)
        obs_size, act_size = probe.observation_size, probe.action_size
        # the reference inits the policy and the twin Q from one key
        self.policy = drawn(GaussianPolicy(obs_size, act_size, config.hidden), config.seed, dev)
        self.qnet = drawn(TwinQ(obs_size, act_size, config.hidden), config.seed, dev)
        self.q_target = copy.deepcopy(self.qnet).requires_grad_(False)
        self.temperature = _Temperature().to(dev)
        self.target_entropy = -float(act_size)
        self.pi_opt = AdamParams(self.policy, config.lr)
        self.q_opt = AdamParams(self.qnet, config.lr)
        self.a_opt = AdamParams(self.temperature, config.lr)
        self.buffer = ReplayBuffer(config.buffer_capacity)
        worker = self.hooks.remote(SACRolloutWorker)
        self.workers = [
            worker.remote(config.env, num_envs=config.num_envs_per_worker,
                          seed=config.seed + 1000 * i, hidden=tuple(config.hidden),
                          device=config.rollout_device)
            for i in range(config.num_rollout_workers)
        ]
        self._rng = prng.PRNGKey(config.seed + 7)
        self._env_steps = 0
        self._iteration = 0

    @property
    def log_alpha(self) -> torch.Tensor:
        return self.temperature.log_alpha

    def update(self, batch: Tensors, key: np.ndarray) -> Tensors:
        """One SAC update over a device batch with the update key ``key``;
        the metrics stay on the device."""
        cfg = self.config
        policy, qnet, scale = self.policy, self.qnet, self.scale
        alpha = (torch.tensor(cfg.fixed_alpha, device=self.device)
                 if cfg.fixed_alpha is not None else torch.exp(self.log_alpha.detach()))
        r1, r2 = prng.split(key)
        shape = tuple(batch["actions"].shape)
        eps1, eps2 = host_draws_to(self.device, prng.normal(r1, shape), prng.normal(r2, shape))

        # -- critic ----------------------------------------------------
        with torch.no_grad():
            next_a, next_logp = sample_action(policy, batch["next_obs"], eps1, scale)
            tq1, tq2 = self.q_target(batch["next_obs"], next_a)
            target_v = torch.minimum(tq1, tq2) - alpha * next_logp
            target_q = batch["rewards"] + cfg.gamma * (1.0 - batch["dones"]) * target_v
        q1, q2 = qnet(batch["obs"], batch["actions"])
        q_loss = ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()
        self.q_opt.step(self.q_opt.grads(q_loss))

        # -- actor (the critics after their step) ------------------------
        a, logp = sample_action(policy, batch["obs"], eps2, scale)
        q1, q2 = qnet(batch["obs"], a)
        pi_loss = (alpha * logp - torch.minimum(q1, q2)).mean()
        self.pi_opt.step(self.pi_opt.grads(pi_loss))

        # -- temperature (alpha from before its step) -------------------
        a_loss = -(torch.exp(self.log_alpha) * (logp.detach() + self.target_entropy)).mean()
        self.a_opt.step(self.a_opt.grads(a_loss))

        # -- polyak target sync ---------------------------------------
        polyak_(self.q_target, qnet, cfg.tau)
        return {"q_loss": q_loss.detach(), "pi_loss": pi_loss.detach(), "alpha": alpha,
                "entropy": -logp.detach().mean()}

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
                metrics = self.update(to_device(batch, self.device), sub)
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
