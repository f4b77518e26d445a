"""CQL: conservative Q-learning for OFFLINE continuous control
(counterpart of ``ray_tpu/rl/cql.py``).

Reference surface: rllib/algorithms/cql/ (cql.py: SAC trained from offline
data with the conservative regularizer; cql_torch_policy.py: the
logsumexp-over-sampled-actions penalty that pushes Q down on out-of-
distribution actions and up on dataset actions). Reuses this package's SAC
networks and the offline datasets (read through ``config.hooks``); the
update (twin critics + CQL penalty, actor, polyak) runs on
``config.device`` with the reference's noise (``rl.prng``: one normal for
the critic target, a uniform and a normal for the candidate actions, one
normal for the actor, all in one copy to the device).
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Any, Dict

import numpy as np
import torch

from ray_tpu_torch import resolve_device
from ray_tpu_torch.rl import offline, prng
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.learner import (AdamParams, Tensors, host_draws_to, host_metrics, polyak_,
                                      to_device)
from ray_tpu_torch.rl.replay_buffers import ReplayBuffer
from ray_tpu_torch.rl.rl_module import drawn
from ray_tpu_torch.rl.sac import GaussianPolicy, TwinQ, sample_action
from ray_tpu_torch.runtime import RuntimeHooks

__all__ = ["CQL", "CQLConfig"]


@dataclasses.dataclass
class CQLConfig:
    input_path: str = ""           # offline dataset (offline.write_sample_batches)
    env: str = "Pendulum-v1"       # for action bounds / eval
    lr: float = 3e-4
    gamma: float = 0.99
    tau: float = 0.005
    batch_size: int = 256
    cql_alpha: float = 1.0         # conservative penalty weight
    cql_num_actions: int = 4       # sampled actions for the logsumexp
    fixed_alpha: float = 0.2       # SAC temperature (fixed for offline)
    hidden: tuple = (128, 128)
    seed: int = 0
    device: Any = None
    hooks: RuntimeHooks = dataclasses.field(default_factory=RuntimeHooks)

    def build(self) -> "CQL":
        return CQL(self)


class CQL:
    def __init__(self, config: CQLConfig):
        self.config = config
        self.device = dev = resolve_device(config.device)
        probe = make_env(config.env)
        self.scale = float(probe.action_high)
        buf = offline.load_replay_buffer(config.input_path, hooks=config.hooks)
        if len(buf) < config.batch_size:
            raise ValueError(
                f"offline dataset has {len(buf)} transitions < batch_size"
            )
        self.buffer: ReplayBuffer = buf
        obs_size, act_size = probe.observation_size, probe.action_size
        self.policy = drawn(GaussianPolicy(obs_size, act_size, config.hidden), config.seed, dev)
        self.qnet = drawn(TwinQ(obs_size, act_size, config.hidden), config.seed, dev)
        self.q_target = copy.deepcopy(self.qnet).requires_grad_(False)
        self.pi_opt = AdamParams(self.policy, config.lr)
        self.q_opt = AdamParams(self.qnet, config.lr)
        self._rng = prng.PRNGKey(config.seed + 13)
        self._iteration = 0
        self._updates = 0

    def _noise(self, key: np.ndarray, b: int, a_dim: int):
        """The update's draws for ``key``: the critic target's normal, the
        uniform candidate actions, the policy candidates' normal (over the
        repeated observations) and the actor's normal."""
        r1, r2, r3, r4 = prng.split(key, 4)
        n = self.config.cql_num_actions
        return host_draws_to(self.device, prng.normal(r1, (b, a_dim)),
                             prng.uniform(r2, (b, n, a_dim), -self.scale, self.scale),
                             prng.normal(r3, (b * n, a_dim)), prng.normal(r4, (b, a_dim)))

    def q_batched(self, obs: torch.Tensor, acts: torch.Tensor) -> torch.Tensor:
        """Q over [B, N, A] candidate actions -> [B, N] (min of twins)."""
        b, n, a = acts.shape
        obs_rep = obs[:, None, :].expand(b, n, obs.shape[-1]).reshape(b * n, -1)
        q1, q2 = self.qnet(obs_rep, acts.reshape(b * n, a))
        return torch.minimum(q1, q2).reshape(b, n)

    def update(self, batch: Tensors, key: np.ndarray) -> Tensors:
        """One CQL update over a device batch with the update key ``key``;
        the metrics stay on the device."""
        cfg = self.config
        policy, qnet, scale = self.policy, self.qnet, self.scale
        alpha = cfg.fixed_alpha
        b, a_dim = batch["obs"].shape[0], batch["actions"].shape[-1]
        eps1, rand_a, eps3, eps4 = self._noise(key, b, a_dim)

        with torch.no_grad():
            # -- SAC critic target ---------------------------------------
            next_a, next_logp = sample_action(policy, batch["next_obs"], eps1, scale)
            tq1, tq2 = self.q_target(batch["next_obs"], next_a)
            target_q = batch["rewards"] + cfg.gamma * (1.0 - batch["dones"]) * (
                torch.minimum(tq1, tq2) - alpha * next_logp)
            # candidate actions for the conservative penalty: uniform random
            # + current-policy samples (no gradient), each observation
            # repeated cql_num_actions times in a row (jnp.repeat)
            pol_a, _ = sample_action(
                policy, batch["obs"].repeat_interleave(cfg.cql_num_actions, dim=0), eps3, scale)
            pol_a = pol_a.reshape(b, cfg.cql_num_actions, a_dim)

        q1, q2 = qnet(batch["obs"], batch["actions"])
        bellman = ((q1 - target_q) ** 2 + (q2 - target_q) ** 2).mean()
        # conservative term: logsumexp over OOD actions minus the dataset
        # action's Q — penalizes optimistic extrapolation
        cand = torch.cat([rand_a, pol_a], dim=1)  # [B, 2N, A]
        q_ood = self.q_batched(batch["obs"], cand)
        penalty = (torch.logsumexp(q_ood, dim=1) - torch.minimum(q1, q2)).mean()
        q_loss = bellman + cfg.cql_alpha * penalty
        self.q_opt.step(self.q_opt.grads(q_loss))

        # -- actor (standard SAC objective on dataset states) --------------
        a, logp = sample_action(policy, batch["obs"], eps4, scale)
        q1, q2 = qnet(batch["obs"], a)
        pi_loss = (alpha * logp - torch.minimum(q1, q2)).mean()
        self.pi_opt.step(self.pi_opt.grads(pi_loss))

        polyak_(self.q_target, qnet, cfg.tau)
        return {"q_loss": q_loss.detach(), "bellman_loss": bellman.detach(),
                "cql_penalty": penalty.detach(), "pi_loss": pi_loss.detach()}

    def train(self, num_updates: int = 64) -> Dict[str, Any]:
        t0 = time.perf_counter()
        metrics: Tensors = {}
        for _ in range(num_updates):
            batch = self.buffer.sample(self.config.batch_size)
            self._rng, sub = prng.split(self._rng)
            metrics = self.update(to_device(batch, self.device), sub)
            self._updates += 1
        self._iteration += 1
        out = {
            "training_iteration": self._iteration,
            "num_updates": self._updates,
            "time_this_iter_s": time.perf_counter() - t0,
        }
        out.update(host_metrics(metrics) if metrics else {})
        return out

    @torch.no_grad()
    def evaluate(self, episodes: int = 4, seed: int = 0) -> float:
        """Mean-action rollout return of the learned policy."""
        total = 0.0
        for ep in range(episodes):
            env = make_env(self.config.env)
            obs, _ = env.reset(seed=seed + ep)
            done = False
            while not done:
                mean, _ = self.policy(torch.as_tensor(np.asarray(obs, np.float32)[None],
                                                      device=self.device))
                obs, r, term, trunc, _ = env.step(
                    (torch.tanh(mean[0]) * self.scale).cpu().numpy())
                total += r
                done = term or trunc
        return total / episodes
