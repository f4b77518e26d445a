"""IMPALA: asynchronous sampling with V-trace off-policy correction
(counterpart of ``ray_tpu/rl/impala.py``).

Reference: rllib/algorithms/impala/impala.py (:26-27 async sample queue +
learner thread), rllib/execution/learner_thread.py. The actor-learner
decoupling is reproduced with pipelined rollout futures: each worker
always has a sample in flight; the learner consumes whichever fragment
lands first and only broadcasts weights every ``broadcast_interval``
updates, so fragments are stale by design — V-trace (Espeholt et al.,
2018) corrects the off-policyness with clipped importance ratios.
The V-trace recursion runs on the learner's device as a loop over time
(the reference's reverse ``lax.scan``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import Any, Dict, List, Sequence, Tuple

import numpy as np
import torch

from ray_tpu_torch import DeviceLike
from ray_tpu_torch.rl.env import make_env
from ray_tpu_torch.rl.learner import PolicyLearner, log_probs, mean_entropy
from ray_tpu_torch.rl.rollout_worker import RolloutWorker
from ray_tpu_torch.runtime import RuntimeHooks


def vtrace(
    target_logp: torch.Tensor,      # [T, B] log pi(a|s) under the learner
    behavior_logp: torch.Tensor,    # [T, B] log mu(a|s) under the actor
    rewards: torch.Tensor,          # [T, B]
    values: torch.Tensor,           # [T, B] learner V(s_t)
    bootstrap_value: torch.Tensor,  # [B]    learner V(s_T)
    dones: torch.Tensor,            # [T, B] episode cuts
    *,
    gamma: float = 0.99,
    rho_bar: float = 1.0,
    c_bar: float = 1.0,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Returns (vs, pg_advantages) per the V-trace definition, both
    detached (the reference's ``stop_gradient``).

    vs_t = V(s_t) + sum_{k>=t} gamma^{k-t} (prod_{i<k} c_i) rho_k delta_k,
    computed as the backward recursion acc_t = delta_t + gamma c_t acc_{t+1}
    with episode cuts zeroing the carry.
    """
    rhos = torch.exp(target_logp - behavior_logp)
    clipped_rho = torch.clamp(rhos, max=rho_bar)
    cs = torch.clamp(rhos, max=c_bar)
    not_done = 1.0 - dones.to(values.dtype)
    next_values = torch.cat([values[1:], bootstrap_value[None]], dim=0) * not_done
    deltas = clipped_rho * (rewards + gamma * next_values - values)
    acc = torch.zeros_like(bootstrap_value)
    accs = []
    for t in range(len(deltas) - 1, -1, -1):
        acc = deltas[t] + gamma * cs[t] * not_done[t] * acc
        accs.append(acc)
    vs = values + torch.stack(accs[::-1])
    next_vs = torch.cat([vs[1:], bootstrap_value[None]], dim=0) * not_done
    pg_adv = clipped_rho * (rewards + gamma * next_vs - values)
    return vs.detach(), pg_adv.detach()


class ImpalaLearner(PolicyLearner):
    """V-trace actor-critic update over time-major fragments."""

    def __init__(self, observation_size: int, num_actions: int, *,
                 hidden: Sequence[int] = (64, 64), lr: float = 5e-4,
                 gamma: float = 0.99, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.01, grad_clip: float = 40.0,
                 rho_bar: float = 1.0, c_bar: float = 1.0, seed: int = 0,
                 device: DeviceLike = None):
        super().__init__(observation_size, num_actions, hidden=hidden, lr=lr,
                         grad_clip=grad_clip, seed=seed, device=device)
        self.gamma, self.vf_coeff, self.entropy_coeff = gamma, vf_coeff, entropy_coeff
        self.rho_bar, self.c_bar = rho_bar, c_bar

    def vtrace_terms(self, batch):
        """(target logp, log_softmax, values, vs, pg advantages) of a
        time-major fragment under the learner's policy."""
        t, b, d = batch["obs"].shape
        logits, values = self.net(batch["obs"].reshape(t * b, d))
        logits = logits.reshape(t, b, -1)
        values = values.reshape(t, b)
        _, bootstrap_value = self.net(batch["bootstrap_obs"])
        logp_all, target_logp = log_probs(logits, batch["actions"])
        vs, pg_adv = vtrace(
            target_logp, batch["behavior_logp"], batch["rewards"],
            values, bootstrap_value, batch["dones"],
            gamma=self.gamma, rho_bar=self.rho_bar, c_bar=self.c_bar,
        )
        return target_logp, logp_all, values, vs, pg_adv

    def loss(self, batch):
        target_logp, logp_all, values, vs, pg_adv = self.vtrace_terms(batch)
        policy_loss = -(target_logp * pg_adv).mean()
        vf_loss = 0.5 * ((vs - values) ** 2).mean()
        entropy = mean_entropy(logp_all)
        total = policy_loss + self.vf_coeff * vf_loss - self.entropy_coeff * entropy
        return total, {"policy_loss": policy_loss.detach(), "vf_loss": vf_loss.detach(),
                       "entropy": entropy.detach()}


@dataclasses.dataclass
class ImpalaConfig:
    env: str = "CartPole-v1"
    num_rollout_workers: int = 2
    num_envs_per_worker: int = 4
    rollout_fragment_length: int = 32
    pipeline_depth: int = 2          # in-flight sample futures per worker
    broadcast_interval: int = 4      # updates between weight broadcasts
    lr: float = 5e-4
    gamma: float = 0.99
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    rho_bar: float = 1.0
    c_bar: float = 1.0
    hidden: tuple = (64, 64)
    seed: int = 0
    device: Any = None
    rollout_device: Any = None
    hooks: RuntimeHooks = dataclasses.field(default_factory=RuntimeHooks)

    def build(self) -> "Impala":
        return Impala(self)


class Impala:
    """Async algorithm: pipelined rollouts + V-trace learner."""

    def __init__(self, config: ImpalaConfig):
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
                device=config.rollout_device,
            )
            for i in range(config.num_rollout_workers)
        ]
        self.learner = self._make_learner(probe)
        self._iteration = 0
        self._updates = 0
        self._env_steps = 0
        self._broadcast_weights()
        # prime the pipeline: every worker keeps pipeline_depth samples
        # in flight, the learner-side analogue of the reference's sample
        # queue feeding the learner thread
        self._inflight: Dict[Any, Any] = {}
        for w in self.workers:
            for _ in range(config.pipeline_depth):
                self._inflight[
                    w.sample_trajectory.remote(config.rollout_fragment_length)
                ] = w

    def _make_learner(self, probe) -> PolicyLearner:
        cfg = self.config
        return ImpalaLearner(
            probe.observation_size, probe.num_actions,
            hidden=cfg.hidden, lr=cfg.lr, gamma=cfg.gamma,
            vf_coeff=cfg.vf_coeff, entropy_coeff=cfg.entropy_coeff,
            rho_bar=cfg.rho_bar, c_bar=cfg.c_bar, seed=cfg.seed, device=cfg.device,
        )

    def _broadcast_weights(self):
        weights = self.learner.get_weights()
        self.hooks.get([w.set_weights.remote(weights) for w in self.workers], timeout=120)

    def train(self, num_updates: int = 8) -> Dict[str, Any]:
        """Consume ``num_updates`` fragments as they land (async)."""
        t0 = time.perf_counter()
        cfg = self.config
        metric_sums: Dict[str, float] = {}
        for _ in range(num_updates):
            ready, _ = self.hooks.wait(list(self._inflight), num_returns=1, timeout=600)
            if not ready:
                raise TimeoutError(
                    "no rollout fragment completed within 600s "
                    f"({len(self._inflight)} in flight) — a rollout worker "
                    "is likely stuck"
                )
            ref = ready[0]
            worker = self._inflight.pop(ref)
            batch = self.hooks.get(ref, timeout=60)
            # immediately refill the pipeline slot
            self._inflight[
                worker.sample_trajectory.remote(cfg.rollout_fragment_length)
            ] = worker
            for k, v in self.learner.update(batch).items():
                metric_sums[k] = metric_sums.get(k, 0.0) + v
            self._env_steps += int(np.prod(batch["actions"].shape))
            self._updates += 1
            if self._updates % cfg.broadcast_interval == 0:
                self._broadcast_weights()
        metrics = {k: v / max(1, num_updates) for k, v in metric_sums.items()}
        episode_returns: List[float] = []
        for w in self.workers:
            episode_returns.extend(self.hooks.get(w.episode_returns.remote(), timeout=60))
        self._iteration += 1
        return {
            "training_iteration": self._iteration,
            "num_updates": self._updates,
            "env_steps_total": self._env_steps,
            "episode_return_mean": float(np.mean(episode_returns))
            if episode_returns else float("nan"),
            "episodes_this_iter": len(episode_returns),
            "time_this_iter_s": time.perf_counter() - t0,
            **metrics,
        }

    def stop(self):
        for w in self.workers:
            self.hooks.kill(w)
