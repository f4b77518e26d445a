"""APPO: asynchronous PPO — the IMPALA pipeline with a clipped-surrogate
learner (counterpart of ``ray_tpu/rl/appo.py``).

Reference surface: rllib/algorithms/appo/ (appo.py config: IMPALA subclass
with ``use_critic/use_kl_loss/clip_param``, appo_torch_policy.py loss:
PPO's clipped surrogate computed on V-trace-corrected advantages). The
asynchrony is identical to the Impala algorithm — pipelined
``sample_trajectory`` futures, stale-by-design fragments, periodic weight
broadcast — only the loss changes: instead of the plain V-trace policy
gradient, the importance ratio pi/mu is clipped PPO-style, which tolerates
the staleness window far better at high pipeline depths.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import torch

from ray_tpu_torch import DeviceLike
from ray_tpu_torch.rl.impala import Impala, ImpalaConfig, ImpalaLearner
from ray_tpu_torch.rl.learner import mean_entropy, normalized


class APPOLearner(ImpalaLearner):
    """V-trace + clipped-surrogate update over time-major fragments."""

    def __init__(self, observation_size: int, num_actions: int, *,
                 hidden: Sequence[int] = (64, 64), lr: float = 5e-4,
                 gamma: float = 0.99, vf_coeff: float = 0.5,
                 entropy_coeff: float = 0.01, grad_clip: float = 40.0,
                 clip_param: float = 0.3, rho_bar: float = 1.0,
                 c_bar: float = 1.0, seed: int = 0, device: DeviceLike = None):
        super().__init__(observation_size, num_actions, hidden=hidden, lr=lr, gamma=gamma,
                         vf_coeff=vf_coeff, entropy_coeff=entropy_coeff,
                         grad_clip=grad_clip, rho_bar=rho_bar, c_bar=c_bar, seed=seed,
                         device=device)
        self.clip_param = clip_param

    def loss(self, batch):
        target_logp, logp_all, values, vs, pg_adv = self.vtrace_terms(batch)
        # PPO clipped surrogate on the V-trace advantages (APPO's core:
        # appo_torch_policy.py computes exactly this pairing)
        ratio = torch.exp(target_logp - batch["behavior_logp"])
        adv = normalized(pg_adv)
        unclipped = ratio * adv
        clipped = torch.clamp(ratio, 1 - self.clip_param, 1 + self.clip_param) * adv
        policy_loss = -torch.minimum(unclipped, clipped).mean()
        vf_loss = 0.5 * ((vs - values) ** 2).mean()
        entropy = mean_entropy(logp_all)
        total = policy_loss + self.vf_coeff * vf_loss - self.entropy_coeff * entropy
        return total, {"policy_loss": policy_loss.detach(), "vf_loss": vf_loss.detach(),
                       "entropy": entropy.detach(), "ratio_mean": ratio.mean().detach()}


@dataclasses.dataclass
class APPOConfig(ImpalaConfig):
    clip_param: float = 0.3

    def build(self) -> "APPO":
        return APPO(self)


class APPO(Impala):
    """Async algorithm with the APPO learner (everything else is IMPALA)."""

    def _make_learner(self, probe) -> APPOLearner:
        cfg = self.config
        return APPOLearner(
            probe.observation_size, probe.num_actions,
            hidden=cfg.hidden, lr=cfg.lr, gamma=cfg.gamma,
            vf_coeff=cfg.vf_coeff, entropy_coeff=cfg.entropy_coeff,
            clip_param=cfg.clip_param, rho_bar=cfg.rho_bar,
            c_bar=cfg.c_bar, seed=cfg.seed, device=cfg.device,
        )
