"""SampleBatch: the unit of experience (reference: rllib/policy/
sample_batch.py:96 — a dict of parallel arrays with concat/shuffle/
minibatch helpers) plus GAE advantage computation.

A copy of ``ray_tpu/rl/sample_batch.py``, which the port may not import:
numpy on the rollout worker, as there."""

from __future__ import annotations

from typing import Dict, Iterator, List

import numpy as np


class SampleBatch(dict):
    OBS = "obs"
    ACTIONS = "actions"
    REWARDS = "rewards"
    DONES = "dones"
    LOGP = "logp"
    VALUES = "values"
    ADVANTAGES = "advantages"
    RETURNS = "returns"

    def __len__(self) -> int:
        for v in self.values():
            return len(v)
        return 0

    @staticmethod
    def concat(batches: List["SampleBatch"]) -> "SampleBatch":
        keys = batches[0].keys()
        return SampleBatch(
            {k: np.concatenate([b[k] for b in batches], axis=0) for k in keys}
        )

    def shuffled(self, rng: np.random.Generator) -> "SampleBatch":
        perm = rng.permutation(len(self))
        return SampleBatch({k: v[perm] for k, v in self.items()})

    def minibatches(self, size: int) -> Iterator["SampleBatch"]:
        n = len(self)
        if 0 < n < size:
            # smaller than one minibatch: train on the whole batch rather
            # than silently performing zero gradient steps
            yield self
            return
        for start in range(0, n - size + 1, size):
            yield SampleBatch({k: v[start : start + size] for k, v in self.items()})


def compute_gae(
    rewards: np.ndarray,
    values: np.ndarray,
    dones: np.ndarray,
    last_values: np.ndarray,
    *,
    gamma: float = 0.99,
    lam: float = 0.95,
):
    """Generalized advantage estimation over [T, num_envs] arrays
    (reference: rllib/evaluation/postprocessing.py compute_advantages)."""
    t_len, n = rewards.shape
    adv = np.zeros((t_len, n), np.float32)
    last_gae = np.zeros(n, np.float32)
    next_values = last_values
    for t in range(t_len - 1, -1, -1):
        nonterminal = 1.0 - dones[t].astype(np.float32)
        delta = rewards[t] + gamma * next_values * nonterminal - values[t]
        last_gae = delta + gamma * lam * nonterminal * last_gae
        adv[t] = last_gae
        next_values = values[t]
    returns = adv + values
    return adv, returns
