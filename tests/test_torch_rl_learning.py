"""The port's RL algorithms learn CartPole on the CPU, at the reference's
configurations, seeds, thresholds and budgets (tests/test_rl.py and
tests/test_rl_breadth.py), with the default hooks: every rollout worker in
this process, the learners and the workers' policies on the CPU.

- PG: best mean return >= 100 within 40 iterations
  (test_rl_breadth.py:600);
- A2C: >= 70 within 60 (:384);
- IMPALA: >= 80 within 40 calls of ``train(num_updates=8)``
  (test_rl.py:257);
- multi-agent PPO: the last mean return above the first over 10
  iterations, both policies trained (test_rl_breadth.py:103);
- PPO: >= 120 within 30 (test_rl.py:84; the reference's is marked slow at
  ~14 s, the port's takes a few seconds here).
"""

import numpy as np

from ray_tpu_torch.rl import (
    A2CConfig,
    ImpalaConfig,
    MultiAgentPPOConfig,
    PGConfig,
    PPOConfig,
)

CPU = dict(device="cpu", rollout_device="cpu")


def _best_within(algo, iterations: int, threshold: float, **train_kw) -> float:
    best = 0.0
    try:
        for _ in range(iterations):
            result = algo.train(**train_kw)
            if np.isfinite(result["episode_return_mean"]):
                best = max(best, result["episode_return_mean"])
            if best >= threshold:
                break
    finally:
        algo.stop()
    return best


def test_pg_learns_cartpole():
    algo = PGConfig(num_rollout_workers=2, num_envs_per_worker=4, rollout_fragment_length=128,
                    lr=2e-3, seed=0, **CPU).build()
    best = _best_within(algo, 40, 100.0)
    assert best >= 100.0, f"PG failed to learn CartPole: best {best}"


def test_a2c_learns_cartpole():
    algo = A2CConfig(num_rollout_workers=2, num_envs_per_worker=4, rollout_fragment_length=32,
                     lr=1e-3, seed=0, **CPU).build()
    best = _best_within(algo, 60, 70.0)
    assert best >= 70.0, f"A2C failed to learn CartPole: best {best}"


def test_impala_learns_cartpole():
    algo = ImpalaConfig(num_rollout_workers=2, num_envs_per_worker=4,
                        rollout_fragment_length=32, lr=1e-3, seed=0, **CPU).build()
    best = _best_within(algo, 40, 80.0, num_updates=8)
    assert best >= 80.0, f"IMPALA failed to learn CartPole: best {best}"


def test_ppo_learns_cartpole():
    algo = PPOConfig(num_rollout_workers=2, num_envs_per_worker=4, rollout_fragment_length=128,
                     lr=1e-3, num_epochs=8, minibatch_size=256, seed=0, **CPU).build()
    best = _best_within(algo, 30, 120.0)
    assert best >= 120.0, f"PPO failed to learn CartPole: best {best}"


def test_multi_agent_ppo_trains():
    algo = MultiAgentPPOConfig(num_rollout_workers=2, rollout_fragment_length=128, seed=0,
                               **CPU).build()
    first = last = None
    try:
        for _ in range(10):
            m = algo.train()
            if m["episode_return_mean"] is not None:
                last = m["episode_return_mean"]
                first = last if first is None else first
    finally:
        algo.stop()
    assert set(m["policy_losses"]) == {"policy_agent_0", "policy_agent_1"}
    assert last is not None and first is not None
    assert last > first, (first, last)
