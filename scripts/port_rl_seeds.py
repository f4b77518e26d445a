#!/usr/bin/env python3
"""How the port's RL learning tests depend on the seed, on the CPU.

    python scripts/port_rl_seeds.py ALGORITHM [--seeds 0 1 2 3 4 5]

Runs the reference's learning-test configuration of one algorithm with the
port on the CPU, in-process hooks, once per seed, and prints for each how
far into its budget the test's gate was met, or the best it reached:

- ``ppo`` (tests/test_rl.py:84): best mean return >= 120 within 30
  iterations; ``impala`` (test_rl.py:257) and ``appo``
  (test_rl_breadth.py:189): >= 80 within 40 calls of ``train(num_updates=8)``;
- ``dqn`` (test_rl.py:231): >= 100 within 60 iterations; ``apex``
  (test_rl_external.py:85): >= 100 within 50;
- ``td3`` (test_rl_breadth.py:247): best > -400 within 30 iterations;
- ``es`` (test_rl_breadth.py:407): best >= 3 * max(first, 15) (or >= 100)
  within 1 + 14 iterations;
- ``sac`` (test_rl_breadth.py:60): the last 5 returns' mean at least 150
  above the first 15 iterations' mean, over 60 iterations;
- ``policy_server`` (test_rl_external.py:19): the last 10 episodes' mean
  >= 120 after at least 20 episodes, within 300 s of wall time.

Every port network starts from the reference's initial weights for the
seed (``rl.prng``), so a seed here is the reference's seed.
"""

from __future__ import annotations

import argparse
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402

CPU = dict(device="cpu", rollout_device="cpu")


def _best_within(algo, budget, reached, **train_kw):
    """(the call that met ``reached(best)``, or None; the best return)."""
    best = -np.inf
    try:
        for i in range(budget):
            r = algo.train(**train_kw)
            m = r["episode_return_mean"]
            if m is not None and np.isfinite(m):
                best = max(best, m)
            if reached(best):
                return i + 1, best
    finally:
        algo.stop()
    return None, best


def _return_gate(name, config, target, budget, train_kw=None):
    def run(seed):
        from ray_tpu_torch import rl

        algo = getattr(rl, name)(seed=seed, **CPU, **config).build()
        return _best_within(algo, budget, lambda b: b >= target, **(train_kw or {}))
    return run, f">= {target} within {budget}"


def _td3(seed):
    from ray_tpu_torch.rl import TD3Config

    algo = TD3Config(env="Pendulum-v1", num_envs_per_worker=4, warmup_steps=512, batch_size=256,
                     rollout_fragment_length=64, updates_per_iteration=256, actor_lr=1e-3,
                     critic_lr=1e-3, tau=0.01, seed=seed, **CPU).build()
    return _best_within(algo, 30, lambda b: b > -400.0)


def _es(seed):
    from ray_tpu_torch.rl import ESConfig

    algo = ESConfig(num_workers=4, population=12, sigma=0.1, lr=0.1, hidden=(32, 32), seed=seed,
                    device="cpu").build()
    try:
        first = best = algo.train()["episode_return_mean"]
        for i in range(14):
            best = max(best, algo.train()["episode_return_mean"])
            if best >= 3 * max(first, 15.0) or best >= 100.0:
                return i + 2, best
    finally:
        algo.stop()
    return None, best


def _sac(seed):
    from ray_tpu_torch.rl import SACConfig

    algo = SACConfig(env="Pendulum-v1", warmup_steps=500, batch_size=128,
                     updates_per_iteration=48, rollout_fragment_length=64,
                     num_envs_per_worker=4, seed=seed, **CPU).build()
    early, late = [], []
    try:
        for i in range(60):
            r = algo.train().get("episode_return_mean")
            if r is not None:
                (early if i < 15 else late).append(r)
    finally:
        algo.stop()
    improvement = float(np.mean(late[-5:]) - np.mean(early))
    return (60 if improvement > 150 else None), improvement


def _policy_server(seed):
    from ray_tpu_torch.rl import PolicyClient, PolicyServer, make_env

    server = PolicyServer(4, 2, lr=1e-3, learning_starts=300, train_every=8,
                          epsilon_decay_steps=2500, seed=seed, device="cpu")
    client = PolicyClient(server.address, timeout=30.0)
    env = make_env("CartPole-v1")
    returns, deadline = [], time.monotonic() + 300
    try:
        while time.monotonic() < deadline:
            episode_id = client.start_episode()
            obs, _ = env.reset(seed=len(returns))
            done = False
            while not done:
                action = client.get_action(episode_id, obs)
                obs, reward, term, trunc, _ = env.step(action)
                client.log_returns(episode_id, reward)
                done = term or trunc
            returns.append(client.end_episode(episode_id, obs)["episode_return"])
            if len(returns) >= 20 and np.mean(returns[-10:]) >= 120.0:
                return len(returns), float(np.mean(returns[-10:]))
    finally:
        client.close()
        server.stop()
    return None, float(np.mean(returns[-10:]))


TESTS = {
    "ppo": _return_gate("PPOConfig", dict(num_rollout_workers=2, num_envs_per_worker=4,
                                          rollout_fragment_length=128, lr=1e-3, num_epochs=8,
                                          minibatch_size=256), 120.0, 30),
    "impala": _return_gate("ImpalaConfig", dict(num_rollout_workers=2, num_envs_per_worker=4,
                                                rollout_fragment_length=32, lr=1e-3), 80.0, 40,
                           dict(num_updates=8)),
    "appo": _return_gate("APPOConfig", dict(num_rollout_workers=2, num_envs_per_worker=4,
                                            rollout_fragment_length=32, lr=1e-3), 80.0, 40,
                         dict(num_updates=8)),
    "dqn": _return_gate("DQNConfig", dict(num_rollout_workers=1, num_envs_per_worker=4,
                                          rollout_fragment_length=64, learning_starts=256,
                                          epsilon_decay_steps=3000, updates_per_iteration=16,
                                          target_update_interval=100), 100.0, 60),
    "apex": _return_gate("ApexDQNConfig", dict(num_rollout_workers=2, num_envs_per_worker=4,
                                               num_replay_shards=2, rollout_fragment_length=32,
                                               learning_starts=500, updates_per_iteration=48,
                                               train_batch_size=64, target_update_interval=200,
                                               epsilon_decay_steps=4000, lr=1e-3), 100.0, 50),
    "td3": (_td3, "> -400 within 30"),
    "es": (_es, ">= 3 * max(first, 15) or >= 100 within 15"),
    "sac": (_sac, "an improvement > 150 over 60 iterations"),
    "policy_server": (_policy_server, "last-10 mean >= 120 within 300 s"),
}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("algorithm", choices=sorted(TESTS))
    ap.add_argument("--seeds", type=int, nargs="+", default=list(range(6)))
    args = ap.parse_args()
    run, gate = TESTS[args.algorithm]
    for seed in args.seeds:
        t0 = time.monotonic()
        taken, best = run(seed)
        print(f"{args.algorithm} seed {seed} ({gate}): "
              + (f"met after {taken}" if taken else "not met")
              + f", best {best:.1f}, {time.monotonic() - t0:.1f} s", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
