"""The port's off-policy algorithms end to end on the CPU, at the
reference's configurations, seeds, gates and budgets
(tests/test_rl_breadth.py, tests/test_rl_external.py), with the default
hooks: every actor in this process, the learners and the workers'
forwards on the CPU. The reference's tier-1 mechanics tests are tier-1
here; its slow-marked learning tests are slow-marked here, and its
``RAYTPU_RUN_SLOW`` one is gated the same way. Ape-X's learning test runs
under ray_tpu's actors (through ``scripts/port_rl_smoke.py``'s hooks), as
the reference's does: with in-process actors every sampling call would
run to its end before the next update.
"""

import os
import time

import numpy as np
import pytest

from ray_tpu_torch.rl import (
    BCConfig,
    CQLConfig,
    ApexDQNConfig,
    DDPGConfig,
    DQNConfig,
    ESConfig,
    MARWILConfig,
    PolicyClient,
    PolicyServer,
    PPOConfig,
    RainbowDQNConfig,
    SACConfig,
    SACRolloutWorker,
    TD3Config,
    make_env,
    offline,
)

from scripts.port_rl_smoke import timed_rl_hooks

CPU = dict(device="cpu", rollout_device="cpu")


def test_sac_update_mechanics():
    """One SAC iteration past warmup: losses finite, alpha positive, env
    steps grow (test_rl_breadth.py:33)."""
    algo = SACConfig(env="Pendulum-v1", warmup_steps=128, batch_size=64,
                     updates_per_iteration=4, rollout_fragment_length=32,
                     num_envs_per_worker=4, **CPU).build()
    try:
        m1 = algo.train()  # warmup sampling
        m2 = algo.train()  # first real updates
        assert np.isfinite(m2["q_loss"]) and np.isfinite(m2["pi_loss"])
        assert m2["alpha"] > 0.0
        assert m2["env_steps"] > m1["env_steps"]
    finally:
        algo.stop()


@pytest.mark.skipif(os.environ.get("RAYTPU_RUN_SLOW") != "1",
                    reason="learning run (~5 min); set RAYTPU_RUN_SLOW=1")
def test_sac_learns_pendulum():
    algo = SACConfig(env="Pendulum-v1", warmup_steps=500, batch_size=128,
                     updates_per_iteration=48, rollout_fragment_length=64,
                     num_envs_per_worker=4, seed=0, **CPU).build()
    try:
        early, late = [], []
        for i in range(60):
            r = algo.train().get("episode_return_mean")
            if r is not None:
                (early if i < 15 else late).append(r)
        assert late, "no episodes completed"
        improvement = np.mean(late[-5:]) - np.mean(early)
        assert improvement > 150, (np.mean(early), late[-5:])
    finally:
        algo.stop()


def test_td3_update_mechanics():
    """Critic every update, actor every policy_delay-th; the targets move
    (test_rl_breadth.py:215)."""
    algo = TD3Config(env="Pendulum-v1", warmup_steps=128, batch_size=64,
                     rollout_fragment_length=64, updates_per_iteration=8, policy_delay=2,
                     seed=0, **CPU).build()
    try:
        q_t0 = {k: v.clone() for k, v in algo.q_target.state_dict().items()}
        algo.train()  # warmup fill
        r2 = algo.train()  # real updates
        assert np.isfinite(r2["q_loss"])
        moved = max(float((v - q_t0[k]).abs().max())
                    for k, v in algo.q_target.state_dict().items())
        assert moved > 0.0, "target never synced"
        assert algo._updates == 16
    finally:
        algo.stop()


@pytest.mark.slow  # as the reference's
def test_td3_improves_pendulum():
    algo = TD3Config(env="Pendulum-v1", num_envs_per_worker=4, warmup_steps=512, batch_size=256,
                     rollout_fragment_length=64, updates_per_iteration=256, actor_lr=1e-3,
                     critic_lr=1e-3, tau=0.01, seed=0, **CPU).build()
    try:
        first, best = None, -1e9
        for _ in range(30):
            m = algo.train()["episode_return_mean"]
            if m is not None and np.isfinite(m):
                first = m if first is None else first
                best = max(best, m)
            if best > -400.0:
                break
        assert best > -400.0, f"TD3 did not improve: first {first}, best {best}"
    finally:
        algo.stop()


def test_ddpg_update_mechanics():
    """The actor updates every step, no target smoothing
    (test_rl_breadth.py:500)."""
    algo = DDPGConfig(env="Pendulum-v1", warmup_steps=128, batch_size=64,
                      rollout_fragment_length=64, updates_per_iteration=8, seed=0,
                      **CPU).build()
    try:
        algo.train()
        r = algo.train()
        assert np.isfinite(r["q_loss"])
        assert r["pi_loss"] != 0.0
        assert algo.config.policy_delay == 1 and algo.config.target_noise == 0.0
    finally:
        algo.stop()


def test_rainbow_dqn_mechanics():
    """dueling + noisy + 3-step + C51 (test_rl_breadth.py:575)."""
    algo = RainbowDQNConfig(num_rollout_workers=1, num_envs_per_worker=4,
                            rollout_fragment_length=32, learning_starts=64,
                            train_batch_size=32, updates_per_iteration=4, seed=0,
                            **CPU).build()
    try:
        assert algo.epsilon == 0.0
        m1 = algo.train()
        m2 = algo.train()
        assert m2["buffer_size"] > 0 and np.isfinite(m2["mean_loss"])
        assert m2["env_steps_total"] > m1["env_steps_total"] > 0
    finally:
        algo.stop()


def test_c51_dqn_mechanics():
    """num_atoms > 1: a finite, positive cross-entropy
    (test_rl_breadth.py:650)."""
    algo = DQNConfig(num_rollout_workers=1, num_envs_per_worker=4, rollout_fragment_length=32,
                     learning_starts=64, train_batch_size=32, updates_per_iteration=4,
                     num_atoms=21, v_min=0.0, v_max=120.0, seed=0, **CPU).build()
    try:
        m1 = algo.train()
        m2 = algo.train()
        assert np.isfinite(m2["mean_loss"]) and m2["mean_loss"] > 0
        assert m2["env_steps_total"] > m1["env_steps_total"]
    finally:
        algo.stop()


def _collect_cartpole_dataset(tmp_path, steps=1500):
    """Train PPO briefly, then log its rollouts as offline data (the
    reference's helper, test_rl_breadth.py:281)."""
    algo = PPOConfig(num_rollout_workers=2, num_envs_per_worker=4, rollout_fragment_length=64,
                     seed=0, **CPU).build()
    try:
        for _ in range(10):
            if (algo.train().get("episode_return_mean") or 0) >= 60.0:
                break
        batches = algo.hooks.get([w.sample.remote(steps // (2 * 4)) for w in algo.workers],
                                 timeout=300)
        path = str(tmp_path / "cartpole_offline")
        offline.write_sample_batches(batches, path)
        returns = [x for w in algo.workers
                   for x in algo.hooks.get(w.episode_returns.remote(), timeout=60)]
        behavior = float(np.mean(returns)) if returns else 0.0
    finally:
        algo.stop()
    return path, behavior


def test_bc_marwil_learn_from_offline(tmp_path):
    """BC clones the behavior policy; MARWIL's value head trains
    (test_rl_breadth.py:311)."""
    path, behavior_return = _collect_cartpole_dataset(tmp_path)
    bc = BCConfig(input_path=path, lr=1e-3, batch_size=256, seed=0, device="cpu").build()
    first = bc.train(epochs=1)["policy_loss"]
    for _ in range(20):
        last = bc.train(epochs=1)["policy_loss"]
    assert last < first, f"BC loss did not decrease: {first} -> {last}"
    bc_return = bc.evaluate("CartPole-v1", episodes=4)
    assert bc_return >= min(40.0, 0.5 * max(behavior_return, 1.0)), (bc_return, behavior_return)

    mw = MARWILConfig(input_path=path, beta=1.0, lr=1e-3, batch_size=256, seed=0,
                      device="cpu").build()
    m1 = mw.train(epochs=1)
    for _ in range(10):
        m2 = mw.train(epochs=1)
    assert np.isfinite(m2["total_loss"])
    assert m2["vf_loss"] < m1["vf_loss"], "MARWIL value head did not train"


def test_cql_trains_offline_conservatively(tmp_path):
    """CQL from a logged random Pendulum dataset (test_rl_breadth.py:431)."""
    w = SACRolloutWorker("Pendulum-v1", num_envs=4, seed=0, device="cpu")
    path = str(tmp_path / "pendulum_offline")
    offline.write_sample_batches([w.sample(128, True)], path)
    algo = CQLConfig(input_path=path, env="Pendulum-v1", batch_size=128, cql_alpha=1.0, seed=0,
                     device="cpu").build()
    r1 = algo.train(num_updates=16)
    r2 = algo.train(num_updates=16)
    assert np.isfinite(r2["q_loss"]) and np.isfinite(r2["pi_loss"])
    assert r2["cql_penalty"] < r1["cql_penalty"] + 50.0
    ret = algo.evaluate(episodes=2)
    assert np.isfinite(ret) and ret <= 0.0


@pytest.mark.slow  # as the reference's
def test_es_improves_cartpole():
    algo = ESConfig(num_workers=4, population=12, sigma=0.1, lr=0.1, hidden=(32, 32), seed=0,
                    device="cpu").build()
    try:
        first = algo.train()["episode_return_mean"]
        best = first
        for _ in range(14):
            best = max(best, algo.train()["episode_return_mean"])
            if best >= 3 * max(first, 15.0):
                break
        assert best >= 3 * max(first, 15.0) or best >= 100.0, (first, best)
    finally:
        algo.stop()


@pytest.mark.slow  # as the reference's
def test_apex_mechanics_and_learning(ray_start_regular):
    """Under ray_tpu's actors, as the reference's: the workers sample while
    the learner trains."""
    algo = ApexDQNConfig(num_rollout_workers=2, num_envs_per_worker=4, num_replay_shards=2,
                         rollout_fragment_length=32, learning_starts=500,
                         updates_per_iteration=48, train_batch_size=64,
                         target_update_interval=200, epsilon_decay_steps=4000, lr=1e-3, seed=0,
                         hooks=timed_rl_hooks(), **CPU).build()
    best = 0.0
    try:
        for _ in range(50):
            result = algo.train()
            assert len(result["replay_shard_sizes"]) == 2
            if np.isfinite(result["episode_return_mean"]):
                best = max(best, result["episode_return_mean"])
            if best >= 100.0:
                break
        final = algo.train()
        assert all(s > 0 for s in final["replay_shard_sizes"]), final
        assert final["num_updates"] > 0 and final["worker_failures"] == 0
        assert best >= 100.0, f"Apex-DQN failed to learn: best {best}"
    finally:
        algo.stop()


@pytest.mark.slow  # as the reference's
def test_policy_client_server_external_cartpole():
    probe = make_env("CartPole-v1")
    server = PolicyServer(probe.observation_size, probe.num_actions, lr=1e-3,
                          learning_starts=300, train_every=8, epsilon_decay_steps=2500, seed=0,
                          device="cpu")
    client = PolicyClient(server.address, timeout=30.0)
    env = make_env("CartPole-v1")
    try:
        returns = []
        deadline = time.monotonic() + 300
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
                break
        recent = float(np.mean(returns[-10:]))
        assert recent >= 120.0, f"last-10 mean {recent} over {len(returns)} episodes"
        stats = client.get_stats()
        assert stats["updates"] > 0 and stats["transitions"] > 300
    finally:
        client.close()
        server.stop()
