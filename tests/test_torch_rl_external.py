"""The port's offline datasets, ES, policy server and Ape-X, on the CPU,
held to the reference and run under ray_tpu's runtime through the glue
(``scripts/port_rl_smoke.py``'s ``rl_hooks()``).

- Offline files: a dataset the reference wrote (``ray_tpu.data``'s
  parquet) reads back in the port, through the default hooks (pyarrow)
  and through the glue's; one the port wrote reads back in the reference.
- ES: the flat vector is the reference's (``jax.tree_util`` order), a
  noise seed perturbs the same weights, an eval worker scores the same
  episode.
- The policy server: episodes, stats and the unknown-episode error over
  the in-process transport and over ray_tpu's ``RpcServer``; under
  concurrent clients no action is taken while the learner's optimizer
  updates the network (every forward and every update hold the server's
  lock).
- Ape-X with 2 rollout actors and a replay-shard actor under ray_tpu.

Every ``get``, ``wait`` and RPC call here has a timeout (the glue's
``timed_rl_hooks()`` raise on a ``get`` or ``wait`` without one, in the
actors too).
"""

import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ray_tpu.api import ActorHandle
from ray_tpu.rl import es as ref_es
from ray_tpu.rl import offline as ref_offline
from ray_tpu.rl import rl_module as ref_rl_module
from ray_tpu.rl.sample_batch import SampleBatch as RefBatch
from ray_tpu_torch.rl import (
    ApexDQNConfig,
    DQNLearner,
    PolicyClient,
    PolicyServer,
    SampleBatch,
    es,
    make_env,
    offline,
)
from ray_tpu_torch.rl.convert import params_to_state_dict, state_dict_to_params

from scripts.port_rl_smoke import timed_rl_hooks as _hooks

CPU = dict(device="cpu", rollout_device="cpu")


def _experience(n=64, seed=0):
    rng = np.random.default_rng(seed)
    return dict(obs=rng.random((n, 4), dtype=np.float32),
                actions=rng.integers(0, 2, n).astype(np.int32),
                rewards=np.ones(n, np.float32),
                next_obs=rng.random((n, 4), dtype=np.float32),
                dones=np.zeros(n, np.float32),
                cont=rng.normal(size=(n, 2, 3)).astype(np.float32))


def _assert_same(got, want):
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_offline_files_round_trip_both_ways(ray_start_regular, tmp_path):
    """The reference writes, the port reads (default hooks and the glue's);
    the port writes (both ways), the reference reads."""
    batch = _experience()
    two = {k: np.concatenate([v, v]) for k, v in batch.items()}
    ref_path = str(tmp_path / "ref")
    ref_offline.write_sample_batches([RefBatch(batch), RefBatch(batch)], ref_path)
    for hooks in (None, _hooks()):
        back = SampleBatch.concat(list(offline.read_sample_batches(ref_path, hooks=hooks)))
        _assert_same(back, two)
    for name, hooks in (("port_default", None), ("port_glue", _hooks())):
        path = str(tmp_path / name)
        files = offline.write_sample_batches([SampleBatch(batch)] * 2, path, hooks=hooks)
        assert files and all(f.startswith(path) for f in files)
        back = RefBatch.concat(list(ref_offline.read_sample_batches(path)))
        _assert_same(back, two)
    buf = offline.load_replay_buffer(ref_path)
    assert len(buf) == 128 and buf.sample(32)["cont"].shape == (32, 2, 3)


def test_offline_dqn_training(tmp_path):
    """DQN from logged experience alone (the reference's
    test_offline_dqn_training, default hooks): the TD loss shrinks."""
    rng = np.random.default_rng(0)
    n = 512
    obs = rng.random((n, 4), dtype=np.float32)
    batch = SampleBatch(
        obs=obs,
        actions=rng.integers(0, 2, n).astype(np.int32),
        rewards=(obs[:, 0] > 0.5).astype(np.float32),
        new_obs=rng.random((n, 4), dtype=np.float32),
        dones=(rng.random(n) < 0.1).astype(np.float32),
    )
    path = str(tmp_path / "exp")
    offline.write_sample_batches([batch], path)
    buf = offline.load_replay_buffer(path)
    learner = DQNLearner(observation_size=4, num_actions=2, device="cpu")
    losses = [learner.update(buf.sample(64))[0] for _ in range(20)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-5:]) < np.mean(losses[:5])


def test_es_flat_vector_and_perturbation_are_the_reference_ones():
    params = jax.device_get(ref_rl_module.DiscretePolicyModule(2, (32, 32)).init(
        jax.random.PRNGKey(3), jnp.zeros((1, 4)))["params"])
    want_flat, spec = ref_es._flatten_params(params)
    got_flat, port_spec = es._flatten_params(params_to_state_dict(params))
    np.testing.assert_array_equal(got_flat, want_flat)
    flat = want_flat.astype(np.float64)
    eps = np.random.default_rng(11).standard_normal(flat.shape[0])
    want = ref_es._unflatten_params(flat + 0.05 * eps, spec)
    got = state_dict_to_params(es._unflatten_params(flat + 0.05 * eps, port_spec))
    for (path, a), b in zip(jax.tree_util.tree_leaves_with_path(want),
                            jax.tree_util.tree_leaves(got)):
        assert b.dtype == np.float32
        np.testing.assert_array_equal(b, np.asarray(a), err_msg=jax.tree_util.keystr(path))
    # an eval worker scores the same perturbed policy on the same episode
    ref_worker = ref_es.ESEvalWorker._cls("CartPole-v1", (32, 32), 5)
    port_worker = es.ESEvalWorker("CartPole-v1", (32, 32), 5, device="cpu")
    np.testing.assert_array_equal(port_worker.flat, ref_worker.flat)
    for w in (ref_worker, port_worker):
        w.set_flat(flat)
    for noise_seed, sign in ((11, 1.0), (11, -1.0), (12, 1.0)):
        assert (port_worker.evaluate(noise_seed, sign, 0.05)
                == ref_worker.evaluate(noise_seed, sign, 0.05))


def test_es_trains_on_the_reference_initial_vector():
    algo = es.ESConfig(num_workers=2, population=4, seed=3, device="cpu").build()
    try:
        params = jax.device_get(ref_rl_module.DiscretePolicyModule(2, (32, 32)).init(
            jax.random.PRNGKey(3), jnp.zeros((1, 4)))["params"])
        np.testing.assert_array_equal(algo.get_flat_weights(),
                                      ref_es._flatten_params(params)[0].astype(np.float64))
        r = algo.train()
        assert r["episodes_total"] == 8 and np.isfinite(r["grad_norm"])
    finally:
        algo.stop()


def _drive(client, env, episodes, seed0=0):
    returns = []
    for ep in range(episodes):
        episode_id = client.start_episode()
        obs, _ = env.reset(seed=seed0 + ep)
        done = False
        while not done:
            action = client.get_action(episode_id, obs)
            obs, reward, term, trunc, _ = env.step(action)
            client.log_returns(episode_id, reward)
            done = term or trunc
        returns.append(client.end_episode(episode_id, obs)["episode_return"])
    return returns


def _unknown_episode_errors(server, client):
    with pytest.raises(KeyError):
        client.get_action("nonexistent", np.zeros(4, np.float32))
    # concurrent episodes are independent
    e1, e2 = client.start_episode(), client.start_episode()
    a1 = client.get_action(e1, np.zeros(4, np.float32))
    a2 = client.get_action(e2, np.ones(4, np.float32))
    assert a1 in (0, 1) and a2 in (0, 1)
    client.log_returns(e1, 1.0)
    client.end_episode(e1, np.zeros(4, np.float32))
    client.log_returns(e2, 2.0)
    out = client.end_episode(e2, np.ones(4, np.float32))
    assert out["episode_return"] == pytest.approx(2.0)


@pytest.mark.parametrize("transport", ["in_process", "ray_tpu_rpc"])
def test_policy_server_mechanics_and_unknown_episode(transport):
    hooks = None if transport == "in_process" else _hooks()
    server = PolicyServer(4, 2, seed=1, learning_starts=64, train_every=8, device="cpu",
                          hooks=hooks)
    client = PolicyClient(server.address, timeout=30.0, hooks=hooks)
    try:
        _unknown_episode_errors(server, client)
        returns = _drive(client, make_env("CartPole-v1"), 6)
        stats = client.get_stats()
        assert stats["episodes"] == 8 and len(returns) == 6
        assert stats["transitions"] == sum(returns) + 2
        assert stats["updates"] == stats["transitions"] // 8 - 64 // 8 + 1
        assert server.device.type == "cpu"
    finally:
        client.close()
        server.stop()


def test_policy_server_takes_no_action_from_half_updated_weights():
    """Four client threads drive episodes while the server trains every 2
    transitions. Each optimizer step is widened (a sleep inside it) and
    marked; no greedy forward may start or end inside one, and none may
    see the network change under it."""
    server = PolicyServer(4, 2, seed=2, learning_starts=32, train_every=2, epsilon_start=0.5,
                          epsilon_end=0.5, device="cpu")
    state = {"updating": False, "version": 0, "forwards": 0, "overlaps": 0}
    step = server.learner.opt.step

    def marked_step(grads):
        state["updating"] = True
        time.sleep(0.002)
        step(grads)
        state["version"] += 1
        state["updating"] = False

    greedy = server._greedy

    def checked_greedy(obs):
        before = (state["updating"], state["version"])
        action = greedy(obs)
        if before[0] or state["updating"] or state["version"] != before[1]:
            state["overlaps"] += 1
        state["forwards"] += 1
        return action

    server.learner.opt.step = marked_step
    server._greedy = checked_greedy
    client = PolicyClient(server.address, hooks=None)
    errors = []

    def run(seed0):
        try:
            _drive(client, make_env("CartPole-v1"), 4, seed0)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=run, args=(100 * i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    try:
        assert not any(t.is_alive() for t in threads) and not errors, errors
        assert server.updates > 20 and state["forwards"] > 50, (server.updates, state)
        assert state["overlaps"] == 0, state
    finally:
        server.stop()


def test_apex_under_ray_tpu_actors(ray_start_regular):
    """2 rollout actors push TD-prioritised fragments straight into a
    replay-shard actor; the learner pulls from it."""
    algo = ApexDQNConfig(num_rollout_workers=2, num_envs_per_worker=2, num_replay_shards=1,
                         rollout_fragment_length=32, updates_per_iteration=8,
                         train_batch_size=32, seed=0, hooks=_hooks(), **CPU).build()
    try:
        assert all(isinstance(a, ActorHandle) for a in (*algo.workers, *algo.shards))
        r1 = algo.train()
        r2 = algo.train()
    finally:
        algo.stop()
    assert r2["num_updates"] == 16 and r2["worker_failures"] == 0
    assert r2["replay_shard_sizes"][0] > 0 and np.isfinite(r2["mean_loss"])
    assert r2["env_steps_total"] >= r1["env_steps_total"] > 0


def test_policy_server_over_ray_tpu_rpc_learns_online():
    """The server behind ray_tpu's RpcServer, a client through RpcClient:
    20 episodes, transitions recorded and updates taken over the wire."""
    hooks = _hooks()
    server = PolicyServer(4, 2, seed=0, learning_starts=100, train_every=4, device="cpu",
                          hooks=hooks)
    client = PolicyClient(server.address, timeout=30.0, hooks=hooks)
    try:
        returns = _drive(client, make_env("CartPole-v1"), 20)
        stats = client.get_stats()
    finally:
        client.close()
        server.stop()
    assert stats["episodes"] == 20 and stats["transitions"] == sum(returns)
    assert stats["updates"] > 0
