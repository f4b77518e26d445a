"""The port's RL algorithms under ray_tpu's actors, on the CPU.

``scripts/port_rl_smoke.py``'s ``rl_hooks()`` gives the port ray_tpu's
``remote``/``get``/``wait``/``kill`` and its host collective; its
``timed_rl_hooks()``, used here, fails a ``get`` or ``wait`` without a
timeout.
PPO runs 2 iterations with 2 rollout-worker actors; IMPALA a call of 4
updates over pipelined actor fragments; a ``LearnerGroup`` of 2 learner
actors holds identical weights after two updates (the reference's
tests/test_rl.py:109). The default hooks, which run actors in the
caller's process, are checked without a runtime.
"""

import numpy as np
import torch

import ray_tpu
from ray_tpu.api import ActorHandle
from ray_tpu_torch.rl import ImpalaConfig, LearnerGroup, PPOConfig, SampleBatch
from ray_tpu_torch.runtime import LocalRef, RuntimeHooks

from scripts.port_rl_smoke import timed_rl_hooks as _hooks

CPU = dict(device="cpu", rollout_device="cpu")


def _finite(result, keys=("total_loss", "policy_loss", "vf_loss", "entropy")):
    return all(np.isfinite(result[k]) for k in keys)


class _Counter:
    def __init__(self, start):
        self.n = start

    def add(self, k):
        self.n += k
        return self.n


def test_default_hooks_run_actors_in_this_process():
    hooks = RuntimeHooks()
    counter = hooks.remote(_Counter).remote(10)
    refs = [counter.add.remote(1), counter.add.remote(2)]
    assert all(isinstance(r, LocalRef) for r in refs)
    assert hooks.get(refs, timeout=1) == [11, 13]
    assert hooks.get(refs[0]) == 11
    ready, rest = hooks.wait(refs, num_returns=1, timeout=1)
    assert ready == refs[:1] and rest == refs[1:]
    hooks.kill(counter)
    assert hooks.init_collective_group is None and hooks.allreduce is None


def test_ppo_with_rollout_actors(ray_start_regular):
    algo = PPOConfig(num_rollout_workers=2, rollout_fragment_length=32, seed=0,
                     hooks=_hooks(), **CPU).build()
    try:
        assert all(isinstance(w, ActorHandle) for w in algo.workers)
        results = [algo.train() for _ in range(2)]
    finally:
        algo.stop()
    assert [r["training_iteration"] for r in results] == [1, 2]
    assert all(r["env_steps_this_iter"] == 256 and _finite(r) for r in results)


def test_impala_pipelines_actor_fragments(ray_start_regular):
    algo = ImpalaConfig(num_rollout_workers=2, rollout_fragment_length=16, seed=0,
                        hooks=_hooks(), **CPU).build()
    try:
        result = algo.train(num_updates=4)
    finally:
        algo.stop()
    assert result["num_updates"] == 4 and result["env_steps_total"] == 4 * 16 * 4
    assert _finite(result)


def test_learner_group_of_two_actors_stays_in_sync(ray_start_regular):
    rng = np.random.default_rng(0)
    n = 256
    batch = SampleBatch(
        obs=rng.normal(size=(n, 4)).astype(np.float32),
        actions=rng.integers(0, 2, size=n).astype(np.int32),
        logp=np.full(n, -0.69, np.float32),
        advantages=rng.normal(size=n).astype(np.float32),
        returns=rng.normal(size=n).astype(np.float32),
        rewards=np.zeros(n, np.float32),
        dones=np.zeros(n, np.bool_),
        values=np.zeros(n, np.float32),
    )
    group = LearnerGroup({"observation_size": 4, "num_actions": 2, "lr": 1e-2, "seed": 0,
                          "device": "cpu"}, num_learners=2, group_name="port_test_lg",
                         hooks=_hooks())
    try:
        before = group.get_weights()
        group.update(batch, minibatch_size=64, num_epochs=1, seed=0)
        m2 = group.update(batch, minibatch_size=64, num_epochs=1, seed=1)
        assert _finite(m2)
        w0, w1 = (ray_tpu.get(a.get_weights.remote(), timeout=60) for a in group.actors)
    finally:
        group.shutdown()
    for k in w0:
        assert torch.equal(w0[k], w1[k]), k
    assert not torch.equal(w0["torso_0.weight"], before["torso_0.weight"])
