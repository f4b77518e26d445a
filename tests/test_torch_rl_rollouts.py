"""The port's rollout workers (ray_tpu_torch.rl.rollout_worker,
.multi_agent) held to the reference's on the CPU.

The reference's worker classes run in this process (``._cls``, as
tests/test_rl_breadth.py does), at the same seed as the port's and with
the port's weights converted (``rl.convert``). The port's copies of the
envs and connectors step the same episodes: observations, rewards and
dones equal bit for bit, actions equal, logp, values, advantages and
returns within ``ATOL``. Where an episode is cut at its time limit the
reward holds gamma * V(final), a value of the forward, so there the
rewards agree within ``ATOL``.
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu.rl import connectors as ref_connectors
from ray_tpu.rl import env as ref_env
from ray_tpu.rl import multi_agent as ref_multi_agent
from ray_tpu.rl import rollout_worker as ref_rollout_worker
from ray_tpu_torch.rl import connectors, env, multi_agent, rollout_worker
from ray_tpu_torch.rl.convert import state_dict_to_params
from ray_tpu_torch.rl.rl_module import RLModule

ATOL = 1e-5
EXACT = ("obs", "dones", "actions")


def _weights(seed: int = 3):
    """A policy's weights as the port's state dict and the reference's tree."""
    state = RLModule(4, 2, seed=seed, device="cpu").get_params()
    return state, state_dict_to_params(state)


def _workers(ref_env_name, port_env_name, **kw):
    state, tree = _weights()
    ref = ref_rollout_worker.RolloutWorker._cls(ref_env_name, num_envs=4, seed=5,
                                                gamma=0.98, lam=0.9, **kw.pop("ref", {}))
    port = rollout_worker.RolloutWorker(port_env_name, num_envs=4, seed=5, gamma=0.98,
                                        lam=0.9, device="cpu", **kw.pop("port", {}))
    ref.set_weights(tree)
    port.set_weights(state)
    return ref, port


def _compare(want, got, rewards_exact=True):
    assert set(want) == set(got)
    for k in want:
        a, b = np.asarray(want[k]), np.asarray(got[k])
        assert a.shape == b.shape and a.dtype == b.dtype, k
        if k in EXACT or (k == "rewards" and rewards_exact):
            np.testing.assert_array_equal(b, a, err_msg=k)
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=ATOL, err_msg=k)


@pytest.mark.parametrize("method", ["sample", "sample_trajectory"])
def test_rollout_worker_matches_reference(method):
    """Three fragments of 64 steps from one worker each, episode returns
    equal."""
    ref, port = _workers("CartPole-v1", "CartPole-v1")
    for _ in range(3):
        _compare(getattr(ref, method)(64), getattr(port, method)(64))
    assert ref.episode_returns() == port.episode_returns()


@pytest.mark.parametrize("method", ["sample", "sample_trajectory"])
def test_time_limit_bootstrap_matches_reference(method):
    """CartPole cut at 12 steps, so episodes end by truncation: the reward
    of a truncated step carries gamma * V(final state)."""
    ref, port = _workers(functools.partial(ref_env.CartPole, max_steps=12),
                         functools.partial(env.CartPole, max_steps=12))
    want, got = getattr(ref, method)(40), getattr(port, method)(40)
    assert (np.asarray(got["rewards"]) > 1.0).any()
    _compare(want, got, rewards_exact=False)
    assert ref.episode_returns() == port.episode_returns()


def test_rollout_worker_with_connectors_matches_reference():
    """A MeanStdFilter between the envs and the policy: the same filtered
    observations reach both policies (and the batch), and the filter
    states agree after the fragments."""
    ref, port = _workers(
        "CartPole-v1", "CartPole-v1",
        ref={"obs_connectors": ref_connectors.ConnectorPipeline([ref_connectors.MeanStdFilter()])},
        port={"obs_connectors": connectors.ConnectorPipeline([connectors.MeanStdFilter()])})
    for _ in range(2):
        _compare(ref.sample(32), port.sample(32))
    want, got = ref.connector_state()["obs"]["0"], port.connector_state()["obs"]["0"]
    assert want["count"] == got["count"] > 0
    np.testing.assert_array_equal(got["mean"], want["mean"])
    np.testing.assert_array_equal(got["m2"], want["m2"])


def test_multi_agent_rollout_worker_matches_reference():
    specs = {pid: {"observation_size": 4, "num_actions": 2}
             for pid in ("policy_agent_0", "policy_agent_1")}
    mapping = {"agent_0": "policy_agent_0", "agent_1": "policy_agent_1"}
    ref = ref_multi_agent.MultiAgentRolloutWorker._cls(
        "IndependentCartPoles", policy_specs=specs, policy_mapping=mapping, seed=2)
    port = multi_agent.MultiAgentRolloutWorker(
        "IndependentCartPoles", policy_specs=specs, policy_mapping=mapping, seed=2,
        device="cpu")
    weights = {pid: _weights(seed=i)[0] for i, pid in enumerate(specs)}
    ref.set_weights({pid: state_dict_to_params(w) for pid, w in weights.items()})
    port.set_weights(weights)
    for _ in range(2):
        want, got = ref.sample(100), port.sample(100)
        assert set(want) == set(got) == set(specs)
        for pid in want:
            _compare(want[pid], got[pid])
    assert ref.episode_returns() == port.episode_returns()


def test_multi_agent_env_contract_holds_on_the_copy():
    ref = ref_multi_agent.IndependentCartPoles(max_steps=10, seed=0)
    port = multi_agent.IndependentCartPoles(max_steps=10, seed=0)
    a, _ = ref.reset(seed=0)
    b, _ = port.reset(seed=0)
    assert set(b) == {"agent_0", "agent_1"}
    for _ in range(10):
        a, ra, ta, _, _ = ref.step({k: 1 for k in a})
        b, rb, tb, _, _ = port.step({k: 1 for k in b})
        assert ra == rb and ta == tb
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
        if tb["__all__"]:
            break


def test_worker_weights_land_on_its_device():
    _, port = _workers("CartPole-v1", "CartPole-v1")
    state, _ = _weights(seed=9)
    port.set_weights(state)
    got = port.module.get_params()
    assert all(torch.equal(got[k], v) for k, v in state.items())
    assert all(p.device.type == "cpu" for p in port.module.net.parameters())


def test_worker_defaults_to_cuda_and_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rollout_worker.RolloutWorker("CartPole-v1", num_envs=2)
