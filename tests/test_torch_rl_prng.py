"""The reference's random streams in numpy (ray_tpu_torch.rl.prng), the
reference's initial weights (``flax_init``) and the replay buffers, held
to JAX, flax and the reference on the CPU.

- ``bits``, ``split``, ``fold_in`` and ``uniform`` (with and without a
  range) are bit for bit ``jax.random``'s;
- ``normal`` and ``truncated_normal`` are within 2 float32 ulps of
  ``jax.random``'s (the measured worst over these draws is 0 ulps: the
  port follows XLA's CPU log1p and erf_inv with their fused multiply-adds);
- every network the reference initialises from a key starts, at seeds
  0-2, from the reference's ``init(PRNGKey(seed), ...)`` weights, drawn
  by the port itself (``convert`` only lays the port's tensors out as
  flax's tree for the comparison): bit for bit, except the LSTM's
  orthogonal hidden kernels, within 1e-6 (LAPACK's float32 QR);
- the replay buffers draw the reference's rows and weights at a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import catalog as ref_catalog
from ray_tpu.rl import dqn as ref_dqn
from ray_tpu.rl import replay_buffers as ref_replay
from ray_tpu.rl import rl_module as ref_rl_module
from ray_tpu.rl import sac as ref_sac
from ray_tpu.rl import td3 as ref_td3
from ray_tpu.rl.sample_batch import SampleBatch as RefBatch
from ray_tpu_torch.rl import catalog, convert, dqn, prng, replay_buffers, rl_module, sac, td3
from ray_tpu_torch.rl.sample_batch import SampleBatch

SEEDS = (0, 1, 2, 7, 12345, 2**32 - 1)
SHAPES = ((), (5,), (3, 7), (64, 64), (2, 3, 4))
MAX_ULPS = 2
OBS = 4


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64))
               .max(initial=0))


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bits_and_uniform_are_jax_bit_for_bit(seed):
    key, port = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
    np.testing.assert_array_equal(np.asarray(key), port)
    for n in (2, 3, 4, 7):
        np.testing.assert_array_equal(np.asarray(jax.random.split(key, n)), prng.split(port, n))
    for data in (0, 1, 123, 2**31 - 1, 2**32 - 1):
        np.testing.assert_array_equal(np.asarray(jax.random.fold_in(key, data)),
                                      prng.fold_in(port, data))
    for shape in SHAPES:
        np.testing.assert_array_equal(np.asarray(jax.random.bits(key, shape)),
                                      prng.bits(port, shape))
        np.testing.assert_array_equal(np.asarray(jax.random.uniform(key, shape)),
                                      prng.uniform(port, shape))
        for lo, hi in ((-2.0, 2.0), (-0.125, 0.125), (-0.9544997, 0.9544997), (0.3, 1.7)):
            got = prng.uniform(port, shape, lo, hi)
            assert got.dtype == np.float32
            np.testing.assert_array_equal(
                np.asarray(jax.random.uniform(key, shape, minval=lo, maxval=hi)), got)


def test_normal_and_truncated_normal_within_two_ulps():
    worst = {"normal": 0, "truncated_normal": 0}
    for seed in range(20):
        key, port = jax.random.PRNGKey(seed), prng.PRNGKey(seed)
        for shape in ((4096,), (64, 64), (3,)):
            worst["normal"] = max(worst["normal"], _ulps(jax.random.normal(key, shape),
                                                         prng.normal(port, shape)))
            worst["truncated_normal"] = max(worst["truncated_normal"], _ulps(
                jax.random.truncated_normal(key, -2.0, 2.0, shape),
                prng.truncated_normal(port, -2.0, 2.0, shape)))
    assert max(worst.values()) <= MAX_ULPS, worst
    assert worst == {"normal": 0, "truncated_normal": 0}, worst  # measured here


def _assert_tree_equal(want, got, atol_paths=()):
    assert jax.tree_util.tree_structure(want) == jax.tree_util.tree_structure(got)
    for path, a in jax.tree_util.tree_leaves_with_path(want):
        b = got
        for k in path:
            b = b[k.key]
        name = jax.tree_util.keystr(path)
        a = np.asarray(a)
        assert a.dtype == b.dtype == np.float32, name
        if any(p in name for p in atol_paths):
            np.testing.assert_allclose(b, a, rtol=0, atol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(b, a, err_msg=name)


def _obs0(n=OBS):
    return jnp.zeros((1, n), jnp.float32)


QNET_KNOBS = {
    "plain": {},
    "dueling": {"dueling": True},
    "noisy": {"noisy": True},
    "c51": {"num_atoms": 51},
    "rainbow": {"dueling": True, "noisy": True, "num_atoms": 51},
}


def _networks():
    """(name, reference init(seed) -> params, port network for seed)."""
    cpu = torch.device("cpu")
    out = [("discrete_policy",
            lambda s: ref_rl_module.DiscretePolicyModule(2, (64, 64)).init(
                jax.random.PRNGKey(s), _obs0())["params"],
            lambda s: rl_module.make_policy(OBS, 2, (64, 64), s, cpu))]
    for name, knobs in QNET_KNOBS.items():
        out.append((f"qnetwork_{name}",
                    lambda s, k=knobs: ref_dqn.QNetwork(2, (64, 64), **k).init(
                        jax.random.PRNGKey(s), _obs0())["params"],
                    lambda s, k=knobs: dqn.make_q_network(OBS, 2, (64, 64), s, cpu, **k)))
    out += [
        ("gaussian_policy",
         lambda s: ref_sac.GaussianPolicy(1, (128, 128)).init(jax.random.PRNGKey(s),
                                                              _obs0(3))["params"],
         lambda s: rl_module.drawn(sac.GaussianPolicy(3, 1), s, cpu)),
        ("twin_q",
         lambda s: ref_sac.TwinQ((128, 128)).init(jax.random.PRNGKey(s), _obs0(3),
                                                  _obs0(1))["params"],
         lambda s: rl_module.drawn(sac.TwinQ(3, 1), s, cpu)),
        ("deterministic_policy",
         lambda s: ref_td3.DeterministicPolicy(1, (128, 128)).init(
             jax.random.PRNGKey(s), _obs0(3))["params"],
         lambda s: rl_module.drawn(td3.DeterministicPolicy(3, 1), s, cpu)),
    ]
    return out


NETWORKS = _networks()


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("name,ref_init,port_net", NETWORKS, ids=[n[0] for n in NETWORKS])
def test_network_starts_from_the_reference_init(name, ref_init, port_net, seed):
    want = jax.device_get(ref_init(seed))
    got = convert.state_dict_to_params(port_net(seed).state_dict())
    _assert_tree_equal(want, got)


CATALOG = {"mlp": {}, "lstm": {"use_lstm": True}, "attention": {"use_attention": True}}


@pytest.mark.parametrize("seed", (0, 1, 2))
@pytest.mark.parametrize("kind", sorted(CATALOG))
def test_catalog_policy_starts_from_the_reference_init(kind, seed):
    cfg = CATALOG[kind]
    model = ref_catalog.get_model(2, ref_catalog.ModelConfig(**cfg))
    sample = jnp.zeros((2, 5, OBS) if kind == "attention" else (2, OBS))
    args = ((sample, ref_catalog.LSTMEncoder((64, 64), 64).initial_carry(2))
            if kind == "lstm" else (sample,))
    want = jax.device_get(model.init(jax.random.PRNGKey(seed), *args)["params"])
    port = catalog.get_model(2, cfg, observation_size=OBS, seed=seed, device="cpu")
    got = convert.state_dict_to_params(port.state_dict(), num_heads=2)
    # the LSTM's hidden kernels come out of a float32 QR
    _assert_tree_equal(want, got, atol_paths=(".lstm']['h",))


def test_noisy_dense_noise_follows_the_reference_keys():
    """The noisy Q-network's forward under a key equals the reference's
    (its noise from fold_in(key, crc32(head)) and split), and under no key
    is the mean weights' forward."""
    obs = np.random.default_rng(0).normal(size=(16, OBS)).astype(np.float32)
    net = ref_dqn.QNetwork(3, (16,), dueling=True, noisy=True)
    params = net.init(jax.random.PRNGKey(0), jnp.zeros((2, OBS)))["params"]
    port = dqn.make_q_network(OBS, 3, (16,), 0, torch.device("cpu"), dueling=True, noisy=True)
    for key in (None, jax.random.PRNGKey(1), jax.random.PRNGKey(2)):
        want = net.apply({"params": params}, jnp.asarray(obs), key)
        got = port(torch.from_numpy(obs), None if key is None else np.asarray(key))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)
    with torch.no_grad():
        a = port(torch.from_numpy(obs), prng.PRNGKey(1))
        b = port(torch.from_numpy(obs), prng.PRNGKey(2))
    assert not torch.allclose(a, b)


def _fill(buf, batches):
    for b in batches:
        buf.add(b)


@pytest.mark.parametrize("kind", ["uniform", "prioritized"])
def test_replay_buffers_draw_the_reference_rows_and_weights(kind):
    rng = np.random.default_rng(3)
    cols = [dict(obs=rng.normal(size=(n, OBS)).astype(np.float32),
                 actions=rng.integers(0, 2, n).astype(np.int32),
                 rewards=rng.normal(size=n).astype(np.float32)) for n in (40, 70, 30)]
    if kind == "uniform":
        ref, port = ref_replay.ReplayBuffer(100, seed=5), replay_buffers.ReplayBuffer(100, seed=5)
    else:
        ref = ref_replay.PrioritizedReplayBuffer(100, alpha=0.6, seed=5)
        port = replay_buffers.PrioritizedReplayBuffer(100, alpha=0.6, seed=5)
    _fill(ref, [RefBatch(c) for c in cols])
    _fill(port, [SampleBatch(c) for c in cols])
    for step in range(4):
        kw = {"beta": 0.4} if kind == "prioritized" else {}
        want, got = ref.sample(32, **kw), port.sample(32, **kw)
        assert set(want) == set(got)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        if kind == "prioritized":
            td = rng.normal(size=32)
            ref.update_priorities(want["batch_indexes"], td)
            port.update_priorities(got["batch_indexes"], td)
    assert len(port) == len(ref) == 100
