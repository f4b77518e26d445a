"""The port's RL networks (ray_tpu_torch.rl.rl_module, .catalog, .convert)
held to the reference's flax modules on the CPU.

The reference's parameters go across through ``rl.convert``; the same
numpy inputs go through both. ``DiscretePolicyModule`` and
``CatalogPolicy`` (MLP under each activation, the LSTM over 3 steps
threading its carry, attention over a 5-step window) agree within
``ATOL``; the conversion's round trip is exact; the port's own
initialisation has flax's statistics (kernel std within 10% of
1/sqrt(fan_in), truncated at two standard deviations; biases zero); and
``RLModule.forward_inference`` draws the reference's actions from the same
numpy generator.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.rl import catalog as ref_catalog
from ray_tpu.rl import rl_module as ref_rl_module
from ray_tpu_torch.rl import catalog, convert, rl_module

ATOL = 1e-5
OBS = 4
ACTIVATIONS = ("tanh", "relu", "gelu", "silu")
KINDS = {
    "mlp": {},
    "lstm": {"use_lstm": True},
    "attention": {"use_attention": True},
}


def _obs(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def _ref_policy(num_actions, cfg, sample, carry=None):
    model = ref_catalog.get_model(num_actions, ref_catalog.ModelConfig(**cfg))
    args = (jnp.asarray(sample),) if carry is None else (jnp.asarray(sample), carry)
    return model, jax.device_get(model.init(jax.random.PRNGKey(3), *args)["params"])


def _port_policy(num_actions, cfg, params):
    policy = catalog.get_model(num_actions, cfg, observation_size=OBS, device="cpu")
    policy.load_state_dict(convert.params_to_state_dict(params))
    return policy


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.detach().numpy(), rtol=0, atol=ATOL)


def test_discrete_policy_module_matches_flax():
    obs = _obs((32, OBS), 0)
    net = ref_rl_module.DiscretePolicyModule(2, (64, 64))
    params = jax.device_get(net.init(jax.random.PRNGKey(1), jnp.asarray(obs))["params"])
    port = rl_module.DiscretePolicyModule(OBS, 2, (64, 64))
    port.load_state_dict(convert.params_to_state_dict(params))
    want = net.apply({"params": params}, jnp.asarray(obs))
    got = port(torch.from_numpy(obs))
    for a, b in zip(want, got):
        _close(a, b)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_catalog_mlp_matches_flax(activation):
    obs = _obs((16, OBS), 1)
    cfg = {"fcnet_activation": activation}
    model, params = _ref_policy(3, cfg, obs)
    port = _port_policy(3, cfg, params)
    for a, b in zip(model.apply({"params": params}, jnp.asarray(obs)), port(torch.from_numpy(obs))):
        _close(a, b)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_catalog_lstm_threads_its_carry_as_flax(activation):
    """Three steps, each step's carry fed to the next: logits, values and
    both halves of the carry (flax's (c, h)) agree at every step."""
    cfg = {"use_lstm": True, "fcnet_activation": activation}
    steps = [_obs((8, OBS), 10 + t) for t in range(3)]
    carry = ref_catalog.LSTMEncoder((64, 64), 64).initial_carry(8)
    model, params = _ref_policy(2, cfg, steps[0], carry)
    port = _port_policy(2, cfg, params)
    port_carry = port.encoder.initial_carry(8)
    for x in steps:
        logits, value, carry = model.apply({"params": params}, jnp.asarray(x), carry)
        p_logits, p_value, port_carry = port(torch.from_numpy(x), port_carry)
        for a, b in zip((logits, value, *carry), (p_logits, p_value, *port_carry)):
            _close(a, b)
    assert not np.allclose(np.asarray(carry[0]), 0)


@pytest.mark.parametrize("activation", ACTIVATIONS)
def test_catalog_attention_over_a_window_matches_flax(activation):
    cfg = {"use_attention": True, "fcnet_activation": activation}
    window = _obs((6, 5, OBS), 2)
    model, params = _ref_policy(2, cfg, window)
    port = _port_policy(2, cfg, params)
    want = model.apply({"params": params}, jnp.asarray(window))
    got = port(torch.from_numpy(window))
    assert got[0].shape == (6, 2) and got[1].shape == (6,)
    for a, b in zip(want, got):
        _close(a, b)


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_conversion_round_trip_is_exact(kind):
    cfg = KINDS[kind]
    sample = _obs((2, 5, OBS) if kind == "attention" else (2, OBS), 3)
    carry = ref_catalog.LSTMEncoder((64, 64), 64).initial_carry(2) if kind == "lstm" else None
    _, params = _ref_policy(2, cfg, sample, carry)
    state = convert.params_to_state_dict(params)
    port = catalog.get_model(2, cfg, observation_size=OBS, device="cpu")
    assert set(state) == set(port.state_dict())
    assert all(state[k].shape == v.shape for k, v in port.state_dict().items())
    back = convert.state_dict_to_params(state, num_heads=2)
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(params)
    for a, b in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and np.array_equal(a, b)


def test_discrete_policy_round_trip_is_exact():
    port = rl_module.DiscretePolicyModule(OBS, 2, (64, 64))
    rl_module.flax_init_(port, 0)
    back = convert.params_to_state_dict(convert.state_dict_to_params(port.state_dict()))
    assert all(torch.equal(back[k], v) for k, v in port.state_dict().items())


def _kernels(module):
    return [(name, p) for name, p in module.named_parameters()
            if name.endswith("weight") and p.ndim == 2 and ".hh." not in name]


@pytest.mark.parametrize("kind", ["discrete", *sorted(KINDS)])
def test_init_is_flax_lecun_normal_with_zero_biases(kind):
    """Each kernel of at least 1024 elements has std within 10% of
    1/sqrt(fan_in), and all kernels together scaled by sqrt(fan_in) within
    10% of 1; none beyond the truncation at 2 / 0.8796 standard
    deviations; every bias zero; the LSTM's hidden kernels orthogonal, gate
    by gate; a LayerNorm's scale one."""
    if kind == "discrete":
        module = rl_module.RLModule(OBS, 2, (256, 256), seed=5, device="cpu").net
    else:
        cfg = dict(KINDS[kind], fcnet_hiddens=(256, 256))
        module = catalog.get_model(2, cfg, observation_size=OBS, seed=5, device="cpu")
    scaled = []
    for name, w in _kernels(module):
        s = w.detach() * w.shape[1] ** 0.5
        if w.numel() >= 1024:
            assert abs(float(s.std()) - 1.0) < 0.1, (name, float(s.std()))
        assert float(s.abs().max()) <= 2.0 / rl_module.TRUNC_STD + 1e-5, name
        scaled.append(s.reshape(-1))
    assert abs(float(torch.cat(scaled).std()) - 1.0) < 0.1
    for name, p in module.named_parameters():
        if name.endswith("bias"):
            assert not p.detach().any(), name
    if kind == "lstm":
        hh = module.encoder.lstm.hh.weight.detach()
        for q in hh.chunk(4):
            torch.testing.assert_close(q @ q.T, torch.eye(len(q)), atol=1e-5, rtol=0)
    if kind == "attention":
        assert torch.equal(module.encoder.ln.weight.detach(), torch.ones(64))
        assert module.encoder.ln.eps == 1e-6


def test_init_is_the_same_for_a_seed_and_differs_across_seeds():
    a = rl_module.RLModule(OBS, 2, seed=0, device="cpu").get_params()
    b = rl_module.RLModule(OBS, 2, seed=0, device="cpu").get_params()
    c = rl_module.RLModule(OBS, 2, seed=1, device="cpu").get_params()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["torso_0.weight"], c["torso_0.weight"])


def test_forward_inference_draws_the_reference_actions():
    """The same weights and the same numpy generator: equal actions, logp
    and values within ATOL, over several calls of one generator."""
    ref = ref_rl_module.RLModule(OBS, 2, seed=0)
    port = rl_module.RLModule(OBS, 2, seed=7, device="cpu")
    port.set_params(convert.params_to_state_dict(jax.device_get(ref.params)))
    ref_rng, port_rng = np.random.default_rng(11), np.random.default_rng(11)
    for t in range(5):
        obs = _obs((64, OBS), 20 + t)
        a, logp, v = ref.forward_inference(obs, ref_rng)
        b, p_logp, p_v = port.forward_inference(obs, port_rng)
        np.testing.assert_array_equal(a, b)
        assert b.dtype == np.int32 and p_logp.dtype == np.float32 and p_v.dtype == np.float32
        np.testing.assert_allclose(logp, p_logp, rtol=0, atol=ATOL)
        np.testing.assert_allclose(v, p_v, rtol=0, atol=ATOL)


def test_get_model_takes_a_dict_or_the_dataclass():
    as_dict = catalog.get_model(2, {"fcnet_hiddens": (16,), "fcnet_activation": "gelu"},
                                observation_size=OBS, device="cpu")
    as_cfg = catalog.get_model(2, catalog.ModelConfig(fcnet_hiddens=(16,),
                                                      fcnet_activation="gelu"),
                               observation_size=OBS, device="cpu")
    assert all(torch.equal(as_dict.state_dict()[k], v) for k, v in as_cfg.state_dict().items())
    logits, value = as_dict(torch.ones(3, OBS))
    assert logits.shape == (3, 2) and value.shape == (3,)


def test_modules_default_to_cuda_and_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        rl_module.RLModule(OBS, 2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        catalog.get_model(2, observation_size=OBS)
