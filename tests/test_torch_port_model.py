"""ray_tpu_torch.models against ray_tpu.models on the CPU: the weight
converter both ways, GPT logits, and the KV-cache extend step.

Weights come from the JAX init and are carried across with
``params_from_jax``; token and cache inputs come from a numpy seed. Every
comparison runs in float32. Tolerance: atol 2e-5, rtol 1e-4 (the two sides
sum matrix products and softmaxes in other orders; the port's full forward
runs the tiled flash algorithm where the JAX CPU path takes the full
softmax).
"""

import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch import resolve_device
from ray_tpu_torch.models import convert, gpt, inference

TOL = dict(atol=2e-5, rtol=1e-4)
REPO = Path(__file__).resolve().parents[1]

# tiny shapes that keep each structural switch of the flagship
VARIANTS = {
    "hd16-parallel": dict(num_heads=4, head_dim=16, rotary_dim=16),
    "hd16-partial-rotary-serial": dict(num_heads=4, head_dim=16, rotary_dim=8,
                                       parallel_residual=False),
    "hd64-tied": dict(num_heads=2, head_dim=64, rotary_dim=32,
                      tie_embeddings=True),
    "hd64-serial-tied": dict(num_heads=2, head_dim=64, rotary_dim=16,
                             parallel_residual=False, tie_embeddings=True),
}
BASE = dict(vocab_size=128, num_layers=2, embed_dim=64, mlp_dim=128,
            max_seq_len=128)


def _configs(name, scan_layers=True):
    kw = {**BASE, **VARIANTS[name]}
    jcfg = jgpt.GPTConfig(**kw, dtype=jnp.float32, remat=False,
                          scan_layers=scan_layers)
    pcfg = gpt.GPTConfig(**kw, dtype=torch.float32)
    return jcfg, pcfg


def _jax_params(jcfg, seed=0):
    variables = jgpt.GPT(jcfg).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, jgpt.unboxed_params(variables))


def _tokens(b, t, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(np.int32)


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


# ---------------------------------------------------------------------------
# converter
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "per-layer"])
@pytest.mark.parametrize("name", ["hd16-parallel", "hd64-serial-tied"])
def test_converter_round_trip(name, scan_layers):
    jcfg, pcfg = _configs(name, scan_layers)
    tree = _jax_params(jcfg)
    sd = convert.params_from_jax(tree, pcfg, device="cpu")
    back = _flat(convert.params_to_jax(sd, pcfg, stacked=scan_layers))
    ref = _flat(tree)
    assert sorted(back) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(back[key], ref[key], err_msg=key)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_state_dict_matches_module_and_num_params(name):
    jcfg, pcfg = _configs(name)
    sd = convert.params_from_jax(_jax_params(jcfg), pcfg, device="cpu")
    model = gpt.GPT(pcfg, device="meta")
    shapes = {k: tuple(p.shape) for k, p in model.named_parameters()}
    assert shapes == {k: tuple(v.shape) for k, v in sd.items()}
    assert sum(v.numel() for v in sd.values()) == pcfg.num_params() == jcfg.num_params()


def test_converter_carries_bf16_leaves():
    import ml_dtypes

    jcfg, pcfg = _configs("hd16-parallel")
    tree = jax.tree_util.tree_map(lambda a: a.astype(ml_dtypes.bfloat16),
                                  _jax_params(jcfg))
    bcfg = gpt.GPTConfig(**{**BASE, **VARIANTS["hd16-parallel"]},
                         param_dtype=torch.bfloat16)
    sd = convert.params_from_jax(tree, bcfg, device="cpu")
    assert all(v.dtype == torch.bfloat16 for v in sd.values())
    np.testing.assert_array_equal(
        sd["wte.weight"].float().numpy(),
        tree["wte"]["embedding"].astype(np.float32))


# ---------------------------------------------------------------------------
# full forward
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "per-layer"])
@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_gpt_logits_match_jax(name, scan_layers):
    jcfg, pcfg = _configs(name, scan_layers)
    tree = _jax_params(jcfg, seed=1)
    tokens = _tokens(2, 80, jcfg.vocab_size)  # 80: a ragged second tile
    ref = np.asarray(jgpt.GPT(jcfg).apply({"params": tree}, jnp.asarray(tokens)))
    sd = convert.params_from_jax(tree, pcfg, device="cpu")
    out = inference.make_forward(pcfg, device="cpu")(sd, torch.from_numpy(tokens))
    assert out.dtype == torch.float32 and out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref, **TOL)


def test_gpt_module_with_loaded_state_dict_matches_forward():
    jcfg, pcfg = _configs("hd16-parallel")
    sd = convert.params_from_jax(_jax_params(jcfg), pcfg, device="cpu")
    model = gpt.GPT(pcfg, device="cpu")
    model.load_state_dict(sd)
    tokens = torch.from_numpy(_tokens(1, 33, pcfg.vocab_size, seed=2)).long()
    with torch.inference_mode():
        direct = model(tokens)
    assert torch.equal(direct, inference.make_forward(pcfg, "cpu")(sd, tokens))


def test_init_params_draws_from_a_generator():
    pcfg = gpt.GPTConfig(**{**BASE, **VARIANTS["hd16-parallel"]}, dtype=torch.float32)
    a = inference.init_params(pcfg, device="cpu", seed=7)
    b = inference.init_params(pcfg, device="cpu", seed=7)
    c = inference.init_params(pcfg, device="cpu", seed=8)
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert not torch.equal(a["wte.weight"], c["wte.weight"])
    assert torch.all(a["blocks.0.ln.weight"] == 1) and torch.all(a["ln_f.bias"] == 0)
    assert torch.all(a["blocks.1.mlp.wi.bias"] == 0)
    assert abs(float(a["lm_head.weight"].std()) - 0.02) < 1e-3


def test_moe_is_refused():
    """The KV-cache extend step refuses MoE, as the reference's does."""
    with pytest.raises(NotImplementedError, match="MoE"):
        gpt.make_extend_fn(gpt.gpt_nano(moe_num_experts=4))


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert resolve_device().type == "cuda"
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.make_forward(gpt.gpt_nano())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        gpt.GPT(gpt.gpt_nano())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        inference.init_params(gpt.gpt_nano())
    assert resolve_device("cpu").type == "cpu"
    assert resolve_device("meta").type == "meta"


def test_presets_match_jax():
    for name in ("gpt_nano", "gpt_125m", "gpt_1b", "gpt_j_6b"):
        j, p = getattr(jgpt, name)(), getattr(gpt, name)()
        for field in ("vocab_size", "num_layers", "num_heads", "head_dim",
                      "embed_dim", "mlp_dim", "max_seq_len", "rotary_dim",
                      "parallel_residual", "tie_embeddings"):
            assert getattr(j, field) == getattr(p, field), (name, field)
        assert j.num_params() == p.num_params()


# ---------------------------------------------------------------------------
# KV-cache extend
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_extend_matches_jax(name):
    """Ragged lengths; lane 2 writes past the capacity of 16 (positions 14..17),
    where the two writes out of capacity must drop."""
    jcfg, pcfg = _configs(name)
    tree = _jax_params(jcfg, seed=2)
    rng = np.random.RandomState(3)
    tc, cap = 4, 16
    tokens = _tokens(3, tc, jcfg.vocab_size, seed=4)
    lengths = np.array([3, 10, 14], np.int32)
    shape = (jcfg.num_layers, 3, cap, jcfg.num_heads, jcfg.head_dim)
    kc = rng.randn(*shape).astype(np.float32)
    vc = rng.randn(*shape).astype(np.float32)
    ref = jgpt.make_extend_fn(jcfg)(
        tree, jnp.asarray(tokens), jnp.asarray(lengths), jnp.asarray(kc),
        jnp.asarray(vc))
    sd = convert.params_from_jax(tree, pcfg, device="cpu")
    k_cache, v_cache = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out = gpt.make_extend_fn(pcfg)(
        sd, torch.from_numpy(tokens).long(), torch.from_numpy(lengths).long(),
        k_cache, v_cache)
    for got, want, what in zip(out, ref, ("logits", "hidden", "k_new", "v_new")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=what, **TOL)
    # the caches were written in place, and nothing past capacity landed
    np.testing.assert_allclose(k_cache[:, 2, 14:].numpy(),
                               out[2][:, 2, :2].numpy(), **TOL)
    np.testing.assert_array_equal(k_cache[:, 2, :14].numpy(), kc[:, 2, :14])


def test_extend_prefill_matches_full_forward():
    _, pcfg = _configs("hd16-parallel")
    sd = inference.init_params(pcfg, device="cpu", seed=5)
    tokens = torch.from_numpy(_tokens(2, 24, pcfg.vocab_size, seed=6)).long()
    k_cache, v_cache = gpt.init_kv_cache(pcfg, 2, 32, device="cpu")
    logits, *_ = gpt.make_extend_fn(pcfg)(
        sd, tokens, torch.zeros(2, dtype=torch.long), k_cache, v_cache)
    full = inference.make_forward(pcfg, "cpu")(sd, tokens)
    np.testing.assert_allclose(logits.numpy(), full.numpy(), **TOL)


def test_port_imports_no_jax_and_no_ray_tpu():
    code = (
        "import sys, ray_tpu_torch, ray_tpu_torch.serve.llm, "
        "ray_tpu_torch.models.convert, ray_tpu_torch.models.training, "
        "ray_tpu_torch.models.moe, ray_tpu_torch.ops.attention, ray_tpu_torch.ops.tf32, "
        "ray_tpu_torch.ops.persistent_bwd, ray_tpu_torch.ops.dcluster, "
        "ray_tpu_torch.ops.flash_bwd_variants, "
        "ray_tpu_torch.ops.flash_bwd_f32_variants, ray_tpu_torch.ops.flash_fwd_f32_variants, "
        "ray_tpu_torch.ops.ring, ray_tpu_torch.parallel, ray_tpu_torch.parallel.mesh, "
        "ray_tpu_torch.parallel.sharding, ray_tpu_torch.parallel.comm, "
        "ray_tpu_torch.parallel.launch, ray_tpu_torch.parallel.dryrun, "
        "ray_tpu_torch.parallel.pipeline, ray_tpu_torch._private.device_plane, "
        "ray_tpu_torch.util.collective, ray_tpu_torch.train.session, "
        "ray_tpu_torch.train.loop, ray_tpu_torch.data, ray_tpu_torch.runtime, "
        "ray_tpu_torch.rl, ray_tpu_torch.rl.a2c, ray_tpu_torch.rl.algorithm, "
        "ray_tpu_torch.rl.appo, ray_tpu_torch.rl.catalog, ray_tpu_torch.rl.connectors, "
        "ray_tpu_torch.rl.convert, ray_tpu_torch.rl.env, ray_tpu_torch.rl.impala, "
        "ray_tpu_torch.rl.learner, ray_tpu_torch.rl.multi_agent, ray_tpu_torch.rl.pg, "
        "ray_tpu_torch.rl.rl_module, ray_tpu_torch.rl.rollout_worker, "
        "ray_tpu_torch.rl.sample_batch, ray_tpu_torch.rl.prng, "
        "ray_tpu_torch.rl.replay_buffers, ray_tpu_torch.rl.dqn, ray_tpu_torch.rl.apex, "
        "ray_tpu_torch.rl.offline, ray_tpu_torch.rl.bc, ray_tpu_torch.rl.sac, "
        "ray_tpu_torch.rl.cql, ray_tpu_torch.rl.td3, ray_tpu_torch.rl.es, "
        "ray_tpu_torch.rl.policy_server, ray_tpu_torch.entry\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'flax', 'optax', "
        "'ray_tpu') or m.startswith(('jax.', 'flax.', 'optax.', 'ray_tpu.')))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
