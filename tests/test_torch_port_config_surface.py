"""The reference's configuration surface and entry in the port, against
ray_tpu on the CPU: ``GPTConfig``'s ``scan_layers``, ``attn_use_pallas`` and
``attn_block_q/k``, ``dot_product_attention``'s ``use_pallas`` and tiles,
and ``ray_tpu_torch.entry`` against ``__graft_entry__.py``.

Weights come from the JAX init and are carried across with
``convert.params_from_jax``; tokens come from a numpy seed. Every comparison
runs in float32. Tolerances: logits atol 2e-5, rtol 1e-4 and the loss atol
1e-5, rtol 1e-5 (the model tests' limits: both sides compute the full
softmax, in other summation orders); gradients atol 1e-5, rtol 1e-4 (the
train tests' limits); the tiny flagship's logits through four layers at
t=256 atol 5e-5, rtol 1e-4.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu_torch import entry
from ray_tpu_torch.models import convert, gpt, inference, training
from ray_tpu_torch.ops import attention

LOGIT_TOL = dict(atol=2e-5, rtol=1e-4)
LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = dict(atol=1e-5, rtol=1e-4)
ENTRY_TOL = dict(atol=5e-5, rtol=1e-4)


def _tokens(b, t, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(np.int32)


def _jax_params(jcfg, seed=0):
    variables = jgpt.GPT(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, jgpt.unboxed_params(variables))


@functools.lru_cache(maxsize=None)
def _gpt_nano_tree(scan_layers):
    """The reference's gpt_nano parameters (seed 3) in the layout
    ``scan_layers`` names; read only."""
    return _jax_params(jgpt.gpt_nano(scan_layers=scan_layers), seed=3)


def _leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _dtype_name(dtype):
    return jnp.dtype(dtype).name if not isinstance(dtype, torch.dtype) else str(
        dtype).removeprefix("torch.")


def test_config_takes_every_reference_field_with_its_default():
    ref, port = jgpt.GPTConfig(), gpt.GPTConfig()
    port_fields = {f.name for f in dataclasses.fields(port)}
    for f in dataclasses.fields(ref):
        assert f.name in port_fields, f.name
        want, got = getattr(ref, f.name), getattr(port, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert _dtype_name(got) == _dtype_name(want), f.name
        else:
            assert got == want, f.name
    cfg = gpt.gpt_1b(dtype=torch.bfloat16, param_dtype=torch.bfloat16, attn_block_q=1024,
                     attn_block_k=1024, ce_chunk=512, scan_layers=False)
    assert (cfg.attn_block_q, cfg.attn_block_k, cfg.scan_layers) == (1024, 1024, False)


@functools.lru_cache(maxsize=None)
def _reference_train_loss():
    """(tokens, parameters, loss, gradients) of the reference's gpt_nano
    train-step loss with ``attn_use_pallas=False`` (its XLA route), numpy;
    read only. The remat policy changes what is recomputed, not the values,
    so one reference serves every policy."""
    jcfg = jgpt.gpt_nano(attn_use_pallas=False, ce_chunk=32)
    tree = _jax_params(jcfg, seed=2)
    tokens = _tokens(2, 48, jcfg.vocab_size, seed=10)
    model = jgpt.GPT(jcfg, return_hidden=True)

    def loss_fn(params):
        hidden, kernel, bias = model.apply({"params": params}, jnp.asarray(tokens))
        return jgpt.blockwise_next_token_loss(hidden, kernel, bias, jnp.asarray(tokens),
                                              chunk=jcfg.ce_chunk)

    loss, grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, tree))
    return tokens, tree, float(loss), _leaves(jax.tree_util.tree_map(np.asarray, grads))


@pytest.mark.parametrize("policy", ["nothing", "attn"])
def test_use_pallas_false_matches_the_references_loss_and_gradients(policy, monkeypatch):
    """``attn_use_pallas=False`` on both sides (the reference's XLA route,
    the port's ``_attention_plain``): the train step's loss and every
    parameter's gradient, under remat "nothing" and "attn". The port's
    route counts in the plain forward counter, forward and recomputation
    (two a layer), and under "attn" keeps its P V: that product runs once a
    layer, not again in the recomputation, and the loss is "nothing"'s bit
    for bit."""
    tokens, tree, ref_loss, ref_grads = _reference_train_loss()
    tokens = torch.from_numpy(tokens).long()
    cfg = gpt.gpt_nano(attn_use_pallas=False, remat_policy=policy, ce_chunk=32)
    sd = convert.params_from_jax(tree, cfg, device="cpu")
    products = []
    einsum = torch.einsum
    monkeypatch.setattr(torch, "einsum", lambda eq, *ops: (
        products.append(eq) if eq == "bhqk,bhkd->bhqd" else None) or einsum(eq, *ops))
    before = attention.flash_fwd_plain_launches
    params = {k: v.clone().requires_grad_() for k, v in sd.items()}
    loss, _ = training._loss_fn(cfg, gpt.GPT(cfg, device="meta"))(params, tokens)
    grads = torch.autograd.grad(loss, list(params.values()))
    assert attention.flash_fwd_plain_launches - before == 2 * cfg.num_layers
    assert len(products) == cfg.num_layers * (1 if policy == "attn" else 2)
    if policy == "attn":
        nothing = dataclasses.replace(cfg, remat_policy="nothing")
        with torch.no_grad():
            nothing_loss, _ = training._loss_fn(nothing, gpt.GPT(nothing, device="meta"))(
                sd, tokens)
        assert torch.equal(loss.detach(), nothing_loss)
    np.testing.assert_allclose(float(loss.detach()), ref_loss, **LOSS_TOL)
    got = _leaves(convert.params_to_jax(dict(zip(sd, grads)), cfg))
    for name, want in ref_grads.items():
        np.testing.assert_allclose(got[name], want, err_msg=name, **GRAD_TOL)


def test_per_layer_reference_tree_loads_and_gives_its_logits():
    """A tree built with ``scan_layers=False`` (``blocks/layer_{i}``) loads
    into the port's model under the same config and gives the reference's
    logits; the flash route and ``use_pallas=False`` both."""
    jcfg = jgpt.gpt_nano(scan_layers=False, remat=False)
    tree = _gpt_nano_tree(False)
    assert set(tree["blocks"]) == {f"layer_{i}" for i in range(jcfg.num_layers)}
    tokens = _tokens(2, 80, jcfg.vocab_size, seed=4)
    ref = np.asarray(jgpt.GPT(jcfg).apply({"params": tree}, jnp.asarray(tokens)))
    for use_pallas in (None, False):
        cfg = gpt.gpt_nano(scan_layers=False, attn_use_pallas=use_pallas)
        sd = convert.params_from_jax(tree, cfg, device="cpu")
        fwd = inference.make_forward(cfg, device="cpu")
        np.testing.assert_allclose(fwd(sd, torch.from_numpy(tokens)).numpy(), ref,
                                   err_msg=f"use_pallas={use_pallas}", **LOGIT_TOL)


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "per-layer"])
def test_params_to_jax_follows_scan_layers(scan_layers):
    """``params_to_jax`` writes the tree the reference builds for the config:
    the same leaves, shapes and values."""
    tree = _gpt_nano_tree(scan_layers)
    cfg = gpt.gpt_nano(scan_layers=scan_layers)
    back = _leaves(convert.params_to_jax(convert.params_from_jax(tree, cfg, device="cpu"), cfg))
    want = _leaves(tree)
    assert sorted(back) == sorted(want)
    for name, arr in want.items():
        np.testing.assert_array_equal(back[name], arr, err_msg=name)


def test_pp_train_step_requires_scan_layers():
    cfg = gpt.gpt_nano(scan_layers=False)
    with pytest.raises(ValueError, match="requires cfg.scan_layers=True"):
        training.make_pp_train_step(cfg, training.default_optimizer(1e-3), None)


def test_entry_on_cpu_matches_the_reference_entry():
    """``entry(device="cpu")`` against ``__graft_entry__.entry()`` on the
    CPU: the tiny flagship on both, the same sizes (b=1, t=256), and with
    the reference's parameters carried over the same logits."""
    import __graft_entry__

    ref_fn, (ref_params, ref_tokens) = __graft_entry__.entry()
    fn, (params, tokens) = entry.entry(device="cpu")
    jcfg, cfg = __graft_entry__._flagship_config(tiny=True), entry.flagship_config(tiny=True)
    for f in dataclasses.fields(jcfg):
        want, got = getattr(jcfg, f.name), getattr(cfg, f.name)
        if f.name in ("dtype", "param_dtype"):
            assert _dtype_name(got) == _dtype_name(want), f.name
        else:
            assert got == want, f.name
    assert tuple(tokens.shape) == tuple(ref_tokens.shape) == (1, 256)
    assert not bool(tokens.any()) and sorted(params) == sorted(
        dict(gpt.GPT(cfg, device="meta").named_parameters()))
    tree = jax.tree_util.tree_map(np.asarray, ref_params)
    want = np.asarray(jax.jit(ref_fn)(ref_params, ref_tokens))
    got = fn(convert.params_from_jax(tree, cfg, device="cpu"), tokens)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape == (1, 256, 512)
    np.testing.assert_allclose(got.numpy(), want, **ENTRY_TOL)


def test_entry_defaults_to_cuda_and_dryrun_delegates(monkeypatch):
    """``None`` is CUDA (raising with no card present), and
    ``dryrun_multichip`` hands the ranks and the device type to
    ``parallel.dryrun``; the flagship on the card is gpt_1b in bf16."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.entry()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        entry.dryrun_multichip(2)
    calls = []
    monkeypatch.setattr(entry.dryrun, "report", lambda n, device: calls.append((n, device)))
    entry.dryrun_multichip(4, "cpu")
    assert calls == [(4, "cpu")]
    assert entry.flagship_config() == gpt.gpt_1b(dtype=torch.bfloat16,
                                                 param_dtype=torch.bfloat16)


DESIGN = attention.FwdDesign("wgmma", "flash_fwd_wgmma", "ray_tpu_flash_fwd_wgmma", 128, 128)


@pytest.mark.parametrize("causal,t_q,t_kv,tiles,raises", [
    (True, 160, 64, (1024, 1024), True),     # rows that see no key: tiles decide them
    (True, 160, 64, (128, 64), True),
    (True, 160, 64, (None, None), False),    # the design's own
    (True, 160, 64, (128, 128), False),
    (True, 64, 64, (1024, 1024), False),     # every row sees a key
    (True, 64, 256, (64, 64), False),        # q the suffix of a longer kv
    (False, 160, 64, (1024, 1024), False),   # no mask, no blind row
], ids=lambda x: str(x))
def test_tile_rule_raises_only_where_tiles_change_the_result(causal, t_q, t_kv, tiles, raises):
    assert attention.tiles_change_result(causal, t_q, t_kv) == (causal and t_q > t_kv)
    kw = dict(causal=causal, t_q=t_q, t_kv=t_kv)
    if raises:
        with pytest.raises(ValueError, match="tiles"):
            attention._check_tiles(DESIGN, 128, *tiles, **kw)
    else:
        attention._check_tiles(DESIGN, 128, *tiles, **kw)


def test_use_pallas_false_counts_in_the_plain_counter():
    """``use_pallas=False`` computes ``_attention_plain`` (gradients through
    autograd) and counts one plain forward launch a call, by head_dim too,
    on any device; ``None`` and ``True`` on the CPU take the flash route's
    plain version and count nothing."""
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 40, 32).astype(np.float32)).requires_grad_()
               for _ in range(3))

    def counts():
        return (attention.flash_fwd_launches, attention.flash_fwd_plain_launches,
                attention.launches_by_head_dim["flash_fwd_plain_d32"],
                attention.flash_bwd_dq_launches, attention.flash_bwd_dkv_launches)

    before = counts()
    out = attention.dot_product_attention(q, k, v, causal=True, use_pallas=False)
    out.sum().backward()
    assert [a - b for a, b in zip(counts(), before)] == [1, 1, 1, 0, 0]
    assert torch.equal(out, attention._attention_plain(q, k, v, causal=True))
    assert q.grad is not None and bool(torch.isfinite(q.grad).all())
    before = counts()
    for use_pallas in (None, True):
        flash = attention.dot_product_attention(q, k, v, causal=True, use_pallas=use_pallas)
        assert torch.equal(flash, attention.flash_attention_fwd_plain(
            q, k, v, causal=True, scale=32 ** -0.5)[0])
    assert counts() == before


def test_tiles_from_the_environment(monkeypatch):
    """``RAYTPU_FLASH_BLOCK_Q``/``_K`` set the call's tiles, as the
    reference's tuning hook: on the CPU the plain version computes at them
    (here with rows that see no key, where they decide the result)."""
    rng = np.random.RandomState(1)
    q = torch.from_numpy(rng.randn(1, 2, 96, 64).astype(np.float32))
    k, v = (torch.from_numpy(rng.randn(1, 2, 40, 64).astype(np.float32)) for _ in range(2))
    scale = 64 ** -0.5
    monkeypatch.setenv("RAYTPU_FLASH_BLOCK_Q", "32")
    monkeypatch.setenv("RAYTPU_FLASH_BLOCK_K", "16")
    out = attention.dot_product_attention(q, k, v, causal=True, block_q=512, block_k=512)
    want = attention.flash_attention_fwd_plain(q, k, v, causal=True, scale=scale,
                                               block_q=32, block_k=16)[0]
    assert torch.equal(out, want)
    default = attention.flash_attention_fwd_plain(q, k, v, causal=True, scale=scale)[0]
    assert not torch.equal(out, default)
