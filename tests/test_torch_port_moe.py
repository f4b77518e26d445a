"""ray_tpu_torch's mixture-of-experts against ray_tpu's on the CPU: the
layer (output, aux loss and gradients; the cases of ``tests/test_moe.py``),
the GPT with MoE blocks (converter, logits, train step).

Inputs come from numpy seeds; the GPT's weights from the JAX init, carried
across with ``params_from_jax``. Everything runs in float32. Tolerances:
- the layer: atol 1e-5, rtol 1e-5 on the output, aux and every gradient
  (the same products and sums in another order; the port gathers rows where
  the reference multiplies by one-hot matrices, which adds exact zeros);
- replicated experts against the dense MLP: atol 1e-4, as in
  ``tests/test_moe.py``;
- the GPT's logits: atol 2e-5, rtol 1e-4 (as ``test_torch_port_model.py``);
- a 3-step MoE gpt_nano train step: loss and grad norm within rtol 1e-4
  (as the dense step in ``test_torch_port_training.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import moe as jmoe
from ray_tpu.models import training as jtr
from ray_tpu_torch.models import convert, gpt, inference, moe, training

LAYER_TOL = dict(atol=1e-5, rtol=1e-5)
LOGITS_TOL = dict(atol=2e-5, rtol=1e-4)
STEP_RTOL = 1e-4

# the layer configuration of tests/test_moe.py
LAYER = dict(vocab_size=256, num_layers=2, num_heads=4, head_dim=16, embed_dim=32,
             mlp_dim=64, max_seq_len=64, rotary_dim=8, moe_num_experts=4,
             moe_top_k=2)


def _layer_cfgs(cf):
    return (jgpt.GPTConfig(**LAYER, dtype=jnp.float32, moe_capacity_factor=cf),
            gpt.GPTConfig(**LAYER, dtype=torch.float32, moe_capacity_factor=cf))


def _layer_params(rng, d, f, n_exp, replicated=False):
    if replicated:
        wi1 = rng.normal(size=(d, f)).astype(np.float32) * 0.2
        wo1 = rng.normal(size=(f, d)).astype(np.float32) * 0.2
        return {"router": rng.normal(size=(d, n_exp)).astype(np.float32) * 0.1,
                "wi": np.broadcast_to(wi1, (n_exp, d, f)).copy(),
                "wo": np.broadcast_to(wo1, (n_exp, f, d)).copy()}
    return {"router": rng.normal(size=(d, n_exp)).astype(np.float32) * 0.5,
            "wi": rng.normal(size=(n_exp, d, f)).astype(np.float32) * 0.2,
            "wo": rng.normal(size=(n_exp, f, d)).astype(np.float32) * 0.2}


def _jax_layer(jcfg, params, x, r, aux_w):
    """(y, aux, grads of sum(y * r) + aux_w * aux w.r.t. params and x)"""
    layer = jmoe.MoeMlp(jcfg)

    def run(p, xx):
        y, mut = layer.apply({"params": p}, xx, mutable=["losses"])
        return y, jax.tree.leaves(mut["losses"])[0]

    def loss(p, xx):
        y, aux = run(p, xx)
        return (y * r).sum() + aux_w * aux

    jp = jax.tree.map(jnp.asarray, params)
    y, aux = run(jp, jnp.asarray(x))
    gp, gx = jax.grad(loss, argnums=(0, 1))(jp, jnp.asarray(x))
    return np.asarray(y), float(aux), {**{k: np.asarray(v) for k, v in gp.items()},
                                       "x": np.asarray(gx)}


def _port_layer(pcfg, params, x, r, aux_w):
    layer = moe.MoeMlp(pcfg, device="cpu")
    tp = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in params.items()}
    tx = torch.from_numpy(x.copy()).requires_grad_()
    y, aux, dropped = torch.func.functional_call(layer, tp, (tx,))
    loss = (y * torch.from_numpy(r)).sum() + aux_w * aux
    grads = torch.autograd.grad(loss, [*tp.values(), tx])
    return (y.detach().numpy(), float(aux.detach()), float(dropped),
            dict(zip([*tp, "x"], (g.numpy() for g in grads))))


@pytest.mark.parametrize("case", ["ample", "replicated", "capacity_0.25"])
def test_moe_layer_matches_jax(case):
    """Output, aux and the gradients of every parameter and of the input.
    Ample capacity drops nothing; replicated experts also equal the dense
    MLP; at capacity 0.25 the same assignments are dropped on both sides:
    every token's output agrees, so does the set of tokens that lost both
    choices (their output is exactly 0)."""
    cf = {"ample": 2.0, "replicated": 8.0, "capacity_0.25": 0.25}[case]
    jcfg, pcfg = _layer_cfgs(cf)
    rng = np.random.default_rng(0)
    d, f, n_exp = pcfg.embed_dim, pcfg.mlp_dim, pcfg.moe_num_experts
    params = _layer_params(rng, d, f, n_exp, replicated=case == "replicated")
    x = rng.normal(size=(2, 32, d)).astype(np.float32)
    r = rng.normal(size=x.shape).astype(np.float32)
    y_ref, aux_ref, g_ref = _jax_layer(jcfg, params, x, r, 0.5)
    y, aux, dropped, g = _port_layer(pcfg, params, x, r, 0.5)
    np.testing.assert_allclose(y, y_ref, **LAYER_TOL)
    np.testing.assert_allclose(aux, aux_ref, **LAYER_TOL)
    for name in g_ref:
        np.testing.assert_allclose(g[name], g_ref[name], err_msg=name, **LAYER_TOL)
    zero_rows = (y == 0).all(-1)
    np.testing.assert_array_equal(zero_rows, (y_ref == 0).all(-1))
    if case == "capacity_0.25":
        # 2 * 64 assignments over 4 experts of 8 slots: 96 dropped
        assert dropped == pytest.approx(0.75)
        assert zero_rows.any() and not zero_rows.all()
    else:
        assert dropped == 0.0 and not zero_rows.any()
    if case == "replicated":
        wi1, wo1 = params["wi"][0], params["wo"][0]
        dense = np.asarray(jax.nn.gelu(x @ wi1) @ wo1)
        np.testing.assert_allclose(y, dense, atol=1e-4)


def test_assign_slots_is_slot_major():
    """Every first choice is placed before any second choice: token 1's
    first choice takes expert 0's last slot before token 0's second."""
    gate_idx = torch.tensor([[1, 0], [0, 1], [0, 1]])
    slot, keep = moe.assign_slots(gate_idx, num_experts=2, capacity=2)
    # slot-major: (t0, e1), (t1, e0), (t2, e0), then (t0, e0), (t1, e1), (t2, e1)
    assert keep.tolist() == [True, True, True, False, True, False]
    assert slot.tolist() == [2, 0, 1, 4, 3, 4]


def test_gather_rows_matches_indexing():
    """Value and gradient against plain indexing of the zero-padded rows,
    whose backward accumulates into repeated indices; the sentinel reads
    zeros and takes no gradient."""
    rng = np.random.RandomState(4)
    src = torch.from_numpy(rng.randn(5, 3).astype(np.float32)).requires_grad_()
    index = torch.tensor([2, 5, 0, 2, 4, 5])      # 5 = len(src): a zero row
    inverse = torch.tensor([[2, 6, 0, 6, 4],      # the rows of out that read
                            [6, 6, 3, 6, 6]])     # each src row; 6 = none
    r = torch.from_numpy(rng.randn(6, 3).astype(np.float32))
    out = moe.gather_rows(src, index, inverse)
    (grad,) = torch.autograd.grad((out * r).sum(), src)
    src2 = src.detach().clone().requires_grad_()
    ref = torch.cat([src2, torch.zeros(1, 3)])[index]
    (ref_grad,) = torch.autograd.grad((ref * r).sum(), src2)
    assert torch.equal(out, ref)
    torch.testing.assert_close(grad, ref_grad)
    assert torch.all(out[1] == 0) and torch.all(grad[1] == 0) and torch.all(grad[3] == 0)


# ---------------------------------------------------------------------------
# the GPT with MoE blocks
# ---------------------------------------------------------------------------

MOE_VARIANTS = {
    "parallel": dict(parallel_residual=True),
    "serial-tied": dict(parallel_residual=False, tie_embeddings=True),
}
GPT_BASE = dict(vocab_size=128, num_layers=2, num_heads=4, head_dim=16, embed_dim=64,
                mlp_dim=128, max_seq_len=128, rotary_dim=16, moe_num_experts=4)


def _gpt_cfgs(name, scan_layers=True):
    kw = {**GPT_BASE, **MOE_VARIANTS[name]}
    return (jgpt.GPTConfig(**kw, dtype=jnp.float32, remat=False, scan_layers=scan_layers),
            gpt.GPTConfig(**kw, dtype=torch.float32))


def _jax_params(jcfg, seed=0):
    variables = jgpt.GPT(jcfg).init(jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, jgpt.unboxed_params(variables))


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


def _tokens(b, t, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(np.int32)


@pytest.mark.parametrize("scan_layers", [True, False], ids=["stacked", "per-layer"])
@pytest.mark.parametrize("name", sorted(MOE_VARIANTS))
def test_moe_converter_round_trip(name, scan_layers):
    jcfg, pcfg = _gpt_cfgs(name, scan_layers)
    tree = _jax_params(jcfg)
    sd = convert.params_from_jax(tree, pcfg, device="cpu")
    assert sd["blocks.1.mlp.wi"].shape == (4, 64, 128)
    back = _flat(convert.params_to_jax(sd, pcfg, stacked=scan_layers))
    ref = _flat(tree)
    assert sorted(back) == sorted(ref)
    for key in ref:
        np.testing.assert_array_equal(back[key], ref[key], err_msg=key)
    model = gpt.GPT(pcfg, device="meta")
    assert {k: tuple(p.shape) for k, p in model.named_parameters()} == \
        {k: tuple(v.shape) for k, v in sd.items()}
    assert sum(v.numel() for v in sd.values()) == pcfg.num_params() == jcfg.num_params()


@pytest.mark.parametrize("name", sorted(MOE_VARIANTS))
def test_moe_gpt_logits_match_jax(name):
    jcfg, pcfg = _gpt_cfgs(name)
    tree = _jax_params(jcfg, seed=1)
    tokens = _tokens(2, 80, jcfg.vocab_size)
    ref = np.asarray(jgpt.GPT(jcfg).apply({"params": tree}, jnp.asarray(tokens)))
    sd = convert.params_from_jax(tree, pcfg, device="cpu")
    out = inference.make_forward(pcfg, device="cpu")(sd, torch.from_numpy(tokens))
    np.testing.assert_allclose(out.numpy(), ref, **LOGITS_TOL)


def test_moe_gpt_nano_train_step_tracks_jax():
    """Three steps of a MoE gpt_nano (4 experts, top 2, capacity 1.25, aux
    weight 0.01) from the same weights on one repeated batch: loss (the
    blockwise loss plus the weighted aux) and grad norm against JAX's
    make_train_step (no mesh)."""
    jcfg = jgpt.gpt_nano(moe_num_experts=4)
    tree = _jax_params(jcfg)
    tokens = _tokens(2, 64, 256, seed=8)
    tx = jtr.default_optimizer(1e-2)
    jstate = jtr.TrainState(step=jnp.zeros((), jnp.int32),
                            params=jax.tree_util.tree_map(jnp.asarray, tree),
                            opt_state=tx.init(tree))
    jstep = jtr.make_train_step(jcfg, tx, donate=False)
    cfg = gpt.gpt_nano(moe_num_experts=4)
    opt = training.default_optimizer(1e-2)
    state = training.init_train_state(convert.params_from_jax(tree, cfg, device="cpu"), opt)
    step = training.make_train_step(cfg, opt, device="cpu")
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        state, m = step(state, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=STEP_RTOL)
        assert 0.5 < float(m["moe_aux"]) < cfg.moe_num_experts
        assert 0.0 <= float(m["moe_dropped"]) < 1.0
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    # the eval step leaves the aux term out, as the reference's
    ev = training.make_eval_step(cfg, device="cpu")(state.params, torch.from_numpy(tokens))
    ref = jtr.make_eval_step(jcfg)(jstate.params, jnp.asarray(tokens))
    np.testing.assert_allclose(float(ev), float(ref), rtol=STEP_RTOL)
