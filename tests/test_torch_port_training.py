"""ray_tpu_torch's training parts against ray_tpu's on the CPU: the losses,
the optimizer, remat and the train and eval steps.

Inputs come from numpy seeds; weights from the JAX init, carried across
with ``params_from_jax``. Everything runs in float32. Tolerances:
- losses and their gradients: atol 1e-5, rtol 1e-5 (other summation
  orders);
- optimizer against optax: atol 1e-6, rtol 1e-5 over 4 steps in float32
  (the same arithmetic in another order of operations); in bfloat16
  (parameters, gradients and both moments, as optax keeps the moments in
  the parameters' dtype) each parameter within two bf16 ulps (rtol 2^-6)
  and the global norm within one (rtol 2^-8): optax rounds every bf16
  operation (its norm and bias corrections included), the port's foreach
  ops compute in float32 and round once each;
- a gpt_j-shaped model (head_dim 256) trained 3 steps: loss and grad norm
  within rtol 1e-4, as gpt_nano's;
- gpt_nano train step, 5 steps at lr 1e-2: loss and grad norm within
  rtol 1e-4 (the port's attention is the tiled flash algorithm, the JAX CPU
  path the full softmax; the optimizer feeds each step's rounding into the
  next);
- gradients under each remat policy: atol 1e-5, rtol 1e-4 against JAX under
  the same policy (a whole model's backward, summed in other orders), and
  atol 1e-7, rtol 1e-6 against the port's "nothing" (the same arithmetic,
  apart from what a policy keeps instead of recomputing).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import training as jtr
from ray_tpu_torch.models import convert, gpt, inference, training
from ray_tpu_torch.ops import attention

LOSS_TOL = dict(atol=1e-5, rtol=1e-5)
OPT_TOL = {"float32": dict(atol=1e-6, rtol=1e-5), "bfloat16": dict(atol=0.0, rtol=2 ** -6)}
OPT_NORM_RTOL = {"float32": 1e-6, "bfloat16": 2 ** -8}
STEP_RTOL = 1e-4


def _nano_params(seed=0):
    variables = jgpt.GPT(jgpt.gpt_nano()).init(
        jax.random.PRNGKey(seed), jnp.zeros((1, 8), jnp.int32))
    return jax.tree_util.tree_map(np.asarray, jgpt.unboxed_params(variables))


def _tokens(b, t, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(np.int32)


# ---------------------------------------------------------------------------
# losses
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("tied", [False, True], ids=["bias", "tied"])
@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_blockwise_loss_matches_jax(masked, tied):
    """Value and gradients (hidden, head weight, head bias); t - 1 = 36 is
    not a multiple of the chunk of 8."""
    rng = np.random.RandomState(1)
    b, t, d, vocab, chunk = 2, 37, 16, 64, 8
    hidden = rng.randn(b, t, d).astype(np.float32)
    kernel = (0.3 * rng.randn(d, vocab)).astype(np.float32)
    bias = None if tied else (0.1 * rng.randn(vocab)).astype(np.float32)
    tokens = _tokens(b, t, vocab, seed=2)
    mask = (rng.rand(b, t) > 0.3).astype(np.float32) if masked else None

    def jloss(h, w, bb):
        return jgpt.blockwise_next_token_loss(
            h, w, bb, jnp.asarray(tokens),
            None if mask is None else jnp.asarray(mask), chunk=chunk)

    jargs = (jnp.asarray(hidden), jnp.asarray(kernel),
             None if bias is None else jnp.asarray(bias))
    argnums = (0, 1) if tied else (0, 1, 2)
    ref, ref_grads = jax.value_and_grad(jloss, argnums=argnums)(*jargs)

    h = torch.from_numpy(hidden).requires_grad_()
    w = torch.from_numpy(kernel.T.copy()).requires_grad_()
    bt = None if bias is None else torch.from_numpy(bias).requires_grad_()
    loss = gpt.blockwise_next_token_loss(
        h, w, bt, torch.from_numpy(tokens),
        None if mask is None else torch.from_numpy(mask), chunk=chunk)
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(ref), **LOSS_TOL)
    np.testing.assert_allclose(h.grad.numpy(), np.asarray(ref_grads[0]), **LOSS_TOL)
    np.testing.assert_allclose(w.grad.numpy().T, np.asarray(ref_grads[1]), **LOSS_TOL)
    if not tied:
        np.testing.assert_allclose(bt.grad.numpy(), np.asarray(ref_grads[2]),
                                   **LOSS_TOL)
    # without grad the chunks are not checkpointed; same value
    with torch.no_grad():
        again = gpt.blockwise_next_token_loss(
            h, w, bt, torch.from_numpy(tokens),
            None if mask is None else torch.from_numpy(mask), chunk=chunk)
    assert torch.equal(again, loss.detach())


@pytest.mark.parametrize("masked", [False, True], ids=["all", "masked"])
def test_next_token_loss_matches_jax(masked):
    rng = np.random.RandomState(3)
    logits = (2 * rng.randn(2, 19, 50)).astype(np.float32)
    tokens = _tokens(2, 19, 50, seed=4)
    mask = (rng.rand(2, 19) > 0.4).astype(np.float32) if masked else None
    ref = jgpt.next_token_loss(jnp.asarray(logits), jnp.asarray(tokens),
                               None if mask is None else jnp.asarray(mask))
    got = gpt.next_token_loss(torch.from_numpy(logits), torch.from_numpy(tokens),
                              None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(float(got), float(ref), **LOSS_TOL)


def test_blockwise_loss_equals_full_loss_of_the_logits():
    sd = inference.init_params(gpt.gpt_nano(), device="cpu", seed=3)
    model = gpt.GPT(gpt.gpt_nano(), device="cpu")
    model.load_state_dict(sd)
    tokens = torch.from_numpy(_tokens(2, 50, 256, seed=5)).long()
    with torch.no_grad():
        hidden, w, bias = model(tokens, return_hidden=True)
        full = gpt.next_token_loss(model(tokens), tokens)
    assert hidden.shape == (2, 50, 64) and w.shape == (256, 64)
    torch.testing.assert_close(
        gpt.blockwise_next_token_loss(hidden, w, bias, tokens, chunk=16), full,
        atol=1e-5, rtol=1e-5)


def test_train_step_flops_matches_jax():
    for name in ("gpt_nano", "gpt_125m", "gpt_1b", "gpt_j_6b"):
        assert gpt.train_step_flops(getattr(gpt, name)(), 12, 2048) == \
            jgpt.train_step_flops(getattr(jgpt, name)(), 12, 2048)
    tied = dict(tie_embeddings=True)
    assert gpt.train_step_flops(gpt.gpt_1b(**tied), 4, 512) == \
        jgpt.train_step_flops(jgpt.gpt_1b(**tied), 4, 512)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("weight_decay", [0.0, 0.1])
def test_optimizer_matches_optax(weight_decay, dtype):
    """Four steps on the same numpy gradients; global norms of 3.0, 0.5,
    2.0 and 0.25, so the clip acts on steps 1 and 3 only. Parameters,
    gradients and moments in ``dtype`` on both sides; the moments stay
    in it."""
    rng = np.random.RandomState(5)
    shapes = {"a": (4, 6), "b": (6,), "c": (3, 2, 5)}
    params = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
    grads = []
    for norm in (3.0, 0.5, 2.0, 0.25):
        g = {k: rng.randn(*s).astype(np.float32) for k, s in shapes.items()}
        total = np.sqrt(sum(float((x.astype(np.float64) ** 2).sum()) for x in g.values()))
        grads.append({k: (x * (norm / total)).astype(np.float32) for k, x in g.items()})

    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    tx = jtr.default_optimizer(1e-2, weight_decay=weight_decay)
    jparams = {k: jnp.asarray(v, jdt) for k, v in params.items()}
    jstate = tx.init(jparams)
    opt = training.default_optimizer(1e-2, weight_decay=weight_decay)
    tparams = {k: torch.from_numpy(v.copy()).to(tdt) for k, v in params.items()}
    tstate = opt.init(tparams)
    for g in grads:
        jg = {k: jnp.asarray(v, jdt) for k, v in g.items()}
        updates, jstate = tx.update(jg, jstate, jparams)
        jparams = optax.apply_updates(jparams, updates)
        tstate, norm = opt.update(
            tparams, [torch.from_numpy(g[k].copy()).to(tdt) for k in tparams], tstate)
        np.testing.assert_allclose(float(norm), float(optax.global_norm(jg)),
                                   rtol=OPT_NORM_RTOL[dtype])
        for k in params:
            assert tparams[k].dtype == tdt and jparams[k].dtype == jdt
            np.testing.assert_allclose(tparams[k].float().numpy(),
                                       np.asarray(jparams[k], np.float32),
                                       err_msg=k, **OPT_TOL[dtype])
    adam = jstate[1][0]  # the chain's adamw: (ScaleByAdamState, ...)
    assert {m.dtype for m in tstate.mu + tstate.nu} == {tdt}
    assert {m.dtype for m in jax.tree_util.tree_leaves((adam.mu, adam.nu))} == {jnp.dtype(jdt)}
    assert tstate.count == 4


# ---------------------------------------------------------------------------
# remat and the steps
# ---------------------------------------------------------------------------


def _grads(cfg, sd, tokens):
    """The train step's loss and its gradients, for a fresh copy of ``sd``."""
    params = {k: v.clone().requires_grad_() for k, v in sd.items()}
    loss, _ = training._loss_fn(cfg, gpt.GPT(cfg, device="meta"))(params, tokens)
    return loss, torch.autograd.grad(loss, list(params.values()))


def test_remat_on_and_off_give_the_same_gradients(monkeypatch):
    """Under remat the attention forward runs twice per layer (forward and
    recomputation) with the policies "nothing" and "dots", once per layer
    under "attn", which keeps its output, and once per layer without remat;
    the gradients agree."""
    calls = []
    plain = attention.flash_attention_fwd_plain
    monkeypatch.setattr(attention, "flash_attention_fwd_plain",
                        lambda *a, **kw: calls.append(1) or plain(*a, **kw))
    cfg_off = gpt.gpt_nano(ce_chunk=32, remat=False)
    sd = inference.init_params(cfg_off, device="cpu", seed=6)
    tokens = torch.from_numpy(_tokens(2, 70, 256, seed=7)).long()
    loss_off, g_off = _grads(cfg_off, sd, tokens)
    assert len(calls) == cfg_off.num_layers
    for policy, per_layer in (("nothing", 2), ("dots", 2), ("attn", 1)):
        cfg_on = gpt.gpt_nano(ce_chunk=32, remat_policy=policy)
        calls.clear()
        loss_on, g_on = _grads(cfg_on, sd, tokens)
        assert len(calls) == per_layer * cfg_on.num_layers, policy
        assert torch.equal(loss_on, loss_off)
        for name, a, b in zip(sd, g_on, g_off):
            torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6, msg=f"{policy} {name}")
        with torch.no_grad():  # no grad, no recomputation
            calls.clear()
            gpt.GPT(cfg_on, device="cpu")(tokens)
            assert len(calls) == cfg_on.num_layers


def test_remat_policies_not_ported_raise():
    """A policy the reference does not have raises, with remat on; the
    reference's three build, and with remat off the policy is not read."""
    with pytest.raises(ValueError, match="remat_policy"):
        gpt.GPT(gpt.gpt_nano(remat_policy="everything"), device="meta")
    for policy in ("nothing", "dots", "attn"):
        gpt.GPT(gpt.gpt_nano(remat_policy=policy), device="meta")
    gpt.GPT(gpt.gpt_nano(remat=False, remat_policy="everything"), device="meta")


class _CountMatmuls(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.n += func == torch.ops.aten.mm.default
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("moe", [0, 4], ids=["dense", "moe"])
def test_dots_policy_keeps_the_matmul_outputs(moe):
    """The backward under "dots" runs exactly the 2-D products of the
    backward without remat: the outputs of q, k, v, o, wi and wo (with
    experts, the router's) are kept, and none is recomputed. Under
    "nothing" the recomputation runs five per layer again: q, k, v, o and
    wi, or the router with experts (it stops before wo, whose output no
    backward needs)."""
    tokens = torch.from_numpy(_tokens(2, 40, 256, seed=11)).long()
    counts = {}
    for policy in ("off", "nothing", "dots"):
        cfg = gpt.gpt_nano(ce_chunk=32, remat=policy != "off",
                           remat_policy="nothing" if policy == "off" else policy,
                           moe_num_experts=moe)
        params = {k: v.requires_grad_() for k, v in
                  inference.init_params(cfg, device="cpu", seed=6).items()}
        hidden, w, b = torch.func.functional_call(
            gpt.GPT(cfg, device="meta"), params, (tokens,), {"return_hidden": True})
        loss = gpt.blockwise_next_token_loss(hidden, w, b, tokens, chunk=32)
        with _CountMatmuls() as mode:
            torch.autograd.grad(loss, list(params.values()))
        counts[policy] = mode.n
    assert counts["dots"] == counts["off"], counts
    assert counts["nothing"] == counts["off"] + 5 * 2, counts


@pytest.mark.parametrize("moe", [0, 4], ids=["dense", "moe"])
@pytest.mark.parametrize("policy", ["dots", "attn"])
def test_remat_policy_gradients_match_jax(policy, moe):
    """Every parameter's gradient of the train step's loss (with the
    weighted aux loss for MoE) under one policy: against JAX's under the
    same policy, and against the port's under "nothing"."""
    jcfg = jgpt.gpt_nano(remat_policy=policy, ce_chunk=32, moe_num_experts=moe)
    variables = jgpt.GPT(jcfg).init(jax.random.PRNGKey(2), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, jgpt.unboxed_params(variables))
    tokens = _tokens(2, 48, 256, seed=10)
    model = jgpt.GPT(jcfg, return_hidden=True)

    def loss_fn(params):
        if moe:
            (hidden, kernel, bias), mut = model.apply(
                {"params": params}, jnp.asarray(tokens), mutable=["losses"])
            aux = sum(jnp.sum(v) for v in jax.tree.leaves(mut["losses"])) / jcfg.num_layers
        else:
            hidden, kernel, bias = model.apply({"params": params}, jnp.asarray(tokens))
            aux = 0.0
        loss = jgpt.blockwise_next_token_loss(hidden, kernel, bias, jnp.asarray(tokens),
                                              chunk=jcfg.ce_chunk)
        return loss + jcfg.moe_aux_weight * aux

    ref_loss, ref_grads = jax.value_and_grad(loss_fn)(jax.tree_util.tree_map(jnp.asarray, tree))
    cfg = gpt.gpt_nano(remat_policy=policy, ce_chunk=32, moe_num_experts=moe)
    sd = convert.params_from_jax(tree, cfg, device="cpu")
    loss, grads = _grads(cfg, sd, torch.from_numpy(tokens).long())
    np.testing.assert_allclose(float(loss.detach()), float(ref_loss), **LOSS_TOL)
    back = convert.params_to_jax(dict(zip(sd, grads)), cfg)
    ref = jax.tree_util.tree_map(np.asarray, ref_grads)
    for path, want in jax.tree_util.tree_leaves_with_path(ref):
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-4,
                                   err_msg=jax.tree_util.keystr(path))
    nothing_loss, nothing_grads = _grads(
        gpt.gpt_nano(ce_chunk=32, moe_num_experts=moe), sd, torch.from_numpy(tokens).long())
    assert torch.equal(loss, nothing_loss)
    for name, a, b in zip(sd, grads, nothing_grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6, msg=name)


def test_gpt_nano_train_step_tracks_jax():
    """Five steps from the same weights on one repeated batch: loss and
    grad norm against JAX's make_train_step (no mesh)."""
    tree = _nano_params()
    tokens = _tokens(2, 64, 256, seed=8)
    tx = jtr.default_optimizer(1e-2)
    jstate = jtr.TrainState(step=jnp.zeros((), jnp.int32),
                            params=jax.tree_util.tree_map(jnp.asarray, tree),
                            opt_state=tx.init(tree))
    jstep = jtr.make_train_step(jgpt.gpt_nano(), tx, donate=False)
    cfg = gpt.gpt_nano()
    opt = training.default_optimizer(1e-2)
    state = training.init_train_state(
        convert.params_from_jax(tree, cfg, device="cpu"), opt)
    step = training.make_train_step(cfg, opt, device="cpu")
    losses = []
    for i in range(5):
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        state, m = step(state, torch.from_numpy(tokens))
        assert m["step"] == i + 1 and state.step == i + 1
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=STEP_RTOL)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
    # the parameters after five steps, carried back
    back = convert.params_to_jax(state.params, cfg)
    np.testing.assert_allclose(back["lm_head"]["kernel"],
                               np.asarray(jstate.params["lm_head"]["kernel"]),
                               atol=1e-4, rtol=1e-3)


def test_gpt_j_shaped_train_step_tracks_jax():
    """gpt_j_6b's shape cut narrow (2 layers, 2 heads of head_dim 256, embed
    512, mlp 1024, vocab 512, rotary 64, parallel residual) in float32:
    three steps on one batch of t=64 from JAX's weights, against JAX's
    make_train_step. The port's attention runs the flash algorithm at
    head_dim 256 (the plain versions of the kernels that the card runs)."""
    shape = dict(vocab_size=512, num_layers=2, num_heads=2, head_dim=256, embed_dim=512,
                 mlp_dim=1024, max_seq_len=64, rotary_dim=64)
    jcfg = jgpt.GPTConfig(dtype=jnp.float32, **shape)
    variables = jgpt.GPT(jcfg).init(jax.random.PRNGKey(3), jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, jgpt.unboxed_params(variables))
    tokens = _tokens(2, 64, 512, seed=11)
    tx = jtr.default_optimizer(1e-2)
    jstate = jtr.TrainState(step=jnp.zeros((), jnp.int32),
                            params=jax.tree_util.tree_map(jnp.asarray, tree),
                            opt_state=tx.init(tree))
    jstep = jtr.make_train_step(jcfg, tx, donate=False)
    cfg = gpt.GPTConfig(dtype=torch.float32, **shape)
    opt = training.default_optimizer(1e-2)
    state = training.init_train_state(
        convert.params_from_jax(tree, cfg, device="cpu"), opt)
    step = training.make_train_step(cfg, opt, device="cpu")
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        state, m = step(state, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=STEP_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=STEP_RTOL)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


def test_eval_step_matches_jax():
    tree = _nano_params(seed=1)
    tokens = _tokens(3, 40, 256, seed=9)
    ref = jtr.make_eval_step(jgpt.gpt_nano())(tree, jnp.asarray(tokens))
    cfg = gpt.gpt_nano()
    sd = convert.params_from_jax(tree, cfg, device="cpu")
    got = training.make_eval_step(cfg, device="cpu")(sd, torch.from_numpy(tokens))
    np.testing.assert_allclose(float(got), float(ref), **LOSS_TOL)
    assert not any(p.requires_grad for p in sd.values())


def test_train_step_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.make_train_step(gpt.gpt_nano(), training.default_optimizer())
    with pytest.raises(RuntimeError, match="device='cpu'"):
        training.make_eval_step(gpt.gpt_nano())
