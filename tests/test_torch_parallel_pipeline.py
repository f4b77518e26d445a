"""ray_tpu_torch's pipeline axis against ray_tpu's: ``stage_split``,
``pipeline_apply``, the pipelined train step, its placements under
``pp_rules``, the GPT-J-6B per-card sizing and the pp dry run.

The reference runs on JAX's virtual 8-device CPU mesh; the port on gloo
ranks (``launch.spawn``), each rank on its block of the same global batch,
from the same weights (``params_from_jax`` of the reference's initial
state, stacked with ``gpt.stack_layers``). This module imports no JAX at its
top, so the ranks do not load it. The train steps clip with a
``grad_clip`` below the gradient's norm, so the clip binds and the second
step's update reads the whole gradient's norm (Adam's first update is
about lr times the gradient's sign whatever its scale). Tolerances:
- ``pipeline_apply`` on the toy ``tanh(h @ w)`` network: outputs atol 1e-5,
  gradients atol 1e-4, against the sequential loop and JAX's (the
  reference's tests' limits);
- the float32 pipelined step: loss rtol 1e-5 at each of 2 steps;
  parameters after each step rtol 1e-4, atol 1e-5, a hundredth of one
  update (Adam divides by the root of the second moment, so an element
  whose gradient is near 0 moves by up to lr on either side for rounding
  alone);
- the float32 steps' whole-gradient norm against the reference's gradient
  (the same step under ``optax.sgd(1.0)``): rtol 1e-4;
- the bfloat16-compute pipelined step: loss rtol 1e-4 (``BF16_LOSS_RTOL``;
  both sides round every activation to bf16, the final norm's statistics
  too, but sum the products in other orders, so an activation may land one
  bf16 step (2^-8 relative) apart; the two read 1.5e-6 apart).
"""

import dataclasses
import functools
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert, gpt, training
from ray_tpu_torch.parallel import dryrun, launch, pipeline, sharding
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec

LR, CLIP = 1e-3, 0.5
STEPS = 2
LOSS_RTOL = 1e-5
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
FLAT_GRAD = 1e-7
NORM_RTOL = 1e-4
BF16_LOSS_RTOL = 1e-4
TOY = dict(L=8, D=16, M=4, mb=2)
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=0.5)


def _tokens(b, t, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(np.int32)


def _nano(**kw):
    return dataclasses.replace(gpt.gpt_nano(remat=False), **{"num_layers": 4, **kw})


def _jax_nano(**kw):
    from ray_tpu.models import gpt as jgpt

    return dataclasses.replace(jgpt.gpt_nano(remat=False), num_layers=4, **kw)


def test_stage_split_shapes():
    out = pipeline.stage_split({"w": torch.zeros(4, 3, 5), "b": torch.zeros(4)}, 2)
    assert out["w"].shape == (2, 2, 3, 5) and out["b"].shape == (2, 2)
    assert pipeline.stage_split(torch.zeros(8, 2), 4).shape == (4, 2, 2)
    with pytest.raises(ValueError, match="not divisible"):
        pipeline.stage_split({"w": torch.zeros(3, 2)}, 2)


# ---------------------------------------------------------------------------
# pipeline_apply on a toy network
# ---------------------------------------------------------------------------


def _toy_layer(w, h):
    return torch.tanh(h @ w)


def _toy_worker(rank, world, w, x):
    """Per remat setting: the pipelined output on this rank, the gradient
    of sum(y^2) for this stage's layers and for the input."""
    mesh = MeshSpec(pp=world).build("cpu")
    stage = mesh.get_local_rank("pp")
    out = {}
    for remat in (False, True):
        wt = torch.from_numpy(w).requires_grad_(True)
        xt = torch.from_numpy(x).requires_grad_(True)
        mine = pipeline.stage_split(wt, world)[stage:stage + 1]
        y = pipeline.pipeline_apply(mesh, _toy_layer, mine, xt, remat=remat)
        gw, gx = torch.autograd.grad((y ** 2).sum(), (wt, xt))
        per = w.shape[0] // world
        out[remat] = {"y": y.detach().numpy(), "gx": gx.numpy(),
                      "gw": gw[stage * per:(stage + 1) * per].numpy(),
                      "gw_elsewhere": float(gw.abs().sum() - gw[stage * per:
                                                                (stage + 1) * per].abs().sum())}
    return out


def _toy_jax(w, x, stages):
    import jax
    import jax.numpy as jnp

    from ray_tpu.parallel import pipeline as jpl
    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec

    mesh = JMeshSpec(pp=stages).build(jax.devices()[:stages])

    def loss(w_, x_):
        y = jpl.pipeline_apply(mesh, lambda lp, h: jnp.tanh(h @ lp), jpl.stage_split(w_, stages),
                               x_, remat=False)
        return (y ** 2).sum(), y

    (_, y), (gw, gx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(
        jnp.asarray(w), jnp.asarray(x))
    return np.asarray(y), np.asarray(gw), np.asarray(gx)


def test_pipeline_apply_matches_sequential_and_jax():
    """pp 4, M=4, mb=2: every rank's output and the gradients (each stage's
    layers on its rank, the input's on every rank) against the sequential
    loop and JAX's ``pipeline_apply``, with and without remat."""
    rng = np.random.default_rng(0)
    w = (rng.standard_normal((TOY["L"], TOY["D"], TOY["D"])) * 0.3).astype(np.float32)
    x = rng.standard_normal((TOY["M"], TOY["mb"], TOY["D"])).astype(np.float32)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(launch.spawn, functools.partial(_toy_worker, w=w, x=x), 4,
                            device="cpu", timeout=240)
        jy, jgw, jgx = _toy_jax(w, x, 4)
        res = ranks.result()
    wt = torch.from_numpy(w).requires_grad_(True)
    xt = torch.from_numpy(x).requires_grad_(True)
    h = xt.reshape(-1, TOY["D"])
    for i in range(TOY["L"]):
        h = torch.tanh(h @ wt[i])
    seq_y = h.reshape(x.shape)
    seq_gw, seq_gx = (g.numpy() for g in torch.autograd.grad((seq_y ** 2).sum(), (wt, xt)))
    seq_y = seq_y.detach().numpy()
    for remat in (False, True):
        gw = np.concatenate([r[remat]["gw"] for r in res])
        for r in res:
            np.testing.assert_allclose(r[remat]["y"], seq_y, atol=1e-5)
            np.testing.assert_allclose(r[remat]["y"], jy, atol=1e-5)
            np.testing.assert_allclose(r[remat]["gx"], seq_gx, atol=1e-4)
            np.testing.assert_allclose(r[remat]["gx"], jgx, atol=1e-4)
            assert r[remat]["gw_elsewhere"] == 0.0  # no gradient for other stages' layers
        np.testing.assert_allclose(gw, seq_gw, atol=1e-4)
        np.testing.assert_allclose(gw, jgw, atol=1e-4)


# ---------------------------------------------------------------------------
# the pipelined train step against JAX's
# ---------------------------------------------------------------------------


def _pp_worker(rank, world, spec_kw, cfg_kw, params, tokens, steps=STEPS):
    """``steps`` pipelined steps from ``params`` (per layer): each step's
    metrics and the parameters after it (gathered, per layer)."""
    cfg = _nano(**cfg_kw)
    mesh = MeshSpec(**spec_kw).build("cpu")
    opt = training.default_optimizer(LR, grad_clip=CLIP)
    rules = sharding.pp_rules()
    state, shardings = training.init_sharded_state(
        cfg, mesh, opt, params={k: torch.from_numpy(v) for k, v in params.items()},
        rules=rules, stacked=True)
    step = training.make_pp_train_step(cfg, opt, mesh, num_microbatches=2, rules=rules,
                                       state_shardings_tree=shardings)
    tokens = torch.from_numpy(tokens)
    out = {"metrics": [], "params": []}
    for _ in range(steps):
        state, m = step(state, tokens)
        out["metrics"].append({k: float(v) for k, v in m.items()})
        # a copy: full_tensor() of a replicated DTensor is the local tensor,
        # which the next step updates in place
        full = {n: p.full_tensor().clone() for n, p in state.params.items()}
        out["params"].append({n: p.numpy() for n, p in gpt.unstack_layers(full, cfg).items()})
    return out


def _jax_pp_run(jcfg, spec_kw, tokens, meanwhile, steps=STEPS):
    """The reference on the mesh ``spec_kw``: its initial weights, and per
    step the loss, the gradient (the same step under ``optax.sgd(1.0)`` from
    the same parameters: the parameters less their update) and the
    parameters after it; and ``meanwhile(initial weights)``'s result (the
    port's ranks, started on a thread once the weights exist, so both run at
    once)."""
    import jax
    import optax

    from ray_tpu.models import training as jtr
    from ray_tpu.parallel import pipeline as jpl
    from ray_tpu.parallel import sharding as jshd
    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec

    n = int(np.prod(list(spec_kw.values())))
    mesh = JMeshSpec(**spec_kw).build(jax.devices()[:n])
    rules = jshd.pp_rules()
    key = jax.random.PRNGKey(0)
    opt, sgd = jtr.default_optimizer(LR, grad_clip=CLIP), optax.sgd(1.0)
    state, shardings = jtr.init_sharded_state(jcfg, mesh, opt, key, tokens.shape, rules=rules)
    sgd_state, sgd_shardings = jtr.init_sharded_state(jcfg, mesh, sgd, key, tokens.shape,
                                                      rules=rules)
    init = jax.tree_util.tree_map(np.asarray, state.params)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(meanwhile, init)
        step, grad_step = (
            jpl.make_pp_train_step(jcfg, o, mesh, num_microbatches=2, rules=rules,
                                   state_shardings_tree=sh, donate=False)
            for o, sh in ((opt, shardings), (sgd, sgd_shardings)))
        out = {"loss": [], "grads": [], "params": []}
        with mesh:
            for _ in range(steps):
                moved, _ = grad_step(jtr.TrainState(step=sgd_state.step, params=state.params,
                                                    opt_state=sgd_state.opt_state), tokens)
                out["grads"].append(jax.tree_util.tree_map(
                    lambda p, q: np.asarray(p) - np.asarray(q), state.params, moved.params))
                state, m = step(state, tokens)
                out["loss"].append(float(m["loss"]))
                out["params"].append(jax.tree_util.tree_map(np.asarray, state.params))
        return init, out, ranks.result()


def _port_params(tree, cfg):
    return {k: v.numpy() for k, v in convert.params_from_jax(tree, cfg, device="cpu").items()}


@pytest.mark.parametrize("spec,moe", [(dict(pp=2, tp=2), False),
                                      (dict(pp=2, fsdp=2, tp=2), False),
                                      (dict(dp=2, pp=2), True)],
                         ids=["pp2_tp2", "pp2_fsdp2_tp2", "moe_dp2_pp2"])
def test_pp_train_steps_match_jax(spec, moe):
    """Two pipelined steps at M=2 from the same weights and tokens, on every
    rank: the loss, the whole gradient's norm (the reference's gradient's)
    and the updated parameters, each rank's own copy of the pp-replicated
    ones (wte, ln_f, lm_head) among them. With ``moe`` every block's MLP is
    4 experts, top 2, capacity factor 0.5, routed per microbatch over the
    data ranks, and the loss leaves the aux term out, as the reference's
    pp step does. An element whose reference gradient is below
    ``FLAT_GRAD`` at some step is held to 2 * lr a step instead: Adam's
    update lr * g / (|g| + 1e-8) turns the rounding of such a gradient into
    up to lr either way."""
    cfg_kw = MOE if moe else {}
    pcfg = _nano(**cfg_kw)
    tokens = _tokens(4, 32, pcfg.vocab_size, seed=1)
    n = int(np.prod(list(spec.values())))
    _, ref, res = _jax_pp_run(
        _jax_nano(**cfg_kw), spec, tokens, lambda init: launch.spawn(functools.partial(
            _pp_worker, spec_kw=spec, cfg_kw=cfg_kw, params=_port_params(init, pcfg),
            tokens=tokens), n, device="cpu", timeout=240))
    flat = {}
    for s in range(STEPS):
        grads = _port_params(ref["grads"][s], pcfg)
        norm = float(np.sqrt(sum(np.square(g.astype(np.float64)).sum() for g in grads.values())))
        for name, g in grads.items():
            flat[name] = flat.get(name, False) | ((np.abs(g) < FLAT_GRAD) & (g != 0))
        want = _port_params(ref["params"][s], pcfg)
        for r in res:
            got = r["metrics"][s]
            assert got["step"] == s + 1
            np.testing.assert_allclose(got["loss"], ref["loss"][s], rtol=LOSS_RTOL)
            np.testing.assert_allclose(got["grad_norm"], norm, rtol=NORM_RTOL)
            assert norm > CLIP  # the clip binds
            for name, w in want.items():
                p, f = r["params"][s][name], flat[name]
                np.testing.assert_allclose(p[~f], w[~f], err_msg=f"{name} step {s}",
                                           **PARAM_TOL)
                assert np.all(np.abs(p[f] - w[f]) <= 2 * LR * (s + 1)), (name, s)
    n_flat = sum(int(f.sum()) for f in flat.values())
    assert n_flat <= 5e-3 * sum(f.size for f in flat.values()), n_flat
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]  # every rank reports the global metrics


#: the reference's bf16 pipelined step, in a process of its own: XLA's CPU
#: compiler fails on it (a check in ``hlo_instruction.cc``: "Invalid binary
#: instruction opcode copy") unless its all-reduce-promotion pass is off
_BF16_REFERENCE = """
import dataclasses, json, sys
import numpy as np
import jax
import jax.numpy as jnp
from ray_tpu.models import gpt as jgpt, training as jtr
from ray_tpu.parallel import pipeline as jpl, sharding as jshd
from ray_tpu.parallel.mesh import MeshSpec
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)
spec, tokens = json.loads(sys.argv[1]), np.asarray(json.loads(sys.argv[2]), np.int32)
cfg = dataclasses.replace(jgpt.gpt_nano(remat=False), num_layers=4, dtype=jnp.bfloat16)
mesh = MeshSpec(**spec).build(jax.devices()[:int(np.prod(list(spec.values())))])
opt, rules = jtr.default_optimizer(float(sys.argv[3]), grad_clip=float(sys.argv[4])), jshd.pp_rules()
state, sh = jtr.init_sharded_state(cfg, mesh, opt, jax.random.PRNGKey(0), tokens.shape, rules=rules)
init = sum(float(np.abs(np.asarray(p, np.float64)).sum()) for p in jax.tree_util.tree_leaves(state.params))
step = jpl.make_pp_train_step(cfg, opt, mesh, num_microbatches=2, rules=rules,
                              state_shardings_tree=sh, donate=False)
with mesh:
    state, m = step(state, tokens)
print(json.dumps({"loss": float(m["loss"]), "init": init}))
"""


def test_pp_bf16_step_matches_jax():
    """bfloat16 compute (float32 parameters) at pp 2 x tp 2, one step: the
    loss against the reference's, whose final norm computes in bf16 as the
    port's pipelined step does (``_BF16_REFERENCE``; its initial weights are
    the ones the ranks start from, checked by their sum)."""
    import json
    import os
    import subprocess
    import sys

    import jax
    import jax.numpy as jnp

    from ray_tpu.models import training as jtr
    from ray_tpu.parallel import sharding as jshd
    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec

    pcfg = _nano(dtype=torch.bfloat16)
    tokens = _tokens(4, 32, pcfg.vocab_size, seed=2)
    spec = dict(pp=2, tp=2)
    state, _ = jtr.init_sharded_state(
        _jax_nano(dtype=jnp.bfloat16), JMeshSpec(**spec).build(jax.devices()[:4]),
        jtr.default_optimizer(LR, grad_clip=CLIP), jax.random.PRNGKey(0), tokens.shape,
        rules=jshd.pp_rules())
    init = jax.tree_util.tree_map(np.asarray, state.params)
    env = dict(os.environ, XLA_FLAGS=os.environ.get("XLA_FLAGS", "")
               + " --xla_disable_hlo_passes=all-reduce-promotion")
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with ThreadPoolExecutor(1) as pool:
        ref = pool.submit(subprocess.run, [
            sys.executable, "-c", _BF16_REFERENCE, json.dumps(spec), json.dumps(tokens.tolist()),
            str(LR), str(CLIP)], cwd=repo, env=env, capture_output=True, text=True, timeout=240)
        res = launch.spawn(functools.partial(
            _pp_worker, spec_kw=spec, cfg_kw=dict(dtype=torch.bfloat16),
            params=_port_params(init, pcfg), tokens=tokens, steps=1), 4, device="cpu",
            timeout=240)
        proc = ref.result()
    assert proc.returncode == 0, proc.stderr[-3000:]
    want = json.loads(proc.stdout.strip().splitlines()[-1])
    assert want["init"] == sum(float(np.abs(p.astype(np.float64)).sum())
                               for p in jax.tree_util.tree_leaves(init))
    for r in res:
        np.testing.assert_allclose(r["metrics"][0]["loss"], want["loss"], rtol=BF16_LOSS_RTOL)


# ---------------------------------------------------------------------------
# placements, a rank's bytes, the GPT-J-6B sizing
# ---------------------------------------------------------------------------


def _sizes(shape):
    return {a: shape.get(a, 1) for a in AXIS_ORDER}


@pytest.mark.parametrize("spec", [dict(pp=2, fsdp=2, tp=2), dict(pp=4, tp=2)],
                         ids=["pp2_fsdp2_tp2", "pp4_tp2"])
def test_pp_placements_match_jax_state_shardings(spec):
    """Every element of every parameter sits on the same mesh coordinates
    under the port's stacked placements (``state_shardings(...,
    pp_rules(), stacked=True)``) as under JAX's ``state_shardings`` with
    ``pp_rules``, and the Adam moments mirror the parameters."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import training as jtr
    from ray_tpu.parallel import sharding as jshd
    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec

    pcfg = _nano()
    mesh = JMeshSpec(**spec).build(jax.devices()[:8])
    _, abstract = jtr.abstract_state(_jax_nano(), jtr.default_optimizer(),
                                     jax.ShapeDtypeStruct((4, 32), jnp.int32))
    shardings = nn.meta.unbox(jtr.state_shardings(mesh, abstract, jshd.pp_rules())).params
    shapes = nn.meta.unbox(abstract.params)
    leaves, treedef = jax.tree_util.tree_flatten(shapes)
    offset, ids = 0, []
    for leaf in leaves:
        n = int(np.prod(leaf.shape))
        ids.append(np.arange(offset, offset + n, dtype=np.float64).reshape(leaf.shape))
        offset += n
    port_ids = gpt.stack_layers(convert.params_from_jax(
        jax.tree_util.tree_unflatten(treedef, ids), dataclasses.replace(
            pcfg, param_dtype=torch.float64), device="cpu"), pcfg)
    held = {}
    shard_leaves = jax.tree_util.tree_leaves(shardings, is_leaf=lambda x: hasattr(x, "spec"))
    for c in np.ndindex(mesh.devices.shape):
        mask = np.zeros(offset, bool)
        for leaf_ids, sh in zip(ids, shard_leaves):
            index = sh.devices_indices_map(leaf_ids.shape)[mesh.devices[c]]
            mask[leaf_ids[index].astype(np.int64).ravel()] = True
        held[c] = mask
    sizes = _sizes(spec)
    state = training.state_shardings(sizes, pcfg, sharding.pp_rules(), stacked=True)
    assert set(state.params) == set(port_ids)
    assert state.opt_state.mu == state.opt_state.nu == list(state.params.values())
    for name, pids in port_ids.items():
        pids = pids.numpy().astype(np.int64)
        spec_ = sharding.spec_of(state.params[name], pids.ndim)
        if name.startswith(gpt.STACKED_PREFIX):
            assert spec_[0] == "pp", name
        for c, mask in held.items():
            coord = dict(zip(AXIS_ORDER, c))
            block = pids[sharding.local_slices(pids.shape, spec_, sizes, coord)].ravel()
            assert mask[block].all() and mask[pids.ravel()].sum() == block.size, (name, c)


def _bytes_worker(rank, world, specs, tokens):
    """Per mesh of ``specs``: this rank's parameter, Adam moment and
    gradient bytes in one pipelined step (the gradients the backward
    returns), and its pp stage."""
    cfg = _nano()
    opt = training.default_optimizer(LR)
    grad_bytes = []
    grad = torch.autograd.grad

    def counted_grad(outputs, inputs, *a, **kw):
        grads = grad(outputs, inputs, *a, **kw)
        grad_bytes.append(sum(g.numel() * g.element_size() for g in grads))
        return grads

    torch.autograd.grad = counted_grad
    try:
        out = {}
        for spec in specs:
            mesh = MeshSpec(**spec).build("cpu")
            state, shardings = training.init_sharded_state(
                cfg, mesh, opt, seed=0, rules=sharding.pp_rules(), stacked=True)
            step = training.make_pp_train_step(cfg, opt, mesh, num_microbatches=2,
                                               state_shardings_tree=shardings)
            grad_bytes.clear()
            state, _ = step(state, torch.from_numpy(tokens))
            local = [p.to_local() for p in state.params.values()]
            out[tuple(spec.items())] = {
                "params": sum(p.numel() * p.element_size() for p in local),
                "moments": sum(m.to_local().numel() * m.to_local().element_size()
                               for m in state.opt_state.mu + state.opt_state.nu),
                "grads": sum(grad_bytes)}
        return out
    finally:
        torch.autograd.grad = grad


def test_a_pp_rank_holds_its_stages_layers():
    """On 4 ranks at pp 2 (x dp 2) and pp 4: each rank's parameter and
    gradient bytes are 1/S of the layers' plus the replicated leaves'
    (wte, ln_f, lm_head) whole, and its Adam moments twice that."""
    cfg = _nano()
    specs = (dict(dp=2, pp=2), dict(pp=4))
    res = launch.spawn(functools.partial(_bytes_worker, specs=specs,
                                         tokens=_tokens(4, 32, cfg.vocab_size)), 4,
                       device="cpu", timeout=240)
    whole = dict(gpt.GPT(cfg, device="meta").named_parameters())
    layers = sum(p.numel() * 4 for n, p in whole.items() if n.startswith("blocks."))
    rest = sum(p.numel() * 4 for n, p in whole.items() if not n.startswith("blocks."))
    for r in res:
        for spec in specs:
            got = r[tuple(spec.items())]
            want = layers // spec["pp"] + rest
            assert got["params"] == got["grads"] == want, (spec, got, want)
            assert got["moments"] == 2 * want


def _port_shape(name, shape):
    """A reference leaf's shape in the port's layout (``convert``'s axis
    map), the leading layer axis kept."""
    lead, tail = shape[:-3], shape[-3:]
    if name.endswith(("attn/q/kernel", "attn/k/kernel", "attn/v/kernel")):
        return (*lead, tail[1] * tail[2], tail[0])
    if name.endswith("attn/o/kernel"):
        return (*lead, tail[2], tail[0] * tail[1])
    if name.endswith(("mlp/wi/kernel", "mlp/wo/kernel", "lm_head/kernel")):
        return (*shape[:-2], shape[-1], shape[-2])
    return tuple(shape)


def _port_name(path, stacked):
    name = path.replace("wte/embedding", "wte.weight").replace("/kernel", ".weight")
    name = name.replace("/scale", ".weight").replace("/", ".")
    return name.replace("blocks.layers.", gpt.STACKED_PREFIX if stacked else "blocks.0.")


def test_gpt_j_6b_sizing_matches_jax_shard_shapes():
    """Both 64-card layouts: every leaf's block on the largest rank, from
    shapes alone, equals the shard shape of JAX's ``state_shardings`` on
    ``abstract_state`` over an ``AbstractMesh`` (no devices); the per-layer
    layout's blocks against the reference's stacked leaves less their
    layer axis."""
    import flax.linen as nn
    import jax
    import jax.numpy as jnp
    from jax.sharding import AbstractMesh

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.models import training as jtr
    from ray_tpu.parallel import sharding as jshd
    from ray_tpu.parallel.mesh import AXIS_ORDER as JAXIS_ORDER

    got = dryrun.gpt_j_6b_sizing()
    jcfg = jgpt.gpt_j_6b(dtype=jnp.bfloat16, param_dtype=jnp.bfloat16)
    _, abstract = jtr.abstract_state(jcfg, jtr.default_optimizer(1e-4),
                                     jax.ShapeDtypeStruct((16, 2048), jnp.int32))
    for label, sizes, pipelined in dryrun.GPT_J_LAYOUTS:
        mesh = AbstractMesh(tuple(sizes.get(a, 1) for a in JAXIS_ORDER), JAXIS_ORDER)
        shardings = nn.meta.unbox(jtr.state_shardings(
            mesh, abstract, jshd.pp_rules() if pipelined else None)).params
        shapes = nn.meta.unbox(abstract.params)
        want = {}
        for path, sh in jax.tree_util.tree_leaves_with_path(
                shardings, is_leaf=lambda x: hasattr(x, "spec")):
            key = "/".join(k.key for k in path)
            leaf = shapes
            for k in path:
                leaf = leaf[k.key]
            shard = sh.shard_shape(leaf.shape)
            if key.startswith("blocks/") and not pipelined:
                shard = shard[1:]
            want[_port_name(key, pipelined)] = _port_shape(key, shard)
        local = got[label]["local_shapes"]
        if not pipelined:  # every layer's blocks alike; layer 0 stands for them
            assert all(local[n] == local["blocks.0." + n.split(".", 2)[2]]
                       for n in local if n.startswith("blocks."))
            local = {n: s for n, s in local.items()
                     if not n.startswith("blocks.") or n.startswith("blocks.0.")}
        assert local == want, label
        n_bytes = 2 * sum(int(np.prod(s)) for s in got[label]["local_shapes"].values())
        assert got[label]["gib"]["params"] == {"bfloat16": n_bytes / 2 ** 30}
        assert got[label]["num_params"] == jcfg.num_params()


def test_pp_dryrun_on_4_cpu_ranks():
    res = launch.spawn(functools.partial(dryrun.run_pp, device="cpu"), 4, device="cpu",
                       timeout=240)
    for r in res:
        assert r["mesh"] == {"pp": 2, "tp": 2}
        assert r["loss"] > 0 and np.isfinite(r["loss"]) and r["step"] == 1
    assert len({r["loss"] for r in res}) == 1


def _refusals_worker(rank, world):
    """What each refused case raised (its exception's name, or None)."""
    out = {}
    opt = training.default_optimizer(LR)
    cases = {"tied": (dict(dp=2, pp=2), _nano(tie_embeddings=True)),
             "layers": (dict(dp=2, pp=2), _nano(num_layers=3)),
             "sp": (dict(pp=2, sp=2), _nano()),
             "ep": (dict(pp=2, ep=2), _nano(moe_num_experts=2))}
    for key, (spec, cfg) in cases.items():
        try:
            training.make_pp_train_step(cfg, opt, MeshSpec(**spec).build("cpu"))
            out[key] = None
        except (ValueError, NotImplementedError) as e:
            out[key] = type(e).__name__
    cfg = _nano()
    mesh = MeshSpec(dp=2, pp=2).build("cpu")
    state, sh = training.init_sharded_state(cfg, mesh, opt, seed=0,
                                            rules=sharding.pp_rules(), stacked=True)
    step = training.make_pp_train_step(cfg, opt, mesh, num_microbatches=4,
                                       state_shardings_tree=sh)
    try:
        step(state, torch.zeros(4, 16, dtype=torch.long))  # 4 rows: 4 microbatches x dp 2
        out["batch"] = None
    except ValueError as e:
        out["batch"] = type(e).__name__
    return out


def test_pp_step_refuses_what_the_reference_never_runs():
    """A tied embedding and layers that do not split over pp raise
    ``ValueError``, pp > 1 with sp or ep ``NotImplementedError``, and a
    batch that does not split into M microbatches over the data ranks
    ``ValueError`` at the step."""
    res = launch.spawn(_refusals_worker, 4, device="cpu", timeout=240)
    for r in res:
        assert r == {"tied": "ValueError", "layers": "ValueError", "sp": "NotImplementedError",
                     "ep": "NotImplementedError", "batch": "ValueError"}
