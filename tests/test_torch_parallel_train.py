"""ray_tpu_torch's sharded train step against ray_tpu's on meshes, the dry
runs, the local process groups, and the serving engine's scoped
deterministic mode.

The reference runs ``make_train_step(cfg, opt, mesh, state_shardings_tree)``
on JAX's virtual 8-device CPU mesh; the port runs the same steps from the
same weights (``params_from_jax`` of the reference's initial state) on gloo
ranks (``launch.spawn``), each rank on its block of the same global batch.
This module imports no JAX at its top, so the ranks do not load it. Every
step clips with a ``grad_clip`` below the gradient's norm, so the clip
binds. Everything is float32. Tolerances:
- loss and grad norm, each step: rtol 1e-4 (the port's attention is the
  tiled flash algorithm, the reference's the full softmax; summation
  orders differ across the mesh);
- parameters after 2 steps at lr 1e-3: rtol 1e-4, atol 1e-5, a hundredth
  of one step's update (Adam divides by the root of the second moment, so
  an element whose gradient is near 0 moves by up to lr on either side for
  rounding alone);
- the MoE kept set: every block's slot of every assignment equal;
- one rank against the single-device step: metrics rtol 1e-6 (the sharded
  loss sums the last position's target with weight 0, in another chunk
  layout); parameters rtol 1e-5, atol 1e-6, a thousandth of one update (the
  same amplification by Adam as above).
"""

import atexit
import contextlib
import dataclasses
import functools
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from ray_tpu_torch.models import convert, gpt, inference, moe, training
from ray_tpu_torch.parallel import comm, dryrun, launch
from ray_tpu_torch.parallel.mesh import MeshSpec
from ray_tpu_torch.serve import llm

STEP_RTOL = 1e-4
PARAM_TOL = dict(rtol=1e-4, atol=1e-5)
LR, CLIP = 1e-3, 0.5
MOE = dict(moe_num_experts=4, moe_top_k=2, moe_capacity_factor=0.25)


def _tokens(b, t, vocab, seed=0):
    return np.random.RandomState(seed).randint(0, vocab, (b, t)).astype(np.int32)


def _block_slots(step, cfg, slots):
    """Hook each MoE block of the sharded step's model: on its first call
    in a step, the slot of every assignment of the global batch, [k, B, T]
    in the reference's order (gathered over the data ranks)."""
    model = step.model
    g = model.groups

    def grab(layer, args):
        if len(slots) >= cfg.num_layers:  # the remat recompute calls again
            return
        x = args[0]
        b, t, d = x.shape
        with torch.no_grad():
            xs = x.reshape(-1, d).to(cfg.dtype)
            cap = moe.expert_capacity(cfg, xs.shape[0] * g.data_size)
            slot = moe.route(xs, layer.router, cfg.moe_top_k, cap, rows=b, groups=g)[3]
            every = comm.all_gather(slot.view(1, cfg.moe_top_k, b, t), g.data)
        blocks, sp = g.batch_blocks, g.sizes["sp"]
        every = every.view(blocks, sp, cfg.moe_top_k, b, t).permute(2, 0, 3, 1, 4)
        slots.append(every.reshape(cfg.moe_top_k, blocks * b, sp * t).numpy())

    for block in model.blocks:
        block.mlp.register_forward_pre_hook(grab)


def _train_worker(rank, world, spec_kw, cfg_kw, params, tokens, steps=2, slots=False):
    """``steps`` sharded steps from ``params``: the eval loss before them,
    each step's metrics, the final parameters (gathered) and, with
    ``slots``, every MoE block's slots in the first step."""
    cfg = gpt.gpt_nano(**cfg_kw)
    mesh = MeshSpec(**spec_kw).build("cpu")
    opt = training.default_optimizer(LR, grad_clip=CLIP)
    state, shardings = training.init_sharded_state(
        cfg, mesh, opt, params={k: torch.from_numpy(v) for k, v in params.items()})
    step = training.make_train_step(cfg, opt, mesh=mesh, state_shardings_tree=shardings)
    tokens = torch.from_numpy(tokens)
    out = {"eval": float(training.make_eval_step(cfg, mesh=mesh)(state.params, tokens)),
           "metrics": [], "slots": []}
    if slots:
        _block_slots(step, cfg, out["slots"])
    for _ in range(steps):
        state, m = step(state, tokens)
        out["metrics"].append({k: float(v) for k, v in m.items()})
    out["params"] = {n: p.full_tensor().numpy() for n, p in state.params.items()}
    return out


def _jax_run(jcfg, spec_kw, tokens, steps=2, meanwhile=None):
    """The reference's initial weights (numpy), its eval loss and each
    step's metrics and final parameters on the mesh ``spec_kw``, and
    ``meanwhile(initial weights)``'s result (the port's ranks, started on a
    thread once the weights exist, so both sides run at once)."""
    import jax

    from ray_tpu.models import training as jtr
    from ray_tpu.parallel.mesh import MeshSpec as JMeshSpec

    n = int(np.prod(list(spec_kw.values())))
    mesh = JMeshSpec(**spec_kw).build(jax.devices()[:n])
    opt = jtr.default_optimizer(LR, grad_clip=CLIP)
    state, shardings = jtr.init_sharded_state(jcfg, mesh, opt, jax.random.PRNGKey(0),
                                              tokens.shape)
    init = jax.tree_util.tree_map(np.asarray, state.params)
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(meanwhile or (lambda _: None), init)
        step = jtr.make_train_step(jcfg, opt, mesh, state_shardings_tree=shardings)
        with mesh:
            ev = float(jtr.make_eval_step(jcfg, mesh)(state.params, tokens))
            metrics = []
            for _ in range(steps):
                state, m = step(state, tokens)
                metrics.append({k: float(m[k]) for k in ("loss", "grad_norm")})
        final = jax.tree_util.tree_map(np.asarray, state.params)
        return init, ev, metrics, final, mesh, ranks.result()


def _port_params(tree, cfg):
    return {k: v.numpy() for k, v in convert.params_from_jax(tree, cfg, device="cpu").items()}


def _check_against_jax(got, ev, metrics, final, pcfg):
    np.testing.assert_allclose(got["eval"], ev, rtol=STEP_RTOL)
    for g, w in zip(got["metrics"], metrics):
        assert w["grad_norm"] > CLIP  # the clip binds
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=STEP_RTOL)
        np.testing.assert_allclose(g["grad_norm"], w["grad_norm"], rtol=STEP_RTOL)
    want = _port_params(final, pcfg)
    for name, arr in want.items():
        np.testing.assert_allclose(got["params"][name], arr, err_msg=name, **PARAM_TOL)


def test_dp2_fsdp2_tp2_steps_match_jax():
    from ray_tpu.models import gpt as jgpt

    spec = dict(dp=2, fsdp=2, tp=2)
    pcfg = gpt.gpt_nano()
    tokens = _tokens(8, 32, pcfg.vocab_size, seed=1)
    _, ev, metrics, final, _, res = _jax_run(
        jgpt.gpt_nano(), spec, tokens, meanwhile=lambda init: launch.spawn(functools.partial(
            _train_worker, spec_kw=spec, cfg_kw={}, params=_port_params(init, pcfg),
            tokens=tokens), 8, device="cpu", timeout=240))
    for r in res[1:]:
        assert r["metrics"] == res[0]["metrics"]  # every rank reports the global metrics
    _check_against_jax(res[0], ev, metrics, final, pcfg)


def _sp2_worker(rank, world, params, tokens):
    """Both sequence-parallel steps on sp 2, from the same weights."""
    return {impl: _train_worker(rank, world, dict(sp=2), dict(seq_parallel_impl=impl),
                                params, tokens) for impl in ("ring", "ulysses")}


@pytest.fixture(scope="module")
def sp2_runs():
    """The port's sp 2 steps under ring and Ulysses attention (2 ranks, one
    start for both), and the reference's (the same initial weights: one
    seed, one shape)."""
    from ray_tpu.models import gpt as jgpt

    tokens = _tokens(2, 64, 256, seed=2)
    pcfg = gpt.gpt_nano()
    ring = _jax_run(jgpt.gpt_nano(seq_parallel_impl="ring"), dict(sp=2), tokens,
                    meanwhile=lambda init: launch.spawn(functools.partial(
                        _sp2_worker, params=_port_params(init, pcfg), tokens=tokens),
                        2, device="cpu", timeout=240))
    ulysses = _jax_run(jgpt.gpt_nano(seq_parallel_impl="ulysses"), dict(sp=2), tokens)
    port = ring[-1][0]
    return {impl: (port[impl], *ref[1:4], pcfg)
            for impl, ref in (("ring", ring), ("ulysses", ulysses))}


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
def test_sp2_steps_match_jax(sp2_runs, impl):
    _check_against_jax(*sp2_runs[impl])


def _jax_slots(jcfg, tree, tokens, mesh):
    """Each MoE block's slot of every assignment in the reference's forward
    on ``mesh``: its blocks' MLP inputs captured (per-layer modules, no
    remat), routed by the reference's expressions (``ray_tpu/models/
    moe.py``): [k, B, T] per block, E * C for a dropped assignment."""
    import dataclasses
    import math

    import flax.linen as nn
    import jax
    import jax.numpy as jnp

    from ray_tpu.models import gpt as jgpt
    from ray_tpu.parallel import sharding as jshd

    cfg = dataclasses.replace(jcfg, scan_layers=False, remat=False)
    pcfg = gpt.gpt_nano(**MOE)
    flat = convert.params_to_jax(convert.params_from_jax(tree, pcfg, device="cpu"), pcfg,
                                 stacked=False)
    model = jgpt.GPT(cfg)
    abstract = jax.eval_shape(lambda r: model.init(r, jnp.zeros((1, 8), jnp.int32)),
                              jax.random.PRNGKey(0))["params"]
    params = jax.device_put(flat, nn.meta.unbox(jshd.params_shardings(mesh, abstract)))
    toks = jax.device_put(jnp.asarray(tokens), jshd.batch_sharding(mesh))

    @jax.jit
    def capture(p, t):
        with nn.logical_axis_rules(jshd.DEFAULT_RULES):
            _, inter = model.apply({"params": p}, t, capture_intermediates=True,
                                   mutable=["intermediates", "losses"])
        return [inter["intermediates"]["blocks"][f"layer_{i}"]["ln"]["__call__"][0]
                for i in range(cfg.num_layers)]

    with mesh:
        inputs = capture(params, toks)
    k, n_exp = cfg.moe_top_k, cfg.moe_num_experts
    b, t = tokens.shape
    s = b * t
    capacity = max(1, int(math.ceil(k * s / n_exp * cfg.moe_capacity_factor)))
    out = []
    for i, x in enumerate(inputs):
        router = flat["blocks"][f"layer_{i}"]["mlp"]["router"]
        probs = jax.nn.softmax(x.reshape(s, -1).astype(jnp.float32) @ jnp.asarray(router), -1)
        _, gate_idx = jax.lax.top_k(probs, k)
        onehot = jax.nn.one_hot(gate_idx, n_exp, dtype=jnp.float32)
        fl = onehot.transpose(1, 0, 2).reshape(k * s, n_exp)
        pos = ((jnp.cumsum(fl, axis=0) - fl) * fl).sum(-1)
        keep = pos < capacity
        expert = gate_idx.T.reshape(-1)
        slot = jnp.where(keep, expert * capacity + pos.astype(jnp.int32), n_exp * capacity)
        out.append(np.asarray(slot).reshape(k, b, t))
    return out


def test_moe_dp2_ep2_tp2_matches_jax_with_drops():
    """MoE gpt_nano on dp 2 x ep 2 x tp 2 at capacity factor 0.25: every
    block routes over the global batch and keeps the reference's set of
    assignments (some kept, some dropped), and two steps match."""
    from ray_tpu.models import gpt as jgpt

    spec = dict(dp=2, ep=2, tp=2)
    jcfg, pcfg = jgpt.gpt_nano(**MOE), gpt.gpt_nano(**MOE)
    tokens = _tokens(4, 16, pcfg.vocab_size, seed=3)
    init, ev, metrics, final, mesh, res = _jax_run(
        jcfg, spec, tokens, meanwhile=lambda init: launch.spawn(functools.partial(
            _train_worker, spec_kw=spec, cfg_kw=MOE, params=_port_params(init, pcfg),
            tokens=tokens, slots=True), 8, device="cpu", timeout=240))
    want_slots = _jax_slots(jcfg, init, tokens, mesh)
    n_slots = pcfg.moe_num_experts * moe.expert_capacity(pcfg, tokens.size)
    for r in res:
        assert len(r["slots"]) == pcfg.num_layers
        for got, want in zip(r["slots"], want_slots):
            np.testing.assert_array_equal(got, want)
            assert 0 < int((got < n_slots).sum()) < got.size  # some kept, some dropped
    _check_against_jax(res[0], ev, metrics, final, pcfg)


def test_one_rank_step_is_the_single_device_step():
    """On a one-rank mesh the sharded step computes the single-device step
    (no collective but the norm's)."""
    cfg = gpt.gpt_nano(**MOE)
    params = {k: v.numpy() for k, v in inference.init_params(cfg, "cpu", seed=4).items()}
    tokens = _tokens(2, 48, cfg.vocab_size, seed=5)
    (got,) = launch.spawn(functools.partial(
        _train_worker, spec_kw=dict(fsdp=-1), cfg_kw=MOE, params=params, tokens=tokens), 1, device="cpu")
    opt = training.default_optimizer(LR, grad_clip=CLIP)
    state = training.init_train_state({k: torch.from_numpy(v.copy()) for k, v in params.items()},
                                      opt)
    step = training.make_train_step(cfg, opt, device="cpu")
    for g in got["metrics"]:
        state, m = step(state, torch.from_numpy(tokens))
        for key in ("loss", "grad_norm", "moe_aux", "moe_dropped"):
            np.testing.assert_allclose(g[key], float(m[key]), rtol=1e-6, err_msg=key)
    for name, p in state.params.items():
        np.testing.assert_allclose(got["params"][name], p.detach().numpy(), rtol=1e-5,
                                   atol=1e-6, err_msg=name)


def _memory_worker(rank, world, specs, tokens):
    """Per mesh of ``specs``, this rank's parameter and gradient bytes in
    one step: its parameter blocks, the most bytes of gathered parameter
    views alive at once (each counted until autograd frees it) and the
    gradients the backward returns; and the bytes of the whole embedding
    and of one whole block."""
    import weakref

    cfg = dataclasses.replace(gpt.gpt_nano(), num_layers=4)
    opt = training.default_optimizer(LR)
    live = {"now": 0, "peak": 0}
    grad_bytes = []
    view, grad = training._view, torch.autograd.grad

    def free(n):
        live["now"] -= n

    def counted_view(local, plan, groups):
        out = view(local, plan, groups)
        if out is not local:
            n = out.numel() * out.element_size()
            live["now"] += n
            live["peak"] = max(live["peak"], live["now"])
            weakref.finalize(out, free, n)
        return out

    def counted_grad(outputs, inputs, *a, **kw):
        grads = grad(outputs, inputs, *a, **kw)
        grad_bytes.append(sum(g.numel() * g.element_size() for g in grads))
        return grads

    training._view, torch.autograd.grad = counted_view, counted_grad
    try:
        out = {}
        for spec in specs:
            mesh = MeshSpec(**spec).build("cpu")
            state, shardings = training.init_sharded_state(cfg, mesh, opt, seed=0)
            step = training.make_train_step(cfg, opt, mesh=mesh, state_shardings_tree=shardings)
            live["peak"] = live["now"]
            grad_bytes.clear()
            state, _ = step(state, torch.from_numpy(tokens))
            out[tuple(spec.items())] = {
                "params": sum(p.to_local().numel() * 4 for p in state.params.values()),
                "gathered_peak": live["peak"], "grads": sum(grad_bytes)}
        whole = inference.init_params(cfg, "cpu", seed=0)
        out["wte"] = whole["wte.weight"].numel() * 4
        out["block"] = sum(p.numel() * 4 for n, p in whole.items() if n.startswith("blocks.0."))
        return out
    finally:
        training._view, torch.autograd.grad = view, grad


def test_fsdp_cuts_each_ranks_parameter_and_gradient_bytes():
    """On 4 ranks, dp 4, then dp 2 x fsdp 2, then fsdp 4: a rank's
    parameter bytes (its blocks and the gathered views alive at once) plus
    its gradient bytes fall as fsdp grows. Gradients are this rank's blocks
    (half and a quarter of dp 4's, less the few parameters without an
    embed dim, which fsdp does not cut), and no more than two blocks and the
    embedding are whole at once (a block's weights are gathered where it
    runs, and again in the backward's recompute)."""
    specs = (dict(dp=4), dict(dp=2, fsdp=2), dict(fsdp=4))
    res = launch.spawn(functools.partial(_memory_worker, specs=specs,
                                         tokens=_tokens(4, 32, 256)), 4, device="cpu")
    for r in res:
        dp4, fsdp2, fsdp4 = (r[tuple(s.items())] for s in specs)
        assert dp4["gathered_peak"] == 0
        for m, share in ((fsdp2, 0.5), (fsdp4, 0.25)):
            assert m["grads"] <= (share + 0.02) * dp4["grads"]
            assert 0 < m["gathered_peak"] <= 2 * r["block"] + r["wte"]
        totals = [m["params"] + m["gathered_peak"] + m["grads"] for m in (dp4, fsdp2, fsdp4)]
        assert totals[2] < totals[1] < 0.8 * totals[0], totals


# ---------------------------------------------------------------------------
# dry runs and the launcher
# ---------------------------------------------------------------------------


def test_dryrun_on_4_cpu_ranks():
    res = dryrun.dryrun(4, device="cpu", timeout=240)
    assert res["dp_fsdp_tp_sp"]["mesh"] == {"sp": 2, "tp": 2}
    assert res["pp"]["mesh"] == {"pp": 2, "tp": 2}
    assert res["ep"]["mesh"] == {"dp": 2, "ep": 2}
    assert res["multislice"]["mesh"] == {"dp": 2, "fsdp": 2}
    assert all(r["loss"] > 0 and np.isfinite(r["loss"]) and r["step"] == 1
               for r in res.values())


def test_dryrun_without_cards_names_the_cpu_device():
    if torch.cuda.device_count() >= 64:
        pytest.skip("64 cards present")
    with pytest.raises(RuntimeError, match="--device cpu"):
        dryrun.dryrun(64, device="cuda")


def _fail_on_rank_one(rank, world):
    if rank == 1:
        raise ValueError("planted failure")
    return rank


def _sum_of_ranks(rank, world):
    return float(comm.all_reduce(torch.tensor([float(rank)]), torch.distributed.group.WORLD))


def test_spawn_returns_in_rank_order_and_raises_a_rank_failure():
    assert launch.spawn(_sum_of_ranks, 3, device="cpu") == [3.0, 3.0, 3.0]
    with pytest.raises(launch.WorkerError, match="planted failure"):
        launch.spawn(_fail_on_rank_one, 2, device="cpu")


def _exit_3_after_reporting(fail: bool, rank, world):
    """Rank 1's process exits with code 3 once its result is reported (an
    exit handler, as a teardown that dies would), having raised or not."""
    if rank == 1:
        atexit.register(os._exit, 3)
        if fail:
            raise ValueError("planted failure")
    return rank


@pytest.mark.parametrize("fail", [False, True], ids=["returned", "raised"])
def test_spawn_takes_a_result_reported_before_the_rank_died(fail):
    """A rank whose process dies after its function's result is reported
    (a non-zero exit in the group's teardown) is held to that result: its
    value, or its traceback, and not "exited ... without a result"."""
    fn = functools.partial(_exit_3_after_reporting, fail)
    if fail:
        with pytest.raises(launch.WorkerError, match="planted failure"):
            launch.spawn(fn, 2, device="cpu", timeout=60.0)
    else:
        assert launch.spawn(fn, 2, device="cpu", timeout=60.0) == [0, 1]


# ---------------------------------------------------------------------------
# the engine's deterministic mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("before", [False, True], ids=["off", "on"])
def test_deterministic_algorithms_restores_the_callers_setting(before):
    prior = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(before)
    try:
        with llm.deterministic_algorithms():
            assert torch.are_deterministic_algorithms_enabled()
        assert torch.are_deterministic_algorithms_enabled() is before
        with contextlib.suppress(KeyError), llm.deterministic_algorithms():
            raise KeyError("inside")
        assert torch.are_deterministic_algorithms_enabled() is before
    finally:
        torch.use_deterministic_algorithms(prior)


@pytest.mark.parametrize("before", [False, True], ids=["off", "on"])
def test_deterministic_algorithms_interleaved_on_two_threads(before):
    """Two engines' steps on two threads, interleaved as the fault had them:
    A opens, B opens, A closes while B is still inside, B closes. The mode
    stays on until B closes and is the caller's again after it."""
    import threading

    prior = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(before)
    a_in, b_in, a_out, b_may_close = (threading.Event() for _ in range(4))
    seen = {}

    def engine_a():
        with llm.deterministic_algorithms():
            a_in.set()
            b_in.wait(10)
        a_out.set()

    def engine_b():
        a_in.wait(10)
        with llm.deterministic_algorithms():
            b_in.set()
            a_out.wait(10)
            seen["inside_b_after_a"] = torch.are_deterministic_algorithms_enabled()
            b_may_close.wait(10)

    try:
        threads = [threading.Thread(target=f) for f in (engine_a, engine_b)]
        for t in threads:
            t.start()
        a_out.wait(10)
        b_may_close.set()
        for t in threads:
            t.join(10)
        assert seen["inside_b_after_a"] is True
        assert torch.are_deterministic_algorithms_enabled() is before
        assert llm._deterministic_users == 0
    finally:
        torch.use_deterministic_algorithms(prior)


def test_cpu_server_leaves_deterministic_mode_alone():
    before = torch.are_deterministic_algorithms_enabled()
    srv = llm.LLMServer(device="cpu", num_blocks=32, cache_buckets=(32, 64))
    try:
        r = srv({"prompt": [1, 2, 3, 4, 5], "max_new_tokens": 3})
        assert len(r["tokens"]) == 3
    finally:
        srv.close()
    assert torch.are_deterministic_algorithms_enabled() is before
