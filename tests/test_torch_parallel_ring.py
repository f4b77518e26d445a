"""ray_tpu_torch.ops.ring against ray_tpu.ops.ring, and the lse-differentiable
flash path against ``jax.grad`` of ``attention_with_lse``.

Inputs come from numpy seeds. The port's ring and Ulysses run on gloo ranks
(``launch.spawn``; each rank passes its block, the batch cut over dp, heads
over tp, the sequence over sp, and returns its blocks of the output and of
the gradients), the reference's ``sequence_parallel_attention`` on JAX's
virtual 8-device CPU mesh. This module imports no JAX at its top, so the
ranks do not load it. Tolerances, those of ``tests/test_ring.py``, in
float32: out atol 2e-5, rtol 1e-4; gradients atol 5e-5, rtol 1e-3 (the
port's blocks are the tiled flash algorithm, the reference's the full
softmax, and the merges add their rounding). In bfloat16 the gradients are
held row by row (``ops/tolerance.py``) to the exact ones, autograd in
float32 on the same inputs: the lse route to ``BWD_TOL`` once the rounding
of out in delta sits in the lse cotangent, and ring attention no further
from exact than the reference's ring or the port's own flash path (10%
margin).
"""

import functools

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention
from ray_tpu_torch.ops.tolerance import BWD_TOL, row_err
from ray_tpu_torch.parallel import launch
from ray_tpu_torch.parallel.mesh import AXIS_ORDER, MeshSpec

OUT_TOL = dict(atol=2e-5, rtol=1e-4)
GRAD_TOL = dict(atol=5e-5, rtol=1e-3)
# each case of the sp runs: sequence_parallel_attention's arguments; the
# last is Ulysses with use_pallas=False (the plain route on every rank)
SP_CASES = {"ring": dict(impl="ring"), "ulysses": dict(impl="ulysses"),
            "ulysses_use_pallas_false": dict(impl="ulysses", use_pallas=False)}


def _rand(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


# ---------------------------------------------------------------------------
# flash_attention_with_lse
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("t_q,t_kv", [(64, 64), (32, 96)], ids=["square", "suffix"])
def test_flash_attention_with_lse_grads_match_jax(causal, t_q, t_kv):
    """(out, lse) and the gradients of q, k, v under random cotangents of
    both, the CPU path (the plain forward and backward with delta - dlse)."""
    import jax
    import jax.numpy as jnp

    from ray_tpu.ops.attention import attention_with_lse as jax_attention_with_lse

    q, k, v = _rand((2, 3, t_q, 16), 0), _rand((2, 3, t_kv, 16), 1), _rand((2, 3, t_kv, 16), 2)
    do, dlse = _rand((2, 3, t_q, 16), 3), _rand((2, 3, t_q), 4)
    scale = 0.25
    (jo, jl), vjp = jax.vjp(
        lambda a, b, c: jax_attention_with_lse(a, b, c, causal=causal, scale=scale),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    jgrads = vjp((jnp.asarray(do), jnp.asarray(dlse)))

    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = attention.flash_attention_with_lse(tq, tk, tv, causal, scale)
    grads = torch.autograd.grad((out, lse), (tq, tk, tv),
                                (torch.from_numpy(do), torch.from_numpy(dlse)))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo), **OUT_TOL)
    np.testing.assert_allclose(lse.detach().numpy(), np.asarray(jl), **OUT_TOL)
    for name, got, want in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), err_msg=f"d{name}",
                                   **GRAD_TOL)


def test_lse_gradient_reaches_the_backward_as_delta():
    """With a zero gradient of out, the gradient is the lse term alone:
    dS = P * dlse, so dq = scale * (P * dlse) K."""
    q, k, v = (torch.from_numpy(_rand((1, 2, 16, 8), s)) for s in (5, 6, 7))
    dlse = torch.from_numpy(_rand((1, 2, 16), 8))
    o, lse = attention.flash_attention_fwd(q, k, v, causal=True, scale=0.5)
    dq, _, _ = attention.flash_attention_bwd(q, k, v, o, lse, torch.zeros_like(o),
                                             causal=True, scale=0.5, dlse=dlse)
    s = torch.einsum("bhqd,bhkd->bhqk", q, k) * 0.5
    s = torch.where(attention._causal_mask(16, 16, "cpu"), s, attention.NEG_INF)
    p = torch.softmax(s, -1)
    want = 0.5 * torch.einsum("bhqk,bhkd->bhqd", p * dlse[..., None], k)
    torch.testing.assert_close(dq, want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_flash_attention_with_lse_bf16_is_the_exact_gradient_of_its_route(causal):
    """bf16 through the CPU path, under random cotangents of out and lse:
    delta takes out rounded to bf16 (as every flash backward does), so the
    gradients are autograd's in float32 for the lse cotangent dlse +
    rowsum(dO * (out32 - out)), to the backward's tolerance; with dlse left
    out or turned in sign they are not."""
    q, k, v, do = (torch.from_numpy(_rand((1, 4, 256, 64), s)).bfloat16() for s in range(4))
    dlse = torch.from_numpy(_rand((1, 4, 256), 4))
    xs = [x.float().requires_grad_() for x in (q, k, v)]
    o32, lse32 = attention.attention_with_lse(*xs, causal=causal)
    out, lse = attention.flash_attention_fwd(q, k, v, causal=causal, scale=0.125)
    route = dlse + (do.float() * (o32.detach() - out.float())).sum(-1)
    exact = torch.autograd.grad((o32, lse32), xs, (do.float(), route))
    bq, bk, bv = (x.requires_grad_() for x in (q, k, v))
    got = torch.autograd.grad(attention.flash_attention_with_lse(bq, bk, bv, causal),
                              (bq, bk, bv), (do, dlse))
    for name, a, b in zip("qkv", got, exact):
        assert row_err(a, b) <= BWD_TOL[torch.bfloat16], f"d{name}"
    for wrong in (None, -dlse):
        dq = attention.flash_attention_bwd(q, k, v, out, lse, do, causal=causal,
                                           scale=0.125, dlse=wrong)[0]
        assert row_err(dq, exact[0]) > 10 * BWD_TOL[torch.bfloat16]


# ---------------------------------------------------------------------------
# ring and Ulysses on gloo ranks
# ---------------------------------------------------------------------------


def _attention_worker(rank, world, spec_kw, cases, q, k, v, dtype=torch.float32):
    """Each rank's blocks of out and of the gradients of sum(o * sin(o)),
    for each case of ``cases`` (``SP_CASES``' names), with its mesh
    coordinates; the inputs cast to ``dtype``, the results float32."""
    from ray_tpu_torch.ops.ring import sequence_parallel_attention
    from ray_tpu_torch.parallel.mesh import MeshGroups

    mesh = MeshSpec(**spec_kw).build("cpu")
    g = MeshGroups.build(mesh)
    b, h, t, _ = q.shape
    bl, hl, tl = b // g.batch_blocks, h // g.sizes["tp"], t // g.sizes["sp"]
    rows = slice(g.batch_index * bl, (g.batch_index + 1) * bl)
    heads = slice(g.coord["tp"] * hl, (g.coord["tp"] + 1) * hl)
    seq = slice(g.coord["sp"] * tl, (g.coord["sp"] + 1) * tl)
    out = {"coord": g.coord, "blocks": (rows, heads, seq)}
    for impl in cases:
        xs = [torch.from_numpy(x[rows, heads, seq].copy()).to(dtype).requires_grad_()
              for x in (q, k, v)]
        o = sequence_parallel_attention(*xs, mesh, **SP_CASES[impl]).float()
        grads = torch.autograd.grad((o * torch.sin(o)).sum(), xs)
        out[impl] = [o.detach().numpy()] + [x.float().numpy() for x in grads]
    return out


def _assemble(results, impl, shape):
    """Global out, dq, dk, dv from the ranks' blocks."""
    full = [np.zeros(shape, np.float32) for _ in range(4)]
    for r in results:
        for arr, block in zip(full, r[impl]):
            arr[r["blocks"]] = block
    return full


def _jax_reference(q, k, v, sp, tp=1, dp=1, impl="ring", dtype=np.float32):
    """The reference's out and q, k, v gradients of sum(o * sin(o)) through
    its ``sequence_parallel_attention`` on a dp x tp x sp mesh (``impl`` a
    case of ``SP_CASES``), the inputs cast to ``dtype``, the results
    float32."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from ray_tpu.ops.ring import sequence_parallel_attention

    devs = np.array(jax.devices()[: dp * tp * sp]).reshape(dp, 1, tp, sp)
    mesh = Mesh(devs, ("dp", "fsdp", "tp", "sp"))

    def loss(a, b, c):
        o = sequence_parallel_attention(a, b, c, mesh, **SP_CASES[impl]).astype(jnp.float32)
        return jnp.sum(o * jnp.sin(o)), o

    (_, o), grads = jax.jit(jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True))(
        *(jnp.asarray(x).astype(dtype) for x in (q, k, v)))
    return [np.asarray(o)] + [np.asarray(x.astype(jnp.float32)) for x in grads]


def _sp_worker(rank, world, q, k, v, q16, k16, v16):
    """Ring and Ulysses (the flash route and use_pallas=False) at sp 2 (dp
    2) and at sp 4 in float32, and ring at both in bfloat16 (key ("bf16",
    sp)), on one start of 4 ranks."""
    out = {sp: _attention_worker(rank, world, dict(dp=4 // sp, sp=sp), tuple(SP_CASES),
                                 q, k, v) for sp in (2, 4)}
    out.update({("bf16", sp): _attention_worker(rank, world, dict(dp=4 // sp, sp=sp),
                                                ("ring",), q16, k16, v16, torch.bfloat16)
                for sp in (2, 4)})
    return out


def _bf16_inputs():
    """q, k, v of the bfloat16 cases (float32 arrays of bf16 values)."""
    return [torch.from_numpy(_rand((2, 4, 256, 64), s)).bfloat16().float().numpy()
            for s in (10, 11, 12)]


@pytest.fixture(scope="module")
def sp_runs():
    """The port's ring and Ulysses at sp 2 (dp 2) and sp 4 on 4 ranks, and
    its bfloat16 ring at both."""
    q, k, v = (_rand((2, 4, 64, 32), s) for s in (0, 1, 2))
    q16, k16, v16 = _bf16_inputs()
    res = launch.spawn(functools.partial(_sp_worker, q=q, k=k, v=v, q16=q16, k16=k16,
                                         v16=v16), 4, device="cpu", timeout=240)
    runs = {(impl, sp): _assemble([r[sp] for r in res], impl, q.shape)
            for sp in (2, 4) for impl in SP_CASES}
    runs.update({("bf16", sp): _assemble([r["bf16", sp] for r in res], "ring", q16.shape)
                 for sp in (2, 4)})
    return (q, k, v), runs


@pytest.mark.parametrize("impl", list(SP_CASES))
@pytest.mark.parametrize("sp", [2, 4])
def test_seq_parallel_matches_jax(sp_runs, impl, sp):
    (q, k, v), runs = sp_runs
    want = _jax_reference(q, k, v, sp, impl=impl)
    got = runs[impl, sp]
    np.testing.assert_allclose(got[0], want[0], err_msg="out", **OUT_TOL)
    for name, a, b in zip("qkv", got[1:], want[1:]):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **GRAD_TOL)


@pytest.mark.parametrize("sp", [2, 4])
def test_ring_bf16_gradients_no_further_from_exact_than_the_references(sp_runs, sp):
    """bfloat16 ring attention: every hop's backward takes delta - dlse with
    delta from the hop's bf16 out, but through the merge that rounding
    cancels (the hop's dlse carries the same out), so the ring's gradients
    are as far from the exact ones as the port's flash path on the whole
    sequence (sp == 1), and no further than the reference's bf16 ring."""
    import jax.numpy as jnp

    _, runs = sp_runs
    q, k, v = (torch.from_numpy(x) for x in _bf16_inputs())
    xs = [x.clone().requires_grad_() for x in (q, k, v)]
    o, _ = attention.attention_with_lse(*xs, causal=True)
    exact = torch.autograd.grad((o * torch.sin(o)).sum(), xs)
    xs = [x.bfloat16().requires_grad_() for x in (q, k, v)]
    o = attention.dot_product_attention(*xs, causal=True).float()
    flash = torch.autograd.grad((o * torch.sin(o)).sum(), xs)
    ref = _jax_reference(q.numpy(), k.numpy(), v.numpy(), sp, dp=4 // sp, dtype=jnp.bfloat16)
    for i, name in enumerate("qkv"):
        got = row_err(torch.from_numpy(runs["bf16", sp][1 + i]), exact[i])
        limit = 1.1 * max(row_err(flash[i], exact[i]),
                          row_err(torch.tensor(ref[1 + i]), exact[i]))
        assert got <= limit, f"d{name}: {got} > {limit}"


def test_seq_parallel_with_tp_and_dp():
    """dp 2 x tp 2 x sp 2 on 8 ranks: batch, heads and sequence all cut."""
    q, k, v = (_rand((4, 4, 32, 16), s) for s in (0, 1, 2))
    res = launch.spawn(functools.partial(
        _attention_worker, spec_kw=dict(dp=2, sp=2, tp=2), cases=("ring", "ulysses"),
        q=q, k=k, v=v), 8, device="cpu", timeout=240)
    assert sorted(tuple(r["coord"][a] for a in AXIS_ORDER) for r in res) == sorted(
        (d, 0, 0, 0, s, t) for d in range(2) for s in range(2) for t in range(2))
    for impl in ("ring", "ulysses"):
        got = _assemble(res, impl, q.shape)
        want = _jax_reference(q, k, v, 2, tp=2, dp=2, impl=impl)
        np.testing.assert_allclose(got[0], want[0], err_msg=f"{impl} out", **OUT_TOL)
        for name, a, b in zip("qkv", got[1:], want[1:]):
            np.testing.assert_allclose(a, b, err_msg=f"{impl} d{name}", **GRAD_TOL)
