"""The port's flash backward against the TPU backward kernels on the CPU.

The same numpy inputs go through ``ray_tpu.ops.attention`` (the Pallas
kernels in interpret mode, at tiles of 64 as the port's kernels use) and
through ``ray_tpu_torch.ops.attention``: the plain backward
``flash_attention_bwd_plain`` against ``_flash_attention_tpu_bwd``, and the
``FlashAttention`` Function's gradients against ``jax.grad`` of the
reference's ``flash_attention`` custom_vjp. All in float32. Tolerance:
atol 5e-5, rtol 1e-4 (the two sides sum in other orders: the reference by
64-wide tiles, the plain version over whole rows). The CUDA kernels are held
against the plain version on the card in tests/test_torch_port_kernels.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import (
    _flash_attention_tpu,
    _flash_attention_tpu_bwd,
    flash_attention,
)
from ray_tpu_torch.ops import attention as port

from test_torch_port_attention import CASES, _ids

GRAD_TOL = dict(atol=5e-5, rtol=1e-4)
TILE = 64


def _inputs(case, seed=0):
    b, h, tq, tkv, d, _ = case
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k = rng.randn(b, h, tkv, d).astype(np.float32)
    v = rng.randn(b, h, tkv, d).astype(np.float32)
    g = rng.randn(b, h, tq, d).astype(np.float32)
    return q, k, v, g


@functools.lru_cache(maxsize=None)
def _jax_reference(case):
    """(o, lse, (dq, dk, dv)) of the Pallas kernels in interpret mode."""
    causal, d = case[5], case[4]
    q, k, v, g = (jnp.asarray(a) for a in _inputs(case))
    scale = 1.0 / d ** 0.5
    o, lse = _flash_attention_tpu(q, k, v, causal=causal, scale=scale,
                                  block_q=TILE, block_k=TILE, interpret=True)
    grads = _flash_attention_tpu_bwd(q, k, v, o, lse, g, causal=causal,
                                     scale=scale, block_q=TILE, block_k=TILE,
                                     interpret=True)
    return np.array(o), np.array(lse), tuple(np.array(x) for x in grads)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_bwd_plain_matches_pallas_kernels(case):
    """dq, dk, dv of the plain backward against the dQ and dK/dV kernels,
    given the same forward out and lse."""
    causal, d = case[5], case[4]
    q, k, v, g = _inputs(case)
    o, lse, ref = _jax_reference(case)
    got = port.flash_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, o, lse, g)),
        causal=causal, scale=1.0 / d ** 0.5)
    for name, x, want in zip(("dq", "dk", "dv"), got, ref):
        assert x.dtype == torch.float32
        np.testing.assert_allclose(x.numpy(), want, err_msg=name, **GRAD_TOL)


# the wgmma backward's shapes: t_q > t_kv at head_dim 64, three full 128-row
# q tiles non-causal, and a causal diagonal crossing 128-row tiles
WGMMA_CASES = [(1, 2, 160, 64, 64, True), (2, 2, 384, 384, 128, False),
               (1, 2, 256, 256, 128, True)]


@pytest.mark.parametrize("case", WGMMA_CASES, ids=_ids)
def test_bwd_plain_matches_pallas_kernels_at_wgmma_tiles(case):
    """The wgmma backward kernels cut the work into 128-row tiles: the Pallas
    kernels at 128 x 128 tiles give the plain backward's dq, dk and dv too,
    so the plain version holds kernels of either tiling."""
    causal, d = case[5], case[4]
    q, k, v, g = _inputs(case)
    scale = 1.0 / d ** 0.5
    jq, jk, jv, jg = (jnp.asarray(a) for a in (q, k, v, g))
    o, lse = _flash_attention_tpu(jq, jk, jv, causal=causal, scale=scale,
                                  block_q=128, block_k=128, interpret=True)
    ref = _flash_attention_tpu_bwd(jq, jk, jv, o, lse, jg, causal=causal, scale=scale,
                                   block_q=128, block_k=128, interpret=True)
    got = port.flash_attention_bwd_plain(
        *(torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, g)),
        causal=causal, scale=scale)
    for name, x, want in zip(("dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(x.numpy(), np.array(want), err_msg=name, **GRAD_TOL)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_function_grads_match_jax_grad(case):
    """Gradients through ``dot_product_attention`` (the ``FlashAttention``
    Function, plain versions on the CPU) against ``jax.grad`` of the
    reference's ``flash_attention`` in interpret mode, cotangent g."""
    causal, d = case[5], case[4]
    q, k, v, g = _inputs(case)
    scale = 1.0 / d ** 0.5

    def loss(q_, k_, v_):
        out = flash_attention(q_, k_, v_, causal, scale, TILE, TILE, True)
        return jnp.sum(out * jnp.asarray(g))

    ref = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = port.dot_product_attention(qt, kt, vt, causal=causal, scale=scale)
    assert out.grad_fn is not None and "FlashAttention" in type(out.grad_fn).__name__
    out.backward(torch.from_numpy(g))
    for name, t, want in zip(("dq", "dk", "dv"), (qt, kt, vt), ref):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(want), err_msg=name,
                                   **GRAD_TOL)


def test_rows_that_see_no_key_get_zero_dq():
    """Causal t_q > t_kv: the guard gives dq = 0 on the leading rows (whose
    lse is the NEG_INF sentinel), as the TPU kernel does, though the forward
    gave some of them the mean of V."""
    case = (1, 1, 160, 64, 128, True)
    q, k, v, g = _inputs(case)
    o, lse, ref = _jax_reference(case)
    assert np.all(lse[0, 0, :96] <= port.NEG_INF / 2)
    dq, _, _ = port.flash_attention_bwd_plain(
        *(torch.from_numpy(a) for a in (q, k, v, o, lse, g)), causal=True,
        scale=1.0 / 128 ** 0.5)
    assert torch.all(dq[0, 0, :96] == 0) and np.all(ref[0][0, 0, :96] == 0)
    assert torch.all(dq[0, 0, 96:].abs().sum(-1) > 0)


def test_bwd_wrapper_on_cpu_takes_the_plain_version():
    case = (1, 2, 96, 136, 64, True)
    q, k, v, o, lse, g = (torch.from_numpy(a) for a in
                          (*_inputs(case)[:3], *_jax_reference(case)[:2],
                           _inputs(case)[3]))
    before = (port.flash_bwd_dq_launches, port.flash_bwd_dkv_launches)
    got = port.flash_attention_bwd(q, k, v, o, lse, g, causal=True, scale=0.125)
    want = port.flash_attention_bwd_plain(q, k, v, o, lse, g, causal=True,
                                          scale=0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (port.flash_bwd_dq_launches, port.flash_bwd_dkv_launches) == before


def test_flash_function_backward_takes_a_non_contiguous_gradient():
    """The model hands the Function a gradient through a transpose; the
    backward makes it contiguous before the wrapper sees it."""
    q, k, v, _ = _inputs((1, 2, 40, 40, 16, True), seed=3)
    qt, kt, vt = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    out = port.dot_product_attention(qt, kt, vt, causal=True)
    w = torch.randn(1, 40, 2, 16, generator=torch.Generator().manual_seed(0))
    (out.transpose(1, 2) * w).sum().backward()
    want = port.flash_attention_bwd_plain(
        qt.detach(), kt.detach(), vt.detach(), out.detach(),
        port.flash_attention_fwd_plain(qt.detach(), kt.detach(), vt.detach(),
                                       causal=True, scale=0.25)[1],
        w.transpose(1, 2).contiguous(), causal=True, scale=0.25)
    for t, x in zip((qt, kt, vt), want):
        torch.testing.assert_close(t.grad, x, atol=1e-6, rtol=1e-6)
