"""The dispatcher against ray_tpu.ops.attention on the CPU, where it takes
what the reference computes beyond the kernels' first inputs.

Every (head_dim, dtype) that no hand-written kernel takes goes to the
``plain`` design of ``FWD_DESIGNS`` and ``BWD_DESIGNS``: the reference's own
route for the input. float16 at head_dim 64, 128 and 256 runs the bf16
kernels' float16 builds on the card, whose CPU path is their plain version;
a non-positive scale runs the kernels too, the forward's sign handed to q.
These tests hold the CPU path to the reference's ``dot_product_attention``
(which on the CPU takes ``_attention_xla``) and its ``jax.grad``, from the
same numpy inputs made from a seed:

* head_dim 48 and 80 in bfloat16 and float32, and 16 in float16, where the
  reference's gate sends every input to ``_attention_xla`` on any device:
  the port computes ``_attention_plain`` and its autograd. float32: the two
  sides sum in other orders (``FWD_ROW_TOL`` / ``BWD_TOL`` float32, 1e-4 of
  each row's norm). bfloat16: both round P to bf16 before P V and the
  einsums' results to bf16, in other orders (the bf16 limits, 2e-2 of each
  row's norm). float16: as bfloat16, at 2^-11 (``F16_VS_REF_*``).
* head_dim 64 in float16, where the reference on its accelerator takes its
  flash kernel and the port the d64 and wgmma kernels: on the CPU the port
  computes ``flash_attention_fwd_plain`` at the kernel's 128 x 128 tiles and
  ``flash_attention_bwd_plain``; the reference on the CPU rounds P and dP
  to float16 inside ``_attention_xla`` where the flash route keeps float32
  (2^-11 relative each; the backward's dP - delta cancels, which the row
  limit of ``F16_VS_REF_BWD`` allows).

The card runs these cases in tests/test_torch_port_kernels.py
(``cuda``-marked) against this CPU path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as ref
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops.tolerance import BWD_TOL, FWD_ROW_TOL, row_err

# the float16 flash route against the reference's float16 XLA route: P and
# dP rounded to float16 on one side only (2^-11 relative each); in the
# backward dS = P (dP - delta) cancels, so a row's error is a few times that
# (read 5.5e-4 on the forward and 2.9e-3 on the gradients here)
F16_VS_REF_FWD = 5e-3
F16_VS_REF_BWD = 1e-2
# lse of the flash route against the logsumexp of the reference's float32
# scores: summation order only
LSE_ATOL = 1e-4

_JAX_DTYPES = {torch.bfloat16: jnp.bfloat16, torch.float32: jnp.float32,
               torch.float16: jnp.float16}

# (b, h, t_q, t_kv, d, causal, dtype): head_dims 48 and 80 in both dtypes
# (causal, q the suffix of kv, non-causal, ragged lengths), head_dim 64 in
# float16 (lengths that are multiples of 8: the reference's kernel route),
# head_dim 16 in float16 (the plain design)
CASES = [
    (2, 2, 64, 64, 48, True, torch.bfloat16),
    (1, 2, 40, 72, 48, True, torch.float32),
    (1, 2, 56, 56, 80, False, torch.bfloat16),
    (2, 1, 64, 64, 80, True, torch.float32),
    (1, 2, 24, 40, 48, True, torch.bfloat16),
    (2, 2, 64, 64, 64, True, torch.float16),
    (1, 2, 64, 128, 64, True, torch.float16),
    (2, 2, 64, 64, 16, True, torch.float16),
]


def _ids(case):
    b, h, tq, tkv, d, causal, dtype = case
    return (f"{b}x{h}-q{tq}-kv{tkv}-d{d}-{'causal' if causal else 'full'}-"
            f"{str(dtype).replace('torch.', '')}")


def _inputs(b, h, tq, tkv, d, seed=0):
    rng = np.random.RandomState(seed)
    return [rng.randn(b, h, t, d).astype(np.float32) for t in (tq, tkv, tkv, tq)]


def _reference(q, k, v, g, causal, dtype):
    """The reference's out and (dq, dk, dv) under the cotangent g, in
    float32."""
    jd = _JAX_DTYPES[dtype]
    qj, kj, vj, gj = (jnp.asarray(x).astype(jd) for x in (q, k, v, g))

    def loss(q_, k_, v_):
        out = ref.dot_product_attention(q_, k_, v_, causal=causal)
        return jnp.sum(out.astype(jnp.float32) * gj.astype(jnp.float32)), out

    (_, out), grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(qj, kj, vj)
    return (np.array(out.astype(jnp.float32)),
            [np.array(x.astype(jnp.float32)) for x in grads])


def _port(q, k, v, g, causal, dtype):
    """The port's out and (dq, dk, dv) through ``dot_product_attention`` on
    the CPU, in float32, and the launch counters' change (none)."""
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    counters = [n for n in dir(port) if n.endswith("_launches")]
    before = [getattr(port, n) for n in counters]
    out = port.dot_product_attention(qt, kt, vt, causal=causal)
    out.backward(torch.from_numpy(g).to(dtype))
    assert [getattr(port, n) for n in counters] == before  # the CPU counts nothing
    assert out.dtype == dtype and qt.grad.dtype == dtype
    return out.detach().float(), [t.grad.float() for t in (qt, kt, vt)]


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_design_matches_the_reference(case):
    """Out and dq, dk, dv of the port's dispatcher on the CPU (the plain
    design's function; at float16 head_dim 64 the d64 kernels' plain
    versions) against the reference's dot_product_attention and its
    gradients, every row within the case's limit."""
    b, h, tq, tkv, d, causal, dtype = case
    q, k, v, g = _inputs(b, h, tq, tkv, d)
    want_fwd, want_bwd = ((port.FWD_DESIGNS.plain, port.BWD_DESIGNS.plain) if d != 64 else
                          (port.FWD_DESIGNS[(64, torch.bfloat16)],
                           port.BWD_DESIGNS[(64, torch.bfloat16)]))
    assert port.FWD_DESIGNS[(d, dtype)] is want_fwd
    assert port.BWD_DESIGNS[(d, dtype)] is want_bwd
    want_out, want_grads = _reference(q, k, v, g, causal, dtype)
    got_out, got_grads = _port(q, k, v, g, causal, dtype)
    fwd_tol = F16_VS_REF_FWD if dtype == torch.float16 else FWD_ROW_TOL[dtype]
    bwd_tol = F16_VS_REF_BWD if dtype == torch.float16 else BWD_TOL[dtype]
    assert row_err(got_out, torch.from_numpy(want_out)) <= fwd_tol
    for name, got, want in zip(("dq", "dk", "dv"), got_grads, want_grads):
        err = row_err(got, torch.from_numpy(want))
        assert err <= bwd_tol, f"{name}: worst-row error {err} > {bwd_tol}"


@pytest.mark.parametrize("d, dtype", [(48, torch.float32), (64, torch.float16)])
def test_plain_design_lse_matches_the_reference(d, dtype):
    """``flash_attention_with_lse`` on the CPU: out against the reference's
    attention_with_lse (q the suffix of kv) and lse within LSE_ATOL of its
    logsumexp, on both routes (the plain design's XLA route at head_dim 48,
    the d64 design's flash forward at 64 in float16)."""
    q, k, v, _ = _inputs(1, 2, 64, 96, d, seed=3)
    jd = _JAX_DTYPES[dtype]
    want_out, want_lse = ref.attention_with_lse(
        *(jnp.asarray(x).astype(jd) for x in (q, k, v)), causal=True)
    out, lse = port.flash_attention_with_lse(*(torch.from_numpy(x).to(dtype) for x in (q, k, v)),
                                             causal=True)
    tol = F16_VS_REF_FWD if dtype == torch.float16 else FWD_ROW_TOL[dtype]
    assert row_err(out.float(), torch.from_numpy(np.array(want_out.astype(jnp.float32)))) <= tol
    np.testing.assert_allclose(lse.numpy(), np.asarray(want_lse), atol=LSE_ATOL, rtol=0)


@pytest.mark.parametrize("d, scale", [(64, -0.125), (16, 0.0)])
def test_non_positive_scale_takes_the_plain_design(d, scale):
    """A non-positive scale stays on the bf16 design of its head_dim (whose
    forward kernel takes a positive one, so the wrapper gives it the same
    scores, ``test_positive_scale_gives_the_kernel_the_same_scores``); on
    the CPU that design's plain version matches the reference at that
    scale, at head_dim 64 (the reference's kernel route) and 16 (its XLA
    route)."""
    assert port.FWD_DESIGNS[(d, torch.bfloat16)].name in port._POSITIVE_SCALE
    q, k, v, g = _inputs(1, 2, 64, 64, d, seed=5)
    qj, kj, vj = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = ref.dot_product_attention(qj, kj, vj, causal=True, scale=scale)
    got = port.dot_product_attention(*(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
                                     causal=True, scale=scale)
    assert row_err(got.float(), torch.from_numpy(np.array(want.astype(jnp.float32)))) <= (
        FWD_ROW_TOL[torch.bfloat16])


@pytest.mark.parametrize("scale", [-0.125, 0.0, 0.5])
def test_positive_scale_gives_the_kernel_the_same_scores(scale):
    """``_positive_scale`` hands the forward kernels a positive scale with
    the same scores, exactly: the plain forward of (q', scale') equals that
    of (q, scale) bit for bit, and a positive scale passes as it is."""
    q, k, v, _ = _inputs(1, 2, 64, 96, 64, seed=7)
    q, k, v = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    q2, scale2 = port._positive_scale(q, scale)
    assert scale2 > 0 and (q2 is q) == (scale > 0)
    for a, b in zip(port.flash_attention_fwd_plain(q2, k, v, causal=True, scale=scale2),
                    port.flash_attention_fwd_plain(q, k, v, causal=True, scale=scale)):
        assert torch.equal(a, b)


def test_plain_design_is_a_table_row_with_counters():
    """Both tables name a ``plain`` design for every key they do not hold
    (head_dims outside HEAD_DIMS that their rule does not take, float16 at
    16 and 32), with no source; each of its kernels has its launch counter;
    the flash route repeats the reference's 512 x 512 tiles. The
    reference's 896 and 1024 are the rule's (``dsplit`` forward, ``dcluster``
    backward), by which every
    head_dim the reference sends to its kernel has one, so off the CPU the
    plain design computes only where the reference takes ``_attention_xla``,
    and raises only for a dtype that no kernel takes (float64), at 896 on
    lengths that are multiples of 8 as at 128."""
    plain_f, plain_b = port.FWD_DESIGNS.plain, port.BWD_DESIGNS.plain
    assert (plain_f.name, plain_f.source, plain_f.schedule) == ("plain", None, False)
    assert (plain_f.block_q, plain_f.block_k) == (port.REF_BLOCK, port.REF_BLOCK) == (512, 512)
    assert {(kn.name, kn.source) for kn in (plain_b.dq, plain_b.dkv)} == {("plain", None)}
    meta = [torch.empty(1, 1, 64, d, device="meta") for d in (896, 48)]
    port._check_plain_inputs(meta[0], meta[0], meta[0])
    port._check_plain_inputs(meta[1], meta[1], meta[1])
    port._check_plain_inputs(*(torch.empty(1, 1, 60, 896, device="meta"),) * 3)
    for d in (896, 128):
        wide = torch.empty(1, 1, 64, d, device="meta", dtype=torch.float64)
        with pytest.raises(ValueError, match="no Hopper kernel takes torch.float64"):
            port._check_plain_inputs(wide, wide, wide)
    for key in [(48, torch.bfloat16), (80, torch.float32), (32, torch.float16),
                (960, torch.bfloat16), (1000, torch.float32), (16, torch.float16)]:
        assert key not in port.FWD_DESIGNS and key not in port.BWD_DESIGNS
        assert port.FWD_DESIGNS[key] is plain_f and port.BWD_DESIGNS[key] is plain_b
    for key in [(896, torch.bfloat16), (1024, torch.float32)]:
        assert key in port.FWD_DESIGNS and key in port.BWD_DESIGNS
        assert port.FWD_DESIGNS[key].name == "dsplit"
        assert port.BWD_DESIGNS[key].dq.name == port.BWD_DESIGNS[key].dkv.name == "dcluster"
    for name in ("flash_fwd_plain_launches", "flash_bwd_dq_plain_launches",
                 "flash_bwd_dkv_plain_launches"):
        assert isinstance(getattr(port, name), int)
    assert port.reference_takes_kernel(64, 64, 128) and port.reference_takes_kernel(896, 8, 8)
    assert not port.reference_takes_kernel(48, 64, 64)
    assert not port.reference_takes_kernel(64, 60, 64)


def test_kernel_input_check_holds_no_shared_head_limit():
    """The b * h limit is each launcher's, not one check for every design:
    ``_check_kernel_inputs`` holds none, the designs carry none, and the
    tf32x3 launchers run 65535 heads a launch (grid.y) and so take any
    b * h."""
    import dataclasses
    import inspect

    src = inspect.getsource(port._check_kernel_inputs)
    assert "65535" not in src and "b * h" not in src
    for cls in (port.FwdDesign, port.BwdKernel):
        assert not any("grid" in f.name for f in dataclasses.fields(cls))
    for name in ("flash_fwd_f32", "flash_bwd_f32"):
        text = (port._build.CSRC_DIR / f"{name}.cu").read_text()
        assert "65535" in text
