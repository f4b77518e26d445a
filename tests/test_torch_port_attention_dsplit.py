"""Head_dims from 896 up, on the CPU: the dispatch tables' rule and the
port's flash forward and backward against the reference's Pallas kernels.

The reference's dispatcher runs its Pallas kernels at every head_dim that is
a multiple of 128, with no upper limit, where both lengths are multiples of
8 (``ray_tpu/ops/attention.py``'s ``dot_product_attention``). Past the wide
designs' 768 the port's tables take such a head_dim by their rule
(``dsplit_takes``, from ``DSPLIT_MIN_D`` = 896): the forward to ``dcluster``
(``csrc/flash_fwd_dcluster.cu``: d a runtime argument, the output's columns
split over the CTAs of a cluster that compute S once;
tests/test_torch_port_attention_dcluster_fwd.py) at 64 x 32 tiles, the
backward to ``dcluster`` (``csrc/flash_bwd_dcluster.cu``: the same split,
S and dP once; tests/test_torch_port_attention_dcluster.py), in bf16,
float16 and float32; where the lengths are not multiples of 8 they
take the reference's own route there, ``plain``. The kernels run only on the
card (``chip_smoke.py`` and the ``cuda``-marked tests of
``tests/test_torch_port_kernels.py`` hold them to their plain versions);
here the CPU path, which is their plain version at the design's tiles, is
held to ``_flash_attention_tpu(..., interpret=True)`` at the same tiles and
its backward to ``jax.grad`` of the reference's ``flash_attention`` in
interpret mode. Inputs are float32 numpy draws from a seed; the limits are
``FWD_ROW_TOL``, ``FWD_LSE_TOL`` and ``BWD_TOL`` for float32 (1e-4 of each
row's norm, lse 1e-4 absolute): the two sides differ by summation order
only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops import attention as ref
from ray_tpu.ops.attention import _flash_attention_tpu, flash_attention
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops.tolerance import BWD_TOL, FWD_LSE_TOL, FWD_ROW_TOL, row_err

DSPLIT = (896, 1024, 1152, 2048, 4096, 8192)
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
F32 = torch.float32
TILES = (64, 32)  # the dcluster forward's tiles, in every dtype

# (t_q, t_kv, causal), b=1 h=2, four length cases at the forward's tiles:
# causal square; q the suffix of a longer kv with a ragged q tile (40 rows)
# and a ragged last kv tile; rows that see no key (rows 0-47 of t_q 112
# against t_kv 64, in a q tile that runs kv tile 0); non-causal with ragged q
# and kv tiles. 1152 is 9 chunks of 128 columns (an odd count through the
# ring) and 4.5 column groups; 2048 on the causal square
CASES = [(128, 128, True), (40, 120, True), (112, 64, True), (104, 72, False)]
D_CASES = [(d, case) for d in (896, 1152) for case in CASES] + [(2048, CASES[0])]


def _ids(case):
    tq, tkv, causal = case
    return f"q{tq}-kv{tkv}-{'causal' if causal else 'full'}"


def _inputs(tq, tkv, d, seed):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(1, 2, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, 2, tkv, d).astype(np.float32) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", DSPLIT)
def test_tables_name_dsplit_by_their_rule(d, dtype):
    """(d, dtype) for d from 896 up is a key of both tables by their rule,
    not a row: ``dcluster`` for the forward (at its 64 x 32 tiles, which
    ``fwd_tiles`` gives, taking only a positive scale, which the wrapper
    hands it; the design since ``dsplit``'s forward, which
    ``flash_fwd_variants --dsplit`` still builds as the one before) and
    for dQ and dK/dV (the backward's design since ``dsplit``'s pair, which
    ``flash_bwd_variants --dsplit`` still builds so;
    tests/test_torch_port_attention_dcluster.py and
    tests/test_torch_port_attention_dcluster_fwd.py hold their plans),
    from sources that exist with the entry points the port binds; each
    counts its launches."""
    fwd, bwd = port.FWD_DESIGNS[(d, dtype)], port.BWD_DESIGNS[(d, dtype)]
    assert port.dsplit_takes(d, dtype)
    assert (d, dtype) in port.FWD_DESIGNS and (d, dtype) in port.BWD_DESIGNS
    assert port.FWD_DESIGNS.takes_by_rule((d, dtype)) and d not in port.HEAD_DIMS
    assert (d, dtype) not in set(port.FWD_DESIGNS) | set(port.BWD_DESIGNS)
    assert (fwd.name, fwd.source, fwd.entry) == ("dcluster", "flash_fwd_dcluster",
                                                 "ray_tpu_flash_fwd_dcluster")
    assert (fwd.block_q, fwd.block_k) == TILES == port.fwd_tiles(d, dtype)
    assert "dcluster" in port._POSITIVE_SCALE and not fwd.schedule
    assert port._TILES_ENTRIES["dcluster"] == "ray_tpu_flash_fwd_dcluster_tiles"
    assert "ray_tpu_flash_fwd_dsplit" in port._SOURCES["flash_fwd_dsplit"][0]
    assert [(kn.name, kn.source, kn.entry, kn.schedule) for kn in (bwd.dq, bwd.dkv)] == [
        ("dcluster", "flash_bwd_dcluster", "ray_tpu_flash_bwd_dq_dcluster", False),
        ("dcluster", "flash_bwd_dcluster", "ray_tpu_flash_bwd_dkv_dcluster", False)]
    assert "ray_tpu_flash_bwd_dq_dsplit" in port._SOURCES["flash_bwd_dsplit"][0]
    for source, entry in [(fwd.source, fwd.entry)] + [(kn.source, kn.entry) for kn in
                                                      (bwd.dq, bwd.dkv)]:
        assert (port._build.CSRC_DIR / f"{source}.cu").exists()
        assert entry in port._SOURCES[source][0]
    for name in ("flash_fwd_dcluster_launches", "flash_bwd_dq_dcluster_launches",
                 "flash_bwd_dkv_dcluster_launches"):
        assert isinstance(getattr(port, name), int)


def test_every_input_the_reference_sends_to_its_kernel_has_a_kernel():
    """For every head_dim the reference's Pallas kernel takes (64 and the
    multiples of 128 up to 8192) in bf16, float16 and float32, at lengths
    that are multiples of 8, both tables name a hand-written design (a row
    up to 768, the rule's ``dcluster`` from 896) and the plain version's
    input check does not refuse it; at lengths that are not, a key of the
    rule takes ``plain``, the reference's XLA route there. A multiple of 64
    that is not one of 128 (960) is no key: the reference takes XLA at
    every length."""
    for d in (64, *range(128, 8192 + 1, 128)):
        for dtype in DTYPES:
            meta = torch.empty(1, 1, 64, d, device="meta", dtype=dtype)
            assert port.reference_takes_kernel(d, 64, 64)
            for table in (port.FWD_DESIGNS, port.BWD_DESIGNS):
                assert (d, dtype) in table
                assert port._design(table, meta, 64) is not table.plain
                assert port._design(table, meta[:, :, :60], 60) is (
                    table.plain if d >= port.DSPLIT_MIN_D else table[(d, dtype)])
            port._check_plain_inputs(meta, meta, meta)
    assert (960, torch.bfloat16) not in port.FWD_DESIGNS
    assert not port.reference_takes_kernel(960, 64, 64)


@pytest.mark.parametrize("d, case", D_CASES, ids=[f"{d}-{_ids(c)}" for d, c in D_CASES])
def test_cpu_forward_and_backward_match_the_pallas_kernels(d, case):
    """The port's CPU path at the forward's tiles (its plain version) against the
    reference's Pallas forward at the same tiles, and the port's backward
    through ``dot_product_attention`` against ``jax.grad`` of the
    reference's ``flash_attention`` (interpret mode) under the same
    cotangent: every row of out, dq, dk and dv within 1e-4 of its own norm,
    lse within 1e-4."""
    tq, tkv, causal = case
    bq, bk = TILES
    q, k, v, g = _inputs(tq, tkv, d, seed=d + tq + tkv)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref_o, ref_lse = _flash_attention_tpu(jq, jk, jv, causal=causal, scale=scale,
                                          block_q=bq, block_k=bk, interpret=True)
    ref_grads = jax.grad(
        lambda *x: jnp.sum(flash_attention(*x, causal, scale, bq, bk, True) * jnp.asarray(g)),
        argnums=(0, 1, 2))(jq, jk, jv)

    tq_, tk_, tv_ = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    o, lse = port.flash_attention_fwd(*(t.detach() for t in (tq_, tk_, tv_)), causal=causal,
                                      scale=scale)
    assert row_err(o, torch.from_numpy(np.array(ref_o))) <= FWD_ROW_TOL[F32]
    assert float((lse - torch.from_numpy(np.array(ref_lse))).abs().max()) <= FWD_LSE_TOL[F32]
    out = port.dot_product_attention(tq_, tk_, tv_, causal=causal)
    assert torch.equal(out.detach(), o)
    out.backward(torch.from_numpy(g))
    for name, x, want in zip(("dq", "dk", "dv"), (tq_.grad, tk_.grad, tv_.grad), ref_grads):
        assert bool(torch.isfinite(x).all())
        err = row_err(x, torch.from_numpy(np.array(want)))
        assert err <= BWD_TOL[F32], f"{name}: worst row {err:.3e}"


@pytest.mark.parametrize("d", (896, 1152))
def test_dsplit_rows_that_see_no_key_follow_the_designs_tiles(d):
    """At t_q 160, t_kv 64 (causal) rows 0-95 see no key. With 64-row q
    tiles rows 0-63 lie in a q tile that skips every kv tile (0 and
    NEG_INF), and rows 64-95 share a q tile with rows that see keys, so it
    runs kv tile 0 (32 rows) and they get the mean of V over it (the flash
    convention at the design's tiles, which the Pallas kernel gives at the
    same tiles). bf16 inputs take the same plain version on the CPU."""
    q, k, v, _ = _inputs(160, 64, d, seed=3)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref_o, ref_lse = _flash_attention_tpu(jq, jk, jv, causal=True, scale=d ** -0.5,
                                          block_q=TILES[0], block_k=TILES[1], interpret=True)
    for dtype in (torch.bfloat16, F32):
        qt, kt, vt = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
        out, lse = port.flash_attention_fwd(qt, kt, vt, causal=True, scale=d ** -0.5)
        assert bool((out[..., :64, :] == 0).all())
        assert bool((lse[..., :64] == port.NEG_INF).all())
        mean_v = vt[:, :, :32].float().mean(dim=2, keepdim=True).expand(-1, -1, 32, -1)
        assert row_err(out[..., 64:96, :], mean_v.to(dtype)) <= FWD_ROW_TOL[dtype]
        assert bool(torch.isfinite(out[..., 96:, :]).all())
        if dtype == F32:
            assert row_err(out, torch.from_numpy(np.array(ref_o))) <= FWD_ROW_TOL[F32]


@pytest.mark.parametrize("dtype", (torch.bfloat16, F32), ids=str)
def test_lengths_not_multiples_of_8_take_the_references_xla_route(dtype):
    """At head_dim 896 with t = 60 the reference's dispatcher takes
    ``_attention_xla`` even on its accelerator, and so does the port: the
    plain design (``_attention_plain``), which counts nothing on the CPU.
    Out and dq, dk, dv against the reference's ``dot_product_attention``
    with its kernel asked for (it declines at these lengths) and its
    ``jax.grad``: bf16 rounds P to bf16 on both sides, in other orders (the
    bf16 limits); float32 within 1e-4 of each row's norm."""
    d = 896
    q, k, v, g = _inputs(60, 60, d, seed=11)
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    qj, kj, vj, gj = (jnp.asarray(x).astype(jd) for x in (q, k, v, g))

    def loss(q_, k_, v_):
        out = ref.dot_product_attention(q_, k_, v_, causal=True, use_pallas=True)
        return jnp.sum(out.astype(jnp.float32) * gj.astype(jnp.float32)), out

    (_, want), want_grads = jax.value_and_grad(loss, argnums=(0, 1, 2), has_aux=True)(qj, kj, vj)
    qt, kt, vt = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (q, k, v))
    assert port._design(port.FWD_DESIGNS, qt, 60) is port.FWD_DESIGNS.plain
    counters = [n for n in dir(port) if n.endswith("_launches")]
    before = [getattr(port, n) for n in counters]
    out = port.dot_product_attention(qt, kt, vt, causal=True)
    out.backward(torch.from_numpy(g).to(dtype))
    assert [getattr(port, n) for n in counters] == before
    plain = port._attention_plain(*(t.detach() for t in (qt, kt, vt)), causal=True,
                                  scale=d ** -0.5)
    assert torch.equal(out.detach(), plain)
    assert row_err(out.detach().float(),
                   torch.from_numpy(np.array(want.astype(jnp.float32)))) <= FWD_ROW_TOL[dtype]
    for x, w in zip((qt, kt, vt), want_grads):
        assert row_err(x.grad.float(), torch.from_numpy(np.array(w.astype(jnp.float32)))) <= (
            BWD_TOL[dtype])
