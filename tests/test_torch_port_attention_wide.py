"""Head_dims 384 to 768, on the CPU: the dispatch tables and the port's
flash forward and backward against the reference's Pallas kernels.

The reference's dispatcher runs its Pallas kernels at every head_dim that is
a multiple of 128 (``ray_tpu/ops/attention.py``'s ``dot_product_attention``).
At 384, 512, 640 and 768 the port's forward table names ``dcluster128``
(``csrc/flash_fwd_dcluster128.cu``,
tests/test_torch_port_attention_wide_fwd.py) in every dtype, at 64 x 32
tiles, and the backward's ``wide`` (``csrc/flash_bwd_wide.cu``) for bf16 and
float16 and ``dcluster128`` (``csrc/flash_bwd_dcluster128.cu``,
tests/test_torch_port_attention_f32_cluster.py) for float32. Past 768 the
wide dK/dV kernel spills and the float32 dQ's tiles pass the shared memory,
so 896 and up take the tables' rule, ``dcluster`` for the forward and
the backward (tests/test_torch_port_attention_dsplit.py,
tests/test_torch_port_attention_dcluster.py,
tests/test_torch_port_attention_dcluster_fwd.py), and run a kernel on the card
too. The kernels run only on the card (``chip_smoke.py`` and the
``cuda``-marked tests of ``tests/test_torch_port_kernels.py`` hold them to
their plain versions); here the CPU path, which is their plain version at
the design's tiles, is held to ``_flash_attention_tpu(..., interpret=True)``
at the same tiles and its backward to ``jax.grad`` of the reference's
``flash_attention`` in interpret mode. Inputs are float32 numpy draws from a
seed; the limits are ``FWD_ROW_TOL``, ``FWD_LSE_TOL`` and ``BWD_TOL`` for
float32 (1e-4 of each row's norm, lse 1e-4 absolute): the two sides differ
by summation order only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import _flash_attention_tpu, flash_attention
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops.tolerance import BWD_TOL, FWD_LSE_TOL, FWD_ROW_TOL, row_err

WIDE = (384, 512, 640, 768)
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
F32 = torch.float32
# the forward's tiles by head_dim: dcluster128's, in bf16 and float16 and in
# float32
TILES = {384: (64, 32), 512: (64, 32), 640: (64, 32), 768: (64, 32)}
F32_TILES = {384: (64, 32), 512: (64, 32), 640: (64, 32), 768: (64, 32)}

# (t_q, t_kv, causal), b=1 h=2: causal square; q the suffix of a longer kv
# with a ragged q tile; rows that see no key (t_q > t_kv: rows 0-47, which
# lie in the first 64-row q tile, which runs kv tile 0); non-causal with
# ragged q and kv tiles. At 640 the rows that see no key, at 768 the suffix
CASES = [(128, 128, True), (40, 120, True), (112, 64, True), (104, 72, False)]
D_CASES = [(d, case) for d in (384, 512) for case in CASES] + [
    (640, CASES[2]), (768, CASES[1])]


def _ids(case):
    tq, tkv, causal = case
    return f"q{tq}-kv{tkv}-{'causal' if causal else 'full'}"


def _inputs(tq, tkv, d, seed):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(1, 2, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, 2, tkv, d).astype(np.float32) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", WIDE)
def test_tables_name_the_wide_designs(d, dtype):
    """(384 | 512 | 640 | 768, dtype) is held by both tables: every dtype's
    forward on ``dcluster128`` at its 64 x 32 tiles, taking only a positive
    scale (the wrapper hands a non-positive one's sign to q); bf16 and
    float16 on ``wide``'s dQ and dK/dV entries, float32 on
    ``dcluster128``'s. Each design counts its launches."""
    fwd, bwd = port.FWD_DESIGNS[(d, dtype)], port.BWD_DESIGNS[(d, dtype)]
    assert (d, dtype) in port.FWD_DESIGNS and (d, dtype) in port.BWD_DESIGNS
    assert d in port.HEAD_DIMS and d in port.WIDE_HEAD_DIMS
    tiles = F32_TILES[d] if dtype == F32 else TILES[d]
    assert (fwd.block_q, fwd.block_k) == tiles == port.fwd_tiles(d, dtype)
    assert (fwd.name, fwd.source, fwd.entry) == ("dcluster128", "flash_fwd_dcluster128",
                                                 "ray_tpu_flash_fwd_dcluster128")
    assert "dcluster128" in port._POSITIVE_SCALE and not fwd.schedule
    assert port._TILES_ENTRIES["dcluster128"] == "ray_tpu_flash_fwd_dcluster128_tiles"
    if dtype == F32:
        want = [("dcluster128", "flash_bwd_dcluster128", "ray_tpu_flash_bwd_dq_dcluster128"),
                ("dcluster128", "flash_bwd_dcluster128", "ray_tpu_flash_bwd_dkv_dcluster128")]
    else:
        want = [("wide", "flash_bwd_wide", "ray_tpu_flash_bwd_dq_wide"),
                ("wide", "flash_bwd_wide", "ray_tpu_flash_bwd_dkv_wide")]
    assert [(kn.name, kn.source, kn.entry) for kn in (bwd.dq, bwd.dkv)] == want
    for source, entry in [(fwd.source, fwd.entry)] + [(kn.source, kn.entry) for kn in
                                                      (bwd.dq, bwd.dkv)]:
        assert (port._build.CSRC_DIR / f"{source}.cu").exists()
        assert entry in port._SOURCES[source][0]
    for name in (f"flash_fwd_{fwd.name}_launches", f"flash_bwd_dq_{bwd.dq.name}_launches",
                 f"flash_bwd_dkv_{bwd.dkv.name}_launches"):
        assert isinstance(getattr(port, name), int)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_first_head_dim_past_the_designs_is_plain_and_raises_off_the_cpu(dtype):
    """896, the first multiple of 128 past the wide designs' 768, is no
    row of the tables but their rule's: ``dcluster`` for the forward and
    the backward, which off the
    CPU launches its kernels (here the meta device, where the kernels' own
    input check answers "needs CUDA", as at 384 to 768) instead of raising
    for want of a kernel. The plain design is left at 896 only for lengths
    that are not multiples of 8 (the reference's XLA route, which it
    computes off the CPU) and for a dtype that no kernel takes, which
    raises off the CPU where the reference takes its kernel; on the CPU 896
    computes at dcluster's tiles."""
    assert port.WIDE_HEAD_DIMS == WIDE and port.DSPLIT_MIN_D == 896
    assert (896, dtype) in port.FWD_DESIGNS and (896, dtype) in port.BWD_DESIGNS
    assert 896 not in {d for d, _ in port.FWD_DESIGNS}  # a key of the rule, not a row
    assert port.FWD_DESIGNS[(896, dtype)].name == "dcluster"
    assert (port.BWD_DESIGNS[(896, dtype)].dq.name,
            port.BWD_DESIGNS[(896, dtype)].dkv.name) == ("dcluster", "dcluster")
    for d in (*WIDE, 896):
        meta = torch.empty(1, 1, 64, d, device="meta", dtype=dtype)
        assert port.FWD_DESIGNS[(d, dtype)] is not port.FWD_DESIGNS.plain
        port._check_plain_inputs(meta, meta, meta)
        with pytest.raises(ValueError, match="needs CUDA"):
            port.flash_attention_fwd(meta, meta, meta, causal=True, scale=0.1)
    ragged = torch.empty(1, 1, 60, 896, device="meta", dtype=dtype)
    assert port._design(port.FWD_DESIGNS, ragged, 60) is port.FWD_DESIGNS.plain
    port._check_plain_inputs(ragged, ragged, ragged)
    wide64 = torch.empty(1, 1, 64, 896, device="meta", dtype=torch.float64)
    assert port.FWD_DESIGNS[(896, torch.float64)] is port.FWD_DESIGNS.plain
    with pytest.raises(ValueError, match="no Hopper kernel takes torch.float64"):
        port._check_plain_inputs(wide64, wide64, wide64)
    cpu = torch.ones(1, 1, 16, 896, dtype=dtype)
    out, lse = port.flash_attention_fwd(cpu, cpu, cpu, causal=True, scale=896 ** -0.5)
    assert out.shape == cpu.shape and bool(torch.isfinite(lse).all())
    want = port.flash_attention_fwd_plain(cpu, cpu, cpu, causal=True, scale=896 ** -0.5,
                                          block_q=64, block_k=32)
    assert all(torch.equal(a, b) for a, b in zip((out, lse), want))


@pytest.mark.parametrize("d, case", D_CASES, ids=[f"{d}-{_ids(c)}" for d, c in D_CASES])
def test_cpu_forward_and_backward_match_the_pallas_kernels(d, case):
    """The port's CPU path (float32: the dcluster128 design's plain version
    at its tiles) against the reference's
    Pallas forward at the same tiles, and the port's backward through
    ``dot_product_attention`` against ``jax.grad`` of the reference's
    ``flash_attention`` (interpret mode) under the same cotangent: every row
    of out, dq, dk and dv within 1e-4 of its own norm, lse within 1e-4. Rows
    that see no key get what the reference's kernel gives them at these
    tiles: 0 and NEG_INF where their q tile skips every kv tile."""
    tq, tkv, causal = case
    bq, bk = F32_TILES[d]
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
    if causal and tq - tkv >= bq:
        assert bool((o[..., :bq, :] == 0).all())
        assert bool((lse[..., :bq] == port.NEG_INF).all())
    out = port.dot_product_attention(tq_, tk_, tv_, causal=causal)
    assert torch.equal(out.detach(), o)
    out.backward(torch.from_numpy(g))
    for name, x, want in zip(("dq", "dk", "dv"), (tq_.grad, tk_.grad, tv_.grad), ref_grads):
        assert bool(torch.isfinite(x).all())
        err = row_err(x, torch.from_numpy(np.array(want)))
        assert err <= BWD_TOL[F32], f"{name}: worst row {err:.3e}"


@pytest.mark.parametrize("d", WIDE)
def test_wide_rows_that_see_no_key_follow_the_designs_tiles(d):
    """At t_q 112, t_kv 64 (causal) rows 0-47 see no key. A row of a q
    tile that skips every kv tile gets 0 and NEG_INF; a row of a q tile
    that shares it with rows that see keys runs that tile's kv tiles and
    gets the mean of V over them (the flash convention at the design's
    tiles). At dcluster128's 64 x 32 tiles rows 0-47 lie in the first q
    tile, which runs kv tile 0 (V's rows 0-31). bf16 inputs take the same
    plain version on the CPU, at the same tiles."""
    q, k, v, _ = _inputs(112, 64, d, seed=3)
    off = 64 - 112
    for dtype in (torch.bfloat16, F32):
        bq, bk = port.fwd_tiles(d, dtype)
        assert (bq, bk) == TILES[d]
        qt, kt, vt = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
        out, lse = port.flash_attention_fwd(qt, kt, vt, causal=True, scale=d ** -0.5)
        for r0 in range(0, 48, bq):  # the q tiles that hold rows 0-47
            r1, last = min(r0 + bq, 48), r0 + bq - 1 + off
            if last < 0:  # the q tile skips every kv tile
                assert bool((out[..., r0:r1, :] == 0).all())
                assert bool((lse[..., r0:r1] == port.NEG_INF).all())
            else:  # it runs kv tiles 0 .. last // bk
                n_kv = min(64, (last // bk + 1) * bk)
                mean_v = vt[..., :n_kv, :].float().mean(dim=2, keepdim=True).expand(
                    -1, -1, r1 - r0, -1)
                assert row_err(out[..., r0:r1, :], mean_v.to(dtype)) <= FWD_ROW_TOL[dtype]
                assert bool((lse[..., r0:r1] < -1e29).all())
        assert bool(torch.isfinite(out[..., 48:, :]).all())
