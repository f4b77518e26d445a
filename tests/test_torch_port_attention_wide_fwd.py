"""Head_dims 384 to 768, the forward, on the CPU: the ``dcluster128``
design's dispatch, its launch plan and its schedule.

At 384, 512, 640 and 768 the forward's table names ``dcluster128``
(``csrc/flash_fwd_dcluster128.cu``) in bf16, float16 and float32, at 64 x 32
tiles: the C = d / 128 CTAs of a thread-block cluster share one 64-row q
tile, each computes its partial S over its own 128 columns as two sources of
64 columns, CTA r sums the 2 C partials of whole rows r ceil(64 / C) and on
in column order and runs their online softmax, and every CTA updates only
its own 128 output columns from the same P (``ops/dcluster.py``'s
``dcluster128_fwd_plan``). The kernel runs only on the card
(``chip_smoke.py`` and the ``cuda``-marked tests of
``tests/test_torch_port_kernels.py`` hold it to its plain version); here the
plan is checked column by column and row by row for every head_dim it
builds for, and ``flash_fwd_dcluster128_model``, which walks the kernel's
tiles, sources and reducers in float64, is held to
``flash_attention_fwd_plain`` (float32 arithmetic) and to the reference's
``_flash_attention_tpu`` in interpret mode at the same tiles. Inputs are
float32 numpy draws from a seed; the limits are ``FWD_ROW_TOL`` and
``FWD_LSE_TOL`` for float32 (1e-4 of each row's norm, lse 1e-4 absolute):
the sides differ by summation order and the plain version's float32 only.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import _flash_attention_tpu
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops import dcluster
from ray_tpu_torch.ops.tolerance import FWD_LSE_TOL, FWD_ROW_TOL, row_err

DTYPES = (torch.bfloat16, torch.float16, torch.float32)
F32 = torch.float32
WIDE = (384, 512, 640, 768)
SMEM_LIMIT = 232448  # the shared memory an H100 block may use
SM_SMEM = 233472     # an H100 SM's, of which the card keeps 1024 bytes a block
TILES = (64, 32)

# (t_q, t_kv, causal), b=1 h=2: causal square over two q tiles with a ragged
# kv tile; rows that see no key (t_q 160 against t_kv 64: rows 0-63 in a q
# tile that skips every kv tile, rows 64-95 in one that runs kv tile 0); q
# the suffix of a longer kv with a ragged q tile; non-causal with ragged
# tiles; both shorter than a tile. 384 runs clusters of 3 (22 rows a
# reducer, the last 20), 640 clusters of 5 (13 rows, the last 12)
MODEL_CASES = [(112, 112, True), (160, 64, True), (40, 120, True), (104, 72, False),
               (24, 20, True)]
MODEL_D = (384, 640)


def _ids(case):
    tq, tkv, causal = case
    return f"q{tq}-kv{tkv}-{'causal' if causal else 'full'}"


def _inputs(tq, tkv, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(1, 2, tq, d).astype(np.float32)
    k, v = (rng.randn(1, 2, tkv, d).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_table_names_the_dcluster128_forward(dtype):
    """At 384 to 768 the forward's rows name ``dcluster128`` at 64 x 32
    tiles in every dtype: a positive-scale kernel (the wrapper hands it a
    non-positive scale's sign in q) whose built tiles and plan the wrapper
    checks (``_TILES_ENTRIES``, ``_PLAN_ENTRIES`` and ``_PLAN_OF``), from a
    source with the entry points the port binds, counting its launches in
    total and by head_dim; the backward's rows stay as they were."""
    for d in WIDE:
        design = port.FWD_DESIGNS[(d, dtype)]
        assert not port.FWD_DESIGNS.takes_by_rule((d, dtype))
        assert (design.name, design.source, design.entry, design.schedule) == (
            "dcluster128", "flash_fwd_dcluster128", "ray_tpu_flash_fwd_dcluster128", False)
        assert (design.block_q, design.block_k) == TILES == port.fwd_tiles(d, dtype)
        bwd = port.BWD_DESIGNS[(d, dtype)]
        assert bwd.dq.name == bwd.dkv.name == ("dcluster128" if dtype == F32 else "wide")
    assert "dcluster128" in port._POSITIVE_SCALE
    assert port._TILES_ENTRIES["dcluster128"] == "ray_tpu_flash_fwd_dcluster128_tiles"
    assert port._PLAN_ENTRIES["flash_fwd_dcluster128"] == (
        "ray_tpu_flash_fwd_dcluster128_plan", ("smem_fwd",))
    assert port._PLAN_OF["flash_fwd_dcluster128"] is dcluster.dcluster128_fwd_plan
    assert (port._build.CSRC_DIR / "flash_fwd_dcluster128.cu").exists()
    assert port._SOURCES["flash_fwd_dcluster128"] == (
        {"ray_tpu_flash_fwd_dcluster128": 5}, "ray_tpu_flash_fwd_dcluster128_error_string")
    assert isinstance(port.flash_fwd_dcluster128_launches, int)


@pytest.mark.parametrize("d", range(256, 1024 + 1, 128))
def test_forward_plan_covers_every_column_and_row_once(d):
    """For every multiple of 128 the build takes (C = d / 128 from 2 to 8,
    the table's 384 to 768 among them): one pass, a group of 128 columns a
    CTA; the CTAs' columns cover [0, d) once in order and each writes only
    its own; the 64-column sources cover [0, d) once in column order, two a
    CTA; the reducing rows cover the 64 rows of a q tile once, in rank
    order, none empty; the shared memory fits a block in every dtype, and
    twice an SM in bf16 and float16, with the receive buffers sized for the
    largest 2 C ceil(64 / C) (140 rows, at C = 7)."""
    for dtype in DTYPES:
        plan = dcluster.dcluster128_fwd_plan(d, dtype)
        assert (plan.group_cols, plan.groups, plan.cluster, plan.passes) == (
            128, d // 128, d // 128, 1)
        assert (plan.smem_dq, plan.smem_dkv) == (0, 0)
        assert plan.smem_fwd == dcluster.fwd_smem_bytes_128(dtype)
        assert 0 < plan.smem_fwd <= SMEM_LIMIT
        if dtype != F32:
            assert 2 * (plan.smem_fwd + 1024) <= SM_SMEM
    cols = [plan.cta_columns(r) for r in range(plan.cluster)]
    assert cols == [(128 * r, 128 * r + 128) for r in range(plan.cluster)]
    assert [plan.output_columns(r, 0) for r in range(plan.cluster)] == cols
    written = np.zeros(d, dtype=int)
    for c0, c1 in cols:
        written[c0:c1] += 1
    assert bool((written == 1).all())
    sources = [(c, c + dcluster.SOURCE_COLS_128) for c in range(0, d, dcluster.SOURCE_COLS_128)]
    assert len(sources) == 2 * plan.cluster and sources[-1][1] == d
    per = -(-64 // plan.cluster)
    rows = [plan.reducer_rows(r) for r in range(plan.cluster)]
    assert rows[0][0] == 0 and rows[-1][1] == 64
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert all(0 < r1 - r0 <= per for r0, r1 in rows)
    assert 2 * plan.cluster * per <= dcluster._max_recv_rows(2) == 140
    assert dcluster.fwd_smem_bytes_128(F32) == 185400
    assert dcluster.fwd_smem_bytes_128(torch.bfloat16) == 103480


def test_forward_plan_refuses_what_the_kernel_does_not_take():
    """A head_dim that is no multiple of 128, 128 itself (a cluster of one
    CTA: the reducer's 8 threads a row need two), one past 8 groups (the
    portable cluster), and a dtype no kernel takes have no plan."""
    for d in (0, -128, 128, 320, 1000, 1152):
        with pytest.raises(ValueError, match="multiple of 128 from 256 to 1024"):
            dcluster.dcluster128_fwd_plan(d, F32)
    with pytest.raises(ValueError, match="float64"):
        dcluster.dcluster128_fwd_plan(640, torch.float64)


@pytest.mark.parametrize("case", MODEL_CASES, ids=_ids)
@pytest.mark.parametrize("d", MODEL_D)
def test_schedule_model_matches_the_plain_forward(d, case):
    """The kernel's schedule in float64 (each CTA's two partial sources
    summed in column order, the softmax by reducing rows, each CTA its own
    output columns, the causal skip by tiles) against
    ``flash_attention_fwd_plain`` at the design's tiles: every row of out
    within 1e-4 of its own norm and lse within 1e-4, in float32; none of
    out zero where a row runs a kv tile."""
    tq, tkv, causal = case
    q, k, v = (torch.from_numpy(a) for a in _inputs(tq, tkv, d, seed=d + tq + tkv))
    scale = d ** -0.5
    out, lse = dcluster.flash_fwd_dcluster128_model(q, k, v, causal=causal, scale=scale)
    want, want_lse = port.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale,
                                                    block_q=TILES[0], block_k=TILES[1])
    assert out.dtype == torch.float64 and out.shape == want.shape
    assert lse.shape == want_lse.shape
    assert row_err(out, want) <= FWD_ROW_TOL[F32]
    assert float((lse.float() - want_lse).abs().max()) <= FWD_LSE_TOL[F32]
    assert float(out[..., -1, :].abs().max()) > 0


@pytest.mark.parametrize("d", MODEL_D)
def test_schedule_model_rows_that_see_no_key(d):
    """At t_q 160, t_kv 64 (causal) rows 0-95 see no key: rows 0-63 lie in
    a q tile that skips every kv tile (0 and NEG_INF), rows 64-95 in one
    that runs kv tile 0 (32 rows), so their reducer keeps m at NEG_INF and
    takes p = 1 on each column: the mean of V over that tile."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(160, 64, d, seed=7))
    out, lse = dcluster.flash_fwd_dcluster128_model(q, k, v, causal=True, scale=d ** -0.5)
    assert bool((out[..., :64, :] == 0).all())
    assert bool((lse[..., :64].float() == port.NEG_INF).all())
    mean_v = v[:, :, :32].double().mean(dim=2, keepdim=True).expand(-1, -1, 32, -1)
    assert row_err(out[..., 64:96, :], mean_v) <= 1e-12
    assert bool((lse[..., 64:96] < -1e29).all())
    assert bool(torch.isfinite(lse[..., 96:]).all() and (lse[..., 96:] > -1e3).all())


@pytest.mark.parametrize("causal", (True, False), ids=("causal", "full"))
def test_schedule_model_matches_the_pallas_forward(causal):
    """At d = 640 (clusters of 5, 13 reducing rows a CTA, the last 12), the
    schedule's out and lse against the reference's ``_flash_attention_tpu``
    in interpret mode at 64 x 32 tiles, with rows that see no key under the
    causal mask (t_q 96 against t_kv 64: rows 0-31 in a q tile that runs kv
    tile 0): every row of out within 1e-4 of its own norm, lse within
    1e-4."""
    d, tq, tkv = 640, 96, 64
    q, k, v = _inputs(tq, tkv, d, seed=5)
    scale = d ** -0.5
    plan = dcluster.dcluster128_fwd_plan(d, F32)
    assert (plan.cluster, plan.passes) == (5, 1)
    assert plan.reducer_rows(4) == (52, 64)
    ref_o, ref_lse = _flash_attention_tpu(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                          scale=scale, block_q=TILES[0], block_k=TILES[1],
                                          interpret=True)
    out, lse = dcluster.flash_fwd_dcluster128_model(*(torch.from_numpy(a) for a in (q, k, v)),
                                                    causal=causal, scale=scale)
    assert row_err(out, torch.from_numpy(np.array(ref_o))) <= FWD_ROW_TOL[F32]
    got_lse, want_lse = lse.float(), torch.from_numpy(np.array(ref_lse))
    assert float((got_lse - want_lse).abs().max()) <= FWD_LSE_TOL[F32]
