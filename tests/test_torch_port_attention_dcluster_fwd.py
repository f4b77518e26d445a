"""Head_dims from 896 up, the forward, on the CPU: the ``dcluster`` design's
dispatch, its launch plan and its schedule.

From 896 up the forward's table takes every multiple of 128 by its rule
(``dsplit_takes``) to ``dcluster`` (``csrc/flash_fwd_dcluster.cu``) in bf16,
float16 and float32, at 64 x 32 tiles: the C CTAs of a thread-block cluster
share one 64-row q tile, each computes S over its own group of 256 columns,
CTA r sums the partials of whole rows r ceil(64 / C) and on in group order
and runs their online softmax, and every CTA updates only its own output
columns from the same P; past 8 groups each CTA writes one group a pass
(``ops/dcluster.py``). The kernel runs only on the card (``chip_smoke.py``
and the ``cuda``-marked tests of ``tests/test_torch_port_kernels.py`` hold it
to its plain version); here the plan is checked row by row and column by
column for every head_dim the reference takes from 896 to 8192, and
``flash_fwd_dcluster_model``, which walks the kernel's tiles, groups,
reducers and passes in float64, is held to ``flash_attention_fwd_plain``
(float32 arithmetic) and, at two passes, to the reference's
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
SMEM_LIMIT = 232448  # the shared memory an H100 block may use
TILES = (64, 32)

# (t_q, t_kv, causal), b=1 h=2: causal square over two q tiles with a ragged
# kv tile; rows that see no key (t_q 160 against t_kv 64: rows 0-63 in a q
# tile that skips every kv tile, rows 64-95 in one that runs kv tile 0); q
# the suffix of a longer kv with a ragged q tile; non-causal with ragged
# tiles; both shorter than a tile. 896 is 3.5 groups in clusters of 4, 1152
# 4.5 in clusters of 5 (13 rows a reducer, the last 12), 1664 6.5 in
# clusters of 7 (10 rows, the last 4), 2048 8 in clusters of 8
MODEL_CASES = [(112, 112, True), (160, 64, True), (40, 120, True), (104, 72, False),
               (24, 20, True)]
MODEL_D = (896, 1152, 1664, 2048)


def _ids(case):
    tq, tkv, causal = case
    return f"q{tq}-kv{tkv}-{'causal' if causal else 'full'}"


def _inputs(tq, tkv, d, seed):
    rng = np.random.RandomState(seed)
    q = rng.randn(1, 2, tq, d).astype(np.float32)
    k, v = (rng.randn(1, 2, tkv, d).astype(np.float32) for _ in range(2))
    return q, k, v


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_table_names_the_dcluster_forward_by_its_rule(dtype):
    """From 896 up, by the rule and not a row, the forward's design is
    ``dcluster`` at 64 x 32 tiles in every dtype: a positive-scale kernel
    (the wrapper hands it a non-positive scale's sign in q) whose built
    tiles and plan the wrapper checks (``_TILES_ENTRIES``,
    ``_PLAN_ENTRIES``), from a source with the entry points the port binds,
    counting its launches in total and by head_dim; ``flash_fwd_dsplit.cu``,
    the design before, stays bound for the variants script only."""
    for d in (896, 1152, 2048, 4096, 8192):
        design = port.FWD_DESIGNS[(d, dtype)]
        assert port.FWD_DESIGNS.takes_by_rule((d, dtype))
        assert (design.name, design.source, design.entry, design.schedule) == (
            "dcluster", "flash_fwd_dcluster", "ray_tpu_flash_fwd_dcluster", False)
        assert (design.block_q, design.block_k) == TILES == port.fwd_tiles(d, dtype)
    assert "dcluster" in port._POSITIVE_SCALE and "dsplit" not in port._POSITIVE_SCALE
    assert port._TILES_ENTRIES["dcluster"] == "ray_tpu_flash_fwd_dcluster_tiles"
    assert port._PLAN_ENTRIES["flash_fwd_dcluster"] == ("ray_tpu_flash_fwd_dcluster_plan",
                                                        ("smem_fwd",))
    assert (port._build.CSRC_DIR / "flash_fwd_dcluster.cu").exists()
    assert (port._build.CSRC_DIR / "dcluster.cuh").exists()
    assert port._SOURCES["flash_fwd_dcluster"] == (
        {"ray_tpu_flash_fwd_dcluster": 5}, "ray_tpu_flash_fwd_dcluster_error_string")
    assert isinstance(port.flash_fwd_dcluster_launches, int)
    assert not hasattr(port, "flash_fwd_dsplit_launches")
    assert "ray_tpu_flash_fwd_dsplit" in port._SOURCES["flash_fwd_dsplit"][0]


@pytest.mark.parametrize("d", range(896, 8192 + 1, 128))
def test_forward_plan_reduces_every_row_once_and_fits(d):
    """For every multiple of 128 from 896 to 8192: the CTAs' reducing rows
    cover the 64 rows of a q tile once, in rank order, ceil(64 / C) each and
    none empty, so every CTA receives partials and pushes P; the forward's
    shared memory fits in 232448 bytes in every dtype, the same at every
    head_dim (nothing a CTA keeps grows with d), with the receive buffers
    sized for the largest C ceil(64 / C) (70 rows, at C = 7)."""
    plan = dcluster.dcluster_plan(d, F32)
    per = -(-64 // plan.cluster)
    rows = [plan.reducer_rows(r) for r in range(plan.cluster)]
    assert rows[0][0] == 0 and rows[-1][1] == 64
    assert all(a[1] == b[0] for a, b in zip(rows, rows[1:]))
    assert all(0 < r1 - r0 <= per for r0, r1 in rows)
    assert plan.cluster * per <= dcluster._max_recv_rows() == 70
    for dtype in DTYPES:
        p = dcluster.dcluster_plan(d, dtype)
        assert 0 < p.smem_fwd <= SMEM_LIMIT
        assert p.smem_fwd == dcluster.fwd_smem_bytes(dtype)
    assert dcluster.fwd_smem_bytes(F32) == 231968
    assert dcluster.fwd_smem_bytes(torch.bfloat16) == 136736


@pytest.mark.parametrize("case", MODEL_CASES, ids=_ids)
@pytest.mark.parametrize("d", MODEL_D)
def test_schedule_model_matches_the_plain_forward(d, case):
    """The kernel's schedule in float64 (each CTA's partial S over its own
    columns, summed in group order, the softmax by reducing rows, each CTA
    its own output columns, the causal skip by tiles) against
    ``flash_attention_fwd_plain``: every row of out within 1e-4 of its own
    norm and lse within 1e-4, in float32; none of out zero where a row
    runs a kv tile."""
    tq, tkv, causal = case
    q, k, v = (torch.from_numpy(a) for a in _inputs(tq, tkv, d, seed=d + tq + tkv))
    scale = d ** -0.5
    out, lse = dcluster.flash_fwd_dcluster_model(q, k, v, causal=causal, scale=scale)
    want, want_lse = port.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
    assert out.dtype == torch.float64 and out.shape == want.shape
    assert lse.shape == want_lse.shape
    assert row_err(out, want) <= FWD_ROW_TOL[F32]
    assert float((lse.float() - want_lse).abs().max()) <= FWD_LSE_TOL[F32]
    assert float(out[..., -1, :].abs().max()) > 0


@pytest.mark.parametrize("d", (1152, 2304))
def test_schedule_model_rows_that_see_no_key(d):
    """At t_q 160, t_kv 64 (causal) rows 0-95 see no key: rows 0-63 lie in
    a q tile that skips every kv tile (0 and NEG_INF), rows 64-95 in one
    that runs kv tile 0 (32 rows), so their reducer keeps m at NEG_INF and
    takes p = 1 on each column: the mean of V over that tile. One pass and
    two."""
    q, k, v = (torch.from_numpy(a) for a in _inputs(160, 64, d, seed=7))
    out, lse = dcluster.flash_fwd_dcluster_model(q, k, v, causal=True, scale=d ** -0.5)
    assert bool((out[..., :64, :] == 0).all())
    assert bool((lse[..., :64].float() == port.NEG_INF).all())
    mean_v = v[:, :, :32].double().mean(dim=2, keepdim=True).expand(-1, -1, 32, -1)
    assert row_err(out[..., 64:96, :], mean_v) <= 1e-12
    assert bool((lse[..., 64:96] < -1e29).all())
    assert bool(torch.isfinite(lse[..., 96:]).all() and (lse[..., 96:] > -1e3).all())


@pytest.mark.parametrize("causal", (True, False), ids=("causal", "full"))
def test_two_pass_schedule_matches_the_pallas_forward(causal):
    """At d = 2304 (9 groups: two passes in clusters of 5, the last CTA's
    second group past d), the schedule's out and lse against the
    reference's ``_flash_attention_tpu`` in interpret mode at 64 x 32
    tiles, with rows that see no key under the causal mask (t_q 96 against
    t_kv 64: rows 0-31 in a q tile that runs kv tile 0): every row of out
    within 1e-4 of its own norm, lse within 1e-4."""
    d, tq, tkv = 2304, 96, 64
    q, k, v = _inputs(tq, tkv, d, seed=5)
    scale = d ** -0.5
    plan = dcluster.dcluster_plan(d, F32)
    assert (plan.cluster, plan.passes) == (5, 2)
    assert plan.output_columns(4, 1) == (d, d)
    ref_o, ref_lse = _flash_attention_tpu(*(jnp.asarray(a) for a in (q, k, v)), causal=causal,
                                          scale=scale, block_q=TILES[0], block_k=TILES[1],
                                          interpret=True)
    out, lse = dcluster.flash_fwd_dcluster_model(*(torch.from_numpy(a) for a in (q, k, v)),
                                                 causal=causal, scale=scale)
    assert row_err(out, torch.from_numpy(np.array(ref_o))) <= FWD_ROW_TOL[F32]
    got_lse, want_lse = lse.float(), torch.from_numpy(np.array(ref_lse))
    assert float((got_lse - want_lse).abs().max()) <= FWD_LSE_TOL[F32]
