"""Head_dims 384 to 768 in bf16 and float16, the backward, on the CPU: the
``dcluster128`` design's wgmma build, its dispatch, its launch plan and its
schedule.

``csrc/flash_bwd_dcluster128_wgmma.cu`` runs the bf16 and float16 dQ and
dK/dV at 384, 512, 640 and 768: the C = d / 128 CTAs of a thread-block
cluster share one resident tile of ``RESIDENT_ROWS_16`` rows, each computes
the partial S and dP over its own 128 columns on wgmma against streamed
tiles (``stream_16``: 64 rows, and 32 for dQ from clusters of 4), the
cluster sums the C partials in
column order, the reducers round P and dS to the dtype, and each CTA writes
only its own output columns (``ops/dcluster.py``'s ``dcluster128_plan``).
The kernels run only on the card (``chip_smoke.py`` and the
``cuda``-marked tests of ``tests/test_torch_port_kernels.py`` hold them to
their plain version); here the plan is checked column by column, and
``flash_bwd_dcluster128_model``, which walks the kernels' tiles and sources
in float64 and rounds P and dS as they do, is held to
``flash_attention_bwd_plain`` in float64 and to ``jax.grad`` of the
reference's ``flash_attention`` in interpret mode. Inputs are numpy draws
from a seed, rounded to the dtype; the limit is ``BWD_TOL`` of the dtype
(2e-2 of each row's norm in bf16, 5e-3 in float16): the model rounds P and
dS to the dtype where the plain backward and the reference keep float32.
"""

import jax.numpy as jnp
import jax
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import flash_attention
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops import dcluster
from ray_tpu_torch.ops.tolerance import BWD_TOL, row_err

WIDE = (384, 512, 640, 768)
HALF = (torch.bfloat16, torch.float16)
SMEM_LIMIT = 232448  # the shared memory an H100 block may use
SOURCE = "flash_bwd_dcluster128_wgmma"

# (t_q, t_kv, causal), b=1 h=2: causal square over two 64-row tiles and a
# ragged third; rows that see no key (t_q 160 against t_kv 64: rows 0-95,
# the first resident q tile wholly); q the suffix of a longer kv; non-causal
# with ragged tiles; a ragged length that is no multiple of 8
MODEL_CASES = [(150, 150, True), (160, 64, True), (64, 200, True), (80, 136, False),
               (60, 76, True)]


def _ids(case):
    tq, tkv, causal = case
    return f"q{tq}-kv{tkv}-{'causal' if causal else 'full'}"


def _inputs(tq, tkv, d, seed, dtype):
    """q, k, v and a cotangent of out as float32 numpy arrays rounded to
    ``dtype``, and the same as torch tensors of ``dtype``."""
    rng = np.random.RandomState(seed)
    arrays = [rng.randn(1, 2, t, d).astype(np.float32) for t in (tq, tkv, tkv, tq)]
    tensors = [torch.from_numpy(a).to(dtype) for a in arrays]
    return [t.float().numpy() for t in tensors], tensors


@pytest.mark.parametrize("dtype", HALF, ids=str)
@pytest.mark.parametrize("d", WIDE)
def test_table_names_dcluster128_for_the_16bit_backward(d, dtype):
    """(d, bf16 | float16) at 384 to 768 is a row of the backward's table
    naming ``dcluster128`` for dQ and dK/dV from its wgmma source, which
    exists with the entry points the port binds, each counting its launches
    in the design's counters (the float32 build's too) and by head_dim; the
    wrapper checks each launch against ``dcluster128_plan``, which reports
    the tiles besides the shared memory."""
    bwd = port.BWD_DESIGNS[(d, dtype)]
    assert (d, dtype) in set(port.BWD_DESIGNS)
    assert [(kn.name, kn.source, kn.entry, kn.schedule) for kn in (bwd.dq, bwd.dkv)] == [
        ("dcluster128", SOURCE, "ray_tpu_flash_bwd_dq_dcluster128_wgmma", False),
        ("dcluster128", SOURCE, "ray_tpu_flash_bwd_dkv_dcluster128_wgmma", False)]
    assert port.BWD_DESIGNS[(d, torch.float32)].dq.name == "dcluster128"
    assert port.FWD_DESIGNS[(d, dtype)].name == "dcluster128"
    assert (port._build.CSRC_DIR / f"{SOURCE}.cu").exists()
    entries, error_fn = port._SOURCES[SOURCE]
    assert entries == {"ray_tpu_flash_bwd_dq_dcluster128_wgmma": 7,
                       "ray_tpu_flash_bwd_dkv_dcluster128_wgmma": 8}
    assert error_fn == "ray_tpu_flash_bwd_dcluster128_wgmma_error_string"
    assert port._PLAN_ENTRIES[SOURCE] == (
        "ray_tpu_flash_bwd_dcluster128_wgmma_plan",
        ("smem_dq", "smem_dkv", "resident_rows", "streamed_rows_dq", "streamed_rows_dkv"))
    assert port._PLAN_OF[SOURCE] is dcluster.dcluster128_plan
    for name in ("flash_bwd_dq_dcluster128_launches", "flash_bwd_dkv_dcluster128_launches"):
        assert isinstance(getattr(port, name), int)


@pytest.mark.parametrize("dtype", HALF, ids=str)
@pytest.mark.parametrize("d", range(256, 1024 + 1, 128))
def test_plan_covers_every_column_once(d, dtype):
    """For every multiple of 128 the 16-bit build takes (C = d / 128 from 2
    to 8, the table's 384 to 768 among them): one pass, a group of 128
    columns a CTA, which is also its one partial source; the CTAs' columns
    cover [0, d) once in order and each writes only its own; the tiles are
    the build's at that cluster size (dQ's 32-row tiles from clusters of
    4), and both kernels' shared memory, the same in both 16-bit dtypes, is
    within the 232448 bytes a block may use, dQ's within half an SM's from
    clusters of 4 (two CTAs an SM)."""
    plan = dcluster.dcluster128_plan(d, dtype)
    assert (plan.group_cols, plan.groups, plan.cluster, plan.passes) == (128, d // 128,
                                                                        d // 128, 1)
    cols = [plan.cta_columns(r) for r in range(plan.cluster)]
    assert cols == [(128 * r, 128 * r + 128) for r in range(plan.cluster)]
    assert [plan.output_columns(r, 0) for r in range(plan.cluster)] == cols
    written = np.zeros(d, dtype=int)
    for c0, c1 in cols:
        written[c0:c1] += 1
    assert bool((written == 1).all())
    c = plan.cluster
    assert (plan.resident_rows, plan.streamed_rows_dq, plan.streamed_rows_dkv) == (
        64, 32 if c >= dcluster.DQ_NARROW_FROM else 64, 64)
    assert (plan.smem_dq, plan.smem_dkv, plan.smem_fwd) == (
        dcluster.smem_bytes_128_16(False, c), dcluster.smem_bytes_128_16(True, c), 0)
    assert 0 < plan.smem_dq <= SMEM_LIMIT and 0 < plan.smem_dkv <= SMEM_LIMIT
    if c >= dcluster.DQ_NARROW_FROM:
        assert 2 * (plan.smem_dq + 1024) <= 233472  # two CTAs an SM, 1 KB each reserved
    assert plan == dcluster.dcluster128_plan(d, HALF[1 - HALF.index(dtype)])
    # the float32 build's plan differs only in its tiles and shared memory
    f32 = dcluster.dcluster128_plan(d, torch.float32)
    assert (f32.cluster, f32.passes, f32.resident_rows) == (plan.cluster, 1, dcluster.ROWS)


@pytest.mark.parametrize("cluster", range(2, 9))
def test_shared_memory_reckoning(cluster):
    """The shared memory of the build's tiles: 64 resident rows; dK/dV,
    and dQ below clusters of 4, 64 streamed rows in three stages; dQ from
    clusters of 4, 32 rows in two. The resident pair, the ring, two
    receive buffers sized for the largest cluster, two P/dS buffers, dQ's
    row statistics, the mbarriers (two receive, two P/dS, a full one a
    stage, the resident pair's) and the alignment."""
    assert dcluster.stream_16(True, cluster) == (64, 3)
    narrow = cluster >= 4
    assert dcluster.stream_16(False, cluster) == ((32, 2) if narrow else (64, 3))
    assert dcluster.smem_bytes_128_16(True, cluster) == (
        32768 + 98304 + 65984 + 32768 + 8 * 8 + 1024) == 230912
    if narrow:
        assert dcluster.smem_bytes_128_16(False, cluster) == (
            32768 + 32768 + 33216 + 8192 + 512 + 7 * 8 + 1024) == 108536
    else:
        assert dcluster.smem_bytes_128_16(False, cluster) == (
            32768 + 98304 + 65984 + 16384 + 512 + 8 * 8 + 1024) == 215040


def test_plan_refuses_what_the_16bit_build_does_not_take():
    """One group (d = 128: a reducing thread takes at most two quads, which
    needs C >= 2), a head_dim that is no multiple of 128, one past 8 groups
    (the portable cluster), and a dtype that no build takes have no plan."""
    for dtype in HALF:
        for d in (0, 128, 320, 1000, 1152):
            with pytest.raises(ValueError, match="from 256 in torch.bfloat16"):
                dcluster.dcluster128_plan(d, dtype)
    with pytest.raises(ValueError, match="float32"):
        dcluster.dcluster128_plan(640, torch.float64)


@pytest.mark.parametrize("dtype", HALF, ids=str)
@pytest.mark.parametrize("case", MODEL_CASES, ids=_ids)
@pytest.mark.parametrize("d", (384, 640))
def test_schedule_model_matches_the_plain_backward(d, case, dtype):
    """The kernels' schedule in float64 (C partial sources of 128 columns
    summed in column order, P and dS rounded to the dtype, each CTA's
    output its own 128 columns, the causal skip by 64-row tiles) against
    ``flash_attention_bwd_plain`` in float64 from the same forward: every
    row of dq, dk and dv within the dtype's ``BWD_TOL`` of its own norm,
    none of them zero, and the model's own rounding above float64's noise
    (it rounds, as the kernels do)."""
    tq, tkv, causal = case
    _, (q, k, v, g) = _inputs(tq, tkv, d, d + tq + tkv, dtype)
    scale = d ** -0.5
    o, lse = port.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    got = dcluster.flash_bwd_dcluster128_model(q, k, v, o, lse, g, causal=causal, scale=scale)
    want = port.flash_attention_bwd_plain(*(x.double() for x in (q, k, v, o, lse, g)),
                                          causal=causal, scale=scale)
    errs = []
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.float64 and x.shape == ref.shape
        assert float(x.abs().max()) > 0
        errs.append(row_err(x, ref))
        assert errs[-1] <= BWD_TOL[dtype], f"{name}: worst row {errs[-1]:.3e}"
    assert max(errs) > 1e-6


def test_schedule_model_rows_that_see_no_key_get_no_gradient():
    """Causal with t_q > t_kv: the q rows that see no key (the first t_q -
    t_kv, a whole resident tile and half of the next) get dq = 0 in the
    schedule, as in the plain backward, and add nothing to dk and dv."""
    d, tq, tkv = 640, 160, 64
    _, (q, k, v, g) = _inputs(tq, tkv, d, 3, torch.bfloat16)
    scale = d ** -0.5
    o, lse = port.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    dq, dk, dv = dcluster.flash_bwd_dcluster128_model(q, k, v, o, lse, g, causal=True,
                                                      scale=scale)
    assert bool((dq[..., : tq - tkv, :] == 0).all())
    assert float(dq[..., tq - tkv:, :].abs().max()) > 0
    g_seen = g.clone()
    g_seen[..., : tq - tkv, :] = 0
    _, dk2, dv2 = dcluster.flash_bwd_dcluster128_model(q, k, v, o, lse, g_seen, causal=True,
                                                       scale=scale)
    torch.testing.assert_close(dk, dk2, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dv, dv2, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_schedule_matches_the_pallas_backward(causal):
    """At d = 640 (clusters of 5 CTAs, 5 partial sources) in bf16, the
    schedule's dq, dk and dv against ``jax.grad`` of the reference's
    ``flash_attention`` in interpret mode at 64 x 32 tiles under the same
    cotangent, from the same bf16-rounded inputs (float32 on the JAX side):
    every row within bf16's 2e-2 of its own norm (the schedule rounds P
    and dS to bf16, the reference keeps them in float32)."""
    d, tq, tkv = 640, 64, 96
    (q, k, v, g), (tq_, tk_, tv_, tg) = _inputs(tq, tkv, d, 7, torch.bfloat16)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jax.grad(
        lambda *x: jnp.sum(flash_attention(*x, causal, scale, 64, 32, True) * jnp.asarray(g)),
        argnums=(0, 1, 2))(jq, jk, jv)
    o, lse = port.flash_attention_fwd(tq_, tk_, tv_, causal=causal, scale=scale)
    got = dcluster.flash_bwd_dcluster128_model(tq_, tk_, tv_, o, lse, tg, causal=causal,
                                               scale=scale)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        err = row_err(x, torch.from_numpy(np.array(ref)))
        assert err <= BWD_TOL[torch.bfloat16], f"{name}: worst row {err:.3e}"


@pytest.mark.parametrize("dtype", HALF, ids=str)
def test_backward_on_cpu_takes_the_plain_version_and_counts_nothing(dtype):
    """On CPU tensors the 16-bit backward at 640 is the plain version in
    the dtype, and no launch counts; off the CPU (the meta device) it goes
    to the kernels' input check, which answers that it needs CUDA, instead
    of a fallback."""
    d = 640
    _, (q, k, v, g) = _inputs(72, 72, d, 11, dtype)
    o, lse = port.flash_attention_fwd(q, k, v, causal=True, scale=d ** -0.5)
    counters = [name for name in dir(port) if name.startswith("flash_bwd")
                and name.endswith("_launches")]
    before = {name: getattr(port, name) for name in counters}
    got = port.flash_attention_bwd(q, k, v, o, lse, g, causal=True, scale=d ** -0.5)
    want = port.flash_attention_bwd_plain(q, k, v, o, lse, g, causal=True, scale=d ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(x.dtype == dtype for x in got)
    assert {name: getattr(port, name) for name in counters} == before
    meta = [torch.empty(1, 2, 64, d, device="meta", dtype=dtype) for _ in range(3)]
    lse_meta = torch.empty(1, 2, 64, device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        port.flash_attention_bwd(*meta, meta[0], lse_meta, meta[0], causal=True,
                                 scale=d ** -0.5)
