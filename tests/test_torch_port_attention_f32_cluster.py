"""Head_dims 384 to 768 in float32, the backward, on the CPU: the
``dcluster128`` design's dispatch, its launch plan and its schedule.

``csrc/flash_bwd_dcluster128.cu`` runs the float32 dQ and dK/dV at 384,
512, 640 and 768: the C = d / 128 CTAs of a thread-block cluster share one
resident tile, each computes the partial S and dP over its own 128 columns
(two sources of 64 columns, its warps' column halves), the cluster sums the
2 C partials in column order, and each CTA writes only its own output
columns (``ops/dcluster.py``'s ``dcluster128_plan``). The kernels run only
on the card (``chip_smoke.py`` and the ``cuda``-marked tests of
``tests/test_torch_port_kernels.py`` hold them to their plain version);
here the plan is checked column by column, and
``flash_bwd_dcluster128_model``, which walks the kernels' tiles and sources
in float64, is held to ``flash_attention_bwd_plain`` in float64 and to
``jax.grad`` of the reference's ``flash_attention`` in interpret mode.
Inputs are float32 numpy draws from a seed; the limit is ``BWD_TOL`` for
float32 (1e-4 of each row's norm): the sides differ by summation order
only.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import flash_attention
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops import dcluster
from ray_tpu_torch.ops.tolerance import BWD_TOL, row_err

F32 = torch.float32
WIDE = (384, 512, 640, 768)
SMEM_LIMIT = 232448  # the shared memory an H100 block may use

# (t_q, t_kv, causal), b=1 h=2: causal square over three 32-row tiles and a
# ragged fourth; rows that see no key (t_q 96 against t_kv 64: rows 0-31);
# q the suffix of a longer kv; non-causal with ragged tiles; a ragged length
# that is no multiple of 8
MODEL_CASES = [(112, 112, True), (96, 64, True), (64, 128, True), (80, 104, False),
               (60, 76, True)]


def _ids(case):
    tq, tkv, causal = case
    return f"q{tq}-kv{tkv}-{'causal' if causal else 'full'}"


def _inputs(tq, tkv, d, seed):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(1, 2, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, 2, tkv, d).astype(np.float32) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("d", WIDE)
def test_table_names_dcluster128_for_the_float32_backward(d):
    """(d, float32) at 384 to 768 is a row of the backward's table naming
    ``dcluster128`` for dQ and dK/dV, from a source that exists with the
    entry points the port binds, each counting its launches; the forward's
    row is ``dcluster128``'s forward, and bf16 and float16 run the same
    design from their own source (``flash_bwd_dcluster128_wgmma.cu``)."""
    bwd = port.BWD_DESIGNS[(d, F32)]
    assert (d, F32) in set(port.BWD_DESIGNS)
    assert [(kn.name, kn.source, kn.entry, kn.schedule) for kn in (bwd.dq, bwd.dkv)] == [
        ("dcluster128", "flash_bwd_dcluster128", "ray_tpu_flash_bwd_dq_dcluster128", False),
        ("dcluster128", "flash_bwd_dcluster128", "ray_tpu_flash_bwd_dkv_dcluster128", False)]
    assert port.FWD_DESIGNS[(d, F32)].name == "dcluster128"
    for dt in (torch.bfloat16, torch.float16):
        assert port.BWD_DESIGNS[(d, dt)].dq.name == "dcluster128"
        assert port.BWD_DESIGNS[(d, dt)].dq.source == "flash_bwd_dcluster128_wgmma"
    assert (port._build.CSRC_DIR / "flash_bwd_dcluster128.cu").exists()
    entries, error_fn = port._SOURCES["flash_bwd_dcluster128"]
    assert entries == {"ray_tpu_flash_bwd_dq_dcluster128": 7,
                       "ray_tpu_flash_bwd_dkv_dcluster128": 8}
    assert error_fn == "ray_tpu_flash_bwd_dcluster128_error_string"
    assert port._PLAN_ENTRIES["flash_bwd_dcluster128"] == (
        "ray_tpu_flash_bwd_dcluster128_plan", ("smem_dq", "smem_dkv"))
    assert port._PLAN_OF["flash_bwd_dcluster128"] is dcluster.dcluster128_plan
    for name in ("flash_bwd_dq_dcluster128_launches", "flash_bwd_dkv_dcluster128_launches"):
        assert isinstance(getattr(port, name), int)


@pytest.mark.parametrize("d", range(128, 1024 + 1, 128))
def test_plan_covers_every_column_once(d):
    """For every multiple of 128 the build takes (C = d / 128 up to 8, the
    table's 384 to 768 among them): one pass, a group of 128 columns a CTA;
    the CTAs' columns cover [0, d) once in order and each writes only its
    own; the 64-column sources cover [0, d) once in column order, two a
    CTA; both kernels' shared memory within the 232448 bytes a block may
    use, the same at every d (the resident side lives in registers)."""
    plan = dcluster.dcluster128_plan(d, F32)
    assert (plan.group_cols, plan.groups, plan.cluster, plan.passes) == (128, d // 128,
                                                                        d // 128, 1)
    cols = [plan.cta_columns(r) for r in range(plan.cluster)]
    assert cols == [(128 * r, 128 * r + 128) for r in range(plan.cluster)]
    assert [plan.output_columns(r, 0) for r in range(plan.cluster)] == cols
    written = np.zeros(d, dtype=int)
    for c0, c1 in cols:
        written[c0:c1] += 1
    assert bool((written == 1).all())
    sources = [(c, c + dcluster.SOURCE_COLS_128) for c in range(0, d, dcluster.SOURCE_COLS_128)]
    assert len(sources) == 2 * plan.cluster and sources[-1][1] == d
    assert (plan.smem_dq, plan.smem_dkv, plan.smem_fwd) == (140448, 148384, 0)
    assert 0 < plan.smem_dq <= SMEM_LIMIT and 0 < plan.smem_dkv <= SMEM_LIMIT


def test_plan_refuses_what_the_kernels_do_not_take():
    """A head_dim that is no multiple of 128, one past 8 groups (the
    portable cluster), and a dtype that no build takes have no plan; bf16
    and float16 have their own build's (tests/test_torch_port_attention_wide_bwd.py),
    which refuses one group."""
    for d in (0, -128, 320, 1000, 1152):
        with pytest.raises(ValueError, match="multiple of 128 up to 1024"):
            dcluster.dcluster128_plan(d, F32)
    for dtype in (torch.float64, torch.int32):
        with pytest.raises(ValueError, match="float32"):
            dcluster.dcluster128_plan(640, dtype)
    for dtype in (torch.bfloat16, torch.float16):
        assert dcluster.dcluster128_plan(640, dtype).resident_rows == dcluster.RESIDENT_ROWS_16
        with pytest.raises(ValueError, match="from 256"):
            dcluster.dcluster128_plan(128, dtype)


@pytest.mark.parametrize("case", MODEL_CASES, ids=_ids)
@pytest.mark.parametrize("d", (384, 640))
def test_schedule_model_matches_the_plain_backward(d, case):
    """The kernels' schedule in float64 (2 C partial sources of 64 columns
    summed in column order, each CTA's output its own 128 columns, the
    causal skip by 32-row tiles) against ``flash_attention_bwd_plain`` in
    float64 from the same forward: every row of dq, dk and dv within 1e-4
    of its own norm, and none of them zero."""
    tq, tkv, causal = case
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(tq, tkv, d, seed=d + tq + tkv))
    scale = d ** -0.5
    o, lse = port.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    got = dcluster.flash_bwd_dcluster128_model(q, k, v, o, lse, g, causal=causal, scale=scale)
    want = port.flash_attention_bwd_plain(*(x.double() for x in (q, k, v, o, lse, g)),
                                          causal=causal, scale=scale)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.float64 and x.shape == ref.shape
        assert float(x.abs().max()) > 0
        err = row_err(x, ref)
        assert err <= BWD_TOL[F32], f"{name}: worst row {err:.3e}"


def test_schedule_model_rows_that_see_no_key_get_no_gradient():
    """Causal with t_q > t_kv: the q rows that see no key (the first t_q -
    t_kv) get dq = 0 in the schedule, as in the plain backward, and add
    nothing to dk and dv."""
    d, tq, tkv = 640, 96, 64
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(tq, tkv, d, seed=3))
    scale = d ** -0.5
    o, lse = port.flash_attention_fwd(q, k, v, causal=True, scale=scale)
    dq, dk, dv = dcluster.flash_bwd_dcluster128_model(q, k, v, o, lse, g, causal=True,
                                                      scale=scale)
    assert bool((dq[..., : tq - tkv, :] == 0).all())
    g_seen = g.clone()
    g_seen[..., : tq - tkv, :] = 0
    _, dk2, dv2 = dcluster.flash_bwd_dcluster128_model(q, k, v, o, lse, g_seen, causal=True,
                                                       scale=scale)
    torch.testing.assert_close(dk, dk2, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dv, dv2, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
def test_schedule_matches_the_pallas_backward(causal):
    """At d = 640 (clusters of 5, 10 partial sources), the schedule's dq,
    dk and dv against ``jax.grad`` of the reference's ``flash_attention``
    in interpret mode at 64 x 32 tiles under the same cotangent: every row
    within 1e-4 of its own norm."""
    d, tq, tkv = 640, 64, 96
    q, k, v, g = _inputs(tq, tkv, d, seed=7)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jax.grad(
        lambda *x: jnp.sum(flash_attention(*x, causal, scale, 64, 32, True) * jnp.asarray(g)),
        argnums=(0, 1, 2))(jq, jk, jv)
    tq_, tk_, tv_, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = port.flash_attention_fwd(tq_, tk_, tv_, causal=causal, scale=scale)
    got = dcluster.flash_bwd_dcluster128_model(tq_, tk_, tv_, o, lse, tg, causal=causal,
                                               scale=scale)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        err = row_err(x, torch.from_numpy(np.array(ref)))
        assert err <= BWD_TOL[F32], f"{name}: worst row {err:.3e}"
