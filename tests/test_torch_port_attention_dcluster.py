"""Head_dims from 896 up, the backward, on the CPU: the ``dcluster`` design's
dispatch, its launch plan and its schedule.

From 896 up the backward's table takes every multiple of 128 by its rule
(``dsplit_takes``) to ``dcluster`` (``csrc/flash_bwd_dcluster.cu``) in bf16,
float16 and float32: the CTAs of a thread-block cluster share one resident
tile, each computes S and dP over its own group of 256 columns, the cluster
sums the partials in group order, and each CTA writes only its own output
columns; past 8 groups each CTA writes one group a pass
(``ops/dcluster.py``). The kernels run only on the card (``chip_smoke.py``
and the ``cuda``-marked tests of ``tests/test_torch_port_kernels.py`` hold
them to their plain version); here the plan is checked column by column for
every head_dim the reference takes from 896 to 8192, and
``flash_bwd_dcluster_model``, which walks the kernels' tiles, groups and
passes in float64, is held to ``flash_attention_bwd_plain`` in float64 and,
at two passes, to ``jax.grad`` of the reference's ``flash_attention`` in
interpret mode. Inputs are float32 numpy draws from a seed; the limit is
``BWD_TOL`` for float32 (1e-4 of each row's norm): the sides differ by
summation order only.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import flash_attention
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops import dcluster
from ray_tpu_torch.ops.tolerance import BWD_TOL, row_err

RULE_D = (896, 1024, 1152, 2048, 4096, 8192)
DTYPES = (torch.bfloat16, torch.float16, torch.float32)
F32 = torch.float32
SMEM_LIMIT = 232448  # the shared memory an H100 block may use

# (t_q, t_kv, causal), b=1 h=2: causal square over three 32-row tiles and a
# ragged fourth; rows that see no key (t_q 96 against t_kv 64: rows 0-31);
# q the suffix of a longer kv; non-causal with ragged tiles. 896 is 3.5
# groups in clusters of 4, 1152 4.5 in clusters of 5, 2048 8 in clusters of
# 8, 2304 9 groups: two passes in clusters of 5
MODEL_CASES = [(112, 112, True), (96, 64, True), (64, 128, True), (80, 104, False)]
MODEL_D = (896, 1152, 2048, 2304)


def _ids(case):
    tq, tkv, causal = case
    return f"q{tq}-kv{tkv}-{'causal' if causal else 'full'}"


def _inputs(tq, tkv, d, seed):
    rng = np.random.RandomState(seed)
    q, g = (rng.randn(1, 2, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(1, 2, tkv, d).astype(np.float32) for _ in range(2))
    return q, k, v, g


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("d", RULE_D)
def test_tables_name_dcluster_by_their_rule(d, dtype):
    """(d, dtype) from 896 up is a key of the backward's table by its rule,
    not a row, and names ``dcluster`` for dQ and dK/dV in every dtype, from
    a source that exists with the entry points the port binds, each
    counting its launches; the forward is ``dcluster`` too
    (tests/test_torch_port_attention_dcluster_fwd.py)."""
    bwd = port.BWD_DESIGNS[(d, dtype)]
    assert port.BWD_DESIGNS.takes_by_rule((d, dtype)) and (d, dtype) not in set(port.BWD_DESIGNS)
    assert port.FWD_DESIGNS[(d, dtype)].name == "dcluster"
    assert [(kn.name, kn.source, kn.entry, kn.schedule) for kn in (bwd.dq, bwd.dkv)] == [
        ("dcluster", "flash_bwd_dcluster", "ray_tpu_flash_bwd_dq_dcluster", False),
        ("dcluster", "flash_bwd_dcluster", "ray_tpu_flash_bwd_dkv_dcluster", False)]
    assert (port._build.CSRC_DIR / "flash_bwd_dcluster.cu").exists()
    entries, error_fn = port._SOURCES["flash_bwd_dcluster"]
    assert entries == {"ray_tpu_flash_bwd_dq_dcluster": 7, "ray_tpu_flash_bwd_dkv_dcluster": 8}
    assert error_fn == "ray_tpu_flash_bwd_dcluster_error_string"
    for name in ("flash_bwd_dq_dcluster_launches", "flash_bwd_dkv_dcluster_launches"):
        assert isinstance(getattr(port, name), int)
    # a length the reference sends to its XLA route takes the plain design
    meta = torch.empty(1, 1, 60, d, device="meta", dtype=dtype)
    assert port._design(port.BWD_DESIGNS, meta, 60) is port.BWD_DESIGNS.plain


@pytest.mark.parametrize("d", range(896, 8192 + 1, 128))
def test_plan_covers_every_column_once(d):
    """For every multiple of 128 from 896 to 8192: G = ceil(d / 256) groups,
    passes = ceil(G / 8), at most 8 CTAs a cluster and none without
    columns; the CTAs' partial columns cover [0, d) once, in group order,
    and so do their output columns over the passes, each CTA writing only
    columns of its own; both kernels' shared memory within the 232448 bytes
    a block may use in every dtype, the forward's too."""
    plan = dcluster.dcluster_plan(d, F32)
    groups = math.ceil(d / 256)
    assert (plan.group_cols, plan.groups) == (256, groups)
    assert plan.passes == math.ceil(groups / 8) and 1 <= plan.cluster <= 8
    assert plan.cluster * plan.passes >= groups > (plan.cluster - 1) * plan.passes
    partial = [plan.cta_columns(r) for r in range(plan.cluster)]
    assert partial[0][0] == 0 and partial[-1][1] == d
    assert all(a[1] == b[0] for a, b in zip(partial, partial[1:]))
    assert all(c1 > c0 for c0, c1 in partial)
    written = np.zeros(d, dtype=int)
    for r in range(plan.cluster):
        for pass_ in range(plan.passes):
            o0, o1 = plan.output_columns(r, pass_)
            assert partial[r][0] <= o0 <= o1 <= partial[r][1]
            assert o1 - o0 in (0, 128, 256)
            written[o0:o1] += 1
    assert bool((written == 1).all())
    for dtype in DTYPES:
        p = dcluster.dcluster_plan(d, dtype)
        assert (p.cluster, p.passes) == (plan.cluster, plan.passes)
        assert 0 < p.smem_dq <= SMEM_LIMIT and 0 < p.smem_dkv <= SMEM_LIMIT
        assert 0 < p.smem_fwd <= SMEM_LIMIT


def test_plan_refuses_what_the_kernels_do_not_take():
    """A head_dim that is no positive multiple of 128, and a dtype that no
    kernel takes, have no plan."""
    for d in (0, -128, 960, 1000):
        with pytest.raises(ValueError, match="multiple of 128"):
            dcluster.dcluster_plan(d, F32)
    with pytest.raises(ValueError, match="multiple of 128"):
        dcluster.dcluster_plan(896, torch.float64)
    assert dcluster.dcluster_plan(896, F32).smem_dkv == 229856
    assert dcluster.dcluster_plan(896, torch.bfloat16).smem_dkv == 134624


@pytest.mark.parametrize("case", MODEL_CASES, ids=_ids)
@pytest.mark.parametrize("d", MODEL_D)
def test_schedule_model_matches_the_plain_backward(d, case):
    """The kernels' schedule in float64 (each CTA's partials over its own
    columns, summed in group order, each CTA's output its own columns, pass
    by pass, the causal skip by tiles) against ``flash_attention_bwd_plain``
    in float64 from the same forward: every row of dq, dk and dv within
    1e-4 of its own norm, and none of them zero."""
    tq, tkv, causal = case
    q, k, v, g = (torch.from_numpy(a) for a in _inputs(tq, tkv, d, seed=d + tq + tkv))
    scale = d ** -0.5
    o, lse = port.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    got = dcluster.flash_bwd_dcluster_model(q, k, v, o, lse, g, causal=causal, scale=scale)
    want = port.flash_attention_bwd_plain(*(x.double() for x in (q, k, v, o, lse, g)),
                                          causal=causal, scale=scale)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == torch.float64 and x.shape == ref.shape
        assert float(x.abs().max()) > 0
        err = row_err(x, ref)
        assert err <= BWD_TOL[F32], f"{name}: worst row {err:.3e}"


def test_two_pass_schedule_matches_the_pallas_backward():
    """At d = 2304 (9 groups: two passes in clusters of 5), the schedule's
    dq, dk and dv against ``jax.grad`` of the reference's
    ``flash_attention`` in interpret mode at 64 x 32 tiles under the same
    cotangent, causal: every row within 1e-4 of its own norm."""
    d, tq, tkv = 2304, 64, 96
    q, k, v, g = _inputs(tq, tkv, d, seed=5)
    scale = d ** -0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    want = jax.grad(
        lambda *x: jnp.sum(flash_attention(*x, True, scale, 64, 32, True) * jnp.asarray(g)),
        argnums=(0, 1, 2))(jq, jk, jv)
    tq_, tk_, tv_, tg = (torch.from_numpy(a) for a in (q, k, v, g))
    o, lse = port.flash_attention_fwd(tq_, tk_, tv_, causal=True, scale=scale)
    assert dcluster.dcluster_plan(d, F32).passes == 2
    got = dcluster.flash_bwd_dcluster_model(tq_, tk_, tv_, o, lse, tg, causal=True,
                                            scale=scale)
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        err = row_err(x, torch.from_numpy(np.array(ref)))
        assert err <= BWD_TOL[F32], f"{name}: worst row {err:.3e}"
