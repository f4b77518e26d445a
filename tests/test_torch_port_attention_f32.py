"""The float32 flash backward's design, on the CPU.

``csrc/flash_bwd_f32.cu`` runs only on the card (``chip_smoke.py`` and the
``cuda``-marked tests of ``tests/test_torch_port_kernels.py`` hold it to the
plain backward there). Here:

* the dispatch table sends every float32 head_dim to that design, and the
  wrapper takes the plain backward for CPU tensors without a launch;
* ``ray_tpu_torch/ops/tf32.py``, which repeats the kernels' operand
  rounding, against hand-picked bit patterns and float64;
* the backward with every product in 3xTF32 (``flash_bwd_3xtf32``) against
  ``jax.grad`` of the reference's ``flash_attention`` custom VJP in Pallas
  interpret mode, in float32: dq, dk and dv each within
  ``BWD_TOL[float32]`` (1e-4) of each row's norm, the limit the card holds
  the kernels to. The inputs are numpy draws from a seed.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import _flash_attention_tpu, flash_attention
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops import tf32
from ray_tpu_torch.ops.tolerance import BWD_TOL, row_err

TILE = 64


def _bits(*patterns):
    return torch.tensor(np.array(patterns, dtype=np.uint32).view(np.int32)).view(torch.float32)


def _as_bits(x):
    return [int(b) & 0xFFFFFFFF for b in x.view(torch.int32).tolist()]


def test_bwd_designs_send_float32_to_the_tensor_core_design():
    """Every float32 head_dim runs the 3xTF32 kernels; the bf16 rows are the
    wgmma design at 128/256 (and dQ at 64, beside d64's dK/dV) and the
    persistent one at 16/32."""
    for d in port.HEAD_DIMS:
        design = port.BWD_DESIGNS[(d, torch.float32)]
        assert {(kn.name, kn.source) for kn in (design.dq, design.dkv)} == {
            ("tf32x3", "flash_bwd_f32")}
        assert (design.dq.entry, design.dkv.entry) == ("ray_tpu_flash_bwd_dq_f32",
                                                       "ray_tpu_flash_bwd_dkv_f32")
        assert (port._build.CSRC_DIR / "flash_bwd_f32.cu").exists()
        want = {64: ("wgmma", "d64"), 128: ("wgmma", "wgmma"), 256: ("wgmma", "wgmma")}.get(
            d, ("persistent", "persistent"))
        bf16 = port.BWD_DESIGNS[(d, torch.bfloat16)]
        assert (bf16.dq.name, bf16.dkv.name) == want
    assert set(port._SOURCES["flash_bwd_f32"][0]) == {"ray_tpu_flash_bwd_dq_f32",
                                                      "ray_tpu_flash_bwd_dkv_f32"}


def test_float32_wrapper_on_cpu_takes_the_plain_version_and_counts_nothing():
    rng = np.random.RandomState(0)
    q, k, v, do = (torch.from_numpy(rng.randn(1, 2, 40, 32).astype(np.float32))
                   for _ in range(4))
    o, lse = port.flash_attention_fwd_plain(q, k, v, causal=True, scale=0.25)
    counters = [name for name in dir(port) if name.startswith("flash_bwd_")
                and name.endswith("_launches")]
    assert {"flash_bwd_dq_tf32x3_launches", "flash_bwd_dkv_tf32x3_launches"} <= set(counters)
    before = {name: getattr(port, name) for name in counters}
    got = port.flash_attention_bwd(q, k, v, o, lse, do, causal=True, scale=0.25)
    want = port.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True, scale=0.25)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert {name: getattr(port, name) for name in counters} == before


@pytest.mark.parametrize("pattern, want", [
    (0x3F800000, 0x3F800000),  # 1.0 is a tf32 value
    (0x3F800FFF, 0x3F800000),  # below half an ulp: down
    (0x3F801000, 0x3F802000),  # a tie: away from zero
    (0xBF801000, 0xBF802000),  # a negative tie: away from zero
    (0x3F803000, 0x3F804000),  # a tie from an odd last bit: away, not to even
    (0x3F801001, 0x3F802000),  # above half: up
    (0x3FFFF000, 0x40000000),  # the carry lands in the exponent
    (0x7F7FFFFF, 0x7F800000),  # the largest float32 rounds to inf
    (0x7F800000, 0x7F800000),  # inf
    (0xFF800000, 0xFF800000),  # -inf
    (0x80000000, 0x80000000),  # -0.0
    (0x00000FFF, 0x00000000),  # a subnormal below half an ulp
    (0x00001000, 0x00002000),  # a subnormal tie
    (0x007FF000, 0x00800000),  # the largest subnormals round to the smallest normal
], ids=lambda x: f"{x:#010x}")
def test_round_tf32_on_bit_patterns(pattern, want):
    assert _as_bits(tf32.round_tf32(_bits(pattern))) == [want]


def test_round_tf32_keeps_nan():
    nans = _bits(0x7FC00000, 0x7FFFFFFF, 0xFFFFFFFF, 0x7F800001)
    assert bool(torch.isnan(tf32.round_tf32(nans)).all())


def test_split_tf32_rebuilds_x_to_2_to_the_minus_22():
    """big and small are tf32 values (low 13 bits clear) and big + small is
    x to 2^-22 of |x|, over normal float32 values of every magnitude."""
    rng = np.random.RandomState(1)
    x = torch.from_numpy((rng.randn(20000) * np.exp2(rng.randint(-100, 100, 20000)))
                         .astype(np.float32))
    big, small = tf32.split_tf32(x)
    assert all(b & 0x1FFF == 0 for b in _as_bits(big) + _as_bits(small))
    err = (big.double() + small.double() - x.double()).abs()
    assert bool((err <= 2.0 ** -22 * x.double().abs()).all())
    assert float((err / x.double().abs()).max()) > 2.0 ** -26  # the bound is near tight


@pytest.mark.parametrize("d", [16, 32, 64, 128, 256])
def test_mm_3xtf32_against_float64(d):
    """Each product of the split operands is off by at most 3.01 * 2^-22 of
    |a_i b_i| (small * small' dropped, each split's own 2^-22), and a float32
    sum of d terms adds at most (d + 2) * 2^-24 of sum |a_i b_i|: the bound
    below. 1xTF32 (big * big alone) breaks it."""
    rng = np.random.RandomState(d)
    a = torch.from_numpy(rng.randn(64, d).astype(np.float32))
    b = torch.from_numpy(rng.randn(d, 48).astype(np.float32))
    exact = a.double() @ b.double()
    scale = a.double().abs() @ b.double().abs()
    bound = (3.01 * 2.0 ** -22 + (d + 2) * 2.0 ** -24) * scale
    assert bool(((tf32.mm_3xtf32(a, b).double() - exact).abs() <= bound).all())
    one = tf32.round_tf32(a) @ tf32.round_tf32(b)
    assert not bool(((one.double() - exact).abs() <= bound).all())


# (b, h, t_q, t_kv, d, causal): head_dims 16 to 256 at t <= 128, causal and
# not, ragged tiles (t_q 40, t_kv 72), and t_q > t_kv (rows that see no key)
CASES = [
    (1, 2, 128, 128, 16, True),
    (1, 2, 40, 72, 64, False),
    (1, 2, 40, 72, 128, True),
    (1, 1, 128, 128, 256, True),
    (1, 1, 96, 64, 128, True),
]


def _ids(case):
    b, h, tq, tkv, d, causal = case
    return f"{b}x{h}-q{tq}-kv{tkv}-d{d}-{'causal' if causal else 'full'}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_3xtf32_backward_matches_jax_flash_attention_vjp(case):
    """dq, dk, dv of the backward with every product in 3xTF32, given the
    reference kernel's out and lse, against jax.grad of the reference's
    flash_attention (Pallas, interpret mode) under cotangent g."""
    b, h, tq, tkv, d, causal = case
    rng = np.random.RandomState(sum(case[:5]))
    q, g = (rng.randn(b, h, tq, d).astype(np.float32) for _ in range(2))
    k, v = (rng.randn(b, h, tkv, d).astype(np.float32) for _ in range(2))
    scale = 1.0 / d ** 0.5
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    ref = jax.grad(lambda *x: jnp.sum(flash_attention(*x, causal, scale, TILE, TILE, True)
                                      * jnp.asarray(g)), argnums=(0, 1, 2))(jq, jk, jv)
    o, lse = _flash_attention_tpu(jq, jk, jv, causal=causal, scale=scale, block_q=TILE,
                                  block_k=TILE, interpret=True)
    got = tf32.flash_bwd_3xtf32(*(torch.from_numpy(np.array(a)) for a in (q, k, v, o, lse, g)),
                                causal=causal, scale=scale)
    for name, x, want in zip(("dq", "dk", "dv"), got, ref):
        assert x.dtype == torch.float32 and bool(torch.isfinite(x).all())
        err = row_err(x, torch.from_numpy(np.array(want)))
        assert err <= BWD_TOL[torch.float32], f"{name}: worst row {err:.3e}"
