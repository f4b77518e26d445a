"""The float32 flash forward's design, on the CPU.

``csrc/flash_fwd_f32.cu`` runs only on the card (``chip_smoke.py`` and the
``cuda``-marked tests of ``tests/test_torch_port_kernels.py`` hold it to the
plain forward there). Here:

* the dispatch table sends every float32 head_dim to that design at
  64 x 64 tiles, and the wrapper takes the plain forward for CPU tensors
  without a launch;
* the forward with S and P V in 3xTF32 (``ops/tf32.py``'s
  ``flash_fwd_3xtf32``, the kernel's numerics) against the reference's
  Pallas forward ``_flash_attention_tpu`` in interpret mode, in float32:
  every row of out within ``FWD_ROW_TOL[float32]`` (1e-4) of its own norm
  and lse within ``FWD_LSE_TOL[float32]`` (1e-4), the limits the card holds
  the kernel to. The inputs are numpy draws from a seed.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import _flash_attention_tpu
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops import tf32
from ray_tpu_torch.ops.tolerance import FWD_LSE_TOL, FWD_ROW_TOL, row_err

TILE = 64


@pytest.mark.parametrize("d", port.HEAD_DIMS)
def test_fwd_designs_send_float32_to_the_tensor_core_design(d):
    """Every float32 head_dim runs the 3xTF32 kernel at 64 x 64 tiles (32 x
    64 at 384 and 512, where 64 rows of Q would not fit in shared memory, 16
    x 64 at 640 and 768, where the warps of 32 rows would not fit an SM's
    registers), from a source the port builds with the entry point its table
    binds; bf16 keeps wgmma at 128/256, d64 at 64, persistent at 16/32 and
    wide at 384, 512, 640 and 768."""
    design = port.FWD_DESIGNS[(d, torch.float32)]
    assert (design.name, design.source, design.entry) == (
        "tf32x3", "flash_fwd_f32", "ray_tpu_flash_fwd_f32")
    tiles = (TILE, TILE) if d <= 256 else (32 if d <= 512 else 16, TILE)
    assert (design.block_q, design.block_k) == tiles == port.fwd_tiles(d, torch.float32)
    assert (port._build.CSRC_DIR / "flash_fwd_f32.cu").exists()
    assert set(port._SOURCES["flash_fwd_f32"][0]) == {"ray_tpu_flash_fwd_f32"}
    want = {64: "d64", 128: "wgmma", 256: "wgmma",
            **{w: "wide" for w in port.WIDE_HEAD_DIMS}}.get(d, "persistent")
    assert port.FWD_DESIGNS[(d, torch.bfloat16)].name == want


def test_float32_forward_on_cpu_takes_the_plain_version_and_counts_nothing():
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 72, 64).astype(np.float32)) for _ in range(3))
    counters = [name for name in dir(port) if name.startswith("flash_fwd_")
                and name.endswith("_launches")] + ["flash_fwd_launches"]
    assert "flash_fwd_tf32x3_launches" in counters
    before = {name: getattr(port, name) for name in counters}
    got = port.flash_attention_fwd(q, k, v, causal=True, scale=0.125)
    want = port.flash_attention_fwd_plain(q, k, v, causal=True, scale=0.125)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert {name: getattr(port, name) for name in counters} == before


# (b, h, t_q, t_kv, d, causal): head_dims 16 to 256, causal and not, ragged
# tiles (t_q 40 or 96, t_kv 72 or 136), q the suffix of a longer kv, and
# t_q > t_kv: at 160 x 64 rows 0-63 see no key and their tile skips every kv
# tile, rows 64-95 see none but share a tile that runs kv tile 0; at 96 x 64
# rows 0-31 see none, in a tile that runs
CASES = [
    (1, 2, 128, 128, 16, True),
    (1, 2, 40, 72, 32, False),
    (1, 2, 96, 136, 64, True),
    (1, 2, 128, 128, 64, False),
    (1, 2, 64, 200, 128, True),
    (1, 2, 40, 72, 128, False),
    (1, 1, 160, 64, 128, True),
    (1, 1, 128, 128, 256, True),
    (1, 1, 96, 64, 256, True),
]


def _ids(case):
    b, h, tq, tkv, d, causal = case
    return f"{b}x{h}-q{tq}-kv{tkv}-d{d}-{'causal' if causal else 'full'}"


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_3xtf32_forward_matches_jax_pallas_forward(case):
    """out and lse of the forward with both products in 3xTF32 against the
    reference's Pallas forward (interpret mode) at the same 64 x 64 tiles."""
    b, h, tq, tkv, d, causal = case
    rng = np.random.RandomState(sum(case[:5]))
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k, v = (rng.randn(b, h, tkv, d).astype(np.float32) for _ in range(2))
    scale = 1.0 / d ** 0.5
    ref_o, ref_lse = _flash_attention_tpu(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                          causal=causal, scale=scale, block_q=TILE,
                                          block_k=TILE, interpret=True)
    o, lse = tf32.flash_fwd_3xtf32(*(torch.from_numpy(a) for a in (q, k, v)),
                                   causal=causal, scale=scale)
    assert o.dtype == lse.dtype == torch.float32
    assert bool(torch.isfinite(o).all()) and bool(torch.isfinite(lse).all())
    err = row_err(o, torch.from_numpy(np.array(ref_o)))
    assert err <= FWD_ROW_TOL[torch.float32], f"out: worst row {err:.3e}"
    lse_err = float((lse - torch.from_numpy(np.array(ref_lse))).abs().max())
    assert lse_err <= FWD_LSE_TOL[torch.float32], f"lse: {lse_err:.3e}"
    if causal and tq - tkv >= TILE:
        # the rows of a q tile that skips every kv tile: 0 and NEG_INF
        assert bool((o[..., :TILE, :] == 0).all())
        assert bool((lse[..., :TILE] == port.NEG_INF).all())


def test_3xtf32_forward_is_closer_than_1xtf32():
    """The 3xTF32 forward sits within float32 rounding of the plain forward;
    with one TF32 product (big * big) in place of each, out moves by ~1e-3 of
    a row, ten times the gate: the split is what the gate needs."""
    rng = np.random.RandomState(11)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 128, 128).astype(np.float32) * 2)
               for _ in range(3))
    want_o, want_lse = port.flash_attention_fwd_plain(q, k, v, causal=True, scale=128 ** -0.5)
    o, lse = tf32.flash_fwd_3xtf32(q, k, v, causal=True, scale=128 ** -0.5)
    assert row_err(o, want_o) <= 1e-5 and float((lse - want_lse).abs().max()) <= 1e-5
    one = port._flash_fwd_tiled(
        q, k, v, causal=True, scale=128 ** -0.5,
        qk=lambda x, y: tf32.round_tf32(x) @ tf32.round_tf32(y).transpose(-1, -2),
        pv=lambda x, y: tf32.round_tf32(x) @ tf32.round_tf32(y))
    assert row_err(one[0], want_o) > FWD_ROW_TOL[torch.float32]
