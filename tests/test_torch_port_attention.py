"""ray_tpu_torch.ops.attention against ray_tpu.ops.attention on the CPU.

The same numpy inputs go through the JAX functions and the port's plain
versions, all in float32. The TPU flash kernel runs in Pallas interpret mode,
as tests/test_attention.py runs it. Tolerance for float32 on the CPU:
atol 2e-5, rtol 1e-4 on outputs (the two sides sum in other orders) and
atol 2e-5, rtol 1e-5 on lse; atol 5e-5, rtol 1e-3 on gradients (as
tests/test_ring.py holds blockwise attention's). The CUDA kernel is held against the plain
version on the card in tests/test_torch_port_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import (
    _attention_xla,
    _flash_attention_tpu,
    attention_with_lse as jax_attention_with_lse,
    blockwise_attention as jax_blockwise_attention,
    merge_attention as jax_merge_attention,
)
from ray_tpu_torch.ops import attention as port

OUT_TOL = dict(atol=2e-5, rtol=1e-4)
LSE_TOL = dict(atol=2e-5, rtol=1e-5)

# (b, h, t_q, t_kv, d, causal): the cases of tests/test_attention.py plus
# q longer than kv (rows that see no key), short tiles and other head dims
CASES = [
    (2, 2, 128, 128, 128, True),
    (2, 2, 128, 128, 128, False),
    (1, 2, 64, 256, 128, True),     # chunked prefill: q is the suffix
    (1, 1, 64, 72, 128, False),     # ragged kv, tiles of 64
    (1, 1, 64, 72, 128, True),
    (1, 1, 160, 64, 128, True),     # t_q > t_kv: leading rows see nothing
    (1, 2, 24, 40, 16, True),       # both shorter than a tile
    (1, 2, 96, 136, 64, True),      # ragged q and kv
]


def _ids(case):
    b, h, tq, tkv, d, causal = case
    return f"{b}x{h}-q{tq}-kv{tkv}-d{d}-{'causal' if causal else 'full'}"


# every (block_q, block_k) the forward's dispatch table can return; the
# mma_sync design's 64 x 64 keeps the case's own id
TILES = sorted({(dz.block_q, dz.block_k) for dz in port.FWD_DESIGNS.values()})
TILED_CASES = [(case, tiles) for tiles in TILES for case in CASES]


def _tiled_ids(case_tiles):
    case, (bq, bk) = case_tiles
    return _ids(case) if (bq, bk) == (64, 64) else f"{_ids(case)}-tiles{bq}x{bk}"


def _qkv(b, h, tq, tkv, d, seed=0):
    rng = np.random.RandomState(seed)
    q = rng.randn(b, h, tq, d).astype(np.float32)
    k = rng.randn(b, h, tkv, d).astype(np.float32)
    v = rng.randn(b, h, tkv, d).astype(np.float32)
    return q, k, v


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_attention_plain_matches_xla(case):
    b, h, tq, tkv, d, causal = case
    q, k, v = _qkv(b, h, tq, tkv, d)
    ref = np.asarray(_attention_xla(jnp.asarray(q), jnp.asarray(k),
                                    jnp.asarray(v), causal=causal))
    out = port._attention_plain(*_t(q, k, v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, **OUT_TOL)


def test_attention_plain_segment_ids_match_xla():
    q, k, v = _qkv(2, 2, 48, 48, 32, seed=3)
    seg = np.repeat(np.array([[0, 1, 2], [0, 0, 1]]), 16, axis=1).astype(np.int32)
    ref = np.asarray(_attention_xla(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                    causal=True, segment_ids=jnp.asarray(seg)))
    out = port.dot_product_attention(*_t(q, k, v), causal=True,
                                     segment_ids=torch.from_numpy(seg))
    np.testing.assert_allclose(out.numpy(), ref, **OUT_TOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_offset", [0, 64, -32])
def test_attention_with_lse_matches_jax(causal, kv_offset):
    q, k, v = _qkv(1, 2, 64, 96, 64, seed=1)
    ref_o, ref_lse = jax_attention_with_lse(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        kv_offset=kv_offset)
    o, lse = port.attention_with_lse(*_t(q, k, v), causal=causal,
                                     kv_offset=kv_offset)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), **OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **LSE_TOL)


@pytest.mark.parametrize("valid", [True, False, "rows"])
def test_merge_attention_matches_jax(valid):
    rng = np.random.RandomState(2)
    o, o_new = (rng.randn(1, 2, 32, 16).astype(np.float32) for _ in range(2))
    lse, lse_new = (rng.randn(1, 2, 32).astype(np.float32) for _ in range(2))
    if valid == "rows":
        valid = rng.rand(1, 2, 32) > 0.5
    ref_o, ref_lse = jax_merge_attention(
        jnp.asarray(o), jnp.asarray(lse), jnp.asarray(o_new),
        jnp.asarray(lse_new), valid)
    vt = torch.from_numpy(valid) if isinstance(valid, np.ndarray) else valid
    out_o, out_lse = port.merge_attention(*_t(o, lse, o_new, lse_new), vt)
    np.testing.assert_allclose(out_o.numpy(), np.asarray(ref_o), **OUT_TOL)
    np.testing.assert_allclose(out_lse.numpy(), np.asarray(ref_lse), **LSE_TOL)


def test_merge_of_two_halves_is_full_attention():
    q, k, v = _qkv(1, 2, 32, 64, 32, seed=4)
    qt, kt, vt = _t(q, k, v)
    o1, l1 = port.attention_with_lse(qt, kt[:, :, :32], vt[:, :, :32], causal=True,
                                     kv_offset=0 - 32)
    o2, l2 = port.attention_with_lse(qt, kt[:, :, 32:], vt[:, :, 32:], causal=True,
                                     kv_offset=32 - 32)
    merged, _ = port.merge_attention(o1.float(), l1, o2, l2)
    full = port._attention_plain(qt, kt, vt, causal=True)
    np.testing.assert_allclose(merged.numpy(), full.numpy(), **OUT_TOL)


# (b, h, t_q, t_kv, d, causal, chunk): tests/test_ring.py's case first; then
# non-causal, q the suffix of kv, and the two routes to the plain version
BLOCKWISE_CASES = [
    (1, 2, 1024, 1024, 32, True, 256),
    (1, 2, 256, 256, 16, False, 64),
    (1, 2, 96, 256, 16, True, 64),
    (1, 2, 64, 200, 16, True, 64),      # t_kv % chunk != 0
    (1, 2, 64, 64, 16, True, 64),       # t_kv <= chunk
]


@pytest.mark.parametrize("case", BLOCKWISE_CASES,
                         ids=lambda c: f"q{c[2]}-kv{c[3]}-{'causal' if c[5] else 'full'}-chunk{c[6]}")
def test_blockwise_attention_matches_jax(case):
    """Value and the gradients of q, k and v (of sum(out * r))."""
    b, h, tq, tkv, d, causal, chunk = case
    q, k, v = _qkv(b, h, tq, tkv, d, seed=9)
    r = np.random.RandomState(10).randn(b, h, tq, d).astype(np.float32)

    def jloss(q, k, v):
        out = jax_blockwise_attention(q, k, v, causal=causal, chunk=chunk)
        return (out * r).sum(), out

    (_, ref), ref_grads = jax.value_and_grad(jloss, argnums=(0, 1, 2), has_aux=True)(
        *(jnp.asarray(a) for a in (q, k, v)))
    qt, kt, vt = (t.requires_grad_() for t in _t(q, k, v))
    out = port.blockwise_attention(qt, kt, vt, causal=causal, chunk=chunk)
    grads = torch.autograd.grad((out * torch.from_numpy(r)).sum(), (qt, kt, vt))
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(ref), **OUT_TOL)
    for name, g, want in zip("qkv", grads, ref_grads):
        np.testing.assert_allclose(g.numpy(), np.asarray(want), atol=5e-5, rtol=1e-3,
                                   err_msg=f"d{name}")
    with torch.no_grad():  # without grad no chunk is checkpointed; same value
        again = port.blockwise_attention(qt, kt, vt, causal=causal, chunk=chunk)
    assert torch.equal(again, out.detach())


@pytest.mark.parametrize("case_tiles", TILED_CASES, ids=_tiled_ids)
def test_flash_plain_matches_pallas_kernel(case_tiles):
    """Out and lse of the plain flash forward against the TPU kernel in
    interpret mode, at each of the port's tiles (``FWD_DESIGNS``), every row
    included: rows that see no key follow the kernel's own convention."""
    (b, h, tq, tkv, d, causal), (block_q, block_k) = case_tiles
    q, k, v = _qkv(b, h, tq, tkv, d)
    scale = 1.0 / d ** 0.5
    ref_o, ref_lse = _flash_attention_tpu(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal,
        scale=scale, block_q=block_q, block_k=block_k, interpret=True)
    o, lse = port.flash_attention_fwd_plain(
        *_t(q, k, v), causal=causal, scale=scale, block_q=block_q, block_k=block_k)
    np.testing.assert_allclose(o.numpy(), np.asarray(ref_o), **OUT_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), **LSE_TOL)


def test_flash_plain_empty_rows_average_processed_tile():
    """The empty-row convention spelled out: with causal t_q > t_kv, a row
    that sees no key averages V over the processed tile (p = 1 on each of
    its 64 columns), and its lse stays at the NEG_INF sentinel; tiles of
    64 x 64."""
    q, k, v = _qkv(1, 1, 160, 64, 16, seed=5)
    o, lse = port.flash_attention_fwd_plain(*_t(q, k, v), causal=True, scale=0.25,
                                            block_q=64, block_k=64)
    # rows 0..63 form a q tile whose last row has q_pos = -33: the causal
    # skip drops every kv tile, so they get 0 and NEG_INF
    assert torch.all(o[0, 0, :64] == 0) and torch.all(lse[0, 0, :64] == port.NEG_INF)
    # rows 64..95 share a q tile with rows that see keys: tile 0 runs
    mean_v = torch.from_numpy(v[0, 0]).mean(0)
    torch.testing.assert_close(o[0, 0, 64], mean_v, atol=1e-6, rtol=1e-5)
    assert float(lse[0, 0, 64]) == pytest.approx(port.NEG_INF)
    # the last row sees every key: ordinary attention
    ref = port._attention_plain(*_t(q, k, v), causal=True, scale=0.25)
    torch.testing.assert_close(o[0, 0, -1], ref[0, 0, -1], **OUT_TOL)


def test_dispatcher_on_cpu_takes_the_plain_flash_version():
    q, k, v = _t(*_qkv(1, 2, 80, 80, 32, seed=6))
    out = port.dot_product_attention(q, k, v, causal=True)
    plain, _ = port.flash_attention_fwd_plain(q, k, v, causal=True,
                                              scale=1.0 / 32 ** 0.5)
    assert torch.equal(out, plain)
    before = port.flash_fwd_launches
    port.dot_product_attention(q, k, v, causal=False)
    assert port.flash_fwd_launches == before  # the CPU path launches nothing


@pytest.mark.parametrize("d, dtype, tiles", [
    (64, torch.bfloat16, (128, 128)),
    (128, torch.bfloat16, (128, 128)),
    (256, torch.bfloat16, (128, 80)),
    (16, torch.bfloat16, (64, 64)),
    (32, torch.bfloat16, (64, 64)),
    (128, torch.float32, (64, 64)),
])
def test_dispatcher_on_cpu_uses_the_table_tiles(d, dtype, tiles):
    """The CPU path computes with the tiles of the kernel that the card runs
    for (head_dim, dtype): rows that see no key (causal, t_q > t_kv) get 0
    only where a 64-row q tile skips every kv tile; a 128-row tile runs kv
    tile 0 and they average V."""
    assert port.fwd_tiles(d, dtype) == tiles
    q, k, v = (x.to(dtype) for x in _t(*_qkv(1, 1, 160, 64, d, seed=8)))
    out = port.dot_product_attention(q, k, v, causal=True)
    want, _ = port.flash_attention_fwd_plain(q, k, v, causal=True, scale=d ** -0.5,
                                             block_q=tiles[0], block_k=tiles[1])
    assert torch.equal(out, want)
    assert bool((out[0, 0, :64] == 0).all()) == (tiles[0] == 64)
