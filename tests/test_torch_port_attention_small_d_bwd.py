"""The bf16 backward at head_dim 16 and 32 (gpt_nano's and the tiny
flagship's heads), on the CPU.

``csrc/flash_bwd_persistent.cu`` runs only on the card (``chip_smoke.py``
phases 3 and 4g and the ``cuda``-marked tests of
``tests/test_torch_port_kernels.py`` hold it to the plain backward there).
Here:

* the backward's dispatch table sends bf16 at 16 and 32 to the
  ``persistent`` design and leaves every other entry as it was; the wrapper
  takes the plain backward for CPU tensors without a launch;
* ``ops/persistent_bwd.py``, the kernels' arithmetic (exp2 with the scale
  and log2(e) folded into one constant, rows that see no key dropped by
  their masks, P and dS rounded to bf16, the scale at the epilogue), and
  ``flash_attention_bwd_plain`` against the reference's Pallas backward ``_flash_attention_tpu_bwd`` in
  interpret mode at 64-row tiles (8 cases at each head_dim), on bf16 inputs
  (the kernels'): every row of dq, dk and dv within ``BWD_TOL[bfloat16]``
  (2e-2) of its own norm, the limit the card holds the kernels to. Both
  sides get the same out (the reference's forward, rounded to bf16 as the
  card's forward gives it) and lse, so delta is the same on both.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.ops.attention import _flash_attention_tpu, _flash_attention_tpu_bwd
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops import persistent_bwd
from ray_tpu_torch.ops.tolerance import BWD_TOL, row_err

SMALL_D = (16, 32)
BF16 = torch.bfloat16
TILE = 64


def test_bwd_designs_send_bf16_16_and_32_to_the_persistent_design():
    """bf16 at head_dim 16 and 32 runs ``flash_bwd_persistent.cu``, bound
    through the entry points its table names; every other entry is the one
    it was: bf16 and float16 128/256 on wgmma, bf16 and float16 64 on d64's
    dQ and dK/dV, bf16 and float16 384, 512, 640 and 768 on dcluster128's
    wgmma build, float32 on tf32x3 up to 256 and on dcluster128 at 384,
    512, 640 and 768."""
    pair = {"tf32x3": [("tf32x3", "flash_bwd_f32")] * 2,
            "dcluster128": [("dcluster128", "flash_bwd_dcluster128")] * 2,
            "persistent": [("persistent", "flash_bwd_persistent")] * 2,
            "wgmma": [("wgmma", "flash_bwd_wgmma")] * 2,
            "d64": [("d64", "flash_bwd_d64")] * 2,
            "dcluster128_wgmma": [("dcluster128", "flash_bwd_dcluster128_wgmma")] * 2}
    want = {(d, torch.float32): pair["dcluster128" if d in port.WIDE_HEAD_DIMS else "tf32x3"]
            for d in port.HEAD_DIMS}
    want.update({(d, BF16): pair["persistent"] for d in SMALL_D})
    want.update({(d, BF16): pair["wgmma"] for d in (128, 256)})
    want[(64, BF16)] = pair["d64"]
    want.update({(d, BF16): pair["dcluster128_wgmma"] for d in (384, 512, 640, 768)})
    want.update({(d, torch.float16): want[(d, BF16)]
                 for d in (64, 128, 256, 384, 512, 640, 768)})
    assert {key: [(kn.name, kn.source) for kn in (dz.dq, dz.dkv)]
            for key, dz in port.BWD_DESIGNS.items()} == want
    for d in SMALL_D:
        design = port.BWD_DESIGNS[(d, BF16)]
        assert (design.dq.entry, design.dkv.entry) == ("ray_tpu_flash_bwd_dq_persistent",
                                                       "ray_tpu_flash_bwd_dkv_persistent")
    assert (port._build.CSRC_DIR / "flash_bwd_persistent.cu").exists()
    assert port._SOURCES["flash_bwd_persistent"][0] == {
        "ray_tpu_flash_bwd_dq_persistent": 7, "ray_tpu_flash_bwd_dkv_persistent": 8}
    # the counters: one per design on the table, none for the design it replaced
    for kernel in ("dq", "dkv"):
        assert hasattr(port, f"flash_bwd_{kernel}_persistent_launches")
        assert not hasattr(port, f"flash_bwd_{kernel}_mma_sync_launches")


@pytest.mark.parametrize("d", SMALL_D)
def test_bf16_backward_on_cpu_takes_the_plain_version_and_counts_nothing(d):
    rng = np.random.RandomState(d)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 4, 72, d).astype(np.float32)).to(BF16)
                   for _ in range(4))
    o, lse = port.flash_attention_fwd(q, k, v, causal=True, scale=d ** -0.5)
    counters = [name for name in dir(port) if name.startswith("flash_bwd")
                and name.endswith("_launches")]
    before = {name: getattr(port, name) for name in counters}
    got = port.flash_attention_bwd(q, k, v, o, lse, do, causal=True, scale=d ** -0.5)
    want = port.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True, scale=d ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert all(x.dtype == BF16 for x in got)
    assert {name: getattr(port, name) for name in counters} == before


def test_rows_that_see_no_key_have_every_score_masked():
    """The kernels drop a row that sees no key by their masks alone: every
    score of such a row is masked, so its P is 0 whatever its lse (the
    reference's forward leaves it about NEG_INF); the kernels' arithmetic
    gives it dq = 0 and nothing in dk and dv, as the reference does."""
    t_q, t_kv, d = 160, 64, 16
    dead = torch.arange(t_q) + (t_kv - t_q) < 0  # q rows before the first key
    assert int(dead.sum()) == t_q - t_kv
    assert not bool(port._causal_mask(t_q, t_kv, "cpu")[dead].any())
    inputs, ref = _case((1, 1, t_q, t_kv, True), d)
    q, k, v, o, lse, do = inputs
    assert bool((lse[..., dead] <= port.NEG_INF / 2).all())
    dq, dk, dv = persistent_bwd.flash_bwd_persistent(*inputs, causal=True, scale=d ** -0.5)
    assert bool((dq[..., dead, :] == 0).all()) and bool((ref[0][..., dead, :] == 0).all())
    # the live rows alone give dk and dv: the dead rows add nothing (an
    # unmasked score of theirs would be exp2(about 1.4e30) = inf)
    live = ~dead
    sub = [x[..., live, :] for x in (q, o, do)]
    dq2, dk2, dv2 = persistent_bwd.flash_bwd_persistent(
        sub[0], k, v, sub[1], lse[..., live], sub[2], causal=True, scale=d ** -0.5)
    for x, want in ((dk, dk2), (dv, dv2), (dq[..., live, :], dq2)):
        assert bool(torch.isfinite(x.float()).all()) and row_err(x, want) <= 1e-3


# (b, h, t_q, t_kv, causal): gpt_nano's t=128 (two tiles, the diagonal
# tile's masks) causal and not, both shorter than a tile, ragged q and kv
# causal and not, ragged tiles of unequal length, q the suffix of kv, and
# rows that see no key (causal, t_q > t_kv)
CASES = [
    (2, 2, 128, 128, True),
    (1, 2, 128, 128, False),
    (1, 2, 24, 40, True),
    (1, 2, 200, 264, True),
    (1, 2, 200, 264, False),
    (1, 1, 96, 136, True),
    (1, 2, 64, 256, True),
    (1, 1, 160, 64, True),
]


def _ids(case):
    b, h, tq, tkv, causal = case
    return f"{b}x{h}-q{tq}-kv{tkv}-{'causal' if causal else 'full'}"


@functools.lru_cache(maxsize=None)
def _case(case, d):
    """The bf16 inputs (q, k, v, o, lse, do as torch tensors) and the
    reference's (dq, dk, dv) from its Pallas kernels in interpret mode."""
    b, h, tq, tkv, causal = case
    rng = np.random.RandomState(tq + tkv + d)
    q, k, v, do = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(BF16)
                   for t in (tq, tkv, tkv, tq))
    scale = d ** -0.5
    jq, jk, jv, jdo = (jnp.asarray(t.float().numpy()) for t in (q, k, v, do))
    o32, lse = _flash_attention_tpu(jq, jk, jv, causal=causal, scale=scale, block_q=TILE,
                                    block_k=TILE, interpret=True)
    # out as the card's forward gives it (bf16), the same on both sides
    o = torch.from_numpy(np.array(o32)).to(BF16)
    ref = _flash_attention_tpu_bwd(jq, jk, jv, jnp.asarray(o.float().numpy()), lse, jdo,
                                   causal=causal, scale=scale, block_q=TILE, block_k=TILE,
                                   interpret=True)
    inputs = (q, k, v, o, torch.from_numpy(np.array(lse)), do)
    return inputs, tuple(torch.from_numpy(np.array(x)) for x in ref)


@pytest.mark.parametrize("fn", ["persistent", "plain"])
@pytest.mark.parametrize("d", SMALL_D)
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_small_d_backward_matches_pallas(case, d, fn):
    """The kernels' arithmetic (``persistent_bwd.flash_bwd_persistent``) and
    the plain backward, each on the bf16 inputs, against the TPU backward
    kernels: every row of dq, dk and dv within ``BWD_TOL[bfloat16]``."""
    causal = case[4]
    inputs, ref = _case(case, d)
    backward = (persistent_bwd.flash_bwd_persistent if fn == "persistent"
                else port.flash_attention_bwd_plain)
    got = backward(*inputs, causal=causal, scale=d ** -0.5)
    for name, x, want in zip(("dq", "dk", "dv"), got, ref):
        assert x.dtype == BF16 and x.shape == want.shape, name
        assert bool(torch.isfinite(x.float()).all()), name
        err = row_err(x, want)
        assert err <= BWD_TOL[BF16], f"{name}: worst-row error {err} > {BWD_TOL[BF16]}"
