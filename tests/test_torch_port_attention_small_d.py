"""bf16 attention at head_dim 16 and 32 (gpt_nano's and the tiny flagship's
heads), on the CPU.

``csrc/flash_fwd_persistent.cu`` runs only on the card (``chip_smoke.py``
phases 2 and 4g and the ``cuda``-marked tests of
``tests/test_torch_port_kernels.py`` hold it to the plain forward there).
Here:

* the forward's dispatch table sends bf16 at 16 and 32 to that design at
  64 x 64 tiles and leaves every other entry as it was; the wrapper takes
  the plain forward for CPU tensors without a launch, and the design refuses
  a scale that is not positive;
* the plain forward at the design's tiles against the reference's Pallas
  forward ``_flash_attention_tpu`` in interpret mode at those tiles (8
  cases at each head_dim), row by row: on bf16 inputs (the kernel's) every row of out within
  ``FWD_ROW_TOL[bfloat16]`` (2e-2) of its own norm and lse within
  ``FWD_LSE_TOL[bfloat16]`` (2e-3), the limits the card holds the kernel
  to (the plain version rounds out to bf16, 2^-9 of each element; the
  reference here keeps float32); and the same inputs in float32 on both
  sides within ``FWD_ROW_TOL[float32]`` and ``FWD_LSE_TOL[float32]`` (1e-4,
  summation order only);
* the bf16 gpt_nano train step (float32 parameters, plain kernels) against
  the reference's bf16 ``make_train_step`` from the same weights
  (``models/convert.py``), 3 steps at lr 1e-2 on one batch: loss within
  rtol 1e-3 and grad norm within rtol 1e-2. Both sides round every
  activation to bf16, at other places (XLA fuses and keeps some sums in
  float32); the two read at most 9.6e-5 (loss) and 4.5e-3 (grad norm)
  apart here.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.models import gpt as jgpt
from ray_tpu.models import training as jtr
from ray_tpu.ops.attention import _flash_attention_tpu
from ray_tpu_torch.models import convert, gpt, training
from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops.tolerance import FWD_LSE_TOL, FWD_ROW_TOL, row_err

SMALL_D = (16, 32)
BF16 = torch.bfloat16
LOSS_RTOL = 1e-3
GRAD_NORM_RTOL = 1e-2


def test_fwd_designs_send_bf16_16_and_32_to_the_persistent_design():
    """bf16 at head_dim 16 and 32 runs ``flash_fwd_persistent.cu`` at 64 x 64
    tiles, bound through the entry its table names; every other entry is
    the one it was: bf16 and float16 128/256 on wgmma, bf16 and float16 64
    on d64 at wgmma's 128 x 128, float32 on tf32x3 up to 256, and every
    dtype at 384, 512, 640 and 768 on dcluster128 at 64 x 32."""
    want = {(d, torch.float32): ("tf32x3", "flash_fwd_f32", (64, 64)) for d in port.HEAD_DIMS}
    want.update({(d, dt): ("dcluster128", "flash_fwd_dcluster128", (64, 32))
                 for d in (384, 512, 640, 768) for dt in (torch.float32, BF16)})
    want.update({(16, BF16): ("persistent", "flash_fwd_persistent", (64, 64)),
                 (32, BF16): ("persistent", "flash_fwd_persistent", (64, 64)),
                 (64, BF16): ("d64", "flash_fwd_d64", (128, 128)),
                 (128, BF16): ("wgmma", "flash_fwd_wgmma", (128, 128)),
                 (256, BF16): ("wgmma", "flash_fwd_wgmma", (128, 80))})
    want.update({(d, torch.float16): want[(d, BF16)]
                 for d in (64, 128, 256, 384, 512, 640, 768)})
    got = {key: (dz.name, dz.source, (dz.block_q, dz.block_k))
           for key, dz in port.FWD_DESIGNS.items()}
    assert got == want
    for d in SMALL_D:
        design = port.FWD_DESIGNS[(d, BF16)]
        assert design.entry == "ray_tpu_flash_fwd_persistent"
        assert port.fwd_tiles(d, BF16) == (64, 64)
    assert (port._build.CSRC_DIR / "flash_fwd_persistent.cu").exists()
    assert set(port._SOURCES["flash_fwd_persistent"][0]) == {"ray_tpu_flash_fwd_persistent"}
    assert port._TILES_ENTRIES["persistent"] == "ray_tpu_flash_fwd_persistent_tiles"
    # the counters: one per design on the table, none for the design it replaced
    assert hasattr(port, "flash_fwd_persistent_launches")
    assert not hasattr(port, "flash_fwd_mma_sync_launches")


@pytest.mark.parametrize("d", SMALL_D)
def test_bf16_forward_on_cpu_takes_the_plain_version_and_counts_nothing(d):
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(2, 4, 72, d).astype(np.float32)).to(BF16)
               for _ in range(3))
    counters = [name for name in dir(port) if name.startswith("flash_fwd")
                and name.endswith("_launches")]
    before = {name: getattr(port, name) for name in counters}
    got = port.flash_attention_fwd(q, k, v, causal=True, scale=d ** -0.5)
    want = port.flash_attention_fwd_plain(q, k, v, causal=True, scale=d ** -0.5)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert got[0].dtype == BF16 and got[1].dtype == torch.float32
    assert {name: getattr(port, name) for name in counters} == before


@pytest.mark.parametrize("scale", [0.0, -0.25])
def test_persistent_design_refuses_a_scale_that_is_not_positive(scale):
    """The kernel takes the row max of the raw scores and folds the scale
    into exp2 after it, which holds for a positive scale only: its launcher
    refuses any other, and the wrapper hands it a positive one with the
    same scores (``_positive_scale``: -q and -scale, or zeros and 1)."""
    assert port.FWD_DESIGNS[(16, BF16)].name in port._POSITIVE_SCALE
    launcher = (port._build.CSRC_DIR / "flash_fwd_persistent.cu").read_text()
    assert "!(scale > 0.f)" in launcher
    q = torch.from_numpy(np.random.RandomState(2).randn(1, 2, 8, 16).astype(np.float32)).to(BF16)
    q2, scale2 = port._positive_scale(q, scale)
    assert scale2 > 0 and q2.dtype == BF16
    assert torch.equal(q2.float() * scale2, q.float() * scale)


# (b, h, t_q, t_kv, causal): gpt_nano's t=128 (two q tiles, the diagonal
# tile's masks) causal and not, both shorter than a tile, non-causal and
# causal ragged pairs, ragged q and kv of unequal length, q the suffix of
# kv, and rows that see no key (causal, t_q > t_kv)
CASES = [
    (2, 2, 128, 128, True),
    (1, 2, 128, 128, False),
    (1, 2, 24, 40, True),
    (1, 2, 200, 264, False),
    (1, 2, 200, 264, True),
    (1, 1, 96, 136, True),
    (1, 2, 64, 256, True),
    (1, 1, 160, 64, True),
]


def _ids(case):
    b, h, tq, tkv, causal = case
    return f"{b}x{h}-q{tq}-kv{tkv}-{'causal' if causal else 'full'}"


@pytest.mark.parametrize("d", SMALL_D)
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_plain_forward_at_the_persistent_tiles_matches_pallas(case, d):
    b, h, tq, tkv, causal = case
    rng = np.random.RandomState(tq + d)
    # the kernel's inputs: bf16 values, handed to the reference in float32
    q, k, v = (torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(BF16)
               for t in (tq, tkv, tkv))
    scale = d ** -0.5
    block_q, block_k = port.fwd_tiles(d, BF16)
    ref_o, ref_lse = (torch.from_numpy(np.array(x)) for x in _flash_attention_tpu(
        *(jnp.asarray(t.float().numpy()) for t in (q, k, v)), causal=causal, scale=scale,
        block_q=block_q, block_k=block_k, interpret=True))
    o, lse = port.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
    assert o.dtype == BF16 and o.shape == ref_o.shape
    assert row_err(o, ref_o) <= FWD_ROW_TOL[BF16]
    assert float((lse - ref_lse).abs().max()) <= FWD_LSE_TOL[BF16]
    o32, lse32 = port.flash_attention_fwd_plain(q.float(), k.float(), v.float(),
                                                causal=causal, scale=scale,
                                                block_q=block_q, block_k=block_k)
    assert row_err(o32, ref_o) <= FWD_ROW_TOL[torch.float32]
    assert float((lse32 - ref_lse).abs().max()) <= FWD_LSE_TOL[torch.float32]


def test_bf16_gpt_nano_train_step_tracks_jax():
    """gpt_nano in bf16 compute with float32 parameters, as phase 4g trains
    it on the card, against the reference's step from the same weights."""
    variables = jgpt.GPT(jgpt.gpt_nano()).init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 8), jnp.int32))
    tree = jax.tree_util.tree_map(np.asarray, jgpt.unboxed_params(variables))
    tokens = np.random.RandomState(8).randint(0, 256, (2, 128)).astype(np.int32)
    # gpt_nano sets dtype itself (float32), in both packages
    jcfg = dataclasses.replace(jgpt.gpt_nano(), dtype=jnp.bfloat16)
    cfg = dataclasses.replace(gpt.gpt_nano(), dtype=BF16)
    tx = jtr.default_optimizer(1e-2)
    jstate = jtr.TrainState(step=jnp.zeros((), jnp.int32),
                            params=jax.tree_util.tree_map(jnp.asarray, tree),
                            opt_state=tx.init(tree))
    jstep = jtr.make_train_step(jcfg, tx, donate=False)
    opt = training.default_optimizer(1e-2)
    state = training.init_train_state(convert.params_from_jax(tree, cfg, device="cpu"), opt)
    assert {p.dtype for p in state.params.values()} == {torch.float32}
    step = training.make_train_step(cfg, opt, device="cpu")
    losses = []
    for _ in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(tokens))
        state, m = step(state, torch.from_numpy(tokens))
        np.testing.assert_allclose(float(m["loss"]), float(jm["loss"]), rtol=LOSS_RTOL)
        np.testing.assert_allclose(float(m["grad_norm"]), float(jm["grad_norm"]),
                                   rtol=GRAD_NORM_RTOL)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]
