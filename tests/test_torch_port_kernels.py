"""The port's Hopper kernels against their plain PyTorch versions.

This file imports neither JAX nor ``ray_tpu``, so that it runs on a machine
with a card and no JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_kernels.py -q

The tests marked ``cuda`` skip where ``torch.cuda.is_available()`` is false.
The CPU tests check what the wrapper does without a card.
"""

import numpy as np
import pytest
import torch

from ray_tpu_torch.ops import attention as port
from ray_tpu_torch.ops.tolerance import BWD_TOL, FWD_LSE_TOL, FWD_ROW_TOL, row_err

# (b, h, t_q, t_kv, d, causal): the cases of tests/test_torch_port_attention.py
# and two shapes of the wgmma backward (tests/test_torch_port_attention_bwd.py)
CASES = [
    (2, 2, 128, 128, 128, True),
    (2, 2, 128, 128, 128, False),
    (1, 2, 64, 256, 128, True),     # chunked prefill: q is the suffix
    (1, 1, 64, 72, 128, False),     # ragged kv, tiles of 64
    (1, 1, 64, 72, 128, True),
    (1, 1, 160, 64, 128, True),     # t_q > t_kv: leading rows see nothing
    (1, 2, 24, 40, 16, True),       # both shorter than a tile
    (1, 2, 96, 136, 64, True),      # ragged q and kv
    (1, 2, 130, 130, 32, True),
    (1, 1, 200, 264, 256, True),
    (1, 2, 160, 64, 64, True),      # t_q > t_kv at head_dim 64 (the wgmma backward)
    (2, 2, 384, 384, 128, False),   # three full q tiles of 128, non-causal
]
# head_dim 256 for the backward (the wgmma split dK/dV kernel and the dQ
# kernel's 48-row kv tiles; CASES has the ragged 200 x 264): b=2 causal,
# non-causal with a ragged q tile, q the suffix, rows that see no key
BWD_D256_CASES = [
    (2, 2, 256, 256, 256, True),
    (1, 2, 192, 192, 256, False),
    (1, 2, 64, 320, 256, True),
    (1, 1, 160, 64, 256, True),
]
# the tolerances and why: ray_tpu_torch/ops/tolerance.py


def _ids(case):
    b, h, tq, tkv, d, causal = case
    return f"{b}x{h}-q{tq}-kv{tkv}-d{d}-{'causal' if causal else 'full'}"


def _qkv(b, h, tq, tkv, d, device="cpu", dtype=torch.float32, seed=0):
    rng = np.random.RandomState(seed)
    return tuple(
        torch.from_numpy(rng.randn(b, h, t, d).astype(np.float32)).to(device, dtype)
        for t in (tq, tkv, tkv))


def _bwd_inputs(b, h, tq, tkv, d, causal, device, dtype, seed=0):
    """q, k, v, the forward's out and lse, and a gradient of out."""
    q, k, v = _qkv(b, h, tq, tkv, d, device=device, dtype=dtype, seed=seed)
    scale = 1.0 / d ** 0.5
    o, lse = port.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    do = torch.from_numpy(np.random.RandomState(seed + 1).randn(b, h, tq, d)
                          .astype(np.float32)).to(device, dtype)
    return q, k, v, o, lse, do, scale


def _assert_grads_close(got, want, tol):
    """Each row of dq, dk and dv within ``tol`` of its own norm."""
    for name, x, ref in zip(("dq", "dk", "dv"), got, want):
        assert x.dtype == ref.dtype and x.shape == ref.shape, name
        err = row_err(x, ref)
        assert err <= tol, f"{name}: worst-row error {err} > {tol}"


def test_row_err_holds_each_row_to_its_own_norm():
    """The backward's comparison: bf16 rounding of the gradients passes, a
    dK/dV pass that skips the last q tile fails, and a row that is 0 in the
    reference and rounding noise in the kernel's result does not count."""
    q, k, v, o, lse, do, scale = _bwd_inputs(1, 2, 512, 512, 64, True, "cpu",
                                             torch.float32)
    want = port.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                          scale=scale)
    for x in want:
        assert row_err(x.to(torch.bfloat16), x) <= BWD_TOL[torch.bfloat16] / 4
    do_skipped = do.clone()
    do_skipped[:, :, -64:] = 0  # what the last q tile adds to dk and dv
    _, dk, dv = port.flash_attention_bwd_plain(q, k, v, o, lse, do_skipped,
                                               causal=True, scale=scale)
    assert row_err(dk, want[1]) > 0.5 and row_err(dv, want[2]) > 0.5
    zero_row = want[0].clone()
    zero_row[..., 0, :] = 0
    noisy = zero_row.clone()
    noisy[..., 0, :] = 1e-6
    assert row_err(noisy, zero_row) <= BWD_TOL[torch.float32]


def test_fwd_row_err_tells_a_v_fault_from_rounding():
    """The forward's comparison at b=1 h=2 t=2048 d=128, causal: bf16
    rounding of the output reads under a quarter of the limit, and half of V
    in one mid kv tile, seen only by the last q tile (a pipeline stage read
    at the wrong time), reads over five times the limit."""
    q, k, v = _qkv(1, 2, 2048, 2048, 128, seed=7)
    scale = 1.0 / 128 ** 0.5
    ref, _ = port.flash_attention_fwd_plain(q, k, v, causal=True, scale=scale)
    tol = FWD_ROW_TOL[torch.bfloat16]
    assert row_err(ref.to(torch.bfloat16), ref) <= tol / 4
    v_fault = v.clone()
    v_fault[:, :, 1024:1088] *= 0.5
    faulty, _ = port.flash_attention_fwd_plain(q, k, v_fault, causal=True, scale=scale)
    out = ref.clone()
    out[:, :, -64:] = faulty[:, :, -64:]
    assert row_err(out, ref) > 5 * tol


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def test_kernel_wrapper_takes_the_plain_version_on_cpu():
    q, k, v = _qkv(1, 2, 72, 72, 64)
    before = port.flash_fwd_launches
    o, lse = port.flash_attention_fwd(q, k, v, causal=True, scale=0.125)
    ref_o, ref_lse = port.flash_attention_fwd_plain(q, k, v, causal=True,
                                                    scale=0.125)
    assert torch.equal(o, ref_o) and torch.equal(lse, ref_lse)
    assert port.flash_fwd_launches == before


def test_kernel_wrapper_refuses_tensors_off_cpu_and_cuda():
    q, k, v = (t.to("meta") for t in _qkv(1, 1, 64, 64, 64))
    with pytest.raises(ValueError, match="needs CUDA"):
        port.flash_attention_fwd(q, k, v, causal=True, scale=0.125)
    with pytest.raises(ValueError, match="tiles"):
        port.flash_attention_fwd(q, k, v, causal=True, scale=0.125, block_q=128)
    lse = torch.empty(1, 1, 64, device="meta")
    with pytest.raises(ValueError, match="needs CUDA"):
        port.flash_attention_bwd(q, k, v, q, lse, q, causal=True, scale=0.125)


def test_bwd_designs_cover_every_head_dim_and_dtype():
    """The backward's dispatch table names a design for every head_dim the
    kernels take in both dtypes, each from a source the port builds, with
    entry points that source binds; bf16 at head_dim 128 and 256 (gpt_1b's
    and gpt_j_6b's) runs the wgmma kernels, bf16 at 64 (gpt_125m's) d64's
    dQ and dK/dV, bf16 at 16 and 32 (gpt_nano's and the tiny flagship's) the
    persistent ones, bf16 at 384, 512, 640 and 768 the wide ones; float16 at
    64, 128, 256, 384, 512, 640 and 768 the bf16 kernels' float16 builds;
    every other key the plain design."""
    wide = {384, 512, 640, 768}
    keys = {(d, dt) for d in port.HEAD_DIMS for dt in (torch.bfloat16, torch.float32)}
    keys |= {(d, torch.float16) for d in {64, 128, 256} | wide}
    assert set(port.BWD_DESIGNS) == keys
    for design in port.BWD_DESIGNS.values():
        for kernel in (design.dq, design.dkv):
            entries, _ = port._SOURCES[kernel.source]
            assert (port._build.CSRC_DIR / f"{kernel.source}.cu").exists()
            assert kernel.entry in entries
    for kernel, name, head_dims in (("dq", "wgmma", {128, 256}),
                                    ("dkv", "wgmma", {128, 256}), ("dq", "d64", {64}),
                                    ("dkv", "d64", {64}), ("dq", "wide", wide),
                                    ("dkv", "wide", wide),
                                    ("dq", "persistent", {16, 32}),
                                    ("dkv", "persistent", {16, 32})):
        assert {d for (d, dt), design in port.BWD_DESIGNS.items()
                if getattr(design, kernel).name == name} == head_dims
        assert {dt for (d, dt), design in port.BWD_DESIGNS.items()
                if getattr(design, kernel).name == name} == (
            {torch.bfloat16} if name == "persistent" else {torch.bfloat16, torch.float16})
    assert port.BWD_DESIGNS[(48, torch.bfloat16)] is port.BWD_DESIGNS.plain
    assert port.BWD_DESIGNS[(16, torch.float16)] is port.BWD_DESIGNS.plain


def test_bwd_wrapper_takes_the_plain_version_on_cpu():
    q, k, v, o, lse, do, scale = _bwd_inputs(1, 2, 72, 72, 64, True, "cpu",
                                             torch.float32)
    before = (port.flash_bwd_dq_launches, port.flash_bwd_dkv_launches)
    got = port.flash_attention_bwd(q, k, v, o, lse, do, causal=True, scale=scale)
    want = port.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True,
                                          scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert (port.flash_bwd_dq_launches, port.flash_bwd_dkv_launches) == before


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_flash_kernel_matches_plain_on_card(card, case, dtype):
    """Out and lse of the Hopper kernel that the dispatch table names
    against its plain version (at the same tiles) on the same device
    tensors, every row included."""
    b, h, tq, tkv, d, causal = case
    dt = getattr(torch, dtype)
    q, k, v = _qkv(b, h, tq, tkv, d, device=card, dtype=dt)
    scale = 1.0 / d ** 0.5
    counter = f"flash_fwd_{port.FWD_DESIGNS[(d, dt)].name}_launches"
    before = (port.flash_fwd_launches, getattr(port, counter))
    o, lse = port.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    assert (port.flash_fwd_launches, getattr(port, counter)) == (
        before[0] + 1, before[1] + 1)
    ref_o, ref_lse = port.flash_attention_fwd_plain(q, k, v, causal=causal,
                                                    scale=scale)
    torch.cuda.synchronize()
    assert o.dtype == dt and lse.dtype == torch.float32
    err = row_err(o, ref_o)
    assert err <= FWD_ROW_TOL[dt], f"out: worst-row error {err} > {FWD_ROW_TOL[dt]}"
    torch.testing.assert_close(lse, ref_lse, atol=FWD_LSE_TOL[dt], rtol=1e-6)


@pytest.mark.cuda
@pytest.mark.parametrize("d", port.HEAD_DIMS)
def test_float32_forward_launches_the_tf32x3_kernel_on_card(card, d):
    """float32 at every head_dim up to 256 goes through the 3xTF32 kernel
    (and at 384 to 768 through dcluster128's 3xTF32 build): one launch on
    its counter and none on the bf16 designs', causal with t_q > t_kv and
    ragged tiles, every row within the float32 limits of the plain
    forward."""
    q, k, v = _qkv(1, 2, 136, 72, d, device=card, dtype=torch.float32)
    design = port.FWD_DESIGNS[(d, torch.float32)].name
    assert design == ("dcluster128" if d in port.WIDE_HEAD_DIMS else "tf32x3")
    counters = ("flash_fwd_launches", f"flash_fwd_{design}_launches",
                "flash_fwd_persistent_launches", "flash_fwd_wgmma_launches")
    before = [getattr(port, c) for c in counters]
    out = port.dot_product_attention(q, k, v, causal=True)
    assert [getattr(port, c) - b for c, b in zip(counters, before)] == [1, 1, 0, 0]
    plain, _ = port.flash_attention_fwd_plain(q, k, v, causal=True, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert row_err(out, plain) <= FWD_ROW_TOL[torch.float32]


# bf16 at head_dim 16 and 32 (the persistent design): gpt_nano's t=128 at a
# batch of 8, long t, ragged q and kv (causal and not), q the suffix of kv,
# rows that see no key
SMALL_D_CASES = [
    (8, 4, 128, 128, 16, True),
    (1, 4, 2048, 2048, 16, True),
    (2, 8, 200, 264, 32, True),
    (2, 4, 200, 264, 16, False),
    (2, 8, 64, 256, 32, True),
    (1, 8, 160, 64, 32, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", SMALL_D_CASES, ids=_ids)
def test_small_d_forward_launches_the_persistent_kernel_on_card(card, case):
    """bf16 at head_dim 16 and 32 goes through the persistent kernel: one
    launch on its counter, every row of out and lse within the bf16 limits
    of the plain forward at the same tiles."""
    b, h, tq, tkv, d, causal = case
    q, k, v = _qkv(b, h, tq, tkv, d, device=card, dtype=torch.bfloat16)
    counters = ("flash_fwd_launches", "flash_fwd_persistent_launches",
                "flash_fwd_wgmma_launches", "flash_fwd_tf32x3_launches")
    before = [getattr(port, c) for c in counters]
    o, lse = port.flash_attention_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    assert [getattr(port, c) - n for c, n in zip(counters, before)] == [1, 1, 0, 0]
    ref_o, ref_lse = port.flash_attention_fwd_plain(q, k, v, causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert row_err(o, ref_o) <= FWD_ROW_TOL[torch.bfloat16]
    torch.testing.assert_close(lse, ref_lse, atol=FWD_LSE_TOL[torch.bfloat16], rtol=1e-6)


@pytest.mark.cuda
def test_dispatcher_launches_the_kernel_on_card(card):
    q, k, v = _qkv(2, 4, 80, 80, 64, device=card, dtype=torch.bfloat16)
    before = port.flash_fwd_launches
    out = port.dot_product_attention(q, k, v, causal=True)
    assert port.flash_fwd_launches == before + 1
    plain, _ = port.flash_attention_fwd_plain(q, k, v, causal=True, scale=0.125)
    assert row_err(out, plain) <= FWD_ROW_TOL[torch.bfloat16]


def _on_card_matches_cpu(card, shape, dtype, designs, scale=None):
    """``dot_product_attention`` with a backward, on the card and on the
    CPU: one forward, one dQ and one dK/dV launch on the counters of
    ``designs`` (forward, dQ, dK/dV) and none on any other design's, and out
    and the gradients within ``dtype``'s limits of the CPU's. The plain
    design is the same function on both sides, so its gradients are held to
    the CPU's own; the kernels' gradients are held to their plain backward
    on the CPU from the card's out, since the backward reads out through
    delta = rowsum(dO * O), where a row with few keys cancels, and the
    forward kernel's rounding of P moves out within its limit but such a
    row's dq by more than the backward's."""
    cpu = [t.requires_grad_() for t in _qkv(*shape[:5], dtype=dtype, seed=11)]
    dev = [t.detach().to(card).requires_grad_() for t in cpu]
    g = torch.from_numpy(np.random.RandomState(12).randn(*shape[:3], shape[4])
                         .astype(np.float32)).to(dtype)
    names = ["flash_fwd_launches", f"flash_fwd_{designs[0]}_launches",
             "flash_bwd_dq_launches", f"flash_bwd_dq_{designs[1]}_launches",
             "flash_bwd_dkv_launches", f"flash_bwd_dkv_{designs[2]}_launches"]
    kernels = [n for n in dir(port) if n.endswith("_launches") and n not in names]
    before = [getattr(port, n) for n in names + kernels]
    out = port.dot_product_attention(*dev, causal=shape[5], scale=scale)
    out.backward(g.to(card))
    assert [getattr(port, n) - b for n, b in zip(names + kernels, before)] == (
        [1] * len(names) + [0] * len(kernels))
    out_cpu = port.dot_product_attention(*cpu, causal=shape[5], scale=scale)
    out_cpu.backward(g)
    assert row_err(out.detach().cpu(), out_cpu.detach()) <= FWD_ROW_TOL[dtype]
    want = [t.grad for t in cpu]
    if designs != ("plain",) * 3:
        qkv = [t.detach() for t in cpu]
        s = shape[4] ** -0.5 if scale is None else scale
        _, lse = port.flash_attention_fwd_plain(*qkv, causal=shape[5], scale=s)
        want = port.flash_attention_bwd_plain(*qkv, out.detach().cpu(), lse, g,
                                              causal=shape[5], scale=s)
    _assert_grads_close([t.grad.cpu() for t in dev], want, BWD_TOL[dtype])


def _plain_on_card_matches_cpu(card, shape, dtype, scale=None):
    """``_on_card_matches_cpu`` of inputs that no kernel takes: every launch
    on the plain design."""
    _on_card_matches_cpu(card, shape, dtype, ("plain",) * 3, scale=scale)


@pytest.mark.cuda
def test_dispatcher_raises_for_what_the_kernel_does_not_take(card):
    """The refusals left are the tiles, and a dtype that no kernel takes
    where the reference runs its Pallas kernel (float64); head_dim 896, the
    first past the wide designs, runs the dcluster forward and backward
    (the tables' rule);
    a non-positive scale runs the kernels (the forward's sign handed to q;
    the dcluster128 forward at 384 and dcluster's at 896 too), float16 at 64 the d64
    kernels, head_dim 48 and float16 at 16 the plain design, each as on the
    CPU."""
    q, k, v = _qkv(1, 2, 64, 64, 64, device=card, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="tiles"):
        port.dot_product_attention(q, k, v, block_q=64, block_k=64)
    with pytest.raises(ValueError, match="no Hopper kernel takes torch.float64"):
        port.dot_product_attention(*_qkv(1, 1, 64, 64, 128, device=card, dtype=torch.float64))
    by_rule = ("dcluster", "dcluster", "dcluster")
    _on_card_matches_cpu(card, (1, 2, 64, 64, 896, True), torch.bfloat16, by_rule)
    _on_card_matches_cpu(card, (1, 2, 64, 96, 896, True), torch.float32, by_rule, scale=-0.03)
    d64 = ("d64",) * 3
    _on_card_matches_cpu(card, (1, 2, 64, 64, 64, True), torch.bfloat16, d64, scale=-0.125)
    _on_card_matches_cpu(card, (1, 2, 64, 64, 16, True), torch.bfloat16, ("persistent",) * 3,
                         scale=-0.25)
    _on_card_matches_cpu(card, (1, 2, 96, 96, 128, True), torch.bfloat16, ("wgmma",) * 3,
                         scale=0.0)
    _on_card_matches_cpu(card, (1, 2, 64, 96, 384, True), torch.bfloat16,
                         ("dcluster128", "wide", "wide"), scale=-0.05)
    # inputs that require grad go through the FlashAttention Function
    out = port.dot_product_attention(q.clone().requires_grad_(), k, v)
    assert "FlashAttention" in type(out.grad_fn).__name__
    _plain_on_card_matches_cpu(card, (1, 1, 64, 64, 48, True), torch.bfloat16)
    _on_card_matches_cpu(card, (1, 1, 64, 64, 64, True), torch.float16, d64)
    _plain_on_card_matches_cpu(card, (1, 1, 64, 64, 16, True), torch.float16)


# bf16 at head_dim 64 (the d64 forward and dK/dV, wgmma's dQ): gpt_125m's
# heads (12 x 64, t=2048, causal) at b=4 and at bench.py's b=16, and ragged t
D64_CASES = [
    (4, 12, 2048, 2048, 64, True),
    (16, 12, 2048, 2048, 64, True),
    (2, 3, 200, 264, 64, True),
    (1, 4, 320, 200, 64, True),     # t_q > t_kv: leading rows see nothing
    (2, 2, 136, 136, 64, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", D64_CASES, ids=_ids)
def test_d64_kernels_match_plain_on_card(card, case):
    """bf16 at head_dim 64: the forward on the d64 design and the backward
    on d64's dQ and dK/dV, one launch of each on those counters and
    none on the other designs', every row of out, lse, dq, dk and dv within
    the bf16 limits of the plain versions (the forward at the table's 128 x
    128 tiles), and the same bits from a second run."""
    b, h, tq, tkv, d, causal = case
    q, k, v = _qkv(b, h, tq, tkv, d, device=card, dtype=torch.bfloat16)
    fwd = ["flash_fwd_launches", "flash_fwd_d64_launches", "flash_fwd_wgmma_launches",
           "flash_fwd_plain_launches"]
    before = [getattr(port, c) for c in fwd]
    o, lse = port.flash_attention_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    assert [getattr(port, c) - n for c, n in zip(fwd, before)] == [1, 1, 0, 0]
    ref_o, ref_lse = port.flash_attention_fwd_plain(q, k, v, causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert row_err(o, ref_o) <= FWD_ROW_TOL[torch.bfloat16]
    torch.testing.assert_close(lse, ref_lse, atol=FWD_LSE_TOL[torch.bfloat16], rtol=1e-6)
    assert all(torch.equal(a, b_) for a, b_ in zip(
        (o, lse), port.flash_attention_fwd(q, k, v, causal=causal, scale=d ** -0.5)))
    do = torch.from_numpy(np.random.RandomState(1).randn(b, h, tq, d).astype(np.float32)).to(
        card, torch.bfloat16)
    bwd = ["flash_bwd_dq_d64_launches", "flash_bwd_dkv_d64_launches",
           "flash_bwd_dkv_wgmma_launches", "flash_bwd_dq_plain_launches"]
    before = [getattr(port, c) for c in bwd]
    got = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=d ** -0.5)
    assert [getattr(port, c) - n for c, n in zip(bwd, before)] == [1, 1, 0, 0]
    want = port.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in got)
    _assert_grads_close(got, want, BWD_TOL[torch.bfloat16])
    again = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=d ** -0.5)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))  # no atomics


@pytest.mark.cuda
def test_d64_forwards_on_two_streams_keep_their_own_items(card):
    """Two d64 forwards launched on two streams at once (together more CTAs
    than the card holds, so the second starts while the first runs): each
    launch hands out the items of its own counter, so both give the bits
    that each gives alone, three times over."""
    scale = 0.125
    inputs = [_qkv(1, 12, 1024, 1024, 64, device=card, dtype=torch.bfloat16, seed=1),
              _qkv(1, 8, 1024, 1024, 64, device=card, dtype=torch.bfloat16, seed=2)]
    alone = [port.flash_attention_fwd(*x, causal=True, scale=scale) for x in inputs]
    torch.cuda.synchronize()
    streams = [torch.cuda.Stream(), torch.cuda.Stream()]
    before = port.flash_fwd_d64_launches
    for _ in range(3):
        got = []
        for stream, x in zip(streams, inputs):
            with torch.cuda.stream(stream):
                got.append(port.flash_attention_fwd(*x, causal=True, scale=scale))
        torch.cuda.synchronize()
        for (o, lse), (o1, lse1) in zip(got, alone):
            assert torch.equal(o, o1) and torch.equal(lse, lse1)
    assert port.flash_fwd_d64_launches == before + 6


# head_dims 384 to 768 (the dcluster128 forward in every dtype at 64 x 32
# tiles; the wide backward in bf16 and float16, the dcluster128 backward in
# float32): ragged q and kv, lengths that are
# not multiples of 8 (the reference takes _attention_xla there; the kernels
# run, as at 64-256), rows that see no key (some in a q tile that runs kv
# tile 0), non-causal with a ragged tile, two full heads
WIDE_CASES = [
    (1, 2, 200, 264, 384, True),
    (1, 2, 60, 76, 512, True),      # lengths that are not multiples of 8
    (1, 2, 112, 64, 512, True),
    (1, 2, 136, 136, 512, False),
    (2, 2, 256, 256, 384, True),
    (1, 2, 200, 264, 640, True),
    (1, 2, 112, 64, 640, True),
    (1, 2, 60, 76, 768, True),
    (1, 2, 104, 72, 768, True),
    (1, 2, 136, 136, 768, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("case", WIDE_CASES, ids=_ids)
def test_wide_head_dim_kernels_match_plain_on_card(card, case, dtype):
    """At head_dims 384 to 768 the forward, dQ and dK/dV kernels of the
    designs the tables name (the dcluster128 forward; the wide dQ and dK/dV,
    in float32 the dcluster128 ones) launch once each on
    their counters (and on their head_dim's) and none on plain, every row of
    out, lse, dq, dk and dv within the dtype's limits of the plain versions
    (the forward at the table's tiles; the backward in float64 for float32,
    as the smoke script's phase 3 holds it), and a second run gives the same
    bits."""
    b, h, tq, tkv, d, causal = case
    dt = getattr(torch, dtype)
    q, k, v = _qkv(b, h, tq, tkv, d, device=card, dtype=dt)
    fwd, bwd = port.FWD_DESIGNS[(d, dt)], port.BWD_DESIGNS[(d, dt)]
    assert (fwd.name, bwd.dq.name, bwd.dkv.name) == (
        ("dcluster128",) * 3 if dt == torch.float32 else ("dcluster128", "wide", "wide"))
    names = ["flash_fwd_plain_launches", "flash_bwd_dq_plain_launches",
             f"flash_fwd_{fwd.name}_launches", f"flash_bwd_dq_{bwd.dq.name}_launches",
             f"flash_bwd_dkv_{bwd.dkv.name}_launches"]
    by_d = [f"flash_fwd_{fwd.name}_d{d}", f"flash_bwd_dq_{bwd.dq.name}_d{d}",
            f"flash_bwd_dkv_{bwd.dkv.name}_d{d}"]
    before = [getattr(port, n) for n in names]
    before_d = [port.launches_by_head_dim[n] for n in by_d]
    scale = d ** -0.5
    o, lse = port.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    do = torch.from_numpy(np.random.RandomState(1).randn(b, h, tq, d).astype(np.float32)).to(
        card, dt)
    got = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    assert [getattr(port, n) - c for n, c in zip(names, before)] == [0, 0, 1, 1, 1]
    assert [port.launches_by_head_dim[n] - c for n, c in zip(by_d, before_d)] == [1, 1, 1]
    ref_o, ref_lse = port.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
    exact = torch.float64 if dt == torch.float32 else dt
    want = [w.to(dt) for w in port.flash_attention_bwd_plain(
        *(x.to(exact) for x in (q, k, v, o, lse, do)), causal=causal, scale=scale)]
    torch.cuda.synchronize()
    assert row_err(o, ref_o) <= FWD_ROW_TOL[dt]
    torch.testing.assert_close(lse, ref_lse, atol=FWD_LSE_TOL[dt], rtol=1e-6)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    _assert_grads_close(got, want, BWD_TOL[dt])
    again = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))  # no atomics


# the dcluster128 forward (head_dims 384 to 768, every dtype): each cluster
# size of its plan (3 to 6) causal over two q tiles, rows that see no key
# (t_q 160 against t_kv 64: rows 0-63 in a q tile that skips every kv tile),
# q the suffix of a longer kv, non-causal with ragged tiles, both shorter
# than a tile, three heads at t 300, and two full heads at 2 x 8 x 2048^2
DCLUSTER128_FWD_CASES = [
    *[(1, 2, 128, 128, d, True) for d in (384, 512, 640, 768)],
    (1, 2, 160, 64, 384, True),
    (1, 2, 40, 120, 640, True),
    (1, 2, 104, 72, 768, False),
    (1, 2, 24, 20, 512, True),
    (1, 3, 300, 300, 640, True),
    (2, 8, 2048, 2048, 640, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("case", DCLUSTER128_FWD_CASES, ids=_ids)
def test_dcluster128_forward_matches_plain_and_repeats_its_bits_on_card(card, case, dtype):
    """The dcluster128 forward (bf16 and float16 on wgmma, float32 in 3xTF32)
    at each cluster size and edge: one launch a call on its counter and on
    its head_dim's, none on tf32x3's or plain's, every row
    of out within the dtype's limit of the plain forward at its 64 x 32
    tiles (rows that see no key too: 0 and NEG_INF where the q tile skips
    every kv tile), lse within its limit, and a second run bit-equal (each
    row's 2 C partials summed in column order by one reducer, no
    atomics)."""
    b, h, tq, tkv, d, causal = case
    dt = getattr(torch, dtype)
    q, k, v = _qkv(b, h, tq, tkv, d, device=card, dtype=dt)
    names = ["flash_fwd_dcluster128_launches", "flash_fwd_tf32x3_launches",
             "flash_fwd_plain_launches"]
    before = [getattr(port, n) for n in names]
    before_d = port.launches_by_head_dim[f"flash_fwd_dcluster128_d{d}"]
    o, lse = port.flash_attention_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    o2, lse2 = port.flash_attention_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    assert [getattr(port, n) - c for n, c in zip(names, before)] == [2, 0, 0]
    assert port.launches_by_head_dim[f"flash_fwd_dcluster128_d{d}"] - before_d == 2
    ref_o, ref_lse = port.flash_attention_fwd_plain(q, k, v, causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o).all())
    assert row_err(o, ref_o) <= FWD_ROW_TOL[dt]
    torch.testing.assert_close(lse, ref_lse, atol=FWD_LSE_TOL[dt], rtol=1e-6)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    if causal and min(64, tq) - 1 < tq - tkv:  # the first q tile skips every kv tile
        assert bool((o[..., :64, :] == 0).all()) and bool((lse[..., :64] == port.NEG_INF).all())


# head_dims from 896 up (the tables' rule: the dcluster forward at 64 x 32
# tiles and the dcluster backward, in bf16, float16 and float32): the CPU
# tests' length cases
# (tests/test_torch_port_attention_dsplit.py) at 896 and 1152 (9 chunks of
# 128 columns, 4.5 column groups), rows that see no key in a q tile that
# skips every kv tile, two full heads at 1024, and 2048 and 4096
DSPLIT_CASES = [
    (1, 2, 128, 128, 896, True),
    (1, 2, 40, 120, 896, True),
    (1, 2, 112, 64, 896, True),
    (1, 2, 104, 72, 896, False),
    (1, 2, 128, 128, 1152, True),
    (1, 2, 40, 120, 1152, True),
    (1, 2, 112, 64, 1152, True),
    (1, 2, 104, 72, 1152, False),
    (1, 2, 160, 64, 1152, True),
    (2, 2, 256, 256, 1024, True),
    (1, 2, 128, 128, 2048, True),
    (1, 2, 64, 64, 4096, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("case", DSPLIT_CASES, ids=_ids)
def test_dsplit_kernels_match_plain_on_card(card, case, dtype):
    """From 896 up the dcluster forward, dQ and dK/dV launch
    once each on their counters (and on their head_dim's) and none on plain,
    every row of out, lse, dq, dk and dv within the dtype's limits of the
    plain versions (the forward at the table's 64 x 32 tiles; the backward
    in float64 for float32), and a second run gives the same bits."""
    b, h, tq, tkv, d, causal = case
    dt = getattr(torch, dtype)
    q, k, v = _qkv(b, h, tq, tkv, d, device=card, dtype=dt)
    fwd, bwd = port.FWD_DESIGNS[(d, dt)], port.BWD_DESIGNS[(d, dt)]
    assert (fwd.name, bwd.dq.name, bwd.dkv.name) == ("dcluster", "dcluster", "dcluster")
    names = ["flash_fwd_plain_launches", "flash_bwd_dq_plain_launches",
             "flash_fwd_dcluster_launches", "flash_bwd_dq_dcluster_launches",
             "flash_bwd_dkv_dcluster_launches"]
    by_d = [f"flash_fwd_dcluster_d{d}", f"flash_bwd_dq_dcluster_d{d}",
            f"flash_bwd_dkv_dcluster_d{d}"]
    before = [getattr(port, n) for n in names]
    before_d = [port.launches_by_head_dim[n] for n in by_d]
    scale = d ** -0.5
    o, lse = port.flash_attention_fwd(q, k, v, causal=causal, scale=scale)
    do = torch.from_numpy(np.random.RandomState(1).randn(b, h, tq, d).astype(np.float32)).to(
        card, dt)
    got = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    assert [getattr(port, n) - c for n, c in zip(names, before)] == [0, 0, 1, 1, 1]
    assert [port.launches_by_head_dim[n] - c for n, c in zip(by_d, before_d)] == [1, 1, 1]
    ref_o, ref_lse = port.flash_attention_fwd_plain(q, k, v, causal=causal, scale=scale)
    exact = torch.float64 if dt == torch.float32 else dt
    want = [w.to(dt) for w in port.flash_attention_bwd_plain(
        *(x.to(exact) for x in (q, k, v, o, lse, do)), causal=causal, scale=scale)]
    torch.cuda.synchronize()
    assert row_err(o, ref_o) <= FWD_ROW_TOL[dt]
    torch.testing.assert_close(lse, ref_lse, atol=FWD_LSE_TOL[dt], rtol=1e-6)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    _assert_grads_close(got, want, BWD_TOL[dt])
    again = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_every_head_dim_the_reference_takes_runs_a_kernel_on_card(card, dtype):
    """Every multiple of 128 from 896 to 8192 at (1, 1, 64, 64), causal,
    through ``dot_product_attention`` with a backward: no refusal, one
    launch of the dcluster forward and of each dcluster backward kernel and
    none of plain, out within the dtype's limit of the plain forward and the
    gradients finite."""
    dt = getattr(torch, dtype)
    for d in range(896, 8192 + 1, 128):
        q, k, v = (t.requires_grad_() for t in _qkv(1, 1, 64, 64, d, device=card, dtype=dt,
                                                    seed=d))
        names = ["flash_fwd_dcluster_launches", "flash_bwd_dq_dcluster_launches",
                 "flash_bwd_dkv_dcluster_launches", "flash_fwd_plain_launches",
                 "flash_bwd_dq_plain_launches", "flash_bwd_dkv_plain_launches"]
        before = [getattr(port, n) for n in names]
        out = port.dot_product_attention(q, k, v, causal=True)
        out.backward(torch.ones_like(out))
        assert [getattr(port, n) - c for n, c in zip(names, before)] == [1, 1, 1, 0, 0, 0], d
        plain, _ = port.flash_attention_fwd_plain(q.detach(), k.detach(), v.detach(),
                                                  causal=True, scale=d ** -0.5)
        torch.cuda.synchronize()
        assert row_err(out.detach(), plain) <= FWD_ROW_TOL[dt], d
        assert all(bool(torch.isfinite(t.grad).all()) for t in (q, k, v)), d


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
def test_dcluster_forward_at_every_head_dim_matches_plain_and_repeats_its_bits_on_card(
        card, dtype):
    """Every multiple of 128 from 896 to 8192 at (1, 2, 96, 96), causal (a
    ragged second q tile, three kv tiles): one launch of the dcluster
    forward a call on its counters, every row of out within the dtype's
    limit of the plain forward at its 64 x 32 tiles, lse within its
    limit, and a second run bit-equal (each row's partials summed in group
    order by one reducer, no atomics)."""
    dt = getattr(torch, dtype)
    for d in range(896, 8192 + 1, 128):
        q, k, v = _qkv(1, 2, 96, 96, d, device=card, dtype=dt, seed=d)
        before = (port.flash_fwd_dcluster_launches,
                  port.launches_by_head_dim[f"flash_fwd_dcluster_d{d}"])
        o, lse = port.flash_attention_fwd(q, k, v, causal=True, scale=d ** -0.5)
        o2, lse2 = port.flash_attention_fwd(q, k, v, causal=True, scale=d ** -0.5)
        assert (port.flash_fwd_dcluster_launches - before[0],
                port.launches_by_head_dim[f"flash_fwd_dcluster_d{d}"] - before[1]) == (2, 2), d
        ref_o, ref_lse = port.flash_attention_fwd_plain(q, k, v, causal=True, scale=d ** -0.5)
        torch.cuda.synchronize()
        assert row_err(o, ref_o) <= FWD_ROW_TOL[dt], d
        torch.testing.assert_close(lse, ref_lse, atol=FWD_LSE_TOL[dt], rtol=1e-6)
        assert torch.equal(o, o2) and torch.equal(lse, lse2), d


# the dcluster forward's plans and edges: clusters of 4 (896), 5 (1152: 13
# rows a reducer, the last 12), 7 (1664: 10 rows, the last 4) and 8 (2048);
# two passes in clusters of 5 (2304, the last CTA's second group past d)
# and of 8 (4096), four passes (8192); rows that see no key (t_q 160 against
# t_kv 64), q the suffix of a longer kv, non-causal with ragged tiles, both
# shorter than a tile, and two full heads
DCLUSTER_FWD_CASES = [
    (1, 2, 160, 64, 896, True),
    (1, 2, 40, 120, 1152, True),
    (1, 2, 104, 72, 1152, False),
    (1, 2, 160, 64, 1664, True),
    (1, 2, 24, 16, 1664, True),
    (1, 2, 200, 264, 2048, True),
    (1, 2, 160, 64, 2304, True),
    (1, 2, 136, 136, 4096, False),
    (1, 1, 160, 64, 8192, True),
    (2, 8, 2048, 2048, 1024, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float16", "float32"])
@pytest.mark.parametrize("case", DCLUSTER_FWD_CASES, ids=_ids)
def test_dcluster_forward_matches_plain_and_repeats_its_bits_on_card(card, case, dtype):
    """The dcluster forward at each kind of plan and edge: one launch a call,
    every row of out within the dtype's limit of the plain forward (rows
    that see no key too: 0 and NEG_INF where the q tile skips every kv
    tile, the mean of V where it runs one), lse within its limit, and a
    second run bit-equal."""
    b, h, tq, tkv, d, causal = case
    dt = getattr(torch, dtype)
    q, k, v = _qkv(b, h, tq, tkv, d, device=card, dtype=dt)
    before = port.flash_fwd_dcluster_launches
    o, lse = port.flash_attention_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    o2, lse2 = port.flash_attention_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    assert port.flash_fwd_dcluster_launches - before == 2
    ref_o, ref_lse = port.flash_attention_fwd_plain(q, k, v, causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o).all())
    assert row_err(o, ref_o) <= FWD_ROW_TOL[dt]
    torch.testing.assert_close(lse, ref_lse, atol=FWD_LSE_TOL[dt], rtol=1e-6)
    assert torch.equal(o, o2) and torch.equal(lse, lse2)
    if causal and min(64, tq) - 1 < tq - tkv:  # the first q tile skips every kv tile
        assert bool((o[..., :64, :] == 0).all()) and bool((lse[..., :64] == port.NEG_INF).all())


# the dcluster backward's plans: one pass in clusters of 4 (896) and 8
# (2048, the last with no recompute), two passes (4096) and four (8192),
# at t 96 (three 32-row tiles), q the suffix of a longer kv at 2048
DCLUSTER_CASES = [
    (1, 2, 96, 96, 896, True),
    (1, 2, 64, 160, 2048, True),
    (1, 2, 96, 96, 4096, True),
    (1, 1, 96, 96, 8192, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", DCLUSTER_CASES, ids=_ids)
def test_dcluster_backward_matches_plain_and_repeats_its_bits_on_card(card, case, dtype):
    """The dcluster dQ and dK/dV at each kind of plan (one pass, four and
    eight CTAs a cluster; two and four passes): one launch of each on their
    counters, every row of dq, dk and dv within the dtype's limit of the
    plain backward (in float64 for float32), and a second run bit-equal
    (every CTA sums the cluster's partials in group order)."""
    b, h, tq, tkv, d, causal = case
    dt = getattr(torch, dtype)
    q, k, v, o, lse, do, scale = _bwd_inputs(b, h, tq, tkv, d, causal, card, dt)
    names = ["flash_bwd_dq_dcluster_launches", "flash_bwd_dkv_dcluster_launches"]
    before = [getattr(port, n) for n in names]
    got = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    assert [getattr(port, n) - c for n, c in zip(names, before)] == [1, 1]
    again = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    exact = torch.float64 if dt == torch.float32 else dt
    want = [w.to(dt) for w in port.flash_attention_bwd_plain(
        *(x.to(exact) for x in (q, k, v, o)), lse, do.to(exact), causal=causal, scale=scale)]
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in got)
    _assert_grads_close(got, want, BWD_TOL[dt])
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


# the float32 backward at 384 to 768 (dcluster128: clusters of 3 to 6
# CTAs of 128 columns): three 32-row tiles causal, rows that see no key (t_q
# 96 against t_kv 40), a ragged non-causal pair, two heads at t 256
DCLUSTER128_CASES = [
    *[(1, 2, 96, 96, d, True) for d in (384, 512, 640, 768)],
    (1, 2, 96, 40, 640, True),
    (1, 2, 72, 104, 768, False),
    (2, 2, 256, 256, 384, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", DCLUSTER128_CASES, ids=_ids)
def test_dcluster128_backward_matches_plain_and_repeats_its_bits_on_card(card, case):
    """The float32 dQ and dK/dV at 384 to 768 (dcluster128, every cluster
    size of its plan): one launch of each on their counters and on their
    head_dim's, none on tf32x3's, every row of dq, dk and dv within 1e-4
    of the plain backward in float64, and a second run bit-equal (every
    reducer sums the 2 C partials in column order)."""
    b, h, tq, tkv, d, causal = case
    q, k, v, o, lse, do, scale = _bwd_inputs(b, h, tq, tkv, d, causal, card, torch.float32)
    names = ["flash_bwd_dq_dcluster128_launches", "flash_bwd_dkv_dcluster128_launches",
             "flash_bwd_dq_tf32x3_launches", "flash_bwd_dkv_tf32x3_launches"]
    by_d = [f"flash_bwd_dq_dcluster128_d{d}", f"flash_bwd_dkv_dcluster128_d{d}"]
    before = [getattr(port, n) for n in names]
    before_d = [port.launches_by_head_dim[n] for n in by_d]
    got = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    assert [getattr(port, n) - c for n, c in zip(names, before)] == [1, 1, 0, 0]
    assert [port.launches_by_head_dim[n] - c for n, c in zip(by_d, before_d)] == [1, 1]
    again = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    want = [w.float() for w in port.flash_attention_bwd_plain(
        *(x.double() for x in (q, k, v, o)), lse, do.double(), causal=causal, scale=scale)]
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in got)
    _assert_grads_close(got, want, BWD_TOL[torch.float32])
    assert all(torch.equal(a, b_) for a, b_ in zip(got, again))


# float16 at head_dim 64, 128 and 256: the bf16 kernels' float16 builds
F16_CASES = [
    (2, 3, 200, 264, 64, True),
    (1, 2, 160, 64, 64, True),      # t_q > t_kv: leading rows see nothing
    (2, 2, 256, 256, 128, True),
    (1, 2, 136, 136, 128, False),
    (1, 2, 200, 264, 256, True),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", F16_CASES, ids=_ids)
def test_float16_kernels_match_plain_on_card(card, case):
    """float16 runs the design of its head_dim (d64 at 64, wgmma at 128
    and 256, wide at 384 and 512), one launch of each kernel on those counters and
    none on plain, every row of out, lse, dq, dk and dv within the float16
    limits of the plain versions."""
    b, h, tq, tkv, d, causal = case
    f16 = torch.float16
    q, k, v = _qkv(b, h, tq, tkv, d, device=card, dtype=f16)
    fwd, bwd = port.FWD_DESIGNS[(d, f16)], port.BWD_DESIGNS[(d, f16)]
    names = ["flash_fwd_plain_launches", f"flash_fwd_{fwd.name}_launches",
             f"flash_bwd_dq_{bwd.dq.name}_launches", f"flash_bwd_dkv_{bwd.dkv.name}_launches"]
    before = [getattr(port, n) for n in names]
    o, lse = port.flash_attention_fwd(q, k, v, causal=causal, scale=d ** -0.5)
    ref_o, ref_lse = port.flash_attention_fwd_plain(q, k, v, causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert row_err(o, ref_o) <= FWD_ROW_TOL[f16]
    torch.testing.assert_close(lse, ref_lse, atol=FWD_LSE_TOL[f16], rtol=1e-6)
    do = torch.from_numpy(np.random.RandomState(1).randn(b, h, tq, d).astype(np.float32)).to(
        card, f16)
    got = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=d ** -0.5)
    want = port.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=d ** -0.5)
    torch.cuda.synchronize()
    assert [getattr(port, n) - c for n, c in zip(names, before)] == [0, 1, 1, 1]
    assert all(bool(torch.isfinite(x).all()) for x in got)
    _assert_grads_close(got, want, BWD_TOL[f16])


@pytest.mark.cuda
def test_tf32x3_kernels_take_more_heads_than_grid_y(card):
    """b * h = 65 600 (t=64) in float32: more than grid.y's 65535, so the
    tf32x3 launchers run it in two launches of at most 65535 heads; forward
    and backward within the float32 limits of the plain versions."""
    q, k, v = _qkv(4, 16400, 64, 64, 16, device=card, dtype=torch.float32)
    before = (port.flash_fwd_tf32x3_launches, port.flash_bwd_dq_tf32x3_launches,
              port.flash_bwd_dkv_tf32x3_launches)
    o, lse = port.flash_attention_fwd(q, k, v, causal=True, scale=0.25)
    ref_o, ref_lse = port.flash_attention_fwd_plain(q, k, v, causal=True, scale=0.25)
    assert row_err(o, ref_o) <= FWD_ROW_TOL[torch.float32]
    torch.testing.assert_close(lse, ref_lse, atol=FWD_LSE_TOL[torch.float32], rtol=1e-6)
    do = torch.ones_like(q)
    got = port.flash_attention_bwd(q, k, v, o, lse, do, causal=True, scale=0.25)
    want = port.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=True, scale=0.25)
    assert (port.flash_fwd_tf32x3_launches, port.flash_bwd_dq_tf32x3_launches,
            port.flash_bwd_dkv_tf32x3_launches) == tuple(n + 1 for n in before)
    _assert_grads_close(got, want, BWD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("shape, dtype", [
    ((1, 2, 64, 64, 48, True), torch.bfloat16),
    ((2, 2, 64, 64, 80, False), torch.float32),
    ((1, 2, 40, 72, 96, True), torch.bfloat16),
    ((1, 2, 64, 128, 16, True), torch.float16),
    ((1, 2, 40, 72, 32, True), torch.float16),
    ((1, 1, 60, 60, 896, True), torch.bfloat16),
], ids=lambda x: str(x).replace(" ", ""))
def test_plain_design_on_card_matches_the_cpu(card, shape, dtype):
    """Inputs that no kernel takes and that the reference sends to its XLA
    route (head_dims 48, 80, 96, float16 at 16 and 32, head_dim 896 at a
    length that is not a multiple of 8) compute on the card through the
    plain design, counted, and agree with the CPU path (the same
    function)."""
    _plain_on_card_matches_cpu(card, shape, dtype)


@pytest.mark.cuda
def test_segment_ids_on_card_match_the_cpu(card):
    """With segment_ids the dispatcher computes the reference's XLA route
    (``_attention_plain``) on the card, differentiable, and launches no
    flash kernel; result and gradients equal the CPU's."""
    cpu = [t.requires_grad_() for t in _qkv(2, 2, 48, 48, 32, seed=3)]
    dev = [t.detach().to(card).requires_grad_() for t in cpu]
    seg = torch.from_numpy(np.repeat(np.array([[0, 1, 2], [0, 0, 1]]), 16, axis=1))
    g = torch.from_numpy(np.random.RandomState(4).randn(2, 2, 48, 32).astype(np.float32))
    before = (port.flash_fwd_launches, port.flash_bwd_dq_launches,
              port.flash_bwd_dkv_launches)
    out_dev = port.dot_product_attention(*dev, causal=True, segment_ids=seg.to(card))
    out_dev.backward(g.to(card))
    assert (port.flash_fwd_launches, port.flash_bwd_dq_launches,
            port.flash_bwd_dkv_launches) == before
    out_cpu = port.dot_product_attention(*cpu, causal=True, segment_ids=seg)
    out_cpu.backward(g)
    assert row_err(out_dev.detach().cpu(), out_cpu.detach()) <= FWD_ROW_TOL[torch.float32]
    _assert_grads_close([t.grad.cpu() for t in dev], [t.grad for t in cpu],
                        BWD_TOL[torch.float32])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", CASES + BWD_D256_CASES, ids=_ids)
def test_flash_bwd_kernels_match_plain_on_card(card, case, dtype):
    """dq, dk, dv of the dQ and dK/dV kernels against the plain backward on
    the same device tensors, rows that see no key included."""
    dt = getattr(torch, dtype)
    q, k, v, o, lse, do, scale = _bwd_inputs(*case, device=card, dtype=dt)
    causal = case[5]
    design = port.BWD_DESIGNS[(case[4], dt)]
    counters = [f"flash_bwd_{kernel}{suffix}_launches" for kernel in ("dq", "dkv")
                for suffix in ("", f"_{getattr(design, kernel).name}")]
    before = [getattr(port, c) for c in counters]
    got = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    assert [getattr(port, c) for c in counters] == [n + 1 for n in before]
    want = port.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal,
                                          scale=scale)
    torch.cuda.synchronize()
    _assert_grads_close(got, want, BWD_TOL[dt])
    again = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.cuda
@pytest.mark.parametrize("case", SMALL_D_CASES, ids=_ids)
def test_small_d_backward_launches_the_persistent_kernels_on_card(card, case):
    """bf16 at head_dim 16 and 32 goes through the persistent dQ and dK/dV
    kernels: one launch of each on their counters and none on the other
    designs', every row of dq, dk and dv within the bf16 limit of the plain
    backward, and the same bits from a second run."""
    b, h, tq, tkv, d, causal = case
    q, k, v, o, lse, do, scale = _bwd_inputs(b, h, tq, tkv, d, causal, card, torch.bfloat16)
    counters = [f"flash_bwd_{kernel}{suffix}_launches" for kernel in ("dq", "dkv")
                for suffix in ("", "_persistent", "_wgmma", "_tf32x3")]
    before = [getattr(port, c) for c in counters]
    got = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    assert [getattr(port, c) - n for c, n in zip(counters, before)] == [1, 1, 0, 0] * 2
    want = port.flash_attention_bwd_plain(q, k, v, o, lse, do, causal=causal, scale=scale)
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(x).all()) for x in got)
    _assert_grads_close(got, want, BWD_TOL[torch.bfloat16])
    again = port.flash_attention_bwd(q, k, v, o, lse, do, causal=causal, scale=scale)
    assert all(torch.equal(a, b) for a, b in zip(got, again))  # no atomics


@pytest.mark.cuda
def test_dispatcher_differentiates_through_the_kernels_on_card(card):
    q, k, v = (t.requires_grad_() for t in
               _qkv(2, 4, 80, 80, 64, device=card, dtype=torch.bfloat16))
    before = (port.flash_fwd_launches, port.flash_bwd_dq_launches,
              port.flash_bwd_dkv_launches)
    out = port.dot_product_attention(q, k, v, causal=True)
    g = torch.ones_like(out).transpose(1, 2).contiguous().transpose(1, 2)
    out.backward(g)  # a non-contiguous gradient, as the model hands it over
    assert (port.flash_fwd_launches, port.flash_bwd_dq_launches,
            port.flash_bwd_dkv_launches) == tuple(n + 1 for n in before)
    o, lse = port.flash_attention_fwd_plain(q.detach(), k.detach(), v.detach(),
                                            causal=True, scale=0.125)
    want = port.flash_attention_bwd_plain(
        q.detach(), k.detach(), v.detach(), out.detach(), lse,
        g.contiguous(), causal=True, scale=0.125)
    _assert_grads_close((q.grad, k.grad, v.grad), want, BWD_TOL[torch.bfloat16])


@pytest.mark.cuda
def test_bwd_wrapper_raises_for_what_the_kernels_do_not_take(card):
    q, k, v, o, lse, do, scale = _bwd_inputs(1, 2, 64, 64, 64, True, card,
                                             torch.bfloat16)
    with pytest.raises(ValueError, match="contiguous"):
        port.flash_attention_bwd(q, k, v, o, lse, do.transpose(2, 3),
                                 causal=True, scale=scale)
    with pytest.raises(ValueError, match="lse"):
        port.flash_attention_bwd(q, k, v, o, lse.to(torch.bfloat16), do,
                                 causal=True, scale=scale)
    with pytest.raises(ValueError, match="dtype"):
        port.flash_attention_bwd(q, k, v, o, lse, do.float(), causal=True,
                                 scale=scale)
    # head_dim 48: no kernel takes it, so the plain design computes it and
    # counts one launch of each backward kernel
    q48, k48, v48 = _qkv(1, 1, 64, 64, 48, device=card, dtype=torch.bfloat16)
    before = (port.flash_bwd_dq_plain_launches, port.flash_bwd_dkv_plain_launches)
    got = port.flash_attention_bwd(q48, k48, v48, q48, lse[:, :1], q48,
                                   causal=True, scale=scale)
    assert (port.flash_bwd_dq_plain_launches, port.flash_bwd_dkv_plain_launches) == tuple(
        n + 1 for n in before)
    want = port.plain_attention_bwd(*(t.cpu() for t in (q48, k48, v48, q48, lse[:, :1], q48)),
                                    causal=True, scale=scale)
    _assert_grads_close([x.cpu() for x in got], want, BWD_TOL[torch.bfloat16])


def _nano_grads(cfg, params, tokens):
    """The train step's loss and its gradients, for a fresh copy of
    ``params``."""
    from ray_tpu_torch.models import gpt, training

    params = {k: v.clone().requires_grad_() for k, v in params.items()}
    loss, _ = training._loss_fn(cfg, gpt.GPT(cfg, device="meta"))(params, tokens)
    return loss, torch.autograd.grad(loss, list(params.values()))


@pytest.mark.cuda
@pytest.mark.parametrize("policy", ["attn", "dots"])
def test_remat_policies_on_card_match_nothing(card, policy):
    """bf16 blocks at head_dim 64 (the d64 forward): under "attn" the
    backward reads the flash forward's kept (out, lse), so the forward
    launches once per layer, not twice; under "dots" twice. Loss and
    gradients equal "nothing"'s: the kept tensors are the finished ones."""
    from ray_tpu_torch.models import gpt, inference

    kw = dict(num_layers=2, num_heads=2, head_dim=64, embed_dim=128, mlp_dim=256,
              vocab_size=256, max_seq_len=256, rotary_dim=32, ce_chunk=64)
    params = inference.init_params(gpt.GPTConfig(**kw), device=card, seed=1)
    tokens = torch.from_numpy(np.random.RandomState(2).randint(0, 256, (2, 256))).to(card)
    loss_ref, g_ref = _nano_grads(gpt.GPTConfig(**kw), params, tokens)
    before = port.flash_fwd_d64_launches
    loss, grads = _nano_grads(gpt.GPTConfig(**kw, remat_policy=policy), params, tokens)
    per_layer = 1 if policy == "attn" else 2
    assert port.flash_fwd_d64_launches - before == per_layer * kw["num_layers"]
    assert torch.equal(loss, loss_ref)
    for name, a, b in zip(params, grads, g_ref):
        torch.testing.assert_close(a, b, atol=1e-6, rtol=1e-5, msg=name)


@pytest.mark.cuda
def test_moe_layer_on_card_matches_the_cpu(card):
    """MoeMlp in float32 at capacity factor 0.25 (assignments dropped): the
    card's slot of every assignment (so the kept set and each kept row's
    place) equal to the CPU's, and its output, aux and gradients against the
    CPU's, each tensor within 1e-5 of its own largest magnitude (float32
    sums in two orders; the router's gradient reaches ~1800 at this loss,
    where float32 against float64 on the CPU differs by 2e-7 of it); the
    forward runs with no host synchronisation."""
    from ray_tpu_torch.models import gpt, moe

    cfg = gpt.GPTConfig(vocab_size=256, num_layers=1, num_heads=2, head_dim=16,
                        embed_dim=64, mlp_dim=128, max_seq_len=128, rotary_dim=16,
                        dtype=torch.float32, moe_num_experts=4, moe_capacity_factor=0.25)
    rng = np.random.RandomState(3)
    params = {"router": rng.randn(64, 4) * 0.5, "wi": rng.randn(4, 64, 128) * 0.2,
              "wo": rng.randn(4, 128, 64) * 0.2}
    x = rng.randn(2, 96, 64)
    cap = moe.expert_capacity(cfg, 2 * 96)
    runs = {}
    for dev in ("cpu", card):
        p = {k: torch.tensor(v, dtype=torch.float32, device=dev, requires_grad=True)
             for k, v in params.items()}
        xt = torch.tensor(x, dtype=torch.float32, device=dev, requires_grad=True)
        layer = moe.MoeMlp(cfg, device="meta")
        if dev != "cpu":
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux, _ = torch.func.functional_call(layer, p, (xt,))
        finally:
            torch.cuda.set_sync_debug_mode("default")
        grads = torch.autograd.grad((y * y).sum() + aux, [*p.values(), xt])
        slot = moe.route(xt.detach().reshape(-1, 64), p["router"].detach(), cfg.moe_top_k,
                         cap)[3]
        runs[str(dev)] = [t.detach().cpu() for t in (slot, y, aux, *grads)]
    cpu, gpu = runs["cpu"], runs[str(card)]
    dropped = cpu[0] == 4 * cap
    assert torch.equal(gpu[0], cpu[0]) and dropped.any() and not dropped.all()
    for name, a, b in zip(("y", "aux", "router", "wi", "wo", "x"), gpu[1:], cpu[1:]):
        torch.testing.assert_close(a, b, atol=1e-5 * float(b.abs().max()), rtol=0,
                                   msg=lambda m, name=name: f"{name}: {m}")


LSE_CASES = [
    (2, 2, 128, 128, 128, True),    # a ring's step 0
    (2, 2, 128, 128, 128, False),   # a ring's hop
    (1, 2, 96, 136, 64, True),      # ragged, q the suffix
    (1, 2, 130, 130, 32, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("case", LSE_CASES, ids=_ids)
def test_flash_attention_with_lse_matches_plain_on_card(card, case, dtype):
    """(out, lse) and the gradients under random cotangents of both: one
    forward and one of each backward kernel (delta - dlse into the dQ and
    dK/dV kernels) against the plain forward and backward, with the same
    dlse, on the same device tensors."""
    dt = getattr(torch, dtype)
    b, h, tq, tkv, d, causal = case
    q, k, v = (t.requires_grad_() for t in _qkv(b, h, tq, tkv, d, device=card, dtype=dt))
    rng = np.random.RandomState(9)
    do = torch.from_numpy(rng.randn(b, h, tq, d).astype(np.float32)).to(card, dt)
    dlse = torch.from_numpy(rng.randn(b, h, tq).astype(np.float32)).to(card)
    scale = 1.0 / d ** 0.5
    counters = ("flash_fwd_launches", "flash_bwd_dq_launches", "flash_bwd_dkv_launches")
    before = [getattr(port, c) for c in counters]
    out, lse = port.flash_attention_with_lse(q, k, v, causal, scale)
    got = torch.autograd.grad((out, lse), (q, k, v), (do, dlse))
    assert [getattr(port, c) for c in counters] == [n + 1 for n in before]
    ref_o, ref_lse = port.flash_attention_fwd_plain(q.detach(), k.detach(), v.detach(),
                                                    causal=causal, scale=scale)
    want = port.flash_attention_bwd_plain(q.detach(), k.detach(), v.detach(), out.detach(),
                                          lse.detach(), do, causal=causal, scale=scale,
                                          dlse=dlse)
    torch.cuda.synchronize()
    assert row_err(out.detach(), ref_o) <= FWD_ROW_TOL[dt]
    assert float((lse - ref_lse).abs().max()) <= FWD_LSE_TOL[dt]
    _assert_grads_close(got, want, BWD_TOL[dt])


_ENGINE_AFTER_TRAINING = r"""
import sys
import numpy as np
import torch
from ray_tpu_torch.models import gpt, inference, training
from ray_tpu_torch.serve import llm

if sys.argv[1:] == ["refuse"]:
    try:
        llm.LLMServer(device="cuda")
    except RuntimeError as e:
        print("refused:", e)
        sys.exit(0)
    sys.exit("the engine started without CUBLAS_WORKSPACE_CONFIG")
assert not torch.are_deterministic_algorithms_enabled()
cfg = gpt.gpt_nano()
opt = training.default_optimizer(1e-2)
state = training.init_train_state(inference.init_params(cfg, "cuda", seed=0), opt)
step = training.make_train_step(cfg, opt, device="cuda")
tokens = torch.randint(0, cfg.vocab_size, (2, 64), device="cuda")
state, m = step(state, tokens)
srv = llm.LLMServer(cfg, params={k: p.detach() for k, p in state.params.items()},
                    device="cuda", num_blocks=64, block_size=16, prefill_chunk=32,
                    cache_buckets=(64, 128))
try:
    p = [int(x) for x in np.random.RandomState(0).randint(0, cfg.vocab_size, 40)]
    r1 = srv({"prompt": p, "max_new_tokens": 8, "return_logits": True})
    r2 = srv({"prompt": p, "max_new_tokens": 8, "return_logits": True})
    assert (r1["prefix_cached_tokens"], r2["prefix_cached_tokens"]) == (0, 32), (
        r1["prefix_cached_tokens"], r2["prefix_cached_tokens"])
    assert r1["tokens"] == r2["tokens"] and np.array_equal(r1["logits"], r2["logits"])
finally:
    srv.close()
assert not torch.are_deterministic_algorithms_enabled()
# two servers in one process, each stepping on its own batcher thread while
# the other steps (one request at a time each, so the shapes are r1's):
# every answer equal to the first server's, the mode off again once both
# are closed
from concurrent.futures import ThreadPoolExecutor
params = {k: p.detach() for k, p in state.params.items()}
pair = [llm.LLMServer(cfg, params=params, device="cuda", num_blocks=64, block_size=16,
                      prefill_chunk=32, cache_buckets=(64, 128)) for _ in range(2)]
try:
    req = {"prompt": p, "max_new_tokens": 8, "return_logits": True}
    with ThreadPoolExecutor(2) as ex:
        outs = sum(ex.map(lambda srv: [srv(dict(req)) for _ in range(3)], pair), [])
    for r in outs:
        assert r["tokens"] == r1["tokens"] and np.array_equal(r["logits"], r1["logits"])
finally:
    for s in pair:
        s.close()
assert not torch.are_deterministic_algorithms_enabled()
state, m2 = step(state, tokens)  # training after the server, as before it
assert np.isfinite(float(m2["loss"]))
print("ok")
"""


@pytest.mark.cuda
def test_engine_scopes_deterministic_mode_on_card(card):
    """A train step, then a server: cached and uncached decode bitwise
    equal, deterministic mode off again after close(); then two servers
    answering at once on their own threads, their decodes bitwise equal to
    the first's and the mode off after both close; training goes on;
    without CUBLAS_WORKSPACE_CONFIG the engine refuses to start. Each in a
    fresh process (cuBLAS reads the variable at its first handle)."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
    run = subprocess.run([sys.executable, "-c", _ENGINE_AFTER_TRAINING], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=600)
    assert run.returncode == 0 and "ok" in run.stdout, run.stdout + run.stderr
    env.pop("CUBLAS_WORKSPACE_CONFIG")
    run = subprocess.run([sys.executable, "-c", _ENGINE_AFTER_TRAINING, "refuse"], cwd=repo,
                         env=env, capture_output=True, text=True, timeout=600)
    assert run.returncode == 0 and "refused" in run.stdout, run.stdout + run.stderr
