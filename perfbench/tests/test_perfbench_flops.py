"""The yardstick's counts against hand arithmetic, for both configurations."""

import json

import pytest
import torch

from conftest import ROOT
from perfbench.core import flops
from perfbench.reference.gpt_parallel import Shape, param_table


def shape(name):
    return Shape.from_config(json.loads((ROOT / f"perfbench/configs/{name}.json").read_text()))


def test_parameter_counts():
    # gpt_1b: wte and head 50304 x 2048 (+ bias), 16 layers of 4 x 2048^2 + 2 x 2048 x 8192
    # + 8192 + 2048 + 2 x 2048, final LayerNorm 2 x 2048
    s = shape("gpt_1b")
    per_layer = 4 * 2048 ** 2 + 2 * 2048 * 8192 + 8192 + 2048 + 2 * 2048
    want = 50304 * 2048 + 16 * per_layer + 2 * 2048 + 2048 * 50304 + 50304
    assert flops.num_params(s) == want
    assert sum(torch.Size(sh).numel() for _, sh, _ in param_table(s)) == want
    j = shape("gpt_j_6b")
    per_layer = 4 * 4096 ** 2 + 2 * 4096 * 16384 + 16384 + 4096 + 2 * 4096
    want_j = 50400 * 4096 + 28 * per_layer + 2 * 4096 + 4096 * 50400 + 50400
    assert sum(torch.Size(sh).numel() for _, sh, _ in param_table(j)) == want_j
    assert 6.05e9 < want_j < 6.06e9


def test_step_flops_by_hand():
    s = shape("gpt_1b")
    n = flops.matmul_params(s)
    assert n == flops.num_params(s) - 50304 * 2048
    tokens = 12 * 2048
    attn = 12 * 16 * 12 * 16 * 2048 ** 2 * 128
    assert flops.train_step_flops(s, 12, 2048) == pytest.approx(6 * n * tokens + attn, rel=1e-12)
    assert flops.eval_step_flops(s, 16, 2048) == pytest.approx(
        2 * n * 16 * 2048 + 4 * 16 * 16 * 16 * 2048 ** 2 * 128, rel=1e-12)
    j = shape("gpt_j_6b")
    assert flops.train_step_flops(j, 4, 2048) == pytest.approx(3.1e14, rel=0.01)


def test_step_flops_match_the_port_today():
    """The frozen copy agrees with the port's train_step_flops as it stands."""
    from perfbench.core.program import gpt_config
    from ray_tpu_torch.models import gpt

    for name, b in (("gpt_1b", 12), ("gpt_j_6b", 4)):
        config = json.loads((ROOT / f"perfbench/configs/{name}.json").read_text())
        assert flops.train_step_flops(shape(name), b, 2048) == pytest.approx(
            gpt.train_step_flops(gpt_config(config), b, 2048), rel=1e-12)


def test_attention_work_by_hand():
    # gpt_1b at b=12: 12 x 16 heads, 2048 x 2049 / 2 visible pairs a head
    pairs = 12 * 16 * 2048 * 2049 // 2
    f, nbytes = flops.attn_fwd_work(12, 16, 2048, 128, 2)
    assert f == 4 * 128 * pairs
    assert nbytes == 4 * 12 * 16 * 2048 * 128 * 2 + 12 * 16 * 2048 * 4
    f, nbytes = flops.attn_bwd_work(12, 16, 2048, 128, 2)
    assert f == 10 * 128 * pairs
    assert nbytes == 8 * 12 * 16 * 2048 * 128 * 2 + 12 * 16 * 2048 * 4
    # both bound by the products at d=128 and d=256: 0.2086 ms forward at b=12
    assert flops.least_seconds(*flops.attn_fwd_work(12, 16, 2048, 128, 2)) == \
        pytest.approx(4 * 128 * pairs / 989e12)
    assert flops.least_seconds(*flops.attn_fwd_work(12, 16, 2048, 128, 2)) * 1e3 == \
        pytest.approx(0.2086, abs=1e-4)
    f, nbytes = flops.attn_bwd_work(4, 16, 2048, 256, 2)
    assert f / 989e12 > nbytes / 3.35e12
