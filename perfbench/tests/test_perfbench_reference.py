"""The plain reference against the port at gpt_nano widths on the CPU: the
parameter layout, three train steps and the eval loss, in float32 on both
sides (where the two must agree to rounding) and with the port in bf16
compute (where they agree to bf16's rounding, below the fp8 control's gap)."""

import json

import pytest
import torch

from conftest import ROOT
from perfbench.core import inputs, program
from perfbench.reference import gpt_parallel as ref


def nano_config(compute="float32", param="float32"):
    config = json.loads((ROOT / "perfbench/configs/gpt_1b.json").read_text())
    config.update(vocab_size=256, n_positions=128, n_embd=64, n_layer=2, n_head=4, n_inner=256,
                  rotary_dim=16, init_std=0.05)
    config["train"].update(compute_dtype=compute, param_dtype=param, ce_chunk=24)
    return config


def weights(config, seed=7):
    s = ref.Shape.from_config(config)
    return inputs.make_weights(ref.param_table(s), inputs.DTYPES[config["train"]["param_dtype"]],
                               seed, "cpu", config["init_std"])


def tokens(config, seed=7, n=3, b=3, t=40):
    return inputs.token_pool(seed, config["vocab_size"], n, b, t, "cpu")


def port_steps(config, batches):
    params = weights(config)
    step, opt = program.train_step(config, "cpu")
    state = program.train_state(params, opt)
    losses = []
    for tok in batches:
        state, m = step(state, tok)
        losses.append(float(m["loss"]))
    return losses, state.params


def ref_steps(config, batches, precision="fp32"):
    params = weights(config)
    out = ref.train_steps(params, batches, ref.Shape.from_config(config),
                          ref.AdamW.from_config(config), chunk=config["train"]["ce_chunk"],
                          precision=precision)
    return out["losses"], params


def test_parameter_table_is_the_ports_state_dict():
    for name in ("gpt_1b", "gpt_j_6b"):
        config = json.loads((ROOT / f"perfbench/configs/{name}.json").read_text())
        table = {n: tuple(s) for n, s, _ in ref.param_table(ref.Shape.from_config(config))}
        assert program.state_dict_shapes(config) == table


def test_train_steps_match_the_port_in_float32():
    config = nano_config()
    batches = list(tokens(config))
    losses, params = port_steps(config, batches)
    ref_losses, ref_params = ref_steps(config, batches)
    assert losses == pytest.approx(ref_losses, abs=2e-5)
    for name, p in params.items():
        torch.testing.assert_close(p, ref_params[name], rtol=0, atol=2e-6, msg=name)


def test_eval_loss_matches_the_port_in_float32():
    config = nano_config()
    params = weights(config)
    eval_step = program.eval_step(config, "cpu")
    for tok in tokens(config):
        want = ref.eval_loss(params, tok, ref.Shape.from_config(config), chunk=24)
        assert float(eval_step(params, tok)) == pytest.approx(want, abs=2e-6)


def test_bf16_port_lies_nearer_than_the_fp8_control():
    config = nano_config(compute="bfloat16")
    batches = list(tokens(config))
    losses, _ = port_steps(config, batches)
    exact, _ = ref_steps(config, batches)
    control, _ = ref_steps(config, batches, precision="fp8")
    port_gap = max(abs(a - b) for a, b in zip(losses, exact))
    control_gap = max(abs(a - b) for a, b in zip(control, exact))
    assert port_gap < 3e-4 < control_gap


def test_bf16_state_is_stored_in_bf16():
    config = nano_config(compute="bfloat16", param="bfloat16")
    _, params = ref_steps(config, list(tokens(config)))
    assert {p.dtype for p in params.values()} == {torch.bfloat16}
