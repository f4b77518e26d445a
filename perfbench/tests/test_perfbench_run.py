"""Whole runs of the tiny cells on the CPU (the harness's look for a card
skipped): the result line's shape, a correct run, and ``correct`` false
under the fp8 control and under each fault the cell can have."""

import json
import math
import time

import pytest

from conftest import TINY_LIMITS
from perfbench import faults
from perfbench.core.manifest import Manifest
from perfbench.core.runner import dumps, run_cell

SEED = 2 ** 31 + 12345  # more than 32 signed bits hold


def run(root, cell, trace=False, seed=SEED, log=lambda line: None):
    manifest = Manifest(root)
    return run_cell(manifest, manifest.cell(cell), seed, 0.3, trace, "cpu", time.monotonic(),
                    log=log)


@pytest.mark.parametrize("cell", sorted(TINY_LIMITS))
def test_result_line(tiny_root, cell):
    lines = []
    result = json.loads(dumps(run(tiny_root, cell, log=lines.append)))
    # attempted counts the window's steps, not set-up's
    window = next(line for line in lines if line.startswith("window "))
    assert result["attempted"] == int(window.split(", ")[1].split()[0])
    assert list(result)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result)[-1] == "checks"
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"tokens_per_s", "peak_mem_gib", "setup_s"}
    assert all(set(m) == {"value", "unit"} for m in result["metrics"].values())
    assert result["metrics"]["setup_s"]["value"] > 0
    assert set(result["checks"]) == set(TINY_LIMITS[cell])
    assert all(c["value"] <= c["limit"] for c in result["checks"].values())
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(result["device"])


def test_traced_line(tiny_root):
    result = run(tiny_root, "tiny.train", trace=True)
    assert result["correct"] is True
    assert "tokens_per_s" not in result["metrics"]
    # on the CPU no device metric is read: mfu from the host's clock, and
    # the allocator's counter (0 off CUDA)
    assert set(result["metrics"]) == {"mfu", "alloc_retries"}
    assert {"busy_s", "window_s"} <= set(result["device"])
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_fp8_control_fails(tiny_root, monkeypatch):
    """The reference in fp8, put in the program's place, comes out not
    correct."""
    from perfbench.kinds import eval as eval_kind
    from perfbench.kinds import train as train_kind

    for module in (train_kind, eval_kind):
        monkeypatch.setattr(module.Kind, "readings",
                            lambda self: [self.reference_readings("fp8")])
    for cell in TINY_LIMITS:
        assert run(tiny_root, cell)["correct"] is False, cell


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(TINY_LIMITS)
                                        for f in faults.BY_KIND[c.split(".")[1]]])
def test_fault_fails(tiny_root, cell, fault):
    with faults.FAULTS[fault]():
        result = run(tiny_root, cell)
    assert result["correct"] is False
    failing = [n for n, c in result["checks"].items()
               if c["value"] is None or not math.isfinite(c["value"]) or c["value"] > c["limit"]]
    assert failing, result["checks"]


def test_a_step_that_changes_after_set_up_fails(tiny_root, monkeypatch):
    """A train step that is sound for set-up's steps and leaves out half of
    each batch after them: the check's second run, through the window's
    call once the window has closed, finds it."""
    from perfbench.kinds.train import CHECK_STEPS
    from ray_tpu_torch.models import training

    make = training.make_train_step

    def make_train_step(*args, **kwargs):
        step, calls = make(*args, **kwargs), [0]

        def late(state, tokens):
            calls[0] += 1
            return step(state, tokens if calls[0] <= CHECK_STEPS
                        else tokens[:tokens.shape[0] // 2])
        return late

    monkeypatch.setattr(training, "make_train_step", make_train_step)
    result = run(tiny_root, "tiny.train")
    assert result["correct"] is False
    assert result["checks"]["loss_gap"]["value"] > result["checks"]["loss_gap"]["limit"]


def test_calibration_readings(tiny_root, tmp_path):
    """``calibrate.py`` at the tiny size: the program's gaps under the
    limits, the control's and each fault's over at least one of them."""
    import calibrate

    out = tmp_path / "calib.jsonl"
    for cell in sorted(TINY_LIMITS):
        assert calibrate.main(["--workload", cell, "--seeds", "1", "--control", "1",
                               "--faults", "1", "--seconds", "0.2", "--device", "cpu",
                               "--out", str(out)], root=tiny_root) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    modes = {(r["workload"], r["mode"]) for r in rows}
    assert modes == {("tiny.train", m) for m in ("program", "control_fp8", "half_batch")} | {
        ("tiny.eval", m) for m in ("program", "control_fp8", "half_batch", "answer_lag")}
    for r in rows:
        limits = TINY_LIMITS[r["workload"]]
        over = [k for k, v in r["gaps"].items() if v > limits[k]]
        assert bool(over) == (r["mode"] != "program"), r
