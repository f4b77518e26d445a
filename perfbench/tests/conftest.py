"""Fixtures of the benchmark's own tests (run from the checkout's root:
``python -m pytest perfbench/tests -q``). They import nothing of JAX.

``tiny_root`` is a copy of the harness beside a ``BENCHMARK.json`` that adds
two cells at gpt_nano-like widths on the CPU, from new files alone: a
configuration, two traffic mixes and their limits."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "perfbench"))  # calibrate.py, run.py

#: the limits of the tiny cells, set from CPU readings of seeds 1-6 (loss
#: gaps 5e-5 to 1.6e-4, grad gaps 6e-4 to 1.1e-3, update gaps 8e-4 to
#: 1.6e-3) and of the fp8 control on seeds 1-3 (loss gaps 5.4e-4 and up,
#: grad gaps 1.0e-2 and up)
TINY_LIMITS = {"tiny.train": {"loss_gap": 4e-4, "grad_gap": 4e-3, "update_gap": 4e-3},
               "tiny.eval": {"loss_gap": 3.5e-4}}


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA card; skips where torch.cuda.is_available() is false")


def make_tiny_root(dest: Path, param_dtype: str = "float32") -> Path:
    shutil.copytree(ROOT / "perfbench", dest / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    config = json.loads((ROOT / "perfbench/configs/gpt_1b.json").read_text())
    config.update(vocab_size=256, n_positions=128, n_embd=64, n_layer=2, n_head=4, n_inner=256,
                  rotary_dim=16)
    config["train"]["param_dtype"] = param_dtype
    pb = dest / "perfbench"
    (pb / "configs/tiny.json").write_text(json.dumps(config))
    (pb / "traffic/tiny_train.json").write_text(json.dumps(
        {"step": "train", "batch": 4, "seq": 64, "pool": 8, "trace_steps": 2}))
    (pb / "traffic/tiny_eval.json").write_text(json.dumps(
        {"step": "eval", "batch": 4, "seq": 64, "pool": 8, "trace_steps": 2}))
    for name, limits in TINY_LIMITS.items():
        (pb / f"limits/{name}.json").write_text(json.dumps(limits))
    manifest = json.loads((ROOT / "BENCHMARK.json").read_text())
    manifest["configs"].append({"name": "tiny", "source": "test", "reduced": [], "why": "test",
                                "file": "perfbench/configs/tiny.json"})
    manifest["workloads"] += [
        {"name": f"tiny.{kind}", "config": "tiny", "traffic": f"tiny_{kind}", "chips": 1,
         "why": "test"} for kind in ("train", "eval")]
    (dest / "BENCHMARK.json").write_text(json.dumps(manifest))
    return dest


@pytest.fixture
def tiny_root(tmp_path):
    return make_tiny_root(tmp_path)
