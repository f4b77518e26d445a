"""What a run may load and where it refuses to print a result. Top-level
module names are compared whole: ``ray_tpu_torch`` begins with ``ray_tpu``
and is allowed."""

import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import ROOT

FORBIDDEN = ("jax", "jaxlib", "flax", "ray_tpu")


def _python(code: str, cwd=ROOT, env=None):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                          timeout=600, env=env)


def test_harness_and_reference_load_no_jax_and_no_jax_package(tmp_path):
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
sys.path.insert(0, {str(ROOT / 'perfbench/tests')!r})
from conftest import make_tiny_root
from pathlib import Path
import time
root = make_tiny_root(Path({str(tmp_path)!r}))
from perfbench.core.manifest import Manifest
from perfbench.core.runner import run_cell
import perfbench.run
m = Manifest(root)
for cell in ("tiny.train", "tiny.eval"):
    assert run_cell(m, m.cell(cell), 3, 0.2, False, "cpu", time.monotonic(), log=print)["correct"]
print(json.dumps([sorted({{n.split(".")[0] for n in sys.modules}}),
                  perfbench.run.forbidden_modules()]))
"""
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded, found = json.loads(proc.stdout.splitlines()[-1])
    assert "ray_tpu_torch" in loaded
    assert not set(loaded) & set(FORBIDDEN)
    assert found == []


def test_reference_imports_nothing_of_the_program():
    code = f"""
import json, sys
sys.path.insert(0, {str(ROOT)!r})
import perfbench.reference.gpt_parallel
print(json.dumps(sorted({{n.split(".")[0] for n in sys.modules}})))
"""
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    loaded = set(json.loads(proc.stdout.splitlines()[-1]))
    assert not loaded & {"ray_tpu_torch", *FORBIDDEN}


def test_no_card_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "gpt_1b.train_b12",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=ROOT,
                          capture_output=True, text=True, timeout=600, env=env)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_checkout_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "perfbench", tmp_path / "perfbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = subprocess.run([sys.executable, "perfbench/run.py", "--workload", "gpt_1b.train_b12",
                           "--seed", "1", "--seconds", "1", "--trace", "0"], cwd=tmp_path,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0 and proc.stdout.strip() == ""


@pytest.mark.cuda
def test_tiny_cells_on_the_card(tiny_root):
    """The tiny cells through the card's kernels, and the control failing
    there."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    import time

    from perfbench.core.manifest import Manifest
    from perfbench.core.runner import run_cell

    m = Manifest(tiny_root)
    for cell in ("tiny.train", "tiny.eval"):
        result = run_cell(m, m.cell(cell), 5, 0.5, True, "cuda", time.monotonic(),
                          log=lambda line: None)
        assert result["correct"] is True, result["checks"]
        assert result["device"]["busy_s"] > 0


def test_guard_compares_whole_top_level_names(monkeypatch):
    import types

    import run

    for name in [n for n in sys.modules if n.split(".")[0] in FORBIDDEN]:
        monkeypatch.delitem(sys.modules, name)
    monkeypatch.setitem(sys.modules, "ray_tpu_torchlike", types.ModuleType("ray_tpu_torchlike"))
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ray_tpu.ops", types.ModuleType("ray_tpu.ops"))
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    assert run.forbidden_modules() == ["jax", "ray_tpu"]
