"""BENCHMARK.json against the contract's shape, and every cell resolved to
its files by name."""

import importlib
import json
import re

import pytest

from conftest import ROOT
from perfbench.core.manifest import Manifest
from perfbench.reference.gpt_parallel import Shape

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
DATA = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(DATA) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert DATA["paths"] == ["perfbench"]
    assert isinstance(DATA["run_seconds"], int) and 1 <= DATA["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = ([c["name"] for c in DATA["configs"]] + [w["name"] for w in DATA["workloads"]]
             + [m["name"] for m in DATA["end_to_end"] + DATA["per_layer"]])
    for w in DATA["workloads"]:
        names += [w["config"], w["traffic"]]
    for c in DATA["configs"]:
        names += c["reduced"]
    assert all(NAME.match(n) for n in names), [n for n in names if not NAME.match(n)]
    metrics = DATA["end_to_end"] + DATA["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    assert all(UNIT.match(m["unit"]) and m["better"] in ("lower", "higher") for m in metrics)
    lines = ([c["why"] for c in DATA["configs"]] + [c["source"] for c in DATA["configs"]]
             + [w["why"] for w in DATA["workloads"]] + [m["layer"] for m in DATA["per_layer"]])
    assert all(1 <= len(s) <= 200 and "\n" not in s and "\t" not in s for s in lines)


def test_end_to_end_and_per_layer_metrics():
    assert [m["name"] for m in DATA["end_to_end"]] == ["tokens_per_s", "peak_mem_gib", "setup_s"]
    assert all(m["source"] in ("host_clock", "device_trace") for m in DATA["end_to_end"])
    assert all(0.01 <= m["bound"] <= 0.25 for m in DATA["end_to_end"])
    assert all(m["moves"] == "tokens_per_s" for m in DATA["per_layer"])
    cells = {w["name"] for w in DATA["workloads"]}
    for m in DATA["per_layer"]:
        assert set(m.get("workloads", cells)) <= cells


def test_cells_on_one_chip_in_order():
    names = [w["name"] for w in DATA["workloads"]]
    order = ["gpt_1b.train_b12", "gpt_j_6b.train_b4", "gpt_1b.eval_b16"]
    assert names == order[:len(names)]
    assert all(w["chips"] == 1 for w in DATA["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in DATA["workloads"]])
def test_cell_resolves_by_name(cell):
    manifest = Manifest(ROOT)
    c = manifest.cell(cell)
    importlib.import_module(f"perfbench.kinds.{c.traffic['step']}")
    importlib.import_module(f"perfbench.reference.{c.config['reference']}")
    assert c.limits and all(v > 0 for v in c.limits.values())
    for m in c.per_layer:
        assert callable(manifest.metric_reader(m["name"]).read)


def test_config_files_hold_their_sizes():
    gpt_j = json.loads((ROOT / "perfbench/configs/gpt_j_6b.json").read_text())
    # huggingface.co/EleutherAI/gpt-j-6b config.json; the epsilon that the
    # port runs is named apart
    assert {k: gpt_j[k] for k in ("n_layer", "n_embd", "n_head", "rotary_dim", "n_inner",
                                  "vocab_size", "n_positions", "layer_norm_epsilon")} == {
        "n_layer": 28, "n_embd": 4096, "n_head": 16, "rotary_dim": 64, "n_inner": None,
        "vocab_size": 50400, "n_positions": 2048, "layer_norm_epsilon": 1e-5}
    assert Shape.from_config(gpt_j).eps == 1e-6
    assert all(c["reduced"] == [] for c in DATA["configs"])
    files = [c["file"] for c in DATA["configs"]]
    assert len(set(files)) == len(files) and all(f.startswith("perfbench/") for f in files)


def test_a_cell_from_new_files_alone(tiny_root):
    manifest = Manifest(tiny_root)
    for name in ("tiny.train", "tiny.eval"):
        cell = manifest.cell(name)
        assert cell.config["n_embd"] == 64 and cell.limits
    # the repo's own files in the copy are unchanged
    for rel in ("perfbench/configs/gpt_1b.json", "perfbench/traffic/train_b12.json"):
        assert (tiny_root / rel).read_bytes() == (ROOT / rel).read_bytes()
