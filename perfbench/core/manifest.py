"""``BENCHMARK.json`` and the files that it names, each found by name:

* a configuration: the file its entry names (``configs/<name>.json``);
* a traffic mix: ``traffic/<traffic>.json``, read by the step kind that
  its ``"step"`` names (``kinds/<step>.py``);
* a per-layer metric: ``metrics/<name>.py``, whose ``read(trace)`` returns
  the metric's value or None where it finds nothing to read;
* a cell's limits for ``correct``: ``limits/<workload>.json``.

A later change adds a configuration, a mix, a metric or a cell by adding
files and entries; nothing here names one.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Dict, List

HARNESS = "perfbench"


@dataclasses.dataclass(frozen=True)
class Cell:
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    traffic: dict
    limits: Dict[str, float]
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(entry: dict, cell: str) -> bool:
    return "workloads" not in entry or cell in entry["workloads"]


class Manifest:
    def __init__(self, root: Path):
        self.root = Path(root)
        self.harness = self.root / HARNESS
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _json(self, path: Path) -> dict:
        if not path.is_file():
            raise FileNotFoundError(f"{path} is missing")
        return json.loads(path.read_text())

    def cell(self, name: str) -> Cell:
        by_name = {w["name"]: w for w in self.data["workloads"]}
        if name not in by_name:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of {sorted(by_name)}")
        w = by_name[name]
        configs = {c["name"]: c for c in self.data["configs"]}
        config_entry = configs[w["config"]]
        return Cell(
            name=name, chips=int(w["chips"]), config_name=w["config"],
            config=self._json(self.root / config_entry["file"]),
            traffic_name=w["traffic"],
            traffic=self._json(self.harness / "traffic" / f"{w['traffic']}.json"),
            limits=self._json(self.harness / "limits" / f"{name}.json"),
            end_to_end=[m for m in self.data["end_to_end"] if _applies(m, name)],
            per_layer=[m for m in self.data["per_layer"] if _applies(m, name)])

    def metric_reader(self, name: str) -> ModuleType:
        """``metrics/<name>.py`` loaded by path (a name may hold dots)."""
        path = self.harness / "metrics" / f"{name}.py"
        if not path.is_file():
            raise FileNotFoundError(f"{path} is missing")
        spec = importlib.util.spec_from_file_location(f"{HARNESS}_metric_{name}", path)
        module = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(module)
        return module
