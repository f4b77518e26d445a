"""One run of one cell: set-up, the measured window, the per-layer trace
where asked, and the check of what the window's path produced.

End-to-end metrics are the harness's own readings: ``tokens_per_s`` every
token the window's steps consumed over the window's seconds (from the first
timed step's start to a synchronize after the last), ``peak_mem_gib`` the
allocator's peak over the window, and ``setup_s`` the seconds from the
process's start to the first timed step, less the seconds set-up spent
reading the program's state for the check.
"""

from __future__ import annotations

import gc
import importlib
import json
import math
import subprocess
import sys
import time
from typing import Callable, Optional

import torch

from perfbench.core import compare, program
from perfbench.core.manifest import Cell, Manifest
from perfbench.core.trace import summarize

GIB = 2 ** 30
#: steps of the window that run before the traced ones
TRACE_AFTER = 2


def load_kind(cell: Cell, seed: int, device):
    module = importlib.import_module(f"perfbench.kinds.{cell.traffic['step']}")
    return module.Kind(cell, seed, device)


def _retries(cuda: bool) -> int:
    return torch.cuda.memory_stats().get("num_alloc_retries", 0) if cuda else 0


def run_cell(manifest: Manifest, cell: Cell, seed: int, seconds: float, trace: bool,
             device, started: float,
             log: Callable[[str], None] = lambda line: print(line, file=sys.stderr)) -> dict:
    """The result line's object for one run (see ``perfbench/README.md``)."""
    t_in = time.monotonic()
    cuda = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    kind = load_kind(cell, seed, device)
    kind.setup()
    sync()
    setup_s = time.monotonic() - started - kind.check_s
    log(f"set-up {setup_s:.3f} s: {t_in - started:.3f} s to the cell, "
        + ", ".join(f"{k} {v:.3f} s" for k, v in kind.timings.items())
        + f" (check readings {kind.check_s:.3f} s apart)")

    if cuda:
        torch.cuda.reset_peak_memory_stats()
    retries0 = _retries(cuda)
    traced_steps = cell.traffic["trace_steps"] if trace else 0
    prof = None
    t_start = time.monotonic()
    i = 0
    while True:
        if traced_steps and i == TRACE_AFTER:
            sync()
            from torch.profiler import ProfilerActivity, profile

            prof = profile(activities=[ProfilerActivity.CPU]
                           + ([ProfilerActivity.CUDA] if cuda else []))
            prof.__enter__()
            launches0 = program.forward_launches()
            t_trace = time.monotonic()
        kind.step(i)
        i += 1
        if prof is not None and i == TRACE_AFTER + traced_steps:
            sync()
            trace_wall = time.monotonic() - t_trace
            launches = program.forward_launches() - launches0
            prof.__exit__(None, None, None)
        if time.monotonic() - t_start >= seconds and i >= TRACE_AFTER + traced_steps:
            break
    sync()
    window_s = time.monotonic() - t_start
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    retries = _retries(cuda) - retries0
    counts = kind.finish()
    log(f"window {window_s:.3f} s, {i} steps, peak {peak / GIB:.3f} GiB")

    result = {"correct": False, **counts}
    if trace:
        tr = summarize(prof, trace_wall, traced_steps, kind.work(),
                       {"flash_fwd_launches": launches, "alloc_retries": retries,
                        "window_steps": i})
        metrics = {}
        for m in cell.per_layer:
            value = manifest.metric_reader(m["name"]).read(tr)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        result["metrics"] = metrics
        result["breakdown"] = {"device_ops": [list(x) for x in tr.device_ops],
                               "idle_gaps": [list(x) for x in tr.idle_gaps]}
        busy = {"busy_s": tr.busy_s, "window_s": tr.wall_s}
        del prof, tr
    else:
        values = {"tokens_per_s": i * kind.tokens_per_step() / window_s,
                  "peak_mem_gib": peak / GIB, "setup_s": setup_s}
        result["metrics"] = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                             for m in cell.end_to_end}
        busy = {}
    result["device"] = {**device_info(device, cell.chips), "memory_peak_bytes": peak, **busy}

    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.monotonic()
    checks = compare.judge(kind.check(), cell.limits)
    log(f"check {time.monotonic() - t0:.3f} s; each reading's gaps {kind.each_gaps}")
    result["correct"] = compare.passed(checks) and result["failed"] == 0
    result["checks"] = {n: {"value": _number(c["value"]), "limit": c["limit"]}
                        for n, c in checks.items()}
    return result


def _number(x: float) -> Optional[float]:
    return x if math.isfinite(x) else None


def device_info(device, chips: int) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips,
            "power_limit_w": power_limit_w()}


def power_limit_w() -> Optional[float]:
    """The card's power limit as ``nvidia-smi`` reads it (the peaks assume
    700 W), or None where it cannot be read."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                              "--format=csv,noheader,nounits"],
                             capture_output=True, text=True, timeout=30).stdout
        return float(out.split()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def dumps(result: dict) -> str:
    return json.dumps(result, allow_nan=False)
