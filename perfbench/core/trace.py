"""The traced steps' reduction: from ``torch.profiler``'s events to the
numbers per-layer metrics read.

The grouping of kernels is a frozen copy of ``chip_smoke._kernel_group``
(the port's kernels by their ``flash_`` names, cuBLAS GEMMs, the
optimizer's multi-tensor kernels, everything else). The idle share is
1 - busy / wall, as ``chip_smoke.profile_report`` has it, with busy the
union of the device's operations (kernels, copies, sets) over the traced
wall. A ``torch.profiler.record_function`` range of the program (such as
``flash_bwd_delta``) counts the device time of the kernels launched by
operators that lie inside it on the host.
"""

from __future__ import annotations

import bisect
import dataclasses
from typing import Dict, List, Tuple

#: ranges the port opens around work it launches (``ops/attention.py``,
#: ``models/moe.py``); their device-side annotations are not operations
RANGES = ("flash_bwd_delta", "moe_router", "moe_dispatch", "moe_experts", "moe_combine")
TOP = 10
NAME_CHARS = 120


def kernel_group(name: str) -> str:
    if "flash_" in name:
        return "attention"
    if name.startswith(("nvjet", "sm90_", "cutlass")) or "gemm" in name.lower():
        return "gemm"
    if "multi_tensor_apply" in name:
        return "optimizer"
    return "other"


@dataclasses.dataclass
class Trace:
    """What per-layer metric readers read. Times in seconds over the
    ``steps`` traced steps; ``work`` is the step kind's yardstick
    (``flops_per_step``, ``attn_fwd`` and ``attn_bwd`` as (FLOPs, bytes)
    of one call, ``attn_bwd_per_step``), ``counters`` the program's
    counters over the traced steps and the window."""

    steps: int
    wall_s: float
    busy_s: float
    groups_s: Dict[str, float]
    kernels_s: Dict[str, float]
    ranges_s: Dict[str, float]
    work: Dict[str, object]
    counters: Dict[str, float]
    device_ops: List[Tuple[str, float]]
    idle_gaps: List[Tuple[str, float]]


def _union(intervals: List[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(covered length, gaps between covered stretches)."""
    covered, gaps, end = 0.0, [], None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                gaps.append((end, a))
            covered += b - a
            end = b
        elif b > end:
            covered += b - end
            end = b
    return covered, gaps


def _host_at(cpu: List[Tuple[float, float, str]], t: float) -> str:
    """The outermost and innermost host operators running at time t."""
    around = [(a, b, n) for a, b, n in cpu if a <= t <= b]
    if not around:
        return "host idle"
    outer = min(around, key=lambda e: (e[0], -e[1]))[2]
    inner = max(around, key=lambda e: (e[0], -e[1]))[2]
    return outer if outer == inner else f"{outer} > {inner}"


def summarize(prof, wall_s: float, steps: int, work: Dict[str, object],
              counters: Dict[str, float]) -> Trace:
    """The ``Trace`` of a stopped ``torch.profiler.profile`` that covered
    ``steps`` steps in ``wall_s`` seconds of the host's clock."""
    from torch.autograd import DeviceType

    events = prof.events()
    device, cpu, ranges = [], [], []
    for e in events:
        start, end = e.time_range.start, e.time_range.end
        if e.device_type == DeviceType.CPU:
            if e.name in RANGES:
                ranges.append((start, end, e.name, e.thread))
            cpu.append((start, end, e.name, e.thread, e))
        elif e.device_type == DeviceType.CUDA and e.name not in RANGES \
                and not getattr(e, "is_user_annotation", False) and end > start:
            device.append((start, end, e.name))
    busy_us, gaps = _union([(a, b) for a, b, _ in device])
    kernels: Dict[str, float] = {}
    groups: Dict[str, float] = {}
    for a, b, name in device:
        kernels[name] = kernels.get(name, 0.0) + (b - a) / 1e6
        g = kernel_group(name)
        groups[g] = groups.get(g, 0.0) + (b - a) / 1e6
    # a range's device time: the kernels of the operators inside it
    cpu.sort(key=lambda c: c[0])
    starts = [c[0] for c in cpu]
    ranges_s: Dict[str, float] = {}
    for a, b, name, thread in ranges:
        inside = sum(k.duration for s, t, _, th, op in cpu[bisect.bisect_left(starts, a):
                                                             bisect.bisect_right(starts, b)]
                     if th == thread and t <= b and op.name not in RANGES
                     for k in op.kernels)
        ranges_s[name] = ranges_s.get(name, 0.0) + inside / 1e6
    host = [(a, b, n) for a, b, n, _, _ in cpu]
    gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
    idle = [(_host_at(host, (a + b) / 2)[:NAME_CHARS], (b - a) / 1e6) for a, b in gaps[:TOP]]
    top = sorted(kernels.items(), key=lambda kv: kv[1], reverse=True)[:TOP]
    return Trace(steps=steps, wall_s=wall_s, busy_s=busy_us / 1e6, groups_s=groups,
                 kernels_s=kernels, ranges_s=ranges_s, work=work, counters=counters,
                 device_ops=[(n[:NAME_CHARS], s) for n, s in top], idle_gaps=idle)
