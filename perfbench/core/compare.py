"""The numbers that decide ``correct``, each against its limit.

Per-leaf norms are compared by the worst leaf: the gap between the
program's norm and the reference's, over the reference's norm of that
leaf or of the median leaf, whichever is larger, since some leaves are
all but zero."""

from __future__ import annotations

import math
import statistics
from typing import Dict, Iterable, Optional


def leaf_gap(program: Dict[str, float], reference: Dict[str, float],
             leaves: Optional[Iterable[str]] = None) -> float:
    names = list(reference if leaves is None else leaves)
    median = statistics.median(reference[n] for n in names)
    gaps = [abs(program[n] - reference[n]) / max(reference[n], median) for n in names]
    worst = max(gaps)
    return worst if math.isfinite(worst) else math.inf


def moved_leaves(grad_norms: Dict[str, float]) -> list:
    """Leaves whose first reference gradient is above a thousandth of the
    median leaf's: the others move under Adam by round-off alone."""
    median = statistics.median(grad_norms.values())
    return [n for n, g in grad_norms.items() if g > 1e-3 * median]


def max_abs_gap(program, reference) -> float:
    worst = max(abs(a - b) for a, b in zip(program, reference, strict=True))
    return worst if math.isfinite(worst) else math.inf


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """{name: {"value", "limit"}} for every limit; a value missing or not
    finite fails."""
    return {name: {"value": values.get(name, math.inf), "limit": limit}
            for name, limit in limits.items()}


def passed(checks: Dict[str, dict]) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"] for c in checks.values())
