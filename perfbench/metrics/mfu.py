"""``mfu``: the traced steps' model FLOPs (the step kind's frozen count,
recomputation left out) over their wall time, as a share of one H100's
989 TFLOP/s of dense bf16."""

from perfbench.core.flops import PEAK_BF16_FLOPS


def read(trace):
    if trace.wall_s <= 0:
        return None
    return 100.0 * trace.work["flops_per_step"] * trace.steps / trace.wall_s / PEAK_BF16_FLOPS
