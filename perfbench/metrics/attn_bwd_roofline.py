"""``attn_bwd_roofline``: the attention backward's least time over its device
time, in %. One backward a layer a step; the least time of one is the larger
of 10 d FLOPs a visible pair at the bf16 peak and its bytes at the memory's
peak (``core/flops.py``), whichever kernels compute it. The device time is
the ``flash_bwd`` kernels' and the ``flash_bwd_delta`` range's."""

from perfbench.core.flops import least_seconds


def read(trace):
    if "attn_bwd" not in trace.work:
        return None
    device = (sum(s for name, s in trace.kernels_s.items() if "flash_bwd" in name)
              + trace.ranges_s.get("flash_bwd_delta", 0.0))
    if device <= 0:
        return None
    calls = trace.work["attn_bwd_per_step"] * trace.steps
    return 100.0 * calls * least_seconds(*trace.work["attn_bwd"]) / device
