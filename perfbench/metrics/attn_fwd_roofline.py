"""``attn_fwd_roofline``: the attention forward's least time over its device
time, in %. The least time of one call is the larger of its products at the
bf16 peak and its bytes at the memory's peak (``core/flops.py``), times the
calls the program counted over the traced steps (recomputations included);
the device time is every ``flash_fwd`` kernel's."""

from perfbench.core.flops import least_seconds


def read(trace):
    calls = trace.counters.get("flash_fwd_launches", 0)
    device = sum(s for name, s in trace.kernels_s.items() if "flash_fwd" in name)
    if calls <= 0 or device <= 0:
        return None
    return 100.0 * calls * least_seconds(*trace.work["attn_fwd"]) / device
