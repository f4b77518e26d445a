"""``elementwise_ms``: device milliseconds a step of every operation that is
not a matrix product, not attention (the ``flash_`` kernels and the kernels
inside the ``flash_bwd_delta`` range) and not the optimizer: norms, rotary,
casts, copies, the blockwise loss."""


def read(trace):
    seconds = trace.groups_s.get("other", 0.0) - trace.ranges_s.get("flash_bwd_delta", 0.0)
    return 1e3 * seconds / trace.steps if seconds > 0 else None
