"""``optimizer_ms``: device milliseconds a step of the optimizer's
multi-tensor kernels (``ClippedAdamW``: the clip's norms and the AdamW
update)."""


def read(trace):
    seconds = trace.groups_s.get("optimizer", 0.0)
    return 1e3 * seconds / trace.steps if seconds > 0 else None
