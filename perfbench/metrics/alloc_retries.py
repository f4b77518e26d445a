"""``alloc_retries``: the CUDA caching allocator's retries (a failed
allocation that freed its cache and tried again) over the window, a step."""


def read(trace):
    steps = trace.counters.get("window_steps", 0)
    return trace.counters["alloc_retries"] / steps if steps else None
