"""``idle_share``: 1 - busy / wall over the traced steps, in %: the share of
the host's clock in which no operation ran on the card."""


def read(trace):
    if trace.wall_s <= 0 or trace.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - trace.busy_s / trace.wall_s)
