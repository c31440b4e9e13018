"""device_idle_pct: the share of the traced window in which no operation
runs on rank 0's card, in %."""


def read(r):
    t = r.trace
    if t is None or not t.busy_s:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
