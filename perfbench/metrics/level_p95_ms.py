"""level_p95_ms: the 95th percentile over every level of the window of
the time from a level's first issue to its last reduced histogram on the
host, by CUDA events on rank 0's stream (numpy's linear percentile)."""

import numpy as np


def read(r):
    return float(np.percentile(r.level_ms, 95)) if r.level_ms else None
