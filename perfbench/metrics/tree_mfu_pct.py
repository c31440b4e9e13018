"""tree_mfu_pct: the whole step's share of the card's peak. A tree's
floor (its calls' bytes at the HBM peak, then each allreduce's
2 (p - 1) / p of the payload at NVLink's peak) over the traced window,
in %. The work is bytes-bound, so the peak that binds is bandwidth."""

from perfbench import floors


def read(r):
    t = r.trace
    if t is None or not t.busy_s:
        return None
    floor = floors.tree_floor_s(t.entries, t.calls, r.nbins, r.ranks)
    return floors.share_pct(floor, t.window_s)
