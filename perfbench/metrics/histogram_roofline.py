"""histogram_roofline: the histogram calls' bytes floor over the device
time of the kernel csrc/histogram.cu (every kernel whose name holds
histogram_kernel) in the traced window, rank 0, in %."""

from perfbench import floors


def read(r):
    t = r.trace
    if t is None:
        return None
    kernel = sum(s for name, s in t.device_s.items()
                 if "histogram_kernel" in name)
    floor = floors.hist_floor_s(t.entries, t.calls, r.nbins)
    return floors.share_pct(floor, kernel) if kernel else None
