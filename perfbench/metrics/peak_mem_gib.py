"""peak_mem_gib: the caching allocator's peak over the window (reset at
its start, so the resident dataset counts), on the fullest rank."""


def read(r):
    return r.peak_window_bytes / 2 ** 30 if r.peak_window_bytes else None
