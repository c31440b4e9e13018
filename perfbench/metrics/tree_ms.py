"""tree_ms: the window over the trees completed in it, in ms. The window
holds whole trees only, so calls completed / calls a tree is their count."""


def read(r):
    return 1e3 * r.window_s / (r.calls / r.calls_per_tree)
