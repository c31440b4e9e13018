"""issue_us_per_call: the host's time inside each call of the port's
entry, with no synchronisation in it, averaged over the untraced calls
(the first half of a --trace 1 window): the wrapper, the dispatch rule,
the kernel's launch and the collective's enqueue."""


def read(r):
    return 1e6 * r.issue_s / r.issue_calls if r.issue_calls else None
