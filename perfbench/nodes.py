"""The one generator of traffic: a mix's file of parameters in, the
histogram calls of each tree out.

A tree is grown depthwise to ``max_depth``, as XGBoost's ``hist`` method
grows it. Its level 0 is one call over all of the rank's rows. Every later
level holds one call for the smaller child of each split of the level
above, over that child's rows: the larger child comes by subtraction and
needs no call. A depth-6 tree makes 1 + 1 + 2 + 4 + 8 + 16 = 32 calls.

The smaller child takes a fraction of its parent drawn uniformly from
``child_fraction``, on the left or the right. The draws come from the
mix's own ``shape_seed``, so every run and every ``--seed`` sees the same
trees: ``shapes`` of them, taken in turn. Node rows are contiguous slices
of the rank's rows, so a call's arrays start on a whole row.
"""

from __future__ import annotations

import random
from typing import List, Tuple

Call = Tuple[int, int]          # (first row, end row) of one call
Tree = List[List[Call]]         # levels, each its calls


def tree_shapes(mix: dict, rows: int) -> List[Tree]:
    """The mix's trees over ``rows`` rows, each a list of levels."""
    depth, count = int(mix["max_depth"]), int(mix["shapes"])
    lo, hi = (float(x) for x in mix["child_fraction"])
    if depth < 1 or count < 1 or not 0.0 < lo <= hi <= 0.5:
        raise ValueError(f"bad tree mix {mix!r}")
    rng = random.Random(int(mix["shape_seed"]))
    shapes = []
    for _ in range(count):
        nodes: List[Call] = [(0, rows)]
        levels: Tree = [[(0, rows)]]
        for _ in range(1, depth):
            calls, children = [], []
            for s, e in nodes:
                n = e - s
                if n < 2:
                    raise ValueError(f"a node of {n} row(s) cannot split: "
                                     f"{rows} rows are too few for {mix!r}")
                k = min(max(1, round(rng.uniform(lo, hi) * n)), n - 1)
                if rng.random() < 0.5:
                    small, large = (s, s + k), (s + k, e)
                    children += [small, large]
                else:
                    small, large = (e - k, e), (s, e - k)
                    children += [large, small]
                calls.append(small)
            levels.append(calls)
            nodes = children
        shapes.append(levels)
    return shapes


def calls_per_tree(shapes: List[Tree]) -> int:
    """Calls a tree; every shape of a mix makes the same number."""
    counts = {sum(len(level) for level in tree) for tree in shapes}
    if len(counts) != 1:
        raise ValueError(f"trees of one mix make {sorted(counts)} calls")
    return counts.pop()
