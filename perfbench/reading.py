"""What one run measured, as the metric readers (``metrics/*.py``) see it.

Host-clock numbers are rank 0's; the allreduce keeps the ranks in step.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional


@dataclass
class Trace:
    window_s: float             # the traced window, rank 0
    busy_s: float               # device busy in it, rank 0
    device_s: Dict[str, float]  # device seconds by operation, rank 0
    idle_s: Dict[str, float]    # idle seconds by host label, rank 0
    calls: int                  # histogram calls in the traced window
    entries: int                # entries those calls read, one rank
    trees: float                # calls / calls a tree


@dataclass
class Reading:
    ranks: int
    nbins: int
    calls_per_tree: int
    setup_s: float              # process start through the warm-up trees
    window_s: float             # the measured window (whole trees)
    calls: int                  # histogram calls completed in the window
    level_ms: List[float]       # each level's time, first issue to host
    issue_s: float              # host time inside the calls, untraced
    issue_calls: int
    peak_window_bytes: int      # allocated peak in the window, fullest rank
    trace: Optional[Trace]      # with --trace 1
