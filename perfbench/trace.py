"""The profiler over a run's traced window, and what is read from it.

``torch.profiler`` records the device's kernels and copies and the
benchmark's own host labels (``record_function``): ``window`` around the
traced trees, and ``issue.L<d>``, ``copy_out.L<d>`` and ``sync.L<d>``
around each call's issue, each call's copy to the host and each level's
wait. Events are read from the profiler's raw results, one pass, without
the per-event objects that ``key_averages`` builds.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Tuple

import torch
from torch.profiler import ProfilerActivity, profile, record_function

WINDOW = "window"
LABELS = ("issue.", "copy_out.", "sync.")
TOP = 10
NAME_CHARS = 160


def _span_ns(e) -> Tuple[int, int]:
    if hasattr(e, "start_ns"):
        start = e.start_ns()
        return start, start + e.duration_ns()
    start = int(e.start_us() * 1000)
    return start, start + int(e.duration_us() * 1000)


def device_work(e) -> bool:
    """Whether a device event is work. Host labels, the benchmark's and
    c10d's (``nccl:coalesced``, ``nccl:all_reduce``), are mirrored on the
    device's timeline as annotations over the kernels they launched."""
    name = e.name()
    annotation = getattr(e, "is_user_annotation", None)
    return not ((annotation is not None and annotation())
                or name == WINDOW or name.startswith(LABELS)
                or name.startswith("nccl:"))


def _union(spans: List[Tuple[int, int]]) -> List[Tuple[int, int]]:
    merged: List[List[int]] = []
    for s, e in sorted(spans):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Tracer:
    """A profiler over the traced window, with the ``window`` label."""

    def __init__(self, device: torch.device):
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.device = device
        self.prof = profile(activities=acts, record_shapes=False,
                            with_stack=False, profile_memory=False)
        self.window = record_function(WINDOW)

    def start(self) -> None:
        self.prof.start()
        self.window.__enter__()

    def stop(self) -> None:
        self.window.__exit__(None, None, None)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.prof.stop()

    def summary(self) -> dict:
        """window_s; busy_s (the union of device operations in the
        window); device_s and device_n, each device operation's seconds
        and count by name; and
        idle_s, the device's idle seconds by the host label open at each
        idle gap's midpoint (``host`` where none is)."""
        gpu: List[Tuple[int, int, str]] = []
        labels: List[Tuple[int, int, str]] = []
        window = None
        cuda = torch.autograd.DeviceType.CUDA
        for e in self.prof.profiler.kineto_results.events():
            name = e.name()
            if e.device_type() == cuda:
                if device_work(e):
                    gpu.append((*_span_ns(e), name))
            elif name == WINDOW:
                window = _span_ns(e)
            elif name.startswith(LABELS):
                labels.append((*_span_ns(e), name))
        if window is None:
            raise RuntimeError("the trace holds no window label")
        w0, w1 = window
        device_s: Dict[str, float] = defaultdict(float)
        device_n: Dict[str, int] = defaultdict(int)
        spans = []
        for s, e, name in gpu:
            s, e = max(s, w0), min(e, w1)
            if e > s:
                device_s[name[:NAME_CHARS]] += (e - s) * 1e-9
                device_n[name[:NAME_CHARS]] += 1
                spans.append((s, e))
        busy = _union(spans)
        labels.sort()
        starts = [s for s, _, _ in labels]
        idle_s: Dict[str, float] = defaultdict(float)
        edge = w0
        for s, e in busy + [(w1, w1)]:
            if s > edge:
                mid = (edge + s) // 2
                i = bisect.bisect_right(starts, mid) - 1
                name = (labels[i][2] if i >= 0 and labels[i][1] >= mid
                        else "host")
                idle_s[name] += (s - edge) * 1e-9
            edge = max(edge, e)
        return {"window_s": (w1 - w0) * 1e-9,
                "busy_s": sum(e - s for s, e in busy) * 1e-9,
                "device_s": dict(device_s), "device_n": dict(device_n),
                "idle_s": dict(idle_s)}


def top(seconds: Dict[str, float]) -> List[list]:
    """The ``TOP`` largest entries as [name, seconds], largest first."""
    return [[k, v] for k, v in sorted(seconds.items(),
                                      key=lambda kv: -kv[1])[:TOP]]
