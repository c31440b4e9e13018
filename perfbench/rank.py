"""One rank of a run: the only module of the benchmark that imports the
port.

A rank joins the run's process group (NCCL on the card, gloo on the CPU),
makes its shard from the seed, warms up, and grows trees for the window.
Every histogram call is the port's entry,
``rabit_tpu_torch.models.histogram.distributed_histogram``: the kernel
``csrc/histogram.cu``, then NCCL's allreduce below 32,768 floats or the
port's ring at or above it. A level's calls are issued back to back, each
result copied to a pinned host buffer as it is issued, and the level ends
when all of them are on the host, because split finding needs them all.

The ranks must make the same calls, so rank 0 alone decides, at the end of
a tree, when the window ends and when tracing starts, and writes the tree
at which that happens into an array that every rank of the host reads at
the end of each tree. No rank can finish a tree before rank 0 has issued
its first level, so rank 0 names a tree one further than the next
(two for tracing, which must start before a tree does) where it has peers.
"""

from __future__ import annotations

import contextlib
import json
import random
import sys
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from . import check, data, nodes
from .trace import Tracer

FORBIDDEN = ("jax", "jaxlib", "flax", "rabit_tpu")
CHECK_TREES = 2             # trees checked, one a gradient set
CHECK_FIRST = 4             # the first is drawn from trees [0, CHECK_FIRST)
STOP, TRACE_FROM = 0, 1     # a job's slots in the shared flags


@dataclass
class Job:
    seed: int
    seconds: float
    trace: bool
    precision: str = "high"     # "fast" is the port's bf16 path: the control


@dataclass
class World:
    """What every rank of a run shares; pickled into each rank."""
    config: dict
    mix: dict
    ranks: int
    device_type: str            # "cuda" or "cpu"
    tmp: str                    # the run's directory: store, results
    t_start: float              # the process's start, wall clock
    flags: object               # 2 ints a job, -1 until rank 0 sets them
    jobs: List[Job]
    prelude: Optional[Callable[[], None]] = None    # a test's fault


def forbidden_modules() -> List[str]:
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def entry(rank: int, world: World) -> None:
    """A spawned rank: its results go to ``rank<r>.json`` in the run's
    directory."""
    out = run_rank(rank, world)
    path = Path(world.tmp) / f"rank{rank}.json"
    path.with_suffix(".tmp").write_text(json.dumps(out))
    path.with_suffix(".tmp").rename(path)


def run_rank(rank: int, world: World) -> List[dict]:
    if world.prelude is not None:
        world.prelude()
    kwargs = {}
    if world.device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend, kwargs["device_id"] = "nccl", device
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(
        backend, store=dist.FileStore(f"{world.tmp}/store", world.ranks),
        rank=rank, world_size=world.ranks, **kwargs)
    try:
        # a communicator's first operation must include every rank
        dist.all_reduce(torch.zeros(1, device=device))
        return [Rank(rank, world, j, device).run()
                for j in range(len(world.jobs))]
    finally:
        dist.destroy_process_group()


class _LevelClock:
    """A level's time from its first issue to its last result on the
    host: CUDA events on the card (the device's clock), the host clock on
    the CPU."""

    def __init__(self, device: torch.device):
        self.cuda = device.type == "cuda"
        self.marks: List = []

    def start(self):
        if not self.cuda:
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def stop(self, mark) -> None:
        """Wait until the level's work is done, and note its time."""
        if not self.cuda:
            self.marks.append((time.perf_counter() - mark) * 1e3)
            return
        end = torch.cuda.Event(enable_timing=True)
        end.record()
        end.synchronize()
        self.marks.append((mark, end))

    def ms(self) -> List[float]:
        return [m if not self.cuda else m[0].elapsed_time(m[1])
                for m in self.marks]


class Rank:
    def __init__(self, rank: int, world: World, job_index: int,
                 device: torch.device):
        from rabit_tpu_torch.models import histogram
        self.entry = histogram      # the port, looked up at each call
        self.rank, self.world, self.device = rank, world, device
        self.job = world.jobs[job_index]
        self.slot = 2 * job_index
        self.peers = world.ranks > 1
        rows = data.rows_per_rank(world.config, world.ranks)
        self.shapes = nodes.tree_shapes(world.mix, rows)
        self.calls_per_tree = nodes.calls_per_tree(self.shapes)
        self.sets = int(world.mix["grad_sets"])
        first = random.Random(self.job.seed).randrange(CHECK_FIRST)
        self.checked = range(first, first + CHECK_TREES)

    def _flag(self, which: int) -> int:
        return self.world.flags[self.slot + which]

    def _set_flag(self, which: int, tree: int) -> None:
        self.world.flags[self.slot + which] = tree

    def grow(self, t: int, tracing: bool, clock: _LevelClock,
             kept: Optional[Dict]) -> float:
        """Tree ``t``, level by level. Returns the host seconds spent
        inside the entry's calls."""
        sh, f, nbins = self.shard, self.shard.features, self.shard.nbins
        g, h = sh.grad[t % self.sets], sh.hess[t % self.sets]
        label = (torch.profiler.record_function if tracing
                 else lambda name: contextlib.nullcontext())
        issue = 0.0
        for d, calls in enumerate(self.shapes[t % len(self.shapes)]):
            mark = clock.start()
            for i, (s, e) in enumerate(calls):
                lo, hi = s * f, e * f
                t0 = time.perf_counter()
                with label(f"issue.L{d}"):
                    out = self.entry.distributed_histogram(
                        g[lo:hi], h[lo:hi], sh.bins[lo:hi], nbins,
                        self.group, precision=self.job.precision)
                issue += time.perf_counter() - t0
                with label(f"copy_out.L{d}"):
                    self.pinned[i].copy_(out, non_blocking=True)
            with label(f"sync.L{d}"):
                clock.stop(mark)
            if kept is not None:
                for i in range(len(calls)):
                    kept[(t, d, i)] = self.pinned[i].clone()
        return issue

    def run(self) -> dict:
        job, dev, cuda = self.job, self.device, self.device.type == "cuda"
        w = self.world
        self.group = dist.group.WORLD
        self.shard = data.make_shard(w.config, job.seed, self.rank, w.ranks,
                                     self.sets, dev)
        width = max(len(level) for tree in self.shapes for level in tree)
        self.pinned = torch.empty((width, self.shard.nbins, 2),
                                  dtype=torch.float32, pin_memory=cuda)
        for t in range(self.sets):                      # warm-up
            self.grow(t, False, _LevelClock(dev), None)
        if job.trace:   # the profiler's first start is slow: not in the window
            warm = Tracer(dev)
            warm.start()
            self.grow(0, True, _LevelClock(dev), None)
            warm.stop()
            del warm
        dist.barrier()
        setup_s = time.time() - w.t_start
        peak_setup = torch.cuda.max_memory_allocated(dev) if cuda else 0
        if cuda:
            torch.cuda.reset_peak_memory_stats(dev)

        clock, kept, tracer = _LevelClock(dev), {}, None
        lag = 1 if self.peers else 0
        issue_s, issue_calls, traced_calls, traced_entries = 0.0, 0, 0, 0
        t0 = time.perf_counter()
        t, t_trace = 0, None
        while True:
            if job.trace and tracer is None and self._flag(TRACE_FROM) == t:
                tracer = Tracer(dev)
                tracer.start()
                t_trace = time.perf_counter()
            issue = self.grow(t, tracer is not None, clock,
                              kept if t in self.checked else None)
            shape = self.shapes[t % len(self.shapes)]
            if tracer is None:
                issue_s += issue
                issue_calls += self.calls_per_tree
            else:
                traced_calls += self.calls_per_tree
                traced_entries += self.shard.features * sum(
                    e - s for level in shape for s, e in level)
            if self.rank == 0:
                now = time.perf_counter()
                if not job.trace:
                    done = now - t0 >= job.seconds
                else:   # half untraced, half traced
                    if (self._flag(TRACE_FROM) < 0
                            and now - t0 >= job.seconds / 2):
                        self._set_flag(TRACE_FROM, t + 1 + lag)
                    done = (t_trace is not None
                            and now - t_trace >= job.seconds / 2)
                if (self._flag(STOP) < 0 and done
                        and t >= self.checked[-1]):
                    self._set_flag(STOP, max(t + lag, self._flag(TRACE_FROM)))
            if 0 <= self._flag(STOP) <= t:
                break
            t += 1
        window_s = time.perf_counter() - t0
        trees = t + 1
        if tracer is not None:
            tracer.stop()
        peak_window = torch.cuda.max_memory_allocated(dev) if cuda else 0
        found = forbidden_modules()
        summary = tracer.summary() if tracer is not None else None
        del tracer

        # the check: after the window, with the peak read
        tc = time.perf_counter()
        checked_nodes = [((t_, d, i), s, e, t_ % self.sets)
                  for t_ in self.checked
                  for d, level in enumerate(self.shapes[t_ % len(self.shapes)])
                  for i, (s, e) in enumerate(level)]
        own = self.shard
        del self.shard, self.pinned

        def shard_of(r: int) -> data.Shard:
            return own if r == self.rank else data.make_shard(
                w.config, job.seed, r, w.ranks, self.sets, dev)

        err, failed = check.compare(kept, checked_nodes, shard_of, w.ranks,
                                    dev)
        del own, kept
        if cuda:
            torch.cuda.empty_cache()
        return {
            "setup_s": setup_s, "window_s": window_s,
            "trees": trees, "calls": trees * self.calls_per_tree,
            "calls_per_tree": self.calls_per_tree,
            "nbins": int(w.config["features"]) * int(w.config["max_bin"]),
            "level_ms": clock.ms() if self.rank == 0 else [],
            "issue_s": issue_s, "issue_calls": issue_calls,
            "peak_window_bytes": peak_window,
            "peak_bytes": max(peak_setup, peak_window),
            "trace": summary, "traced_calls": traced_calls,
            "traced_entries": traced_entries,
            "hist_rel_err": err, "failed": failed,
            "checked": len(checked_nodes),
            "check_s": time.perf_counter() - tc,
            "forbidden": found,
        }
