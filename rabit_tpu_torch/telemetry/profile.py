"""Deep profiling plane: compile-time, cache, analytic collective cost,
overlap and device-memory accounting — the port's twin of
``rabit_tpu/telemetry/profile.py``. Off by default (``rabit_profile=1``
turns it on), and a no-op on every computation: what it records is
host-side, so the operations a step runs are the same with it on or off
(asserted in tests, the same bar as telemetry itself).

What it records:

- **compile probes** (``jit_probe(tag, fn)``): wrap a call to ``fn``;
  the probe reads ``fn._cache_size()`` before and after. Growth means
  this call paid the compile — the elapsed wall time is recorded as a
  compile sample under ``tag`` and a cache *miss*; no growth is a cache
  *hit*. A function without that method records nothing ("no data",
  never wrong data): the port's collectives run eagerly, so they have
  none. The port's compile is the nvcc build of a kernel library at its
  first use: ``ops/_build.py::load`` runs under the probe
  ``build:<library>``, with ``_build._cache_size`` counting the loaded
  libraries, so a first load is a compile sample and a miss and every
  later load a hit.
- **cache events** (``cache_event(tag, hit=...)``): plain hit/miss
  counters for host-side caches (the dispatch-table mtime cache).
- **analytic collective cost** (``record_cost(...)``): FLOPs and wire
  bytes from the schedule shape — ring/bidir move ``2·n·(p−1)/p``
  elements per rank over ``2(p−1)`` hops, swing moves the same bytes
  over ``2·log2(p)`` halving/doubling steps, tree/psum is modelled as
  reduce-scatter + allgather over ``2·ceil(log2 p)`` hops. Wire
  quantization scales bytes (bf16 → 2 B/elem, int8 → 1 B/elem plus the
  per-block scale). Totals are kept here *and* returned so call sites
  can stamp them into the span recorder as attrs. The model is the JAX
  package's, number for number.
- **overlap** (``record_overlap(...)``): an async collective's exposed
  and overlapped wire time, measured by its handle at ``wait()``.
- **device memory** (``sample_memory()`` + optional poller thread):
  the CUDA caching allocator's ``torch.cuda.memory_stats`` of each
  device, summed: ``live_bytes`` from ``allocated_bytes.all.current``,
  ``peak_bytes`` the high-water mark of itself and
  ``allocated_bytes.all.peak``, ``arrays`` from
  ``allocation.all.current``. Here the port differs from the JAX
  package: in a process that has not initialised CUDA the sample is
  ``None`` (the CPU allocator keeps no count) and the snapshot's
  ``device_mem`` stays at zeros with ``samples`` 0, where JAX on the CPU
  sums ``jax.live_arrays()``. ``rabit_profile_memory_poll_ms`` runs a
  daemon poller so peaks between snapshots aren't missed.

``snapshot()`` returns a plain-JSON section that ``export.build_summary``
attaches to every ``telemetry_summary`` document when profiling is on.
"""

from __future__ import annotations

import math
import os
import threading
import time
from typing import Any, Dict, Optional

ENV_ENABLED = "RABIT_PROFILE"
ENV_POLL_MS = "RABIT_PROFILE_MEMORY_POLL_MS"
MEMORY_POLL_MS_DEFAULT = 500

# bytes shipped per element for the legacy symmetric wire modes (int8
# adds one f32 scale per 1024-element block — see parallel/wire.py).
# Phase-split / custom-block specs ("int8:bf16", "bf16@512", ...) are
# delegated to parallel.wire.wire_itemsize lazily, so this module stays
# importable without torch.
_WIRE_ITEMSIZE = {"bf16": 2.0, "int8": 1.0 + 4.0 / 1024.0}


def _wire_itemsize_of(wire: Optional[str], itemsize: int) -> float:
    if not wire:
        return float(itemsize)
    b = _WIRE_ITEMSIZE.get(wire)
    if b is not None:
        return b
    try:
        from ..parallel.wire import wire_itemsize
        return wire_itemsize(wire, itemsize)
    except (ImportError, ValueError):
        return float(itemsize)


def _env_enabled() -> bool:
    return os.environ.get(ENV_ENABLED, "").strip().lower() in (
        "1", "true", "yes", "on")


def collective_cost(method: Optional[str], n: int, itemsize: int,
                    axis_size: int, wire: Optional[str] = None,
                    phase: Optional[str] = None,
                    group_size: Optional[int] = None) -> Dict[str, Any]:
    """Analytic per-rank cost of one allreduce-shaped collective.

    Returns ``{"flops", "wire_bytes", "hops"}``. All bandwidth-optimal
    schedules here (ring, bidir, swing) ship ``2·n·(p−1)/p`` elements
    per rank; they differ in hop count (latency term). Tree/psum is
    modelled the same way over ``2·ceil(log2 p)`` hops — an upper-bound
    fiction for the library's fused reduction (NCCL's or gloo's), but a
    stable one to trend against.

    ``phase="rs"`` / ``"ag"`` models a standalone reduce-scatter /
    all-gather: one direction of the round trip (``n·(p−1)/p`` elements,
    ``p−1`` ring hops; an all-gather reduces nothing, so flops 0).

    ``method="hier"`` with ``group_size=g`` models the two-level
    schedule on H = p/g hosts: intra RS + AG at full precision plus an
    inter allreduce of n/g elements over H ranks (the only wire-scaled
    term), in ``2(g−1) + 2(H−1)`` hops.
    """
    p = max(1, int(axis_size))
    n = max(0, int(n))
    if p == 1 or n == 0:
        return {"flops": 0, "wire_bytes": 0, "hops": 0}
    wire_b = _wire_itemsize_of(wire, itemsize)
    if (method == "hier" and group_size and 1 < group_size < p
            and p % group_size == 0):
        g, hosts = group_size, p // group_size
        intra = 2.0 * n * (g - 1) / g
        inter = 2.0 * (n / g) * (hosts - 1) / hosts
        return {"flops": int(n * (p - 1) / p),
                "wire_bytes": int(intra * itemsize + inter * wire_b),
                "hops": 2 * (g - 1) + 2 * (hosts - 1)}
    elems = 2.0 * n * (p - 1) / p
    log2p = max(1, math.ceil(math.log2(p)))
    if method == "swing":
        hops = 2 * log2p
    elif method in ("ring", "bidir", "hier"):
        hops = 2 * (p - 1)  # hier w/o usable grouping degrades to ring
    else:  # tree / psum / psum_mask
        hops = 2 * log2p
    flops = n * (p - 1) / p
    if phase == "rs":
        elems, hops = elems / 2, hops // 2
    elif phase == "ag":
        elems, hops, flops = elems / 2, hops // 2, 0
    return {"flops": int(flops),
            "wire_bytes": int(elems * wire_b),
            "hops": hops}


class _NullProbe:
    """Shared disabled probe — zero allocation on the hot path."""

    __slots__ = ()
    live = False

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NULL_PROBE = _NullProbe()


class _JitProbe:
    """Times one call to ``fn`` and classifies it hit/miss by the growth
    of its ``_cache_size()``. The recorded "compile" time is the full
    first-call cost (for a kernel library: nvcc, then the load) — the
    number a user actually waits for."""

    __slots__ = ("_prof", "_tag", "_fn", "_before", "_t0")
    live = True

    def __init__(self, prof: "Profiler", tag: str, fn: Any):
        self._prof = prof
        self._tag = tag
        self._fn = fn

    def _cache_size(self) -> Optional[int]:
        size = getattr(self._fn, "_cache_size", None)
        if not callable(size):
            return None
        try:
            return int(size())
        except Exception:
            return None

    def __enter__(self):
        self._before = self._cache_size()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dur = time.perf_counter() - self._t0
        after = self._cache_size()
        if self._before is None or after is None:
            return False  # no cache API — record nothing, never guess
        miss = after > self._before
        self._prof.cache_event(self._tag, hit=not miss)
        if miss:
            self._prof.record_compile(self._tag, dur)
        return False


class Profiler:
    """Lock-guarded exact counters; safe to call from any thread."""

    def __init__(self, enabled: Optional[bool] = None):
        self._lock = threading.Lock()
        self.reset(enabled=enabled)

    # ------------------------------------------------------- lifecycle

    def reset(self, enabled: Optional[bool] = None) -> None:
        with self._lock:
            if enabled is not None:
                self._enabled = bool(enabled)
            elif not hasattr(self, "_enabled"):
                self._enabled = _env_enabled()
            self._compile: Dict[str, Dict[str, float]] = {}
            self._cache: Dict[str, Dict[str, int]] = {}
            self._cost: Dict[tuple, Dict[str, int]] = {}
            self._overlap: Dict[tuple, Dict[str, float]] = {}
            self._mem: Dict[str, int] = {
                "live_bytes": 0, "peak_bytes": 0, "arrays": 0, "samples": 0}

    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, on: bool) -> None:
        with self._lock:
            self._enabled = bool(on)

    # --------------------------------------------------------- probes

    def jit_probe(self, tag: str, fn: Any):
        if not self._enabled:
            return _NULL_PROBE
        return _JitProbe(self, tag, fn)

    def cache_event(self, tag: str, hit: bool) -> None:
        if not self._enabled:
            return
        with self._lock:
            c = self._cache.setdefault(tag, {"hits": 0, "misses": 0})
            c["hits" if hit else "misses"] += 1

    def record_compile(self, tag: str, dur_s: float) -> None:
        if not self._enabled:
            return
        with self._lock:
            c = self._compile.setdefault(
                tag, {"count": 0, "total_s": 0.0, "max_s": 0.0})
            c["count"] += 1
            c["total_s"] += dur_s
            c["max_s"] = max(c["max_s"], dur_s)

    def record_cost(self, name: str, method: Optional[str],
                    wire: Optional[str], n: int, itemsize: int,
                    axis_size: int, phase: Optional[str] = None,
                    group_size: Optional[int] = None
                    ) -> Optional[Dict[str, Any]]:
        """Accumulate an analytic cost sample; returns the estimate so
        the caller can stamp it into its span, or None when disabled."""
        if not self._enabled:
            return None
        est = collective_cost(method, n, itemsize, axis_size, wire,
                              phase=phase, group_size=group_size)
        key = (name, method or "", wire or "")
        with self._lock:
            c = self._cost.setdefault(
                key, {"count": 0, "flops": 0, "wire_bytes": 0})
            c["count"] += 1
            c["flops"] += est["flops"]
            c["wire_bytes"] += est["wire_bytes"]
        return est

    def record_overlap(self, name: str, method: Optional[str],
                       exposed_s: float, overlapped_s: float) -> None:
        """One completed async collective's exposed-vs-hidden wire
        split (measured by the handle at ``wait()``): ``exposed_s`` is
        wall time the caller actually blocked, ``overlapped_s`` is wire
        time hidden behind whatever ran between issue and wait. Served
        as the ``rabit_collective_overlap_*`` families."""
        if not self._enabled:
            return
        key = (name, method or "")
        with self._lock:
            c = self._overlap.setdefault(
                key, {"count": 0, "exposed_ms": 0.0, "overlapped_ms": 0.0})
            c["count"] += 1
            c["exposed_ms"] += exposed_s * 1e3
            c["overlapped_ms"] += overlapped_s * 1e3

    # --------------------------------------------------------- memory

    def sample_memory(self) -> Optional[Dict[str, int]]:
        """One device-memory sample from the CUDA caching allocator of
        every device, summed; ``None`` when disabled or when this process
        has not initialised CUDA. Never raises."""
        if not self._enabled:
            return None
        try:
            import torch
            if not torch.cuda.is_initialized():
                return None
            live = dev_peak = n_arrays = 0
            for d in range(torch.cuda.device_count()):
                stats = torch.cuda.memory_stats(d)
                live += int(stats.get("allocated_bytes.all.current", 0))
                dev_peak += int(stats.get("allocated_bytes.all.peak", 0))
                n_arrays += int(stats.get("allocation.all.current", 0))
        except Exception:
            return None
        with self._lock:
            self._mem["live_bytes"] = live
            self._mem["arrays"] = n_arrays
            self._mem["peak_bytes"] = max(
                self._mem["peak_bytes"], live, dev_peak)
            self._mem["samples"] += 1
            return dict(self._mem)

    # ------------------------------------------------------- snapshot

    def snapshot(self) -> Dict[str, Any]:
        """Plain-JSON section for summaries. Takes a fresh memory
        sample first so snapshots are never stale."""
        self.sample_memory()
        with self._lock:
            return {
                "compile": [
                    {"fn": tag, "count": int(c["count"]),
                     "total_s": c["total_s"], "max_s": c["max_s"]}
                    for tag, c in sorted(self._compile.items())],
                "jit_cache": [
                    {"fn": tag, "hits": c["hits"], "misses": c["misses"]}
                    for tag, c in sorted(self._cache.items())],
                "cost": [
                    {"name": k[0], "method": k[1], "wire": k[2],
                     "count": c["count"], "flops": c["flops"],
                     "wire_bytes": c["wire_bytes"]}
                    for k, c in sorted(self._cost.items())],
                "overlap": [
                    {"name": k[0], "method": k[1], "count": c["count"],
                     "exposed_ms": c["exposed_ms"],
                     "overlapped_ms": c["overlapped_ms"]}
                    for k, c in sorted(self._overlap.items())],
                "device_mem": dict(self._mem),
            }


# ----------------------------------------------------- module-level API

_PROFILER = Profiler()
_poll_thread: Optional[threading.Thread] = None
_poll_stop = threading.Event()


def enabled() -> bool:
    return _PROFILER.enabled


def set_enabled(on: bool) -> None:
    _PROFILER.set_enabled(on)
    if not on:
        stop_poller()


def reset(enabled: Optional[bool] = None) -> None:
    _PROFILER.reset(enabled=enabled)


def jit_probe(tag: str, fn: Any):
    return _PROFILER.jit_probe(tag, fn)


def cache_event(tag: str, hit: bool) -> None:
    _PROFILER.cache_event(tag, hit)


def record_compile(tag: str, dur_s: float) -> None:
    _PROFILER.record_compile(tag, dur_s)


def record_cost(name: str, method: Optional[str], wire: Optional[str],
                n: int, itemsize: int, axis_size: int,
                phase: Optional[str] = None,
                group_size: Optional[int] = None):
    return _PROFILER.record_cost(name, method, wire, n, itemsize,
                                 axis_size, phase=phase,
                                 group_size=group_size)


def record_overlap(name: str, method: Optional[str], exposed_s: float,
                   overlapped_s: float) -> None:
    _PROFILER.record_overlap(name, method, exposed_s, overlapped_s)


def sample_memory():
    return _PROFILER.sample_memory()


def snapshot() -> Dict[str, Any]:
    return _PROFILER.snapshot()


def _poll_loop(interval_s: float) -> None:
    while not _poll_stop.wait(interval_s):
        if not _PROFILER.enabled:
            return
        _PROFILER.sample_memory()


def start_poller(interval_ms: int = MEMORY_POLL_MS_DEFAULT) -> bool:
    """Start the daemon memory poller (idempotent). ``interval_ms <= 0``
    disables polling (on-demand samples still happen at snapshot)."""
    global _poll_thread
    if interval_ms <= 0 or not _PROFILER.enabled:
        return False
    if _poll_thread is not None and _poll_thread.is_alive():
        return True
    _poll_stop.clear()
    _poll_thread = threading.Thread(
        target=_poll_loop, args=(max(0.01, interval_ms / 1000.0),),
        name="rabit-profile-mem", daemon=True)
    _poll_thread.start()
    return True


def stop_poller() -> None:
    global _poll_thread
    _poll_stop.set()
    t = _poll_thread
    if t is not None and t.is_alive():
        t.join(timeout=1.0)
    _poll_thread = None


def configure(cfg) -> bool:
    """Apply ``rabit_profile`` / ``rabit_profile_memory_poll_ms`` from a
    Config (both engines call this at init, mirroring
    ``telemetry.configure``). Only keys present are applied, so a bare
    init inherits the environment seed."""
    if cfg is None:
        return _PROFILER.enabled
    if "rabit_profile" in cfg:
        set_enabled(cfg.get_bool("rabit_profile", False))
    if _PROFILER.enabled:
        poll_ms = int(cfg.get_int(
            "rabit_profile_memory_poll_ms",
            int(os.environ.get(ENV_POLL_MS, MEMORY_POLL_MS_DEFAULT))))
        start_poller(poll_ms)
    return _PROFILER.enabled
