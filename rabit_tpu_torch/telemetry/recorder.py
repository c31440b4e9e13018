"""Low-overhead span recorder behind the collective telemetry API: the
port's own copy of ``rabit_tpu/telemetry/recorder.py``.

- **off by default** (``rabit_telemetry=0``): the disabled fast path is
  one attribute load + one ``if`` per call site, and nothing telemetry
  does changes a computation (spans are host-side; the
  ``record_function`` labels are applied only when enabled and add no
  operation either way).
- **bounded memory**: spans land in a ring buffer of configurable
  capacity (``rabit_telemetry_buffer``, default 4096); under churn the
  oldest spans are overwritten and counted in ``dropped`` — counters
  keep exact totals regardless.
- **counters keyed op×method×size-bucket**: every span/ event also
  folds into an exact counter row ``(name, op, method, wire, bucket,
  provenance)`` with count / bytes / total seconds / max seconds and a
  log2-microsecond duration histogram, so summaries stay O(distinct
  keys) no matter how many collectives ran.
- **thread-safe**: the engines' async worker and the robust engine's
  data-plane callback record from other threads; all mutation happens
  under one lock (the enabled check stays lock-free — a torn read there
  only means one span more or less).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

_ENV_ENABLED = "RABIT_TELEMETRY"
_ENV_BUFFER = "RABIT_TELEMETRY_BUFFER"

DEFAULT_CAPACITY = 4096

# Size buckets: powers of 4 from 1 KiB to 256 MiB (the payload range the
# dispatch table spans), plus an open top bucket and "0B" for
# byte-less events.
_BUCKET_BOUNDS = [1 << (10 + 2 * i) for i in range(10)]  # 1K .. 256M


def _fmt_bytes(n: int) -> str:
    if n >= 1 << 20:
        return f"{n >> 20}MiB"
    return f"{n >> 10}KiB"


def size_bucket(nbytes: int) -> str:
    """Histogram bucket label for a payload size in bytes."""
    if nbytes <= 0:
        return "0B"
    for b in _BUCKET_BOUNDS:
        if nbytes <= b:
            return "<=" + _fmt_bytes(b)
    return ">" + _fmt_bytes(_BUCKET_BOUNDS[-1])


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").lower() in ("1", "true", "yes", "on")


class _NullSpan:
    """Singleton returned when telemetry is disabled: enter/exit are
    no-ops and ``live`` lets instrumented call sites skip any
    measurement-only work (e.g. ``block_until_ready``)."""

    live = False
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_SPAN = _NullSpan()


class _Span:
    live = True
    __slots__ = ("_rec", "name", "nbytes", "op", "method", "wire",
                 "attrs", "_t0")

    def __init__(self, rec, name, nbytes, op, method, wire, attrs):
        self._rec = rec
        self.name = name
        self.nbytes = nbytes
        self.op = op
        self.method = method
        self.wire = wire
        self.attrs = attrs

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        t1 = time.perf_counter()
        self._rec._record(self.name, self._t0, t1 - self._t0, self.nbytes,
                          self.op, self.method, self.wire, "", self.attrs)
        return False


class Recorder:
    """Ring-buffered span store + exact counters. One module-level
    instance serves the process; tests may build their own."""

    def __init__(self, capacity: int = DEFAULT_CAPACITY,
                 enabled: Optional[bool] = None):
        self._lock = threading.Lock()
        self.reset(capacity=capacity, enabled=enabled)

    # -- lifecycle --------------------------------------------------------
    def reset(self, capacity: Optional[int] = None,
              enabled: Optional[bool] = None) -> None:
        with self._lock:
            if capacity is not None:
                if capacity < 1:
                    raise ValueError(f"capacity must be >= 1, got {capacity}")
                self.capacity = capacity
            if enabled is None:
                enabled = _env_truthy(_ENV_ENABLED)
            self.enabled = enabled
            self._spans: list = []
            self._head = 0          # overwrite cursor once full
            self.recorded = 0       # spans ever recorded
            self.dropped = 0        # spans overwritten in the ring
            self._counters: dict = {}
            self._rounds: dict = {}
            self.t_base = time.perf_counter()
            # wall-clock anchor for the same instant as t_base: spans'
            # relative t0 + t_base_unix gives an absolute arrival time
            # comparable ACROSS ranks (cross-rank round stitching
            # by round id)
            self.t_base_unix = time.time()

    # -- recording --------------------------------------------------------
    def span(self, name: str, nbytes: int = 0, op=None, method=None,
             wire=None, **attrs):
        """Context manager timing one operation. Disabled mode returns
        the shared no-op span (``live == False``)."""
        if not self.enabled:
            return NULL_SPAN
        return _Span(self, name, int(nbytes), op, method, wire, attrs)

    def record_span(self, name: str, dur_s: float, nbytes: int = 0,
                    op=None, method=None, wire=None, provenance: str = "",
                    **attrs) -> None:
        """Directly record a completed span (tests, tools, and events
        whose duration was measured elsewhere)."""
        if not self.enabled:
            return
        t0 = time.perf_counter() - self.t_base
        self._record(name, self.t_base + t0, dur_s, int(nbytes), op,
                     method, wire, provenance, attrs)

    def count(self, name: str, nbytes: int = 0, op=None, method=None,
              wire=None, provenance: str = "") -> None:
        """Counter-only event (no span, no duration) — e.g. one
        dispatch-table resolution."""
        if not self.enabled:
            return
        key = (name, op or "", method or "", wire or "",
               size_bucket(nbytes), provenance)
        with self._lock:
            self._bump_locked(key, nbytes, None)

    def next_round(self, name: str) -> int:
        """Per-name collective sequence number (1-based). Engine call
        order is deterministic across ranks, so the same round id on
        two ranks names the same collective — the cross-rank stitching
        key. Advances only while enabled, so
        uniformly-configured ranks stay in step; returns 0 disabled."""
        if not self.enabled:
            return 0
        with self._lock:
            n = self._rounds.get(name, 0) + 1
            self._rounds[name] = n
            return n

    def _record(self, name, t0_abs, dur_s, nbytes, op, method, wire,
                provenance, attrs) -> None:
        entry = {
            "name": name,
            "t0": t0_abs - self.t_base,
            "dur": dur_s,
            "bytes": nbytes,
            "op": op or "",
            "method": method or "",
            "wire": wire or "",
            "tid": threading.get_ident(),
        }
        if provenance:
            entry["provenance"] = provenance
        if attrs:
            entry["attrs"] = dict(attrs)
        key = (name, op or "", method or "", wire or "",
               size_bucket(nbytes), provenance)
        with self._lock:
            self.recorded += 1
            if len(self._spans) < self.capacity:
                self._spans.append(entry)
            else:
                self._spans[self._head] = entry
                self._head = (self._head + 1) % self.capacity
                self.dropped += 1
            self._bump_locked(key, nbytes, dur_s)

    def _bump_locked(self, key, nbytes, dur_s) -> None:
        c = self._counters.get(key)
        if c is None:
            c = self._counters[key] = {
                "count": 0, "bytes": 0, "total_s": 0.0, "max_s": 0.0,
                "hist_log2_us": {}}
        c["count"] += 1
        c["bytes"] += nbytes
        if dur_s is not None:
            c["total_s"] += dur_s
            if dur_s > c["max_s"]:
                c["max_s"] = dur_s
            # log2(µs) histogram bucket: 0 covers <=1µs, k covers
            # (2^(k-1), 2^k] µs — cheap, bounded (~40 buckets max)
            exp = max(0, int(dur_s * 1e6).bit_length())
            h = c["hist_log2_us"]
            h[exp] = h.get(exp, 0) + 1

    def counter_rows(self, name: str) -> list:
        """Aggregated counter rows for one span/counter name — a cheap
        policy-plane read (no span-ring copy; dispatch's adaptive wire
        election calls this per resolve)."""
        out = []
        with self._lock:
            for (nm, op, method, wire, bucket, prov), c in \
                    self._counters.items():
                if nm != name:
                    continue
                out.append({"name": nm, "op": op, "method": method,
                            "wire": wire, "bucket": bucket,
                            "provenance": prov, "count": c["count"],
                            "bytes": c["bytes"],
                            "total_s": c["total_s"],
                            "max_s": c["max_s"]})
        return out

    # -- snapshots --------------------------------------------------------
    def snapshot(self) -> dict:
        """Point-in-time copy: spans in chronological order, counter
        rows as dicts (keys flattened into fields)."""
        with self._lock:
            if len(self._spans) < self.capacity:
                spans = list(self._spans)
            else:
                spans = self._spans[self._head:] + self._spans[:self._head]
            counters = []
            for (name, op, method, wire, bucket, prov), c in sorted(
                    self._counters.items()):
                row = {"name": name, "op": op, "method": method,
                       "wire": wire, "bucket": bucket,
                       "count": c["count"], "bytes": c["bytes"],
                       "total_s": c["total_s"], "max_s": c["max_s"],
                       "hist_log2_us": {str(k): v for k, v in
                                        sorted(c["hist_log2_us"].items())}}
                if prov:
                    row["provenance"] = prov
                counters.append(row)
            return {"enabled": self.enabled,
                    "capacity": self.capacity,
                    "recorded": self.recorded,
                    "dropped": self.dropped,
                    "t_base_unix": self.t_base_unix,
                    "spans": [dict(s) for s in spans],
                    "counters": counters}
