"""Exporters for recorder snapshots: the port's own copy of
``rabit_tpu/telemetry/export.py``.

Two artifact kinds, both carrying the shared schema header
(``telemetry/schema.py``) with the JAX package's ids:

- ``rabit_tpu.telemetry_summary/v1`` — counters + ring-buffer stats,
  small enough to ship through the tracker protocol and diff in CI.
- ``rabit_tpu.telemetry_trace/v1`` — Chrome trace-event JSON
  (``chrome://tracing`` / https://ui.perfetto.dev). Perfetto ignores
  the extra top-level keys, so the schema header rides along.
"""

from __future__ import annotations

import json

from .schema import make_header

SUMMARY_KIND = "telemetry_summary"
TRACE_KIND = "telemetry_trace"


def build_summary(snapshot: dict, rank: int = -1,
                  world_size: int = 0) -> dict:
    """Schema-versioned summary document from ``Recorder.snapshot()``."""
    doc = make_header(SUMMARY_KIND)
    doc["rank"] = rank
    doc["world_size"] = world_size
    doc["recorded"] = snapshot["recorded"]
    doc["dropped"] = snapshot["dropped"]
    doc["capacity"] = snapshot["capacity"]
    doc["t_base_unix"] = snapshot.get("t_base_unix", 0.0)
    doc["counters"] = snapshot["counters"]
    # the profiling plane rides the summary: the shutdown artifact and
    # the tracker's merged fleet summaries gain the compile, cache,
    # cost, overlap and device-memory sections with no extra wiring
    from . import profile
    if profile.enabled():
        doc["profile"] = profile.snapshot()
    # the fleet event bus rides the summary the same way: the metrics
    # wire command delivers the bounded ring (with its monotonic seq, so
    # a reader dedups) to the tracker; the rank's current HLC stamp rides
    # along so the tracker's clock merges every sender's causal past.
    # Both sections appear only when rabit_events is on (byte-identical
    # payloads otherwise).
    from . import clock, events
    if events.enabled():
        doc["events"] = events.snapshot()
        stamp = clock.tick()
        if stamp is not None:
            doc["hlc"] = stamp
    return doc


def export_summary(snapshot: dict, path: str, rank: int = -1,
                   world_size: int = 0) -> dict:
    doc = build_summary(snapshot, rank=rank, world_size=world_size)
    with open(path, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True)
        f.write("\n")
    return doc


def build_chrome_trace(snapshot: dict, rank: int = -1) -> dict:
    """Trace-event document: one complete ("X") event per span, ts/dur
    in microseconds, pid = rank, tid = a dense index per recording
    thread. Spans come out of the ring in chronological order already;
    sort defensively anyway so ts is monotonic for validators."""
    pid = rank if rank >= 0 else 0
    tids: dict = {}
    events = []
    for s in sorted(snapshot["spans"], key=lambda s: s["t0"]):
        tid = tids.setdefault(s.get("tid", 0), len(tids))
        args = {"bytes": s["bytes"]}
        for k in ("op", "method", "wire", "provenance"):
            if s.get(k):
                args[k] = s[k]
        args.update(s.get("attrs", {}))
        events.append({
            "name": s["name"],
            "ph": "X",
            "ts": s["t0"] * 1e6,
            "dur": s["dur"] * 1e6,
            "pid": pid,
            "tid": tid,
            "args": args,
        })
    meta = [{"name": "process_name", "ph": "M", "pid": pid, "tid": 0,
             "args": {"name": f"rabit rank {pid}"}}]
    doc = make_header(TRACE_KIND)
    doc["displayTimeUnit"] = "ms"
    # wall-clock anchor for ts=0: lets per-rank traces be stitched on
    # absolute time (cross-rank round skew)
    doc["t_base_unix"] = snapshot.get("t_base_unix", 0.0)
    doc["traceEvents"] = meta + events
    return doc


def export_chrome_trace(snapshot: dict, path: str, rank: int = -1) -> dict:
    doc = build_chrome_trace(snapshot, rank=rank)
    with open(path, "w") as f:
        json.dump(doc, f)
        f.write("\n")
    return doc
