"""Collective telemetry of the port: per-op spans, counters, the
profiling plane and exporters — the port's own copy of the JAX package's
recorder plane (``rabit_tpu/telemetry/``), with its schema ids, counter
keys and span names, so one consumer reads both packages' artifacts.

The module-level API fronts one process-wide :class:`Recorder`:

    from rabit_tpu_torch import telemetry
    with telemetry.span("allreduce", nbytes=nb, method="ring"):
        ...                      # timed only when rabit_telemetry=1

Off by default (``rabit_telemetry=0``). When disabled, ``span()``
returns a shared no-op context (``live == False``) and
``trace_annotation()`` returns ``contextlib.nullcontext()``; when on,
``trace_annotation`` labels the host's region in ``torch.profiler``
(the counterpart of ``jax.named_scope``) and adds no operation. The
package imports no torch at module level (the tracker imports the
aggregation side without it).

Engines turn it on with ``rabit_telemetry=1`` (spans and counters),
``rabit_profile=1`` (``telemetry/profile.py``) and ``rabit_events=1``
(``telemetry/events.py`` and the HLC); at shutdown each rank writes
``telemetry_summary_rank<r>.json`` and ``telemetry_trace_rank<r>.json``
into ``RABIT_TELEMETRY_EXPORT`` and ships its summary to the tracker,
which prints the merged fleet table at the end of the run.

The live plane serves the recorder while the run is alive:
``rabit_metrics_port`` starts a rank's HTTP endpoint (``live.py``:
``/metrics`` in the Prometheus text of ``prom.py`` with the SLO gauges
of ``slo.py``, ``/healthz``, ``/summary``), which the tracker's poll
loop scrapes into its straggler snapshot (``crossrank.py``) and fleet
skew election; the skew plane (``skew.py``) feeds that election back
into the collectives' schedules under ``rabit_skew_adapt``.
"""

from __future__ import annotations

import contextlib
import json
import os
from typing import Optional

from .recorder import (Recorder, NULL_SPAN,  # noqa: F401  (re-export)
                       DEFAULT_CAPACITY, size_bucket)
from .export import (build_summary, export_summary,  # noqa: F401
                     build_chrome_trace, export_chrome_trace,
                     SUMMARY_KIND, TRACE_KIND)
from .aggregate import (merge_summaries,  # noqa: F401  (re-export)
                        format_fleet_table, FLEET_KIND)
from .schema import (schema_id, make_header,  # noqa: F401  (re-export)
                     matches, timestamp_utc)
from . import clock
from ..utils.config import parse_size

_EXPORT_ENV = "RABIT_TELEMETRY_EXPORT"

_REC = Recorder()  # enabled state seeded from RABIT_TELEMETRY at import
_OFF = contextlib.nullcontext()  # trace_annotation while disabled: shared


def enabled() -> bool:
    return _REC.enabled


def set_enabled(on: bool) -> None:
    _REC.enabled = bool(on)


def reset(capacity: Optional[int] = None,
          enabled: Optional[bool] = None) -> None:
    _REC.reset(capacity=capacity, enabled=enabled)


def _stamp_round(attrs: dict) -> dict:
    """Central HLC stamping: any round-carrying span gains an ``hlc``
    attr when the event plane is on (``rabit_events``), so cross-rank
    stitching can order arrivals causally instead of trusting wall
    anchors — no per-engine call-site changes, and with the knob unset
    the attrs dict is returned untouched (byte-identical spans)."""
    if "round" in attrs and "hlc" not in attrs:
        stamp = clock.tick()
        if stamp is not None:
            attrs["hlc"] = stamp
    return attrs


def span(name: str, nbytes: int = 0, op=None, method=None, wire=None,
         **attrs):
    """Timed context for one operation — the tentpole entry point."""
    return _REC.span(name, nbytes=nbytes, op=op, method=method, wire=wire,
                     **_stamp_round(attrs))


def record_span(name: str, dur_s: float, nbytes: int = 0, **kw) -> None:
    _REC.record_span(name, dur_s, nbytes=nbytes, **_stamp_round(kw))


def count(name: str, nbytes: int = 0, op=None, method=None, wire=None,
          provenance: str = "") -> None:
    """Counter-only event (no span) — e.g. a watchdog expiry or one
    recovery step. Keyed like spans so the fleet merge aggregates it."""
    _REC.count(name, nbytes=nbytes, op=op, method=method, wire=wire,
               provenance=provenance)


def collective_round(name: str) -> int:
    """Per-name collective round id (1-based; 0 when disabled) —
    stamped into spans so cross-rank stitching can match the same
    collective across ranks."""
    return _REC.next_round(name)


def record_dispatch(n: int, itemsize: int, op: str, method: str,
                    wire: Optional[str], provenance: str) -> None:
    """One ``dispatch.resolve()`` outcome: which schedule/wire an
    auto-resolution picked and whether the choice came from the
    measured table, the fallback constants, or an explicit request."""
    _REC.count("dispatch", nbytes=n * itemsize, op=op, method=method,
               wire=wire, provenance=provenance)


def snapshot() -> dict:
    return _REC.snapshot()


def counter_rows(name: str) -> list:
    """Aggregated counter rows for one name (recorder keying)."""
    return _REC.counter_rows(name)


def stats() -> dict:
    """Recorder occupancy counters (tests and doctors)."""
    return {"enabled": _REC.enabled, "capacity": _REC.capacity,
            "recorded": _REC.recorded, "dropped": _REC.dropped}


def configure(cfg) -> bool:
    """Apply engine config (``rabit_telemetry``,
    ``rabit_telemetry_buffer``) at init; returns the enabled state.
    Only keys actually present change anything, so an engine without
    telemetry params leaves a test-enabled recorder alone."""
    if cfg is None:
        return _REC.enabled
    if "rabit_telemetry" in cfg:
        _REC.enabled = cfg.get_bool("rabit_telemetry")
    cap = cfg.get("rabit_telemetry_buffer")
    if cap:
        _REC.reset(capacity=max(1, parse_size(cap)), enabled=_REC.enabled)
    # the fleet event bus + HLC share the rabit_events master knob;
    # events.configure flips the clock alongside the ring
    from . import events
    events.configure(cfg)
    return _REC.enabled


def trace_annotation(name: str):
    """A ``torch.profiler`` range named ``name`` when telemetry is on
    (collectives become attributable in profiles; under ``emit_nvtx``
    also in nsys), a plain ``nullcontext`` when off. Either way no
    operation is added: the range is ``record_function``'s, entered
    through the profiler's C++ hook (``_RecordFunctionFast``) where torch
    has it, since ``record_function`` itself dispatches two profiler
    operators that a ``TorchDispatchMode`` would see. The disabled path
    never imports torch."""
    if not _REC.enabled:
        return _OFF
    import torch
    fast = getattr(torch._C._profiler, "_RecordFunctionFast", None)
    if fast is not None:
        return fast(name)
    return torch.profiler.record_function(name)


def export_at_shutdown(rank: int = -1, world_size: int = 0) -> list:
    """Write summary + Chrome-trace files into the directory named by
    ``RABIT_TELEMETRY_EXPORT`` (``rabit_telemetry_export``); returns the
    paths written ([] when disabled or unconfigured)."""
    out_dir = os.environ.get(_EXPORT_ENV)
    if not _REC.enabled or not out_dir:
        return []
    os.makedirs(out_dir, exist_ok=True)
    tag = f"rank{rank}" if rank >= 0 else "local"
    snap = _REC.snapshot()
    spath = os.path.join(out_dir, f"telemetry_summary_{tag}.json")
    tpath = os.path.join(out_dir, f"telemetry_trace_{tag}.json")
    export_summary(snap, spath, rank=rank, world_size=world_size)
    export_chrome_trace(snap, tpath, rank=rank)
    return [spath, tpath]


def ship_to_tracker(rank: int = -1, world_size: int = 0,
                    timeout: float = 10.0) -> bool:
    """Send this rank's summary to the tracker (``metrics`` wire
    command) for fleet-wide aggregation. Uses the same env rendezvous
    the engine used (``RABIT_TRACKER_URI``/``PORT``, ``RABIT_TASK_ID``,
    with DMLC aliases). Must run BEFORE the engine's shutdown command —
    the tracker exits once every rank has sent shutdown. Best-effort:
    returns False instead of raising (a run without a tracker, or one
    that already went away, must not fail at exit over telemetry)."""
    if not _REC.enabled:
        return False
    host = (os.environ.get("RABIT_TRACKER_URI")
            or os.environ.get("DMLC_TRACKER_URI") or "")
    port = (os.environ.get("RABIT_TRACKER_PORT")
            or os.environ.get("DMLC_TRACKER_PORT") or "")
    if not host or host == "NULL" or not port:
        return False
    task_id = (os.environ.get("RABIT_TASK_ID")
               or os.environ.get("DMLC_TASK_ID") or "0")
    doc = build_summary(_REC.snapshot(), rank=rank, world_size=world_size)
    payload = json.dumps(doc)

    from ..tracker.tracker import MAGIC, _recv_u32, _send_str, _send_u32
    from ..utils import retry
    try:
        # backoff-retried connect: a tracker mid-restart (or behind a
        # chaos blackout window) still gets this rank's metrics
        with retry.connect_with_retry(
                host, int(port), timeout=timeout,
                deadline=retry.Deadline(timeout)) as conn:
            _send_u32(conn, MAGIC)
            _send_str(conn, "metrics")
            _send_str(conn, task_id)
            _send_u32(conn, 0)  # num_attempt (informational)
            _send_str(conn, payload)
            return _recv_u32(conn) == 1
    except (OSError, ValueError, ConnectionError, retry.RetryError):
        return False
