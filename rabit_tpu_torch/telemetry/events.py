"""The fleet event bus of one process: the port's own copy of
``rabit_tpu/telemetry/events.py``. Recovery provenance, membership
transitions and the other signals the JAX package emits are normalized
into HLC-stamped, schema-versioned ``rabit_tpu.fleet_event/v1`` records.

Per process: a bounded ring (overwrite-oldest, drop-counted like the
span recorder) plus a monotonic ``seq`` so a consumer reading repeated
snapshots can dedup. Workers ship their ring inside the telemetry
summary (``export.build_summary`` attaches ``doc["events"]`` when the
plane is on), which rides the ``metrics`` wire command and the live
``/summary`` scrape to the tracker; the tracker folds each task's
records into one fleet event log served at ``/events`` and feeds the
incident engine (``telemetry/incident.py``).

Off by default (``rabit_events``/``RABIT_EVENTS`` master knob, shared
with the HLC in ``telemetry/clock.py``): when disabled ``emit()``
returns ``None`` without recording and no payload grows a field.
``rabit_events_buffer``/``RABIT_EVENTS_BUFFER`` sizes the ring
(default 256 records).

Every ``kind`` passed to :func:`emit` must appear in the
:data:`EVENT_KINDS` registry, copied verbatim from the JAX package so
that both packages' records share one vocabulary; :func:`emit` rejects
an unknown kind at run time. Stdlib-only.
"""

from __future__ import annotations

import os
import threading
import time
from typing import List, Optional

from . import clock
from .schema import schema_id

EVENT_KIND = "fleet_event"

_ENABLE_ENV = "RABIT_EVENTS"
_BUFFER_ENV = "RABIT_EVENTS_BUFFER"
DEFAULT_BUFFER = 256

# The single registry of every fleet-event kind this repo emits,
# anywhere (verbatim from rabit_tpu/telemetry/events.py, whose lint rule
# T005 AST-checks literal emit() kinds against it); emit() rejects
# unregistered kinds at run time.
EVENT_KINDS = (
    # chaos injections (chaos/proxy.py) — one per registered rule kind
    # (chaos/schedule.py KINDS), emitted as chaos.<kind>
    "chaos.delay",
    "chaos.reset",
    "chaos.partial",
    "chaos.partition",
    "chaos.blackout",
    "chaos.tracker_kill",
    "chaos.tracker_partition",
    "chaos.bitflip",
    "chaos.job_storm",
    # watchdog escalation ladder (utils/watchdog.py)
    "watchdog.retry",
    "watchdog.reform",
    "watchdog.abort",
    # recovery provenance (engine/dataplane.py, engine/native.py,
    # engine/xla.py)
    "recovery.retry",
    "recovery.frame_reject",
    "recovery.link_resurrect",
    "recovery.link_reset",
    "recovery.epoch_advance",
    "recovery.world_reform",
    "recovery.cold_restart",
    # membership transitions (tracker/tracker.py, engines)
    "membership.admit",
    "membership.evict",
    "membership.epoch_reset",
    # control-plane lifecycle (tracker/standby.py, tracker/tracker.py)
    "tracker.promoted",
    "tracker.resume",
    "tracker.quarantine",
    # admission verdicts (tracker/tracker.py _submit)
    "admission.admitted",
    "admission.queued",
    "admission.shed",
    # SLO state changes (tracker poll loop, telemetry/slo.py states)
    "slo.ok",
    "slo.warn",
    "slo.violating",
    "slo.no_data",
)

_KIND_SET = frozenset(EVENT_KINDS)


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in (
        "1", "true", "yes", "on")


def _env_buffer() -> int:
    try:
        return max(1, int(os.environ.get(_BUFFER_ENV, DEFAULT_BUFFER)))
    except ValueError:
        return DEFAULT_BUFFER


class EventRing:
    """Bounded fleet-event ring: overwrite-oldest with a drop counter
    (the span recorder's discipline) plus a monotonic per-process seq
    so snapshot consumers dedup across repeated reads."""

    def __init__(self, capacity: int = DEFAULT_BUFFER,
                 enabled: bool = False):
        self._lock = threading.Lock()
        self.capacity = max(1, int(capacity))
        self.enabled = bool(enabled)
        self._records: List[dict] = []
        self._head = 0
        self.seq = 0
        self.dropped = 0

    def emit(self, kind: str, detail: str = "", job: str = "",
             rank: int = -1, **attrs) -> Optional[dict]:
        if not self.enabled:
            return None
        if kind not in _KIND_SET:
            raise ValueError(
                f"fleet-event kind {kind!r} not in events.EVENT_KINDS "
                "(register it, lint rule T005)")
        rec = {"schema": schema_id(EVENT_KIND),
               "kind": kind,
               "detail": str(detail),
               "t_unix": time.time()}
        stamp = clock.tick()
        if stamp is not None:
            rec["hlc"] = stamp
        if job:
            rec["job"] = str(job)
        if rank >= 0:
            rec["rank"] = int(rank)
        for k, v in attrs.items():
            if v is not None:
                rec[k] = v
        with self._lock:
            self.seq += 1
            rec["seq"] = self.seq
            if len(self._records) < self.capacity:
                self._records.append(rec)
            else:
                self._records[self._head] = rec
                self._head = (self._head + 1) % self.capacity
                self.dropped += 1
        return rec

    def snapshot(self) -> dict:
        """Ring contents in emission order plus occupancy counters."""
        with self._lock:
            ordered = (self._records[self._head:]
                       + self._records[:self._head])
            return {"records": [dict(r) for r in ordered],
                    "seq": self.seq,
                    "dropped": self.dropped,
                    "capacity": self.capacity}

    def reset(self, capacity: Optional[int] = None,
              enabled: Optional[bool] = None) -> None:
        with self._lock:
            if capacity is not None:
                self.capacity = max(1, int(capacity))
            if enabled is not None:
                self.enabled = bool(enabled)
            self._records = []
            self._head = 0
            self.seq = 0
            self.dropped = 0


# -- process-global ring ---------------------------------------------------

_RING = EventRing(capacity=_env_buffer(), enabled=_env_truthy(_ENABLE_ENV))


def enabled() -> bool:
    return _RING.enabled


def set_enabled(on: bool) -> None:
    _RING.enabled = bool(on)
    clock.set_enabled(bool(on))


def configure(cfg) -> bool:
    """Apply engine config (``rabit_events``, ``rabit_events_buffer``)
    at init; only keys actually present change anything."""
    if cfg is None:
        return _RING.enabled
    if "rabit_events" in cfg:
        set_enabled(cfg.get_bool("rabit_events"))
    cap = cfg.get_int("rabit_events_buffer", 0)
    if cap > 0:
        _RING.reset(capacity=cap)
    return _RING.enabled


def emit(kind: str, detail: str = "", job: str = "", rank: int = -1,
         **attrs) -> Optional[dict]:
    """Record one fleet event (HLC-stamped when the clock is on);
    returns the record, or ``None`` when the plane is disabled. The
    ``kind`` must be registered in :data:`EVENT_KINDS`."""
    return _RING.emit(kind, detail=detail, job=job, rank=rank, **attrs)


def emit_chaos(rule_kind: str, detail: str = "", **attrs):
    """Chaos-proxy helper: injections arrive with the schedule's rule
    kind (``reset``, ``bitflip``, ...) and map onto the registered
    ``chaos.<kind>`` namespace; an unregistered rule kind (a schedule
    grown past this registry) is dropped, never a crash in the
    injection path."""
    kind = f"chaos.{rule_kind}"
    if kind not in _KIND_SET:
        return None
    return _RING.emit(kind, detail=detail, **attrs)


def snapshot() -> dict:
    return _RING.snapshot()


def stats() -> dict:
    return {"enabled": _RING.enabled, "capacity": _RING.capacity,
            "seq": _RING.seq, "dropped": _RING.dropped}


def reset(capacity: Optional[int] = None,
          enabled: Optional[bool] = None) -> None:
    """Fresh ring state (tests); ``enabled`` also flips the HLC, and
    defaults back to the env knob (clock.reset's convention)."""
    if enabled is None:
        enabled = _env_truthy(_ENABLE_ENV)
    _RING.reset(capacity=capacity, enabled=enabled)
    clock.set_enabled(bool(enabled))
