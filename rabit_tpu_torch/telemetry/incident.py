"""Incident engine: root-cause attribution for SLO burns and aborts.
The port's copy of ``rabit_tpu/telemetry/incident.py``, over the port's
own ``clock``, ``slo``, ``schema``, ``events`` and ``prom``; its schema
id keeps the shared ``rabit_tpu.`` prefix, so the same trigger over the
same events is the same document from either package.

The fleet event bus (``telemetry/events.py``) answers *what happened*;
this module answers *why the gate fired*. Each SLO warn/violation (and
each watchdog abort) becomes a trigger correlated against the fleet
events inside a causal window (``rabit_incident_window_ms``, default
5000 ms) before it. The result is a schema-versioned
``rabit_tpu.incident/v1`` artifact carrying:

- an **attribution chain**: candidate cause events ordered causally
  (HLC when stamped, wall time otherwise), rooted at the earliest
  highest-priority cause — chaos injections outrank
  recovery/watchdog rungs, which outrank membership/control-plane and
  admission churn (an injected RST *explains* the retry rung that
  followed it, never the reverse);
- a **severity** (``warn`` for SLO warns, ``critical`` for violations
  and aborts), the affected job/ranks, and a one-line summary like
  ``chaos.reset ×2 → recovery.retry ×3 → p99_ms violating``;
- an explicit ``unattributed: true`` marker when no candidate cause
  fell inside the window — the honest answer.

:class:`IncidentBook` tracks open incidents over repeated sweeps (the
tracker's poll loop runs one per sweep and serves the open set at
``/incidents``; incidents dump alongside flight records). ``python -m
rabit_tpu_torch.telemetry.incident --smoke`` is the contract check.
Stdlib-only.
"""

from __future__ import annotations

import json
import os
import sys
import time
from typing import Dict, Iterable, List, Optional

from . import clock, slo
from .schema import make_header, matches

INCIDENT_KIND = "incident"

_WINDOW_ENV = "RABIT_INCIDENT_WINDOW_MS"
DEFAULT_WINDOW_MS = 5000.0

SEV_WARN = "warn"
SEV_CRITICAL = "critical"
_SEVERITY_RANK = {"": 0, SEV_WARN: 1, SEV_CRITICAL: 2}

# Causal priority by kind prefix: lower number = closer to the root
# cause. An injected fault explains the recovery/escalation that
# followed it; recovery rungs explain membership and admission churn;
# the control plane's own lifecycle ranks last.
_CAUSE_PRIORITY = (
    ("chaos.", 0),
    ("recovery.", 1),
    ("watchdog.", 1),
    ("membership.", 2),
    ("tracker.", 2),
    ("admission.", 3),
)
_DEFAULT_PRIORITY = 4


def window_ms(override: Optional[float] = None) -> float:
    """The causal window: explicit override beats the
    ``RABIT_INCIDENT_WINDOW_MS`` env beats the 5000 ms default."""
    if override is not None:
        return max(0.0, float(override))
    try:
        return max(0.0, float(os.environ.get(_WINDOW_ENV,
                                             DEFAULT_WINDOW_MS)))
    except ValueError:
        return DEFAULT_WINDOW_MS


def cause_priority(kind: str) -> int:
    for prefix, pri in _CAUSE_PRIORITY:
        if kind.startswith(prefix):
            return pri
    return _DEFAULT_PRIORITY


def _event_key(ev: dict) -> tuple:
    """Causal sort key: HLC when stamped, wall time as fallback (a
    mixed chain still orders sanely — HLC ms tracks wall ms)."""
    hlc = ev.get("hlc")
    if clock.is_stamp(hlc):
        return clock.key(hlc)
    return (int(float(ev.get("t_unix", 0.0)) * 1e3), 0, "")


def _chain_entry(ev: dict) -> dict:
    out = {"kind": ev.get("kind", "?"),
           "detail": ev.get("detail", ""),
           "t_unix": float(ev.get("t_unix", 0.0))}
    for k in ("hlc", "rank", "job", "seq", "source"):
        if ev.get(k) is not None:
            out[k] = ev[k]
    return out


def _compress(kinds: List[str]) -> str:
    """``a → a → b`` renders as ``a ×2 → b``."""
    parts: List[str] = []
    for k in kinds:
        if parts and parts[-1][0] == k:
            parts[-1][1] += 1
        else:
            parts.append([k, 1])
    return " → ".join(k if n == 1 else f"{k} ×{n}" for k, n in parts)


def slo_trigger(verdict: dict, t_unix: Optional[float] = None,
                job: str = "") -> dict:
    """Trigger doc from one ``slo.evaluate`` verdict row."""
    return {"type": "slo",
            "slo": verdict.get("slo", "?"),
            "state": verdict.get("state", slo.NO_DATA),
            "value": verdict.get("value"),
            "burn": verdict.get("burn"),
            "job": job,
            "t_unix": time.time() if t_unix is None else float(t_unix)}


def abort_trigger(event: dict) -> dict:
    """Trigger doc from a ``watchdog.abort`` fleet event."""
    return {"type": "watchdog_abort",
            "detail": event.get("detail", ""),
            "rank": event.get("rank"),
            "job": event.get("job", ""),
            "seq": event.get("seq"),
            "t_unix": float(event.get("t_unix", 0.0))}


def correlate(trigger: dict, events: Iterable[dict],
              window: Optional[float] = None,
              incident_id: str = "") -> dict:
    """Build one ``incident/v1`` document for a trigger.

    Candidate causes are the fleet events inside ``[t_trigger -
    window_ms, t_trigger]`` (slo.* state-change events never attribute
    an SLO burn — a symptom cannot cause itself). The chain is every
    candidate in causal order; the root is the earliest
    highest-priority candidate. No candidates → ``unattributed``."""
    win = window_ms(window)
    t_trig = float(trigger.get("t_unix", time.time()))
    lo = t_trig - win / 1e3
    cands = []
    for ev in events:
        kind = str(ev.get("kind", ""))
        if kind.startswith("slo."):
            continue
        if trigger.get("type") == "watchdog_abort" \
                and kind == "watchdog.abort" \
                and ev.get("seq") == trigger.get("seq"):
            continue  # the trigger itself is not its own cause
        t = float(ev.get("t_unix", 0.0))
        if lo <= t <= t_trig:
            cands.append(ev)
    cands.sort(key=_event_key)

    doc = make_header(INCIDENT_KIND)
    doc["id"] = incident_id or f"inc-{trigger.get('type', '?')}"
    doc["trigger"] = dict(trigger)
    doc["window_ms"] = win
    critical = (trigger.get("type") == "watchdog_abort"
                or trigger.get("state") == slo.VIOLATING)
    doc["severity"] = SEV_CRITICAL if critical else SEV_WARN
    doc["unattributed"] = not cands
    doc["attribution"] = [_chain_entry(ev) for ev in cands]
    if cands:
        root = min(cands,
                   key=lambda ev: (cause_priority(str(ev.get("kind", ""))),
                                   _event_key(ev)))
        doc["root_cause"] = _chain_entry(root)
    jobs = {str(ev["job"]) for ev in cands if ev.get("job")}
    if trigger.get("job"):
        jobs.add(str(trigger["job"]))
    doc["jobs"] = sorted(jobs)
    doc["ranks"] = sorted({int(ev["rank"]) for ev in cands
                           if ev.get("rank") is not None})
    doc["summary"] = summarize(doc)
    return doc


def summarize(incident: dict) -> str:
    """One-line attribution: root-first chain, then the trigger."""
    trig = incident.get("trigger", {})
    if trig.get("type") == "watchdog_abort":
        tail = "watchdog abort"
        if trig.get("rank") is not None:
            tail += f" on rank {trig['rank']}"
    else:
        tail = f"{trig.get('slo', '?')} {trig.get('state', '?')}"
        if trig.get("burn") is not None:
            tail += f" (burn {trig['burn']:g})"
    if incident.get("unattributed"):
        return f"unattributed: {tail}"
    kinds = [str(e.get("kind", "?"))
             for e in incident.get("attribution", [])]
    return f"{_compress(kinds)} → {tail}"


def worst_severity(incidents: Iterable[dict]) -> str:
    worst = ""
    for inc in incidents:
        sev = str(inc.get("severity", ""))
        if _SEVERITY_RANK.get(sev, 0) > _SEVERITY_RANK.get(worst, 0):
            worst = sev
    return worst or "none"


def gauges(open_incidents: List[dict], events_dropped: int = 0) -> list:
    """GaugeSpec rows for the live ``/metrics`` exposition: the open
    incident count by severity plus the fleet-wide dropped-event
    counter (both registered in ``prom.METRIC_FAMILIES``)."""
    by_sev: Dict[str, int] = {SEV_WARN: 0, SEV_CRITICAL: 0}
    for inc in open_incidents:
        sev = str(inc.get("severity", SEV_WARN))
        by_sev[sev] = by_sev.get(sev, 0) + 1
    return [
        ("rabit_open_incidents",
         "Open incidents by severity (incident engine).", "gauge",
         [({"severity": sev}, by_sev[sev]) for sev in sorted(by_sev)]),
        ("rabit_events_dropped_total",
         "Fleet events overwritten in bounded rings and logs.",
         "counter", [({}, int(events_dropped))]),
    ]


def dump(incident: dict, out_dir: str) -> Optional[str]:
    """Write one incident artifact alongside the flight records
    (``incident_<id>_<utc>.json``); best-effort like flight dumps."""
    try:
        os.makedirs(out_dir, exist_ok=True)
        tag = str(incident.get("id", "inc")).replace("/", "_")
        path = os.path.join(
            out_dir,
            f"incident_{tag}_{incident.get('timestamp_utc', '')}.json")
        with open(path, "w") as f:
            json.dump(incident, f, indent=2, sort_keys=True)
            f.write("\n")
        return path
    except OSError:
        return None


class IncidentBook:
    """Open-incident bookkeeping across evaluation sweeps.

    One incident per (trigger type, objective, job) key: a warn or
    violating verdict opens (or escalates) it, the objective going
    back to ``ok`` closes it. Watchdog aborts are terminal — each
    abort event opens one incident that never closes. Not thread-safe;
    callers serialize sweeps (the tracker runs one per poll)."""

    def __init__(self, window: Optional[float] = None):
        self.window = window
        self.open: Dict[tuple, dict] = {}
        self.closed_total = 0
        self._next_id = 1
        self._aborts_seen: set = set()

    def _new_id(self) -> str:
        iid = f"inc{self._next_id}"
        self._next_id += 1
        return iid

    def observe_slo(self, verdict: dict, events: Iterable[dict],
                    job: str = "",
                    t_unix: Optional[float] = None) -> Optional[dict]:
        """Fold one verdict row; returns a NEWLY OPENED incident (the
        caller's cue to dump it) or None."""
        key = ("slo", str(verdict.get("slo", "?")), str(job))
        state = verdict.get("state")
        if state in (slo.WARN, slo.VIOLATING):
            trig = slo_trigger(verdict, t_unix=t_unix, job=job)
            if key not in self.open:
                inc = correlate(trig, events, window=self.window,
                                incident_id=self._new_id())
                self.open[key] = inc
                return inc
            inc = self.open[key]
            # escalation re-correlates (warn -> violating picks up the
            # causes that arrived since the incident opened)
            if state == slo.VIOLATING \
                    and inc.get("severity") != SEV_CRITICAL:
                self.open[key] = correlate(
                    trig, events, window=self.window,
                    incident_id=inc.get("id", self._new_id()))
            return None
        if key in self.open and state == slo.OK:
            self.open.pop(key)
            self.closed_total += 1
        return None

    def observe_events(self, events: Iterable[dict]) -> List[dict]:
        """Open one terminal incident per unseen ``watchdog.abort``
        fleet event; returns the newly opened incidents."""
        opened = []
        evs = list(events)
        for ev in evs:
            if str(ev.get("kind", "")) != "watchdog.abort":
                continue
            key = (str(ev.get("source", "")), ev.get("seq"))
            if key in self._aborts_seen:
                continue
            self._aborts_seen.add(key)
            inc = correlate(abort_trigger(ev), evs, window=self.window,
                            incident_id=self._new_id())
            self.open[("abort",) + key] = inc
            opened.append(inc)
        return opened

    def open_docs(self) -> List[dict]:
        return [dict(inc) for inc in self.open.values()]

    def worst(self) -> str:
        return worst_severity(self.open.values())


# ---------------------------------------------------------------- smoke

def _smoke() -> int:  # noqa: C901 - linear assertion script
    from . import events as ev_mod
    from . import prom

    ev_mod.reset(capacity=64, enabled=True)
    clock.reset("smoke", enabled=True)

    # 1) HLC basics: strict monotonicity under a stalled wall clock,
    #    and merge ordering after both inputs
    stalled = iter([100, 100, 100, 100])
    h = clock.HLC("a", wall_ms=lambda: next(stalled))
    s1, s2, s3 = h.tick(), h.tick(), h.tick()
    assert clock.key(s1) < clock.key(s2) < clock.key(s3), (s1, s2, s3)
    behind = clock.HLC("b", wall_ms=lambda: 50)  # wall 50ms behind
    s4 = behind.merge(s3)
    assert clock.key(s4) > clock.key(s3), (s3, s4)

    # 2) a seeded causal story: injection -> frame rejects -> retry
    ev_mod.emit("chaos.reset", "link conn#2", rank=2)
    ev_mod.emit("recovery.frame_reject", "crc mismatch", rank=2)
    ev_mod.emit("recovery.frame_reject", "crc mismatch", rank=2)
    ev_mod.emit("recovery.retry", "round 7 attempt 1", rank=2)
    records = ev_mod.snapshot()["records"]
    assert len(records) == 4 and all("hlc" in r for r in records)

    verdict = {"slo": "p99_ms", "state": slo.VIOLATING, "value": 3100.0,
               "objective": 2000.0, "burn": 1.55}
    inc = correlate(slo_trigger(verdict), records, window=5000.0,
                    incident_id="inc-smoke")
    assert matches(inc, INCIDENT_KIND), inc.get("schema")
    assert not inc["unattributed"] and inc["severity"] == SEV_CRITICAL
    assert inc["root_cause"]["kind"] == "chaos.reset", inc["root_cause"]
    kinds = [e["kind"] for e in inc["attribution"]]
    assert kinds == ["chaos.reset", "recovery.frame_reject",
                     "recovery.frame_reject", "recovery.retry"], kinds
    assert inc["ranks"] == [2] and "chaos.reset" in inc["summary"]

    # 3) window edge: the same trigger with a zero-width window sees
    #    no candidate causes and says so explicitly
    old = correlate(slo_trigger(verdict, t_unix=time.time() + 3600),
                    records, window=1.0)
    assert old["unattributed"] and old["summary"].startswith(
        "unattributed"), old["summary"]

    # 4) book lifecycle: warn opens, ok closes, abort is terminal
    book = IncidentBook(window=5000.0)
    warn_v = {"slo": "availability", "state": slo.WARN, "value": 0.91,
              "objective": 0.9, "burn": 0.9}
    opened = book.observe_slo(warn_v, records, job="jobA")
    assert opened is not None and book.worst() == SEV_WARN
    assert book.observe_slo(warn_v, records, job="jobA") is None
    book.observe_slo({**warn_v, "state": slo.OK}, records, job="jobA")
    assert not book.open and book.closed_total == 1
    abort_ev = ev_mod.emit("watchdog.abort", "phase allreduce", rank=1)
    aborts = book.observe_events(ev_mod.snapshot()["records"])
    assert len(aborts) == 1 and aborts[0]["severity"] == SEV_CRITICAL
    assert aborts[0]["root_cause"]["kind"] == "chaos.reset"
    assert not book.observe_events(ev_mod.snapshot()["records"])
    assert abort_ev["seq"] not in (None, 0)

    # 5) ring overflow drops are counted (bounded-bus contract)
    ev_mod.reset(capacity=4, enabled=True)
    for i in range(10):
        ev_mod.emit("recovery.retry", f"r{i}")
    snap = ev_mod.snapshot()
    assert snap["dropped"] == 6 and len(snap["records"]) == 4, snap
    assert [r["detail"] for r in snap["records"]] == \
        [f"r{i}" for i in range(6, 10)]

    # 6) the /metrics families render and are registered (lint T003)
    for fam in ("rabit_open_incidents", "rabit_events_dropped_total"):
        assert fam in prom.METRIC_FAMILIES, fam
    text = prom.render_prometheus(
        [], gauges=gauges(book.open_docs(), snap["dropped"]))
    assert 'rabit_open_incidents{severity="critical"} 1' in text, text
    assert "rabit_events_dropped_total 6" in text, text

    ev_mod.reset()
    clock.reset()
    print("incident smoke ok", file=sys.stderr)
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="incident engine: root-cause attribution for SLO "
                    "burns and aborts")
    ap.add_argument("--smoke", action="store_true",
                    help="run the contract check")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke()
    ap.print_help()
    return 0


if __name__ == "__main__":
    sys.exit(main())
