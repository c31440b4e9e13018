"""Render saved telemetry artifacts as PERF.md tables: the port's copy of
``tools/trace_report.py``, over the port's own ``telemetry`` (recorder,
``crossrank``, ``schema``, ``flight``), so it runs where JAX is absent
(the card's machine) and prints the same text as the JAX package's tool
on the same file. Point it at any schema-versioned artifact either
package writes (the ids keep the shared ``rabit_tpu.`` prefix) --

- ``rabit_tpu.telemetry_summary/v1`` (per-rank counters,
  ``telemetry.export_summary`` / ``RABIT_TELEMETRY_EXPORT``)
- ``rabit_tpu.telemetry_fleet/v1``   (tracker-merged fleet stats)
- ``rabit_tpu.telemetry_trace/v1``   (Chrome trace-event file -- also
  loadable directly in https://ui.perfetto.dev / chrome://tracing)
- ``rabit_tpu.collective_sweep/v1``/``v2``  (dispatch-table artifacts;
  v2 adds the lag-injection skew columns)
- ``rabit_tpu.flight_record/v1``     (crash flight-recorder bundles --
  last spans, noted wire/chaos events, per-thread stacks)
- ``rabit_tpu.bench_sentinel/v1``    (regression-sentinel verdicts --
  per-metric trend table, ``tools/bench_sentinel.py``)
- ``rabit_tpu.soak/v1`` and ``rabit_tpu.tracker_bench/v1`` (the JAX
  package's soak and tracker benchmarks)
- ``rabit_tpu.fleet_event/v1``       (one event, or the tracker's
  ``/events`` log)
- ``rabit_tpu.incident/v1``          (one incident's attribution chain)

-- and it prints a GitHub-markdown table ready to paste into PERF.md.
``--dir PATH`` renders every recognized artifact in a directory in one
invocation (unrecognized files are listed and skipped).

Given MULTIPLE artifacts whose spans carry collective round ids
(traces, flight bundles, raw snapshots -- one per rank), the report
appends a cross-rank section: per-round arrival skew and critical
path, plus a per-rank attribution table naming who straggled
(``telemetry/crossrank.py``).

``--smoke`` records deterministic spans, exports both artifacts,
reloads them through this renderer, and asserts the summary's
per-method byte/duration totals agree with the trace events (then a
flight bundle and three cross-rank stitches). Prints ``telemetry smoke
ok`` on success.

Usage:
  python -m rabit_tpu_torch.tools.trace_report ARTIFACT.json
  python -m rabit_tpu_torch.tools.trace_report --dir build/artifacts
  python -m rabit_tpu_torch.tools.trace_report --smoke
"""

import argparse
import json
import os
import sys
import tempfile

from ..telemetry import crossrank
from ..telemetry.schema import matches


def _md_table(headers, rows):
    lines = ["| " + " | ".join(headers) + " |",
             "|" + "|".join("---" for _ in headers) + "|"]
    for r in rows:
        lines.append("| " + " | ".join(str(c) for c in r) + " |")
    return "\n".join(lines)


def _fmt_s(s):
    return f"{s * 1e3:.3f} ms" if s >= 1e-3 else f"{s * 1e6:.1f} µs"


def _fmt_bytes(n):
    if n >= 1 << 20:
        return f"{n / (1 << 20):.1f} MiB"
    if n >= 1 << 10:
        return f"{n / (1 << 10):.1f} KiB"
    return f"{n} B"


def render_counters(doc):
    """telemetry_summary / telemetry_fleet counter rows."""
    rows = []
    for c in doc.get("counters", []):
        mean = c["total_s"] / c["count"] if c["count"] else 0.0
        rows.append((c["name"], c["op"] or "-", c["method"] or "-",
                     c["wire"] or "-", c["bucket"],
                     c.get("provenance", "") or "-", c["count"],
                     _fmt_bytes(c["bytes"]), _fmt_s(c["total_s"]),
                     _fmt_s(mean), _fmt_s(c["max_s"])))
    head = ("name", "op", "method", "wire", "size bucket", "provenance",
            "count", "bytes", "total", "mean", "max")
    who = (f"fleet of {doc['num_ranks']} rank(s)"
           if matches(doc, "telemetry_fleet")
           else f"rank {doc.get('rank', '?')}")
    title = (f"Telemetry summary — {who}, {doc.get('recorded', 0)} "
             f"span(s) recorded, {doc.get('dropped', 0)} dropped "
             f"({doc.get('timestamp_utc', '')})")
    out = title + "\n\n" + _md_table(head, rows)
    # recovery sub-table: watchdog expiries, link resets, epoch
    # advances, world re-formations, cold restarts — the at-a-glance
    # answer to "did this run survive anything, and what did it cost".
    # The rung column places each event on the self-healing escalation
    # ladder (doc/fault_tolerance.md): frame -> retry -> reconnect ->
    # reform -> abort, cheapest first.
    rec = [c for c in doc.get("counters", [])
           if (c.get("provenance") or "") == "recovery"]
    if rec:
        rrows = [(c["name"], _recovery_rung(c["name"]), c["op"] or "-",
                  c["count"], _fmt_bytes(c["bytes"]), _fmt_s(c["total_s"]),
                  _fmt_s(c["max_s"])) for c in rec]
        out += ("\n\nRecovery events ({} kind(s))\n\n".format(len(rec))
                + _md_table(("event", "rung", "op", "count", "bytes",
                             "total", "max"), rrows))
    return out


# escalation-ladder rung per recovery event name: where on the
# self-healing ladder the event sits (frame = hop-local CRC
# retransmission, retry = round re-run in place, reconnect = link-level
# repair, reform = global world re-formation, abort = last resort)
_RECOVERY_RUNGS = {
    "recovery.frame_reject": "frame",
    "recovery.retry": "retry",
    "recovery.link_reset": "reconnect",
    "recovery.link_resurrect": "reconnect",
    "recovery.epoch_advance": "reform",
    "recovery.world_reform": "reform",
    "watchdog.reform": "reform",
    "watchdog.expired": "report",
    "watchdog.stall": "report",
    "watchdog.abort": "abort",
    "recovery.cold_restart": "abort",
}


def _recovery_rung(name):
    return _RECOVERY_RUNGS.get(name, "-")


def render_trace(doc):
    """Chrome trace: aggregate complete ("X") events per name."""
    agg = {}
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        a = agg.setdefault(ev["name"], {"count": 0, "dur_us": 0.0,
                                        "bytes": 0})
        a["count"] += 1
        a["dur_us"] += ev.get("dur", 0.0)
        a["bytes"] += ev.get("args", {}).get("bytes", 0)
    rows = [(name, a["count"], _fmt_bytes(a["bytes"]),
             _fmt_s(a["dur_us"] / 1e6),
             _fmt_s(a["dur_us"] / 1e6 / a["count"]))
            for name, a in sorted(agg.items())]
    title = (f"Chrome trace — {sum(a['count'] for a in agg.values())} "
             f"event(s) ({doc.get('timestamp_utc', '')}); load the file "
             "in https://ui.perfetto.dev for the timeline view")
    return title + "\n\n" + _md_table(
        ("span", "count", "bytes", "total", "mean"), rows)


def render_sweep(doc):
    """collective_sweep dispatch-table artifact."""
    rows = []
    for cls in ("float_sum", "other"):
        for r in doc.get("table", {}).get(cls, []):
            rows.append((cls, "open" if r["max_n"] is None else r["max_n"],
                         r["method"], r.get("wire") or "-"))
    title = (f"Dispatch table ({doc.get('timestamp_utc', '')}"
             f"{', SMOKE — do not commit' if doc.get('smoke') else ''})")
    return title + "\n\n" + _md_table(
        ("class", "max n", "method", "wire"), rows)


def render_flight(doc, last_n=16):
    """flight_record bundle: why the process died, what it was doing
    (last spans, round ids included), what was injected/escalated just
    before (noted events), and where every thread was blocked."""
    detail = f" — {doc['detail']}" if doc.get("detail") else ""
    parts = [f"Flight record — rank {doc.get('rank', '?')}, reason "
             f"`{doc.get('reason', '?')}`{detail}, pid "
             f"{doc.get('pid', '?')} ({doc.get('timestamp_utc', '')})"]
    telem = doc.get("telemetry") or {}
    spans = telem.get("spans", [])[-last_n:]
    if spans:
        rows = [(s["name"], (s.get("attrs") or {}).get("round", "-"),
                 f"{s.get('t0', 0.0):.3f}", _fmt_s(s.get("dur", 0.0)),
                 _fmt_bytes(s.get("bytes", 0)), s.get("op") or "-",
                 s.get("method") or "-") for s in spans]
        parts.append(f"Last {len(spans)} span(s) of "
                     f"{telem.get('recorded', 0)} recorded\n\n" +
                     _md_table(("span", "round", "t0 (s)", "dur", "bytes",
                                "op", "method"), rows))
    rec = [c for c in telem.get("counters", [])
           if (c.get("provenance") or "") in ("recovery", "chaos")]
    if rec:
        rows = [(c["name"], c.get("provenance"), c["op"] or "-",
                 c["count"]) for c in rec]
        parts.append("Recovery/chaos counters\n\n" +
                     _md_table(("event", "provenance", "op", "count"),
                               rows))
    events = doc.get("events", [])[-last_n:]
    if events:
        rows = [(f"{e.get('t_unix', 0.0):.3f}", e.get("kind", "?"),
                 e.get("detail", "") or "-") for e in events]
        parts.append(f"Last {len(events)} noted event(s)\n\n" +
                     _md_table(("t_unix", "kind", "detail"), rows))
    stacks = doc.get("stacks") or ""
    if stacks:
        nthreads = stacks.count("Thread ") + stacks.count(
            "Current thread ")
        parts.append(f"Per-thread stacks ({max(1, nthreads)} thread(s))"
                     "\n\n```\n" + stacks.strip() + "\n```")
    return "\n\n".join(parts)


def render_skew(docs):
    """Cross-rank section from >=2 round-carrying artifacts: per-round
    arrival skew/critical path plus per-rank straggler attribution.
    Returns None when fewer than two ranks contributed rounds."""
    docs = list(docs)
    rounds = crossrank.stitch_documents(docs)
    comparable = [r for r in rounds if r["skew_s"] is not None]
    if not comparable:
        return None
    warn = crossrank.anchor_warning(docs, rounds)
    # hierarchical allreduces stitch as one row PER PHASE (the three
    # hier.* spans share a round id): the phase column turns "round 7
    # straggled" into "round 7 straggled in the inter-host phase".
    # The adaptation column shows which skew plan (rotate / tree_reroot
    # / preagg / hier_demote @ laggard) a round ran under — "-" rounds
    # ran the flat schedule, so adapted vs unadapted skew is comparable
    # in the same table
    rows = [(r["name"], r["round"], r.get("phase") or "-",
             r.get("adapted") or "-",
             len(r["arrivals"]), r["straggler_rank"], _fmt_s(r["skew_s"]),
             _fmt_s(r["critical_path_s"])) for r in comparable]
    out = (f"Cross-rank rounds ({len(comparable)} comparable of "
           f"{len(rounds)} stitched)\n\n" +
           _md_table(("collective", "round", "phase", "adaptation",
                      "ranks", "straggler", "arrival skew",
                      "critical path"), rows))
    attr = crossrank.skew_table(comparable)
    arow = [(a["rank"], a["rounds"], a["straggler_rounds"],
             _fmt_s(a["skew_caused_s"]), _fmt_s(a["worst_skew_s"]))
            for a in attr]
    worst = max(attr, key=lambda a: a["skew_caused_s"])
    out += ("\n\nPer-rank straggler attribution\n\n" +
            _md_table(("rank", "rounds seen", "times straggler",
                       "skew caused", "worst skew"), arow))
    out += (f"\n\nStraggler: rank {worst['rank']} caused "
            f"{_fmt_s(worst['skew_caused_s'])} of arrival skew across "
            f"{worst['straggler_rounds']} round(s)")
    if warn is not None:
        out += "\n\n**WARNING**: " + warn["message"]
    return out


def render_sentinel(doc):
    """bench_sentinel verdict: the PERF.md trend table — newest value
    per (metric, config) against its rolling MAD baseline."""
    rows = []
    for v in doc.get("verdicts", []):
        if v.get("regressed") is None:
            verdict = f"no gate ({v.get('n_baseline', 0)} baseline)"
        elif v["regressed"]:
            verdict = "**REGRESSED**"
        else:
            verdict = "ok"
        med = v.get("baseline_median")
        thr = v.get("threshold")
        trend = " → ".join(f"{x:g}" for x in v.get("recent", []))
        rows.append((v.get("metric", "?"), v.get("fingerprint", ""),
                     f"{v.get('value', 0):g} {v.get('unit', '')}".strip(),
                     "-" if med is None else f"{med:g}",
                     "-" if thr is None else f"{thr:g}",
                     v.get("direction", ""), trend or "-", verdict))
    title = (f"Regression sentinel — {doc.get('checked', 0)} series "
             f"checked, {doc.get('regressions', 0)} regression(s) "
             f"(window {doc.get('window', '?')}, "
             f"{doc.get('mad_k', '?')}×MAD gate, "
             f"{doc.get('timestamp_utc', '')})")
    return title + "\n\n" + _md_table(
        ("metric", "config", "latest", "baseline median", "threshold",
         "better", "trend", "verdict"), rows)


def render_soak(doc):
    """soak/v1 verdict: the PERF.md SLO table — each fleet objective
    with its measured value, burn ratio, and gate state, plus the
    run's chaos and admission story in one line each."""
    rows = []
    for v in doc.get("slos", []):
        val = v.get("value")
        burn = v.get("burn")
        state = v.get("state", "?")
        rows.append((
            v.get("slo", "?"),
            "-" if val is None else f"{val:g} {v.get('unit', '')}".strip(),
            f"{v.get('objective', 0):g} {v.get('unit', '')}".strip(),
            v.get("direction", ""),
            "-" if burn is None else f"{burn:g}",
            "**VIOLATING**" if state == "violating" else state))
    gate = doc.get("gate", {})
    rounds = doc.get("rounds", {})
    jobs = doc.get("jobs", {})
    adm = doc.get("admission", {}).get("verdicts", {})
    chaos = doc.get("chaos", {})
    fo = doc.get("failover", {})
    ev = {**chaos.get("tracker_events", {}), **chaos.get("link_events", {})}
    title = (f"Fleet soak — {doc.get('duration_s', '?')}s at "
             f"{doc.get('qps_key', '?')} submits/s, "
             f"{'PASS' if gate.get('pass') else 'FAIL'} "
             f"({doc.get('timestamp_utc', '')})")
    out = title + "\n\n" + _md_table(
        ("SLO", "measured", "objective", "better", "burn", "state"), rows)
    out += (f"\n\nRounds: {rounds.get('on_time', 0)}/"
            f"{rounds.get('total', 0)} on schedule "
            f"(deadline {rounds.get('deadline_ms', '?')} ms, "
            f"{rounds.get('retried', 0)} retried, "
            f"{rounds.get('failed', 0)} failed); jobs "
            f"{jobs.get('completed', 0)}/{jobs.get('submitted', 0)} "
            f"completed")
    out += ("\nAdmission verdicts: " + ", ".join(
        f"{k}={adm[k]}" for k in sorted(adm)) if adm else "")
    out += ("\nChaos injected: " + (", ".join(
        f"{k}×{ev[k]}" for k in sorted(ev)) or "none"))
    if fo.get("promoted"):
        out += (f"\nFailover: standby {fo.get('node', '?')} promoted in "
                f"{fo.get('duration_ms', 0):g} ms")
    return out


def render_tracker_bench(doc):
    """tracker_bench/v1: the C10k ladder — per idle-conn rung, world
    formation throughput, command latency, and the boundedness
    evidence (resident threads + fds must not scale with the rung)."""
    rows = []
    for lv in doc.get("levels", []):
        rows.append((
            str(lv.get("idle_conns", "?")),
            f"{lv.get('regs_per_s', 0):g}",
            f"{lv.get('cmd_p50_ms', 0):g}",
            f"{lv.get('cmd_p99_ms', 0):g}",
            str(lv.get("threads", "?")),
            str(lv.get("fds", "?")),
            f"{lv.get('loop_lag_ms', 0):g}"))
    base = doc.get("baseline", {})
    title = (f"Tracker C10k bench — up to "
             f"{doc.get('max_idle_conns', '?')} idle conns, threads "
             f"{'bounded' if doc.get('bounded_threads') else 'UNBOUNDED'}"
             f" ({doc.get('timestamp_utc', '')})")
    out = title + "\n\n" + _md_table(
        ("idle conns", "regs/s", "cmd p50 ms", "cmd p99 ms",
         "threads", "fds", "loop lag ms"), rows)
    out += (f"\n\nBaseline before the ladder: "
            f"{base.get('threads', '?')} threads, "
            f"{base.get('fds', '?')} fds; {doc.get('waves', '?')} "
            f"formation waves x {doc.get('nworkers', '?')} workers and "
            f"{doc.get('cmd_samples', '?')} latency samples per rung")
    return out


def render_fleet_events(doc, last_n=32):
    """fleet_event/v1: either one HLC-stamped record or a fleet event
    log (the tracker's /events document) — rendered as an ordered
    event table."""
    events = doc.get("events")
    if events is None:
        events = [doc]  # a single shipped record
    events = events[-last_n:]
    rows = []
    for e in events:
        hlc = e.get("hlc") or {}
        stamp = (f"{hlc.get('ms', '?')}+{hlc.get('lc', 0)}"
                 if hlc else f"{e.get('t_unix', 0.0):.3f}")
        rows.append((stamp, e.get("kind", "?"),
                     e.get("source", e.get("job", "")) or "-",
                     "-" if e.get("rank") is None else e["rank"],
                     e.get("detail", "") or "-"))
    title = (f"Fleet events — {len(events)} record(s) shown, "
             f"{doc.get('dropped', 0)} dropped "
             f"({doc.get('timestamp_utc', '')})")
    return title + "\n\n" + _md_table(
        ("hlc/t", "kind", "source", "rank", "detail"), rows)


def render_incident(doc):
    """incident/v1: the attribution chain behind one SLO burn or
    abort — root cause first, severity, affected jobs/ranks."""
    sev = doc.get("severity", "?")
    title = (f"Incident `{doc.get('id', '?')}` — "
             f"{'**CRITICAL**' if sev == 'critical' else sev}: "
             f"{doc.get('summary', '')} "
             f"({doc.get('timestamp_utc', '')})")
    parts = [title]
    if doc.get("unattributed"):
        parts.append("No candidate cause inside the "
                     f"{doc.get('window_ms', '?')} ms causal window "
                     "(explicitly unattributed).")
    else:
        rows = []
        root_seq = (doc.get("root_cause") or {}).get("seq")
        for e in doc.get("attribution", []):
            hlc = e.get("hlc") or {}
            stamp = (f"{hlc.get('ms', '?')}+{hlc.get('lc', 0)}"
                     if hlc else f"{e.get('t_unix', 0.0):.3f}")
            mark = ("**root**" if root_seq is not None
                    and e.get("seq") == root_seq else "")
            rows.append((stamp, e.get("kind", "?"),
                         "-" if e.get("rank") is None else e["rank"],
                         e.get("detail", "") or "-", mark))
        parts.append(f"Attribution chain ({len(rows)} event(s), "
                     f"window {doc.get('window_ms', '?')} ms)\n\n" +
                     _md_table(("hlc/t", "kind", "rank", "detail", ""),
                               rows))
    scope = []
    if doc.get("jobs"):
        scope.append("jobs: " + ", ".join(doc["jobs"]))
    if doc.get("ranks"):
        scope.append("ranks: " + ", ".join(str(r) for r in doc["ranks"]))
    if scope:
        parts.append("Affected " + "; ".join(scope))
    return "\n\n".join(parts)


_KINDS = ("telemetry_summary", "telemetry_fleet", "telemetry_trace",
          "flight_record", "bench_sentinel", "soak", "tracker_bench",
          "fleet_event", "incident")


def recognized(doc):
    """True when :func:`render` can handle this document."""
    if not isinstance(doc, dict):
        return False
    return (any(matches(doc, k) for k in _KINDS)
            or doc.get("schema") in ("rabit_tpu.collective_sweep/v1",
                                     "rabit_tpu.collective_sweep/v2"))


def render(doc):
    if matches(doc, "telemetry_summary") or matches(doc, "telemetry_fleet"):
        return render_counters(doc)
    if matches(doc, "telemetry_trace"):
        return render_trace(doc)
    if matches(doc, "flight_record"):
        return render_flight(doc)
    if matches(doc, "bench_sentinel"):
        return render_sentinel(doc)
    if matches(doc, "soak"):
        return render_soak(doc)
    if matches(doc, "tracker_bench"):
        return render_tracker_bench(doc)
    if matches(doc, "fleet_event"):
        return render_fleet_events(doc)
    if matches(doc, "incident"):
        return render_incident(doc)
    if doc.get("schema") in ("rabit_tpu.collective_sweep/v1",
                             "rabit_tpu.collective_sweep/v2"):
        return render_sweep(doc)
    raise SystemExit(f"unrecognized artifact schema {doc.get('schema')!r}")


def smoke(out_dir):
    """record -> export -> reload -> render round-trip, totals cross-
    checked between the summary counters and the trace events."""
    from .. import telemetry

    telemetry.reset(capacity=64, enabled=True)
    spans = [("allreduce", 1e-3, 4 << 20, "sum", "ring", "bf16"),
             ("allreduce", 2e-3, 4 << 20, "sum", "ring", "bf16"),
             ("allreduce", 5e-4, 64 << 10, "sum", "tree", None),
             ("broadcast", 1e-4, 1 << 10, None, "psum_mask", None)]
    for name, dur, nb, op, method, wire in spans:
        telemetry.record_span(name, dur, nbytes=nb, op=op, method=method,
                              wire=wire)
    os.makedirs(out_dir, exist_ok=True)
    spath = os.path.join(out_dir, "telemetry_summary_smoke.json")
    tpath = os.path.join(out_dir, "telemetry_trace_smoke.json")
    snap = telemetry.snapshot()
    telemetry.export_summary(snap, spath, rank=0, world_size=1)
    telemetry.export_chrome_trace(snap, tpath, rank=0)
    with open(spath) as f:
        summary = json.load(f)
    with open(tpath) as f:
        trace = json.load(f)
    assert matches(summary, "telemetry_summary"), summary.get("schema")
    assert matches(trace, "telemetry_trace"), trace.get("schema")
    # totals must agree between the two exporters (acceptance criterion)
    want_bytes = sum(nb for _, _, nb, _, _, _ in spans)
    want_dur = sum(d for _, d, _, _, _, _ in spans)
    got_bytes = sum(c["bytes"] for c in summary["counters"])
    got_dur = sum(c["total_s"] for c in summary["counters"])
    assert got_bytes == want_bytes, (got_bytes, want_bytes)
    assert abs(got_dur - want_dur) < 1e-9, (got_dur, want_dur)
    evs = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    assert len(evs) == len(spans), len(evs)
    assert sum(e["args"]["bytes"] for e in evs) == want_bytes
    assert abs(sum(e["dur"] for e in evs) / 1e6 - want_dur) < 1e-9
    ts = [e["ts"] for e in evs]
    assert ts == sorted(ts), "trace ts not monotonic"
    print(render(summary))
    print()
    print(render(trace))
    # flight-record rendering + cross-rank stitch round-trip
    from ..telemetry.flight import FlightRecorder
    telemetry.reset(capacity=64, enabled=True)
    for i in range(2):
        telemetry.record_span(
            "engine.allreduce", 1e-3, nbytes=1 << 20, op="sum",
            round=telemetry.collective_round("engine.allreduce"))
    fr = FlightRecorder(out_dir, rank=0)
    fpath = fr.dump("smoke")
    assert fpath, "flight dump failed"
    with open(fpath) as f:
        fdoc = json.load(f)
    body = render(fdoc)
    assert "Flight record" in body and "`smoke`" in body, body[:200]
    peer = {"rank": 1,
            "t_base_unix": fdoc["t_base_unix"],
            "spans": [{"name": "engine.allreduce", "t0": 0.25,
                       "dur": 1e-3, "attrs": {"round": r}}
                      for r in (1, 2)]}
    skew = render_skew([fdoc, peer])
    assert skew is not None and "Straggler: rank" in skew, skew
    # hierarchical rounds stitch per phase: the three hier.* spans of
    # one round must land as three critical-path rows with the phase
    # column filled (the per-phase attribution contract)
    phases = [("hier.reduce_scatter", "reduce_scatter"),
              ("hier.inter", "inter"), ("hier.allgather", "allgather")]
    hier = [{"rank": rk, "t_base_unix": 0.0,
             "spans": [{"name": nm, "t0": 0.1 * i + 0.01 * rk,
                        "dur": 1e-3, "attrs": {"round": 5, "phase": ph}}
                       for i, (nm, ph) in enumerate(phases)]}
            for rk in (0, 1)]
    hskew = render_skew(hier)
    assert hskew is not None, "hier phase rounds did not stitch"
    for nm, ph in phases:
        assert nm in hskew and ph in hskew, (nm, ph, hskew)
    # adapted rounds carry their plan into the adaptation column;
    # unadapted rounds render "-" in the same table
    adap = [{"rank": rk, "t_base_unix": 0.0,
             "spans": [{"name": "engine.allreduce", "t0": 0.01 * rk,
                        "dur": 1e-3,
                        "attrs": {"round": 1, "adapted": "rotate@2"}},
                       {"name": "engine.allreduce", "t0": 0.2 + 0.01 * rk,
                        "dur": 1e-3, "attrs": {"round": 2}}]}
            for rk in (0, 1)]
    askew = render_skew(adap)
    assert askew is not None and "adaptation" in askew, askew
    assert "rotate@2" in askew, askew
    telemetry.reset()
    print("telemetry smoke ok")


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="render telemetry/sweep artifacts as PERF.md tables")
    ap.add_argument("artifact", nargs="*",
                    help="path(s) to *.json artifacts; several "
                    "round-carrying ones add a cross-rank skew section")
    ap.add_argument("--smoke", action="store_true",
                    help="record->export->render round-trip")
    ap.add_argument("--dir", default=None,
                    help="render every recognized *.json artifact in "
                         "this directory (with --smoke: the smoke "
                         "output dir, default a temporary one)")
    args = ap.parse_args(argv)
    if args.smoke:
        if args.dir:
            smoke(args.dir)
        else:
            with tempfile.TemporaryDirectory() as tmp:
                smoke(tmp)
        return 0
    paths = list(args.artifact)
    if args.dir:
        import glob
        paths.extend(sorted(glob.glob(os.path.join(args.dir, "*.json"))))
    if not paths:
        ap.error("need an artifact path, --dir, or --smoke")
    docs = []
    skipped = []
    for path in paths:
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            if not args.dir:
                raise
            skipped.append((path, f"unreadable: {e}"))
            continue
        if args.dir and not recognized(doc):
            # a directory scan keeps going past foreign files; an
            # explicit file argument still fails loudly in render()
            skipped.append((path, f"schema {doc.get('schema')!r}"))
            continue
        docs.append(doc)
        print(render(doc))
        print()
    if skipped:
        print(f"(skipped {len(skipped)} unrecognized file(s): "
              + ", ".join(os.path.basename(p) for p, _ in skipped) + ")")
        print()
    if len(docs) >= 2:
        skew = render_skew(docs)
        if skew is not None:
            print(skew)
    return 0


if __name__ == "__main__":
    sys.exit(main())
