"""Cross-rank collective tracing: stitch one collective across ranks.
The port's copy of ``rabit_tpu/telemetry/crossrank.py`` (stdlib only).

Every engine stamps a per-collective **round id** into its spans (a
per-name sequence number — engine ordering is deterministic across
ranks, so round N on rank A and round N on rank B are the same
collective), and every exported artifact carries the recorder's
wall-clock anchor (``t_base_unix``), so a span's relative ``t0``
becomes a comparable arrival timestamp. From per-rank artifacts this
module computes, per round:

- **arrival skew**: last arrival minus first arrival — the imbalance
  cost every other rank pays waiting (arXiv:1804.05349's dominant
  real-world allreduce cost);
- **straggler**: the rank that arrived last;
- **critical path**: skew plus the straggler's own span duration — the
  wall-clock floor of that collective as actually experienced.

Inputs: ``telemetry_trace/v1`` documents, ``flight_record/v1``
bundles, or raw recorder snapshots (tests build synthetic ones).
Stdlib-only: the tracker and tools import this without torch.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional

from . import clock
from .schema import matches

# Span names that represent one cross-rank collective occurrence. The
# hier.* names are the three phases of one hierarchical allreduce —
# they share a round id, so each phase stitches into its own row and
# the report shows WHICH phase a straggler lost time in.
ROUND_SPAN_NAMES = ("engine.allreduce", "engine.broadcast",
                    "engine.reduce_scatter", "engine.allgather",
                    "dataplane.allreduce", "hier.reduce_scatter",
                    "hier.inter", "hier.allgather")


def _exposed_dur(attrs: dict, raw_dur: float) -> float:
    """A span's contribution to the critical path. Async-overlapped
    collectives stamp ``wire_exposed_ms`` — the wall time the caller
    actually blocked, with the portion hidden behind compute already
    subtracted; when present it replaces the raw duration so overlap
    doesn't inflate the tables."""
    exp = attrs.get("wire_exposed_ms")
    if exp is None:
        return raw_dur
    try:
        return float(exp) / 1e3
    except (TypeError, ValueError):
        return raw_dur


def _records_from_spans(spans: Iterable[dict],
                        t_base_unix: float) -> List[dict]:
    out = []
    for s in spans:
        attrs = s.get("attrs") or {}
        rnd = attrs.get("round")
        if rnd is None:
            continue
        out.append({"round": int(rnd), "name": s["name"],
                    "phase": attrs.get("phase"),
                    "adapted": attrs.get("adapted"),
                    "hlc": attrs.get("hlc"),
                    "t_wall": t_base_unix + float(s.get("t0", 0.0)),
                    "dur": _exposed_dur(attrs, float(s.get("dur", 0.0)))})
    return out


def _records_from_trace(doc: dict) -> List[dict]:
    base = float(doc.get("t_base_unix", 0.0))
    out = []
    for ev in doc.get("traceEvents", []):
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        rnd = args.get("round")
        if rnd is None:
            continue
        out.append({"round": int(rnd), "name": ev["name"],
                    "phase": args.get("phase"),
                    "adapted": args.get("adapted"),
                    "hlc": args.get("hlc"),
                    "t_wall": base + float(ev.get("ts", 0.0)) / 1e6,
                    "dur": _exposed_dur(args,
                                        float(ev.get("dur", 0.0)) / 1e6)})
    return out


def extract_rounds(doc: dict) -> Optional[tuple]:
    """``(rank, [records])`` from any round-carrying artifact, or None
    when the document has no rounds to contribute."""
    if matches(doc, "telemetry_trace"):
        rank = next((ev.get("pid", 0) for ev in doc.get("traceEvents", [])),
                    0)
        recs = _records_from_trace(doc)
    elif matches(doc, "flight_record"):
        rank = doc.get("rank", 0)
        telem = doc.get("telemetry") or {}
        recs = _records_from_spans(telem.get("spans", []),
                                   float(doc.get("t_base_unix", 0.0)))
    elif "spans" in doc:  # raw recorder snapshot (tests, tools)
        rank = doc.get("rank", 0)
        recs = _records_from_spans(doc.get("spans", []),
                                   float(doc.get("t_base_unix", 0.0)))
    else:
        return None
    return (rank, recs) if recs else None


def stitch_rounds(per_rank: Dict[int, List[dict]]) -> List[dict]:
    """Merge per-rank round records into per-round rows. Only rounds
    observed on at least two ranks are comparable (a round seen on one
    rank alone has no skew); they are kept with ``skew_s=None`` so a
    report can still show them.

    Ordering prefers HLC stamps (``telemetry/clock.py``) when every
    arrival in a round carries one — causal order survives wall-clock
    skew between hosts — and falls back to the per-rank
    ``t_base_unix``-anchored wall time otherwise; each comparable row
    says which basis it used in ``ordered_by`` (``"hlc"``/``"wall"``)."""
    rounds: Dict[tuple, dict] = {}
    for rank, recs in per_rank.items():
        for r in recs:
            key = (r["name"], r["round"])
            row = rounds.setdefault(key, {"name": r["name"],
                                          "round": r["round"],
                                          "phase": r.get("phase"),
                                          "adapted": r.get("adapted"),
                                          "arrivals": {}, "durs": {},
                                          "hlcs": {}})
            if row.get("phase") is None:
                row["phase"] = r.get("phase")
            if row.get("adapted") is None:
                row["adapted"] = r.get("adapted")
            row["arrivals"][rank] = r["t_wall"]
            row["durs"][rank] = r["dur"]
            if clock.is_stamp(r.get("hlc")):
                row["hlcs"][rank] = r["hlc"]
    out = []
    for key in sorted(rounds, key=lambda k: (k[0], k[1])):
        row = rounds[key]
        arr = row["arrivals"]
        hlcs = row["hlcs"]
        if len(arr) >= 2:
            if len(hlcs) == len(arr):
                # causal ordering: first/straggler by HLC key, skew
                # from the stamps' physical-ms component (monotone
                # with the causal order, so never negative)
                first_rank = min(hlcs, key=lambda r: clock.key(hlcs[r]))
                straggler = max(hlcs, key=lambda r: clock.key(hlcs[r]))
                skew = (hlcs[straggler]["ms"]
                        - hlcs[first_rank]["ms"]) / 1e3
                row["ordered_by"] = "hlc"
            else:
                first_rank = min(arr, key=lambda r: arr[r])
                straggler = max(arr, key=lambda r: arr[r])
                skew = arr[straggler] - arr[first_rank]
                row["ordered_by"] = "wall"
            row["first_rank"] = first_rank
            row["straggler_rank"] = straggler
            row["skew_s"] = skew
            row["critical_path_s"] = skew + row["durs"][straggler]
        else:
            row["first_rank"] = row["straggler_rank"] = None
            row["skew_s"] = row["critical_path_s"] = None
            row["ordered_by"] = None
        out.append(row)
    return out


def skew_table(rounds: List[dict]) -> List[dict]:
    """Per-rank attribution over stitched rounds: how often each rank
    was the straggler and how much skew it caused while lagging."""
    per: Dict[int, dict] = {}
    for row in rounds:
        for rank in row["arrivals"]:
            per.setdefault(rank, {"rank": rank, "rounds": 0,
                                  "straggler_rounds": 0,
                                  "skew_caused_s": 0.0,
                                  "worst_skew_s": 0.0})
            per[rank]["rounds"] += 1
        if row["skew_s"] is None:
            continue
        lag = per[row["straggler_rank"]]
        lag["straggler_rounds"] += 1
        lag["skew_caused_s"] += row["skew_s"]
        lag["worst_skew_s"] = max(lag["worst_skew_s"], row["skew_s"])
    return [per[r] for r in sorted(per)]


def stitch_documents(docs: Iterable[dict]) -> List[dict]:
    """Convenience: stitch any mix of round-carrying artifacts. Ranks
    colliding across documents keep the last document's records (one
    artifact per rank is the expected shape)."""
    per_rank: Dict[int, List[dict]] = {}
    for doc in docs:
        got = extract_rounds(doc)
        if got is not None:
            per_rank[got[0]] = got[1]
    return stitch_rounds(per_rank)


def _anchor_of(doc: dict) -> Optional[tuple]:
    """``(rank, t_base_unix)`` for any round-carrying artifact shape
    (mirrors :func:`extract_rounds`'s routing), or None."""
    if matches(doc, "telemetry_trace"):
        rank = next((ev.get("pid", 0) for ev in doc.get("traceEvents", [])),
                    0)
    elif matches(doc, "flight_record") or "spans" in doc:
        rank = doc.get("rank", 0)
    else:
        return None
    base = doc.get("t_base_unix")
    if base is None:
        return None
    return (rank, float(base))


def round_gap_s(rounds: List[dict]) -> Optional[float]:
    """Median wall-time gap between consecutive comparable rounds of
    the same collective — the stitcher's yardstick for how much anchor
    disagreement actually matters (anchors off by less than one round
    gap cannot swap arrival order)."""
    firsts: Dict[str, List[tuple]] = {}
    for row in rounds:
        if row.get("skew_s") is None:
            continue
        firsts.setdefault(row["name"], []).append(
            (row["round"], min(row["arrivals"].values())))
    gaps = []
    for lst in firsts.values():
        lst.sort()
        gaps.extend(t2 - t1 for (_, t1), (_, t2) in zip(lst, lst[1:])
                    if t2 > t1)
    if not gaps:
        return None
    gaps.sort()
    return gaps[len(gaps) // 2]


def anchor_warning(docs: Iterable[dict],
                   rounds: List[dict]) -> Optional[dict]:
    """Detect silently mis-ordered stitches: when two ranks'
    ``t_base_unix`` anchors disagree by more than the typical round
    gap, wall-ordered first/straggler verdicts are unreliable —
    anything beyond the gap can swap arrival order wholesale. Returns
    a warning doc (spread, gap, how many rounds fell back to wall
    ordering) for the stitched report, or None when anchors agree
    within the gap (or fewer than two anchors exist)."""
    anchors: Dict[int, float] = {}
    for doc in docs:
        got = _anchor_of(doc)
        if got is not None:
            anchors[got[0]] = got[1]
    if len(anchors) < 2:
        return None
    spread = max(anchors.values()) - min(anchors.values())
    gap = round_gap_s(rounds)
    if gap is None or spread <= gap:
        return None
    wall_rows = sum(1 for r in rounds if r.get("ordered_by") == "wall")
    hlc_rows = sum(1 for r in rounds if r.get("ordered_by") == "hlc")
    msg = (f"wall-clock anchors disagree by {spread:.3f}s across "
           f"{len(anchors)} rank(s) — more than the {gap:.3f}s round "
           "gap, so wall-ordered arrival verdicts are unreliable")
    if wall_rows and not hlc_rows:
        msg += (f"; all {wall_rows} comparable round(s) fell back to "
                "wall ordering (no HLC stamps — enable rabit_events)")
    elif wall_rows:
        msg += (f"; {hlc_rows} round(s) causally ordered by HLC, "
                f"{wall_rows} fell back to wall ordering")
    else:
        msg += f"; all {hlc_rows} round(s) causally ordered by HLC"
    return {"anchor_spread_s": spread, "round_gap_s": gap,
            "ranks": sorted(anchors), "wall_rounds": wall_rows,
            "hlc_rounds": hlc_rows, "message": msg}


# -- live straggler snapshot (counter-only inputs) -------------------------

_COLLECTIVE_PREFIXES = ("engine.", "dataplane.")

# a fleet whose laggard is behind by zero rounds AND whose busy-time
# spread is under this is healthy — no rank gets named (the periodic
# tracker print has always used this threshold; the endpoint now does
# too instead of naming an arbitrary tie-break winner)
BUSY_SKEW_SIGNAL_S = 1.0


def straggler_snapshot(summaries: Dict[str, dict]) -> dict:
    """Who is behind, from live-polled ``telemetry_summary`` docs
    (counters only — spans never ride the poll path). A lagging rank
    has completed the FEWEST collectives (it is behind the others'
    round sequence); ties break toward the SMALLEST in-collective busy
    time: synchronizing collectives complete in lockstep, and the rank
    everyone waits for is the one that arrives last and leaves at once,
    while the waiters burn their time blocked inside the collective.

    Returns per-rank rows plus an explicit verdict: ``signal`` is True
    only when someone is measurably behind (a round lag, or busy skew
    over ``BUSY_SKEW_SIGNAL_S``); ``lagging_rank`` is named only then.
    ``candidate_rank`` always carries the tie-break winner so callers
    can see who WOULD be named. The tracker serves this as
    ``/straggler`` and as gauges on its ``/metrics``."""
    rows = []
    for tid in sorted(summaries, key=str):
        doc = summaries[tid]
        if not matches(doc, "telemetry_summary"):
            continue
        count = busy = maxs = 0.0
        for c in doc.get("counters", []):
            if not str(c.get("name", "")).startswith(_COLLECTIVE_PREFIXES):
                continue
            count += c.get("count", 0)
            busy += c.get("total_s", 0.0)
            maxs = max(maxs, c.get("max_s", 0.0))
        rows.append({"task_id": str(tid), "rank": doc.get("rank", -1),
                     "collectives": int(count), "busy_s": busy,
                     "max_s": maxs})
    snap = {"ranks": rows, "lagging_rank": None, "candidate_rank": None,
            "lag_collectives": 0, "busy_skew_s": 0.0, "signal": False}
    if len(rows) >= 2:
        lead = max(r["collectives"] for r in rows)
        lag = min(rows, key=lambda r: (r["collectives"], r["busy_s"]))
        snap["candidate_rank"] = lag["rank"]
        snap["lag_collectives"] = lead - lag["collectives"]
        busys = [r["busy_s"] for r in rows]
        snap["busy_skew_s"] = max(busys) - min(busys)
        snap["signal"] = (snap["lag_collectives"] > 0
                          or snap["busy_skew_s"] > BUSY_SKEW_SIGNAL_S)
        if snap["signal"]:
            snap["lagging_rank"] = lag["rank"]
    return snap
