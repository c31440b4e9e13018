"""Normalized perf history + median-absolute-deviation regression gate:
the port's copy of ``rabit_tpu/telemetry/history.py`` (its record
fields, fingerprint, dedupe key, directions registry and gate), writing
the port's own ``build/artifacts/history.jsonl``, never the JAX
package's ``benchmarks/history.jsonl``.

Benchmarks write timestamped JSON artifacts; this module turns each into
normalized records in an append-only history:

    {"metric", "value", "unit", "direction", "fingerprint",
     "timestamp_utc", "source"}

keyed by ``(metric, fingerprint, timestamp_utc)`` where the
*fingerprint* hashes the artifact's stable config-ish scalars (backend,
device, method, sizes ...) so runs are only compared against runs of the
same configuration.

The gate is deliberately distribution-free: for each (metric,
fingerprint) series the newest value is judged against the median and
MAD of the previous ``window`` samples; a worse-direction deviation
beyond ``mad_k`` MADs (floored at 1% of the median, so an all-identical
history doesn't flag measurement noise) is a regression.
``tools/overlap_bench.py`` appends its series through :func:`append`.
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Any, Dict, List, Optional

from .schema import make_header, timestamp_utc

SENTINEL_KIND = "bench_sentinel"

WINDOW_DEFAULT = int(os.environ.get("RABIT_SENTINEL_WINDOW", 8))
MAD_K_DEFAULT = float(os.environ.get("RABIT_SENTINEL_MAD_K", 3.0))
MIN_SAMPLES_DEFAULT = int(os.environ.get("RABIT_SENTINEL_MIN_SAMPLES", 4))
# MAD floor as a fraction of the median: an all-identical baseline has
# MAD 0 and would flag any change at all; 1% is below every effect this
# repo trends (crossovers and speedups are 10%+ phenomena)
REL_FLOOR = 0.01

# units where smaller is better; everything else defaults higher-better
_LOWER_UNITS = frozenset({"s", "ms", "us", "seconds", "sec"})
# explicit per-metric direction registrations: the unit
# heuristic cannot know that a fraction-valued series like fleet
# availability gates on DROPS — sources that know better say so here.
# Seeded with the soak SLO series so a bare sentinel run judges a
# committed soak artifact correctly without importing the soak tool.
_DIRECTIONS: Dict[str, str] = {
    "soak_availability": "higher",
    "soak_p99_ms": "lower",
    "soak_failover_ms": "lower",
    "soak_shed_rate": "lower",
}
# tracker_bench/v1 per-rung series at the standard idle-conn ladder:
# throughput is higher-better; latency, resident threads
# and descriptors gate on GROWTH. Seeded for the same reason as the
# soak rows — a bare sentinel run must judge a committed artifact
# correctly without importing the bench tool.
for _lvl in (0, 1000, 5000, 10000):
    _DIRECTIONS[f"tracker_regs_per_s.c{_lvl}"] = "higher"
    _DIRECTIONS[f"tracker_cmd_p99_ms.c{_lvl}"] = "lower"
    _DIRECTIONS[f"tracker_threads.c{_lvl}"] = "lower"
    _DIRECTIONS[f"tracker_fds.c{_lvl}"] = "lower"
# artifact keys that are measurements/noise, never configuration
_NON_CONFIG_KEYS = frozenset({
    "value", "vs_baseline", "correct", "timestamp_utc", "t_dev_ms",
    "t_host_ms", "gbps", "bandwidth_vs_rows", "losses", "rows", "table",
    "counters", "spans", "tpu", "cpu", "status", "cached_from",
    "best_step_s", "compile_plus_first_step_s", "complete",
    "bounded_threads", "max_idle_conns",
})


def repo_root() -> str:
    return os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))


def history_path(root: Optional[str] = None) -> str:
    """The port's history file: ``build/artifacts/history.jsonl`` under
    ``root`` (by default this checkout)."""
    return os.path.join(root or repo_root(), "build", "artifacts",
                        "history.jsonl")


def register_direction(metric: str, direction: str) -> None:
    """Declare which way is better for one metric series. Beats the
    unit/suffix heuristic in :func:`_direction` — the API for
    higher-is-better series whose unit says nothing (fractions,
    ratios, counts-per-round)."""
    if direction not in ("lower", "higher"):
        raise ValueError(f"direction must be 'lower' or 'higher', "
                         f"got {direction!r}")
    _DIRECTIONS[str(metric)] = direction


def _direction(metric: str, unit: str) -> str:
    reg = _DIRECTIONS.get(metric)
    if reg is not None:
        return reg
    u = str(unit).strip().lower()
    if u in _LOWER_UNITS or metric.endswith(("_s", "_ms", "_seconds")):
        return "lower"
    return "higher"


def config_fingerprint(doc: Dict[str, Any]) -> str:
    """Short stable hash of the artifact's scalar config fields —
    backend, device, method, sizes — so only like-for-like runs trend
    against each other. Measurement keys are excluded explicitly."""
    keep = {}
    for k, v in doc.items():
        if k in _NON_CONFIG_KEYS:
            continue
        if v is None or isinstance(v, (str, int, bool)):
            keep[k] = v
    blob = json.dumps(keep, sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:12]


def extract_metrics(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Numeric series hiding in one artifact. Recognizes the repo's
    two measurement shapes: ``metric``/``value``/``unit`` result docs
    (BENCH_LOCAL and friends — with their ``gbps`` /
    ``bandwidth_vs_rows`` sub-curves) and the flagship timing keys.
    Driver wrappers and non-measurement docs yield nothing."""
    out: List[Dict[str, Any]] = []

    def add(metric: str, value: Any, unit: str = "") -> None:
        if isinstance(value, bool) or not isinstance(value, (int, float)):
            return
        out.append({"metric": metric, "value": float(value),
                    "unit": unit, "direction": _direction(metric, unit)})

    metric = doc.get("metric")
    if isinstance(metric, str) and "value" in doc:
        unit = str(doc.get("unit", ""))
        add(metric, doc.get("value"), unit)
        gbps = doc.get("gbps")
        if isinstance(gbps, dict):
            for k in sorted(gbps):
                add(f"{metric}.{k}", gbps[k], unit)
        curve = doc.get("bandwidth_vs_rows")
        if isinstance(curve, dict):
            for k in sorted(curve):
                add(f"{metric}.rows_{k}", curve[k], unit)
    for key in ("best_step_s", "compile_plus_first_step_s"):
        if key in doc:
            add(key, doc.get(key), "s")
    if doc.get("schema") in ("rabit_tpu.collective_sweep/v1",
                             "rabit_tpu.collective_sweep/v2",
                             "rabit_tpu.collective_sweep/v3") \
            and not doc.get("smoke"):  # smoke timings are noise by design
        # one series per (section, method, wire, size): the sentinel
        # then trends every schedule's s_per_op across committed sweeps
        # — a slowed-down hier inter phase fails CI like any perf bug.
        # v3 wire values are phase-split specs ("int8:bf16@512"); the
        # separators fold to "_" so a series name stays one dotted token
        for r in doc.get("rows", []):
            if not isinstance(r, dict):
                continue
            wire = (f"_{r['wire']}".replace(":", "_").replace("@", "_b")
                    if r.get("wire") else "")
            add(f"sweep_s_per_op.{r.get('section')}.{r.get('method')}"
                f"{wire}.n_{r.get('n')}", r.get("s_per_op"), "s")
    if doc.get("schema") == "rabit_tpu.soak/v1" \
            and not doc.get("smoke"):  # smoke soaks are noise by design
        # one series per SLO verdict; the verdict's own direction is
        # authoritative (availability is a higher-is-better fraction —
        # the unit heuristic alone would gate it the wrong way)
        for v in doc.get("slos", []):
            if not isinstance(v, dict) or not v.get("slo"):
                continue
            metric = str(v.get("metric") or f"soak_{v['slo']}")
            if v.get("direction") in ("lower", "higher"):
                register_direction(metric, v["direction"])
            add(metric, v.get("value"), str(v.get("unit", "")))
    if doc.get("schema") == "rabit_tpu.tracker_bench/v1" \
            and not doc.get("smoke"):  # smoke ladders are noise by design
        # one series per (measurement, idle-conn rung): a thread count
        # that starts scaling with connections, an fd leak, or a p99
        # blow-up at 10k idle conns fails CI like any perf regression
        for lv in doc.get("levels", []):
            if not isinstance(lv, dict) or "idle_conns" not in lv:
                continue
            rung = lv["idle_conns"]
            for key, unit, direction in (
                    ("regs_per_s", "regs/s", "higher"),
                    ("cmd_p99_ms", "ms", "lower"),
                    ("threads", "threads", "lower"),
                    ("fds", "fds", "lower")):
                metric = f"tracker_{key}.c{rung}"
                register_direction(metric, direction)
                add(metric, lv.get(key), unit)
    return out


def records_from_artifact(doc: Dict[str, Any],
                          source: str = "") -> List[Dict[str, Any]]:
    """Normalized history records for one artifact document."""
    metrics = extract_metrics(doc)
    if not metrics:
        return []
    fp = config_fingerprint(doc)
    ts = str(doc.get("timestamp_utc") or timestamp_utc())
    recs = []
    for m in metrics:
        r = dict(m)
        r["fingerprint"] = fp
        r["timestamp_utc"] = ts
        r["source"] = source
        recs.append(r)
    return recs


def load(path: str) -> List[Dict[str, Any]]:
    """All well-formed records in a history file (bad lines skipped —
    an append-only log must survive a torn write)."""
    out: List[Dict[str, Any]] = []
    try:
        with open(path) as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if isinstance(rec, dict) and "metric" in rec \
                        and isinstance(rec.get("value"), (int, float)):
                    out.append(rec)
    except OSError:
        return []
    return out


def append(path: str, records: List[Dict[str, Any]]) -> int:
    """Append records not already present (dedupe key: metric,
    fingerprint, timestamp). Returns how many were written."""
    if not records:
        return 0
    seen = {(r.get("metric"), r.get("fingerprint"), r.get("timestamp_utc"))
            for r in load(path)}
    fresh = []
    for r in records:
        key = (r.get("metric"), r.get("fingerprint"), r.get("timestamp_utc"))
        if key in seen:
            continue
        seen.add(key)
        fresh.append(r)
    if not fresh:
        return 0
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "a") as f:
        for r in fresh:
            f.write(json.dumps(r, sort_keys=True) + "\n")
    return len(fresh)


def _median(xs: List[float]) -> float:
    s = sorted(xs)
    n = len(s)
    mid = n // 2
    return s[mid] if n % 2 else 0.5 * (s[mid - 1] + s[mid])


def mad(xs: List[float]) -> float:
    """Median absolute deviation — robust scale, immune to the single
    outlier run that IS the thing being detected."""
    med = _median(xs)
    return _median([abs(x - med) for x in xs])


def gate(records: List[Dict[str, Any]], window: int = WINDOW_DEFAULT,
         mad_k: float = MAD_K_DEFAULT,
         min_samples: int = MIN_SAMPLES_DEFAULT) -> List[Dict[str, Any]]:
    """Judge the newest sample of every (metric, fingerprint) series
    against the rolling baseline of the ``window`` samples before it.
    Series with fewer than ``min_samples`` baseline points are reported
    unjudged (``regressed`` None) — no gate without history."""
    series: Dict[tuple, List[Dict[str, Any]]] = {}
    for r in records:
        key = (str(r.get("metric")), str(r.get("fingerprint")))
        series.setdefault(key, []).append(r)
    verdicts = []
    for (metric, fp), recs in sorted(series.items()):
        recs = sorted(recs, key=lambda r: str(r.get("timestamp_utc", "")))
        latest = recs[-1]
        baseline = [float(r["value"]) for r in recs[:-1]][-window:]
        v = {
            "metric": metric,
            "fingerprint": fp,
            "value": float(latest["value"]),
            "unit": latest.get("unit", ""),
            "direction": latest.get("direction", "higher"),
            "timestamp_utc": latest.get("timestamp_utc", ""),
            "n_baseline": len(baseline),
            "recent": [float(r["value"]) for r in recs[-(window + 1):]],
            "regressed": None,
            "baseline_median": None,
            "mad": None,
            "threshold": None,
        }
        if len(baseline) >= min_samples:
            med = _median(baseline)
            scale = max(mad(baseline), REL_FLOOR * abs(med))
            v["baseline_median"] = med
            v["mad"] = mad(baseline)
            if v["direction"] == "lower":
                v["threshold"] = med + mad_k * scale
                v["regressed"] = v["value"] > v["threshold"]
            else:
                v["threshold"] = med - mad_k * scale
                v["regressed"] = v["value"] < v["threshold"]
        verdicts.append(v)
    return verdicts


def verdict_doc(verdicts: List[Dict[str, Any]],
                window: int = WINDOW_DEFAULT,
                mad_k: float = MAD_K_DEFAULT) -> Dict[str, Any]:
    """Schema-versioned ``bench_sentinel/v1`` artifact (rendered by
    tools/trace_report.py; CI exits nonzero when regressions > 0)."""
    doc = make_header(SENTINEL_KIND)
    doc["window"] = window
    doc["mad_k"] = mad_k
    doc["checked"] = len(verdicts)
    doc["regressions"] = sum(1 for v in verdicts if v["regressed"])
    doc["verdicts"] = verdicts
    return doc
