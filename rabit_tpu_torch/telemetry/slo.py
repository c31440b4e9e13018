"""Declarative SLO plane over the telemetry the system already emits:
the port's copy of ``rabit_tpu/telemetry/slo.py`` (stdlib only).

The robustness features ship one at a time (standby failover, multi-job
admission, self-healing links, elastic membership) but nothing states
what "good" means for the fleet as a whole. This module does: an
:class:`SLO` is a declarative objective — metric source, target value,
direction, evaluation window — and :func:`evaluate_all` turns raw
measurements into per-objective burn verdicts (``ok`` / ``warn`` /
``violating`` / ``no_data``). Everything is computed from telemetry
that already exists; the SLO plane adds no new instrumentation to the
hot path:

- **fleet availability** — fraction of collective rounds completed on
  schedule (a soak harness's round ledger)
- **p99 collective latency** — read straight out of the recorder's
  log2-microsecond duration histograms (``hist_log2_us``; bucket ``k``
  covers ``(2^(k-1), 2^k]`` µs, so the quantile is a bucket upper
  bound, never an interpolation that claims false precision)
- **failover time** — leader-kill → standby-promoted, stamped by the
  control plane itself at promotion (``tracker.promoted_wall`` /
  ``promoted_mono``, tracker/standby.py) — the harness only reads it
- **admission shed rate** — shed verdicts as a fraction of all submit
  verdicts (a multi-job tracker's admission counters)

Burn state is served live: :func:`gauges` renders verdicts as
``rabit_slo_*`` gauge families for the per-rank and tracker
``/metrics`` endpoints (registered in ``prom.METRIC_FAMILIES``), and
:func:`burn_doc` shapes the tracker's ``/slo`` JSON route.

Objectives are knobs (env, flags beat env in tools):
``RABIT_SLO_AVAILABILITY`` (default 0.90), ``RABIT_SLO_P99_MS``
(2000), ``RABIT_SLO_FAILOVER_MS`` (15000), ``RABIT_SLO_SHED_RATE``
(0.90), and ``RABIT_SLO_WARN_BURN`` (0.75) — the error-budget fraction
past which ``ok`` degrades to ``warn``.

Self-test: ``python -m rabit_tpu_torch.telemetry.slo --smoke``.
"""

from __future__ import annotations

import os
from typing import Dict, Iterable, List, Optional, Sequence

OK = "ok"
WARN = "warn"
VIOLATING = "violating"
NO_DATA = "no_data"

# gauge encoding for rabit_slo_state; NO_DATA is negative so alerting
# on "state > 0" never pages for an objective that simply has no
# samples yet
STATE_CODE = {NO_DATA: -1, OK: 0, WARN: 1, VIOLATING: 2}
# severity order for worst_state(): an unmeasured objective is worse
# than a healthy one (you cannot claim an SLO you never measured) but
# better than one actively burning
_STATE_RANK = {OK: 0, NO_DATA: 1, WARN: 2, VIOLATING: 3}

_AVAILABILITY_ENV = "RABIT_SLO_AVAILABILITY"
_P99_ENV = "RABIT_SLO_P99_MS"
_FAILOVER_ENV = "RABIT_SLO_FAILOVER_MS"
_SHED_ENV = "RABIT_SLO_SHED_RATE"
_WARN_ENV = "RABIT_SLO_WARN_BURN"

# span names whose duration histograms count as "collective latency"
# (recorder counter rows; the soak harness records its rounds under
# "allreduce" like the engines do)
COLLECTIVE_NAMES = frozenset({
    "allreduce", "allreduce_async", "broadcast", "reduce_scatter",
    "allgather", "hier_allreduce"})

# burn ratios are capped so a zero-budget objective renders as a large
# finite gauge instead of an exposition-breaking inf
_BURN_CAP = 1e9


class SLO:
    """One declarative objective. ``direction`` says which way is
    good: ``"lower"`` (latencies, rates) violates above the objective,
    ``"higher"`` (availability — fraction-valued by contract) violates
    below it."""

    __slots__ = ("name", "metric", "unit", "objective", "direction",
                 "window_s", "source")

    def __init__(self, name: str, metric: str, unit: str,
                 objective: float, direction: str, window_s: float,
                 source: str):
        if direction not in ("lower", "higher"):
            raise ValueError(f"SLO direction must be 'lower' or "
                             f"'higher', got {direction!r}")
        self.name = str(name)
        self.metric = str(metric)
        self.unit = str(unit)
        self.objective = float(objective)
        self.direction = direction
        self.window_s = float(window_s)
        self.source = str(source)

    def doc(self) -> dict:
        return {"name": self.name, "metric": self.metric,
                "unit": self.unit, "objective": self.objective,
                "direction": self.direction, "window_s": self.window_s,
                "source": self.source}


def warn_burn() -> float:
    return float(os.environ.get(_WARN_ENV, 0.75))


def default_slos(overrides: Optional[Dict[str, float]] = None,
                 window_s: float = 300.0) -> Sequence[SLO]:
    """The fleet's four objectives. ``overrides`` (name -> objective)
    beats the env knobs — tools pass their ``--objective`` flags
    through here, which is also how a test injects a violation."""
    ov = dict(overrides or {})

    def obj(name: str, env: str, default: float) -> float:
        if name in ov:
            return float(ov[name])
        return float(os.environ.get(env, default))

    return (
        SLO("availability", "soak_availability", "fraction",
            obj("availability", _AVAILABILITY_ENV, 0.90), "higher",
            window_s,
            "rounds completed on schedule / rounds run (soak ledger)"),
        SLO("p99_ms", "soak_p99_ms", "ms",
            obj("p99_ms", _P99_ENV, 2000.0), "lower", window_s,
            "p99 collective latency from the log2-us span histograms"),
        SLO("failover_ms", "soak_failover_ms", "ms",
            obj("failover_ms", _FAILOVER_ENV, 15000.0), "lower",
            window_s,
            "leader-kill -> standby-promoted (control-plane stamped)"),
        SLO("shed_rate", "soak_shed_rate", "fraction",
            obj("shed_rate", _SHED_ENV, 0.90), "lower", window_s,
            "submissions shed / submit verdicts (admission counters)"),
    )


# -- histogram math -------------------------------------------------------

def merged_hist(counters: Optional[Iterable[dict]],
                names: Optional[frozenset] = None) -> Dict[int, int]:
    """Sum the ``hist_log2_us`` histograms of recorder counter rows
    (optionally restricted to span ``names``) into one histogram."""
    h: Dict[int, int] = {}
    for row in counters or []:
        if names is not None and row.get("name") not in names:
            continue
        for k, v in (row.get("hist_log2_us") or {}).items():
            k = int(k)
            h[k] = h.get(k, 0) + int(v)
    return h


def hist_quantile_us(hist: Dict[int, int], q: float = 0.99) \
        -> Optional[float]:
    """Quantile upper bound (µs) of a log2-µs histogram: the smallest
    bucket upper edge ``2^k`` whose cumulative count reaches
    ``q * total``. None on an empty histogram."""
    total = sum(hist.values())
    if total <= 0:
        return None
    need = q * total
    cum = 0
    for k in sorted(hist):
        cum += hist[k]
        if cum >= need:
            return float(1 << int(k))
    return float(1 << max(int(k) for k in hist))  # pragma: no cover


def p99_ms_from_counters(counters: Optional[Iterable[dict]],
                         names: Optional[frozenset] = COLLECTIVE_NAMES) \
        -> Optional[float]:
    """p99 collective latency (ms) out of recorder counter rows; None
    when no matching durations were recorded."""
    us = hist_quantile_us(merged_hist(counters, names))
    return None if us is None else us / 1e3


# -- evaluation -----------------------------------------------------------

def burn_ratio(slo: SLO, value: Optional[float]) -> Optional[float]:
    """Error-budget burn: >= 1.0 means the objective is violated.
    Lower-direction: value / objective. Higher-direction objectives are
    fraction-valued by contract (availability), so the budget is
    ``1 - objective`` and burn is the fraction of it consumed."""
    if value is None:
        return None
    if slo.direction == "lower":
        if slo.objective <= 0:
            return 0.0 if value <= 0 else _BURN_CAP
        return min(_BURN_CAP, value / slo.objective)
    budget = 1.0 - slo.objective
    if budget <= 0:
        return 0.0 if value >= slo.objective else _BURN_CAP
    return min(_BURN_CAP, max(0.0, 1.0 - value) / budget)


def evaluate(slo: SLO, value: Optional[float],
             warn: Optional[float] = None) -> dict:
    """One verdict: the objective, the measurement, the burn ratio and
    the resulting state. ``value`` None -> ``no_data`` (reported, never
    counted as a pass)."""
    w = warn_burn() if warn is None else float(warn)
    burn = burn_ratio(slo, value)
    if burn is None:
        state = NO_DATA
    elif (value < slo.objective if slo.direction == "higher"
          else value > slo.objective):
        state = VIOLATING
    elif burn >= w:
        state = WARN
    else:
        state = OK
    return {"slo": slo.name, "metric": slo.metric, "unit": slo.unit,
            "value": None if value is None else float(value),
            "objective": slo.objective, "direction": slo.direction,
            "window_s": slo.window_s,
            "burn": None if burn is None else round(burn, 6),
            "state": state}


def evaluate_all(slos: Sequence[SLO],
                 measurements: Dict[str, Optional[float]],
                 warn: Optional[float] = None) -> List[dict]:
    return [evaluate(s, measurements.get(s.name), warn=warn)
            for s in slos]


def worst_state(verdicts: Iterable[dict]) -> str:
    worst = OK
    for v in verdicts:
        s = v.get("state", NO_DATA)
        if _STATE_RANK.get(s, 1) > _STATE_RANK[worst]:
            worst = s
    return worst


def burn_doc(verdicts: List[dict]) -> dict:
    """The ``/slo`` JSON route's shape (tracker metrics server): the
    verdicts and the ``worst`` state."""
    return {"slos": verdicts, "worst": worst_state(verdicts)}


# -- live gauges ----------------------------------------------------------

def gauges(verdicts: List[dict]) -> list:
    """Verdicts as GaugeSpec rows for a ``/metrics`` endpoint. State
    and objective are emitted for every declared SLO; value and burn
    only once measured (absence IS the no-data signal)."""
    measured = [v for v in verdicts if v.get("value") is not None]
    out = [
        ("rabit_slo_state",
         "Burn state per objective: 0 ok, 1 warn, 2 violating, "
         "-1 no data yet.", "gauge",
         [({"slo": v["slo"]}, STATE_CODE[v["state"]])
          for v in verdicts]),
        ("rabit_slo_objective",
         "Declared objective per SLO (ms or fraction, per the "
         "series' unit).", "gauge",
         [({"slo": v["slo"]}, v["objective"]) for v in verdicts]),
    ]
    if measured:
        out.append((
            "rabit_slo_value",
            "Measured value per SLO over its evaluation window.",
            "gauge", [({"slo": v["slo"]}, v["value"])
                      for v in measured]))
        out.append((
            "rabit_slo_burn_ratio",
            "Error-budget burn per SLO: >= 1 means the objective is "
            "violated right now.", "gauge",
            [({"slo": v["slo"]}, v["burn"]) for v in measured
             if v.get("burn") is not None]))
    return out


def rank_gauges() -> list:
    """Per-rank ``/metrics`` contribution (the engines' gauges_fn
    calls this): the latency objective evaluated from this process's
    own recorder histograms. Cheap and empty-safe — with telemetry off
    the verdict is ``no_data`` and only state/objective render."""
    from .. import telemetry
    slos = [s for s in default_slos() if s.name == "p99_ms"]
    counters = telemetry.snapshot().get("counters")
    return gauges(evaluate_all(
        slos, {"p99_ms": p99_ms_from_counters(counters)}))


# ------------------------------------------------------------- CI smoke

def _smoke() -> int:
    """Self-test: histogram quantile math,
    all four objectives evaluated with directions gating the right
    way, warn/no_data states, and the gauge families rendering through
    the registered exposition."""
    # bucket k covers (2^(k-1), 2^k] us: 99 of 100 samples at or
    # below bucket 10 -> p99 upper bound 1024 us
    assert hist_quantile_us({0: 50, 5: 30, 10: 19, 14: 1}) == 1024.0
    assert hist_quantile_us({}) is None
    assert hist_quantile_us({3: 1}) == 8.0
    counters = [
        {"name": "allreduce", "hist_log2_us": {"10": 99, "14": 1}},
        # non-collective rows must not pollute the latency SLO
        {"name": "dispatch", "hist_log2_us": {"20": 1000}},
    ]
    assert p99_ms_from_counters(counters) == 1.024

    slos = default_slos(overrides={
        "availability": 0.95, "p99_ms": 100.0,
        "failover_ms": 5000.0, "shed_rate": 0.5})
    good = {v["slo"]: v for v in evaluate_all(slos, {
        "availability": 0.999, "p99_ms": 20.0,
        "failover_ms": 1200.0, "shed_rate": 0.1})}
    assert all(v["state"] == OK for v in good.values()), good
    bad = {v["slo"]: v for v in evaluate_all(slos, {
        "availability": 0.90, "p99_ms": 500.0,
        "failover_ms": 9000.0, "shed_rate": 0.9})}
    assert all(v["state"] == VIOLATING for v in bad.values()), bad
    assert all(v["burn"] >= 1.0 for v in bad.values()), bad
    # higher-direction burn: 0.96 availability against 0.95 has burned
    # 4/5 of the error budget -> warn at the default 0.75 threshold
    w = evaluate(slos[0], 0.96, warn=0.75)
    assert w["state"] == WARN and 0.75 <= w["burn"] < 1.0, w
    nd = evaluate(slos[2], None)
    assert nd["state"] == NO_DATA and nd["burn"] is None, nd
    assert worst_state(good.values()) == OK
    assert worst_state(list(good.values()) + [w]) == WARN
    assert worst_state([w, nd] + list(bad.values())) == VIOLATING
    assert burn_doc([nd])["worst"] == NO_DATA

    # every family minted here is registered, and the exposition
    # renders them with the slo label
    from . import prom
    specs = gauges(list(bad.values()) + [nd])
    for name, _help, _typ, _rows in specs:
        assert name in prom.METRIC_FAMILIES, name
    text = prom.render_prometheus([], gauges=specs)
    assert "# TYPE rabit_slo_state gauge" in text, text
    assert 'rabit_slo_burn_ratio{slo="p99_ms"}' in text, text
    assert 'rabit_slo_state{slo="failover_ms"} -1' in text, text
    # per-rank hook is empty-safe with a quiet recorder
    for name, _help, _typ, _rows in rank_gauges():
        assert name in prom.METRIC_FAMILIES, name
    print("slo smoke ok")
    return 0


def main(argv: Optional[List[str]] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="declarative SLO plane (evaluator + live gauges)")
    ap.add_argument("--smoke", action="store_true",
                    help="run the self-test")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke()
    ap.print_help()
    return 2


if __name__ == "__main__":
    import sys
    sys.exit(main())
