"""Prometheus text-exposition rendering for recorder summaries: the
port's copy of ``rabit_tpu/telemetry/prom.py`` (stdlib only), whose
output it matches byte for byte.

The live metrics endpoints (``telemetry/live.py``, the tracker's
fleet-merged endpoint) serve recorder state in the Prometheus text
format (version 0.0.4) so any off-the-shelf scraper — or plain curl —
can watch a run mid-flight. Stdlib-only on purpose: no
prometheus_client dependency, and the tracker renders without torch.

Mapping from recorder counters (one row per
``(name, op, method, wire, bucket, provenance)`` key):

- ``rabit_collective_total``           count        (counter)
- ``rabit_collective_bytes_total``     bytes        (counter)
- ``rabit_collective_seconds_total``   total_s      (counter)
- ``rabit_collective_max_seconds``     max_s        (gauge)
- ``rabit_collective_duration_seconds`` the log2-µs histogram as a
  native Prometheus histogram: recorder bucket k covers
  ``(2^(k-1), 2^k]`` µs, so its cumulative ``le`` bound is
  ``2^k * 1e-6`` seconds; ``_sum``/``_count`` come from the exact
  counter row.

Recorder occupancy (recorded / dropped / capacity / enabled) is
exported under ``rabit_telemetry_*`` per source, and callers may append
arbitrary extra gauges (watchdog expiries, poll counts, straggler
snapshots).
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Tuple

_LABEL_FIELDS = ("name", "op", "method", "wire", "bucket", "provenance")

# extra gauge spec: (metric_name, help_text, type, [(labels, value)])
GaugeSpec = Tuple[str, str, str, List[Tuple[Dict[str, str], float]]]

# The single registry of every /metrics family name this repo exports,
# anywhere (recorder families rendered below, profile-plane families,
# and the engine/tracker extra gauges), as the JAX package registers
# them: a new metric must be registered here to ship.
METRIC_FAMILIES = (
    # recorder counters (rendered by render_prometheus)
    "rabit_collective_total",
    "rabit_collective_bytes_total",
    "rabit_collective_seconds_total",
    "rabit_collective_max_seconds",
    "rabit_collective_duration_seconds",
    "rabit_telemetry_recorded_total",
    "rabit_telemetry_dropped_total",
    "rabit_telemetry_buffer_capacity",
    "rabit_telemetry_enabled",
    # profiling plane (telemetry/profile.py section, rendered below)
    "rabit_compile_total",
    "rabit_compile_seconds_total",
    "rabit_compile_max_seconds",
    "rabit_jit_cache_hits_total",
    "rabit_jit_cache_misses_total",
    "rabit_collective_cost_flops_total",
    "rabit_collective_cost_wire_bytes_total",
    "rabit_device_mem_live_bytes",
    "rabit_device_mem_peak_bytes",
    "rabit_device_mem_arrays",
    # async overlap accounting (telemetry/profile.py)
    "rabit_collective_overlap_ops_total",
    "rabit_collective_overlap_exposed_ms_total",
    "rabit_collective_overlap_hidden_ms_total",
    # engine extra gauges (engine/xla.py, engine/native.py)
    "rabit_watchdog_expired_total",
    "rabit_world_epoch",
    # tracker fleet gauges (tracker/tracker.py)
    "rabit_tracker_endpoints",
    "rabit_tracker_polls_total",
    "rabit_tracker_topology_hosts",
    "rabit_tracker_topology_ranks_per_host",
    "rabit_straggler_lag_collectives",
    "rabit_straggler_busy_skew_seconds",
    "rabit_skew_offset_ms",
    "rabit_skew_epoch",
    # elastic membership (tracker/tracker.py)
    "rabit_world_size",
    "rabit_member_evictions_total",
    "rabit_member_admissions_total",
    # crash-recoverable tracker (tracker/tracker.py)
    "rabit_tracker_restarts_total",
    "rabit_wal_records_total",
    # hot-standby control plane (tracker/tracker.py)
    "rabit_tracker_role",
    "rabit_repl_acked_seq",
    "rabit_repl_lag_records",
    # self-healing data plane (engine/native.py)
    "rabit_dataplane_retries_total",
    "rabit_frame_crc_rejects_total",
    # multi-job control plane (tracker/tracker.py)
    "rabit_tracker_jobs",
    "rabit_admission_queue_depth",
    "rabit_admission_queued_total",
    "rabit_admission_shed_total",
    "rabit_job_quarantined_total",
    # in-collective wire quantization (parallel/dispatch.py)
    "rabit_wire_quantized_bytes_total",
    "rabit_wire_adapted_total",
    # SLO plane (telemetry/slo.py, tracker/tracker.py)
    "rabit_slo_state",
    "rabit_slo_objective",
    "rabit_slo_value",
    "rabit_slo_burn_ratio",
    "rabit_failover_duration_ms",
    # C10k event-loop control plane (tracker/tracker.py)
    "rabit_tracker_open_conns",
    "rabit_tracker_loop_lag_ms",
    "rabit_wal_snapshot_seq",
    "rabit_sched_preemptions_total",
    # causal incident plane (telemetry/incident.py)
    "rabit_open_incidents",
    "rabit_events_dropped_total",
)


def escape_label_value(v: str) -> str:
    """Label-value escaping per the exposition format: backslash,
    double-quote, and newline."""
    return (str(v).replace("\\", "\\\\").replace('"', '\\"')
            .replace("\n", "\\n"))


def _labels(pairs: Dict[str, str]) -> str:
    if not pairs:
        return ""
    inner = ",".join(f'{k}="{escape_label_value(v)}"'
                     for k, v in pairs.items())
    return "{" + inner + "}"


def _fmt_value(v) -> str:
    if isinstance(v, bool):
        return "1" if v else "0"
    if isinstance(v, int):
        return str(v)
    return repr(float(v))


class _Family:
    """One metric family: emits HELP/TYPE once, then every sample."""

    def __init__(self, name: str, help_text: str, mtype: str):
        self.name = name
        self.help = help_text
        self.type = mtype
        self.samples: List[str] = []

    def add(self, labels: Dict[str, str], value, suffix: str = "") -> None:
        self.samples.append(
            f"{self.name}{suffix}{_labels(labels)} {_fmt_value(value)}")

    def lines(self) -> List[str]:
        if not self.samples:
            return []
        return [f"# HELP {self.name} {self.help}",
                f"# TYPE {self.name} {self.type}"] + self.samples


def _counter_labels(row: dict, base: Dict[str, str]) -> Dict[str, str]:
    labels = dict(base)
    for f in _LABEL_FIELDS:
        labels[f] = row.get(f, "") or ""
    return labels


def render_prometheus(sources: Iterable[Tuple[Dict[str, str], dict]],
                      gauges: Iterable[GaugeSpec] = ()) -> str:
    """Render ``[(base_labels, summary_doc)]`` plus extra gauges into
    one exposition document. A worker passes one source (its own
    summary, labelled with its rank); the tracker passes one source per
    polled rank so a single scrape carries per-rank counters."""
    fams = {
        "count": _Family("rabit_collective_total",
                         "Events per (name,op,method,wire,bucket,"
                         "provenance) key.", "counter"),
        "bytes": _Family("rabit_collective_bytes_total",
                         "Payload bytes per counter key.", "counter"),
        "secs": _Family("rabit_collective_seconds_total",
                        "Busy seconds per counter key.", "counter"),
        "max": _Family("rabit_collective_max_seconds",
                       "Slowest single event per counter key.", "gauge"),
        "hist": _Family("rabit_collective_duration_seconds",
                        "Event duration distribution (log2-microsecond "
                        "recorder buckets).", "histogram"),
        "recorded": _Family("rabit_telemetry_recorded_total",
                            "Spans recorded since reset.", "counter"),
        "dropped": _Family("rabit_telemetry_dropped_total",
                           "Spans overwritten in the ring buffer.",
                           "counter"),
        "capacity": _Family("rabit_telemetry_buffer_capacity",
                            "Ring-buffer capacity in spans.", "gauge"),
        "enabled": _Family("rabit_telemetry_enabled",
                           "1 when the recorder is enabled.", "gauge"),
        # profiling plane (summary docs carry a "profile" section when
        # rabit_profile=1; see telemetry/profile.py)
        "compile_n": _Family("rabit_compile_total",
                             "Jit compilations observed per probed "
                             "function.", "counter"),
        "compile_s": _Family("rabit_compile_seconds_total",
                             "Wall seconds spent in trace+compile "
                             "(first-call cost) per probed function.",
                             "counter"),
        "compile_max": _Family("rabit_compile_max_seconds",
                               "Slowest single compile per probed "
                               "function.", "gauge"),
        "jit_hits": _Family("rabit_jit_cache_hits_total",
                            "Jit/trace cache hits per probed function.",
                            "counter"),
        "jit_misses": _Family("rabit_jit_cache_misses_total",
                              "Jit/trace cache misses per probed "
                              "function.", "counter"),
        "cost_flops": _Family("rabit_collective_cost_flops_total",
                              "Analytic reduction FLOPs per collective "
                              "(name,method,wire).", "counter"),
        "cost_bytes": _Family("rabit_collective_cost_wire_bytes_total",
                              "Analytic wire bytes per collective "
                              "(name,method,wire).", "counter"),
        "mem_live": _Family("rabit_device_mem_live_bytes",
                            "Live device bytes at the last sample.",
                            "gauge"),
        "mem_peak": _Family("rabit_device_mem_peak_bytes",
                            "High-water device bytes since reset.",
                            "gauge"),
        "mem_arrays": _Family("rabit_device_mem_arrays",
                              # the reference's help text, kept so
                              # the two expositions match byte for byte
                              "Live jax arrays at the last sample.",
                              "gauge"),
        "ovl_ops": _Family("rabit_collective_overlap_ops_total",
                           "Async collectives completed per "
                           "(name,method).", "counter"),
        "ovl_exposed": _Family("rabit_collective_overlap_exposed_ms_total",
                               "Wire milliseconds the caller actually "
                               "blocked on (wait time).", "counter"),
        "ovl_hidden": _Family("rabit_collective_overlap_hidden_ms_total",
                              "Wire milliseconds hidden behind compute "
                              "between issue and wait.", "counter"),
        # in-collective wire quantization: dedicated families carved
        # out of the recorder counter rows so dashboards can rate()
        # quantized traffic and adaptive elections without label-
        # matching the generic collective counters
        "wire_q_bytes": _Family("rabit_wire_quantized_bytes_total",
                                "Payload bytes resolved onto a "
                                "quantized wire per (op,method,wire,"
                                "provenance).", "counter"),
        "wire_adapted": _Family("rabit_wire_adapted_total",
                                "Adaptive wire elections made by "
                                "dispatch per (op,method,wire).",
                                "counter"),
    }
    for base, doc in sources:
        base = dict(base or {})
        fams["recorded"].add(base, int(doc.get("recorded", 0)))
        fams["dropped"].add(base, int(doc.get("dropped", 0)))
        if "capacity" in doc:
            fams["capacity"].add(base, int(doc["capacity"]))
        if "enabled" in doc:
            fams["enabled"].add(base, bool(doc["enabled"]))
        for row in doc.get("counters", []):
            if row.get("name") == "wire.quantized":
                fams["wire_q_bytes"].add(_counter_labels(row, base),
                                         int(row.get("bytes", 0)))
            elif row.get("name") == "dispatch.wire_adapted":
                fams["wire_adapted"].add(_counter_labels(row, base),
                                         int(row.get("count", 0)))
            labels = _counter_labels(row, base)
            fams["count"].add(labels, int(row.get("count", 0)))
            fams["bytes"].add(labels, int(row.get("bytes", 0)))
            fams["secs"].add(labels, float(row.get("total_s", 0.0)))
            fams["max"].add(labels, float(row.get("max_s", 0.0)))
            hist = row.get("hist_log2_us") or {}
            if hist:
                cum = 0
                for k, n in sorted((int(b), n) for b, n in hist.items()):
                    cum += n
                    le = dict(labels)
                    le["le"] = repr((1 << k) * 1e-6)
                    fams["hist"].add(le, cum, suffix="_bucket")
                inf = dict(labels)
                inf["le"] = "+Inf"
                fams["hist"].add(inf, cum, suffix="_bucket")
                fams["hist"].add(labels, float(row.get("total_s", 0.0)),
                                 suffix="_sum")
                fams["hist"].add(labels, cum, suffix="_count")
        prof = doc.get("profile")
        if prof:
            for row in prof.get("compile", []):
                labels = dict(base)
                labels["fn"] = str(row.get("fn", ""))
                fams["compile_n"].add(labels, int(row.get("count", 0)))
                fams["compile_s"].add(labels, float(row.get("total_s", 0.0)))
                fams["compile_max"].add(labels, float(row.get("max_s", 0.0)))
            for row in prof.get("jit_cache", []):
                labels = dict(base)
                labels["fn"] = str(row.get("fn", ""))
                fams["jit_hits"].add(labels, int(row.get("hits", 0)))
                fams["jit_misses"].add(labels, int(row.get("misses", 0)))
            for row in prof.get("cost", []):
                labels = dict(base)
                for f in ("name", "method", "wire"):
                    labels[f] = str(row.get(f, "") or "")
                fams["cost_flops"].add(labels, int(row.get("flops", 0)))
                fams["cost_bytes"].add(labels,
                                       int(row.get("wire_bytes", 0)))
            for row in prof.get("overlap", []):
                labels = dict(base)
                for f in ("name", "method"):
                    labels[f] = str(row.get(f, "") or "")
                fams["ovl_ops"].add(labels, int(row.get("count", 0)))
                fams["ovl_exposed"].add(
                    labels, float(row.get("exposed_ms", 0.0)))
                fams["ovl_hidden"].add(
                    labels, float(row.get("overlapped_ms", 0.0)))
            mem = prof.get("device_mem") or {}
            if mem.get("samples"):
                fams["mem_live"].add(base, int(mem.get("live_bytes", 0)))
                fams["mem_peak"].add(base, int(mem.get("peak_bytes", 0)))
                fams["mem_arrays"].add(base, int(mem.get("arrays", 0)))
    lines: List[str] = []
    order = ("count", "bytes", "secs", "max", "hist", "recorded",
             "dropped", "capacity", "enabled", "compile_n", "compile_s",
             "compile_max", "jit_hits", "jit_misses", "cost_flops",
             "cost_bytes", "ovl_ops", "ovl_exposed", "ovl_hidden",
             "mem_live", "mem_peak", "mem_arrays",
             "wire_q_bytes", "wire_adapted")
    for key in order:
        lines.extend(fams[key].lines())
    for name, help_text, mtype, samples in gauges:
        fam = _Family(name, help_text, mtype)
        for labels, value in samples:
            fam.add(labels, value)
        lines.extend(fam.lines())
    return "\n".join(lines) + "\n"
