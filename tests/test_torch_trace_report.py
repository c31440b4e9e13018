"""The port's post-mortem renderer and regression gate
(``rabit_tpu_torch/tools/trace_report.py``, ``tools/bench_sentinel.py``)
against the JAX package's ``tools/trace_report.py`` and
``tools/bench_sentinel.py``: the same text on every artifact kind the
renderer recognizes, each written by the port (a rank's summary, the
fleet document, a trace, a flight bundle, a sentinel verdict, a sweep,
the tracker's fleet events, one event, an incident; the soak and tracker
benchmark documents, which only the JAX package writes, from a seed),
the cross-rank section, ``--dir``, and the sentinel's verdict and exit
code on the same history. Both tools' ``--smoke`` run where JAX is not
imported."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from rabit_tpu.telemetry import schema as jax_schema
from rabit_tpu_torch import telemetry
from rabit_tpu_torch.telemetry import (clock, events, flight, history,
                                       incident, schema)
from rabit_tpu_torch.telemetry.aggregate import merge_summaries
from rabit_tpu_torch.tools import bench_sentinel, trace_report
from rabit_tpu_torch.tools.collective_sweep import derive_table
from rabit_tpu_torch.tools.overlap_bench import ingest as overlap_ingest

ROOT = Path(__file__).resolve().parents[1]
STAMP = "20260102T030405Z"


def _load(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


jax_report = _load("trace_report")
jax_sentinel = _load("bench_sentinel")


@pytest.fixture(autouse=True)
def _plane(monkeypatch):
    for mod in (schema, jax_schema):
        monkeypatch.setattr(mod, "timestamp_utc", lambda: STAMP)
    telemetry.reset(capacity=256, enabled=True)
    events.reset()
    clock.reset()
    yield
    telemetry.reset(enabled=False)
    events.reset()
    clock.reset()


# ------------------------------------------------- artifacts by the port

def _spans(rank, rounds=3):
    for r in range(rounds):
        telemetry.record_span(
            "engine.allreduce", 1e-3 * (1 + rank + r), nbytes=1 << 20,
            op="sum", method="native",
            round=telemetry.collective_round("engine.allreduce"))
    telemetry.record_span("allreduce", 2e-4, nbytes=4096, op="sum",
                          method="ring", wire="bf16")
    telemetry.record_span("broadcast", 5e-5, nbytes=64, method="tree")
    for name in ("recovery.retry", "watchdog.reform", "recovery.link_reset",
                 "recovery.cold_restart"):
        telemetry.count(name, provenance="recovery")


def _summary(rank):
    telemetry.reset(capacity=256, enabled=True)
    _spans(rank)
    return telemetry.build_summary(telemetry.snapshot(), rank=rank,
                                   world_size=2)


def _summary_doc(tmp):
    return _summary(0)


def _fleet_doc(tmp):
    return merge_summaries({"0": _summary(0), "1": _summary(1)})


def _trace_doc(tmp):
    _spans(0)
    path = tmp / "trace.json"
    telemetry.export_chrome_trace(telemetry.snapshot(), str(path), rank=0)
    return json.loads(path.read_text())


def _flight_doc(tmp, rank=0):
    _spans(rank)
    flight.note("chaos_reset", "link conn#2")
    flight.note("watchdog_expired", "engine.allreduce after 2000 ms")
    path = flight.FlightRecorder(str(tmp), rank=rank).dump(
        "watchdog_abort", "engine.allreduce stalled")
    return json.loads(Path(path).read_text())


def _sentinel_doc(tmp):
    hist = str(tmp / "history.jsonl")
    _overlap_history(hist, regress=True)
    return bench_sentinel.run_gate(hist, 8, 3.0, 4)


def _sweep_doc(tmp):
    """A sweep's dispatch table by the port's ``derive_table`` under the
    v2 header (both renderers take v1 and v2; neither renders v3)."""
    rng = np.random.default_rng(3)
    sizes = [1024, 65536, 1 << 21]
    rows = [{"section": sec, "n": n, "method": m, "wire": w,
             "s_per_op": float(rng.uniform(1e-5, 1e-3))}
            for sec in ("float_sum", "other") for n in sizes
            for m in ("tree", "ring", "hier") for w in (None, "bf16")
            if not (sec == "other" and w)]
    doc = {"schema": "rabit_tpu.collective_sweep/v2",
           "timestamp_utc": STAMP, "rows": rows,
           "table": derive_table(rows, sizes)}
    return doc


def _ring(node, kinds, t0):
    return {"records": [
        {"schema": "rabit_tpu.fleet_event/v1", "kind": k,
         "detail": f"{node} {i}", "t_unix": t0 + 0.1 * i,
         "hlc": {"ms": int((t0 + 0.1 * i) * 1e3), "lc": i, "node": node},
         "seq": i + 1, "rank": int(node[1:])}
        for i, k in enumerate(kinds)], "dropped": 3}


def _fleet_events_doc(tmp):
    from rabit_tpu_torch.tracker.tracker import Tracker
    events.reset(capacity=256, enabled=True)
    clock.reset("t", enabled=True)
    tr = Tracker(2)
    try:
        tr._fold_events("0", {"events": _ring(
            "r0", ["chaos.reset", "recovery.retry"], 1000.0)})
        tr._fold_events("1", {"events": _ring(
            "r1", ["recovery.frame_reject"], 1000.05)})
        tr._fleet_emit("membership.evict", "silent", rank=1)
        doc = tr._events_doc()
    finally:
        tr.stop()
    return json.loads(json.dumps(doc))


def _one_event_doc(tmp):
    events.reset(capacity=8, enabled=True)
    clock.reset("r3", enabled=True)
    return dict(events.emit("recovery.link_reset", "conn RST", rank=3))


def _incident_doc(tmp):
    fleet = _fleet_events_doc(tmp)["events"]
    trig = incident.slo_trigger(
        {"slo": "p99_ms", "state": "violating", "value": 80.0,
         "burn": 1.6}, t_unix=1001.0)
    return incident.correlate(trig, fleet, incident_id="inc1")


def _unattributed_doc(tmp):
    trig = incident.abort_trigger({"kind": "watchdog.abort", "rank": 2,
                                   "t_unix": 5.0, "seq": 9})
    return incident.correlate(trig, [], incident_id="inc2")


def _soak_doc(tmp):
    rng = np.random.default_rng(7)
    doc = schema.make_header("soak")
    doc.update({
        "duration_s": 60, "qps_key": 4.0,
        "gate": {"pass": bool(rng.integers(2))},
        "slos": [{"slo": s, "value": float(rng.uniform(0, 9)), "unit": u,
                  "objective": 5.0, "direction": d,
                  "burn": float(rng.uniform(0, 2)),
                  "state": ("ok", "violating")[int(rng.integers(2))]}
                 for s, u, d in (("p99_ms", "ms", "lower"),
                                 ("availability", "", "higher"))],
        "rounds": {"on_time": 9, "total": 10, "deadline_ms": 500,
                   "retried": 1, "failed": 0},
        "jobs": {"completed": 3, "submitted": 4},
        "admission": {"verdicts": {"admitted": 3, "shed": 1}},
        "chaos": {"tracker_events": {"tracker_kill": 1},
                  "link_events": {"reset": 2}},
        "failover": {"promoted": True, "node": "standby",
                     "duration_ms": 812.5}})
    return doc


def _tracker_bench_doc(tmp):
    rng = np.random.default_rng(8)
    doc = schema.make_header("tracker_bench")
    doc.update({"max_idle_conns": 1000, "bounded_threads": True,
                "waves": 3, "nworkers": 8, "cmd_samples": 50,
                "baseline": {"threads": 4, "fds": 12},
                "levels": [{"idle_conns": c,
                            "regs_per_s": float(rng.uniform(50, 90)),
                            "cmd_p50_ms": 0.4, "cmd_p99_ms": 1.5,
                            "threads": 4, "fds": 12 + c,
                            "loop_lag_ms": 0.1} for c in (0, 1000)]})
    return doc


KINDS = {"summary": _summary_doc, "fleet": _fleet_doc, "trace": _trace_doc,
         "flight": _flight_doc, "sentinel": _sentinel_doc,
         "sweep": _sweep_doc, "fleet_events": _fleet_events_doc,
         "one_event": _one_event_doc, "incident": _incident_doc,
         "unattributed": _unattributed_doc, "soak": _soak_doc,
         "tracker_bench": _tracker_bench_doc}


@pytest.mark.parametrize("kind", sorted(KINDS))
def test_render_prints_the_jax_tool_s_text(kind, tmp_path):
    doc = json.loads(json.dumps(KINDS[kind](tmp_path)))
    assert trace_report.recognized(doc) and jax_report.recognized(doc)
    ours = trace_report.render(doc)
    assert ours == jax_report.render(doc)
    assert len(ours.splitlines()) >= 3


def test_a_v3_sweep_and_foreign_documents_are_refused_alike(tmp_path):
    table = json.loads((ROOT / "rabit_tpu_torch" / "parallel" / "tables" /
                        "COLLECTIVE_SWEEP_20261017T131733Z.json")
                       .read_text())
    for doc in (table, {"schema": "rabit_tpu.telemetry_summary/v2"},
                {"schema": "other"}, ["not", "a", "dict"]):
        assert trace_report.recognized(doc) is False
        assert jax_report.recognized(doc) is False
    for mod in (trace_report, jax_report):
        with pytest.raises(SystemExit, match="unrecognized artifact"):
            mod.render(table)


def test_the_cross_rank_section_equals_the_jax_tool_s(tmp_path):
    docs = [_flight_doc(tmp_path / "a", 0), _flight_doc(tmp_path / "b", 1)]
    ours = trace_report.render_skew(docs)
    assert ours is not None and "Straggler: rank" in ours
    assert ours == jax_report.render_skew(docs)
    hier = [{"rank": rk, "t_base_unix": 0.0,
             "spans": [{"name": nm, "t0": 0.1 * i + 0.01 * rk,
                        "dur": 1e-3, "attrs": {"round": 5, "phase": nm}}
                       for i, nm in enumerate(("hier.a", "hier.b"))]}
            for rk in (0, 1)]
    assert trace_report.render_skew(hier) == jax_report.render_skew(hier)
    assert trace_report.render_skew(docs[:1]) is None
    assert jax_report.render_skew(docs[:1]) is None


def _cli(mod, argv, capsys, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["trace_report"] + argv)
    rc = mod.main() if mod is jax_report else mod.main(argv)
    return rc, capsys.readouterr().out


@pytest.mark.parametrize("mode", ["files", "dir"])
def test_the_command_line_prints_the_jax_tool_s_text(tmp_path, capsys,
                                                     monkeypatch, mode):
    """Every kind as files on the command line, or ``--dir`` over a
    directory that also holds a v3 sweep, a foreign file and a torn one
    (listed and skipped): the same text from both tools; two flight
    bundles add the cross-rank section."""
    art = tmp_path / "art"
    art.mkdir()
    paths = []
    for i, (kind, fn) in enumerate(sorted(KINDS.items())):
        p = art / f"{i:02d}_{kind}.json"
        (tmp_path / kind).mkdir()
        p.write_text(json.dumps(fn(tmp_path / kind)))
        paths.append(str(p))
    p = art / "99_flight_peer.json"
    p.write_text(json.dumps(_flight_doc(tmp_path / "peer", 1)))
    paths.append(str(p))
    if mode == "dir":
        (art / "90_v3.json").write_text(
            (ROOT / "rabit_tpu_torch" / "parallel" / "tables" /
             "COLLECTIVE_SWEEP_20261017T131733Z.json").read_text())
        (art / "91_foreign.json").write_text('{"schema": "x"}')
        (art / "92_torn.json").write_text('{"sche')
        argv = ["--dir", str(art)]
    else:
        argv = paths
    rc_o, ours = _cli(trace_report, argv, capsys, monkeypatch)
    rc_t, theirs = _cli(jax_report, argv, capsys, monkeypatch)
    assert rc_o == rc_t == 0
    assert ours == theirs
    assert "Cross-rank rounds" in ours and "Incident `inc1`" in ours
    if mode == "dir":
        assert "(skipped 3 unrecognized file(s): 90_v3.json, " \
            "91_foreign.json, 92_torn.json)" in ours


# --------------------------------------------------------- the sentinel

def _overlap_history(path, regress=False, n=8):
    """``n`` overlap-bench runs appended through the port's bench's own
    ``ingest``, a seeded jitter around 10 ms; with ``regress`` the newest
    sync step of the device path comes out 40% slower."""
    rng = np.random.default_rng(11)
    for i in range(n):
        base = {"world": 4, "n_buckets": 4, "bucket_elems": 1_000_000,
                "dtype": "float32", "compute_dim": 384, "compute_reps": 4,
                "backend": "nccl", "paths": {}}
        for name in ("host", "device"):
            sync = 10.0 + float(rng.normal(0, 0.1))
            if regress and i == n - 1 and name == "device":
                sync *= 1.4
            base["paths"][name] = {
                "bucket_step_ms_sync": sync,
                "bucket_step_ms_overlap": 9.0 + float(rng.normal(0, 0.1))}
        overlap_ingest(base, f"OVERLAP_BENCH_{i}.json",
                       f"20260801T0000{i:02d}Z", path)


@pytest.mark.parametrize("regress", [False, True])
def test_the_sentinel_s_verdict_and_exit_code_are_the_jax_tool_s(
        tmp_path, capsys, monkeypatch, regress):
    hist = tmp_path / "history.jsonl"
    _overlap_history(str(hist), regress)
    argv = ["--history", str(hist), "--no-ingest",
            "--out", str(tmp_path / "v.json")]
    monkeypatch.setattr(sys, "argv", ["bench_sentinel"] + argv)
    rc_t = jax_sentinel.main()
    theirs = capsys.readouterr()
    jax_verdict = (tmp_path / "v.json").read_bytes()
    rc_o = bench_sentinel.main(argv)
    ours = capsys.readouterr()
    assert rc_o == rc_t == (1 if regress else 0)
    assert ours.out == theirs.out
    assert ours.err == theirs.err
    assert (tmp_path / "v.json").read_bytes() == jax_verdict
    doc = json.loads(ours.out)
    assert doc["regressions"] == (1 if regress else 0)
    assert doc["checked"] == 4


def test_the_sentinel_ingests_a_directory_as_the_jax_tool_does(tmp_path):
    """Artifacts of a directory become the same history lines; a torn or
    foreign file is skipped, and a second ingest adds nothing."""
    art = tmp_path / "art"
    art.mkdir()
    for i in range(3):
        (art / f"OVERLAP_BENCH_{i}.json").write_text(json.dumps(
            {"metric": "bucket_step_ms_sync", "value": 10.0 + i,
             "unit": "ms", "world": 4, "timestamp_utc":
             f"20260801T00000{i}Z"}))
    (art / "torn.json").write_text("{")
    (art / "list.json").write_text("[1, 2]")
    ours, theirs = tmp_path / "ours.jsonl", tmp_path / "theirs.jsonl"
    assert bench_sentinel.ingest_dir(str(art), str(ours)) == 3
    assert jax_sentinel.ingest_dir(str(art), str(theirs)) == 3
    assert ours.read_bytes() == theirs.read_bytes()
    assert bench_sentinel.ingest_dir(str(art), str(ours)) == 0


def test_the_sentinel_defaults_to_the_port_s_artifacts(tmp_path, capsys,
                                                       monkeypatch):
    """Without ``--ingest`` and ``--history`` the port's tool reads and
    writes ``build/artifacts/`` of its checkout, never ``benchmarks/``."""
    art = tmp_path / "artifacts"
    art.mkdir()
    monkeypatch.setattr(bench_sentinel, "ARTIFACTS", art)
    monkeypatch.setattr(history, "repo_root", lambda: str(tmp_path))
    (art / "OVERLAP_BENCH_0.json").write_text(json.dumps(
        {"metric": "bucket_step_ms_sync", "value": 10.0, "unit": "ms",
         "timestamp_utc": STAMP}))
    assert bench_sentinel.main([]) == 0
    err = capsys.readouterr().err
    hist = tmp_path / "build" / "artifacts" / "history.jsonl"
    assert f"ingested 1 new records into {hist}" in err
    assert len(hist.read_text().splitlines()) == 1


@pytest.mark.parametrize("tool,marker,stream", [
    ("trace_report", "telemetry smoke ok", "stdout"),
    ("bench_sentinel", "bench sentinel smoke ok", "stdout")])
def test_each_smoke_runs_without_jax(tool, marker, stream):
    code = ("import runpy, sys\n"
            f"sys.argv = ['{tool}', '--smoke']\n"
            "try:\n"
            f"    runpy.run_module('rabit_tpu_torch.tools.{tool}', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'rabit_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert marker in getattr(r, stream)
