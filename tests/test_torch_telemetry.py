"""The port's recorder plane (``rabit_tpu_torch/telemetry/``) against the
JAX package's (``rabit_tpu/telemetry/``):

* the copies: one call sequence through both packages, with
  ``time.perf_counter`` and ``time.time`` replaced alike by a counter,
  gives equal recorder snapshots, summaries, Chrome traces, fleet merges
  and fleet tables (the profile section's device memory aside: see
  ``tests/test_torch_profile.py``);
* the analytic cost model, number for number, for every method x wire x
  world of the table below;
* the export at shutdown: both files, with the JAX package's schema ids,
  and ``tools/trace_report.py`` (the JAX package's renderer) renders the
  port's summary;
* the port's tracker: the ``metrics`` command at world 2, the merged doc
  equal to ``rabit_tpu.telemetry.aggregate.merge_summaries`` of the same
  summaries, and the fleet table printed once at the end of the run;
* the span contract: ``tools/lint.py``'s rule T001 over the port's entry
  points (``SPAN_REQUIRED`` set to the port's names in the test), and a
  copy with one span taken out, which the rule flags."""

import importlib.util
import itertools
import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import pytest

import rabit_tpu.telemetry as jt
import rabit_tpu.telemetry.clock as jclock
import rabit_tpu.telemetry.events as jevents
import rabit_tpu.telemetry.profile as jprofile
import rabit_tpu_torch.telemetry as pt
from rabit_tpu_torch.telemetry import clock as pclock
from rabit_tpu_torch.telemetry import events as pevents
from rabit_tpu_torch.telemetry import profile as pprofile
from rabit_tpu_torch.tracker.tracker import Tracker

ROOT = Path(__file__).resolve().parents[1]
PKG = {"jax": (jt, jprofile, jevents, jclock),
       "port": (pt, pprofile, pevents, pclock)}


@pytest.fixture(autouse=True)
def _planes_off():
    """Every plane off after each test, in both packages (the processes
    share the recorders with other tests)."""
    yield
    for tel, prof, ev, clk in PKG.values():
        tel.reset(enabled=False)
        prof.reset(enabled=False)
        prof.stop_poller()
        ev.reset(enabled=False)
        clk.reset(enabled=False)


class _Clock:
    """A deterministic stand-in for ``time.perf_counter`` / ``time.time``:
    each read advances by a fixed step."""

    def __init__(self, t0: float, step: float):
        self.t, self.step = t0, step

    def __call__(self) -> float:
        self.t += self.step
        return self.t


def _drive(which: str, monkeypatch) -> dict:
    """One call sequence through one package's planes; returns what the
    exporters and the aggregator make of it."""
    tel, prof, ev, clk = PKG[which]
    monkeypatch.setattr(time, "perf_counter", _Clock(100.0, 0.00025))
    monkeypatch.setattr(time, "time", _Clock(1.7e9, 0.001))
    tel.reset(capacity=6, enabled=True)
    prof.reset(enabled=True)
    ev.reset(capacity=4, enabled=True)
    clk.reset("rank1", enabled=True)
    for i in range(3):
        with tel.span("allreduce", nbytes=4096 << i, op="sum",
                      method="ring", wire="bf16" if i else None,
                      round=tel.collective_round("allreduce"), phase="x"):
            pass
    with tel.span("broadcast", nbytes=12, method="psum_mask", root=1):
        pass
    tel.record_span("allreduce", 0.0125, nbytes=1 << 22, op="sum",
                    method="tree", provenance="engine", round=7, **{
                        "async": 1, "wire_exposed_ms": 1.5})
    tel.count("async.issued", nbytes=64, op="max", method="tree")
    tel.count("recovery.retry", op="native_round", provenance="recovery")
    tel.record_dispatch(1 << 20, 4, "sum", "ring", "int8", "table")
    for i in range(4):   # overflows the ring of 6
        tel.record_span("hier.inter", 0.001 * i, nbytes=1 << 12,
                        method="swing", round=i + 1)
    ev.emit("recovery.epoch_advance", "rank 1 re-forming", rank=1)
    ev.emit("recovery.retry", "retries", rank=1, count=3)
    with pytest.raises(ValueError, match="EVENT_KINDS"):
        ev.emit("no.such.kind")  # noqa: T005 - negative test
    prof.record_cost("allreduce", "ring", "int8:bf16", 1 << 20, 4, 4)
    prof.record_cost("hier.inter", "ring", None, 4096, 4, 2, phase="rs",
                     group_size=2)
    prof.record_overlap("allreduce", "ring", 0.002, 0.003)
    prof.cache_event("dispatch_table", hit=False)
    prof.cache_event("dispatch_table", hit=True)
    prof.record_compile("build:histogram", 1.25)
    snap = tel.snapshot()
    summary = tel.build_summary(snap, rank=1, world_size=2)
    other = tel.build_summary(snap, rank=0, world_size=2)
    fleet = tel.merge_summaries({"0": other, "1": summary,
                                 "x": {"schema": "someone_else/v1"}})
    out = {"snapshot": snap, "stats": tel.stats(), "summary": summary,
           "trace": tel.build_chrome_trace(snap, rank=1), "fleet": fleet,
           "table": tel.format_fleet_table(fleet)}
    for doc in (summary, fleet, out["trace"]):
        assert doc.pop("timestamp_utc")
    # device memory is the one section the port samples otherwise
    assert summary["profile"].pop("device_mem")
    return out


def test_the_copies_equal_rabit_tpu_on_one_call_sequence(monkeypatch):
    want = _drive("jax", monkeypatch)
    got = _drive("port", monkeypatch)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    # the sequence reached every section, with the JAX package's ids
    assert got["stats"]["dropped"] == 3 and len(got["snapshot"]["spans"]) == 6
    assert got["summary"]["schema"] == "rabit_tpu.telemetry_summary/v1"
    assert got["trace"]["schema"] == "rabit_tpu.telemetry_trace/v1"
    assert got["fleet"]["schema"] == "rabit_tpu.telemetry_fleet/v1"
    assert got["fleet"]["num_ranks"] == 2
    recs = got["summary"]["events"]["records"]
    assert [r["schema"] for r in recs] == ["rabit_tpu.fleet_event/v1"] * 2
    assert got["summary"]["hlc"]["node"] == "rank1"
    assert pevents.EVENT_KINDS == jevents.EVENT_KINDS
    assert "hier.inter" in got["table"]


def test_disabled_planes_record_nothing_and_share_one_null_span():
    for tel, prof, ev, clk in PKG.values():
        tel.reset(enabled=False)
        prof.reset(enabled=False)
        ev.reset(enabled=False)
        assert tel.span("a") is tel.span("b") is tel.NULL_SPAN
        assert tel.collective_round("allreduce") == 0
        tel.count("x")
        tel.record_span("x", 1.0)
        assert prof.record_cost("allreduce", "ring", None, 8, 4, 2) is None
        assert ev.emit("recovery.retry") is None
        assert tel.stats()["recorded"] == 0
        assert tel.snapshot()["counters"] == []
    assert pt.trace_annotation("rabit_x") is pt.trace_annotation("rabit_y")


_METHODS = ("tree", "ring", "bidir", "swing", "hier", "psum", "psum_mask")
_WIRES = ("none", "bf16", "int8", "int8:bf16", "bf16@512")


@pytest.mark.parametrize("method,wire,p", list(itertools.product(
    _METHODS, _WIRES, (1, 2, 3, 4, 8))))
def test_collective_cost_equals_rabit_tpu(method, wire, p):
    for n, itemsize, phase, group in itertools.product(
            (0, 1, 1000, 4096, 1 << 21), (2, 4, 8), (None, "rs", "ag"),
            (None, 2, 4)):
        got = pprofile.collective_cost(method, n, itemsize, p, wire,
                                       phase=phase, group_size=group)
        want = jprofile.collective_cost(method, n, itemsize, p, wire,
                                        phase=phase, group_size=group)
        assert got == want, (n, itemsize, phase, group)


def test_export_at_shutdown_writes_both_files_and_trace_report_reads_them(
        tmp_path, monkeypatch):
    monkeypatch.setenv("RABIT_TELEMETRY_EXPORT", str(tmp_path))
    pt.reset(enabled=True)
    pprofile.reset(enabled=True)
    for i in range(3):
        with pt.span("allreduce", nbytes=4096, op="sum", method="ring",
                     round=pt.collective_round("allreduce")):
            pass
    pprofile.record_cost("allreduce", "ring", None, 1024, 4, 2)
    paths = pt.export_at_shutdown(rank=1, world_size=2)
    assert [Path(p).name for p in paths] == [
        "telemetry_summary_rank1.json", "telemetry_trace_rank1.json"]
    summary, trace = (json.loads(Path(p).read_text()) for p in paths)
    assert jt.matches(summary, "telemetry_summary")
    assert jt.matches(trace, "telemetry_trace")
    assert summary["profile"]["cost"][0]["wire_bytes"] == 4096
    assert [e["args"]["round"] for e in trace["traceEvents"][1:]] == [1, 2, 3]
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, str(ROOT / "tools" / "trace_report.py"),
                        paths[0]], capture_output=True, text=True,
                       timeout=120, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "allreduce" in r.stdout and "|" in r.stdout
    pt.reset(enabled=False)
    assert pt.export_at_shutdown(rank=1) == []


def _ship(tracker, task: str, rank: int, nbytes: int, monkeypatch) -> bool:
    """This process's recorder, refilled as rank ``rank`` would fill it,
    shipped to ``tracker`` under task id ``task``."""
    monkeypatch.setenv("RABIT_TRACKER_URI", tracker.host)
    monkeypatch.setenv("RABIT_TRACKER_PORT", str(tracker.port))
    monkeypatch.setenv("RABIT_TASK_ID", task)
    pt.reset(enabled=True)
    for _ in range(3):
        with pt.span("engine.allreduce", nbytes=nbytes, op="sum",
                     method="auto",
                     round=pt.collective_round("engine.allreduce")):
            pass
    pt.count("recovery.link_reset", op="dataplane", provenance="recovery")
    return pt.ship_to_tracker(rank=rank, world_size=2)


def test_tracker_merges_the_shipped_summaries_and_prints_the_table_once(
        monkeypatch, capsys):
    tr = Tracker(2).start()
    try:
        assert _ship(tr, "0", 0, 8192, monkeypatch)
        assert _ship(tr, "1", 1, 8192, monkeypatch)
        fleet = tr.merged_metrics()
        docs = dict(tr._metrics)
        assert set(docs) == {"0", "1"}
        want = jt.merge_summaries(docs)
        for d in (fleet, want):
            d.pop("timestamp_utc")
        assert fleet == want
        rows = {r["name"]: r for r in fleet["counters"]}
        assert rows["engine.allreduce"]["count"] == 6
        assert rows["recovery.link_reset"]["provenance"] == "recovery"
        tr.print_fleet_metrics()
        tr.print_fleet_metrics()
        tables = [m for m in tr.messages if m.startswith("telemetry:")]
        assert len(tables) == 1
        assert tables[0].startswith("telemetry: 2 rank(s), 6 span(s)")
        assert "engine.allreduce" in capsys.readouterr().out
    finally:
        tr.stop()
    # without a tracker, shipping is a no-op that says so, never a raise
    monkeypatch.delenv("RABIT_TRACKER_URI")
    assert not pt.ship_to_tracker(rank=0, world_size=2)


def _load_lint():
    spec = importlib.util.spec_from_file_location(
        "rabit_lint", str(ROOT / "tools" / "lint.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the port's entry points that must hold a span or a trace annotation
# (the JAX package's SPAN_REQUIRED, in the port's names: ``allreduce`` is
# ``device_allreduce``; the schedules' labels live in ``_annotated`` and
# the hier phases' in ``_labelled_phase``)
PORT_SPAN_REQUIRED = {
    "rabit_tpu_torch/parallel/collectives.py": {
        "allreduce", "device_allreduce_tree", "device_broadcast",
        "device_reduce_scatter", "device_allgather",
        "device_hier_allreduce", "_annotated", "_labelled_phase",
        "device_allreduce_async", "bucket_allreduce_async",
        "device_hier_allreduce_async", "grad_bucket_allreduce_async"},
    "rabit_tpu_torch/engine/base.py": {"reduce_scatter", "allgather"},
    "rabit_tpu_torch/engine/torch_engine.py": {
        "allreduce", "broadcast", "reduce_scatter", "allgather",
        "allreduce_async"},
    "rabit_tpu_torch/engine/native.py": {"allreduce", "broadcast"},
    "rabit_tpu_torch/engine/dataplane.py": {"_allreduce"},
}


def test_lint_span_contract_holds_on_the_port(monkeypatch):
    lint = _load_lint()
    for rel, names in PORT_SPAN_REQUIRED.items():
        monkeypatch.setitem(lint.SPAN_REQUIRED, rel, names)
        issues = lint.check_file(str(ROOT / rel))
        assert not [i for i in issues if i[2] == "T001"], issues


def test_lint_flags_a_port_entry_point_without_its_span(tmp_path,
                                                        monkeypatch):
    lint = _load_lint()
    src = (ROOT / "rabit_tpu_torch/parallel/collectives.py").read_text()
    cut = src.replace('sp = telemetry.span("broadcast"',
                      'sp = dict(name="broadcast"', 1).replace(
        'telemetry.trace_annotation("rabit_broadcast")',
        'contextlib.nullcontext()', 1)
    assert cut.count("dict(name=") == 1 and "rabit_broadcast" not in cut
    bare = tmp_path / "collectives.py"
    bare.write_text(cut)
    rel = os.path.relpath(str(bare), lint.REPO)
    monkeypatch.setitem(lint.SPAN_REQUIRED, rel,
                        PORT_SPAN_REQUIRED[
                            "rabit_tpu_torch/parallel/collectives.py"])
    flagged = [i for i in lint.check_file(str(bare)) if i[2] == "T001"]
    assert len(flagged) == 1 and "device_broadcast" in flagged[0][3]
    shutil.rmtree(tmp_path)
