"""The port's live plane (``rabit_tpu_torch/telemetry/live.py``,
``prom.py``, ``slo.py``, ``crossrank.py``, the tracker's ``endpoint``
command, poll loop and metrics server, the engines' endpoints) against
the JAX package's:

* the copies on the same inputs: ``render_prometheus`` byte for byte (the
  recorder's counters, histograms, the profile section, extra gauges),
  the registered families and label escaping; the SLO plane's verdicts,
  burn document and gauges; the cross-rank stitcher and the straggler
  snapshot;
* a rank's endpoint (``/metrics``, ``/healthz``, ``/summary``, extra
  routes), its announce over the port tracker's wire, and both engines'
  ``rabit_metrics_port``;
* the tracker with ``metrics_port=0``: it polls three endpoints, names
  the lagging rank on ``/straggler``, serves a ``skew`` digest whose epoch
  bumps only when the election changes, and a tracker without a metrics
  port stays dark;
* end to end on the CPU: three ``TorchEngine`` ranks under the port's
  launcher, rank 2 sleeping before each allreduce, no forced digest --
  the tracker elects rank 2 and every rank adopts the digest at the same
  boundary, every round's result exact.
"""

import json
import os
import socket
import sys
import tempfile
import time
import urllib.error
import urllib.request
from pathlib import Path

import pytest

from rabit_tpu_torch.telemetry import crossrank as tc
from rabit_tpu_torch.telemetry import live as tl
from rabit_tpu_torch.telemetry import prom as tp
from rabit_tpu_torch.telemetry import schema
from rabit_tpu_torch.telemetry import slo as tslo

ROOT = Path(__file__).resolve().parents[1]
LIVE_ENV = ("RABIT_METRICS_PORT", "RABIT_METRICS_POLL_MS",
            "RABIT_TRACKER_URI", "RABIT_TRACKER_PORT", "RABIT_TASK_ID",
            "DMLC_TRACKER_URI", "DMLC_TRACKER_PORT", "DMLC_TASK_ID",
            "RABIT_SLO_AVAILABILITY", "RABIT_SLO_P99_MS",
            "RABIT_SLO_FAILOVER_MS", "RABIT_SLO_SHED_RATE",
            "RABIT_SLO_WARN_BURN", "RABIT_SKEW_ADAPT", "RABIT_SKEW_DIGEST")


@pytest.fixture
def clean(monkeypatch):
    for k in LIVE_ENV:
        monkeypatch.delenv(k, raising=False)
    yield monkeypatch


def _get(port: int, path: str):
    with urllib.request.urlopen(f"http://127.0.0.1:{port}{path}",
                                timeout=5) as resp:
        return resp.status, resp.read().decode()


def _summary(rank: int, count: int = 12, busy: float = 0.5) -> dict:
    """A ``telemetry_summary`` document as a rank serves it: collective
    rows with histograms, a wire row, an adaptive-election row and the
    profile section."""
    doc = schema.make_header("telemetry_summary")
    doc.update({
        "rank": rank, "world_size": 3, "recorded": count + 3, "dropped": 1,
        "capacity": 4096, "enabled": True, "t_base_unix": 1.7e9 + rank,
        "counters": [
            {"name": "engine.allreduce", "op": "sum", "method": "ring",
             "wire": "", "bucket": "<=64KiB", "provenance": "",
             "count": count, "bytes": 4096 * count, "total_s": busy,
             "max_s": busy / count,
             "hist_log2_us": {"10": count - 2, "14": 1, "17": 1}},
            {"name": "wire.quantized", "op": "sum", "method": "ring",
             "wire": "int8:bf16@512", "bucket": "<=4MiB",
             "provenance": "adaptive", "count": 2, "bytes": 1 << 22,
             "total_s": 0.0, "max_s": 0.0},
            {"name": "dispatch.wire_adapted", "op": "", "method": "",
             "wire": "int8", "bucket": "<=4MiB", "provenance": "",
             "count": 3, "bytes": 3 << 20, "total_s": 0.0, "max_s": 0.0},
            {"name": "label\"with\\odd\nchars", "count": 1, "bytes": 0,
             "total_s": 0.25, "max_s": 0.25}],
        "profile": {
            "compile": [{"fn": "build:histogram", "count": 1,
                         "total_s": 1.5, "max_s": 1.5}],
            "jit_cache": [{"fn": "build:histogram", "hits": 4,
                           "misses": 1}],
            "cost": [{"name": "allreduce", "method": "ring", "wire": None,
                      "flops": 1 << 20, "wire_bytes": 3 << 20}],
            "overlap": [{"name": "allreduce", "method": "ring",
                         "count": 2, "exposed_ms": 1.25,
                         "overlapped_ms": 3.5}],
            "device_mem": {"samples": 2, "live_bytes": 1 << 26,
                           "peak_bytes": 1 << 28, "arrays": 40}}})
    return doc


GAUGES = [("rabit_world_epoch", "Tracker epoch.", "gauge", [({}, 3)]),
          ("rabit_skew_offset_ms", "Offsets.", "gauge",
           [({"rank": "0"}, 0.0), ({"rank": "2"}, 26.673)]),
          ("rabit_tracker_polls_total", "Sweeps.", "counter",
           [({}, True)])]


def test_render_prometheus_like_jax():
    from rabit_tpu.telemetry import prom as jp
    sources = [({"rank": str(r)}, _summary(r, 10 + r, 0.5 * r))
               for r in range(3)]
    text = tp.render_prometheus(sources, gauges=GAUGES)
    assert text == jp.render_prometheus(sources, gauges=GAUGES)
    assert tp.render_prometheus([]) == jp.render_prometheus([])
    assert 'rabit_collective_duration_seconds_bucket{rank="2"' in text
    assert tp.METRIC_FAMILIES == jp.METRIC_FAMILIES
    for v in ("plain", 'q"uote', "back\\slash", "new\nline"):
        assert tp.escape_label_value(v) == jp.escape_label_value(v)


def test_render_of_a_live_recorder_like_jax():
    """A real snapshot of the port's recorder through ``build_summary``,
    rendered by both."""
    from rabit_tpu.telemetry import prom as jp
    from rabit_tpu_torch import telemetry
    telemetry.reset(capacity=64, enabled=True)
    try:
        for i in range(5):
            telemetry.record_span("allreduce", 1e-4 * (i + 1), nbytes=4096,
                                  op="sum", method="tree")
        telemetry.count("dispatch.skew_adapted")
        doc = telemetry.build_summary(telemetry.snapshot(), rank=0,
                                      world_size=1)
    finally:
        telemetry.reset(enabled=False)
    src = [({"rank": "0"}, doc)]
    assert tp.render_prometheus(src) == jp.render_prometheus(src)


MEASUREMENTS = [
    {},
    {"availability": 0.999, "p99_ms": 20.0, "failover_ms": 1200.0,
     "shed_rate": 0.1},
    {"availability": 0.90, "p99_ms": 500.0, "failover_ms": 9000.0,
     "shed_rate": 0.9},
    {"availability": 0.96, "p99_ms": 1999.0, "shed_rate": 0.0},
]


@pytest.mark.parametrize("env", [{}, {"RABIT_SLO_P99_MS": "50",
                                      "RABIT_SLO_WARN_BURN": "0.5",
                                      "RABIT_SLO_AVAILABILITY": "0.95"}])
def test_slo_plane_like_jax(clean, env):
    from rabit_tpu.telemetry import prom as jp
    from rabit_tpu.telemetry import slo as jslo
    for k, v in env.items():
        clean.setenv(k, v)
    for overrides in (None, {"p99_ms": 100.0, "shed_rate": 0.5}):
        slos = (tslo.default_slos(overrides), jslo.default_slos(overrides))
        assert [s.doc() for s in slos[0]] == [s.doc() for s in slos[1]]
        for m in MEASUREMENTS:
            got = tslo.evaluate_all(slos[0], m)
            assert got == jslo.evaluate_all(slos[1], m)
            assert tslo.burn_doc(got) == jslo.burn_doc(got)
            assert tslo.gauges(got) == jslo.gauges(got)
            text = tp.render_prometheus([], gauges=tslo.gauges(got))
            assert text == jp.render_prometheus([], gauges=jslo.gauges(got))
    counters = _summary(0)["counters"]
    for names in (tslo.COLLECTIVE_NAMES, None, frozenset({"x"})):
        assert tslo.merged_hist(counters, names) == \
            jslo.merged_hist(counters, names)
    for h in ({}, {3: 1}, {0: 50, 5: 30, 10: 19, 14: 1}):
        for q in (0.5, 0.99, 1.0):
            assert tslo.hist_quantile_us(h, q) == jslo.hist_quantile_us(h, q)
    rows = [{"name": "allreduce", "hist_log2_us": {"10": 99, "14": 1}}]
    assert tslo.p99_ms_from_counters(rows) == jslo.p99_ms_from_counters(rows)
    assert tslo.rank_gauges() == jslo.rank_gauges()   # both recorders quiet
    assert tslo.main(["--smoke"]) == 0


def _round_doc(rank: int, base: float, offsets: list, hlc: bool = False,
               kind: str = "snapshot") -> dict:
    """A rank's round-carrying artifact: ``engine.allreduce`` rounds and
    the three hier phases, arriving ``offsets[i]`` seconds after the
    round's start, one adapted round, one async round."""
    spans = []
    for i, off in enumerate(offsets):
        attrs = {"round": i}
        if i == 1:
            attrs["adapted"] = "rotate@2"
        if i == 2:
            attrs["wire_exposed_ms"] = 0.5
        if hlc:
            attrs["hlc"] = {"ms": int((base + i + off) * 1e3), "c": rank,
                            "node": f"r{rank}"}
        spans.append({"name": "engine.allreduce", "t0": i + off,
                      "dur": 0.01 + 0.001 * rank, "attrs": attrs})
        spans.append({"name": "hier.inter", "t0": i + off + 0.02,
                      "dur": 0.002, "attrs": {"round": i, "phase": "inter"}})
    if kind == "snapshot":
        return {"rank": rank, "t_base_unix": base, "spans": spans}
    doc = schema.make_header("telemetry_trace")
    doc.update({"t_base_unix": base, "traceEvents": [
        {"ph": "X", "name": s["name"], "pid": rank, "ts": s["t0"] * 1e6,
         "dur": s["dur"] * 1e6, "args": s["attrs"]} for s in spans]})
    return doc


@pytest.mark.parametrize("variant", ["wall", "hlc", "trace", "skewed_anchor"])
def test_crossrank_stitching_like_jax(variant):
    from rabit_tpu.telemetry import crossrank as jc
    base = 1.7e9
    lag = [[0.0, 0.001, 0.0, 0.002], [0.002, 0.0, 0.001, 0.0],
           [0.05, 0.06, 0.04, 0.05]]
    docs = []
    for r in range(3):
        anchor = base + (5.0 if variant == "skewed_anchor" and r == 2 else 0)
        docs.append(_round_doc(r, anchor, lag[r], hlc=variant == "hlc",
                               kind="trace" if variant == "trace"
                               else "snapshot"))
    docs.append({"no": "rounds"})
    rounds = tc.stitch_documents(docs)
    assert rounds == jc.stitch_documents(docs)
    assert tc.skew_table(rounds) == jc.skew_table(rounds)
    assert tc.round_gap_s(rounds) == jc.round_gap_s(rounds)
    assert tc.anchor_warning(docs, rounds) == jc.anchor_warning(docs, rounds)
    per_rank = dict(tc.extract_rounds(d) for d in docs[:3])
    assert tc.stitch_rounds(per_rank) == jc.stitch_rounds(per_rank)
    if variant == "wall":
        assert {r["straggler_rank"] for r in rounds} == {2}


def test_straggler_snapshot_like_jax():
    from rabit_tpu.telemetry import crossrank as jc
    for sums in ({str(r): _summary(r, 12, b) for r, b in
                  enumerate((3.0, 2.8, 0.3))},
                 {str(r): _summary(r, 12 - (r == 1), 0.2)
                  for r in range(3)},
                 {"0": _summary(0), "x": {"schema": "other"}}, {}):
        assert tc.straggler_snapshot(sums) == jc.straggler_snapshot(sums)
    assert tc.BUSY_SKEW_SIGNAL_S == jc.BUSY_SKEW_SIGNAL_S == 1.0


def test_rank_endpoint_routes(clean):
    from rabit_tpu_torch import telemetry
    telemetry.reset(capacity=64, enabled=True)
    srv = tl.start_rank_server(0, rank=1, world=3, gauges_fn=lambda: GAUGES)
    try:
        telemetry.record_span("allreduce", 0.002, nbytes=64, op="sum",
                              method="tree")
        code, text = _get(srv.port, "/metrics")
        assert code == 200
        assert 'rabit_collective_total{rank="1",name="allreduce"' in text
        assert "rabit_skew_offset_ms" in text
        doc = json.loads(_get(srv.port, "/healthz")[1])
        assert doc["ok"] and doc["rank"] == 1 and doc["world"] == 3
        assert doc["role"] == "worker" and doc["pid"] == os.getpid()
        summary = json.loads(_get(srv.port, "/summary?x=1")[1])
        assert schema.matches(summary, "telemetry_summary")
        assert summary["rank"] == 1 and summary["counters"]
        assert tl.scrape_json("127.0.0.1", srv.port) == summary
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.port, "/nope")
        assert e.value.code == 404
    finally:
        srv.stop()
        telemetry.reset(enabled=False)
    assert tl.scrape_json("127.0.0.1", srv.port, timeout=0.5) is None

    def boom():
        raise RuntimeError("no")
    srv = tl.MetricsServer(port=0, routes={"/ok": lambda: {"a": 1},
                                           "/boom": boom}).start()
    try:
        assert json.loads(_get(srv.port, "/ok")[1]) == {"a": 1}
        with pytest.raises(urllib.error.HTTPError) as e:
            _get(srv.port, "/boom")
        assert e.value.code == 500
        with pytest.raises(urllib.error.HTTPError):
            _get(srv.port, "/summary")   # no summary_fn: not found
    finally:
        srv.stop()


@pytest.mark.parametrize("raw", [None, "", "10", "200", "2500", "x"])
def test_poll_interval_like_jax(clean, raw):
    from rabit_tpu.telemetry import live as jl
    if raw is not None:
        clean.setenv("RABIT_METRICS_POLL_MS", raw)
    assert tl.poll_interval_s() == jl.poll_interval_s()
    cfg = {"rabit_metrics_poll_ms": "300"}
    assert tl.poll_interval_s(cfg) == jl.poll_interval_s(cfg) == 0.3


def test_announce_endpoint_over_the_port_tracker(clean):
    from rabit_tpu_torch.tracker.tracker import Tracker
    assert not tl.announce_endpoint("127.0.0.1", 1234, 0)  # no tracker
    tr = Tracker(2, ready_timeout=5.0).start()
    try:
        clean.setenv("RABIT_TRACKER_URI", tr.host)
        clean.setenv("RABIT_TRACKER_PORT", str(tr.port))
        clean.setenv("RABIT_TASK_ID", "7")
        assert tl.announce_endpoint("127.0.0.1", 4321, 1)
        assert tr.live_stats()["endpoints"] == {
            "7": {"host": "127.0.0.1", "port": 4321, "rank": 1}}
        with tr._lock:
            tr._endpoints.clear()
        assert tl.reannounce()
        assert tr.live_stats()["endpoints"]["7"]["port"] == 4321
        # the dark tracker keeps the endpoint but polls nothing
        time.sleep(0.3)
        stats = tr.live_stats()
        assert stats["metrics_addr"] is None and stats["polls"] == 0
        assert stats["skew"] == {} and stats["straggler"] is None
        from rabit_tpu_torch.telemetry import skew
        assert skew.fetch_skew(tr.host, tr.port) is None
    finally:
        tr.stop()


class _Rank:
    """An in-process rank endpoint serving a summary that the test moves."""

    def __init__(self, rank: int):
        self.rank = rank
        self.doc = _summary(rank, 12, 0.5)
        self.srv = tl.MetricsServer(
            port=0, summary_fn=lambda: self.doc,
            identity={"rank": rank, "role": "worker"}).start()

    def set(self, count: int, busy: float) -> None:
        self.doc = _summary(self.rank, count, busy)


def _wait(cond, timeout: float = 10.0) -> bool:
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        if cond():
            return True
        time.sleep(0.05)
    return cond()


def test_tracker_polls_endpoints_and_serves_the_election(clean):
    from rabit_tpu_torch.telemetry import skew
    from rabit_tpu_torch.tracker.tracker import Tracker
    clean.setenv("RABIT_METRICS_POLL_MS", "50")
    ranks = [_Rank(r) for r in range(3)]
    tr = Tracker(3, ready_timeout=5.0, metrics_port=0).start()
    try:
        mport = tr.live_stats()["metrics_addr"][1]
        clean.setenv("RABIT_TRACKER_URI", tr.host)
        clean.setenv("RABIT_TRACKER_PORT", str(tr.port))
        for rk in ranks:
            clean.setenv("RABIT_TASK_ID", f"t{rk.rank}")
            assert tl.announce_endpoint("127.0.0.1", rk.srv.port, rk.rank)
        # rank 2 waits least inside its collectives: the fleet waits on it
        for rk, busy in zip(ranks, (3.0, 2.9, 0.4)):
            rk.set(12, busy)
        assert _wait(lambda: (tr.live_stats()["straggler"] or {}).get(
            "lagging_rank") == 2)
        straggler = json.loads(_get(mport, "/straggler")[1])
        assert straggler["lagging_rank"] == 2 and straggler["signal"]
        assert _wait(lambda: tr.live_stats()["skew"].get("laggard") == 2)
        first = skew.fetch_skew(tr.host, tr.port)
        assert first["laggard"] == 2 and first["epoch"] >= 1
        # the election holds: more sweeps, the same epoch
        polls = tr.live_stats()["polls"]
        assert _wait(lambda: tr.live_stats()["polls"] >= polls + 5)
        assert skew.fetch_skew(tr.host, tr.port)["epoch"] == first["epoch"]
        # a tie: the digest retracts the laggard, and the epoch bumps
        for rk in ranks:
            rk.set(12, 0.5)
        assert _wait(lambda: tr.live_stats()["skew"].get("laggard") is None)
        tie = skew.fetch_skew(tr.host, tr.port)
        assert tie["epoch"] == first["epoch"] + 1
        metrics = _get(mport, "/metrics")[1]
        for fam in ("rabit_tracker_endpoints 3", "rabit_skew_epoch",
                    'rabit_collective_total{rank="2"',
                    "rabit_tracker_polls_total"):
            assert fam in metrics, fam
        health = json.loads(_get(mport, "/healthz")[1])
        assert health["role"] == "tracker" and health["nworkers"] == 3
        assert json.loads(_get(mport, "/slo")[1])["worst"] == "no_data"
        fleet = json.loads(_get(mport, "/summary")[1])
        assert sorted(fleet["ranks"]) == [0, 1, 2]
    finally:
        tr.stop()
        for rk in ranks:
            rk.srv.stop()


def test_engines_serve_their_endpoint(clean):
    import rabit_tpu_torch
    from rabit_tpu_torch.engine.torch_engine import TorchEngine
    e = TorchEngine()
    e.init(["rabit_device=cpu", "rabit_metrics_port=0"])
    try:
        port = e._metrics_server.port
        doc = json.loads(_get(port, "/healthz")[1])
        assert doc["rank"] == 0 and doc["world"] == 1
        assert "rabit_slo_state" in _get(port, "/metrics")[1]
    finally:
        e.shutdown()
    assert e._metrics_server is None
    assert tl.scrape_json("127.0.0.1", port, "/healthz", 0.5) is None
    rabit_tpu_torch.finalize()
    rabit_tpu_torch.init(["rabit_metrics_port=0"], engine="robust")
    try:
        srv = rabit_tpu_torch._engine._metrics_server
        text = _get(srv.port, "/metrics")[1]
        assert "rabit_world_epoch" in text and "rabit_slo_objective" in text
    finally:
        rabit_tpu_torch.finalize()


def test_launcher_tracker_elects_a_lagging_torch_engine_rank(clean):
    """Three ``TorchEngine`` ranks over gloo under the port's launcher with
    the tracker's live plane on; rank 2 sleeps 80 ms before each of 40
    allreduces; no forced digest. The tracker names rank 2 and serves its
    digest; every rank counts boundaries and adapted dispatches and
    adopts at the same round; every result exact and equal across
    ranks."""
    from rabit_tpu_torch.tracker.launch import launch
    clean.setenv("RABIT_METRICS_POLL_MS", "200")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    cmd = [sys.executable, "-m", "rabit_tpu_torch.tools.skew_round_worker",
           "--mode", "tracker", "rabit_engine=torch",
           f"rabit_coordinator=127.0.0.1:{port}", "rabit_num_processes=3",
           "rabit_device=cpu", "rabit_telemetry=1", "rabit_metrics_port=0",
           "rabit_skew_adapt=1", "rabit_skew_poll_ms=100",
           "rabit_skew_sync_rounds=4"]
    stats = {}
    with tempfile.TemporaryDirectory() as tmp:
        launch(3, cmd, max_attempts=0, timeout=120, quiet=True, stats=stats,
               env={"RABIT_RESULT_DIR": tmp, "PAYLOAD": "65536",
                    "N_ROUNDS": "40", "PYTHONPATH": os.pathsep.join(
                        filter(None, [str(ROOT),
                                      os.environ.get("PYTHONPATH")]))},
               metrics_port=0)
        docs = [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(3)]
    live = stats["live"]
    assert live["straggler"]["lagging_rank"] == 2, live["straggler"]
    assert live["skew"]["laggard"] == 2 and live["skew"]["epoch"] >= 1
    adopted = {d["adopted_round"] for d in docs}
    assert len(adopted) == 1 and None not in adopted, adopted
    for d in docs:
        assert d["lag_rank"] == 2 and d["exact"] and d["crc_agree"], d
        assert d["counts"]["dispatch.skew_sync"] > 0, d["counts"]
        assert d["counts"]["dispatch.skew_adapted"] > 0, d["counts"]
        assert d["tags"] == docs[0]["tags"]
        assert d["tags"][-1].endswith("@2"), d["tags"][-1]
