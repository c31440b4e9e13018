"""The port's ``capture_status --live`` (``rabit_tpu_torch/tools/capture_status.py``)
against the JAX tool's (``tools/capture_status.py``): both scrape the same
stdlib HTTP stub, which serves every route in each variant (a rank's
endpoint, a tracker's gauges, ``/straggler`` lagging, tie and none,
``/jobs`` with a queue, ``/slo``, ``/incidents`` with two entries, an
unhealthy and a malformed endpoint), and must give equal documents, the
timestamp aside. Then the exit codes, and one scrape of a live port
tracker."""

import http.server
import importlib.util
import json
import os
import socket
import sys
import threading

import pytest

from rabit_tpu_torch.tools import capture_status as port_cs

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

EXPO = "text/plain; version=0.0.4; charset=utf-8"
RANK_METRICS = (
    "# HELP rabit_collective_total Collectives by name.\n"
    "# TYPE rabit_collective_total counter\n"
    'rabit_collective_total{name="engine.allreduce"} 12\n'
    'rabit_collective_total{name="engine.broadcast"} 3\n'
    "# TYPE rabit_up gauge\n"
    "rabit_up 1\n")
TRACKER_METRICS = (
    "# TYPE rabit_tracker_open_conns gauge\n"
    "rabit_tracker_open_conns 7\n"
    "# TYPE rabit_tracker_loop_lag_ms gauge\n"
    "rabit_tracker_loop_lag_ms 0.25\n"
    "# TYPE rabit_wal_snapshot_seq gauge\n"
    "rabit_wal_snapshot_seq 41\n"
    "# TYPE rabit_sched_preemptions_total counter\n"
    'rabit_sched_preemptions_total{job="a"} 2\n'
    'rabit_sched_preemptions_total{job="b"} 1\n')
JOBS = {"multi_job": True,
        "jobs": [{"job": "a", "status": "live", "world": 2, "epoch": 3,
                  "quarantined": 0},
                 {"job": "b", "status": "forming", "world": 0, "epoch": 0,
                  "quarantined": 1},
                 {"status": "nameless"}],
        "queue": [{"job": "c"}, {"job": "d"}],
        "queued_total": 5, "shed_total": 2}
SLO = {"worst": "warn", "slos": [
    {"slo": "availability", "state": "ok", "value": 0.999, "burn": 0.1},
    {"slo": "p99_ms", "state": "warn", "value": 80.0, "burn": 0.8},
    {"slo": "failover_ms", "state": "no_data", "value": None,
     "burn": None}]}
INCIDENTS = {"open": [{"id": "inc-2"}], "open_count": 1, "worst": "critical",
             "recent": [{"id": "inc-1", "severity": "warn",
                         "summary": "p99_ms warn <- chaos.reset"},
                        {"id": "inc-2", "severity": "critical",
                         "summary": "failover_ms violating <- "
                                    "chaos.tracker_kill"}]}
STRAGGLER = {
    "lagging": {"signal": True, "lagging_rank": 2, "lag_collectives": 5,
                "busy_skew_s": 0.4},
    "tie": {"signal": False, "candidate_rank": 1, "busy_skew_s": 0.01},
    "none": {"signal": False},
}


def _routes(kind):
    """The routes of one stub variant: path -> (content type, body)."""
    health = ("application/json", json.dumps({"ok": True, "rank": 0}))
    if kind == "rank":
        return {"/healthz": health, "/metrics": (EXPO, RANK_METRICS)}
    if kind == "unhealthy":
        return {"/healthz": ("application/json", json.dumps({"ok": False})),
                "/metrics": (EXPO, RANK_METRICS)}
    if kind == "bad_exposition":
        return {"/healthz": health,
                "/metrics": ("text/plain", "rabit_collective_total 3\n")}
    if kind == "no_metrics":
        return {"/healthz": health}
    # a tracker: its gauges and every optional route
    strag = kind.split("_", 1)[1]
    return {"/healthz": ("application/json", json.dumps({"ok": True})),
            "/metrics": (EXPO, TRACKER_METRICS),
            "/straggler": ("application/json",
                           json.dumps(STRAGGLER[strag])),
            "/jobs": ("application/json", json.dumps(JOBS)),
            "/slo": ("application/json", json.dumps(SLO)),
            "/incidents": ("application/json", json.dumps(INCIDENTS))}


class _Stub:
    def __init__(self, routes):
        table = routes

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):
                hit = table.get(self.path)
                if hit is None:
                    self.send_error(404)
                    return
                body = hit[1].encode()
                self.send_response(200)
                self.send_header("Content-Type", hit[0])
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *a):
                pass

        self.srv = http.server.ThreadingHTTPServer(("127.0.0.1", 0),
                                                   Handler)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.target = f"127.0.0.1:{self.srv.server_address[1]}"

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


@pytest.fixture(scope="module")
def jax_cs():
    spec = importlib.util.spec_from_file_location(
        "capture_status", os.path.join(ROOT, "tools", "capture_status.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _strip(doc):
    return {k: v for k, v in doc.items() if k != "timestamp_utc"}


def _both(jax_cs, target):
    jdoc, jok = jax_cs.live_status(target)
    pdoc, pok = port_cs.live_status(target)
    assert pdoc["schema"] == "rabit_tpu.live_status/v1"
    assert pok == jok
    assert _strip(pdoc) == _strip(jdoc)
    return pdoc, pok


@pytest.mark.parametrize("kind", ["rank", "tracker_lagging", "tracker_tie",
                                  "tracker_none", "unhealthy",
                                  "bad_exposition", "no_metrics"])
def test_live_status_equals_jax_on_every_route(jax_cs, kind):
    stub = _Stub(_routes(kind))
    try:
        doc, ok = _both(jax_cs, stub.target)
    finally:
        stub.close()
    if kind == "rank":
        assert ok and doc["collectives_total"] == 15 and doc["samples"] == 3
        assert "straggler" not in doc and "jobs" not in doc
    elif kind.startswith("tracker"):
        assert ok and doc["open_conns"] == 7 and doc["loop_lag_ms"] == 0.25
        assert doc["wal_snapshot_seq"] == 41
        assert doc["sched_preemptions_total"] == 3
        assert doc["straggler"]["verdict"] == kind.split("_", 1)[1]
        assert set(doc["jobs"]) == {"a", "b"}
        assert doc["admission"] == {"queue_depth": 2, "queued_total": 5,
                                    "shed_total": 2}
        assert doc["slo"]["worst"] == "warn"
        assert doc["incidents"]["newest"].startswith("inc-2 [critical]")
    else:
        assert not ok


def _free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("target", ["unreachable", "127.0.0.1:notaport",
                                    "noport"])
def test_bad_targets_exit_1_in_both(jax_cs, monkeypatch, capsys, target):
    if target == "unreachable":
        target = f"127.0.0.1:{_free_port()}"
    monkeypatch.setattr(sys, "argv", ["capture_status", "--live", target])
    with pytest.raises(SystemExit) as e:
        jax_cs.main()
    assert e.value.code == 1
    jdoc = json.loads(capsys.readouterr().out)
    assert port_cs.main(["--live", target]) == 1
    pdoc = json.loads(capsys.readouterr().out)
    assert _strip(pdoc) == _strip(jdoc)
    assert pdoc["ok"] is False and pdoc["error"]


@pytest.mark.parametrize("argv", [["--have", "kernel_hw"], ["--json"], []])
def test_on_disk_capture_set_is_refused(capsys, argv):
    assert port_cs.main(argv) == 2
    assert "not portable" in capsys.readouterr().err


def test_scrapes_a_live_port_tracker(jax_cs):
    from rabit_tpu_torch.tracker.tracker import Tracker
    tr = Tracker(2, metrics_port=0).start()
    try:
        host, port = tr.live_stats()["metrics_addr"]
        target = f"{host}:{port}"
        pdoc, pok = port_cs.live_status(target)
        jdoc, jok = jax_cs.live_status(target)
    finally:
        tr.stop()
    assert pok and jok and pdoc["exposition_ok"]
    # the gauges move between two scrapes; the fields present do not
    assert set(_strip(pdoc)) == set(_strip(jdoc))
    assert {"open_conns", "loop_lag_ms", "straggler"} <= set(pdoc)
    assert pdoc["straggler"]["verdict"] == "none"
