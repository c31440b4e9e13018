"""``python -m rabit_tpu_torch.telemetry`` -- observability self-checks,
the port's copy of ``python -m rabit_tpu.telemetry``.

``--smoke`` exercises the live plane end to end in one process, on the
CPU, no cluster and no torch collective: record spans with round ids,
serve them over a real HTTP endpoint, scrape and validate the
Prometheus exposition, then round-trip a flight-recorder bundle and
stitch two synthetic ranks. A broken endpoint fails here fast, before
any cluster run would hang on a poller.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import urllib.error
import urllib.request


def _get(host: str, port: int, path: str):
    with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                timeout=5.0) as resp:
        return resp.headers.get("Content-Type", ""), resp.read().decode()


def _smoke() -> int:
    from . import collective_round, record_span, reset
    from .flight import FlightRecorder, note, recent_events
    from .live import MetricsServer, start_rank_server
    from .schema import matches
    from . import crossrank

    reset(enabled=True)
    for i in range(3):
        record_span("engine.allreduce", 0.001 * (i + 1), nbytes=1 << 20,
                    op="sum", method="ring",
                    round=collective_round("engine.allreduce"))
    record_span("engine.broadcast", 0.002, nbytes=4096,
                round=collective_round("engine.broadcast"))

    srv = start_rank_server(0, rank=0, world=1)
    try:
        ctype, text = _get(srv.host, srv.port, "/metrics")
        assert "version=0.0.4" in ctype, f"bad content type: {ctype}"
        for needle in (
                "# TYPE rabit_collective_total counter",
                'rabit_collective_total{',
                'name="engine.allreduce"',
                "# TYPE rabit_collective_duration_seconds histogram",
                'le="+Inf"',
                'rabit_telemetry_recorded_total{rank="0"} 4'):
            assert needle in text, f"missing {needle!r} in /metrics"
        _, health = _get(srv.host, srv.port, "/healthz")
        hdoc = json.loads(health)
        assert hdoc.get("ok") is True and hdoc.get("rank") == 0, hdoc
        _, summary = _get(srv.host, srv.port, "/summary")
        sdoc = json.loads(summary)
        assert matches(sdoc, "telemetry_summary"), sdoc.get("schema")
        assert sdoc["recorded"] == 4, sdoc["recorded"]
    finally:
        srv.stop()

    # a 404 must not wedge the server, and extra routes must serve
    srv2 = MetricsServer(sources_fn=lambda: [],
                         routes={"/extra": lambda: {"x": 1}}).start()
    try:
        try:
            _get(srv2.host, srv2.port, "/nope")
            raise AssertionError("404 path returned 200")
        except urllib.error.HTTPError as e:
            assert e.code == 404, e.code
        _, extra = _get(srv2.host, srv2.port, "/extra")
        assert json.loads(extra) == {"x": 1}
    finally:
        srv2.stop()

    # flight-recorder round-trip: dump, reload, stitchable
    with tempfile.TemporaryDirectory() as td:
        note("smoke", "self-check event")
        fr = FlightRecorder(td, rank=0, keep=2).install()
        try:
            path = fr.dump("smoke")
            assert path, "flight dump returned no path"
            with open(path) as f:
                doc = json.load(f)
            assert matches(doc, "flight_record"), doc.get("schema")
            assert doc["reason"] == "smoke"
            assert any(e["kind"] == "smoke" for e in doc["events"]), \
                recent_events()
            assert "rabit" in doc["stacks"] or "Thread" in doc["stacks"]
            got = crossrank.extract_rounds(doc)
            assert got is not None and len(got[1]) == 4, got
        finally:
            fr.uninstall()

    # stitching math: two synthetic ranks, rank 1 lags round 2 by 50 ms
    base = doc["t_base_unix"]
    r0 = {"rank": 0, "t_base_unix": base, "spans": [
        {"name": "engine.allreduce", "t0": 0.0, "dur": 0.01,
         "attrs": {"round": 1}},
        {"name": "engine.allreduce", "t0": 1.0, "dur": 0.01,
         "attrs": {"round": 2}}]}
    r1 = {"rank": 1, "t_base_unix": base, "spans": [
        {"name": "engine.allreduce", "t0": 0.001, "dur": 0.01,
         "attrs": {"round": 1}},
        {"name": "engine.allreduce", "t0": 1.05, "dur": 0.02,
         "attrs": {"round": 2}}]}
    rounds = crossrank.stitch_documents([r0, r1])
    lagged = [r for r in rounds if r["round"] == 2][0]
    assert lagged["straggler_rank"] == 1, lagged
    assert abs(lagged["skew_s"] - 0.05) < 1e-5, lagged
    assert abs(lagged["critical_path_s"] - 0.07) < 1e-5, lagged

    reset()
    print("telemetry smoke ok: /metrics + /healthz + /summary + "
          "flight round-trip + cross-rank stitch")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--smoke", action="store_true",
                    help="run the live-plane self-check and exit")
    args = ap.parse_args(argv)
    if args.smoke:
        return _smoke()
    ap.print_help()
    return 2


if __name__ == "__main__":
    sys.exit(main())
