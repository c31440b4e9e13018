"""The port's causal incident plane against the JAX package's: the
incident engine (``telemetry/incident.py``) on the same seeded event
streams, the tracker's fleet event log (``/events``), its incident sweep
(``/incidents``), the ``hlc`` piggyback on its JSON replies with the
plane on and the unchanged bytes with it off, ``fetch_topo``'s retry
and clock merge, and a link reset at world 3 under the port's launcher
that ends as one incident rooted at ``chaos.reset``."""

import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from rabit_tpu.telemetry import clock as jax_clock
from rabit_tpu.telemetry import events as jax_events
from rabit_tpu.telemetry import incident as jax_incident
from rabit_tpu.telemetry import schema as jax_schema
from rabit_tpu.telemetry import slo as jax_slo
from rabit_tpu.tracker import tracker as jax_tracker
from rabit_tpu_torch.parallel import topology
from rabit_tpu_torch.telemetry import clock, events, incident, schema, slo
from rabit_tpu_torch.tracker import tracker as port_tracker

ROOT = Path(__file__).resolve().parents[1]
STAMP = "20260101T000000Z"


@pytest.fixture(autouse=True)
def _fresh_planes(monkeypatch):
    """Both packages' rings and clocks at their defaults (RABIT_EVENTS is
    unset here, so off) before and after each test, and one artifact
    timestamp, so two documents compare whole."""
    monkeypatch.delenv("RABIT_EVENTS", raising=False)
    monkeypatch.delenv("RABIT_INCIDENT_WINDOW_MS", raising=False)
    for mod in (schema, jax_schema):
        monkeypatch.setattr(mod, "timestamp_utc", lambda: STAMP)
    for ev, ck in ((events, clock), (jax_events, jax_clock)):
        ev.reset()
        ck.reset()
    yield
    for ev, ck in ((events, clock), (jax_events, jax_clock)):
        ev.reset()
        ck.reset()


def _arm(node="test"):
    """Both packages' planes on, as ``RABIT_EVENTS=1`` would bring them
    up in a fresh process."""
    for ev, ck in ((events, clock), (jax_events, jax_clock)):
        ev.reset(capacity=256, enabled=True)
        ck.reset(node, enabled=True)


# ------------------------------------------------------- seeded streams

# the kinds a stream draws from: every priority class of the engine
_KINDS = ("chaos.reset", "chaos.tracker_kill", "recovery.retry",
          "recovery.frame_reject", "watchdog.retry", "watchdog.abort",
          "membership.evict", "tracker.promoted", "admission.shed",
          "slo.violating", "slo.ok")


def _stream(seed, n=24, t0=1_000.0):
    """``n`` fleet records made from ``seed`` with numpy: kinds, ranks,
    jobs, sources and times (some HLC-stamped, some on the wall clock
    only), 0.4 s apart on average."""
    rng = np.random.default_rng(seed)
    t = t0
    out = []
    for i in range(n):
        t += float(rng.exponential(0.4))
        rec = {"schema": "rabit_tpu.fleet_event/v1",
               "kind": _KINDS[int(rng.integers(len(_KINDS)))],
               "detail": f"d{int(rng.integers(100))}", "t_unix": t,
               "seq": i + 1, "source": f"{int(rng.integers(3))}"}
        if rng.random() < 0.8:
            rec["hlc"] = {"ms": int(t * 1e3) + int(rng.integers(-50, 50)),
                          "lc": int(rng.integers(3)),
                          "node": f"r{int(rng.integers(3))}"}
        if rng.random() < 0.7:
            rec["rank"] = int(rng.integers(4))
        if rng.random() < 0.5:
            rec["job"] = ("a", "b")[int(rng.integers(2))]
        out.append(rec)
    return out


def _verdict(rng, state=None):
    return {"slo": ("p99_ms", "failover_ms")[int(rng.integers(2))],
            "state": state or ("warn", "violating", "ok",
                               "no_data")[int(rng.integers(4))],
            "value": float(rng.uniform(10, 5000)),
            "objective": 2000.0, "burn": float(rng.uniform(0, 3))}


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("window", [None, 1500.0, 20_000.0])
def test_correlate_and_summarize_equal_the_jax_package_s(seed, window):
    evs = _stream(seed)
    rng = np.random.default_rng(seed + 100)
    t_trig = evs[int(rng.integers(len(evs)))]["t_unix"] + 0.05
    for trig_of in (lambda m: m.slo_trigger(_verdict(rng), t_unix=t_trig,
                                            job="a"),
                    lambda m: m.abort_trigger(
                        next(e for e in evs if e["kind"] == "watchdog.abort")
                        if any(e["kind"] == "watchdog.abort" for e in evs)
                        else {"t_unix": t_trig, "seq": 7})):
        st = rng.bit_generator.state
        ours = incident.correlate(trig_of(incident), evs, window=window,
                                  incident_id="inc-x")
        rng.bit_generator.state = st
        theirs = jax_incident.correlate(trig_of(jax_incident), evs,
                                        window=window, incident_id="inc-x")
        assert ours == theirs
        assert incident.summarize(ours) == jax_incident.summarize(theirs)
        assert ours["schema"] == "rabit_tpu.incident/v1"


def test_the_engine_s_constants_and_helpers_are_the_jax_package_s(
        monkeypatch):
    assert incident.INCIDENT_KIND == jax_incident.INCIDENT_KIND
    assert incident.DEFAULT_WINDOW_MS == jax_incident.DEFAULT_WINDOW_MS
    assert incident._CAUSE_PRIORITY == jax_incident._CAUSE_PRIORITY
    assert incident._SEVERITY_RANK == jax_incident._SEVERITY_RANK
    for kind in events.EVENT_KINDS + ("other.kind", ""):
        assert incident.cause_priority(kind) == \
            jax_incident.cause_priority(kind)
    for ev in _stream(3):
        assert incident._event_key(ev) == jax_incident._event_key(ev)
    for raw, want in ((None, 5000.0), ("250", 250.0), ("-4", 0.0),
                      ("junk", 5000.0)):
        if raw is None:
            monkeypatch.delenv("RABIT_INCIDENT_WINDOW_MS", raising=False)
        else:
            monkeypatch.setenv("RABIT_INCIDENT_WINDOW_MS", raw)
        assert incident.window_ms() == jax_incident.window_ms() == want
    assert incident.window_ms(12) == jax_incident.window_ms(12) == 12.0


@pytest.mark.parametrize("seed", range(4))
def test_incident_book_equals_the_jax_package_s(seed):
    """Open, escalate (warn -> violating re-correlates), close, and the
    abort dedup, over the same verdict sequence and event stream."""
    evs = _stream(seed, n=30)
    rng = np.random.default_rng(seed)
    ours, theirs = incident.IncidentBook(window=8000.0), \
        jax_incident.IncidentBook(window=8000.0)
    t_end = evs[-1]["t_unix"]
    for step in range(12):
        v = _verdict(rng)
        job = ("a", "")[int(rng.integers(2))]
        t = t_end - float(rng.uniform(0, 6))
        a = ours.observe_slo(v, evs, job=job, t_unix=t)
        b = theirs.observe_slo(v, evs, job=job, t_unix=t)
        assert a == b, step
        assert ours.open_docs() == theirs.open_docs(), step
    for book in (ours, theirs):
        book.observe_slo({"slo": "x", "state": "warn"}, evs, t_unix=t_end)
        book.observe_slo({"slo": "x", "state": "violating"}, evs,
                         t_unix=t_end)
    assert ours.open_docs() == theirs.open_docs()
    assert ours.observe_events(evs) == theirs.observe_events(evs)
    assert ours.observe_events(evs) == theirs.observe_events(evs) == []
    assert ours.closed_total == theirs.closed_total
    assert ours.worst() == theirs.worst()
    assert incident.gauges(ours.open_docs(), 7) == \
        jax_incident.gauges(theirs.open_docs(), 7)
    assert incident.worst_severity(ours.open_docs()) == \
        jax_incident.worst_severity(theirs.open_docs())


def test_book_lifecycle_warn_opens_ok_closes_abort_is_terminal():
    evs = [{"kind": "chaos.reset", "t_unix": 100.0, "seq": 1, "rank": 2},
           {"kind": "recovery.retry", "t_unix": 100.5, "seq": 2,
            "rank": 2},
           {"kind": "watchdog.abort", "t_unix": 101.0, "seq": 3, "rank": 1,
            "source": "1"}]
    for mod in (incident, jax_incident):
        book = mod.IncidentBook(window=5000.0)
        warn = {"slo": "availability", "state": "warn", "burn": 0.9}
        opened = book.observe_slo(warn, evs, job="a", t_unix=101.0)
        assert opened["severity"] == "warn" and book.worst() == "warn"
        assert book.observe_slo(warn, evs, job="a", t_unix=101.0) is None
        book.observe_slo(dict(warn, state="violating"), evs, job="a",
                         t_unix=101.0)
        assert book.open_docs()[0]["severity"] == "critical"
        book.observe_slo(dict(warn, state="ok"), evs, job="a")
        assert not book.open and book.closed_total == 1
        (ab,) = book.observe_events(evs)
        assert ab["root_cause"]["kind"] == "chaos.reset"
        assert ab["summary"] == ("chaos.reset → recovery.retry → watchdog "
                                 "abort on rank 1")
        assert book.observe_events(evs) == []


def test_dump_writes_the_jax_package_s_file(tmp_path):
    evs = _stream(9)
    trig = {"type": "slo", "slo": "p99_ms", "state": "violating",
            "value": 3.0, "burn": 1.5, "job": "", "t_unix":
            evs[-1]["t_unix"]}
    doc = incident.correlate(trig, evs, incident_id="inc/7")
    p = incident.dump(doc, str(tmp_path / "ours"))
    q = jax_incident.dump(jax_incident.correlate(trig, evs,
                                                 incident_id="inc/7"),
                          str(tmp_path / "theirs"))
    assert Path(p).name == Path(q).name == f"incident_inc_7_{STAMP}.json"
    assert Path(p).read_bytes() == Path(q).read_bytes()
    # best-effort: a directory that cannot be made gives None
    blocker = tmp_path / "file"
    blocker.write_text("x")
    assert incident.dump(doc, str(blocker / "sub")) is None


def test_incident_smoke_runs_without_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['incident', '--smoke']\n"
            "try:\n"
            "    runpy.run_module('rabit_tpu_torch.telemetry.incident', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert e.code == 0, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'rabit_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items()
           if k not in ("PYTHONPATH", "RABIT_EVENTS")}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "incident smoke ok" in r.stderr


# ------------------------------------------------------- the tracker's wire

def _send_u32(c, v):
    c.sendall(struct.pack("<I", v))


def _send_str(c, s):
    b = s.encode()
    _send_u32(c, len(b))
    c.sendall(b)


def _recv_all(c, n):
    out = b""
    while len(out) < n:
        chunk = c.recv(n - len(out))
        if not chunk:
            raise ConnectionError("closed")
        out += chunk
    return out


def _ask(tr, cmd, task="0", payload=None):
    """One command; the raw reply: a JSON string's bytes, or a u32."""
    with socket.create_connection((tr.host, tr.port), timeout=10) as c:
        _send_u32(c, port_tracker.MAGIC)
        _send_str(c, cmd)
        _send_str(c, task)
        _send_u32(c, 0)
        if payload is not None:
            _send_str(c, payload)
            return struct.unpack("<I", _recv_all(c, 4))[0]
        return _recv_all(c, struct.unpack("<I", _recv_all(c, 4))[0])


_TOPO = {"epoch": 1, "groups": [[0, 1], [2]], "delegates": [0, 2],
         "single_host": False}
_SKEW = {"epoch": 2, "laggard": 1, "offsets_ms": {"0": 0.0, "1": 40.5}}


def _state(tr, tag):
    """The same topology and skew digest in either package's tracker (the
    JAX one keeps them on its default job)."""
    held = tr._default if tag == "jax" else tr
    held._topo = dict(_TOPO)
    held._skew = dict(_SKEW)


@pytest.mark.parametrize("cmd", ["topo", "skew", "world"])
def test_json_replies_are_unchanged_with_the_plane_off(cmd):
    """Off: the port's reply is the bare document, byte for byte the JAX
    tracker's, no route or gauge of the plane; and a u32 reply stays a
    u32."""
    replies = []
    for cls, tag in ((port_tracker.Tracker, "port"),
                     (jax_tracker.Tracker, "jax")):
        tr = cls(3, elastic=True).start()
        try:
            _state(tr, tag)
            assert tr._events_on is False
            replies.append(_ask(tr, cmd))
            if tag == "port":
                want = {"topo": _TOPO, "skew": _SKEW,
                        "world": tr.membership_doc()}[cmd]
                assert replies[-1] == json.dumps(want).encode()
                assert set(tr._live_routes()) == {"/straggler", "/jobs",
                                                  "/slo"}
                names = {g[0] for g in tr._live_gauges()}
                assert not names & {"rabit_open_incidents",
                                    "rabit_events_dropped_total"}
                assert _ask(tr, "metrics", payload=json.dumps(
                    {"rank": 0})) == 1
                assert not tr._fleet_events
        finally:
            tr.stop()
    assert replies[0] == replies[1]


@pytest.mark.parametrize("cmd", ["topo", "skew", "world"])
def test_json_replies_gain_only_hlc_with_the_plane_on(cmd):
    _arm()
    got = {}
    for cls, tag in ((port_tracker.Tracker, "port"),
                     (jax_tracker.Tracker, "jax")):
        tr = cls(3, elastic=True).start()
        try:
            _state(tr, tag)
            assert tr._events_on is True
            got[tag] = json.loads(_ask(tr, cmd))
            if tag == "port":
                base = {"topo": _TOPO, "skew": _SKEW,
                        "world": tr.membership_doc()}[cmd]
                assert set(got[tag]) == set(base) | {"hlc"}
                assert {k: got[tag][k] for k in base} == base
                routes = set(tr._live_routes())
                assert {"/events", "/incidents"} <= routes
                names = {g[0] for g in tr._live_gauges()}
                assert {"rabit_open_incidents",
                        "rabit_events_dropped_total"} <= names
        finally:
            tr.stop()
    for doc in got.values():
        assert clock.is_stamp(doc["hlc"])
        assert doc["hlc"]["node"] == "tracker:leader"
        doc.pop("hlc")
    assert got["port"] == got["jax"]


@pytest.mark.parametrize("on", [False, True])
def test_the_journal_s_bytes_do_not_move_with_the_plane(tmp_path,
                                                         monkeypatch, on):
    """The WAL script of ``test_torch_wal.py`` through the port's tracker
    with the plane off and on: the journal is byte for byte the JAX
    tracker's (plane off) either way."""
    import test_torch_wal as W
    monkeypatch.setenv("RABIT_METRICS_POLL_MS", "50")
    monkeypatch.setenv("RABIT_TRACKER_RESUME_GRACE_MS", "0")
    jax_bytes = W._script(jax_tracker.Tracker, str(tmp_path / "jax"),
                          W._set_jax)
    if on:
        events.reset(capacity=256, enabled=True)
        clock.reset("wal", enabled=True)
    port_bytes = W._script(port_tracker.Tracker, str(tmp_path / "port"),
                           W._set_port)
    assert port_bytes == jax_bytes


def _ring(seq0, t0, node, kinds, dropped=0):
    recs = [{"schema": "rabit_tpu.fleet_event/v1", "kind": k,
             "detail": f"{node} {i}", "t_unix": t0 + 0.1 * i,
             "hlc": {"ms": int((t0 + 0.1 * i) * 1e3), "lc": 0,
                     "node": node},
             "seq": seq0 + i, "rank": int(node[1:])}
            for i, k in enumerate(kinds)]
    return {"records": recs, "seq": seq0 + len(kinds) - 1,
            "dropped": dropped, "capacity": 256}


def _summaries(t0):
    """Two ranks' summaries as a scrape would ship them, twice (the second
    re-ships the first ring and adds to it)."""
    a1 = _ring(1, t0, "r0", ["chaos.reset", "recovery.retry"], dropped=1)
    a2 = _ring(1, t0, "r0", ["chaos.reset", "recovery.retry",
                             "recovery.link_reset"], dropped=2)
    b1 = _ring(1, t0 + 0.05, "r1", ["recovery.frame_reject",
                                    "watchdog.abort"])
    hlc = {"ms": int((t0 + 1) * 1e3), "lc": 0, "node": "r0"}
    return [("0", {"rank": 0, "events": a1, "hlc": hlc}),
            ("1", {"rank": 1, "events": b1}),
            ("0", {"rank": 0, "events": a2, "hlc": hlc}),
            ("1", {"rank": 1, "events": b1})]


def _tracker_side(doc):
    """A document with the tracker's own stamps and times set aside."""
    doc = json.loads(json.dumps(doc))
    for rec in doc.get("events", []):
        if rec.get("source") == "tracker":
            for k in ("hlc", "t_unix", "seq"):
                rec.pop(k, None)
    return doc


def test_the_tracker_folds_worker_rings_with_dedup():
    _arm("w")
    tr = port_tracker.Tracker(2)
    try:
        t0 = time.time()
        for task, doc in _summaries(t0):
            tr._fold_events(task, doc)
        evdoc = tr._events_doc()
        assert [(e["source"], e["kind"]) for e in evdoc["events"]] == [
            ("0", "chaos.reset"), ("1", "recovery.frame_reject"),
            ("0", "recovery.retry"), ("1", "watchdog.abort"),
            ("0", "recovery.link_reset")]
        assert all(e["job"] == "default" for e in evdoc["events"])
        assert evdoc["dropped"] == 2 and evdoc["count"] == 5
        # the tracker's clock follows the folded worker
        assert clock.local().peek()["ms"] >= int((t0 + 1) * 1e3)
        # the tracker's own emissions land in the same log, as "tracker"
        tr._fleet_emit("tracker.resume", "re-adopted")
        kinds = [(e["source"], e["kind"]) for e in tr._events_doc()["events"]]
        assert ("tracker", "tracker.resume") in kinds
        # a foreign payload folds nothing
        tr._fold_events("2", {"events": "junk"})
        tr._fold_events("2", ["not", "a", "dict"])
        assert len(tr._events_doc()["events"]) == 6
    finally:
        tr.stop()


def test_events_and_incidents_equal_the_jax_tracker_s(tmp_path,
                                                      monkeypatch):
    """The same summaries over ``metrics`` into both trackers, then one
    incident sweep each with the tracker promoted 30 s after its leader's
    death: ``/events`` and ``/incidents`` agree, the tracker's own stamps
    and times aside, and each tracker dumped the same incidents."""
    _arm()
    t0 = time.time() - 1.0
    docs = {}
    for cls, tag in ((port_tracker.Tracker, "port"),
                     (jax_tracker.Tracker, "jax")):
        flight = tmp_path / tag
        monkeypatch.setenv("RABIT_FLIGHT_DIR", str(flight))
        tr = cls(2).start()
        try:
            for task, doc in _summaries(t0):
                assert _ask(tr, "metrics", task, json.dumps(doc)) == 1
            tr.promoted = True
            tr.failover_duration_ms = 30_000.0
            tr._incident_sweep()
            tr._incident_sweep()     # no edge, nothing new
            ev, inc = tr._events_doc(), tr._incidents_doc()
        finally:
            tr.stop()
        for d in inc["open"] + inc["recent"]:
            d["trigger"].pop("t_unix", None)
        files = sorted(flight.iterdir())
        dumped = [json.loads(p.read_text()) for p in files]
        for d in dumped:
            d["trigger"].pop("t_unix", None)
        docs[tag] = (_tracker_side(ev), inc, [p.name for p in files],
                     dumped)
    assert docs["port"] == docs["jax"]
    ev, inc, names, _ = docs["port"]
    assert [e["kind"] for e in ev["events"]
            if e["source"] == "tracker"] == [
        "slo.violating", "slo.no_data"]
    assert inc["open_count"] == 2 and inc["worst"] == "critical"
    roots = sorted(d["root_cause"]["kind"] for d in inc["open"])
    assert roots == ["chaos.reset", "chaos.reset"]
    summaries = sorted(d["summary"] for d in inc["open"])
    assert "failover_ms violating" in summaries[1]
    assert summaries[0].endswith("watchdog abort on rank 1")
    assert len(names) == 2


def test_the_sweep_runs_on_the_poll_cadence_without_endpoints(
        tmp_path, monkeypatch):
    """The poll loop sweeps even when no endpoint is announced: a
    promoted tracker past its failover objective opens one critical
    incident, serves it at ``/incidents`` and dumps it; the exposition
    carries the plane's gauges."""
    from rabit_tpu_torch.telemetry import live
    monkeypatch.setenv("RABIT_METRICS_POLL_MS", "50")
    monkeypatch.setenv("RABIT_SLO_FAILOVER_MS", "400")
    monkeypatch.setenv("RABIT_FLIGHT_DIR", str(tmp_path))
    _arm()
    events.emit_chaos("tracker_kill", "leader killed")
    tr = port_tracker.Tracker(1, metrics_port=0)
    tr.promoted = True
    tr.failover_duration_ms = 812.5
    tr.start()
    try:
        host, port = tr.live_stats()["metrics_addr"]
        deadline = time.monotonic() + 10
        while True:
            doc = live.scrape_json(host, port, path="/incidents")
            if doc and doc["open_count"]:
                break
            assert time.monotonic() < deadline, doc
            time.sleep(0.05)
        (inc,) = doc["open"]
        assert inc["severity"] == "critical" and not inc["unattributed"]
        assert inc["root_cause"]["kind"] == "chaos.tracker_kill"
        assert "failover_ms violating" in inc["summary"]
        evdoc = live.scrape_json(host, port, path="/events")
        keys = [clock.key(e["hlc"]) for e in evdoc["events"]]
        assert keys == sorted(keys) and len(keys) >= 3
        from urllib.request import urlopen
        with urlopen(f"http://{host}:{port}/metrics", timeout=10) as r:
            text = r.read().decode()
        assert 'rabit_open_incidents{severity="critical"} 1' in text
        assert "rabit_events_dropped_total 0" in text
        assert [p.name.startswith("incident_inc1_")
                for p in tmp_path.iterdir()] == [True]
    finally:
        tr.stop()


def test_a_resume_and_a_transition_reach_the_fleet_log(tmp_path):
    _arm()
    tr = port_tracker.Tracker(2, wal_dir=str(tmp_path), elastic=True)
    tr.stop()
    res = port_tracker.Tracker(2, wal_dir=str(tmp_path), resume=True,
                               elastic=True)
    try:
        assert res.evict_rank(1, "test")
        got = [(e["kind"], e.get("job"), e.get("rank"))
               for e in res._events_doc()["events"]]
        assert got == [("tracker.resume", None, None),
                       ("membership.evict", "default", 1)]
    finally:
        res.stop()


# ----------------------------------------------------------- fetch_topo

def test_fetch_topo_merges_the_tracker_s_clock(monkeypatch):
    """A stamped ``topo`` reply (a tracker whose clock runs a minute
    ahead) moves the worker's clock past the tracker's stamp."""
    _arm()
    ahead = int(time.time() * 1e3) + 60_000
    monkeypatch.setattr(jax_clock, "_LOCAL",
                        jax_clock.HLC("tracker:far", wall_ms=lambda: ahead))
    tr = jax_tracker.Tracker(3).start()
    try:
        _state(tr, "jax")
        groups = topology.fetch_topo(tr.host, tr.port)
    finally:
        tr.stop()
    assert groups == ((0, 1), (2,))
    assert clock.key(clock.local().peek()) > (ahead, 0, "tracker:far")


def test_fetch_topo_leaves_the_clock_alone_with_the_plane_off():
    tr = port_tracker.Tracker(3).start()
    try:
        tr._topo = dict(_TOPO)
        before = clock.local().peek()
        assert topology.fetch_topo(tr.host, tr.port) == ((0, 1), (2,))
        assert _ask(tr, "topo") == json.dumps(_TOPO).encode()
    finally:
        tr.stop()
    assert clock.local().peek() == before and clock.tick() is None


def test_fetch_topo_retries_until_the_tracker_listens():
    """A tracker that comes up after the first attempt is still reached
    (the JAX package's backoff); a port that never answers gives None."""
    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    port = probe.getsockname()[1]
    probe.close()
    box = {}

    def late():
        time.sleep(0.4)
        box["tr"] = port_tracker.Tracker(3, port=port).start()
        box["tr"]._topo = dict(_TOPO)

    t = threading.Thread(target=late)
    t.start()
    try:
        assert topology.fetch_topo("127.0.0.1", port, timeout=10.0) == \
            ((0, 1), (2,))
    finally:
        t.join()
        box["tr"].stop()
    assert topology.fetch_topo("127.0.0.1", port, timeout=0.5) is None


# ------------------------------------------------- a link reset at world 3

def test_a_link_reset_at_world_3_is_one_incident_rooted_at_chaos_reset():
    """The port's counterpart of ``tests/test_incident_cluster.py``: a
    seeded link RST against three native-engine workers under the port's
    launcher comes out as one attributed incident."""
    from rabit_tpu_torch.engine import _native_build
    from rabit_tpu_torch.tracker.launch import launch
    _native_build.build()
    chaos = {"seed": 5, "rules": [
        {"kind": "reset", "after_bytes": 4096, "max_times": 1,
         "target": "link"}]}
    events.reset(capacity=2048, enabled=True)
    clock.reset("launcher", enabled=True)
    stats = {}
    rc = launch(3, [sys.executable,
                    str(ROOT / "tests" / "workers" /
                        "torch_recover_worker.py")],
                max_attempts=30, timeout=120, quiet=True, stats=stats,
                env={"RABIT_EVENTS": "1", "RABIT_TELEMETRY": "1",
                     "N_ITER": "4"}, chaos=chaos)
    assert rc == 0
    assert stats["chaos"]["events"] >= 1, "no reset ever fired"
    fleet = stats["fleet_events"]["events"]
    kinds = {e["kind"] for e in fleet}
    assert "chaos.reset" in kinds, sorted(kinds)
    rungs = {k for k in kinds if k.startswith(("recovery.", "watchdog."))}
    assert rungs, sorted(kinds)
    assert {e.get("source") for e in fleet} - {"tracker"}
    assert all(clock.is_stamp(e.get("hlc")) for e in fleet)
    keys = [clock.key(e["hlc"]) for e in fleet]
    assert keys == sorted(keys)
    p99 = slo.p99_ms_from_counters(
        stats["fleet"]["counters"],
        names=frozenset({"engine.allreduce", "engine.broadcast"}))
    assert p99 is not None and p99 > 0
    (obj,) = [s for s in slo.default_slos(overrides={"p99_ms": p99 / 2})
              if s.name == "p99_ms"]
    (verdict,) = slo.evaluate_all([obj], {"p99_ms": p99})
    assert verdict["state"] == slo.VIOLATING
    book = incident.IncidentBook(window=30 * 60 * 1e3)
    t_end = max(float(e["t_unix"]) for e in fleet)
    opened = book.observe_slo(verdict, fleet, t_unix=t_end)
    assert book.observe_slo(verdict, fleet, t_unix=t_end) is None
    assert len(book.open_docs()) == 1
    assert opened["severity"] == "critical" and not opened["unattributed"]
    assert opened["root_cause"]["kind"] == "chaos.reset"
    assert any(e["kind"] in rungs for e in opened["attribution"])
    assert "p99_ms violating" in opened["summary"]
    # the JAX engine gives the same incident over the same log
    jbook = jax_incident.IncidentBook(window=30 * 60 * 1e3)
    (jv,) = jax_slo.evaluate_all(
        [s for s in jax_slo.default_slos(overrides={"p99_ms": p99 / 2})
         if s.name == "p99_ms"], {"p99_ms": p99})
    assert jbook.observe_slo(jv, fleet, t_unix=t_end) == opened
    # the tracker's own book opened nothing: no control-plane objective
    # was burning
    assert stats["incidents"]["open_count"] == 0, stats["incidents"]
