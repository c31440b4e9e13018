"""The port's chaos plane (``rabit_tpu_torch/chaos/``) against the JAX
package's (``rabit_tpu/chaos/``): the rules' validation, the schedule's
shapes and seeded draws, and the proxy's byte-level behaviour for every
fault kind the port runs (``tests/test_chaos.py`` and the chaos half of
``tests/test_failover.py`` are the JAX package's own). Every comparison
with the JAX package is exact: the same spec, seed, rule and connection
give the same draws, and the same schedule over the same connection
order gives the same injected faults."""

import json
import socket
import struct
import threading
import time

import pytest

from rabit_tpu import chaos as jax_chaos
from rabit_tpu_torch import chaos as port_chaos
from rabit_tpu_torch.chaos import ChaosProxy, Rule, Schedule
from rabit_tpu_torch.chaos import proxy as port_proxy
from rabit_tpu_torch.chaos import schedule as port_schedule
from rabit_tpu_torch.utils import retry


# -- servers ---------------------------------------------------------------

def _serve(handler):
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    srv.settimeout(10.0)

    def loop():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            try:
                handler(conn)
            except OSError:
                pass
            finally:
                conn.close()

    threading.Thread(target=loop, daemon=True).start()
    return srv


def _echo_server():
    def echo(conn):
        while True:
            data = conn.recv(65536)
            if not data:
                return
            conn.sendall(data)
    return _serve(echo)


def _sink_server():
    def sink(conn):
        while conn.recv(65536):
            pass
    return _serve(sink)


def _round_trip(host, port, payload, timeout=10.0):
    """Send ``payload``, half-close, read the echo until EOF."""
    with socket.create_connection((host, port), timeout=timeout) as conn:
        conn.sendall(payload)
        conn.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = conn.recv(65536)
            if not chunk:
                return out
            out += chunk


def _wait(pred, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not pred() and time.monotonic() < deadline:
        time.sleep(0.01)
    return pred()


# -- the schedule ------------------------------------------------------------

def test_kinds_and_targets_are_the_jax_package_s():
    assert port_schedule.KINDS == jax_chaos.schedule.KINDS
    assert port_schedule.TARGETS == jax_chaos.schedule.TARGETS


@pytest.mark.parametrize("mod", [port_schedule, jax_chaos.schedule],
                         ids=["port", "jax"])
def test_rule_validation(mod):
    """The same refusals in both packages."""
    with pytest.raises(ValueError, match="kind"):
        mod.Rule("explode")
    for kind in ("partition", "blackout", "tracker_partition", "job_storm"):
        with pytest.raises(ValueError, match="window_s"):
            mod.Rule(kind)
    with pytest.raises(ValueError, match="window_s or conn"):
        mod.Rule("tracker_kill")
    with pytest.raises(ValueError, match="bitflip"):
        mod.Rule("bitflip")
    with pytest.raises(ValueError, match="unknown chaos rule field"):
        mod.Rule.from_dict({"kind": "delay", "sverity": 9})
    with pytest.raises(ValueError, match="target"):
        mod.Rule("delay", target="worker")


def test_rule_defaults_match_the_jax_package():
    """Implicit targets and budgets, and each rule's dict, equal the JAX
    package's for the same arguments."""
    cases = [("tracker_partition", dict(window_s=(0.5, 1.0))),
             ("tracker_partition", dict(window_s=(0, 1), target="link")),
             ("tracker_kill", dict(conn=3, delay_ms=4000)),
             ("tracker_kill", dict(window_s=(3.0, 600.0))),
             ("bitflip", dict(after_bytes=64, target="link")),
             ("job_storm", dict(window_s=(1, 2), burst=32)),
             ("partial", dict(after_bytes=512, truncate_to=7, max_times=2,
                              prob=0.25, conn=3))]
    for kind, kw in cases:
        ours, theirs = Rule(kind, **kw), jax_chaos.Rule(kind, **kw)
        assert ours.to_dict() == theirs.to_dict(), (kind, kw)
        assert (ours.target, ours.max_times) == \
            (theirs.target, theirs.max_times)
    r = Rule("tracker_partition", window_s=(0.5, 1.0))
    assert r.target == "tracker"
    assert Rule.from_dict(r.to_dict()).to_dict() == r.to_dict()


def test_schedule_from_spec_shapes(tmp_path):
    assert Schedule.from_spec(None).rules == []
    s = Schedule.from_spec({"seed": 4, "rules": [{"kind": "delay",
                                                  "delay_ms": 5}]})
    assert s.seed == 4 and s.rules[0].kind == "delay"
    assert Schedule.from_spec(s) is s   # passthrough, not a copy
    s3 = Schedule.from_spec('{"seed": 9, "rules": [{"kind": "reset"}]}')
    assert s3.seed == 9 and s3.rules[0].kind == "reset"
    f = tmp_path / "sched.json"
    f.write_text(json.dumps({"seed": 2, "rules": [
        {"kind": "blackout", "window_s": [1, 3]}]}))
    s4 = Schedule.from_spec(f"@{f}")
    assert s4.seed == 2 and s4.rules[0].window_s == (1.0, 3.0)
    with pytest.raises(ValueError, match="must be a dict"):
        Schedule.from_spec("[1, 2]")


def test_schedule_json_roundtrip_equals_the_jax_package_s():
    spec = {"seed": 11, "rules": [
        {"kind": "partial", "after_bytes": 512, "truncate_to": 7,
         "max_times": 2, "prob": 0.25, "conn": 3},
        {"kind": "partition", "window_s": [0.5, 2.0]},
        {"kind": "tracker_kill", "window_s": [3.0, 600.0],
         "delay_ms": 4000, "target": "tracker"},
        {"kind": "bitflip", "after_bytes": 100, "target": "link"}]}
    ours = Schedule.from_spec(spec)
    back = Schedule.from_spec(ours.to_json())
    assert back.seed == ours.seed
    assert [r.to_dict() for r in back.rules] == \
        [r.to_dict() for r in ours.rules]
    assert ours.to_json() == jax_chaos.Schedule.from_spec(spec).to_json()


def test_reseed_gives_fresh_counters():
    rule = Rule("reset", max_times=1)
    s = Schedule([rule], seed=5)
    Schedule.consume(rule)
    s2 = s.reseed(3)
    assert s2.seed == 8
    assert s2.rules[0].fired == 0 and s2.rules[0] is not rule


def test_for_target_scopes_rules():
    tr = Rule("blackout", window_s=(0, 1), target="tracker")
    ln = Rule("reset", after_bytes=64, target="link")
    both = Rule("delay", delay_ms=2)
    part = Rule("tracker_partition", window_s=(0, 1))
    s = Schedule([tr, ln, both, part], seed=4)
    assert [r.kind for r in s.for_target("tracker").rules] == \
        ["blackout", "delay", "tracker_partition"]
    # a tracker partition never leaks onto the data links
    assert [r.kind for r in s.for_target("link").rules] == \
        ["reset", "delay"]
    assert s.for_target("tracker").seed == 4
    with pytest.raises(ValueError, match="target"):
        s.for_target("worker")
    back = Schedule.from_spec(s.to_json())
    assert [r.target for r in back.rules] == \
        ["tracker", "link", None, "tracker"]


def test_decide_conn_filter_and_budget():
    rule = Rule("reset", conn=2, max_times=1)
    s = Schedule([rule], seed=0)
    assert s.decide(0) == [] and s.decide(1) == []
    assert s.decide(2) == [rule]
    assert Schedule.consume(rule) is True
    assert Schedule.consume(rule) is False   # budget spent
    assert s.decide(2) == []


@pytest.mark.parametrize("seed", [0, 7, 8, 123456])
def test_decide_equals_the_jax_schedule_s(seed):
    """The seeded draw keyed by (seed, rule, conn): for the same spec the
    port decides exactly what the JAX package decides, connection by
    connection, through ``for_target`` and ``reseed`` too."""
    spec = {"seed": seed, "rules": [
        {"kind": "delay", "delay_ms": 1, "prob": 0.5},
        {"kind": "reset", "after_bytes": 10, "prob": 0.3, "target": "link"},
        {"kind": "partial", "after_bytes": 5, "truncate_to": 2,
         "prob": 0.7, "conn": 5},
        {"kind": "blackout", "window_s": [0, 1], "prob": 0.2,
         "target": "tracker"}]}
    ours, theirs = Schedule.from_spec(spec), jax_chaos.Schedule.from_spec(spec)
    pairs = [(ours, theirs)]
    for target in ("tracker", "link"):
        pairs.append((ours.for_target(target).reseed(3),
                      theirs.for_target(target).reseed(3)))
    hits = 0
    for a, b in pairs:
        for conn in range(200):
            got = [r.to_dict() for r in a.decide(conn)]
            assert got == [r.to_dict() for r in b.decide(conn)], conn
            hits += len(got)
    assert hits > 0
    # the seed keys the draws
    other = Schedule.from_spec(dict(spec, seed=seed + 1))
    assert [len(ours.decide(c)) for c in range(200)] != \
        [len(other.decide(c)) for c in range(200)]


# -- the proxy ---------------------------------------------------------------

def test_proxy_forwards_byte_exact_without_faults():
    payload = bytes(range(256)) * 300   # ~75 KiB, content-checkable
    srv = _echo_server()
    try:
        with ChaosProxy(*srv.getsockname(), Schedule()) as proxy:
            assert _round_trip(proxy.host, proxy.port, payload) == payload
            assert proxy.events == [] and proxy.accepted == 1
            assert _wait(lambda: proxy.bytes_forwarded == 2 * len(payload))
    finally:
        srv.close()


def test_proxy_delay_slows_the_stream():
    srv = _echo_server()
    try:
        sched = Schedule([Rule("delay", delay_ms=250)])
        with ChaosProxy(*srv.getsockname(), sched) as proxy:
            t0 = time.monotonic()
            assert _round_trip(proxy.host, proxy.port, b"x" * 1000) == \
                b"x" * 1000
            assert time.monotonic() - t0 >= 0.25
            assert any(e[1] == "delay" for e in proxy.events)
    finally:
        srv.close()


def test_proxy_reset_tears_connection_mid_transfer():
    payload = b"y" * 16384
    srv = _echo_server()
    try:
        sched = Schedule([Rule("reset", after_bytes=4096, max_times=1)])
        with ChaosProxy(*srv.getsockname(), sched) as proxy:
            with pytest.raises((ConnectionError, OSError)):
                out = _round_trip(proxy.host, proxy.port, payload)
                if out != payload:
                    raise ConnectionError(
                        f"torn echo {len(out)}/{len(payload)}")
            assert [e[1] for e in proxy.events] == ["reset"]
            # the budget is spent: the retry goes through
            assert _round_trip(proxy.host, proxy.port, payload) == payload
    finally:
        srv.close()


@pytest.mark.parametrize("side", ["upstream", "client"])
def test_a_peer_s_reset_crosses_the_proxy(side):
    """One end resets its connection (a close with unread bytes, as the
    native core's link teardown in recovery does): the other end, blocked
    reading, sees the connection die within a moment, as it would without
    the proxy, and no event is counted. A proxy that swallowed the reset
    left that end waiting forever: a link reset at world 3 hung its
    recovery."""
    held = []

    def hold(conn):
        held.append(conn)
        time.sleep(30)
    srv = _serve(hold)
    try:
        with ChaosProxy(*srv.getsockname(), Schedule()) as proxy:
            with socket.create_connection((proxy.host, proxy.port),
                                          timeout=10.0) as conn:
                assert _wait(lambda: held)
                up = held[0]
                resetter, reader = (up, conn) if side == "upstream" \
                    else (conn, up)
                reader.sendall(b"unread")   # the resetter never reads it
                time.sleep(0.2)
                resetter.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                                    struct.pack("ii", 1, 0))
                reader.settimeout(5.0)
                t0 = time.monotonic()
                resetter.close()
                try:
                    got = reader.recv(1)
                except (ConnectionError, OSError):
                    got = None
                assert got in (None, b""), got
                assert time.monotonic() - t0 < 2.0
            assert proxy.events == []
    finally:
        srv.close()


def test_proxy_partial_forwards_truncated_chunk_then_kills():
    srv = _sink_server()
    try:
        sched = Schedule([Rule("partial", after_bytes=1, truncate_to=100)])
        with ChaosProxy(*srv.getsockname(), sched) as proxy:
            with socket.create_connection((proxy.host, proxy.port),
                                          timeout=10.0) as conn:
                conn.sendall(b"z" * 8192)
                with pytest.raises((ConnectionError, OSError,
                                    AssertionError)):
                    assert conn.recv(1) == b""   # RST or EOF, never data
            assert [e[1] for e in proxy.events] == ["partial"]
            assert _wait(lambda: proxy.bytes_forwarded >= 100)
            assert proxy.bytes_forwarded == 100   # exactly the torn write
    finally:
        srv.close()


def test_proxy_blackout_refuses_then_recovers_via_retry():
    payload = b"b" * 4096
    srv = _echo_server()
    try:
        sched = Schedule([Rule("blackout", window_s=(0.0, 0.6))])
        with ChaosProxy(*srv.getsockname(), sched) as proxy:

            def round_trip():
                out = _round_trip(proxy.host, proxy.port, payload,
                                  timeout=5.0)
                if out != payload:
                    raise ConnectionError("torn echo")
                return out

            assert retry.retry_call(round_trip, attempts=8, base_s=0.2,
                                    max_s=0.4) == payload
            assert proxy.refused >= 1
            assert any(e[1] == "blackout" for e in proxy.events)
    finally:
        srv.close()


@pytest.mark.parametrize("kind", ["partition", "tracker_partition"])
def test_proxy_partition_stalls_inside_window_then_delivers(kind):
    payload = b"p" * 2048
    srv = _echo_server()
    try:
        sched = Schedule([Rule(kind, window_s=(0.0, 0.6), max_times=1)])
        with ChaosProxy(*srv.getsockname(), sched.for_target("tracker"),
                        name="part-test") as proxy:
            t0 = time.monotonic()
            out = _round_trip(proxy.host, proxy.port, payload)
            assert out == payload   # stalled, not dropped
            assert time.monotonic() - t0 >= 0.4
            assert [e[1] for e in proxy.events] == [kind]
    finally:
        srv.close()


def test_proxy_tracker_kill_fires_its_hook_once_and_refuses():
    srv = _echo_server()
    fired = []
    try:
        sched = Schedule([Rule("tracker_kill", conn=1, delay_ms=4000)])
        with ChaosProxy(*srv.getsockname(), sched,
                        kill_hook=fired.append) as proxy:
            assert _round_trip(proxy.host, proxy.port, b"a") == b"a"
            with pytest.raises((ConnectionError, OSError, AssertionError)):
                assert _round_trip(proxy.host, proxy.port, b"b") == b"b"
            assert _round_trip(proxy.host, proxy.port, b"c") == b"c"
            assert fired == [4000.0]
            assert [e[1:] for e in proxy.events] == [("tracker_kill", 1)]
            assert proxy.refused == 1
    finally:
        srv.close()


def test_proxy_bitflip_corrupts_one_chunk_as_the_jax_proxy_does():
    """A bit flip changes 1-4 bytes of one forwarded chunk; the seeded
    draw flips the same bytes in both packages' proxies."""
    payload = bytes(range(256)) * 4
    outs = []
    for mod in (jax_chaos, port_chaos):
        srv = _echo_server()
        try:
            sched = mod.Schedule([mod.Rule("bitflip", conn=0)], seed=21)
            with mod.ChaosProxy(*srv.getsockname(), sched) as proxy:
                outs.append(_round_trip(proxy.host, proxy.port, payload))
                assert [e[1] for e in proxy.events] == ["bitflip"]
        finally:
            srv.close()
    assert outs[0] == outs[1] != payload
    assert 1 <= sum(a != b for a, b in zip(outs[1], payload)) <= 4


def test_proxy_retarget_swaps_upstream():
    a, b = socket.socket(), socket.socket()
    for s in (a, b):
        s.bind(("127.0.0.1", 0))
        s.listen(4)
    try:
        with ChaosProxy(*a.getsockname(), Schedule([]),
                        name="retarget-test") as proxy:
            c1 = socket.create_connection((proxy.host, proxy.port),
                                          timeout=5)
            a.settimeout(5.0)
            a.accept()[0].close()   # reached upstream A
            c1.close()
            proxy.retarget(*b.getsockname())
            c2 = socket.create_connection((proxy.host, proxy.port),
                                          timeout=5)
            c2.sendall(b"x")
            b.settimeout(5.0)
            peer, _ = b.accept()     # reached upstream B
            peer.settimeout(5.0)
            assert peer.recv(1) == b"x"
            assert proxy.upstream == b.getsockname()
            peer.close()
            c2.close()
    finally:
        a.close()
        b.close()


def test_a_job_storm_rule_raises_at_start(monkeypatch):
    """A ``job_storm`` rule no longer raises at start: the proxy fires it
    at its window against the multi-job tracker it fronts, through a
    bounded pool, and the rogues' traffic and verdicts are the JAX
    package's (one at a time, so the verdicts do not hang on arrival
    order): the same submits, half-open registrations and verdicts."""
    from rabit_tpu.chaos import proxy as jax_proxy
    from rabit_tpu.tracker.tracker import Tracker as JaxTracker
    from rabit_tpu_torch.tracker.tracker import Tracker as PortTracker
    monkeypatch.setenv("RABIT_MULTI_JOB", "1")
    monkeypatch.setenv("RABIT_MAX_JOBS", "2")
    monkeypatch.setenv("RABIT_ADMISSION_QUEUE", "2")
    assert port_proxy._STORM_POOL_MAX == jax_proxy._STORM_POOL_MAX
    tallies = []
    for mod, cls in ((port_proxy, PortTracker), (jax_proxy, JaxTracker)):
        tr = cls(2).start()
        try:
            rule = mod.Rule("job_storm", window_s=(0, 1), burst=24)
            tally = mod.run_job_storm(tr.host, tr.port, rule, 7, pool=1)
            tally["verdicts"] = [{k: x for k, x in v.items() if k != "hlc"}
                                 for v in tally["verdicts"]]
            tallies.append(tally)
        finally:
            tr.stop()
    assert tallies[0] == tallies[1]
    assert tallies[0]["submits"] == tallies[0]["half_open"] == 12
    assert tallies[0]["errors"] == 0
    # through the proxy: the storm fires at its window
    tr = PortTracker(2).start()
    try:
        sched = Schedule([Rule("job_storm", window_s=(0, 5), burst=16)])
        proxy = ChaosProxy(tr.host, tr.port, sched).start()
        try:
            assert _wait(lambda: proxy.storm_results)
            proxy.join_storms()
            (tally,) = proxy.storm_results
            assert tally["opened"] == 16 and tally["submits"] == 8
            assert [e[1] for e in proxy.events] == ["job_storm"]
        finally:
            proxy.stop()
    finally:
        tr.stop()


def _drive(mod, sched_spec, conns):
    """``conns`` sequential connections through ``mod``'s proxy to an
    echo server, each sending 3 KiB; the proxy's (kind, connection) pairs
    (a per-chunk fault counts once a connection), what each connection
    got back ("ok" intact, "torn" cut short, "flipped" corrupted) and the
    kill hook's calls."""
    srv = _echo_server()
    got = []
    fired = []
    try:
        sched = mod.Schedule.from_spec(sched_spec)
        with mod.ChaosProxy(*srv.getsockname(), sched,
                            kill_hook=fired.append) as proxy:
            for i in range(conns):
                payload = bytes([i]) * 3072
                try:
                    out = _round_trip(proxy.host, proxy.port, payload,
                                      timeout=5.0)
                except OSError:
                    out = b""
                # a flip's bytes hang on how the stream was chunked; the
                # bitflip test holds them with a payload of one chunk
                got.append("ok" if out == payload else
                           "torn" if len(out) < len(payload) else "flipped")
            events = sorted({e[1:] for e in proxy.events},
                            key=lambda e: (e[1], e[0]))
    finally:
        srv.close()
    return events, got, fired


def test_the_same_schedule_gives_the_same_events_in_both_proxies():
    """One schedule of every stream fault, seeded draws included, over
    the same connection order: the port's proxy injects what the JAX
    package's injects, connection by connection, and forwards the same
    bytes."""
    spec = {"seed": 5, "rules": [
        {"kind": "delay", "delay_ms": 5, "prob": 0.5},
        {"kind": "reset", "after_bytes": 1024, "prob": 0.4},
        {"kind": "partial", "after_bytes": 1, "truncate_to": 10,
         "conn": 3},
        {"kind": "bitflip", "conn": 6},
        {"kind": "tracker_kill", "conn": 8, "delay_ms": 100}]}
    theirs = _drive(jax_chaos, spec, 12)
    ours = _drive(port_chaos, spec, 12)
    assert ours == theirs
    kinds = {k for k, _ in ours[0]}
    assert {"reset", "partial", "bitflip", "tracker_kill"} <= kinds
    assert ("bitflip", 6) in ours[0] and ours[2] == [100.0]
