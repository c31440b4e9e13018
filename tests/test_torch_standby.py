"""The port's hot standby against the JAX package's: the lease helpers,
the leader's lease and ``repl`` stream (subscribe, append, ack, a torn
stream's resync, heartbeats kept out of the journal, publication order,
a confused follower dropped), ``tracker/standby.py``'s follow loop and
lease-gated promotion, the launcher supervisor's adoption, the workers'
failover (the skew poller, the membership monitor) and the leader's
gauges -- the counterparts of ``tests/test_failover.py`` -- and the
cross-package pairs: a port standby follows and promotes from a JAX
leader and a JAX standby from a port leader, the promoted journal folds
to the leader's state in either package, and both leaders stream the
same frames, byte for byte, for the same transitions. Every comparison
is exact."""

import json
import os
import socket
import struct
import threading
import time

import pytest

from rabit_tpu.tracker import standby as jax_standby
from rabit_tpu.tracker import tracker as jax_tracker
from rabit_tpu.tracker import wal as jax_wal
from rabit_tpu.utils import retry as jax_retry
from rabit_tpu_torch.tracker import standby as port_standby
from rabit_tpu_torch.tracker import tracker as port_tracker
from rabit_tpu_torch.tracker import wal as wal_mod
from rabit_tpu_torch.tracker.launch import _TrackerSupervisor
from rabit_tpu_torch.tracker.standby import StandbyTracker, standby_addr
from rabit_tpu_torch.tracker.tracker import MAGIC, Tracker
from rabit_tpu_torch.utils.retry import parse_hostport

LEASE = 2000     # long: nothing here may expire it by accident
SHORT = 300      # short: the tests that want an expiry wait one of these


# --------------------------------------------------------------- helpers

def _send_u32(s, v):
    s.sendall(struct.pack("<I", v))


def _send_str(s, txt):
    b = txt.encode()
    _send_u32(s, len(b))
    s.sendall(b)


def _recv_all(s, n):
    out = b""
    while len(out) < n:
        chunk = s.recv(n - len(out))
        if not chunk:
            raise ConnectionError("closed")
        out += chunk
    return out


def _recv_u32(s):
    return struct.unpack("<I", _recv_all(s, 4))[0]


def _request(tr, cmd, task, *fields):
    c = socket.create_connection((tr.host, tr.port), timeout=30)
    _send_u32(c, MAGIC)
    _send_str(c, cmd)
    _send_str(c, task)
    _send_u32(c, 0)
    for f in fields:
        if isinstance(f, str):
            _send_str(c, f)
        else:
            _send_u32(c, f)
    return c


def _announce(tr, task_id, port):
    """One journaled transition: an ``endpoint`` announce."""
    c = _request(tr, "endpoint", task_id,
                 json.dumps({"host": "127.0.0.1", "port": port,
                             "rank": int(task_id)}))
    assert _recv_u32(c) == 1
    c.close()


def _subscribe(tr, last_seq, node_id="test-follower", timeout=5.0):
    """A raw ``repl`` subscription; the open stream, or None when the
    leader refused it."""
    c = _request(tr, "repl", node_id)
    c.settimeout(timeout)
    if _recv_u32(c) != 1:
        c.close()
        return None
    _send_u32(c, last_seq)
    return c


def _wait(pred, timeout=10.0, msg="condition never held"):
    deadline = time.monotonic() + timeout
    while not pred():
        assert time.monotonic() < deadline, msg
        time.sleep(0.02)


def _read_and_ack(c):
    """One assignment, acked: (rank, world, epoch)."""
    rank, world, epoch = (_recv_u32(c) for _ in range(3))
    _recv_all(c, _recv_u32(c))
    for _ in range(3):
        _recv_u32(c)
    for _ in range(_recv_u32(c)):
        _recv_u32(c)
    _recv_u32(c), _recv_u32(c)
    for _ in range(_recv_u32(c)):
        _recv_u32(c)
        _recv_all(c, _recv_u32(c))
        _recv_u32(c)
        _recv_all(c, _recv_u32(c))
    _recv_u32(c)
    _send_u32(c, 1)
    c.close()
    return rank, world, epoch


def _form(tr, n=2):
    """Register tasks t0..t{n-1} one at a time (each journaled before the
    next is sent), read and ack the batch's assignments."""
    conns = []
    for i in range(n):
        before = tr.wal_records()
        conns.append(_request(tr, "start", f"t{i}", "127.0.0.1", 9000 + i,
                              0, ""))
        if i < n - 1:
            _wait(lambda: tr.wal_records() > before, msg="assign journaled")
    return sorted(_read_and_ack(c) for c in conns)


def _script(tr):
    """The same control-plane transitions on any tracker: a formation of
    two (two ``assign``, the ``epoch``, the ``topo``) and two endpoint
    announces. No shutdown: a tracker whose every rank is down ends its
    serving, its streams too."""
    assert _form(tr) == [(0, 2, 1), (1, 2, 1)]
    for i in range(2):
        _announce(tr, str(i), 9300 + i)


def _metrics_text(addr):
    import urllib.request
    with urllib.request.urlopen(f"http://{addr[0]}:{addr[1]}/metrics",
                                timeout=10) as r:
        return r.read().decode()


# ------------------------------------------------------------ lease math

def test_lease_helpers_equal_the_jax_package_s():
    doc = wal_mod.lease_doc("leader", 2000, now_ms=1_000_000)
    assert doc == jax_wal.lease_doc("leader", 2000, now_ms=1_000_000) == \
        {"owner": "leader", "until_ms": 1_002_000, "lease_ms": 2000}
    for now in (1_001_999, 1_002_000, 1_002_001):
        assert wal_mod.lease_expired(doc, now_ms=now) == \
            jax_wal.lease_expired(doc, now_ms=now) == (now >= 1_002_000)
    for bad in (None, {}, {"until_ms": "soon"}, "not a lease"):
        assert wal_mod.lease_expired(bad) and jax_wal.lease_expired(bad)
    recs = [("assign", {"task": "0"}),
            (wal_mod.LEASE_KIND, {"owner": "a", "until_ms": 1}),
            ("epoch", {"epoch": 1}),
            (wal_mod.LEASE_KIND, {"owner": "b", "until_ms": 2})]
    for r in (recs, recs[:1], []):
        assert wal_mod.last_lease(r) == jax_wal.last_lease(r)
    assert wal_mod.last_lease(recs)["owner"] == "b"
    a = wal_mod.lease_doc("x", 1000, now_ms=1)
    for prev, new, want in (
            (a, wal_mod.lease_doc("x", 1000, now_ms=2), True),
            (None, a, False),
            (a, wal_mod.lease_doc("y", 1000, now_ms=2), False),
            (a, wal_mod.lease_doc("x", 2000, now_ms=2), False)):
        assert wal_mod.lease_renewal_only(prev, new) == \
            jax_wal.lease_renewal_only(prev, new) == want


def test_lease_knobs_equal_the_jax_package_s(monkeypatch):
    for v in (None, "800", "5", "x"):
        for env, fn in (("RABIT_LEASE_MS", "default_lease_ms"),
                        ("RABIT_REPL_ACK_TIMEOUT_MS", "repl_ack_timeout_ms")):
            if v is None:
                monkeypatch.delenv(env, raising=False)
            else:
                monkeypatch.setenv(env, v)
            if v == "x":
                with pytest.raises(ValueError, match=env):
                    getattr(port_tracker, fn)()
                continue
            assert getattr(port_tracker, fn)() == \
                getattr(jax_tracker, fn)()


def test_leader_claims_lease_once_then_renews_in_memory(tmp_path):
    tr = Tracker(2, wal_dir=str(tmp_path), lease_ms=SHORT).start()
    try:
        first = tr.lease()
        assert first is not None and first["owner"] == "leader"
        _wait(lambda: tr.lease()["until_ms"] > first["until_ms"],
              msg="lease never renewed")
        seq = tr.repl_stats()["seq"]
    finally:
        tr.stop()
    replayed = wal_mod.WriteAheadLog(str(tmp_path)).replay()
    leases = [d for k, d in replayed if k == wal_mod.LEASE_KIND]
    # renewals ride the stream as heartbeats: the journal holds the claim
    assert len(leases) == 1
    assert seq == len(replayed) == 1
    assert wal_mod.last_lease(replayed)["owner"] == "leader"


def test_lease_off_without_wal_or_knob(tmp_path):
    no_wal = Tracker(2, lease_ms=SHORT).start()
    no_lease = Tracker(2, wal_dir=str(tmp_path)).start()
    try:
        time.sleep(0.3)
        assert no_wal.lease() is None and no_lease.lease() is None
        assert no_wal._lease_thread is None
        assert no_lease._lease_thread is None
    finally:
        no_wal.stop()
        no_lease.stop()
    kinds = [k for k, _ in wal_mod.WriteAheadLog(str(tmp_path)).replay()]
    assert wal_mod.LEASE_KIND not in kinds


# ------------------------------------------------------- the repl stream

def test_repl_refused_without_wal_as_the_jax_tracker_refuses():
    for tr in (Tracker(2).start(), jax_tracker.Tracker(2).start()):
        try:
            assert _subscribe(tr, 0) is None      # 0: no journal
        finally:
            tr.stop()


def test_repl_stream_subscribe_append_ack(tmp_path):
    tr = Tracker(2, wal_dir=str(tmp_path)).start()
    try:
        for i in range(3):
            _announce(tr, str(i), 9000 + i)
        c = _subscribe(tr, 0)
        assert c is not None
        got = []
        for want in (1, 2, 3):
            seq, kind, data = wal_mod.decode_record(wal_mod.recv_frame(c))
            assert seq == want and kind == "endpoint"
            got.append(data["doc"]["port"])
            _send_u32(c, seq)
        assert got == [9000, 9001, 9002]
        _wait(lambda: tr.repl_stats()["acked_seq"] == 3)
        stats = tr.repl_stats()
        assert stats["subscribers"] == 1
        assert stats["lag_records"] == stats["seq"] - 3 == 0
        # records journaled after the subscription stream live
        _announce(tr, "3", 9003)
        seq, kind, data = wal_mod.decode_record(wal_mod.recv_frame(c))
        assert (seq, data["doc"]["port"]) == (4, 9003)
        _send_u32(c, seq)
        c.close()
        # a torn follower is noticed when the next record flows
        _announce(tr, "4", 9004)
        _wait(lambda: tr.repl_stats()["subscribers"] == 0)
    finally:
        tr.stop()


def test_repl_torn_stream_resyncs_from_last_seq(tmp_path):
    tr = Tracker(2, wal_dir=str(tmp_path)).start()
    try:
        for i in range(4):
            _announce(tr, str(i), 9100 + i)
        c = _subscribe(tr, 0)
        for want in (1, 2):
            seq, _, _ = wal_mod.decode_record(wal_mod.recv_frame(c))
            assert seq == want
            _send_u32(c, seq)
        c.close()                                 # torn after acking 2
        _wait(lambda: tr.repl_stats()["subscribers"] == 0)
        # from the last durable seq: nothing twice, nothing skipped
        c2 = _subscribe(tr, 2)
        for want in (3, 4):
            seq, _, data = wal_mod.decode_record(wal_mod.recv_frame(c2))
            assert seq == want and data["doc"]["port"] == 9100 + want - 1
            _send_u32(c2, seq)
        c2.close()
    finally:
        tr.stop()


def test_repl_stream_heartbeats_renewals_without_journal(tmp_path):
    tr = Tracker(2, wal_dir=str(tmp_path), lease_ms=SHORT).start()
    try:
        c = _subscribe(tr, 0)
        # the journaled claim is record 1 and wants an ack
        seq, kind, claim = wal_mod.decode_record(wal_mod.recv_frame(c))
        assert (seq, kind) == (1, wal_mod.LEASE_KIND)
        _send_u32(c, seq)
        # renewals stream as seq-0 heartbeats, no ack between them
        for _ in range(2):
            hseq, hkind, hdoc = wal_mod.decode_record(wal_mod.recv_frame(c))
            assert (hseq, hkind) == (0, wal_mod.LEASE_KIND)
            assert hdoc["owner"] == claim["owner"]
            assert hdoc["until_ms"] > claim["until_ms"]
        c.close()
        assert tr.repl_stats()["seq"] == 1         # the journal did not grow
    finally:
        tr.stop()


def test_wal_publication_order_under_concurrent_writers(tmp_path):
    """Seq assignment and publication are one step: 8 writers journaling
    at once never misindex the positional stream."""
    tr = Tracker(2, wal_dir=str(tmp_path))
    try:
        def hammer(t):
            for j in range(100):
                with tr._lock:
                    tr._wal("endpoint", task=f"{t}-{j}",
                            doc={"host": "h", "port": j, "rank": t})
        workers = [threading.Thread(target=hammer, args=(t,))
                   for t in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=60)
            assert not w.is_alive()
        assert len(tr._repl_log) == 800
        for i, frame in enumerate(tr._repl_log):
            seq, _, _ = wal_mod.decode_record(frame)
            assert seq == i + 1, f"frame at index {i} carries seq {seq}"
    finally:
        tr.stop()


def test_repl_wrong_ack_drops_subscriber(tmp_path):
    tr = Tracker(2, wal_dir=str(tmp_path)).start()
    try:
        _announce(tr, "0", 9200)
        c = _subscribe(tr, 0)
        wal_mod.recv_frame(c)
        _send_u32(c, 77)                          # a confused follower
        _wait(lambda: tr.repl_stats()["subscribers"] == 0,
              msg="wrong-ack subscriber never dropped")
        c.close()
    finally:
        tr.stop()


def test_stop_and_crash_tear_the_stream_at_once(tmp_path):
    """A subscriber's thread must not outlive its tracker: ``stop`` and
    ``crash`` end the stream, and the follower reads EOF at once rather
    than at its read timeout."""
    for end in ("stop", "crash"):
        tr = Tracker(2, wal_dir=str(tmp_path / end)).start()
        _announce(tr, "0", 9250)
        c = _subscribe(tr, 0, timeout=30.0)
        seq, _, _ = wal_mod.decode_record(wal_mod.recv_frame(c))
        _send_u32(c, seq)
        _wait(lambda: tr.repl_stats()["acked_seq"] == 1)
        t0 = time.monotonic()
        getattr(tr, end)()
        with pytest.raises((ConnectionError, OSError)):
            if wal_mod.recv_frame(c) is None:
                raise ConnectionError("EOF")
        assert time.monotonic() - t0 < 5.0
        c.close()
        tr.stop()


# --------------------------------------------- standby follow + promote

def _pair(tmp_path, lease_ms, leader_pkg=port_tracker,
          standby_pkg=port_standby, **kw):
    tr = leader_pkg.Tracker(2, wal_dir=str(tmp_path / "leader"),
                            lease_ms=lease_ms, **kw).start()
    sb = standby_pkg.StandbyTracker(tr.host, tr.port, 2,
                                    wal_dir=str(tmp_path / "standby"),
                                    lease_ms=lease_ms, quiet=True).start()
    return tr, sb


def test_standby_follows_and_acks(tmp_path):
    tr, sb = _pair(tmp_path, LEASE)
    try:
        _announce(tr, "0", 9999)
        _wait(lambda: tr.repl_stats()["seq"] > 0
              and sb.acked_seq == tr.repl_stats()["seq"],
              msg="standby never caught up")
        assert not sb.promoted() and sb.alive()
        assert sb._lease is not None and sb._lease["owner"] == "leader"
        # the advertised failover port is bound but refuses until the
        # promotion: the workers' probes read that as "not yet"
        with pytest.raises(OSError):
            socket.create_connection((sb.host, sb.port), timeout=1.0)
        replayed = wal_mod.WriteAheadLog(str(tmp_path / "standby")).replay()
        assert "endpoint" in [k for k, _ in replayed]
    finally:
        sb.stop()
        tr.stop()


def test_standby_resyncs_but_holds_while_lease_live(tmp_path):
    """A torn stream alone never promotes while the lease is live."""
    tr, sb = _pair(tmp_path, LEASE)
    try:
        _wait(lambda: sb.acked_seq > 0)
        tr.crash()                                # the stream tears (EOF)
        _wait(lambda: sb.resyncs >= 1, msg="torn stream never resynced")
        assert not sb.promoted() and sb.alive()
    finally:
        sb.stop()
        tr.stop()


def test_heartbeats_hold_standby_through_idle(tmp_path):
    """An idle leader holds its standby through heartbeats alone: three
    leases of idle do not promote it."""
    tr, sb = _pair(tmp_path, SHORT)
    try:
        _wait(lambda: sb._lease is not None)
        time.sleep(3 * SHORT / 1e3)
        assert not sb.promoted() and sb.alive()
    finally:
        sb.stop()
        tr.stop()


def test_promotion_immune_to_leader_clock_skew(tmp_path, monkeypatch):
    """The gate is the standby's own monotonic countdown: a leader whose
    wall clock is an hour ahead cannot hold its lease past its death."""
    real = wal_mod.lease_doc

    def skewed(owner, lease_ms, now_ms=None):
        return real(owner, lease_ms,
                    now_ms=int(time.time() * 1000) + 3_600_000)

    monkeypatch.setattr(wal_mod, "lease_doc", skewed)
    tr, sb = _pair(tmp_path, SHORT)
    try:
        _wait(lambda: sb._lease is not None)
        assert sb._lease["until_ms"] > int(time.time() * 1000) + SHORT
        tr.crash()
        _wait(lambda: sb.promoted(),
              msg="skewed until_ms deferred promotion past the lease")
        assert sb.tracker.promoted
    finally:
        sb.stop()
        tr.stop()


def test_promotion_only_after_lease_expiry(tmp_path):
    tr, sb = _pair(tmp_path, SHORT)
    try:
        _announce(tr, "0", 9999)
        # the claim (seq 1) and the announce (seq 2), both acked
        _wait(lambda: sb.acked_seq == tr.repl_stats()["seq"] == 2
              and sb._lease is not None)
        lease_at_crash = dict(sb._lease)
        tr.crash()
        _wait(lambda: sb.promoted(), msg="standby never promoted")
        # promoted strictly after the last replicated lease lapsed
        assert wal_mod.lease_expired(lease_at_crash)
        res = sb.tracker
        assert (res.host, res.port) == (sb.host, sb.port)
        assert res.promoted and res.restarts == 1
        assert res.lease()["owner"] == "standby"  # renewing as itself
        assert res._endpoints["0"]["port"] == 9999
        assert 0 < res.failover_duration_ms < 10_000
        kinds = [k for k, _ in
                 wal_mod.WriteAheadLog(str(tmp_path / "standby")).replay()]
        assert kinds.count("promoted") == 1 and "resume" in kinds
    finally:
        sb.stop()
        tr.stop()


def test_promoted_tracker_serves_failover_gauges_and_healthz(tmp_path):
    """The families ``prom.py`` registers for the failover, served by a
    leader and by the promoted standby (``/metrics``, ``/healthz``,
    ``/slo``); a tracker without a lease serves none of them."""
    from rabit_tpu.telemetry.prom import METRIC_FAMILIES as JAX_FAMILIES
    from rabit_tpu_torch.telemetry import live
    from rabit_tpu_torch.telemetry.prom import METRIC_FAMILIES
    fams = ("rabit_tracker_role", "rabit_repl_acked_seq",
            "rabit_repl_lag_records", "rabit_failover_duration_ms")
    for f in fams:
        assert f in METRIC_FAMILIES and f in JAX_FAMILIES
    tr = Tracker(2, wal_dir=str(tmp_path / "leader"), lease_ms=SHORT,
                 metrics_port=0).start()
    sb = StandbyTracker(tr.host, tr.port, 2,
                        wal_dir=str(tmp_path / "standby"), lease_ms=SHORT,
                        metrics_port=0, quiet=True).start()
    plain = Tracker(2, metrics_port=0).start()
    try:
        _announce(tr, "0", 9999)
        _wait(lambda: tr.repl_stats()["acked_seq"] == sb.acked_seq
              == tr.repl_stats()["seq"] > 0)
        text = _metrics_text(tr.live_addr())
        assert 'rabit_tracker_role{node="leader"} 1' in text
        assert f"rabit_repl_acked_seq {sb.acked_seq}" in text
        assert "rabit_repl_lag_records 0" in text
        assert "rabit_failover_duration_ms" not in text
        doc = live.scrape_json(*tr.live_addr(), path="/healthz")
        assert (doc["tracker_role"], doc["node"], doc["promoted"]) == \
            ("leader", "leader", False)
        assert not any(f in _metrics_text(plain.live_addr())
                       for f in fams)
        tr.crash()
        _wait(lambda: sb.promoted())
        res = sb.tracker
        text = _metrics_text(res.live_addr())
        assert 'rabit_tracker_role{node="standby"} 1' in text
        assert 'rabit_failover_duration_ms{node="standby"}' in text
        doc = live.scrape_json(*res.live_addr(), path="/healthz")
        assert (doc["node"], doc["promoted"]) == ("standby", True)
        slo = live.scrape_json(*res.live_addr(), path="/slo")
        assert slo is not None
    finally:
        plain.stop()
        sb.stop()
        tr.stop()


# ------------------------------------------------- supervisor adoption

def test_supervisor_adopts_promoted_standby(tmp_path):
    cold_respawns = []

    def factory(host, port):                      # the double failure's
        cold_respawns.append((host, port))
        raise AssertionError("no cold respawn with a live standby")

    tr, sb = _pair(tmp_path, SHORT)
    sup = _TrackerSupervisor(tr, str(tmp_path / "leader"), factory,
                             quiet=True)
    sup.standby = sb
    try:
        _wait(lambda: tr.repl_stats()["acked_seq"] == sb.acked_seq
              == tr.repl_stats()["seq"] > 0)
        assert not sup._leader_alive()            # not promoted yet
        sup.kill(delay_ms=0.0)
        assert sup.leader_repl["acked_seq"] == sb.acked_seq
        # while the standby works toward its promotion the supervisor
        # holds the cold respawn
        deadline = time.monotonic() + 10
        while not sb.promoted():
            assert time.monotonic() < deadline
            sup.poll()
            time.sleep(0.02)
        sup.poll()                                # adopt
        assert sup.tracker is sb.tracker
        assert sup.failovers == 1 and sup.fenced == 0
        assert sup._leader_alive()
        assert cold_respawns == [] and sup.restarts == 0
        assert tr.crashed
        sup.poll()                                # idempotent
        assert sup.failovers == 1
    finally:
        sb.stop()
        tr.stop()


def test_supervisor_fences_a_partitioned_leader_and_retargets(tmp_path):
    """A leader that merely lost reach (never crashed) is fenced at the
    adoption, and the front proxy is repointed at the promoted tracker."""
    from rabit_tpu_torch.chaos import ChaosProxy, Schedule
    tr, sb = _pair(tmp_path, SHORT)
    proxy = ChaosProxy(tr.host, tr.port, Schedule()).start()
    sup = _TrackerSupervisor(tr, str(tmp_path / "leader"),
                             lambda h, p: None, quiet=True)
    sup.standby, sup.proxy = sb, proxy
    try:
        _wait(lambda: tr.repl_stats()["acked_seq"] == sb.acked_seq
              == tr.repl_stats()["seq"] > 0)
        # the leader lives on, but its standby stops hearing it
        sb.leader_port = 1
        for c in list(tr._repl_conns):
            port_tracker._drop(c)
        _wait(lambda: sb.promoted(), msg="standby never promoted")
        assert not tr.crashed
        sup.poll()
        assert tr.crashed and sup.tracker is sb.tracker
        assert sup.leader_repl is not None and sup.crashed == [tr]
        assert sup.fenced == 1 and sup.failovers == 1
        assert proxy.upstream == (sb.host, sb.port)
        c = socket.create_connection((proxy.host, proxy.port), timeout=10)
        _send_u32(c, MAGIC)
        for s in ("world", "t0"):
            _send_str(c, s)
        _send_u32(c, 0)
        assert json.loads(_recv_all(c, _recv_u32(c)))["world"] == 2
        c.close()
    finally:
        proxy.stop()
        sb.stop()
        tr.stop()


def test_leader_alive_false_without_standby(tmp_path):
    tr = Tracker(2, wal_dir=str(tmp_path)).start()
    sup = _TrackerSupervisor(tr, str(tmp_path), lambda h, p: None,
                             quiet=True)
    try:
        assert not sup._leader_alive()
    finally:
        tr.stop()


# -------------------------------------- worker-side failover discovery

def test_parse_hostport_and_standby_addr(monkeypatch):
    for raw in ("10.0.0.1:9091", " h:1 ", ":500", "nocolon", "h:noport",
                "", None):
        assert parse_hostport(raw) == jax_retry.parse_hostport(raw)
    assert parse_hostport(":500") == ("127.0.0.1", 500)
    monkeypatch.delenv("RABIT_TRACKER_STANDBY", raising=False)
    assert standby_addr() is None is jax_standby.standby_addr()
    monkeypatch.setenv("RABIT_TRACKER_STANDBY", "127.0.0.1:7777")
    assert standby_addr() == jax_standby.standby_addr() == \
        ("127.0.0.1", 7777)
    assert port_standby.STANDBY_ENV == jax_standby.STANDBY_ENV


def test_skew_poller_fails_over_to_standby(tmp_path, monkeypatch):
    """The poller's miss flips every tracker variable of the process to a
    promoted standby that answers, and re-presents the identity there."""
    from rabit_tpu_torch.telemetry import skew
    from rabit_tpu_torch.tracker import membership

    probe = socket.socket()
    probe.bind(("127.0.0.1", 0))
    dead = probe.getsockname()
    probe.close()                                 # nothing listens here

    promoted = Tracker(2, wal_dir=str(tmp_path)).start()
    try:
        monkeypatch.setenv("RABIT_TRACKER_URI", dead[0])
        monkeypatch.setenv("RABIT_TRACKER_PORT", str(dead[1]))
        monkeypatch.setenv("RABIT_SKEW_TRACKER", f"{dead[0]}:{dead[1]}")
        monkeypatch.setenv("RABIT_TRACKER_STANDBY",
                           f"{promoted.host}:{promoted.port}")
        membership.note_identity("0", 0, 0)
        mon = skew.SkewMonitor()
        assert mon._try_failover()
        assert os.environ["RABIT_SKEW_TRACKER"] == \
            f"{promoted.host}:{promoted.port}"
        assert os.environ["RABIT_TRACKER_URI"] == promoted.host
        assert os.environ["RABIT_TRACKER_PORT"] == str(promoted.port)
        assert mon.breaker_state()["misses"] == 0
        # the re-presented identity: a resume handshake, adopted
        _wait(lambda: 0 in promoted._resumed_ranks)
        assert not mon._try_failover()             # already there
        monkeypatch.delenv("RABIT_TRACKER_STANDBY")
        assert not mon._try_failover()             # none configured
    finally:
        promoted.stop()


def test_membership_monitor_fails_over(tmp_path, monkeypatch):
    from rabit_tpu_torch.tracker import membership
    promoted = Tracker(2, wal_dir=str(tmp_path), elastic=True).start()
    try:
        monkeypatch.setenv("RABIT_TRACKER_STANDBY",
                           f"{promoted.host}:{promoted.port}")
        mon = membership.MembershipMonitor("127.0.0.1", 1, "0")   # dead
        doc = mon.refresh()
        assert doc is not None                    # served by the standby
        assert (mon.host, mon.port) == (promoted.host, promoted.port)
        assert mon._misses == 0
    finally:
        promoted.stop()


# ------------------------------------------------- across the packages

def _leader_state(pkg, tr):
    with tr._lock:
        return pkg.snapshot_state(tr)


@pytest.mark.parametrize("leader_pkg,standby_pkg", [
    (jax_tracker, port_standby), (port_tracker, jax_standby)],
    ids=["port-follows-jax", "jax-follows-port"])
def test_a_standby_follows_and_promotes_from_the_other_package_s_leader(
        tmp_path, leader_pkg, standby_pkg):
    """A standby of one package follows the other's leader through a
    formation, endpoint announces and the shutdowns, acks every record,
    holds while the lease lives, and promotes after the leader's crash.
    The replicated part of the promoted journal folds, in either package,
    to the leader's state at the crash, and the whole promoted journal to
    the promoted tracker's."""
    tr, sb = _pair(tmp_path, SHORT, leader_pkg, standby_pkg)
    try:
        _script(tr)
        _wait(lambda: tr.repl_stats()["acked_seq"] == sb.acked_seq
              == tr.repl_stats()["seq"] >= 7, msg="standby never caught up")
        assert tr.repl_stats()["lag_records"] == 0
        assert not sb.promoted()
        leader_state = _leader_state(leader_pkg, tr)
        acked = sb.acked_seq
        tr.crash()
        _wait(lambda: sb.promoted(), msg="standby never promoted")
        res = sb.tracker
        assert res.promoted and res.restarts == 1 and res._epoch == 1
        assert res._ranks == {"t0": 0, "t1": 1}
        recs = wal_mod.WriteAheadLog(str(tmp_path / "standby")).replay()
        kinds = [k for k, _ in recs]
        assert kinds[:acked].count("assign") == 2
        assert {"lease", "epoch", "topo", "endpoint"} <= set(kinds[:acked])
        assert kinds[acked:][:2] == ["resume", "promoted"]
        for fold in (port_tracker.fold_records, jax_tracker.fold_records):
            assert fold(recs[:acked], nworkers=2) == leader_state
        _wait(lambda: res.lease() is not None)
        recs = wal_mod.WriteAheadLog(str(tmp_path / "standby")).replay()
        res_pkg = port_tracker if standby_pkg is port_standby \
            else jax_tracker
        want = _leader_state(res_pkg, res)
        # the promotion's record is journaled rounded (to the microsecond
        # and the microsecond of a ms), the live fields are not
        live_prom = want.pop("promoted")
        assert want["lease"]["owner"] == "standby"
        for fold in (port_tracker.fold_records, jax_tracker.fold_records):
            got = fold(recs, nworkers=2)
            prom = got.pop("promoted")
            assert got == want
            assert prom == {"wall": round(live_prom["wall"], 6),
                            "mono": round(live_prom["mono"], 6),
                            "failover_ms": round(live_prom["failover_ms"],
                                                 3)}
    finally:
        sb.stop()
        tr.stop()


def _frames(tr, n):
    """Subscribe from 0 and read ``n`` journaled frames, acking each."""
    c = _subscribe(tr, 0)
    out = []
    while len(out) < n:
        frame = wal_mod.recv_frame(c)
        if wal_mod.decode_record(frame)[0] == 0:
            continue                              # a heartbeat
        out.append(frame)
        _send_u32(c, wal_mod.decode_record(frame)[0])
    c.close()
    return out


def test_both_leaders_stream_the_same_frames(tmp_path, monkeypatch):
    """The same transitions through a port leader and a JAX leader, both
    with a lease (its clock pinned, so that the claim's bytes are the
    same): the ``repl`` frames of the two are equal byte for byte, and so
    are the two journals."""
    pinned = {"owner": "leader", "until_ms": 5_000, "lease_ms": SHORT}
    for mod in (wal_mod, jax_wal):
        monkeypatch.setattr(mod, "lease_doc",
                            lambda owner, ms, now_ms=None: dict(pinned))
    frames = []
    for name, pkg in (("port", port_tracker), ("jax", jax_tracker)):
        tr = pkg.Tracker(2, wal_dir=str(tmp_path / name),
                         lease_ms=SHORT).start()
        try:
            _script(tr)
            n = tr.repl_stats()["seq"]
            assert n == 7
            frames.append(_frames(tr, n))
        finally:
            tr.stop()
    assert frames[0] == frames[1]
    kinds = [wal_mod.decode_record(f)[1] for f in frames[0]]
    assert kinds == ["lease", "assign", "assign", "epoch", "topo",
                     "endpoint", "endpoint"]
    assert (tmp_path / "port" / wal_mod.LOG_NAME).read_bytes() == \
        (tmp_path / "jax" / wal_mod.LOG_NAME).read_bytes()


def test_lease_off_keeps_the_journal_of_the_parent(tmp_path):
    """With the lease unset a port leader journals and answers as it did
    without a standby, and as the JAX tracker does: no lease record, the
    same journal bytes, and the same assignment bytes on the wire."""
    for name, pkg in (("port", port_tracker), ("jax", jax_tracker)):
        tr = pkg.Tracker(2, wal_dir=str(tmp_path / name)).start()
        try:
            _script(tr)
            assert tr.lease() is None
        finally:
            tr.stop()
    a = (tmp_path / "port" / wal_mod.LOG_NAME).read_bytes()
    assert a == (tmp_path / "jax" / wal_mod.LOG_NAME).read_bytes()
    kinds = [k for k, _ in wal_mod.WriteAheadLog(str(tmp_path /
                                                     "port")).replay()]
    assert "lease" not in kinds and kinds.count("assign") == 2
