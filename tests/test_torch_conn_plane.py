"""The port's tracker on its connection plane (``tracker/evloop.py``) on
the CPU: half-open clients held with no thread added, parked joiners that
hold no pool thread, the ready-ack barrier's timeout, a crash with held
connections and its successor on the same port, a detached ``repl``
stream, the loop's gauges under the JAX tracker's names, and the store
of a member that evicted itself and shut down, reaped as the JAX tracker
reaps its services."""

import json
import socket
import struct
import threading
import time

import pytest

from rabit_tpu.tracker import tracker as jax_tracker
from rabit_tpu_torch.tools import tracker_bench
from rabit_tpu_torch.tracker import tracker as port_tracker
from rabit_tpu_torch.tracker.tracker import MAGIC, Tracker


def _u32(v):
    return struct.pack("<I", v)


def _str(s):
    b = s.encode()
    return _u32(len(b)) + b


def _recv_all(c, n):
    out = b""
    while len(out) < n:
        chunk = c.recv(n - len(out))
        assert chunk, "the tracker closed mid-reply"
        out += chunk
    return out


def _recv_u32(c):
    return struct.unpack("<I", _recv_all(c, 4))[0]


def _send(tr, cmd, task, *fields):
    c = socket.create_connection((tr.host, tr.port), timeout=10)
    c.sendall(_u32(MAGIC) + _str(cmd) + _str(task) + _u32(0) + b"".join(
        _u32(f) if isinstance(f, int) else _str(f) for f in fields))
    return c


def _ask(tr, cmd, task="t0", payload=None):
    """One command answered and closed: its u32 or its JSON reply."""
    c = _send(tr, cmd, task, *(() if payload is None else (payload,)))
    try:
        if cmd in ("world", "topo", "skew", "submit"):
            return json.loads(_recv_all(c, _recv_u32(c)))
        return _recv_u32(c)
    finally:
        c.close()


def _register(tr, task, cmd="start", flags=0):
    return _send(tr, cmd, task, "127.0.0.1", 9000 + int(task[-1]), flags, "")


def _read_blob(c):
    """One assignment: (rank, world, epoch, coord_port)."""
    rank, world, epoch = _recv_u32(c), _recv_u32(c), _recv_u32(c)
    _recv_all(c, _recv_u32(c))
    port = _recv_u32(c)
    _recv_u32(c), _recv_u32(c)
    for _ in range(_recv_u32(c)):
        _recv_u32(c)
    _recv_u32(c), _recv_u32(c)
    for _ in range(_recv_u32(c)):
        _recv_u32(c)
        _recv_all(c, _recv_u32(c))
        _recv_u32(c)
        _recv_all(c, _recv_u32(c))
    _recv_u32(c)
    return rank, world, epoch, port


def _wait(cond, timeout=10.0, what="the condition"):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out waiting for {what}"
        time.sleep(0.01)


def _form(tr, tasks, cmd="start", flags=0, ack=True):
    """Register ``tasks`` one at a time (each rank fixed before the
    next), read every assignment and ack it; the blobs."""
    conns = []
    for t in tasks:
        conns.append(_register(tr, t, cmd, flags))
        _wait(lambda: t in tr._ranks, what=f"{t}'s rank")
    blobs = [_read_blob(c) for c in conns]
    for c in conns:
        if ack:
            c.sendall(_u32(1))
        c.close()
    return blobs


def test_300_half_open_clients_add_no_thread():
    tr = Tracker(2).start()
    held = []
    try:
        assert _ask(tr, "world")["world"] == 2   # the pool is up
        before = threading.active_count()
        prefix = tracker_bench.half_open_prefix()
        for _ in range(300):
            c = socket.create_connection((tr.host, tr.port), timeout=10)
            c.sendall(prefix)
            held.append(c)
        _wait(lambda: tr._loop.open_conns >= 300, what="300 held")
        assert threading.active_count() == before
        t0 = time.monotonic()
        assert _ask(tr, "world")["world"] == 2
        assert time.monotonic() - t0 < 2.0
        gauges = {g[0]: g[3] for g in tr._live_gauges()}
        assert gauges["rabit_tracker_open_conns"][0][1] >= 300
        for c in held:
            c.close()
        _wait(lambda: tr._loop.open_conns == 0, what="the release")
        assert threading.active_count() == before
    finally:
        for c in held:
            c.close()
        tr.stop()


def test_parked_joiners_hold_no_pool_thread_and_are_bounced(monkeypatch):
    monkeypatch.setenv("RABIT_LOOP_SERVICE_THREADS", "1")
    monkeypatch.setenv("RABIT_JOIN_GRACE_MS", "800")
    tr = Tracker(4, elastic=True).start()
    joiners = []
    try:
        assert tr._svc.nthreads == 1
        _form(tr, ["0", "1", "2", "3"])
        for r in (1, 2, 3):
            assert _ask(tr, "evict", payload=json.dumps(
                {"rank": r, "reason": "test"})) == 1
        t0 = time.monotonic()
        for t in ("1", "2", "3"):
            joiners.append(_register(tr, t, "join"))
        _wait(lambda: tr.membership_doc()["joining"] == [1, 2, 3],
              what="three parked joiners")
        # the one pool thread still serves a fourth command at once
        t1 = time.monotonic()
        assert _ask(tr, "world")["joining"] == [1, 2, 3]
        assert time.monotonic() - t1 < 0.5
        for c in joiners:
            c.settimeout(10)
            assert c.recv(4) == b""          # bounced: EOF, no assignment
        waited = time.monotonic() - t0
        assert 0.7 <= waited < 5.0, waited
        assert not tr._pending
    finally:
        for c in joiners:
            c.close()
        tr.stop()


def test_a_worker_that_never_acks_fails_its_barrier_and_reaps_nothing():
    tr = Tracker(2, ready_timeout=0.5).start()
    try:
        assert [b[2] for b in _form(tr, ["0", "1"], flags=1)] == [1, 1]
        _wait(lambda: tr._default._all_acked == 1, what="epoch 1's acks")
        assert tr.store_count() == 1
        c0, c1 = _register(tr, "0", "recover", 1), \
            _register(tr, "1", "recover", 1)
        assert _read_blob(c0)[2] == _read_blob(c1)[2] == 2
        c0.sendall(_u32(1))
        c0.close()
        t0 = time.monotonic()
        c1.settimeout(10)
        assert c1.recv(4) == b""     # the tracker gave up on rank 1
        assert 0.4 <= time.monotonic() - t0 < 5.0
        c1.close()
        _wait(lambda: tr._acked == {0: 2, 1: 1}, what="the settled acks")
        time.sleep(0.1)
        assert tr._default._all_acked == 1 and tr.store_count() == 2
    finally:
        tr.stop()


def test_crash_with_held_connections_then_a_successor_on_the_port(tmp_path):
    wal = str(tmp_path / "wal")
    tr = Tracker(2, wal_dir=wal).start()
    held = []
    res = None
    try:
        _form(tr, ["0", "1"])
        for _ in range(50):
            c = socket.create_connection((tr.host, tr.port), timeout=10)
            c.sendall(tracker_bench.half_open_prefix())
            held.append(c)
        parked = _register(tr, "0", "recover")
        held.append(parked)
        _wait(lambda: 0 in tr._pending, what="a parked registration")
        tr.crash()
        for c in held:
            c.settimeout(10)
            assert c.recv(4) == b""   # dropped with the dead incarnation
        assert not tr._thread.is_alive()
        res = Tracker(2, port=tr.port, wal_dir=wal, resume=True).start()
        assert res.port == tr.port and res.restarts == 1
        doc = _ask(res, "world")
        assert doc["epoch"] == 1 and res._ranks == {"0": 0, "1": 1}
        _wait(lambda: res._loop.open_conns == 0, what="the reply's close")
    finally:
        for c in held:
            c.close()
        if res is not None:
            res.stop()
        tr.stop()


def test_a_repl_follower_is_detached_and_streams(tmp_path):
    tr = Tracker(2, wal_dir=str(tmp_path / "wal")).start()
    c = None
    try:
        _form(tr, ["0", "1"])
        c = _send(tr, "repl", "standby")
        assert _recv_u32(c) == 1
        c.sendall(_u32(0))            # resync from the start
        frames = []
        for want in tr._repl_log:
            frames.append(_recv_all(c, len(want)))
            c.sendall(_u32(len(frames)))   # ack each record's seq
        assert frames == tr._repl_log and len(frames) >= 4
        _wait(lambda: tr.repl_stats()["acked_seq"] == len(frames),
              what="the follower's acks")
        assert tr.repl_stats()["subscribers"] == 1
        _wait(lambda: tr._loop.open_conns == 0, what="off the loop")
        assert [t for t in threading.enumerate()
                if t.name == "rabit-tracker-repl"]
        # a record journaled now streams as before
        assert _ask(tr, "endpoint", payload=json.dumps(
            {"host": "h", "port": 1, "rank": 0})) == 1
        frame = c.recv(65536)
        assert frame == tr._repl_log[len(frames)]
        c.sendall(_u32(len(frames) + 1))
        tr.stop()
        c.settimeout(10)
        assert c.recv(4) == b""               # stop() drops the stream
    finally:
        if c is not None:
            c.close()
        tr.stop()


def test_the_loop_gauges_carry_the_jax_trackers_names():
    names = ("rabit_tracker_open_conns", "rabit_tracker_loop_lag_ms")
    got = {}
    for cls in (Tracker, jax_tracker.Tracker):
        tr = cls(2)
        try:
            got[cls] = [(g[0], g[1], g[2]) for g in tr._live_gauges()
                        if g[0] in names]
            rows = {g[0]: g[3] for g in tr._live_gauges()}
            assert rows["rabit_tracker_open_conns"] == [({}, 0)]
            assert rows["rabit_tracker_loop_lag_ms"] == [({}, 0.0)]
        finally:
            tr.stop()
    assert got[Tracker] == got[jax_tracker.Tracker]
    assert [g[0] for g in got[Tracker]] == list(names)


@pytest.mark.parametrize("shutdown_first", [True, False])
def test_a_member_that_left_keeps_no_store(shutdown_first):
    """An elastic job's member evicts itself and shuts down; once the
    survivor's epoch 2 is acked the job holds the one store the JAX
    tracker holds of its coordination services. Before the shutdown the
    store of epoch 1 stays for the member, which may still hold its world
    (as a member evicted while its process lives on does)."""
    counts = {}
    for cls in (Tracker, jax_tracker.Tracker):
        kw = {} if cls is Tracker else {"coordinator": True}
        tr = cls(2, elastic=True, ready_timeout=10, **kw).start()
        count = (tr.store_count if cls is Tracker else tr.service_count)
        try:
            assert [b[2] for b in _form(tr, ["0", "1"], flags=1)] == [1, 1]
            _wait(lambda: count() == 1, what="epoch 1's store")
            assert _ask(tr, "evict", "1", json.dumps(
                {"rank": 1, "reason": "leaving"})) == 1
            if shutdown_first:
                assert _ask(tr, "shutdown", "1") == 1
            blobs = _form(tr, ["0"], "recover", flags=1)
            assert blobs[0][:3] == (0, 1, 2)
            if not shutdown_first:
                if cls is Tracker:
                    _wait(lambda: tr._default._all_acked == 2,
                          what="epoch 2's acks")
                    assert count() == 2   # kept for the member alive
                assert _ask(tr, "shutdown", "1") == 1
            _wait(lambda: count() == 1, what="one store")
            time.sleep(0.2)
            counts[cls] = count()
            assert not tr.join(0)     # the survivor has not shut down
        finally:
            tr.stop()
    assert counts[Tracker] == counts[jax_tracker.Tracker] == 1


def test_the_request_timeout_and_the_thread_a_connection_are_gone():
    assert not hasattr(port_tracker, "_REQUEST_TIMEOUT_S")
    tr = Tracker(1)
    try:
        assert not hasattr(tr, "_conns") and not hasattr(tr, "_cv")
    finally:
        tr.stop()
