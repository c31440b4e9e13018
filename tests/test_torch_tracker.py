"""The port's tracker (``rabit_tpu_torch/tracker``) on the JAX package's
own wire protocol: it serves ``tests/workers/recover_worker.py`` and
``basic_worker.py`` (``rabit_tpu`` workers on their native engines) through
scripted kills; its assignment blob for a registration is the JAX
tracker's byte for byte, apart from the fields of the epoch's rendezvous
(a ``TCPStore`` here, a JAX coordination service there); stores of old
epochs are reaped once every member of a newer epoch acked."""

import datetime
import json
import os
import socket
import struct
import sys
import time

import pytest

from rabit_tpu_torch.engine import _native_build
from rabit_tpu_torch.tracker import launch as port_launch
from rabit_tpu_torch.tracker.tracker import MAGIC, Tracker

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(ROOT, "tests", "workers")
JAX_LIB = os.path.join(ROOT, "native", "build", "librabit_tpu_core.so")


@pytest.fixture(scope="module", autouse=True)
def native_core():
    _native_build.build()


def run_port(n, worker, args=(), env=None, timeout=120):
    cmd = [sys.executable, os.path.join(WORKERS, worker), *args]
    return port_launch.launch(n, cmd, timeout=timeout, quiet=True, env=env)


@pytest.mark.parametrize("mock", [
    [],
    ["mock=1,2,1,0"],
    ["mock=0,1,0,0", "mock=2,1,1,0"],
    ["mock=1,1,1,0", "mock=1,1,1,1"],
])
def test_port_tracker_serves_jax_recover_worker(mock):
    if not os.path.isfile(JAX_LIB):
        pytest.skip("the JAX package's native core is not built")
    assert run_port(4, "recover_worker.py", mock) == 0


def test_port_tracker_serves_jax_basic_worker_robust_engine():
    if not os.path.isfile(JAX_LIB):
        pytest.skip("the JAX package's native core is not built")
    assert run_port(3, "basic_worker.py",
                    env={"WORKER_ENGINE": "robust"}) == 0


def _send_str(conn, s):
    b = s.encode()
    conn.sendall(struct.pack("<I", len(b)) + b)


def _request(addr, cmd, task_id, *fields):
    conn = socket.create_connection(addr, timeout=30)
    conn.sendall(struct.pack("<I", MAGIC))
    _send_str(conn, cmd)
    _send_str(conn, task_id)
    conn.sendall(struct.pack("<I", 0))
    for f in fields:
        if isinstance(f, str):
            _send_str(conn, f)
        else:
            conn.sendall(struct.pack("<I", f))
    return conn


def _recv_exact(conn, n):
    out = b""
    while len(out) < n:
        chunk = conn.recv(n - len(out))
        assert chunk, "tracker closed the connection"
        out += chunk
    return out


def _read_blob(conn):
    """One assignment, split at the rendezvous fields: (head, coord_host,
    coord_port, tail) with head = rank, world, epoch."""
    u32 = lambda: struct.unpack("<I", _recv_exact(conn, 4))[0]  # noqa: E731
    s = lambda: _recv_exact(conn, u32()).decode()  # noqa: E731
    head = _recv_exact(conn, 12)
    coord_host, coord_port = s(), u32()
    tail = bytearray()
    for _ in range(2):                       # single_host, parent
        tail += _recv_exact(conn, 4)
    ntree = _recv_exact(conn, 4)
    tail += ntree + _recv_exact(conn, 4 * struct.unpack("<I", ntree)[0])
    tail += _recv_exact(conn, 8)             # ring_prev, ring_next
    nconnect = _recv_exact(conn, 4)
    tail += nconnect
    for _ in range(struct.unpack("<I", nconnect)[0]):
        tail += _recv_exact(conn, 4)
        for kind in ("s", "u", "s"):
            if kind == "s":
                n = _recv_exact(conn, 4)
                tail += n + _recv_exact(conn, struct.unpack("<I", n)[0])
            else:
                tail += _recv_exact(conn, 4)
    tail += _recv_exact(conn, 4)             # naccept
    return bytes(head), coord_host, coord_port, bytes(tail)


def _register_all(tracker, world, flags, cmd="start"):
    """Register ``world`` fake workers, read every blob; returns the
    connections (ack pending) and the blobs in rank order."""
    addr = (tracker.host, tracker.port)
    conns = []
    for i in range(world):
        conns.append(_request(addr, cmd, f"t{i}", "127.0.0.1", 9000 + i,
                              flags, f"tok{i}"))
        # one at a time: ranks go by order of registration
        _wait(lambda: len(tracker._ranks) > i)
    blobs = [_read_blob(c) for c in conns]
    return conns, blobs


@pytest.mark.parametrize("world", [1, 2, 3, 5])
def test_assignment_blob_matches_the_jax_tracker(world):
    """The same registrations get the same bytes from both trackers; with
    the data-plane flag the port's blob differs only in the rendezvous
    fields, which name a live TCPStore."""
    import torch.distributed as dist
    from rabit_tpu.tracker.tracker import Tracker as JaxTracker
    jax_tr = JaxTracker(world).start()
    port_tr = Tracker(world).start()
    flagged = Tracker(world).start()
    try:
        jc, want = _register_all(jax_tr, world, 0)
        pc, got = _register_all(port_tr, world, 0)
        fc, stored = _register_all(flagged, world, 1)
        assert got == want
        for (h, ch, cp, t), (h2, _, _, t2) in zip(stored, want):
            assert (h, t) == (h2, t2)
            assert ch == flagged.host and cp > 0
        assert len({(ch, cp) for _, ch, cp, _ in stored}) == 1
        client = dist.TCPStore(stored[0][1], stored[0][2], is_master=False,
                               timeout=datetime.timedelta(seconds=10))
        client.set("k", "v")
        assert client.get("k") == b"v"
        for c in jc + pc + fc:
            c.sendall(struct.pack("<I", 1))
            c.close()
    finally:
        for tr in (jax_tr, port_tr, flagged):
            tr.stop()


def _wait(cond, timeout=10.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.02)


def test_old_stores_reaped_once_a_newer_epoch_is_acked():
    tr = Tracker(2, ready_timeout=10).start()
    try:
        seen = []
        for epoch, cmd in ((1, "start"), (2, "recover"), (3, "recover")):
            conns, blobs = _register_all(tr, 2, 1, cmd)
            assert {struct.unpack("<III", b[0])[2] for b in blobs} == {epoch}
            seen.append(blobs[0][2])
            # before the acks, the previous epoch's store is still hosted
            assert tr.store_count() == min(epoch, 2)
            for c in conns:
                c.sendall(struct.pack("<I", 1))
                c.close()
            _wait(lambda: tr.store_count() == 1)
        assert len(set(seen)) == 3   # a fresh store (port) each epoch
        # an epoch whose member never acks reaps nothing
        conns, _ = _register_all(tr, 2, 1, "recover")
        conns[0].sendall(struct.pack("<I", 1))
        conns[0].close()
        conns[1].close()
        time.sleep(0.5)
        assert tr.store_count() == 2
    finally:
        tr.stop()


def test_print_topo_shutdown_and_unknown_commands():
    tr = Tracker(2).start()
    addr = (tr.host, tr.port)
    try:
        conn = _request(addr, "topo", "t0")
        n = struct.unpack("<I", _recv_exact(conn, 4))[0]
        assert json.loads(_recv_exact(conn, n)) == {}
        conns, _ = _register_all(tr, 2, 0)
        for c in conns:
            c.sendall(struct.pack("<I", 1))
        conn = _request(addr, "topo", "t0")
        n = struct.unpack("<I", _recv_exact(conn, 4))[0]
        doc = json.loads(_recv_exact(conn, n))
        assert doc == {"epoch": 1, "groups": [[0, 1]], "delegates": [0],
                       "single_host": True}
        conn = _request(addr, "print", "t0", "hello from rank 0")
        assert struct.unpack("<I", _recv_exact(conn, 4))[0] == 1
        assert tr.messages == ["hello from rank 0"]
        # metrics keeps a JSON object by task id (1), refuses anything
        # else (0); with no counter in any summary, no fleet table prints
        conn = _request(addr, "metrics", "t0", '{"schema": "x"}')
        assert struct.unpack("<I", _recv_exact(conn, 4))[0] == 1
        conn = _request(addr, "metrics", "t1", "not json")
        assert struct.unpack("<I", _recv_exact(conn, 4))[0] == 0
        assert tr.merged_metrics()["num_ranks"] == 0   # foreign schema
        # resume, without a WAL: the JAX tracker's answer to each request
        # on the same world (a match, a contradiction, an epoch from the
        # future, a new task id on a taken rank, a malformed payload)
        from rabit_tpu.tracker.tracker import Tracker as JaxTracker
        jax_tr = JaxTracker(2).start()
        try:
            jc, _ = _register_all(jax_tr, 2, 0)
            for c in jc:
                c.sendall(struct.pack("<I", 1))
                c.close()
            for task, payload in (("t0", '{"rank": 0, "epoch": 1}'),
                                  ("t0", '{"rank": 1, "epoch": 1}'),
                                  ("t1", '{"rank": 1, "epoch": 99}'),
                                  ("t9", '{"rank": 1, "epoch": 1}'),
                                  ("t1", "not json")):
                answers = []
                for t in (tr, jax_tr):
                    conn = _request((t.host, t.port), "resume", task,
                                    payload)
                    answers.append(struct.unpack(
                        "<I", _recv_exact(conn, 4))[0])
                assert answers[0] == answers[1], (task, payload, answers)
            assert tr._resumed_ranks == jax_tr._resumed_ranks == {0}
            # repl without a WAL: refused with 0 and closed, as the JAX
            # tracker answers (replication streams a journal)
            for t in (tr, jax_tr):
                conn = _request((t.host, t.port), "repl", "follower")
                assert _recv_exact(conn, 4) == struct.pack("<I", 0)
                assert conn.recv(1) == b""
            # submit with multi-job off: the JAX tracker's error verdict
            verdicts = []
            for t in (tr, jax_tr):
                conn = _request((t.host, t.port), "submit", "t0",
                                json.dumps({"job": "a", "nworkers": 1}))
                n = struct.unpack("<I", _recv_exact(conn, 4))[0]
                verdicts.append(json.loads(_recv_exact(conn, n)))
            assert verdicts[0] == verdicts[1]
            assert "multi-job disabled" in verdicts[0]["error"]
        finally:
            jax_tr.stop()
        bad = socket.create_connection(addr, timeout=10)
        bad.sendall(struct.pack("<I", 0xDEADBEEF))
        assert bad.recv(1) == b""
        for i, t in enumerate(("t0", "t1")):
            conn = _request(addr, "shutdown", t)
            assert struct.unpack("<I", _recv_exact(conn, 4))[0] == 1
            assert tr.join(timeout=0.2) == (i == 1)
    finally:
        tr.stop()


def test_launcher_cli_respawns_and_reports(capfd):
    cmd = [sys.executable, "-c",
           "import os,sys; sys.exit(0 if os.environ['RABIT_NUM_TRIAL'] "
           "!= '0' or os.environ['RABIT_TASK_ID'] != '1' else 3)"]
    assert port_launch.main(["-n", "2", "--timeout", "60", "--", *cmd]) == 0
    assert "worker 1 died rc=3 at" in capfd.readouterr().err
    with pytest.raises(RuntimeError, match="per-rank budget"):
        port_launch.launch(1, [sys.executable, "-c", "raise SystemExit(4)"],
                           max_attempts=2, quiet=True)
