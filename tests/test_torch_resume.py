"""The port's tracker journals and resumes (``rabit_tpu_torch/tracker``):
crash -> resume re-adopts the world on the pinned port, the ``resume``
handshake against the JAX tracker's answers, the resume grace and the
poll loop's waiver, a crash's teardown, the WAL-off bytes, the journaling
rule (the JAX lint's R003 over the port's source), the skew poller's
reconnect, and two worlds that keep computing through a tracker crash:
the standalone tracker killed by SIGKILL and resumed with ``--resume``
under native-engine workers, and the launcher's supervisor over a gloo
data plane."""

import ast
import json
import os
import re
import signal
import socket
import struct
import subprocess
import sys
import time
from pathlib import Path

import pytest

from rabit_tpu.tracker import tracker as jax_tracker
from rabit_tpu_torch.engine import _native_build
from rabit_tpu_torch.tracker import launch as port_launch
from rabit_tpu_torch.tracker import tracker as port_tracker
from rabit_tpu_torch.tracker.tracker import MAGIC, Tracker
from rabit_tpu_torch.tracker.wal import LOG_NAME, WriteAheadLog

ROOT = Path(__file__).resolve().parent.parent
WORKER = ROOT / "tests" / "workers" / "torch_resume_worker.py"


# ----------------------------------------------------------------- helpers

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


def _recv_u32(c):
    return struct.unpack("<I", _recv_all(c, 4))[0]


def _request(tr, cmd, task="0", payload=None):
    c = socket.create_connection((tr.host, tr.port), timeout=10)
    _send_u32(c, MAGIC)
    _send_str(c, cmd)
    _send_str(c, task)
    _send_u32(c, 0)
    if payload is not None:
        _send_str(c, payload)
    return c


def _register(tr, task, cmd="start"):
    c = _request(tr, cmd, task)
    _send_str(c, "127.0.0.1")
    _send_u32(c, 9000 + int(task))
    _send_u32(c, 0)
    _send_str(c, "")
    return c


def _assignment(c):
    out = {"rank": _recv_u32(c), "world": _recv_u32(c),
           "epoch": _recv_u32(c), "coord": _recv_all(c, _recv_u32(c))}
    out["rest"] = [_recv_u32(c) for _ in range(3)]
    out["tree"] = [_recv_u32(c) for _ in range(_recv_u32(c))]
    out["ring"] = (_recv_u32(c), _recv_u32(c))
    links = []
    for _ in range(_recv_u32(c)):
        links.append((_recv_u32(c), _recv_all(c, _recv_u32(c)),
                      _recv_u32(c), _recv_all(c, _recv_u32(c))))
    out["links"], out["naccept"] = links, _recv_u32(c)
    return out


def _form(tr, n=2):
    """Register n workers one at a time, read and ack the assignments."""
    conns = []
    for i in range(n):
        conns.append(_register(tr, str(i)))
        _wait(lambda: len(tr._ranks) > i, "registration")
    got = [_assignment(c) for c in conns]
    for c in conns:
        _send_u32(c, 1)
        c.close()
    return got


def _wait(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.02)


def _resume(cls, dead, root, **kw):
    """``resume=True`` on the dead tracker's port (its listener may
    linger a moment)."""
    deadline = time.monotonic() + 10
    while True:
        try:
            return cls(dead.nworkers, host=dead.host, port=dead.port,
                       wal_dir=root, resume=True, **kw)
        except OSError:
            assert time.monotonic() < deadline, "port never freed"
            time.sleep(0.05)


# ------------------------------------------------- journal, crash, resume

def test_wal_off_is_byte_identical_and_a_formation_is_journaled(tmp_path):
    plain = Tracker(2).start()
    waled = Tracker(2, wal_dir=str(tmp_path)).start()
    try:
        got_plain, got_waled = _form(plain), _form(waled)
        for a, b in zip(got_plain, got_waled):
            assert a == b
        assert plain._wal_log is None and plain.wal_records() == 0
        assert not plain.in_resume_grace() and not waled.in_resume_grace()
        assert waled.wal_records() == 4
    finally:
        plain.stop()
        waled.stop()
    assert os.listdir(str(tmp_path)) == [LOG_NAME]
    assert WriteAheadLog(str(tmp_path)).replay() == [
        ("assign", {"task": "0", "rank": 0}),
        ("assign", {"task": "1", "rank": 1}),
        ("epoch", {"epoch": 1, "members": [0, 1]}),
        ("topo", {"doc": {"epoch": 1, "groups": [[0, 1]], "delegates": [0],
                          "single_host": True}})]


def test_crash_resume_readopts_the_world_on_the_pinned_port(tmp_path,
                                                           capfd):
    tr = Tracker(2, wal_dir=str(tmp_path)).start()
    res = res2 = None
    try:
        _form(tr)
        c = _request(tr, "shutdown", "0")
        assert _recv_u32(c) == 1
        tr.crash()
        res = _resume(Tracker, tr, str(tmp_path)).start()
        assert res.port == tr.port
        assert (res._ranks, res._epoch, res.restarts) == \
            ({"0": 0, "1": 1}, 1, 1)
        assert res._shutdown_ranks == {0}   # the replayed "down"
        assert res.replayed == 5 and res.replay_ms > 0
        assert "[tracker] resumed from WAL (5 records, restart #1, " \
               "epoch 1, 2 known ranks)" in capfd.readouterr().err
        # a second crash and resume keeps counting
        res.crash()
        res2 = _resume(Tracker, res, str(tmp_path)).start()
        assert res2.restarts == 2 and res2._ranks == {"0": 0, "1": 1}
        assert res2.wal_records() == 7
    finally:
        for t in (res2, res, tr):
            if t is not None:
                t.stop()
    kinds = [k for k, _ in WriteAheadLog(str(tmp_path)).replay()]
    assert kinds == ["assign", "assign", "epoch", "topo", "down", "resume",
                     "resume"]
    assert [d["restarts"] for k, d in
            WriteAheadLog(str(tmp_path)).replay() if k == "resume"] == [1, 2]


@pytest.mark.parametrize("task,doc,drop", [
    ("0", {"rank": 0, "epoch": 1}, None),      # matching identity: 1
    ("0", {"rank": 1, "epoch": 1}, None),      # contradicting rank: 0
    ("1", {"rank": 1, "epoch": 99}, None),     # an epoch from the future
    ("1", {"rank": 1, "epoch": 1}, "1"),       # lost to a torn tail: adopt
    ("9", {"rank": 1, "epoch": 1}, None),      # a new task on a taken rank
    ("9", {"rank": 5, "epoch": 1}, None),      # a rank out of range
])
def test_resume_handshake_answers_as_the_jax_tracker(tmp_path, task, doc,
                                                     drop):
    answers, ranks = [], []
    for cls in (jax_tracker.Tracker, Tracker):
        root = str(tmp_path / cls.__module__)
        tr = cls(2, wal_dir=root).start()
        res = None
        try:
            _form(tr)
            tr.crash()
            res = _resume(cls, tr, root).start()
            if drop is not None:
                with res._lock:
                    del res._ranks[drop]
            c = _request(res, "resume", task, json.dumps(doc))
            answers.append(_recv_u32(c))
            c.close()
            ranks.append((dict(res._ranks), set(res._resumed_ranks)))
        finally:
            if res is not None:
                res.stop()
            tr.stop()
        ranks[-1] += ([k for k, _ in WriteAheadLog(root).replay()],)
    assert answers[0] == answers[1], answers
    assert ranks[0] == ranks[1]
    assert answers[0] == (1 if doc == {"rank": 0, "epoch": 1} or drop
                          else 0)


@pytest.mark.parametrize("grace_ms,in_grace", [("60000", True),
                                               ("0", False)])
def test_resume_grace_window(tmp_path, monkeypatch, grace_ms, in_grace):
    tr = Tracker(2, wal_dir=str(tmp_path)).start()
    res = None
    try:
        _form(tr)
        tr.crash()
        monkeypatch.setenv("RABIT_TRACKER_RESUME_GRACE_MS", grace_ms)
        res = _resume(Tracker, tr, str(tmp_path)).start()
        assert res.in_resume_grace() == in_grace
        assert not tr.in_resume_grace()   # a cold tracker never opens it
        assert port_tracker.resume_grace_ms() == \
            jax_tracker.resume_grace_ms()
    finally:
        if res is not None:
            res.stop()
        tr.stop()
    monkeypatch.setenv("RABIT_TRACKER_RESUME_GRACE_MS", "soon")
    with pytest.raises(ValueError):
        port_tracker.resume_grace_ms()


@pytest.mark.parametrize("grace_ms,evicted", [("60000", []),
                                              ("0", [1])])
def test_poll_loop_waives_eviction_in_the_resume_grace(tmp_path,
                                                       monkeypatch,
                                                       grace_ms, evicted):
    """An elastic resumed tracker polls an endpoint that answered before
    and is now silent: inside the grace the silence evicts nobody, after
    it the rank goes."""
    monkeypatch.setenv("RABIT_METRICS_POLL_MS", "30")
    monkeypatch.setenv("RABIT_TRACKER_RESUME_GRACE_MS", grace_ms)
    tr = Tracker(2, wal_dir=str(tmp_path), elastic=True).start()
    res = None
    try:
        _form(tr)
        tr.crash()
        res = _resume(Tracker, tr, str(tmp_path), elastic=True,
                      metrics_port=0).start()
        dead = socket.socket()
        dead.bind(("127.0.0.1", 0))
        dead_port = dead.getsockname()[1]
        dead.close()
        with res._lock:
            res._metrics["1"] = {"rank": 1}   # it answered before
        c = _request(res, "endpoint", "1", json.dumps(
            {"host": "127.0.0.1", "port": dead_port, "rank": 1}))
        assert _recv_u32(c) == 1
        _wait(lambda: res.live_stats()["polls"] >= 10, "ten sweeps")
        assert res.membership_doc()["evicted"] == evicted
    finally:
        if res is not None:
            res.stop()
        tr.stop()


def _dropped(conn):
    """True when the peer closed ``conn`` (a FIN, or an RST where it left
    bytes unread) within 5 s."""
    conn.settimeout(5)
    try:
        return conn.recv(4) == b""
    except ConnectionResetError:
        return True


def test_crash_drops_every_connection_and_journals_nothing_more(tmp_path):
    """A crashed tracker answers nothing: a parked joiner and a request
    in flight are dropped, its listener refuses, no record lands after
    the crash, and the port is free at once."""
    tr = Tracker(2, wal_dir=str(tmp_path), elastic=True).start()
    try:
        _form(tr)
        c = _request(tr, "evict", "1", json.dumps({"rank": 1}))
        assert _recv_u32(c) == 1
        joiner = _register(tr, "1", "join")          # parked
        _wait(lambda: 1 in tr._pending, "the joiner parked")
        half = _request(tr, "endpoint", "0")         # payload never sent
        size = os.path.getsize(tmp_path / LOG_NAME)
        t0 = time.monotonic()
        tr.crash()
        assert _dropped(joiner) and _dropped(half)
        assert time.monotonic() - t0 < 2
        with pytest.raises(OSError):
            socket.create_connection((tr.host, tr.port), timeout=1)
        with tr._lock:
            with pytest.raises(ConnectionError):
                tr._wal("epoch", epoch=9)
        assert os.path.getsize(tmp_path / LOG_NAME) == size
        probe = socket.socket()
        probe.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        probe.bind((tr.host, tr.port))
        probe.close()
    finally:
        tr.stop()


@pytest.mark.parametrize("cls", [jax_tracker.Tracker, Tracker],
                         ids=["jax", "port"])
def test_a_stopped_tracker_stops_listening(cls):
    """``stop()`` shuts the listener: a connection after it is refused,
    as the JAX tracker's. A bare ``close`` of a socket another thread is
    blocked on in ``accept`` left it listening."""
    tr = cls(1).start()
    addr = (tr.host, tr.port)
    c = socket.create_connection(addr, timeout=5)
    c.close()
    time.sleep(0.1)    # the serve loop is back in accept
    tr.stop()
    time.sleep(0.1)
    with pytest.raises(OSError):
        socket.create_connection(addr, timeout=1).close()


def test_journaling_rule_holds_on_the_port_tracker():
    """The JAX lint's R003 over the port's tracker: every function that
    mutates journaled state (ranks, epoch, topology, skew, endpoints,
    membership transitions) calls ``_wal``; and so does every function
    that records a shutdown. The rule flags a copy with one call taken
    out."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import lint
    finally:
        sys.path.pop(0)
    src = (ROOT / "rabit_tpu_torch" / "tracker" / "tracker.py").read_text()
    tree = ast.parse(src)
    assert lint._r003_issues(lint.R003_FILE, tree) == []
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and \
                not node.name.startswith(("__init__", "_replay")):
            adds = [n for n in ast.walk(node) if isinstance(n, ast.Call)
                    and isinstance(n.func, ast.Attribute)
                    and n.func.attr == "add"
                    and getattr(n.func.value, "attr", "") ==
                    "_shutdown_ranks"]
            calls = {n.func.attr for n in ast.walk(node)
                     if isinstance(n, ast.Call)
                     and isinstance(n.func, ast.Attribute)}
            assert not adds or "_wal" in calls, node.name
    broken = src.replace('            self._wal("topo", doc=topo, _job=job)\n',
                         "")
    assert broken != src
    issues = lint._r003_issues(lint.R003_FILE, ast.parse(broken))
    assert [i[2] for i in issues] == ["R003"] and "'_assign'" in issues[0][3]


def test_skew_poller_reconnect_presents_resume(tmp_path, monkeypatch):
    """A tripped skew poller pointed at a resumed tracker re-arms and
    re-presents the worker's identity (the ``resume`` handshake lands in
    ``_resumed_ranks``)."""
    from rabit_tpu_torch.telemetry import skew
    from rabit_tpu_torch.tracker import membership
    tr = Tracker(2, wal_dir=str(tmp_path)).start()
    res = None
    try:
        _form(tr)
        tr.crash()
        res = _resume(Tracker, tr, str(tmp_path)).start()
        monkeypatch.setenv("RABIT_TRACKER_URI", res.host)
        monkeypatch.setenv("RABIT_TRACKER_PORT", str(res.port))
        monkeypatch.setenv("RABIT_SKEW_TRACKER", f"{res.host}:{res.port}")
        monkeypatch.setenv("RABIT_SKEW_POLL_MS", "50")
        monkeypatch.setattr(membership, "_identity", None)
        membership.note_identity("0", 0, 1)
        mon = skew.SkewMonitor()
        mon._misses = skew.BREAKER_FAILURES   # tripped by the outage
        mon._ensure_poller()
        try:
            _wait(lambda: 0 in res._resumed_ranks
                  and not mon.breaker_state()["tripped"], "re-armed")
        finally:
            mon._stop.set()
    finally:
        if res is not None:
            res.stop()
        tr.stop()


# ------------------------------------- worlds that compute through a crash

def _streams(out):
    """task -> [(round, crc)] and the log lines, from the workers' logs."""
    got = {}
    for p in sorted(Path(out).glob("r*.log")):
        lines = p.read_text().splitlines()
        got[p.stem[1:]] = (
            [(int(m.group(1)), m.group(2)) for m in
             (re.match(r"round=(\d+) crc=([0-9a-f]{8})$", ln)
              for ln in lines) if m], lines)
    return got


def _cli(*args):
    """The standalone tracker in a process of its own; returns it and its
    address (from its first line on stderr)."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    proc = subprocess.Popen(
        [sys.executable, "-m", "rabit_tpu_torch.tracker.tracker", *args],
        cwd=ROOT, env=env, stderr=subprocess.PIPE, text=True)
    for line in proc.stderr:
        m = re.search(r"listening on ([\d.]+):(\d+)", line)
        if m:
            return proc, m.group(1), int(m.group(2))
    raise AssertionError(f"the tracker exited rc={proc.wait()}")


def _workers(n, host, port, out, env_extra):
    procs = []
    for i in range(n):
        env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        env.update({"PYTHONPATH": str(ROOT), "RABIT_TRACKER_URI": host,
                    "RABIT_TRACKER_PORT": str(port), "RABIT_TASK_ID": str(i),
                    "RABIT_NUM_TRIAL": "0", "RABIT_WORLD_SIZE": str(n),
                    "RABIT_SLAVE_PORT": "0", "RESUME_OUT": str(out),
                    **env_extra})
        procs.append(subprocess.Popen(
            [sys.executable, str(WORKER), "rabit_engine=robust"], env=env))
    return procs


def _finish(procs, timeout=120):
    deadline = time.monotonic() + timeout
    rcs = []
    for p in procs:
        try:
            rcs.append(p.wait(max(1, deadline - time.monotonic())))
        except subprocess.TimeoutExpired:
            p.kill()
            rcs.append(p.wait())
    return rcs


ROUNDS = {"RESUME_ROUNDS": "40", "RESUME_ROUND_SLEEP_MS": "150",
          "RABIT_SKEW_POLL_MS": "100", "RESUME_DEADLINE": "100"}


def test_cli_tracker_killed_and_resumed_keeps_the_crc_stream(tmp_path):
    """Three native-engine workers under the standalone tracker stream
    int64 CRCs; the tracker dies by SIGKILL after round 5 and comes back
    with ``--resume`` on the same port: every round, bit for bit the
    uninterrupted run's, no worker restarted."""
    _native_build.build()
    n = 3
    base, hit, wal = tmp_path / "base", tmp_path / "hit", tmp_path / "wal"
    base.mkdir()
    hit.mkdir()
    # more rounds than the supervisor's test: the resumed tracker is a new
    # interpreter, which takes seconds to start on a loaded machine
    env = dict(ROUNDS, RESUME_ROUNDS="60")
    tr, host, port = _cli("-n", str(n))
    rcs = _finish(_workers(n, host, port, base, env))
    assert rcs == [0] * n and tr.wait(30) == 0

    tr, host, port = _cli("-n", str(n), "--wal-dir", str(wal))
    procs = _workers(n, host, port, hit, env)
    try:
        _wait(lambda: all(any(r >= 5 for r, _ in s) for s, _ in
                          _streams(hit).values()) and len(_streams(hit)) == n,
              "round 5 everywhere", timeout=90)
        tr.send_signal(signal.SIGKILL)
        assert tr.wait(10) == -signal.SIGKILL
        time.sleep(1.0)                          # the outage
        res, _, rport = _cli("-n", str(n), "--host", host, "--port",
                             str(port), "--resume", str(wal))
        assert rport == port
        rcs = _finish(procs)
        assert rcs == [0] * n, rcs
        assert res.wait(30) == 0
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    want, got = _streams(base), _streams(hit)
    for t in map(str, range(n)):
        assert [r for r, _ in got[t][0]] == list(range(60)), got[t][1]
        assert got[t][0] == want[t][0], f"task {t}'s CRC stream diverged"
        assert "done" in got[t][1]
    # every worker saw the outage, and no longer than the test made it
    seen = [float(ln.split("=")[1]) for t in got for ln in got[t][1]
            if ln.startswith("outage s=")]
    assert len(seen) == n and min(seen) >= 1.0, seen
    kinds = [k for k, _ in WriteAheadLog(str(wal)).replay()]
    assert kinds.count("assign") == n and kinds.count("epoch") == 1
    assert kinds.count("resume") == 1 and kinds.count("down") == n


def test_launcher_supervisor_resumes_a_killed_tracker_on_gloo(tmp_path,
                                                             monkeypatch):
    """The launcher's supervisor: a tick kills the tracker after round 5,
    the WAL'd tracker comes back after the outage, and the world (the
    robust engine over a gloo data plane, a histogram a round) streams
    every round as the uninterrupted run did, with no respawn; without a
    WAL a killed tracker stays dead."""
    _native_build.build()
    n = 2
    cmd = [sys.executable, str(WORKER), "rabit_dataplane=torch",
           "rabit_device=cpu", "rabit_dataplane_minbytes=0"]
    env = dict(ROUNDS, RESUME_HIST_ROWS="4096", RESUME_HIST_BINS="64")

    def run(out, wal=None, kill_after=None):
        out.mkdir()
        if wal is None:
            monkeypatch.delenv("RABIT_TRACKER_WAL_DIR", raising=False)
        else:
            monkeypatch.setenv("RABIT_TRACKER_WAL_DIR", str(wal))
        killed = []

        def tick(sup):
            if kill_after is not None and not killed and \
                    len(_streams(out)) == n and \
                    all(any(r >= kill_after for r, _ in s)
                        for s, _ in _streams(out).values()):
                killed.append(sup.tracker)
                sup.kill(800)

        stats = {}
        rc = port_launch.launch(n, cmd, max_attempts=0, timeout=150,
                                quiet=True, stats=stats,
                                env=dict(env, RESUME_OUT=str(out)),
                                tick=tick)
        return rc, stats

    rc, stats = run(tmp_path / "base")
    assert rc == 0 and stats["tracker_restarts"] == 0
    assert stats["tracker_wal"]["dir"] is None
    rc, stats = run(tmp_path / "hit", tmp_path / "wal", kill_after=5)
    assert rc == 0
    wal = stats["tracker_wal"]
    assert stats["tracker_restarts"] == 1 and wal["restarts"] == 1, stats
    assert wal["records"] > 0 and wal["replayed"] > 0 and \
        wal["replay_ms"] > 0
    assert len(wal["killed_at"]) == len(wal["resumed_at"]) == 1
    assert stats["total_attempts"] == 0 and stats["readmissions"] == 0
    assert stats["epoch"] == 1
    want, got = _streams(tmp_path / "base"), _streams(tmp_path / "hit")
    for t in map(str, range(n)):
        assert got[t][0] == want[t][0] and len(got[t][0]) == 40
        doc = json.loads((tmp_path / "hit" / f"r{t}.json").read_text())
        assert {r["hist_crc"] for r in doc["rounds"]} != {None}
        assert doc["launches"] == [0] * 40   # the plain version on the CPU
        assert doc["epoch"] == 1
    kinds = [k for k, _ in WriteAheadLog(str(tmp_path / "wal")).replay()]
    assert "resume" in kinds and "epoch" in kinds and "topo" in kinds
    assert kinds.count("down") == n

    # without a WAL the killed tracker stays dead: the world computes on,
    # but its shutdown finds no tracker and the launch times out
    quiet = Tracker(1).start()
    sup = port_launch._TrackerSupervisor(quiet, None,
                                         lambda h, p: Tracker(1), quiet=True)
    sup.kill(0)
    sup.poll()
    assert sup.tracker is quiet and quiet.crashed and sup.restarts == 0
    sup.kill(0)                       # a second kill of a dead one: no-op
    assert sup.crashed == [quiet]
    quiet.stop()


def test_new_modules_and_worker_import_neither_jax_nor_rabit_tpu():
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', "
            "'rabit_tpu'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import rabit_tpu_torch.tracker.wal\n"
            "import rabit_tpu_torch.tracker.tracker\n"
            "import rabit_tpu_torch.tracker.launch\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    tree = ast.parse(WORKER.read_text())
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom)]
    assert not [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "rabit_tpu")]
