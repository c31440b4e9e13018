"""The port's write-ahead log (``rabit_tpu_torch/tracker/wal.py``) against
the JAX package's: the frame format and its failure rules, snapshot
compaction and the replay fold, the CLI, and the cross-replay -- the same
transitions driven through both trackers give byte-identical journals,
each package's ``WriteAheadLog`` replays the other's, and the two
``fold_records`` agree."""

import json
import os
import shutil
import socket
import struct
import sys
import time
import zlib

import pytest

from rabit_tpu.tracker import tracker as jax_tracker
from rabit_tpu.tracker import wal as jax_wal
from rabit_tpu_torch.tracker import tracker as port_tracker
from rabit_tpu_torch.tracker import wal as port_wal
from rabit_tpu_torch.tracker.wal import (
    LOG_NAME, MAGIC, SNAPSHOT_KIND, WalCorruptError, WalError,
    WalVersionError, WriteAheadLog, encode_record)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


# ------------------------------------------------------------- the format

def test_constants_and_knobs_are_the_jax_packages(monkeypatch):
    for name in ("MAGIC", "LOG_NAME", "MAX_RECORD_BYTES", "WAL_DIR_ENV",
                 "SNAPSHOT_KIND", "SNAPSHOT_V", "SNAPSHOT_EVERY_ENV",
                 "SNAPSHOT_EVERY_DEFAULT", "LEASE_KIND"):
        assert getattr(port_wal, name) == getattr(jax_wal, name), name
    for raw in ("", "5", "-3", "x"):
        monkeypatch.setenv("RABIT_WAL_SNAPSHOT_EVERY", raw)
        assert port_wal.snapshot_every() == jax_wal.snapshot_every()


@pytest.mark.parametrize("kind,data", [
    ("epoch", {"b": 2, "a": 1}),
    ("assign", {"task": "t0", "rank": 3}),
    ("topo", {"doc": {"epoch": 1, "groups": [[0, 1]], "delegates": [0],
                      "single_host": True}}),
    ("skew", {"digest": {"epoch": 2, "laggard": 1,
                         "offsets_ms": {"0": 0.0, "1": 80.5}}}),
    ("endpoint", {"task": "é", "doc": {"host": "h", "port": 1, "rank": 0}}),
])
def test_encode_record_is_canonical_and_the_jax_bytes(kind, data):
    a = encode_record(7, kind, data)
    assert a == jax_wal.encode_record(7, kind, data)
    assert a == encode_record(7, kind, dict(reversed(list(data.items()))))
    length, crc = struct.unpack_from("<II", a)
    payload = a[8:]
    assert len(payload) == length and zlib.crc32(payload) == crc
    assert json.loads(payload) == {"seq": 7, "kind": kind, "data": data}
    assert port_wal.decode_record(a) == (7, kind, data)


def test_record_replay_roundtrip_and_fresh_open(tmp_path):
    w = WriteAheadLog(str(tmp_path))
    w.open()
    wrote = [("assign", {"task": "a", "rank": 0}),
             ("epoch", {"epoch": 1, "members": [0]}),
             ("topo", {"doc": {"hosts": ["h"]}}),
             ("skew", {"digest": {"epoch": 1, "laggard": 2}})]
    assert [w.record(k, **d) for k, d in wrote] == [1, 2, 3, 4]
    assert w.records_total == 4 and w.seq == 4
    w.close()
    assert WriteAheadLog(str(tmp_path)).replay() == wrote
    assert jax_wal.WriteAheadLog(str(tmp_path)).replay() == wrote
    w2 = WriteAheadLog(str(tmp_path))
    assert w2.open(resume=False) == []   # an atomic re-create
    w2.close()
    assert WriteAheadLog(str(tmp_path)).replay() == []
    assert not [n for n in os.listdir(str(tmp_path)) if n.startswith(".tmp")]


def _two_records(root):
    w = WriteAheadLog(root)
    w.open()
    w.record("assign", task="a", rank=0)
    w.record("epoch", epoch=1)
    w.close()
    return os.path.join(root, LOG_NAME)


def _flip_last(blob):
    blob[-1] ^= 0xFF                     # damage the FINAL record only


@pytest.mark.parametrize("damage,kept", [
    (b"\x40", 2),                                  # torn frame
    (struct.pack("<II", 64, 0xDEAD), 2),           # a frame, no payload
    (struct.pack("<II", 8, 0xDEAD) + b"shrt", 2),  # a short payload
    (_flip_last, 1),                               # a CRC-bad last record
])
def test_torn_tail_truncated_and_appendable(tmp_path, damage, kept):
    path = _two_records(str(tmp_path))
    blob = bytearray(open(path, "rb").read())
    size = len(blob)
    if callable(damage):
        damage(blob)
    else:
        blob += damage
    open(path, "wb").write(bytes(blob))
    want = [("assign", {"task": "a", "rank": 0}),
            ("epoch", {"epoch": 1})][:kept]
    w = WriteAheadLog(str(tmp_path))
    assert w.open(resume=True) == want
    assert w.truncated_bytes == (len(blob) - size if kept == 2
                                 else len(encode_record(2, "epoch",
                                                        {"epoch": 1})))
    assert w.record("down", rank=0) == kept + 1   # seq continues cleanly
    w.close()
    assert WriteAheadLog(str(tmp_path)).replay() == \
        want + [("down", {"rank": 0})]


def _corrupt_middle(path):
    blob = bytearray(open(path, "rb").read())
    blob[len(MAGIC) + 8 + 2] ^= 0xFF     # the first record's payload
    open(path, "wb").write(bytes(blob))


def _out_of_sequence(path):
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(encode_record(1, "assign", {"task": "a", "rank": 0}))
        f.write(encode_record(3, "epoch", {"epoch": 1}))  # skips seq 2
        f.write(encode_record(3, "epoch", {"epoch": 2}))  # not a tail


def _version_skew(path):
    open(path, "wb").write(b"RBTWAL99")


def _bad_magic(path):
    open(path, "wb").write(b"notawal!")


def _giant_length(path):
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<II", port_wal.MAX_RECORD_BYTES + 1, 0))
        f.write(b"\x00" * 64)


@pytest.mark.parametrize("corrupt,err", [
    (_corrupt_middle, WalCorruptError),
    (_out_of_sequence, WalCorruptError),
    (_version_skew, WalVersionError),
    (_bad_magic, WalCorruptError),
    (_giant_length, WalCorruptError),
    (os.remove, WalError),
])
def test_deeper_damage_is_fatal_in_both_packages(tmp_path, corrupt, err):
    path = _two_records(str(tmp_path))
    corrupt(path)
    with pytest.raises(err):
        WriteAheadLog(str(tmp_path)).replay()
    with pytest.raises(err):
        WriteAheadLog(str(tmp_path)).open(resume=True)
    jax_err = getattr(jax_wal, err.__name__)
    with pytest.raises(jax_err):
        jax_wal.WriteAheadLog(str(tmp_path)).replay()


def test_snapshot_continues_the_numbering_and_a_follower_adopts_a_jump(
        tmp_path):
    root = str(tmp_path / "leader")
    w = WriteAheadLog(root)
    w.open()
    for i in range(3):
        w.record("epoch", epoch=i + 1)
    seq, frame = w.snapshot({"fold": "of-3-records"}, ts=1.5)
    assert (seq, w.base, w.snapshot_seq) == (4, 3, 4)
    assert frame == jax_wal.encode_record(
        4, SNAPSHOT_KIND, {"v": port_wal.SNAPSHOT_V,
                           "state": {"fold": "of-3-records"}, "ts": 1.5})
    assert w.record("epoch", epoch=9) == 5
    w.close()
    got = WriteAheadLog(root)
    records = got.open(resume=True)
    assert [k for k, _ in records] == [SNAPSHOT_KIND, "epoch"]
    assert (got.seq, got.base, got.snapshot_seq) == (5, 3, 4)
    got.close()
    assert jax_wal.WriteAheadLog(root).replay() == records
    follower = WriteAheadLog(str(tmp_path / "follower"))
    follower.open()
    follower.record("epoch", epoch=1)    # a stale tail the jump folds
    assert follower.append_encoded(frame) == 4
    assert (follower.seq, follower.base) == (4, 3)
    assert follower.append_encoded(encode_record(5, "epoch",
                                                 {"epoch": 9})) == 5
    with pytest.raises(WalCorruptError):
        follower.append_encoded(encode_record(9, "epoch", {"epoch": 1}))
    follower.close()
    assert follower.replay() == records


def test_lease_helpers_are_the_jax_packages():
    lease = port_wal.lease_doc("leader", 2000, now_ms=1000)
    assert lease == jax_wal.lease_doc("leader", 2000, now_ms=1000)
    for now in (2999, 3000):
        assert port_wal.lease_expired(lease, now) == \
            jax_wal.lease_expired(lease, now)
    assert port_wal.lease_expired(None) and port_wal.lease_expired({"x": 1})
    renewed = port_wal.lease_doc("leader", 2000, now_ms=5000)
    other = port_wal.lease_doc("standby", 2000, now_ms=5000)
    for prev, new in ((lease, renewed), (lease, other), (None, lease)):
        assert port_wal.lease_renewal_only(prev, new) == \
            jax_wal.lease_renewal_only(prev, new)
    recs = [("lease", lease), ("epoch", {"epoch": 1}), ("lease", other)]
    assert port_wal.last_lease(recs) == other
    assert port_wal.last_lease(recs[1:2]) is None


# -------------------------------------------- the CLI and the inspection

def test_cli_compact_inspect_and_refusals(tmp_path, capsys):
    root = str(tmp_path / "wal")
    w = WriteAheadLog(root)
    w.open()
    w.record("assign", task="0", rank=0)
    w.record("epoch", epoch=1)
    w.close()
    twin = str(tmp_path / "jax")
    shutil.copytree(root, twin)
    assert port_wal._main(["--compact", root, "--nworkers", "2"]) == 0
    out = capsys.readouterr().out
    assert "compacted 2 records into a snapshot at seq 3" in out
    assert port_wal._main(["--inspect", root]) == 0
    out = capsys.readouterr().out
    assert "snapshot at seq 3" in out and "+0 tail records" in out
    doc = port_wal.inspect_journal(root)
    assert doc["base"] == 2 and doc["snapshot_seq"] == 3
    assert doc["tail_records"] == 0 and doc["error"] is None
    state = WriteAheadLog(root).replay()[0][1]["state"]
    assert state["jobs"]["default"]["ranks"] == {"0": 0}
    assert state["jobs"]["default"]["epoch"] == 1
    # the JAX package's compaction of the same journal folds the same
    # state (the timestamps differ)
    jax_wal.compact_dir(twin, nworkers=2)
    assert jax_wal.WriteAheadLog(twin).replay()[0][1]["state"] == state
    assert port_wal._main(["--inspect", root, "--json"]) == 0
    got = json.loads(capsys.readouterr().out)
    assert got["root"]["snapshot_seq"] == 3 and got["jobs"] == {}
    with pytest.raises(WalError):
        port_wal.compact_dir(str(tmp_path / "nope"))
    assert port_wal._main(["--compact", str(tmp_path / "nope")]) == 1
    # a damaged journal is reported, never raised
    _corrupt_middle(_two_records(str(tmp_path / "bad")))
    bad = port_wal.inspect_journal(str(tmp_path / "bad"))
    assert bad["error"].startswith("WalCorruptError")
    assert port_wal._main(["--inspect", str(tmp_path / "bad")]) == 1
    assert port_wal._main([]) == 2


def test_wal_smoke_runs_as_a_module():
    import subprocess
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run(
        [sys.executable, "-m", "rabit_tpu_torch.tracker.wal", "--smoke"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("wal smoke ok")


# --------------------------------------------- both trackers, same script

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


def _request(tr, cmd, task, *fields):
    c = socket.create_connection((tr.host, tr.port), timeout=30)
    _send_u32(c, jax_tracker.MAGIC)
    _send_str(c, cmd)
    _send_str(c, task)
    _send_u32(c, 0)
    for f in fields:
        if isinstance(f, str):
            _send_str(c, f)
        else:
            _send_u32(c, f)
    return c


def _register(tr, cmd, task):
    return _request(tr, cmd, task, "127.0.0.1", 9000 + int(task[1:]), 0, "")


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


def _wait(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.01)


def _batch(tr, regs):
    """Register ``(cmd, task)`` one at a time, each journaled before the
    next is sent, and read every assignment of the batch that forms."""
    conns = []
    for cmd, task in regs:
        n = tr.wal_records()
        conns.append(_register(tr, cmd, task))
        if len(conns) < len(regs):
            _wait(lambda: tr.wal_records() > n or cmd == "recover",
                  f"{cmd} {task} journaled")
            time.sleep(0.05)
    return sorted(_read_and_ack(c) for c in conns)


class _Election:
    """A fleet election that elects once the test says so: the poll loop
    journals its verdict at that point of the script in both trackers."""

    def __init__(self):
        self.digest = None

    def fold(self, raw):
        return self.digest


def _resume(cls, dead, root):
    deadline = time.monotonic() + 10
    while True:
        try:
            return cls(dead.nworkers, host=dead.host, port=dead.port,
                       wal_dir=root, resume=True, elastic=dead.elastic)
        except OSError:
            assert time.monotonic() < deadline, "port never freed"
            time.sleep(0.05)


def _script(cls, root, set_election):
    """Registration, endpoints, an eviction, the shrunk world, a parked
    joiner, the grown world, a skew verdict, a crash and a resume, the
    shutdowns; returns the journal's bytes at the end."""
    tr = cls(3, wal_dir=root, elastic=True, metrics_port=0).start()
    elect = _Election()
    set_election(tr, elect)
    res = None
    try:
        assert _batch(tr, [("start", "t0"), ("start", "t1"),
                           ("start", "t2")]) == \
            [(0, 3, 1), (1, 3, 1), (2, 3, 1)]
        for t in ("t0", "t1"):
            c = _request(tr, "endpoint", t, json.dumps(
                {"host": "127.0.0.1", "port": 1, "rank": int(t[1])}))
            assert _recv_u32(c) == 1
        c = _request(tr, "evict", "t1", json.dumps({"rank": 1,
                                                    "reason": "script"}))
        assert _recv_u32(c) == 1
        assert _batch(tr, [("recover", "t0"), ("recover", "t2")]) == \
            [(0, 2, 2), (1, 2, 2)]
        n = tr.wal_records()
        joiner = _register(tr, "join", "t1")
        _wait(lambda: tr.wal_records() > n, "the park journaled")
        grown = _batch(tr, [("recover", "t0"), ("recover", "t2")])
        assert grown + [_read_and_ack(joiner)] == \
            [(0, 3, 3), (2, 3, 3), (1, 3, 3)]
        n = tr.wal_records()
        elect.digest = {"epoch": 1, "laggard": 2,
                        "offsets_ms": {"0": 0.0, "1": 3.25, "2": 80.5}}
        _wait(lambda: tr.wal_records() > n, "the skew verdict journaled")
        time.sleep(0.2)   # later sweeps journal nothing (the same epoch)
        tr.crash()
        res = _resume(cls, tr, root).start()
        for t in ("t0", "t1", "t2"):
            c = _request(res, "shutdown", t)
            assert _recv_u32(c) == 1
        _wait(lambda: res.join(0), "the shutdowns")
        assert res.restarts == 1
    finally:
        if res is not None:
            res.stop()
        tr.stop()
    return open(os.path.join(root, LOG_NAME), "rb").read()


def _set_port(tr, elect):
    tr._skew_election = elect


def _set_jax(tr, elect):
    tr._default._skew_election = elect


def test_cross_replay_journals_are_byte_identical(tmp_path, monkeypatch):
    monkeypatch.setenv("RABIT_METRICS_POLL_MS", "50")
    monkeypatch.setenv("RABIT_TRACKER_RESUME_GRACE_MS", "0")
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    jax_bytes = _script(jax_tracker.Tracker, jroot, _set_jax)
    port_bytes = _script(port_tracker.Tracker, proot, _set_port)
    kinds = [k for k, _ in WriteAheadLog(proot).replay()]
    assert kinds == ["assign"] * 3 + ["epoch", "topo"] + ["endpoint"] * 2 \
        + ["evict", "epoch", "topo", "park", "epoch", "topo", "skew",
           "resume"] + ["down"] * 3
    assert port_bytes == jax_bytes
    # each package replays the other's journal to the same records
    from_jax = WriteAheadLog(jroot).replay()
    from_port = jax_wal.WriteAheadLog(proot).replay()
    assert from_jax == from_port == jax_wal.WriteAheadLog(jroot).replay()
    # and the two folds agree, on the whole journal and on every prefix
    for n in range(len(from_jax) + 1):
        want = jax_tracker.fold_records(from_jax[:n], nworkers=3,
                                        elastic=True)
        assert port_tracker.fold_records(from_port[:n], nworkers=3,
                                         elastic=True) == want, n
    fold = port_tracker.fold_records(from_port, nworkers=3, elastic=True)
    job = fold["jobs"]["default"]
    assert fold["restarts"] == 1 and job["epoch"] == 3
    assert job["member"]["live"] == [0, 1, 2] and job["down"] == [0, 1, 2]
    assert job["skew"]["laggard"] == 2 and job["endpoints"]["t1"]["rank"] == 1


def test_fold_refuses_what_this_tracker_does_not_serve():
    """Nothing of the JAX tracker's journal is refused now: the records
    of its multi-job plane (``job_open``, ``quota``, a job-tagged
    ``assign``, ``job_close``) fold into the port's job table as the JAX
    package folds them, and so do the hot standby's ``lease`` and
    ``promoted`` records and a snapshot that holds any of them."""
    jobs = [("job_open", {"job": "a", "nworkers": 2, "elastic": True}),
            ("assign", {"task": "t0", "rank": 0, "job": "a"}),
            ("quota", {"quota": 1, "preempted": 1, "job": "a"}),
            ("assign", {"task": "t9", "rank": 0, "job": "torn"}),
            ("job_open", {"job": "b", "nworkers": 1, "sched_class": 2}),
            ("job_close", {"job": "b", "reason": "complete"})]
    fold = port_tracker.fold_records(jobs)
    assert fold == jax_tracker.fold_records(jobs)
    assert fold["multi_job"] is True
    assert fold["jobs"]["a"]["quota"] == 1
    assert fold["jobs"]["a"]["ranks"] == {"t0": 0}
    assert fold["jobs"]["b"]["closed"] and fold["jobs"]["torn"]["ranks"]
    standby = [("lease", port_wal.lease_doc("leader", 2000, now_ms=5)),
               ("promoted", {"node": "standby", "wall": 1.5, "mono": 2.5,
                             "failover_ms": 812.25})]
    fold = port_tracker.fold_records(standby)
    assert fold == jax_tracker.fold_records(standby)
    assert fold["lease"]["owner"] == "leader"
    assert fold["promoted"]["failover_ms"] == 812.25
    snap = {"v": port_wal.SNAPSHOT_V, "ts": 0.0, "state": fold}
    assert port_tracker.fold_records([(SNAPSHOT_KIND, snap)]) == fold
    snap = {"v": port_wal.SNAPSHOT_V, "ts": 0.0,
            "state": port_tracker.fold_records(jobs)}
    assert port_tracker.fold_records([(SNAPSHOT_KIND, snap)]) == \
        jax_tracker.fold_records([(SNAPSHOT_KIND, snap)]) == snap["state"]


# ------------------------------------------------ snapshots of a tracker

def _busy_port_tracker(root):
    """An elastic port tracker with real history: a formed world of 3,
    endpoint announces, an eviction and the shrunk world."""
    tr = port_tracker.Tracker(3, wal_dir=root, elastic=True).start()
    assert _batch(tr, [("start", "t0"), ("start", "t1"),
                       ("start", "t2")])[0] == (0, 3, 1)
    for t in ("t0", "t1"):
        c = _request(tr, "endpoint", t, json.dumps(
            {"host": "127.0.0.1", "port": 9100 + int(t[1]),
             "rank": int(t[1])}))
        assert _recv_u32(c) == 1
    c = _request(tr, "evict", "t1", json.dumps({"rank": 1,
                                                "reason": "test"}))
    assert _recv_u32(c) == 1
    assert _batch(tr, [("recover", "t0"), ("recover", "t2")])[0] == \
        (0, 2, 2)
    return tr


def test_fold_records_is_the_live_state_and_compaction_replays_to_it(
        tmp_path):
    """The journal IS the state: ``fold_records`` over it equals the live
    tracker's own serialization at the crash, and a journal compacted
    offline resumes to the same state as the full one."""
    full, compacted = str(tmp_path / "full"), str(tmp_path / "compacted")
    tr = _busy_port_tracker(full)
    with tr._lock:
        live = port_tracker.snapshot_state(tr)
    tr.crash()
    records = WriteAheadLog(full).replay()
    assert port_tracker.fold_records(records, nworkers=3,
                                     elastic=True) == live
    assert live["jobs"]["default"]["member"]["evicted"] == [1]
    assert live["jobs"]["default"]["endpoints"]["t1"]["port"] == 9101
    shutil.copytree(full, compacted)
    out = port_wal.compact_dir(compacted, nworkers=3, elastic=True)
    assert out == {"folded": len(records), "seq": len(records) + 1}
    log = WriteAheadLog(compacted)
    assert [k for k, _ in log.open(resume=True)] == [SNAPSHOT_KIND]
    log.close()
    assert log.base == len(records)
    a = _resume(port_tracker.Tracker, tr, full).start()
    try:
        b = port_tracker.Tracker(3, wal_dir=compacted, resume=True,
                                 elastic=True).start()
        try:
            with a._lock, b._lock:
                assert port_tracker.snapshot_state(a) == \
                    port_tracker.snapshot_state(b)
            assert b._epoch == 2 and b.membership_doc()["live"] == [0, 2]
        finally:
            b.stop()
    finally:
        a.stop()
        tr.stop()


def test_live_snapshot_compacts_off_the_path_and_resumes(tmp_path,
                                                         monkeypatch):
    """``RABIT_WAL_SNAPSHOT_EVERY`` compacts a live journal into snapshot +
    tail, ``inspect`` reports it, and a crash -> resume replays it to the
    same world; unset, no snapshot is journaled."""
    root = str(tmp_path / "wal")
    monkeypatch.setenv("RABIT_WAL_SNAPSHOT_EVERY", "6")
    tr = port_tracker.Tracker(2, wal_dir=root).start()
    res = None
    try:
        assert _batch(tr, [("start", "t0"), ("start", "t1")]) == \
            [(0, 2, 1), (1, 2, 1)]
        for i in range(8):
            c = _request(tr, "endpoint", "t0", json.dumps(
                {"host": "127.0.0.1", "port": 9200 + i, "rank": 0}))
            assert _recv_u32(c) == 1
        _wait(lambda: tr.snapshot_seq() > 0, "a live snapshot")
        _wait(lambda: not tr._snap_pending, "the compaction's end")
        doc = port_wal.inspect_journal(root)
        assert doc["snapshot_seq"] == tr.snapshot_seq()
        assert doc["base"] == doc["snapshot_seq"] - 1
        assert doc["snapshot_age_s"] is not None
        with tr._lock:
            live = port_tracker.snapshot_state(tr)
        tr.crash()
        res = _resume(port_tracker.Tracker, tr, root).start()
        assert res._ranks == {"t0": 0, "t1": 1} and res._epoch == 1
        with res._lock:
            got = port_tracker.snapshot_state(res)
        got["restarts"] = live["restarts"]   # the resume counted itself
        assert got == live
        assert got["jobs"]["default"]["endpoints"]["t0"]["port"] == 9207
    finally:
        if res is not None:
            res.stop()
        tr.stop()
    monkeypatch.delenv("RABIT_WAL_SNAPSHOT_EVERY")
    plain = str(tmp_path / "plain")
    tr = port_tracker.Tracker(2, wal_dir=plain).start()
    try:
        _batch(tr, [("start", "t0"), ("start", "t1")])
        assert tr.snapshot_seq() == 0
    finally:
        tr.stop()
    assert SNAPSHOT_KIND not in [k for k, _ in
                                 WriteAheadLog(plain).replay()]
