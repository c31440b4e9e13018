"""The port's multi-job control plane (``rabit_tpu_torch/tracker/jobs.py``
and the per-job tracker) against the JAX package's: ``JobState``, the
task-id spelling, the admission queue, the ``submit`` verdicts of both
trackers on one sequence (preemption by class included), the quarantine,
byte-identical journals of the same multi-job transitions with each
package resuming from the other's, the orphan reaper and the forming
timeout, ``/jobs`` and the shed-rate objective, the bytes with multi-job
unset, and ``card_index`` for ``<job>/<i>`` task ids. Every comparison
is exact: these are control-plane bytes and integers."""

import json
import os
import shutil
import socket
import struct
import time

import pytest

from rabit_tpu.tracker import jobs as jax_jobs
from rabit_tpu.tracker import tracker as jax_tracker
from rabit_tpu.tracker import wal as jax_wal
from rabit_tpu_torch.tracker import jobs as port_jobs
from rabit_tpu_torch.tracker import tracker as port_tracker
from rabit_tpu_torch.tracker import wal as port_wal

PAIRS = ((port_tracker.Tracker, "port"), (jax_tracker.Tracker, "jax"))


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


def _request(tr, cmd, task, *fields):
    c = socket.create_connection((tr.host, tr.port), timeout=30)
    _send_u32(c, port_tracker.MAGIC)
    _send_str(c, cmd)
    _send_str(c, task)
    _send_u32(c, 0)
    for f in fields:
        if isinstance(f, str):
            _send_str(c, f)
        else:
            _send_u32(c, f)
    return c


def _wait(cond, what, timeout=20.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, f"timed out: {what}"
        time.sleep(0.01)


def _registered(tr, task):
    """Whether ``task``'s registration has been given its rank."""
    job, rest = (port_jobs.split_task(task) if tr.multi_job
                 else (port_jobs.DEFAULT_JOB, task))
    with tr._lock:
        jb = tr._jobs.get(job)
        return jb is not None and rest in jb._ranks


def _batch(tr, tasks):
    """Register ``tasks`` one at a time, each given its rank before the
    next is sent (ranks go by arrival), and read every assignment of the
    batch that forms: the sorted ``(rank, world, epoch)``."""
    conns = []
    for i, task in enumerate(tasks):
        conns.append(port_jobs.wire_register(tr.host, tr.port, task))
        if i + 1 < len(tasks):
            _wait(lambda: _registered(tr, task), f"{task} registered")
    return sorted(port_jobs.wire_read_assignment(c) for c in conns)


def _recover(tr, tasks):
    conns = []
    for task in tasks:
        c = _request(tr, "recover", task, "127.0.0.1", 9100, 0, "")
        conns.append(c)
        time.sleep(0.05)
    return sorted(port_jobs.wire_read_assignment(c) for c in conns)


def _strip_hlc(v):
    return {k: x for k, x in v.items() if k != "hlc"}


@pytest.fixture
def multi_env(monkeypatch):
    monkeypatch.setenv("RABIT_MULTI_JOB", "1")
    for k in ("RABIT_MAX_JOBS", "RABIT_MAX_FLEET_RANKS",
              "RABIT_ADMISSION_QUEUE", "RABIT_SCHED_CLASS",
              "RABIT_SCHED_WEIGHT", "RABIT_JOB_FORMING_TIMEOUT_MS",
              "RABIT_EVENTS", "RABIT_METRICS_PORT",
              "RABIT_TRACKER_WAL_DIR"):
        monkeypatch.delenv(k, raising=False)


# ------------------------------------------------------- jobs.py itself

def test_knobs_and_constants_are_the_jax_packages(monkeypatch):
    for name in ("DEFAULT_JOB", "JOB_SEP", "MULTI_JOB_ENV", "MAX_JOBS_ENV",
                 "MAX_FLEET_RANKS_ENV", "ADMISSION_QUEUE_ENV",
                 "SCHED_CLASS_ENV", "SCHED_WEIGHT_ENV", "MAX_JOBS_DEFAULT",
                 "MAX_FLEET_RANKS_DEFAULT", "ADMISSION_QUEUE_DEFAULT",
                 "RETRY_AFTER_MS_DEFAULT", "SCHED_CLASS_DEFAULT",
                 "SCHED_WEIGHT_DEFAULT", "JOB_STATUSES"):
        assert getattr(port_jobs, name) == getattr(jax_jobs, name), name
    knobs = ("multi_job_enabled", "max_jobs", "max_fleet_ranks",
             "admission_queue_depth", "sched_class", "sched_weight")
    for value in (None, "", "0", "3", "-2", "2.5", "junk"):
        for env in ("RABIT_MULTI_JOB", "RABIT_MAX_JOBS",
                    "RABIT_MAX_FLEET_RANKS", "RABIT_ADMISSION_QUEUE",
                    "RABIT_SCHED_CLASS", "RABIT_SCHED_WEIGHT"):
            if value is None:
                monkeypatch.delenv(env, raising=False)
            else:
                monkeypatch.setenv(env, value)
        for k in knobs:
            assert getattr(port_jobs, k)() == getattr(jax_jobs, k)(), \
                (k, value)


def test_jobstate_lifecycle_and_doc_equal_the_jax_ones():
    docs = {}
    for mod in (port_jobs, jax_jobs):
        jb = mod.JobState("a", 3, elastic=True, sched_class=2,
                          sched_weight=1.5)
        seen = [jb.status, jb.open]
        jb.mark_live()
        seen.append(jb.status)
        jb._member.formed({0, 1, 2})
        jb._member.evict(2)
        jb._shutdown_ranks |= {0, 1}
        seen.append(jb.all_down_locked())
        jb.mark_failed("all ranks lost")
        seen += [jb.status, jb.open, jb.live_world()]
        jb.mark_live()                     # an elastic re-formation
        jb.close("complete")
        jb.mark_live()                     # closed is terminal
        seen += [jb.status, jb.open]
        fixed = mod.JobState("f", 2)
        fixed._shutdown_ranks.add(0)
        seen.append(fixed.all_down_locked())
        fixed._shutdown_ranks.add(1)
        seen.append(fixed.all_down_locked())
        docs[mod] = (seen, jb.doc(), fixed.doc())
    assert docs[port_jobs] == docs[jax_jobs]
    seen, doc, _ = docs[port_jobs]
    assert seen == ["forming", True, "live", True, "failed", True, 2,
                    "closed", False, False, True]
    assert doc["closed_reason"] == "complete" and doc["live"] == [0, 1]


@pytest.mark.parametrize("task", ["alpha/7", "3", "/x", "a/b/c", "", "a/",
                                  "default/2", "j/0"])
def test_split_and_join_task_ids_equal_the_jax_ones(task):
    assert port_jobs.split_task(task) == jax_jobs.split_task(task)
    job, rest = port_jobs.split_task(task)
    assert port_jobs.job_task(job, rest) == jax_jobs.job_task(job, rest)


def test_admission_queue_equals_the_jax_one():
    qs = [port_jobs.AdmissionQueue(depth=2), jax_jobs.AdmissionQueue(depth=2)]
    script = [("offer", "a"), ("offer", "b"), ("offer", "a"), ("offer", "c"),
              ("peek", None), ("pop", None), ("offer", "d"), ("offer", "e"),
              ("snap", None), ("pop", None), ("pop", None), ("pop", None),
              ("len", None)]
    outs = []
    for q in qs:
        out = []
        for op, job in script:
            if op == "offer":
                out.append(q.offer({"job": job, "nworkers": 2}))
            elif op == "peek":
                out.append(q.peek())
            elif op == "pop":
                out.append(q.pop_front())
            elif op == "snap":
                out.append(q.snapshot())
            else:
                out.append(len(q))
        outs.append((out, q.queued_total, q.shed_total))
    assert outs[0] == outs[1]
    assert outs[0][0][:4] == [0, 1, 0, -1] and outs[0][1:] == (3, 2)


# -------------------------------------------------------- the verdicts

def _verdicts(cls, root):
    """One submit sequence against a multi-job tracker of ``cls``: the
    verdicts, the trackers' per-job docs, the preemption tally, the
    admission plane's documents and the journal's bytes."""
    tr = cls(2, wal_dir=root).start()
    try:
        out = []

        def sub(job, n, **kw):
            out.append(_strip_hlc(jax_jobs.submit(tr.host, tr.port, job, n,
                                                  **kw)))

        sub("A", 2, elastic=True)
        sub("A", 2, elastic=True)             # already open
        sub("B", 2)
        assert _batch(tr, ["A/0", "A/1"]) == [(0, 2, 1), (1, 2, 1)]
        assert _batch(tr, ["B/0", "B/1"]) == [(0, 2, 1), (1, 2, 1)]
        sub("C", 1)                           # the fleet is full: queued
        sub("D", 1)                           # the queue is full: shed
        sub("C", 1)                           # keeps its position
        sub("E", 5)                           # larger than the fleet
        sub("", 2)                            # malformed
        sub("F", 0)
        out.append(_strip_hlc(json.loads(_request_json(
            tr, "submit", "x", "{not json"))))
        sub("H", 1, elastic=True, sched_class=2)   # preempts A's rank 1
        sub("P", 1, elastic=True)             # same class: no preemption
        a = tr.job("A")
        assert sorted(a._member.live) == [0]
        assert _recover(tr, ["A/0"]) == [(0, 1, 2)]
        for t in ("B/0", "B/1"):
            c = _request(tr, "shutdown", t)
            assert struct.unpack("<I", _recv_all(c, 4))[0] == 1
        _wait(lambda: tr.job("C") is not None, "C admitted at B's close")
        docs = {jid: tr.job(jid).doc() for jid in ("A", "B", "C", "H")}
        res = (out, docs, dict(tr.sched_preemptions), tr._jobs_doc(),
               tr._slo_doc(), tr.submit_admitted_total)
    finally:
        tr.stop()
    journal = {}
    for dirpath, _dirs, files in os.walk(root):
        for f in files:
            path = os.path.join(dirpath, f)
            journal[os.path.relpath(path, root)] = open(path, "rb").read()
    return res, journal


def _request_json(tr, cmd, task, payload):
    c = _request(tr, cmd, task, payload)
    n = struct.unpack("<I", _recv_all(c, 4))[0]
    return _recv_all(c, n)


def test_submit_verdicts_and_journals_equal_the_jax_trackers(
        multi_env, monkeypatch, tmp_path):
    monkeypatch.setenv("RABIT_MAX_FLEET_RANKS", "4")
    monkeypatch.setenv("RABIT_MAX_JOBS", "3")
    monkeypatch.setenv("RABIT_ADMISSION_QUEUE", "1")
    got = {tag: _verdicts(cls, str(tmp_path / tag)) for cls, tag in PAIRS}
    (port, port_journal), (jax, jax_journal) = got["port"], got["jax"]
    assert port == jax
    verdicts, docs, preempt, jobs_doc, slo_doc, admitted = port
    assert verdicts[:3] == [{"ok": 1, "job": "A"},
                            {"ok": 1, "job": "A", "already": 1},
                            {"ok": 1, "job": "B"}]
    assert verdicts[3] == {"ok": 0, "queued": 1, "position": 0,
                           "retry_after_ms": 500}
    assert verdicts[4] == {"ok": 0, "shed": 1, "retry_after_ms": 1000}
    assert verdicts[5]["position"] == 0
    assert "rabit_max_fleet_ranks 4" in verdicts[6]["error"]
    assert all("error" in v for v in verdicts[7:10])
    assert verdicts[10] == {"ok": 1, "job": "H", "preempted": 1}
    assert verdicts[11]["shed"] == 1   # an equal class preempts nothing
    assert preempt == {0: 1}
    assert docs["A"]["quota"] == 1 and docs["A"]["preempted"] == 1
    assert docs["A"]["epoch"] == 2 and docs["A"]["world"] == 1
    assert docs["B"]["status"] == "closed" and docs["C"]["status"] == \
        "forming" and docs["H"]["sched_class"] == 2
    assert jobs_doc["queue"] == []   # C went in at B's close
    assert (jobs_doc["queued_total"], jobs_doc["shed_total"], admitted) \
        == (1, 2, 4)
    # the shed rate: 2 shed of 4 admitted + 1 queued + 2 shed
    (shed,) = [v for v in slo_doc["slos"] if v["slo"] == "shed_rate"]
    assert shed["value"] == 2 / 7
    # the root journal and each job's mirror, byte for byte
    assert sorted(port_journal) == sorted(jax_journal) == [
        os.path.join(j, port_wal.LOG_NAME) for j in ("A", "B", "C", "H")] \
        + [port_wal.LOG_NAME]
    assert port_journal == jax_journal


def test_cross_resume_readopts_live_jobs_and_not_closed_ones(
        multi_env, monkeypatch, tmp_path):
    """Each package resumes from the other's journal of the same
    multi-job transitions: the live jobs with their own epochs and ranks,
    the closed one closed, and the two resumed trackers' state equal."""
    monkeypatch.setenv("RABIT_MAX_FLEET_RANKS", "4")
    monkeypatch.setenv("RABIT_MAX_JOBS", "3")
    monkeypatch.setenv("RABIT_ADMISSION_QUEUE", "1")
    for cls, tag in PAIRS:
        _verdicts(cls, str(tmp_path / tag))
    records = {tag: port_wal.WriteAheadLog(str(tmp_path / tag)).replay()
               for tag in ("port", "jax")}
    assert records["port"] == records["jax"] == \
        jax_wal.WriteAheadLog(str(tmp_path / "port")).replay()
    for n in range(len(records["jax"]) + 1):
        assert port_tracker.fold_records(records["jax"][:n], nworkers=2) \
            == jax_tracker.fold_records(records["port"][:n], nworkers=2), n
    states = {}
    for (cls, tag), src in zip(PAIRS, ("jax", "port")):
        root = str(tmp_path / f"resume_{tag}")
        shutil.copytree(str(tmp_path / src), root)
        tr = cls(2, wal_dir=root, resume=True)
        try:
            a, b = tr._jobs["A"], tr._jobs["B"]
            assert a.open and a._epoch == 2 and a._ranks == {"0": 0, "1": 1}
            assert not b.open and b.closed_reason == "complete"
            assert tr._orphan_jobs == {"A", "C", "H"}
            with tr._lock:
                states[tag] = (port_tracker.snapshot_state(tr)
                               if tag == "port"
                               else jax_tracker.snapshot_state(tr))
        finally:
            tr._wal_log.close()
    assert states["port"] == states["jax"]
    assert states["port"]["multi_job"] is True
    assert states["port"]["restarts"] == 1


def test_snapshot_of_a_multi_job_tracker_resumes_in_both_packages(
        multi_env, monkeypatch, tmp_path):
    """A live compaction of the port's multi-job journal: each package's
    resume adopts the snapshot, every job with it."""
    monkeypatch.setenv("RABIT_WAL_SNAPSHOT_EVERY", "4")
    root = str(tmp_path / "wal")
    tr = port_tracker.Tracker(2, wal_dir=root).start()
    try:
        for job in ("A", "B"):
            assert port_jobs.submit(tr.host, tr.port, job, 2)["ok"] == 1
            assert _batch(tr, [f"{job}/0", f"{job}/1"]) == \
                [(0, 2, 1), (1, 2, 1)]
        _wait(lambda: tr.snapshot_seq() > 0, "a snapshot")
        with tr._lock:
            live = port_tracker.snapshot_state(tr)
    finally:
        tr.stop()
    for cls in (port_tracker.Tracker, jax_tracker.Tracker):
        copy = str(tmp_path / cls.__module__)
        shutil.copytree(root, copy)
        res = cls(2, wal_dir=copy, resume=True)
        try:
            with res._lock:
                got = (port_tracker.snapshot_state(res)
                       if cls is port_tracker.Tracker
                       else jax_tracker.snapshot_state(res))
            assert got["jobs"] == live["jobs"] and got["multi_job"]
        finally:
            res._wal_log.close()


# ------------------------------------------------------- the boundary

def test_quarantine_is_counted_on_the_job_and_the_tracker_serves_on(
        multi_env):
    for cls, tag in PAIRS:
        tr = cls(2).start()
        try:
            assert port_jobs.submit(tr.host, tr.port, "q", 2)["ok"] == 1
            assert port_jobs.submit(tr.host, tr.port, "n", 2)["ok"] == 1
            # an endpoint whose port is no integer: int() raises in the
            # handler, which the job boundary quarantines
            c = _request(tr, "endpoint", "q/0",
                         json.dumps({"host": "h", "port": "not-a-port"}))
            assert c.recv(4) == b""   # that connection only is closed
            c.close()
            _wait(lambda: tr.job("q").quarantined == 1, "quarantined")
            # the tracker's lock is free and the neighbour untouched
            assert tr._lock.acquire(timeout=5)
            tr._lock.release()
            assert tr.job("n").quarantined == 0
            assert _batch(tr, ["q/0", "q/1"]) == [(0, 2, 1), (1, 2, 1)]
            assert _batch(tr, ["n/0", "n/1"]) == [(0, 2, 1), (1, 2, 1)]
            assert tr.job("q").status == tr.job("n").status == "live"
        finally:
            tr.stop()


def test_job_failure_is_isolated(multi_env):
    tr = port_tracker.Tracker(2).start()
    try:
        assert port_jobs.submit(tr.host, tr.port, "victim", 2,
                                elastic=True)["ok"] == 1
        assert port_jobs.submit(tr.host, tr.port, "healthy", 2)["ok"] == 1
        assert _batch(tr, ["victim/0", "victim/1"]) == [(0, 2, 1), (1, 2, 1)]
        assert _batch(tr, ["healthy/0", "healthy/1"]) == \
            [(0, 2, 1), (1, 2, 1)]
        victim, healthy = tr.job("victim"), tr.job("healthy")
        assert tr.evict_rank(0, "test: worker died", job=victim)
        assert victim.status == "live"
        assert tr.evict_rank(1, "test: worker died", job=victim)
        assert victim.status == "failed" and victim.open
        assert healthy.status == "live" and healthy._epoch == 1
        for i in range(2):
            port_jobs.wire_shutdown(tr.host, tr.port, f"healthy/{i}")
        _wait(lambda: healthy.status == "closed", "healthy closed")
        assert not tr.join(0)   # the tracker serves on
    finally:
        tr.stop()


def test_two_jobs_epoch_stores_are_their_own(multi_env):
    """Two jobs whose registrations ask for a data plane: each epoch 1
    has a store of its own job (two ports), a re-formation reaps only its
    job's older store, and closing a job reaps its stores alone."""
    tr = port_tracker.Tracker(2, ready_timeout=10).start()
    try:
        for job in ("A", "B"):
            assert port_jobs.submit(tr.host, tr.port, job, 2)["ok"] == 1
        ports = {}
        for job in ("A", "B"):
            conns = [_request(tr, "start", f"{job}/{i}", "127.0.0.1",
                              9200 + i, 1, "") for i in range(2)]
            blobs = [_read_coord(c) for c in conns]
            ports[job] = {b[1] for b in blobs}
        assert len(ports["A"]) == len(ports["B"]) == 1
        assert ports["A"] != ports["B"]
        assert tr.store_count("A") == tr.store_count("B") == 1
        assert tr.store_count() == 0 and tr.store_count("none") == 0
        conns = [_request(tr, "recover", f"A/{i}", "127.0.0.1", 9200 + i, 1,
                          "") for i in range(2)]
        assert {_read_coord(c)[0] for c in conns} == {2}
        _wait(lambda: tr.store_count("A") == 1, "A's epoch 1 reaped")
        assert tr.store_count("B") == 1
        for i in range(2):
            port_jobs.wire_shutdown(tr.host, tr.port, f"A/{i}")
        _wait(lambda: tr.job("A").status == "closed", "A closed")
        assert tr.store_count("A") == 0 and tr.store_count("B") == 1
    finally:
        tr.stop()


def _read_coord(c):
    """One assignment, acked: (epoch, coord_port)."""
    def u32():
        return struct.unpack("<I", _recv_all(c, 4))[0]

    _rank, _world, epoch = u32(), u32(), u32()
    _recv_all(c, u32())
    port = u32()
    u32(), u32()
    for _ in range(u32()):
        u32()
    u32(), u32()
    for _ in range(u32()):
        u32()
        _recv_all(c, u32())
        u32()
        _recv_all(c, u32())
    u32()
    _send_u32(c, 1)
    c.close()
    return epoch, port


# ---------------------------------------- the reaper, /jobs, the SLO

def test_resume_reaps_orphan_jobs(multi_env, monkeypatch, tmp_path):
    monkeypatch.setenv("RABIT_MAX_JOBS", "2")
    monkeypatch.setenv("RABIT_TRACKER_RESUME_GRACE_MS", "1")
    for cls, tag in PAIRS:
        wal = str(tmp_path / tag)
        first = cls(1, wal_dir=wal)
        assert first._submit(json.dumps({"job": "a"}))["ok"] == 1
        assert first._submit(json.dumps({"job": "b"}))["ok"] == 1
        assert first._submit(json.dumps({"job": "c"}))["ok"] == 0
        first._wal_log.close()   # the crash: no job_close records
        second = cls(1, wal_dir=wal, resume=True)
        assert second._orphan_jobs == {"a", "b"}
        time.sleep(0.01)         # outlive the 1 ms grace
        assert second._job_for("a") is not None   # contact: no orphan
        assert second._orphan_jobs == {"b"}
        assert second._submit(json.dumps({"job": "c"}))["ok"] == 1
        assert not second._orphan_jobs
        assert second._jobs["a"].open and not second._jobs["b"].open
        assert second._jobs["b"].closed_reason == "orphaned"
        second._wal_log.close()
    assert port_wal.WriteAheadLog(str(tmp_path / "port")).replay() == \
        port_wal.WriteAheadLog(str(tmp_path / "jax")).replay()


def test_forming_timeout_reaps_ghost_jobs(multi_env, monkeypatch):
    monkeypatch.setenv("RABIT_MAX_JOBS", "2")
    monkeypatch.setenv("RABIT_JOB_FORMING_TIMEOUT_MS", "10")
    assert port_tracker.forming_timeout_ms() == \
        jax_tracker.forming_timeout_ms() == 10
    tr = port_tracker.Tracker(1)
    try:
        assert tr._submit(json.dumps({"job": "a"}))["ok"] == 1
        assert tr._submit(json.dumps({"job": "b"}))["ok"] == 1
        time.sleep(0.03)
        assert tr._job_for("a") is not None   # contact refreshes a
        assert tr._submit(json.dumps({"job": "c"}))["ok"] == 1
        assert tr._jobs["a"].open and not tr._jobs["b"].open
        assert tr._jobs["b"].closed_reason == "forming timeout"
    finally:
        tr.stop()
    monkeypatch.setenv("RABIT_JOB_FORMING_TIMEOUT_MS", "x")
    with pytest.raises(ValueError):
        port_tracker.forming_timeout_ms()


def test_jobs_route_gauges_and_shed_rate_equal_the_jax_trackers(
        multi_env, monkeypatch):
    import urllib.request
    monkeypatch.setenv("RABIT_MAX_JOBS", "1")
    monkeypatch.setenv("RABIT_ADMISSION_QUEUE", "1")
    got = {}
    for cls, tag in PAIRS:
        tr = cls(2, metrics_port=0).start()
        try:
            for job in ("a", "b", "c", "d"):
                port_jobs.submit(tr.host, tr.port, job, 1)
            host, port = tr.live_addr()

            def read(path):
                with urllib.request.urlopen(f"http://{host}:{port}{path}",
                                            timeout=5) as r:
                    return r.read().decode()

            text = read("/metrics")
            fams = sorted({ln.split("{")[0].split(" ")[0]
                           for ln in text.splitlines()
                           if ln.startswith(("rabit_admission",
                                             "rabit_tracker_jobs",
                                             "rabit_sched", "rabit_job",
                                             "rabit_slo"))})
            rows = sorted(ln for ln in text.splitlines()
                          if ln.startswith(("rabit_admission",
                                            "rabit_tracker_jobs",
                                            "rabit_sched_preemptions")))
            got[tag] = (json.loads(read("/jobs")), json.loads(read("/slo")),
                        json.loads(read("/straggler")), fams, rows)
        finally:
            tr.stop()
    assert got["port"] == got["jax"]
    jobs_doc, slo_doc, strag, fams, rows = got["port"]
    assert jobs_doc["multi_job"] is True and jobs_doc["shed_total"] == 2
    assert [j["job"] for j in jobs_doc["jobs"]] == ["default", "a"]
    assert strag == {"ranks": [], "signal": False, "jobs": {}}
    assert "rabit_admission_shed_total 2" in rows
    (shed,) = [v for v in slo_doc["slos"] if v["slo"] == "shed_rate"]
    assert shed["value"] == 0.5


def test_multi_job_unset_is_single_job(monkeypatch, tmp_path):
    """Multi-job unset: a task id's ``/`` is only its spelling, no job
    exists beside the default, the journal carries no job field, no
    mirror directory appears, the live plane grows no job label, and the
    journal's bytes are the JAX tracker's."""
    import urllib.request
    monkeypatch.delenv("RABIT_MULTI_JOB", raising=False)
    journals = {}
    for cls, tag in PAIRS:
        root = str(tmp_path / tag)
        tr = cls(2, wal_dir=root, metrics_port=0).start()
        try:
            assert not tr.multi_job
            assert _batch(tr, ["alpha/0", "beta/1"]) == \
                [(0, 2, 1), (1, 2, 1)]
            assert tr.job("alpha") is None and tr.job("beta") is None
            assert tr._ranks == {"alpha/0": 0, "beta/1": 1}
            host, port = tr.live_addr()
            with urllib.request.urlopen(f"http://{host}:{port}/metrics",
                                        timeout=5) as r:
                text = r.read().decode()
            assert 'job="' not in text
            assert "rabit_tracker_jobs" not in text
            assert "rabit_admission_queue_depth" not in text
            with urllib.request.urlopen(f"http://{host}:{port}/straggler",
                                        timeout=5) as r:
                assert "jobs" not in json.load(r)
            with urllib.request.urlopen(f"http://{host}:{port}/jobs",
                                        timeout=5) as r:
                assert json.load(r)["multi_job"] is False
            for t in ("alpha/0", "beta/1"):
                port_jobs.wire_shutdown(tr.host, tr.port, t)
            _wait(lambda: tr.join(0), "the shutdowns")
        finally:
            tr.stop()
        assert os.listdir(root) == [port_wal.LOG_NAME]
        journals[tag] = open(os.path.join(root, port_wal.LOG_NAME),
                             "rb").read()
        for kind, data in port_wal.WriteAheadLog(root).replay():
            assert "job" not in data and not kind.startswith("job_")
    assert journals["port"] == journals["jax"]


# ------------------------------------------------------- card_index

@pytest.mark.parametrize("task, rank, cards, want", [
    ("A/1", 0, 4, 1), ("B/3", 0, 2, 1), ("A/x", 3, 4, 3), ("7", 0, 4, 3),
    ("/5", 2, 4, 2), ("t", 1, 4, 1), ("job/2", 9, 8, 2)])
def test_card_index_takes_the_task_index_after_the_job(task, rank, cards,
                                                       want):
    from rabit_tpu_torch.engine.dataplane import card_index
    assert card_index(rank, cards, task) == want


def test_card_of_a_multi_job_task_after_a_shrink_is_its_tasks(multi_env):
    """Job A of 4, elastic, on a multi-job tracker: after ranks 0 and 2
    are evicted, A/3 is slot 1 of the shrunk world, and its card is still
    card 3 (its task's), not card 1 (its slot's, held by A/1)."""
    from rabit_tpu_torch.engine.dataplane import card_index
    tr = port_tracker.Tracker(2, elastic=True).start()
    try:
        assert port_jobs.submit(tr.host, tr.port, "A", 4,
                                elastic=True)["ok"] == 1
        tasks = [f"A/{i}" for i in range(4)]
        first = _batch(tr, tasks)
        assert first == [(r, 4, 1) for r in range(4)]
        for r in (0, 2):
            assert tr.evict_rank(r, "dead", job=tr.job("A"))
        shrunk = {}
        for t in ("A/1", "A/3"):
            shrunk[t] = _request(tr, "recover", t, "127.0.0.1", 9100, 0, "")
            time.sleep(0.05)
        slots = {t: port_jobs.wire_read_assignment(c)
                 for t, c in shrunk.items()}
        assert slots == {"A/1": (0, 2, 2), "A/3": (1, 2, 2)}
        cards = {t: card_index(s[0], 4, t) for t, s in slots.items()}
        assert cards == {"A/1": 1, "A/3": 3}
        # what the card was before the repair: the slot's, A/1's card
        assert card_index(slots["A/3"][0], 4, "x") == 1
    finally:
        tr.stop()


# ------------------------------------------------------- the standby

@pytest.mark.parametrize("leader_cls", [port_tracker.Tracker,
                                        jax_tracker.Tracker],
                         ids=["port-leader", "jax-leader"])
def test_port_standby_follows_and_promotes_a_multi_job_leader(
        multi_env, tmp_path, leader_cls):
    """A port ``StandbyTracker`` behind a multi-job leader of either
    package: it follows the job records, promotes once the crashed
    leader's lease passes, and the promoted tracker holds every job (its
    own ranks and epoch) and answers its tasks by job."""
    from rabit_tpu_torch.tracker import standby as port_standby
    tr = leader_cls(2, wal_dir=str(tmp_path / "leader"),
                    lease_ms=300).start()
    sb = port_standby.StandbyTracker(tr.host, tr.port, 2,
                                     wal_dir=str(tmp_path / "standby"),
                                     lease_ms=300, quiet=True).start()
    try:
        for job, n in (("A", 2), ("B", 1)):
            assert port_jobs.submit(tr.host, tr.port, job, n,
                                    elastic=True)["ok"] == 1
        assert _batch(tr, ["A/0", "A/1"]) == [(0, 2, 1), (1, 2, 1)]
        assert _batch(tr, ["B/0"]) == [(0, 1, 1)]
        assert _recover(tr, ["B/0"]) == [(0, 1, 2)]
        _wait(lambda: sb.acked_seq == tr.repl_stats()["seq"] > 0,
              "the standby caught up")
        with tr._lock:
            want = (port_tracker.snapshot_state(tr)
                    if leader_cls is port_tracker.Tracker
                    else jax_tracker.snapshot_state(tr))["jobs"]
        tr.crash()
        _wait(lambda: sb.promoted(), "the promotion")
        res = sb.tracker
        assert res.multi_job and res.promoted
        with res._lock:
            got = port_tracker.snapshot_state(res)["jobs"]
        assert got == want
        assert res.job("A")._epoch == 1 and res.job("B")._epoch == 2
        c = _request(res, "world", "B/0")
        n = struct.unpack("<I", _recv_all(c, 4))[0]
        doc = json.loads(_recv_all(c, n))
        assert doc["epoch"] == 2 and doc["world"] == 1
    finally:
        sb.stop()
        tr.stop()
