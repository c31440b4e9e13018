"""Multi-job worlds of the port on one multi-job port tracker, on the CPU:
the JAX package's two-job fault isolation with the port's native-engine
worker (job A's whole world dies mid-collective, job B's CRC stream is
its solo run's bit for bit, B has no eviction, the tracker never
restarts); two jobs on the gloo data plane, each on epoch stores of its
own; and a small ``job_storm`` against a live world of 2 (every round
exact, every rogue submit but at most one refused). Every comparison is
exact."""

import json
import re
import sys
import threading
import time
from pathlib import Path

import pytest

from rabit_tpu_torch.tracker import jobs as port_jobs
from rabit_tpu_torch.tracker.launch import launch, submit_launch
from rabit_tpu_torch.tracker.tracker import Tracker

ROOT = Path(__file__).resolve().parent.parent
WORKERS = ROOT / "tests" / "workers"
MJ_WORKER = WORKERS / "torch_multijob_worker.py"
RESUME_WORKER = WORKERS / "torch_resume_worker.py"
ROUNDS = 4


@pytest.fixture
def multi_env(monkeypatch):
    monkeypatch.setenv("RABIT_MULTI_JOB", "1")
    for k in ("RABIT_MAX_JOBS", "RABIT_MAX_FLEET_RANKS",
              "RABIT_ADMISSION_QUEUE", "RABIT_TRACKER_WAL_DIR",
              "RABIT_METRICS_PORT", "RABIT_EVENTS", "RABIT_CHAOS",
              "RABIT_TRACKER_STANDBY", "RABIT_ELASTIC"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setenv("PYTHONPATH", str(ROOT))


def _crcs(out_dir, job, task):
    lines = (Path(out_dir) / f"r{job}_{task}.log").read_text().splitlines()
    crcs = [(int(m.group(1)), int(m.group(2)), m.group(3)) for m in
            (re.match(r"sum round=(\d+) world=(\d+) crc=([0-9a-f]{8})$", ln)
             for ln in lines) if m]
    return lines, crcs


def _run_mj(tr, job, out_dir, die_at=-1, elastic=False):
    cmd = [sys.executable, str(MJ_WORKER), f"mj_out={out_dir}",
           f"mj_rounds={ROUNDS}", "rabit_device=cpu", "mj_hist_rows=4096",
           "mj_hist_bins=64"]
    if die_at >= 0:
        cmd.append(f"mj_die_at={die_at}")
    return submit_launch(f"{tr.host}:{tr.port}", job, 2, cmd,
                         max_attempts=1, timeout=60, elastic=elastic,
                         quiet=True)


def test_two_job_fault_isolation(multi_env, tmp_path):
    """Job A's whole world dies at round 1; job B on the SAME tracker
    ends with its solo run's CRC stream, no eviction, a clean close, and
    one tracker throughout; A fails alone once its ranks are evicted."""
    solo = tmp_path / "solo"
    solo.mkdir()
    tr0 = Tracker(2).start()
    try:
        assert _run_mj(tr0, "B", solo) == 0
    finally:
        tr0.stop()
    solo_b = [_crcs(solo, "B", t)[1] for t in range(2)]
    assert [len(c) for c in solo_b] == [ROUNDS, ROUNDS]

    both = tmp_path / "both"
    both.mkdir()
    tr = Tracker(2).start()
    rcs = {}
    try:
        threads = [
            threading.Thread(target=lambda: rcs.__setitem__(
                "A", _run_mj(tr, "A", both, die_at=1, elastic=True))),
            threading.Thread(target=lambda: rcs.__setitem__(
                "B", _run_mj(tr, "B", both)))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(90)
        assert rcs == {"A": 1, "B": 0}
        b = [_crcs(both, "B", t)[1] for t in range(2)]
        assert b == solo_b, "job B's stream diverged from its solo run"
        assert all(w == 2 for _r, w, _c in b[0] + b[1])
        for t in range(2):
            lines, a = _crcs(both, "A", t)
            assert any(ln.startswith("dying round=1") for ln in lines)
            assert len(a) == 1   # only round 0 completed
        # the kernel's plain version ran a round on every B process
        for t in range(2):
            doc = json.loads((both / f"rB_{t}.json").read_text())
            assert doc["launches"] == [0] * ROUNDS and doc["device"] == "cpu"
            assert [r["hist_crc"] for r in doc["rounds"]] == [
                r["hist_crc"] for r in json.loads(
                    (solo / f"rB_{t}.json").read_text())["rounds"]]
        jb = tr.job("B")
        deadline = time.monotonic() + 10
        while jb.status != "closed" and time.monotonic() < deadline:
            time.sleep(0.05)
        assert jb.status == "closed" and jb._shutdown_ranks == {0, 1}
        assert tr._thread.is_alive() and not tr.join(0)
        ja = tr.job("A")
        for rank in range(2):
            tr.evict_rank(rank, "test: worker died", job=ja)
        assert ja.status == "failed" and tr.job("B").status == "closed"
    finally:
        tr.stop()


def _run_dataplane(tr, job):
    return submit_launch(
        f"{tr.host}:{tr.port}", job, 2,
        [sys.executable, str(RESUME_WORKER), "rabit_device=cpu",
         "rabit_dataplane=torch", "rabit_dataplane_minbytes=0",
         "rabit_engine=robust_torch", "rabit_telemetry=1"],
        max_attempts=1, timeout=60, quiet=True)


def test_two_jobs_on_the_gloo_data_plane_each_on_its_own_store(
        multi_env, monkeypatch, tmp_path):
    """Jobs A and B, two processes each, the robust engine with the torch
    data plane over gloo: every round exact and the two streams equal
    (each is a function of round and world alone), each job's epoch 1 on
    a store of its own (two ports), each job's stores reaped at its
    close."""
    out = tmp_path / "dp"
    out.mkdir()
    for k, v in (("RESUME_OUT", str(out)), ("RESUME_ROUNDS", "4"),
                 ("RESUME_ROUND_SLEEP_MS", "100"),
                 ("RESUME_HIST_ROWS", "4096"), ("RESUME_HIST_BINS", "64"),
                 ("RESUME_DEADLINE", "50")):
        monkeypatch.setenv(k, v)
    tr = Tracker(2, ready_timeout=30).start()
    seen = {"A": set(), "B": set()}
    stop = threading.Event()

    def watch():
        while not stop.is_set():
            for j in ("A", "B"):
                jb = tr.job(j)
                if jb is not None:
                    with tr._lock:
                        seen[j] |= {(e, st.port) for e, st, _ in jb._stores}
            time.sleep(0.01)

    w = threading.Thread(target=watch, daemon=True)
    w.start()
    rcs = {}
    try:
        assert port_jobs.submit(tr.host, tr.port, "A", 2)["ok"] == 1
        assert port_jobs.submit(tr.host, tr.port, "B", 2)["ok"] == 1
        threads = [threading.Thread(target=lambda j=j: rcs.__setitem__(
            j, _run_dataplane(tr, j))) for j in ("A", "B")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(90)
        stop.set()
        w.join(5)
        assert rcs == {"A": 0, "B": 0}
        docs = {(j, t): json.loads((out / f"r{j}_{t}.json").read_text())
                for j in "AB" for t in range(2)}
        streams = {k: [(r["round"], r["world"], r["crc"], r["hist_crc"])
                       for r in d["rounds"]] for k, d in docs.items()}
        assert [r[0] for r in streams["A", 0]] == list(range(4))
        assert streams["A", 0] == streams["B", 0]
        assert streams["A", 1] == streams["B", 1]
        for d in docs.values():
            # the gloo world formed once, at epoch 1, on the job's store
            assert [s["epoch"] for s in d["world_reform"]] == [1]
            assert {x["dataplane"] for x in d["devices"]} == {"cpu"}
        # one store a job at epoch 1, on two ports
        assert [e for e, _ in seen["A"]] == [1] == [e for e, _ in seen["B"]]
        assert seen["A"] != seen["B"]
        for j in "AB":
            assert tr.job(j).status == "closed" and tr.store_count(j) == 0
        assert tr.store_count() == 0
    finally:
        stop.set()
        tr.stop()


def test_a_small_job_storm_against_a_live_world(multi_env, monkeypatch,
                                                tmp_path):
    """The JAX package's submit-storm cluster test at a burst of 60: the
    rogues' submits and half-open registrations hit the tracker's front
    while a world of 2 computes, every round of the live world is exact,
    and at most one rogue takes the one free job slot."""
    monkeypatch.setenv("RABIT_MAX_JOBS", "1")
    monkeypatch.setenv("RABIT_ADMISSION_QUEUE", "2")
    chaos = {"seed": 19, "rules": [
        {"kind": "job_storm", "window_s": [0.0, 60.0], "burst": 60,
         "target": "tracker"}]}
    out = tmp_path / "storm"
    out.mkdir()
    stats = {}
    rc = launch(2, [sys.executable, str(MJ_WORKER), f"mj_out={out}",
                    "mj_rounds=6", "mj_sleep_ms=100", "rabit_device=cpu"],
                max_attempts=0, timeout=60, quiet=True, stats=stats,
                chaos=chaos)
    assert rc == 0
    assert stats["chaos"]["events"] >= 1, "the storm never fired"
    assert stats["chaos"]["storm_submits"] >= 20, stats["chaos"]
    assert stats["chaos"]["storm_submits"] - \
        stats["chaos"]["storm_shed"] <= 1, stats["chaos"]
    for t in range(2):
        doc = json.loads((out / f"r{t}.json").read_text())
        assert [r["round"] for r in doc["rounds"]] == list(range(6))
        assert all(r["world"] == 2 for r in doc["rounds"])
    assert stats["total_attempts"] == 0
