"""A world of two computes through the loss of its tracker with no
respawn: the port's counterpart of ``tests/test_failover_cluster.py``,
on the CPU. ``tests/workers/torch_resume_worker.py`` runs under the
port's launcher (the robust engine over a gloo data plane, elastic) with
a write-ahead log, a hot standby (``RABIT_TRACKER_STANDBY=1``,
``RABIT_LEASE_MS=800``) and the chaos front proxy. Once every rank has
logged round 5 the front proxy's schedule takes the leader away: by
``tracker_kill`` (a crash, with a cold respawn scheduled 4 s later that
must never come) or by ``tracker_partition`` (the leader lives, but
nothing reaches it for 2.5 s, its standby's stream included). The
standby promotes after a lease of silence, the supervisor adopts it and
retargets the front proxy, and the workers' pollers find it on the
pre-advertised address. The asserts are the JAX test's
``_assert_zero_downtime``: one failover, zero restarts, zero relaunches,
no eviction, epoch 1, every round's CRC equal to the uninterrupted
run's; and the standby's journal holds the replicated formation, the
promotion and every rank's shutdown (``finalize`` through the retargeted
proxy)."""

import json
import re
import sys
from pathlib import Path

import pytest

from rabit_tpu_torch.engine import _native_build
from rabit_tpu_torch.tracker import launch as port_launch
from rabit_tpu_torch.tracker.wal import WriteAheadLog

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "workers" / "torch_resume_worker.py"
N = 2
ROUNDS = 30
HIT_AT = 5          # the fault, once every rank has logged this round
PARTITION_S = 2.5   # the partition's window from then
ENV = {"RESUME_ROUNDS": str(ROUNDS), "RESUME_ROUND_SLEEP_MS": "150",
       "RABIT_SKEW_POLL_MS": "100", "RESUME_DEADLINE": "100",
       "RESUME_HIST_ROWS": "4096", "RESUME_HIST_BINS": "64"}
# the rules start outside any window: the tick opens one at round HIT_AT
NEVER = [1e9, 1e9 + 1]
CHAOS = {"kill": {"seed": 11, "rules": [
             {"kind": "tracker_kill", "target": "tracker",
              "window_s": NEVER, "delay_ms": 4000}]},
         "partition": {"seed": 13, "rules": [
             {"kind": "tracker_partition", "window_s": NEVER}]}}


def _streams(out):
    """task -> ([(round, crc)], log lines)."""
    got = {}
    for p in sorted(Path(out).glob("r*.log")):
        lines = p.read_text().splitlines()
        got[p.stem[1:]] = (
            [(int(m.group(1)), m.group(2)) for m in
             (re.match(r"round=(\d+) crc=([0-9a-f]{8})$", ln)
              for ln in lines) if m], lines)
    return got


def _reached(out, rnd):
    s = _streams(out)
    return len(s) == N and all(any(r >= rnd for r, _ in v)
                               for v, _ in s.values())


def open_window(proxy, kind, seconds):
    """Move ``kind``'s window of the front proxy's schedule to [now, now +
    seconds)."""
    now = proxy.elapsed()
    for rule in proxy.schedule.rules:
        if rule.kind == kind:
            rule.window_s = (now, now + seconds)


def _run(out, monkeypatch, mode=None, wal=None):
    out.mkdir()
    for k in ("RABIT_TRACKER_WAL_DIR", "RABIT_TRACKER_STANDBY",
              "RABIT_LEASE_MS", "RABIT_CHAOS"):
        monkeypatch.delenv(k, raising=False)
    if mode is not None:
        monkeypatch.setenv("RABIT_TRACKER_WAL_DIR", str(wal))
        monkeypatch.setenv("RABIT_TRACKER_STANDBY", "1")
        monkeypatch.setenv("RABIT_LEASE_MS", "800")
        monkeypatch.setenv("RABIT_TRACKER_RESUME_GRACE_MS", "15000")
    opened = []

    def tick(sup):
        if mode is None or opened or not _reached(out, HIT_AT):
            return
        opened.append(sup.proxy.elapsed())
        if mode == "kill":
            open_window(sup.proxy, "tracker_kill", 600.0)
        else:
            open_window(sup.proxy, "tracker_partition", PARTITION_S)

    stats = {}
    cmd = [sys.executable, str(WORKER), "rabit_dataplane=torch",
           "rabit_device=cpu", "rabit_dataplane_minbytes=0"]
    rc = port_launch.launch(N, cmd, max_attempts=0, timeout=120,
                            quiet=True, stats=stats,
                            env=dict(ENV, RESUME_OUT=str(out)),
                            elastic=True, tick=tick,
                            chaos=None if mode is None else CHAOS[mode])
    assert rc == 0
    assert mode is None or opened, "round 5 was never reached"
    return stats


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The uninterrupted run: no chaos, no WAL, no standby."""
    _native_build.build()
    mp = pytest.MonkeyPatch()
    try:
        out = tmp_path_factory.mktemp("failover") / "base"
        stats = _run(out, mp)
    finally:
        mp.undo()
    assert stats["tracker_restarts"] == 0
    assert not stats["failover"]["standby"]        # off: as before
    assert stats["total_attempts"] == 0
    return _streams(out)


@pytest.mark.parametrize("mode", ["kill", "partition"])
def test_a_world_computes_through_a_leader_loss_with_no_respawn(
        tmp_path, monkeypatch, baseline, mode):
    out, wal = tmp_path / "hit", tmp_path / "wal"
    stats = _run(out, monkeypatch, mode, wal)
    fo = stats["failover"]
    assert fo["standby"] and fo["promoted"], fo
    assert fo["failovers"] == 1, fo
    assert fo["acked_seq"] > 0, fo                 # replication ran
    assert 0 < fo["failover_ms"] < 10_000, fo
    assert fo["leader_repl"]["lag_records"] == 0, fo
    # a partitioned leader still lives: the adoption fences it
    assert fo["fenced"] == (1 if mode == "partition" else 0), fo
    assert stats["chaos"]["events"] >= 1, stats["chaos"]
    # a promotion is not a restart, and nothing else happened
    assert stats["tracker_restarts"] == 0, stats
    assert stats["total_attempts"] == 0 and stats["readmissions"] == 0
    doc = stats["membership"]
    assert doc["evicted"] == [] and doc["world"] == N, doc
    assert doc["epoch"] == 1 and stats["epoch"] == 1, doc
    got = _streams(out)
    for t in map(str, range(N)):
        rounds, lines = got[t]
        assert [r for r, _ in rounds] == list(range(ROUNDS)), lines
        assert rounds == baseline[t][0], f"task {t}'s CRC stream diverged"
        assert "done" in lines, lines
        doc = json.loads((out / f"r{t}.json").read_text())
        assert doc["epoch"] == 1
        assert doc["launches"] == [0] * ROUNDS    # the plain version
    # the promoted tracker's journal: the replicated formation, then the
    # promotion, then every rank's shutdown through the retargeted proxy
    kinds = [k for k, _ in WriteAheadLog(str(wal / "standby")).replay()]
    assert kinds.count("assign") == N and "epoch" in kinds, kinds
    assert "lease" in kinds and kinds.count("promoted") == 1, kinds
    after = kinds[kinds.index("promoted"):]
    assert after.count("down") == N, kinds
    if mode == "partition":
        # the deposed leader was fenced: it journaled nothing once its
        # standby had promoted
        leader = [k for k, _ in WriteAheadLog(str(wal)).replay()]
        assert "down" not in leader and "promoted" not in leader, leader
