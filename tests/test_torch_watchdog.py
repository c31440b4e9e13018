"""The port's watchdog (``rabit_tpu_torch/utils/watchdog.py``) against the
JAX package's on the same inputs: deadlines, config, the three-rung
ladder with its counters, spans, events and flight notes; and the
watchdog in both engines of the port: the hung bootstrap (exit 86 and a
bundle), a gloo world of ``TorchEngine`` through a stalled peer (sync and
async), the robust engine's retry rung through a stall in its data
plane, and the phases each engine guards. The stalls live in
``tests/workers/torch_stall_worker.py``."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import rabit_tpu.telemetry as jax_telemetry
import rabit_tpu.telemetry.events as jax_events
import rabit_tpu.telemetry.flight as jax_flight
import rabit_tpu.utils.watchdog as jax_wd
from rabit_tpu.utils.config import Config as JaxConfig

import rabit_tpu_torch
import rabit_tpu_torch.telemetry as telemetry
import rabit_tpu_torch.telemetry.events as events
import rabit_tpu_torch.telemetry.flight as flight
import rabit_tpu_torch.utils.watchdog as wd_mod
from rabit_tpu_torch.engine import _native_build
from rabit_tpu_torch.tracker.launch import launch
from rabit_tpu_torch.tracker.tracker import Tracker
from rabit_tpu_torch.utils.config import Config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "workers", "torch_stall_worker.py")
PORT = (wd_mod, telemetry, events, flight)
JAX = (jax_wd, jax_telemetry, jax_events, jax_flight)


def test_constants_are_the_jax_packages():
    for name in ("WATCHDOG_EXIT_CODE", "DEFAULT_FLOOR_MS",
                 "DEFAULT_MS_PER_MB", "_MIN_GRACE_S"):
        assert getattr(wd_mod, name) == getattr(jax_wd, name), name
    assert wd_mod.WATCHDOG_EXIT_CODE == 86


@pytest.mark.parametrize("floor_ms", [0, -5, 1, 500, 1500, 60000])
@pytest.mark.parametrize("ms_per_mb", [0.0, 10.0, 100.0, 2500.0])
def test_scale_deadline_matches_jax(floor_ms, ms_per_mb):
    for nbytes in (0, 8, 8192, 1 << 20, 3 * (1 << 20) + 5, 1 << 28):
        assert wd_mod.scale_deadline_s(nbytes, floor_ms, ms_per_mb) == \
            jax_wd.scale_deadline_s(nbytes, floor_ms, ms_per_mb)
    assert wd_mod.scale_deadline_s(1 << 20, floor_ms) == \
        jax_wd.scale_deadline_s(1 << 20, floor_ms)


@pytest.mark.parametrize("args", [
    [], ["rabit_deadline_ms=1500"], ["rabit_deadline_ms=0"],
    ["rabit_deadline_ms=250", "rabit_deadline_ms_per_mb=7.5"],
    ["rabit_deadline_ms=250", "rabit_deadline_ms_per_mb=0"],
    ["rabit_deadline_ms=800", "rabit_watchdog_abort=0"],
    ["rabit_deadline_ms=800", "rabit_watchdog_abort=false"],
    ["rabit_watchdog_abort=1"]])
def test_from_config_matches_jax(args):
    ours = wd_mod.Watchdog.from_config(Config.from_args(args))
    theirs = jax_wd.Watchdog.from_config(JaxConfig.from_args(args))
    for attr in ("floor_ms", "ms_per_mb", "abort", "enabled"):
        assert getattr(ours, attr) == getattr(theirs, attr), attr
    assert ours.guard("x", nbytes=1 << 20).__class__.__name__ == \
        theirs.guard("x", nbytes=1 << 20).__class__.__name__


def _records(mods) -> dict:
    _, tel, ev, fl = mods
    snap = tel.snapshot()
    return {"counters": sorted((c["name"], c["op"], c["provenance"])
                               for c in snap["counters"]),
            "spans": sorted((s["name"], s["op"]) for s in snap["spans"]),
            "events": [e["kind"] for e in ev.snapshot()["records"]],
            "notes": [n["kind"] for n in fl.recent_events()]}


def _fresh(mods) -> None:
    _, tel, ev, fl = mods
    tel.reset(enabled=True)
    ev.reset(enabled=True)
    with fl._events_lock:
        fl._events.clear()


def _off(mods) -> None:
    _, tel, ev, _ = mods
    tel.reset(enabled=False)
    ev.reset(enabled=False)


def _ladder(mods, abort: bool, reform_fails: bool = False) -> dict:
    """A guard that never exits: the hooks in the order they fired, the
    abort seam's codes, the guard's state and the records."""
    wd_m = mods[0]
    _fresh(mods)
    fired, codes = [], []
    done = threading.Event()

    def reform():
        fired.append("reform")
        if reform_fails:
            raise RuntimeError("interrupt plane unavailable")
        if not abort:
            done.set()

    def seam(code):
        codes.append(code)
        fired.append("abort")
        done.set()

    wd = wd_m.Watchdog(floor_ms=80, abort=abort, abort_fn=seam)
    try:
        with wd.guard("stuck.phase", nbytes=64,
                      on_expire=lambda: fired.append("retry"),
                      on_reform=reform) as g:
            assert done.wait(10), fired
            time.sleep(0.1)   # past the rung's own records
            with wd._cv:
                armed = g in wd._guards
        out = {"fired": fired, "codes": codes, "armed": armed,
               "expired": g.expired, "reformed": g.reformed,
               "expired_total": wd.expired_total, **_records(mods)}
    finally:
        wd.close()
        _off(mods)
    return out


@pytest.mark.parametrize("abort,reform_fails",
                         [(True, False), (False, False), (True, True)],
                         ids=["full_ladder", "abort_off_stops_at_reform",
                              "failing_reform_hook_still_aborts"])
def test_ladder_matches_jax(abort, reform_fails):
    ours = _ladder(PORT, abort, reform_fails)
    theirs = _ladder(JAX, abort, reform_fails)
    assert ours == theirs
    if abort:
        assert ours["fired"] == ["retry", "reform", "abort"]
        assert ours["codes"] == [86]
        assert ("watchdog.abort", "stuck.phase", "recovery") in \
            ours["counters"]
        assert ours["events"] == ["watchdog.retry", "watchdog.reform",
                                  "watchdog.abort"]
    else:
        # abort=0: the ladder stops at reform, notes the stall and drops
        # the guard; the abort rung never fires
        assert ours["fired"] == ["retry", "reform"] and ours["codes"] == []
        assert not ours["armed"]
        assert ours["notes"] == ["watchdog_expired", "watchdog.stall"]
    assert ours["expired"] and ours["reformed"]
    assert ours["expired_total"] == 1
    assert ("watchdog.expired", "stuck.phase", "recovery") in ours["counters"]
    assert ("watchdog.reform", "stuck.phase", "recovery") in ours["counters"]
    assert ("watchdog.stall", "stuck.phase") in ours["spans"]


def test_disabled_watchdog_hands_back_the_shared_null_guard():
    wd = wd_mod.Watchdog()
    assert not wd.enabled
    assert wd.guard("engine.allreduce", nbytes=1 << 30) is wd_mod.NULL_GUARD
    with wd.guard("x") as g:
        assert g.expired is False
    assert wd._thread is None   # no monitor without an armed guard


# -- the engines -----------------------------------------------------------

@pytest.fixture(scope="module")
def native_core():
    _native_build.build()


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _env(**kw) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    env.update({k: str(v) for k, v in kw.items()})
    return env


def _results(tmp_path, world: int) -> list:
    return [json.loads((tmp_path / f"rank{r}.json").read_text())
            for r in range(world)]


def test_hung_bootstrap_exits_86_with_a_bundle(tmp_path, native_core):
    """A worker stalled in the native rendezvous (its peer never starts)
    climbs the ladder to the abort: exit 86 and one flight bundle that
    names ``engine.init`` and carries every thread's stack (the twin of
    ``test_cluster_watchdog_abort_writes_flight_bundle``)."""
    fdir = tmp_path / "flight"
    tr = Tracker(2, ready_timeout=60.0).start()
    try:
        env = _env(RABIT_TELEMETRY=1, RABIT_FLIGHT_DIR=fdir)
        env.update(tr.env(task_id="0"))
        t0 = time.monotonic()
        p = subprocess.run(
            [sys.executable, WORKER, "bootstrap", "rabit_deadline_ms=1500",
             "rabit_dataplane=torch", "rabit_device=cpu"],
            env=env, capture_output=True, text=True, timeout=60)
        took = time.monotonic() - t0
    finally:
        tr.stop()
    assert p.returncode == wd_mod.WATCHDOG_EXIT_CODE, p.stderr[-2000:]
    # retry at 1.5 s, reform at 3.0 s, abort at 4.5 s after the guard
    assert 4.5 <= took < 30, took
    bundles = [f for f in os.listdir(fdir) if "_watchdog_abort" in f]
    assert len(bundles) == 1, os.listdir(fdir)
    assert "_local_" in bundles[0]   # the rank was never assigned
    doc = json.loads((fdir / bundles[0]).read_text())
    assert doc["schema"] == "rabit_tpu.flight_record/v1"
    assert doc["reason"] == "watchdog_abort" and doc["rank"] == -1
    assert "engine.init" in doc["detail"]
    assert "rabit_deadline_ms=1500" in doc["config"]
    assert "Thread" in doc["stacks"] and "init" in doc["stacks"]
    kinds = [e["kind"] for e in doc["events"]]
    assert "watchdog_expired" in kinds
    names = {c["name"] for c in doc["telemetry"]["counters"]}
    assert {"watchdog.expired", "watchdog.reform",
            "watchdog.abort"} <= names


def _engine_world(tmp_path, extra_env: dict) -> list:
    """``TorchEngine`` at world 2 over gloo, rank 1 asleep for 2.5 s
    before op 2; the watchdog at 600 ms without the abort rung."""
    port = _free_port()
    env = _env(RABIT_RESULT_DIR=tmp_path, STALL_S=2.5, **extra_env)
    procs = [subprocess.Popen(
        [sys.executable, WORKER, "engine", "rabit_device=cpu",
         f"rabit_coordinator=127.0.0.1:{port}", "rabit_num_processes=2",
         f"rabit_process_id={r}", "rabit_deadline_ms=600",
         "rabit_watchdog_abort=0", "rabit_telemetry=1", "rabit_events=1"],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for r in range(2)]
    try:
        outs = [p.communicate(timeout=90)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return _results(tmp_path, 2)


@pytest.mark.parametrize("asynchronous", [False, True],
                         ids=["allreduce", "allreduce_async"])
def test_torch_engine_survivor_climbs_to_reform_and_sums_stay_exact(
        tmp_path, asynchronous):
    """The survivor's guard expires while its peer sleeps (for the async
    op: while the op is in flight on the engine's worker): it counts
    ``watchdog.expired`` and ``watchdog.reform``, emits
    ``watchdog.retry`` and ``watchdog.reform``, notes ``watchdog.stall``
    and drops the guard (``rabit_watchdog_abort=0``); every sum is
    exact. The sleeper's own op is not stalled: its peer was waiting."""
    survivor, sleeper = _engine_world(
        tmp_path, {"ASYNC": int(asynchronous)})
    assert survivor["exact"] and sleeper["exact"]
    assert survivor["crcs"] == sleeper["crcs"]
    c = survivor["counters"]
    assert c["watchdog.expired|engine.allreduce"] == 1
    assert c["watchdog.reform|engine.allreduce"] == 1
    assert "watchdog.abort|engine.allreduce" not in c
    assert survivor["events"] == ["watchdog.retry", "watchdog.reform"]
    assert [n["kind"] for n in survivor["notes"]] == ["watchdog_expired",
                                                      "watchdog.stall"]
    assert survivor["expired_total"] == 1
    # the rungs at 0.6 s and 1.2 s after the survivor's call
    retry_at = survivor["notes"][0]["t_unix"] - survivor["t_call"]
    reform_at = survivor["notes"][1]["t_unix"] - survivor["t_call"]
    assert 0.55 < retry_at < 1.2 and 1.15 < reform_at < 2.0, \
        (retry_at, reform_at)
    assert survivor["t_done"] - survivor["t_call"] >= 2.4
    assert sleeper["expired_total"] == 0 and sleeper["notes"] == []


def _robust(tmp_path, stall_s: float) -> tuple:
    cmd = [sys.executable, WORKER, "robust", "rabit_dataplane=torch",
           "rabit_dataplane_minbytes=0", "rabit_device=cpu",
           "rabit_deadline_ms=2500", "rabit_watchdog_abort=0",
           "rabit_telemetry=1", "rabit_events=1"]
    tmp_path.mkdir()
    stats = {}
    assert launch(2, cmd, max_attempts=0, timeout=120, quiet=True,
                  stats=stats, env={"PYTHONPATH": ROOT, "STALL_S": str(stall_s),
                                    "RABIT_RESULT_DIR": str(tmp_path)}) == 0
    return _results(tmp_path, 2), stats


def test_robust_retry_rung_replays_a_stalled_round(tmp_path, native_core):
    """Rank 1's data plane sleeps 3 s inside a collective; rank 0 blocks
    in it. At 2.5 s both ranks' retry rungs mark their worlds aborted;
    once the collective ends the round fails on both, the native layer
    resets the links (the epoch advances), the data plane re-forms and the
    round replays: every result equals the clean run's bit for bit."""
    clean, clean_stats = _robust(tmp_path / "clean", 0)
    got, stats = _robust(tmp_path / "stall", 3.0)
    assert [r["crcs"] for r in got] == [r["crcs"] for r in clean]
    assert all(r["exact"] for r in got + clean)
    assert clean_stats["epoch"] == 1 and stats["epoch"] == 2
    assert stats["total_attempts"] == 0
    for r in got:
        c = r["counters"]
        assert c["watchdog.expired|engine.allreduce"] == 1
        assert c["recovery.retry|watchdog_rung"] == 1
        assert c["recovery.link_reset|dataplane"] == 1
        assert r["formations"] == 2 and r["epoch"] == 2
        kinds = [n["kind"] for n in r["notes"]]
        assert kinds[:2] == ["watchdog_expired", "link_reset"], kinds
        assert "watchdog's retry rung" in r["notes"][1]["detail"]
        assert r["events"][:3] == ["watchdog.retry", "recovery.retry",
                                   "recovery.link_reset"]
    for r in clean:
        assert r["formations"] == 1 and r["expired_total"] == 0


# -- the phases each engine guards -----------------------------------------

class _Spy(wd_mod.Watchdog):
    """An enabled watchdog that records each guard it hands out."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        self.seen = []

    def guard(self, name, nbytes=0, deadline_s=None, on_expire=None,
              on_reform=None):
        g = super().guard(name, nbytes, deadline_s, on_expire, on_reform)
        self.seen.append((name, nbytes, deadline_s, on_expire is not None,
                          on_reform is not None))
        return g


def _guarded_torch_rank(rank, p):
    from rabit_tpu_torch.engine.torch_engine import TorchEngine
    e = TorchEngine()
    e.init(["rabit_device=cpu", "rabit_deadline_ms=60000",
            "rabit_hier_phase_deadline_scale=0.25", "rabit_reduce_method=hier",
            "rabit_hier_group=2"])
    spy = _Spy(floor_ms=60000)
    e._watchdog = spy
    x = np.arange(64, dtype=np.float32) + rank
    e.allreduce(x, rabit_tpu_torch.SUM)
    e.allreduce_async(x.copy(), rabit_tpu_torch.SUM).wait()
    rs = e.reduce_scatter(np.arange(64, dtype=np.float32), rabit_tpu_torch.SUM)
    ag = e.allgather(np.arange(4, dtype=np.float32))
    e.shutdown()
    names = [s[0] for s in spy.seen]
    hier = [s for s in spy.seen if s[0].startswith("hier.")]
    return {"names": np.array(names), "x": x, "rs": rs, "ag": ag,
            "hier_deadlines": np.array([s[2] for s in hier]),
            "hier_nbytes": np.array([s[1] for s in hier]),
            "hooks": np.array([s[3] or s[4] for s in spy.seen])}


def test_torch_engine_guards_jax_xla_engines_phases(tmp_path):
    """``XlaEngine``'s guards (``engine/xla.py``): the whole allreduce
    and each of its hier phases (deadline scaled by
    ``rabit_hier_phase_deadline_scale``), the async op, reduce-scatter
    and all-gather; no hooks."""
    from torch_world import spawn_world
    ranks = spawn_world(_guarded_torch_rank, 4, tmp_path)
    phases = ["hier.reduce_scatter", "hier.inter", "hier.allgather"]
    want = ["engine.allreduce", *phases, "engine.allreduce", *phases,
            "engine.reduce_scatter", "engine.allgather"]
    for r, got in enumerate(ranks):
        assert got["names"].tolist() == want, r
        assert not got["hooks"].any()
        for d, n in zip(got["hier_deadlines"], got["hier_nbytes"]):
            assert d == wd_mod.scale_deadline_s(int(n), 60000) * 0.25
        np.testing.assert_array_equal(
            got["x"], 4 * np.arange(64, dtype=np.float32) + 6)


def test_native_engine_guards_jax_native_engines_phases(monkeypatch,
                                                        native_core):
    """The JAX binding's guards: the bootstrap (no hooks needed: no world
    yet, but the JAX engine passes none), ``allreduce``, both phases of
    ``broadcast`` and ``load_checkpoint``, each with the retry and reform
    hooks."""
    import rabit_tpu_torch.engine.native as native
    spies = []

    class Spy(_Spy):
        @classmethod
        def from_config(cls, cfg):
            spy = cls(floor_ms=60000)
            spies.append(spy)
            return spy

    monkeypatch.setattr(native, "Watchdog", Spy)
    rabit_tpu_torch.finalize()
    rabit_tpu_torch.init([], engine="robust")
    try:
        rabit_tpu_torch.allreduce(np.ones(8, np.float32), rabit_tpu_torch.SUM)
        rabit_tpu_torch.broadcast({"k": 1}, 0)
        rabit_tpu_torch.load_checkpoint()
    finally:
        rabit_tpu_torch.finalize()
    (spy,) = spies
    assert [(s[0], s[3], s[4]) for s in spy.seen] == [
        ("engine.init", False, False), ("engine.allreduce", True, True),
        ("engine.broadcast.size", True, True),
        ("engine.broadcast", True, True),
        ("engine.load_checkpoint", True, True)]
    assert spy._stop   # closed at shutdown


def test_a_formation_after_a_failed_one_keys_as_its_peers(monkeypatch):
    """A formation that failed on one rank alone (a store timeout, as
    after a rung's abort) left torch's default-group counter ahead of the
    other ranks', so the next formation's rendezvous keys never met
    theirs; every formation now names the group as a fresh process
    does."""
    import torch.distributed as dist
    from torch.distributed import distributed_c10d as c10d
    from rabit_tpu_torch.engine import dataplane as dpm
    master = dist.TCPStore("127.0.0.1", 0, world_size=1, is_master=True)
    dp = dpm.TorchDataPlane.__new__(dpm.TorchDataPlane)
    dp.__dict__.update(
        _device_spec=dpm.resolve_device("cpu"), _timeout=dpm.datetime
        .timedelta(seconds=10), _formed_epoch=None, _last_epoch=None,
        _group=None, _rank=0, _world=1, formations=0, _aborted=False,
        on_world_reformed=None)

    class Lib:
        RbtGetRank = staticmethod(lambda: 0)
        RbtGetWorldSize = staticmethod(lambda: 1)

    dp._lib = Lib()
    monkeypatch.setattr(dp, "_coord_addr", lambda: f"127.0.0.1:{master.port}",
                        raising=False)
    c10d._world.group_count = 3   # a failed formation's leftover
    try:
        dp._form_world(1, 0, 0)
        assert dist.get_world_size() == 1
        assert c10d._get_default_group().group_name == "0"
    finally:
        dp.shutdown()
    assert not dist.is_initialized()
