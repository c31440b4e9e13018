"""The port's flight recorder (``rabit_tpu_torch/telemetry/flight.py``),
its history (``telemetry/history.py``), its ``telemetry --smoke`` and the
data plane's flight notes, each against the JAX package's on the same
inputs: the bundle's fields, the excepthook and SIGTERM hooks, the
prune, the watchdog's abort bundle rendered by the JAX package's own
``tools/trace_report.py``, the history records and their dedupe, and the
notes of the torch data plane's retry rung against the XLA data
plane's."""

import json
import os
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest

import rabit_tpu.telemetry as jax_telemetry
import rabit_tpu.telemetry.flight as jax_flight
import rabit_tpu.telemetry.history as jax_history
from rabit_tpu.engine import dataplane as jax_dp
from rabit_tpu.utils.config import Config as JaxConfig

import rabit_tpu_torch.telemetry as telemetry
import rabit_tpu_torch.telemetry.flight as flight
import rabit_tpu_torch.telemetry.history as history
from rabit_tpu_torch.engine import dataplane as port_dp
from rabit_tpu_torch.ops.reducers import DTYPE_ENUM
from rabit_tpu_torch.telemetry import crossrank
from rabit_tpu_torch.telemetry.schema import matches
from rabit_tpu_torch.utils.config import Config
from rabit_tpu_torch.utils.watchdog import WATCHDOG_EXIT_CODE, Watchdog

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def telem():
    for tel in (telemetry, jax_telemetry):
        tel.reset(capacity=256, enabled=True)
    for fl in (flight, jax_flight):
        with fl._events_lock:
            fl._events.clear()
    yield
    for tel in (telemetry, jax_telemetry):
        tel.reset(enabled=False)


def test_constants_are_the_jax_packages():
    for name in ("FLIGHT_KIND", "DEFAULT_KEEP", "_EVENTS_MAX"):
        assert getattr(flight, name) == getattr(jax_flight, name), name


def _bundle(tel, fl, out_dir) -> tuple:
    tel.record_span("engine.allreduce", 1e-3, nbytes=1 << 20,
                    round=tel.collective_round("engine.allreduce"))
    fl.note("chaos.partition", "link#0")
    fr = fl.FlightRecorder(str(out_dir), rank=2, keep=2,
                           config_args=["rabit_telemetry=1"])
    fr.install()
    try:
        assert fl.installed() is fr
        paths = [fr.dump(f"reason{i}") for i in range(4)]
        assert fl.trigger("via_trigger") is not None
    finally:
        fr.uninstall()
    assert fl.installed() is None and fl.trigger("after") is None
    with open(paths[-1]) as f:
        return json.load(f), paths, sorted(os.listdir(out_dir))


def test_bundle_round_trip_and_prune_match_jax(tmp_path, telem):
    ours, paths, kept = _bundle(telemetry, flight, tmp_path / "port")
    theirs, _, jkept = _bundle(jax_telemetry, jax_flight, tmp_path / "jax")
    assert all(paths) and len(kept) == len(jkept) == 2   # keep-pruned
    # file names: flight_<ts>_<seq>_rank<r>_<reason>.json
    assert [k.split("_", 2)[2] for k in kept] == \
        [k.split("_", 2)[2] for k in jkept] == \
        ["004_rank2_reason3.json", "005_rank2_via_trigger.json"]
    assert sorted(ours) == sorted(theirs)
    assert matches(ours, "flight_record")
    for key in ("schema", "reason", "detail", "rank", "config"):
        assert ours[key] == theirs[key], key
    assert ours["reason"] == "reason3" and ours["rank"] == 2
    assert ours["config"] == ["rabit_telemetry=1"]
    assert sorted(ours["telemetry"]) == sorted(theirs["telemetry"])
    assert ours["telemetry"]["recorded"] == theirs["telemetry"]["recorded"]
    assert [(e["kind"], e["detail"]) for e in ours["events"]] == \
        [(e["kind"], e["detail"]) for e in theirs["events"]]
    assert "test_bundle_round_trip" in ours["stacks"]
    got = crossrank.extract_rounds(ours)
    assert got is not None and got[0] == 2


def test_from_config_matches_jax(tmp_path):
    args = [f"rabit_flight_dir={tmp_path}", "rabit_flight_keep=1"]
    ours = flight.FlightRecorder.from_config(Config.from_args(args), rank=0)
    try:
        assert ours is not None and ours.keep == 1
        assert flight.installed() is ours
    finally:
        ours.uninstall()
    theirs = jax_flight.FlightRecorder.from_config(
        JaxConfig.from_args(args), rank=0)
    theirs.uninstall()
    assert (ours.out_dir, ours.keep, ours.rank, ours.config_args) == \
        (theirs.out_dir, theirs.keep, theirs.rank, theirs.config_args)
    assert flight.FlightRecorder.from_config(Config.from_args([])) is None


def test_excepthook_chains(tmp_path):
    calls = []
    prev = sys.excepthook
    sys.excepthook = lambda *a: calls.append(a)
    fr = flight.FlightRecorder(str(tmp_path), rank=0).install()
    try:
        sys.excepthook(ValueError, ValueError("boom"), None)
        assert len(calls) == 1  # the previous hook still ran
        bundles = [f for f in os.listdir(tmp_path) if "_exception" in f]
        assert len(bundles) == 1
        with open(tmp_path / bundles[0]) as f:
            assert "boom" in json.load(f)["detail"]
    finally:
        fr.uninstall()
        sys.excepthook = prev
    assert sys.excepthook is prev


def test_sigterm_dumps_and_chains(tmp_path):
    seen = []
    prev = signal.signal(signal.SIGTERM, lambda s, f: seen.append(s))
    fr = flight.FlightRecorder(str(tmp_path), rank=0).install()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
        deadline = time.monotonic() + 5
        while not seen and time.monotonic() < deadline:
            time.sleep(0.01)
        assert seen == [signal.SIGTERM]  # the previous handler chained
        assert any("_sigterm" in f for f in os.listdir(tmp_path))
    finally:
        fr.uninstall()
        signal.signal(signal.SIGTERM, prev)


def _abort_bundle(tmp_path) -> dict:
    aborted = threading.Event()
    codes = []

    def seam(code):
        codes.append(code)
        aborted.set()

    fr = flight.FlightRecorder(str(tmp_path), rank=1).install()
    wd = Watchdog(floor_ms=40, abort=True, abort_fn=seam)
    try:
        with wd.guard("engine.allreduce", nbytes=1 << 20, deadline_s=0.05):
            assert aborted.wait(10), "the abort rung never fired"
    finally:
        wd.close()
        fr.uninstall()
    assert codes == [WATCHDOG_EXIT_CODE]
    bundles = [f for f in os.listdir(tmp_path) if "_watchdog_abort" in f]
    assert len(bundles) == 1
    return tmp_path / bundles[0]


def test_watchdog_abort_bundle_renders_in_jax_trace_report(tmp_path, telem):
    path = _abort_bundle(tmp_path)
    doc = json.loads(path.read_text())
    assert doc["reason"] == "watchdog_abort"
    assert "engine.allreduce" in doc["detail"]
    names = {c["name"] for c in doc["telemetry"]["counters"]}
    assert {"watchdog.expired", "watchdog.reform", "watchdog.abort"} <= names
    assert [e["kind"] for e in doc["events"]] == ["watchdog_expired"]
    # the JAX package's own reader takes the port's bundle as it is
    r = subprocess.run([sys.executable, os.path.join(ROOT, "tools",
                                                     "trace_report.py"),
                        str(path)], capture_output=True, text=True,
                       timeout=60, cwd=ROOT)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "`watchdog_abort`" in r.stdout
    assert "watchdog_expired" in r.stdout


def test_telemetry_smoke_runs_as_jaxs():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    r = subprocess.run([sys.executable, "-m", "rabit_tpu_torch.telemetry",
                        "--smoke"], capture_output=True, text=True,
                       timeout=60, cwd=ROOT, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "telemetry smoke ok" in r.stdout
    r = subprocess.run([sys.executable, "-m", "rabit_tpu_torch.telemetry"],
                       capture_output=True, text=True, timeout=60, cwd=ROOT,
                       env=env)
    assert r.returncode == 2   # usage without --smoke, as JAX's


# -- history -----------------------------------------------------------------

_ARTIFACTS = [
    {"world": 4, "n_buckets": 4, "bucket_elems": 1000000, "dtype": "float32",
     "compute_dim": 384, "compute_reps": 8, "path": "device",
     "backend": "nccl", "metric": "bucket_step_ms_overlap", "value": 2.5,
     "unit": "ms", "timestamp_utc": "20261017T120000Z"},
    {"metric": "histogram_gbps", "value": 41.5, "unit": "GB/s",
     "backend": "cuda", "n": 2097152, "gbps": {"k32": 40.0, "k256": 43.0},
     "bandwidth_vs_rows": {"262144": 10.0}, "correct": True,
     "timestamp_utc": "20261017T120001Z"},
    {"best_step_s": 0.0081, "compile_plus_first_step_s": 3.2,
     "device": "H100"},
    {"schema": "rabit_tpu.collective_sweep/v3", "rows": [
        {"section": "allreduce", "method": "ring", "wire": "int8:bf16@512",
         "n": 4096, "s_per_op": 1.2e-4},
        {"section": "allreduce", "method": "tree", "n": 4096,
         "s_per_op": 2e-5}]},
    {"schema": "rabit_tpu.soak/v1", "slos": [
        {"slo": "availability", "metric": "soak_availability",
         "value": 0.999, "unit": "", "direction": "higher"}]},
    {"schema": "x", "rows": []},
]


@pytest.mark.parametrize("doc", _ARTIFACTS,
                         ids=["overlap", "bench", "flagship", "sweep", "soak",
                              "foreign"])
def test_records_from_artifact_match_jax(doc):
    ours = history.records_from_artifact(doc, source="a.json")
    theirs = jax_history.records_from_artifact(doc, source="a.json")
    if "timestamp_utc" not in doc and ours:
        for r in ours + theirs:   # stamped at call time
            r.pop("timestamp_utc")
    assert ours == theirs
    assert history.config_fingerprint(doc) == \
        jax_history.config_fingerprint(doc)


def test_append_dedupes_and_survives_a_torn_line_as_jax(tmp_path):
    docs = [d for d in _ARTIFACTS if "timestamp_utc" in d]
    for mod, name in ((history, "port.jsonl"), (jax_history, "jax.jsonl")):
        path = str(tmp_path / name)
        recs = [r for d in docs for r in mod.records_from_artifact(d, "s")]
        assert mod.append(path, recs) == len(recs) == 5
        assert mod.append(path, recs) == 0   # dedupe on (metric, fp, ts)
        with open(path, "a") as f:
            f.write('{"metric": "torn", "val')   # a torn write
        assert len(mod.load(path)) == 5
        assert mod.append(path, recs[:1]) == 0
    assert (tmp_path / "port.jsonl").read_text() == \
        (tmp_path / "jax.jsonl").read_text()
    verdicts = history.gate(history.load(str(tmp_path / "port.jsonl")))
    assert verdicts == jax_history.gate(
        jax_history.load(str(tmp_path / "jax.jsonl")))


def test_history_path_is_the_ports_own():
    assert history.history_path("/r") == "/r/build/artifacts/history.jsonl"
    assert history.history_path() == os.path.join(
        ROOT, "build", "artifacts", "history.jsonl")
    assert "benchmarks" not in history.history_path()


# -- the data plane's flight notes -----------------------------------------

def _bare(mod, retries: int):
    """A data plane for ``_invoke`` without a world: the collective is
    scripted per test (the JAX suite's ``_bare_dataplane``)."""
    cls = mod.XlaDataPlane if mod is jax_dp else mod.TorchDataPlane
    dp = cls.__new__(cls)
    dp._lib = None
    dp._fail_at = None
    dp._invocations = 0
    dp._retries = retries
    dp.retries_total = 0
    dp._rank = 0
    dp._world = 2
    if mod is jax_dp:
        dp._formed_epoch = None
        dp.ensure_world = lambda epoch: None
    else:
        dp._formed_epoch = 0
        dp._round_epoch = None
        dp._epoch_round = 0
        dp._aborted = False
        dp.first_collective_at = None
        dp._form_world = lambda *a: None
    dp._teardown = lambda: None
    return dp


def _notes(mod, retries: int, fail_times: int) -> tuple:
    fl = jax_flight if mod is jax_dp else flight
    with fl._events_lock:
        fl._events.clear()
    dp = _bare(mod, retries)
    calls = []

    def allreduce(buf, op):
        calls.append(1)
        if len(calls) <= fail_times:
            buf[:] = -1
            raise RuntimeError("device lost")
        buf *= 2

    dp._allreduce = allreduce
    arr = np.arange(8, dtype=np.float64)
    rc = dp._invoke(arr.ctypes.data, arr.size,
                    DTYPE_ENUM[np.dtype(arr.dtype)], 2, 0, None)
    return rc, arr, [(n["kind"], n["detail"]) for n in fl.recent_events()]


@pytest.mark.parametrize("retries,fail_times", [(3, 2), (1, 5), (0, 1)],
                         ids=["recovered_in_place", "retries_spent",
                              "no_retries"])
def test_dataplane_flight_notes_match_jax(retries, fail_times, telem):
    ours = _notes(port_dp, retries, fail_times)
    theirs = _notes(jax_dp, retries, fail_times)
    assert ours[0] == theirs[0]
    np.testing.assert_array_equal(ours[1], theirs[1])
    assert ours[2] == theirs[2]
    kinds = [k for k, _ in ours[2]]
    if fail_times < retries + 1:
        assert ours[0] == 0
        assert kinds == ["recovery.retry"] * (fail_times + 1)
        assert "recovered in-collective after 2 retries crc=" in \
            ours[2][-1][1]
    else:
        assert ours[0] == 1
        assert kinds == ["recovery.retry"] * retries + ["link_reset"]
        assert ours[2][-1][1] == "rank 0 epoch 0: RuntimeError: device lost"


def test_rung_abort_fails_the_round_in_flight(telem):
    """The retry rung's ``abort`` (from another thread) while the
    collective runs: the collective ends normally (the stalled peer
    arrived), and the round fails all the same, noted as a link reset."""
    dp = _bare(port_dp, 0)
    teardowns = []
    dp._teardown = lambda: teardowns.append(dp.__dict__.update(
        _aborted=False) or 1)

    def allreduce(buf, op):
        dp.abort()   # the monitor thread's call, mid-collective
        buf *= 2

    dp._allreduce = allreduce
    arr = np.arange(4, dtype=np.float32)
    rc = dp._invoke(arr.ctypes.data, arr.size,
                    DTYPE_ENUM[np.dtype(arr.dtype)], 2, 0, None)
    assert rc == 1 and teardowns == [1] and not dp._aborted
    kinds = [n["kind"] for n in flight.recent_events()]
    assert kinds == ["link_reset"]
    assert "retry rung" in flight.recent_events()[-1]["detail"]
