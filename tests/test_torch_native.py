"""The port's host control plane beside ``rabit_tpu``'s: the copies of
``utils/log.py``, ``utils/retry.py`` and ``engine/ckpt_store.py`` against
the originals (checkpoint records read both ways), the native core's build
from ``native/src``, and the host API under the robust engine at world 1
against ``rabit_tpu`` under the same engine."""

import os
import random
from pathlib import Path

import numpy as np
import pytest

import rabit_tpu
import rabit_tpu_torch
from rabit_tpu.engine import ckpt_store as jax_store
from rabit_tpu.utils import log as jax_log
from rabit_tpu.utils import retry as jax_retry
from rabit_tpu_torch.engine import _native_build, ckpt_store
from rabit_tpu_torch.utils import log, retry

ROOT = Path(rabit_tpu_torch.__file__).resolve().parents[1]


@pytest.fixture(scope="module", autouse=True)
def native_core():
    _native_build.build()


def test_log_copy_matches_rabit_tpu():
    for mod in (log, jax_log):
        mod.check(True, "fine")
        with pytest.raises(mod.CheckError, match="check failed: boom"):
            mod.check(False, "boom")
    assert (log.DEBUG, log.INFO, log.WARN) == (jax_log.DEBUG, jax_log.INFO,
                                               jax_log.WARN)


def test_log_lines_carry_the_identity(capsys):
    log.set_identity(2, 4)
    try:
        log.log_warn("x=%d", 7)
    finally:
        log.clear_identity()
    err = capsys.readouterr().err
    assert "[rabit_tpu_torch r2/4" in err and "warning: x=7" in err


@pytest.mark.parametrize("attempt", [0, 1, 3, 9])
def test_retry_backoff_copy_matches_rabit_tpu(attempt):
    for jitter in (0.0, 0.5):
        got = retry.backoff_delay(attempt, 0.1, 2.0, jitter,
                                  rng=random.Random(attempt))
        want = jax_retry.backoff_delay(attempt, 0.1, 2.0, jitter,
                                       rng=random.Random(attempt))
        assert got == want


def test_retry_call_and_hostport_copy_match_rabit_tpu():
    for mod in (retry, jax_retry):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("refused")
            return "up"
        assert mod.retry_call(flaky, attempts=5, base_s=0.001,
                              max_s=0.002) == "up"
        assert len(calls) == 3
        with pytest.raises(mod.RetryError):
            mod.retry_call(lambda: (_ for _ in ()).throw(OSError("x")),
                           attempts=2, base_s=0.001, max_s=0.001)
    for addr in ("h:12", ":9", "bad", "", "h:x", None):
        assert retry.parse_hostport(addr) == jax_retry.parse_hostport(addr)


def test_checkpoint_records_read_both_ways(tmp_path):
    for v, g, lo in ((1, b"glob", b""), (7, b"\x00" * 300, b"local bytes")):
        rec = ckpt_store.encode_record(v, g, lo)
        assert rec == jax_store.encode_record(v, g, lo)
        assert jax_store.decode_record(rec) == (v, g, lo)
        assert ckpt_store.decode_record(rec) == (v, g, lo)
        assert ckpt_store.is_wrapped(rec) and jax_store.is_wrapped(rec)
    ours = ckpt_store.CheckpointStore(str(tmp_path / "a"), rank=1, keep=2)
    for v in (1, 2, 3):
        ours.save(v, f"g{v}".encode(), f"l{v}".encode())
    theirs = jax_store.CheckpointStore(str(tmp_path / "a"), rank=1, keep=2)
    assert theirs.versions() == ours.versions() == [2, 3]
    assert theirs.latest() == (3, b"g3", b"l3")
    theirs.save(4, b"g4")
    assert ours.latest() == (4, b"g4", b"")
    # a torn record is skipped by both, the older version stays eligible
    Path(ours.path_for(4)).write_bytes(b"RBTCKPT1" + b"\x01" * 10)
    assert ours.latest() == theirs.latest() == (3, b"g3", b"l3")
    with pytest.raises(ValueError):
        ckpt_store.decode_record(b"RBTCKPT1" + b"\x01" * 10)


def test_native_core_built_from_sources_into_the_build_dir():
    lib = _native_build.library_path()
    assert lib.is_file()
    assert lib.parent == ROOT / "build" / "rabit_tpu_torch" / "native"
    assert lib.name.startswith("librabit_tpu_core-") and lib.suffix == ".so"
    assert _native_build.build() == 0.0    # built once, then reused
    assert _native_build.library() == str(lib)
    assert "native/build" not in _native_build.library()


def test_native_core_env_override(monkeypatch):
    monkeypatch.setenv(_native_build.LIB_ENV, "/elsewhere/libx.so")
    assert _native_build.library() == "/elsewhere/libx.so"


def test_native_build_hash_follows_the_sources(tmp_path, monkeypatch):
    """A copy of the sources gets the same name; an edit, another."""
    import shutil
    copy = tmp_path / "native"
    for sub in ("src", "include"):
        shutil.copytree(ROOT / "native" / sub, copy / sub)
    monkeypatch.setattr(_native_build, "NATIVE", copy)
    assert _native_build.library_path().name == \
        _native_build.library_path().name
    want = _native_build.library_path().name
    monkeypatch.setattr(_native_build, "NATIVE", ROOT / "native")
    assert _native_build.library_path().name == want
    monkeypatch.setattr(_native_build, "NATIVE", copy)
    (copy / "src" / "extra.h").write_text("// edit\n")
    assert _native_build.library_path().name != want


def test_failed_native_build_raises_with_the_compiler_output(
        tmp_path, monkeypatch):
    bad = tmp_path / "native"
    (bad / "src").mkdir(parents=True)
    (bad / "include").mkdir()
    (bad / "src" / "broken.cc").write_text("int f( { return 0; }\n")
    monkeypatch.setattr(_native_build, "NATIVE", bad)
    monkeypatch.setattr(_native_build, "BUILD_DIR", tmp_path / "out")
    with pytest.raises(RuntimeError, match="broken.cc"):
        _native_build.build()
    assert list((tmp_path / "out").iterdir()) == []   # no torn library


def _drive_robust(lib, ckpt_dir):
    """One user program through either package's host API on the robust
    engine at world 1 (no tracker), with a durable checkpoint store."""
    lib.finalize()
    lib.init([f"rabit_ckpt_dir={ckpt_dir}"], engine="robust")
    out = {"rank": lib.get_rank(), "world": lib.get_world_size(),
           "dist": lib.is_distributed(), "host": lib.get_processor_name(),
           "fresh": lib.load_checkpoint(), "v0": lib.version_number()}
    seen = []
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    out["sum"] = lib.allreduce(data, lib.SUM,
                               prepare_fun=lambda a: seen.append(a.shape))
    out["prepared"] = seen
    out["max_u64"] = lib.allreduce(np.array([2**63 + 5], np.uint64), lib.MAX)
    out["bitor"] = lib.allreduce(np.array([5, 8], np.int32), lib.BITOR)
    out["async"] = lib.allreduce_async(np.arange(4, dtype=np.int64),
                                       lib.SUM).wait()
    out["rs"] = lib.reduce_scatter(np.arange(6.0), lib.SUM)
    out["ag"] = lib.allgather(np.array([7, 8], np.int64))
    out["bcast"] = lib.broadcast({"k": [1, 2]}, 0)
    lib.checkpoint({"round": 1}, local_model=[1])
    lib.lazy_checkpoint({"round": 2})
    out["v2"] = lib.version_number()
    lib.init_after_exception()
    lib.finalize()
    # a new engine cold-restarts from the durable store
    lib.init([f"rabit_ckpt_dir={ckpt_dir}"], engine="robust")
    out["cold"] = lib.load_checkpoint()
    out["v_cold"] = lib.version_number()
    lib.finalize()
    return out


def test_host_api_under_robust_engine_matches_rabit_tpu(tmp_path):
    want = _drive_robust(rabit_tpu, tmp_path / "jax")
    got = _drive_robust(rabit_tpu_torch, tmp_path / "port")
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_equal(got[k], want[k], err_msg=k)
    assert got["v2"] == 2 and got["cold"] == (2, {"round": 2})
    # the stores hold the same records
    for v in (1, 2):
        a = (tmp_path / "jax" / "r0" / f"ckpt_v{v}.rbt").read_bytes()
        b = (tmp_path / "port" / "r0" / f"ckpt_v{v}.rbt").read_bytes()
        assert a == b


def test_unported_knobs_raise_rather_than_be_ignored(tmp_path):
    """No knob of the JAX engine is refused any more. The hot standby's
    ``rabit_tracker_standby`` is accepted, alone and with
    ``rabit_elastic``, as the JAX engine accepts it (the launcher and the
    skew poller act on it), and the engine computes; the telemetry
    plane's knobs are honoured (``rabit_telemetry``, ``rabit_profile``,
    ``rabit_events``), and so are the live plane's ``rabit_metrics_port``
    (the engine serves its endpoint), the skew plane's
    ``rabit_skew_adapt`` (accepted at init), the watchdog's
    ``rabit_deadline_ms`` (the engine's watchdog carries it) and the
    flight recorder's ``rabit_flight_dir`` (installed, with the rank), and
    elastic membership's ``rabit_elastic`` is accepted, as the JAX engine
    accepts it (the launcher and the tracker act on it)."""
    from rabit_tpu_torch import telemetry
    from rabit_tpu_torch.telemetry import events, flight, profile
    rabit_tpu_torch.finalize()
    for extra in ([], ["rabit_elastic=1"]):
        rabit_tpu_torch.init(extra + ["rabit_tracker_standby=127.0.0.1:9"],
                             engine="robust")
        try:
            assert rabit_tpu_torch._engine is not None
            x = np.arange(8, dtype=np.int64)
            np.testing.assert_array_equal(
                rabit_tpu_torch.allreduce(x.copy(), rabit_tpu_torch.SUM), x)
        finally:
            rabit_tpu_torch.finalize()
    assert rabit_tpu_torch._engine is None
    knobs = ["rabit_telemetry=1", "rabit_profile=1", "rabit_events=1",
             "rabit_metrics_port=0", "rabit_skew_adapt=1",
             "rabit_deadline_ms=500", f"rabit_flight_dir={tmp_path}",
             "rabit_elastic=1"]
    try:
        rabit_tpu_torch.init(knobs, engine="robust")
        eng = rabit_tpu_torch._engine
        assert telemetry.enabled() and profile.enabled()
        assert events.enabled()
        assert eng._metrics_server is not None
        assert eng._watchdog.enabled and eng._watchdog.floor_ms == 500
        assert flight.installed() is eng._flight and eng._flight.rank == 0
    finally:
        rabit_tpu_torch.finalize()
        rabit_tpu_torch.init([k.replace("=1", "=0") for k in knobs
                              if "metrics_port" not in k
                              and "flight_dir" not in k], engine="robust")
        rabit_tpu_torch.finalize()
    assert not telemetry.enabled() and not events.enabled()
    assert flight.installed() is None


def test_torch_dataplane_refuses_the_cpu_fallback(monkeypatch):
    """``rabit_dataplane=torch`` without ``rabit_device=cpu`` means the
    card: where there is none, init raises before any rendezvous."""
    import torch
    rabit_tpu_torch.finalize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rabit_tpu_torch.init([], engine="robust_torch")
    with pytest.raises(ValueError, match="rabit_dataplane"):
        rabit_tpu_torch.init(["rabit_dataplane=xla"], engine="robust")
    with pytest.raises(ValueError, match="rabit_reduce_method"):
        rabit_tpu_torch.init(["rabit_device=cpu", "rabit_reduce_method=x"],
                             engine="robust_torch")
    with pytest.raises(ValueError, match="rabit_dataplane_wire"):
        rabit_tpu_torch.init(["rabit_device=cpu",
                              "rabit_dataplane_wire=int7"],
                             engine="robust_torch")
    assert rabit_tpu_torch._engine is None
    assert os.environ.get("RABIT_REDUCE_METHOD") is None
