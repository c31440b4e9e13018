"""The port's measurement entry points on the CPU: its copy of
``slope_time`` against ``rabit_tpu/utils/slope.py`` under one fake clock,
and ``python -m rabit_tpu_torch.bench``, ``.tools.histogram_sweep`` and
``.tools.kernel_hw_proof`` run end to end with ``--device cpu --smoke`` in
a subprocess (their kernels take the plain versions on the CPU), and
refusing to run without a card when not given ``--device cpu``.

Their timings on the card come only from ``chip_smoke.py`` there."""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from rabit_tpu.utils import slope as jax_slope
from rabit_tpu_torch.tools import ARTIFACTS
from rabit_tpu_torch.utils import slope

ROOT = Path(__file__).resolve().parents[1]
FIVE = {"metric", "value", "unit", "vs_baseline", "correct"}


class FakeClock:
    """``time.perf_counter`` whose time moves only in ``run_fn``: a fixed
    cost a batch plus ``per_k`` an iteration, and a repeating ``jitter``."""

    def __init__(self, fixed, per_k, jitter=(0.0,)):
        self.now, self.fixed, self.per_k = 0.0, fixed, per_k
        self.jitter, self.calls = jitter, 0

    def __call__(self):
        return self.now

    def run(self, k, salt):
        self.now += (self.fixed + self.per_k * k
                     + self.jitter[self.calls % len(self.jitter)])
        self.calls += 1
        return np.float32(salt)


def _both(monkeypatch, clock_args, **kw):
    """Each implementation on a fresh clock of the same series."""
    out = []
    for impl in (jax_slope, slope):
        clock = FakeClock(*clock_args)
        monkeypatch.setattr(impl.time, "perf_counter", clock)
        try:
            out.append(impl.slope_time(clock.run, 8, 64, **kw))
        except RuntimeError as e:
            out.append(e)
    return out


@pytest.mark.parametrize("clock_args", [
    (0.070, 0.003), (0.001, 2e-5, (0.0, 1e-4, 3e-5)), (0.0, 1e-6)])
def test_slope_time_matches_jax_package_on_stable_series(monkeypatch,
                                                         clock_args):
    jax_t, ours = _both(monkeypatch, clock_args)
    assert ours == jax_t
    assert ours == pytest.approx(clock_args[1], rel=0.2)


def test_slope_time_raises_like_jax_package_on_flat_series(monkeypatch):
    jax_e, ours = _both(monkeypatch, (0.070, 0.0))
    assert isinstance(jax_e, RuntimeError) and isinstance(ours, RuntimeError)
    assert str(ours) == str(jax_e)
    assert "unstable after 3 attempts" in str(ours)


def test_slope_time_noisy_value_matches_jax_package(monkeypatch):
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jax_t, ours = _both(monkeypatch, (0.070, 1e-5, (0.0, 0.02)),
                            allow_noisy=True)
    assert ours == jax_t
    assert len(caught) == 2
    assert [str(w.message) for w in caught[1:]] == \
        [str(w.message) for w in caught[:1]]
    assert all(w.category is RuntimeWarning for w in caught)


def test_slope_time_refuses_no_attempts():
    for impl in (jax_slope, slope):
        with pytest.raises(ValueError, match="attempts"):
            impl.slope_time(lambda k, s: 0, 1, 2, attempts=0)


def _run(module, *args, env_extra=None, timeout=300):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    env.update(env_extra or {})
    return subprocess.run([sys.executable, "-m", module, *args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=timeout)


def _artifacts():
    """The entry points' artifacts where a run could leave them: their
    default ``--out``, the repo's root and ``benchmarks/``."""
    names = ("HIST_SWEEP_TORCH_*", "BENCH_TORCH_*", "KERNEL_HW_TORCH_*")
    return {p for n in names
            for p in [*ROOT.glob(n), *ARTIFACTS.rglob(n),
                      *(ROOT / "benchmarks").rglob(n)]}


SMOKES = {
    "rabit_tpu_torch.tools.histogram_sweep": "sweep",
    "rabit_tpu_torch.bench": "bench",
    "rabit_tpu_torch.tools.kernel_hw_proof": "proof",
}


@pytest.mark.parametrize("module", sorted(SMOKES))
def test_cpu_smoke_runs_end_to_end(module):
    before = _artifacts()
    res = _run(module, "--device", "cpu", "--smoke")
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    kind = SMOKES[module]
    if kind == "sweep":
        assert "mask_only counts correct=True" in lines
        rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
        assert [(r["rows"], r["nbins"]) for r in rows] == \
            [(1 << 17, 256), (1 << 17, 1024)]
        for r in rows:
            # the JAX tool's smoke contract (tests/test_bench_smoke.py)
            assert {"mask_only_ms", "fast_ms", "high_ms",
                    "per_component_ms"} <= set(r)
            assert {"mask_only_gbps", "fast_gbps", "high_gbps",
                    "mask_floor_frac_of_high"} <= set(r)
    elif kind == "bench":
        assert len(lines) == 1, lines
        line = json.loads(lines[0])
        assert set(line) == FIVE
        assert line["correct"] is True
        assert line["metric"] == "histogram_allreduce_throughput"
        assert line["unit"] == "GB/s" and line["value"] > 0
    else:
        assert lines[-1] == "smoke ok"
        assert any(ln.startswith("flash fwd+bwd chain") for ln in lines)
    assert _artifacts() == before


@pytest.mark.parametrize("module", sorted(SMOKES))
def test_refuses_to_run_without_a_card(module):
    """Not given ``--device cpu`` and with no card visible, each entry
    point exits non-zero and prints no value."""
    res = _run(module, "--smoke", env_extra={"CUDA_VISIBLE_DEVICES": ""},
               timeout=120)
    assert res.returncode != 0
    assert "torch.cuda.is_available() is False" in res.stderr \
        or "no CUDA device" in res.stderr
    for ln in res.stdout.strip().splitlines():
        assert not ln.startswith("{") or "value" not in json.loads(ln)
    if SMOKES[module] == "bench":
        assert json.loads(res.stdout) == {"status": "no_cuda"}
    else:
        assert res.stdout == ""


def test_kernel_variants_refuses_to_run_without_a_card(tmp_path):
    """``kernel_variants.py`` builds and times kernels only on a card;
    with none visible it exits non-zero before it builds anything."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=str(ROOT), CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, str(ROOT / "kernel_variants.py"),
                          str(tmp_path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "no CUDA device" in res.stderr
    assert list(tmp_path.iterdir()) == []


def test_tracker_bench_smoke_is_bounded_renders_and_writes_nothing_else(
        tmp_path):
    """``python -m rabit_tpu_torch.tools.tracker_bench --smoke`` climbs its
    tiny ladder against the port's tracker: a ``tracker_bench/v1``
    document with ``bounded_threads``, which the port's ``trace_report``
    renders; it writes its ``--out`` and nothing else (no history)."""
    from rabit_tpu_torch.tools import trace_report
    hist = ARTIFACTS / "history.jsonl"

    def elsewhere():
        names = ("TRACKER_BENCH*", "tracker_bench*")
        return ({p for n in names for p in [
            *ROOT.glob(n), *ARTIFACTS.rglob(n),
            *(ROOT / "benchmarks").rglob(n)]},
            hist.stat().st_mtime_ns if hist.exists() else None)

    before = elsewhere()
    out = tmp_path / "bench.json"
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-m",
                          "rabit_tpu_torch.tools.tracker_bench", "--smoke",
                          "--out", str(out)], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "tracker_bench smoke ok" in res.stderr
    doc = json.loads(out.read_text())
    assert doc == json.loads(res.stdout)
    assert doc["schema"] == "rabit_tpu.tracker_bench/v1"
    assert doc["bounded_threads"] is True and doc["smoke"] is True
    assert [lv["idle_conns"] for lv in doc["levels"]] == [0, 50, 150]
    assert doc["levels"][-1]["open_conns"] >= 150 and doc["cut"] == []
    text = trace_report.render(doc)
    assert "threads bounded" in text and "| 150 |" in text
    assert [p.name for p in tmp_path.iterdir()] == ["bench.json"]
    assert elsewhere() == before


def _new_artifacts():
    """Where the MPI, wire and boosted tools could leave an artifact."""
    names = ("SOCKET_VS_MPI_*", "WIRE_BENCH_*", "BOOSTED_BENCH_*")
    return {p for n in names
            for p in [*ROOT.glob(n), *ARTIFACTS.rglob(n),
                      *(ROOT / "benchmarks").rglob(n)]}


def test_socket_vs_mpi_smoke_contract():
    """Both engines run the speed worker at world 2 (the socket engine
    under the port's launcher, the MPI engine under ``mpirun``); each
    row has both engines' MB/s of the three collectives; nothing is
    written. Skips only where the machine has no MPI runtime."""
    from rabit_tpu_torch.tools import mpi_launch
    ok, why = mpi_launch.have_mpi()
    if not ok:
        pytest.skip(why)
    before = _new_artifacts()
    res = _run("rabit_tpu_torch.tools.socket_vs_mpi", "--smoke",
               timeout=900)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "smoke ok"
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert [(r["world"], r["ndata"], r["nrep"]) for r in rows] == \
        [(2, 1024, 3)]
    for key in ("socket_mbs", "mpi_mbs"):
        assert set(rows[0][key]) == {"sum", "max", "bcast"}
        assert all(v > 0 for v in rows[0][key].values())
    assert "MPI runtime" in res.stderr
    assert _new_artifacts() == before


def test_socket_vs_mpi_without_mpi_exits_2_naming_the_search(
        monkeypatch, tmp_path, capsys):
    from rabit_tpu_torch.engine import _native_build as NB
    from rabit_tpu_torch.tools import socket_vs_mpi
    monkeypatch.setattr(NB, "MPI_PREFIXES", (str(tmp_path / "mpi"),))
    monkeypatch.setattr(NB, "MPI_RUNTIME_DIRS", (str(tmp_path / "lib"),))
    monkeypatch.setattr(NB.shutil, "which", lambda name: None)
    assert socket_vs_mpi.main(["--smoke"]) == 2
    out, err = capsys.readouterr()
    assert out == ""
    assert "no MPI runtime" in err and str(tmp_path / "lib") in err


def test_speed_worker_lines_read_by_both_parsers():
    """The port's speed worker prints ``speed_test.cc``'s lines: the JAX
    tool's parser and the port's read the same MB/s from them."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import socket_vs_mpi as jax_tool
    finally:
        sys.path.pop(0)
    from rabit_tpu_torch.tools import socket_vs_mpi
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run(
        [sys.executable, "-m", "rabit_tpu_torch.tracker.launch", "-n", "2",
         "--timeout", "600", *socket_vs_mpi.WORKER, "ndata=4096", "nrep=2",
         "rabit_engine=base"], cwd=ROOT, env=env, capture_output=True,
        text=True, timeout=600)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    assert "== speed_test: 4096 floats (16384 bytes) x 2 reps, world=2 ==" \
        in res.stdout
    got = socket_vs_mpi.parse_speed(res.stdout)
    assert got == jax_tool.parse_speed(res.stdout)
    assert set(got) == {"sum", "max", "bcast"}


def test_wire_bench_smoke_contract():
    """The host phase at world 4 and n = 4096 through the port's
    launcher, each wire's sum checked by the worker, its hop bytes the
    JAX tool's; the card phase's codec rows on the CPU at n = 4096 (no
    key names a TPU); nothing written."""
    sys.path.insert(0, str(ROOT / "tools"))
    try:
        import wire_bench as jax_tool
    finally:
        sys.path.pop(0)
    before = _new_artifacts()
    res = _run("rabit_tpu_torch.tools.wire_bench", "--smoke", "--device",
               "cpu", timeout=900)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "smoke ok"
    rows = [json.loads(ln) for ln in lines if ln.startswith("{")]
    host = [r for r in rows if "world" in r]
    codec = [r for r in rows if "ns_per_elem" in r]
    assert [(r["wire"], r["world"], r["n"]) for r in host] == \
        [(w, 4, 4096) for w in ("none", "bf16", "int8")]
    for r in host:
        assert r["s_per_op"] > 0
        assert r["hop_bytes"] == jax_tool.hop_bytes(4096, 4, r["wire"])
    assert [(r["wire"], r["n"], r["device"]) for r in codec] == \
        [(w, 4096, "cpu") for w in ("none", "bf16", "int8")]
    for r in codec:
        assert r["ns_per_elem"] > 0 and "tpu" not in json.dumps(r)
    assert all("overhead_vs_f32" in r for r in codec[1:])
    assert _new_artifacts() == before


def test_boosted_bench_smoke_contract():
    """Phase A's 8 launched host workers and phase B's build of the same
    per-worker workload (the plain version on the CPU), with the launch
    count and the derived round; nothing written."""
    before = _new_artifacts()
    res = _run("rabit_tpu_torch.tools.boosted_bench", "--smoke", "--device",
               "cpu", timeout=900)
    assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-2000:]
    lines = res.stdout.strip().splitlines()
    assert lines[-1] == "smoke ok"
    host, dev = [json.loads(ln) for ln in lines if ln.startswith("{")]
    assert host["phase"] == "host_8_workers" and host["world"] == 8
    assert host["contributions_per_worker"] == 4096 * 16
    assert host["nbins"] == 1024 and host["rounds_timed"] == 2
    assert dev["phase"] == "card_kernel" and dev["device"] == "cpu"
    assert dev["launches"] == 0     # the plain version launches nothing
    assert dev["contributions"] == 4096 * 16 and dev["nbins"] == 1024
    assert dev["card_round_ms"] == pytest.approx(
        dev["card_kernel_ms_per_round"] + host["allreduce_ms_per_round"])
    assert dev["speedup_vs_host_round"] == pytest.approx(
        host["host_round_ms"] / dev["card_round_ms"])
    assert _new_artifacts() == before


@pytest.mark.parametrize("module", ["rabit_tpu_torch.tools.wire_bench",
                                    "rabit_tpu_torch.tools.boosted_bench"])
@pytest.mark.parametrize("args,env_extra", [
    (("--device", "cpu"), None),
    (("--smoke",), {"CUDA_VISIBLE_DEVICES": ""})])
def test_card_phases_refuse_to_run_without_a_card(module, args, env_extra):
    """At full size on the CPU, or with no card visible, the card phases
    exit non-zero before anything runs and print no result."""
    before = _new_artifacts()
    res = _run(module, *args, env_extra=env_extra, timeout=120)
    assert res.returncode != 0
    assert res.stdout == ""
    assert "needs a CUDA device" in res.stderr or \
        "torch.cuda.is_available() is False" in res.stderr
    assert _new_artifacts() == before
