"""The port's profiling twin (``rabit_tpu_torch/telemetry/profile.py``)
against ``rabit_tpu/telemetry/profile.py``, and its hooks in the port:

* ``sample_memory`` returns None in a process without CUDA (the CPU
  allocator keeps no count), and the snapshot's ``device_mem`` stays at
  zeros with 0 samples -- the one place where the port differs from the
  JAX package, which sums ``jax.live_arrays()`` on the CPU;
* the compile probe classifies calls as the JAX probe does, on the same
  cache growth, and records nothing for a function without
  ``_cache_size``; ``ops/_build.py::load`` runs under it as
  ``build:<library>`` (a first load is a compile sample and a miss, every
  later load a hit);
* the dispatch table's mtime cache counts hits and misses as the JAX
  loader does over the same file;
* ``configure`` and the memory poller, under both packages;
* ``trace_annotation``: a ``torch.profiler`` range when on, a shared
  ``nullcontext`` when off, and no operator either way (a
  ``TorchDispatchMode`` sees none)."""

import json
import os
import shutil
import threading
from pathlib import Path

import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import rabit_tpu.parallel.dispatch as jdispatch
import rabit_tpu.telemetry as jt
import rabit_tpu.telemetry.profile as jprofile
import rabit_tpu_torch.parallel.dispatch as pdispatch
import rabit_tpu_torch.telemetry as pt
from rabit_tpu.utils.config import Config as JConfig
from rabit_tpu_torch.ops import _build
from rabit_tpu_torch.telemetry import profile as pprofile
from rabit_tpu_torch.utils.config import Config

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def _planes_off():
    yield
    for tel, prof in ((jt, jprofile), (pt, pprofile)):
        tel.reset(enabled=False)
        prof.reset(enabled=False)
        prof.stop_poller()


def test_sample_memory_is_none_on_the_cpu_and_device_mem_stays_zero():
    assert not torch.cuda.is_initialized()
    pprofile.reset(enabled=False)
    assert pprofile.sample_memory() is None          # disabled
    pprofile.reset(enabled=True)
    assert pprofile.sample_memory() is None          # no CUDA allocator
    snap = pprofile.snapshot()
    assert snap["device_mem"] == {"live_bytes": 0, "peak_bytes": 0,
                                  "arrays": 0, "samples": 0}
    # the JAX package's twin counts the CPU's live arrays instead
    jprofile.reset(enabled=True)
    assert jprofile.sample_memory()["samples"] == 1


class _Jitted:
    """A stand-in with the jit cache API: its cache grows on the calls
    that ``compiles`` names."""

    def __init__(self, compiles):
        self.size, self.compiles, self.calls = 0, set(compiles), 0

    def _cache_size(self):
        return self.size

    def __call__(self):
        if self.calls in self.compiles:
            self.size += 1
        self.calls += 1


def test_compile_probe_classifies_calls_as_rabit_tpu_does():
    for prof in (jprofile, pprofile):
        prof.reset(enabled=True)
        fn = _Jitted({0, 3})
        for _ in range(5):
            with prof.jit_probe("step", fn):
                fn()
        with prof.jit_probe("eager", lambda: None):   # no cache API
            pass
    got, want = pprofile.snapshot(), jprofile.snapshot()
    assert got["jit_cache"] == want["jit_cache"] == [
        {"fn": "step", "hits": 3, "misses": 2}]
    assert [c["count"] for c in got["compile"]] == [2]
    assert [c["fn"] for c in want["compile"]] == ["step"]


def test_kernel_library_load_is_a_compile_sample_then_hits(monkeypatch):
    """``_build.load`` with the build and the ``dlopen`` stubbed (no nvcc
    here): one miss and one compile sample a library, hits after; no
    record at all with profiling off."""

    class _Lib:
        rabit_cuda_error_string = type("F", (), {})()

    opened = []
    monkeypatch.setattr(_build, "_loaded", {})
    monkeypatch.setattr(_build, "build", lambda names: {})
    monkeypatch.setattr(_build.ctypes, "CDLL",
                        lambda path: opened.append(path) or _Lib())
    pprofile.reset(enabled=False)
    _build.load("histogram")
    assert pprofile.snapshot()["jit_cache"] == []
    monkeypatch.setattr(_build, "_loaded", {})
    pprofile.reset(enabled=True)
    for name in ("histogram", "mask_only", "histogram", "histogram"):
        assert isinstance(_build.load(name), _Lib)
    snap = pprofile.snapshot()
    assert snap["jit_cache"] == [
        {"fn": "build:histogram", "hits": 2, "misses": 1},
        {"fn": "build:mask_only", "hits": 0, "misses": 1}]
    assert [(c["fn"], c["count"]) for c in snap["compile"]] == [
        ("build:histogram", 1), ("build:mask_only", 1)]
    assert len(opened) == 3 and _build.load._cache_size() == 2


def test_dispatch_table_cache_counts_as_rabit_tpu_does(tmp_path,
                                                       monkeypatch):
    table = sorted((ROOT / "benchmarks" / "artifacts").glob(
        "COLLECTIVE_SWEEP_*.json"))[-1]
    path = tmp_path / "COLLECTIVE_SWEEP_x.json"
    shutil.copy(table, path)
    rows = {}
    for name, prof, disp in (("jax", jprofile, jdispatch),
                             ("port", pprofile, pdispatch)):
        disp.clear_cache()
        prof.reset(enabled=True)
        for _ in range(3):
            assert disp.load_table(str(path)) is not None
        mtime = path.stat().st_mtime
        os.utime(path, (mtime + 5, mtime + 5))    # a new mtime: re-parse
        disp.load_table(str(path))
        rows[name] = prof.snapshot()["jit_cache"]
        disp.clear_cache()
        os.utime(path, (mtime, mtime))
    assert rows["port"] == rows["jax"] == [
        {"fn": "dispatch_table", "hits": 2, "misses": 2}]


def test_configure_and_the_memory_poller_follow_rabit_tpu():
    for prof, cfg in ((jprofile, JConfig), (pprofile, Config)):
        prof.reset(enabled=False)
        assert not prof.configure(cfg({"rabit_engine": "empty"}))
        assert prof.configure(cfg({"rabit_profile": "1",
                                   "rabit_profile_memory_poll_ms": "20"}))
        poller = [t for t in threading.enumerate()
                  if t.name == "rabit-profile-mem"]
        assert poller, prof.__name__
        prof.stop_poller()
        assert not [t for t in threading.enumerate()
                    if t.name == "rabit-profile-mem" and t.is_alive()]
        assert not prof.configure(cfg({"rabit_profile": "0"}))


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def test_trace_annotation_is_a_profiler_range_that_adds_no_operator():
    x = torch.arange(8.0)
    seen = {}
    for on in (False, True):
        pt.set_enabled(on)
        with _Ops() as mode:
            with pt.trace_annotation("rabit_allreduce_ring"):
                y = x * 2
        seen[on] = mode.ops
        assert torch.equal(y, x * 2)
    assert seen[True] == seen[False] == ["aten.mul.Tensor"]
    pt.set_enabled(True)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with pt.trace_annotation("rabit_allreduce_tree"):
            (x + 1).sum()
    names = {e.key for e in prof.key_averages()}
    assert "rabit_allreduce_tree" in names
    pt.set_enabled(False)
    assert pt.trace_annotation("a") is pt.trace_annotation("b")


def test_profile_section_rides_the_summary_only_when_on():
    pt.reset(enabled=True)
    pprofile.reset(enabled=False)
    assert "profile" not in pt.build_summary(pt.snapshot())
    pprofile.reset(enabled=True)
    pprofile.record_cost("allreduce", "ring", "bf16", 1 << 20, 4, 4)
    doc = pt.build_summary(pt.snapshot(), rank=0, world_size=4)
    assert doc["profile"]["cost"] == [
        {"name": "allreduce", "method": "ring", "wire": "bf16", "count": 1,
         "flops": 786432, "wire_bytes": 3145728}]
    json.dumps(doc)
