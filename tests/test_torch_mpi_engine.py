"""The port's ``mpi`` engine (``rabit_engine=mpi``) against the JAX
package's, and the MPI build and launchers it runs on.

The port builds the native core's MPI variant itself
(``engine/_native_build.py``: ``-DRT_WITH_MPI`` against the runtime
``find_mpi`` finds; here the bare ``libmpi.so.40`` through
``native/src/mpi_abi_shim.h``) and its own launchers
(``tools/mpi_launch.py``: the ``orted`` and ``mpirun`` shims of
``native/test`` under a scaffolded ``OPAL_PREFIX``). The JAX package runs
on its CMake build (``native/build``). The same program
(``tests/workers/torch_mpi_worker.py``) runs through both packages at
worlds 1, 2 and 4 under ``mpirun --oversubscribe``; every result must be
equal bit for bit, and right against numpy. The world tests skip only
where this machine has no MPI runtime.
"""

import hashlib
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import rabit_tpu_torch
from rabit_tpu_torch.engine import _native_build as NB
from rabit_tpu_torch.engine import native as port_native
from rabit_tpu_torch.tools import mpi_launch

ROOT = Path(__file__).resolve().parents[1]
WORKER = ROOT / "tests" / "workers" / "torch_mpi_worker.py"
sys.path.insert(0, str(WORKER.parent))
import torch_mpi_worker as W  # noqa: E402

SEED = 5
WORLD_TIMEOUT_S = 240
FLOAT_TOL = {"float32": 1e-5, "float64": 1e-12}


@pytest.fixture(scope="module")
def mpi(tmp_path_factory):
    """(env, mpirun) of this machine's MPI runtime and the port's
    launchers; skips where there is no runtime."""
    ok, why = mpi_launch.have_mpi()
    if not ok:
        pytest.skip(why)
    return mpi_launch.scaffold_mpi(str(tmp_path_factory.mktemp("mpi")))


def _world(mpi, world: int, pkg: str, out: Path, owner: str = "",
           core: str = "", **extra) -> list:
    """Each rank's results of the worker at ``world`` through ``pkg``;
    ``core``, where given, is the native library every rank must load."""
    env, mpirun = mpi
    out.mkdir()
    env = dict(env, MPI_PKG=pkg, MPI_SEED=str(SEED), MPI_OWNER=owner,
               MPI_LIBRARY=NB.mpi_runtime().library,
               RABIT_RESULT_DIR=str(out), PYTHONPATH=str(ROOT),
               JAX_PLATFORMS="cpu")
    env.update(extra)
    res = subprocess.run(
        mpi_launch.mpirun_cmd(mpirun, world, [sys.executable, str(WORKER)]),
        env=env, capture_output=True, text=True, timeout=WORLD_TIMEOUT_S)
    assert res.returncode == 0, (pkg, res.stdout[-2000:], res.stderr[-3000:])
    assert f"mpi worker world {world} done" in res.stdout, res.stdout
    if core:
        for r in range(world):
            assert f"rank {r} core {core}\n" in res.stdout, res.stdout
    return [dict(np.load(out / f"rank{r}.npz")) for r in range(world)]


def _expected(world: int) -> dict:
    """Every collective's result by numpy, from every rank's inputs."""
    ins = [W.inputs(r, SEED) for r in range(world)]
    want = {}
    for key in ins[0]:
        xs = np.stack([d[key] for d in ins])
        op = key.partition("_")[2]
        if key == "custom":
            want[key] = np.stack([xs[:, :, 0].max(0), xs[:, :, 1].sum(0)], 1)
        elif key == "blob":
            want["bcast"] = xs[1 % world]
        elif op in ("sum", "lazy"):
            want[key] = xs.sum(0, dtype=xs.dtype)
        elif op == "max":
            want[key] = xs.max(0)
        elif op == "min":
            want[key] = xs.min(0)
        else:
            want[key] = np.bitwise_or.reduce(xs, 0)
    return want


@pytest.mark.parametrize("world,owner", [(1, ""), (2, "app"), (4, "")])
def test_mpi_engine_equals_the_jax_package_bit_for_bit(mpi, tmp_path, world,
                                                       owner):
    """f32, f64, i32 and u8 under SUM, MAX, MIN and BITOR, a lazy
    (prepare_fun) SUM, a custom reducer, a broadcast from root 1 and the
    version-only checkpoints: the port equal to ``rabit_tpu`` on every
    rank, both right against numpy. At world 2 the program owns MPI
    (``MPI_Init`` before ``init``): neither engine finalizes it."""
    port = _world(mpi, world, "rabit_tpu_torch", tmp_path / "port", owner)
    jax = _world(mpi, world, "rabit_tpu", tmp_path / "jax", owner)
    _equal(port, jax)
    _right(port, world, owner)


def _equal(a: list, b: list) -> None:
    """Two worlds' results, bit for bit, rank by rank."""
    for r in range(len(a)):
        assert a[r].keys() == b[r].keys()
        for key in a[r]:
            assert a[r][key].dtype == b[r][key].dtype, key
            assert np.array_equal(a[r][key], b[r][key]), (r, key)


def _right(results: list, world: int, owner: str) -> None:
    """Every rank's results against numpy and MpiComm's semantics."""
    want = _expected(world)
    for r, got in enumerate(results):
        assert got["world"][0] == world
        assert bool(got["distributed"][0]) == (world > 1)
        # two checkpoints count two versions; the load gives nothing back
        assert got["versions"].tolist() == [0, 1, 2, 0]
        assert got["model_none"][0]
        assert bool(got["finalized"][0]) == (owner != "app")
        for key, w in want.items():
            dtype = w.dtype.name
            if key.endswith("_sum") and dtype in FLOAT_TOL:
                # MPI's reduction order is not numpy's
                np.testing.assert_allclose(got[key], w,
                                           rtol=FLOAT_TOL[dtype],
                                           atol=FLOAT_TOL[dtype], err_msg=key)
            else:
                assert np.array_equal(got[key], w), (r, key)


def test_mpi_build_is_a_library_of_its_own(mpi):
    """The MPI variant builds once into a name of its own that links
    libmpi; the plain library, which every other engine loads, does not."""
    NB.build("mpi")
    mpi_lib, plain = NB.library_path("mpi"), NB.library_path("plain")
    assert mpi_lib.is_file() and mpi_lib != plain
    assert mpi_lib.name.startswith("librabit_tpu_core_mpi-")
    assert mpi_lib.parent == plain.parent == \
        ROOT / "build" / "rabit_tpu_torch" / "native"
    assert NB.build("mpi") == 0.0
    assert NB.library("mpi") == str(mpi_lib)
    NB.build("plain")
    assert b"libmpi.so" in mpi_lib.read_bytes()
    assert b"libmpi.so" not in plain.read_bytes()


def test_plain_library_keeps_its_name():
    """The plain library's name is the hash it had before the MPI
    variant: its flags and the sources, nothing of MPI."""
    h = hashlib.sha256(" ".join(NB.GXX_FLAGS).encode())
    for p in NB._inputs():
        h.update(str(p.relative_to(NB.NATIVE)).encode())
        h.update(p.read_bytes())
    assert NB.library_path().name == \
        f"librabit_tpu_core-{h.hexdigest()[:12]}.so"
    assert NB.library_path() == NB.library_path("plain")


@pytest.mark.parametrize("variant,want", [
    ("base", "plain"), ("native", "plain"), ("robust", "plain"),
    ("mock", "plain"), ("mpi", "mpi")])
def test_engine_loads_the_mpi_library_only_for_mpi(monkeypatch, variant,
                                                   want):
    asked = []

    def library(v="plain"):
        asked.append(v)
        return str(NB.library_path("plain"))
    NB.build("plain")
    monkeypatch.setattr(port_native, "library", library)
    port_native.NativeEngine(variant=variant)
    assert asked == [want]


def _no_mpi(monkeypatch, tmp_path):
    monkeypatch.delenv(NB.LIB_ENV, raising=False)
    monkeypatch.setattr(NB, "MPI_PREFIXES", (str(tmp_path / "mpi"),))
    monkeypatch.setattr(NB, "MPI_RUNTIME_DIRS", (str(tmp_path / "lib"),))
    monkeypatch.setattr(NB.shutil, "which", lambda name: None)


def test_mpi_without_a_runtime_raises_naming_what_was_searched(
        monkeypatch, tmp_path):
    """No runtime: the build, the engine (by name, and by
    ``rabit_engine`` under ``auto``) and the launcher's check all say so,
    with every path searched; nothing falls back to another engine."""
    _no_mpi(monkeypatch, tmp_path)
    searched = [str(tmp_path / "mpi" / "include" / "mpi.h"),
                str(tmp_path / "lib" / "libmpi.so.40")]
    for call in (lambda: NB.library("mpi"),
                 lambda: rabit_tpu_torch.init([], engine="mpi"),
                 lambda: rabit_tpu_torch.init(["rabit_engine=mpi"])):
        with pytest.raises(RuntimeError, match="no MPI runtime|none was "
                                               "found") as e:
            call()
        for path in searched:
            assert path in str(e.value)
        assert rabit_tpu_torch._engine is None
    ok, why = mpi_launch.have_mpi()
    assert not ok and all(path in why for path in searched)
    # the other engines keep their library
    assert NB.library_path("plain").name.startswith("librabit_tpu_core-")


def test_env_override_wins_for_the_mpi_variant(monkeypatch, tmp_path):
    _no_mpi(monkeypatch, tmp_path)
    monkeypatch.setenv(NB.LIB_ENV, "/elsewhere/libx.so")
    assert NB.library("mpi") == "/elsewhere/libx.so"
    with pytest.raises(ValueError, match="variant"):
        NB.library("openmp")


def _fake_install(prefix: Path, lib: str = "lib") -> None:
    (prefix / "include").mkdir(parents=True)
    (prefix / "include" / "mpi.h").write_text("/* mpi.h */\n")
    (prefix / lib).mkdir()
    (prefix / lib / "libmpi.so").write_bytes(b"")


def test_find_mpi_prefers_a_full_install_with_its_header(monkeypatch,
                                                         tmp_path):
    """A full install (``mpicxx`` on PATH first, then ``MPI_PREFIXES``)
    compiles with the real header and links with an rpath; the bare
    runtime is the last resort. The MPI flags and the runtime's path
    name the library."""
    _no_mpi(monkeypatch, tmp_path)
    (tmp_path / "lib").mkdir()
    (tmp_path / "lib" / "libmpi.so.40").write_bytes(b"")
    rt, _ = NB.find_mpi()
    assert rt.kind == "abi" and rt.flags() == ("-DRT_WITH_MPI",)
    abi_name = NB.library_path("mpi").name

    _fake_install(tmp_path / "mpi")
    rt, _ = NB.find_mpi()
    assert rt == NB.MpiRuntime("header",
                               str(tmp_path / "mpi" / "lib" / "libmpi.so"),
                               str(tmp_path / "mpi" / "include"))
    assert "-DRT_MPI_REAL_HEADER" in rt.flags()
    assert rt.link() == (rt.library,
                         f"-Wl,-rpath,{tmp_path / 'mpi' / 'lib'}")
    header_name = NB.library_path("mpi").name
    assert header_name != abi_name

    tool = tmp_path / "hpcx" / "bin" / "mpicxx"
    _fake_install(tmp_path / "hpcx", lib="lib64")
    tool.parent.mkdir()
    tool.write_text("#!/bin/sh\n")
    tool.chmod(0o755)
    monkeypatch.setattr(NB.shutil, "which",
                        lambda name: str(tool) if name == "mpicxx" else None)
    rt, searched = NB.find_mpi()
    assert rt.library == str(tmp_path / "hpcx" / "lib64" / "libmpi.so")
    assert searched[0] == str(tmp_path / "hpcx" / "include" / "mpi.h")
    assert NB.library_path("mpi").name not in (abi_name, header_name)


def _stand_in_install(prefix: Path, runtime: str) -> None:
    """A full install's layout around the bare runtime: an ``mpi.h``
    that holds the ABI shim's declarations, ``lib/libmpi.so`` linked to
    the runtime."""
    shim = (NB.NATIVE / "src" / "mpi_abi_shim.h").read_text()
    decls = shim.split("#else\n", 1)[1].split("#endif  // RT_MPI_REAL", 1)[0]
    (prefix / "include").mkdir(parents=True)
    (prefix / "include" / "mpi.h").write_text(
        "#ifndef STAND_IN_MPI_H\n#define STAND_IN_MPI_H\n" + decls +
        "#endif\n")
    (prefix / "lib").mkdir()
    (prefix / "lib" / "libmpi.so").symlink_to(runtime)


def test_full_install_branch_builds_links_and_runs(mpi, monkeypatch,
                                                   tmp_path):
    """The full-install branch (``-DRT_MPI_REAL_HEADER``, ``-I``, the
    library by path with an ``-rpath``) compiled, linked and run at
    world 2 against a stand-in prefix: its results equal the bare
    runtime's build bit for bit, and are right against numpy."""
    abi = NB.mpi_runtime()
    if abi.kind != "abi":
        pytest.skip("a full install is the runtime here: the world tests "
                    "run its branch")
    prefix = tmp_path / "mpi"
    _stand_in_install(prefix, abi.library)
    monkeypatch.setattr(NB, "MPI_PREFIXES", (str(prefix),))
    real_which = NB.shutil.which
    monkeypatch.setattr(NB.shutil, "which", lambda name: None if name in (
        "mpicxx", "mpirun") else real_which(name))
    monkeypatch.setattr(NB, "BUILD_DIR", tmp_path / "build")
    rt = NB.mpi_runtime()
    assert rt.kind == "header" and rt.include == str(prefix / "include")
    NB.build("mpi")
    lib = NB.library_path("mpi")
    assert lib.parent == tmp_path / "build"
    assert str(prefix / "lib").encode() in lib.read_bytes()   # the rpath
    header = _world(mpi, 2, "rabit_tpu_torch", tmp_path / "header",
                    MPI_LIBRARY=rt.library, **{NB.LIB_ENV: str(lib)},
                    core=str(lib))
    bare = _world(mpi, 2, "rabit_tpu_torch", tmp_path / "bare")
    _equal(header, bare)
    _right(header, 2, "")


@pytest.mark.parametrize("fault", ["shim does not compile",
                                   "no libopen-rte"])
def test_have_mpi_raises_when_a_runtime_has_no_launcher(monkeypatch,
                                                        tmp_path, fault):
    """With a runtime found and no launchers on PATH, a shim that cannot
    be built is a fault, not a machine without MPI: ``have_mpi`` raises
    (so the world tests fail and phase 25 fails) and never says False."""
    lib = tmp_path / "lib"
    lib.mkdir()
    names = ["libmpi.so.40", "libevent_core.so"]
    if fault == "shim does not compile":
        names.append(mpi_launch.ORTE_SONAME)
    for n in names:
        (lib / n).write_bytes(b"")
    bad = tmp_path / "bad_shim.c"
    bad.write_text("int main(void) { return not_declared; }\n")
    monkeypatch.delenv(NB.LIB_ENV, raising=False)
    monkeypatch.setattr(NB, "MPI_PREFIXES", (str(tmp_path / "mpi"),))
    monkeypatch.setattr(NB, "MPI_RUNTIME_DIRS", (str(lib),))
    monkeypatch.setattr(NB, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(mpi_launch, "SHIMS", {"orted": bad, "mpirun": bad})
    real_which = NB.shutil.which
    monkeypatch.setattr(NB.shutil, "which", lambda name: None if name in (
        "mpicxx", "mpirun", "orted") else real_which(name))
    want = "shim build failed|no C compiler" \
        if fault == "shim does not compile" else "no " + mpi_launch.ORTE_SONAME
    with pytest.raises(RuntimeError, match=want):
        mpi_launch.have_mpi()
    assert not (tmp_path / "build").exists() or \
        not any((tmp_path / "build").iterdir())


def test_scaffold_runs_the_ports_own_launchers(mpi, tmp_path):
    """The launchers are the port's shims under ``build/`` (never
    ``native/build``), copied under an ``OPAL_PREFIX`` with the
    runtime's ``lib`` and ``share``; the environment carries the knobs a
    root container needs."""
    env, mpirun = mpi_launch.scaffold_mpi(str(tmp_path))
    real, orted, shim = mpi_launch.launchers()
    if not shim:
        pytest.skip("launchers on PATH: nothing scaffolded")
    for path in (real, orted):
        assert Path(path).parent == NB.BUILD_DIR and \
            "native/build" not in path
    prefix = tmp_path / "prefix"
    assert env["OPAL_PREFIX"] == str(prefix)
    assert mpirun == str(prefix / "bin" / "mpirun")
    assert (prefix / "bin" / "orted").is_file()
    assert os.readlink(prefix / "lib") == "/usr/lib"
    for key in ("OMPI_ALLOW_RUN_AS_ROOT", "OMPI_ALLOW_RUN_AS_ROOT_CONFIRM",
                "OMPI_MCA_mpi_yield_when_idle"):
        assert env[key] == "1"
    assert env["OMPI_MCA_btl_vader_single_copy_mechanism"] == "none"
    cmd = mpi_launch.mpirun_cmd(mpirun, 3, ["x"])
    assert cmd[:6] == [mpirun, "--oversubscribe", "--bind-to", "none",
                       "-n", "3"] and cmd[-1] == "x"
