"""Build the native core for the port's ctypes binding.

The native core is the C++ host control plane under both packages: the
socket engines, the robust engine's consensus, result replay and
checkpoint recovery, and the tracker client (``native/src``, with the C
interface of ``native/include/rabit_tpu_c.h``). The port compiles it from
the sources with one compiler call:

    g++ -shared -fPIC -O2 -std=c++17 -Wall -I native/include \\
        native/src/*.cc -o build/rabit_tpu_torch/native/\\
        librabit_tpu_core-<hash>.so -pthread

The name carries a hash of every file under ``native/src`` and
``native/include`` and of the flags, so edited sources build anew and
unchanged ones are reused. The build happens at first use. Several
processes may build at once: each compiles into a temporary name of its
own and renames it into place. ``RABIT_TPU_CORE_LIB`` names a library to
load in place of building one.

The MPI variant (``rabit_engine=mpi``, ``native/src/engine_mpi.h``) is a
second library, ``librabit_tpu_core_mpi-<hash>.so``, loaded only by the
``mpi`` engine: every other engine keeps the plain library above, with
or without MPI on the machine. It compiles the same sources with
``-DRT_WITH_MPI`` and links the MPI runtime that :func:`find_mpi` finds,
as ``native/CMakeLists.txt:74-112`` does for the JAX package's build:

- a full install (``mpicxx`` or ``mpirun`` on ``PATH``, or
  ``/usr/local/mpi``, as CUDA images ship it) with ``include/mpi.h``:
  ``-DRT_MPI_REAL_HEADER -I<prefix>/include``, linked with an ``-rpath``
  to its ``libmpi.so``;
- else the bare OpenMPI 4 runtime ``libmpi.so.40`` (no headers), whose
  ABI ``native/src/mpi_abi_shim.h`` declares.

The full-install branch has never been built against a real install's
``mpi.h``: no machine this was tried on has one. Its flags, ``-I``,
link and ``-rpath`` are compiled, linked and run only against a
stand-in prefix (``tests/test_torch_mpi_engine.py``: an ``mpi.h`` that
holds the ABI shim's declarations, ``libmpi.so`` linked to the bare
runtime).

The hash of its name also covers the MPI flags and the runtime's path.
Asking for it where no runtime is found raises, naming what was searched.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from pathlib import Path
from typing import List, Optional, Tuple

ROOT = Path(__file__).resolve().parents[2]
NATIVE = ROOT / "native"
BUILD_DIR = ROOT / "build" / "rabit_tpu_torch" / "native"
GXX_FLAGS = ("-shared", "-fPIC", "-O2", "-std=c++17", "-Wall")
LIB_ENV = "RABIT_TPU_CORE_LIB"
BUILD_TIMEOUT_S = 600
VARIANTS = ("plain", "mpi")

# where a full MPI install lives when no launcher is on PATH (NGC-style
# CUDA images), and where Debian puts the bare OpenMPI runtime
MPI_PREFIXES = ("/usr/local/mpi",)
MPI_RUNTIME_DIRS = ("/usr/lib/x86_64-linux-gnu", "/lib/x86_64-linux-gnu")
MPI_RUNTIME_SONAME = "libmpi.so.40"
_MPI_HEADER_DIRS = ("include", "include/openmpi")
_MPI_LIB_DIRS = ("lib", "lib64", "lib/x86_64-linux-gnu")


@dataclass(frozen=True)
class MpiRuntime:
    """An MPI runtime to build the ``mpi`` variant against: ``header``
    (a full install: ``include`` holds ``mpi.h``) or ``abi`` (the bare
    OpenMPI 4 runtime, declared by ``native/src/mpi_abi_shim.h``)."""
    kind: str
    library: str
    include: Optional[str] = None

    def flags(self) -> Tuple[str, ...]:
        """Compile flags of the variant; the library and its ``-rpath``
        follow the sources on the command line."""
        if self.kind == "header":
            # C only: OpenMPI's and MPICH's mpi.h pull in their C++
            # bindings otherwise, which need a library more
            return ("-DRT_WITH_MPI", "-DRT_MPI_REAL_HEADER",
                    "-DOMPI_SKIP_MPICXX", "-DMPICH_SKIP_MPICXX",
                    "-I", self.include)
        return ("-DRT_WITH_MPI",)

    def link(self) -> Tuple[str, ...]:
        return (self.library,
                f"-Wl,-rpath,{os.path.dirname(self.library)}")


def _mpi_prefixes() -> List[str]:
    found = []
    for tool in ("mpicxx", "mpirun"):
        path = shutil.which(tool)
        if path:
            found.append(str(Path(path).resolve().parent.parent))
    found.extend(MPI_PREFIXES)
    return list(dict.fromkeys(found))


def find_mpi() -> Tuple[Optional[MpiRuntime], List[str]]:
    """The MPI runtime of this machine, or None, and the paths searched:
    each full-install prefix (from ``mpicxx``/``mpirun`` on ``PATH``,
    then ``MPI_PREFIXES``) for ``mpi.h`` and ``libmpi.so``, then
    ``MPI_RUNTIME_DIRS`` for the bare ``libmpi.so.40``. The full install
    comes first, though that branch has been built only against a
    stand-in prefix, never a real install's header (module docstring)."""
    searched = []
    for prefix in _mpi_prefixes():
        for inc in _MPI_HEADER_DIRS:
            header = os.path.join(prefix, inc, "mpi.h")
            searched.append(header)
            if not os.path.isfile(header):
                continue
            for lib in _MPI_LIB_DIRS:
                path = os.path.join(prefix, lib, "libmpi.so")
                searched.append(path)
                if os.path.isfile(path):
                    return MpiRuntime("header", path,
                                      os.path.dirname(header)), searched
    for d in MPI_RUNTIME_DIRS:
        path = os.path.join(d, MPI_RUNTIME_SONAME)
        searched.append(path)
        if os.path.isfile(path):
            return MpiRuntime("abi", path), searched
    return None, searched


def mpi_runtime() -> MpiRuntime:
    """:func:`find_mpi`'s runtime; raises where there is none."""
    rt, searched = find_mpi()
    if rt is None:
        raise RuntimeError(
            "rabit_engine=mpi needs an MPI runtime and none was found; "
            "searched: " + ", ".join(searched))
    return rt


def _check_variant(variant: str) -> None:
    if variant not in VARIANTS:
        raise ValueError(f"unknown native core variant {variant!r} "
                         f"(one of {VARIANTS})")


def _inputs():
    for sub in ("src", "include"):
        yield from sorted(p for p in (NATIVE / sub).rglob("*") if p.is_file())


def _flags(variant: str) -> Tuple[Tuple[str, ...], Tuple[str, ...]]:
    """(compile flags, link arguments) of ``variant``."""
    if variant == "plain":
        return GXX_FLAGS, ()
    rt = mpi_runtime()
    return GXX_FLAGS + rt.flags(), rt.link()


def library_path(variant: str = "plain") -> Path:
    """Where the library of the present sources goes."""
    _check_variant(variant)
    flags, link = _flags(variant)
    h = hashlib.sha256(" ".join(flags + link).encode())
    for p in _inputs():
        h.update(str(p.relative_to(NATIVE)).encode())
        h.update(p.read_bytes())
    stem = "librabit_tpu_core" if variant == "plain" \
        else f"librabit_tpu_core_{variant}"
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:12]}.so"


def build(variant: str = "plain") -> float:
    """Build the library of ``variant`` unless it is built; returns the
    seconds the compiler took (0.0 when there was nothing to do). Raises
    with the compiler's output when the build fails, and for ``mpi``
    where the machine has no MPI runtime."""
    lib = library_path(variant)
    if lib.is_file():
        return 0.0
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the native "
                           "core of rabit_tpu_torch cannot be built")
    flags, link = _flags(variant)
    srcs = sorted(str(p) for p in (NATIVE / "src").glob("*.cc"))
    return compile_into(lib, [gxx, *flags, "-I", str(NATIVE / "include"),
                              *srcs], ["-pthread", *link],
                        "native core build")


def compile_into(out: Path, cmd: List[str], tail: List[str],
                 what: str) -> float:
    """Run the compiler ``cmd + ["-o", <tmp>] + tail`` and rename its
    output into ``out``; returns its seconds. Each process compiles into
    a temporary name of its own, so a concurrent build never sees half a
    file. Raises with the compiler's output when it fails."""
    out.parent.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    full = [*cmd, "-o", str(tmp), *tail]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(full, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT,
                             timeout=BUILD_TIMEOUT_S)
        if res.returncode != 0:
            raise RuntimeError(
                f"{what} failed (exit {res.returncode}): {' '.join(full)}\n"
                f"{res.stdout.decode(errors='replace')}")
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    finally:
        tmp.unlink(missing_ok=True)
    return time.perf_counter() - t0


def library(variant: str = "plain") -> str:
    """The library to load: ``$RABIT_TPU_CORE_LIB`` if set, else the one
    of ``variant`` built from the checkout's sources (built first if
    needed)."""
    _check_variant(variant)
    env = os.environ.get(LIB_ENV)
    if env:
        return env
    build(variant)
    return str(library_path(variant))
