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
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
NATIVE = ROOT / "native"
BUILD_DIR = ROOT / "build" / "rabit_tpu_torch" / "native"
GXX_FLAGS = ("-shared", "-fPIC", "-O2", "-std=c++17", "-Wall")
LIB_ENV = "RABIT_TPU_CORE_LIB"
BUILD_TIMEOUT_S = 600


def _inputs():
    for sub in ("src", "include"):
        yield from sorted(p for p in (NATIVE / sub).rglob("*") if p.is_file())


def library_path() -> Path:
    """Where the library of the present sources goes."""
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    for p in _inputs():
        h.update(str(p.relative_to(NATIVE)).encode())
        h.update(p.read_bytes())
    return BUILD_DIR / f"librabit_tpu_core-{h.hexdigest()[:12]}.so"


def build() -> float:
    """Build the library unless it is built; returns the seconds the
    compiler took (0.0 when there was nothing to do). Raises with the
    compiler's output when the build fails."""
    lib = library_path()
    if lib.is_file():
        return 0.0
    gxx = shutil.which("g++") or shutil.which("c++")
    if gxx is None:
        raise RuntimeError("no C++ compiler (g++ or c++) on PATH: the native "
                           "core of rabit_tpu_torch cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    srcs = sorted(str(p) for p in (NATIVE / "src").glob("*.cc"))
    cmd = [gxx, *GXX_FLAGS, "-I", str(NATIVE / "include"), *srcs,
           "-o", str(tmp), "-pthread"]
    t0 = time.perf_counter()
    try:
        res = subprocess.run(cmd, stdout=subprocess.PIPE,
                             stderr=subprocess.STDOUT,
                             timeout=BUILD_TIMEOUT_S)
        if res.returncode != 0:
            raise RuntimeError(
                f"native core build failed (exit {res.returncode}): "
                f"{' '.join(cmd)}\n{res.stdout.decode(errors='replace')}")
        os.replace(tmp, lib)   # atomic: a concurrent loader sees all or none
    finally:
        tmp.unlink(missing_ok=True)
    return time.perf_counter() - t0


def library() -> str:
    """The library to load: ``$RABIT_TPU_CORE_LIB`` if set, else the one
    built from the checkout's sources (built first if needed)."""
    env = os.environ.get(LIB_ENV)
    if env:
        return env
    build()
    return str(library_path())
