"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Every ``csrc/<name>.cu`` compiles on its own into a shared library with a
plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/rabit_tpu_torch/lib<name>-<hash>.so \\
         rabit_tpu_torch/csrc/<name>.cu

The library lands in ``build/rabit_tpu_torch/`` beside the package, named
by a hash of its source, the shared headers ``csrc/*.cuh`` and the flags,
so an edited source builds anew and an unchanged one is reused. Builds
happen at first use; ``build()`` starts one nvcc per source, all at once,
and waits for them together. nvcc's output, with ptxas's registers and
spills of every kernel (``-Xptxas -v``), is kept beside the library
(``ptxas_log``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Callable, Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "rabit_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
BUILD_TIMEOUT_S = 600

_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> its ``.cu`` source."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def nvcc() -> str:
    """Path of nvcc: on PATH, under ``$CUDA_HOME``, or the toolkit's usual
    place. Raises when there is none (as on a machine without CUDA)."""
    found = shutil.which("nvcc")
    if found:
        return found
    for home in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if home and os.access(os.path.join(home, "bin", "nvcc"), os.X_OK):
            return os.path.join(home, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): the "
        "CUDA kernels of rabit_tpu_torch build only where the CUDA toolkit "
        "is installed")


def library_path(name: str) -> Path:
    """The library's path, named by a hash of its source, the shared
    headers (``csrc/*.cuh``) and the flags."""
    h = hashlib.sha256(sources()[name].read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def ptxas_log(name: str) -> Path:
    """nvcc's output of the library's build: ptxas's registers, spills and
    stack of each kernel."""
    return library_path(name).with_suffix(".ptxas.txt")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Build the named kernels (all by default) that are not built yet,
    one nvcc each, all started together. Returns seconds per kernel built;
    raises with nvcc's output if any build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    unknown = [n for n in names if n not in srcs]
    if unknown:
        raise KeyError(f"no kernel source for {unknown} in {CSRC}")
    todo = [n for n in names if not library_path(n).is_file()]
    if not todo:
        return {}
    compiler = nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    t0 = time.perf_counter()
    for n in todo:
        tmp = library_path(n).with_suffix(f".{os.getpid()}.tmp")
        cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), str(srcs[n])]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    seconds, failed = {}, []
    try:
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate(timeout=BUILD_TIMEOUT_S)
            seconds[n] = time.perf_counter() - t0
            if proc.returncode != 0:
                failed.append(f"{n}: nvcc exit {proc.returncode}\n"
                              f"{out.decode(errors='replace')}")
            else:
                ptxas_log(n).write_bytes(out)
                os.replace(tmp, library_path(n))  # atomic: no torn library
    finally:
        for tmp, proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            tmp.unlink(missing_ok=True)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel library ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = _loaded[name] = ctypes.CDLL(str(library_path(name)))
        lib.rabit_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rabit_cuda_error_string.restype = ctypes.c_char_p
    return lib


def entry(name: str, symbol: str, argtypes: List) -> Callable[..., int]:
    """The C entry point ``symbol`` of the kernel library ``name`` with
    its argument types set (``c_void_p`` for a pointer or stream, else
    ctypes cuts it to 32 bits); it returns a cudaError_t."""
    fn = getattr(load(name), symbol)
    if not fn.argtypes:
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return fn


def check(err: int, name: str) -> None:
    """Raises if a launch of the library ``name`` returned a CUDA error: a
    refused launch never runs, and no synchronise reports it."""
    if err != 0:
        msg = _loaded[name].rabit_cuda_error_string(err).decode()
        raise RuntimeError(f"{name} kernel launch failed: cuda error {err} "
                           f"({msg})")
