"""Launching MPI worlds for the ``mpi`` engine: the port's copy of
``tools/mpi_launch.py::scaffold_mpi``.

Where ``orted`` and ``mpirun`` are on ``PATH`` (a full MPI install) they
are used with the caller's environment. A runtime-only OpenMPI (Debian's
``libmpi.so.40`` without launcher binaries) gets launchers built from
``libopen-rte``'s exported machinery: ``native/test/orted_shim.c`` and
``native/test/mpirun_shim.c``, compiled with ``gcc`` into
``build/rabit_tpu_torch/native/`` and linked as
``native/CMakeLists.txt:118-140`` links them (``libopen-rte.so.40``, and
``libevent_core`` for the mpirun's event loop). OpenMPI finds its
daemons and help files under ``OPAL_PREFIX``, so :func:`scaffold_mpi`
builds a prefix in the caller's directory: ``lib`` and ``share`` linked
to the runtime's, the two launchers in ``bin``.

    env, mpirun = scaffold_mpi(tmpdir)
    subprocess.run(mpirun_cmd(mpirun, 4, [sys.executable, "prog.py",
                                          "rabit_engine=mpi"]), env=env)

:func:`have_mpi` says whether this machine has an MPI runtime at all
and, where it has none, what was searched; where it has one, a launcher
that cannot be built raises.
"""

from __future__ import annotations

import hashlib
import os
import shutil
from pathlib import Path
from typing import Dict, List, Optional, Tuple

from ..engine import _native_build as NB

ORTE_SONAME = "libopen-rte.so.40"
LIBEVENT_NAMES = ("libevent_core.so", "libevent_core-2.1.so.7")
SHIMS = {"orted": NB.NATIVE / "test" / "orted_shim.c",
         "mpirun": NB.NATIVE / "test" / "mpirun_shim.c"}


def _find(names) -> Tuple[Optional[str], List[str]]:
    searched = []
    for d in NB.MPI_RUNTIME_DIRS:
        for n in names:
            path = os.path.join(d, n)
            searched.append(path)
            if os.path.isfile(path):
                return path, searched
    return None, searched


def have_mpi() -> Tuple[bool, str]:
    """(whether this machine has an MPI runtime, a line saying what was
    found or, where nothing was, every path searched). Builds the
    launcher shims where they are needed and not yet built. Where a
    runtime is found, a launcher that cannot be had (no ``libopen-rte``
    to build a shim from, a shim that does not compile) raises: it is a
    fault of the launch, not a machine without MPI."""
    rt, searched = NB.find_mpi()
    if rt is None:
        return False, "no MPI runtime; searched " + ", ".join(searched)
    mpirun, orted, shim = launchers()
    how = "shims built from native/test" if shim else "on PATH"
    return True, (f"MPI runtime {rt.library} ({rt.kind}); mpirun {mpirun}, "
                  f"orted {orted} ({how})")


def _shim_path(name: str, libs: List[str]) -> Path:
    h = hashlib.sha256(SHIMS[name].read_bytes())
    h.update(" ".join(libs).encode())
    return NB.BUILD_DIR / f"{name}-{h.hexdigest()[:12]}"


def build_shim(name: str) -> Path:
    """Build the ``orted`` or ``mpirun`` shim unless it is built; raises
    where ``gcc``, ``libopen-rte`` or (for mpirun) ``libevent_core`` is
    missing, or the compiler fails."""
    orte, searched = _find((ORTE_SONAME,))
    if orte is None:
        raise RuntimeError("no launcher on PATH and no " + ORTE_SONAME +
                           " to build one from; searched " +
                           ", ".join(searched))
    libs = [orte]
    if name == "mpirun":
        event, searched = _find(LIBEVENT_NAMES)
        if event is None:
            raise RuntimeError("no libevent_core for the mpirun shim; "
                               "searched " + ", ".join(searched))
        libs.append(event)
    out = _shim_path(name, libs)
    if out.is_file():
        return out
    gcc = shutil.which("gcc") or shutil.which("cc")
    if gcc is None:
        raise RuntimeError("no C compiler (gcc or cc) for the MPI "
                           "launcher shims")
    NB.compile_into(out, [gcc, "-O2", str(SHIMS[name])], libs,
                    f"{name} shim build")
    return out


def launchers() -> Tuple[str, str, bool]:
    """(mpirun, orted, whether they are the shims): those on ``PATH``
    where both are, else the shims, built first if needed."""
    mpirun, orted = shutil.which("mpirun"), shutil.which("orted")
    if mpirun and orted:
        return mpirun, orted, False
    return str(build_shim("mpirun")), str(build_shim("orted")), True


def scaffold_mpi(scaffold_dir: str) -> Tuple[Dict[str, str], str]:
    """The environment and the mpirun to launch MPI worlds with.

    With launchers on ``PATH`` that mpirun and the caller's environment;
    else the shims under an ``OPAL_PREFIX`` scaffolded in
    ``scaffold_dir``. Callers exec the returned path, never one derived
    from the environment (an ambient ``OPAL_PREFIX`` of a relocated
    install must not redirect the launch)."""
    env = dict(os.environ)
    env.update({
        # the local launch needs no remote agent, but the plm insists on
        # finding one
        "OMPI_MCA_plm_rsh_agent": "/bin/true",
        # containers run as root, which mpirun refuses unless told
        "OMPI_ALLOW_RUN_AS_ROOT": "1",
        "OMPI_ALLOW_RUN_AS_ROOT_CONFIRM": "1",
        # the shared-memory BTL's single copy (CMA) needs CAP_SYS_PTRACE,
        # which containers drop: copy through the shared segment instead
        "OMPI_MCA_btl_vader_single_copy_mechanism": "none",
        # no InfiniBand verbs here: keep the openib BTL from probing and
        # warning
        "OMPI_MCA_btl": "^openib",
        # ranks outnumber cores: keep the busy-poll from starving the
        # other ranks' time slices
        "OMPI_MCA_mpi_yield_when_idle": "1",
    })
    mpirun, orted, shim = launchers()
    if not shim:
        return env, mpirun
    prefix = Path(scaffold_dir) / "prefix"
    (prefix / "bin").mkdir(parents=True, exist_ok=True)
    for d in ("lib", "share"):
        # the runtime's components (lib/<triplet>/openmpi) and help files
        # (share/openmpi), as Debian installs them under /usr
        link = prefix / d
        if not link.exists():
            link.symlink_to(Path("/usr") / d)
    shutil.copy2(orted, prefix / "bin" / "orted")
    shutil.copy2(mpirun, prefix / "bin" / "mpirun")
    env["OPAL_PREFIX"] = str(prefix)
    return env, str(prefix / "bin" / "mpirun")


def mpirun_cmd(mpirun: str, n: int, cmd: List[str]) -> List[str]:
    """``mpirun`` of ``n`` ranks of ``cmd`` on this host:
    ``--oversubscribe`` (ranks may outnumber cores) and ``--bind-to
    none`` (ranks that share a card, or a core, must not be pinned)."""
    return [mpirun, "--oversubscribe", "--bind-to", "none", "-n", str(n),
            *cmd]
