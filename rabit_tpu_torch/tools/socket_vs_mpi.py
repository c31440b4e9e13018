"""Socket against MPI, head to head: the port of ``tools/socket_vs_mpi.py``
(the reference's ``speed_test.mpi`` role: the same speed test against
the socket engine and against the MPI engine).

The same worker (``tools/speed_worker.py``, ``native/test/speed_test.cc``'s
loop on host tensors) runs against

- the socket engine (``rabit_engine=base``) under the port's launcher
  (``python -m rabit_tpu_torch.tracker.launch``), and
- the MPI engine (``rabit_engine=mpi``, the native core's ``MpiComm``)
  under ``mpirun`` (``tools/mpi_launch.py``: ``--oversubscribe``,
  ``--bind-to none``),

on the grid of the JAX tool: worlds 2 and 4, 10,000 and 1,000,000 floats,
20 repetitions. Each row has both engines' MB/s of ``allreduce.sum``,
``allreduce.max`` and ``broadcast``. Both engines move host memory over
one host, so the numbers compare the two implementations' costs, not a
fabric. Where the machine has no MPI runtime the tool exits 2 and says
what was searched.

    python -m rabit_tpu_torch.tools.socket_vs_mpi [--quick | --smoke]
        [--out DIR]

``--quick`` runs world 2 at 100,000 floats; ``--smoke`` world 2 at 1024
floats and 3 repetitions, and writes nothing. Otherwise the rows go to
``SOCKET_VS_MPI_<ts>.json`` in ``--out``, by default the port's
``build/artifacts/`` (never ``benchmarks/``), with the machine's card
and its power limit where it has one.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from . import ARTIFACTS, card, timestamp, worker_env, write_json
from .mpi_launch import have_mpi, mpirun_cmd, scaffold_mpi

ROOT = Path(__file__).resolve().parents[2]
WORKER = [sys.executable, "-m", "rabit_tpu_torch.tools.speed_worker"]
RUN_TIMEOUT_S = 900
SMOKE_GRID = [(2, 1024, 3)]
QUICK_GRID = [(2, 100000, 20)]
# the reference's speed_runner.py grid: small (latency-bound) and large
# (bandwidth-bound) payloads at worlds 2 and 4
FULL_GRID = [(w, n, 20) for w in (2, 4) for n in (10000, 1000000)]


def parse_speed(stdout: str) -> dict:
    """MB/s of each collective from the speed test's lines."""
    res = {}
    for name, key in (("allreduce.sum", "sum"), ("allreduce.max", "max"),
                      ("broadcast", "bcast")):
        m = re.search(rf"{re.escape(name)}\s+mean\s+([\d.]+)s.*?"
                      rf"([\d.]+) MB/s", stdout)
        if m is None:
            raise RuntimeError(f"no {name} line in the speed test's "
                               f"output:\n{stdout[-2000:]}")
        res[key] = float(m.group(2))
    return res


def _check(what: str, res: subprocess.CompletedProcess) -> dict:
    if res.returncode != 0:
        raise RuntimeError(f"{what} failed (exit {res.returncode}):\n"
                           f"{res.stdout[-1000:]}\n{res.stderr[-2000:]}")
    return parse_speed(res.stdout)


def run_socket(world: int, ndata: int, nrep: int, env: dict) -> dict:
    # the launcher's own timeout above its 300 s default: under a loaded
    # test suite one slow worker must not fail the contract check
    cmd = [sys.executable, "-m", "rabit_tpu_torch.tracker.launch", "-n",
           str(world), "--timeout", "600", *WORKER, f"ndata={ndata}",
           f"nrep={nrep}", "rabit_engine=base"]
    return _check(f"socket world {world}", subprocess.run(
        cmd, capture_output=True, text=True, timeout=RUN_TIMEOUT_S,
        cwd=ROOT, env=env))


def run_mpi(world: int, ndata: int, nrep: int, env: dict,
            mpirun: str) -> dict:
    cmd = mpirun_cmd(mpirun, world, [*WORKER, f"ndata={ndata}",
                                     f"nrep={nrep}", "rabit_engine=mpi"])
    return _check(f"mpi world {world}", subprocess.run(
        cmd, capture_output=True, text=True, timeout=RUN_TIMEOUT_S,
        cwd=ROOT, env=env))


def run(grid: list, emit=print) -> list:
    """Both engines over ``grid`` ((world, ndata, nrep) rows); the rows."""
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        env, mpirun = scaffold_mpi(tmp)
        env.update(worker_env())
        for world, ndata, nrep in grid:
            sock = run_socket(world, ndata, nrep, env)
            mpi = run_mpi(world, ndata, nrep, env, mpirun)
            row = {"world": world, "ndata": ndata, "nrep": nrep,
                   "bytes": ndata * 4, "socket_mbs": sock, "mpi_mbs": mpi}
            rows.append(row)
            emit(json.dumps(row))
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true",
                    help="one configuration: world 2, 100,000 floats")
    ap.add_argument("--smoke", action="store_true",
                    help="the contract check: tiny sizes, no artifact")
    ap.add_argument("--out", type=Path, default=ARTIFACTS)
    args = ap.parse_args(argv)
    ok, why = have_mpi()
    if not ok:
        print(f"socket_vs_mpi: {why}", file=sys.stderr)
        return 2
    print(why, file=sys.stderr)
    grid = SMOKE_GRID if args.smoke else QUICK_GRID if args.quick \
        else FULL_GRID
    rows = run(grid, emit=lambda line: print(line, flush=True))
    if args.smoke:
        print("smoke ok")
        return 0
    dev = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    ts = timestamp()
    path = args.out / f"SOCKET_VS_MPI_{ts}.json"
    write_json(path, {
        "benchmark": "speed_worker: socket engine under the port's "
                     "launcher against the MPI engine under mpirun, one "
                     "host, host tensors",
        "mpi": why, "card": card(dev), "rows": rows, "timestamp_utc": ts})
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
