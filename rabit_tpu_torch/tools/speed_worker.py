"""Collective speed worker: ``native/test/speed_test.cc``'s loop through
the port's engine, for ``tools/socket_vs_mpi.py``.

Each of ``nrep`` repetitions fills a host f32 tensor of ``ndata``
elements with ``rank + r + i % 17`` and allreduces it (SUM), fills it
with ``rank * (r + 1)`` and allreduces it (MAX), then broadcasts its
bytes from rank ``r % world``; each call is timed on the host clock.
The per-rank sums, minima and maxima of those times are reduced over the
world through the same engine, and rank 0 prints the C++ harness's lines
(``name mean ...s  min ...s  max ...s  ... MB/s``), so that one parser
reads both. Every result is checked against its formula. The engine is
the one ``rabit_engine`` names (``base`` under the port's launcher,
``mpi`` under ``mpirun``); the calls go to the engine in place, as
``rabit::Allreduce`` and ``rabit::Broadcast`` work on the caller's
buffer.

    python -m rabit_tpu_torch.tracker.launch -n 4 python -m \\
        rabit_tpu_torch.tools.speed_worker ndata=100000 nrep=20 \\
        rabit_engine=base
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

import rabit_tpu_torch as rabit
from rabit_tpu_torch.utils.config import Config


def report(name: str, times: list, nrep: int, nbytes: int) -> None:
    """Rank 0 prints the world's mean, min and max seconds a call and the
    MB/s of the mean (``speed_test.cc::Report``)."""
    eng = rabit._engine
    stats = np.array([sum(times)])
    eng.allreduce(stats, rabit.SUM)
    lo, hi = np.array([min(times)]), np.array([-max(times)])
    eng.allreduce(lo, rabit.MIN)
    eng.allreduce(hi, rabit.MIN)
    if eng.rank == 0:
        mean = stats[0] / (nrep * eng.world_size)
        print(f"{name:<12} mean {mean:.6f}s  min {lo[0]:.6f}s  max "
              f"{-hi[0]:.6f}s  {nbytes / mean / 1e6:.1f} MB/s", flush=True)


def main(argv=None) -> None:
    argv = sys.argv[1:] if argv is None else argv
    cfg = Config.from_args([a for a in argv if "=" in a])
    ndata = int(cfg.get("ndata", "100000"))
    nrep = int(cfg.get("nrep", "20"))
    rabit.init([a for a in argv if "=" in a])
    eng = rabit._engine
    rank, world = eng.rank, eng.world_size
    nbytes = ndata * 4
    buf = torch.empty(ndata, dtype=torch.float32)
    view = buf.numpy()
    mod17 = torch.arange(ndata, dtype=torch.float32) % 17
    ranks = torch.arange(world, dtype=torch.float32)
    t_sum, t_max, t_bcast = [], [], []
    for r in range(nrep):
        torch.add(mod17, float(rank + r), out=buf)
        t0 = time.perf_counter()
        eng.allreduce(view, rabit.SUM)
        t_sum.append(time.perf_counter() - t0)
        want = mod17 * world + float((ranks + r).sum())
        if not torch.equal(buf, want):
            raise AssertionError(f"allreduce SUM wrong at rep {r}")

        buf.fill_(float(rank * (r + 1)))
        t0 = time.perf_counter()
        eng.allreduce(view, rabit.MAX)
        t_max.append(time.perf_counter() - t0)
        if not bool((buf == float((world - 1) * (r + 1))).all()):
            raise AssertionError(f"allreduce MAX wrong at rep {r}")

        root = r % world
        buf.fill_(float(root + 1000 * r) if rank == root else -1.0)
        payload = view.tobytes() if rank == root else None
        t0 = time.perf_counter()
        got = eng.broadcast(payload, root)
        t_bcast.append(time.perf_counter() - t0)
        view[:] = np.frombuffer(got, np.float32)
        if not bool((buf == float(root + 1000 * r)).all()):
            raise AssertionError(f"broadcast wrong at rep {r}")
    if rank == 0:
        print(f"== speed_test: {ndata} floats ({nbytes} bytes) x {nrep} "
              f"reps, world={world} ==", flush=True)
    report("allreduce.sum", t_sum, nrep, nbytes)
    report("allreduce.max", t_max, nrep, nbytes)
    report("broadcast", t_bcast, nrep, nbytes)
    rabit.finalize()


if __name__ == "__main__":
    main()
