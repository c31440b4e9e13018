"""Timing worker of ``tools/wire_bench.py``'s host phase: the port of
``tests/workers/wire_bench_worker.py``.

K float-SUM allreduces of an n-element payload (``WIRE_BENCH_N``,
``WIRE_BENCH_K``) through the robust engine's torch data plane, with the
wire ``rabit_dataplane_wire`` names (none, bf16 or int8). Every rank sends
the same ``linspace(-1, 1, n)``, so the sum is ``world`` times it: the
result is checked against it (within the wire's tolerance) after a warm
call and after the timed ones, so a broken wire cannot win the timing.
Rank 0 writes ``wire.json`` into ``RABIT_RESULT_DIR`` (the mode, world, n,
k, seconds an allreduce and the wire the data plane applied) and prints
it after ``WIREBENCH``.

    python -m rabit_tpu_torch.tracker.launch -n 4 python -m \\
        rabit_tpu_torch.tools.wire_bench_worker rabit_engine=robust_torch \\
        rabit_device=cpu rabit_dataplane_minbytes=0 rabit_dataplane_wire=int8
"""

from __future__ import annotations

import json
import os
import sys
import time
from pathlib import Path

import numpy as np

import rabit_tpu_torch as rabit
from rabit_tpu_torch.parallel import dispatch
from rabit_tpu_torch.tools import write_json
from rabit_tpu_torch.utils.config import Config

RTOL = {"bf16": 2e-2, "int8": 5e-2}


def main() -> None:
    args = [a for a in sys.argv[1:] if "=" in a]
    rabit.init(args)
    rank, world = rabit.get_rank(), rabit.get_world_size()
    wire = Config.from_args(args).get("rabit_dataplane_wire") or "none"
    n = int(os.environ.get("WIRE_BENCH_N", "65536"))
    k = int(os.environ.get("WIRE_BENCH_K", "10"))
    base = np.linspace(-1.0, 1.0, n).astype(np.float32)
    want = base * world
    rtol = RTOL.get(wire, 1e-5)

    out = rabit.allreduce(base.copy(), rabit.SUM)   # warm
    np.testing.assert_allclose(out, want, rtol=rtol, atol=rtol * world)
    t0 = time.perf_counter()
    for _ in range(k):
        out = rabit.allreduce(base.copy(), rabit.SUM)
    elapsed = time.perf_counter() - t0
    np.testing.assert_allclose(out, want, rtol=rtol, atol=rtol * world)
    doc = {"wire": wire, "world": world, "n": n, "k": k,
           "s_per_op": elapsed / k,
           "wire_applied": dispatch.last_wire() or "off"}
    rabit.finalize()
    if rank == 0:
        write_json(Path(os.environ["RABIT_RESULT_DIR"]) / "wire.json", doc)
        print("WIREBENCH " + json.dumps(doc), flush=True)


if __name__ == "__main__":
    main()
