"""Stall scenarios for the port's watchdog: one rank of a healthy world
stalls and the others' guards climb the escalation ladder. The stall
lives here, in the test worker, never in the package.

    python tests/workers/torch_stall_worker.py MODE key=value...

MODE:
  engine     ``TorchEngine`` (the key=value args name the world:
             ``rabit_coordinator``, ``rabit_num_processes``,
             ``rabit_process_id``); ``N_OPS`` allreduces of exact integer
             payloads; rank ``STALL_RANK`` sleeps ``STALL_S`` before op
             ``STALL_AT`` (with ``ASYNC=1`` every rank issues that op as
             ``allreduce_async`` and the guard rides it in flight).
  stop       as ``engine``, but rank ``STALL_RANK`` stops itself with
             SIGSTOP before op ``STALL_AT``; the survivors' abort rung ends
             them (exit 86). The stopped rank is killed by the caller.
  robust     the robust engine with the torch data plane (under the port's
             launcher): rank ``STALL_RANK``'s data plane sleeps ``STALL_S``
             inside its ``STALL_AT``-th collective, the survivors block in
             theirs. With ``STALL_S=0`` the same stream runs clean.
  bootstrap  init only: the tracker never completes the assignment.

env: STALL_RANK (1), STALL_S (3.0), STALL_AT (2), N_OPS (5), N_ELEMS
(4096), ASYNC (0), RABIT_RESULT_DIR (each rank writes ``rank<r>.json``
there: its results' CRCs, whether every sum was exact, the telemetry
counters, the fleet events, the flight notes and the wall-clock times of
the stalled op).
"""

import json
import os
import signal
import sys
import time
import zlib

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import rabit_tpu_torch as rabit  # noqa: E402
from rabit_tpu_torch import telemetry  # noqa: E402
from rabit_tpu_torch.telemetry import events, flight  # noqa: E402

STALL_RANK = int(os.environ.get("STALL_RANK", "1"))
STALL_S = float(os.environ.get("STALL_S", "3.0"))
STALL_AT = int(os.environ.get("STALL_AT", "2"))
N_OPS = int(os.environ.get("N_OPS", "5"))
N_ELEMS = int(os.environ.get("N_ELEMS", "4096"))
ASYNC = os.environ.get("ASYNC", "0") == "1"
# this rank's report so far (every report rewrites the whole file)
STATE = {}


def payload(rank: int, i: int) -> np.ndarray:
    return (np.arange(N_ELEMS) % 1000).astype(np.float32) + rank + i


def want(world: int, i: int) -> np.ndarray:
    return ((np.arange(N_ELEMS) % 1000).astype(np.float64) * world
            + world * (world - 1) / 2 + world * i).astype(np.float32)


def report(rank: int, doc: dict) -> None:
    out = os.environ.get("RABIT_RESULT_DIR")
    if not out:
        return
    STATE.update(doc)
    doc = STATE
    snap = telemetry.snapshot()
    doc.update(
        counters={f"{c['name']}|{c.get('op', '')}": c["count"]
                  for c in snap["counters"]},
        events=[e["kind"] for e in events.snapshot()["records"]],
        notes=flight.recent_events(), pid=os.getpid())
    path = os.path.join(out, f"rank{rank}.json")
    with open(path + ".tmp", "w") as f:
        json.dump(doc, f)
    os.replace(path + ".tmp", path)


def run_ops(mode: str) -> None:
    rank, world = rabit.get_rank(), rabit.get_world_size()
    crcs, exact, t_call, t_done = [], True, None, None
    for i in range(N_OPS):
        buf = payload(rank, i)
        if i == STALL_AT and rank == STALL_RANK and mode != "robust":
            t_call = time.time()
            report(rank, {"rank": rank, "t_stall": t_call})
            if mode == "stop":
                os.kill(os.getpid(), signal.SIGSTOP)
            elif mode == "engine":
                time.sleep(STALL_S)
        elif i == STALL_AT:
            t_call = time.time()
        if i == STALL_AT and ASYNC:
            out = rabit.allreduce_async(buf, rabit.SUM).wait()
        else:
            out = rabit.allreduce(buf, rabit.SUM)
        if i == STALL_AT:
            t_done = time.time()
        exact &= bool(np.array_equal(out, want(world, i)))
        crcs.append(zlib.crc32(out.tobytes()))
    eng = rabit._engine  # test-only peek at the active engine
    doc = {"rank": rank, "world": world, "exact": exact, "crcs": crcs,
           "t_call": t_call, "t_done": t_done,
           "expired_total": eng._watchdog.expired_total}
    dp = getattr(eng, "dataplane", None)
    if dp is not None:
        doc.update(epoch=eng.world_epoch, formations=dp.formations,
                   backend=dp.backend)
    report(rank, doc)


def stall_dataplane(engine) -> None:
    """Rank ``STALL_RANK``'s data plane sleeps inside its ``STALL_AT``-th
    collective (once), before the torch collective runs."""
    dp = engine.dataplane
    inner, calls = dp._allreduce, [0]

    def stalled(buf, op):
        calls[0] += 1
        if calls[0] == STALL_AT + 1:
            report(engine.rank, {"rank": engine.rank, "t_stall": time.time()})
            time.sleep(STALL_S)
        return inner(buf, op)

    dp._allreduce = stalled


def main() -> None:
    mode, args = sys.argv[1], sys.argv[2:]
    if mode == "bootstrap":
        rabit.init(args, engine="robust_torch")
        raise SystemExit("bootstrap completed: the tracker was expected "
                         "to hang it")
    if mode == "robust":
        rabit.init(args, engine="robust_torch")
        if STALL_S > 0 and rabit.get_rank() == STALL_RANK:
            stall_dataplane(rabit._engine)
    else:
        rabit.init(["rabit_engine=torch", *args])
    try:
        run_ops(mode)
    finally:
        rabit.finalize()


if __name__ == "__main__":
    main()
