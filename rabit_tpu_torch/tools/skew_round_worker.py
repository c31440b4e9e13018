"""Allreduce rounds over a lagging fleet, through ``TorchEngine``: the
port of ``benchmarks/skew_round_worker.py``, run one process a rank under
the port's launcher (``tools/skew_bench.py`` starts it).

One designated rank sleeps ``LAG_MS`` before every round's allreduce --
the persistent arrival straggler of arXiv:1804.05349. Two modes:

* ``--mode bench`` (the JAX worker's): both series in one process on the
  same fabric, first with ``rabit_skew_adapt`` off (every rank pays the
  lag inside the flat schedule), then with it on and a forced digest
  naming the laggard (``RABIT_SKEW_PREAGG_MS`` 0.0001, so the plan is
  pre-aggregation). A round's cost is the fleet MAX of the per-rank
  in-call times; each series' mean excludes ``N_WARMUP`` rounds. Every
  round's result must equal its integer sum.
* ``--mode tracker``: no forced digest. The engine's knobs
  (``rabit_skew_adapt=1``, ``rabit_metrics_port``, ``rabit_telemetry``,
  ...) come on the command line; the tracker's poll loop has to find the
  laggard from the ranks' endpoints and serve its digest, which each
  rank's monitor fetches and the fleet adopts at an agreement boundary.
  Each round's result is checked against its integer sum and its CRC
  against every other rank's (a MAX and a MIN allreduce).

    python -m rabit_tpu_torch.tracker.launch -n 4 python -m \\
        rabit_tpu_torch.tools.skew_round_worker --mode bench \\
        rabit_engine=torch rabit_coordinator=127.0.0.1:29512 \\
        rabit_num_processes=4 [rabit_device=cpu]

env: PAYLOAD (default 2000000 float32 elements), LAG_MS (80), LAG_RANK
(2; p - 1 at world 2 or 3), N_ROUNDS (6), N_WARMUP (2),
RABIT_RESULT_DIR (each rank writes ``rank<r>.json`` there).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import zlib
from pathlib import Path

import numpy as np

import rabit_tpu_torch as rabit
from rabit_tpu_torch import telemetry
from rabit_tpu_torch.telemetry import skew
from rabit_tpu_torch.tools import write_json

_ADAPT_VARS = ("RABIT_SKEW_ADAPT", "RABIT_SKEW_PREAGG_MS",
               "RABIT_SKEW_DIGEST")


def lag_rank_of(world: int) -> int:
    """``LAG_RANK`` (default 2), or p - 1 where the world has no rank 2."""
    lag = int(os.environ.get("LAG_RANK", "2"))
    return lag if lag < world else world - 1


def _set_adapt(enabled: bool, world: int, lag_rank: int,
               lag_ms: float) -> None:
    if enabled:
        os.environ["RABIT_SKEW_ADAPT"] = "1"
        os.environ["RABIT_SKEW_PREAGG_MS"] = "0.0001"
        os.environ["RABIT_SKEW_DIGEST"] = json.dumps(
            {"epoch": 1, "laggard": lag_rank,
             "offsets_ms": {str(i): (lag_ms if i == lag_rank else 0.0)
                            for i in range(world)}})
    else:
        for var in _ADAPT_VARS:
            os.environ.pop(var, None)
    skew.reset_monitor()


def _payload(n: int, rank: int, world: int):
    """This rank's integer-valued f32 payload and the exact sum."""
    base = (np.arange(n) % 251).astype(np.float32)
    return base + rank, base * world + sum(range(world))


def _timed_rounds(xs, want, rank: int, lag_rank: int, lag_s: float,
                  rounds: int, warmup: int) -> tuple:
    """The fleet's round ms (each the MAX of the ranks' in-call times)
    after ``warmup`` rounds, whether every result was exact, and the skew
    plans the timed allreduces ran."""
    times, exact, tags = [], True, set()
    for i in range(warmup + rounds):
        rabit.allreduce(np.zeros(1, np.int32), rabit.SUM)  # align start
        if rank == lag_rank:
            time.sleep(lag_s)
        t0 = time.perf_counter()
        out = rabit.allreduce(xs.copy(), rabit.SUM)
        dt = time.perf_counter() - t0
        exact &= bool(np.array_equal(out, want))
        tags.add(skew.last_applied())
        if i >= warmup:
            times.append(float(rabit.allreduce(
                np.array([dt], np.float64), rabit.MAX)[0]) * 1e3)
    return times, exact, tags


def _bench(rank: int, world: int, payload: int, lag_rank: int,
           lag_ms: float) -> dict:
    rounds = int(os.environ.get("N_ROUNDS", "6"))
    warmup = int(os.environ.get("N_WARMUP", "2"))
    xs, want = _payload(payload, rank, world)
    series = {}
    for name, on in (("flat", False), ("adapted", True)):
        _set_adapt(on, world, lag_rank, lag_ms)
        ms, exact, tags = _timed_rounds(xs, want, rank, lag_rank,
                                        lag_ms / 1e3, rounds, warmup)
        series[name] = {"round_ms": ms, "exact": exact,
                        "applied": sorted(tags, key=str)}
    _set_adapt(False, world, lag_rank, lag_ms)
    return {"rounds": rounds, "warmup": warmup, "series": series,
            "skew_round_ms_flat": float(np.mean(series["flat"]["round_ms"])),
            "skew_round_ms_adapted": float(np.mean(
                series["adapted"]["round_ms"]))}


def _crc_agrees(arr: np.ndarray) -> bool:
    crc = np.array([zlib.crc32(np.ascontiguousarray(arr).tobytes())],
                   np.int64)
    hi = rabit.allreduce(crc.copy(), rabit.MAX)
    lo = rabit.allreduce(crc.copy(), rabit.MIN)
    return int(hi[0]) == int(lo[0]) == int(crc[0])


def _tracker_rounds(rank: int, world: int, payload: int, lag_rank: int,
                    lag_ms: float) -> dict:
    rounds = int(os.environ.get("N_ROUNDS", "40"))
    xs, want = _payload(payload, rank, world)
    exact, agree, tags, epochs = True, True, [], []
    for _ in range(rounds):
        if rank == lag_rank:
            time.sleep(lag_ms / 1e3)
        out = rabit.allreduce(xs.copy(), rabit.SUM)
        applied = skew.monitor().applied()
        tags.append(skew.last_applied())   # the payload's own plan
        epochs.append(None if applied is None else applied["epoch"])
        exact &= bool(np.array_equal(out, want))
        agree &= _crc_agrees(out)
    # a quiet second with every rank at the same count, so that the
    # tracker's last sweeps compare equal counts (and name the laggard
    # by its in-collective time alone)
    rabit.allreduce(np.zeros(1, np.int32), rabit.SUM)
    time.sleep(1.0)
    counts = {}
    for row in telemetry.snapshot()["counters"]:
        if row["name"] in ("dispatch.skew_sync", "dispatch.skew_adapted"):
            counts[row["name"]] = counts.get(row["name"], 0) + row["count"]
    adopted = next((i for i, t in enumerate(tags) if t), None)
    return {"rounds": rounds, "exact": exact, "crc_agree": agree,
            "tags": tags, "epochs": epochs, "adopted_round": adopted,
            "counts": counts}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", choices=("bench", "tracker"), default="bench")
    opts, rest = ap.parse_known_args(argv)
    args = [a for a in rest if "=" in a]
    if not any(a.startswith("rabit_process_id=") for a in args):
        args.append(f"rabit_process_id={os.environ.get('RABIT_TASK_ID', 0)}")
    rabit.init(args, engine="torch")
    rank, world = rabit.get_rank(), rabit.get_world_size()
    payload = int(os.environ.get("PAYLOAD", "2000000"))
    lag_ms = float(os.environ.get("LAG_MS", "80"))
    lag_rank = lag_rank_of(world)
    run = _bench if opts.mode == "bench" else _tracker_rounds
    doc = {"rank": rank, "world": world, "mode": opts.mode,
           "device": str(rabit._engine.device), "payload_elems": payload,
           "dtype": "float32", "lag_rank": lag_rank, "lag_ms": lag_ms}
    doc.update(run(rank, world, payload, lag_rank, lag_ms))
    rabit.finalize()
    out_dir = os.environ.get("RABIT_RESULT_DIR")
    if out_dir:
        write_json(Path(out_dir) / f"rank{rank}.json", doc)
    sys.stdout.write(f"SKEW-ROUNDS-OK rank={rank} world={world}\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
