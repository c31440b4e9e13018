"""Straggler-adaptive allreduce benchmark: flat against skew-adapted round
time over a lagging fleet, the port of ``tools/skew_bench.py``.

Starts ``--world`` ranks of ``tools/skew_round_worker.py --mode bench``
under the port's launcher, ``TorchEngine`` over NCCL one process a card
(or over gloo with ``--device cpu``), with one rank sleeping ``LAG_MS``
before every round, and records the two fleet-mean round times:

- ``skew_round_ms_flat`` -- ``rabit_skew_adapt`` off: every rank pays the
  laggard's delay inside the flat schedule;
- ``skew_round_ms_adapted`` -- the knob on, a forced digest naming the
  laggard: pre-aggregation overlaps the early ranks' reduction with the
  delay.

    python -m rabit_tpu_torch.tools.skew_bench [--world 4]
        [--device cpu] [--smoke] [--out DIR]

The JAX worker's defaults: 2,000,000 f32 a rank, 80 ms of lag on rank 2
(p - 1 at world 2 or 3), 6 rounds after 2 warm-ups. ``--smoke`` shrinks
them (65,536 elements, 20 ms, 3 rounds after 1) and writes nothing; a
full run writes ``SKEW_BENCH_<ts>.json`` into ``--out``, by default the
port's ``build/artifacts/`` (never ``benchmarks/``), with the card's name
and power limit. Without a card and without ``--device cpu`` it exits
non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import socket
import sys
import tempfile
from pathlib import Path
from typing import Optional

import torch

from . import ARTIFACTS, card, device_from_arg, timestamp, worker_env, \
    write_json

SMOKE_ENV = {"PAYLOAD": str(1 << 16), "LAG_MS": "20", "N_ROUNDS": "3",
             "N_WARMUP": "1"}
TIMEOUT_S = 600


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_fleet(world: int, device: torch.device, smoke: bool,
              extra_env: Optional[dict] = None) -> dict:
    """One bench run; returns every rank's document (rank order)."""
    from ..tracker.launch import launch
    if device.type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(f"a world of {world} needs {world} CUDA devices, "
                           f"this machine has {torch.cuda.device_count()}")
    cmd = [sys.executable, "-m", "rabit_tpu_torch.tools.skew_round_worker",
           "--mode", "bench", "rabit_engine=torch",
           f"rabit_coordinator=127.0.0.1:{_free_port()}",
           f"rabit_num_processes={world}", f"rabit_device={device.type}"]
    with tempfile.TemporaryDirectory() as tmp:
        env = dict(worker_env(), RABIT_RESULT_DIR=tmp,
                   **(SMOKE_ENV if smoke else {}), **(extra_env or {}))
        launch(world, cmd, max_attempts=0, timeout=TIMEOUT_S, quiet=True,
               env=env)
        return [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(world)]


def summary(ranks: list) -> dict:
    """The artifact's fields from the ranks' documents (rank 0's series:
    every rank computed the same fleet maxima)."""
    r0 = ranks[0]
    return {"world": r0["world"], "payload_elems": r0["payload_elems"],
            "dtype": r0["dtype"], "lag_rank": r0["lag_rank"],
            "lag_ms": r0["lag_ms"], "rounds": r0["rounds"],
            "warmup": r0["warmup"],
            "skew_round_ms_flat": r0["skew_round_ms_flat"],
            "skew_round_ms_adapted": r0["skew_round_ms_adapted"],
            "round_ms": {k: s["round_ms"] for k, s in r0["series"].items()},
            "applied": r0["series"]["adapted"]["applied"],
            "correct": all(s["exact"] for r in ranks
                           for s in r["series"].values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="flat vs skew-adapted allreduce round bench")
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--device", default=None,
                    help="cuda (default: NCCL, a card a rank) or cpu (gloo)")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes, no artifact")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    device = device_from_arg(args.device)
    result = summary(run_fleet(args.world, device, args.smoke))
    result["card"] = card(torch.device(device.type, 0)
                          if device.type == "cuda" else device)
    print(json.dumps(result), flush=True)
    if not result["correct"]:
        print("skew_bench: an adapted or flat round's result was not its "
              "exact sum", file=sys.stderr)
        return 1
    if args.smoke:
        return 0
    ts = timestamp()
    path = Path(args.out) / f"SKEW_BENCH_{ts}.json"
    write_json(path, {"benchmark": f"allreduce rounds over a lagging "
                                   f"{args.world}-process fleet, flat vs "
                                   f"skew-adapted (pre-aggregation)",
                      "timestamp_utc": ts, **result})
    print(f"wrote {path}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
