"""The watchdog's host cost on ``TorchEngine.allreduce`` of the 8 KB
histogram payload (2048 f32), for several checkouts in turns, over NCCL
at world 2 (one card a rank).

    python3 guard_cost.py DIR [DIR ...] [--calls 2000] [--rounds 2]
        [--device cpu]

Each DIR is the root of a checkout of this repository (a parent commit
unpacked with ``git archive`` under ``build/``, which git ignores, and
``.``). In each round every DIR runs in the order A B ... B A, each in a
fresh world of two processes that import that DIR's ``rabit_tpu_torch``
and meet through ``rabit_coordinator``. Each process times ``--calls``
allreduces of 2048 f32 zeros (SUM, so the payload stays the same),
host-paced (the wall clock over the loop: every call ends with the
result copied back to the host), after 200 calls of warm-up. A checkout
whose engine has a watchdog times it in four turns within the process:
the disabled watchdog's ``NULL_GUARD``, an armed guard (a 60 s deadline,
far above any call, ``rabit_watchdog_abort=0``), armed, null; one
without runs the plain call four times. A JSON line per (DIR, round)
gives the slowest rank's µs a call in each turn; the last lines the
median per DIR and setting over all rounds, with the card's name and
power limit. Host-side time moves with the load on the host, so versions
are compared only within one run. It needs two cards (``--device cpu``:
gloo on the CPU), and exits non-zero without them.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time
from pathlib import Path

N_ELEMS = 2048   # the 8 KB histogram payload
WARMUP = 200


def child(root: str, rank: int, port: int, calls: int, device: str) -> None:
    sys.path.insert(0, root)
    import numpy as np
    import rabit_tpu_torch
    if not Path(rabit_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {rabit_tpu_torch.__file__}, not the "
                           f"checkout {root}")
    from rabit_tpu_torch.engine.torch_engine import TorchEngine
    from rabit_tpu_torch.ops.reducers import MAX, SUM
    e = TorchEngine()
    e.init([f"rabit_device={device}", f"rabit_coordinator=127.0.0.1:{port}",
            "rabit_num_processes=2", f"rabit_process_id={rank}"])
    buf = np.zeros(N_ELEMS, np.float32)
    if hasattr(e, "_watchdog"):
        from rabit_tpu_torch.utils.watchdog import Watchdog
        null, armed = Watchdog(), Watchdog(floor_ms=60000, abort=False)
        turns = [("null", null), ("armed", armed), ("armed", armed),
                 ("null", null)]
    else:
        turns = [("plain", None)] * 4
    for _ in range(WARMUP):
        e.allreduce(buf, SUM)
    out = []
    for name, wd in turns:
        if wd is not None:
            e._watchdog = wd
        word = np.zeros(1, np.int32)
        e.allreduce(word, SUM)   # align the ranks' starts
        t0 = time.perf_counter()
        for _ in range(calls):
            e.allreduce(buf, SUM)
        us = np.array([(time.perf_counter() - t0) / calls * 1e6])
        e.allreduce(us, MAX)
        out.append([name, float(us[0])])
    assert not buf.any()
    e.shutdown()
    if rank == 0:
        print(json.dumps({"root": root, "turns": out}), flush=True)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(root: str, calls: int, device: str) -> dict:
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=root)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--child", root,
         str(r), str(port), str(calls), device], env=env,
        stdout=subprocess.PIPE, text=True) for r in range(2)]
    outs = [p.communicate(timeout=600)[0] for p in procs]
    for r, p in enumerate(procs):
        if p.returncode != 0:
            raise RuntimeError(f"{root} rank {r} exited {p.returncode}")
    return json.loads(outs[0].strip().splitlines()[-1])


def card_power() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="+")
    ap.add_argument("--calls", type=int, default=2000)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.device == "cuda":
        import torch
        if torch.cuda.device_count() < 2:
            print("guard_cost: needs two CUDA devices", file=sys.stderr)
            return 1
        power = card_power()
    else:
        power = "cpu"
    roots = [str(Path(d).resolve()) for d in args.dirs]
    order = roots + roots[::-1]
    by = {}
    for rnd in range(args.rounds):
        for root in order:
            doc = run_world(root, args.calls, args.device)
            print(json.dumps({"round": rnd, **doc}), flush=True)
            for name, us in doc["turns"]:
                by.setdefault((root, name), []).append(us)
    for (root, name), xs in by.items():
        print(f"{root} {name}: median {statistics.median(xs):.3f} us a "
              f"call over {len(xs)} turns of {args.calls} "
              f"({', '.join(f'{x:.3f}' for x in xs)}) [{power}]",
              flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) > 1 and sys.argv[1] == "--child":
        child(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
              int(sys.argv[5]), sys.argv[6])
    else:
        sys.exit(main())
