"""A gradient-boosting round end to end: the port of
``tools/boosted_bench.py``.

Phase A: 8 workers (``tools/boosted_round_worker.py``) under the port's
launcher run boosting rounds on the host: each round a host histogram
build of rows x F contributions and the socket allreduce of the result
(the robust engine), timed as the world's MAX a phase.

Phase B: the same per-worker workload (``contributions_per_worker`` ids
into ``nbins`` bins; 2^21 x 1024 at the defaults) built on one card by
``ops.histogram.histogram`` (the CUDA kernel ``csrc/histogram.cu``), in a
loop over 16 staged inputs made on the card from a seeded
``torch.Generator`` (``tools.gen_pool``), slope-timed between K = 16 and
128 (``utils/slope.py``: CUDA events behind a sleep, the host-paced
slope beside it). ``card_kernel_ms_per_round`` is the kernel's slope,
``card_round_ms`` that plus phase A's measured allreduce (the round a
worker pays once its build is on the card), ``speedup_vs_host_round``
phase A's round over it; ``launches`` counts the kernel's launches in
phase B.

    python -m rabit_tpu_torch.tools.boosted_bench [--device cpu --smoke]
        [--out DIR]

``--smoke`` runs phase A at 4096 rows and 3 rounds and phase B at that
size with K 2 and 4 (on the CPU, the kernel's plain version), and writes
nothing. Phase B at full size needs a card: without one the tool exits
non-zero and prints no result. A full run writes
``BOOSTED_BENCH_<ts>.json`` into ``--out``, by default the port's
``build/artifacts/`` (never ``benchmarks/``), with the card's name and
power limit. Each phase prints a JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

import torch

from . import ARTIFACTS, card, device_from_arg, gen_pool, timestamp, \
    worker_env, write_json
from ..utils import slope

ROOT = Path(__file__).resolve().parents[2]
WORKERS = 8
SMOKE_ENV = {"ROWS": str(1 << 12), "N_ROUNDS": "3"}
STAGES = 16                      # staged inputs, cycled by the loop
K_FULL, K_SMOKE = (16, 128), (2, 4)
SEED = 7
RUN_TIMEOUT_S = 900


def phase_a(smoke: bool) -> dict:
    """The host round at world ``WORKERS``: rank 0's document."""
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, **worker_env(), RABIT_RESULT_DIR=out)
        if smoke:
            env.update(SMOKE_ENV)
        res = subprocess.run(
            [sys.executable, "-m", "rabit_tpu_torch.tracker.launch", "-n",
             str(WORKERS), sys.executable, "-m",
             "rabit_tpu_torch.tools.boosted_round_worker"],
            capture_output=True, text=True, timeout=RUN_TIMEOUT_S, env=env,
            cwd=ROOT)
        if res.returncode != 0:
            raise RuntimeError(f"phase A failed (exit {res.returncode}):\n"
                               f"{res.stdout[-2000:]}\n{res.stderr[-2000:]}")
        return json.loads((Path(out) / "boosted.json").read_text())


def phase_b(host: dict, device: torch.device, smoke: bool) -> dict:
    """The same per-worker build on ``device`` (see the module's doc).
    Raises unless ``device`` is a card, except in smoke."""
    from ..ops import histogram as K
    if device.type != "cuda" and not smoke:
        raise RuntimeError(f"phase B needs a CUDA device, got {device}; "
                           f"only --smoke runs it on the CPU")
    n, nbins = host["contributions_per_worker"], host["nbins"]
    k_small, k_big = K_SMOKE if smoke else K_FULL
    stages = k_small if smoke else STAGES
    b, g, h = gen_pool(SEED, stages, n, nbins, device)

    def run(k, salt):
        acc = torch.full((nbins, 2), salt * 1e-30, device=device)
        for i in range(k):
            s = i % stages
            acc += K.histogram(b[s], g[s], h[s], nbins, precision="high")
        return acc

    K.histogram.launches = 0
    if device.type == "cuda":
        host_s, dev_s = slope.slope_times(run, k_small, k_big)
    else:
        host_s = dev_s = slope.slope_time(run, k_small, k_big,
                                          allow_noisy=True)
    where = card(device)
    return {"card_kernel_ms_per_round": dev_s * 1e3,
            "card_kernel_host_ms_per_round": host_s * 1e3,
            "card_round_ms": dev_s * 1e3 + host["allreduce_ms_per_round"],
            "speedup_vs_host_round": host["host_round_ms"] /
            (dev_s * 1e3 + host["allreduce_ms_per_round"]),
            "launches": K.histogram.launches,
            "kernel": "csrc/histogram.cu" if device.type == "cuda"
            else "histogram_reference (plain)",
            "contributions": n, "nbins": nbins,
            "device": where["name"], "power_limit": where["power_limit"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes, no artifact")
    ap.add_argument("--device", default=None,
                    help="phase B's device (default: the card)")
    ap.add_argument("--out", type=Path, default=ARTIFACTS)
    args = ap.parse_args(argv)
    device = device_from_arg(args.device)
    if device.type != "cuda" and not args.smoke:
        raise SystemExit(f"boosted_bench: phase B needs a CUDA device, got "
                         f"{device}; only --smoke runs it on the CPU")
    host = phase_a(args.smoke)
    print(json.dumps({"phase": "host_8_workers", **host}), flush=True)
    dev = phase_b(host, device, args.smoke)
    print(json.dumps({"phase": "card_kernel", **dev}), flush=True)
    if args.smoke:
        print("smoke ok")
        return 0
    ts = timestamp()
    path = args.out / f"BOOSTED_BENCH_{ts}.json"
    write_json(path, {
        "benchmark": "a gradient-boosting round: 8 host workers (build + "
                     "socket allreduce) and the histogram kernel's build "
                     "on one card at the same shape",
        "host": host, "card": dev, "timestamp_utc": ts})
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
