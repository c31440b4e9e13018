"""The wire codec's cost: the port of ``tools/wire_bench.py``.

Two phases:

**host**: world 4 of ``tools/wire_bench_worker.py`` under the port's
launcher, on the robust engine's torch data plane over gloo
(``rabit_engine=robust_torch``, ``rabit_device=cpu``,
``rabit_dataplane_minbytes=0``), times K float-SUM allreduces for each
wire (none, bf16, int8: ``parallel/wire.py``) at 65,536 and 4,194,304
floats; the worker checks every sum. Each row carries the bytes a ring
hop moves by construction: n/p·4 (f32), n/p·2 (bf16), n/p·(1 + 4/block)
(int8 and its f32 scale a block).

**card**: on one card there is no hop to time, so what is measured is
the codec's own work: ``decode(encode(y))`` folded into an f32 loop of K
steps over n = 2^22 floats, against the same loop without the codec (the
f32 identity pass), slope-timed between K = 8 and 64
(``utils/slope.py``: CUDA events behind a sleep, the host-paced slope
beside it). Each codec's row gives ``ns_per_elem`` and its
``overhead_vs_f32``, seconds a step over the f32 pass: the compute a ring
pays a hop to move fewer bytes. It needs a card; ``--smoke`` runs it on
the CPU at n = 4096.

    python -m rabit_tpu_torch.tools.wire_bench [--host-only | --card-only]
        [--device cpu] [--out DIR]
    python -m rabit_tpu_torch.tools.wire_bench --smoke --device cpu

``--smoke`` runs the host phase at n = 4096 (K 3) and the card phase at
n = 4096 (K 2 and 4), and writes nothing. A full run writes
``WIRE_BENCH_<ts>.json`` into ``--out``, by default the port's
``build/artifacts/`` (never ``benchmarks/``), with the card's name and
power limit. Without a card and without ``--device cpu`` it exits
non-zero and prints no result; at full size the card phase refuses the
CPU before anything runs (``--host-only`` runs the host phase alone).
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

from . import ARTIFACTS, card, device_from_arg, timestamp, worker_env, \
    write_json
from ..parallel import wire as W
from ..utils import slope

ROOT = Path(__file__).resolve().parents[2]
HOST_WORLD = 4
WIRES = ("none", "bf16", "int8")
HOST_GRID = [(65536, 10), (4194304, 10)]
SMOKE_HOST_GRID = [(4096, 3)]
CARD_N, SMOKE_N = 1 << 22, 4096
CARD_K, SMOKE_K = (8, 64), (2, 4)
RUN_TIMEOUT_S = 900


def hop_bytes(n: int, world: int, wire: str, block: int) -> int:
    """Bytes one ring hop moves for an n-float allreduce at ``world``."""
    chunk = n // world
    if wire == "bf16":
        return chunk * 2
    if wire == "int8":
        return chunk + (chunk // block) * 4
    return chunk * 4


def run_host(world: int, n: int, k: int, wire: str) -> dict:
    """One wire mode's allreduces at world ``world``: the worker's row."""
    with tempfile.TemporaryDirectory() as out:
        env = dict(os.environ, **worker_env(), WIRE_BENCH_N=str(n),
                   WIRE_BENCH_K=str(k), RABIT_RESULT_DIR=out)
        cmd = [sys.executable, "-m", "rabit_tpu_torch.tracker.launch",
               "-n", str(world), sys.executable, "-m",
               "rabit_tpu_torch.tools.wire_bench_worker",
               "rabit_engine=robust_torch", "rabit_device=cpu",
               "rabit_dataplane_minbytes=0"]
        if wire != "none":
            cmd.append(f"rabit_dataplane_wire={wire}")
        res = subprocess.run(cmd, capture_output=True, text=True,
                             timeout=RUN_TIMEOUT_S, cwd=ROOT, env=env)
        if res.returncode != 0:
            raise RuntimeError(f"host phase, wire {wire}, n {n}: exit "
                               f"{res.returncode}\n{res.stdout[-800:]}\n"
                               f"{res.stderr[-2000:]}")
        row = json.loads((Path(out) / "wire.json").read_text())
    row["hop_bytes"] = hop_bytes(n, world, wire, W.wire_block())
    return row


def run_card(device: torch.device, smoke: bool) -> list:
    """The codec's cost a step on ``device`` (see the module's doc).
    Raises unless ``device`` is a card, except in smoke."""
    if device.type != "cuda" and not smoke:
        raise RuntimeError(f"the card phase needs a CUDA device, got "
                           f"{device}; only --smoke runs it on the CPU")
    n = SMOKE_N if smoke else CARD_N
    k_small, k_big = SMOKE_K if smoke else CARD_K
    block = W.wire_block()
    x = torch.linspace(-1.0, 1.0, n, device=device)

    def make_run(codec):
        def run(k, salt):
            acc = x
            for _ in range(k):
                y = acc + float(salt)
                if codec is not None:
                    y = W.decode(W.encode(y, codec, block), codec, y.shape)
                acc = y * 0.5 + acc * 0.5
            return acc
        return run

    where = card(device)
    rows = []
    for codec in (None, "bf16", "int8"):
        if device.type == "cuda":
            host_s, dev_s = slope.slope_times(make_run(codec), k_small,
                                              k_big)
        else:
            host_s = dev_s = slope.slope_time(make_run(codec), k_small,
                                              k_big, allow_noisy=True)
        rows.append({"wire": codec or "none", "n": n, "block": block,
                     "device": where["name"],
                     "power_limit": where["power_limit"],
                     "s_per_iter": dev_s, "host_s_per_iter": host_s,
                     "ns_per_elem": dev_s / n * 1e9})
    for r in rows[1:]:
        r["overhead_vs_f32"] = r["s_per_iter"] - rows[0]["s_per_iter"]
        r["overhead_ns_per_elem"] = r["overhead_vs_f32"] / n * 1e9
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--host-only", action="store_true")
    ap.add_argument("--card-only", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="tiny sizes, no artifact")
    ap.add_argument("--device", default=None,
                    help="the card phase's device (default: the card)")
    ap.add_argument("--out", type=Path, default=ARTIFACTS)
    args = ap.parse_args(argv)
    device = device_from_arg(args.device) if not args.host_only \
        else torch.device("cpu")
    if device.type != "cuda" and not (args.smoke or args.host_only):
        raise SystemExit(f"wire_bench: the card phase needs a CUDA device, "
                         f"got {device}; only --smoke runs it on the CPU")
    result = {}
    if not args.card_only:
        rows = []
        for n, k in SMOKE_HOST_GRID if args.smoke else HOST_GRID:
            for wire in WIRES:
                rows.append(run_host(HOST_WORLD, n, k, wire))
                print(json.dumps(rows[-1]), flush=True)
        result["host"] = rows
    if not args.host_only:
        result["card"] = run_card(device, args.smoke)
        for r in result["card"]:
            print(json.dumps(r), flush=True)
    if args.smoke:
        print("smoke ok")
        return 0
    ts = timestamp()
    path = args.out / f"WIRE_BENCH_{ts}.json"
    write_json(path, dict(result, device=card(device), timestamp_utc=ts))
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
