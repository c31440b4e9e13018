"""Benchmark: the gradient-histogram allreduce on the card, the port of
``bench.py``.

    python -m rabit_tpu_torch.bench [--device cpu] [--smoke] [--out DIR]

The workload (``BASELINE.json``): each worker builds a per-bin (grad,
hess) histogram of its rows and allreduces it. Here ``models/histogram.py::
distributed_histogram`` runs over a world-1 process group (NCCL on the
card, gloo on the CPU) at 2^21 rows x 1024 bins.

Headline: gradient-pair GB/s end to end (device-resident inputs to the
reduced histogram), p * n * 12 B over the time a call, against the numpy
host histogram (min of 3) that the reference's worker would run before its
socket allreduce. The time is the slope between K = 32 and 256 calls
(``utils/slope.py``), cycling a pool of 32 datasets made on the device
(805 MB at the headline size, so each call reads from device memory). On
the card the slope is taken on CUDA events (device time) and on the host
clock (host-paced); the headline is the device slope, and the artifact
keeps both. A batch sums only its last output, with the salt.

Variants: ``cuda/high``, ``cuda/fast`` (the kernel, ``csrc/histogram.cu``)
and ``scatter/high`` (``index_add_``); on the CPU ``auto/high`` (the
kernel's plain version) and ``scatter/high``. The headline is the best
``high`` variant. Then a bandwidth curve of that variant at 2^18, 2^20 and
2^22 rows, and a check of the same path against the f64 host sum with
``bench.py``'s tolerance.

Prints ONE JSON line: ``{"metric", "value", "unit", "vs_baseline",
"correct"}``. Without a card, and not asked for ``--device cpu``, it
prints ``{"status": "no_cuda"}`` and exits non-zero. A full run writes a
``rabit_tpu_torch.bench/v1`` artifact into ``--out`` (by default
``build/artifacts/``); ``--smoke`` shrinks the sizes and writes nothing.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .models import histogram as H
from .parallel.mesh import make_group
from .tools import (ARTIFACTS, card, device_from_arg, gen_pool, timestamp,
                    write_json)
from .utils.slope import slope_time, slope_times

METRIC = "histogram_allreduce_throughput"
K_SMALL, K_BIG, K_STAGE = 32, 256, 32
SMOKE_K = (4, 16, 4)
ROWS, NBINS = 1 << 21, 1024
SMOKE_ROWS = 1 << 14
CURVE = (1 << 18, 1 << 20, 1 << 22)
SMOKE_CURVE = (1 << 13,)


def run_batch(data, salt: int, k: int, nbins: int, group, method: str,
              precision: str) -> torch.Tensor:
    """k calls of the distributed path, cycling the pool; the last
    output's sum with the salt."""
    b, g, h = data
    out = None
    for i in range(k):
        s = i % b.shape[0]
        out = H.distributed_histogram(g[s], h[s], b[s], nbins, group, method,
                                      precision)
    return out.sum() + salt * 1e-30


def bench(device: torch.device, smoke: bool = False) -> dict:
    """The measurement; returns the JSON line and the artifact's body."""
    k_small, k_big, k_stage = SMOKE_K if smoke else (K_SMALL, K_BIG, K_STAGE)
    n = SMOKE_ROWS if smoke else ROWS
    nbins = NBINS
    cuda = device.type == "cuda"
    created = not dist.is_initialized()
    group, device = make_group(device)
    try:
        p = dist.get_world_size(group)

        def slopes(fn):
            """(host-paced, device) seconds a call; device None on the
            CPU."""
            if cuda:
                return slope_times(fn, k_small, k_big, allow_noisy=smoke)
            return slope_time(fn, k_small, k_big, allow_noisy=smoke), None

        rank = dist.get_rank(group)
        data = gen_pool(7 + rank, k_stage, n, nbins, device)
        variants = ([("cuda", "high"), ("cuda", "fast"), ("scatter", "high")]
                    if cuda else [("auto", "high"), ("scatter", "high")])
        results = {}
        for method, prec in variants:
            results[f"{method}/{prec}"] = slopes(
                lambda k, s, m=method, pr=prec: run_batch(
                    data, s, k, nbins, group, m, pr))
        del data
        clock = 1 if cuda else 0     # the device slope where there is one
        high = {v: t for v, t in results.items() if v.endswith("/high")}
        best = min(high, key=lambda v: high[v][clock])
        method = best.split("/")[0]
        nbytes = p * n * 12          # bins i32 + grad f32 + hess f32 a row
        t_dev = results[best][clock]
        gbps = nbytes / t_dev / 1e9

        curve, curve_host = {}, {}
        for nn in SMOKE_CURVE if smoke else CURVE:
            dd = gen_pool(7 + rank, k_stage, nn, nbins, device)
            t = slopes(lambda k, s, d=dd: run_batch(d, s, k, nbins, group,
                                                    method, "high"))
            curve[nn] = p * nn * 12 / t[clock] / 1e9
            curve_host[nn] = p * nn * 12 / t[0] / 1e9
            del dd

        # the numpy host histogram of one worker's rows, scaled to p
        # workers in series on one host; min of 3 against host noise
        grad, hess, bins = H.make_inputs(n, nbins, p=p, seed=1000)
        t_host = float("inf")
        for _ in range(3):
            t0 = time.perf_counter()
            H.host_histogram(grad[0], hess[0], bins[0], nbins)
            t_host = min(t_host, (time.perf_counter() - t0) * p)
        host_gbps = nbytes / t_host / 1e9

        # the same path on host-verified data, against the f64 host sum;
        # bench.py's tolerance
        got = H.distributed_histogram(
            *(torch.from_numpy(a[rank]).to(device)
              for a in (grad, hess, bins)),
            nbins, group, method, "high").cpu().numpy()
        want = np.zeros((nbins, 2), np.float64)
        for i in range(p):
            want += H.host_histogram(grad[i], hess[i], bins[i], nbins)
        ok = bool(np.allclose(got, want, rtol=1e-3,
                              atol=4e-3 * math.sqrt(p * n / nbins)))
    finally:
        if created:
            dist.destroy_process_group()

    line = {"metric": METRIC, "value": round(gbps, 3), "unit": "GB/s",
            "vs_baseline": round(gbps / host_gbps, 3), "correct": ok}
    host_paced = nbytes / results[best][0] / 1e9
    doc = {
        "kind": "rabit_tpu_torch.bench/v1", "line": line,
        "device": card(device), "torch": torch.__version__, "devices": p,
        "rows_per_worker": n, "nbins": nbins, "headline": best,
        "t_ms": {v: {"host_paced": t[0] * 1e3,
                     "device": None if t[1] is None else t[1] * 1e3}
                 for v, t in results.items()},
        "host_paced": {"value": host_paced,
                       "vs_baseline": host_paced / host_gbps},
        "bandwidth_vs_rows": curve, "bandwidth_vs_rows_host_paced": curve_host,
        "t_host_ms": t_host * 1e3,
        "measurement": (
            f"slope between K={k_small} and K={k_big} calls, cycling a pool "
            f"of {k_stage} datasets made on the device; the headline on "
            + ("CUDA events behind a sleep kernel" if cuda else
               "the host clock") + ", host_paced on the host clock"),
    }
    return {"line": line, "artifact": doc}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; the card by default")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes, noisy slopes allowed, no artifact")
    ap.add_argument("--out", default=str(ARTIFACTS),
                    help="directory of the artifact")
    args = ap.parse_args(argv)
    if args.device is None and not torch.cuda.is_available():
        print(json.dumps({"status": "no_cuda"}), flush=True)
        print("rabit_tpu_torch.bench: no CUDA device; pass --device cpu to "
              "run on the CPU", file=sys.stderr)
        return 1
    device = device_from_arg(args.device)
    out = bench(device, args.smoke)
    t = out["artifact"]["t_ms"]
    print(f"# {out['artifact']['device']['name']}: headline "
          f"{out['artifact']['headline']}, ms a call {t}", file=sys.stderr)
    if not args.smoke:
        ts = timestamp()
        path = Path(args.out) / f"BENCH_TORCH_{ts}.json"
        write_json(path, dict(out["artifact"], timestamp_utc=ts))
        print(f"# wrote {path}", file=sys.stderr)
    print(json.dumps(out["line"]), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
