"""The histogram kernel's cost split on the card: the port of
``tools/histogram_sweep.py``.

    python -m rabit_tpu_torch.tools.histogram_sweep [--device cpu] [--smoke]
        [--out DIR]

Three variants over rows {2^20, 2^21} x nbins {256, 1024, 4096} (smoke:
2^17 x {256, 1024}):

- ``mask_only``: the bin count (``ops/histogram.py::mask_only``,
  ``csrc/mask_only.cu``): 4 B of ids a row, one shared atomic;
- ``fast`` and ``high``: the full histogram (``ops/histogram.py::
  histogram``): 12 B a row, two shared atomics.

Each is timed by the slope between K = 8 and 64 calls
(``utils/slope.py``; on the card on CUDA events, the host-paced slope
printed beside it where they differ), cycling a pool of datasets made on
the device from a seed, large enough that each variant streams several
times the 50 MB L2 (the pool size is in the artifact). A call is what a
user makes: the wrapper with its output allocation and zero fill. The
batch sums only its last output, with the salt: a sum a call would put
two more small launches into every iteration.

Keys of each row, as in the JAX tool: ``<variant>_ms``, ``<variant>_gbps``
(4 or 12 B a row), ``per_component_ms`` and ``mask_floor_frac_of_high``.
On this card they mean other things than on the TPU: ``fast`` and
``high`` differ only by one bf16 round of each value, so
``per_component_ms`` ((high - fast) / 2) is expected near 0 and is not the
TPU's cost of one value component (a select and an MXU dot);
``mask_floor_frac_of_high`` is the share of the full kernel's time that
the id stream and one atomic a row set.

Then a spot check: ``mask_only`` counts equal ``np.bincount`` exactly
(prints ``mask_only counts correct=True``, fails otherwise). A full run
writes ``HIST_SWEEP_TORCH_<ts>.json`` into ``--out`` (by default
``build/artifacts/``); ``--smoke`` writes nothing.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
from pathlib import Path
from typing import Callable, List

import numpy as np
import torch

from ..ops import histogram as K
from ..utils.slope import slope_time
from . import (ARTIFACTS, card, device_from_arg, gen_pool, timestamp,
               write_json)

K_SMALL, K_BIG = 8, 64
SMOKE_K = (2, 4)
ROWS, NBINS = (1 << 20, 1 << 21), (256, 1024, 4096)
SMOKE_ROWS, SMOKE_NBINS = (1 << 17,), (256, 1024)
VARIANTS = ("mask_only", "fast", "high")
# every variant's pool of ids alone is this many bytes: four times the
# H100's 50 MB L2, so each call reads from device memory
POOL_BYTES = 200e6
SMOKE_POOL = 2


def pool_size(nrows: int, smoke: bool) -> int:
    return SMOKE_POOL if smoke else max(8, math.ceil(POOL_BYTES / (4 * nrows)))


def run_batch(data, salt: int, k: int, variant: str, nbins: int
              ) -> torch.Tensor:
    """k calls of ``variant``, cycling the pool; the last output's sum
    with the salt."""
    b, g, h = data
    out = None
    for i in range(k):
        s = i % b.shape[0]
        if variant == "mask_only":
            out = K.mask_only(b[s], nbins)
        else:
            out = K.histogram(b[s], g[s], h[s], nbins, variant)
    return out.sum() + salt * 1e-30


def spot_check(device: torch.device, smoke: bool) -> bool:
    """``mask_only`` against ``np.bincount``, exactly."""
    rng = np.random.default_rng(0)
    n, nb = (1 << 17, 256) if smoke else (1 << 20, 1024)
    b = rng.integers(0, nb, n).astype(np.int32)
    got = K.mask_only(torch.from_numpy(b).to(device), nb).cpu().numpy()
    want = np.bincount(b, minlength=nb).astype(np.float32)
    return bool(np.array_equal(got, want))


def sweep(device: torch.device, smoke: bool = False,
          emit: Callable[[str], None] = print) -> dict:
    """The sweep's rows and its spot check on ``device``; ``emit`` gets
    each row as a JSON line and the check's verdict. Raises if the counts
    are wrong."""
    k_small, k_big = SMOKE_K if smoke else (K_SMALL, K_BIG)
    cuda = device.type == "cuda"
    table: List[dict] = []
    pools = {}
    for nrows in SMOKE_ROWS if smoke else ROWS:
        pools[nrows] = pool_size(nrows, smoke)
        for nbins in SMOKE_NBINS if smoke else NBINS:
            data = gen_pool(7, pools[nrows], nrows, nbins, device)
            row = {"rows": nrows, "nbins": nbins}
            for variant in VARIANTS:
                t = slope_time(
                    lambda k, s, v=variant: run_batch(data, s, k, v, nbins),
                    k_small, k_big, allow_noisy=smoke, cuda_events=cuda)
                row[f"{variant}_ms"] = round(t * 1e3, 6)
                # bytes streamed: mask_only reads the 4-byte ids only;
                # fast/high also grad and hess
                nbytes = nrows * (4 if variant == "mask_only" else 12)
                row[f"{variant}_gbps"] = round(nbytes / t / 1e9, 3)
            row["per_component_ms"] = round(
                (row["high_ms"] - row["fast_ms"]) / 2, 6)
            row["mask_floor_frac_of_high"] = round(
                row["mask_only_ms"] / row["high_ms"], 3)
            del data
            table.append(row)
            emit(json.dumps(row))
    ok = spot_check(device, smoke)
    emit(f"mask_only counts correct={ok}")
    if not ok:
        raise AssertionError("mask_only counts differ from np.bincount")
    return {"table": table, "k": [k_small, k_big], "pool_datasets": pools,
            "clock": "cuda events" if cuda else "host"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; the card by default")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes, noisy slopes allowed, no artifact")
    ap.add_argument("--out", default=str(ARTIFACTS),
                    help="directory of the artifact")
    args = ap.parse_args(argv)
    device = device_from_arg(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    result = sweep(device, args.smoke)
    if args.smoke:
        print("smoke ok")
        return 0
    ts = timestamp()
    path = Path(args.out) / f"HIST_SWEEP_TORCH_{ts}.json"
    k_small, k_big = result["k"]
    write_json(path, {
        "kind": "rabit_tpu_torch.histogram_sweep/v1",
        "device": card(device), "torch": torch.__version__,
        "measurement": (f"slope K={k_small}->{k_big} calls on "
                        f"{result['clock']}, cycling a pool of "
                        f"{result['pool_datasets']} datasets (rows -> "
                        f"datasets) made on the device"),
        "pool_datasets": result["pool_datasets"],
        "table": result["table"], "timestamp_utc": ts})
    print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
