"""Gradient-boosting rounds at benchmark size: the port of
``benchmarks/boosted_round_worker.py``, one rank of
``tools/boosted_bench.py``'s phase A under the port's launcher.

Each round, per worker: the gradients and hessians of its shard, the
flattened (feature, bucket) histogram built on the host ((rows x F)
contributions by ``np.bincount``, the host build the reference's workers
do), then ``rabit_tpu_torch.allreduce`` of the [nbins, 2] histogram. The
two phases are timed a round; the world's MAX of each rides a last
allreduce, and rank 0 writes ONE JSON document of the per-round means
(the first round left out as warm-up) to ``boosted.json`` in
``RABIT_RESULT_DIR`` (where set) and prints it.

env: ROWS (131072), N_FEAT (16), N_BUCKETS (64), N_ROUNDS (10)

    python -m rabit_tpu_torch.tracker.launch -n 8 python -m \\
        rabit_tpu_torch.tools.boosted_round_worker
"""

from __future__ import annotations

import json
import os
import time
from pathlib import Path

import numpy as np

import rabit_tpu_torch as rabit
from rabit_tpu_torch.tools import write_json


def main() -> None:
    rabit.init()
    rank, world = rabit.get_rank(), rabit.get_world_size()
    rows = int(os.environ.get("ROWS", str(1 << 17)))
    n_feat = int(os.environ.get("N_FEAT", "16"))
    n_buckets = int(os.environ.get("N_BUCKETS", "64"))
    n_rounds = int(os.environ.get("N_ROUNDS", "10"))
    nbins = n_feat * n_buckets

    rng = np.random.default_rng(100 + rank)
    x = rng.random((rows, n_feat), dtype=np.float32)
    y = (rng.random(rows) < 0.5).astype(np.float64)
    buckets = np.minimum((x * n_buckets).astype(np.int64), n_buckets - 1)
    # flattened (feature, bucket) ids: each row contributes to EVERY
    # feature's histogram -- rows x F contributions a round
    flat = (buckets + np.arange(n_feat)[None, :] * n_buckets).ravel()

    margin = np.zeros(rows, np.float64)
    t_hist, t_coll = [], []
    for _ in range(n_rounds):
        p = 1.0 / (1.0 + np.exp(-margin))
        g, h = p - y, p * (1.0 - p)
        t0 = time.perf_counter()
        gw = np.repeat(g, n_feat)
        hw = np.repeat(h, n_feat)
        hist = np.stack([
            np.bincount(flat, weights=gw, minlength=nbins),
            np.bincount(flat, weights=hw, minlength=nbins)], axis=1)
        t1 = time.perf_counter()
        hist = rabit.allreduce(hist.ravel(), rabit.SUM)
        t2 = time.perf_counter()
        t_hist.append(t1 - t0)
        t_coll.append(t2 - t1)
        # a split-like consumer keeps the loop honest (and the margin
        # moving, so that g and h change every round)
        hist = hist.reshape(nbins, 2)
        b = int(np.argmax(hist[:, 0] ** 2 / (hist[:, 1] + 1.0)))
        f, bk = divmod(b, n_buckets)
        margin += 0.3 * np.where(buckets[:, f] <= bk, -0.1, 0.1)

    # the world's MAX a phase (a round ends when its slowest worker
    # does), then the means a round without the warm-up round
    per_round = rabit.allreduce(np.stack([t_hist, t_coll]), rabit.MAX)
    rabit.finalize()
    if rank == 0:
        hist_ms = float(per_round[0, 1:].mean() * 1e3)
        coll_ms = float(per_round[1, 1:].mean() * 1e3)
        doc = {"world": world, "rows_per_worker": rows, "n_feat": n_feat,
               "n_buckets": n_buckets, "nbins": nbins,
               "contributions_per_worker": rows * n_feat,
               "rounds_timed": n_rounds - 1,
               "host_hist_ms_per_round": round(hist_ms, 3),
               "allreduce_ms_per_round": round(coll_ms, 3),
               "host_round_ms": round(hist_ms + coll_ms, 3)}
        out = os.environ.get("RABIT_RESULT_DIR")
        if out:
            write_json(Path(out) / "boosted.json", doc)
        print(json.dumps(doc), flush=True)


if __name__ == "__main__":
    main()
