"""Gradient-boosting histogram rounds under the port's launcher: the port
of ``benchmarks/boosted_round_worker.py`` on the host API, with the
histogram built by the port's kernel (``ops.histogram.histogram``: the
CUDA kernel on the card, its plain version on the CPU).

Each round, per worker: gradients and hessians of its shard, the
flattened (feature, bucket) histogram of rows x features contributions
on its device, ``rabit.allreduce`` of the [nbins, 2] result (one
collective a round, nothing else), and a split-like consumer that moves
the margin. The gradients are rounded to the shard's exact step
(``boosted_trees.exact_step``), so that every partial sum of a bin is
exact in f32 and a run is bit for bit reproducible whatever order the
kernel's atomics add in.

    python -m rabit_tpu_torch.tracker.launch -n 4 python -m \\
        rabit_tpu_torch.tools.histogram_rounds --rows 131072 \\
        --features 28 --buckets 256 --rounds 3 rabit_engine=torch \\
        rabit_coordinator=127.0.0.1:29511 rabit_num_processes=4 \\
        [rabit_telemetry=1 rabit_profile=1 ...]

The rank is the launcher's task id (``RABIT_TASK_ID``) unless
``rabit_process_id`` is given. Each worker writes ``rank<r>.json`` into
``RABIT_RESULT_DIR`` (when set): the sha256 of every round's reduced
histogram, the kernel's launches, the device and the host-paced ms of
each round's allreduce.
"""

from __future__ import annotations

import argparse
import hashlib
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

import rabit_tpu_torch as rabit
from rabit_tpu_torch.ops import histogram as K
from rabit_tpu_torch.tools import write_json
from rabit_tpu_torch.tools.boosted_trees import exact_step, make_shard


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--rows", type=int, default=1 << 17)
    ap.add_argument("--features", type=int, default=28)
    ap.add_argument("--buckets", type=int, default=256)
    ap.add_argument("--rounds", type=int, default=3)
    opts, rest = ap.parse_known_args(argv)
    args = [a for a in rest if "=" in a]
    if not any(a.startswith("rabit_process_id=") for a in args):
        args.append(f"rabit_process_id={os.environ.get('RABIT_TASK_ID', 0)}")
    rabit.init(args)
    rank, world = rabit.get_rank(), rabit.get_world_size()
    dev = rabit._engine.device
    n_feat, n_buckets = opts.features, opts.buckets
    nbins = n_feat * n_buckets
    _, y, buckets = make_shard(rank, opts.rows, n_feat, n_buckets)
    step = exact_step(buckets, n_buckets)
    bins = torch.from_numpy(
        (buckets + np.arange(n_feat) * n_buckets).reshape(-1)
        .astype(np.int32)).to(dev)
    margin = np.zeros(len(y), np.float64)
    shas, allreduce_ms = [], []
    for _ in range(opts.rounds):
        p = 1.0 / (1.0 + np.exp(-margin))
        g = torch.from_numpy(np.round((p - y) / step) * step).float().to(dev)
        h = torch.from_numpy(np.round(p * (1.0 - p) / step) * step).float(
            ).to(dev)
        hist = K.histogram(bins, g.repeat_interleave(n_feat),
                           h.repeat_interleave(n_feat), nbins).cpu().numpy()
        t0 = time.perf_counter()
        hist = rabit.allreduce(hist, rabit.SUM)
        allreduce_ms.append((time.perf_counter() - t0) * 1e3)
        shas.append(hashlib.sha256(hist.tobytes()).hexdigest())
        b = int(np.argmax(hist[:, 0] ** 2 / (hist[:, 1] + 1.0)))
        f, bk = divmod(b, n_buckets)
        margin += 0.3 * np.where(buckets[:, f] <= bk, -0.1, 0.1)
    doc = {"rank": rank, "world": world, "device": str(dev),
           "hist_sha256": shas, "launches": K.histogram.launches,
           "allreduce_ms": allreduce_ms}
    rabit.finalize()
    out_dir = os.environ.get("RABIT_RESULT_DIR")
    if out_dir:
        write_json(Path(out_dir) / f"rank{rank}.json", doc)
    sys.stdout.write(f"ROUNDS-OK rank={rank} world={world}\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
