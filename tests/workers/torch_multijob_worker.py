"""Multi-job worker of the port (tests/test_torch_multi_job_cluster.py
and chip_smoke.py phase 21): the port's copy of ``multijob_worker.py``,
over the native engine of ``rabit_tpu_torch``.

One native-engine rank of ONE job on a shared multi-job tracker. Every
round is a pure function of (round, world), so the logged CRC stream is
bit-comparable with a solo run of the same job's shape: a neighbour job
dying mid-collective must leave this job's stream identical to running
alone. Each round allreduces an int64 SUM of 8192 elements and, with
``mj_hist_rows`` > 0, a histogram of that many rows into ``mj_hist_bins``
bins built by ``ops.histogram.histogram`` on the process's card (the
card its task index picks, ``engine/dataplane.py::card_index``: the CUDA
kernel there) or, under ``rabit_device=cpu``, on the CPU (its plain
version); grad and hess are integers in [-8, 8] from ``mj_seed`` and the
rank, so every sum is exact and is held to numpy's.

``mj_die_at=K`` makes the rank exit hard (no shutdown, no finalize) just
before round K; ``mj_die_task=I`` limits that to the task of index I
(every task of the job otherwise). ``mj_sleep_ms`` sleeps between
rounds. Configuration rides argv ``key=value`` pairs like the other
workers: the ``mj_*`` keys and ``rabit_device`` are taken here, the rest
feed ``rabit.init``.

Each process writes ``<mj_out>/r<job>_<task>.log`` (the JAX worker's
lines) and ``r<job>_<task>.json``, rewritten after every round: its
rounds with their CRCs, the kernel's launches a round and the device of
its histograms.
"""

import json
import os
import sys
import time
import zlib

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import rabit_tpu_torch as rabit  # noqa: E402
from rabit_tpu_torch.engine.dataplane import card_index  # noqa: E402
from rabit_tpu_torch.ops import histogram as K  # noqa: E402
from rabit_tpu_torch.tracker.jobs import split_task  # noqa: E402

TASK = os.environ.get("RABIT_TASK_ID", "?")
COUNT = 8192


def hist_data(rank, rows, bins, seed):
    rng = np.random.default_rng([seed, rank])
    ids = rng.integers(0, bins, rows, dtype=np.int32)
    grad = rng.integers(-8, 9, rows).astype(np.float32)
    hess = rng.integers(-8, 9, rows).astype(np.float32)
    return ids, grad, hess


def exact_hist(rank, rows, bins, seed):
    ids, grad, hess = hist_data(rank, rows, bins, seed)
    return np.stack([np.bincount(ids, grad.astype(np.float64), bins),
                     np.bincount(ids, hess.astype(np.float64), bins)], 1)


def main():
    cfg = dict(a.split("=", 1) for a in sys.argv[1:] if "=" in a)
    out_dir = cfg.pop("mj_out")
    rounds = int(cfg.pop("mj_rounds", "4"))
    die_at = int(cfg.pop("mj_die_at", "-1"))
    die_task = cfg.pop("mj_die_task", "")
    sleep_s = float(cfg.pop("mj_sleep_ms", "0")) / 1e3
    rows = int(cfg.pop("mj_hist_rows", "0"))
    bins = int(cfg.pop("mj_hist_bins", "1024"))
    seed = int(cfg.pop("mj_seed", "17"))
    device = cfg.pop("rabit_device", "cuda")
    _job, index = split_task(TASK)
    if die_task and die_task != index:
        die_at = -1
    tag = TASK.replace("/", "_")
    log_path = os.path.join(out_dir, f"r{tag}.log")
    doc = {"task": TASK, "pid": os.getpid(), "rounds": [], "launches": []}

    def log(msg):
        with open(log_path, "a") as f:
            f.write(msg + "\n")

    def dump():
        with open(os.path.join(out_dir, f"r{tag}.json"), "w") as f:
            json.dump(doc, f)

    rabit.init([f"{k}={v}" for k, v in cfg.items()], engine="native")
    rank, world = rabit.get_rank(), rabit.get_world_size()
    assert rabit.is_distributed()
    log(f"formed rank={rank} world={world}")
    dev = (torch.device("cpu") if device == "cpu" else torch.device(
        "cuda", card_index(rank, max(1, torch.cuda.device_count()))))
    doc["device"] = str(dev)
    inputs = (tuple(torch.from_numpy(a).to(dev)
                    for a in hist_data(rank, rows, bins, seed))
              if rows else None)
    want_hist = (sum(exact_hist(r, rows, bins, seed) for r in range(world))
                 .astype(np.float32) if rows else None)

    for rnd in range(rounds):
        if rnd == die_at:
            log(f"dying round={rnd}")
            dump()
            os._exit(17)    # a crash: no shutdown, no finalize
        a = np.arange(COUNT, dtype=np.int64) * (rank + 1) + rnd
        out = rabit.allreduce(a, rabit.SUM)
        expect = (np.arange(COUNT, dtype=np.int64)
                  * (world * (world + 1) // 2) + rnd * world)
        np.testing.assert_array_equal(out, expect)
        crc = zlib.crc32(out.tobytes())
        hcrc = None
        if rows:
            before = K.histogram.launches
            local = K.histogram(*inputs, bins)
            doc["launches"].append(K.histogram.launches - before)
            hist = rabit.allreduce(local.cpu().numpy(), rabit.SUM)
            np.testing.assert_array_equal(hist, want_hist)
            hcrc = f"{zlib.crc32(hist.tobytes()):08x}"
        log(f"sum round={rnd} world={world} crc={crc:08x}")
        doc["rounds"].append({"round": rnd, "world": world, "rank": rank,
                              "crc": f"{crc:08x}", "hist_crc": hcrc})
        dump()   # a rank whose peer dies leaves its rounds behind
        if sleep_s:
            time.sleep(sleep_s)

    log("done")
    dump()
    rabit.finalize()


if __name__ == "__main__":
    main()
