"""Self-healing data-plane worker of the port (tests/test_torch_selfheal_cluster.py
and chip_smoke.py phase 24): the port's copy of ``selfheal_worker.py``,
over the native engine of ``rabit_tpu_torch``.

A native-engine rank streaming CRC-framed collectives
(``rabit_frame_crc=1``) while chaos link proxies corrupt or tear the wire
underneath it. Every round is a pure function of (round, world), so the
int64 sums are exact and the logged CRC streams compare bit for bit with
a fault-free run: hop-local frame retransmission and link resurrection
must heal the wire without the application seeing any difference (no
wrong bytes, no exit, no respawn, no eviction).

The rounds are the JAX worker's: ``N_SUM`` int64 sums of ``SUM_COUNT``
elements (512 KiB: the 16-byte frame headers are a vanishing fraction of
the stream, so seeded bitflips land in CRC-protected payload bytes), then
``N_BCAST`` broadcasts of 256 KiB. Then ``HIST_ROUNDS`` histogram rounds:
the rank's histogram of ``HIST_ROWS`` rows into ``HIST_BINS`` bins, built
by ``ops.histogram.histogram`` on the rank's ``rabit_device`` (the CUDA
kernel on card ``card_index(rank, cards)``; its plain version under
``rabit_device=cpu``), copied to the host and allreduced (SUM) through
the framed native core. Grad and hess are integers in [-8, 8] drawn from
seed 17 and the rank, so every sum is exact in f32 and is held to
numpy's.

Each process appends ``sum round=R world=W crc=XXXXXXXX``, ``bcast
round=...`` and ``hist round=...`` lines, then ``done``, to
``SELFHEAL_OUT/r<task>.log``, and writes ``SELFHEAL_OUT/r<task>.json``:
the histogram's device and the kernel's launches each round. With
``SELFHEAL_AWAIT`` naming a file, each rank then waits for it to exist
before ``finalize`` (its metrics endpoint stays up meanwhile, for a
scrape by the caller). Exit 0 only if every collective on every rank was
exact.
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

TASK = os.environ.get("RABIT_TASK_ID", "?")
OUT = os.environ["SELFHEAL_OUT"]
N_SUM = int(os.environ.get("N_SUM", "6"))
N_BCAST = int(os.environ.get("N_BCAST", "2"))
COUNT = int(os.environ.get("SUM_COUNT", "65536"))  # x8 bytes = 512 KiB
HIST_ROUNDS = int(os.environ.get("HIST_ROUNDS", "2"))
HIST_ROWS = int(os.environ.get("HIST_ROWS", str(1 << 21)))
HIST_BINS = int(os.environ.get("HIST_BINS", "1024"))
HIST_SEED = 17
AWAIT = os.environ.get("SELFHEAL_AWAIT", "")
AWAIT_S = 120
DEVICE = next((a.split("=", 1)[1] for a in sys.argv[1:]
               if a.startswith("rabit_device=")), "cuda")


def log(msg):
    with open(os.path.join(OUT, f"r{TASK}.log"), "a") as f:
        f.write(msg + "\n")


def hist_data(rank):
    rng = np.random.default_rng([HIST_SEED, rank])
    bins = rng.integers(0, HIST_BINS, HIST_ROWS, dtype=np.int32)
    grad = rng.integers(-8, 9, HIST_ROWS).astype(np.float32)
    hess = rng.integers(-8, 9, HIST_ROWS).astype(np.float32)
    return bins, grad, hess


def exact_hist(rank):
    bins, grad, hess = hist_data(rank)
    return np.stack([np.bincount(bins, grad.astype(np.float64), HIST_BINS),
                     np.bincount(bins, hess.astype(np.float64), HIST_BINS)],
                    1)


def hist_device(rank):
    if DEVICE == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", card_index(rank, torch.cuda.device_count()))


def main():
    rabit.init([a for a in sys.argv[1:] if "=" in a], engine="native")
    rank, world = rabit.get_rank(), rabit.get_world_size()
    assert rabit.is_distributed()
    log(f"formed rank={rank} world={world}")

    for rnd in range(N_SUM):
        a = np.arange(COUNT, dtype=np.int64) * (rank + 1) + rnd
        out = rabit.allreduce(a, rabit.SUM)
        expect = (np.arange(COUNT, dtype=np.int64)
                  * (world * (world + 1) // 2) + rnd * world)
        np.testing.assert_array_equal(out, expect)
        log(f"sum round={rnd} world={world} "
            f"crc={zlib.crc32(out.tobytes()):08x}")

    for rnd in range(N_BCAST):
        blob = (np.arange(32768, dtype=np.int64) + rnd).tobytes()  # 256 KiB
        got = rabit.broadcast(blob if rank == 0 else None, 0)
        assert got == blob, f"bcast round {rnd} corrupted"
        log(f"bcast round={rnd} world={world} crc={zlib.crc32(got):08x}")

    dev = hist_device(rank)
    doc = {"task": TASK, "rank": rank, "device": str(dev), "launches": []}
    if HIST_ROUNDS:
        ins = tuple(torch.from_numpy(a).to(dev) for a in hist_data(rank))
        want = sum(exact_hist(r) for r in range(world)).astype(np.float32)
    for rnd in range(HIST_ROUNDS):
        before = K.histogram.launches
        local = K.histogram(*ins, HIST_BINS)
        doc["launches"].append(K.histogram.launches - before)
        out = rabit.allreduce(local.cpu().numpy(), rabit.SUM)
        np.testing.assert_array_equal(out, want)
        log(f"hist round={rnd} world={world} "
            f"crc={zlib.crc32(out.tobytes()):08x}")

    with open(os.path.join(OUT, f"r{TASK}.json"), "w") as f:
        json.dump(doc, f)
    log("done")
    deadline = time.monotonic() + AWAIT_S
    while AWAIT and not os.path.exists(AWAIT):
        assert time.monotonic() < deadline, f"no {AWAIT} in {AWAIT_S} s"
        time.sleep(0.05)
    rabit.finalize()


if __name__ == "__main__":
    main()
