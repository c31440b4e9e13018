"""In-process resize worker of the port (tests/test_torch_resize.py and
chip_smoke.py phase 17): the port's copy of ``resize_worker.py``, over the
robust engine of ``rabit_tpu_torch`` with the torch data plane.

A rank survives an elastic shrink and grow WITHOUT its process ever
exiting: ``rabit_tpu_torch.resize()`` re-registers in the same process and
the data plane forms its next world at the new size.

Phases (rounds are a pure function of (round, world, rank), so every sum
is exact and the streams compare bit for bit across runs):

- pre: all ranks form world N and stream ``PRE`` rounds;
- shrink (``RESIZE_ENABLE=1`` only): the victim reports ITSELF evicted over
  the ``evict`` command (its process stays alive) and the survivors
  absorb the shrink with ``resize("recover")``, streaming ``MID`` rounds at
  world N-1 while the victim waits;
- grow: the victim re-admits itself with ``resize("join")`` (parked at the
  tracker until the epoch boundary; the survivors see the parked joiner
  and resize once more), and all N ranks stream ``POST`` rounds, which
  must equal a fixed-world baseline's bit for bit.

A round is the JAX worker's int64 allreduce of 256 elements and, with
``RESIZE_HIST_ROWS`` > 0, a histogram of that many rows into
``RESIZE_HIST_BINS`` bins built with ``ops.histogram.histogram`` on the
data plane's device (the CUDA kernel on the card, its plain version on
the CPU) and allreduced through the engine. The histogram's bins, grad
and hess come from ``RESIZE_SEED`` and the rank; grad and hess are
integers in [-8, 8], so every f32 sum is exact whatever the order of the
kernel's atomics, and each result is held to the exact sum (numpy, f64).

Each process appends its log to ``RESIZE_OUT/r<task>.log`` (the JAX
worker's lines) and writes ``RESIZE_OUT/r<task>.json`` at the end: its
pid, its rounds with their CRCs and wall clocks (around the int64
allreduce and at the round's end), the eviction's wall clock, each
``resize`` call's, the card before, between and after the resizes, the
data plane's formations (and, with ``rabit_telemetry=1``, the
``recovery.world_reform`` spans), and the kernel's launches a round.
Exit 0 only if every round was exact.
"""

import json
import os
import socket
import struct
import sys
import time
import zlib

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import rabit_tpu_torch as rabit  # noqa: E402
from rabit_tpu_torch import telemetry  # noqa: E402
from rabit_tpu_torch.ops import histogram as K  # noqa: E402
from rabit_tpu_torch.tracker import membership  # noqa: E402
from rabit_tpu_torch.tracker.tracker import MAGIC  # noqa: E402

HOST = os.environ["RABIT_TRACKER_URI"]
PORT = int(os.environ["RABIT_TRACKER_PORT"])
TASK = os.environ.get("RABIT_TASK_ID", "?")
OUT = os.environ["RESIZE_OUT"]
KILL_TASK = os.environ.get("KILL_TASK", "1")
DO_RESIZE = os.environ.get("RESIZE_ENABLE", "") == "1"
DEADLINE = time.monotonic() + float(os.environ.get("RESIZE_DEADLINE", "90"))
HIST_ROWS = int(os.environ.get("RESIZE_HIST_ROWS", "0"))
HIST_BINS = int(os.environ.get("RESIZE_HIST_BINS", "1024"))
SEED = int(os.environ.get("RESIZE_SEED", "0"))

PRE = range(0, 5)      # world N
MID = range(5, 8)      # world N-1 (survivors only)
POST = range(10, 15)   # world N again: compared against the baseline

DOC = {"task": TASK, "pid": os.getpid(), "rounds": [], "devices": [],
       "launches": [], "resizes": []}
_inputs = {}     # (rank, device) -> (bins, grad, hess) on the device
_exact = {}      # rank -> f64 [bins, 2]


def log(msg):
    with open(os.path.join(OUT, f"r{TASK}.log"), "a") as f:
        f.write(msg + "\n")


def hist_data(rank):
    """The rank's rows: bin ids, and integer-valued grad and hess."""
    rng = np.random.default_rng([SEED, rank])
    bins = rng.integers(0, HIST_BINS, HIST_ROWS, dtype=np.int32)
    grad = rng.integers(-8, 9, HIST_ROWS).astype(np.float32)
    hess = rng.integers(-8, 9, HIST_ROWS).astype(np.float32)
    return bins, grad, hess


def exact_hist(rank):
    if rank not in _exact:
        bins, grad, hess = hist_data(rank)
        _exact[rank] = np.stack(
            [np.bincount(bins, grad.astype(np.float64), HIST_BINS),
             np.bincount(bins, hess.astype(np.float64), HIST_BINS)], 1)
    return _exact[rank]


def dataplane_device():
    dp = rabit._engine.dataplane
    return None if dp is None or dp.device is None else str(dp.device)


def note_devices(when):
    cur = (torch.cuda.current_device() if torch.cuda.is_available()
           and torch.cuda.is_initialized() else None)
    DOC["devices"].append({"when": when, "current": cur,
                           "dataplane": dataplane_device(),
                           "rank": rabit.get_rank(),
                           "world": rabit.get_world_size()})


def hist_round(rank, world):
    """The rank's histogram by the kernel on its data plane's device,
    allreduced through the engine; returns its CRC."""
    dev = torch.device(dataplane_device() or "cpu")
    key = (rank, str(dev))
    if key not in _inputs:
        _inputs[key] = tuple(torch.from_numpy(a).to(dev)
                             for a in hist_data(rank))
    before = K.histogram.launches
    local = K.histogram(*_inputs[key], HIST_BINS)
    launched = K.histogram.launches - before
    host = local.cpu().numpy()
    out = rabit.allreduce(host, rabit.SUM)
    want = sum(exact_hist(r) for r in range(world)).astype(np.float32)
    np.testing.assert_array_equal(out, want)
    DOC["launches"].append(launched)
    return zlib.crc32(out.tobytes())


def do_round(tag, rnd):
    world, rank = rabit.get_world_size(), rabit.get_rank()
    a = np.arange(256, dtype=np.int64) * (rank + 1) + rnd
    t_start = time.time()
    out = rabit.allreduce(a, rabit.SUM)
    t_int64 = time.time()
    expect = (np.arange(256, dtype=np.int64)
              * (world * (world + 1) // 2) + rnd * world)
    np.testing.assert_array_equal(out, expect)
    crc = zlib.crc32(out.tobytes())
    hcrc = hist_round(rank, world) if HIST_ROWS else None
    DOC["rounds"].append({"tag": tag, "round": rnd, "world": world,
                          "rank": rank, "crc": f"{crc:08x}",
                          "hist_crc": None if hcrc is None
                          else f"{hcrc:08x}", "t_start": t_start,
                          "t_int64": t_int64, "t_end": time.time()})
    log(f"{tag} round={rnd} world={world} crc={crc:08x}")


def evict_self(rank):
    """First-party death evidence for THIS rank; the process stays alive,
    which makes the later ``join`` an in-process re-admission."""
    c = socket.create_connection((HOST, PORT), timeout=10)
    c.sendall(struct.pack("<I", MAGIC))
    for s in ("evict", TASK):
        b = s.encode()
        c.sendall(struct.pack("<I", len(b)) + b)
    c.sendall(struct.pack("<I", 0))
    payload = json.dumps({"rank": rank, "reason": "resize-test"}).encode()
    c.sendall(struct.pack("<I", len(payload)) + payload)
    ok = struct.unpack("<I", c.recv(4))[0]
    c.close()
    return ok


def resize(cmd):
    """``rabit.resize(cmd)``, its wall clock kept."""
    t0 = time.time()
    rabit.resize(cmd)
    DOC["resizes"].append({"cmd": cmd, "t0": t0, "t1": time.time()})


def wait_for(pred, what):
    while True:
        assert time.monotonic() < DEADLINE, f"timed out waiting for {what}"
        doc = membership.fetch_world(HOST, PORT, TASK)
        if doc is not None and pred(doc):
            return doc
        time.sleep(0.05)


def finish():
    eng = rabit._engine
    dp = eng.dataplane
    DOC["epoch"] = eng.world_epoch
    DOC["formations"] = 0 if dp is None else dp.formations
    DOC["backend"] = None if dp is None else dp.backend
    DOC["world_reform"] = [
        {"dur": s["dur"], "epoch": s.get("attrs", {}).get("epoch")}
        for s in telemetry.snapshot()["spans"]
        if s["name"] == "recovery.world_reform"]
    with open(os.path.join(OUT, f"r{TASK}.json"), "w") as f:
        json.dump(DOC, f)


def main():
    rabit.init([a for a in sys.argv[1:] if "=" in a], engine="robust_torch")
    rank, world = rabit.get_rank(), rabit.get_world_size()
    assert rabit.is_distributed()
    log(f"formed rank={rank} world={world}")

    for rnd in PRE:
        do_round("pre", rnd)
    note_devices("pre")

    if DO_RESIZE:
        if TASK == KILL_TASK:
            DOC["evicted_at"] = time.time()
            assert evict_self(rabit.get_rank()) == 1
            log("evicted self (process alive)")
            # the survivors must absorb the shrink before we park, or the
            # next batch forms straight back at the target world
            wait_for(lambda d: d.get("epoch", 0) >= 2, "shrunk world")
            note_devices("mid")
            resize("join")
            log(f"rejoined rank={rabit.get_rank()} "
                f"world={rabit.get_world_size()}")
        else:
            wait_for(lambda d: d.get("evicted"), "eviction")
            resize("recover")
            log(f"reformed rank={rabit.get_rank()} "
                f"world={rabit.get_world_size()}")
            for rnd in MID:
                do_round("mid", rnd)
            note_devices("mid")
            wait_for(lambda d: d.get("joining"), "parked joiner")
            resize("recover")
            log(f"reformed rank={rabit.get_rank()} "
                f"world={rabit.get_world_size()}")

    for rnd in POST:
        do_round("post", rnd)
    note_devices("post")

    finish()
    log("done")
    rabit.finalize()


if __name__ == "__main__":
    main()
