"""Tracker-resume worker of the port (tests/test_torch_resume.py and
chip_smoke.py phase 18): the port's copy of ``resume_worker.py``, over the
robust engine of ``rabit_tpu_torch``.

A rank that keeps computing THROUGH a tracker crash: once the world is
formed its collectives ride the worker-worker links (and, with
``rabit_dataplane=torch``, the torch data plane's world), so the
tracker's death must cost nothing but control-plane reachability. Each
round allreduces a deterministic int64 payload (a pure function of
round, rank and world) and, with ``RESUME_HIST_ROWS`` > 0, a histogram
of that many rows into ``RESUME_HIST_BINS`` bins built by
``ops.histogram.histogram`` on the data plane's device (the CUDA kernel
on the card, its plain version on the CPU; where no torch data plane
forms -- at world 1, or with the native core's own links
(``rabit_dataplane`` unset) -- on the card the task index picks,
``engine/dataplane.py::card_index``, or the CPU under
``rabit_device=cpu``) and allreduced; grad
and hess are integers in [-8, 8] from ``RESUME_SEED`` and the rank, so
every sum is exact and is held to numpy's. The CRC streams compare bit for bit
with an uninterrupted run.

Between rounds the worker leans on the control plane as a real job does:

- the skew plane's poller (``RABIT_SKEW_TRACKER`` pointed at the
  tracker) polls it every ``RABIT_SKEW_POLL_MS``; its breaker trips
  during the outage and re-arms against the resumed tracker, which fires
  ``membership.present_resume`` and ``live.reannounce`` once (logged as
  ``breaker tripped`` / ``breaker rearmed``);
- a prober asks the tracker for its ``world`` doc every
  ``RESUME_PROBE_MS``: the outage as this worker saw it is the time from
  the start of the first unanswered probe to the next answer (to within
  a probe interval).

With ``RESUME_SHRINK_AT`` = k >= 0 (an elastic world), at round k task
``KILL_TASK`` reports itself evicted (``evict``) and, once the shrunk
world has formed, leaves with exit code 0 and without ``finalize``
(whose consensus exit would wait on the world it has left): it sends its
``shutdown`` itself on the way out, the tracker's sign that it let go of
its world (so the store of its last epoch can go), and the survivors absorb
the shrink with ``resize("recover")`` and stream the remaining rounds at
world N-1. With ``RESUME_AWAIT`` naming a file, every rank waits for it
to exist before round k (the caller writes it once the tracker has been
resumed).

Each process writes ``RESUME_OUT/r<task>.log`` (the JAX worker's lines)
and ``RESUME_OUT/r<task>.json`` (a multi-job task id ``<job>/<i>`` as
``<job>_<i>``): its rounds with their CRCs, the kernel's
launches a round, the outages, ``init``'s seconds, the data plane's
formations with their ``recovery.world_reform`` spans (under
``rabit_telemetry=1``), the card before and after, the epoch, and the
process's fleet event ring (``rabit_events``: whether it was on, and each
record's seq and kind). Exit 0 only if every round was exact.
"""

import json
import os
import socket
import struct
import sys
import threading
import time
import zlib

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import rabit_tpu_torch as rabit  # noqa: E402
from rabit_tpu_torch import telemetry  # noqa: E402
from rabit_tpu_torch.engine.dataplane import card_index  # noqa: E402
from rabit_tpu_torch.ops import histogram as K  # noqa: E402
from rabit_tpu_torch.telemetry import events  # noqa: E402
from rabit_tpu_torch.telemetry import skew  # noqa: E402
from rabit_tpu_torch.tracker import jobs, membership  # noqa: E402
from rabit_tpu_torch.tracker.tracker import MAGIC  # noqa: E402

HOST = os.environ["RABIT_TRACKER_URI"]
PORT = int(os.environ["RABIT_TRACKER_PORT"])
TASK = os.environ.get("RABIT_TASK_ID", "?")
# a multi-job task id <job>/<i> names its files <job>_<i>
TAG = TASK.replace("/", "_")
OUT = os.environ["RESUME_OUT"]
ROUNDS = int(os.environ.get("RESUME_ROUNDS", "30"))
ROUND_SLEEP_S = float(os.environ.get("RESUME_ROUND_SLEEP_MS", "200")) / 1e3
PROBE_S = float(os.environ.get("RESUME_PROBE_MS", "50")) / 1e3
HIST_ROWS = int(os.environ.get("RESUME_HIST_ROWS", "0"))
HIST_BINS = int(os.environ.get("RESUME_HIST_BINS", "1024"))
SEED = int(os.environ.get("RESUME_SEED", "17"))
SHRINK_AT = int(os.environ.get("RESUME_SHRINK_AT", "-1"))
KILL_TASK = os.environ.get("KILL_TASK", "1")
AWAIT = os.environ.get("RESUME_AWAIT", "")
DEADLINE = time.monotonic() + float(os.environ.get("RESUME_DEADLINE", "120"))
DEVICE = next((a.split("=", 1)[1] for a in sys.argv[1:]
               if a.startswith("rabit_device=")), "cuda")

DOC = {"task": TASK, "pid": os.getpid(), "rounds": [], "launches": [],
       "outages": [], "devices": []}
_inputs = {}     # (rank, device) -> (bins, grad, hess) on the device
_exact = {}      # rank -> f64 [bins, 2]


def log(msg):
    with open(os.path.join(OUT, f"r{TAG}.log"), "a") as f:
        f.write(msg + "\n")


class Prober(threading.Thread):
    """Asks the tracker for its ``world`` doc every ``PROBE_S``; keeps
    each outage's wall clocks (first unanswered probe, next answer)."""

    def __init__(self):
        super().__init__(name="resume-prober", daemon=True)
        self.stop = threading.Event()

    def run(self):
        down = None
        while not self.stop.wait(PROBE_S):
            # a probe of a dead tracker retries until its timeout: the
            # outage starts when the first unanswered probe did
            start = time.time()
            doc = membership.fetch_world(HOST, PORT, TASK, timeout=0.5)
            now = time.time()
            if doc is None and down is None:
                down = start
            elif doc is not None and down is not None:
                DOC["outages"].append({"down": down, "up": now,
                                       "s": now - down})
                log(f"outage s={now - down:.3f}")
                down = None


def hist_data(rank):
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


def hist_device():
    """The data plane's device; where no torch data plane forms (world 1,
    or the native core's links) the card the task index picks, as the
    data plane would pick it (card 0 at world 1), or the CPU."""
    dp = dataplane_device()
    if dp is not None:
        return torch.device(dp)
    if DEVICE == "cpu":
        return torch.device("cpu")
    # card 0 where no card is visible (a run that builds no histogram)
    return torch.device("cuda", card_index(
        rabit.get_rank(), max(1, torch.cuda.device_count())))


def note_device(when):
    DOC["devices"].append({"when": when, "dataplane": dataplane_device(),
                           "hist": str(hist_device()),
                           "rank": rabit.get_rank(),
                           "world": rabit.get_world_size()})


def hist_round(rank, world):
    """The rank's histogram by the kernel on its device, allreduced
    through the engine; returns its CRC."""
    dev = hist_device()
    key = (rank, str(dev))
    if key not in _inputs:
        _inputs[key] = tuple(torch.from_numpy(a).to(dev)
                             for a in hist_data(rank))
    before = K.histogram.launches
    local = K.histogram(*_inputs[key], HIST_BINS)
    DOC["launches"].append(K.histogram.launches - before)
    out = rabit.allreduce(local.cpu().numpy(), rabit.SUM)
    want = sum(exact_hist(r) for r in range(world)).astype(np.float32)
    np.testing.assert_array_equal(out, want)
    return zlib.crc32(out.tobytes())


def do_round(rnd):
    world, rank = rabit.get_world_size(), rabit.get_rank()
    a = np.arange(256, dtype=np.int64) * (rank + 1) + rnd
    out = rabit.allreduce(a, rabit.SUM)
    expect = (np.arange(256, dtype=np.int64)
              * (world * (world + 1) // 2) + rnd * world)
    np.testing.assert_array_equal(out, expect)
    crc = zlib.crc32(out.tobytes())
    hcrc = hist_round(rank, world) if HIST_ROWS else None
    DOC["rounds"].append({"round": rnd, "world": world, "rank": rank,
                          "crc": f"{crc:08x}",
                          "hist_crc": None if hcrc is None
                          else f"{hcrc:08x}", "t": time.time()})
    log(f"round={rnd} crc={crc:08x}")


def evict_self(rank):
    """First-party death evidence for THIS rank; the process stays
    alive."""
    c = socket.create_connection((HOST, PORT), timeout=10)
    c.sendall(struct.pack("<I", MAGIC))
    for s in ("evict", TASK):
        b = s.encode()
        c.sendall(struct.pack("<I", len(b)) + b)
    c.sendall(struct.pack("<I", 0))
    payload = json.dumps({"rank": rank, "reason": "resume-test"}).encode()
    c.sendall(struct.pack("<I", len(payload)) + payload)
    ok = struct.unpack("<I", c.recv(4))[0]
    c.close()
    return ok


def wait_for(pred, what):
    while True:
        assert time.monotonic() < DEADLINE, f"timed out waiting for {what}"
        if pred():
            return
        time.sleep(0.05)


def world_doc():
    return membership.fetch_world(HOST, PORT, TASK) or {}


def shrink():
    """The round-k transition: the victim leaves, the survivors resize.
    True for the victim (it stops computing)."""
    if AWAIT:
        wait_for(lambda: os.path.exists(AWAIT), "the tracker's resume")
    if TASK == KILL_TASK:
        assert evict_self(rabit.get_rank()) == 1
        log("evicted self (process alive)")
        wait_for(lambda: world_doc().get("epoch", 0) >= 2, "shrunk world")
        return True
    wait_for(lambda: world_doc().get("evicted"), "eviction")
    t0 = time.time()
    rabit.resize("recover")
    DOC["resize_s"] = time.time() - t0
    log(f"reformed rank={rabit.get_rank()} world={rabit.get_world_size()}")
    return False


def finish():
    eng = rabit._engine
    dp = eng.dataplane
    DOC["epoch"] = eng.world_epoch
    DOC["formations"] = 0 if dp is None else dp.formations
    DOC["world_reform"] = [
        {"dur": s["dur"], "epoch": s.get("attrs", {}).get("epoch")}
        for s in telemetry.snapshot()["spans"]
        if s["name"] == "recovery.world_reform"]
    DOC["events_on"] = events.enabled()
    DOC["events"] = [{"seq": r["seq"], "kind": r["kind"]}
                     for r in events.snapshot()["records"]]
    with open(os.path.join(OUT, f"r{TAG}.json"), "w") as f:
        json.dump(DOC, f)


def main():
    # the skew poller is this worker's steady control-plane heartbeat
    os.environ["RABIT_SKEW_TRACKER"] = f"{HOST}:{PORT}"
    t0 = time.time()
    rabit.init([a for a in sys.argv[1:] if "=" in a])
    DOC["init_s"] = time.time() - t0
    assert rabit.is_distributed()
    log(f"formed rank={rabit.get_rank()} world={rabit.get_world_size()}")
    prober = Prober()
    prober.start()
    mon = skew.monitor()
    mon.current()   # starts the poller
    was_tripped = False
    for rnd in range(ROUNDS):
        if rnd == SHRINK_AT and shrink():
            prober.stop.set()
            prober.join()
            note_device("done")
            finish()
            # it has let go of its world: say so, as finalize would
            jobs.wire_shutdown(HOST, PORT, TASK)
            log("left")
            os._exit(0)
        do_round(rnd)
        if rnd == 0:
            # the data plane forms its world at the first collective
            note_device("first round")
        tripped = mon.breaker_state()["tripped"]
        if tripped and not was_tripped:
            log("breaker tripped")
        elif was_tripped and not tripped:
            log("breaker rearmed")
        was_tripped = tripped
        time.sleep(ROUND_SLEEP_S)
    prober.stop.set()
    prober.join()
    note_device("done")
    finish()
    log("done")
    rabit.finalize()


if __name__ == "__main__":
    main()
