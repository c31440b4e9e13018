"""Elastic-membership cluster worker of the port (tests/test_torch_resize.py):
the port's copy of ``elastic_worker.py``, over ``rabit_tpu_torch``'s
tracker, launcher, membership module and checkpoint store.

A pure control-plane worker: speaks the tracker registration protocol
directly (no native engine, no torch world) so the membership state
machine is exercised end to end across real processes — initial
formation at the target world, a scripted death, the survivors' in-job
re-formation at N-1, and the re-admission back to N at the next epoch
boundary.

Roles (selected by RABIT_TASK_ID / KILL_TASK / RABIT_NUM_TRIAL):

- the victim's first attempt registers, acks the formed world, then
  dies hard (exit 1 — the launcher re-admits it, budget-exempt);
- the victim's relaunch reports its predecessor dead (the ``evict``
  wire command: a restarted process is first-party death evidence),
  waits until the survivors have re-formed the shrunk world, sends
  ``join`` (parking at the tracker until the epoch boundary), and on
  admission seeds its empty checkpoint store from its siblings'
  durable shards (adopt_latest_from_peers);
- survivors watch the membership doc between "rounds" and re-register
  whenever the tracker has made a decision their formed world has not
  absorbed — once for the shrink, once for the grow.

Every live member of an epoch durably checkpoints the SAME payload
(a pure function of the assignment epoch and world size), so the test
can assert bit-exactness across ranks and across the resize.

The writes are ordered: the survivors save v2 only once the joiner has
seeded its store (it leaves an ``adopted`` marker in ELASTIC_OUT after
logging its adoption). Otherwise a survivor's v2 can reach the disk
before the joiner looks, and the joiner adopts v2 instead of the shrunk
world's v1.
"""

import json
import os
import socket
import struct
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

from rabit_tpu_torch.engine.ckpt_store import CheckpointStore  # noqa: E402
from rabit_tpu_torch.tracker import membership  # noqa: E402
from rabit_tpu_torch.tracker.tracker import MAGIC  # noqa: E402

HOST = os.environ["RABIT_TRACKER_URI"]
PORT = int(os.environ["RABIT_TRACKER_PORT"])
TASK = os.environ["RABIT_TASK_ID"]
ATTEMPT = int(os.environ.get("RABIT_NUM_TRIAL", "0") or 0)
OUT = os.environ["ELASTIC_OUT"]
KILL_TASK = os.environ.get("KILL_TASK", "1")
TARGET = int(os.environ.get("ELASTIC_TARGET", "4"))
DEADLINE = time.monotonic() + float(os.environ.get("ELASTIC_DEADLINE", "90"))


def _send_u32(c, v):
    c.sendall(struct.pack("<I", v))


def _send_str(c, s):
    b = s.encode()
    _send_u32(c, len(b))
    c.sendall(b)


def _recv_all(c, n):
    out = b""
    while len(out) < n:
        chunk = c.recv(n - len(out))
        if not chunk:
            raise ConnectionError("closed")
        out += chunk
    return out


def _recv_u32(c):
    return struct.unpack("<I", _recv_all(c, 4))[0]


def _recv_str(c):
    return _recv_all(c, _recv_u32(c)).decode()


def register(cmd):
    """One full registration: returns (rank, world, epoch) after the
    ready ack. Blocks inside the tracker until the batch forms."""
    c = socket.create_connection((HOST, PORT), timeout=10)
    c.settimeout(60)
    _send_u32(c, MAGIC)
    _send_str(c, cmd)
    _send_str(c, TASK)
    _send_u32(c, ATTEMPT)
    _send_str(c, "127.0.0.1")
    _send_u32(c, 9100 + int(TASK))
    _send_u32(c, 0)   # flags: no data plane
    _send_str(c, "")  # no UDS twin
    rank = _recv_u32(c)
    world = _recv_u32(c)
    epoch = _recv_u32(c)
    _recv_str(c)      # coord_host
    _recv_u32(c)      # coord_port
    _recv_u32(c)      # single_host
    _recv_u32(c)      # parent
    for _ in range(_recv_u32(c)):
        _recv_u32(c)  # tree neighbor
    _recv_u32(c)      # ring_prev
    _recv_u32(c)      # ring_next
    for _ in range(_recv_u32(c)):
        _recv_u32(c)
        _recv_str(c)
        _recv_u32(c)
        _recv_str(c)
    _recv_u32(c)      # naccept
    _send_u32(c, 1)   # ready ack
    c.close()
    return rank, world, epoch


def predecessor_rank():
    """The stable rank the tracker assigned this task's DEAD
    incarnation. Ranks are handed out in registration-arrival order,
    not by task id — under load task "1" may well hold rank 2 — so
    evicting ``int(TASK)`` can hit a live survivor and wedge the
    world. The attempt-0 ``formed rank=R`` log line is the
    first-party record of the real assignment."""
    try:
        with open(os.path.join(OUT, f"r{TASK}.log")) as f:
            for ln in f.read().splitlines():
                if ln.startswith("formed rank="):
                    return int(ln.split("rank=")[1].split()[0])
    except OSError:
        pass
    return int(TASK)


def evict_self(rank):
    """Report the previous incarnation of this stable rank dead."""
    c = socket.create_connection((HOST, PORT), timeout=10)
    _send_u32(c, MAGIC)
    _send_str(c, "evict")
    _send_str(c, TASK)
    _send_u32(c, ATTEMPT)
    _send_str(c, json.dumps({"rank": rank, "reason": "restarted"}))
    ok = _recv_u32(c)
    c.close()
    return ok


def wait_for(pred, what):
    while True:
        assert time.monotonic() < DEADLINE, f"timed out waiting for {what}"
        doc = membership.fetch_world(HOST, PORT, TASK)
        if doc is not None and pred(doc):
            return doc
        time.sleep(0.05)


def adopted_marker():
    return os.path.join(OUT, "adopted")


def wait_for_adoption():
    """Block until the joiner has seeded its store from the shrunk
    world's checkpoint."""
    while not os.path.exists(adopted_marker()):
        assert time.monotonic() < DEADLINE, "timed out waiting for adoption"
        time.sleep(0.02)


def log(msg):
    with open(os.path.join(OUT, f"r{TASK}.log"), "a") as f:
        f.write(msg + "\n")


def checkpoint_payload(epoch, world):
    """The deterministic 'model' every live member of an epoch writes:
    a pure function of the formed epoch and world size, so bit-exact
    agreement across ranks is assertable from the outside."""
    return json.dumps({"epoch": epoch, "world": world},
                      sort_keys=True).encode()


def main():
    store = CheckpointStore(os.path.join(OUT, "ckpt"), rank=int(TASK),
                            keep=2)
    if TASK == KILL_TASK and ATTEMPT == 0:
        rank, world, epoch = register("start")
        log(f"formed rank={rank} world={world} epoch={epoch}")
        log("dying")
        os._exit(1)

    if TASK == KILL_TASK:
        # relaunched victim: first-party death evidence, then park
        evict_self(predecessor_rank())
        log("evicted self")
        # the survivors must absorb the shrink before we re-admit, or
        # the next batch would form straight back at the target world
        wait_for(lambda d: d.get("epoch", 0) >= 2, "shrunk world")
        rank, world, epoch = register("join")
        log(f"rejoined rank={rank} world={world} epoch={epoch}")
        adopted = store.adopt_latest_from_peers()
        log(f"adopted v{adopted}")
        # release the survivors' v2 saves (an atomic create)
        tmp = adopted_marker() + f".tmp{os.getpid()}"
        with open(tmp, "w") as f:
            f.write(str(adopted))
        os.replace(tmp, adopted_marker())
        store.save(2, checkpoint_payload(epoch, world))
        log("done")
        return

    # survivor: form, absorb the shrink, absorb the grow
    rank, world, epoch = register("start")
    log(f"formed rank={rank} world={world} epoch={epoch}")
    wait_for(lambda d: d.get("evicted"), "eviction")
    rank, world, epoch = register("recover")
    log(f"reformed rank={rank} world={world} epoch={epoch}")
    store.save(1, checkpoint_payload(epoch, world))
    wait_for(lambda d: d.get("joining"), "parked joiner")
    rank, world, epoch = register("recover")
    log(f"reformed rank={rank} world={world} epoch={epoch}")
    wait_for_adoption()
    store.save(2, checkpoint_payload(epoch, world))
    log("done")


if __name__ == "__main__":
    main()
