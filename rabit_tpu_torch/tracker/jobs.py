"""Per-job control-plane state of the multi-job tracker: the port's copy
of ``rabit_tpu/tracker/jobs.py``, whole.

Without it one tracker serves one world, so many jobs mean many
trackers, each its own blast radius. Everything in ``tracker/tracker.py``
that is derived from one world -- stable ranks, pending registrations,
the epoch, membership, telemetry, topology, the skew election, the
epochs' rendezvous stores -- lives on a :class:`JobState`, and the
tracker is a long-lived multiplexing service over a ``{job_id:
JobState}`` table.

Job addressing rides the EXISTING wire protocol: a worker whose
``task_id`` is ``<job>/<task>`` addresses job ``<job>`` (the prefix up
to the first ``/``), and a task_id without a separator addresses the
implicit ``default`` job. The tracker only ever splits task ids when
``rabit_multi_job`` is set — unset, every byte on the wire and in the
WAL is identical to a single-job tracker (``tests/test_torch_jobs.py``
holds the bytes), and the native engine needs no change, because the job
id is only the task id's spelling.

Admission control makes overload a degraded mode instead of an outage:
``rabit_max_jobs`` / ``rabit_max_fleet_ranks`` cap the live set, the
``submit`` wire command answers immediately with ok / queued / shed
(never blocks the accept loop), and a bounded FIFO
:class:`AdmissionQueue` parks submissions that do not fit until a
running job closes. A shed or queued submitter backs off and retries
after the hinted ``retry_after_ms`` (:func:`submit_blocking`, the
``tracker.launch --submit`` path).

Stdlib + membership only — the tracker imports this module, never the
reverse (the ``--smoke`` CLI imports the tracker lazily, like wal.py).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List, Optional, Tuple

from . import membership as _membership

DEFAULT_JOB = "default"
JOB_SEP = "/"

MULTI_JOB_ENV = "RABIT_MULTI_JOB"
MAX_JOBS_ENV = "RABIT_MAX_JOBS"
MAX_FLEET_RANKS_ENV = "RABIT_MAX_FLEET_RANKS"
ADMISSION_QUEUE_ENV = "RABIT_ADMISSION_QUEUE"
SCHED_CLASS_ENV = "RABIT_SCHED_CLASS"
SCHED_WEIGHT_ENV = "RABIT_SCHED_WEIGHT"

MAX_JOBS_DEFAULT = 8
MAX_FLEET_RANKS_DEFAULT = 0        # 0 = unbounded
ADMISSION_QUEUE_DEFAULT = 4
RETRY_AFTER_MS_DEFAULT = 500
SCHED_CLASS_DEFAULT = 0
SCHED_WEIGHT_DEFAULT = 1.0

# job lifecycle: forming (submitted/opened, world not yet assembled)
# -> live (first epoch formed) -> closed (all ranks shut down, or the
# operator closed it); failed = every live rank lost without a clean
# shutdown — the job re-forms inside its own fault domain or stays
# failed, but never touches a neighbor.
JOB_STATUSES = ("forming", "live", "failed", "closed")


def multi_job_enabled() -> bool:
    """``rabit_multi_job``: serve multiple fault-isolated jobs through
    one tracker. Unset/0: the tracker is byte-identical to the single-job
    control plane -- task ids are never split, the WAL carries no job
    fields, and /metrics grows no job labels."""
    return os.environ.get(MULTI_JOB_ENV, "0") not in ("", "0", None)


def max_jobs() -> int:
    """``rabit_max_jobs``: admission cap on concurrently open (not yet
    closed) jobs. Submissions past it queue, then shed."""
    try:
        return max(1, int(os.environ.get(MAX_JOBS_ENV,
                                         MAX_JOBS_DEFAULT)))
    except ValueError:
        return MAX_JOBS_DEFAULT


def max_fleet_ranks() -> int:
    """``rabit_max_fleet_ranks``: admission cap on the sum of worker
    counts across open jobs (0 = unbounded). Protects the tracker's
    poll/accept planes from an aggregate world it cannot serve."""
    try:
        return max(0, int(os.environ.get(MAX_FLEET_RANKS_ENV,
                                         MAX_FLEET_RANKS_DEFAULT)))
    except ValueError:
        return MAX_FLEET_RANKS_DEFAULT


def admission_queue_depth() -> int:
    """``rabit_admission_queue``: bounded FIFO depth for submissions
    that do not fit the caps right now. Beyond it submitters are shed
    (told to back off and retry), never stalled."""
    try:
        return max(0, int(os.environ.get(ADMISSION_QUEUE_ENV,
                                         ADMISSION_QUEUE_DEFAULT)))
    except ValueError:
        return ADMISSION_QUEUE_DEFAULT


def sched_class() -> int:
    """``rabit_sched_class``: the priority class a ``submit`` carries
    (higher = more important, default 0). Under
    ``rabit_max_fleet_ranks`` contention, a higher-class submit may
    preempt ranks from the lowest open class (elastic jobs only) via
    the tracker's fleet scheduler; equal or lower classes
    queue FIFO as before."""
    try:
        return max(0, int(os.environ.get(SCHED_CLASS_ENV,
                                         SCHED_CLASS_DEFAULT)))
    except ValueError:
        return SCHED_CLASS_DEFAULT


def sched_weight() -> float:
    """``rabit_sched_weight``: this job's share weight in the fleet
    scheduler's weighted fairness over ``rabit_max_fleet_ranks``
    (default 1.0). A weight-2 job is entitled to twice the ranks of a
    weight-1 neighbor when the autoscaler's fleet sweep rebalances a
    contended fleet."""
    try:
        w = float(os.environ.get(SCHED_WEIGHT_ENV, SCHED_WEIGHT_DEFAULT))
        return w if w > 0 else SCHED_WEIGHT_DEFAULT
    except ValueError:
        return SCHED_WEIGHT_DEFAULT


def split_task(task_id: str) -> Tuple[str, str]:
    """``<job>/<task>`` -> ``(job, task)``; no separator -> the
    implicit default job. Only ever called when multi-job is ON — the
    single-job tracker forwards task ids untouched, so a ``/`` in a
    legacy task id cannot change behavior unless the operator opted
    in."""
    if JOB_SEP in task_id:
        job, task = task_id.split(JOB_SEP, 1)
        if job:
            return job, task
    return DEFAULT_JOB, task_id


def job_task(job_id: str, task: str) -> str:
    """Inverse of :func:`split_task` for launchers: the wire task_id
    addressing ``task`` inside ``job_id``."""
    if job_id == DEFAULT_JOB:
        return str(task)
    return f"{job_id}{JOB_SEP}{task}"


class JobState:
    """All tracker state derived from ONE world. The tracker holds a
    ``{job_id: JobState}`` table and every command handler resolves its
    job first; an exception while handling one job's command is caught
    at the job boundary (``quarantined`` counts them) and can never
    poison a neighbor or the accept loop."""

    def __init__(self, job_id: str, nworkers: int,
                 elastic: bool = False, sched_class: int = 0,
                 sched_weight: float = 1.0):
        self.job_id = str(job_id)
        self.nworkers = int(nworkers)
        self.elastic = bool(elastic)
        # the fleet scheduler: priority class (higher wins under
        # contention), fairness weight, and the admission-counted rank
        # quota — nworkers until preemption shrinks it, so with the
        # scheduler knobs unset every capacity sum is exactly the old
        # nworkers sum
        self.sched_class = int(sched_class)
        self.sched_weight = float(sched_weight)
        self.quota = self.nworkers
        self.preempted = 0             # ranks taken by higher classes
        self.status = "forming"
        self.quarantined = 0            # commands quarantined at the boundary
        self.closed_reason = ""
        # -- the per-world state --
        self._ranks: Dict[str, int] = {}     # task -> stable rank
        self._pending: Dict[int, tuple] = {}
        self._epoch = 0
        self._shutdown_ranks: set = set()
        self._metrics: Dict[str, dict] = {}  # task -> telemetry summary
        self._endpoints: Dict[str, dict] = {}
        self._endpoint_misses: Dict[str, int] = {}
        self._topo: dict = {}
        self._skew: dict = {}
        self._skew_election = None      # lazy telemetry.skew.FleetElection
        self._member = (_membership.MembershipView(self.nworkers)
                        if self.elastic else None)
        self._resumed_ranks: set = set()
        self._last_straggler: Optional[dict] = None
        # (epoch, TCPStore, members): this job's epoch rendezvous stores
        self._stores: List[tuple] = []
        # stable rank -> the newest epoch it acked, and the newest epoch
        # every member of which acked it (the store reaping)
        self._acked: Dict[int, int] = {}
        self._all_acked = 0

    # -- lifecycle ---------------------------------------------------------
    def mark_live(self) -> None:
        """First epoch formed (or re-formed after a failure)."""
        if self.status != "closed":
            self.status = "live"

    def mark_failed(self, reason: str = "") -> None:
        """Every live rank lost without clean shutdown: the job's own
        fault domain absorbed the loss. It may re-form (elastic) or
        stay failed; neighbors never observe the transition."""
        if self.status not in ("closed",):
            self.status = "failed"
            self.closed_reason = reason or self.closed_reason

    def close(self, reason: str = "") -> None:
        self.status = "closed"
        self.closed_reason = reason or self.closed_reason

    @property
    def open(self) -> bool:
        """Counted against the admission caps: anything not closed."""
        return self.status != "closed"

    def live_world(self) -> int:
        if self.elastic and self._member is not None:
            return self._member.world()
        return self.nworkers

    def all_down_locked(self) -> bool:
        """True when every live rank has sent shutdown (caller holds
        the tracker lock). Evicted ranks never send shutdown."""
        if self.elastic and self._member is not None and self._member.live:
            return self._member.live <= self._shutdown_ranks
        return len(self._shutdown_ranks) >= self.nworkers

    def doc(self) -> dict:
        """Per-job health document (the tracker's ``/jobs`` route and
        ``capture_status.py --live``)."""
        return {
            "job": self.job_id,
            "status": self.status,
            "nworkers": self.nworkers,
            "elastic": self.elastic,
            "epoch": self._epoch,
            "world": self.live_world(),
            "ranks": len(self._ranks),
            "quarantined": self.quarantined,
            "endpoints": len(self._endpoints),
            "shutdown": len(self._shutdown_ranks),
            "closed_reason": self.closed_reason,
            "sched_class": self.sched_class,
            "weight": self.sched_weight,
            "quota": self.quota,
            "preempted": self.preempted,
            # the fleet sweep needs rank IDENTITY (evict targets), not
            # just a count; fixed worlds are the contiguous range
            "live": (sorted(self._member.live)
                     if self.elastic and self._member is not None
                     else list(range(self.nworkers))),
        }


class AdmissionQueue:
    """Bounded FIFO of job submissions that did not fit the caps.
    Thread-compat: the tracker mutates it under its own lock; the
    internal lock only guards direct CLI/test use."""

    def __init__(self, depth: Optional[int] = None):
        self.depth = admission_queue_depth() if depth is None else depth
        self._items: List[dict] = []
        self._lock = threading.Lock()
        self.queued_total = 0
        self.shed_total = 0

    def __len__(self) -> int:
        with self._lock:
            return len(self._items)

    def offer(self, entry: dict) -> int:
        """Queue ``entry`` FIFO; returns its 0-based position, or -1
        when the queue is full (the submitter is shed). A job id
        already queued keeps its position (idempotent resubmit)."""
        with self._lock:
            for i, it in enumerate(self._items):
                if it.get("job") == entry.get("job"):
                    return i
            if len(self._items) >= self.depth:
                self.shed_total += 1
                return -1
            self._items.append(dict(entry))
            self.queued_total += 1
            return len(self._items) - 1

    def pop_front(self) -> Optional[dict]:
        with self._lock:
            return self._items.pop(0) if self._items else None

    def peek(self) -> Optional[dict]:
        with self._lock:
            return dict(self._items[0]) if self._items else None

    def snapshot(self) -> List[dict]:
        with self._lock:
            return [dict(it) for it in self._items]


# ------------------------------------------------------------ wire client


def submit(host: str, port: int, job_id: str, nworkers: int,
           elastic: bool = False, timeout: float = 10.0,
           sched_class: Optional[int] = None,
           weight: Optional[float] = None) -> dict:
    """Submit a job to a running tracker over the ``submit`` wire
    command. Returns the tracker's JSON verdict immediately:
    ``{"ok": 1, ...}`` admitted, ``{"ok": 0, "queued": 1,
    "retry_after_ms": n}`` parked FIFO, ``{"ok": 0, "shed": 1,
    "retry_after_ms": n}`` shed — the tracker never stalls a
    submitter. ``sched_class``/``weight`` default to the
    ``rabit_sched_class``/``rabit_sched_weight`` knobs and ride the
    payload only when non-default, so an unconfigured submit is
    byte-identical to the pre-scheduler wire."""
    import struct

    from ..utils import retry
    from .tracker import MAGIC, _recv_str, _send_str, _send_u32
    doc = {"job": str(job_id), "nworkers": int(nworkers),
           "elastic": bool(elastic)}
    _class_knob = globals()["sched_class"]  # the parameter shadows it
    cls = sched_class if sched_class is not None else _class_knob()
    w = weight if weight is not None else sched_weight()
    if cls:
        doc["sched_class"] = int(cls)
    if w != SCHED_WEIGHT_DEFAULT:
        doc["weight"] = float(w)
    payload = json.dumps(doc)
    with retry.connect_with_retry(host, int(port),
                                  timeout=timeout) as conn:
        conn.sendall(struct.pack("<I", MAGIC))
        _send_str(conn, "submit")
        _send_str(conn, str(job_id))
        _send_u32(conn, 0)
        _send_str(conn, payload)
        verdict = json.loads(_recv_str(conn))
    from ..telemetry import clock
    clock.merge_from_doc(verdict)   # HLC piggyback
    return verdict


def submit_blocking(host: str, port: int, job_id: str, nworkers: int,
                    elastic: bool = False, max_wait_s: float = 60.0,
                    sleep=None) -> dict:
    """Backoff-and-retry wrapper over :func:`submit` for launchers
    (``tracker.launch --submit``): honors the tracker's
    ``retry_after_ms`` hint until admitted or ``max_wait_s`` lapses.
    Raises TimeoutError when the budget runs out — shed is a verdict
    to surface, never an infinite stall."""
    import time as _time
    _sleep = _time.sleep if sleep is None else sleep
    deadline = _time.monotonic() + max_wait_s
    while True:
        resp = submit(host, port, job_id, nworkers, elastic=elastic)
        if resp.get("ok"):
            return resp
        wait_ms = int(resp.get("retry_after_ms",
                               RETRY_AFTER_MS_DEFAULT))
        if _time.monotonic() + wait_ms / 1e3 > deadline:
            raise TimeoutError(
                f"job {job_id!r} not admitted within {max_wait_s}s "
                f"(last verdict: {resp})")
        _sleep(wait_ms / 1e3)


# ---------------------------------------------- raw wire test helpers
# Used by the --smoke below and the tests: a registration is just bytes
# on a socket, so they drive a real tracker without workers or a native
# build.


def wire_register(host: str, port: int, task: str,
                  addr: str = "127.0.0.1", link_port: int = 9100):
    """Open a raw ``start`` registration for ``task``: returns the
    connected socket with the full preamble sent. Pair with
    :func:`wire_read_assignment` to consume the tracker's reply."""
    import socket
    import struct

    from .tracker import MAGIC
    c = socket.create_connection((host, int(port)), timeout=10)
    c.settimeout(30)
    c.sendall(struct.pack("<I", MAGIC))
    for s in ("start", task):
        b = s.encode()
        c.sendall(struct.pack("<I", len(b)) + b)
    c.sendall(struct.pack("<I", 0))
    b = addr.encode()
    c.sendall(struct.pack("<I", len(b)) + b)
    c.sendall(struct.pack("<I", int(link_port)))
    c.sendall(struct.pack("<I", 0))
    c.sendall(struct.pack("<I", 0))  # empty uds_token
    return c


def wire_read_assignment(c) -> Tuple[int, int, int]:
    """Consume one assignment reply from a :func:`wire_register`
    socket, ack ready, close. Returns ``(rank, world, epoch)``."""
    import struct

    def u32():
        out = b""
        while len(out) < 4:
            chunk = c.recv(4 - len(out))
            assert chunk, "tracker closed mid-assignment"
            out += chunk
        return struct.unpack("<I", out)[0]

    def skip_str():
        n = u32()
        got = 0
        while got < n:
            got += len(c.recv(n - got))

    rank, world, epoch = u32(), u32(), u32()
    skip_str(); u32(); u32(); u32()
    for _ in range(u32()):
        u32()
    u32(); u32()
    for _ in range(u32()):
        u32(); skip_str(); u32(); skip_str()
    u32()
    c.sendall(struct.pack("<I", 1))  # ready ack
    c.close()
    return rank, world, epoch


def wire_shutdown(host: str, port: int, task: str) -> None:
    """Send one clean ``shutdown`` for ``task`` and wait for the ack."""
    import socket
    import struct

    from .tracker import MAGIC
    c = socket.create_connection((host, int(port)), timeout=10)
    c.sendall(struct.pack("<I", MAGIC))
    for s in ("shutdown", task):
        b = s.encode()
        c.sendall(struct.pack("<I", len(b)) + b)
    c.sendall(struct.pack("<I", 0))
    c.recv(4)
    c.close()


# ---------------------------------------------------------------- smoke


def _smoke() -> None:
    """``python -m rabit_tpu_torch.tracker.jobs --smoke``: two in-process
    jobs through ONE tracker — independent ranks, independent epochs — plus the
    admission-control verdicts: a third job past ``rabit_max_jobs``
    queues, a fourth past the queue depth is shed, and closing a live
    job admits the queued one FIFO."""
    from .tracker import Tracker

    env_save = {k: os.environ.get(k) for k in
                (MULTI_JOB_ENV, MAX_JOBS_ENV, ADMISSION_QUEUE_ENV)}
    os.environ[MULTI_JOB_ENV] = "1"
    os.environ[MAX_JOBS_ENV] = "2"
    os.environ[ADMISSION_QUEUE_ENV] = "1"

    def register(tr, task):
        return wire_register(tr.host, tr.port, task)

    read_assignment = wire_read_assignment

    def shut(tr, task):
        wire_shutdown(tr.host, tr.port, task)

    try:
        tr = Tracker(2).start()
        try:
            # two jobs, one tracker: both worlds form, epochs are
            # per-job (job B forming must not bump job A's epoch)
            assert submit(tr.host, tr.port, "jobA", 2)["ok"] == 1
            assert submit(tr.host, tr.port, "jobB", 2)["ok"] == 1
            conns = [register(tr, f"jobA{JOB_SEP}{i}") for i in range(2)]
            got = sorted(read_assignment(c) for c in conns)
            assert got == [(0, 2, 1), (1, 2, 1)], got
            conns = [register(tr, f"jobB{JOB_SEP}{i}") for i in range(2)]
            got = sorted(read_assignment(c) for c in conns)
            assert got == [(0, 2, 1), (1, 2, 1)], got
            ja, jb = tr.job("jobA"), tr.job("jobB")
            assert ja is not jb and ja.status == jb.status == "live"
            assert ja._epoch == 1 and jb._epoch == 1

            # admission: cap is 2 open jobs -> jobC queues (FIFO pos
            # 0), jobD overflows the depth-1 queue -> shed. Neither
            # stalls: both verdicts answer immediately.
            v = submit(tr.host, tr.port, "jobC", 1)
            assert v.get("queued") == 1 and v["retry_after_ms"] > 0, v
            v = submit(tr.host, tr.port, "jobD", 1)
            assert v.get("shed") == 1 and v["retry_after_ms"] > 0, v

            # closing jobA admits the queued jobC FIFO; its resubmit
            # is now an idempotent ok
            for i in range(2):
                shut(tr, f"jobA{JOB_SEP}{i}")
            deadline = 50
            while tr.job("jobC") is None and deadline:
                import time
                time.sleep(0.05)
                deadline -= 1
            assert tr.job("jobC") is not None, "queued job not admitted"
            assert tr.job("jobA").status == "closed"
            assert submit(tr.host, tr.port, "jobC", 1)["ok"] == 1
            # jobB sailed through all of it untouched
            assert jb.status == "live" and jb.quarantined == 0
        finally:
            tr.stop()
    finally:
        for k, v in env_save.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print("multi-job smoke ok")


if __name__ == "__main__":
    import sys
    if "--smoke" in sys.argv:
        _smoke()
    else:
        print(__doc__)
