"""Elastic world membership: the port's copy of
``rabit_tpu/tracker/membership.py``, whole.

The tracker is the membership authority of a live job: it evicts dead
ranks so that the survivors re-form at world N-1 within one
failure-detection deadline, and re-admits late joiners back to N at the
next epoch boundary, without a cold restart of anyone (the answer of
"Highly Available Data Parallel ML training on Mesh Networks",
arXiv:2011.03605).

State machine (``doc/fault_tolerance.md``, "Elastic membership")::

    live --(watchdog/poll evidence, `evict` command)--> evicting
    evicting --(survivors re-register, batch forms at N-1)--> resized
    resized --(`join` parked at the tracker)--> readmitting
    readmitting --(next epoch boundary, batch forms at N)--> live

Everything here is OFF unless ``rabit_elastic`` / ``RABIT_ELASTIC`` is
set: with it unset the tracker waits for the full fixed world exactly as
before (``tests/test_torch_elastic.py`` holds the bytes).

:class:`MembershipView` is the tracker-side state machine -- pure
bookkeeping, no locking (the port's tracker, ``tracker/tracker.py``,
calls it under its own lock and condition). Worker-side,
:func:`fetch_world` pulls the ``world`` wire command's membership doc
and :class:`MembershipMonitor` polls it so an engine can notice a parked
joiner and re-form in the job (no process restart) at a collective
boundary (``rabit_tpu_torch.resize``).

:func:`present_resume` speaks the ``resume`` command, which a tracker
resumed from its write-ahead log answers (``tracker/tracker.py``); the
monitor and the skew poller call it when the tracker comes back. The
monitor's miss first probes the pre-advertised hot standby
(``RABIT_TRACKER_STANDBY``, ``tracker/standby.py``) and follows it once
it has promoted.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Iterable, Optional, Set

_ELASTIC_ENV = "RABIT_ELASTIC"
_GRACE_ENV = "RABIT_JOIN_GRACE_MS"
_ON = ("1", "true", "yes", "on")

JOIN_GRACE_MS_DEFAULT = 60_000
# consecutive failed /summary scrapes of a previously-healthy endpoint
# before the poll loop treats the silence as a partition and evicts —
# scaled by the live plane's poll interval, so the effective deadline
# tracks the operator's chosen scrape cadence
EVICT_POLL_MISSES = 3


def elastic_enabled() -> bool:
    """Whether elastic membership may engage (``rabit_elastic``,
    exported as ``RABIT_ELASTIC``; default off — with it unset every
    code path below is dead and the fixed-world behavior is
    unchanged)."""
    return os.environ.get(_ELASTIC_ENV, "").strip().lower() in _ON


def join_grace_ms() -> int:
    """How long the tracker parks a joiner waiting for the next epoch
    boundary before bouncing its registration (the joiner retries) —
    ``rabit_join_grace_ms``, default {JOIN_GRACE_MS_DEFAULT} ms."""
    v = os.environ.get(_GRACE_ENV)
    if not v:
        return JOIN_GRACE_MS_DEFAULT
    try:
        return max(0, int(v))
    except ValueError:
        raise ValueError(
            f"{_GRACE_ENV} must be an integer (ms), got {v!r}")


def dense_slots(members: Iterable[int]) -> Dict[int, int]:
    """Stable rank -> dense collective slot for a (possibly holey)
    member set: schedules (ring/tree/bidir/swing/hier) are built over
    contiguous 0..world-1 slots, so an elastic world {0, 2, 3} runs
    its collectives as slots {0, 1, 2}. Identity when the member set
    is already contiguous from 0 — the fixed-world case."""
    return {r: i for i, r in enumerate(sorted(members))}


class MembershipView:
    """The tracker-side membership state machine for one live job.

    Pure bookkeeping — the tracker calls every mutator under its own
    lock. ``target`` is the admission ceiling (the launch-time world
    size); ``live`` is the stable-rank set of the last formed epoch;
    ``evicted`` ranks are out until re-admitted; ``joining`` ranks are
    parked at the tracker awaiting the next epoch boundary.
    ``generation`` bumps on every membership *decision* (evict, park,
    form) so pollers can cheaply detect "something changed"."""

    def __init__(self, target: int):
        self.target = int(target)
        self.live: Set[int] = set()
        self.evicted: Set[int] = set()
        self.joining: Set[int] = set()
        self.generation = 0
        self.evictions = 0
        self.admissions = 0

    # -- decisions --------------------------------------------------------
    def expected(self) -> Set[int]:
        """Ranks the NEXT registration batch must contain before it
        forms. Initial formation expects the full target world; after
        that, the survivors of the last formed world plus any parked
        joiners."""
        if not self.live:
            # nothing formed yet: the full target world, minus anyone
            # already evicted pre-formation, plus early joiners
            return (set(range(self.target)) - self.evicted) | self.joining
        return (self.live - self.evicted) | self.joining

    def evict(self, rank: int) -> bool:
        """Remove ``rank`` from the job (watchdog/poll evidence or the
        ``evict`` wire command). False if already out."""
        rank = int(rank)
        if rank in self.evicted:
            return False
        self.evicted.add(rank)
        self.live.discard(rank)
        self.joining.discard(rank)
        self.generation += 1
        self.evictions += 1
        return True

    def park(self, rank: int) -> bool:
        """Admit ``rank`` as a parked joiner: it will be handed a slot
        at the next epoch boundary, never mid-collective. False when
        the rank is already a live member (plain recovery, not a
        join)."""
        rank = int(rank)
        if rank in self.live and rank not in self.evicted:
            return False
        self.evicted.discard(rank)
        if rank not in self.joining:
            self.joining.add(rank)
            self.generation += 1
        return True

    def formed(self, ranks: Iterable[int]) -> Set[int]:
        """A registration batch completed assignment: ``ranks`` is the
        new live world. Returns the subset that was parked (the
        admissions this epoch)."""
        ranks = {int(r) for r in ranks}
        admitted = ranks & self.joining
        self.admissions += len(admitted)
        self.joining -= ranks
        self.live = ranks
        self.generation += 1
        return admitted

    # -- views ------------------------------------------------------------
    def world(self) -> int:
        """The live world size (target before first formation)."""
        return len(self.live) if self.live else len(self.expected())

    def doc(self, epoch: int) -> dict:
        """The ``world`` wire command's membership payload."""
        live = sorted(self.live)
        return {
            "epoch": int(epoch),
            "world": self.world(),
            "target": self.target,
            "live": live,
            "evicted": sorted(self.evicted),
            "joining": sorted(self.joining),
            "slots": {str(r): s for r, s in dense_slots(live).items()},
            "generation": self.generation,
            "elastic": True,
        }


# ------------------------------------------------------- worker side


def fetch_world(host: str, port: int, task_id: str = "0",
                timeout: float = 2.0) -> Optional[dict]:
    """Pull the tracker's membership doc (``world`` wire command, same
    rendezvous protocol as ``topo``/``skew``). Best-effort: returns
    None instead of raising — a tracker that predates the command or
    went away just means a fixed world."""
    from ..utils import retry
    from .tracker import MAGIC, _recv_str, _send_str, _send_u32
    try:
        with retry.connect_with_retry(
                host, int(port), timeout=timeout,
                deadline=retry.Deadline(timeout)) as conn:
            _send_u32(conn, MAGIC)
            _send_str(conn, "world")
            _send_str(conn, task_id)
            _send_u32(conn, 0)  # num_attempt (informational)
            doc = json.loads(_recv_str(conn))
        from ..telemetry import clock
        clock.merge_from_doc(doc)   # HLC piggyback
        return doc if isinstance(doc, dict) and doc else None
    except (OSError, ValueError, ConnectionError, retry.RetryError):
        return None


# This worker's last formed (task_id, stable_rank, epoch) — the
# identity it re-presents to a RESUMED tracker over the ``resume``
# wire handshake. Engines stamp it after every successful
# registration; None until the first world forms.
_identity_lock = threading.Lock()
_identity: Optional[tuple] = None


def note_identity(task_id: str, rank: int, epoch: int) -> None:
    """Record this worker's formed identity (engine post-registration
    hook) so reconnecting pollers can re-present it to a resumed
    tracker without a full re-registration."""
    global _identity
    with _identity_lock:
        _identity = (str(task_id), int(rank), int(epoch))


def identity() -> Optional[tuple]:
    with _identity_lock:
        return _identity


def present_resume(host: Optional[str] = None,
                   port: Optional[int] = None,
                   timeout: float = 2.0) -> bool:
    """Re-present this worker's ``(task_id, stable_rank, epoch)`` to a
    (possibly resumed) tracker over the ``resume`` wire command. True
    when the tracker reconciled the identity against its replayed WAL.
    Best-effort and cheap: called from reconnecting pollers on a
    dead->alive transition, never the dispatch path."""
    ident = identity()
    if ident is None:
        return False
    task_id, rank, epoch = ident
    if host is None:
        host = os.environ.get("RABIT_TRACKER_URI", "")
    if port is None:
        port = int(os.environ.get("RABIT_TRACKER_PORT", 0) or 0)
    if not host or not port:
        return False
    from ..utils import retry
    from .tracker import MAGIC, _recv_all, _send_str, _send_u32
    import struct
    try:
        with retry.connect_with_retry(
                host, int(port), timeout=timeout,
                deadline=retry.Deadline(timeout)) as conn:
            _send_u32(conn, MAGIC)
            _send_str(conn, "resume")
            _send_str(conn, task_id)
            _send_u32(conn, 0)  # num_attempt (informational)
            _send_str(conn, json.dumps({"rank": rank, "epoch": epoch}))
            ok = struct.unpack("<I", _recv_all(conn, 4))[0]
        return ok == 1
    except (OSError, ValueError, ConnectionError, retry.RetryError):
        return False


class MembershipMonitor:
    """Worker-side cache of the tracker's membership view.

    A daemon poller refreshes the doc every ``poll_s``;
    :meth:`reformation_due` is what an engine checks at a collective
    boundary: True when the tracker has made a membership decision
    (generation advance with a parked joiner or an eviction) since the
    generation this worker last formed at — the worker should tear
    down and re-register so the next epoch boundary can resize the
    world. Reads only ever touch the cache, so a dead tracker can
    never stall a dispatch."""

    def __init__(self, host: Optional[str] = None,
                 port: Optional[int] = None, task_id: str = "0"):
        if host is None:
            host = os.environ.get("RABIT_TRACKER_URI", "")
        if port is None:
            port = int(os.environ.get("RABIT_TRACKER_PORT", 0) or 0)
        self.host, self.port, self.task_id = host, int(port), task_id
        self._lock = threading.Lock()
        self._doc: Optional[dict] = None
        self._formed_generation = 0
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # consecutive failed refreshes: past RECONNECT_MISSES the
        # tracker is considered dead, and the next success is a
        # dead->alive transition worth a `resume` re-present
        self._misses = 0

    def current(self) -> Optional[dict]:
        with self._lock:
            return None if self._doc is None else dict(self._doc)

    def note_formed(self) -> None:
        """Record the generation this worker's world formed at (called
        right after a successful registration): only decisions NEWER
        than this are grounds for re-formation."""
        doc = self.refresh()
        with self._lock:
            self._formed_generation = (doc or {}).get(
                "generation", self._formed_generation)

    RECONNECT_MISSES = 3

    def refresh(self) -> Optional[dict]:
        if not (self.host and self.port):
            return None
        doc = fetch_world(self.host, self.port, self.task_id)
        if doc is None:
            # hot-standby failover: before counting the miss
            # toward an outage, try the pre-advertised standby address —
            # a promoted standby serving the world doc IS the tracker
            # now (pre-promotion its port refuses instantly, so this
            # probe is cheap and the miss stands)
            from ..utils import retry as _retry
            sb = _retry.parse_hostport(
                os.environ.get("RABIT_TRACKER_STANDBY"))
            if sb is not None and sb != (self.host, self.port):
                sb_doc = fetch_world(sb[0], sb[1], self.task_id)
                if sb_doc is not None:
                    self.host, self.port = sb
                    with self._lock:
                        self._misses = 0
                        self._doc = sb_doc
                    present_resume(self.host, self.port)
                    return sb_doc
            with self._lock:
                self._misses += 1
            return None
        with self._lock:
            was_dead = self._misses >= self.RECONNECT_MISSES
            self._misses = 0
            self._doc = doc
        if was_dead:
            # the tracker came back — possibly a resumed incarnation
            # that replayed its WAL: re-present our formed
            # identity so it reconciles us without re-registration
            present_resume(self.host, self.port)
        return doc

    def reformation_due(self) -> bool:
        with self._lock:
            doc = self._doc
            formed = self._formed_generation
        if not doc:
            return False
        # a parked joiner or a fresh eviction the formed world has not
        # absorbed yet — either way the next epoch boundary resizes
        return bool(doc.get("generation", 0) > formed
                    and (doc.get("joining") or doc.get("evicted")))

    def start_poller(self, poll_s: float = 1.0) -> "MembershipMonitor":
        if self._thread is not None and self._thread.is_alive():
            return self
        self._stop.clear()

        def loop():
            while not self._stop.wait(poll_s):
                self.refresh()

        self._thread = threading.Thread(
            target=loop, name="rabit-membership-poll", daemon=True)
        self._thread.start()
        return self

    def stop_poller(self) -> None:
        self._stop.set()


_monitor = MembershipMonitor()


def monitor() -> MembershipMonitor:
    return _monitor


def epoch_reset(world: int) -> None:
    """Re-arm worker-side membership state for a newly formed epoch of
    ``world`` ranks (the R002 epoch-reset hook): the cached doc is
    stale the moment the world re-forms, and the formed generation
    baseline must advance so the *last* transition stops reading as
    "re-formation due"."""
    del world  # the monitor re-learns the live set from the tracker
    global _monitor
    _monitor.stop_poller()
    fresh = MembershipMonitor()
    fresh.note_formed()
    _monitor = fresh


# ------------------------------------------------------------- CI smoke


def _smoke() -> None:
    """A 2-rank elastic world
    against a LIVE tracker — scripted evict shrinks it to 1, a
    re-admission grows it back to 2, and the membership doc, counters,
    and epoch advance observably at each transition."""
    import socket
    import struct
    import time

    os.environ[_ELASTIC_ENV] = "1"
    from .tracker import MAGIC, Tracker, _recv_all

    def _send_u32(c, v):
        c.sendall(struct.pack("<I", v))

    def _send_str(c, s):
        b = s.encode()
        _send_u32(c, len(b))
        c.sendall(b)

    def _recv_u32(c):
        return struct.unpack("<I", _recv_all(c, 4))[0]

    def _recv_str(c):
        return _recv_all(c, _recv_u32(c)).decode()

    def register(tr, task, cmd="start"):
        c = socket.create_connection(  # noqa: R001 - smoke-only client
            (tr.host, tr.port), timeout=10)
        c.settimeout(30)
        _send_u32(c, MAGIC)
        _send_str(c, cmd)
        _send_str(c, task)
        _send_u32(c, 0)
        _send_str(c, "127.0.0.1")
        _send_u32(c, 9000 + int(task))
        _send_u32(c, 0)   # flags: no data plane
        _send_str(c, "")  # no UDS twin
        return c

    def read_assignment(c):
        rank = _recv_u32(c)
        world = _recv_u32(c)
        epoch = _recv_u32(c)
        _recv_str(c)      # coord_host
        _recv_u32(c)      # coord_port
        _recv_u32(c)      # single_host
        _recv_u32(c)      # parent (NO_RANK when none)
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

    def command(tr, cmd, payload=None):
        c = socket.create_connection(  # noqa: R001 - smoke-only client
            (tr.host, tr.port), timeout=10)
        _send_u32(c, MAGIC)
        _send_str(c, cmd)
        _send_str(c, "smoke")
        _send_u32(c, 0)
        if payload is not None:
            _send_str(c, payload)
            out = _recv_u32(c)
        else:
            out = json.loads(_recv_str(c))
        c.close()
        return out

    tracker = Tracker(2, elastic=True).start()
    try:
        # initial formation at the target world
        conns = [register(tracker, str(i)) for i in range(2)]
        got = sorted(read_assignment(c) for c in conns)
        assert got == [(0, 2, 1), (1, 2, 1)], got

        # evict rank 1 (scripted watchdog evidence) -> world view 1
        assert command(tracker, "evict",
                       json.dumps({"rank": 1, "reason": "smoke"})) == 1
        doc = command(tracker, "world")
        assert doc["evicted"] == [1] and doc["generation"] >= 1, doc

        # the survivor re-forms alone at world 1 within one epoch
        rank, world, epoch = read_assignment(
            register(tracker, "0", cmd="recover"))
        assert (rank, world, epoch) == (0, 1, 2), (rank, world, epoch)

        # re-admission: the joiner parks, the survivor's next
        # re-registration forms the grown world at the epoch boundary
        joiner = register(tracker, "1", cmd="join")
        deadline = time.monotonic() + 10
        while command(tracker, "world").get("joining") != [1]:
            assert time.monotonic() < deadline, "joiner never parked"
            time.sleep(0.02)
        survivor = register(tracker, "0", cmd="recover")
        a = read_assignment(survivor)
        b = read_assignment(joiner)
        assert sorted([a, b]) == [(0, 2, 3), (1, 2, 3)], (a, b)

        doc = command(tracker, "world")
        assert doc["world"] == 2 and doc["evicted"] == [], doc
        assert tracker._member.evictions == 1, tracker._member.evictions
        assert tracker._member.admissions == 1, tracker._member.admissions
    finally:
        tracker.stop()
    print("elastic smoke ok")


if __name__ == "__main__":
    import sys
    if "--smoke" in sys.argv:
        _smoke()
    else:
        print(__doc__)
