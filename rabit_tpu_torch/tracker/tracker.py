"""Rendezvous tracker: the port's copy of the registration path of
``rabit_tpu/tracker/tracker.py``, on the same wire protocol.

It assigns stable ranks (task_id -> rank survives restarts, the basis of
fail-restart-and-catch-up recovery), computes the tree + ring topology,
barriers each (re)registration epoch so every worker is listening before
link wiring starts, and relays ``print``/``shutdown``/``topo`` commands.
Where the JAX package's tracker hosts a JAX coordination service for an
epoch whose workers register a data plane, this one hosts a
``torch.distributed.TCPStore``: the rendezvous of that epoch's torch world
(``engine/dataplane.py``). It lives in the tracker process, so it
outlives any worker. A store is reaped once a newer epoch has been acked
by every member and every member of the store's own epoch has acked a
newer one: the data plane drops its world before it acks, so no client
of the store is left then. A member evicted while its process lives on
(the in-process ``resize("join")``) still holds its old world until its
own re-registration tears it down, so its epoch's store stays until it
has acked a newer epoch.

Wire protocol (binary, little-endian, length-prefixed strings):
  worker -> tracker: magic u32 0x52425401, cmd str, task_id str,
                     num_attempt u32
    start/recover/join: + host str, listen_port u32, flags u32 (bit 0:
                   the worker will register a data plane — the tracker
                   hosts the epoch's store), uds_token str (random name
                   of the worker's abstract-UDS listener twin; "" =
                   TCP-only); ``join`` parks the worker until the next
                   epoch boundary (elastic only; otherwise a plain
                   registration)
    print:         + msg str
    topo:          (no extra fields) tracker -> worker: a JSON str
                   {"epoch","groups","delegates","single_host"} of the
                   host topology at the last assignment ("{}" before it)
    world:         (no extra fields) tracker -> worker: a JSON str, the
                   membership doc (``membership.MembershipView.doc``; a
                   static fixed-world doc when elastic is off)
    evict:         + JSON str {"rank","reason"}; tracker -> worker: u32 1
                   when the rank left the job, 0 otherwise (elastic off,
                   out of range, already out)
    metrics:       + summary str (a rank's ``telemetry_summary`` JSON,
                   ``telemetry.ship_to_tracker``), kept by task id;
                   tracker -> worker: u32 1 (0 for a payload that is not
                   a JSON object)
    endpoint:      + JSON str {"host","port","rank"}: where the rank's
                   metrics endpoint listens (``live.announce_endpoint``);
                   tracker -> worker: u32 1 (0 for a malformed payload)
    skew:          (no extra fields) tracker -> worker: a JSON str, the
                   fleet skew digest {"epoch","offsets_ms","laggard"}
                   ("{}" before the poll loop's first election)
    resume:        + JSON str {"rank","epoch"}: a live worker re-presents
                   its identity to a (possibly resumed) tracker;
                   tracker -> worker: u32 1 when it agrees with the
                   replayed journal (or was adopted), 0 on a
                   contradiction (the worker should re-register)
    shutdown:      (no extra fields) tracker -> worker: u32 1
  tracker -> worker (start/recover/join): rank u32, world u32, epoch u32,
    coord_host str, coord_port u32 (this epoch's store; ""/0 when none is
    hosted), single_host u32, parent u32 (0xFFFFFFFF = none), ntree u32 +
    tree neighbor ranks, ring_prev u32, ring_next u32, nconnect u32 +
    (peer_rank u32, host str, port u32, uds_token str)..., naccept u32;
    the worker replies ready u32 after wiring its links.
Workers connect to lower-ranked neighbors and accept from higher ranks.
The epoch counts completed registration batches: every live worker
re-registers in the same batch during recovery, so all members of a
batch observe the same epoch.

Elastic membership (``elastic``, else ``RABIT_ELASTIC``; off by default,
and then every byte on the wire is as without it): one
``membership.MembershipView`` on the tracker, mutated under the
tracker's lock. A batch forms once every EXPECTED rank is pending (the
survivors of the last formed world plus the parked joiners), so an
eviction (the ``evict`` command, or the poll loop's evidence: an
endpoint that answered before and stayed silent for
``membership.EVICT_POLL_MISSES`` sweeps) completes a batch of survivors
at once; the assignment's ``rank`` is the member's dense slot
(``membership.dense_slots``) and ``world`` the batch's size. A new task
id arriving when the target world is full adopts the lowest evicted
stable rank; a joiner (``join``, an evicted rank, or a rank outside the
live set) is parked until the next epoch boundary and bounced after
``rabit_join_grace_ms`` (its connection thread waits on the tracker's
condition). Every transition counts ``membership.<kind>``, records a
zero-length ``membership.transition`` span, leaves a flight note and
emits a ``membership.evict``/``membership.admit`` event (the JAX
tracker's ``_note_transition``); ``/metrics`` adds ``rabit_world_size``,
``rabit_member_evictions_total`` and ``rabit_member_admissions_total``.

At the end of the run (every live rank sent ``shutdown``, or the
launcher's ``print_fleet_metrics`` once its workers have exited, for
engines such as ``TorchEngine`` that do not register) the tracker merges
the summaries it received (``merged_metrics``, the port's
``telemetry.aggregate``) and prints the fleet table, once.

The live plane (``metrics_port``, else ``RABIT_METRICS_PORT``; off when
neither is set, 0 picks a free port): a ``telemetry.live.MetricsServer``
serves ``/metrics`` (every polled rank's counters, labelled by rank,
and the tracker's gauges: endpoints, poll sweeps, the host topology,
the straggler, the skew digest and, elastic, the membership), ``/healthz``,
``/summary`` (the merged fleet document), ``/straggler`` and ``/slo``; a
poll thread scrapes each announced endpoint's ``/summary`` every
``RABIT_METRICS_POLL_MS`` (``live.poll_interval_s``) into the same
per-task dict the end-of-run merge reads, builds
``crossrank.straggler_snapshot`` from it, folds the snapshot's digest
through one ``skew.FleetElection`` and serves the result over the
``skew`` command, and prints a straggler line every five sweeps while
someone is behind (the JAX tracker's single-job poll loop,
``tracker.py:1785-1866``).

The write-ahead log (``wal_dir``, else ``RABIT_TRACKER_WAL_DIR``; off
when neither is set, and then nothing is journaled and every byte on the
wire is as without it): every control-plane transition goes through
``_wal`` (``tracker/wal.py``) BEFORE it takes effect, under the tracker's
lock -- ``assign``, ``epoch``, ``topo``, ``park``, ``evict``,
``endpoint``, ``skew``, ``down``, ``resume``, ``lease`` and
``promoted``, the JAX tracker's single-job records byte for byte. ``resume=True`` replays the journal
(``fold_records``'s fold, shared with ``wal.py --compact``), counts the
restart, journals ``resume`` and opens the resume grace
(``rabit_tracker_resume_grace_ms``): while it lasts the poll loop takes
no silence as eviction evidence, since every worker's poller is still
reconnecting. ``RABIT_WAL_SNAPSHOT_EVERY`` compacts the journal into a
snapshot off the registration path. ``crash()`` is a kill without the
process exit: the listener, the threads and every connection die,
nothing is flushed or reaped (the journal handle and the epochs' stores
stay as they are). ``python -m rabit_tpu_torch.tracker.tracker -n N
[--host H] [--port P] [--wal-dir D] [--resume D]`` runs one standalone;
pin ``--host``/``--port`` to a dead tracker's address to resume it in
place, so the environment the workers were launched with stays valid.

The hot standby's half of the leader (``lease_ms``, with a WAL; the
launcher sets it with ``RABIT_TRACKER_STANDBY``, its width
``RABIT_LEASE_MS``): the leader journals its lease claim and heartbeats
a renewal every third of a lease; ``repl`` (+ the follower's last
durable seq u32; tracker -> follower: u32 1, or 0 without a WAL, then
every journaled record's frame from that seq on, one u32 ack a record
back, and seq-0 lease heartbeats between them, unacked) streams the
journal to ``tracker/standby.py``, which promotes itself into a
``resume=True`` tracker once a lease passes in silence. An idempotent
renewal stays out of the journal. ``/healthz`` then says
``tracker_role``, ``node`` and ``promoted``, and ``/metrics`` adds
``rabit_tracker_role``, ``rabit_repl_acked_seq``,
``rabit_repl_lag_records``, ``rabit_failover_duration_ms`` (once
promoted) and the SLO burn gauges. With ``lease_ms`` unset nothing of it
exists, and every byte on the wire and in the journal is as without it.
``link_rewrite(peer_rank, host, port)`` rewrites the peer addresses an
assignment advertises (the launcher's chaos link proxies).

The causal incident plane (``rabit_events``, i.e. ``RABIT_EVENTS`` in
the tracker's process; off when unset, and then none of it exists and
every byte on the wire and in the journal is as without it): the
tracker's clock takes the node ``tracker:<node>``; each worker summary
that arrives (``metrics``, or a poll scrape of ``/summary``) has its
event ring folded into one fleet event log, deduplicated by the task's
``seq``, with the worker's HLC merged into the tracker's; the tracker's
own events (``tracker.resume``, ``membership.*``, ``slo.*``) and every
other record of its process's ring (the launcher's chaos proxies, a hot
standby's ``tracker.promoted``) are folded in as source ``tracker``.
Once a poll pass, even when no endpoint answered, the incident sweep
emits an ``slo.<state>`` event on each edge of the tracker's own
objectives, correlates each warn or violating verdict and each unseen
``watchdog.abort`` against the log (``telemetry/incident.py``) and dumps
each newly opened incident into the flight directory. The live plane
adds ``/events`` (the log in HLC order) and ``/incidents`` (the open
incidents and the recent ones) and the gauges ``rabit_open_incidents``
and ``rabit_events_dropped_total``; the ``topo``, ``skew`` and
``world`` replies carry the tracker's ``hlc`` (never a u32 reply). The
JAX tracker's ``tracker.py:1616-1760`` and ``:1982-1992``.

Any other command closes the connection. Not ported yet (the JAX
package's tracker has them): multi-job (``submit``, the per-job state
and its journal records) with the autoscaler.
"""

from __future__ import annotations

import datetime
import json
import os
import socket
import struct
import sys
import threading
import time
from collections import deque
from typing import Deque, Dict, List, Optional, Tuple

from . import membership as _membership
from . import wal as _wal_mod
from ..telemetry import clock as _clock
from ..telemetry import events as _events
from ..telemetry import incident as _incident
from ..telemetry.aggregate import format_fleet_table, merge_summaries

MAGIC = 0x52425401
NO_RANK = 0xFFFFFFFF
FLAG_DATAPLANE = 1  # registration flags bit 0
# a wire string longer than this is a protocol violation, not a payload
_MAX_WIRE_STR = 16 << 20
# how long a connection may take to send its request
_REQUEST_TIMEOUT_S = 60.0


def _recv_all(conn: socket.socket, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = conn.recv(n - len(out))
        if not chunk:
            raise ConnectionError("worker closed connection")
        out += chunk
    return out


def _recv_u32(conn) -> int:
    return struct.unpack("<I", _recv_all(conn, 4))[0]


def _recv_str(conn) -> str:
    n = _recv_u32(conn)
    if n > _MAX_WIRE_STR:
        raise ConnectionError(f"wire string claims {n} bytes")
    return _recv_all(conn, n).decode()


def _send_u32(conn, v: int) -> None:
    conn.sendall(struct.pack("<I", v))


def _send_str(conn, s: str) -> None:
    b = s.encode()
    _send_u32(conn, len(b))
    conn.sendall(b)


def _pack_u32(buf: bytearray, v: int) -> None:
    buf += struct.pack("<I", v)


def _pack_str(buf: bytearray, s: str) -> None:
    b = s.encode()
    buf += struct.pack("<I", len(b))
    buf += b


def tree_neighbors(rank: int, world: int) -> Tuple[Optional[int], List[int]]:
    """Complete binary tree: parent + children of ``rank``."""
    parent = (rank - 1) // 2 if rank > 0 else None
    children = [c for c in (2 * rank + 1, 2 * rank + 2) if c < world]
    return parent, children


def _drop(conn: socket.socket) -> None:
    """Close a connection hard: ``shutdown`` first, which wakes a thread
    blocked on it (a listener's ``accept`` too); a bare ``close`` wakes
    neither, and a closed listener would go on accepting."""
    try:
        conn.shutdown(socket.SHUT_RDWR)
    except OSError:
        pass
    conn.close()


def _default_ready_timeout() -> float:
    """``rabit_tracker_ready_timeout``: how long ``_assign`` waits for
    each worker's ready ack before declaring the epoch partially
    failed."""
    try:
        return float(os.environ.get("RABIT_TRACKER_READY_TIMEOUT", 60.0))
    except ValueError:
        return 60.0


RESUME_GRACE_MS_DEFAULT = 15_000
LEASE_MS_DEFAULT = 2_000
REPL_ACK_TIMEOUT_MS_DEFAULT = 1_000

# the JAX package's implicit job: a snapshot names the one world by it
DEFAULT_JOB = "default"


def default_lease_ms() -> int:
    """``rabit_lease_ms``: the leadership lease's length. The leader
    heartbeats a renewal every third of it; a hot standby promotes only
    after a full lease of silence from the leader, so this bounds the
    failover time from above."""
    v = os.environ.get("RABIT_LEASE_MS")
    if not v:
        return LEASE_MS_DEFAULT
    try:
        return max(100, int(v))
    except ValueError:
        raise ValueError(
            f"RABIT_LEASE_MS must be an integer (ms), got {v!r}")


def repl_ack_timeout_ms() -> int:
    """``rabit_repl_ack_timeout_ms``: how long the leader waits for a
    follower's ack of one record before dropping that subscriber (which
    resubscribes from its last durable seq)."""
    v = os.environ.get("RABIT_REPL_ACK_TIMEOUT_MS")
    if not v:
        return REPL_ACK_TIMEOUT_MS_DEFAULT
    try:
        return max(50, int(v))
    except ValueError:
        raise ValueError(
            f"RABIT_REPL_ACK_TIMEOUT_MS must be an integer (ms), "
            f"got {v!r}")


def resume_grace_ms() -> int:
    """``rabit_tracker_resume_grace_ms``: how long a resumed tracker
    waives poll-miss eviction evidence while worker pollers reconnect --
    a brief tracker outage must never evict healthy ranks."""
    v = os.environ.get("RABIT_TRACKER_RESUME_GRACE_MS")
    if not v:
        return RESUME_GRACE_MS_DEFAULT
    try:
        return max(0, int(v))
    except ValueError:
        raise ValueError(
            f"RABIT_TRACKER_RESUME_GRACE_MS must be an integer (ms), "
            f"got {v!r}")


# -- the journal's read side ------------------------------------------------
# One fold for both consumers: ``Tracker(resume=True)`` and snapshot
# compaction (live, and ``wal.py --compact`` through ``fold_records``), so
# compacted state cannot drift from replayed state. The JAX package's
# fold (``rabit_tpu/tracker/tracker.py:383-536``) restricted to the one
# job this tracker serves: a journal of the JAX tracker's multi-job plane
# raises rather than replay part of its history.

_REPLAYED = frozenset({"assign", "epoch", "park", "evict", "topo", "skew",
                       "endpoint", "down", "resume", "promoted",
                       _wal_mod.LEASE_KIND})


class _ReplayWorld:
    """The state ``_replay_apply`` and ``snapshot_state`` touch, without
    the sockets and threads of a real tracker (offline folds)."""

    def __init__(self, nworkers: int, elastic: bool):
        self.nworkers = int(nworkers)
        self.elastic = bool(elastic)
        self.restarts = 0
        self._ranks: Dict[str, int] = {}
        self._epoch = 0
        self._member = (_membership.MembershipView(self.nworkers)
                        if self.elastic else None)
        self._topo: dict = {}
        self._skew: dict = {}
        self._skew_election = None
        self._endpoints: Dict[str, dict] = {}
        self._shutdown_ranks: set = set()
        self.promoted_wall = 0.0
        self.promoted_mono = 0.0
        self.failover_duration_ms = 0.0
        self._lease: Optional[dict] = None
        self._journaled_lease: Optional[dict] = None


def snapshot_state(world) -> dict:
    """``world``'s replay-reachable state as a ``wal_snapshot/v1`` doc,
    the JAX tracker's ``snapshot_state`` of a single-job tracker field
    for field (its scheduler fields at their defaults): ranks, epoch,
    membership, topology, skew, endpoints, shutdown ranks, restarts, a
    promotion and the journaled lease -- nothing ephemeral (pending
    registrations, sockets and stores die with the process). The caller
    holds a live tracker's lock."""
    jd: Dict[str, object] = {
        "nworkers": world.nworkers, "elastic": world.elastic,
        "sched_class": 0, "weight": 1.0, "quota": world.nworkers,
        "preempted": 0, "closed": False, "closed_reason": "",
        "ranks": dict(world._ranks), "epoch": world._epoch,
        "topo": dict(world._topo), "skew": dict(world._skew),
        "endpoints": {t: dict(d) for t, d in world._endpoints.items()},
        "down": sorted(world._shutdown_ranks)}
    if world.elastic and world._member is not None:
        mv = world._member
        jd["member"] = {
            "target": mv.target, "live": sorted(mv.live),
            "evicted": sorted(mv.evicted), "joining": sorted(mv.joining),
            "generation": mv.generation, "evictions": mv.evictions,
            "admissions": mv.admissions}
    doc: Dict[str, object] = {"multi_job": False,
                              "restarts": int(world.restarts),
                              "jobs": {DEFAULT_JOB: jd}}
    if world.promoted_wall or world.failover_duration_ms:
        doc["promoted"] = {
            "wall": world.promoted_wall, "mono": world.promoted_mono,
            "failover_ms": world.failover_duration_ms}
    if world._journaled_lease is not None:
        doc["lease"] = dict(world._journaled_lease)
    return doc


def _replay_adopt_into(world, state: dict) -> None:
    """Adopt one ``wal_snapshot/v1`` doc: it replaces the journaled state,
    and the journal's tail then replays on top. The world's shape
    (nworkers, elastic) is the launch's, as a full replay never changes
    it."""
    from ..telemetry import skew as _skew_mod
    jobs = state.get("jobs") or {}
    if state.get("multi_job") or set(jobs) - {DEFAULT_JOB}:
        raise _wal_mod.WalError(
            "snapshot holds multi-job state, which this tracker does not "
            "serve")
    world.restarts = int(state.get("restarts", world.restarts))
    prom = state.get("promoted") or {}
    if prom:
        world.promoted_wall = float(prom.get("wall", 0.0))
        world.promoted_mono = float(prom.get("mono", 0.0))
        world.failover_duration_ms = float(prom.get("failover_ms", 0.0))
    lease = state.get("lease")
    if lease is not None:
        world._lease = dict(lease)
        world._journaled_lease = dict(lease)
    jd = jobs.get(DEFAULT_JOB) or {}
    if jd.get("closed"):
        raise _wal_mod.WalError("snapshot holds a closed job")
    world._ranks = {str(t): int(r)
                    for t, r in (jd.get("ranks") or {}).items()}
    world._epoch = int(jd.get("epoch", 0))
    world._topo = dict(jd.get("topo") or {})
    digest = dict(jd.get("skew") or {})
    if digest:
        world._skew = digest
        world._skew_election = _skew_mod.FleetElection.seeded(digest)
    world._endpoints = {str(t): dict(d) for t, d in
                        (jd.get("endpoints") or {}).items()}
    world._shutdown_ranks = {int(r) for r in jd.get("down") or []}
    m = jd.get("member")
    if world.elastic and world._member is not None and m:
        mv = world._member
        mv.target = int(m.get("target", world.nworkers))
        mv.live = {int(r) for r in m.get("live") or []}
        mv.evicted = {int(r) for r in m.get("evicted") or []}
        mv.joining = {int(r) for r in m.get("joining") or []}
        mv.generation = int(m.get("generation", 0))
        mv.evictions = int(m.get("evictions", 0))
        mv.admissions = int(m.get("admissions", 0))


def _replay_apply(world, kind: str, data: dict) -> None:
    """Apply one journaled ``(kind, data)`` record to ``world`` (a tracker
    under construction or a :class:`_ReplayWorld`). Raw mutations are
    deliberate: this IS the journal's read side."""
    from ..telemetry import skew as _skew_mod
    if kind == _wal_mod.SNAPSHOT_KIND:
        _replay_adopt_into(world, data.get("state") or {})
        return
    if kind not in _REPLAYED or \
            str(data.get("job", DEFAULT_JOB)) != DEFAULT_JOB:
        raise _wal_mod.WalError(
            f"journal record {kind!r} (job {data.get('job', DEFAULT_JOB)!r})"
            f" is not one this tracker serves")
    if kind == "assign":
        world._ranks[str(data["task"])] = int(data["rank"])
    elif kind == "epoch":
        world._epoch = int(data["epoch"])
        if world.elastic and world._member is not None:
            world._member.formed(data.get("members", []))
    elif kind == "park":
        if world.elastic and world._member is not None:
            world._member.park(int(data["rank"]))
    elif kind == "evict":
        if world.elastic and world._member is not None:
            world._member.evict(int(data["rank"]))
    elif kind == "topo":
        world._topo = dict(data.get("doc") or {})
    elif kind == "skew":
        digest = dict(data.get("digest") or {})
        world._skew = digest
        world._skew_election = _skew_mod.FleetElection.seeded(digest)
    elif kind == "endpoint":
        world._endpoints[str(data["task"])] = dict(data["doc"])
    elif kind == "down":
        world._shutdown_ranks.add(int(data["rank"]))
    elif kind == "resume":
        world.restarts = int(data.get("restarts", world.restarts))
    elif kind == "promoted":
        # a journaled failover outlives the promoted process: a later
        # resume keeps reporting the measured duration
        world.promoted_wall = float(data.get("wall", 0.0))
        world.promoted_mono = float(data.get("mono", 0.0))
        world.failover_duration_ms = float(data.get("failover_ms", 0.0))
    elif kind == _wal_mod.LEASE_KIND:
        world._lease = dict(data)
        world._journaled_lease = dict(data)


def fold_records(records, nworkers: int = 1, elastic: bool = False) -> dict:
    """Fold a replayed ``(kind, data)`` list into one ``wal_snapshot/v1``
    state doc (``wal.py --compact``). ``nworkers``/``elastic`` must match
    the tracker's launch, as ``--resume`` itself requires."""
    world = _ReplayWorld(nworkers, elastic)
    for kind, data in records:
        _replay_apply(world, kind, data)
    return snapshot_state(world)


class Tracker:
    def __init__(self, nworkers: int, host: str = "127.0.0.1", port: int = 0,
                 ready_timeout: Optional[float] = None,
                 metrics_port: Optional[int] = None,
                 elastic: Optional[bool] = None,
                 wal_dir: Optional[str] = None,
                 resume: bool = False,
                 link_rewrite=None,
                 lease_ms: Optional[int] = None,
                 node_id: str = "leader"):
        self.nworkers = nworkers
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(256)
        self.host, self.port = self.sock.getsockname()
        self._ready_timeout = (ready_timeout if ready_timeout is not None
                               else _default_ready_timeout())
        self._lock = threading.Lock()
        # the condition a parked joiner's connection thread waits on: a
        # formation, an eviction and stop() notify it
        self._cv = threading.Condition(self._lock)
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.messages: List[str] = []
        self._ranks: Dict[str, int] = {}
        self._pending: Dict[int, tuple] = {}
        self._epoch = 0
        self._shutdown_ranks: set = set()
        self._topo: dict = {}
        self._stores: List[tuple] = []   # (epoch, TCPStore, members)
        # stable rank -> the newest epoch it acked (the store reaping)
        self._acked: Dict[int, int] = {}
        # elastic membership (off unless asked for, or RABIT_ELASTIC):
        # with it off every batch is the full fixed world
        if elastic is None:
            elastic = _membership.elastic_enabled()
        self.elastic = bool(elastic)
        self._member = (_membership.MembershipView(nworkers)
                        if self.elastic else None)
        self._metrics: Dict[str, dict] = {}   # task id -> its summary
        self._fleet_printed = False
        # the live plane (off unless a metrics port is configured):
        # workers announce their endpoints (``endpoint``), the poll thread
        # scrapes them into _metrics and elects the fleet's laggard
        if metrics_port is None:
            raw = os.environ.get("RABIT_METRICS_PORT")
            metrics_port = int(raw) if raw not in (None, "") else None
        self._metrics_port = metrics_port
        self._metrics_server = None
        self._poll_thread: Optional[threading.Thread] = None
        self._poll_stop = threading.Event()
        self._poll_count = 0                   # completed poll sweeps
        self._endpoints: Dict[str, dict] = {}  # task id -> host, port, rank
        # task id -> consecutive failed scrapes (the poll loop's eviction)
        self._endpoint_misses: Dict[str, int] = {}
        self._skew: dict = {}                  # the served skew digest
        self._skew_election = None             # skew.FleetElection
        self._last_straggler: Optional[dict] = None
        # every connection the serve loop accepted and nobody closed yet:
        # crash() drops them all (a dead incarnation answers nothing)
        self._conns: set = set()
        self._conns_lock = threading.Lock()
        self.crashed = False
        # chaos hook: ``link_rewrite(peer_rank, host, port) -> (host,
        # port)`` rewrites the peer addresses an assignment advertises, so
        # worker-worker links route through fault-injection proxies; a
        # rewritten peer gets an empty uds_token (the UDS fast path would
        # bypass a TCP proxy)
        self._link_rewrite = link_rewrite
        # the hot standby's half of the leader: with ``lease_ms`` and a WAL
        # the leader journals its lease claim, heartbeats renewals every
        # lease_ms/3 and streams every journaled record to ``repl``
        # subscribers; with lease_ms unset none of this exists (no lease
        # record, no thread, no gauge)
        self.lease_ms = int(lease_ms) if lease_ms else None
        self.node_id = str(node_id)
        self.promoted = False
        # stamped by the standby at promotion: both clocks, and the
        # measured leader-silence -> promoted duration, journaled as a
        # ``promoted`` record so a later resume keeps reporting it
        self.promoted_wall = 0.0
        self.promoted_mono = 0.0
        self.failover_duration_ms = 0.0
        self._lease: Optional[dict] = None
        self._lease_thread: Optional[threading.Thread] = None
        # the replication side never takes self._lock: frames live under
        # their own condition (lock order: _lock, then _repl_cv), appended
        # by ``_wal`` and drained by each subscriber's connection thread.
        # Frame i carries seq _repl_base + i + 1; the base is constant for
        # the process (a live compaction appends its snapshot frame).
        self._repl_cv = threading.Condition()
        self._repl_log: List[bytes] = []
        self._repl_base = 0
        self._repl_subs: List[dict] = []
        self._repl_conns: set = set()   # stop() tears these streams
        # the newest lease heartbeat (a seq-0 frame) and a counter, so
        # each subscriber can tell a fresher one arrived
        self._repl_hb: Optional[bytes] = None
        self._repl_hb_n = 0
        # the lease doc last journaled: a renewal equal to it but for
        # until_ms stays out of the journal
        self._journaled_lease: Optional[dict] = None
        # the causal incident plane (off unless the process's event ring
        # is, i.e. RABIT_EVENTS): the fleet event log folded from the
        # workers' rings and this process's own, the incident book the
        # poll loop's sweep keeps, and the SLO states of the last sweep.
        # Set up before the journal opens: a resume emits into it.
        self._events_on = _events.enabled()
        self._fleet_events: Deque[dict] = deque(
            maxlen=4 * _events.stats()["capacity"])
        self._event_seen: Dict[str, int] = {}   # task id -> newest seq
        self._event_drops: Dict[str, int] = {}  # task id -> ring drops
        # a leaf lock over the fold cursors: never held while another
        # lock is taken
        self._events_fold_lock = threading.Lock()
        self._incidents = _incident.IncidentBook()
        self._incident_log: Deque[dict] = deque(maxlen=64)
        self._slo_prev: Dict[str, str] = {}
        if self._events_on:
            _clock.set_node(f"tracker:{node_id}")
        # the write-ahead log (off unless a directory is given, or
        # RABIT_TRACKER_WAL_DIR): every transition is journaled before it
        # takes effect; resume=True replays it and re-adopts a live world
        if wal_dir is None:
            wal_dir = os.environ.get(_wal_mod.WAL_DIR_ENV) or None
        self.wal_dir = wal_dir
        self._wal_log: Optional[_wal_mod.WriteAheadLog] = None
        self.restarts = 0                      # resumes of this journal
        self._grace_until = 0.0                # the resume grace's end
        self._resumed_ranks: set = set()       # ranks that re-presented
        self.replayed = 0                      # records the resume read
        self.replay_ms = 0.0                   # its open and fold
        self.journal_s = 0.0                   # time inside record()
        self._snap_every = _wal_mod.snapshot_every()
        self._snap_pending = False             # one compaction at a time
        if wal_dir is not None:
            t0 = time.perf_counter()
            self._wal_log = _wal_mod.WriteAheadLog(wal_dir)
            records = self._wal_log.open(resume=resume)
            # the replication log starts as the journal it opened, so a
            # subscriber can resync from any seq past the journal's base
            base = self._wal_log.base
            self._repl_base = base
            self._repl_log = [
                _wal_mod.encode_record(base + i + 1, kind, data)
                for i, (kind, data) in enumerate(records)]
            if resume:
                for kind, data in records:
                    _replay_apply(self, kind, data)
                self.replayed = len(records)
                self.replay_ms = (time.perf_counter() - t0) * 1e3
                self.restarts += 1
                self._wal("resume", restarts=self.restarts,
                          epoch=self._epoch)
                self._grace_until = (time.monotonic()
                                     + resume_grace_ms() / 1e3)
                self._note_resume(len(records))

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Tracker":
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="rabit-tracker")
        self._thread.start()
        self._start_live_plane()
        if self.lease_ms and self._wal_log is not None:
            self._renew_lease()
            self._lease_thread = threading.Thread(
                target=self._lease_loop, name="rabit-tracker-lease",
                daemon=True)
            self._lease_thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def stop(self) -> None:
        self._done.set()
        self._poll_stop.set()
        with self._repl_cv:
            self._repl_cv.notify_all()   # wake idle repl streamers
            streams = list(self._repl_conns)
        for conn in streams:
            _drop(conn)   # a streamer blocked on an ack wakes at once
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        _drop(self.sock)
        with self._cv:
            pending = [p[0] for p in self._pending.values()]
            self._pending.clear()
            # workers have exited (or been killed) by now: no live client
            # is left on these stores
            self._stores = []
            self._cv.notify_all()   # parked joiners stop waiting
        for conn in pending:
            self._close(conn)
        if self._wal_log is not None and not self.crashed:
            self._wal_log.close()

    def crash(self) -> None:
        """A tracker crash without the process exit (tests, the
        launcher's supervisor): the listener and the background threads
        die and every connection in flight is dropped hard, but nothing
        is flushed, closed gracefully or reaped -- the journal's handle
        and the epochs' stores stay as a kill leaves them (every record
        was fsynced on append), ready for a ``resume=True`` successor on
        the same pinned port. Parked joiners are woken and dropped."""
        with self._lock:
            # under the lock, where every record is written: no record
            # lands after this (``_wal`` refuses once crashed)
            self.crashed = True
        with self._conns_lock:
            conns = list(self._conns)
            self._conns.clear()
        self._done.set()
        self._poll_stop.set()
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        _drop(self.sock)
        # every connection dies hard, a repl stream too: its follower sees
        # EOF at once, and its streamer thread ends on the dropped socket
        for conn in conns:
            _drop(conn)
        with self._repl_cv:
            self._repl_cv.notify_all()
        with self._cv:
            self._cv.notify_all()   # parked joiners stop waiting

    @property
    def epoch(self) -> int:
        return self._epoch

    def wal_records(self) -> int:
        """Records in the journal (0 when the WAL is off): a resumed
        tracker counts the replayed ones too."""
        return 0 if self._wal_log is None else self._wal_log.records_total

    def snapshot_seq(self) -> int:
        """Seq of the newest snapshot in the journal (0: none, or no
        WAL)."""
        return 0 if self._wal_log is None else self._wal_log.snapshot_seq

    def in_resume_grace(self) -> bool:
        """True while poll-miss eviction evidence is waived after a resume
        (the workers' pollers are still reconnecting)."""
        return time.monotonic() < self._grace_until

    # -- the write-ahead log ----------------------------------------------------
    def _wal(self, kind: str, **data) -> None:
        """Journal one control-plane transition (a no-op with the WAL
        off). Callers hold the tracker's lock and call this BEFORE acting
        on the transition: a crash between the two replays the intent,
        never loses it. A crashed tracker journals nothing more (its
        successor may own the file already). Every journaled record is
        also published to ``repl`` subscribers as the exact frame bytes
        that reached the disk; an idempotent lease renewal is not
        journaled but becomes the stream's seq-0 heartbeat."""
        if self._wal_log is None:
            return
        if self.crashed:
            raise ConnectionError("the tracker crashed")
        with self._repl_cv:
            if kind == _wal_mod.LEASE_KIND and \
                    _wal_mod.lease_renewal_only(self._journaled_lease, data):
                # same owner and width, only until_ms advanced: at one
                # beat a third of a lease it would grow the journal, this
                # log and every replay without bound
                self._repl_hb = _wal_mod.encode_record(0, kind, data)
                self._repl_hb_n += 1
                self._repl_cv.notify_all()
                return
            # seq assignment and positional publication are one step:
            # writers run concurrently (the lease thread against the
            # connection threads), and seq N+1 reaching the log before
            # seq N would misindex the stream for good. record() takes
            # only the journal's own leaf lock.
            t0 = time.perf_counter()
            seq = self._wal_log.record(kind, **data)
            self.journal_s += time.perf_counter() - t0
            if kind == _wal_mod.LEASE_KIND:
                self._journaled_lease = dict(data)
            self._repl_log.append(_wal_mod.encode_record(seq, kind, data))
            self._repl_cv.notify_all()
        if self._snap_every and not self._snap_pending and \
                seq - self._wal_log.snapshot_seq >= self._snap_every:
            # compact off the journaling path: a thread of its own folds
            # the state under the lock once this caller has released it
            self._snap_pending = True
            threading.Thread(target=self._take_snapshot, daemon=True,
                             name="rabit-wal-snapshot").start()

    def _take_snapshot(self) -> None:
        """One live compaction: serialize the replay-reachable state under
        the tracker's lock, atomically rewrite the journal as
        snapshot-root + future tail, and publish the snapshot's frame to
        the replication stream (a follower adopts it as an append)."""
        try:
            with self._lock:
                if self._wal_log is None or self.crashed:
                    return
                state = snapshot_state(self)
                with self._repl_cv:
                    _seq, frame = self._wal_log.snapshot(state)
                    self._repl_log.append(frame)
                    self._repl_cv.notify_all()
        finally:
            self._snap_pending = False

    # -- the leadership lease and the replication stream -----------------------
    def _renew_lease(self) -> None:
        """Renew the leadership lease. The claim (the first lease, or a
        change of owner or width) is a journaled record of the replicated
        log; a renewal that only advances ``until_ms`` rides the stream as
        a heartbeat. The standby promotes only after a full lease of
        silence from this stream, counted on its own monotonic clock, so
        the gate needs no clock agreement between hosts."""
        lease = _wal_mod.lease_doc(self.node_id, self.lease_ms)
        with self._lock:
            # journal and publish under one hold, so that a live snapshot
            # never captures the state from between them
            self._wal(_wal_mod.LEASE_KIND, **lease)
            self._lease = lease

    def _lease_loop(self) -> None:
        """Renewals at a third of the lease: two missed beats still leave
        it live, and it lapses only when the leader is gone (a crash) or
        unreachable (a partition)."""
        period = max(0.05, self.lease_ms / 3000.0)
        while not self._done.wait(period):
            if self.crashed:
                return
            try:
                self._renew_lease()
            except (_wal_mod.WalError, ConnectionError):
                return   # the journal's disk died, or the tracker crashed

    def lease(self) -> Optional[dict]:
        """The newest lease this tracker renewed (None with the lease
        off)."""
        with self._lock:
            return None if self._lease is None else dict(self._lease)

    def repl_stats(self) -> dict:
        """The replication plane: the journal's seq, the live subscribers,
        the newest acked seq and the records not yet acked."""
        seq = 0 if self._wal_log is None else self._wal_log.seq
        with self._repl_cv:
            acked = max((s["acked"] for s in self._repl_subs), default=0)
            nsubs = len(self._repl_subs)
        return {"seq": seq, "subscribers": nsubs, "acked_seq": acked,
                "lag_records": max(0, seq - acked)}

    def _serve_repl(self, conn: socket.socket, peer: str) -> None:
        """One ``repl`` subscriber, on its connection's own thread for as
        long as the follower keeps acking: every record at or past its
        resync point, one ack a record, and the lease heartbeats between
        them. A slow, torn or confused follower is dropped (it resubscribes
        from its last durable seq): replication never stalls the control
        plane. Without a WAL the answer is 0, as the JAX tracker's."""
        if self._wal_log is None:
            self._reply_u32(conn, 0)   # replication needs a journal
            return
        sub = {"peer": peer, "acked": 0}
        try:
            _send_u32(conn, 1)
            last = _recv_u32(conn)
            conn.settimeout(repl_ack_timeout_ms() / 1e3)
            sub["acked"] = last
            with self._repl_cv:
                if self._done.is_set():
                    return
                self._repl_subs.append(sub)
                self._repl_conns.add(conn)
                hb_seen = self._repl_hb_n
            # a positional cursor: frame idx carries seq base + idx + 1. A
            # follower acked below the base resynced into a compacted
            # history and gets the snapshot root first (idx 0)
            idx = max(0, last - self._repl_base)
            while not self._done.is_set():
                frame = hb = None
                with self._repl_cv:
                    while (len(self._repl_log) <= idx
                           and self._repl_hb_n <= hb_seen
                           and not self._done.is_set()):
                        self._repl_cv.wait(0.2)
                    if self._done.is_set():
                        break
                    if len(self._repl_log) > idx:
                        frame = self._repl_log[idx]
                    else:
                        hb = self._repl_hb
                        hb_seen = self._repl_hb_n
                if hb is not None:
                    # seq 0: proof of life, never journaled or acked
                    conn.sendall(hb)
                    continue
                conn.sendall(frame)
                ack = _recv_u32(conn)
                if ack != self._repl_base + idx + 1:
                    break   # a confused follower: drop it, it resyncs
                with self._repl_cv:
                    sub["acked"] = ack
                idx += 1
        except (OSError, ConnectionError, struct.error):
            pass
        finally:
            with self._repl_cv:
                self._repl_subs = [x for x in self._repl_subs
                                   if x is not sub]
                self._repl_conns.discard(conn)
            self._close(conn)

    def _note_resume(self, nrecords: int) -> None:
        """Make a resume observable: a counter, a zero-length span, a
        flight note, a fleet event (``_fleet_emit``) and a line on
        stderr."""
        from .. import telemetry
        from ..telemetry import flight
        detail = (f"replayed {nrecords} WAL records, restart "
                  f"#{self.restarts}, epoch {self._epoch}")
        telemetry.count("tracker.resume", provenance="tracker")
        telemetry.record_span("tracker.resume", 0.0, op="resume",
                              provenance="tracker", records=nrecords,
                              restarts=self.restarts)
        flight.note("tracker_resume", detail)
        self._fleet_emit("tracker.resume", detail)
        print(f"[tracker] resumed from WAL ({nrecords} records, restart "
              f"#{self.restarts}, epoch {self._epoch}, {len(self._ranks)} "
              f"known ranks)", file=sys.stderr, flush=True)

    def _resume_present(self, task_id: str, rank: int, epoch: int) -> bool:
        """Reconcile one worker's ``resume`` handshake against the
        replayed journal: a matching identity confirms it, an unknown task
        id with a free rank is adopted (a torn tail can lose the last
        ``assign``: the live worker is the authority on its own rank), and
        a contradiction is refused, so the worker falls back to a full
        re-registration."""
        with self._lock:
            known = self._ranks.get(task_id)
            if known is None and 0 <= rank < self.nworkers \
                    and rank not in self._ranks.values():
                self._wal("assign", task=task_id, rank=rank)
                self._ranks[task_id] = rank
                known = rank
            ok = known == rank and epoch <= self._epoch + 1
            if ok:
                self._endpoint_misses[task_id] = 0
                self._resumed_ranks.add(rank)
        return ok

    def store_count(self) -> int:
        """Rendezvous stores still hosted (old epochs are reaped)."""
        with self._lock:
            return len(self._stores)

    def env(self, task_id: str, num_attempt: int = 0) -> Dict[str, str]:
        """Environment for a worker process."""
        return {
            "RABIT_TRACKER_URI": self.host,
            "RABIT_TRACKER_PORT": str(self.port),
            "RABIT_TASK_ID": task_id,
            "RABIT_NUM_TRIAL": str(num_attempt),
            "RABIT_WORLD_SIZE": str(self.nworkers),
        }

    # -- serving ------------------------------------------------------------
    def _serve(self) -> None:
        while not self._done.is_set():
            try:
                conn, _ = self.sock.accept()
            except OSError:
                return   # stop() or crash() shut the listener
            with self._conns_lock:
                if self.crashed:
                    _drop(conn)
                    return
                self._conns.add(conn)
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _close(self, conn: socket.socket) -> None:
        with self._conns_lock:
            self._conns.discard(conn)
        conn.close()

    def _handle(self, conn: socket.socket) -> None:
        """One request. A registration's connection stays open, parked in
        ``_pending`` until its batch is complete; every other command is
        answered and closed."""
        try:
            conn.settimeout(_REQUEST_TIMEOUT_S)
            if _recv_u32(conn) != MAGIC:
                self._close(conn)
                return
            cmd = _recv_str(conn)
            task_id = _recv_str(conn)
            _recv_u32(conn)   # num_attempt (informational)
            if cmd in ("start", "recover", "join"):
                host = _recv_str(conn)
                port = _recv_u32(conn)
                flags = _recv_u32(conn)
                token = _recv_str(conn)
                conn.settimeout(None)
                self._register(conn, task_id, host, port, flags, token,
                               join=cmd == "join")
            elif cmd == "print":
                msg = _recv_str(conn)
                self.messages.append(msg)
                print(msg, flush=True)
                self._reply_u32(conn, 1)
            elif cmd == "metrics":
                try:
                    doc = json.loads(_recv_str(conn))
                except ValueError:
                    doc = None
                ok = isinstance(doc, dict)
                if ok:
                    with self._lock:
                        self._metrics[task_id] = doc
                    self._fold_events(task_id, doc)
                self._reply_u32(conn, 1 if ok else 0)
            elif cmd == "shutdown":
                with self._lock:
                    rank = self._ranks.get(task_id)
                    if rank is not None:
                        # journaled, so a tracker resumed mid-teardown
                        # still sees the job complete (a worker sends
                        # shutdown once)
                        self._wal("down", rank=rank)
                        self._shutdown_ranks.add(rank)
                    if self.elastic and self._member.live:
                        # evicted ranks never send shutdown
                        all_down = self._member.live <= self._shutdown_ranks
                    else:
                        all_down = len(self._shutdown_ranks) >= self.nworkers
                self._reply_u32(conn, 1)
                if all_down:
                    self.print_fleet_metrics()
                    self._done.set()
            elif cmd == "endpoint":
                try:
                    doc = json.loads(_recv_str(conn))
                except ValueError:
                    doc = None
                ok = (isinstance(doc, dict) and "host" in doc
                      and "port" in doc)
                if ok:
                    ep = {"host": str(doc["host"]), "port": int(doc["port"]),
                          "rank": int(doc.get("rank", -1))}
                    with self._lock:
                        self._wal("endpoint", task=task_id, doc=ep)
                        self._endpoints[task_id] = ep
                        # a (re-)announce is proof of life: no earlier
                        # misses count toward an eviction
                        self._endpoint_misses[task_id] = 0
                self._reply_u32(conn, 1 if ok else 0)
            elif cmd == "world":
                self._reply_json(conn, self.membership_doc())
            elif cmd in ("evict", "resume"):
                try:
                    doc = json.loads(_recv_str(conn))
                except ValueError:
                    doc = None
                ok = False
                if isinstance(doc, dict) and doc.get("rank") is not None:
                    try:
                        if cmd == "evict":
                            ok = self.evict_rank(int(doc["rank"]),
                                                 str(doc.get("reason", "")))
                        else:
                            # a live worker re-presents its identity to a
                            # (possibly resumed) tracker
                            ok = self._resume_present(
                                task_id, int(doc["rank"]),
                                int(doc.get("epoch", 0)))
                    except (TypeError, ValueError):
                        ok = False
                self._reply_u32(conn, 1 if ok else 0)
            elif cmd in ("topo", "skew"):
                with self._lock:
                    doc = dict(self._topo if cmd == "topo" else self._skew)
                self._reply_json(conn, doc)
            elif cmd == "repl":
                # a subscriber holds this connection's thread for as long
                # as it follows: one thread a standby
                self._serve_repl(conn, task_id)
            else:
                self._close(conn)
        except (ConnectionError, OSError, struct.error, UnicodeDecodeError):
            self._close(conn)

    # -- the live plane -------------------------------------------------------
    def _start_live_plane(self) -> None:
        """The fleet metrics endpoint and the poll thread, when a metrics
        port is configured. A port that does not bind is a warning, never
        a failed rendezvous."""
        if self._metrics_port is None:
            return
        from ..telemetry import live
        identity = {"role": "tracker", "nworkers": self.nworkers}
        if self.lease_ms:
            # the supervisor's probe before a cold respawn reads this: a
            # tracker whose /healthz says tracker_role "leader" IS the
            # control plane (a promoted standby says so too)
            identity.update({"tracker_role": "leader",
                             "node": self.node_id,
                             "promoted": bool(self.promoted)})
        try:
            self._metrics_server = live.MetricsServer(
                port=self._metrics_port,
                sources_fn=self._metric_sources,
                summary_fn=lambda: self.merged_metrics() or {},
                gauges_fn=self._live_gauges,
                identity=identity,
                routes=self._live_routes(),
            ).start()
        except OSError as e:
            print(f"[tracker] metrics server failed to bind port "
                  f"{self._metrics_port}: {e}", file=sys.stderr, flush=True)
            return
        # port 0 picks one: without this line it could not be found
        print(f"[tracker] live metrics on {self._metrics_server.host}:"
              f"{self._metrics_server.port}", file=sys.stderr, flush=True)
        self._poll_stop.clear()
        self._poll_thread = threading.Thread(
            target=self._poll_loop, name="rabit-tracker-poll", daemon=True)
        self._poll_thread.start()

    def _live_routes(self) -> dict:
        """The live endpoint's JSON routes: ``/events`` and
        ``/incidents`` only while the incident plane is on."""
        routes = {"/straggler": self._straggler_doc, "/slo": self._slo_doc}
        if self._events_on:
            routes["/events"] = self._events_doc
            routes["/incidents"] = self._incidents_doc
        return routes

    def _metric_sources(self) -> list:
        """One Prometheus source a polled rank: its summary, labelled with
        its rank."""
        with self._lock:
            return [({"rank": str(doc.get("rank", -1))}, doc)
                    for doc in self._metrics.values()]

    def _live_gauges(self) -> list:
        with self._lock:
            nend, polls = len(self._endpoints), self._poll_count
            topo, skew = dict(self._topo), dict(self._skew)
            strag = self._last_straggler
            m = self._member
            member = (None if m is None
                      else (m.world(), m.evictions, m.admissions))
        gauges = [
            ("rabit_tracker_endpoints",
             "Worker metrics endpoints known to the tracker.", "gauge",
             [({}, nend)]),
            ("rabit_tracker_polls_total", "Completed endpoint poll sweeps.",
             "counter", [({}, polls)]),
        ]
        if self._wal_log is not None:
            gauges.append((
                "rabit_tracker_restarts_total",
                "Tracker crash-resume cycles (WAL replay + live-world "
                "re-adoption).", "counter", [({}, self.restarts)]))
            gauges.append((
                "rabit_wal_records_total",
                "Control-plane transitions journaled to the tracker "
                "write-ahead log.", "counter",
                [({}, self._wal_log.records_total)]))
            gauges.append((
                "rabit_wal_snapshot_seq",
                "Seq of the journal's most recent snapshot record (0 "
                "until one exists) — replay cost is bounded by the "
                "records after it.", "gauge",
                [({}, self._wal_log.snapshot_seq)]))
        if self.lease_ms and self._wal_log is not None:
            repl = self.repl_stats()
            gauges.append((
                "rabit_tracker_role",
                "Control-plane role: 1 while this tracker holds the "
                "leadership lease and serves the world (a promoted "
                "standby reports 1 too — by then it IS the leader).",
                "gauge", [({"node": self.node_id}, 1)]))
            gauges.append((
                "rabit_repl_acked_seq",
                "Newest WAL seq a standby has durably acked (0 with "
                "no subscriber).", "gauge", [({}, repl["acked_seq"])]))
            gauges.append((
                "rabit_repl_lag_records",
                "Journaled records not yet acked by the standby — the "
                "bounded data loss of a failover right now.",
                "gauge", [({}, repl["lag_records"])]))
        if member is not None:
            world, evictions, admissions = member
            gauges.append((
                "rabit_world_size",
                "Live world size of the current membership epoch "
                "(elastic jobs shrink below the launch target and "
                "grow back on re-admission).", "gauge", [({}, world)]))
            gauges.append((
                "rabit_member_evictions_total",
                "Ranks evicted from the live job (watchdog/poll "
                "evidence or the evict command).", "counter",
                [({}, evictions)]))
            gauges.append((
                "rabit_member_admissions_total",
                "Parked joiners admitted at an epoch boundary.",
                "counter", [({}, admissions)]))
        if topo.get("groups"):
            sizes = [len(g) for g in topo["groups"]]
            gauges.append((
                "rabit_tracker_topology_hosts",
                "Distinct hosts in the current link-registration epoch.",
                "gauge", [({}, len(topo["groups"]))]))
            gauges.append((
                "rabit_tracker_topology_ranks_per_host",
                "Ranks per host (max label distinguishes ragged "
                "groupings, which disable the hierarchical schedule).",
                "gauge", [({"stat": "min"}, min(sizes)),
                          ({"stat": "max"}, max(sizes))]))
        if strag is not None and strag.get("lagging_rank") is not None:
            gauges.append((
                "rabit_straggler_lag_collectives",
                "Collectives the laggard is behind the leader.", "gauge",
                [({"rank": str(strag["lagging_rank"])},
                  strag["lag_collectives"])]))
            gauges.append((
                "rabit_straggler_busy_skew_seconds",
                "Spread of per-rank collective busy time.", "gauge",
                [({}, strag["busy_skew_s"])]))
        if skew.get("offsets_ms"):
            gauges.append((
                "rabit_skew_offset_ms",
                "Per-rank mean arrival offset behind the earliest rank "
                "(the skew digest served to workers).", "gauge",
                [({"rank": str(r)}, v) for r, v in
                 sorted(skew["offsets_ms"].items(),
                        key=lambda kv: int(kv[0]))]))
            gauges.append((
                "rabit_skew_epoch",
                "Fleet skew election epoch (bumps when the served "
                "laggard verdict changes).", "gauge",
                [({}, skew.get("epoch", 0))]))
        if self.promoted:
            gauges.append((
                "rabit_failover_duration_ms",
                "Leader-kill to standby-promoted duration, stamped by "
                "the control plane at promotion (tracker/standby.py).",
                "gauge", [({"node": self.node_id},
                           round(self.failover_duration_ms, 3))]))
        if self.lease_ms:
            # the SLO burn gauges only where the tracker has something to
            # judge (a failover): a plain tracker's exposition is as before
            from ..telemetry import slo as _slo
            gauges.extend(_slo.gauges(self._slo_verdicts()))
        if self._events_on:
            # the incident plane's gauges, only with the plane on
            gauges.extend(_incident.gauges(self._incidents.open_docs(),
                                           self._events_dropped_total()))
        return gauges

    def _straggler_doc(self) -> dict:
        """The ``/straggler`` route: the last poll sweep's snapshot."""
        with self._lock:
            strag = self._last_straggler
        return (dict(strag) if strag is not None
                else {"ranks": [], "signal": False})

    def _slo_verdicts(self) -> list:
        """The objectives a tracker can judge on its own: the failover
        time, once promoted, and the admission shed rate (``no_data``
        here, without a multi-job admission plane)."""
        from ..telemetry import slo as _slo
        measured: Dict[str, float] = {}
        if self.promoted and self.failover_duration_ms > 0:
            measured["failover_ms"] = self.failover_duration_ms
        slos = [s for s in _slo.default_slos()
                if s.name in ("failover_ms", "shed_rate")]
        return _slo.evaluate_all(slos, measured)

    def _slo_doc(self) -> dict:
        """The ``/slo`` route: each objective's burn state."""
        from ..telemetry import slo as _slo
        return _slo.burn_doc(self._slo_verdicts())

    # -- the causal incident plane ------------------------------------------
    def _fleet_emit(self, kind: str, detail: str = "", job: str = "",
                    rank: int = -1, **attrs) -> None:
        """A tracker-side fleet event: into the process's ring, then the
        ring folds into the fleet log (the tracker is its own consumer; a
        control-plane event needs no scrape). Never takes the tracker's
        lock (callers hold it on several paths); the fold's leaf lock is
        safe under it."""
        if not self._events_on:
            return
        _events.emit(kind, detail=detail, job=job, rank=rank, **attrs)
        self._fold_local_ring()

    def _fold_local_ring(self) -> None:
        """Fold this process's OWN event ring into the fleet log, as
        source ``tracker``, deduplicated by ``seq`` like a worker's. The
        ring is process-wide: the launcher's chaos proxies and a hot
        standby stamping its promotion share it with the tracker, and
        this fold is what brings their records into ``/events`` and the
        sweep's causal window (a promoted tracker's log starts empty and
        sees the kill only through it)."""
        if not self._events_on:
            return
        with self._events_fold_lock:
            seen = self._event_seen.get("__local__", 0)
            newest = seen
            for rec in _events.snapshot()["records"]:
                seq = rec.get("seq", 0)
                if not isinstance(seq, int) or seq <= seen:
                    continue
                newest = max(newest, seq)
                rec = dict(rec)
                rec["source"] = "tracker"
                self._fleet_events.append(rec)
            self._event_seen["__local__"] = newest

    def _fold_events(self, task_id: str, doc: dict) -> None:
        """Fold one worker summary's event ring into the fleet log.
        Every scrape re-ships the whole ring: the task's ``seq`` is the
        dedup cursor. The worker's HLC merges into the tracker's, so
        every later tracker stamp follows what it has observed, and the
        worker's cumulative ring drops feed the fleet-wide gauge. A
        record without a job takes the one job's name, as the JAX
        tracker's default job gives it."""
        if not self._events_on or not isinstance(doc, dict):
            return
        _clock.merge_from_doc(doc)
        ev = doc.get("events")
        if not isinstance(ev, dict):
            return
        with self._events_fold_lock:
            seen = self._event_seen.get(task_id, 0)
            newest = seen
            for rec in ev.get("records", ()):
                if not isinstance(rec, dict):
                    continue
                seq = rec.get("seq", 0)
                if not isinstance(seq, int) or seq <= seen:
                    continue
                newest = max(newest, seq)
                rec = dict(rec)
                rec["source"] = task_id
                if not rec.get("job"):
                    rec["job"] = DEFAULT_JOB
                self._fleet_events.append(rec)
            self._event_seen[task_id] = newest
            dropped = ev.get("dropped")
            if isinstance(dropped, int) and dropped >= 0:
                self._event_drops[task_id] = dropped

    def _events_dropped_total(self) -> int:
        """Fleet-wide dropped events: every task's cumulative ring drops
        and the tracker's own ring's."""
        return sum(self._event_drops.values()) \
            + _events.stats()["dropped"]

    def _events_doc(self) -> dict:
        """The ``/events`` route: the fleet event log in causal order
        (HLC when stamped, wall time otherwise)."""
        from ..telemetry.schema import make_header
        self._fold_local_ring()
        evs = sorted(self._fleet_events, key=_incident._event_key)
        doc = make_header(_events.EVENT_KIND)
        doc["events"] = evs
        doc["count"] = len(evs)
        doc["dropped"] = self._events_dropped_total()
        return doc

    def _incidents_doc(self) -> dict:
        """The ``/incidents`` route: the open incidents and the recent
        ones."""
        open_docs = self._incidents.open_docs()
        return {"open": open_docs,
                "open_count": len(open_docs),
                "worst": self._incidents.worst(),
                "closed_total": self._incidents.closed_total,
                "recent": list(self._incident_log)}

    def _incident_sweep(self) -> None:
        """One poll pass of the incident engine: an ``slo.<state>`` event
        on each edge of a verdict, each warn or violating verdict and
        each unseen ``watchdog.abort`` correlated against the fleet log,
        and each newly opened incident dumped beside the flight records
        (the installed recorder's directory, else ``RABIT_FLIGHT_DIR``)."""
        from ..telemetry import flight
        self._fold_local_ring()
        verdicts = self._slo_verdicts()
        events_now = list(self._fleet_events)
        opened = []
        for v in verdicts:
            name = str(v.get("slo", "?"))
            state = str(v.get("state", ""))
            if self._slo_prev.get(name) != state:
                self._slo_prev[name] = state
                kind = f"slo.{state}"
                if kind in _events.EVENT_KINDS:
                    self._fleet_emit(
                        kind, f"{name} = {v.get('value')} "
                              f"{v.get('unit', '')} (burn "
                              f"{v.get('burn')})")
            inc = self._incidents.observe_slo(v, events_now)
            if inc is not None:
                opened.append(inc)
        opened.extend(self._incidents.observe_events(events_now))
        if not opened:
            return
        fr = flight.installed()
        out_dir = fr.out_dir if fr is not None \
            else os.environ.get("RABIT_FLIGHT_DIR")
        for inc in opened:
            self._incident_log.append(inc)
            if out_dir:
                _incident.dump(inc, out_dir)
            print(f"[tracker] incident {inc.get('id')} "
                  f"[{inc.get('severity')}]: {inc.get('summary')}",
                  file=sys.stderr, flush=True)

    def _poll_loop(self) -> None:
        from ..telemetry import live
        interval = live.poll_interval_s()
        since_snapshot = 0
        while not self._poll_stop.wait(interval):
            with self._lock:
                endpoints = dict(self._endpoints)
            since_snapshot += 1
            if endpoints:
                since_snapshot = self._poll_sweep(endpoints, since_snapshot)
            if self._events_on:
                # the incident sweep rides the poll cadence even when no
                # endpoint answered: the tracker's own events (membership,
                # SLO edges, a promotion) still need correlating
                self._incident_sweep()

    def _poll_sweep(self, endpoints: Dict[str, dict],
                    since_snapshot: int) -> int:
        """One pass over the announced endpoints: scrape each, evict the
        silent ones (elastic), elect the laggard and serve the digest;
        returns the sweeps since the last straggler line."""
        from ..telemetry import crossrank, live, skew
        for tid, ep in endpoints.items():
            doc = live.scrape_json(ep["host"], ep["port"])
            if doc is not None:
                with self._lock:
                    self._metrics[tid] = doc
                    self._endpoint_misses[tid] = 0
                self._fold_events(tid, doc)
                continue
            # right after a resume every worker's poller is still
            # timing out against the dead incarnation's cadence: the
            # silence is the tracker's outage, not the worker's
            if self.in_resume_grace():
                with self._lock:
                    self._endpoint_misses[tid] = 0
                continue
            # an endpoint that HAS answered before and now stays
            # silent for several sweeps is, to the fleet, a dead rank:
            # in an elastic world that is grounds for eviction (the
            # watchdog catches the same failure from the inside; this
            # catches a process that is unreachable rather than dead)
            with self._lock:
                seen_before = tid in self._metrics
                misses = self._endpoint_misses.get(tid, 0) + 1
                self._endpoint_misses[tid] = misses
                rank = self._ranks.get(tid)
                live_rank = (self.elastic and rank is not None
                             and rank in self._member.live)
            if seen_before and live_rank and \
                    misses >= _membership.EVICT_POLL_MISSES:
                self.evict_rank(
                    rank, f"endpoint silent for {misses} polls")
        with self._lock:
            summaries = dict(self._metrics)
        strag = crossrank.straggler_snapshot(summaries)
        # each sweep's raw offsets fold through the ONE election; the
        # served digest is its smoothed, hysteretic verdict, whose
        # epoch bumps exactly when the election changes
        if self._skew_election is None:
            self._skew_election = skew.FleetElection()
        digest = self._skew_election.fold(
            skew.digest_from_snapshot(strag))
        with self._lock:
            if digest is not None and \
                    digest.get("epoch") != self._skew.get("epoch"):
                # journal verdicts, not sweeps: the epoch bumps exactly
                # when the election changes
                self._wal("skew", digest=digest)
            self._last_straggler = strag
            if digest is not None:
                self._skew = digest
            self._poll_count += 1
        # one line every ~5 sweeps, only while someone is behind: in
        # the round sequence, or by more than 1 s of in-collective wait
        behind = bool(strag.get("signal")) \
            and strag.get("lagging_rank") is not None
        if since_snapshot >= 5 and behind:
            since_snapshot = 0
            print(f"[tracker] straggler: rank {strag['lagging_rank']} "
                  f"is {strag['lag_collectives']} collectives behind "
                  f"(busy skew {strag['busy_skew_s']:.3f}s)",
                  file=sys.stderr, flush=True)
        return since_snapshot

    def live_addr(self) -> Optional[Tuple[str, int]]:
        """The live plane's ``(host, port)``, or None without a metrics
        port: what the supervisor probes before it dares a cold
        respawn."""
        srv = self._metrics_server
        return None if srv is None else (srv.host, srv.port)

    def live_stats(self) -> dict:
        """The live plane's state, for launchers and tests: the metrics
        address, the endpoints, the sweeps, the last straggler snapshot
        and the served skew digest."""
        with self._lock:
            srv = self._metrics_server
            return {"metrics_addr": (None if srv is None
                                     else list(srv.address)),
                    "endpoints": {t: dict(e)
                                  for t, e in self._endpoints.items()},
                    "polls": self._poll_count,
                    "straggler": self._last_straggler,
                    "skew": dict(self._skew)}

    def merged_metrics(self) -> Optional[dict]:
        """The ``telemetry_fleet`` document merged from the summaries
        received so far, or None when no worker sent one."""
        with self._lock:
            snap = dict(self._metrics)
        return merge_summaries(snap) if snap else None

    def print_fleet_metrics(self) -> None:
        """Print the end-of-run fleet table (once), and keep it in
        ``messages`` like a print command, so launchers and tests see
        it. Nothing when no summary with a counter arrived."""
        fleet = self.merged_metrics()
        if fleet is None or not fleet.get("counters"):
            return
        with self._lock:
            if self._fleet_printed:
                return
            self._fleet_printed = True
        table = format_fleet_table(fleet)
        self.messages.append(table)
        print(table, flush=True)

    def _reply_u32(self, conn: socket.socket, v: int) -> None:
        conn.sendall(struct.pack("<I", v))
        self._close(conn)

    def _reply_json(self, conn: socket.socket, doc: dict) -> None:
        """A JSON-str reply (``topo``, ``skew``, ``world``), with the
        tracker's HLC piggybacked while the incident plane is on, so a
        worker's clock causally follows the control plane; never on a
        u32 reply."""
        if self._events_on:
            stamp = _clock.tick()
            if stamp is not None:
                doc["hlc"] = stamp
        b = json.dumps(doc).encode()
        conn.sendall(struct.pack("<I", len(b)) + b)
        self._close(conn)

    def _register(self, conn, task_id: str, host: str, port: int,
                  flags: int, token: str, join: bool = False) -> None:
        """Park the registration in ``_pending``; whichever registration
        (or eviction) completes the batch serves everyone via
        ``_assign``. A parked joiner's thread waits on the condition
        until a formation adopts it, or bounces it after
        ``rabit_join_grace_ms`` (the joiner retries)."""
        grace_s: Optional[float] = None
        with self._cv:
            if task_id not in self._ranks:
                rank = len(self._ranks)
                if self.elastic and rank >= self.nworkers \
                        and self._member.evicted:
                    # replacement hardware arrives under a NEW task id:
                    # it adopts the lowest vacated stable rank, so the
                    # world can grow back to its target (and the newcomer
                    # inherits that rank's checkpoint shard directory)
                    rank = min(self._member.evicted)
                self._wal("assign", task=task_id, rank=rank)
                self._ranks[task_id] = rank
            rank = self._ranks[task_id]
            if rank >= self.nworkers:
                self._close(conn)
                return
            if self.elastic:
                m = self._member
                if join or rank in m.evicted or \
                        (m.live and rank not in m.live):
                    # (re-)admission: parked until the epoch boundary; a
                    # joiner never perturbs a world in flight
                    self._wal("park", rank=rank)
                    m.park(rank)
                    grace_s = _membership.join_grace_ms() / 1e3 or None
            self._shutdown_ranks.discard(rank)
            prev = self._pending.get(rank)
            self._pending[rank] = (conn, host, port, flags, token)
            got = self._try_complete_batch_locked()
        if prev is not None and prev[0] is not conn:
            # a re-registration superseded a still-parked connection
            self._close(prev[0])
        if got is not None:
            self._assign(*got)
            return
        if grace_s is not None:
            self._park_joiner(conn, rank, grace_s)

    def _park_joiner(self, conn, rank: int, grace_s: float) -> None:
        """Hold a parked joiner's connection until a formation adopts it
        (or a re-registration supersedes it); after ``grace_s`` close it
        rather than hold the socket open forever."""
        deadline = time.monotonic() + grace_s
        with self._cv:
            while True:
                pend = self._pending.get(rank)
                if pend is None or pend[0] is not conn:
                    return   # adopted (or superseded) in time
                left = deadline - time.monotonic()
                if left <= 0 or self._done.is_set():
                    break
                self._cv.wait(left)
            del self._pending[rank]
        self._close(conn)

    def _expected_ranks(self) -> set:
        """Ranks the current registration batch must contain before it
        forms (caller holds the lock): the fixed world, or, elastic, the
        survivors of the last formed world plus the parked joiners."""
        if self.elastic:
            return self._member.expected()
        return set(range(self.nworkers))

    def _try_complete_batch_locked(self) -> Optional[tuple]:
        """``(batch, epoch, admitted)`` when every expected rank is
        pending, else None. Caller holds the lock and, on success, runs
        ``_assign`` outside it. An eviction can complete a batch too:
        survivors re-register and wait for a dead rank until it leaves
        the expected set."""
        expected = self._expected_ranks()
        if not expected or not expected <= set(self._pending):
            return None
        batch = {r: self._pending.pop(r) for r in sorted(expected)}
        self._wal("epoch", epoch=self._epoch + 1, members=sorted(batch))
        self._epoch += 1
        admitted = (sorted(self._member.formed(batch)) if self.elastic
                    else [])
        self._cv.notify_all()
        return batch, self._epoch, admitted

    # -- elastic membership ---------------------------------------------------
    def membership_doc(self) -> dict:
        """The ``world`` command's payload: the live membership view, or
        a static fixed-world doc when elastic is off (so the command
        always answers: a worker probing an inelastic tracker learns the
        world is fixed rather than timing out)."""
        with self._lock:
            if self.elastic:
                return self._member.doc(self._epoch)
            return {"epoch": self._epoch, "world": self.nworkers,
                    "target": self.nworkers,
                    "live": list(range(self.nworkers)), "evicted": [],
                    "joining": [], "generation": 0, "elastic": False}

    def _note_transition(self, kind: str, rank: int, detail: str) -> None:
        """Make a membership transition observable: a counter, a
        zero-length ``membership.transition`` span, a flight note naming
        the rank (a post-mortem bundle shows WHY the world resized) and a
        fleet event of the one job."""
        from .. import telemetry
        from ..telemetry import flight
        telemetry.count(f"membership.{kind}", provenance="membership")
        telemetry.record_span("membership.transition", 0.0, op=kind,
                              provenance="membership", rank=rank,
                              detail=detail)
        flight.note(f"member_{kind}", f"rank {rank}: {detail}")
        self._fleet_emit(f"membership.{kind}", detail, job=DEFAULT_JOB,
                         rank=rank)
        print(f"[tracker] membership: {kind} rank {rank} ({detail})",
              file=sys.stderr, flush=True)

    def evict_rank(self, rank: int, reason: str = "") -> bool:
        """Evict ``rank`` from the live job (the ``evict`` command, or
        the poll loop's silent-endpoint evidence). The rank leaves the
        expected set at once, so survivors already waiting in
        re-registration form their N-1 batch now instead of waiting out
        the ready timeout on a dead peer. False unless elastic, in range
        and not already out."""
        if not self.elastic or not 0 <= int(rank) < self.nworkers:
            return False
        rank = int(rank)
        with self._cv:
            if rank in self._member.evicted:
                return False
            self._wal("evict", rank=rank, reason=reason)
            if not self._member.evict(rank):
                return False
            pend = self._pending.pop(rank, None)
            got = self._try_complete_batch_locked()
            self._cv.notify_all()
        self._note_transition("evict", rank, reason or "evicted")
        if pend is not None:
            self._close(pend[0])
        if got is not None:
            self._assign(*got)
        return True

    # -- the epoch's rendezvous store -----------------------------------------
    def _new_store(self, epoch: int, members) -> Tuple[str, int]:
        """Start this epoch's rendezvous store on a fresh port;
        ``members`` are the stable ranks of the epoch's batch."""
        import torch.distributed as dist
        store = dist.TCPStore(self.host, 0, is_master=True,
                              wait_for_workers=False,
                              timeout=datetime.timedelta(seconds=300))
        with self._lock:
            self._stores.append((epoch, store, frozenset(members)))
        return self.host, store.port

    def _reap_old_stores(self, acked_epoch: int) -> None:
        """Once every member of ``acked_epoch`` acked it, drop each older
        store whose members have all acked a newer epoch: a worker drops
        its torch world before it acks (the data plane's teardown
        sentinel), so no client of such a store is left. A member evicted
        while its process lives on (the in-process ``resize("join")``)
        keeps the world of its last epoch, and with it a client of that
        epoch's store, until its own re-registration tears the world
        down; so that store stays until the member has acked a newer
        epoch. In a fixed world every batch holds every rank, and this
        drops every store older than ``acked_epoch``. Keeps the store
        count bounded whatever the number of recoveries."""
        with self._lock:
            self._stores = [
                (e, st, members) for e, st, members in self._stores
                if e >= acked_epoch or
                any(self._acked.get(r, 0) <= e for r in members)]

    def _assign(self, batch: Dict[int, tuple], epoch: int,
                admitted=()) -> None:
        for r in admitted:
            self._note_transition("admit", r, f"joined at epoch {epoch}")
        # an elastic world may be holey in STABLE rank space (rank 1 of
        # {0, 2, 3} is gone): the schedules are built over dense SLOTS,
        # and the wire's rank carries the slot. A fixed world's batch is
        # always the full range, so the map is the identity and nothing
        # changes on the wire
        world = len(batch)
        slot_of = _membership.dense_slots(batch)
        conns = {slot_of[r]: c for r, (c, h, p, f, tok) in batch.items()}
        addr = {slot_of[r]: (h, p, tok)
                for r, (c, h, p, f, tok) in batch.items()}
        # a store only for an epoch whose workers register a data plane
        want_store = any(f & FLAG_DATAPLANE
                         for (c, h, p, f, tok) in batch.values())
        try:
            coord_host, coord_port = (self._new_store(epoch, batch)
                                      if want_store else ("", 0))
        except (RuntimeError, OSError) as e:
            # a silent failure here would hang every worker in this batch;
            # closing their connections surfaces a registration error
            print(f"[tracker] rendezvous store start failed, rejecting "
                  f"epoch {epoch}: {e}", file=sys.stderr, flush=True)
            for c in conns.values():
                self._close(c)
            return

        # single_host and the host grouping are judged by the OBSERVED
        # registration source address, not the self-reported hostname
        # (cloned machines can share one); both steer schedule choice only
        def _src_ip(c):
            try:
                return c.getpeername()[0]
            except OSError:
                return None  # died pre-assignment; be conservative
        single_host = len({_src_ip(c) for c in conns.values()}) <= 1
        by_host: Dict[str, List[int]] = {}
        for rank in sorted(batch):
            c, h, p, f, tok = batch[rank]
            by_host.setdefault(_src_ip(c) or h, []).append(slot_of[rank])
        groups = list(by_host.values())
        topo = {"epoch": epoch, "groups": groups,
                "delegates": [min(g) for g in groups],
                "single_host": single_host}
        with self._lock:
            self._wal("topo", doc=topo)
            self._topo = topo

        for rank in sorted(conns):
            parent, children = tree_neighbors(rank, world)
            tree_nbrs = ([] if parent is None else [parent]) + children
            ring_prev = (rank - 1) % world
            ring_next = (rank + 1) % world
            neighbors = sorted(set(tree_nbrs) |
                               ({ring_prev, ring_next} if world > 1
                                else set()))
            connect_to = [r for r in neighbors if r < rank]
            naccept = len([r for r in neighbors if r > rank])
            blob = bytearray()
            _pack_u32(blob, rank)
            _pack_u32(blob, world)
            _pack_u32(blob, epoch)
            _pack_str(blob, coord_host)
            _pack_u32(blob, coord_port)
            _pack_u32(blob, 1 if single_host else 0)
            _pack_u32(blob, NO_RANK if parent is None else parent)
            _pack_u32(blob, len(tree_nbrs))
            for r in tree_nbrs:
                _pack_u32(blob, r)
            _pack_u32(blob, ring_prev)
            _pack_u32(blob, ring_next)
            _pack_u32(blob, len(connect_to))
            for r in connect_to:
                peer_host, peer_port, peer_tok = addr[r]
                if self._link_rewrite is not None:
                    peer_host, peer_port = self._link_rewrite(
                        r, peer_host, peer_port)
                    peer_tok = ""   # UDS would bypass the proxy
                _pack_u32(blob, r)
                _pack_str(blob, peer_host)
                _pack_u32(blob, int(peer_port))
                _pack_str(blob, peer_tok)
            _pack_u32(blob, naccept)
            try:
                conns[rank].sendall(bytes(blob))
            except OSError as e:
                print(f"[tracker] rank {rank} lost before its epoch "
                      f"{epoch} assignment ({e})", file=sys.stderr,
                      flush=True)
        stable = {s: r for r, s in slot_of.items()}
        threading.Thread(target=self._await_acks,
                         args=(conns, epoch, stable), daemon=True).start()

    def _await_acks(self, conns: Dict[int, socket.socket], epoch: int,
                    stable: Dict[int, int]) -> None:
        """The ready-ack barrier (``conns`` by slot, ``stable`` maps a
        slot to its stable rank). A worker dying before its ack is
        logged: the epoch still completes (the dead worker re-registers
        into the next one after its respawn), but no store is reaped on
        it."""
        deadline = time.monotonic() + self._ready_timeout
        all_acked = True
        for rank, conn in sorted(conns.items()):
            try:
                conn.settimeout(max(0.0, deadline - time.monotonic()))
                _recv_all(conn, 4)
                with self._lock:
                    self._acked[stable[rank]] = max(
                        epoch, self._acked.get(stable[rank], 0))
            except (ConnectionError, OSError) as e:
                all_acked = False
                if not self.crashed:
                    print(f"[tracker] rank {rank} did not ack epoch "
                          f"{epoch} ({type(e).__name__}: {e})",
                          file=sys.stderr, flush=True)
            finally:
                self._close(conn)
        if all_acked and not self.crashed:
            # a crashed tracker reaps nothing: its stores stay as a kill
            # leaves them
            self._reap_old_stores(epoch)


def main(argv: Optional[List[str]] = None) -> int:
    """Standalone tracker. ``--wal-dir`` journals every control-plane
    transition; ``--resume <wal_dir>`` replays it and re-adopts a live
    world after a crash: pin ``--host``/``--port`` to the dead tracker's
    address, so the environment the workers were launched with stays
    valid. Elastic membership follows ``RABIT_ELASTIC``, the live plane
    ``RABIT_METRICS_PORT``."""
    import argparse
    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0)
    ap.add_argument("--wal-dir", default=None,
                    help="journal control-plane transitions here "
                         "(also RABIT_TRACKER_WAL_DIR)")
    ap.add_argument("--resume", metavar="WAL_DIR", default=None,
                    help="replay WAL_DIR and re-adopt the live world")
    args = ap.parse_args(argv)
    tr = Tracker(args.num_workers, host=args.host, port=args.port,
                 wal_dir=args.resume or args.wal_dir,
                 resume=args.resume is not None).start()
    print(f"[tracker] listening on {tr.host}:{tr.port}", file=sys.stderr,
          flush=True)
    try:
        tr.join()
    finally:
        tr.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
