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
by every member and every member of the store's own epoch has let go of
its world: acked a newer epoch (the data plane drops its world before it
acks), or sent ``shutdown`` (a member that evicted itself and exits says
so on its way out). A member evicted while its process lives on (the
in-process ``resize("join")``) still holds its old world until its own
re-registration tears it down, so its epoch's store stays until it has
acked a newer epoch.

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
``rabit_join_grace_ms`` (a timer of the event loop hands the bounce to
the command pool; nothing waits for it). Every transition counts
``membership.<kind>``, records a zero-length ``membership.transition``
span, leaves a flight note and
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

The multi-job control plane (``multi_job``, else ``RABIT_MULTI_JOB``; off
by default, and then task ids are never split and every byte on the wire
and in the journal is as without it): one tracker serves many
fault-isolated jobs. A task id ``<job>/<task>`` addresses job ``<job>``
(``tracker/jobs.py``), one without a separator the implicit ``default``
job. Everything derived from one world -- ranks, pending registrations,
the epoch, membership, topology, endpoints, metrics, the skew election
and the epochs' rendezvous stores -- lives on that job's ``JobState``:
two jobs' epoch 1 never share a store, and a job's reap touches only its
own. ``submit`` (+ JSON str {"job","nworkers","elastic"[,"sched_class",
"weight"]}; tracker -> worker: a JSON str verdict, answered at once:
``{"ok": 1}`` admitted or already open, ``{"ok": 0, "queued": 1,
"position": p, "retry_after_ms": n}``, ``{"ok": 0, "shed": 1,
"retry_after_ms": n}`` or ``{"ok": 0, "error": ...}``) admits a job under
``RABIT_MAX_JOBS`` and ``RABIT_MAX_FLEET_RANKS`` or parks it in the
bounded FIFO ``RABIT_ADMISSION_QUEUE``; a higher ``sched_class`` may
preempt ranks of lower-class elastic jobs (a ``quota`` record). The
journal gains ``job_open``, ``job_close`` and ``quota`` records and a
``job`` tag on every record of a non-default job, mirrored into
``<wal_dir>/<job>/``; a resume re-adopts every live job, and closes (as
``orphaned``) one whose tasks make no contact within the resume grace;
``RABIT_JOB_FORMING_TIMEOUT_MS`` closes a job nobody registers into. An
exception one job's command raises is quarantined at the job boundary
(counted on the job, a ``tracker.quarantine`` event): it closes that
connection only. The live plane adds ``/jobs``, a ``jobs`` map on
``/straggler``, job labels on ``/metrics``, the admission gauges and the
shed-rate objective on ``/slo``. The JAX tracker's
``tracker.py:2166-2523``.

The connection plane (``tracker/evloop.py``, the JAX tracker's
``tracker.py:1941-2011``): one ``EventLoop`` thread owns accept, read and
write readiness for every connection, and no thread is spent on one. A
request is read by the incremental parser (``_parse_command``, the whole
grammar above, a wire string over ``_MAX_WIRE_STR`` hangs up) and handed
to a fixed ``ServicePool`` (``RABIT_LOOP_SERVICE_THREADS``, 4), queued
by its job, so that one job's storm cannot starve another's and a job's
commands start in the order they arrived. Replies and assignments leave
through the loop's buffers; the ready-ack barrier is an ``expect`` a
member with the ready timeout, its counters kept on the loop thread and
the store reaping run on the pool; a parked joiner's bounce is a loop
timer that hands it to the pool; a ``repl`` subscriber's socket leaves
the loop (``detach``) for a streamer thread of its own. A request has no
timeout: an idle connection costs a descriptor and a buffer, and
``RABIT_LOOP_MAX_CONNS`` sheds connections past a cap at the door.
``/metrics`` adds ``rabit_tracker_open_conns`` and
``rabit_tracker_loop_lag_ms``. Nothing that runs on the pool waits for
another command, and the loop thread takes no tracker lock.

Any other command closes the connection.
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

from . import evloop as _evloop
from . import jobs as _jobs_mod
from . import membership as _membership
from . import wal as _wal_mod
from ..telemetry import clock as _clock
from ..telemetry import events as _events
from ..telemetry import incident as _incident
from ..telemetry.aggregate import format_fleet_table, merge_summaries

MAGIC = 0x52425401
NO_RANK = 0xFFFFFFFF
FLAG_DATAPLANE = 1  # registration flags bit 0
# a wire string longer than this is a protocol violation, not a payload:
# the cap keeps a flipped length bit from growing a connection's buffer
_MAX_WIRE_STR = 16 << 20


# -- the blocking helpers of the clients (membership, the repl stream) ------


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


# -- the incremental parser the event loop feeds ---------------------------
# A generator yields how many bytes it needs next and returns the parsed
# value: the grammar of the blocking helpers above, with no thread
# blocked on a request in flight (the JAX tracker's ``tracker.py:175-220``).


def _p_u32():
    return struct.unpack("<I", (yield 4))[0]


def _p_str():
    n = struct.unpack("<I", (yield 4))[0]
    if n == 0:
        return ""
    if n > _MAX_WIRE_STR:
        raise ConnectionError(f"wire string claims {n} bytes")
    return (yield n).decode()


def _parse_command():
    """One whole worker -> tracker request: the preamble (magic, cmd,
    task_id, num_attempt) and the command's own fields. ``(cmd, task_id,
    args)``, ``args`` the command's fields, or None for a bad magic (the
    connection is hung up on)."""
    magic = yield from _p_u32()
    if magic != MAGIC:
        return None
    cmd = yield from _p_str()
    task_id = yield from _p_str()
    yield from _p_u32()   # num_attempt (informational)
    if cmd in ("start", "recover", "join"):
        host = yield from _p_str()
        port = yield from _p_u32()
        flags = yield from _p_u32()
        token = yield from _p_str()
        return cmd, task_id, (host, port, flags, token)
    if cmd in ("print", "metrics", "endpoint", "resume", "evict",
               "submit"):
        payload = yield from _p_str()
        return cmd, task_id, (payload,)
    # topo, skew, world, shutdown, repl (and unknown commands) carry no
    # fields of their own
    return cmd, task_id, ()


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
FORMING_TIMEOUT_MS_DEFAULT = 0
LEASE_MS_DEFAULT = 2_000
REPL_ACK_TIMEOUT_MS_DEFAULT = 1_000

# the implicit job: the one world of a tracker without multi-job
DEFAULT_JOB = _jobs_mod.DEFAULT_JOB


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
# compacted state cannot drift from replayed state. The JAX package's fold
# (``rabit_tpu/tracker/tracker.py:383-536``), record for record.


class _ReplayWorld:
    """The state ``_replay_apply`` and ``snapshot_state`` touch, without
    the sockets and threads of a real tracker (offline folds)."""

    def __init__(self, nworkers: int, elastic: bool):
        self.nworkers = int(nworkers)
        self.elastic = bool(elastic)
        self.multi_job = False
        self._jobs: Dict[str, _jobs_mod.JobState] = {
            DEFAULT_JOB: _jobs_mod.JobState(DEFAULT_JOB, nworkers,
                                            elastic=elastic)}
        self._orphan_jobs: set = set()
        self.restarts = 0
        self.promoted_wall = 0.0
        self.promoted_mono = 0.0
        self.failover_duration_ms = 0.0
        self._lease: Optional[dict] = None
        self._journaled_lease: Optional[dict] = None


def snapshot_state(world) -> dict:
    """``world``'s replay-reachable state as a ``wal_snapshot/v1`` doc,
    the JAX tracker's field for field: the job table (each job's ranks,
    epoch, membership, scheduler fields, topology, skew, endpoints and
    shutdown ranks), restarts, a promotion and the journaled lease --
    nothing ephemeral (pending registrations, sockets and stores die with
    the process). The caller holds a live tracker's lock."""
    jobs: Dict[str, dict] = {}
    for jid, jb in world._jobs.items():
        jd: Dict[str, object] = {
            "nworkers": jb.nworkers, "elastic": jb.elastic,
            "sched_class": jb.sched_class, "weight": jb.sched_weight,
            "quota": jb.quota, "preempted": jb.preempted,
            "closed": not jb.open, "closed_reason": jb.closed_reason,
            "ranks": dict(jb._ranks), "epoch": jb._epoch,
            "topo": dict(jb._topo), "skew": dict(jb._skew),
            "endpoints": {t: dict(d) for t, d in jb._endpoints.items()},
            "down": sorted(jb._shutdown_ranks)}
        if jb.elastic and jb._member is not None:
            mv = jb._member
            jd["member"] = {
                "target": mv.target, "live": sorted(mv.live),
                "evicted": sorted(mv.evicted), "joining": sorted(mv.joining),
                "generation": mv.generation, "evictions": mv.evictions,
                "admissions": mv.admissions}
        jobs[jid] = jd
    doc: Dict[str, object] = {"multi_job": bool(world.multi_job),
                              "restarts": int(world.restarts),
                              "jobs": jobs}
    if world.promoted_wall or world.failover_duration_ms:
        doc["promoted"] = {
            "wall": world.promoted_wall, "mono": world.promoted_mono,
            "failover_ms": world.failover_duration_ms}
    if world._journaled_lease is not None:
        doc["lease"] = dict(world._journaled_lease)
    return doc


def _replay_adopt_into(world, state: dict) -> None:
    """Adopt one ``wal_snapshot/v1`` doc: it replaces the job table and
    the journaled state, and the journal's tail then replays on top. The
    default job is adopted in place (its shape, nworkers and elastic, is
    the launch's, as a full replay never changes it); every other job is
    rebuilt from its snapshotted shape."""
    from ..telemetry import skew as _skew_mod
    if state.get("multi_job"):
        world.multi_job = True
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
    keep = {DEFAULT_JOB: world._jobs[DEFAULT_JOB]}
    world._orphan_jobs.clear()
    for jid, jd in (state.get("jobs") or {}).items():
        jid = str(jid)
        job = keep.get(jid)
        if job is None:
            job = _jobs_mod.JobState(
                jid, int(jd.get("nworkers", world.nworkers)),
                elastic=bool(jd.get("elastic", False)),
                sched_class=int(jd.get("sched_class", 0)),
                sched_weight=float(jd.get("weight", 1.0)))
            keep[jid] = job
        job.quota = int(jd.get("quota", job.nworkers))
        job.preempted = int(jd.get("preempted", 0))
        job._ranks = {str(t): int(r)
                      for t, r in (jd.get("ranks") or {}).items()}
        job._epoch = int(jd.get("epoch", 0))
        job._topo = dict(jd.get("topo") or {})
        digest = dict(jd.get("skew") or {})
        if digest:
            job._skew = digest
            job._skew_election = _skew_mod.FleetElection.seeded(digest)
        job._endpoints = {str(t): dict(d) for t, d in
                          (jd.get("endpoints") or {}).items()}
        job._shutdown_ranks = {int(r) for r in jd.get("down") or []}
        m = jd.get("member")
        if job.elastic and job._member is not None and m:
            mv = job._member
            mv.target = int(m.get("target", job.nworkers))
            mv.live = {int(r) for r in m.get("live") or []}
            mv.evicted = {int(r) for r in m.get("evicted") or []}
            mv.joining = {int(r) for r in m.get("joining") or []}
            mv.generation = int(m.get("generation", 0))
            mv.evictions = int(m.get("evictions", 0))
            mv.admissions = int(m.get("admissions", 0))
        if jd.get("closed"):
            job.close(str(jd.get("closed_reason", "")))
        if jid != DEFAULT_JOB and job.open:
            world._orphan_jobs.add(jid)
    world._jobs = keep


def _replay_apply(world, kind: str, data: dict) -> None:
    """Apply one journaled ``(kind, data)`` record to ``world`` (a tracker
    under construction or a :class:`_ReplayWorld`). A record tagged
    ``job`` replays into that job; ``job_open``/``job_close`` rebuild the
    job table. Raw mutations are deliberate: this IS the journal's read
    side."""
    from ..telemetry import skew as _skew_mod
    if kind == _wal_mod.SNAPSHOT_KIND:
        _replay_adopt_into(world, data.get("state") or {})
        return
    jid = str(data.get("job", DEFAULT_JOB))
    if kind == "job_open":
        # a journaled open proves multi-job was on when it was written
        world.multi_job = True
        prev = world._jobs.get(jid)
        if prev is None or not prev.open:
            world._jobs[jid] = _jobs_mod.JobState(
                jid, int(data.get("nworkers", world.nworkers)),
                elastic=bool(data.get("elastic", False)),
                sched_class=int(data.get("sched_class", 0)),
                sched_weight=float(data.get("weight", 1.0)))
            if jid != DEFAULT_JOB:
                world._orphan_jobs.add(jid)
        return
    if kind == "job_close":
        closing = world._jobs.get(jid)
        if closing is not None:
            closing.close(str(data.get("reason", "")))
        world._orphan_jobs.discard(jid)
        return
    job = world._jobs.get(jid)
    if job is None:
        # tagged records outlived a torn job_open: the tags prove the
        # job existed, so it is adopted
        world.multi_job = True
        job = _jobs_mod.JobState(jid, world.nworkers, elastic=world.elastic)
        world._jobs[jid] = job
        if jid != DEFAULT_JOB:
            world._orphan_jobs.add(jid)
    if kind == "assign":
        job._ranks[str(data["task"])] = int(data["rank"])
    elif kind == "epoch":
        job._epoch = int(data["epoch"])
        if job.elastic and job._member is not None:
            job._member.formed(data.get("members", []))
    elif kind == "park":
        if job.elastic and job._member is not None:
            job._member.park(int(data["rank"]))
    elif kind == "evict":
        if job.elastic and job._member is not None:
            job._member.evict(int(data["rank"]))
    elif kind == "quota":
        # a preemption's transfer of capacity outlives a resume: without
        # it the victim would claim its full nworkers again and
        # over-commit the fleet's cap
        job.quota = int(data.get("quota", job.quota))
        job.preempted = int(data.get("preempted", job.preempted))
    elif kind == "topo":
        job._topo = dict(data.get("doc") or {})
    elif kind == "skew":
        digest = dict(data.get("digest") or {})
        job._skew = digest
        job._skew_election = _skew_mod.FleetElection.seeded(digest)
    elif kind == "endpoint":
        job._endpoints[str(data["task"])] = dict(data["doc"])
    elif kind == "down":
        job._shutdown_ranks.add(int(data["rank"]))
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


def forming_timeout_ms() -> int:
    """``rabit_job_forming_timeout_ms``: close an open multi-job job that
    has held an admission slot this long with no registered rank, no
    pending registration and no wire contact (0, the default: never). It
    guards a serving fleet against ghost jobs -- admitted from the queue
    after their submitter gave up, or flooded in by a storm of submits --
    that would hold admission capacity for good."""
    v = os.environ.get("RABIT_JOB_FORMING_TIMEOUT_MS")
    if not v:
        return FORMING_TIMEOUT_MS_DEFAULT
    try:
        return max(0, int(v))
    except ValueError:
        raise ValueError(
            f"RABIT_JOB_FORMING_TIMEOUT_MS must be an integer (ms), "
            f"got {v!r}")


def _default_attr(name: str) -> property:
    """The default job's ``name``, read and written through the tracker:
    the single-job surface (the launcher, the smokes, the tests) keeps
    reading one world off the tracker."""
    return property(lambda self: getattr(self._default, name),
                    lambda self, v: setattr(self._default, name, v))


class Tracker:
    def __init__(self, nworkers: int, host: str = "127.0.0.1", port: int = 0,
                 ready_timeout: Optional[float] = None,
                 metrics_port: Optional[int] = None,
                 elastic: Optional[bool] = None,
                 wal_dir: Optional[str] = None,
                 resume: bool = False,
                 link_rewrite=None,
                 lease_ms: Optional[int] = None,
                 node_id: str = "leader",
                 multi_job: Optional[bool] = None):
        self.nworkers = nworkers   # the default job's target
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(256)
        self.host, self.port = self.sock.getsockname()
        # the connection plane: one readiness loop owns every connection,
        # a fixed pool serves the parsed commands queued by job (made once
        # the port is bound: a bind that fails leaves nothing to close)
        self._loop = _evloop.EventLoop()
        self._svc = _evloop.ServicePool(name="rabit-tracker-svc")
        self._ready_timeout = (ready_timeout if ready_timeout is not None
                               else _default_ready_timeout())
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.messages: List[str] = []
        # elastic membership (off unless asked for, or RABIT_ELASTIC):
        # with it off every batch is the full fixed world. It is the
        # default job's, and the shape of a job a registration opens
        if elastic is None:
            elastic = _membership.elastic_enabled()
        self.elastic = bool(elastic)
        # the multi-job plane (off unless asked for, or RABIT_MULTI_JOB):
        # the world's state lives on a JobState a job; the implicit
        # default job always exists and, with multi-job off, IS the
        # tracker's one world, its task ids never split
        if multi_job is None:
            multi_job = _jobs_mod.multi_job_enabled()
        self.multi_job = bool(multi_job)
        self._default = _jobs_mod.JobState(DEFAULT_JOB, nworkers,
                                           elastic=self.elastic)
        self._jobs: Dict[str, _jobs_mod.JobState] = {
            DEFAULT_JOB: self._default}
        # admission: the caps as at construction, and a bounded FIFO of
        # the submissions that do not fit now
        self._admission = _jobs_mod.AdmissionQueue()
        self._max_jobs = _jobs_mod.max_jobs()
        self._max_fleet_ranks = _jobs_mod.max_fleet_ranks()
        # admitted verdicts: with the queue's queued_total and shed_total
        # the shed-rate objective's denominator
        self.submit_admitted_total = 0
        # jobs a resume re-adopted whose tasks made no contact yet: closed
        # ("orphaned") once the resume grace has passed
        self._orphan_jobs: set = set()
        # the last wire contact a job (monotonic; the forming timeout)
        self._job_contact: Dict[str, float] = {}
        # the fleet scheduler: the recent closes give the retry hint its
        # measured drain rate; preemptions by the victim's class
        self._drain_t: Deque[float] = deque(maxlen=16)
        self.sched_preemptions: Dict[int, int] = {}
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
        # a non-default job's mirror of its own records, for inspection
        self._job_wals: Dict[str, _wal_mod.WriteAheadLog] = {}
        self.restarts = 0                      # resumes of this journal
        self._grace_until = 0.0                # the resume grace's end
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
                for job in self._jobs.values():
                    if job.open and job._epoch > 0:
                        job.mark_live()
                self.replayed = len(records)
                self.replay_ms = (time.perf_counter() - t0) * 1e3
                self.restarts += 1
                self._wal("resume", restarts=self.restarts,
                          epoch=self._epoch)
                self._grace_until = (time.monotonic()
                                     + resume_grace_ms() / 1e3)
                self._note_resume(len(records))

    # the default job's world, read (and, by tests, written) through the
    # tracker; the tracker's own code goes through a job
    _ranks = _default_attr("_ranks")
    _pending = _default_attr("_pending")
    _epoch = _default_attr("_epoch")
    _shutdown_ranks = _default_attr("_shutdown_ranks")
    _metrics = _default_attr("_metrics")
    _endpoints = _default_attr("_endpoints")
    _endpoint_misses = _default_attr("_endpoint_misses")
    _topo = _default_attr("_topo")
    _skew = _default_attr("_skew")
    _skew_election = _default_attr("_skew_election")
    _member = _default_attr("_member")
    _resumed_ranks = _default_attr("_resumed_ranks")
    _last_straggler = _default_attr("_last_straggler")
    _stores = _default_attr("_stores")
    _acked = _default_attr("_acked")

    def job(self, job_id: str) -> Optional[_jobs_mod.JobState]:
        """The JobState of ``job_id`` (None: never opened)."""
        with self._lock:
            return self._jobs.get(str(job_id))

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
        self._drop_streams()
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None  # noqa: C003 - lifecycle teardown
        self._stop_plane()
        with self._lock:
            for jb in self._jobs.values():
                jb._pending.clear()   # the loop closed their connections
                # workers have exited (or been killed) by now: no live
                # client is left on these stores
                jb._stores = []
        if self._wal_log is not None and not self.crashed:
            self._wal_log.close()
            with self._repl_cv:
                mirrors = list(self._job_wals.values())
                self._job_wals.clear()
            for w in mirrors:
                try:
                    w.close()
                except (OSError, _wal_mod.WalError):
                    pass   # a mirror is best-effort

    def crash(self) -> None:
        """A tracker crash without the process exit (tests, the
        launcher's supervisor): the listener and the background threads
        die and every connection in flight is dropped hard, but nothing
        is flushed, closed gracefully or reaped -- the journal's handle
        and the epochs' stores stay as a kill leaves them (every record
        was fsynced on append), ready for a ``resume=True`` successor on
        the same pinned port. Parked joiners are dropped with every other
        connection of the loop."""
        with self._lock:
            # under the lock, where every record is written: no record
            # lands after this (``_wal`` refuses once crashed)
            self.crashed = True
        self._done.set()
        self._poll_stop.set()
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None  # noqa: C003 - lifecycle teardown
        # every connection dies hard, a repl stream too: its follower sees
        # EOF at once, and its streamer thread ends on the dropped socket
        self._stop_plane()
        self._drop_streams()

    def _drop_streams(self) -> None:
        """Wake the ``repl`` streamers and drop their sockets: a streamer
        blocked on an ack wakes at once, its follower reads EOF."""
        with self._repl_cv:
            self._repl_cv.notify_all()
            streams = list(self._repl_conns)
        for conn in streams:
            _drop(conn)

    def _stop_plane(self) -> None:
        """Stop the connection plane: the pool first (a queued handler
        may still queue a reply, and the loop's teardown runs its op queue
        once more), then the loop, which closes every connection; the
        listener is shut so that the port stops listening at once and a
        successor can bind it. Waits for the loop's teardown, unless
        called on the loop's own thread."""
        self._svc.stop()
        self._loop.stop()
        _drop(self.sock)
        serve = self._thread
        if serve is None:
            self._loop.run()   # never started: run() only tears down
        elif serve is not threading.current_thread():
            serve.join(10)

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
    def _wal(self, kind: str, _job=None, **data) -> None:
        """Journal one control-plane transition (a no-op with the WAL
        off). Callers hold the tracker's lock and call this BEFORE acting
        on the transition: a crash between the two replays the intent,
        never loses it. A crashed tracker journals nothing more (its
        successor may own the file already). Every journaled record is
        also published to ``repl`` subscribers as the exact frame bytes
        that reached the disk; an idempotent lease renewal is not
        journaled but becomes the stream's seq-0 heartbeat. ``_job`` is
        the owning JobState: with multi-job on, a non-default job's
        records carry its ``job`` tag and are mirrored into its own
        ``<wal_dir>/<job>/``; the default job's stay untagged, so a
        journal with multi-job off is the single-job tracker's."""
        if self._wal_log is None:
            return
        if self.crashed:
            raise ConnectionError("the tracker crashed")
        jid = None
        if self.multi_job:
            if _job is not None and _job.job_id != DEFAULT_JOB:
                jid = _job.job_id
                data = dict(data)
                data["job"] = jid
            elif str(data.get("job", DEFAULT_JOB)) != DEFAULT_JOB:
                jid = str(data["job"])      # job_open, job_close
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
            if jid is not None:
                self._mirror_job_record_locked(jid, kind, data)
        if self._snap_every and not self._snap_pending and \
                seq - self._wal_log.snapshot_seq >= self._snap_every:
            # compact off the journaling path: a task of the pool folds
            # the state under the lock once this caller has released it
            self._snap_pending = True  # noqa: C003 - advisory flag
            self._svc.submit("__wal_snapshot__", self._take_snapshot)

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
                    for jid, w in list(self._job_wals.items()):
                        jd = state["jobs"].get(jid)
                        if jd is None:
                            continue
                        try:
                            w.snapshot({"multi_job": True,
                                        "jobs": {jid: jd}})
                        except (OSError, _wal_mod.WalError):
                            pass   # a mirror is best-effort
        finally:
            self._snap_pending = False  # noqa: C003 - advisory flag

    def _mirror_job_record_locked(self, jid: str, kind: str,
                                  data: dict) -> None:
        """Mirror one record into its job's own journal (the caller,
        ``_wal``, holds ``_repl_cv``). The root journal is the authority:
        a mirror that cannot open or append is dropped, never a failed
        transition."""
        try:
            w = self._job_wals.get(jid)
            if w is None and kind != "job_close":
                w = _wal_mod.WriteAheadLog(os.path.join(self.wal_dir, jid))
                w.open(resume=os.path.exists(w.path))
                self._job_wals[jid] = w
            if w is not None:
                w.record(kind,
                         **{k: v for k, v in data.items() if k != "job"})
                if kind == "job_close":
                    w.close()
                    self._job_wals.pop(jid, None)
        except (OSError, ValueError, _wal_mod.WalError):
            pass   # a mirror is best-effort

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
        """One ``repl`` subscriber, its socket taken off the loop, on a
        streamer thread of its own for as long as the follower keeps
        acking: every record at or past its resync point, one ack a
        record, and the lease heartbeats between them. A slow, torn or
        confused follower is dropped (it resubscribes from its last
        durable seq): replication never stalls the control plane."""
        sub = {"peer": peer, "acked": 0}
        with self._repl_cv:
            self._repl_conns.add(conn)   # from here on stop() drops it
        try:
            if self._done.is_set():
                return
            conn.settimeout(repl_ack_timeout_ms() / 1e3)
            _send_u32(conn, 1)
            last = _recv_u32(conn)
            sub["acked"] = last
            with self._repl_cv:
                if self._done.is_set():
                    return
                self._repl_subs.append(sub)
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
            conn.close()

    def _note_resume(self, nrecords: int) -> None:
        """Make a resume observable: a counter, a zero-length span, a
        flight note, a fleet event (``_fleet_emit``) and a line on
        stderr."""
        from .. import telemetry
        from ..telemetry import flight
        detail = (f"replayed {nrecords} WAL records, restart "
                  f"#{self.restarts}, epoch {self._epoch}")
        live_jobs = sorted(j.job_id for j in self._jobs.values() if j.open)
        jobs_note = f", jobs {live_jobs}" if self.multi_job else ""
        telemetry.count("tracker.resume", provenance="tracker")
        telemetry.record_span("tracker.resume", 0.0, op="resume",
                              provenance="tracker", records=nrecords,
                              restarts=self.restarts)
        flight.note("tracker_resume", detail + jobs_note)
        self._fleet_emit("tracker.resume", detail)
        print(f"[tracker] resumed from WAL ({nrecords} records, restart "
              f"#{self.restarts}, epoch {self._epoch}, {len(self._ranks)} "
              f"known ranks{jobs_note})", file=sys.stderr, flush=True)

    def _resume_present(self, job, task_id: str, rank: int,
                        epoch: int) -> bool:
        """Reconcile one worker's ``resume`` handshake against the
        replayed journal of its job: a matching identity confirms it, an
        unknown task id with a free rank is adopted (a torn tail can lose
        the last ``assign``: the live worker is the authority on its own
        rank), and a contradiction is refused, so the worker falls back
        to a full re-registration."""
        with self._lock:
            known = job._ranks.get(task_id)
            if known is None and 0 <= rank < job.nworkers \
                    and rank not in job._ranks.values():
                self._wal("assign", task=task_id, rank=rank, _job=job)
                job._ranks[task_id] = rank
                known = rank
            ok = known == rank and epoch <= job._epoch + 1
            if ok:
                job._endpoint_misses[task_id] = 0
                job._resumed_ranks.add(rank)
        return ok

    def store_count(self, job_id: Optional[str] = None) -> int:
        """Rendezvous stores still hosted (old epochs are reaped) by the
        default job, or by ``job_id`` (0 for a job never opened)."""
        with self._lock:
            job = self._jobs.get(DEFAULT_JOB if job_id is None
                                 else str(job_id))
            return 0 if job is None else len(job._stores)

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
        """The serve thread: the readiness loop. Accept, read and write
        readiness of every connection live on this one thread; the parsed
        commands drain through the fixed pool."""
        try:
            self._loop.add_listener(self.sock, self._on_accept)
        except (OSError, ValueError):
            pass   # stop() or crash() shut the listener first
        else:
            self._svc.start()
        self._loop.run()

    def _on_accept(self, conn) -> None:
        """Loop thread: arm the incremental parser on a new connection."""
        self._loop.start_parse(conn, _parse_command(), self._on_command)

    def _on_command(self, conn, parsed) -> None:
        """Loop thread: one whole request parsed. Resolve its job and
        queue it there; the pool serves the jobs' queues round-robin."""
        if parsed is None:   # a bad magic: hang up
            self._loop.close_conn(conn)
            return
        cmd, task_id, args = parsed
        job_id = DEFAULT_JOB
        if self.multi_job:
            job_id, task_id = _jobs_mod.split_task(task_id)
        self._svc.submit(job_id, lambda: self._handle(
            conn, cmd, job_id, task_id, args))

    def _handle(self, conn, cmd: str, job_id: str, task_id: str,
                args: tuple) -> None:
        """One command on a pool thread. A registration's connection stays
        open, parked in its job's ``_pending`` until its batch is
        complete; every other command is answered and closed. An exception
        a job's command raises stops at the job boundary: it is
        quarantined and closes this connection only; a wire error is the
        peer's and closes it too."""
        try:
            try:
                self._dispatch(conn, cmd, job_id, task_id, args)
            except (ConnectionError, OSError, struct.error):
                raise
            except Exception as e:   # the job's fault boundary
                self._quarantine(job_id, cmd, e)
                self._loop.close_conn(conn)
        except (ConnectionError, OSError, struct.error):
            self._loop.close_conn(conn)

    def _dispatch(self, conn, cmd: str, job_id: str, task_id: str,
                  args: tuple) -> None:
        """Serve one parsed command within its job."""
        if cmd in ("start", "recover", "join"):
            host, port, flags, token = args
            job = self._job_for_register(job_id)
            if job is None:
                # admission refused: shed, never parked
                self._loop.close_conn(conn)
                return
            self._register(conn, job, task_id, host, port, flags, token,
                           join=cmd == "join")
        elif cmd == "print":
            self.messages.append(args[0])
            print(args[0], flush=True)
            self._reply_u32(conn, 1)
        elif cmd == "metrics":
            try:
                doc = json.loads(args[0])
            except ValueError:
                doc = None
            job = self._job_for(job_id)
            ok = isinstance(doc, dict) and job is not None
            if ok:
                with self._lock:
                    job._metrics[task_id] = doc
                self._fold_events(task_id, doc, job)
            self._reply_u32(conn, 1 if ok else 0)
        elif cmd == "shutdown":
            job = self._job_for(job_id)
            all_down = down = False
            if job is not None:
                with self._lock:
                    rank = job._ranks.get(task_id)
                    if rank is not None:
                        # journaled, so a tracker resumed mid-teardown
                        # still sees the job complete (a worker sends
                        # shutdown once)
                        self._wal("down", rank=rank, _job=job)
                        job._shutdown_ranks.add(rank)
                        down = True
                    all_down = job.all_down_locked()
            self._reply_u32(conn, 1)
            if down:
                # the rank let go of its world: a store kept for it alone
                # may go now
                self._reap_old_stores(job)
            if all_down:
                self._job_complete(job)
        elif cmd == "endpoint":
            try:
                doc = json.loads(args[0])
            except ValueError:
                doc = None
            job = self._job_for(job_id)
            ok = (isinstance(doc, dict) and "host" in doc
                  and "port" in doc and job is not None)
            if ok:
                ep = {"host": str(doc["host"]), "port": int(doc["port"]),
                      "rank": int(doc.get("rank", -1))}
                with self._lock:
                    self._wal("endpoint", task=task_id, doc=ep, _job=job)
                    job._endpoints[task_id] = ep
                    # a (re-)announce is proof of life: no earlier
                    # misses count toward an eviction
                    job._endpoint_misses[task_id] = 0
            self._reply_u32(conn, 1 if ok else 0)
        elif cmd == "world":
            self._reply_json(conn, self.membership_doc(self._job_for(job_id)))
        elif cmd in ("evict", "resume"):
            try:
                doc = json.loads(args[0])
            except ValueError:
                doc = None
            job = self._job_for(job_id)
            ok = False
            if isinstance(doc, dict) and doc.get("rank") is not None \
                    and job is not None:
                try:
                    if cmd == "evict":
                        ok = self.evict_rank(int(doc["rank"]),
                                             str(doc.get("reason", "")),
                                             job=job)
                    else:
                        # a live worker re-presents its identity to a
                        # (possibly resumed) tracker
                        ok = self._resume_present(
                            job, task_id, int(doc["rank"]),
                            int(doc.get("epoch", 0)))
                except (TypeError, ValueError):
                    ok = False
            self._reply_u32(conn, 1 if ok else 0)
        elif cmd in ("topo", "skew"):
            job = self._job_for(job_id)
            with self._lock:
                doc = ({} if job is None
                       else dict(job._topo if cmd == "topo" else job._skew))
            self._reply_json(conn, doc)
        elif cmd == "submit":
            # admission answers at once: overload sheds, it never stalls
            # a submitter's socket
            self._reply_json(conn, self._submit(args[0]))
        elif cmd == "repl":
            if self._wal_log is None:
                self._reply_u32(conn, 0)   # replication needs a journal
            else:
                # a subscriber follows for the tracker's life, not for a
                # request's: its socket leaves the loop for a streamer
                # thread of its own, one a standby
                self._loop.call(lambda: self._detach_repl(conn, task_id))
        else:
            self._loop.close_conn(conn)

    def _detach_repl(self, conn, peer: str) -> None:
        """Loop thread: take a ``repl`` subscriber's socket off the loop
        (blocking again) and start its streamer."""
        if conn.closed or conn.detached:
            return
        raw, leftover = self._loop.detach(conn)
        if leftover:
            # a protocol violation: a follower sends its resync seq only
            # after the tracker's ok
            raw.close()
            return
        threading.Thread(target=self._serve_repl, args=(raw, peer),
                         name="rabit-tracker-repl", daemon=True).start()

    # -- the live plane -------------------------------------------------------
    def _start_live_plane(self) -> None:
        """The fleet metrics endpoint and the poll thread, when a metrics
        port is configured. A port that does not bind is a warning, never
        a failed rendezvous."""
        if self._metrics_port is None:
            return
        from ..telemetry import live
        identity = {"role": "tracker", "nworkers": self.nworkers}
        if self.multi_job:
            identity["multi_job"] = True
        if self.lease_ms:
            # the supervisor's probe before a cold respawn reads this: a
            # tracker whose /healthz says tracker_role "leader" IS the
            # control plane (a promoted standby says so too)
            identity.update({"tracker_role": "leader",
                             "node": self.node_id,
                             "promoted": bool(self.promoted)})
        try:
            # C003: set once at start, torn down at stop or crash
            self._metrics_server = live.MetricsServer(  # noqa: C003
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
        routes = {"/straggler": self._straggler_doc,
                  "/jobs": self._jobs_doc,
                  "/slo": self._slo_doc}
        if self._events_on:
            routes["/events"] = self._events_doc
            routes["/incidents"] = self._incidents_doc
        return routes

    def _jl(self, jid: str, **labels) -> Dict[str, str]:
        """A gauge row's labels: a ``job`` label only with multi-job on,
        so a single-job exposition stays as it was."""
        if self.multi_job:
            labels["job"] = jid
        return labels

    def _jobs_shown_locked(self) -> list:
        """The jobs the live plane reports (caller holds the lock): every
        job with multi-job on, else the one world."""
        return (list(self._jobs.values()) if self.multi_job
                else [self._default])

    def _metric_sources(self) -> list:
        """One Prometheus source a polled rank: its summary, labelled with
        its rank (and, multi-job, its job)."""
        with self._lock:
            return [(self._jl(jb.job_id, rank=str(doc.get("rank", -1))), doc)
                    for jb in self._jobs_shown_locked()
                    for doc in jb._metrics.values()]

    def _job_snapshots_locked(self) -> List[dict]:
        """Each shown job's gauge state, taken under the lock."""
        snap = []
        for jb in self._jobs_shown_locked():
            m = jb._member if jb.elastic else None
            snap.append({
                "id": jb.job_id, "status": jb.status,
                "elastic": jb.elastic, "nend": len(jb._endpoints),
                "topo": dict(jb._topo), "skew": dict(jb._skew),
                "strag": jb._last_straggler,
                "world": jb.nworkers if m is None else m.world(),
                "evictions": 0 if m is None else m.evictions,
                "admissions": 0 if m is None else m.admissions,
                "quarantined": jb.quarantined})
        return snap

    def _live_gauges(self) -> list:
        with self._lock:
            snap = self._job_snapshots_locked()
            polls = self._poll_count
            queued_total = self._admission.queued_total
            shed_total = self._admission.shed_total
            preempt = dict(self.sched_preemptions)
        qdepth = len(self._admission)
        gauges = [
            ("rabit_tracker_endpoints",
             "Worker metrics endpoints known to the tracker.", "gauge",
             [(self._jl(s["id"]), s["nend"]) for s in snap]),
            ("rabit_tracker_polls_total", "Completed endpoint poll sweeps.",
             "counter", [({}, polls)]),
            ("rabit_tracker_open_conns",
             "Worker connections currently held by the selectors event "
             "loop (each costs a descriptor and a buffer, never a "
             "thread).", "gauge", [({}, self._loop.open_conns)]),
            ("rabit_tracker_loop_lag_ms",
             "EWMA of loop wakeup service time — the delay a newly "
             "ready connection waits behind the current batch.",
             "gauge", [({}, round(self._loop.lag_ms(), 4))]),
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
        elastic_rows = [s for s in snap if s["elastic"]]
        if elastic_rows:
            gauges.append((
                "rabit_world_size",
                "Live world size of the current membership epoch "
                "(elastic jobs shrink below the launch target and "
                "grow back on re-admission).", "gauge",
                [(self._jl(s["id"]), s["world"]) for s in elastic_rows]))
            gauges.append((
                "rabit_member_evictions_total",
                "Ranks evicted from the live job (watchdog/poll "
                "evidence or the evict command).", "counter",
                [(self._jl(s["id"]), s["evictions"])
                 for s in elastic_rows]))
            gauges.append((
                "rabit_member_admissions_total",
                "Parked joiners admitted at an epoch boundary.",
                "counter", [(self._jl(s["id"]), s["admissions"])
                            for s in elastic_rows]))
        topo_rows = [s for s in snap if s["topo"].get("groups")]
        if topo_rows:
            gauges.append((
                "rabit_tracker_topology_hosts",
                "Distinct hosts in the current link-registration epoch.",
                "gauge", [(self._jl(s["id"]), len(s["topo"]["groups"]))
                          for s in topo_rows]))
            rows = []
            for s in topo_rows:
                sizes = [len(g) for g in s["topo"]["groups"]]
                rows.append((self._jl(s["id"], stat="min"), min(sizes)))
                rows.append((self._jl(s["id"], stat="max"), max(sizes)))
            gauges.append((
                "rabit_tracker_topology_ranks_per_host",
                "Ranks per host (max label distinguishes ragged "
                "groupings, which disable the hierarchical schedule).",
                "gauge", rows))
        strag_rows = [s for s in snap if s["strag"] is not None
                      and s["strag"].get("lagging_rank") is not None]
        if strag_rows:
            gauges.append((
                "rabit_straggler_lag_collectives",
                "Collectives the laggard is behind the leader.", "gauge",
                [(self._jl(s["id"], rank=str(s["strag"]["lagging_rank"])),
                  s["strag"]["lag_collectives"]) for s in strag_rows]))
            gauges.append((
                "rabit_straggler_busy_skew_seconds",
                "Spread of per-rank collective busy time.", "gauge",
                [(self._jl(s["id"]), s["strag"]["busy_skew_s"])
                 for s in strag_rows]))
        skew_rows = [s for s in snap if s["skew"].get("offsets_ms")]
        if skew_rows:
            gauges.append((
                "rabit_skew_offset_ms",
                "Per-rank mean arrival offset behind the earliest rank "
                "(the skew digest served to workers).", "gauge",
                [(self._jl(s["id"], rank=str(r)), v) for s in skew_rows
                 for r, v in sorted(s["skew"]["offsets_ms"].items(),
                                    key=lambda kv: int(kv[0]))]))
            gauges.append((
                "rabit_skew_epoch",
                "Fleet skew election epoch (bumps when the served "
                "laggard verdict changes).", "gauge",
                [(self._jl(s["id"]), s["skew"].get("epoch", 0))
                 for s in skew_rows]))
        if self.multi_job:
            by_status: Dict[str, int] = {}
            for s in snap:
                by_status[s["status"]] = by_status.get(s["status"], 0) + 1
            gauges.append((
                "rabit_tracker_jobs",
                "Jobs known to this tracker by lifecycle status "
                "(forming/live/failed/closed).", "gauge",
                [({"status": st}, n) for st, n in sorted(by_status.items())]))
            gauges.append((
                "rabit_admission_queue_depth",
                "Submitted jobs parked in the bounded FIFO admission "
                "queue right now.", "gauge", [({}, qdepth)]))
            gauges.append((
                "rabit_admission_queued_total",
                "Job submissions parked (they retry after the hinted "
                "backoff).", "counter", [({}, queued_total)]))
            gauges.append((
                "rabit_admission_shed_total",
                "Job submissions shed past the queue depth — overload "
                "answered with backoff, never a stall.", "counter",
                [({}, shed_total)]))
            gauges.append((
                "rabit_job_quarantined_total",
                "Commands quarantined at this job's fault boundary "
                "(exceptions that never reached the accept loop).",
                "counter", [(self._jl(s["id"]), s["quarantined"])
                            for s in snap]))
            gauges.append((
                "rabit_sched_preemptions_total",
                "Ranks preempted from running jobs by priority-class "
                "admission, labeled by the VICTIM's class.", "counter",
                [({"sched_class": str(c)}, n)
                 for c, n in sorted(preempt.items())]
                or [({"sched_class": "0"}, 0)]))
        if self.promoted:
            gauges.append((
                "rabit_failover_duration_ms",
                "Leader-kill to standby-promoted duration, stamped by "
                "the control plane at promotion (tracker/standby.py).",
                "gauge", [({"node": self.node_id},
                           round(self.failover_duration_ms, 3))]))
        if self.multi_job or self.lease_ms:
            # the SLO burn gauges only where the tracker has something to
            # judge (admission, a failover): a plain tracker's exposition
            # is as before
            from ..telemetry import slo as _slo
            gauges.extend(_slo.gauges(self._slo_verdicts()))
        if self._events_on:
            # the incident plane's gauges, only with the plane on
            gauges.extend(_incident.gauges(self._incidents.open_docs(),
                                           self._events_dropped_total()))
        return gauges

    def _straggler_doc(self) -> dict:
        """The ``/straggler`` route: the default job's last snapshot and,
        multi-job, a ``jobs`` map of every job's own."""
        with self._lock:
            strag = self._default._last_straggler
            per_job = ({jb.job_id: jb._last_straggler
                        for jb in self._jobs.values()
                        if jb._last_straggler is not None}
                       if self.multi_job else None)
        doc = (dict(strag) if strag is not None
               else {"ranks": [], "signal": False})
        if per_job is not None:
            doc["jobs"] = per_job
        return doc

    def _jobs_doc(self) -> dict:
        """The ``/jobs`` route: each job's health and the admission
        plane."""
        with self._lock:
            docs = [jb.doc() for jb in self._jobs.values()]
            queued_total = self._admission.queued_total
            shed_total = self._admission.shed_total
        return {"multi_job": bool(self.multi_job), "jobs": docs,
                "queue": self._admission.snapshot(),
                "queued_total": queued_total, "shed_total": shed_total,
                "max_jobs": self._max_jobs,
                "max_fleet_ranks": self._max_fleet_ranks}

    def _slo_verdicts(self) -> list:
        """The objectives a tracker can judge on its own: the failover
        time, once promoted, and the admission shed rate (shed over every
        verdict of a submit that was admitted, queued or shed)."""
        from ..telemetry import slo as _slo
        with self._lock:
            shed = self._admission.shed_total
            queued = self._admission.queued_total
            admitted = self.submit_admitted_total
        measured: Dict[str, float] = {}
        if self.promoted and self.failover_duration_ms > 0:
            measured["failover_ms"] = self.failover_duration_ms
        total = admitted + queued + shed
        if total:
            measured["shed_rate"] = shed / total
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

    def _fold_events(self, task_id: str, doc: dict, job=None) -> None:
        """Fold one worker summary's event ring into the fleet log.
        Every scrape re-ships the whole ring: the task's ``seq`` is the
        dedup cursor. The worker's HLC merges into the tracker's, so
        every later tracker stamp follows what it has observed, and the
        worker's cumulative ring drops feed the fleet-wide gauge. A
        record without a job takes its task's job (``job``, else the
        default job)."""
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
                    rec["job"] = DEFAULT_JOB if job is None else job.job_id
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
                jobs_now = [jb for jb in self._jobs.values() if jb.open]
            polled = False
            since_snapshot += 1
            for job in jobs_now:
                with self._lock:
                    endpoints = dict(job._endpoints)
                if endpoints:
                    polled = True
                    since_snapshot = self._poll_sweep(job, endpoints,
                                                      since_snapshot)
            if polled:
                with self._lock:
                    self._poll_count += 1
            if self._events_on:
                # the incident sweep rides the poll cadence even when no
                # endpoint answered: the tracker's own events (membership,
                # admission, SLO edges, a promotion) still need correlating
                self._incident_sweep()

    def _poll_sweep(self, job, endpoints: Dict[str, dict],
                    since_snapshot: int) -> int:
        """One pass over a job's announced endpoints: scrape each, evict
        the silent ones (elastic; only within the silent endpoint's own
        job), elect the job's laggard through its own election and serve
        the digest; returns the sweeps since the last straggler line."""
        from ..telemetry import crossrank, live, skew
        for tid, ep in endpoints.items():
            doc = live.scrape_json(ep["host"], ep["port"])
            if doc is not None:
                with self._lock:
                    job._metrics[tid] = doc
                    job._endpoint_misses[tid] = 0
                self._fold_events(tid, doc, job)
                continue
            # right after a resume every worker's poller is still
            # timing out against the dead incarnation's cadence: the
            # silence is the tracker's outage, not the worker's
            if self.in_resume_grace():
                with self._lock:
                    job._endpoint_misses[tid] = 0
                continue
            # an endpoint that HAS answered before and now stays
            # silent for several sweeps is, to the fleet, a dead rank:
            # in an elastic world that is grounds for eviction (the
            # watchdog catches the same failure from the inside; this
            # catches a process that is unreachable rather than dead)
            with self._lock:
                seen_before = tid in job._metrics
                misses = job._endpoint_misses.get(tid, 0) + 1
                job._endpoint_misses[tid] = misses
                rank = job._ranks.get(tid)
                live_rank = (job.elastic and rank is not None
                             and rank in job._member.live)
            if seen_before and live_rank and \
                    misses >= _membership.EVICT_POLL_MISSES:
                self.evict_rank(
                    rank, f"endpoint silent for {misses} polls", job=job)
        with self._lock:
            summaries = dict(job._metrics)
            served_epoch = job._skew.get("epoch")
        strag = crossrank.straggler_snapshot(summaries)
        # each sweep's raw offsets fold through the job's ONE election
        # (job B's laggard never skews job A's schedules); the served
        # digest is its smoothed, hysteretic verdict, whose epoch bumps
        # exactly when the election changes
        if job._skew_election is None:
            job._skew_election = skew.FleetElection()
        digest = job._skew_election.fold(skew.digest_from_snapshot(strag))
        with self._lock:
            if digest is not None and digest.get("epoch") != served_epoch:
                # journal verdicts, not sweeps: the epoch bumps exactly
                # when the election changes
                self._wal("skew", digest=digest, _job=job)
            job._last_straggler = strag
            if digest is not None:
                job._skew = digest
        # one line every ~5 sweeps, only while someone is behind: in
        # the round sequence, or by more than 1 s of in-collective wait
        behind = bool(strag.get("signal")) \
            and strag.get("lagging_rank") is not None
        if since_snapshot >= 5 and behind:
            since_snapshot = 0
            jtag = f" job {job.job_id}" if self.multi_job else ""
            print(f"[tracker] straggler:{jtag} rank "
                  f"{strag['lagging_rank']} is {strag['lag_collectives']} "
                  f"collectives behind (busy skew "
                  f"{strag['busy_skew_s']:.3f}s)",
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
        and the served skew digest of the default job, and, multi-job,
        each job's ``/jobs`` doc."""
        with self._lock:
            srv = self._metrics_server
            stats = {"metrics_addr": (None if srv is None
                                      else list(srv.address)),
                     "endpoints": {t: dict(e)
                                   for t, e in self._endpoints.items()},
                     "polls": self._poll_count,
                     "straggler": self._last_straggler,
                     "skew": dict(self._skew)}
            if self.multi_job:
                stats["jobs"] = {jb.job_id: jb.doc()
                                 for jb in self._jobs.values()}
            return stats

    def merged_metrics(self, job=None) -> Optional[dict]:
        """The ``telemetry_fleet`` document merged from the summaries
        received so far (``job``'s alone when given), or None when no
        worker sent one. Multi-job, the union over the jobs, each task
        as ``<job>/<task>`` so that tasks of two jobs never collide."""
        with self._lock:
            if job is not None:
                snap = dict(job._metrics)
            elif self.multi_job:
                snap = {_jobs_mod.job_task(jid, t): d
                        for jid, jb in self._jobs.items()
                        for t, d in jb._metrics.items()}
            else:
                snap = dict(self._default._metrics)
        return merge_summaries(snap) if snap else None

    def print_fleet_metrics(self, job=None) -> None:
        """Print the end-of-run fleet table, and keep it in ``messages``
        like a print command, so launchers and tests see it: a completed
        ``job``'s own on a multi-job tracker, else the fleet's, once (the
        default job's counts as that once). Nothing when no summary with
        a counter arrived."""
        scoped = job is not None and self.multi_job
        fleet = self.merged_metrics(job if scoped else None)
        if fleet is None or not fleet.get("counters"):
            return
        if not scoped or job is self._default:
            with self._lock:
                if self._fleet_printed:
                    return
                self._fleet_printed = True
        table = format_fleet_table(fleet)
        self.messages.append(table)
        print(table, flush=True)

    def _reply_u32(self, conn, v: int) -> None:
        """A u32 reply, queued on the loop, which hangs up once it is
        sent."""
        self._loop.send(conn, struct.pack("<I", v), close_after=True)

    def _reply_json(self, conn, doc: dict) -> None:
        """A JSON-str reply (``topo``, ``skew``, ``world``, ``submit``),
        queued on the loop like ``_reply_u32``, with the tracker's HLC
        piggybacked while the incident plane is on, so a worker's clock
        causally follows the control plane; never on a u32 reply."""
        if self._events_on:
            stamp = _clock.tick()
            if stamp is not None:
                doc["hlc"] = stamp
        b = json.dumps(doc).encode()
        self._loop.send(conn, struct.pack("<I", len(b)) + b,
                        close_after=True)

    # -- jobs: the fault boundary, admission and the fleet scheduler ---------
    def _quarantine(self, job_id: str, cmd: str, exc: Exception) -> None:
        """One job's command raised: count it against THAT job's fault
        domain (a counter, a flight note, a ``tracker.quarantine`` event)
        and keep serving; no other job and no other connection sees it."""
        from .. import telemetry
        from ..telemetry import flight
        with self._lock:
            job = self._jobs.get(job_id)
            if job is not None:
                job.quarantined += 1
        telemetry.count("tracker.quarantine", provenance="tracker")
        flight.note("job_quarantine", f"job {job_id}: {cmd} raised "
                    f"{type(exc).__name__}: {exc}")
        self._fleet_emit("tracker.quarantine",
                         f"{cmd} raised {type(exc).__name__}: {exc}",
                         job=job_id)
        print(f"[tracker] quarantined {cmd} for job {job_id}: "
              f"{type(exc).__name__}: {exc}", file=sys.stderr, flush=True)

    def _job_for(self, job_id: str):
        """The named job, or None when unknown (a command for a job never
        admitted answers not-ok rather than raising). Contact with an open
        job clears it of orphanhood and restarts its forming clock."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is not None and job.open:
                self._orphan_jobs.discard(job_id)
                self._job_contact[job_id] = time.monotonic()
            return job

    def _job_for_register(self, job_id: str):
        """A registration's job: an open job, the default job (a closed
        default job forms again in place), or, multi-job, a job opened
        at the launch's shape when it fits the caps. None: admission
        refused (the connection is shed; its launcher should ``submit``
        and retry after the hint)."""
        with self._lock:
            job = self._jobs.get(job_id)
            if job is not None and job.open:
                self._orphan_jobs.discard(job_id)
                self._job_contact[job_id] = time.monotonic()
                return job
            if job_id == DEFAULT_JOB:
                return self._default
            if job is not None:
                return None   # a closed job: its task ids are retired
            if self._fits_locked(self.nworkers):
                return self._open_job_locked(job_id, self.nworkers,
                                             self.elastic)
        return None

    def _submit(self, payload: str) -> dict:
        """The ``submit`` command's verdict: ``{"ok": 1}`` admitted (once
        more for an open job: ``"already"``), ``{"ok": 0, "queued": 1,
        "position": p, "retry_after_ms": n}`` parked in the queue,
        ``{"ok": 0, "shed": 1, "retry_after_ms": n}`` the queue full,
        ``{"ok": 0, "error": ...}`` never admissible."""
        try:
            doc = json.loads(payload)
        except ValueError:
            doc = None
        if not isinstance(doc, dict) or not doc.get("job"):
            return {"ok": 0, "error": "malformed submit payload"}
        if not self.multi_job:
            return {"ok": 0,
                    "error": "multi-job disabled (rabit_multi_job unset)"}
        job_id = str(doc["job"])
        try:
            n = int(doc.get("nworkers", self.nworkers))
        except (TypeError, ValueError):
            return {"ok": 0, "error": "nworkers must be an integer"}
        if n < 1:
            return {"ok": 0, "error": "nworkers must be >= 1"}
        elastic = bool(doc.get("elastic", self.elastic))
        try:
            cls = max(0, int(doc.get("sched_class", 0)))
        except (TypeError, ValueError):
            cls = 0
        try:
            weight = float(doc.get("weight", 1.0))
        except (TypeError, ValueError):
            weight = 1.0
        if weight <= 0:
            weight = 1.0
        self._reap_orphans()   # free the capacity of dead jobs first
        with self._lock:
            job = self._jobs.get(job_id)
            if job is not None and job.open:
                self.submit_admitted_total += 1
                self._fleet_emit("admission.admitted",
                                 f"{job_id} already open", job=job_id)
                return {"ok": 1, "job": job_id, "already": 1}
            if self._max_fleet_ranks and n > self._max_fleet_ranks:
                return {"ok": 0,
                        "error": f"nworkers {n} exceeds "
                                 f"rabit_max_fleet_ranks "
                                 f"{self._max_fleet_ranks}"}
            if self._fits_locked(n):
                self._open_job_locked(job_id, n, elastic, cls, weight)
                self.submit_admitted_total += 1
                self._fleet_emit("admission.admitted",
                                 f"{job_id} opened at {n} ranks", job=job_id)
                return {"ok": 1, "job": job_id}
            plan = self._plan_preemption_locked(n, cls) if cls else None
        if plan:
            verdict = self._preempt(job_id, n, elastic, cls, weight, plan)
            if verdict is not None:
                return verdict
        retry = self._retry_hint_ms()
        with self._lock:
            if self._fits_locked(n):   # capacity freed while unlocked
                self._open_job_locked(job_id, n, elastic, cls, weight)
                self.submit_admitted_total += 1
                self._fleet_emit("admission.admitted",
                                 f"{job_id} opened at {n} ranks", job=job_id)
                return {"ok": 1, "job": job_id}
            pos = self._admission.offer(
                {"job": job_id, "nworkers": n, "elastic": elastic,
                 "sched_class": cls, "weight": weight})
            if pos < 0:
                depth = len(self._admission)
                self._fleet_emit("admission.shed",
                                 f"{job_id} shed past queue depth {depth}",
                                 job=job_id)
                return {"ok": 0, "shed": 1,
                        "retry_after_ms": retry * (depth + 1)}
            self._fleet_emit("admission.queued",
                             f"{job_id} parked at position {pos}",
                             job=job_id)
            return {"ok": 0, "queued": 1, "position": pos,
                    "retry_after_ms": retry * (pos + 1)}

    def _retry_hint_ms(self) -> int:
        """The backoff hint from the measured drain rate: the mean gap
        between recent job closes says how long a queue slot takes to
        free; the default until two closes were seen."""
        with self._lock:
            ts = list(self._drain_t)
        if len(ts) >= 2:
            per_close_s = (ts[-1] - ts[0]) / (len(ts) - 1)
            if per_close_s > 0:
                return max(50, min(60_000, int(per_close_s * 1e3)))
        return _jobs_mod.RETRY_AFTER_MS_DEFAULT

    def _open_jobs_locked(self) -> list:
        """The jobs the caps count (caller holds the lock): every open
        job; the default job only once someone registered into it."""
        return [jb for jb in self._jobs.values()
                if jb.open and (jb.job_id != DEFAULT_JOB
                                or jb._ranks or jb._pending)]

    def _fits_locked(self, nworkers: int) -> bool:
        """Would a job of ``nworkers`` fit the admission caps now? Caller
        holds the lock. Capacity sums ``quota`` (nworkers until a
        preemption shrinks it), so preempted ranks are transferable."""
        open_jobs = self._open_jobs_locked()
        if len(open_jobs) >= self._max_jobs:
            return False
        if self._max_fleet_ranks:
            in_use = sum(jb.quota for jb in open_jobs)
            if in_use + nworkers > self._max_fleet_ranks:
                return False
        return True

    def _plan_preemption_locked(self, n: int, cls: int):
        """Victim ranks whose eviction would fit an ``n``-rank class-
        ``cls`` job under ``rabit_max_fleet_ranks``. Caller holds the
        lock; the plan runs outside it (``evict_rank`` takes it again).
        Victims are elastic open jobs of a strictly lower class, lowest
        class first, highest live rank first; each keeps at least one
        rank so its survivors re-form. None: the shortfall cannot be
        covered, or the job-count cap blocks (no preemption fixes it)."""
        if not self._max_fleet_ranks:
            return None
        open_jobs = self._open_jobs_locked()
        if len(open_jobs) >= self._max_jobs:
            return None
        need = n - (self._max_fleet_ranks
                    - sum(jb.quota for jb in open_jobs))
        if need <= 0:
            return None
        victims = sorted(
            (jb for jb in open_jobs
             if jb.elastic and jb.sched_class < cls
             and jb._member is not None),
            key=lambda jb: (jb.sched_class, jb.job_id))
        plan = []
        for jb in victims:
            if need <= 0:
                break
            live = sorted(jb._member.live, reverse=True)
            take = min(need, jb.quota - 1, max(0, len(live) - 1))
            for r in live[:take]:
                plan.append((jb, r))
            need -= max(0, take)
        return plan if plan and need <= 0 else None

    def _preempt(self, job_id: str, n: int, elastic: bool, cls: int,
                 weight: float, plan) -> Optional[dict]:
        """Run a preemption plan: evict the victims' ranks (the elastic
        evict path: their survivors re-form smaller), transfer the freed
        quota (a journaled ``quota`` record) and admit the submitter.
        None when the plan went stale (capacity moved meanwhile; the
        caller falls back to the queue)."""
        evicted: Dict[object, int] = {}
        for jb, r in plan:
            if self.evict_rank(r, f"preempted by class {cls} job {job_id}",
                               job=jb):
                evicted[jb] = evicted.get(jb, 0) + 1
        if not evicted:
            return None
        with self._lock:
            for jb, cnt in evicted.items():
                jb.quota = max(1, jb.quota - cnt)
                jb.preempted += cnt
                self._wal("quota", quota=jb.quota, preempted=jb.preempted,
                          _job=jb)
                self.sched_preemptions[jb.sched_class] = \
                    self.sched_preemptions.get(jb.sched_class, 0) + cnt
            if not self._fits_locked(n):
                return None
            self._open_job_locked(job_id, n, elastic, cls, weight)
            self.submit_admitted_total += 1
        total = sum(evicted.values())
        print(f"[tracker] admitted class {cls} job {job_id} by preempting "
              f"{total} rank(s) from "
              f"{', '.join(sorted(jb.job_id for jb in evicted))}",
              file=sys.stderr, flush=True)
        return {"ok": 1, "job": job_id, "preempted": total}

    def _open_job_locked(self, job_id: str, nworkers: int, elastic: bool,
                         sched_class: int = 0, weight: float = 1.0):
        """Create and journal a job (caller holds the lock and checked it
        fits). The scheduler's fields ride ``job_open`` only when not at
        their defaults, as the JAX tracker writes it."""
        job = _jobs_mod.JobState(job_id, nworkers, elastic=elastic,
                                 sched_class=sched_class,
                                 sched_weight=weight)
        extra = {}
        if sched_class:
            extra["sched_class"] = int(sched_class)
        if weight != 1.0:
            extra["weight"] = float(weight)
        self._wal("job_open", job=job_id, nworkers=int(nworkers),
                  elastic=bool(elastic), **extra)
        self._jobs[job_id] = job
        self._job_contact[job_id] = time.monotonic()
        return job

    def _close_job_locked(self, job, reason: str) -> None:
        """Close ``job`` (journaled; caller holds the lock) and reap its
        epoch stores: a closed job's stores have no client left, and no
        other job's store is touched."""
        if not job.open:
            return
        self._wal("job_close", job=job.job_id, reason=reason)
        job.close(reason)
        job._stores = []
        # one sample of the drain rate a close: the retry hint is measured
        self._drain_t.append(time.monotonic())

    def _admit_queued_locked(self) -> List[str]:
        """Admit queued submissions in strict FIFO order while the head
        fits; a head too big blocks the queue (a small job never starves
        a big one). Caller holds the lock. The admitted job ids."""
        admitted = []
        while True:
            head = self._admission.peek()
            if head is None or not self._fits_locked(head["nworkers"]):
                break
            self._admission.pop_front()
            self._open_job_locked(head["job"], head["nworkers"],
                                  head["elastic"],
                                  int(head.get("sched_class", 0)),
                                  float(head.get("weight", 1.0)))
            admitted.append(head["job"])
        return admitted

    def _reap_orphans(self) -> List[str]:
        """Close the open jobs no live worker is behind, freeing their
        admission slots: a job a resume re-adopted whose tasks made no
        contact within the resume grace (``"orphaned"``), and, with
        ``RABIT_JOB_FORMING_TIMEOUT_MS``, a job with no rank, no pending
        registration and no contact for that long (``"forming
        timeout"``). Queued submissions take the freed capacity. The
        reaped job ids."""
        reaped: List[tuple] = []
        admitted: List[str] = []
        with self._lock:
            if self._orphan_jobs and not self.in_resume_grace():
                for jid in sorted(self._orphan_jobs):
                    jb = self._jobs.get(jid)
                    if jb is not None and jb.open:
                        self._close_job_locked(jb, "orphaned")
                        reaped.append((jid, "no contact since resume"))
                self._orphan_jobs.clear()
            t_ms = forming_timeout_ms()
            if t_ms:
                now = time.monotonic()
                for jid, jb in list(self._jobs.items()):
                    if (jid != DEFAULT_JOB and jb.open and not jb._ranks
                            and not jb._pending
                            and now - self._job_contact.get(jid, now)
                            > t_ms / 1e3):
                        self._close_job_locked(jb, "forming timeout")
                        reaped.append((jid, f"forming > {t_ms} ms"))
            if reaped:
                admitted = self._admit_queued_locked()
        for jid, why in reaped:
            print(f"[tracker] reaped orphaned job {jid} ({why})",
                  file=sys.stderr, flush=True)
        for jid in admitted:
            print(f"[tracker] admitted queued job {jid}", file=sys.stderr,
                  flush=True)
        return [jid for jid, _ in reaped]

    def _job_complete(self, job) -> None:
        """Every live rank of ``job`` sent shutdown: print its fleet
        table, close it, admit queued jobs into the freed capacity, and
        end the tracker only when nothing else runs or waits (with
        multi-job off: at once, as a single-job tracker ends)."""
        self.print_fleet_metrics(job)
        if not self.multi_job:
            self._done.set()
            return
        with self._lock:
            self._close_job_locked(job, "complete")
            admitted = self._admit_queued_locked()
            still_open = self._open_jobs_locked()
            queue_empty = self._admission.peek() is None
        for jid in admitted:
            print(f"[tracker] admitted queued job {jid}", file=sys.stderr,
                  flush=True)
        if job is self._default and not still_open and queue_empty:
            self._done.set()

    # -- registration -----------------------------------------------------------
    def _register(self, conn, job, task_id: str, host: str, port: int,
                  flags: int, token: str, join: bool = False) -> None:
        """Park the registration in its job's ``_pending``; whichever
        registration (or eviction) completes the batch serves everyone
        via ``_assign``. Nothing waits here: a parked joiner is bounced
        after ``rabit_join_grace_ms`` unless a formation adopted it (the
        joiner retries)."""
        grace_s: Optional[float] = None
        with self._lock:
            if task_id not in job._ranks:
                rank = len(job._ranks)
                if job.elastic and rank >= job.nworkers \
                        and job._member.evicted:
                    # replacement hardware arrives under a NEW task id:
                    # it adopts the lowest vacated stable rank, so the
                    # world can grow back to its target (and the newcomer
                    # inherits that rank's checkpoint shard directory)
                    rank = min(job._member.evicted)
                self._wal("assign", task=task_id, rank=rank, _job=job)
                job._ranks[task_id] = rank
            rank = job._ranks[task_id]
            if rank >= job.nworkers:
                self._loop.close_conn(conn)
                return
            if job.elastic:
                m = job._member
                if join or rank in m.evicted or \
                        (m.live and rank not in m.live):
                    # (re-)admission: parked until the epoch boundary; a
                    # joiner never perturbs a world in flight
                    self._wal("park", rank=rank, _job=job)
                    m.park(rank)
                    grace_s = _membership.join_grace_ms() / 1e3 or None
            job._shutdown_ranks.discard(rank)
            prev = job._pending.get(rank)
            job._pending[rank] = (conn, host, port, flags, token)
            got = self._try_complete_batch_locked(job)
        if prev is not None and prev[0] is not conn:
            # a re-registration superseded a still-parked connection
            self._loop.close_conn(prev[0])
        if got is not None:
            self._assign(job, *got)
        elif grace_s is not None:
            self._arm_join_bounce(job, conn, rank, grace_s)

    def _arm_join_bounce(self, job, conn, rank: int, grace_s: float) -> None:
        """Close a parked joiner's connection after ``grace_s`` unless a
        formation adopted it (or a re-registration superseded it), rather
        than hold its socket open for good. The loop's timer hands the
        bounce to the pool: the loop thread takes no tracker lock."""
        def bounce() -> None:   # a pool thread
            with self._lock:
                pend = job._pending.get(rank)
                if pend is None or pend[0] is not conn:
                    return   # adopted (or superseded) in time
                del job._pending[rank]
            self._loop.close_conn(conn)
        self._loop.call_later(
            grace_s, lambda: self._svc.submit(job.job_id, bounce))

    @staticmethod
    def _expected_ranks(job) -> set:
        """Ranks the job's current registration batch must contain
        before it forms (caller holds the lock): the fixed world, or,
        elastic, the survivors of the last formed world plus the parked
        joiners."""
        if job.elastic:
            return job._member.expected()
        return set(range(job.nworkers))

    def _try_complete_batch_locked(self, job) -> Optional[tuple]:
        """``(batch, epoch, admitted)`` when every expected rank of the
        job is pending, else None. Caller holds the lock and, on success,
        runs ``_assign`` outside it. An eviction can complete a batch
        too: survivors re-register and wait for a dead rank until it
        leaves the expected set."""
        expected = self._expected_ranks(job)
        if not expected or not expected <= set(job._pending):
            return None
        batch = {r: job._pending.pop(r) for r in sorted(expected)}
        self._wal("epoch", epoch=job._epoch + 1, members=sorted(batch),
                  _job=job)
        job._epoch += 1
        job.mark_live()
        admitted = (sorted(job._member.formed(batch)) if job.elastic
                    else [])
        return batch, job._epoch, admitted

    # -- elastic membership ---------------------------------------------------
    def membership_doc(self, job=None) -> dict:
        """The ``world`` command's payload of ``job`` (None: the default
        job): the live membership view, or a static fixed-world doc when
        elastic is off (so the command always answers: a worker probing
        an inelastic tracker learns the world is fixed rather than timing
        out)."""
        if job is None:
            job = self._default
        with self._lock:
            if job.elastic:
                return job._member.doc(job._epoch)
            return {"epoch": job._epoch, "world": job.nworkers,
                    "target": job.nworkers,
                    "live": list(range(job.nworkers)), "evicted": [],
                    "joining": [], "generation": 0, "elastic": False}

    def _note_transition(self, kind: str, rank: int, detail: str,
                         job=None) -> None:
        """Make a membership transition observable: a counter, a
        zero-length ``membership.transition`` span, a flight note naming
        the rank (a post-mortem bundle shows WHY the world resized) and a
        fleet event of its job."""
        from .. import telemetry
        from ..telemetry import flight
        if job is None:
            job = self._default
        jtag = (f" job {job.job_id}"
                if self.multi_job and job.job_id != DEFAULT_JOB else "")
        telemetry.count(f"membership.{kind}", provenance="membership")
        telemetry.record_span("membership.transition", 0.0, op=kind,
                              provenance="membership", rank=rank,
                              detail=detail)
        flight.note(f"member_{kind}", f"rank {rank}:{jtag} {detail}")
        self._fleet_emit(f"membership.{kind}", detail, job=job.job_id,
                         rank=rank)
        print(f"[tracker] membership:{jtag} {kind} rank {rank} ({detail})",
              file=sys.stderr, flush=True)

    def evict_rank(self, rank: int, reason: str = "", job=None) -> bool:
        """Evict ``rank`` from ``job`` (None: the default job; the
        ``evict`` command, the poll loop's silent-endpoint evidence, a
        preemption). The rank leaves the expected set at once, so
        survivors already waiting in re-registration form their N-1
        batch now instead of waiting out the ready timeout on a dead
        peer. A job whose every member is gone has failed, inside its own
        fault domain. False unless elastic, in range and not already
        out."""
        if job is None:
            job = self._default
        if not job.elastic or not 0 <= int(rank) < job.nworkers:
            return False
        rank = int(rank)
        with self._lock:
            if rank in job._member.evicted:
                return False
            self._wal("evict", rank=rank, reason=reason, _job=job)
            if not job._member.evict(rank):
                return False
            pend = job._pending.pop(rank, None)
            got = self._try_complete_batch_locked(job)
            if job.open and not job._member.live:
                job.mark_failed()
        self._note_transition("evict", rank, reason or "evicted", job)
        if pend is not None:
            self._loop.close_conn(pend[0])
        if got is not None:
            self._assign(job, *got)
        return True

    # -- the epoch's rendezvous store -----------------------------------------
    def _new_store(self, job, epoch: int, members) -> Tuple[str, int]:
        """Start the job's store of this epoch on a fresh port; ``members``
        are the stable ranks of the epoch's batch."""
        import torch.distributed as dist
        store = dist.TCPStore(self.host, 0, is_master=True,
                              wait_for_workers=False,
                              timeout=datetime.timedelta(seconds=300))
        with self._lock:
            job._stores.append((epoch, store, frozenset(members)))
        return self.host, store.port

    def _reap_old_stores(self, job) -> None:
        """Drop each store of the job older than the newest epoch every
        member of which acked it (``job._all_acked``) once every member of
        the store's own epoch has let go of its world: acked a newer epoch
        (a worker drops its torch world before it acks, the data plane's
        teardown sentinel), or sent ``shutdown`` (a member that evicted
        itself says so as it exits). No client of such a store is left. A
        member evicted while its process lives on (the in-process
        ``resize("join")``) keeps the world of its last epoch, and with it
        a client of that epoch's store, until its own re-registration
        tears the world down; so that store stays until the member has
        acked a newer epoch. In a fixed world every batch holds every
        rank, and this drops every store older than the acked epoch.
        Keeps the store count bounded whatever the number of recoveries
        and departures; no other job's store is touched."""
        with self._lock:
            acked_epoch = job._all_acked
            job._stores = [
                (e, st, members) for e, st, members in job._stores
                if e >= acked_epoch or
                any(job._acked.get(r, 0) <= e
                    and r not in job._shutdown_ranks for r in members)]

    def _acks_settled(self, job, epoch: int, acked: List[int],
                      every: bool) -> None:
        """A pool thread, once each member of ``epoch`` acked, failed or
        timed out: record the stable ranks that ``acked`` and, when
        ``every`` member did, the job's newest fully acked epoch; then
        reap. A crashed tracker records and reaps nothing: its stores stay
        as a kill leaves them."""
        if self.crashed:
            return
        with self._lock:
            for r in acked:
                job._acked[r] = max(epoch, job._acked.get(r, 0))
            if every:
                job._all_acked = max(job._all_acked, epoch)
        self._reap_old_stores(job)

    def _assign(self, job, batch: Dict[int, tuple], epoch: int,
                admitted=()) -> None:
        for r in admitted:
            self._note_transition("admit", r, f"joined at epoch {epoch}",
                                  job)
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
            coord_host, coord_port = (self._new_store(job, epoch, batch)
                                      if want_store else ("", 0))
        except (RuntimeError, OSError) as e:
            # a silent failure here would hang every worker in this batch;
            # closing their connections surfaces a registration error
            print(f"[tracker] rendezvous store start failed, rejecting "
                  f"epoch {epoch}: {e}", file=sys.stderr, flush=True)
            for c in conns.values():
                self._loop.close_conn(c)
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
            self._wal("topo", doc=topo, _job=job)
            job._topo = topo

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
            self._loop.send(conns[rank], bytes(blob))
        self._await_acks(job, conns, epoch,
                         {s: r for r, s in slot_of.items()})

    def _await_acks(self, job, conns: dict, epoch: int,
                    stable: Dict[int, int]) -> None:
        """The ready-ack barrier on the loop (``conns`` by slot, ``stable``
        maps a slot to its stable rank): each member's 4-byte ack is an
        ``expect`` with the ready timeout. ``state`` is touched only by
        these loop-thread callbacks; once every member answered, failed
        or timed out, the pool records the acks and reaps. A worker dying
        before its ack is logged: the epoch still completes (the dead
        worker re-registers into the next one after its respawn), but no
        store is reaped on it."""
        state = {"left": len(conns), "acked": []}

        def settle() -> None:   # loop thread
            state["left"] -= 1
            if state["left"] == 0:
                acked = state["acked"]
                self._svc.submit(job.job_id, lambda: self._acks_settled(
                    job, epoch, acked, len(acked) == len(conns)))

        def on_ack(slot):
            def _on_ack(c, _data) -> None:   # loop thread
                self._loop.close_conn(c)
                state["acked"].append(stable[slot])
                settle()
            return _on_ack

        def on_fail(slot):
            def _on_fail(c, exc) -> None:   # loop thread
                if not self.crashed:
                    print(f"[tracker] rank {slot} did not ack epoch "
                          f"{epoch} ({type(exc).__name__}: {exc})",
                          file=sys.stderr, flush=True)
                self._loop.close_conn(c)
                settle()
            return _on_fail

        for slot, conn in sorted(conns.items()):
            self._loop.expect(conn, 4, on_ack(slot),
                              timeout=self._ready_timeout,
                              on_fail=on_fail(slot))


def main(argv: Optional[List[str]] = None) -> int:
    """Standalone tracker. ``--wal-dir`` journals every control-plane
    transition; ``--resume <wal_dir>`` replays it and re-adopts a live
    world after a crash: pin ``--host``/``--port`` to the dead tracker's
    address, so the environment the workers were launched with stays
    valid. ``--multi-job`` serves many fault-isolated jobs: workers name
    their job in their task id (``<job>/<task>``) and launchers
    ``submit`` (``launch --submit``). Elastic membership follows
    ``RABIT_ELASTIC``, the live plane ``RABIT_METRICS_PORT``."""
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
    ap.add_argument("--multi-job", action="store_true",
                    help="serve many fault-isolated jobs on this one "
                         "tracker (also RABIT_MULTI_JOB=1)")
    args = ap.parse_args(argv)
    tr = Tracker(args.num_workers, host=args.host, port=args.port,
                 wal_dir=args.resume or args.wal_dir,
                 resume=args.resume is not None,
                 multi_job=True if args.multi_job else None).start()
    print(f"[tracker] listening on {tr.host}:{tr.port}", file=sys.stderr,
          flush=True)
    try:
        tr.join()
    finally:
        tr.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
