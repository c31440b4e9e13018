"""Hot-standby tracker: the port's copy of ``rabit_tpu/tracker/standby.py``,
whole. WAL streaming replication and lease-gated promotion.

A warm follower subscribes to the leader over the tracker's own wire
protocol (the ``repl`` command), persists every streamed WAL record to a
journal of its own, acks each one, and -- only after the last replicated
leadership lease has expired -- promotes itself by replaying that
journal into a full :class:`~rabit_tpu_torch.tracker.tracker.Tracker` on
the pre-advertised failover address. Without it a tracker crash costs a
cold respawn and replay (the launcher's supervisor); with it the outage
is bounded by the lease ("Highly Available Data Parallel ML training on
Mesh Networks", arXiv:2011.03605).

Why split-brain is structurally impossible: leadership is a record in
the replicated stream, not a lock in memory. The leader journals its
lease CLAIM (replicated in the same total order as every other
transition) and then heartbeats a renewal every ``lease_ms/3`` --
idempotent renewals ride the stream as ephemeral seq-0 frames so the
journal stays bounded (``tracker.py``'s ``_wal``). The follower's
promotion gate is "a full lease of *silence* from the leader, measured
on MY monotonic clock": every frame received restarts a local
``time.monotonic`` countdown of one lease, and promotion requires the
countdown to lapse with the stream down. Deliberately NOT "the
leader-stamped ``until_ms`` passed my wall clock": across hosts that
comparison is hostage to NTP -- a clock step larger than the renewal
margin could promote under a live leader, or hold a dead leader's lease
alive forever. Monotonic clocks never step, so the gate needs no clock
agreement between machines.

Failure model:

- leader crash: the repl stream tears (EOF), reconnects are refused,
  the local countdown lapses within ``lease_ms`` of the last received
  frame, and the standby promotes -- failover is bounded by the lease,
  not by the supervisor's respawn schedule;
- leader partition: frames stop arriving (the stream stalls rather
  than tears); the follower's read timeout fires after a full lease of
  silence and the same countdown gate promotes it;
- double failure (standby also dead): the supervisor falls back to the
  cold respawn with ``resume=True`` on the pinned port.

Workers find the promoted tracker through the reconnect path: the skew
poller probes the pre-advertised standby address
(``RABIT_TRACKER_STANDBY``) once the leader stops answering, and adopts
it with ``membership.present_resume`` and the endpoint re-announce --
no worker restarts, the epoch unchanged. The launcher's chaos front
proxy (``chaos/proxy.py``), retargeted at adoption, keeps the address
baked into the native core (its ``finalize``) resolving.

``python -m rabit_tpu_torch.tracker.standby --smoke`` runs an in-process
leader and standby through one replicated record, a leader crash and a
lease-gated promotion. Stdlib-only, like the rest of the tracker
package.
"""

from __future__ import annotations

import os
import socket
import struct
import sys
import threading
import time
from typing import Optional, Tuple

from ..utils import retry as _retry
from . import tracker as _tracker_mod
from . import wal as _wal_mod

STANDBY_ENV = "RABIT_TRACKER_STANDBY"


def standby_addr() -> Optional[Tuple[str, int]]:
    """The pre-advertised failover address from ``RABIT_TRACKER_STANDBY``
    (``host:port``), or None when no standby is configured. Worker-side
    failover discovery (telemetry/skew.py, tracker/membership.py) calls
    this on every probe so a launcher can repoint it live."""
    return _retry.parse_hostport(os.environ.get(STANDBY_ENV))


class StandbyTracker:
    """A warm follower of one leader tracker.

    ``start()`` spawns the follow loop: subscribe (``repl`` + last
    durable seq), persist + ack every streamed frame, track the newest
    lease, and — once the stream is gone AND the lease expired —
    promote by replaying the replicated journal into a real
    :class:`Tracker` bound to the advertised failover address. The
    failover port is reserved at construction (bound, NOT listening,
    so probes are refused until promotion) and handed to the promoted
    tracker.
    """

    def __init__(self, leader_host: str, leader_port: int, nworkers: int,
                 wal_dir: str, host: str = "127.0.0.1", port: int = 0,
                 lease_ms: Optional[int] = None, node_id: str = "standby",
                 elastic: Optional[bool] = None, link_rewrite=None,
                 ready_timeout: Optional[float] = None,
                 metrics_port: Optional[int] = None,
                 quiet: bool = False):
        self.leader_host = leader_host
        self.leader_port = int(leader_port)
        self.nworkers = int(nworkers)
        self.wal_dir = str(wal_dir)
        self.lease_ms = int(lease_ms) if lease_ms \
            else _tracker_mod.default_lease_ms()
        self.node_id = str(node_id)
        self._elastic = elastic
        self._link_rewrite = link_rewrite
        self._ready_timeout = ready_timeout
        self._metrics_port = metrics_port
        self._quiet = quiet
        # reserve the failover address now so it can be advertised to
        # workers before any failure: bound but NOT listening — probes
        # are refused (the discovery signal for "not promoted yet"),
        # and the promoted tracker rebinds it the instant we release it
        self._placeholder = socket.socket(   # bound, never connects
            socket.AF_INET, socket.SOCK_STREAM)
        self._placeholder.setsockopt(socket.SOL_SOCKET,
                                     socket.SO_REUSEADDR, 1)
        self._placeholder.bind((host, int(port)))
        self.host, self.port = self._placeholder.getsockname()
        self._wal = _wal_mod.WriteAheadLog(self.wal_dir)
        self._wal.open(resume=False)
        self._lease: Optional[dict] = None
        # the promotion gate: a LOCAL monotonic deadline one lease out
        # from the last frame the leader managed to deliver. Restarted
        # on every received frame (any frame is proof of life), never
        # compared against the leader-stamped until_ms — wall clocks
        # on two hosts need not agree, monotonic silence does.
        self._lease_deadline: Optional[float] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # guards the state shared between the follow thread and the
        # supervisor's alive()/promoted()/stop() probes (C001)
        self._mu = threading.Lock()
        self.tracker: Optional[_tracker_mod.Tracker] = None  # guarded-by: _mu
        self.acked_seq = 0                                   # guarded-by: _mu
        self.promoted_at: Optional[float] = None             # guarded-by: _mu
        self.resyncs = 0                                     # guarded-by: _mu

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "StandbyTracker":
        self._thread = threading.Thread(
            target=self._follow_loop, name="rabit-tracker-standby",
            daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        try:
            self._placeholder.close()
        except OSError:
            pass
        with self._mu:
            tr = self.tracker
        if tr is not None:
            tr.stop()
        else:
            self._wal.close()

    def alive(self) -> bool:
        """True while the standby can still take over: following, or
        already promoted and serving."""
        with self._mu:
            tr = self.tracker
        if tr is not None:
            return not tr.crashed
        return self._thread is not None and self._thread.is_alive()

    def promoted(self) -> bool:
        with self._mu:
            return self.tracker is not None

    def _log(self, msg: str) -> None:
        if not self._quiet:
            print(f"[standby {self.node_id}] {msg}", file=sys.stderr,
                  flush=True)

    # -- the follow loop --------------------------------------------------
    def _subscribe(self) -> socket.socket:
        """One ``repl`` subscription from this journal's resync point."""
        conn = _retry.connect_with_retry(
            self.leader_host, self.leader_port, timeout=5.0, attempts=1)
        try:
            conn.sendall(struct.pack("<I", _tracker_mod.MAGIC))
            for s in ("repl", self.node_id):
                b = s.encode()
                conn.sendall(struct.pack("<I", len(b)) + b)
            conn.sendall(struct.pack("<I", 0))          # num_attempt
            ok = struct.unpack("<I", _tracker_mod._recv_all(conn, 4))[0]
            if ok != 1:
                raise ConnectionError(
                    "leader refused replication (no WAL configured?)")
            conn.sendall(struct.pack("<I", self._wal.seq))
            # a healthy leader renews its lease every lease_ms/3, so a
            # full lease of silence means crash or partition — exactly
            # when the expiry gate below is allowed to fire anyway
            conn.settimeout(max(0.5, self.lease_ms / 1e3))
            return conn
        except BaseException:
            conn.close()
            raise

    def _restart_countdown(self, lease: Optional[dict] = None) -> None:
        """A frame arrived: the leader is alive and could reach us, so
        the promotion countdown restarts — one full lease of LOCAL
        monotonic time (a lease record's own width wins over ours, so
        both sides always count the same lease)."""
        ms = self.lease_ms
        if isinstance(lease, dict):
            try:
                ms = max(100, int(lease.get("lease_ms", ms)))
            except (TypeError, ValueError):
                pass
        with self._mu:
            self._lease_deadline = time.monotonic() + ms / 1e3

    def _may_promote(self) -> bool:
        """True once a full lease of silence elapsed on the local
        monotonic clock since the last frame — with the stream already
        down (the caller only asks between subscriptions). Never
        compares the leader-stamped ``until_ms`` against our wall
        clock: cross-host skew must not be able to promote under a
        live leader (see the module docstring)."""
        with self._mu:
            return (self._lease is not None
                    and self._lease_deadline is not None
                    and time.monotonic() >= self._lease_deadline)

    def _follow_loop(self) -> None:
        backoff = 0.05
        while not self._stop.is_set():
            try:
                conn = self._subscribe()
            except (OSError, ConnectionError, _retry.RetryError):
                conn = None
            if conn is not None:
                backoff = 0.05
                try:
                    while not self._stop.is_set():
                        frame = _wal_mod.recv_frame(conn)
                        if frame is None:
                            raise ConnectionError("leader closed stream")
                        seq, kind, data = _wal_mod.decode_record(frame)
                        lease = data if kind == _wal_mod.LEASE_KIND \
                            else None
                        self._restart_countdown(lease)
                        if lease is not None:
                            with self._mu:
                                self._lease = lease
                        if seq == 0:
                            # ephemeral lease heartbeat: proof of life
                            # and a fresher doc, never journaled or
                            # acked on either side
                            continue
                        seq = self._wal.append_encoded(frame)
                        conn.sendall(struct.pack("<I", seq))
                        with self._mu:
                            self.acked_seq = seq
                except (OSError, ConnectionError, struct.error,
                        _wal_mod.WalError):
                    # torn stream, ack lost, or leader gone: resync by
                    # resubscribing from the last DURABLE seq — every
                    # acked record is already fsynced, so nothing acked
                    # can be lost
                    with self._mu:
                        self.resyncs += 1
                finally:
                    try:
                        conn.close()
                    except OSError:
                        pass
            if self._stop.is_set():
                return
            if self._may_promote():
                self._promote()
                return
            with self._mu:
                never_synced = self._lease is None
            if never_synced and conn is None:
                # never synced at all and the leader is unreachable:
                # nothing to promote from — keep trying to subscribe
                pass
            time.sleep(min(backoff, self.lease_ms / 1e3 / 4))
            backoff = min(backoff * 2, 0.5)

    # -- promotion --------------------------------------------------------
    def _promote(self) -> None:
        """A full lease of silence and the leader is unreachable:
        replay the replicated journal into a real Tracker on the
        advertised failover address. The promoted tracker claims the
        lease under its OWN node id from here on — it is the leader
        now. The replay re-adopts the live world (ranks, epoch,
        membership) exactly as a cold ``resume=True`` restart does -- of
        a multi-job leader every live job, each with its own ranks and
        epoch, since the job records ride the same stream -- and the
        promoted tracker hosts every later epoch's store."""
        self._wal.close()
        try:
            self._placeholder.close()
        except OSError:
            pass
        with self._mu:
            last_lease = self._lease
            lease_deadline = self._lease_deadline
        # the failover's clock: the countdown deadline sits one
        # full lease past the LAST frame the leader delivered, so
        # deadline - lease is the leader's last proof of life — the
        # instant the failover duration starts counting
        detect_mono = (lease_deadline - self.lease_ms / 1e3
                       if lease_deadline is not None
                       else time.monotonic())
        self._log(f"no leader frame for a full lease "
                  f"({self.lease_ms}ms, last lease {last_lease}); "
                  f"promoting on {self.host}:{self.port} from seq "
                  f"{self._wal.seq}")
        deadline = time.monotonic() + 10
        while True:
            if self._stop.is_set():
                return
            try:
                tr = _tracker_mod.Tracker(
                    self.nworkers, host=self.host, port=self.port,
                    wal_dir=self.wal_dir, resume=True,
                    lease_ms=self.lease_ms, node_id=self.node_id,
                    elastic=self._elastic,
                    link_rewrite=self._link_rewrite,
                    ready_timeout=self._ready_timeout,
                    metrics_port=self._metrics_port)
                break
            except OSError:
                if time.monotonic() > deadline:  # pragma: no cover
                    self._log("failover port never freed; giving up")
                    return
                time.sleep(0.05)
        tr.promoted = True
        # stamp BOTH clocks at promotion (wall for humans and
        # cross-host logs, monotonic for the arithmetic) and journal
        # the measured leader-kill -> promoted duration so the control
        # plane itself reports failover time (rabit_failover_duration_ms
        # gauge; a later resume replays the record and keeps serving it)
        now_mono = time.monotonic()
        tr.promoted_wall = time.time()
        tr.promoted_mono = now_mono
        tr.failover_duration_ms = max(0.0,
                                      (now_mono - detect_mono) * 1e3)
        tr._wal("promoted", node=self.node_id,
                wall=round(tr.promoted_wall, 6),
                mono=round(tr.promoted_mono, 6),
                failover_ms=round(tr.failover_duration_ms, 3))
        tr.start()
        with self._mu:
            self.tracker = tr
            self.promoted_at = now_mono
        self._note_promotion()

    def _note_promotion(self) -> None:
        """Make a failover observable: counter + span + flight note,
        mirroring the tracker's own transition notes."""
        from .. import telemetry
        from ..telemetry import flight
        with self._mu:
            acked, resyncs, tr = self.acked_seq, self.resyncs, self.tracker
        telemetry.count("tracker.failover", provenance="tracker")
        telemetry.record_span("tracker.failover", 0.0, op="promote",
                              provenance="tracker",
                              acked_seq=acked, resyncs=resyncs)
        flight.note("tracker_failover",
                    f"standby {self.node_id} promoted on "
                    f"{self.host}:{self.port} at seq {acked}")
        from ..telemetry import events
        events.emit("tracker.promoted",
                    f"standby {self.node_id} promoted on "
                    f"{self.host}:{self.port} at seq {acked}",
                    failover_ms=round(tr.failover_duration_ms, 3)
                    if tr is not None else None)
        self._log(f"promoted: serving epoch "
                  f"{tr._epoch} with "
                  f"{len(tr._ranks)} known ranks")


# ------------------------------------------------------------- CI smoke


def _smoke() -> None:
    """An in-process leader and standby — one journaled transition replicated and acked, then a leader
    crash, promotion strictly after the forced lease expiry, and the
    promoted tracker serving the replicated state on the pre-advertised
    failover address."""
    import json
    import shutil
    import tempfile

    root = tempfile.mkdtemp(prefix="rabit-standby-smoke-")
    lease_ms = 400
    tr = sb = None
    try:
        tr = _tracker_mod.Tracker(
            2, wal_dir=os.path.join(root, "leader"),
            lease_ms=lease_ms).start()
        sb = StandbyTracker(tr.host, tr.port, 2,
                            wal_dir=os.path.join(root, "standby"),
                            lease_ms=lease_ms, quiet=True).start()

        # one journaled transition: an endpoint announce over the wire
        c = _retry.connect_with_retry(tr.host, tr.port, timeout=5.0)
        c.sendall(struct.pack("<I", _tracker_mod.MAGIC))
        for s in ("endpoint", "0"):
            b = s.encode()
            c.sendall(struct.pack("<I", len(b)) + b)
        c.sendall(struct.pack("<I", 0))
        payload = json.dumps({"host": "127.0.0.1", "port": 9999,
                              "rank": 0}).encode()
        c.sendall(struct.pack("<I", len(payload)) + payload)
        assert struct.unpack(
            "<I", _tracker_mod._recv_all(c, 4))[0] == 1
        c.close()

        # ...replicated AND acked (leases + the endpoint record)
        deadline = time.monotonic() + 10
        while sb.acked_seq < tr.repl_stats()["seq"] \
                or tr.repl_stats()["seq"] == 0:
            assert time.monotonic() < deadline, "replication never caught up"
            time.sleep(0.02)
        assert tr.repl_stats()["subscribers"] == 1
        assert tr.repl_stats()["lag_records"] == 0

        # crash the leader; promotion may happen only AFTER the lease
        # the standby holds has expired (bounded by one lease width)
        lease_at_crash = dict(sb._lease)
        tr.crash()
        t0 = time.monotonic()
        while not sb.promoted():
            assert time.monotonic() - t0 < 10, "standby never promoted"
            time.sleep(0.02)
        assert _wal_mod.lease_expired(lease_at_crash), \
            "promoted while the leader's lease was still live"

        # the promoted tracker serves the replicated state on the
        # advertised failover address
        res = sb.tracker
        assert (res.host, res.port) == (sb.host, sb.port)
        assert res._endpoints["0"]["port"] == 9999, res._endpoints
        assert res.restarts == 1
        assert res.promoted and res.lease() is not None
        c = _retry.connect_with_retry(sb.host, sb.port, timeout=5.0)
        c.sendall(struct.pack("<I", _tracker_mod.MAGIC))
        for s in ("world", "0"):
            b = s.encode()
            c.sendall(struct.pack("<I", len(b)) + b)
        c.sendall(struct.pack("<I", 0))
        n = struct.unpack("<I", _tracker_mod._recv_all(c, 4))[0]
        doc = json.loads(_tracker_mod._recv_all(c, n).decode())
        c.close()
        assert doc["world"] == 2, doc
    finally:
        if sb is not None:
            sb.stop()
        if tr is not None:
            tr.stop()
        shutil.rmtree(root, ignore_errors=True)
    print("failover smoke ok (replicated+acked, lease-gated promotion, "
          "replicated state served)")


if __name__ == "__main__":
    if "--smoke" in sys.argv:
        _smoke()
    else:
        print(__doc__)
