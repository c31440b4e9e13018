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
outlives any worker, and it is reaped once every member of a newer epoch
has acked its assignment (no worker holds a client of an older one by
then: the data plane drops its world before acking).

Wire protocol (binary, little-endian, length-prefixed strings):
  worker -> tracker: magic u32 0x52425401, cmd str, task_id str,
                     num_attempt u32
    start/recover: + host str, listen_port u32, flags u32 (bit 0: the
                   worker will register a data plane — the tracker hosts
                   the epoch's store), uds_token str (random name of the
                   worker's abstract-UDS listener twin; "" = TCP-only)
    print:         + msg str
    topo:          (no extra fields) tracker -> worker: a JSON str
                   {"epoch","groups","delegates","single_host"} of the
                   host topology at the last assignment ("{}" before it)
    metrics:       + summary str (a rank's ``telemetry_summary`` JSON,
                   ``telemetry.ship_to_tracker``), kept by task id;
                   tracker -> worker: u32 1 (0 for a payload that is not
                   a JSON object)
    shutdown:      (no extra fields) tracker -> worker: u32 1
  tracker -> worker (start/recover): rank u32, world u32, epoch u32,
    coord_host str, coord_port u32 (this epoch's store; ""/0 when none is
    hosted), single_host u32, parent u32 (0xFFFFFFFF = none), ntree u32 +
    tree neighbor ranks, ring_prev u32, ring_next u32, nconnect u32 +
    (peer_rank u32, host str, port u32, uds_token str)..., naccept u32;
    the worker replies ready u32 after wiring its links.
Workers connect to lower-ranked neighbors and accept from higher ranks.
The epoch counts completed registration batches: every live worker
re-registers in the same batch during recovery, so all members of a
batch observe the same epoch.

At the end of the run (every rank sent ``shutdown``, or the launcher's
``print_fleet_metrics`` once its workers have exited, for engines such
as ``TorchEngine`` that do not register) the tracker merges the
summaries it received (``merged_metrics``, the port's
``telemetry.aggregate``) and prints the fleet table, once.

Any other command closes the connection. Not ported yet (the JAX
package's tracker has them): the write-ahead log and resume, the hot
standby, multi-job, elastic membership, the ``join``/``resume``/
``evict``/``repl``/``submit``/``skew``/``endpoint``/``world`` commands,
the folding of the summaries' events into a fleet event log, the
incident plane, and chaos link rewrites.
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
from typing import Dict, List, Optional, Tuple

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


def _default_ready_timeout() -> float:
    """``rabit_tracker_ready_timeout``: how long ``_assign`` waits for
    each worker's ready ack before declaring the epoch partially
    failed."""
    try:
        return float(os.environ.get("RABIT_TRACKER_READY_TIMEOUT", 60.0))
    except ValueError:
        return 60.0


class Tracker:
    def __init__(self, nworkers: int, host: str = "127.0.0.1", port: int = 0,
                 ready_timeout: Optional[float] = None):
        self.nworkers = nworkers
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.sock.bind((host, port))
        self.sock.listen(256)
        self.host, self.port = self.sock.getsockname()
        self._ready_timeout = (ready_timeout if ready_timeout is not None
                               else _default_ready_timeout())
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.messages: List[str] = []
        self._ranks: Dict[str, int] = {}
        self._pending: Dict[int, tuple] = {}
        self._epoch = 0
        self._shutdown_ranks: set = set()
        self._topo: dict = {}
        self._stores: List[tuple] = []   # (epoch, TCPStore)
        self._metrics: Dict[str, dict] = {}   # task id -> its summary
        self._fleet_printed = False

    # -- lifecycle ----------------------------------------------------------
    def start(self) -> "Tracker":
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name="rabit-tracker")
        self._thread.start()
        return self

    def join(self, timeout: Optional[float] = None) -> bool:
        return self._done.wait(timeout)

    def stop(self) -> None:
        self._done.set()
        try:
            self.sock.close()
        except OSError:
            pass
        with self._lock:
            pending = [p[0] for p in self._pending.values()]
            self._pending.clear()
            # workers have exited (or been killed) by now: no live client
            # is left on these stores
            self._stores = []
        for conn in pending:
            conn.close()

    @property
    def epoch(self) -> int:
        return self._epoch

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
                return   # stop() closed the listener
            threading.Thread(target=self._handle, args=(conn,),
                             daemon=True).start()

    def _handle(self, conn: socket.socket) -> None:
        """One request. A registration's connection stays open, parked in
        ``_pending`` until its batch is complete; every other command is
        answered and closed."""
        try:
            conn.settimeout(_REQUEST_TIMEOUT_S)
            if _recv_u32(conn) != MAGIC:
                conn.close()
                return
            cmd = _recv_str(conn)
            task_id = _recv_str(conn)
            _recv_u32(conn)   # num_attempt (informational)
            if cmd in ("start", "recover"):
                host = _recv_str(conn)
                port = _recv_u32(conn)
                flags = _recv_u32(conn)
                token = _recv_str(conn)
                conn.settimeout(None)
                self._register(conn, task_id, host, port, flags, token)
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
                self._reply_u32(conn, 1 if ok else 0)
            elif cmd == "shutdown":
                with self._lock:
                    rank = self._ranks.get(task_id)
                    if rank is not None:
                        self._shutdown_ranks.add(rank)
                    all_down = len(self._shutdown_ranks) >= self.nworkers
                self._reply_u32(conn, 1)
                if all_down:
                    self.print_fleet_metrics()
                    self._done.set()
            elif cmd == "topo":
                with self._lock:
                    doc = dict(self._topo)
                b = json.dumps(doc).encode()
                conn.sendall(struct.pack("<I", len(b)) + b)
                conn.close()
            else:
                conn.close()
        except (ConnectionError, OSError, struct.error, UnicodeDecodeError):
            conn.close()

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

    @staticmethod
    def _reply_u32(conn: socket.socket, v: int) -> None:
        conn.sendall(struct.pack("<I", v))
        conn.close()

    def _register(self, conn, task_id: str, host: str, port: int,
                  flags: int, token: str) -> None:
        batch = None
        with self._lock:
            if task_id not in self._ranks:
                self._ranks[task_id] = len(self._ranks)
            rank = self._ranks[task_id]
            if rank >= self.nworkers:
                conn.close()
                return
            self._shutdown_ranks.discard(rank)
            prev = self._pending.get(rank)
            self._pending[rank] = (conn, host, port, flags, token)
            if set(range(self.nworkers)) <= set(self._pending):
                batch = {r: self._pending.pop(r)
                         for r in range(self.nworkers)}
                self._epoch += 1
                epoch = self._epoch
        if prev is not None and prev[0] is not conn:
            # a re-registration superseded a still-parked connection
            prev[0].close()
        if batch is not None:
            self._assign(batch, epoch)

    # -- the epoch's rendezvous store -----------------------------------------
    def _new_store(self, epoch: int) -> Tuple[str, int]:
        """Start this epoch's rendezvous store on a fresh port."""
        import torch.distributed as dist
        store = dist.TCPStore(self.host, 0, is_master=True,
                              wait_for_workers=False,
                              timeout=datetime.timedelta(seconds=300))
        with self._lock:
            self._stores.append((epoch, store))
        return self.host, store.port

    def _reap_old_stores(self, acked_epoch: int) -> None:
        """Drop the stores older than the epoch whose members ALL acked:
        the teardown-before-ack contract guarantees no live client of an
        older epoch exists. Keeps the store count bounded whatever the
        number of recoveries."""
        with self._lock:
            self._stores = [(e, s) for e, s in self._stores
                            if e >= acked_epoch]

    def _assign(self, batch: Dict[int, tuple], epoch: int) -> None:
        world = self.nworkers
        conns = {r: c for r, (c, h, p, f, tok) in batch.items()}
        addr = {r: (h, p, tok) for r, (c, h, p, f, tok) in batch.items()}
        # a store only for an epoch whose workers register a data plane
        want_store = any(f & FLAG_DATAPLANE
                         for (c, h, p, f, tok) in batch.values())
        try:
            coord_host, coord_port = (self._new_store(epoch) if want_store
                                      else ("", 0))
        except (RuntimeError, OSError) as e:
            # a silent failure here would hang every worker in this batch;
            # closing their connections surfaces a registration error
            print(f"[tracker] rendezvous store start failed, rejecting "
                  f"epoch {epoch}: {e}", file=sys.stderr, flush=True)
            for c in conns.values():
                c.close()
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
            by_host.setdefault(_src_ip(c) or h, []).append(rank)
        groups = list(by_host.values())
        with self._lock:
            self._topo = {"epoch": epoch, "groups": groups,
                          "delegates": [min(g) for g in groups],
                          "single_host": single_host}

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
        threading.Thread(target=self._await_acks, args=(conns, epoch),
                         daemon=True).start()

    def _await_acks(self, conns: Dict[int, socket.socket],
                    epoch: int) -> None:
        """The ready-ack barrier. A worker dying before its ack is logged:
        the epoch still completes (the dead worker re-registers into the
        next one after its respawn), but no store is reaped on it."""
        deadline = time.monotonic() + self._ready_timeout
        all_acked = True
        for rank, conn in sorted(conns.items()):
            try:
                conn.settimeout(max(0.0, deadline - time.monotonic()))
                _recv_all(conn, 4)
            except (ConnectionError, OSError) as e:
                all_acked = False
                print(f"[tracker] rank {rank} did not ack epoch {epoch} "
                      f"({type(e).__name__}: {e})", file=sys.stderr,
                      flush=True)
            finally:
                conn.close()
        if all_acked:
            self._reap_old_stores(epoch)

