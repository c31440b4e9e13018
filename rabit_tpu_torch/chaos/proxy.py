"""In-process TCP fault-injection proxy: the port's copy of
``rabit_tpu/chaos/proxy.py``, without the ``job_storm`` rule's firing.

One :class:`ChaosProxy` fronts one upstream endpoint (the tracker, or
one worker's link listener). Each accepted client connection gets a
fresh upstream connection and two pump threads (client->upstream,
upstream->client); the connection's fault plan — resolved once from the
seeded :class:`~rabit_tpu_torch.chaos.schedule.Schedule` at accept time —
is applied to the byte stream itself:

- ``delay``       sleep ``delay_ms`` before forwarding each chunk
- ``reset``       once ``after_bytes`` total bytes passed, close BOTH
                  sockets with ``SO_LINGER 0`` so peers see a hard RST
                  mid-transfer, not a polite FIN
- ``partial``     like reset, but first forward only ``truncate_to``
                  bytes of the pending chunk — the torn-write shape
- ``partition``   inside ``window_s`` the pumps stall (bytes neither
                  delivered nor refused) and resume after — the hung
                  peer / lossy-link shape that only a watchdog catches
- ``blackout``    inside ``window_s`` new connections are accepted and
                  immediately RST — the tracker-down shape that the
                  connect-retry path must absorb
- ``bitflip``     XOR 1-4 seeded random bytes of one forwarded chunk —
                  the silent-corruption shape (flaky NIC, bad cable)
                  that only end-to-end payload CRC catches; the bytes
                  still flow, just wrong
- ``tracker_kill``  the first accept inside ``window_s`` (or the
                  ``conn``-th) calls ``kill_hook(delay_ms)``, which
                  crashes the proxied tracker (the launcher's
                  supervisor), and is refused
- ``tracker_partition``  ``partition``, scoped to tracker proxies: the
                  control plane hangs while the links flow

A ``job_storm`` rule (rogue ``submit`` connections at the tracker) makes
:meth:`ChaosProxy.start` raise: the port's tracker has no ``submit``.

Faults fire on the proxy's own threads; the proxied processes observe
only their sockets misbehaving, exactly as with real network faults.
No-fault configs forward byte-exactly (pinned by tier-1 tests).
"""

from __future__ import annotations

import random
import select
import socket
import struct
import sys
import threading
import time
from typing import List, Optional, Tuple

from .schedule import Rule, Schedule

_CHUNK = 65536


def _arm_rst(sock: Optional[socket.socket]) -> None:
    """SO_LINGER 0: make the eventual close() surface as a hard RST —
    an injected fault must look like a crashed peer, not a graceful
    shutdown handshake."""
    if sock is None:
        return
    try:
        sock.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                        struct.pack("ii", 1, 0))
    except OSError:
        pass


def _hard_close(sock: Optional[socket.socket]) -> None:
    """Close with RST. Only safe from the thread that owns the socket:
    closing an fd another thread is blocked reading lets the kernel
    reuse the number for the next accept, silently rewiring the stale
    reader onto the new connection (see ``_Conn.kill``)."""
    if sock is None:
        return
    _arm_rst(sock)
    try:
        sock.close()
    except OSError:
        pass


def _soft_close(sock: Optional[socket.socket]) -> None:
    if sock is None:
        return
    try:
        sock.close()
    except OSError:
        pass


class _Conn:
    """State shared by one proxied connection's two pump threads."""

    def __init__(self, index: int, client: socket.socket,
                 upstream: socket.socket, rules: List[Rule],
                 proxy: "ChaosProxy"):
        self.index = index
        self.client = client
        self.upstream = upstream
        self.rules = rules
        self.proxy = proxy
        self.nbytes = 0            # both directions, under proxy._lock
        self.pumps_done = 0
        self.dead = False

    def kill(self) -> None:
        """Flag the connection dead and arm RST-on-close. The fds are
        NOT closed here: the peer pump thread may be blocked in recv on
        one of them, and closing an fd under a blocked reader lets the
        kernel recycle the number for the next accepted connection —
        the stale reader then steals the new connection's bytes. Each
        pump notices ``dead`` within one select tick and the last one
        out closes both sockets (RST, linger is already armed)."""
        self.dead = True
        _arm_rst(self.client)
        _arm_rst(self.upstream)


class ChaosProxy:
    """TCP proxy executing a seeded fault schedule. Thread-based and
    in-process: start()/stop() from tests or the launcher."""

    def __init__(self, upstream_host: str, upstream_port: int,
                 schedule: Optional[Schedule] = None,
                 listen_host: str = "127.0.0.1", port: int = 0,
                 name: str = "chaos", kill_hook=None):
        self.upstream = (upstream_host, int(upstream_port))
        self.schedule = schedule or Schedule()
        self.name = name
        # ``tracker_kill`` support: ``kill_hook(delay_ms)`` kills the
        # proxied upstream (and, when the supervisor has a WAL,
        # schedules a --resume respawn after delay_ms). None = the
        # rule is inert on this proxy (e.g. link proxies).
        self.kill_hook = kill_hook
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((listen_host, port))
        self._sock.listen(128)
        self.host, self.port = self._sock.getsockname()
        self._lock = threading.Lock()
        self._done = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._conns: List[_Conn] = []
        self._t0 = 0.0
        # observability: (t_rel, kind, conn_index) per injected fault,
        # plus totals the byte-accuracy tests assert on
        self.events: List[Tuple[float, str, int]] = []
        self.accepted = 0
        self.refused = 0
        self.bytes_forwarded = 0

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ChaosProxy":
        if any(r.kind == "job_storm" for r in self.schedule.rules):
            # refused, never skipped: a schedule that asked for a storm
            # and ran without one would pass for a survived storm
            self._sock.close()
            raise NotImplementedError(
                "chaos 'job_storm' is not ported to rabit_tpu_torch: it "
                "speaks 'submit', which the port's tracker lacks")
        # written once before the accept thread exists (Thread.start()
        # is the happens-before edge), read-only afterwards
        self._t0 = time.monotonic()
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"{self.name}-accept")
        self._thread.start()
        return self

    def stop(self) -> None:
        self._done.set()
        try:
            self._sock.close()
        except OSError:
            pass
        with self._lock:
            conns = list(self._conns)
        for c in conns:
            c.kill()

    def __enter__(self) -> "ChaosProxy":
        return self.start()

    def __exit__(self, *exc) -> bool:
        self.stop()
        return False

    def retarget(self, host: str, port: int) -> None:
        """Repoint NEW connections at a different upstream (a hot
        standby's failover): the promoted tracker owns the world now,
        and every address baked into a live worker — including the
        native engine's shutdown path — keeps resolving through this
        proxy. Established connections are untouched; they belong to
        the deposed upstream and die with it."""
        with self._lock:
            self.upstream = (host, int(port))

    def elapsed(self) -> float:
        return time.monotonic() - self._t0

    def _event(self, kind: str, conn_index: int) -> None:
        with self._lock:
            self.events.append((self.elapsed(), kind, conn_index))
        # telemetry is stdlib-only, so the chaos layer may lean on it:
        # every injected fault leaves a counter (fleet tables show how
        # much chaos a run actually absorbed) and a flight-recorder
        # breadcrumb (crash bundles show what was injected just before)
        from .. import telemetry
        from ..telemetry import events, flight
        telemetry.count(f"chaos.{kind}", op=self.name, provenance="chaos")
        flight.note(f"chaos.{kind}",
                    f"{self.name} conn#{conn_index} -> "
                    f"{self.upstream[0]}:{self.upstream[1]}")
        # fleet event bus: the injection lands HLC-stamped in the
        # causal record, so the incident engine can attribute the
        # recovery rungs and SLO burns that follow it (the rule kind
        # maps onto the registered chaos.<kind> namespace)
        events.emit_chaos(kind,
                          f"{self.name} conn#{conn_index} -> "
                          f"{self.upstream[0]}:{self.upstream[1]}")
        print(f"[{self.name}] t={self.elapsed():.2f}s inject {kind} "
              f"conn#{conn_index} -> {self.upstream[0]}:{self.upstream[1]}",
              file=sys.stderr, flush=True)

    # -- accept loop ------------------------------------------------------
    def _in_window(self, rule: Rule) -> bool:
        if rule.window_s is None:
            return False
        t = self.elapsed()
        return rule.window_s[0] <= t < rule.window_s[1]

    def _serve(self) -> None:
        self._sock.settimeout(0.2)
        while not self._done.is_set():
            try:
                client, _ = self._sock.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            index = self.accepted
            # accept/refuse tallies have a single writer (this serve
            # thread); tests read them only after stop()
            self.accepted += 1
            rules = self.schedule.decide(index)
            blackout = next((r for r in rules if r.kind == "blackout"
                             and self._in_window(r)), None)
            if blackout is not None and Schedule.consume(blackout):
                self.refused += 1
                self._event("blackout", index)
                _hard_close(client)
                continue
            # tracker_kill: the first accept inside the
            # rule's window (or its targeted conn index) murders the
            # proxied tracker via the supervisor's kill hook — the
            # triggering client sees an RST exactly as it would
            # connecting to a freshly dead tracker
            kill = next((r for r in rules if r.kind == "tracker_kill"
                         and (self._in_window(r) or (r.window_s is None
                                                     and r.conn == index))),
                        None)
            if kill is not None and self.kill_hook is not None \
                    and Schedule.consume(kill):
                self._event("tracker_kill", index)
                try:
                    self.kill_hook(kill.delay_ms)
                except Exception as e:  # chaos never aborts
                    print(f"[{self.name}] kill hook failed: {e}",
                          file=sys.stderr, flush=True)
                self.refused += 1
                _hard_close(client)
                continue
            with self._lock:
                upstream_addr = self.upstream  # retarget()-able
            try:
                upstream = socket.create_connection(upstream_addr,
                                                    timeout=10.0)
            except OSError:
                # upstream genuinely down: behave like it (RST, since a
                # refused connect surfaces as an error, not a hang)
                self.refused += 1
                _hard_close(client)
                continue
            conn = _Conn(index, client, upstream, rules, self)
            with self._lock:
                self._conns.append(conn)
            for src, dst, tag in ((client, upstream, "c2u"),
                                  (upstream, client, "u2c")):
                threading.Thread(
                    target=self._pump, args=(conn, src, dst), daemon=True,
                    name=f"{self.name}-{index}-{tag}").start()

    # -- data path --------------------------------------------------------
    def _pump(self, conn: _Conn, src: socket.socket,
              dst: socket.socket) -> None:
        try:
            while not self._done.is_set() and not conn.dead:
                # select (not a blocking recv) so a kill() from the
                # other pump is noticed within one tick — recv may only
                # run while this thread knows the fds are still owned
                try:
                    readable, _, _ = select.select([src], [], [], 0.05)
                except (OSError, ValueError):
                    break
                if not readable:
                    continue
                try:
                    chunk = src.recv(_CHUNK)
                except OSError:
                    # the peer reset its end (a crash, or a close with
                    # unread bytes): pass the reset on, as the wire
                    # would. Without it the far end, waiting to read,
                    # never learns and waits forever.
                    conn.kill()
                    break
                if not chunk:
                    # graceful EOF: half-close toward dst so protocols
                    # relying on shutdown semantics still work
                    try:
                        dst.shutdown(socket.SHUT_WR)
                    except OSError:
                        pass
                    break
                if not self._apply_faults(conn, dst, chunk):
                    break
        finally:
            with self._lock:
                conn.pumps_done += 1
                last = conn.pumps_done >= 2
                if last and conn in self._conns:
                    self._conns.remove(conn)
            if last:
                # both pumps out: this thread now owns the fds. Killed
                # connections close hard (RST — linger armed by kill);
                # the no-fault path closes gracefully.
                closer = _hard_close if conn.dead else _soft_close
                closer(conn.client)
                closer(conn.upstream)

    def _apply_faults(self, conn: _Conn, dst: socket.socket,
                      chunk: bytes) -> bool:
        """Forward ``chunk`` under the connection's plan. Returns False
        once the connection was killed."""
        for rule in conn.rules:
            if rule.kind == "delay" and rule.delay_ms > 0:
                if Schedule.consume(rule):
                    self._event("delay", conn.index)
                    time.sleep(rule.delay_ms / 1e3)
            elif rule.kind in ("partition", "tracker_partition"):
                # tracker_partition is the same pump stall,
                # but the rule is target-scoped to tracker proxies at
                # schedule level: control-plane bytes hang while link
                # proxies keep flowing — the shape that must trip
                # hot-standby failover, not worker recovery
                stalled = False
                while self._in_window(rule) and not self._done.is_set() \
                        and not conn.dead:
                    if not stalled:
                        stalled = True
                        if not Schedule.consume(rule):
                            break
                        self._event(rule.kind, conn.index)
                    time.sleep(0.02)
        with self._lock:
            total = conn.nbytes + len(chunk)
            conn.nbytes = total
        for rule in conn.rules:
            # seeded per-draw corruption: the rng key folds in the
            # firing count so each flip of a multi-shot rule corrupts
            # different bytes, while two runs with the same seed and
            # accept order corrupt byte-identically
            if rule.kind != "bitflip":
                continue
            if rule.window_s is not None and not self._in_window(rule):
                continue
            if rule.after_bytes and total < rule.after_bytes:
                continue
            draw = rule.fired
            if not Schedule.consume(rule):
                continue
            rng = random.Random(
                (self.schedule.seed * 1_000_003 + conn.index)
                * 1_000_003 + draw)
            corrupt = bytearray(chunk)
            for _ in range(rng.randint(1, min(4, len(corrupt)))):
                pos = rng.randrange(len(corrupt))
                corrupt[pos] ^= rng.randint(1, 255)  # never a no-op flip
            chunk = bytes(corrupt)
            self._event("bitflip", conn.index)
        trigger = next(
            (r for r in conn.rules
             if r.kind in ("reset", "partial") and total >= r.after_bytes),
            None)
        if trigger is not None and Schedule.consume(trigger):
            if trigger.kind == "partial" and trigger.truncate_to > 0:
                part = chunk[:trigger.truncate_to]
                try:
                    dst.sendall(part)
                    with self._lock:
                        self.bytes_forwarded += len(part)
                except OSError:
                    pass
            self._event(trigger.kind, conn.index)
            conn.kill()
            return False
        try:
            dst.sendall(chunk)
        except OSError:
            conn.kill()   # dst is gone: src learns it as a reset too
            return False
        with self._lock:
            self.bytes_forwarded += len(chunk)
        return True
