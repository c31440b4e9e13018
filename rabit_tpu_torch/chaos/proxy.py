"""In-process TCP fault-injection proxy: the port's copy of
``rabit_tpu/chaos/proxy.py``, whole.

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
- ``job_storm``   on entering ``window_s``, hurl a seeded ``burst`` of
                  rogue control connections at the upstream tracker --
                  bogus ``submit`` payloads interleaved with half-open
                  ``start`` preambles -- the thundering-herd shape that
                  multi-job admission control must shed without
                  stalling live jobs (generative: the storm IS the
                  traffic, fired from its own clock thread through a
                  bounded pool of ``_STORM_POOL_MAX`` threads, never a
                  thread a rogue)

Faults fire on the proxy's own threads; the proxied processes observe
only their sockets misbehaving, exactly as with real network faults.
No-fault configs forward byte-exactly (pinned by tier-1 tests).
"""

from __future__ import annotations

import json
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


# tracker/tracker.py's MAGIC: the storm speaks just enough of the
# control protocol (magic u32 + length-prefixed strings) to be rude
_WIRE_MAGIC = 0x52425401


# job_storm's concurrency: the rogues are driven by a BOUNDED pool of
# threads, never a thread a connection -- a burst of hundreds is really
# concurrent load, and the storm itself spawns no thread explosion
_STORM_POOL_MAX = 16


def _storm_rogue(host: str, port: int, seed: int, i: int,
                 tally: dict, lock: threading.Lock) -> None:
    """One rogue connection, index ``i`` of the burst. Its traffic is
    drawn from a Random keyed ``(seed, i)`` — per-connection streams
    stay byte-identical across runs no matter how the pool interleaves
    them (the determinism contract, restated for concurrency)."""
    rng = random.Random((seed * 1_000_003 + 17) * 2_654_435_761 + i)
    job = f"storm-{seed % 997}-{i}"

    def _s(conn: socket.socket, text: str) -> None:
        b = text.encode()
        conn.sendall(struct.pack("<I", len(b)) + b)

    def _recv_exact(conn: socket.socket, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = conn.recv(n - len(out))
            if not chunk:
                raise OSError("tracker closed mid-verdict")
            out += chunk
        return out

    time.sleep(rng.random() * 0.01)  # jittered arrival, still seeded
    try:
        conn = socket.create_connection((host, port), timeout=5.0)
    except OSError:
        with lock:
            tally["errors"] += 1
        return
    verdict = None
    err = False
    try:
        conn.settimeout(5.0)
        conn.sendall(struct.pack("<I", _WIRE_MAGIC))
        if i % 2 == 0:
            _s(conn, "submit")
            _s(conn, job)
            conn.sendall(struct.pack("<I", 0))  # num_attempt
            if rng.random() < 0.34:
                _s(conn, "{not json")  # malformed: error verdict
            else:
                _s(conn, json.dumps({
                    "job": job, "elastic": False,
                    "nworkers": rng.randrange(2, 64)}))
            n = struct.unpack("<I", _recv_exact(conn, 4))[0]
            verdict = json.loads(_recv_exact(conn, n).decode())
        else:
            _s(conn, "start")
            partial = f"{job}/0".encode()
            conn.sendall(struct.pack("<I", len(partial) + 64)
                         + partial)  # promise bytes that never come
    except (OSError, ValueError):
        err = True
    finally:
        _hard_close(conn)
    with lock:
        tally["opened"] += 1
        if err:
            tally["errors"] += 1
        elif i % 2 == 0:
            tally["submits"] += 1
            tally["verdicts"].append((i, verdict))
        else:
            tally["half_open"] += 1


def run_job_storm(host: str, port: int, rule: Rule, seed: int,
                  pool: Optional[int] = None) -> dict:
    """Fire one ``job_storm``: open ``rule.burst`` rogue connections
    against the tracker at ``host:port``, CONCURRENTLY through a
    bounded pool of ``min(burst, pool)`` worker threads (default
    ``_STORM_POOL_MAX``) — a burst of hundreds lands as genuinely
    simultaneous submits, the thundering-herd shape admission control
    must shed without stalling live jobs. Even indices send a complete
    ``submit`` for a job that should never be admitted (fresh bogus
    name; a third carry garbage payloads) and collect the verdict; odd
    indices send a half-open ``start`` preamble — a length prefix
    promising more bytes than ever arrive — then vanish with an RST
    (the crashed-launcher shape). Seeded per connection: rogue ``i``
    draws from a Random keyed ``(seed, i)``, so two storms with the
    same ``(seed, rule)`` emit identical per-connection traffic
    regardless of pool interleaving. Returns a tally the chaos smoke
    and cluster tests assert on."""
    tally = {"opened": 0, "submits": 0, "half_open": 0, "errors": 0,
             "verdicts": []}
    lock = threading.Lock()
    nthreads = min(rule.burst, _STORM_POOL_MAX if pool is None
                   else max(1, pool))
    pending = list(range(rule.burst))

    def _drain() -> None:
        while True:
            with lock:
                if not pending:
                    return
                i = pending.pop(0)
            _storm_rogue(host, port, seed, i, tally, lock)

    threads = [threading.Thread(target=_drain,
                                name=f"chaos-storm-{t}", daemon=True)
               for t in range(nthreads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    # index order, not completion order: assertions on the verdict
    # list must not depend on pool scheduling
    tally["verdicts"] = [v for _i, v in sorted(tally["verdicts"])]
    return tally


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
        # each job_storm firing's tally (appended under _lock; a test
        # polls this to know the burst finished)
        self.storm_results: List[dict] = []
        self._storm_threads: List[threading.Thread] = []
        self._storm_quiesce = threading.Event()
        self.accepted = 0
        self.refused = 0
        self.bytes_forwarded = 0

    # -- lifecycle --------------------------------------------------------
    def start(self) -> "ChaosProxy":
        # written once before the accept thread exists (Thread.start()
        # is the happens-before edge), read-only afterwards
        self._t0 = time.monotonic()  # noqa: C003 - before the thread
        self._thread = threading.Thread(target=self._serve, daemon=True,
                                        name=f"{self.name}-accept")
        self._thread.start()
        # generative rules: job_storm has no byte stream to mutate (the
        # storm IS the traffic), so each one gets a clock-driven thread
        # aimed at whatever upstream retarget() currently points at
        for idx, rule in enumerate(self.schedule.rules):
            if rule.kind == "job_storm":
                t = threading.Thread(target=self._storm_loop,
                                     args=(rule, idx), daemon=True,
                                     name=f"{self.name}-storm-{idx}")
                t.start()
                self._storm_threads.append(t)
        return self

    def join_storms(self, timeout: float = 30.0) -> None:
        """Wait (bounded) for the ``job_storm`` firings in flight, so that
        their tallies land in :attr:`storm_results` before a harvest: a
        short-lived world must not race the storm it survived. Storms
        still waiting for their window stand down rather than being
        waited on."""
        self._storm_quiesce.set()
        deadline = time.monotonic() + timeout
        for t in self._storm_threads:
            t.join(timeout=max(0.0, deadline - time.monotonic()))

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

    def _storm_loop(self, rule: Rule, rule_idx: int) -> None:
        """Clock half of ``job_storm``: sleep to the window edge, spend
        one firing, hurl the burst at the current upstream, and record
        the tally in :attr:`storm_results`."""
        start = rule.window_s[0] if rule.window_s else 0.0
        while self.elapsed() < start and not self._done.is_set() \
                and not self._storm_quiesce.is_set():
            time.sleep(min(0.02, max(0.001, start - self.elapsed())))
        if self._done.is_set() or self._storm_quiesce.is_set() \
                or not self._in_window(rule):
            return
        if not Schedule.consume(rule):
            return
        self._event("job_storm", -1)
        with self._lock:
            host, port = self.upstream
        tally = run_job_storm(host, port, rule,
                              self.schedule.seed * 1_000_003 + rule_idx)
        with self._lock:
            self.storm_results.append(tally)

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
            self.accepted += 1  # noqa: C003 - single-writer tally
            rules = self.schedule.decide(index)
            blackout = next((r for r in rules if r.kind == "blackout"
                             and self._in_window(r)), None)
            if blackout is not None and Schedule.consume(blackout):
                self.refused += 1  # noqa: C003 - single-writer tally
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
                self.refused += 1  # noqa: C003 - single-writer tally
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
                self.refused += 1  # noqa: C003 - single-writer tally
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
