"""The tracker's connection plane: the port's copy of
``rabit_tpu/tracker/evloop.py``, one ``selectors`` readiness loop and a
fixed pool of command threads.

One loop thread owns accept, read and write readiness for every worker
connection. Each connection keeps an input and an output buffer instead
of a blocking ``recv`` loop, and a parsed command is handed to a fixed
pool of service threads (:class:`ServicePool`) through per-key FIFO
queues. An idle connection costs a file descriptor and a buffer, never a
thread; ``python -m rabit_tpu_torch.tools.tracker_bench`` measures that.

This module knows bytes and readiness, never commands: the wire grammar,
the dispatch and every ``JobState`` mutation stay in ``tracker.py``. The
tracker hands the loop parser GENERATORS: a generator yields how many
bytes it needs next and returns the parsed command, and the loop feeds
it exactly those bytes as they arrive.

Threading contract:

- every :class:`Conn` is owned by the loop thread: its buffers and its
  selector registration are touched there only;
- other threads reach a connection only through :meth:`EventLoop.send`,
  :meth:`EventLoop.expect`, :meth:`EventLoop.close_conn` and
  :meth:`EventLoop.call`, which marshal onto the loop thread through a
  wakeup socket pair. The op queue's lock is a leaf, held only around an
  append or a pop and never across user code, so it cannot close a lock
  cycle with the tracker's locks;
- callbacks (``on_command``, ``on_bytes``, timers) run ON the loop thread
  and stay cheap: they take no tracker lock, and real work goes to the
  :class:`ServicePool`.

Knobs: ``RABIT_LOOP_MAX_CONNS`` (:func:`loop_max_conns`, default 0:
unbounded) closes connections past the cap at the door;
``RABIT_LOOP_SERVICE_THREADS`` (:func:`service_threads`, default 4) sizes
the pool. ``python -m rabit_tpu_torch.tracker.evloop --smoke`` holds 200
half-written connections on the loop with no thread added, then echoes a
frame on each. Standard library only.
"""

from __future__ import annotations

import os
import selectors
import socket
import threading
import time
from collections import deque
from typing import Callable, Deque, Dict, Generator, List, Optional, \
    Tuple

LOOP_MAX_CONNS_ENV = "RABIT_LOOP_MAX_CONNS"
SERVICE_THREADS_ENV = "RABIT_LOOP_SERVICE_THREADS"
SERVICE_THREADS_DEFAULT = 4

# one recv a readiness event: large enough that an assignment or a JSON
# payload lands in one call, small enough to bound a connection's burst
_RECV_CHUNK = 1 << 16


def loop_max_conns() -> int:
    """``rabit_loop_max_conns``: the cap on open worker connections; past
    it a new connection is closed at once (shed at the door, the loop
    never stalls). 0, the default, is unbounded."""
    try:
        return max(0, int(os.environ.get(LOOP_MAX_CONNS_ENV, 0)))
    except ValueError:
        return 0


def service_threads() -> int:
    """``rabit_loop_service_threads``: the size of the fixed pool that
    serves parsed commands. The tracker's threads are the loop, this pool
    and its fixed helpers, never a number that grows with connections."""
    try:
        return max(1, int(os.environ.get(SERVICE_THREADS_ENV,
                                         SERVICE_THREADS_DEFAULT)))
    except ValueError:
        return SERVICE_THREADS_DEFAULT


class Conn:
    """One accepted connection, owned by the loop thread (see the
    module's threading contract)."""

    __slots__ = ("sock", "fd", "peer", "inbuf", "outbuf", "parser",
                 "need", "on_parsed", "on_fail", "want", "exp_n",
                 "exp_cb", "exp_fail", "timer", "close_after",
                 "closed", "detached")

    def __init__(self, sock: socket.socket, peer):
        self.sock = sock
        self.fd = sock.fileno()
        self.peer = peer                  # kept: getpeername after close
        self.inbuf = bytearray()
        self.outbuf = bytearray()
        self.parser: Optional[Generator] = None
        self.need = 0                     # bytes the parser waits for
        self.on_parsed: Optional[Callable] = None
        self.on_fail: Optional[Callable] = None
        self.exp_n = 0                    # bytes an expect() waits for
        self.exp_cb: Optional[Callable] = None
        self.exp_fail: Optional[Callable] = None
        self.timer = None                 # the expect's timeout, if any
        self.want = 0                     # the selector interest mask
        self.close_after = False          # close once outbuf drains
        self.closed = False
        self.detached = False

    def getpeername(self):
        """The peer's address as at accept: stable across a close, which
        the tracker's host grouping needs."""
        return self.peer


class _Timer:
    __slots__ = ("deadline", "fn", "cancelled")

    def __init__(self, deadline: float, fn: Callable):
        self.deadline = deadline
        self.fn = fn
        self.cancelled = False


class EventLoop:
    """The readiness loop. Construct it, :meth:`add_listener`, then
    :meth:`run` on a thread of its own; every other public method is safe
    from any thread unless it says it is for the loop thread only."""

    def __init__(self, max_conns: Optional[int] = None):
        self._sel = selectors.DefaultSelector()
        self._mu = threading.Lock()       # leaf: the op queue, wake flag
        self._ops: Deque[Callable] = deque()   # guarded-by: _mu
        self._wake_armed = False               # guarded-by: _mu
        # the wakeup channel: one byte written makes select() return
        self._wr, self._rd = socket.socketpair()
        self._rd.setblocking(False)
        self._wr.setblocking(False)
        self._sel.register(self._rd, selectors.EVENT_READ, ("wake", None))
        self._timers: List[_Timer] = []   # loop thread only, sorted
        self._listeners: Dict[int, Tuple[socket.socket, Callable]] = {}
        self._conns: Dict[int, Conn] = {}  # loop thread only
        self._done = threading.Event()
        self.max_conns = loop_max_conns() if max_conns is None else max_conns
        self.accepted_total = 0
        self.shed_conns_total = 0
        self._lag_ewma_ms = 0.0

    # -- introspection (any thread; plain reads) ------------------------------
    @property
    def open_conns(self) -> int:
        return len(self._conns)

    def lag_ms(self) -> float:
        """EWMA of the time the loop spent serving one wakeup: the delay a
        newly ready connection waits behind the current batch."""
        return self._lag_ewma_ms

    # -- marshalling onto the loop thread -------------------------------------
    def call(self, fn: Callable) -> None:
        """Run ``fn()`` on the loop thread, in each caller's order. Safe
        from any thread, the loop thread too."""
        with self._mu:
            self._ops.append(fn)
            wake = not self._wake_armed
            self._wake_armed = True
        if wake:
            try:
                self._wr.send(b"\x00")
            except (OSError, ValueError):
                pass  # the loop is ending; its teardown drains the queue

    def call_later(self, delay_s: float, fn: Callable) -> _Timer:
        """Run ``fn()`` on the loop thread after ``delay_s``. The handle's
        ``cancelled`` flag, set on the loop thread, revokes it."""
        t = _Timer(time.monotonic() + max(0.0, delay_s), fn)
        self.call(lambda: self._arm_timer(t))
        return t

    def _arm_timer(self, t: _Timer) -> None:
        self._timers.append(t)
        self._timers.sort(key=lambda x: x.deadline)

    # -- the connection API (any thread; marshalled) --------------------------
    def send(self, conn: Conn, data: bytes,
             close_after: bool = False) -> None:
        """Queue ``data`` on ``conn``; write readiness drains it.
        ``close_after`` closes once the buffer is empty: the reply-then-
        hang-up of most tracker commands."""
        self.call(lambda: self._do_send(conn, bytes(data), close_after))

    def expect(self, conn: Conn, n: int, on_bytes: Callable,
               timeout: Optional[float] = None,
               on_fail: Optional[Callable] = None) -> None:
        """Wait for exactly ``n`` bytes on ``conn``, then call
        ``on_bytes(conn, data)`` (loop thread). EOF, a socket error, or
        ``timeout`` seconds without the bytes call ``on_fail(conn, exc)``
        instead; the connection is left for the callback to close."""
        self.call(lambda: self._do_expect(conn, n, on_bytes, timeout,
                                          on_fail))

    def close_conn(self, conn: Conn) -> None:
        """Close from any thread (an eviction, a stop). Pending output is
        dropped."""
        self.call(lambda: self._do_close(conn))

    # -- loop thread only -----------------------------------------------------
    def start_parse(self, conn: Conn, gen: Generator,
                    on_parsed: Callable,
                    on_fail: Optional[Callable] = None) -> None:
        """Prime ``gen`` (it yields byte counts and returns the parsed
        value) on ``conn``; ``on_parsed(conn, value)`` fires when it
        returns. Loop thread only (accept callbacks run there)."""
        conn.parser = gen
        conn.on_parsed = on_parsed
        conn.on_fail = on_fail
        try:
            conn.need = gen.send(None)
        except StopIteration as stop:
            conn.parser = None
            on_parsed(conn, stop.value)
            return
        self._update_interest(conn)
        self._pump(conn)

    def detach(self, conn: Conn) -> Tuple[socket.socket, bytes]:
        """Take ``conn`` off the loop: its socket, blocking again, and the
        bytes already buffered, for a protocol that leaves readiness for a
        thread of its own (the ``repl`` stream). Loop thread only."""
        if conn.want:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
            conn.want = 0
        self._conns.pop(conn.fd, None)
        conn.detached = True
        conn.parser = None
        conn.sock.setblocking(True)
        return conn.sock, bytes(conn.inbuf)

    # -- listeners ------------------------------------------------------------
    def add_listener(self, sock: socket.socket,
                     on_accept: Callable) -> None:
        """Register a listening socket; ``on_accept(conn)`` runs on the
        loop thread for each accepted connection (after the ``max_conns``
        shed). Call before :meth:`run`."""
        sock.setblocking(False)
        self._listeners[sock.fileno()] = (sock, on_accept)
        self._sel.register(sock, selectors.EVENT_READ,
                           ("accept", on_accept))

    # -- lifecycle ------------------------------------------------------------
    def stop(self) -> None:
        """Stop the loop from any thread; ``run`` closes every connection
        (without flushing) and returns."""
        self._done.set()
        try:
            self._wr.send(b"\x00")
        except (OSError, ValueError):
            pass

    def run(self) -> None:
        """The loop's body, on a thread of its own."""
        try:
            while not self._done.is_set():
                events = self._sel.select(self._next_timeout())
                t0 = time.monotonic()
                for key, mask in events:
                    kind = key.data[0] if isinstance(key.data, tuple) \
                        else key.data
                    if kind == "wake":
                        self._drain_wake()
                    elif kind == "accept":
                        self._do_accept(key.fileobj, key.data[1])
                    else:  # a Conn
                        self._service(key.data, mask)
                self._run_ops()
                self._fire_timers()
                busy_ms = (time.monotonic() - t0) * 1e3
                self._lag_ewma_ms += 0.2 * (busy_ms - self._lag_ewma_ms)
        finally:
            self._teardown()

    # -- internals (loop thread) ----------------------------------------------
    def _next_timeout(self) -> Optional[float]:
        while self._timers and self._timers[0].cancelled:
            self._timers.pop(0)
        if not self._timers:
            return None
        return max(0.0, self._timers[0].deadline - time.monotonic())

    def _fire_timers(self) -> None:
        now = time.monotonic()
        while self._timers and self._timers[0].deadline <= now:
            t = self._timers.pop(0)
            if t.cancelled:
                continue
            try:
                t.fn()
            except Exception:  # noqa: BLE001 - a timer never kills the loop
                pass

    def _drain_wake(self) -> None:
        try:
            while self._rd.recv(4096):
                pass
        except (BlockingIOError, OSError):
            pass
        with self._mu:
            self._wake_armed = False

    def _run_ops(self) -> None:
        while True:
            with self._mu:
                if not self._ops:
                    return
                fn = self._ops.popleft()
            try:
                fn()
            except Exception:  # noqa: BLE001 - an op never kills the loop
                pass

    def _do_accept(self, lsock, on_accept: Callable) -> None:
        # accept a burst: one readiness event may stand for many
        # connections under a storm
        for _ in range(64):
            try:
                s, peer = lsock.accept()
            except (BlockingIOError, InterruptedError):
                return
            except OSError:
                return  # the listener was shut under us (stop, crash)
            if self.max_conns and len(self._conns) >= self.max_conns:
                self.shed_conns_total += 1
                try:
                    s.close()
                except OSError:
                    pass
                continue
            s.setblocking(False)
            conn = Conn(s, peer)
            self._conns[conn.fd] = conn
            self.accepted_total += 1
            try:
                on_accept(conn)
            except Exception:  # noqa: BLE001 - accept goes on
                self._do_close(conn)

    def _update_interest(self, conn: Conn) -> None:
        if conn.closed or conn.detached:
            return
        want = 0
        if conn.parser is not None or conn.exp_cb is not None:
            want |= selectors.EVENT_READ
        if conn.outbuf:
            want |= selectors.EVENT_WRITE
        if want == conn.want:
            return
        try:
            if not want:
                self._sel.unregister(conn.sock)
            elif not conn.want:
                self._sel.register(conn.sock, want, conn)
            else:
                self._sel.modify(conn.sock, want, conn)
        except (KeyError, ValueError, OSError):
            self._do_close(conn)
            return
        conn.want = want

    def _service(self, conn: Conn, mask: int) -> None:
        if conn.closed:
            return
        if mask & selectors.EVENT_WRITE:
            self._flush(conn)
        if conn.closed:
            return
        if mask & selectors.EVENT_READ:
            try:
                data = conn.sock.recv(_RECV_CHUNK)
            except (BlockingIOError, InterruptedError):
                data = None
            except OSError as e:
                self._fail(conn, e)
                return
            if data == b"":
                self._fail(conn, ConnectionError("peer closed"))
                return
            if data:
                conn.inbuf += data
                self._pump(conn)

    def _fail(self, conn: Conn, exc: Exception) -> None:
        """EOF or an error: to whichever continuation is armed."""
        cb = conn.exp_fail or conn.on_fail
        conn.exp_cb = conn.exp_fail = None
        conn.parser = None
        self._cancel_timer(conn)
        if cb is not None:
            conn.on_fail = None
            try:
                cb(conn, exc)
            except Exception:  # noqa: BLE001 - outlive the callback
                pass
            if not conn.closed and not conn.detached:
                self._update_interest(conn)
        else:
            self._do_close(conn)

    def _pump(self, conn: Conn) -> None:
        """Feed the buffered bytes to the parser or the expect."""
        while not conn.closed and not conn.detached:
            if conn.parser is not None:
                if len(conn.inbuf) < conn.need:
                    break
                chunk = bytes(conn.inbuf[:conn.need])
                del conn.inbuf[:conn.need]
                try:
                    conn.need = conn.parser.send(chunk)
                except StopIteration as stop:
                    conn.parser = None
                    on_parsed, conn.on_parsed = conn.on_parsed, None
                    if on_parsed is not None:
                        on_parsed(conn, stop.value)
                except Exception as e:  # noqa: BLE001 - the parser bailed
                    self._fail(conn, e)
                    return
            elif conn.exp_cb is not None:
                if len(conn.inbuf) < conn.exp_n:
                    break
                data = bytes(conn.inbuf[:conn.exp_n])
                del conn.inbuf[:conn.exp_n]
                cb, conn.exp_cb, conn.exp_fail = conn.exp_cb, None, None
                self._cancel_timer(conn)
                try:
                    cb(conn, data)
                except Exception:  # noqa: BLE001 - outlive the callback
                    self._do_close(conn)
                    return
            else:
                break
        if not conn.closed and not conn.detached:
            self._update_interest(conn)

    def _flush(self, conn: Conn) -> None:
        try:
            while conn.outbuf:
                n = conn.sock.send(conn.outbuf)
                if n <= 0:
                    break
                del conn.outbuf[:n]
        except (BlockingIOError, InterruptedError):
            pass
        except OSError as e:
            self._fail(conn, e)
            return
        if not conn.outbuf and conn.close_after:
            self._do_close(conn)
            return
        self._update_interest(conn)

    def _do_send(self, conn: Conn, data: bytes, close_after: bool) -> None:
        if conn.closed or conn.detached:
            return
        conn.outbuf += data
        conn.close_after = conn.close_after or close_after
        self._flush(conn)

    def _do_expect(self, conn: Conn, n: int, on_bytes: Callable,
                   timeout: Optional[float],
                   on_fail: Optional[Callable]) -> None:
        if conn.closed or conn.detached:
            if on_fail is not None:
                try:
                    on_fail(conn, ConnectionError("connection closed"))
                except Exception:  # noqa: BLE001 - the loop outlives it
                    pass
            return
        conn.exp_n = n
        conn.exp_cb = on_bytes
        conn.exp_fail = on_fail
        if timeout is not None:
            def _expire() -> None:
                if conn.exp_cb is on_bytes and not conn.closed:
                    self._fail(conn, TimeoutError(
                        f"no reply within {timeout:.1f}s"))
            t = _Timer(time.monotonic() + timeout, _expire)
            conn.timer = t
            self._arm_timer(t)
        self._pump(conn)

    def _cancel_timer(self, conn: Conn) -> None:
        if conn.timer is not None:
            conn.timer.cancelled = True
            conn.timer = None

    def _do_close(self, conn: Conn) -> None:
        if conn.closed or conn.detached:
            return
        conn.closed = True
        self._cancel_timer(conn)
        if conn.want:
            try:
                self._sel.unregister(conn.sock)
            except (KeyError, ValueError, OSError):
                pass
            conn.want = 0
        self._conns.pop(conn.fd, None)
        try:
            conn.sock.close()
        except OSError:
            pass

    def _teardown(self) -> None:
        self._run_ops()  # late sends and closes still drain in order
        for conn in list(self._conns.values()):
            self._do_close(conn)
        for lsock, _cb in self._listeners.values():
            try:
                self._sel.unregister(lsock)
            except (KeyError, ValueError, OSError):
                pass
        try:
            self._sel.unregister(self._rd)
        except (KeyError, ValueError, OSError):
            pass
        for s in (self._rd, self._wr):
            try:
                s.close()
            except OSError:
                pass
        self._sel.close()


class ServicePool:
    """A fixed pool of command threads draining per-key FIFO queues. Keys
    (the tracker's are job ids) are served round-robin, a task a turn: a
    key with work waits for at most one task of each other key with work,
    so one job's storm of commands cannot starve a neighbour's. Within a
    key commands start in FIFO order but may overlap across threads, as
    they did with a thread a connection."""

    def __init__(self, nthreads: Optional[int] = None,
                 name: str = "rabit-svc"):
        self.nthreads = service_threads() if nthreads is None else nthreads
        self._name = name
        self._cv = threading.Condition()
        self._queues: Dict[str, Deque[Callable]] = {}  # guarded-by: _cv
        # the rotation: each key with queued work, once
        self._ready: Deque[str] = deque()              # guarded-by: _cv
        self._done = False                             # guarded-by: _cv
        self._threads: List[threading.Thread] = []

    def start(self) -> "ServicePool":
        for i in range(self.nthreads):
            t = threading.Thread(target=self._run,
                                 name=f"{self._name}-{i}", daemon=True)
            t.start()
            self._threads.append(t)
        return self

    def submit(self, key: str, fn: Callable) -> None:
        """Queue ``fn()`` on ``key``'s FIFO. Never blocks."""
        with self._cv:
            if self._done:
                return
            q = self._queues.get(key)
            if q is None:
                q = self._queues[key] = deque()
                self._ready.append(key)   # the key joins the rotation
            q.append(fn)
            self._cv.notify()

    def stop(self) -> None:
        with self._cv:
            self._done = True
            self._cv.notify_all()

    def depth(self) -> int:
        with self._cv:
            return sum(len(q) for q in self._queues.values())

    def _run(self) -> None:
        while True:
            with self._cv:
                while not self._ready and not self._done:
                    self._cv.wait()
                if self._done:
                    return
                key = self._ready.popleft()
                q = self._queues[key]
                fn = q.popleft()
                if q:
                    self._ready.append(key)   # its next task, next turn
                else:
                    del self._queues[key]
            try:
                fn()
            except Exception:  # noqa: BLE001 - the pool survives a task;
                # a command's own quarantine is the tracker's
                pass


# ------------------------------------------------------------------ smoke


def _smoke() -> None:
    """One loop thread echoes length-prefixed frames over 200 connections
    at once, held half-written first, with no thread added."""
    import struct as _struct

    before = threading.active_count()
    lsock = socket.socket()
    lsock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(512)
    port = lsock.getsockname()[1]

    loop = EventLoop(max_conns=0)

    def parser():
        (n,) = _struct.unpack("<I", (yield 4))
        body = (yield n) if n else b""
        return body

    def on_accept(conn):
        def done(c, body):
            loop.send(c, _struct.pack("<I", len(body)) + body,
                      close_after=True)
        loop.start_parse(conn, parser(), done)

    loop.add_listener(lsock, on_accept)
    th = threading.Thread(target=loop.run, name="evloop-smoke",
                          daemon=True)
    th.start()
    try:
        n_conns = 200
        socks = []
        for _ in range(n_conns):
            c = socket.create_connection(("127.0.0.1", port), timeout=10)
            c.settimeout(10)
            socks.append(c)
        # every connection open and half-written: the loop holds them
        # without starting anything
        for c in socks:
            c.sendall(_struct.pack("<I", 8))  # the header now, the body later
        assert threading.active_count() <= before + 1, \
            f"the loop grew threads: {threading.active_count()} vs {before}"
        for i, c in enumerate(socks):
            c.sendall(_struct.pack("<Q", i))
        for i, c in enumerate(socks):
            got = b""
            while len(got) < 12:
                chunk = c.recv(12 - len(got))
                assert chunk, "the echo closed early"
                got += chunk
            (ln,) = _struct.unpack("<I", got[:4])
            (val,) = _struct.unpack("<Q", got[4:])
            assert ln == 8 and val == i, (ln, val, i)
            c.close()
        deadline = time.monotonic() + 5
        while loop.open_conns and time.monotonic() < deadline:
            time.sleep(0.01)
        assert loop.open_conns == 0, loop.open_conns
        assert loop.accepted_total == n_conns
    finally:
        loop.stop()
        th.join(timeout=5)
        lsock.close()
    print("evloop smoke ok")


if __name__ == "__main__":
    import sys
    if "--smoke" in sys.argv:
        _smoke()
    else:
        print(__doc__)
