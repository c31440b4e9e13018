"""The port's connection plane (``rabit_tpu_torch/tracker/evloop.py`` and
the tracker's incremental parser) on the CPU: the port's ``EventLoop``
and the JAX package's, fed the same requests cut into fragments (cut
points from a numpy seed, and every byte boundary of one request), parse
the same commands and send the same reply bytes; the port's
``_parse_command`` equals the JAX tracker's on every command's encoding;
and the loop's and the pool's own cases."""

import socket
import struct
import threading
import time

import numpy as np
import pytest

from rabit_tpu.tracker import evloop as jax_evloop
from rabit_tpu.tracker import tracker as jax_tracker
from rabit_tpu_torch.tracker import evloop
from rabit_tpu_torch.tracker import tracker as port_tracker

MAGIC = port_tracker.MAGIC


def _u32(v):
    return struct.pack("<I", v)


def _str(s):
    b = s.encode() if isinstance(s, str) else s
    return _u32(len(b)) + b


def _request(cmd, task="t0", *fields):
    out = _u32(MAGIC) + _str(cmd) + _str(task) + _u32(3)
    for f in fields:
        out += _u32(f) if isinstance(f, int) else _str(f)
    return out


# every command's encoding, as the workers and launchers write it
REQUESTS = [
    _request("start", "t0", "10.0.0.1", 9100, 1, "uds-a"),
    _request("recover", "A/1", "host-b", 9101, 0, ""),
    _request("join", "2", "127.0.0.1", 0, 1, "tok"),
    _request("print", "t1", "hello from rank 1"),
    _request("metrics", "t1", '{"rank": 1, "counters": {}}'),
    _request("endpoint", "t0", '{"host": "h", "port": 9, "rank": 0}'),
    _request("resume", "t0", '{"rank": 0, "epoch": 1}'),
    _request("evict", "t0", '{"rank": 1, "reason": "dead"}'),
    _request("submit", "x", '{"job": "A", "nworkers": 2}'),
    _request("topo", "t0"), _request("skew", "0"), _request("world", "t0"),
    _request("shutdown", "t0"), _request("repl", "standby"),
    _request("bogus", "t0"),
    _request("print", "t0", "ünïcödé"),
    _u32(MAGIC ^ 1) + _str("world"),   # a bad magic
]


def _drive(gen, data: bytes):
    """Feed ``data`` to a parser generator exactly as the loop does; its
    value, or the exception it raised."""
    try:
        need = gen.send(None)
        while True:
            chunk, data = data[:need], data[need:]
            assert len(chunk) == need, "the request ran out"
            need = gen.send(chunk)
    except StopIteration as stop:
        return stop.value
    except (ConnectionError, UnicodeDecodeError) as e:
        return type(e).__name__


@pytest.mark.parametrize("i", range(len(REQUESTS)))
def test_parse_command_matches_the_jax_trackers(i):
    data = REQUESTS[i]
    got = _drive(port_tracker._parse_command(), data)
    assert got == _drive(jax_tracker._parse_command(), data)
    if i < len(REQUESTS) - 1:
        assert got[0] in data.decode("utf-8", "replace")


@pytest.mark.parametrize("bad", [
    _u32(MAGIC) + _u32(port_tracker._MAX_WIRE_STR + 1),
    _u32(MAGIC) + _str("print") + _str("t0") + _u32(0) + _str(b"\xff\xfe"),
])
def test_parse_command_refuses_what_the_jax_tracker_refuses(bad):
    got = _drive(port_tracker._parse_command(), bad)
    assert got in ("ConnectionError", "UnicodeDecodeError")
    assert got == _drive(jax_tracker._parse_command(), bad)


# ---------------------------------------------------------------- the loops


class _Server:
    """A loop of ``mod`` parsing with ``parse`` on a listener of its own;
    each parsed request is answered with its repr, length-prefixed."""

    def __init__(self, mod, parse, max_conns=0):
        self.loop = mod.EventLoop(max_conns=max_conns)
        self.parsed = []
        self.lsock = socket.socket()
        self.lsock.bind(("127.0.0.1", 0))
        self.lsock.listen(512)
        self.addr = self.lsock.getsockname()

        def done(conn, value):
            self.parsed.append(value)
            body = repr(value).encode()
            self.loop.send(conn, _u32(len(body)) + body, close_after=True)

        self.loop.add_listener(
            self.lsock, lambda c: self.loop.start_parse(c, parse(), done))
        self.thread = threading.Thread(target=self.loop.run, daemon=True)
        self.thread.start()

    def close(self):
        self.loop.stop()
        self.thread.join(5)
        assert not self.thread.is_alive()
        self.lsock.close()


def _exchange(addr, fragments) -> bytes:
    """Send ``fragments`` one by one (TCP_NODELAY, a pause between them);
    everything the server sends back until it hangs up (a server that
    hangs up early, on a bad magic, ends the sending)."""
    c = socket.create_connection(addr, timeout=10)
    c.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
    out = b""
    try:
        for frag in fragments:
            c.sendall(frag)
            time.sleep(0.002)
        while True:
            chunk = c.recv(65536)
            if not chunk:
                return out
            out += chunk
    except (BrokenPipeError, ConnectionResetError):
        return out
    finally:
        c.close()


def _cuts(data, rng):
    k = int(rng.integers(1, min(8, len(data)) + 1))
    points = sorted(set(rng.integers(1, len(data), size=k - 1).tolist()))
    edges = [0] + points + [len(data)]
    return [data[a:b] for a, b in zip(edges, edges[1:])]


def test_both_loops_parse_fragmented_requests_alike():
    rng = np.random.default_rng(20)
    plans = [_cuts(r, rng) for r in REQUESTS]
    # every byte boundary of one registration
    reg = REQUESTS[0]
    plans += [[reg[:k], reg[k:]] for k in range(1, len(reg))]
    got = {}
    for tag, mod, parse in (("port", evloop, port_tracker._parse_command),
                            ("jax", jax_evloop, jax_tracker._parse_command)):
        srv = _Server(mod, parse)
        try:
            got[tag] = ([_exchange(srv.addr, p) for p in plans],
                        list(srv.parsed))
        finally:
            srv.close()
    assert got["port"] == got["jax"]
    replies, parsed = got["port"]
    assert parsed[:len(REQUESTS) - 1] == [
        _drive(port_tracker._parse_command(), r) for r in REQUESTS[:-1]]
    assert parsed[-1] == parsed[-2] and len(parsed) == len(plans)
    assert replies[0] == _u32(len(repr(parsed[0]))) + repr(
        parsed[0]).encode()


def test_the_loop_holds_200_half_written_connections_with_no_thread(capsys):
    evloop._smoke()
    assert "evloop smoke ok" in capsys.readouterr().out


def test_max_conns_sheds_at_the_door():
    srv = _Server(evloop, port_tracker._parse_command, max_conns=2)
    socks = []
    try:
        for _ in range(4):
            socks.append(socket.create_connection(srv.addr, timeout=5))
        deadline = time.monotonic() + 5
        while srv.loop.shed_conns_total < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert srv.loop.shed_conns_total == 2
        assert srv.loop.open_conns == 2 and srv.loop.accepted_total == 2
        # the shed ones read EOF; the held ones are still served
        for c in socks[2:]:
            assert c.recv(16) == b""
        socks[0].sendall(REQUESTS[11])
        body = socks[0].recv(4096)
        assert body.endswith(repr(("world", "t0", ())).encode())
    finally:
        for c in socks:
            c.close()
        srv.close()


def _bare_loop():
    """A port loop with a listener whose accepts the test scripts."""
    loop = evloop.EventLoop(max_conns=0)
    lsock = socket.socket()
    lsock.bind(("127.0.0.1", 0))
    lsock.listen(16)
    accepted = []
    loop.add_listener(lsock, accepted.append)
    th = threading.Thread(target=loop.run, daemon=True)
    th.start()
    return loop, lsock, accepted, th


def _wait(cond, timeout=5.0):
    deadline = time.monotonic() + timeout
    while not cond():
        assert time.monotonic() < deadline, "timed out"
        time.sleep(0.005)


def test_expect_times_out_into_on_fail():
    loop, lsock, accepted, th = _bare_loop()
    got, failed = [], []
    c = socket.create_connection(lsock.getsockname(), timeout=5)
    try:
        _wait(lambda: accepted)
        t0 = time.monotonic()
        loop.expect(accepted[0], 4, lambda conn, data: got.append(data),
                    timeout=0.2,
                    on_fail=lambda conn, e: failed.append(
                        (time.monotonic() - t0, type(e).__name__)))
        _wait(lambda: failed)
        assert got == [] and failed[0][1] == "TimeoutError"
        assert 0.15 <= failed[0][0] < 3.0
        # the connection is left for the callback to close
        assert not accepted[0].closed
        c.sendall(b"\x01\x00\x00\x00")
        loop.expect(accepted[0], 4, lambda conn, data: got.append(data))
        _wait(lambda: got)
        assert got == [b"\x01\x00\x00\x00"]
    finally:
        c.close()
        loop.stop()
        th.join(5)
        lsock.close()


def test_call_later_fires_in_deadline_order():
    loop, lsock, _accepted, th = _bare_loop()
    order = []
    try:
        for delay, tag in ((0.15, "c"), (0.05, "a"), (0.1, "b")):
            loop.call_later(delay, lambda tag=tag: order.append(tag))
        loop.call(lambda: order.append("now"))
        cancelled = loop.call_later(0.02, lambda: order.append("never"))
        loop.call(lambda: setattr(cancelled, "cancelled", True))
        _wait(lambda: len(order) == 4)
        time.sleep(0.05)
        assert order == ["now", "a", "b", "c"]
    finally:
        loop.stop()
        th.join(5)
        lsock.close()


def test_detach_returns_the_buffered_bytes():
    loop, lsock, accepted, th = _bare_loop()
    taken = []

    def four():
        return (yield 4)

    c = socket.create_connection(lsock.getsockname(), timeout=5)
    try:
        c.sendall(b"HEADrest-of-it")
        _wait(lambda: accepted)
        time.sleep(0.05)   # both writes in the loop's buffer
        loop.call(lambda: loop.start_parse(
            accepted[0], four(),
            lambda conn, v: taken.append((v, *loop.detach(conn)))))
        _wait(lambda: taken)
        value, raw, left = taken[0]
        assert value == b"HEAD" and left == b"rest-of-it"
        assert loop.open_conns == 0 and raw.getblocking()
        raw.sendall(b"streamed")   # the socket is the caller's now
        assert c.recv(64) == b"streamed"
        raw.close()
    finally:
        c.close()
        loop.stop()
        th.join(5)
        lsock.close()


def test_close_after_drains_before_it_closes():
    loop, lsock, accepted, th = _bare_loop()
    payload = np.random.default_rng(3).bytes(8 << 20)
    c = socket.create_connection(lsock.getsockname(), timeout=10)
    try:
        _wait(lambda: accepted)
        loop.send(accepted[0], payload, close_after=True)
        time.sleep(0.2)    # the socket buffers fill; the rest waits
        assert loop.open_conns == 1
        got = bytearray()
        while True:
            chunk = c.recv(1 << 20)
            if not chunk:
                break
            got += chunk
        assert bytes(got) == payload
        _wait(lambda: loop.open_conns == 0)
    finally:
        c.close()
        loop.stop()
        th.join(5)
        lsock.close()


# ------------------------------------------------------------------ the pool


def test_pool_keeps_fifo_within_a_key_and_survives_a_raise():
    pool = evloop.ServicePool(nthreads=1, name="t-fifo").start()
    seen = []
    try:
        pool.submit("a", lambda: 1 / 0)
        for i in range(100):
            pool.submit("a", lambda i=i: seen.append(i))
        _wait(lambda: len(seen) == 100)
        assert seen == list(range(100)) and pool.depth() == 0
    finally:
        pool.stop()


def test_a_storm_on_one_key_does_not_starve_another():
    pool = evloop.ServicePool(nthreads=1, name="t-storm").start()
    gate = threading.Event()
    order = []
    try:
        pool.submit("storm", gate.wait)
        for i in range(1000):
            pool.submit("storm", lambda i=i: order.append(("storm", i)))
        pool.submit("other", lambda: order.append(("other", 0)))
        _wait(lambda: pool.depth() == 1001)   # the gate holds the thread
        gate.set()
        _wait(lambda: len(order) == 1001)
        # the other key waits for one storm task at most, not a thousand
        assert order.index(("other", 0)) <= 1
        assert [x for x in order if x[0] == "storm"] == [
            ("storm", i) for i in range(1000)]
    finally:
        gate.set()
        pool.stop()


def test_knobs_read_the_environment(monkeypatch):
    assert evloop.loop_max_conns() == 0 and evloop.service_threads() == 4
    monkeypatch.setenv("RABIT_LOOP_MAX_CONNS", "7")
    monkeypatch.setenv("RABIT_LOOP_SERVICE_THREADS", "2")
    assert evloop.loop_max_conns() == 7 and evloop.service_threads() == 2
    assert evloop.EventLoop().max_conns == 7
    monkeypatch.setenv("RABIT_LOOP_SERVICE_THREADS", "x")
    assert evloop.service_threads() == 4
    for name in ("LOOP_MAX_CONNS_ENV", "SERVICE_THREADS_ENV",
                 "SERVICE_THREADS_DEFAULT"):
        assert getattr(evloop, name) == getattr(jax_evloop, name)
