"""The tracker's connection-plane bench: the port's copy of
``tools/tracker_bench.py``. How many IDLE worker connections one port
tracker holds, and what registration throughput and command latency look
like while it holds them.

The tracker's event loop (``tracker/evloop.py``) claims that an idle
connection costs a file descriptor and a buffer, not a thread. This tool
measures that claim: it climbs a ladder of idle connections held open
(a 0 rung, then ``LEVELS_DEFAULT``, 1000 / 5000 / 10000) against a
tracker in this process and, at each rung, reads

- ``regs_per_s``: whole world formations through the registration wire
  protocol (register, read the assignment, ack ready), workers a second;
- ``cmd_p50_ms`` / ``cmd_p99_ms``: the round trip of the ``world``
  command, connect included, sampled one after another;
- ``threads``: ``threading.active_count()`` of this process, which must
  not grow with the rung (``bounded_threads``: the top rung at most
  ``THREAD_SLACK`` above the 0 rung);
- ``fds``: this process's open descriptors;
- ``open_conns`` and ``loop_lag_ms``: the loop's own gauges.

Idle connections are held by CHILD processes (``--hold``), one a rung's
increment, so that this process spends its ``RLIMIT_NOFILE`` on its own
end of each connection only, as with remote workers. The limit is raised
to its hard value first (``raise_nofile``); a rung that would not fit in
it, with ``FD_HEADROOM`` descriptors to spare, is cut, and the document
says which and why (``cut``). Needs no card and no JAX.

It writes a ``rabit_tpu.tracker_bench/v1`` document (``tools/trace_report``
renders it), with ``--out`` into a file, and appends each rung's series to
the port's history (``telemetry/history.py``:
``build/artifacts/history.jsonl``, never ``benchmarks/``).

    python -m rabit_tpu_torch.tools.tracker_bench --out TRACKER_BENCH.json
    python -m rabit_tpu_torch.tools.tracker_bench --smoke   # a tiny ladder

``--smoke`` climbs 50 and 150 connections, checks the document's shape
and ``bounded_threads``, and writes nothing but its ``--out``.
"""

import argparse
import json
import os
import resource
import socket
import struct
import subprocess
import sys
import threading
import time

BENCH_KIND = "tracker_bench"
LEVELS_DEFAULT = (1000, 5000, 10000)
SMOKE_LEVELS = (50, 150)
# the boundedness bar: from the 0 rung to the top rung the tracker may
# start at most this many more threads (a fixed helper started late),
# never one a connection
THREAD_SLACK = 4
# descriptors a rung leaves for everything but its held connections
FD_HEADROOM = 256


def _fd_count() -> int:
    try:
        return len(os.listdir("/proc/self/fd"))
    except OSError:   # no procfs: probe each descriptor under the limit
        n = 0
        for fd in range(resource.getrlimit(resource.RLIMIT_NOFILE)[0]):
            try:
                os.fstat(fd)
                n += 1
            except OSError:
                pass
        return n


def raise_nofile() -> int:
    """Raise this process's ``RLIMIT_NOFILE`` to its hard limit; the soft
    limit it has then."""
    soft, hard = resource.getrlimit(resource.RLIMIT_NOFILE)
    if soft < hard:
        try:
            resource.setrlimit(resource.RLIMIT_NOFILE, (hard, hard))
            soft = hard
        except (ValueError, OSError):
            pass
    return soft


def plan_levels(levels, nofile: int):
    """The rungs that fit in ``nofile`` descriptors with ``FD_HEADROOM``
    to spare, and each cut rung with why."""
    kept, cut = [], []
    for n in sorted(levels):
        if n + FD_HEADROOM > nofile:
            cut.append({"idle_conns": n,
                        "why": f"RLIMIT_NOFILE {nofile} < {n} + "
                               f"{FD_HEADROOM} headroom"})
        else:
            kept.append(n)
    return kept, cut


# ------------------------------------------------------------ measurement


def _recv_all(s: socket.socket, n: int) -> bytes:
    out = b""
    while len(out) < n:
        chunk = s.recv(n - len(out))
        if not chunk:
            raise ConnectionError("the tracker closed mid-reply")
        out += chunk
    return out


def world_rtt_ms(host: str, port: int) -> float:
    """One ``world`` command's round trip, connect included: a worker's
    view of the control plane's latency."""
    from ..tracker.tracker import MAGIC
    t0 = time.perf_counter()
    c = socket.create_connection((host, port), timeout=30)
    try:
        c.sendall(struct.pack("<I", MAGIC))
        for txt in ("world", "bench"):
            b = txt.encode()
            c.sendall(struct.pack("<I", len(b)) + b)
        c.sendall(struct.pack("<I", 0))
        (n,) = struct.unpack("<I", _recv_all(c, 4))
        _recv_all(c, n)
    finally:
        c.close()
    return (time.perf_counter() - t0) * 1e3


def _reg_waves(tr, waves: int) -> float:
    """``waves`` whole world formations through the registration wire
    protocol; registrations a second."""
    from ..tracker import jobs as jobs_mod
    t0 = time.perf_counter()
    for _ in range(waves):
        conns = [jobs_mod.wire_register(tr.host, tr.port, str(i))
                 for i in range(tr.nworkers)]
        for c in conns:
            jobs_mod.wire_read_assignment(c)   # acks ready and closes
    dt = time.perf_counter() - t0
    return (waves * tr.nworkers) / dt if dt > 0 else 0.0


def percentile(xs, q: float) -> float:
    """The ``q`` quantile of ``xs`` by nearest rank (0.0 when empty)."""
    s = sorted(xs)
    if not s:
        return 0.0
    return s[min(len(s) - 1, max(0, int(round(q * (len(s) - 1)))))]


def _measure(tr, waves: int, samples: int) -> dict:
    regs = _reg_waves(tr, waves)
    rtts = [world_rtt_ms(tr.host, tr.port) for _ in range(samples)]
    return {
        "regs_per_s": round(regs, 1),
        "cmd_p50_ms": round(percentile(rtts, 0.50), 3),
        "cmd_p99_ms": round(percentile(rtts, 0.99), 3),
        "threads": threading.active_count(),
        "fds": _fd_count(),
        "open_conns": tr._loop.open_conns,
        "loop_lag_ms": round(tr._loop.lag_ms(), 4),
    }


# ---------------------------------------------------------------- holders


def _hold_main(host: str, port: int, n: int, prefix: bytes) -> int:
    """The child: open ``n`` connections, send each ``prefix`` (none: an
    idle connection; a request's first bytes: a half-open client), say
    ``held <k>``, then hold them until the parent closes our stdin. The
    connects are paced so that the listener's backlog never overflows
    into retries."""
    raise_nofile()
    socks = []
    deadline = time.monotonic() + 120
    while len(socks) < n:
        try:
            c = socket.create_connection((host, port), timeout=30)
            if prefix:
                c.sendall(prefix)
            socks.append(c)
        except OSError:
            if time.monotonic() > deadline:
                print(f"held {len(socks)}", flush=True)
                return 1
            time.sleep(0.05)
            continue
        if len(socks) % 200 == 0:
            time.sleep(0.02)
    print(f"held {len(socks)}", flush=True)
    sys.stdin.read()   # the parent hangs up: release
    for s in socks:
        try:
            s.close()
        except OSError:
            pass
    return 0


def half_open_prefix() -> bytes:
    """A half-open client's bytes: the magic and part of a command (the
    ``world`` command's length and its first three letters), then
    nothing."""
    from ..tracker.tracker import MAGIC
    return struct.pack("<II", MAGIC, 5) + b"wor"


class Holder:
    """A child process holding ``n`` connections open against
    ``host:port`` (``prefix``: the bytes each sends first)."""

    def __init__(self, host: str, port: int, n: int, prefix: bytes = b""):
        self.n = n
        self.proc = subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--hold", host,
             str(port), str(n), prefix.hex()],
            stdin=subprocess.PIPE, stdout=subprocess.PIPE, text=True)
        line = self.proc.stdout.readline().strip()
        self.held = int(line.split()[1]) if line.startswith("held") else 0

    def release(self) -> None:
        try:
            self.proc.stdin.close()
        except OSError:
            pass
        try:
            self.proc.wait(timeout=30)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


# -------------------------------------------------------------------- run


def run_bench(levels, nworkers: int, waves: int, samples: int,
              quiet: bool = False) -> dict:
    """Climb the idle-connection ladder as far as ``RLIMIT_NOFILE``
    allows; the ``rabit_tpu.tracker_bench/v1`` document."""
    from ..telemetry.schema import make_header
    from ..tracker.tracker import Tracker
    nofile = raise_nofile()
    kept, cut = plan_levels(levels, nofile)
    tr = Tracker(nworkers).start()
    holders = []
    try:
        doc = make_header(BENCH_KIND)
        doc.update(nworkers=nworkers, waves=waves, cmd_samples=samples,
                   nofile=nofile, cut=cut,
                   baseline={"threads": threading.active_count(),
                             "fds": _fd_count()},
                   levels=[])
        if not quiet:
            print(f"[tracker_bench] RLIMIT_NOFILE {nofile}; rungs "
                  f"{[0] + kept}" + "".join(
                      f"; cut {c['idle_conns']}: {c['why']}" for c in cut),
                  file=sys.stderr, flush=True)
        held = 0
        for target in [0] + kept:
            if target > held:
                h = Holder(tr.host, tr.port, target - held)
                holders.append(h)
                held += h.held
                # let the loop drain its accept backlog
                deadline = time.monotonic() + 60
                while tr._loop.open_conns < held \
                        and time.monotonic() < deadline:
                    time.sleep(0.05)
            m = _measure(tr, waves, samples)
            m["idle_conns"] = held
            doc["levels"].append(m)
            if not quiet:
                print(f"[tracker_bench] {held} idle conns: "
                      f"{m['regs_per_s']:g} regs/s, p50 "
                      f"{m['cmd_p50_ms']:g} ms, p99 {m['cmd_p99_ms']:g} ms,"
                      f" {m['threads']} threads, {m['fds']} fds, "
                      f"open_conns {m['open_conns']}, loop lag "
                      f"{m['loop_lag_ms']:g} ms", file=sys.stderr,
                      flush=True)
        top = doc["levels"][-1]
        doc["max_idle_conns"] = top["idle_conns"]
        # the claim: the top rung's threads are the 0 rung's (measured
        # after the fixed pools started)
        doc["bounded_threads"] = (
            top["threads"] <= doc["levels"][0]["threads"] + THREAD_SLACK)
        return doc
    finally:
        for h in holders:
            h.release()
        tr.stop()


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    if argv[:1] == ["--hold"]:
        return _hold_main(argv[1], int(argv[2]), int(argv[3]),
                          bytes.fromhex(argv[4]) if len(argv) > 4 else b"")
    from ..telemetry import history
    from ..telemetry.schema import matches
    ap = argparse.ArgumentParser(
        description="The tracker's connection-plane bench: a ladder of "
                    "idle connections, with each rung's registrations a "
                    "second, command latency, threads and descriptors")
    ap.add_argument("--levels", default=None,
                    help="comma-separated idle-connection rungs "
                         "(default 1000,5000,10000)")
    ap.add_argument("--nworkers", type=int, default=2,
                    help="the world size of a registration wave")
    ap.add_argument("--waves", type=int, default=50,
                    help="world formations a rung")
    ap.add_argument("--samples", type=int, default=200,
                    help="command-latency samples a rung")
    ap.add_argument("--out", default=None,
                    help="write the tracker_bench/v1 document here")
    ap.add_argument("--history", default=history.history_path(),
                    help="the history JSONL the rungs are trended into")
    ap.add_argument("--no-history", action="store_true")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="a tiny ladder: checks the document's shape and "
                         "bounded_threads; no history")
    args = ap.parse_args(argv)

    levels = LEVELS_DEFAULT
    if args.levels:
        levels = tuple(int(x) for x in args.levels.split(",") if x)
    waves, samples = args.waves, args.samples
    if args.smoke:
        if args.levels is None:
            levels = SMOKE_LEVELS
        waves = min(waves, 10)
        samples = min(samples, 40)

    doc = run_bench(levels, args.nworkers, waves, samples, quiet=args.quiet)
    doc["smoke"] = bool(args.smoke)
    if args.smoke:
        if not matches(doc, BENCH_KIND) or \
                len(doc["levels"]) != len(levels) + 1 or doc["cut"]:
            raise SystemExit(f"tracker_bench smoke: {doc}")
        top = doc["levels"][-1]
        if top["idle_conns"] < max(levels) or \
                top["open_conns"] < max(levels) or \
                not doc["bounded_threads"] or \
                any(m["regs_per_s"] <= 0 or m["cmd_p99_ms"] <= 0
                    for m in doc["levels"]):
            raise SystemExit(f"tracker_bench smoke: {doc}")
        print("tracker_bench smoke ok", file=sys.stderr)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
    print(json.dumps(doc, sort_keys=True))
    if not args.smoke and not args.no_history:
        os.makedirs(os.path.dirname(os.path.abspath(args.history)),
                    exist_ok=True)
        added = history.append(args.history, history.records_from_artifact(
            doc, source=os.path.basename(args.out or "tracker_bench")))
        print(f"[tracker_bench] trended {added} records into "
              f"{args.history}", file=sys.stderr)
    return 0 if doc["bounded_threads"] else 1


if __name__ == "__main__":
    sys.exit(main())
