"""``python -m rabit_tpu_torch.chaos --smoke``: the port's copy of
``python -m rabit_tpu.chaos --smoke``, with the same five rounds, seeds,
rules and assertions.

1. ``reset``: an echo server behind a chaos proxy; exactly one
   mid-transfer connection reset, recovered through the retry helper,
   the replayed payload checked byte for byte.
2. ``tracker_kill``: a targeted rule fires the proxy's kill hook exactly
   once (the supervisor's kill-and-respawn path), then the retried
   connection echoes clean through the "respawned" upstream.
3. ``tracker_partition``: tracker-bound bytes stall inside the window
   (neither delivered nor refused), then flow; the rule is scoped to
   tracker proxies, so a link schedule never runs it.
4. ``bitflip``: one chunk is corrupted mid-stream; the client detects the
   mangled echo and the retry lands clean (the application-level analog
   of the frame CRC's reject and retransmit).
5. ``job_storm``: a seeded burst of rogue submits and half-open starts
   against a real multi-job tracker, whose admission answers every rogue
   at once (queued, shed or error, never ok), while a live job's world
   registers through the storm.

Proxy, schedule, retry and tracker together in a few seconds, with no
torch, no native build and no JAX.
"""

from __future__ import annotations

import argparse
import os
import socket
import sys
import threading
import time

from .proxy import ChaosProxy
from .schedule import Rule, Schedule
from ..utils import retry

PAYLOAD = bytes(range(256)) * 64  # 16 KiB, content-checkable


def _echo_server() -> socket.socket:
    srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    srv.settimeout(10.0)

    def serve():
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            try:
                while True:
                    data = conn.recv(65536)
                    if not data:
                        break
                    conn.sendall(data)
            except OSError:
                pass
            finally:
                conn.close()

    threading.Thread(target=serve, daemon=True).start()
    return srv


def _echo(proxy: ChaosProxy) -> bytes:
    """Send the payload through ``proxy``, half-close, read the echo until
    EOF."""
    conn = retry.connect_with_retry(proxy.host, proxy.port, timeout=5.0)
    with conn:
        conn.sendall(PAYLOAD)
        conn.shutdown(socket.SHUT_WR)
        out = b""
        while True:
            chunk = conn.recv(65536)
            if not chunk:
                return out
            out += chunk


def _count(proxy: ChaosProxy, kind: str) -> int:
    return sum(1 for e in proxy.events if e[1] == kind)


def _reset_and_kill(host: str, port: int) -> None:
    """Rounds 1 and 2, over one proxy."""
    # exactly one reset, injected mid-transfer on the first connection
    sched = Schedule([Rule("reset", after_bytes=4096, max_times=1)], seed=7)
    with ChaosProxy(host, port, sched, name="chaos-smoke") as proxy:

        def round_trip() -> bytes:
            out = _echo(proxy)
            if out != PAYLOAD:
                raise ConnectionError(
                    f"torn echo: {len(out)}/{len(PAYLOAD)} bytes")
            return out

        # the first attempt hits the scripted reset; the retry recovers
        retry.retry_call(round_trip, attempts=4, base_s=0.05,
                         desc="chaos echo round-trip")
        assert _count(proxy, "reset") == 1, \
            f"expected 1 injected reset: {proxy.events}"
        assert proxy.accepted >= 2, "retry never reconnected"

        # tracker_kill fires the kill hook on the targeted connection
        # (once: max_times defaults to 1), the triggering client sees an
        # RST, and the retry lands on the still-running upstream as it
        # would on a resumed tracker
        kills = []
        proxy.kill_hook = lambda delay_ms: kills.append(delay_ms)
        proxy.schedule.rules.append(
            Rule("tracker_kill", conn=proxy.accepted, delay_ms=250))
        retry.retry_call(round_trip, attempts=4, base_s=0.05,
                         desc="chaos tracker-kill round-trip")
        assert _count(proxy, "tracker_kill") == 1, \
            f"expected 1 tracker_kill event: {proxy.events}"
        assert kills == [250.0], f"kill hook saw {kills}"


def _partition(host: str, port: int) -> None:
    """Round 3: the stream stalls for the window, then flows whole."""
    part_sched = Schedule([Rule("tracker_partition",
                                window_s=(0.0, 0.4), max_times=1)], seed=7)
    assert part_sched.for_target("link").rules == [], \
        "tracker_partition leaked onto link proxies"
    assert len(part_sched.for_target("tracker").rules) == 1
    with ChaosProxy(host, port, part_sched.for_target("tracker"),
                    name="chaos-smoke-part") as proxy:
        t0 = time.monotonic()
        out = _echo(proxy)
        took = time.monotonic() - t0
        assert out == PAYLOAD, f"torn echo: {len(out)}/{len(PAYLOAD)}"
        assert _count(proxy, "tracker_partition") == 1, \
            f"expected 1 tracker_partition event: {proxy.events}"
        assert took >= 0.35, \
            f"partition window never stalled the stream ({took:.2f}s)"


def _bitflip(host: str, port: int) -> None:
    """Round 4: one corrupted chunk, detected and retried."""
    flip_sched = Schedule([Rule("bitflip", after_bytes=4096, max_times=1)],
                          seed=11)
    with ChaosProxy(host, port, flip_sched, name="chaos-smoke-flip") as proxy:

        def flip_trip() -> bytes:
            out = _echo(proxy)
            if out != PAYLOAD:
                raise ConnectionError(
                    f"corrupt echo ({len(out)} bytes, "
                    f"{sum(a != b for a, b in zip(out, PAYLOAD))} "
                    f"byte(s) wrong)")
            return out

        retry.retry_call(flip_trip, attempts=4, base_s=0.05,
                         desc="chaos bitflip round-trip")
        assert _count(proxy, "bitflip") == 1, \
            f"expected 1 bitflip event: {proxy.events}"
        assert proxy.accepted >= 2, "corruption was never detected/retried"


def _job_storm() -> None:
    """Round 5: a storm against a real multi-job tracker while a live job
    forms its world."""
    from ..tracker import jobs as tjobs
    from ..tracker.tracker import Tracker

    tr = Tracker(2).start()
    try:
        assert tjobs.submit(tr.host, tr.port, "live", 2)["ok"] == 1
        storm_sched = Schedule([Rule("job_storm", window_s=(0.0, 5.0),
                                     burst=6)], seed=23)
        assert storm_sched.for_target("link").rules == [], \
            "job_storm leaked onto link proxies"
        with ChaosProxy(tr.host, tr.port, storm_sched,
                        name="chaos-smoke-storm") as sproxy:
            # the live job keeps working THROUGH the storm: both workers
            # register and the world forms at epoch 1
            conns = [tjobs.wire_register(tr.host, tr.port, f"live/{i}")
                     for i in range(2)]
            got = sorted(tjobs.wire_read_assignment(c) for c in conns)
            assert got == [(0, 2, 1), (1, 2, 1)], got
            deadline = time.monotonic() + 10.0
            while not sproxy.storm_results and time.monotonic() < deadline:
                time.sleep(0.02)
            assert sproxy.storm_results, "storm thread never fired"
            tally = sproxy.storm_results[0]
            assert _count(sproxy, "job_storm") == 1, \
                f"expected 1 job_storm event: {sproxy.events}"
            assert tally["submits"] >= 1 and tally["half_open"] >= 1, tally
            assert all(not v.get("ok") for v in tally["verdicts"]), \
                f"a rogue submit was admitted: {tally['verdicts']}"
            assert any(v.get("queued") or v.get("shed")
                       for v in tally["verdicts"]), \
                f"admission never queued/shed: {tally['verdicts']}"
        # the tracker survived the storm with the live job intact: its
        # resubmit is an idempotent ok and nothing leaked into its
        # quarantine
        v = tjobs.submit(tr.host, tr.port, "live", 2)
        assert v.get("already") == 1, v
        live = tr.job("live")
        assert live.status == "live" and live.quarantined == 0
        for i in range(2):
            tjobs.wire_shutdown(tr.host, tr.port, f"live/{i}")
    finally:
        tr.stop()


STORM_ENV = {"RABIT_MULTI_JOB": "1", "RABIT_MAX_JOBS": "1",
             "RABIT_ADMISSION_QUEUE": "1"}


def smoke() -> int:
    srv = _echo_server()
    host, port = srv.getsockname()
    try:
        _reset_and_kill(host, port)
        _partition(host, port)
        _bitflip(host, port)
    finally:
        srv.close()
    env_save = {k: os.environ.get(k) for k in STORM_ENV}
    os.environ.update(STORM_ENV)
    try:
        _job_storm()
    finally:
        for k, v in env_save.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    print("chaos smoke ok (1 reset + 1 tracker_kill + 1 tracker_partition "
          "+ 1 bitflip + 1 job_storm injected, retry recovered, payload "
          "intact, admission shed the storm)")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rabit_tpu_torch.chaos", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="run the five fault rounds and exit")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke()
    ap.error("nothing to do (pass --smoke)")
    return 2


if __name__ == "__main__":
    sys.exit(main())
