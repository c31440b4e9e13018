"""Local cluster launcher — the ``dmlc-submit --cluster local
--num-workers N --local-num-attempt M`` equivalent (reference
test/test.mk:13-37) and the port's copy of ``rabit_tpu/tracker/launch.py``'s
``launch``: starts the port's tracker, spawns N worker processes, and
respawns any worker that exits nonzero (up to ``max_attempts`` times per
worker, with the attempt counter exported so mock kill schedules
advance).

Usage:
    python -m rabit_tpu_torch.tracker.launch -n 4 [--max-attempts 20] \\
        [--timeout 300] [--metrics-port 0] [--elastic] \\
        prog arg1 key=value ...

``--metrics-port`` (else ``RABIT_METRICS_PORT`` in the environment)
turns on the tracker's live plane: its metrics endpoint, the poll loop
over the workers' announced endpoints and the skew election it serves.

``--elastic`` (else ``RABIT_ELASTIC`` in the environment, or
``rabit_elastic=1`` in the worker command) runs the tracker with elastic
membership (``tracker/membership.py``) and exports ``RABIT_ELASTIC=1``
to the workers. A worker that dies is then re-admitted, not respawned
against the budget: the tracker evicts the dead rank (the poll loop's
evidence or an ``evict`` command) so the survivors re-form at N-1, and
the relaunch rejoins toward the target world. The launch's timeout still
bounds a rank that keeps dying.

Each worker's native core listens for its links on an ephemeral port
(``RABIT_SLAVE_PORT=0``) unless the environment names one: the core's
default ports (9010 up, probed with ``SO_REUSEADDR``) can be bound twice
by workers that start together, and the second ``listen`` then fails.
The port's engines read the variable; the JAX package's do not.

With ``RABIT_TRACKER_WAL_DIR`` set the tracker journals its control
plane there, and the launcher supervises it as it does the workers: a
crash (``_TrackerSupervisor.kill``, scripted by a test through
``launch(tick=...)``) is followed, after the outage, by a ``resume=True``
tracker on the same host and port, which replays the journal and
re-adopts the live world; without a WAL a killed tracker stays dead.
``stats["tracker_restarts"]`` counts the respawns and
``stats["tracker_wal"]`` describes the journal.

Not ported yet: chaos proxies (and their ``tracker_kill``), the hot
standby (the supervisor's adoption of a promoted standby) and
``--submit`` to a multi-job tracker.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional

from . import membership as _membership
from . import wal as _wal_mod
from .tracker import Tracker


class _TrackerSupervisor:
    """Supervise the launcher's tracker the way the launcher supervises
    its workers (the cold half of the JAX launcher's supervisor): a crash
    is followed by a ``resume=True`` tracker on the SAME pinned host and
    port once the scheduled outage has passed, so the environment every
    worker was launched with stays valid and the replayed journal
    re-adopts the live world. Without a WAL a killed tracker stays dead:
    supervision never invents durability."""

    def __init__(self, tracker: Tracker, wal_dir: Optional[str],
                 factory: Callable[[str, int], Tracker],
                 quiet: bool = False):
        self.tracker = tracker
        self.wal_dir = wal_dir
        self._factory = factory     # (host, port) -> resumed Tracker
        self.quiet = quiet
        self.restarts = 0
        # crashed incarnations: kept, with the stores they host, until the
        # launch ends (a kill that exits the process would take them along)
        self.crashed: List[Tracker] = []
        self.killed_at: List[float] = []    # wall clock of each kill
        self.resumed_at: List[float] = []   # and of each resume
        self._lock = threading.Lock()
        self._respawn_at: Optional[float] = None

    def kill(self, delay_ms: float = 0.0) -> None:
        """Crash the live tracker now and, with a WAL, schedule its
        ``resume=True`` successor ``delay_ms`` later (the outage the
        world must ride out)."""
        with self._lock:
            if self.tracker.crashed:
                return
            self.tracker.crash()
            self.crashed.append(self.tracker)
            self.killed_at.append(time.time())
            if not self.quiet:
                print(f"[launch] tracker killed (outage "
                      f"{delay_ms / 1e3:.1f}s"
                      + (", will resume from WAL)" if self.wal_dir
                         else ", no WAL: stays dead)"),
                      file=sys.stderr, flush=True)
            if self.wal_dir is not None:
                self._respawn_at = time.monotonic() + delay_ms / 1e3

    def poll(self) -> None:
        """The supervision loop's turn: resume the tracker once its
        outage has passed."""
        with self._lock:
            if self._respawn_at is None or \
                    time.monotonic() < self._respawn_at:
                return
            self._respawn_at = None
            host, port = self.tracker.host, self.tracker.port
        # the dead incarnation's listener can linger a moment after the
        # crash; the pinned port must win before the workers notice
        deadline = time.monotonic() + 10
        while True:
            try:
                fresh = self._factory(host, port)
                break
            except OSError:
                if time.monotonic() >= deadline:
                    raise
                time.sleep(0.05)
        fresh.start()
        with self._lock:
            self.tracker = fresh
            self.restarts += 1
            self.resumed_at.append(time.time())
        if not self.quiet:
            print(f"[launch] tracker resumed on {host}:{port} "
                  f"(restart {self.restarts})", file=sys.stderr, flush=True)


def launch(nworkers: int, cmd: List[str], max_attempts: int = 20,
           timeout: float = 300.0, quiet: bool = False,
           stats: Optional[Dict] = None,
           env: Optional[Dict[str, str]] = None,
           metrics_port: Optional[int] = None,
           elastic: Optional[bool] = None,
           tick: Optional[Callable[[_TrackerSupervisor], None]] = None
           ) -> int:
    """Run ``cmd`` as ``nworkers`` local processes under a tracker.
    Returns 0 on success; raises when a worker exhausts its budget or the
    run outlasts ``timeout`` seconds. A worker exiting nonzero is
    respawned with an incremented attempt counter (``RABIT_NUM_TRIAL``)
    until it has failed ``max_attempts`` times. ``env`` is added to each
    worker's environment. ``stats``, when given, receives the attempts
    by rank (every relaunch, re-admissions included) and their total, the
    re-admissions, the last epoch, the stores still hosted, the tracker's
    messages (the fleet table among them), its membership doc and the
    merged telemetry document (``fleet``, None when no worker shipped a
    summary). The tracker hosts an epoch's rendezvous store when the
    workers' registrations ask for one (they do under
    ``rabit_dataplane=torch``). ``metrics_port`` starts the tracker's
    live plane (None: ``RABIT_METRICS_PORT``, else off); its state at the
    end lands in ``stats["live"]``. ``elastic`` (None: ``RABIT_ELASTIC``
    or ``rabit_elastic=1`` in ``cmd``) turns on elastic membership: a
    dead worker's relaunch is a re-admission, exempt from
    ``max_attempts``. ``RABIT_TRACKER_WAL_DIR`` journals the tracker's
    control plane, and a killed tracker is then resumed in place:
    ``tick``, when given, is called with the tracker's supervisor once a
    pass of the supervision loop (a test scripts ``kill`` with it);
    ``stats`` gets ``tracker_restarts`` and ``tracker_wal`` (the
    directory, the live incarnation's records and restarts, what its
    resume replayed and in how many ms, the seconds each incarnation
    spent journaling, and the wall clocks of each kill and resume)."""
    if elastic is None:
        elastic = (_membership.elastic_enabled()
                   or any(a == "rabit_elastic=1" for a in cmd))
    wal_dir = os.environ.get(_wal_mod.WAL_DIR_ENV) or None
    tracker = Tracker(nworkers, metrics_port=metrics_port, elastic=elastic,
                      wal_dir=wal_dir).start()

    def _resumed_tracker(host: str, port: int) -> Tracker:
        return Tracker(nworkers, host=host, port=port,
                       metrics_port=metrics_port, elastic=elastic,
                       wal_dir=wal_dir, resume=True)

    sup = _TrackerSupervisor(tracker, wal_dir, _resumed_tracker, quiet=quiet)
    procs: Dict[int, subprocess.Popen] = {}
    # every relaunch of worker i, exported as RABIT_NUM_TRIAL so mock kill
    # schedules advance; with elastic membership a relaunch is a
    # re-admission, the mechanism working, and spends no budget
    attempts: Dict[int, int] = {i: 0 for i in range(nworkers)}
    readmissions = 0
    finished: Dict[int, bool] = {i: False for i in range(nworkers)}

    def spawn(i: int) -> None:
        worker_env = dict(os.environ)
        worker_env.update(env or {})
        # the live incarnation's: a resumed tracker keeps the address
        worker_env.update(sup.tracker.env(task_id=str(i),
                                          num_attempt=attempts[i]))
        # an ephemeral link listener unless the caller names a port: the
        # native core probes its default ports (9010 up) with SO_REUSEADDR,
        # and workers started together can bind one port twice, so that
        # the second listen fails and the worker dies at init
        worker_env.setdefault("RABIT_SLAVE_PORT", "0")
        if elastic:
            worker_env["RABIT_ELASTIC"] = "1"
        procs[i] = subprocess.Popen(cmd, env=worker_env)

    try:
        for i in range(nworkers):
            spawn(i)
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if tick is not None:
                tick(sup)
            # the tracker is supervised like the workers below
            sup.poll()
            for i in range(nworkers):
                if finished[i]:
                    continue
                rc = procs[i].poll()
                if rc is None:
                    continue
                if rc == 0:
                    finished[i] = True
                    continue
                attempts[i] += 1
                if elastic:
                    readmissions += 1
                elif attempts[i] > max_attempts:
                    raise RuntimeError(
                        f"worker {i} failed rc={rc} after {max_attempts} "
                        f"attempts (per-rank budget)")
                if not quiet:
                    # the wall clock of the death: recovery is timed from it
                    verb = "re-admit" if elastic else "respawn"
                    print(f"[launch] worker {i} died rc={rc} at "
                          f"{time.time():.3f}; {verb} attempt "
                          f"{attempts[i]}", file=sys.stderr, flush=True)
                spawn(i)
            if all(finished.values()):
                # engines that never register (TorchEngine) send no
                # shutdown: the run's end is the workers' exit
                sup.tracker.print_fleet_metrics()
                return 0
            time.sleep(0.05)
        raise RuntimeError(
            f"timeout: finished={sum(finished.values())}/{nworkers} after "
            f"{timeout:.0f} s")
    finally:
        # a resume replaced the tracker: every read below, and the
        # teardown, go to the live incarnation (and the dead ones)
        tracker = sup.tracker
        incarnations = [t for t in sup.crashed if t is not tracker] + \
            [tracker]
        if stats is not None:
            stats["attempts_by_rank"] = dict(attempts)
            stats["total_attempts"] = sum(attempts.values())
            stats["readmissions"] = readmissions
            stats["membership"] = tracker.membership_doc()
            stats["epoch"] = tracker.epoch
            stats["stores_retained"] = tracker.store_count()
            stats["messages"] = list(tracker.messages)
            # the merged telemetry summaries the workers shipped, if any
            stats["fleet"] = tracker.merged_metrics()
            stats["live"] = tracker.live_stats()
            stats["tracker_restarts"] = sup.restarts
            stats["tracker_wal"] = {
                "dir": wal_dir, "records": tracker.wal_records(),
                "restarts": tracker.restarts,
                "replayed": tracker.replayed,
                "replay_ms": tracker.replay_ms,
                # by incarnation: the first one's is the formation's
                "journal_s": [t.journal_s for t in incarnations],
                "killed_at": list(sup.killed_at),
                "resumed_at": list(sup.resumed_at)}
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        for t in incarnations:
            t.stop()


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("-n", "--num-workers", type=int, required=True)
    ap.add_argument("--max-attempts", type=int, default=20)
    ap.add_argument("--timeout", type=float, default=300.0)
    ap.add_argument("--metrics-port", type=int, default=None,
                    help="the tracker's live metrics port (0: a free one)")
    ap.add_argument("--elastic", action="store_true", default=None,
                    help="elastic membership: evict dead ranks, re-admit "
                         "their relaunches (default: RABIT_ELASTIC)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.cmd and args.cmd[0] == "--":
        args.cmd = args.cmd[1:]
    if not args.cmd:
        ap.error("missing worker command")
    return launch(args.num_workers, args.cmd, args.max_attempts,
                  args.timeout, metrics_port=args.metrics_port,
                  elastic=args.elastic)


if __name__ == "__main__":
    sys.exit(main())
