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

Not ported yet: chaos proxies, the tracker's write-ahead log and its
supervision, the hot standby and ``--submit`` to a multi-job tracker.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from . import membership as _membership
from .tracker import Tracker


def launch(nworkers: int, cmd: List[str], max_attempts: int = 20,
           timeout: float = 300.0, quiet: bool = False,
           stats: Optional[Dict] = None,
           env: Optional[Dict[str, str]] = None,
           metrics_port: Optional[int] = None,
           elastic: Optional[bool] = None) -> int:
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
    ``max_attempts``."""
    if elastic is None:
        elastic = (_membership.elastic_enabled()
                   or any(a == "rabit_elastic=1" for a in cmd))
    tracker = Tracker(nworkers, metrics_port=metrics_port,
                      elastic=elastic).start()
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
        worker_env.update(tracker.env(task_id=str(i),
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
                tracker.print_fleet_metrics()
                return 0
            time.sleep(0.05)
        raise RuntimeError(
            f"timeout: finished={sum(finished.values())}/{nworkers} after "
            f"{timeout:.0f} s")
    finally:
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
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        tracker.stop()


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
