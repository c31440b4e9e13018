"""Local cluster launcher — the ``dmlc-submit --cluster local
--num-workers N --local-num-attempt M`` equivalent (reference
test/test.mk:13-37) and the port's copy of ``rabit_tpu/tracker/launch.py``'s
``launch``: starts the port's tracker, spawns N worker processes, and
respawns any worker that exits nonzero (up to ``max_attempts`` times per
worker, with the attempt counter exported so mock kill schedules
advance).

Usage:
    python -m rabit_tpu_torch.tracker.launch -n 4 [--max-attempts 20] \\
        [--timeout 300] prog arg1 key=value ...

Not ported yet: chaos proxies, the tracker's write-ahead log and its
supervision, the hot standby, elastic re-admission and ``--submit`` to a
multi-job tracker.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time
from typing import Dict, List, Optional

from .tracker import Tracker


def launch(nworkers: int, cmd: List[str], max_attempts: int = 20,
           timeout: float = 300.0, quiet: bool = False,
           stats: Optional[Dict] = None,
           env: Optional[Dict[str, str]] = None) -> int:
    """Run ``cmd`` as ``nworkers`` local processes under a tracker.
    Returns 0 on success; raises when a worker exhausts its budget or the
    run outlasts ``timeout`` seconds. A worker exiting nonzero is
    respawned with an incremented attempt counter (``RABIT_NUM_TRIAL``)
    until it has failed ``max_attempts`` times. ``env`` is added to each
    worker's environment. ``stats``, when given, receives the attempts
    by rank, the last epoch, the stores still hosted, the tracker's
    messages (the fleet table among them) and the merged telemetry
    document (``fleet``, None when no worker shipped a summary). The tracker hosts
    an epoch's rendezvous store when the workers' registrations ask for
    one (they do under ``rabit_dataplane=torch``)."""
    tracker = Tracker(nworkers).start()
    procs: Dict[int, subprocess.Popen] = {}
    attempts: Dict[int, int] = {i: 0 for i in range(nworkers)}
    finished: Dict[int, bool] = {i: False for i in range(nworkers)}

    def spawn(i: int) -> None:
        worker_env = dict(os.environ)
        worker_env.update(env or {})
        worker_env.update(tracker.env(task_id=str(i),
                                      num_attempt=attempts[i]))
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
                if attempts[i] > max_attempts:
                    raise RuntimeError(
                        f"worker {i} failed rc={rc} after {max_attempts} "
                        f"attempts (per-rank budget)")
                if not quiet:
                    # the wall clock of the death: recovery is timed from it
                    print(f"[launch] worker {i} died rc={rc} at "
                          f"{time.time():.3f}; respawn attempt "
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
            stats["epoch"] = tracker.epoch
            stats["stores_retained"] = tracker.store_count()
            stats["messages"] = list(tracker.messages)
            # the merged telemetry summaries the workers shipped, if any
            stats["fleet"] = tracker.merged_metrics()
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
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.cmd and args.cmd[0] == "--":
        args.cmd = args.cmd[1:]
    if not args.cmd:
        ap.error("missing worker command")
    return launch(args.num_workers, args.cmd, args.max_attempts,
                  args.timeout)


if __name__ == "__main__":
    sys.exit(main())
