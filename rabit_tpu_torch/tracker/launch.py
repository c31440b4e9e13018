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
    python -m rabit_tpu_torch.tracker.launch --submit HOST:PORT \\
        --job NAME -n 2 [--submit-wait 60] prog arg1 key=value ...

``--submit HOST:PORT`` runs the workers as one job of a RUNNING
multi-job tracker (``python -m rabit_tpu_torch.tracker.tracker
--multi-job``) instead of starting one: the launcher submits ``--job``
through the admission plane, backing off on a queued or shed verdict by
the tracker's ``retry_after_ms`` hints (overload sheds, it never
stalls), then spawns its workers with task ids ``<job>/<i>`` and
``RABIT_MULTI_JOB=1``. Many such launchers share one tracker, each job
inside its own fault domain. A tracker without multi-job answers every
submit with an error verdict, and the launch then fails with it once
``--submit-wait`` has passed: it never falls back to a launch of its
own.

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

With ``RABIT_TRACKER_STANDBY`` set as well (``1``, or a ``host:port`` to
pin the failover address) a hot standby (``tracker/standby.py``) follows
the tracker's journal over the ``repl`` stream under a lease of
``RABIT_LEASE_MS``, and the workers' environment names its address. A
crashed or partitioned leader is then replaced by the promoted standby,
which the supervisor adopts (``stats["failover"]``); the cold respawn is
held while the standby lives and is the fallback of a double failure.

``chaos`` (``launch(chaos=...)``, else ``RABIT_CHAOS``: a
``chaos.Schedule`` spec) puts fault-injection proxies on every socket
path: the workers reach the tracker through one front proxy, whose
``tracker_kill`` crashes the tracker through the supervisor and which the
supervisor retargets at a promoted standby, and the tracker rewrites the
peer addresses it advertises through a proxy a link
(``stats["chaos"]``: its proxies, injected faults, and the rogue
``submit`` connections of a ``job_storm`` with those refused).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from . import membership as _membership
from . import standby as _standby_mod
from . import wal as _wal_mod
from .tracker import Tracker, default_lease_ms


class _ChaosFarm:
    """The proxies of one ``launch(chaos=...)``: one fronts the tracker,
    and one a distinct worker link listener is made on demand by the
    tracker's ``link_rewrite`` hook (listen ports are known only at
    registration). Every proxy runs the schedule filtered to its target
    class (``tracker`` or ``link``; an unscoped rule runs on both) and
    reseeded a proxy, so faults stay deterministic a link without
    sharing ``max_times`` budgets."""

    def __init__(self, schedule):
        from ..chaos.schedule import Schedule
        self.schedule = Schedule.from_spec(schedule)
        self._lock = threading.Lock()
        self._by_target: Dict[Tuple[str, int], object] = {}
        self.tracker_proxy = None

    def front_tracker(self, tracker: Tracker, kill_hook=None):
        from ..chaos.proxy import ChaosProxy
        self.tracker_proxy = ChaosProxy(
            tracker.host, tracker.port,
            self.schedule.for_target("tracker").reseed(0),
            name="chaos-tracker", kill_hook=kill_hook).start()
        return self.tracker_proxy

    def link_rewrite(self, peer_rank: int, host: str,
                     port: int) -> Tuple[str, int]:
        from ..chaos.proxy import ChaosProxy
        with self._lock:
            proxy = self._by_target.get((host, port))
            if proxy is None:
                proxy = ChaosProxy(
                    host, port,
                    self.schedule.for_target("link").reseed(1 + peer_rank),
                    name=f"chaos-link-r{peer_rank}").start()
                self._by_target[(host, port)] = proxy
        return proxy.host, proxy.port

    def stop(self) -> Dict[str, int]:
        with self._lock:
            proxies = list(self._by_target.values())
            self._by_target.clear()
        if self.tracker_proxy is not None:
            proxies.append(self.tracker_proxy)
            self.tracker_proxy = None
        events = 0
        storm_submits = 0
        storm_shed = 0
        for p in proxies:
            # a short-lived world must not race a storm it survived: let
            # the firings in flight land their tallies (bounded)
            p.join_storms()
            events += len(p.events)
            for tally in p.storm_results:
                storm_submits += tally.get("submits", 0)
                storm_shed += sum(1 for v in tally.get("verdicts", [])
                                  if isinstance(v, dict) and not v.get("ok"))
            p.stop()
        return {"proxies": len(proxies), "events": events,
                "storm_submits": storm_submits, "storm_shed": storm_shed}


class _TrackerSupervisor:
    """Supervise the launcher's tracker the way the launcher supervises
    its workers (the JAX launcher's supervisor): a crash is followed by a
    ``resume=True`` tracker on the SAME pinned host and port once the
    scheduled outage has passed, so the environment every worker was
    launched with stays valid and the replayed journal re-adopts the live
    world. Without a WAL a killed tracker stays dead: supervision never
    invents durability. With a hot standby the supervisor's job becomes
    adopting the promoted standby, and never forking a second tracker
    into a healthy world."""

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
        self.standby: Optional[_standby_mod.StandbyTracker] = None
        self.proxy = None            # the chaos front proxy, retargeted
        self.failovers = 0
        self.fenced = 0              # live leaders crashed at an adoption
        # the deposed leader's replication plane at its kill (or, for a
        # partition, at its fencing): the lag a failover could lose
        self.leader_repl: Optional[dict] = None
        self._lock = threading.Lock()
        self._respawn_at: Optional[float] = None

    def kill(self, delay_ms: float = 0.0) -> None:
        """Crash the live tracker now and, with a WAL, schedule its
        ``resume=True`` successor ``delay_ms`` later (the outage the
        world must ride out)."""
        with self._lock:
            if self.tracker.crashed:
                return
            if self.standby is not None:
                self.leader_repl = self.tracker.repl_stats()
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

    def _leader_alive(self) -> bool:
        """Probe for a live leader OTHER than the one supervised before a
        cold respawn: a promoted standby owns the tracker's role now. The
        ``/healthz`` identity probe first (it works for a standby in
        another process too), else the in-process promotion state."""
        sb = self.standby
        if sb is None:
            return False
        tr = sb.tracker
        if tr is not None and tr.live_addr() is not None:
            from ..telemetry import live as _live
            doc = _live.scrape_json(*tr.live_addr(), path="/healthz")
            return bool(doc and doc.get("ok")
                        and doc.get("tracker_role") == "leader")
        return tr is not None and not tr.crashed

    def _adopt_locked(self) -> None:
        """A standby promoted itself: it IS the tracker now. Fence the
        deposed incarnation (after a partition it may still be
        listening), repoint the chaos front proxy so that the addresses
        baked into live workers -- the native core's ``finalize`` too --
        keep resolving, and cancel any scheduled respawn."""
        fresh = self.standby.tracker
        old, self.tracker = self.tracker, fresh
        self.failovers += 1
        self._respawn_at = None
        if not old.crashed:
            self.leader_repl = old.repl_stats()
            old.crash()
            self.crashed.append(old)
            self.fenced += 1
        if self.proxy is not None:
            self.proxy.retarget(fresh.host, fresh.port)
        if not self.quiet:
            print(f"[launch] standby promoted: tracker now "
                  f"{fresh.host}:{fresh.port} (failover "
                  f"{self.failovers}, seq {self.standby.acked_seq})",
                  file=sys.stderr, flush=True)

    def poll(self) -> None:
        """The supervision loop's turn: adopt a promoted standby; else,
        once a killed tracker's outage has passed, hold the cold respawn
        while a standby still works toward its promotion, and resume the
        tracker in place only when there is none (a double failure)."""
        with self._lock:
            if (self.standby is not None and self.standby.promoted()
                    and self.tracker is not self.standby.tracker):
                self._adopt_locked()
                return
            if self._respawn_at is None or \
                    time.monotonic() < self._respawn_at:
                return
            if self._leader_alive():
                # a promoted leader serves this world already: never fork
                # a second tracker into it (adopted at the next poll)
                self._respawn_at = None
                return
            if self.standby is not None and self.standby.alive():
                # the promotion is bounded by the lease: hold the cold
                # respawn while the standby works toward it
                self._respawn_at = time.monotonic() + 0.05
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
           tick: Optional[Callable[[_TrackerSupervisor], None]] = None,
           chaos=None) -> int:
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
    end lands in ``stats["live"]``. With the incident plane on in this
    process (``RABIT_EVENTS``), ``stats`` also gets the tracker's
    ``/events`` document (``fleet_events``) and its ``/incidents``
    (``incidents``), read before it stops. ``elastic`` (None: ``RABIT_ELASTIC``
    or ``rabit_elastic=1`` in ``cmd``) turns on elastic membership: a
    dead worker's relaunch is a re-admission, exempt from
    ``max_attempts``. ``RABIT_TRACKER_WAL_DIR`` journals the tracker's
    control plane, and a killed tracker is then resumed in place:
    ``tick``, when given, is called with the tracker's supervisor once a
    pass of the supervision loop (a test scripts ``kill`` with it);
    ``stats`` gets ``tracker_restarts`` and ``tracker_wal`` (the
    directory, the live incarnation's records and restarts, what its
    resume replayed and in how many ms, the seconds each incarnation
    spent journaling, and the wall clocks of each kill and resume).
    ``RABIT_TRACKER_STANDBY`` with a WAL adds a hot standby, journaling
    under ``<wal_dir>/standby``; ``stats["failover"]`` then counts its
    adoptions, its acked seq and resyncs, the measured failover, the
    deposed leader's replication plane at its kill or fencing, and the
    live leaders fenced. ``chaos`` (None: ``RABIT_CHAOS``, else
    off) is a ``chaos.Schedule`` spec; ``stats["chaos"]`` counts its
    proxies and injected faults."""
    if elastic is None:
        elastic = (_membership.elastic_enabled()
                   or any(a == "rabit_elastic=1" for a in cmd))
    if chaos is None:
        chaos = os.environ.get("RABIT_CHAOS") or None
    farm = _ChaosFarm(chaos) if chaos is not None else None
    link_rewrite = farm.link_rewrite if farm is not None else None
    wal_dir = os.environ.get(_wal_mod.WAL_DIR_ENV) or None
    # the hot standby is engaged only with both: an advertised standby
    # and a journal to stream. Without either, lease_ms stays None and
    # the tracker is as it was without a standby, byte for byte
    standby_spec = os.environ.get(_standby_mod.STANDBY_ENV) or None
    lease_ms = default_lease_ms() if (standby_spec and wal_dir) else None
    tracker = Tracker(nworkers, metrics_port=metrics_port, elastic=elastic,
                      wal_dir=wal_dir, link_rewrite=link_rewrite,
                      lease_ms=lease_ms).start()

    def _resumed_tracker(host: str, port: int) -> Tracker:
        return Tracker(nworkers, host=host, port=port,
                       metrics_port=metrics_port, elastic=elastic,
                       wal_dir=wal_dir, resume=True,
                       link_rewrite=link_rewrite, lease_ms=lease_ms)

    sup = _TrackerSupervisor(tracker, wal_dir, _resumed_tracker, quiet=quiet)
    front = None
    if farm is not None:
        try:
            front = farm.front_tracker(tracker, kill_hook=sup.kill)
        except BaseException:
            tracker.stop()   # a schedule the port cannot run
            raise
        sup.proxy = front
    standby = None
    if lease_ms:
        sb_host, sb_port = "127.0.0.1", 0
        if ":" in standby_spec:     # else "1": an ephemeral port
            h, _, p = standby_spec.rpartition(":")
            sb_host, sb_port = (h or "127.0.0.1"), int(p)
        # the standby follows the leader THROUGH the front proxy: a
        # tracker_partition severs replication as it severs the workers,
        # which is what makes a partition's failover honest
        lead = (front.host, front.port) if front is not None else \
            (tracker.host, tracker.port)
        standby = _standby_mod.StandbyTracker(
            lead[0], lead[1], nworkers,
            wal_dir=os.path.join(wal_dir, "standby"), host=sb_host,
            port=sb_port, lease_ms=lease_ms, elastic=elastic,
            link_rewrite=link_rewrite, metrics_port=metrics_port,
            quiet=quiet).start()
        sup.standby = standby
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
        if front is not None:
            # the front proxy, retargeted at a failover, keeps the address
            # valid for the run
            worker_env["RABIT_TRACKER_URI"] = front.host
            worker_env["RABIT_TRACKER_PORT"] = str(front.port)
        if standby is not None:
            # the pre-advertised failover address: the workers' pollers
            # probe it when the leader goes quiet
            worker_env[_standby_mod.STANDBY_ENV] = \
                f"{standby.host}:{standby.port}"
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
        # a resume or a failover replaced the tracker: every read below,
        # and the teardown, go to the live incarnation (and the dead ones)
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
            # the causal incident plane, when the tracker's process armed
            # it (RABIT_EVENTS): the folded fleet event log and the
            # incident book, read before the tracker stops
            if tracker._events_on:
                stats["fleet_events"] = tracker._events_doc()
                stats["incidents"] = tracker._incidents_doc()
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
            # a promotion is not a restart: nothing was forked
            stats["failover"] = {
                "standby": standby is not None,
                "failovers": sup.failovers,
                "promoted": standby is not None and standby.promoted(),
                "acked_seq": 0 if standby is None else standby.acked_seq,
                "resyncs": 0 if standby is None else standby.resyncs,
                "failover_ms": tracker.failover_duration_ms,
                "leader_repl": sup.leader_repl,
                "fenced": sup.fenced}
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        if farm is not None:
            chaos_stats = farm.stop()
            if stats is not None:
                stats["chaos"] = chaos_stats
            if not quiet and chaos_stats["events"]:
                print(f"[launch] chaos injected {chaos_stats['events']} "
                      f"fault(s) across {chaos_stats['proxies']} proxies",
                      file=sys.stderr, flush=True)
        for t in incarnations:
            if standby is None or t is not standby.tracker:
                t.stop()
        if standby is not None:
            standby.stop()   # and the promoted tracker it owns


def submit_launch(addr: str, job_id: str, nworkers: int, cmd: List[str],
                  max_attempts: int = 20, timeout: float = 300.0,
                  elastic: bool = False, max_wait_s: float = 60.0,
                  quiet: bool = False) -> int:
    """``launch --submit``: run ``cmd`` as one JOB of an already running
    multi-job tracker at ``addr`` (``HOST:PORT``). Admission first --
    :func:`jobs.submit_blocking` honours queued and shed verdicts' hints
    until admitted or ``max_wait_s`` passes -- then the spawn and respawn
    of :func:`launch`, every worker addressing its own fault domain by
    its ``<job>/<i>`` task id. The tracker is NOT owned here: its life
    (and any chaos or standby in front of it) is its starter's. Returns
    0 once every worker exited 0; 1 when admission failed, a worker
    spent its ``max_attempts`` or the job outlasted ``timeout``; 2 for a
    malformed address."""
    from . import jobs as _jobs_mod
    host, _, port_s = addr.rpartition(":")
    if not host or not port_s.isdigit():
        print(f"[submit] bad --submit address {addr!r} (want HOST:PORT)",
              file=sys.stderr, flush=True)
        return 2
    port = int(port_s)
    try:
        verdict = _jobs_mod.submit_blocking(
            host, port, job_id, nworkers, elastic=elastic,
            max_wait_s=max_wait_s)
    except (TimeoutError, OSError) as e:
        print(f"[submit] job {job_id!r} not admitted: {e}",
              file=sys.stderr, flush=True)
        return 1
    if not quiet:
        print(f"[submit] job {job_id!r} admitted at {host}:{port} "
              f"({verdict})", file=sys.stderr, flush=True)
    procs: Dict[int, subprocess.Popen] = {}
    attempts: Dict[int, int] = {i: 0 for i in range(nworkers)}
    finished: Dict[int, bool] = {i: False for i in range(nworkers)}

    def spawn(i: int) -> None:
        env = dict(os.environ)
        env["RABIT_TRACKER_URI"] = host
        env["RABIT_TRACKER_PORT"] = str(port)
        env["RABIT_TASK_ID"] = _jobs_mod.job_task(job_id, str(i))
        env["RABIT_NUM_TRIAL"] = str(attempts[i])
        env["RABIT_WORLD_SIZE"] = str(nworkers)
        env["RABIT_MULTI_JOB"] = "1"
        # an ephemeral link listener unless the caller names a port, as
        # launch() exports it
        env.setdefault("RABIT_SLAVE_PORT", "0")
        if elastic:
            env["RABIT_ELASTIC"] = "1"
        procs[i] = subprocess.Popen(cmd, env=env)
        attempts[i] += 1

    for i in range(nworkers):
        spawn(i)
    deadline = time.monotonic() + timeout
    rc = 0
    try:
        while not all(finished.values()):
            if time.monotonic() > deadline:
                print(f"[submit] job {job_id!r} timed out after "
                      f"{timeout:.0f}s", file=sys.stderr, flush=True)
                rc = 1
                break
            time.sleep(0.1)
            for i, p in list(procs.items()):
                code = p.poll()
                if code is None or finished[i]:
                    continue
                if code == 0:
                    finished[i] = True
                elif attempts[i] >= max_attempts:
                    print(f"[submit] worker {job_id}/{i} exhausted "
                          f"{max_attempts} attempts", file=sys.stderr,
                          flush=True)
                    rc = 1
                    finished[i] = True
                else:
                    spawn(i)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
    return rc


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
    ap.add_argument("--submit", default=None, metavar="HOST:PORT",
                    help="submit --job to an already running multi-job "
                         "tracker instead of starting one; backs off and "
                         "retries on queued or shed verdicts")
    ap.add_argument("--job", default=None, metavar="NAME",
                    help="the job id for --submit (default: job-<pid>); "
                         "workers get task ids NAME/<i>")
    ap.add_argument("--submit-wait", type=float, default=60.0,
                    metavar="S", help="admission budget of --submit "
                                      "before it gives up (default 60)")
    ap.add_argument("cmd", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    if args.cmd and args.cmd[0] == "--":
        args.cmd = args.cmd[1:]
    if not args.cmd:
        ap.error("missing worker command")
    if args.submit:
        if args.metrics_port is not None:
            ap.error("--metrics-port starts a tracker: not with --submit")
        return submit_launch(args.submit, args.job or f"job-{os.getpid()}",
                             args.num_workers, args.cmd, args.max_attempts,
                             args.timeout, elastic=bool(args.elastic),
                             max_wait_s=args.submit_wait)
    if args.job:
        ap.error("--job requires --submit")
    return launch(args.num_workers, args.cmd, args.max_attempts,
                  args.timeout, metrics_port=args.metrics_port,
                  elastic=args.elastic)


if __name__ == "__main__":
    sys.exit(main())
