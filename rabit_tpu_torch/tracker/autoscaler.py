"""The fleet scheduler's autoscaler of the multi-job control plane: the
port's copy of ``rabit_tpu/tracker/autoscaler.py``, whole. It reads the
tracker's fleet metrics plane and drives the membership path.

The tracker already exposes everything a scheduler needs -- per-job
straggler verdicts on ``/straggler``, per-job health on ``/jobs`` -- and
owns the only safe resize primitive: the ``evict`` wire command and the
elastic re-formation. This module closes the loop: a rank that stays
``rabit_autoscale_lag`` collectives behind the leader for
``rabit_autoscale_strikes`` consecutive sweeps is evicted, so its world
re-forms smaller and faster instead of pacing every round at the
laggard's speed; the launcher's re-admission (``join``) grows the world
back when healthy hardware shows up.

Deliberately conservative:

- hysteresis (strikes) -- one GC pause never costs a rank its
  membership;
- a world-size floor (``rabit_autoscale_min_world``) -- shrinking a
  2-rank world to 1 usually costs more than the straggler does;
- one action per job per sweep -- the world must re-form and the
  verdict refresh before the next eviction can be justified;
- every decision rides the public wire and HTTP planes, so the loop can
  run anywhere the operator can reach the tracker (it holds no
  tracker-internal state and is safe to kill at any time).

The fleet half is weighted cross-job fairness over
``rabit_max_fleet_ranks``. Under contention (a non-empty admission
queue) each open job is entitled to a weighted share of the fleet cap
(:func:`fair_shares`, largest-remainder apportionment over
``rabit_sched_weight``); an elastic job living beyond its share is
shrunk -- same strikes hysteresis, one rank per job per sweep, highest
live rank first -- until the queue can drain into the freed capacity.
An uncontended fleet is work-conserving: nothing is shrunk just for
exceeding a share nobody else wants. Priority-class preemption is the
tracker's own, synchronous, half (a higher-class ``submit`` evicts
lowest-class ranks inline); this loop is the slow rebalancing half.

``python -m rabit_tpu_torch.tracker.autoscaler --smoke`` drives the
policy on scripted documents and a preemption through the port's
tracker; ``--tracker HOST:PORT --metrics HOST:PORT`` runs the loop.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import threading
from typing import Callable, Dict, List, Optional, Tuple

from . import jobs as _jobs_mod

INTERVAL_ENV = "RABIT_AUTOSCALE_INTERVAL_MS"
LAG_ENV = "RABIT_AUTOSCALE_LAG"
STRIKES_ENV = "RABIT_AUTOSCALE_STRIKES"
MIN_WORLD_ENV = "RABIT_AUTOSCALE_MIN_WORLD"

INTERVAL_MS_DEFAULT = 5000
LAG_DEFAULT = 50
STRIKES_DEFAULT = 3
MIN_WORLD_DEFAULT = 2


def _int_env(name: str, default: int, floor: int) -> int:
    try:
        return max(floor, int(os.environ.get(name, default)))
    except ValueError:
        return default


def autoscale_interval_ms() -> int:
    """``rabit_autoscale_interval_ms``: sweep period (floor 100 ms)."""
    return _int_env(INTERVAL_ENV, INTERVAL_MS_DEFAULT, 100)


def autoscale_lag() -> int:
    """``rabit_autoscale_lag``: collectives behind the leader before a
    rank starts accruing strikes."""
    return _int_env(LAG_ENV, LAG_DEFAULT, 1)


def autoscale_strikes() -> int:
    """``rabit_autoscale_strikes``: consecutive over-threshold sweeps
    before the autoscaler acts (hysteresis)."""
    return _int_env(STRIKES_ENV, STRIKES_DEFAULT, 1)


def autoscale_min_world() -> int:
    """``rabit_autoscale_min_world``: live-world floor below which the
    autoscaler refuses to evict."""
    return _int_env(MIN_WORLD_ENV, MIN_WORLD_DEFAULT, 1)


def fair_shares(jobs: List[dict], cap: int) -> Dict[str, int]:
    """Weighted largest-remainder apportionment of ``cap`` ranks
    across open jobs: job ``j`` is entitled to
    ``cap * weight_j / sum(weights)`` ranks, floored, with the
    leftover ranks going to the largest fractional remainders
    (job-id ties broken lexicographically, so shares are
    deterministic). Inelastic jobs get a share too — they consume
    capacity even though only elastic jobs can be shrunk toward
    theirs."""
    live = [(str(jd["job"]), float(jd.get("weight", 1.0)) or 1.0)
            for jd in jobs if isinstance(jd, dict) and jd.get("job")]
    total_w = sum(w for _, w in live)
    if cap <= 0 or total_w <= 0:
        return {}
    exact = {j: cap * w / total_w for j, w in live}
    shares = {j: int(exact[j]) for j, _ in live}
    leftover = cap - sum(shares.values())
    order = sorted(shares, key=lambda j: (-(exact[j] - shares[j]), j))
    for j in order[:leftover]:
        shares[j] += 1
    return shares


def request_evict(host: str, port: int, rank: int, reason: str,
                  job_id: str = _jobs_mod.DEFAULT_JOB,
                  timeout: float = 5.0) -> bool:
    """Send the ``evict`` wire command (job-addressed when the target
    is not the default job). Returns the tracker's ack."""
    from ..utils import retry
    from .tracker import MAGIC, _recv_u32, _send_str, _send_u32
    task = _jobs_mod.job_task(job_id, "autoscaler")
    with retry.connect_with_retry(host, int(port),
                                  timeout=timeout) as conn:
        conn.sendall(struct.pack("<I", MAGIC))
        _send_str(conn, "evict")
        _send_str(conn, task)
        _send_u32(conn, 0)
        _send_str(conn, json.dumps({"rank": int(rank),
                                    "reason": reason}))
        return _recv_u32(conn) == 1


class Autoscaler:
    """Poll the tracker's metrics plane; evict persistent stragglers.

    ``scrape_fn(path) -> Optional[dict]`` and ``evict_fn(job, rank,
    reason) -> bool`` are injectable so the policy is unit-testable
    without a cluster; the defaults ride the live HTTP plane and the
    ``evict`` wire command."""

    def __init__(self, tracker_host: str, tracker_port: int,
                 metrics_host: str, metrics_port: int,
                 scrape_fn: Optional[Callable] = None,
                 evict_fn: Optional[Callable] = None):
        from ..telemetry import live
        self.tracker_addr = (tracker_host, int(tracker_port))
        self.metrics_addr = (metrics_host, int(metrics_port))
        self._scrape = scrape_fn or (
            lambda path: live.scrape_json(self.metrics_addr[0],
                                          self.metrics_addr[1],
                                          path=path))
        self._evict = evict_fn or (
            lambda job, rank, reason: request_evict(
                self.tracker_addr[0], self.tracker_addr[1], rank,
                reason, job_id=job))
        self.lag = autoscale_lag()
        self.strikes_needed = autoscale_strikes()
        self.min_world = autoscale_min_world()
        self._strikes: Dict[Tuple[str, int], int] = {}
        self._fleet_strikes: Dict[str, int] = {}
        self.evicted_total = 0
        self.rebalanced_total = 0
        self.sweeps = 0
        self._stop = threading.Event()

    # -- policy -----------------------------------------------------------
    def _job_worlds(self) -> Dict[str, dict]:
        """job id -> /jobs doc (empty when the route is unreachable —
        the sweep then acts only where a straggler verdict names a
        job it can size)."""
        doc = self._scrape("/jobs") or {}
        out = {}
        for jd in doc.get("jobs", []):
            if isinstance(jd, dict) and jd.get("job"):
                out[str(jd["job"])] = jd
        return out

    def _verdicts(self) -> List[Tuple[str, dict]]:
        """(job id, straggler doc) pairs for this sweep: the per-job
        map when the tracker is multi-job, else the aggregate doc
        attributed to the default job."""
        doc = self._scrape("/straggler")
        if not isinstance(doc, dict):
            return []
        per_job = doc.get("jobs")
        if isinstance(per_job, dict) and per_job:
            return [(str(j), d) for j, d in sorted(per_job.items())
                    if isinstance(d, dict)]
        return [(_jobs_mod.DEFAULT_JOB, doc)]

    def sweep(self) -> List[Tuple[str, int]]:
        """One pass: accrue/clear strikes, evict at the threshold.
        Returns the (job, rank) evictions performed this sweep."""
        self.sweeps += 1  # noqa: C003 - sole writer: run()'s loop
        worlds = self._job_worlds()
        actions: List[Tuple[str, int]] = []
        live_keys = set()
        for job_id, strag in self._verdicts():
            rank = strag.get("lagging_rank")
            lagging = (bool(strag.get("signal")) and rank is not None
                       and int(strag.get("lag_collectives", 0))
                       >= self.lag)
            if not lagging:
                continue
            key = (job_id, int(rank))
            live_keys.add(key)
            n = self._strikes.get(key, 0) + 1
            self._strikes[key] = n
            if n < self.strikes_needed:
                continue
            jd = worlds.get(job_id, {})
            world = int(jd.get("world", 0) or 0)
            if jd and not jd.get("elastic"):
                continue   # inelastic job: eviction would be refused
            if world and world <= self.min_world:
                continue   # at the floor: live with the straggler
            reason = (f"autoscaler: {strag.get('lag_collectives')} "
                      f"collectives behind for {n} sweeps")
            if self._evict(job_id, int(rank), reason):
                self.evicted_total += 1  # noqa: C003 - sole writer
                actions.append((job_id, int(rank)))
                self._strikes.pop(key, None)
                print(f"[autoscaler] evicted job {job_id} rank {rank} "
                      f"({reason})", file=sys.stderr, flush=True)
        # a rank that recovered (or a world that re-formed) resets its
        # strike count: hysteresis measures CONSECUTIVE bad sweeps
        for key in list(self._strikes):
            if key not in live_keys:
                del self._strikes[key]
        return actions

    def fleet_sweep(self) -> List[Tuple[str, int]]:
        """One fairness pass: under contention (submissions
        waiting in the admission queue), shrink elastic jobs living
        beyond their weighted share of ``rabit_max_fleet_ranks`` —
        highest live rank first, one rank per job per sweep, same
        strikes hysteresis as the straggler policy. Uncontended (or
        uncapped), the fleet is work-conserving and this is a no-op.
        Returns the (job, rank) evictions performed."""
        doc = self._scrape("/jobs") or {}
        cap = int(doc.get("max_fleet_ranks", 0) or 0)
        contended = bool(doc.get("queue"))
        open_jobs = [jd for jd in doc.get("jobs", [])
                     if isinstance(jd, dict) and jd.get("job")
                     and jd.get("status") != "closed"]
        if not cap or not contended or not open_jobs:
            self._fleet_strikes.clear()
            return []
        shares = fair_shares(open_jobs, cap)
        actions: List[Tuple[str, int]] = []
        for jd in open_jobs:
            job_id = str(jd["job"])
            live_ranks = [int(r) for r in (jd.get("live") or [])]
            world = len(live_ranks) or int(jd.get("world", 0) or 0)
            share = shares.get(job_id, 0)
            if not jd.get("elastic") \
                    or world <= max(share, self.min_world):
                self._fleet_strikes.pop(job_id, None)
                continue
            n = self._fleet_strikes.get(job_id, 0) + 1
            self._fleet_strikes[job_id] = n
            if n < self.strikes_needed:
                continue
            rank = max(live_ranks) if live_ranks else world - 1
            reason = (f"fleet rebalance: world {world} over weighted "
                      f"share {share} with submissions queued")
            if self._evict(job_id, rank, reason):
                self.rebalanced_total += 1  # noqa: C003 - sole writer
                actions.append((job_id, rank))
                self._fleet_strikes.pop(job_id, None)
                print(f"[autoscaler] rebalanced job {job_id}: evicted "
                      f"rank {rank} ({reason})", file=sys.stderr,
                      flush=True)
        return actions

    # -- loop -------------------------------------------------------------
    def run(self) -> None:
        period = autoscale_interval_ms() / 1e3
        while not self._stop.wait(period):
            try:
                self.sweep()
                self.fleet_sweep()
            except Exception as e:   # the loop must survive
                print(f"[autoscaler] sweep failed: {e}",
                      file=sys.stderr, flush=True)

    def start(self) -> "Autoscaler":
        self._thread = threading.Thread(target=self.run,
                                        name="rabit-autoscaler",
                                        daemon=True)
        self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()


def _smoke() -> None:
    """Policy unit-drive: hysteresis, the world floor, per-job strike
    isolation, and strike reset on recovery — no cluster needed."""
    os.environ[STRIKES_ENV] = "2"
    os.environ[LAG_ENV] = "10"
    os.environ[MIN_WORLD_ENV] = "2"
    try:
        state = {"strag": None, "jobs": None}
        evicted = []

        def scrape(path):
            return state["strag"] if path == "/straggler" \
                else state["jobs"]

        sc = Autoscaler("127.0.0.1", 1, "127.0.0.1", 1,
                        scrape_fn=scrape,
                        evict_fn=lambda j, r, why: evicted.append(
                            (j, r)) or True)
        lag = {"signal": True, "lagging_rank": 2, "lag_collectives": 40,
               "busy_skew_s": 1.0}
        state["strag"] = {"signal": False, "jobs": {"jobA": dict(lag)}}
        state["jobs"] = {"jobs": [
            {"job": "jobA", "world": 4, "elastic": True},
            {"job": "jobB", "world": 4, "elastic": True}]}
        assert sc.sweep() == []          # strike 1 of 2: hysteresis
        assert sc.sweep() == [("jobA", 2)] and evicted == [("jobA", 2)]
        # recovery clears strikes: one bad sweep after a clean one
        # must not evict
        state["strag"] = {"signal": False, "jobs": {}}
        sc.sweep()
        state["strag"] = {"signal": False, "jobs": {"jobA": dict(lag)}}
        assert sc.sweep() == []
        # world floor: a 2-rank world keeps its straggler
        state["jobs"] = {"jobs": [
            {"job": "jobA", "world": 2, "elastic": True}]}
        assert sc.sweep() == [] and sc.sweep() == []
        # below the lag threshold: never even a strike
        small = dict(lag)
        small["lag_collectives"] = 3
        state["strag"] = {"signal": False, "jobs": {"jobB": small}}
        state["jobs"] = {"jobs": [
            {"job": "jobB", "world": 4, "elastic": True}]}
        assert sc.sweep() == [] and sc.sweep() == [] and sc.sweep() == []
        assert ("jobB", 2) not in sc._strikes
        # inelastic jobs are never shrunk
        state["strag"] = {"signal": False, "jobs": {"jobB": dict(lag)}}
        state["jobs"] = {"jobs": [
            {"job": "jobB", "world": 4, "elastic": False}]}
        assert sc.sweep() == [] and sc.sweep() == []
        assert sc.evicted_total == 1

        # -- fleet fairness -----------------------------------------
        # weighted shares: cap 8 split 1:3 -> jobA 2, jobB 6
        assert fair_shares([{"job": "jobA", "weight": 1.0},
                            {"job": "jobB", "weight": 3.0}], 8) \
            == {"jobA": 2, "jobB": 6}
        # remainders go to the largest fraction, ties lexicographic
        assert fair_shares([{"job": "a"}, {"job": "b"},
                            {"job": "c"}], 8) \
            == {"a": 3, "b": 3, "c": 2}
        # contended fleet (queue non-empty): jobA is 2 ranks over its
        # share -> strikes accrue, then its HIGHEST live rank goes;
        # jobB sits under its share and is untouched
        evicted.clear()
        state["jobs"] = {"max_fleet_ranks": 8, "queue": [{"job": "jobC"}],
                        "jobs": [
            {"job": "jobA", "world": 4, "elastic": True, "weight": 1.0,
             "status": "live", "live": [0, 1, 2, 3]},
            {"job": "jobB", "world": 4, "elastic": True, "weight": 3.0,
             "status": "live", "live": [0, 1, 2, 3]}]}
        assert sc.fleet_sweep() == []    # strike 1 of 2: hysteresis
        assert sc.fleet_sweep() == [("jobA", 3)]
        assert evicted == [("jobA", 3)] and sc.rebalanced_total == 1
        # uncontended (queue empty): over-share is fine, strikes clear
        state["jobs"]["queue"] = []
        assert sc.fleet_sweep() == [] and sc._fleet_strikes == {}
        # at the min_world floor the fleet sweep also refuses
        state["jobs"] = {"max_fleet_ranks": 4, "queue": [{"job": "jobC"}],
                        "jobs": [
            {"job": "jobA", "world": 2, "elastic": True, "weight": 1.0,
             "status": "live", "live": [0, 1]},
            {"job": "jobB", "world": 2, "elastic": True, "weight": 9.0,
             "status": "live", "live": [0, 1]}]}
        assert sc.fleet_sweep() == [] and sc.fleet_sweep() == []

        # -- priority preemption (the tracker's half) ----------------
        # a higher-class submit against a full fleet evicts the lowest
        # class's ranks via the elastic evict path and is admitted
        from .tracker import Tracker
        env2 = {k: os.environ.get(k) for k in
                (_jobs_mod.MULTI_JOB_ENV, _jobs_mod.MAX_FLEET_RANKS_ENV)}
        os.environ[_jobs_mod.MULTI_JOB_ENV] = "1"
        os.environ[_jobs_mod.MAX_FLEET_RANKS_ENV] = "4"
        try:
            tr = Tracker(2, elastic=True).start()
            try:
                assert _jobs_mod.submit(
                    tr.host, tr.port, "low", 4, elastic=True)["ok"] == 1
                conns = [_jobs_mod.wire_register(tr.host, tr.port,
                                                 f"low/{i}")
                         for i in range(4)]
                for c in conns:
                    _jobs_mod.wire_read_assignment(c)
                v = _jobs_mod.submit(tr.host, tr.port, "hi", 2,
                                     elastic=True, sched_class=2)
                assert v.get("ok") == 1 and v.get("preempted") == 2, v
                low = tr.job("low")
                assert low.quota == 2 and sorted(
                    low._member.live) == [0, 1]
                assert tr.sched_preemptions == {0: 2}
                # an equal-class submit must NOT preempt: it queues
                v = _jobs_mod.submit(tr.host, tr.port, "peer", 2,
                                     elastic=True)
                assert not v.get("ok") and v.get("queued") == 1, v
            finally:
                tr.stop()
        finally:
            for k, val in env2.items():
                if val is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = val
        print("autoscaler smoke ok")
    finally:
        for k in (STRIKES_ENV, LAG_ENV, MIN_WORLD_ENV):
            os.environ.pop(k, None)


def _main(argv: Optional[List[str]] = None) -> int:
    """Run the autoscaler against a live tracker: ``--tracker
    HOST:PORT`` (wire commands) + ``--metrics HOST:PORT`` (the
    tracker's fleet /straggler + /jobs plane)."""
    import argparse
    ap = argparse.ArgumentParser(description=_main.__doc__)
    ap.add_argument("--tracker", required=False,
                    help="tracker wire address HOST:PORT")
    ap.add_argument("--metrics", required=False,
                    help="tracker fleet-metrics address HOST:PORT")
    ap.add_argument("--smoke", action="store_true")
    args = ap.parse_args(argv)
    if args.smoke:
        _smoke()
        return 0
    if not args.tracker or not args.metrics:
        ap.error("--tracker and --metrics are required (or --smoke)")
    th, tp = args.tracker.rsplit(":", 1)
    mh, mp = args.metrics.rsplit(":", 1)
    sc = Autoscaler(th, int(tp), mh, int(mp))
    print(f"[autoscaler] watching {args.metrics}, driving "
          f"{args.tracker} (lag>={sc.lag}, strikes={sc.strikes_needed},"
          f" min_world={sc.min_world})", file=sys.stderr, flush=True)
    try:
        sc.run()
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    sys.exit(_main())
