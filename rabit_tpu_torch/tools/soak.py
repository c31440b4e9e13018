"""Serving-scale soak: one tracker, a rolling job population, the full
chaos schedule, an SLO-gated exit. The port's copy of ``tools/soak.py``,
with the same scenarios, schedule, job kinds, ledger and gate, over the
port's tracker, standby, chaos proxy, multi-job admission, event bus,
clock, incident engine and SLO plane.

Only a sustained run exercises standby failover, multi-job admission and
self-healing links together: this tool stands up a leader tracker (WAL
and lease) with a hot standby, fronts the control plane with a chaos
proxy, and submits a rolling population of short- and long-lived jobs
(boosting rounds, transformer steps, RS/AG programs) at a configurable
QPS through real admission control (the ``submit`` wire command). Each
admitted job registers real workers over the wire and runs its rounds as
framed echo exchanges through a link-plane chaos proxy, so injected RSTs
and bitflips hit real payload bytes. The chaos schedule keeps every
scenario live for the whole run: leader crash (tracker_kill, then the
standby's promotion), leader partition, link RSTs, wire corruption and a
submit storm. The workers do no device work.

At the end the four fleet SLOs (``telemetry/slo.py``) are evaluated from
what the run measured: availability (rounds completed on schedule), p99
collective latency (log2-us span histograms), failover time (stamped by
the control plane at promotion) and admission shed rate (submit
verdicts). Any ``violating`` objective exits nonzero. Every warn or
violating verdict is correlated against the run's fleet event log into
an ``incident/v1``; ``--strict-attribution`` fails the gate on an
unattributed one. The ``rabit_tpu.soak/v1`` artifact goes to ``--out``
and, outside ``--smoke`` and ``--no-history``, into the port's history
file (``build/artifacts/history.jsonl``, ``telemetry/history.py``), never
``benchmarks/``.

Knobs (flags beat env): ``--duration``/``RABIT_SOAK_DURATION_S``,
``--qps``/``RABIT_SOAK_QPS``, ``--workers``/``RABIT_SOAK_WORKERS``,
``--round-deadline-ms``/``RABIT_SOAK_ROUND_DEADLINE_MS``; objectives
override with ``--objective NAME=VALUE`` (beats the ``RABIT_SLO_*``
env), which is also how a test injects a violation.

    python -m rabit_tpu_torch.tools.soak --duration 300 --qps 2 --out SOAK.json
    python -m rabit_tpu_torch.tools.soak --smoke    # 45 s mini-soak
"""

import argparse
import json
import os
import shutil
import socket
import struct
import sys
import tempfile
import threading
import time

from .. import telemetry
from ..chaos.proxy import ChaosProxy
from ..chaos.schedule import Schedule
from ..telemetry import clock as clock_mod
from ..telemetry import events as events_mod
from ..telemetry import history, incident, slo
from ..telemetry.schema import make_header, matches
from ..tracker import jobs as jobs_mod
from ..tracker.standby import StandbyTracker
from ..tracker.tracker import Tracker

SOAK_KIND = "soak"

_DURATION_ENV = "RABIT_SOAK_DURATION_S"
_QPS_ENV = "RABIT_SOAK_QPS"
_WORKERS_ENV = "RABIT_SOAK_WORKERS"
_DEADLINE_ENV = "RABIT_SOAK_ROUND_DEADLINE_MS"

# Every soak scenario maps to a REGISTERED chaos rule kind
# (chaos/schedule.py KINDS) -- lint T004 pins this table, so
# a renamed or misspelled kind can never become a silent no-op
# scenario. Window/prob anchors are added per run in chaos_spec().
SCENARIOS = {
    "leader_crash": {"kind": "tracker_kill", "target": "tracker"},
    "leader_partition": {"kind": "tracker_partition",
                         "target": "tracker"},
    "link_rst": {"kind": "reset", "target": "link"},
    "wire_corruption": {"kind": "bitflip", "target": "link"},
    "submit_storm": {"kind": "job_storm", "target": "tracker"},
}

# job archetypes in the rolling population: (kind, rounds, payload)
_JOB_KINDS = (("boost", 4, 8 << 10),
              ("transformer", 10, 32 << 10),
              ("rs_ag", 6, 16 << 10))


def chaos_spec(duration_s: float, seed: int) -> dict:
    """The full schedule, every scenario live, anchored to the run
    length: partition early, leader kill in the first half (so the
    promoted tracker serves most of the run), corruption mid-run, a
    submit storm late (it must hit the PROMOTED control plane), RSTs
    probabilistic throughout."""
    t = float(duration_s)

    def rule(scenario, **kw):
        r = dict(SCENARIOS[scenario])
        r.update(kw)
        return r

    return {"seed": int(seed), "rules": [
        rule("leader_partition", window_s=[0.08 * t, 0.16 * t]),
        rule("leader_crash", window_s=[0.25 * t, 0.60 * t]),
        rule("wire_corruption", window_s=[0.30 * t, 0.90 * t],
             after_bytes=1024),
        rule("link_rst", prob=0.05, after_bytes=4096),
        rule("submit_storm", window_s=[0.65 * t, 0.80 * t], burst=8),
    ]}


class _Ledger:
    """Thread-shared tallies: the round ledger behind the
    availability SLO plus submit-verdict counts behind shed rate."""

    def __init__(self):
        self.mu = threading.Lock()
        self.rounds_total = 0
        self.rounds_on_time = 0
        self.rounds_retried = 0
        self.rounds_failed = 0
        self.verdicts = {"ok": 0, "queued": 0, "shed": 0, "error": 0}
        self.submit_errors = 0
        self.jobs = {"submitted": 0, "admitted": 0, "completed": 0,
                     "failed": 0, "abandoned": 0}

    def round_done(self, on_time: bool, retried: bool,
                   failed: bool) -> None:
        with self.mu:
            self.rounds_total += 1
            if on_time:
                self.rounds_on_time += 1
            if retried:
                self.rounds_retried += 1
            if failed:
                self.rounds_failed += 1

    def verdict(self, resp: dict) -> None:
        with self.mu:
            if resp.get("ok"):
                self.verdicts["ok"] += 1
            elif resp.get("queued"):
                self.verdicts["queued"] += 1
            elif resp.get("shed"):
                self.verdicts["shed"] += 1
            else:
                self.verdicts["error"] += 1


class _LinkPlane:
    """The data plane the chaos link proxy mutates: one framed echo
    listener ("rank 0's link"); every collective round is one
    length-prefixed exchange through the proxy, byte-compared on
    return so an injected bitflip is DETECTED (and the round retried)
    exactly like the frame-CRC data plane would."""

    def __init__(self, schedule: Schedule):
        self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._srv.bind(("127.0.0.1", 0))
        self._srv.listen(64)
        self._srv.settimeout(0.2)
        self._done = threading.Event()
        host, port = self._srv.getsockname()
        self.proxy = ChaosProxy(host, port, schedule=schedule,
                                name="soak-link").start()
        threading.Thread(target=self._serve, name="soak-link-echo",
                         daemon=True).start()

    def _serve(self) -> None:
        while not self._done.is_set():
            try:
                conn, _ = self._srv.accept()
            except socket.timeout:
                continue
            except OSError:
                return
            threading.Thread(target=self._echo, args=(conn,),
                             daemon=True).start()

    @staticmethod
    def _recv_exact(conn, n: int) -> bytes:
        out = b""
        while len(out) < n:
            chunk = conn.recv(n - len(out))
            if not chunk:
                raise OSError("peer closed mid-frame")
            out += chunk
        return out

    def _echo(self, conn) -> None:
        try:
            conn.settimeout(5.0)
            n = struct.unpack("<I", self._recv_exact(conn, 4))[0]
            payload = self._recv_exact(conn, n)
            conn.sendall(struct.pack("<I", n) + payload)
        except (OSError, struct.error):
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def exchange(self, payload: bytes, timeout: float) -> bool:
        """One round trip through the chaos proxy; True only when the
        echo came back byte-identical (a bitflipped or torn exchange
        is a detected failure, never silent corruption)."""
        try:
            conn = socket.create_connection(  # noqa: R001 - bench client
                (self.proxy.host, self.proxy.port), timeout=timeout)
        except OSError:
            return False
        try:
            conn.settimeout(timeout)
            conn.sendall(struct.pack("<I", len(payload)) + payload)
            n = struct.unpack("<I", self._recv_exact(conn, 4))[0]
            return self._recv_exact(conn, n) == payload
        except (OSError, struct.error):
            return False
        finally:
            try:
                conn.close()
            except OSError:
                pass

    def close(self) -> None:
        self._done.set()
        self.proxy.stop()
        try:
            self._srv.close()
        except OSError:
            pass


class _Job(threading.Thread):
    """One job's lifecycle: admission (counting every verdict),
    worker registration over the wire, its round program through the
    link plane, clean shutdown."""

    def __init__(self, idx: int, ctl, link: _LinkPlane,
                 ledger: _Ledger, workers: int, deadline_ms: float,
                 stop_ev: threading.Event):
        super().__init__(name=f"soak-job-{idx}", daemon=True)
        self.idx = idx
        self._ctl = ctl            # () -> (host, port) of the proxy
        self._link = link
        self._ledger = ledger
        self._workers = workers
        self._deadline_ms = deadline_ms
        self._halt = stop_ev
        self.kind, self.rounds, self.payload = \
            _JOB_KINDS[idx % len(_JOB_KINDS)]
        self.job_id = f"soak{idx}"

    def _admit(self) -> bool:
        deadline = time.monotonic() + 8.0
        backoff = 0.5
        while not self._halt.is_set():
            host, port = self._ctl()
            try:
                resp = jobs_mod.submit(host, port, self.job_id,
                                       self._workers, timeout=3.0)
            except Exception:
                with self._ledger.mu:
                    self._ledger.submit_errors += 1
                if time.monotonic() > deadline:
                    return False
                time.sleep(0.5)
                continue
            self._ledger.verdict(resp)
            if resp.get("ok"):
                return True
            if resp.get("error") or time.monotonic() > deadline:
                return False
            if resp.get("queued"):
                # in line: admission happens at queue-pop, so poll
                # briskly enough to claim the slot before the forming
                # timeout decides nobody is behind this job
                backoff = 0.5
                time.sleep(min(1.0, resp.get("retry_after_ms", 500) / 1e3))
            else:
                # shed: the fleet is overloaded -- double the server's
                # hint each time; retrying faster than asked turns one
                # rejection into a storm
                time.sleep(max(backoff,
                               resp.get("retry_after_ms", 500) / 1e3))
                backoff = min(4.0, backoff * 2)
        return False

    def _round(self, rng_byte: int) -> None:
        payload = bytes((rng_byte + i) & 0xFF
                        for i in range(self.payload))
        timeout = max(2.0, 4 * self._deadline_ms / 1e3)
        t0 = time.perf_counter()
        ok = self._link.exchange(payload, timeout)
        retried = False
        if not ok:
            retried = True
            ok = self._link.exchange(payload, timeout)
        dur = time.perf_counter() - t0
        telemetry.record_span("allreduce", dur, nbytes=len(payload),
                              op=self.kind, method="soak")
        self._ledger.round_done(
            on_time=ok and dur * 1e3 <= self._deadline_ms,
            retried=retried, failed=not ok)

    def run(self) -> None:
        with self._ledger.mu:
            self._ledger.jobs["submitted"] += 1
        if not self._admit():
            with self._ledger.mu:
                self._ledger.jobs["abandoned"] += 1
            return
        with self._ledger.mu:
            self._ledger.jobs["admitted"] += 1
        host, port = self._ctl()
        tasks = [f"{self.job_id}{jobs_mod.JOB_SEP}{i}"
                 for i in range(self._workers)]
        try:
            conns = [jobs_mod.wire_register(
                host, port, t, link_port=self._link.proxy.port)
                for t in tasks]
            for c in conns:
                jobs_mod.wire_read_assignment(c)
        except Exception:
            with self._ledger.mu:
                self._ledger.jobs["failed"] += 1
            return
        for r in range(self.rounds):
            if self._halt.is_set():
                break
            for w in range(self._workers):
                self._round(self.idx * 31 + r * 7 + w)
            time.sleep(0.15)
        host, port = self._ctl()
        for t in tasks:
            try:
                jobs_mod.wire_shutdown(host, port, t)
            except Exception:
                pass
        with self._ledger.mu:
            self._ledger.jobs["completed"] += 1


def run_soak(duration_s: float, qps: float, workers: int, seed: int,
             deadline_ms: float, objectives=None, quiet: bool = False,
             chaos: dict = None) -> dict:
    """One full soak; returns the ``rabit_tpu.soak/v1`` artifact (the
    JAX package's schema id, which the port's readers share)."""

    def log(msg):
        if not quiet:
            print(f"[soak] {msg}", file=sys.stderr, flush=True)

    env_save = {k: os.environ.get(k) for k in
                (jobs_mod.MULTI_JOB_ENV, jobs_mod.MAX_JOBS_ENV,
                 jobs_mod.ADMISSION_QUEUE_ENV,
                 jobs_mod.MAX_FLEET_RANKS_ENV,
                 "RABIT_TRACKER_RESUME_GRACE_MS",
                 "RABIT_JOB_FORMING_TIMEOUT_MS",
                 "RABIT_EVENTS")}
    # fleet sizing: the rolling job mix needs ~2.4 slots at the default
    # 2 submits/s, so 4 slots gives steady-state headroom while the
    # storm and the chaos windows still drive the queue into shedding
    os.environ[jobs_mod.MULTI_JOB_ENV] = "1"
    # a shallow queue on purpose: FIFO admission happens at queue-pop,
    # so a deep queue goes stale -- heads get admitted after their
    # submitter's deadline passed, and every stale head burns a slot
    # until the forming timeout reaps it
    os.environ[jobs_mod.MAX_JOBS_ENV] = "4"
    os.environ[jobs_mod.ADMISSION_QUEUE_ENV] = "2"
    os.environ[jobs_mod.MAX_FLEET_RANKS_ENV] = str(4 * workers)
    # soak jobs live ~1-2 s, so membership that survived the crash
    # re-presents fast; a short grace lets the promoted standby reap
    # pre-crash zombie jobs before they distort the shed-rate SLO
    os.environ["RABIT_TRACKER_RESUME_GRACE_MS"] = "4000"
    # a queued job admitted after its submitter stopped waiting (or a
    # storm-injected one) has nobody behind it: reap such ghosts well
    # inside the submitter's retry horizon so they cannot jam the fleet
    os.environ["RABIT_JOB_FORMING_TIMEOUT_MS"] = "3000"
    telemetry.reset(capacity=4096, enabled=True)
    # the causal incident plane: a soak is exactly the run that needs
    # attribution -- chaos injections, watchdog rungs, and
    # admission churn all land on the fleet event bus, and every SLO
    # burn below is correlated against it
    os.environ["RABIT_EVENTS"] = "1"
    events_mod.reset(capacity=2048, enabled=True)
    clock_mod.reset("soak", enabled=True)

    spec = chaos if chaos is not None else chaos_spec(duration_s, seed)
    sched = Schedule.from_spec(spec)
    lease_ms = 800
    tmp = tempfile.mkdtemp(prefix="rabit_soak_")
    ledger = _Ledger()
    stop_ev = threading.Event()
    leader = standby = ctl = link = None
    jobs_list = []
    try:
        leader = Tracker(workers, wal_dir=os.path.join(tmp, "leader"),
                         lease_ms=lease_ms, node_id="soak-leader")
        leader.start()
        standby = StandbyTracker(
            leader.host, leader.port, workers,
            wal_dir=os.path.join(tmp, "standby"), lease_ms=lease_ms,
            node_id="soak-standby", quiet=quiet).start()
        ctl = ChaosProxy(leader.host, leader.port,
                         schedule=sched.for_target("tracker").reseed(1),
                         name="soak-ctl",
                         kill_hook=lambda delay_ms: leader.crash())
        ctl.start()
        link = _LinkPlane(sched.for_target("link").reseed(2))

        def ctl_addr():
            return ctl.host, ctl.port

        # repoint NEW control connections at the promoted standby the
        # moment it takes over -- live workers keep resolving through
        # the proxy, exactly as the launcher's supervisor does
        def monitor():
            while not stop_ev.is_set():
                if standby.promoted():
                    ctl.retarget(standby.host, standby.port)
                    log(f"control plane failed over to "
                        f"{standby.host}:{standby.port}")
                    return
                time.sleep(0.1)

        threading.Thread(target=monitor, name="soak-failover-monitor",
                         daemon=True).start()

        log(f"soaking {duration_s:g}s at {qps:g} submits/s, "
            f"{workers} workers/job, chaos seed {seed}")
        t_end = time.monotonic() + duration_s
        idx = 0
        period = 1.0 / max(qps, 1e-3)
        while time.monotonic() < t_end:
            job = _Job(idx, ctl_addr, link, ledger, workers,
                       deadline_ms, stop_ev)
            job.start()
            jobs_list.append(job)
            idx += 1
            wake = time.monotonic() + period
            while time.monotonic() < min(wake, t_end):
                time.sleep(0.05)
        stop_ev.set()
        for job in jobs_list:
            job.join(timeout=10.0)

        # a fired tracker_kill must end in a promotion before the
        # failover SLO can be judged; give the lease gate room
        kill_fired = any(k == "tracker_kill" for _, k, _ in ctl.events)
        if kill_fired:
            waited = time.monotonic() + 6 * lease_ms / 1e3 + 5.0
            while not standby.promoted() and time.monotonic() < waited:
                time.sleep(0.1)

        # -- measurements ------------------------------------------------
        snap = telemetry.snapshot()
        with ledger.mu:
            rounds_total = ledger.rounds_total
            rounds_on_time = ledger.rounds_on_time
            verdicts = dict(ledger.verdicts)
        for tally in ctl.storm_results:
            for v in tally.get("verdicts", []):
                ledger.verdict(v)
        with ledger.mu:
            verdicts_all = dict(ledger.verdicts)
        measured = {}
        if rounds_total:
            measured["availability"] = rounds_on_time / rounds_total
        p99 = slo.p99_ms_from_counters(snap.get("counters"))
        if p99 is not None:
            measured["p99_ms"] = p99
        promoted_tr = standby.tracker
        if promoted_tr is not None \
                and promoted_tr.failover_duration_ms > 0:
            measured["failover_ms"] = promoted_tr.failover_duration_ms
        denom = (verdicts_all["ok"] + verdicts_all["queued"]
                 + verdicts_all["shed"])
        if denom:
            measured["shed_rate"] = verdicts_all["shed"] / denom

        slos = slo.default_slos(overrides=objectives,
                                window_s=duration_s)
        verdict_rows = slo.evaluate_all(slos, measured)
        violating = [v["slo"] for v in verdict_rows
                     if v["state"] == slo.VIOLATING]
        no_data = [v["slo"] for v in verdict_rows
                   if v["state"] == slo.NO_DATA]

        # root-cause attribution: every warn/violating
        # verdict becomes an incident/v1 correlated against the fleet
        # event log of the whole run (the soak judges at the end, so
        # the causal window spans the duration); the verdict row
        # carries the attribution one-liner -- or an explicit
        # ``unattributed`` marker, which --strict-attribution turns
        # into a failed gate
        ev_snap = events_mod.snapshot()
        fleet_events = ev_snap["records"]
        incidents = []
        for v in verdict_rows:
            if v["state"] not in (slo.WARN, slo.VIOLATING):
                continue
            inc = incident.correlate(
                incident.slo_trigger(v), fleet_events,
                window=duration_s * 1e3,
                incident_id=f"soak-{v['slo']}")
            incidents.append(inc)
            v["incident"] = inc["id"]
            v["unattributed"] = inc["unattributed"]
            v["attribution"] = inc["summary"]

        def by_kind(events):
            out = {}
            for _, kind, _ in events:
                out[kind] = out.get(kind, 0) + 1
            return out

        doc = make_header(SOAK_KIND)
        # top-level scalars are the config fingerprint (history.py):
        # measurements stay nested so run-to-run noise can't fork the
        # trend series
        doc["duration_s"] = int(duration_s)
        doc["qps_key"] = f"{qps:g}"
        doc["workers_per_job"] = int(workers)
        doc["seed"] = int(seed)
        doc["round_deadline_ms"] = int(deadline_ms)
        doc["scenarios"] = "+".join(sorted(SCENARIOS))
        doc["rounds"] = {
            "total": rounds_total, "on_time": rounds_on_time,
            "retried": ledger.rounds_retried,
            "failed": ledger.rounds_failed,
            "deadline_ms": deadline_ms}
        doc["jobs"] = dict(ledger.jobs)
        doc["admission"] = {"verdicts": verdicts_all,
                            "own_verdicts": verdicts,
                            "submit_errors": ledger.submit_errors}
        doc["failover"] = {
            "promoted": promoted_tr is not None,
            "duration_ms": (None if promoted_tr is None else
                            round(promoted_tr.failover_duration_ms, 3)),
            "promoted_wall": (None if promoted_tr is None else
                              promoted_tr.promoted_wall),
            "node": None if promoted_tr is None else standby.node_id}
        doc["chaos"] = {"spec": sched.to_json(),
                        "tracker_events": by_kind(ctl.events),
                        "link_events": by_kind(link.proxy.events),
                        "storms": len(ctl.storm_results)}
        doc["slos"] = verdict_rows
        doc["incidents"] = incidents
        ev_by_kind = {}
        for rec in fleet_events:
            k = rec.get("kind", "?")
            ev_by_kind[k] = ev_by_kind.get(k, 0) + 1
        doc["events"] = {"by_kind": ev_by_kind,
                         "seq": ev_snap["seq"],
                         "dropped": ev_snap["dropped"]}
        doc["gate"] = {"pass": not violating, "violating": violating,
                       "no_data": no_data,
                       "unattributed": [i["id"] for i in incidents
                                        if i["unattributed"]]}
        for v in verdict_rows:
            log(f"SLO {v['slo']}: value="
                f"{'-' if v['value'] is None else format(v['value'], 'g')}"
                f" objective={v['objective']:g} {v['unit']}"
                f" ({v['direction']} is better) -> {v['state']}")
        return doc
    finally:
        stop_ev.set()
        for obj in (ctl, link):
            if obj is not None:
                try:
                    obj.stop() if obj is ctl else obj.close()
                except Exception:
                    pass
        if standby is not None:
            try:
                standby.stop()
            except Exception:
                pass
        if leader is not None and not leader.crashed:
            try:
                leader.stop()
            except Exception:
                pass
        shutil.rmtree(tmp, ignore_errors=True)
        for k, v in env_save.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
        # the event bus and clock re-read the restored env
        events_mod.reset()
        clock_mod.reset()


def _parse_objectives(pairs) -> dict:
    out = {}
    for p in pairs or []:
        name, _, val = p.partition("=")
        if not val:
            raise SystemExit(f"--objective wants NAME=VALUE, got {p!r}")
        out[name.strip()] = float(val)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m rabit_tpu_torch.tools.soak",
        description="SLO-gated fleet soak under sustained chaos")
    ap.add_argument("--duration", type=float,
                    default=float(os.environ.get(_DURATION_ENV, 300)))
    ap.add_argument("--qps", type=float,
                    default=float(os.environ.get(_QPS_ENV, 2.0)))
    ap.add_argument("--workers", type=int,
                    default=int(os.environ.get(_WORKERS_ENV, 2)))
    ap.add_argument("--round-deadline-ms", type=float,
                    default=float(os.environ.get(_DEADLINE_ENV, 250)))
    ap.add_argument("--seed", type=int, default=7)
    ap.add_argument("--chaos", default=None,
                    help="chaos spec (JSON or @file) replacing the "
                         "built-in full schedule")
    ap.add_argument("--objective", action="append", metavar="NAME=VAL",
                    help="override one SLO objective (beats RABIT_SLO_* "
                         "env); repeatable")
    ap.add_argument("--out", default=None,
                    help="write the soak/v1 artifact here")
    ap.add_argument("--history", default=history.history_path(),
                    help="history JSONL to trend into (non-smoke)")
    ap.add_argument("--no-history", action="store_true")
    ap.add_argument("--strict-attribution", action="store_true",
                    help="fail the gate when any warn/violating SLO "
                         "verdict's incident is unattributed (no "
                         "candidate cause in the event window)")
    ap.add_argument("--quiet", action="store_true")
    ap.add_argument("--smoke", action="store_true",
                    help="45 s mini-soak: low QPS, "
                         "seeded chaos, asserts a well-formed artifact "
                         "with all four SLOs evaluated")
    args = ap.parse_args(argv)

    duration = args.duration
    qps = args.qps
    if args.smoke:
        # mini-soak defaults: a rolling handful of jobs, every chaos
        # scenario still live; flags may tighten further (tests run
        # --smoke --duration 8)
        if _DURATION_ENV not in os.environ and duration == 300:
            duration = 45.0
        if _QPS_ENV not in os.environ and qps == 2.0:
            qps = 0.5
    chaos = None
    if args.chaos:
        spec = args.chaos
        if spec.startswith("@"):
            with open(spec[1:]) as f:
                chaos = json.load(f)
        else:
            chaos = json.loads(spec)

    doc = run_soak(duration, qps, args.workers, args.seed,
                   args.round_deadline_ms,
                   objectives=_parse_objectives(args.objective),
                   quiet=args.quiet, chaos=chaos)
    doc["smoke"] = bool(args.smoke)

    if args.smoke:
        # the artifact contract: well-formed soak/v1, all four SLOs
        # present, and every measurable objective actually measured
        assert matches(doc, SOAK_KIND), doc.get("schema")
        assert len(doc["slos"]) == 4, doc["slos"]
        states = {v["slo"]: v["state"] for v in doc["slos"]}
        assert set(states) == {"availability", "p99_ms",
                               "failover_ms", "shed_rate"}, states
        values = {v["slo"]: v["value"] for v in doc["slos"]}
        for name in ("availability", "p99_ms", "failover_ms",
                     "shed_rate"):
            assert values[name] is not None, (name, doc)
        assert doc["failover"]["promoted"], doc["failover"]
        assert doc["chaos"]["tracker_events"].get("tracker_kill"), \
            doc["chaos"]
        # the attribution contract: every warn/violating
        # verdict carries an incident/v1 with an attribution chain or
        # the explicit unattributed marker -- never silence
        for v in doc["slos"]:
            if v["state"] in (slo.WARN, slo.VIOLATING):
                assert "attribution" in v and "unattributed" in v, v
        for inc in doc["incidents"]:
            assert matches(inc, incident.INCIDENT_KIND), inc
            assert inc["unattributed"] or inc.get("root_cause"), inc
        assert doc["events"]["seq"] > 0, doc["events"]
        print("soak smoke ok", file=sys.stderr)

    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
    print(json.dumps(doc, sort_keys=True))
    if not args.smoke and not args.no_history:
        added = history.append(
            args.history, history.records_from_artifact(
                doc, source=os.path.basename(args.out or "soak")))
        print(f"[soak] trended {added} records into {args.history}",
              file=sys.stderr)
    if args.strict_attribution and doc["gate"]["unattributed"]:
        print(f"[soak] strict attribution: unattributed incidents "
              f"{doc['gate']['unattributed']}", file=sys.stderr)
        return 1
    return 0 if doc["gate"]["pass"] else 1


if __name__ == "__main__":
    sys.exit(main())
