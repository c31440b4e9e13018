"""Live arrival-skew estimation and schedule-adaptation policy: the
port's copy of ``rabit_tpu/telemetry/skew.py``.

The observability plane measures per-round arrival skew and names the
laggard rank (``crossrank.straggler_snapshot``, tracker ``/straggler``);
this module feeds the measurement back into dispatch: every schedule
assumes ranks arrive together, which arXiv:1804.05349 shows leaves large
fractions of round time on the table under imbalanced process arrival.

Four pieces live here, all plain Python (no torch import: the tracker
uses the estimator and the digest builder without an accelerator
stack):

- :class:`SkewEstimator` -- an EWMA of per-rank arrival offsets with
  hysteresis on the laggard election, so one noisy round cannot flip
  the adapted schedule back and forth. It runs ONLY inside the
  tracker's :class:`FleetElection`: there is exactly one election for
  the whole fleet, never a per-process opinion -- every rank must run
  the same schedule for the same round, and ranks that run different
  schedules post mismatched exchanges (NCCL hangs, gloo garbles);
- the fleet **skew digest** ``{epoch, offsets_ms, laggard}`` -- built
  tracker-side from the ``/straggler`` poll sweep
  (:func:`digest_from_snapshot` -> :class:`FleetElection`, whose epoch
  bumps exactly when the election changes), served over the ``skew``
  wire command (mirroring ``topo``), fetched worker-side by a
  background thread owned by the process-global :class:`SkewMonitor`
  and applied VERBATIM -- no worker-side smoothing;
- the **agreement boundary**: a tracker-fetched digest is only a
  *candidate* until every process has adopted the same one. Dispatch
  calls :func:`sync_due` (a pure function of a per-process dispatch
  counter all processes advance in program order) and, when due,
  broadcasts group rank 0's candidate over the process group
  (:func:`encode_digest` / :func:`decode_digest`,
  ``parallel/collectives._skew_sync_point``); only the broadcast
  result ever reaches :func:`adapt_plan`, so every process applies
  identical plans or none at all;
- the pure **adaptation plan** (:func:`adapt_plan` and its helpers) --
  given a method, world size, and digest, decide the re-rooted /
  rotated / pre-aggregating schedule. Pure functions on ints.

Everything is off by default behind ``rabit_skew_adapt``; with the
knob unset no caller consults this module on the collective path at
all.

Not ported yet: the poller's failover to a hot standby
(``rabit_tracker_standby``, which the engines refuse) and the
``resume`` half of its reconnect (``membership.present_resume``, whose
``resume`` command comes with the tracker's write-ahead log); its
reconnect re-announces the metrics endpoint (``live.reannounce``).
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, Optional

_ADAPT_ENV = "RABIT_SKEW_ADAPT"
_PREAGG_ENV = "RABIT_SKEW_PREAGG_MS"
_POLL_ENV = "RABIT_SKEW_POLL_MS"
_SYNC_ENV = "RABIT_SKEW_SYNC_ROUNDS"
_DIGEST_ENV = "RABIT_SKEW_DIGEST"
_TRACKER_ENV = "RABIT_SKEW_TRACKER"

_ON = ("1", "true", "yes", "on")

# Pre-aggregation pays for its extra fold traffic only when the hidden
# wait exceeds the transfer time it adds; 2 ms per MiB of payload is
# conservative against loopback TCP (~GB/s) and far below any real
# cross-host straggler this repo has measured (BUSY_SKEW_SIGNAL_S = 1s).
PREAGG_MS_PER_MIB_DEFAULT = 2.0

# Digest refresh cadence (worker-side background pull of the tracker's
# `skew` command). Floored like the metrics poll: the fetch runs off
# the dispatch path, but a sub-100ms poll would still hammer the
# tracker's accept loop for no fresher data than its own sweep cadence.
POLL_MS_DEFAULT = 2000
POLL_MS_FLOOR = 100

# Background-fetch socket budget and circuit breaker: a dead or wedged
# tracker costs at most FETCH_TIMEOUT_S per attempt on the poller
# thread (never the dispatch path), and after BREAKER_FAILURES
# consecutive misses the poller backs off to BREAKER_BACKOFF x the
# poll interval (one success re-arms it).
FETCH_TIMEOUT_S = 1.0
BREAKER_FAILURES = 3
BREAKER_BACKOFF = 10

# How many adapt-enabled dispatches run between fleet agreement
# boundaries. Static schedule state may only change AT a boundary:
# every process reaches its k-th adaptable dispatch in the same
# program order, so "counter % sync_rounds == 0" is a fleet-wide
# rendezvous without any extra control plane. 1 agrees before every
# collective (one tiny broadcast each); larger amortizes the sync at
# the cost of applying a new election up to N-1 rounds late.
SYNC_ROUNDS_DEFAULT = 32

# EWMA smoothing and laggard-flip hysteresis defaults. A challenger
# must beat the incumbent laggard's smoothed offset by HYSTERESIS_MS
# before the election flips — each flip changes the fleet's schedule,
# so flapping costs re-agreements, not just wrong rotations.
EWMA_ALPHA = 0.3
HYSTERESIS_MS = 5.0


def adapt_enabled() -> bool:
    """Whether skew adaptation may engage (``rabit_skew_adapt``,
    exported as ``RABIT_SKEW_ADAPT``; default off). Enabled alone does
    nothing — a digest naming a laggard must also be live."""
    return os.environ.get(_ADAPT_ENV, "").strip().lower() in _ON


def preagg_ms_per_mib() -> float:
    """Per-MiB skew threshold (ms) above which pre-aggregation engages
    (``rabit_skew_preagg_ms``); ``<= 0`` disables pre-aggregation while
    keeping rotation/re-rooting."""
    v = os.environ.get(_PREAGG_ENV)
    if not v:
        return PREAGG_MS_PER_MIB_DEFAULT
    try:
        return float(v)
    except ValueError:
        raise ValueError(
            f"{_PREAGG_ENV} must be a number (ms per MiB), got {v!r}")


def poll_interval_s() -> float:
    """Worker-side digest refresh interval in seconds
    (``rabit_skew_poll_ms``, floor {POLL_MS_FLOOR} ms)."""
    v = os.environ.get(_POLL_ENV)
    if not v:
        return POLL_MS_DEFAULT / 1000.0
    try:
        ms = int(v)
    except ValueError:
        raise ValueError(
            f"{_POLL_ENV} must be an integer (ms), got {v!r}")
    return max(ms, POLL_MS_FLOOR) / 1000.0


def sync_rounds() -> int:
    """Dispatches between fleet agreement boundaries
    (``rabit_skew_sync_rounds``, floor 1). Must be uniform across
    ranks — the boundary IS the cross-process rendezvous."""
    v = os.environ.get(_SYNC_ENV)
    if not v:
        return SYNC_ROUNDS_DEFAULT
    try:
        n = int(v)
    except ValueError:
        raise ValueError(
            f"{_SYNC_ENV} must be an integer (dispatch count), got {v!r}")
    return max(n, 1)


# --------------------------------------------------------------- estimator


class SkewEstimator:
    """EWMA of per-rank arrival offsets with a hysteretic laggard.

    ``update`` folds one observation (a ``{rank: offset_ms}`` map —
    one poll sweep's fleet view, or one stitched round's arrivals) into
    the smoothed state. The laggard only flips when a challenger's
    smoothed offset exceeds the incumbent's by ``hysteresis_ms``: the
    elected laggard decides the schedule downstream, so the election
    must be stable under round-to-round noise."""

    def __init__(self, alpha: float = EWMA_ALPHA,
                 hysteresis_ms: float = HYSTERESIS_MS):
        if not 0.0 < alpha <= 1.0:
            raise ValueError(f"alpha must be in (0, 1], got {alpha}")
        self.alpha = float(alpha)
        self.hysteresis_ms = float(hysteresis_ms)
        self._ewma: Dict[int, float] = {}
        self._laggard: Optional[int] = None

    def update(self, offsets_ms: Dict[int, float]) -> None:
        a = self.alpha
        for rank, off in offsets_ms.items():
            rank, off = int(rank), float(off)
            prev = self._ewma.get(rank)
            self._ewma[rank] = off if prev is None else \
                a * off + (1.0 - a) * prev
        if not self._ewma:
            return
        challenger = max(self._ewma, key=self._ewma.get)
        if self._laggard is None or self._laggard not in self._ewma:
            self._laggard = challenger
        elif challenger != self._laggard:
            if self._ewma[challenger] > (self._ewma[self._laggard]
                                         + self.hysteresis_ms):
                self._laggard = challenger

    @property
    def laggard(self) -> Optional[int]:
        return self._laggard

    def offsets_ms(self) -> Dict[int, float]:
        return dict(self._ewma)

    def skew_ms(self) -> float:
        """Smoothed spread between the latest and earliest rank."""
        if len(self._ewma) < 2:
            return 0.0
        vals = self._ewma.values()
        return max(vals) - min(vals)


class FleetElection:
    """Tracker-side: the ONE smoothed, hysteretic laggard election the
    whole fleet shares.

    Each ``/straggler`` poll sweep's raw digest folds through the EWMA
    estimator; the served digest carries the estimator's smoothed
    offsets and its hysteretic laggard (suppressed while the sweep's
    own verdict is a tie — a digest must never accuse a candidate the
    detector declined to name). The epoch bumps exactly when the
    served laggard changes, so workers' schedules are stable for as
    long as the election holds and a schedule switch is always
    attributable to an epoch transition. Smoothing lives HERE and not
    in the workers so every process receives the same election —
    per-process EWMAs fed by independently-timed fetches diverge, and
    divergent elections are divergent schedules (deadlock)."""

    def __init__(self, alpha: float = EWMA_ALPHA,
                 hysteresis_ms: float = HYSTERESIS_MS):
        self._est = SkewEstimator(alpha=alpha, hysteresis_ms=hysteresis_ms)
        self._epoch = 0
        self._laggard: Optional[int] = None

    @classmethod
    def seeded(cls, digest: Optional[dict]) -> "FleetElection":
        """Rebuild an election from its last served digest (what a
        tracker resumed from its write-ahead log needs): it must keep
        serving the SAME verdict and epoch the fleet already adopted — a
        cold election would restart the epoch at 1 and re-elect from
        empty state, flapping every worker's schedule across a restart
        that changed nothing about the fleet."""
        el = cls()
        d = parse_digest(digest)
        if d is None:
            return el
        el._est.update(d["offsets_ms"])
        el._est._laggard = d["laggard"]
        el._laggard = d["laggard"]
        el._epoch = max(1, d["epoch"])
        return el

    def fold(self, raw: Optional[dict]) -> Optional[dict]:
        """Fold one sweep's raw digest; returns the digest to serve
        (None if there is nothing to fold and never has been)."""
        if raw is not None:
            self._est.update(raw.get("offsets_ms") or {})
            lag = (self._est.laggard
                   if raw.get("laggard") is not None else None)
            if self._epoch == 0 or lag != self._laggard:
                self._laggard = lag
                self._epoch += 1
        if self._epoch == 0:
            return None
        return {"epoch": self._epoch,
                "offsets_ms": {str(r): round(v, 3) for r, v in
                               self._est.offsets_ms().items()},
                "laggard": self._laggard}

    def evict(self, rank: int) -> None:
        """Forget an evicted rank (elastic membership): its smoothed
        offset must not haunt the next world's election, and a served
        digest naming a rank that no longer exists would rotate the
        survivors around a ghost. Bumps the epoch when the served
        laggard WAS the evicted rank, so workers see the retraction as
        an ordinary election change."""
        rank = int(rank)
        ewma = self._est._ewma
        ewma.pop(rank, None)
        if self._est._laggard == rank:
            # immediate re-election, no hysteresis: the incumbent did
            # not lose a contest, it left the world
            self._est._laggard = (max(ewma, key=ewma.get)
                                  if ewma else None)
        if self._laggard == rank and self._epoch > 0:
            self._laggard = self._est._laggard
            self._epoch += 1


# ----------------------------------------------------------------- digest


def digest_from_snapshot(snap: dict, epoch: int = 0) -> Optional[dict]:
    """Tracker-side: one ``/straggler`` snapshot -> the compact skew
    digest the ``skew`` wire command serves.

    Offsets come from the counter heuristic's busy times: the rank the
    fleet waits FOR spends the least time inside collectives, so its
    estimated per-round arrival offset is ``(max busy - busy) /
    collectives``. ``laggard`` carries the snapshot's verdict verbatim —
    None on a tie (``signal=false``): a digest must never accuse a
    candidate the detector itself declined to name."""
    rows = [r for r in (snap or {}).get("ranks", [])
            if isinstance(r, dict) and r.get("rank") is not None]
    if not rows:
        return None
    busiest = max(float(r.get("busy_s", 0.0)) for r in rows)
    offsets = {}
    for r in rows:
        per_round = (busiest - float(r.get("busy_s", 0.0))) \
            / max(1, int(r.get("collectives", 0)))
        offsets[str(int(r["rank"]))] = round(per_round * 1e3, 3)
    laggard = snap.get("lagging_rank") if snap.get("signal") else None
    return {"epoch": int(epoch), "offsets_ms": offsets,
            "laggard": None if laggard is None else int(laggard)}


def parse_digest(doc) -> Optional[dict]:
    """Validate a wire/env digest into canonical int-keyed form, or
    None — a malformed digest disables adaptation rather than crashing
    the dispatch path."""
    if not isinstance(doc, dict):
        return None
    raw = doc.get("offsets_ms")
    if not isinstance(raw, dict):
        return None
    try:
        offsets = {int(k): float(v) for k, v in raw.items()}
        epoch = int(doc.get("epoch", 0))
        laggard = doc.get("laggard")
        laggard = None if laggard is None else int(laggard)
    except (TypeError, ValueError):
        return None
    if laggard is not None and laggard not in offsets:
        return None
    return {"epoch": epoch, "offsets_ms": offsets, "laggard": laggard}


def _fetch_skew_raw(host: str, port: int, task_id: str = "0",
                    timeout: float = FETCH_TIMEOUT_S):
    """``(reached, digest)``: ``reached`` is True when the wire round
    trip completed — even when the tracker served ``"{}"`` (no digest
    yet) or something unparseable. The split matters to the poller's
    circuit breaker: "the tracker is alive but has no verdict" must
    re-arm the breaker, while "the tracker is unreachable" must trip
    it."""
    from ..tracker.tracker import MAGIC, _recv_str, _send_str, _send_u32
    from ..utils import retry
    try:
        with retry.connect_with_retry(
                host, int(port), timeout=timeout,
                deadline=retry.Deadline(timeout)) as conn:
            _send_u32(conn, MAGIC)
            _send_str(conn, "skew")
            _send_str(conn, task_id)
            _send_u32(conn, 0)  # num_attempt (informational)
            raw = _recv_str(conn)
    except (OSError, ConnectionError, retry.RetryError):
        return False, None
    try:
        doc = json.loads(raw)
    except ValueError:
        return True, None
    from . import clock
    clock.merge_from_doc(doc)   # HLC piggyback
    return True, parse_digest(doc)


def fetch_skew(host: str, port: int, task_id: str = "0",
               timeout: float = FETCH_TIMEOUT_S) -> Optional[dict]:
    """Pull the tracker's current skew digest (``skew`` wire command,
    same rendezvous protocol as ``topo``). Best-effort: returns None
    instead of raising — a tracker that predates the command, went
    away, or has no digest yet just means no adaptation. The default
    timeout is deliberately tight: the only production caller is the
    :class:`SkewMonitor` poller thread, and a wedged tracker must not
    wedge the poller for whole seconds per attempt."""
    try:
        return _fetch_skew_raw(host, port, task_id, timeout)[1]
    except ValueError:
        return None


class SkewMonitor:
    """Process-global cache of the live fleet skew view.

    Sources, strongest first: a forced ``RABIT_SKEW_DIGEST`` env digest
    (tests, CI smoke — deterministic, no tracker needed), then the
    tracker's ``skew`` command via ``RABIT_SKEW_TRACKER=host:port``
    (exported by the engine at init), refreshed by a daemon poller
    thread every ``rabit_skew_poll_ms`` — :meth:`current` only ever
    reads the cache, so a slow or dead tracker can never stall a
    dispatch behind a socket timeout (the poller itself backs off
    ``BREAKER_BACKOFF``x after ``BREAKER_FAILURES`` straight misses).

    The tracker's digest is applied VERBATIM — smoothing and the
    hysteretic election are fleet-global, tracker-side state
    (:class:`FleetElection`). Worker-side, :meth:`current` is still
    only this process's *candidate*: what dispatch may act on is
    :meth:`applied`, the digest the whole fleet adopted at the last
    agreement boundary (``parallel/collectives._skew_sync_point``)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._digest: Optional[dict] = None
        self._forced_raw: Optional[str] = None
        self._applied: Optional[dict] = None
        self._synced = False
        self._poller: Optional[threading.Thread] = None
        self._stop = threading.Event()
        # consecutive failed round trips (the circuit breaker's state;
        # held on the instance so tests and `breaker_state` can see it)
        self._misses = 0

    def observe(self, doc) -> Optional[dict]:
        """Cache one digest verbatim; returns the current candidate."""
        d = parse_digest(doc)
        with self._lock:
            if d is not None:
                self._digest = d
            return self._digest

    def current(self) -> Optional[dict]:
        """This process's candidate digest. Never blocks on a socket."""
        forced = os.environ.get(_DIGEST_ENV)
        if forced:
            with self._lock:
                changed = forced != self._forced_raw
                if changed:
                    self._forced_raw = forced
            if changed:
                try:
                    doc = json.loads(forced)
                except ValueError:
                    doc = None
                with self._lock:
                    self._digest = parse_digest(doc)
            with self._lock:
                return self._digest
        with self._lock:
            self._forced_raw = None
        if ":" in os.environ.get(_TRACKER_ENV, ""):
            self._ensure_poller()
        with self._lock:
            return self._digest

    def applied(self) -> Optional[dict]:
        """The digest the fleet agreed to act on.

        Before the first agreement boundary only a forced env digest is
        eligible (identical on every process by the launch contract —
        and reconciled anyway at the first boundary); a tracker-fetched
        candidate is per-process opinion and must pass through the sync
        broadcast before any dispatch may key a schedule on it."""
        with self._lock:
            if self._synced:
                return self._applied
        if os.environ.get(_DIGEST_ENV):
            return self.current()
        return None

    def set_applied(self, digest: Optional[dict]) -> None:
        """Adopt the fleet-agreed digest (sync boundaries only)."""
        with self._lock:
            self._applied = digest
            self._synced = True

    # -- background refresh ------------------------------------------------
    def _ensure_poller(self) -> None:
        with self._lock:
            if self._poller is not None and self._poller.is_alive():
                return
            self._poller = threading.Thread(
                target=self._poll_loop, name="rabit-skew-poll", daemon=True)
            self._poller.start()

    def breaker_state(self) -> dict:
        """Circuit-breaker introspection (tests, diagnostics)."""
        with self._lock:
            misses = self._misses
        return {"misses": misses,
                "tripped": misses >= BREAKER_FAILURES}

    def _on_reconnect(self) -> None:
        """Dead->alive transition: the tracker just reached may be a
        RESUMED incarnation that replayed its journal -- re-present this
        worker's identity over the ``resume`` handshake and re-announce
        its metrics endpoint, so the new incarnation's world view
        converges without any re-registration. Best-effort: the poller
        must keep polling whatever happens here."""
        from ..tracker import membership
        from . import live
        try:
            membership.present_resume()
        except Exception:  # noqa: BLE001 - reconnect is best-effort
            pass
        try:
            live.reannounce()
        except Exception:  # noqa: BLE001 - reconnect is best-effort
            pass

    def _poll_loop(self) -> None:
        while True:
            interval = poll_interval_s()
            with self._lock:
                tripped = self._misses >= BREAKER_FAILURES
            if tripped:
                interval *= BREAKER_BACKOFF
            if self._stop.wait(interval):
                return
            addr = os.environ.get(_TRACKER_ENV, "")
            if ":" not in addr:
                continue
            host, _, port = addr.rpartition(":")
            try:
                reached, d = _fetch_skew_raw(host, int(port))
            except ValueError:
                reached, d = False, None
            if reached:
                # the breaker re-arms on the first successful ROUND
                # TRIP, not the first parsed digest: a tracker serves
                # "{}" until its first poll sweep, and that must not
                # count as a miss
                with self._lock:
                    was_tripped = self._misses >= BREAKER_FAILURES
                    self._misses = 0
                if was_tripped:
                    self._on_reconnect()
                if d is not None:
                    self.observe(d)
            else:
                with self._lock:
                    self._misses += 1


_monitor = SkewMonitor()


def monitor() -> SkewMonitor:
    return _monitor


def reset_monitor() -> None:
    """Drop all cached/agreed state (tests; also correct after a
    recovery epoch where ranks may have been reassigned)."""
    global _monitor, _last_applied, _dispatch_round
    _monitor._stop.set()
    _monitor = SkewMonitor()
    _last_applied = None
    _dispatch_round = 0


# ------------------------------------------------------ agreement boundary
#
# The schedule (adapted method / groups) must be the same on every
# process of a group: all processes MUST derive it from the same digest
# or they post different exchanges for the same round and deadlock. The
# rendezvous is program order itself — every process counts its
# adapt-enabled dispatches identically, so "counter hits a sync_rounds
# boundary" fires on all of them at the same collective, where
# parallel/collectives broadcasts group rank 0's candidate digest over
# the process group and every process adopts the result.

_dispatch_round = 0


def sync_due() -> bool:
    """Advance the dispatch counter; True when this dispatch is a fleet
    agreement boundary (always true for the first adaptable dispatch
    after a reset, so adaptation never acts on un-agreed state)."""
    global _dispatch_round
    due = _dispatch_round % sync_rounds() == 0
    _dispatch_round += 1
    return due


def reset_sync() -> None:
    """Re-arm the agreement boundary (world formation / recovery): a
    re-formed world replays collectives from a common point, so every
    process restarts the counter together, and the first dispatch of
    the new epoch re-agrees before anything adapts. Rank assignments
    may have changed, so the previously agreed digest is dropped."""
    global _dispatch_round
    _dispatch_round = 0
    with _monitor._lock:
        _monitor._applied = None
        _monitor._synced = False


def epoch_reset(world: int) -> None:
    """Membership epoch hook: every module
    holding world-size-derived state must drop it when the registration
    epoch changes. For the skew plane that is the cached/agreed digest
    (its laggard and offsets are OLD-world ranks — a rotation keyed on
    them would permute the new world around a ghost), the applied tag,
    and the dispatch counter that defines the agreement rendezvous."""
    del world  # only the fact of the transition matters here
    reset_sync()
    note_applied(None)
    with _monitor._lock:
        _monitor._digest = None


# A digest rides the agreement broadcast as a flat vector of floats —
# fixed shape, so the broadcast program itself is digest-independent.
# Only the plan-relevant facts travel: validity, epoch, laggard, the
# elected root, and the smoothed spread; decode re-synthesizes a
# canonical two-entry digest for which laggard_of / earliest_of /
# skew_ms_of reproduce the encoded elections exactly.
SYNC_VEC_LEN = 5


def encode_digest(digest: Optional[dict], world: int):
    """Canonical digest -> length-``SYNC_VEC_LEN`` float tuple."""
    d = parse_digest(digest)
    if d is None:
        return (0.0, 0.0, -1.0, -1.0, 0.0)
    lag = d["laggard"]
    root = earliest_of(d, world) if lag is not None else -1
    return (1.0, float(d["epoch"]),
            -1.0 if lag is None else float(lag),
            float(root), max(skew_ms_of(d), 0.0))


def decode_digest(vec) -> Optional[dict]:
    """Inverse of :func:`encode_digest` (tolerates float32 transport)."""
    vec = [float(v) for v in vec]
    if len(vec) != SYNC_VEC_LEN or vec[0] < 0.5:
        return None
    epoch, lag, root = (int(round(v)) for v in vec[1:4])
    if lag < 0:
        return {"epoch": epoch, "offsets_ms": {}, "laggard": None}
    offsets = {lag: max(vec[4], 0.0)}
    if root >= 0 and root != lag:
        offsets[root] = 0.0
    return {"epoch": epoch, "offsets_ms": offsets, "laggard": lag}


# The plan the most recent device_allreduce / device_hier_allreduce on
# this host applied (``"<kind>@<laggard>"``) or None. The engines stamp
# it into their round-carrying spans AFTER the device call, so
# cross-rank stitching (telemetry/crossrank.py) can show which rounds
# ran adapted; collectives write it on every call (None clears stale
# state when adaptation disengages).
_last_applied: Optional[str] = None


def note_applied(tag: Optional[str]) -> None:
    global _last_applied
    _last_applied = tag


def last_applied() -> Optional[str]:
    return _last_applied


# ------------------------------------------------------- adaptation plans


def laggard_of(digest) -> Optional[int]:
    return None if not digest else digest.get("laggard")


def earliest_of(digest, world: int) -> int:
    """The earliest-arrival rank (minimum smoothed offset) — the root
    re-rooted trees and pre-aggregation folds elect. Falls back to the
    lowest non-laggard rank when offsets are missing."""
    lag = laggard_of(digest)
    offs = (digest or {}).get("offsets_ms") or {}
    cands = [(off, r) for r, off in offs.items()
             if r != lag and 0 <= int(r) < world]
    if cands:
        return int(min(cands)[1])
    return 1 if lag == 0 else 0


def skew_ms_of(digest) -> float:
    offs = (digest or {}).get("offsets_ms") or {}
    if len(offs) < 2:
        return 0.0
    return max(offs.values()) - min(offs.values())


def rotation_order(world: int, laggard: int):
    """Logical rank order with the laggard rotated to the LAST slot —
    it then owns the final position of every ring walk, so its late
    contribution blocks the fewest downstream steps on an async
    fabric."""
    if not 0 <= laggard < world:
        raise ValueError(f"laggard {laggard} outside world {world}")
    return tuple((laggard + 1 + i) % world for i in range(world))


def rotation_groups(world: int, laggard: int):
    """The rotated order as a single-group ``groups`` tuple — the same
    argument the grouped ring/swing schedules already take, so rotation
    rides existing machinery."""
    return (rotation_order(world, laggard),)


def demote_delegate(groups, laggard: int):
    """Hier adaptation: move a lagging rank to the LAST slot of its
    host group. Slot order defines both the intra-host ring position
    and which inter-host slot ring the rank serves; the first slot is
    the delegate ring, so a lagging delegate is demoted to the
    tail slot and a prompt housemate takes over. Other groups are
    untouched (group order and membership are preserved)."""
    out = []
    for grp in groups:
        grp = tuple(grp)
        if laggard in grp and grp[-1] != laggard:
            grp = tuple(r for r in grp if r != laggard) + (laggard,)
        out.append(grp)
    return tuple(out)


def preagg_groups(world: int, laggard: int, root: Optional[int] = None):
    """Membership encoding for the pre-aggregation schedule: the
    arrived subgroup and the laggard as a singleton — hashable, so it
    rides the same static ``groups`` slot as the rotations.

    ``root`` (the elected earliest-arrival rank) is placed FIRST in the
    early tuple: ``preagg_allreduce`` folds at ``early[0]``, so this is
    where the election becomes load-bearing. Without ``root`` the early
    tuple keeps flat order (``early[0]`` = lowest non-laggard rank)."""
    if not 0 <= laggard < world:
        raise ValueError(f"laggard {laggard} outside world {world}")
    early = tuple(r for r in range(world) if r != laggard)
    if root is not None:
        if root == laggard or not 0 <= root < world:
            raise ValueError(
                f"preagg root {root} must be a non-laggard rank inside "
                f"world {world} (laggard {laggard})")
        early = (root,) + tuple(r for r in early if r != root)
    return (early, (laggard,))


def adapt_plan(method: str, world: int, nbytes: int, op_name: str,
               groups=None, digest=None) -> Optional[dict]:
    """The pure adaptation decision for one dispatch.

    Returns None (run the flat schedule unchanged) unless the digest
    names a laggard inside this world. Otherwise:

    - measured skew above ``rabit_skew_preagg_ms`` per MiB and a SUM
      payload -> ``preagg`` (early subgroup reduces while waiting, the
      laggard's contribution folds in on arrival; the elected root
      leads the early tuple, so ``preagg_allreduce``'s ``early[0]``
      fold root IS the earliest-arrival rank);
    - ``tree`` -> ``tree_reroot``: laggard to a leaf, earliest arrival
      to the root (the library's reduction, NCCL's or gloo's, is
      rank-symmetric, so this records the election; the rooted fold
      inside ``preagg`` is where the root is load-bearing);
    - ``hier`` -> ``hier_demote`` via :func:`demote_delegate`;
    - ring/bidir/swing -> ``rotate`` via :func:`rotation_groups`.

    Every plan only permutes the logical rank order or changes which
    schedule runs — never the contributing rank set (property-tested).
    """
    lag = laggard_of(digest)
    if lag is None or not 0 <= lag < world or world < 2:
        return None
    root = earliest_of(digest, world)
    base = {"laggard": lag, "root": root, "epoch": digest.get("epoch", 0)}
    thresh = preagg_ms_per_mib()
    if (op_name == "sum" and world >= 2 and thresh > 0
            and skew_ms_of(digest) >= thresh * max(nbytes, 1) / (1 << 20)
            and method in ("tree", "ring", "bidir", "swing")):
        return dict(base, kind="preagg", method="preagg",
                    groups=preagg_groups(world, lag, root=root))
    if method == "tree":
        return dict(base, kind="tree_reroot", method="tree", groups=None)
    if method == "hier":
        if not groups:
            return None
        return dict(base, kind="hier_demote", method="hier",
                    groups=demote_delegate(groups, lag))
    if method in ("ring", "bidir", "swing"):
        return dict(base, kind="rotate", method=method,
                    groups=rotation_groups(world, lag))
    return None
