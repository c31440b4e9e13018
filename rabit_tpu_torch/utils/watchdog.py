"""Collective watchdog: deadlines on collectives and bootstrap phases,
the port's copy of ``rabit_tpu/utils/watchdog.py`` (its constants, rungs,
counters, spans, events and flight notes).

A dead peer crashes its sockets (or fails its NCCL collective) and the
robust engine recovers; a *hung* peer (a livelocked or stopped process,
a stalled link, a partition that drops packets without resetting
connections) leaves every survivor blocked in a receive or a device
wait with no error to react to -- the one failure mode the epoch
machinery cannot see. The watchdog turns that stall into a detected
failure: each guarded phase registers a deadline scaled by payload size
with a floor (``rabit_deadline_ms`` + ``rabit_deadline_ms_per_mb``); a
monitor thread escalates expiry up a three-rung ladder (``exit 86`` is
the LAST resort, reached only when in-process recovery is itself
stuck):

1. **retry** (at expiry): record a ``watchdog.expired`` telemetry
   counter and a ``recovery``-provenance span carrying the
   stall-so-far, log a warning, and fire the guard's ``on_expire``
   hook -- the robust engine registers the torch data plane's world
   teardown here (an abort of its communicators), which errors the
   blocked collective so the C++ plane re-runs the round.
2. **reform** (one more deadline later, floor 0.5 s): the retry rung
   did not unstick the phase, so fire the guard's ``on_reform`` hook --
   the native engine registers ``RbtInterruptEx`` here, which bails the
   blocked socket collective out into the robust layer's global
   re-formation without exiting. With ``rabit_watchdog_abort=0`` the
   ladder STOPS here: the stall is recorded as a ``watchdog.stall``
   flight note and the guard is dropped, instead of spinning silently
   forever.
3. **abort** (another deadline later): if the phase is STILL running --
   recovery itself is stuck -- exit the process with code
   :data:`WATCHDOG_EXIT_CODE`. To every peer that is a link reset; to
   the launcher it is a respawn; the epoch advances and the replay
   machinery does the rest.

The monitor is a Python thread: a rung fires while the stalled thread
waits with the GIL released (a socket receive in the native core, a
``work.wait()``, a device-to-host copy or ``torch.cuda.synchronize``).

Deadlines are **opt-in** (``rabit_deadline_ms=0`` disables): a watchdog
mis-sized for the slowest healthy collective converts stragglers into
crashes, so the floor must be chosen per deployment, and below the
process group's own timeouts (``engine/dataplane.py::TIMEOUT_S``; NCCL's
default for ``TorchEngine``'s group), which would otherwise act first.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

from . import log

# distinct from the mock engine's scripted kill (255) so launch logs and
# chaos tests can tell a watchdog escalation from a scheduled death
WATCHDOG_EXIT_CODE = 86

DEFAULT_FLOOR_MS = 0          # 0 = watchdog disabled
DEFAULT_MS_PER_MB = 100.0     # 10 MiB/s worst-case link assumption
_MIN_GRACE_S = 0.5


def scale_deadline_s(nbytes: int, floor_ms: float,
                     ms_per_mb: float = DEFAULT_MS_PER_MB) -> float:
    """Deadline for one phase: payload-proportional with a floor, so a
    256 MiB allreduce is not policed at the 8-byte consensus word's
    budget. <= 0 floor disables (returns 0)."""
    if floor_ms <= 0:
        return 0.0
    return max(floor_ms, (nbytes / (1 << 20)) * ms_per_mb) / 1e3


class _Guard:
    """One armed phase. Context manager; disarms on exit."""

    __slots__ = ("_wd", "name", "nbytes", "deadline_s", "on_expire",
                 "on_reform", "t0", "expired", "reformed", "done")

    def __init__(self, wd: "Watchdog", name: str, nbytes: int,
                 deadline_s: float,
                 on_expire: Optional[Callable[[], None]],
                 on_reform: Optional[Callable[[], None]] = None):
        self._wd = wd
        self.name = name
        self.nbytes = nbytes
        self.deadline_s = deadline_s
        self.on_expire = on_expire
        self.on_reform = on_reform
        self.expired = False
        self.reformed = False
        self.done = False

    def __enter__(self):
        self.t0 = time.monotonic()
        self._wd._arm(self)
        return self

    def __exit__(self, *exc):
        self._wd._disarm(self)
        return False


class _NullGuard:
    """Returned when the watchdog is disabled."""

    expired = False
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NULL_GUARD = _NullGuard()


class Watchdog:
    """Deadline monitor. One instance per engine; ``guard()`` wraps each
    collective / bootstrap phase. The monitor thread is started lazily
    on the first armed guard and is a daemon — it never blocks process
    exit."""

    def __init__(self, floor_ms: float = DEFAULT_FLOOR_MS,
                 ms_per_mb: float = DEFAULT_MS_PER_MB,
                 abort: bool = True,
                 abort_fn: Optional[Callable[[int], None]] = None):
        self.floor_ms = float(floor_ms)
        self.ms_per_mb = float(ms_per_mb)
        self.abort = abort
        # test seam: defaults to os._exit — sys.exit would only unwind
        # the monitor thread while the stalled thread stays stalled
        self._abort_fn = abort_fn or os._exit
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._guards: list = []
        self._thread: Optional[threading.Thread] = None
        self._stop = False
        self.expired_total = 0

    @classmethod
    def from_config(cls, cfg) -> "Watchdog":
        """Build from engine config (``rabit_deadline_ms``,
        ``rabit_deadline_ms_per_mb``, ``rabit_watchdog_abort``)."""
        return cls(
            floor_ms=float(cfg.get("rabit_deadline_ms", 0) or 0),
            ms_per_mb=float(cfg.get("rabit_deadline_ms_per_mb",
                                    DEFAULT_MS_PER_MB) or DEFAULT_MS_PER_MB),
            abort=cfg.get_bool("rabit_watchdog_abort", True))

    @property
    def enabled(self) -> bool:
        return self.floor_ms > 0

    def guard(self, name: str, nbytes: int = 0,
              deadline_s: Optional[float] = None,
              on_expire: Optional[Callable[[], None]] = None,
              on_reform: Optional[Callable[[], None]] = None):
        """Deadline context for one phase. Disabled watchdogs hand back
        a shared no-op guard (zero threads, zero locking).

        ``on_expire`` fires at the retry rung (deadline expiry);
        ``on_reform`` one deadline later, when the retry did not
        unstick the phase — the hook should trigger global world
        re-formation (e.g. ``RbtInterrupt``) without exiting."""
        if deadline_s is None:
            deadline_s = scale_deadline_s(nbytes, self.floor_ms,
                                          self.ms_per_mb)
        if deadline_s <= 0:
            return NULL_GUARD
        return _Guard(self, name, nbytes, deadline_s, on_expire, on_reform)

    def close(self) -> None:
        with self._cv:
            self._stop = True
            self._cv.notify_all()

    # -- monitor ----------------------------------------------------------
    def _arm(self, g: _Guard) -> None:
        with self._cv:
            self._guards.append(g)
            if self._thread is None or not self._thread.is_alive():
                self._stop = False
                self._thread = threading.Thread(
                    target=self._monitor, name="rabit-watchdog", daemon=True)
                self._thread.start()
            self._cv.notify_all()

    def _disarm(self, g: _Guard) -> None:
        with self._cv:
            g.done = True
            try:
                self._guards.remove(g)
            except ValueError:
                pass
            self._cv.notify_all()

    def _monitor(self) -> None:
        while True:
            with self._cv:
                if self._stop:
                    return
                now = time.monotonic()
                wake = None
                fire = None
                reform = None
                kill = None
                for g in self._guards:
                    expiry = g.t0 + g.deadline_s
                    gap = max(_MIN_GRACE_S, g.deadline_s)
                    reform_at = expiry + gap
                    abort_at = expiry + 2 * gap
                    if not g.expired and now >= expiry:
                        fire = g
                        break
                    if g.expired and not g.reformed and now >= reform_at:
                        reform = g
                        break
                    if g.reformed and self.abort and now >= abort_at:
                        kill = g
                        break
                    if not g.expired:
                        nxt = expiry
                    elif not g.reformed:
                        nxt = reform_at
                    elif self.abort:
                        nxt = abort_at
                    else:
                        nxt = None  # ladder stopped at reform (abort=0)
                    if nxt is not None:
                        wake = nxt if wake is None else min(wake, nxt)
                if fire is None and reform is None and kill is None:
                    self._cv.wait(None if wake is None
                                  else max(0.01, wake - now))
                    continue
                if fire is not None:
                    fire.expired = True
                    self.expired_total += 1
                elif reform is not None:
                    reform.reformed = True
            # escalation runs OUTSIDE the lock: on_expire/on_reform may
            # take arbitrary time (device-world teardown) and new guards
            # must stay armable meanwhile
            if fire is not None:
                self._escalate(fire)
            elif reform is not None:
                self._reform(reform)
            elif kill is not None:
                self._abort(kill)
                return

    def _escalate(self, g: _Guard) -> None:
        stalled = time.monotonic() - g.t0
        from .. import telemetry
        telemetry.count("watchdog.expired", nbytes=g.nbytes, op=g.name,
                        provenance="recovery")
        telemetry.record_span("watchdog.stall", stalled, nbytes=g.nbytes,
                              op=g.name, provenance="recovery")
        from ..telemetry import events, flight
        flight.note("watchdog_expired",
                    f"{g.name} stalled {stalled:.1f}s "
                    f"(deadline {g.deadline_s:.1f}s)")
        events.emit("watchdog.retry",
                    f"{g.name} stalled {stalled:.1f}s "
                    f"(deadline {g.deadline_s:.1f}s)")
        log.log_warn("watchdog: %s stalled %.1fs past its %.1fs deadline; "
                     "escalating to in-collective retry (reform%s on "
                     "further stall)", g.name, stalled, g.deadline_s,
                     ", then abort" if self.abort else "")
        if g.on_expire is not None:
            try:
                g.on_expire()
            except Exception as e:  # noqa: BLE001 - escalation best-effort
                log.log_warn("watchdog: on_expire for %s failed: %s",
                             g.name, e)

    def _reform(self, g: _Guard) -> None:
        stalled = time.monotonic() - g.t0
        from .. import telemetry
        from ..telemetry import events
        telemetry.count("watchdog.reform", nbytes=g.nbytes, op=g.name,
                        provenance="recovery")
        events.emit("watchdog.reform",
                    f"{g.name} stalled {stalled:.1f}s past retry rung")
        log.log_warn("watchdog: %s still stalled %.1fs after retry rung; "
                     "escalating to world re-formation%s", g.name, stalled,
                     " (abort on further stall)" if self.abort else "")
        if g.on_reform is not None:
            try:
                g.on_reform()
            except Exception as e:  # noqa: BLE001 - escalation best-effort
                log.log_warn("watchdog: on_reform for %s failed: %s",
                             g.name, e)
        if not self.abort:
            # ladder top with abort opted out: record the stall in the
            # flight recorder and stop tracking the guard — the
            # pre-ladder behavior was to keep spinning silently forever
            from ..telemetry import flight
            flight.note("watchdog.stall",
                        f"{g.name} stalled {stalled:.1f}s past reform rung; "
                        f"rabit_watchdog_abort=0, ladder stops here")
            self._disarm(g)

    def _abort(self, g: _Guard) -> None:
        from .. import telemetry
        telemetry.count("watchdog.abort", nbytes=g.nbytes, op=g.name,
                        provenance="recovery")
        log.log_warn(
            "watchdog: %s still stalled after escalation; aborting process "
            "(exit %d) so the launcher respawns and the epoch advances",
            g.name, WATCHDOG_EXIT_CODE)
        # the flight recorder (if installed) gets the last word before
        # os._exit: ring buffer, recent events, and every thread's stack
        # — including the one stalled inside the C++ recv we are about
        # to kill the process over
        from ..telemetry import events, flight
        events.emit("watchdog.abort",
                    f"{g.name} ({g.nbytes} bytes) stalled past grace")
        flight.trigger("watchdog_abort",
                       f"{g.name} ({g.nbytes} bytes) stalled past grace")
        self._abort_fn(WATCHDOG_EXIT_CODE)
