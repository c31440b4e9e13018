"""Crash flight recorder: leave evidence when a run dies. The port's
copy of ``rabit_tpu/telemetry/flight.py``, with its schema id, bundle
fields and file names, so the JAX package's readers
(``tools/trace_report.py``, ``crossrank.extract_rounds``) take the port's
bundles as they are.

A world can die a dozen ways -- watchdog expiry, grace abort (exit 86),
an uncaught engine exception, a SIGTERM from the launcher -- and each
would take the telemetry ring buffer down with it. With
``rabit_flight_dir`` configured, each of those paths dumps a
schema-versioned bundle (``rabit_tpu.flight_record/v1``) containing:

- the telemetry ring buffer + counters (``Recorder.snapshot()``, round
  ids included -- two ranks' bundles stitch into per-round arrival-skew
  attribution);
- the last-N wire/watchdog/recovery events noted via :func:`note` (the
  watchdog's escalation path and the data plane's retries feed this
  ring);
- per-thread stacks via ``faulthandler`` -- the "where was everyone
  blocked" answer for stalls Python cannot unwind (a thread inside an
  NCCL wait or the native core's receive);
- the engine's config snapshot, so the bundle is self-describing.

Off by default; installing hooks costs one ``sys.excepthook`` wrap and
(best-effort, main thread only) one SIGTERM handler. Dumps are wholly
best-effort: a failing flight dump must never mask the original death.
``rabit_flight_keep`` bounds retained bundles per rank.
"""

from __future__ import annotations

import collections
import faulthandler
import json
import os
import signal
import sys
import tempfile
import threading
import time
from typing import List, Optional

from .schema import make_header, timestamp_utc

FLIGHT_KIND = "flight_record"
DEFAULT_KEEP = 4
_EVENTS_MAX = 256

_events: collections.deque = collections.deque(maxlen=_EVENTS_MAX)
_events_lock = threading.Lock()
_installed: Optional["FlightRecorder"] = None


def note(kind: str, detail: str = "") -> None:
    """Record one wire/chaos/watchdog event into the flight ring.
    Always cheap (bounded deque append); captured in the next dump."""
    with _events_lock:
        _events.append({"t_unix": time.time(), "kind": kind,
                        "detail": detail})


def recent_events() -> List[dict]:
    with _events_lock:
        return list(_events)


def trigger(reason: str, detail: str = "") -> Optional[str]:
    """Dump a bundle through the installed recorder (no-op without
    one). The watchdog's abort path calls this before exiting 86."""
    fr = _installed
    if fr is None:
        return None
    return fr.dump(reason, detail)


def installed() -> Optional["FlightRecorder"]:
    return _installed


def _thread_stacks() -> str:
    """All-thread stacks via faulthandler (needs a real fd)."""
    try:
        with tempfile.TemporaryFile(mode="w+") as f:
            faulthandler.dump_traceback(file=f, all_threads=True)
            f.seek(0)
            return f.read()
    except Exception as e:  # noqa: BLE001 - stacks are nice-to-have
        return f"<stack capture failed: {e}>"


class FlightRecorder:
    """Bundle writer + process hooks for one engine lifetime."""

    def __init__(self, out_dir: str, rank: int = -1,
                 keep: int = DEFAULT_KEEP,
                 config_args: Optional[List[str]] = None):
        self.out_dir = out_dir
        self.rank = rank
        self.keep = max(1, int(keep))
        self.config_args = list(config_args or [])
        self._seq = 0
        self._lock = threading.Lock()
        self._prev_excepthook = None
        self._prev_sigterm = None
        self._hooked = False

    @classmethod
    def from_config(cls, cfg, rank: int = -1
                    ) -> Optional["FlightRecorder"]:
        """Build + install from engine config (``rabit_flight_dir``,
        ``rabit_flight_keep``); None when unconfigured."""
        out_dir = cfg.get("rabit_flight_dir")
        if not out_dir:
            return None
        fr = cls(out_dir, rank=rank,
                 keep=cfg.get_int("rabit_flight_keep", DEFAULT_KEEP),
                 config_args=cfg.as_args())
        fr.install()
        return fr

    # -- hooks ------------------------------------------------------------
    def install(self) -> "FlightRecorder":
        global _installed
        _installed = self
        if self._hooked:
            return self
        self._hooked = True
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._on_exception
        try:
            # main thread only; a worker embedding the engine on a side
            # thread simply skips the SIGTERM hook
            self._prev_sigterm = signal.signal(signal.SIGTERM,
                                               self._on_sigterm)
        except ValueError:
            self._prev_sigterm = None
        return self

    def uninstall(self) -> None:
        global _installed
        if _installed is self:
            _installed = None
        if not self._hooked:
            return
        self._hooked = False
        if sys.excepthook is self._on_exception:
            sys.excepthook = self._prev_excepthook or sys.__excepthook__
        if self._prev_sigterm is not None:
            try:
                if signal.getsignal(signal.SIGTERM) is self._on_sigterm:
                    signal.signal(signal.SIGTERM, self._prev_sigterm)
            except ValueError:
                pass

    def _on_exception(self, etype, value, tb) -> None:
        self.dump("exception", f"{etype.__name__}: {value}")
        prev = self._prev_excepthook or sys.__excepthook__
        prev(etype, value, tb)

    def _on_sigterm(self, signum, frame) -> None:
        self.dump("sigterm")
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
            return
        # restore the previous disposition and re-raise so the process
        # still dies by SIGTERM (exit status visible to the launcher)
        try:
            signal.signal(signal.SIGTERM,
                          prev if prev is not None else signal.SIG_DFL)
        except ValueError:
            pass
        os.kill(os.getpid(), signal.SIGTERM)

    # -- dumping ----------------------------------------------------------
    def dump(self, reason: str, detail: str = "") -> Optional[str]:
        """Write one ``flight_record/v1`` bundle; returns the path or
        None (never raises — the dump must not mask the death that
        triggered it)."""
        try:
            return self._dump(reason, detail)
        except Exception:  # noqa: BLE001 - best-effort by contract
            return None

    def _dump(self, reason: str, detail: str) -> str:
        from . import snapshot  # late: recorder state at dump time
        with self._lock:
            self._seq += 1
            seq = self._seq
        snap = snapshot()
        doc = make_header(FLIGHT_KIND)
        doc["reason"] = reason
        doc["detail"] = detail
        doc["rank"] = self.rank
        doc["pid"] = os.getpid()
        doc["t_base_unix"] = snap.get("t_base_unix", 0.0)
        doc["config"] = self.config_args
        doc["telemetry"] = snap
        doc["events"] = recent_events()
        doc["stacks"] = _thread_stacks()
        os.makedirs(self.out_dir, exist_ok=True)
        tag = f"rank{self.rank}" if self.rank >= 0 else "local"
        name = (f"flight_{timestamp_utc()}_{seq:03d}_{tag}_"
                f"{reason}.json")
        path = os.path.join(self.out_dir, name)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        os.replace(tmp, path)
        self._prune(tag)
        return path

    def _prune(self, tag: str) -> None:
        """Keep the newest ``keep`` bundles for this rank (filenames
        sort by timestamp then sequence)."""
        try:
            mine = sorted(
                f for f in os.listdir(self.out_dir)
                if f.startswith("flight_") and f.endswith(".json")
                and f"_{tag}_" in f)
        except OSError:
            return
        for stale in mine[:-self.keep]:
            try:
                os.remove(os.path.join(self.out_dir, stale))
            except OSError:
                pass
