"""Hybrid logical clocks (HLC) for causal cross-rank ordering: the
port's own copy of ``rabit_tpu/telemetry/clock.py``.

Wall clocks across hosts drift, so "which event happened first" cannot
be answered from wall time alone. An HLC (Kulkarni et al., "Logical
Physical Clocks") keeps a (wall_ms, logical, node) triple per process:

- ``tick()`` stamps a local or send event: wall time when it moved
  forward, else the logical counter increments — stamps are strictly
  monotonic per process even when the wall clock stalls or steps back;
- ``merge(remote)`` folds a received stamp in, so causality propagates
  across processes: anything stamped after a merge orders after
  everything the sender had seen.

Stamps are plain JSON dicts ``{"ms": int, "lc": int, "node": str}``
and totally ordered by :func:`key` — (ms, lc, node).

Process-global singleton, gated like the rest of the telemetry plane:
``RABIT_EVENTS=1`` (or ``configure(cfg)`` with ``rabit_events``)
enables stamping; when disabled every hook returns ``None`` and no
payload grows a field. Stdlib-only: the tracker imports it without
torch.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Optional

_ENABLE_ENV = "RABIT_EVENTS"


def _env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in (
        "1", "true", "yes", "on")


class HLC:
    """One hybrid logical clock. Thread-safe."""

    def __init__(self, node_id: str = "", wall_ms=None):
        self.node = str(node_id) or f"pid{os.getpid()}"
        # injectable wall source (tests drive skewed/stalled clocks)
        self._wall_ms = wall_ms or (lambda: int(time.time() * 1e3))
        self._lock = threading.Lock()
        self._ms = 0
        self._lc = 0

    def tick(self) -> dict:
        """Stamp a local/send event; strictly monotonic."""
        with self._lock:
            wall = int(self._wall_ms())
            if wall > self._ms:
                self._ms, self._lc = wall, 0
            else:
                self._lc += 1
            return {"ms": self._ms, "lc": self._lc, "node": self.node}

    def merge(self, remote) -> dict:
        """Fold a received stamp in and stamp the receive event; the
        result orders after both the remote stamp and every prior local
        stamp. Malformed input degrades to a plain tick."""
        try:
            rms, rlc = int(remote["ms"]), int(remote["lc"])
        except (TypeError, KeyError, ValueError):
            return self.tick()
        with self._lock:
            wall = int(self._wall_ms())
            ms = max(self._ms, rms, wall)
            if ms == self._ms == rms:
                lc = max(self._lc, rlc) + 1
            elif ms == self._ms:
                lc = self._lc + 1
            elif ms == rms:
                lc = rlc + 1
            else:
                lc = 0
            self._ms, self._lc = ms, lc
            return {"ms": ms, "lc": lc, "node": self.node}

    def peek(self) -> dict:
        """Current stamp without advancing (diagnostics only)."""
        with self._lock:
            return {"ms": self._ms, "lc": self._lc, "node": self.node}


def key(stamp) -> tuple:
    """Total-order sort key for a stamp dict; ``None``/malformed
    stamps sort first (they carry no causal information)."""
    try:
        return (int(stamp["ms"]), int(stamp["lc"]),
                str(stamp.get("node", "")))
    except (TypeError, KeyError, ValueError):
        return (-1, -1, "")


def is_stamp(obj) -> bool:
    """True when ``obj`` looks like a serialized HLC stamp."""
    return (isinstance(obj, dict) and "ms" in obj and "lc" in obj)


# -- process-global clock --------------------------------------------------

_LOCAL = HLC()
_ENABLED = _env_truthy(_ENABLE_ENV)


def enabled() -> bool:
    return _ENABLED


def set_enabled(on: bool) -> None:
    global _ENABLED
    _ENABLED = bool(on)


def configure(cfg) -> bool:
    """Apply engine config: ``rabit_events`` turns HLC stamping on
    (the clock and the fleet event bus share the master knob)."""
    global _ENABLED
    if cfg is not None and "rabit_events" in cfg:
        _ENABLED = cfg.get_bool("rabit_events")
    return _ENABLED


def set_node(node_id: str) -> None:
    """Name this process's clock (rank/task id) once known; stamps
    minted before keep the pid-derived default."""
    _LOCAL.node = str(node_id) or _LOCAL.node


def local() -> HLC:
    return _LOCAL


def tick() -> Optional[dict]:
    """Stamp a local event on the process clock, or ``None`` when the
    plane is disabled (callers attach the stamp only when non-None, so
    disabled payloads stay byte-identical)."""
    return _LOCAL.tick() if _ENABLED else None


def merge(remote) -> Optional[dict]:
    """Merge a received stamp into the process clock (no-op when the
    plane is disabled or the stamp is absent)."""
    if not _ENABLED or not is_stamp(remote):
        return None
    return _LOCAL.merge(remote)


def merge_from_doc(doc) -> None:
    """Fold an ``"hlc"`` field out of any parsed reply/summary dict —
    the one-line client hook for every JSON the tracker hands back."""
    if isinstance(doc, dict):
        merge(doc.get("hlc"))


def reset(node_id: str = "", enabled: Optional[bool] = None) -> None:
    """Fresh clock state (tests)."""
    global _LOCAL, _ENABLED
    _LOCAL = HLC(node_id)
    if enabled is not None:
        _ENABLED = bool(enabled)
    else:
        _ENABLED = _env_truthy(_ENABLE_ENV)
