"""The port's copy of ``rabit_tpu/utils/log.py``: logging + check
helpers, mirroring the reference's utils.h semantics:
Assert/Check/Error either kill the process or raise, controlled by
``DMLC_WORKER_STOP_PROCESS_ON_ERROR`` (utils.h:65-95,
allreduce_base.cc:202-210). The Python layer always raises — process-exit
is only meaningful inside the C++ engine, which honours the same flag.

Logging is leveled (debug < info < warn): ``log_info`` keeps its
original signature and line shape, ``log_debug`` is gated behind the
``rabit_debug`` knob (``RABIT_DEBUG`` env / ``set_debug``), and
``log_warn`` always prints. Once an engine is initialised it calls
:func:`set_identity` so every line carries ``r<rank>/<world>`` —
interleaved stderr from a tracker-launched world stays attributable.
"""

from __future__ import annotations

import os
import sys
import time
from typing import Optional


class CheckError(RuntimeError):
    """Raised when a rabit_tpu_torch invariant check fails (utils::Check)."""


def check(cond: bool, msg: str = "") -> None:
    if not cond:
        raise CheckError(f"check failed: {msg}")


_START = time.monotonic()

DEBUG, INFO, WARN = 10, 20, 30

_level = DEBUG if os.environ.get("RABIT_DEBUG", "").lower() in (
    "1", "true", "yes", "on") else INFO
_rank: Optional[int] = None
_world: Optional[int] = None


def set_debug(on: bool) -> None:
    """``rabit_debug`` knob: opens the debug level (engines call this
    from their config at init)."""
    global _level
    _level = DEBUG if on else INFO


def set_identity(rank: int, world_size: int) -> None:
    """Prefix subsequent lines with ``r<rank>/<world>`` (engine init)."""
    global _rank, _world
    _rank, _world = rank, world_size


def clear_identity() -> None:
    global _rank, _world
    _rank = _world = None


def _emit(fmt: str, args: tuple) -> None:
    msg = fmt % args if args else fmt
    who = f" r{_rank}/{_world}" if _rank is not None else ""
    print(f"[rabit_tpu_torch{who} {time.monotonic() - _START:9.3f}s] {msg}",
          file=sys.stderr, flush=True)


def log_debug(fmt: str, *args) -> None:
    """Per-op tracing — silent unless ``rabit_debug`` is on."""
    if _level <= DEBUG:
        _emit(fmt, args)


def log_info(fmt: str, *args) -> None:
    """Timestamped info log (utils::HandleLogInfo, utils.h:100-108)."""
    if _level <= INFO:
        _emit(fmt, args)


def log_warn(fmt: str, *args) -> None:
    """Always printed — conditions an operator should see."""
    _emit("warning: " + fmt, args)
