"""The port's copy of ``rabit_tpu/utils/retry.py``: retry with
exponential backoff + jitter for control-plane socket operations.

The C++ engine already absorbs transient tracker refusal at
registration (``rabit_connect_retry``, comm.cc:96-116); this module is
the Python-side counterpart for everything the Python layer talks to
over sockets — telemetry shipping, chaos smoke clients, tools — so a
tracker restart or a temporary partition degrades into a logged retry
instead of killing the worker at shutdown or losing its metrics.

Two pieces:

- :func:`retry_call` — call a function until it succeeds, with
  ``delay = min(max_s, base_s * 2**attempt) * (1 + jitter*U[0,1))``
  between failures. Full jitter on top of the exponential curve keeps a
  world-N reconnection storm from re-synchronizing on the tracker (the
  thundering-herd failure mode of fixed backoff).
- :class:`Deadline` — a wall-clock budget shared across attempts, so a
  retry loop inside a watchdog-guarded phase cannot outlive the phase's
  own deadline.

``connect_with_retry`` is the common composition: a TCP connect that
survives ECONNREFUSED/ETIMEDOUT bursts.
"""

from __future__ import annotations

import random
import socket
import time
from typing import Callable, Optional, Tuple, Type

from . import log

DEFAULT_ATTEMPTS = 5
DEFAULT_BASE_S = 0.1
DEFAULT_MAX_S = 2.0
DEFAULT_JITTER = 0.5


class RetryError(RuntimeError):
    """All attempts (or the deadline) exhausted; ``last`` holds the
    final underlying exception."""

    def __init__(self, msg: str, last: Optional[BaseException] = None):
        super().__init__(msg)
        self.last = last


class Deadline:
    """Wall-clock budget. ``None``/``<=0`` seconds means unlimited."""

    def __init__(self, seconds: Optional[float] = None):
        self._t0 = time.monotonic()
        self.seconds = seconds if seconds and seconds > 0 else None

    def remaining(self) -> Optional[float]:
        if self.seconds is None:
            return None
        return self.seconds - (time.monotonic() - self._t0)

    def expired(self) -> bool:
        rem = self.remaining()
        return rem is not None and rem <= 0

    def clamp(self, delay: float) -> float:
        """Never sleep past the deadline."""
        rem = self.remaining()
        return delay if rem is None else max(0.0, min(delay, rem))


def backoff_delay(attempt: int, base_s: float = DEFAULT_BASE_S,
                  max_s: float = DEFAULT_MAX_S,
                  jitter: float = DEFAULT_JITTER,
                  rng: Optional[random.Random] = None) -> float:
    """Delay before retry number ``attempt`` (0-based): capped
    exponential plus proportional full jitter."""
    d = min(max_s, base_s * (2.0 ** attempt))
    if jitter > 0:
        d *= 1.0 + jitter * (rng or random).random()
    return d


def retry_call(fn: Callable, *, attempts: int = DEFAULT_ATTEMPTS,
               base_s: float = DEFAULT_BASE_S, max_s: float = DEFAULT_MAX_S,
               jitter: float = DEFAULT_JITTER,
               retry_on: Tuple[Type[BaseException], ...] = (
                   OSError, ConnectionError),
               deadline: Optional[Deadline] = None,
               desc: str = "", rng: Optional[random.Random] = None):
    """Run ``fn()`` until it returns, retrying ``retry_on`` exceptions.

    Raises :class:`RetryError` (chaining the last failure) once
    ``attempts`` calls failed or ``deadline`` expired. Each retry is
    logged at debug level so a chaos run shows its backoff trace.
    """
    last: Optional[BaseException] = None
    for attempt in range(max(1, attempts)):
        if deadline is not None and deadline.expired():
            break
        try:
            return fn()
        except retry_on as e:  # noqa: PERF203 - retry loop by design
            last = e
            if attempt + 1 >= attempts:
                break
            delay = backoff_delay(attempt, base_s, max_s, jitter, rng)
            if deadline is not None:
                delay = deadline.clamp(delay)
            log.log_debug("retry %s: attempt %d/%d failed (%s: %s); "
                          "backoff %.3fs", desc or fn, attempt + 1,
                          attempts, type(e).__name__, e, delay)
            time.sleep(delay)
    raise RetryError(
        f"{desc or fn} failed after {attempts} attempt(s): "
        f"{type(last).__name__ if last else 'deadline'}: {last}", last)


def parse_hostport(addr: Optional[str],
                   default_host: str = "127.0.0.1"
                   ) -> Optional[Tuple[str, int]]:
    """``"host:port"`` (or ``":port"``) -> ``(host, port)``, or None
    when the string is empty/malformed. The tolerant parser behind
    every control-plane address knob (``RABIT_SKEW_TRACKER``,
    ``RABIT_TRACKER_STANDBY``): a bad address must read as "not
    configured", never crash a poller thread."""
    raw = (addr or "").strip()
    if not raw or ":" not in raw:
        return None
    host, _, port = raw.rpartition(":")
    try:
        return (host or default_host, int(port))
    except ValueError:
        return None


def connect_with_retry(host: str, port: int, timeout: float = 10.0,
                       attempts: int = DEFAULT_ATTEMPTS,
                       base_s: float = DEFAULT_BASE_S,
                       max_s: float = DEFAULT_MAX_S,
                       jitter: float = DEFAULT_JITTER,
                       deadline: Optional[Deadline] = None
                       ) -> socket.socket:
    """TCP connect surviving refused/reset bursts (tracker restart, a
    chaos blackout window). Returns a connected socket; raises
    :class:`RetryError` when the budget is spent."""
    return retry_call(
        lambda: socket.create_connection((host, int(port)), timeout=timeout),
        attempts=attempts, base_s=base_s, max_s=max_s, jitter=jitter,
        deadline=deadline, desc=f"connect {host}:{port}")
