"""Abstract engine interface — the Python face of the reference's
``IEngine`` (engine.h:32-183). One engine instance per process; the
reference keeps a thread-local singleton (engine.cc:33-43), which in
Python is the module-global in ``rabit_tpu_torch.__init__`` (the API is
documented not thread-safe, rabit.h:177-178).

The port's copy of ``rabit_tpu/engine/base.py``, with its telemetry spans
on the base compositions and with ``restore_checkpoint``."""

from __future__ import annotations

import os
import socket
from abc import ABC, abstractmethod
from typing import Callable, List, Optional, Tuple

import numpy as np

from .. import telemetry
from ..ops.reducers import SUM

# the one knob of the JAX package's engines that the port has no code for
# yet: set, it raises rather than be ignored (both engines of the port)
_STANDBY_KNOB = "rabit_tracker_standby"
_STANDBY_ENV = "RABIT_TRACKER_STANDBY"


def refuse_unported(cfg) -> None:
    """Raise for a configured hot standby (``rabit_tracker_standby``, or
    ``RABIT_TRACKER_STANDBY`` in the environment), whose machinery the
    port lacks: the skew poller's failover to it is not ported.
    Telemetry, profiling, the event bus, the live plane
    (``rabit_metrics_port``), the skew plane (``rabit_skew_*``), the
    watchdog (``rabit_deadline_ms``, ``rabit_deadline_ms_per_mb``,
    ``rabit_watchdog_abort``, ``rabit_hier_phase_deadline_scale``) and
    the flight recorder (``rabit_flight_dir``, ``rabit_flight_keep``)
    are ported."""
    bad = [_STANDBY_KNOB] if cfg.get(_STANDBY_KNOB) else []
    if os.environ.get(_STANDBY_ENV) and not bad:
        bad.append(_STANDBY_ENV)
    if bad:
        raise NotImplementedError(
            f"{bad}: the hot standby is not ported to rabit_tpu_torch yet")


class AllreduceHandle:
    """Awaitable engine-level collective (:meth:`Engine.allreduce_async`).

    ``wait()`` blocks until the buffer passed at issue holds the reduced
    result, then returns it; idempotent. ``ready()`` is a non-blocking
    completion probe (False when the engine can't tell). Engines without
    a true async path complete the op at issue and hand back an
    already-done handle."""

    __slots__ = ("_wait_fn", "_ready_fn", "_value", "_done")

    def __init__(self, wait_fn=None, value=None, ready_fn=None):
        self._wait_fn = wait_fn
        self._ready_fn = ready_fn
        self._value = value
        self._done = wait_fn is None

    def ready(self) -> bool:
        if self._done:
            return True
        if self._ready_fn is not None:
            return bool(self._ready_fn())
        return False

    def wait(self):
        if self._done:
            return self._value
        wait_fn, self._wait_fn = self._wait_fn, None
        try:
            self._value = wait_fn()
        finally:
            self._done = True
            self._ready_fn = None
        return self._value


class EnvExports:
    """Engine config params exported to the environment, so that code
    which never sees the config (the data plane, dispatch, the skew
    monitor, a respawned process) reads one consistent setting; tracked
    so ``restore`` can undo them at shutdown -- an engine configured
    WITHOUT the param must not inherit a previous engine's value, while
    a value the user set independently in the environment survives."""

    def __init__(self) -> None:
        # env name -> (value before our first export, our exported value)
        self._saved: dict = {}

    def export(self, name: str, value: str) -> None:
        if value:
            if name not in self._saved:
                # first export only: a retried init must not snapshot
                # the engine's own exported value as "the user's"
                self._saved[name] = (os.environ.get(name), value)
            else:
                self._saved[name] = (self._saved[name][0], value)
            os.environ[name] = value

    def restore(self) -> None:
        # only touch a var if it still holds OUR export
        for name, (prev, ours) in self._saved.items():
            if os.environ.get(name) == ours:
                if prev is None:
                    os.environ.pop(name, None)
                else:
                    os.environ[name] = prev
        self._saved = {}


def export_skew(env: EnvExports, cfg) -> None:
    """The skew-adaptation knobs (``rabit_skew_adapt``,
    ``rabit_skew_preagg_ms``, ``rabit_skew_poll_ms``,
    ``rabit_skew_sync_rounds``) to the environment, where
    ``telemetry/skew.py`` reads them on each dispatch, and with the knob
    on the tracker's address (``RABIT_SKEW_TRACKER``) for the
    ``SkewMonitor``'s poller; then validated, so a garbage value fails
    here and not mid-training (the JAX package's
    ``NativeEngine._export_skew`` and ``XlaDataPlane``'s check)."""
    from ..telemetry import skew
    for key in ("rabit_skew_adapt", "rabit_skew_preagg_ms",
                "rabit_skew_poll_ms", "rabit_skew_sync_rounds"):
        env.export(key.upper(), cfg.get(key, "") or "")
    if cfg.get_bool("rabit_skew_adapt"):
        host = cfg.get("rabit_tracker_uri")
        port = cfg.get_int("rabit_tracker_port", 0)
        if host and host != "NULL" and port:
            env.export("RABIT_SKEW_TRACKER", f"{host}:{port}")
    try:
        skew.preagg_ms_per_mib()   # each raises ValueError on garbage
        skew.poll_interval_s()
        skew.sync_rounds()
    except ValueError:
        env.restore()
        raise


def start_live_plane(cfg, rank: int, world: int, gauges_fn,
                     announce: bool):
    """The per-rank metrics endpoint (``telemetry/live.py``), off unless
    ``rabit_metrics_port`` is configured (0 picks a free port); with
    ``announce`` its address goes to the tracker (the ``endpoint``
    command) for the tracker's poll loop. Returns the server, or None.
    A port that does not bind is a warning, never an init failure."""
    if "rabit_metrics_port" not in cfg:
        return None
    from ..telemetry import live
    from ..utils import log
    try:
        server = live.start_rank_server(cfg.get_int("rabit_metrics_port", 0),
                                        rank, world, gauges_fn=gauges_fn)
    except OSError as e:
        log.log_warn("metrics endpoint failed to start: %s", e)
        return None
    if announce:
        live.announce_endpoint(server.host, server.port, rank)
    return server


def note_identity(rank: int) -> None:
    """Record this worker's formed identity (its task id, else its rank;
    the rank; epoch 0 at init), which a reconnecting poller re-presents
    to a resumed tracker (``membership.present_resume``)."""
    from ..tracker import membership
    membership.note_identity(os.environ.get("RABIT_TASK_ID", str(rank)),
                             rank, 0)


class Engine(ABC):
    """Collective engine. Buffers are 1-D contiguous numpy arrays mutated
    in place, matching the reference's in-place sendrecvbuf contract
    (engine.h:74-96)."""

    @abstractmethod
    def init(self, args: List[str]) -> None:
        """Bootstrap: parse config, rendezvous, establish links
        (IEngine construction + AllreduceBase::Init,
        allreduce_base.cc:53-120)."""

    @abstractmethod
    def shutdown(self) -> None:
        """Tear down links (AllreduceBase::Shutdown,
        allreduce_base.cc:125-142)."""

    # -- collectives ------------------------------------------------------
    @abstractmethod
    def allreduce(self, buf: np.ndarray, op: int,
                  prepare_fun: Optional[Callable[[], None]] = None,
                  key: str = "") -> None:
        """In-place elementwise allreduce of ``buf`` across ranks
        (IEngine::Allreduce, engine.h:74-96). ``prepare_fun`` runs lazily
        right before the reduction. ``key`` is the caller-signature cache
        key used by the bootstrap cache (rabit.h:26-39)."""

    def allreduce_async(self, buf: np.ndarray, op: int,
                        prepare_fun: Optional[Callable[[], None]] = None,
                        key: str = "") -> AllreduceHandle:
        """Issue an in-place allreduce of ``buf`` and return an
        awaitable :class:`AllreduceHandle`. Default implementation
        completes the collective synchronously (zero overlap, same
        result)."""
        self.allreduce(buf, op, prepare_fun=prepare_fun, key=key)
        return AllreduceHandle(value=buf)

    @abstractmethod
    def broadcast(self, data: Optional[bytes], root: int) -> bytes:
        """Broadcast a byte string from ``root``; returns the payload on
        every rank (IEngine::Broadcast, engine.h:98-105). Non-root ranks
        pass ``None``. Handles the size pre-broadcast internally
        (rabit-inl.h:130-165)."""

    def reduce_scatter(self, buf: np.ndarray, op: int) -> np.ndarray:
        """Reduce ``buf`` elementwise across ranks and return this
        rank's chunk — ``n/p`` elements starting at ``rank*n/p`` (rank i
        owns chunk i, allreduce_base.cc:829-918). ``buf.size`` must
        divide by the world size. Default composition: a full allreduce
        (``buf`` is mutated to the complete reduction) followed by a
        slice copy."""
        p = self.world_size
        if buf.size % p:
            raise ValueError(
                f"reduce_scatter payload of {buf.size} elements must "
                f"divide by the world size {p} (rank i owns chunk i)")
        with telemetry.span("engine.reduce_scatter", nbytes=buf.nbytes,
                            method="allreduce",
                            round=telemetry.collective_round(
                                "engine.reduce_scatter")):
            self.allreduce(buf, op)
            m = buf.size // p
            return buf[self.rank * m:(self.rank + 1) * m].copy()

    def allgather(self, buf: np.ndarray) -> np.ndarray:
        """Concatenate every rank's ``buf`` in rank order; every rank
        returns the full length ``p*m`` result (TryAllgatherRing,
        allreduce_base.cc:751-815). Default composition: zero-pad into
        the owned slot and SUM-allreduce (exact — every other slot is
        zero)."""
        p = self.world_size
        m = buf.size
        out = np.zeros(p * m, dtype=buf.dtype)
        out[self.rank * m:(self.rank + 1) * m] = buf.reshape(-1)
        with telemetry.span("engine.allgather", nbytes=out.nbytes,
                            method="allreduce",
                            round=telemetry.collective_round(
                                "engine.allgather")):
            self.allreduce(out, SUM)
        return out

    # -- checkpointing ----------------------------------------------------
    def load_checkpoint(self, with_local: bool = False
                        ) -> Tuple[int, Optional[bytes], Optional[bytes]]:
        """Returns (version, global_bytes, local_bytes); version 0 means
        fresh start (IEngine::LoadCheckPoint, engine.h:107-137)."""
        return (0, None, None)

    def checkpoint(self, global_bytes: bytes,
                   local_bytes: Optional[bytes] = None) -> None:
        """Two-phase commit checkpoint; bumps version
        (IEngine::CheckPoint, engine.h:139-153)."""
        self._version += 1

    def lazy_checkpoint(self, make_global: Callable[[], bytes]) -> None:
        """Defer serialization until a failure needs it
        (IEngine::LazyCheckPoint, engine.h:155-166)."""
        self._version += 1

    def init_after_exception(self) -> None:
        """Reset engine state after the caller caught an exception
        mid-collective (IEngine::InitAfterException,
        allreduce_robust.h:163-169). Only the robust engine can honor it."""
        raise NotImplementedError(
            "InitAfterException requires the robust engine")

    def resize(self, cmd: str = "recover") -> None:
        """In-process world resize (elastic membership): re-register
        with the tracker and rebuild the link topology from the fresh
        assignment without process exit -- rank and world size may both
        change. ``cmd`` is ``"recover"`` (a survivor re-forming after an
        eviction) or ``"join"`` (an evicted rank rejoining at the next
        epoch boundary). Only engines with a tracker-registered link
        plane can honor it; checkpoints and the version counter survive
        the transition."""
        raise NotImplementedError(
            "in-process resize requires a tracker-registered engine")

    def restore_checkpoint(self, version: int, global_bytes: Optional[bytes],
                           local_bytes: Optional[bytes] = None) -> None:
        """Take over a checkpoint written elsewhere (``convert.py``): the
        next ``load_checkpoint`` returns it."""
        if version < 0:
            raise ValueError(f"checkpoint version must be >= 0, got "
                             f"{version}")
        self._global, self._local = global_bytes, local_bytes
        self._version = int(version)

    # -- properties -------------------------------------------------------
    _version: int = 0

    @property
    def version_number(self) -> int:
        return self._version

    @property
    @abstractmethod
    def rank(self) -> int: ...

    @property
    @abstractmethod
    def world_size(self) -> int: ...

    @property
    def is_distributed(self) -> bool:
        return self.world_size > 1

    @property
    def host(self) -> str:
        return socket.gethostname()

    def tracker_print(self, msg: str) -> None:
        """Default: rank-0 stdout, like the empty/MPI engines
        (engine_empty.cc TrackerPrint)."""
        if self.rank == 0:
            print(msg, flush=True)
