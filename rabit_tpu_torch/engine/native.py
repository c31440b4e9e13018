"""ctypes binding to the native core's engines (``librabit_tpu_core``).

The port's copy of ``rabit_tpu/engine/native.py``. The library is built
from ``native/src`` by ``engine/_native_build.py`` (never the JAX
package's ``native/build/`` copy). The engine variant (``base`` /
``robust`` / ``mock``) is chosen at run time through ``rabit_engine``;
``mpi`` (``MpiComm``, ``native/src/engine_mpi.h``: the world of
``MPI_COMM_WORLD``, every reducer through one custom ``MPI_Op``,
checkpoints that only count versions, and ``MPI_Finalize`` only where the
engine called ``MPI_Init``) loads the core's MPI build instead, a library
of its own (``_native_build.library("mpi")``).
With ``rabit_dataplane=torch`` the robust engine hands each allreduce of
at least ``rabit_dataplane_minbytes`` bytes to a
:class:`~rabit_tpu_torch.engine.dataplane.TorchDataPlane`, which reduces
it over a ``torch.distributed`` world (NCCL on the card, gloo with
``rabit_device=cpu``) while the C++ side keeps consensus, replay and
checkpoint recovery.

Caller-signature cache keys: the reference captures __builtin_FILE/LINE
in its C++ templates (rabit.h:26-39) so the bootstrap cache can replay
pre-LoadCheckPoint collectives; through the C interface those keys are
lost. The binding rebuilds them from the Python caller's frame and passes
them through RbtAllreduceEx.

Telemetry (the JAX binding's wiring, ``rabit_tpu/engine/native.py``):
``init`` applies ``rabit_telemetry``, ``rabit_profile`` and
``rabit_events``; ``allreduce`` and the payload of ``broadcast`` record
``engine.allreduce`` / ``engine.broadcast`` spans (method ``native``)
with round ids; after each collective the native recovery counters
(``RbtRecoveryStats``: in-collective retries, frame CRC rejects, link
resurrections) are drained into ``recovery.retry`` /
``recovery.frame_reject`` / ``recovery.link_resurrect`` counts (at most
1000 a drain) and one fleet event a kind; ``shutdown`` writes this rank's
telemetry files and ships its summary to the tracker BEFORE
``RbtFinalize``, since the tracker exits once every rank has sent
``shutdown``.

The live plane and the skew plane (the JAX binding's wiring,
``native.py:312-353``): ``rabit_metrics_port`` starts this rank's
metrics endpoint (``/metrics``, ``/healthz``, ``/summary``) at init and
announces it to the tracker (the ``endpoint`` command), whose poll loop
scrapes it; with the torch data plane the ``rabit_skew_*`` knobs and
the tracker's address (``RABIT_SKEW_TRACKER``) are exported for the
data plane's collectives, and validated there.

The watchdog and the flight recorder (the JAX binding's wiring,
``native.py:239-248``, ``:391-425``, ``:559-611``): ``rabit_flight_dir``
installs the recorder before the bootstrap, with rank -1, and stamps the
rank once it is known; ``rabit_deadline_ms`` guards the bootstrap
(``engine.init``: a tracker that never completes the assignment ends in
exit 86 with a bundle), ``allreduce``, both phases of ``broadcast``
(``engine.broadcast.size``, ``engine.broadcast``) and
``load_checkpoint``, each guard with the two hooks of the ladder:
``_rung_retry`` marks the torch data plane's world aborted (the blocked
round fails once its collective ends, and replays) and ``_rung_reform``
raises the native core's out-of-band
interrupt (``RbtInterruptEx``), which bails a blocked socket collective
out into the robust layer's global re-formation.

Elastic membership (the JAX binding's ``resize`` and ``epoch_reset``,
``native.py:476-506``, ``:760-795``): :meth:`NativeEngine.resize`
re-registers with the tracker in the same process (``RbtResize``:
``"recover"`` for a survivor of an eviction, ``"join"`` for an evicted
rank coming back), under a watchdog guard ``engine.resize`` with the
ladder's hooks and a span of the same name; the data plane's next
collective forms its world at the new epoch and size. Then
:meth:`NativeEngine.epoch_reset` drops what the old world left behind.
``rabit_elastic`` is accepted at init, as the JAX engine accepts it: the
launcher and the tracker act on it (``tracker/membership.py``).

The hot standby (``RABIT_TRACKER_STANDBY``, ``tracker/standby.py``) is
the launcher's and the skew poller's: the launcher names the standby's
address in the worker's environment, and the poller adopts the promoted
tracker. As in the JAX engine, nothing here reads or refuses it.
"""

from __future__ import annotations

import ctypes
import os
import sys
from typing import Callable, List, Optional, Tuple

import numpy as np

from . import ckpt_store
from ._native_build import library
from .base import (Engine, EnvExports, export_skew, note_identity,
                   start_live_plane)
from .. import telemetry
from ..ops.reducers import DTYPE_ENUM, MAX, MIN, OP_NAMES
from ..telemetry import events
from ..telemetry import profile as _profile
from ..utils import log, retry
from ..utils.config import Config
from ..utils.watchdog import Watchdog

_PREPARE_CB = ctypes.CFUNCTYPE(None, ctypes.c_void_p)
# C hook signature (native/include/rabit_tpu_c.h RbtDataPlaneFn)
DATAPLANE_CB = ctypes.CFUNCTYPE(
    ctypes.c_int, ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int,
    ctypes.c_int, ctypes.c_uint32, ctypes.c_void_p)


def _load(variant: str = "plain") -> ctypes.CDLL:
    lib = ctypes.cdll.LoadLibrary(library(variant))
    lib.RbtInit.argtypes = [ctypes.c_int, ctypes.POINTER(ctypes.c_char_p)]
    lib.RbtGetRank.restype = ctypes.c_int
    lib.RbtGetWorldSize.restype = ctypes.c_int
    lib.RbtIsDistributed.restype = ctypes.c_int
    lib.RbtVersionNumber.restype = ctypes.c_int
    lib.RbtGetLastError.restype = ctypes.c_char_p
    lib.RbtTrackerPrint.argtypes = [ctypes.c_char_p]
    lib.RbtAllreduceEx.argtypes = [
        ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int, ctypes.c_int,
        _PREPARE_CB, ctypes.c_void_p, ctypes.c_char_p]
    lib.RbtBroadcastEx.argtypes = [
        ctypes.c_void_p, ctypes.c_uint64, ctypes.c_int, ctypes.c_char_p]
    lib.RbtCheckpoint.argtypes = [
        ctypes.c_char_p, ctypes.c_uint64, ctypes.c_char_p, ctypes.c_uint64]
    lib.RbtLazyCheckpoint.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
    lib.RbtLoadCheckpoint.argtypes = [
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
        ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_char)),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.RbtLoadCheckpoint.restype = ctypes.c_int
    lib.RbtSetDataPlane.argtypes = [
        DATAPLANE_CB, ctypes.c_void_p, ctypes.c_uint64]
    lib.RbtWorldEpoch.restype = ctypes.c_int
    lib.RbtCoordAddr.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_size_t), ctypes.c_size_t]
    lib.RbtRecoveryStats.argtypes = [
        ctypes.POINTER(ctypes.c_uint64), ctypes.POINTER(ctypes.c_uint64),
        ctypes.POINTER(ctypes.c_uint64)]
    lib.RbtRecoveryStats.restype = ctypes.c_int
    # the out-of-band interrupt (the watchdog's reform rung): any thread
    lib.RbtInterrupt.restype = ctypes.c_int
    lib.RbtInterruptEx.argtypes = [ctypes.c_char_p]
    lib.RbtInterruptEx.restype = ctypes.c_int
    lib.RbtInterruptReason.restype = ctypes.c_char_p
    # in-process re-registration (elastic membership): "recover" / "join"
    lib.RbtResize.argtypes = [ctypes.c_char_p]
    lib.RbtResize.restype = ctypes.c_int
    return lib


def _caller_site(depth: int = 2) -> str:
    """file::line caller signature (reference rabit.h:26-39 semantics).
    sys._getframe reads the one frame directly — inspect.stack() would
    walk the whole stack and read source files on every collective."""
    try:
        frame = sys._getframe(depth)
        return f"{os.path.basename(frame.f_code.co_filename)}::{frame.f_lineno}"
    except ValueError:  # pragma: no cover - shallower stack than depth
        return ""


class NativeEngine(Engine):
    def __init__(self, variant: str = "robust",
                 dataplane: Optional[str] = None) -> None:
        self._lib = _load("mpi" if variant == "mpi" else "plain")
        self._variant = variant
        self._key_counts: dict = {}
        self._loaded = False
        self._dataplane_kind = dataplane
        self._dataplane = None
        # config params exported to the environment, undone at shutdown
        self._env = EnvExports()
        # the per-rank metrics endpoint (rabit_metrics_port), or None
        self._metrics_server = None
        # durable cold-restart mirror (rabit_ckpt_dir); None = memory-only
        self._store: Optional[ckpt_store.CheckpointStore] = None
        # absolute version = native version + offset: the native counter
        # restarts at 0 on a cold restart while the durable store keeps
        # counting, so the app-visible version_number never goes backward
        self._version_offset = 0
        # last-seen native recovery counters (retries, frame rejects,
        # link resurrections): _drain_recovery_stats diffs against these
        self._recovery_seen = (0, 0, 0)
        self._watchdog = Watchdog()  # disabled until init reads config
        # the flight recorder (rabit_flight_dir), or None
        self._flight = None

    def _cache_key(self, site: str, size: int) -> bytes:
        """Deterministic replay key: caller site + payload size + an
        occurrence counter, so repeated same-site pre-load calls get
        distinct keys that are stable across process restarts (the
        reference keys on file::line::caller#nbytes, rabit.h:26-39).
        Keys only matter for the pre-LoadCheckpoint bootstrap cache, so
        key generation stops after the first load (and _key_counts stays
        bounded by the number of pre-load call sites)."""
        if not site or self._loaded:
            return b""
        base = f"{site}#{size}"
        n = self._key_counts.get(base, 0)
        self._key_counts[base] = n + 1
        return f"{base}@{n}".encode()

    def _check(self, rc: int, what: str) -> None:
        if rc != 0:
            err = self._lib.RbtGetLastError().decode()
            raise RuntimeError(f"native {what} failed: {err}")

    def init(self, args: List[str]) -> None:
        argv = list(args)
        if self._variant != "auto" and \
                not any(a.startswith("rabit_engine=") for a in argv):
            argv.append(f"rabit_engine={self._variant}")
        cfg = Config.from_args(args)
        kind = self._dataplane_kind or cfg.get("rabit_dataplane")
        if kind not in (None, "", "torch", "none"):
            raise ValueError(f"unknown rabit_dataplane {kind!r} "
                             f"(rabit_tpu_torch has 'torch')")
        if kind == "torch" and \
                not any(a.startswith("rabit_dataplane=") for a in argv):
            # the engine-API path (NativeEngine(dataplane="torch")) must
            # be visible to the C++ side BEFORE Init: registration
            # advertises data-plane need so the tracker hosts the
            # epoch's rendezvous store
            argv.append("rabit_dataplane=torch")
        port = cfg.get("rabit_slave_port")
        if port is not None and \
                not any(a.startswith("rabit_slave_port=") for a in argv):
            # the core reads its link port from argv alone: the env's
            # (RABIT_SLAVE_PORT, set by the port's launcher) goes there
            argv.append(f"rabit_slave_port={port}")
        try:
            if kind == "torch":
                # validated before any rendezvous: a typo must fail here,
                # not at the first collective
                from .dataplane import TorchDataPlane
                self._env.export("RABIT_DATAPLANE_WIRE",
                                 cfg.get("rabit_dataplane_wire", ""))
                self._env.export("RABIT_DATAPLANE_WIRE_MINCOUNT",
                                 cfg.get("rabit_dataplane_wire_mincount", ""))
                self._env.export("RABIT_REDUCE_METHOD",
                                 cfg.get("rabit_reduce_method", ""))
                export_skew(self._env, cfg)
                self._dataplane = TorchDataPlane(
                    self._lib, device=cfg.get("rabit_device") or None)
            arr = (ctypes.c_char_p * len(argv))(*[a.encode() for a in argv])
            self._watchdog = Watchdog.from_config(cfg)
            # the flight recorder arms BEFORE the guarded bootstrap: a hung
            # rendezvous escalated to the abort must still leave a bundle
            # (the rank is unknown yet; stamped once init succeeds)
            from ..telemetry import flight
            self._flight = flight.FlightRecorder.from_config(cfg, rank=-1)
            # a tracker that accepted the connection but never completes
            # the assignment would otherwise hang the worker forever
            with self._watchdog.guard("engine.init"):
                self._check(self._lib.RbtInit(len(argv), arr), "init")
        except BaseException:
            # a failed init leaves no exported knob or hook behind
            self._dataplane = None
            self._env.restore()
            self._watchdog.close()
            if self._flight is not None:
                self._flight.uninstall()
                self._flight = None
            raise
        if self._flight is not None:
            self._flight.rank = self.rank
        log.set_debug(cfg.get_bool("rabit_debug"))
        log.set_identity(self.rank, self.world_size)
        telemetry.configure(cfg)
        _profile.configure(cfg)
        # the C++ side composed the start handshake; the endpoint is
        # announced right after, over the same rendezvous (best-effort)
        self._metrics_server = start_live_plane(
            cfg, self.rank, self.world_size, self._live_gauges,
            announce=self.is_distributed)
        if self.is_distributed:
            note_identity(self.rank)
        ckpt_dir = cfg.get("rabit_ckpt_dir")
        if ckpt_dir:
            self._store = ckpt_store.CheckpointStore(
                ckpt_dir, rank=self.rank,
                keep=cfg.get_int("rabit_ckpt_keep", ckpt_store.DEFAULT_KEEP))
        if self._dataplane is not None:
            if self.is_distributed:
                self._export_hier_topology(cfg)
                minbytes = cfg.get_size("rabit_dataplane_minbytes", 1024)
                self._check(self._lib.RbtSetDataPlane(
                    self._dataplane.c_callback, None, minbytes),
                    "set_dataplane")
            else:
                self._dataplane = None

    def _export_hier_topology(self, cfg) -> None:
        """Hierarchical-schedule knobs -> env for the data plane. An
        explicit ``rabit_hier_group`` wins; otherwise ask the tracker for
        its host grouping (the ``topo`` command) and export it as a group
        spec. Only a genuinely two-level grouping (>1 host, >1 rank/host,
        uniform) is exported — degenerate worlds keep the flat schedules.
        Best-effort: an unreachable tracker leaves hierarchy off, never
        fails init."""
        from ..parallel import topology
        self._env.export("RABIT_HIER", cfg.get("rabit_hier", ""))
        group = cfg.get("rabit_hier_group", "")
        if not group and topology.hier_enabled():
            host = cfg.get("rabit_tracker_uri")
            port = cfg.get_int("rabit_tracker_port", 0)
            if host and port:
                groups = topology.fetch_topo(
                    host, port, task_id=cfg.get("rabit_task_id", "0") or "0")
                if groups is not None and topology.is_hierarchical(
                        groups, self.world_size):
                    group = topology.groups_spec(groups)
        self._env.export("RABIT_HIER_GROUP", group)

    def _live_gauges(self) -> list:
        """The watchdog's and the recovery gauges served on ``/metrics``
        beside the recorder's counters (the JAX binding's), and this
        rank's SLO burn (``telemetry/slo.py``)."""
        from ..telemetry import slo as _slo
        retries, rejects, links = (ctypes.c_uint64(), ctypes.c_uint64(),
                                   ctypes.c_uint64())
        self._lib.RbtRecoveryStats(ctypes.byref(retries),
                                   ctypes.byref(rejects), ctypes.byref(links))
        dp = self._dataplane
        py_retries = dp.retries_total if dp is not None else 0
        return [
            ("rabit_watchdog_expired_total",
             "Watchdog deadline expiries in this process.", "counter",
             [({}, self._watchdog.expired_total)]),
            ("rabit_world_epoch",
             "Tracker link-registration epoch (advances on recovery).",
             "gauge", [({}, int(self._lib.RbtWorldEpoch()))]),
            ("rabit_dataplane_retries_total",
             "In-collective recovery retries (rounds re-run in place).",
             "counter", [({}, int(retries.value) + py_retries)]),
            ("rabit_frame_crc_rejects_total",
             "CRC-rejected collective frames (retransmitted hop-local).",
             "counter", [({}, int(rejects.value))]),
            *_slo.rank_gauges(),
        ]

    @property
    def world_epoch(self) -> int:
        """The tracker's link-registration epoch — advances exactly when
        the worker set was rewired (a recovery happened)."""
        return int(self._lib.RbtWorldEpoch())

    def _rung_retry(self) -> None:
        """The watchdog's retry rung (first escalation): fail the stalled
        device collective's round by marking the data plane's world
        aborted (``TorchDataPlane.abort``; ``_invoke`` fails the round
        once its collective ends and tears the group down on its own
        thread): the data plane then re-runs the round in place
        (``RABIT_COLLECTIVE_RETRIES`` > 0) or returns nonzero to C++,
        which takes it for a link reset and replays. A stall in the
        native core's own sockets is out of its reach; the reform rung
        handles those."""
        telemetry.count("recovery.retry", op="watchdog_rung",
                        provenance="recovery")
        events.emit("recovery.retry", "watchdog retry rung: device "
                    "world torn down for in-collective replay",
                    rank=self.rank)
        dp = self._dataplane
        if dp is not None and dp.formed:
            dp.abort()

    def _rung_reform(self) -> None:
        """The watchdog's reform rung (second escalation): the retry rung
        did not unstick the phase, so the stall is inside a socket
        collective of the native core. ``RbtInterruptEx`` raises the
        out-of-band flag every native poll loop checks; the blocked
        collective bails out into the robust layer's global re-formation
        (reconnect and replay) without the process exiting. Safe from
        the monitor thread."""
        telemetry.count("recovery.world_reform", op="watchdog_rung",
                        provenance="recovery")
        events.emit("recovery.world_reform",
                    "watchdog reform rung: out-of-band interrupt into "
                    "global re-formation", rank=self.rank)
        self._lib.RbtInterruptEx(b"watchdog_reform")

    def _guard(self, name: str, nbytes: int = 0):
        """A guard of this engine's watchdog with the ladder's hooks."""
        return self._watchdog.guard(name, nbytes=nbytes,
                                    on_expire=self._rung_retry,
                                    on_reform=self._rung_reform)

    @property
    def dataplane(self):
        """The registered :class:`TorchDataPlane`, or None."""
        return self._dataplane

    def set_world_reformed_callback(self, fn) -> None:
        """``fn(epoch)`` fires after each formation of the data plane's
        world (see the state contract in ``engine/dataplane.py``)."""
        if self._dataplane is None:
            raise RuntimeError("no data plane registered")
        self._dataplane.on_world_reformed = fn

    def epoch_reset(self, world: int) -> None:
        """The elastic-membership epoch hook: the tracker re-formed the
        world at a new size, so drop everything keyed on the old one --
        the exported host grouping (its ranks are old-world names), the
        dispatch table cache, the skew plane's agreed digest and dispatch
        counter, the membership monitor's formed baseline -- pin the
        newest old-world checkpoint against pruning until the resized
        world commits its own, and seed a re-admitted rank's store from
        its siblings' durable shards. Counts ``membership.epoch_reset``,
        records a zero-length ``membership.transition`` span, leaves a
        flight note and emits the event."""
        from ..parallel import dispatch as _dispatch
        from ..parallel import topology as _topology
        from ..telemetry import flight as _fl
        from ..telemetry import skew as _skew
        from ..tracker import membership as _membership
        world = int(world)
        _topology.epoch_reset(world)
        _dispatch.epoch_reset(world)
        _skew.epoch_reset(world)
        _membership.epoch_reset(world)
        if self._store is not None:
            self._store.protect_current()
            self._store.adopt_latest_from_peers()
        telemetry.count("membership.epoch_reset", provenance="membership")
        telemetry.record_span("membership.transition", 0.0, op="resize",
                              provenance="membership", world=world)
        _fl.note("member_resize", f"world resized to {world}")
        events.emit("membership.epoch_reset", f"world resized to {world}",
                    rank=self.rank)

    def _drain_recovery_stats(self) -> None:
        """Diff the native recovery counters against the last drain and
        record the delta as recovery-provenance telemetry: the native
        plane recovers without unwinding into Python, so this is where
        those events reach the fleet tables."""
        r, f, s = ctypes.c_uint64(), ctypes.c_uint64(), ctypes.c_uint64()
        if self._lib.RbtRecoveryStats(ctypes.byref(r), ctypes.byref(f),
                                      ctypes.byref(s)) != 0:
            return
        cur = (r.value, f.value, s.value)
        prev, self._recovery_seen = self._recovery_seen, cur
        kinds = (("recovery.retry", "native_round",
                  "native in-collective retries"),
                 ("recovery.frame_reject", "frame_crc", "frame CRC rejects"),
                 ("recovery.link_resurrect", "link", "link resurrections"))
        for (name, op, what), c, p in zip(kinds, cur, prev):
            # monotonic counters; cap the replay so a drain after
            # thousands of events cannot stall the caller
            delta = min(max(0, c - p), 1000)
            for _ in range(delta):
                telemetry.count(name, op=op, provenance="recovery")
            if delta:
                # one fleet event a drained kind: the bus carries the
                # causal marker, the counters the magnitude
                events.emit(name, f"{what} ×{delta}", rank=self.rank,
                            count=delta)

    def shutdown(self) -> None:
        if self._dataplane is not None:
            self._dataplane.shutdown()
            self._dataplane = None
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        if self._flight is not None:
            self._flight.uninstall()
            self._flight = None
        _profile.stop_poller()
        # telemetry flushes BEFORE finalize: RbtFinalize sends the tracker
        # its shutdown command, and the tracker exits (printing the fleet
        # table) once every rank has. Best-effort: a run without telemetry
        # or a tracker skips them.
        if telemetry.enabled():
            try:
                rank, world = self.rank, self.world_size
                telemetry.export_at_shutdown(rank, world)
                if self.is_distributed:
                    telemetry.ship_to_tracker(rank, world)
            except Exception as e:  # noqa: BLE001 - never block shutdown
                log.log_warn("telemetry flush failed: %s", e)
        self._env.restore()
        self._watchdog.close()
        # the shutdown handshake is a fresh tracker connection per
        # attempt and idempotent tracker-side, so retry a brief outage
        retry.retry_call(
            lambda: self._check(self._lib.RbtFinalize(), "finalize"),
            attempts=6, base_s=0.4, max_s=4.0,
            retry_on=(RuntimeError,), desc="finalize")

    def allreduce(self, buf: np.ndarray, op: int,
                  prepare_fun: Optional[Callable[[], None]] = None,
                  key: str = "") -> None:
        if not buf.flags["C_CONTIGUOUS"]:
            raise ValueError("allreduce buffer must be C-contiguous")
        dtype_enum = DTYPE_ENUM[np.dtype(buf.dtype)]
        cache_key = key.encode() if key else \
            self._cache_key("" if self._loaded else _caller_site(3),
                            buf.nbytes)
        if prepare_fun is None:
            cb = _PREPARE_CB()
        else:
            def trampoline(_arg, fn=prepare_fun):
                fn()
            cb = _PREPARE_CB(trampoline)
        with self._guard("engine.allreduce", buf.nbytes), \
                telemetry.span("engine.allreduce", nbytes=buf.nbytes,
                               op=OP_NAMES.get(op, str(op)), method="native",
                               round=telemetry.collective_round(
                                   "engine.allreduce")):
            rc = self._lib.RbtAllreduceEx(
                buf.ctypes.data_as(ctypes.c_void_p), buf.size, dtype_enum,
                op, cb, None, cache_key)
        self._check(rc, "allreduce")
        self._drain_recovery_stats()

    def broadcast(self, data: Optional[bytes], root: int) -> bytes:
        # two-phase: 8-byte length then payload (reference rabit.py:171-206)
        site = "" if self._loaded else _caller_site(3)
        length = np.zeros(1, dtype=np.uint64)
        if self.rank == root:
            if data is None:
                raise ValueError("root must provide broadcast data")
            length[0] = len(data)
        with self._guard("engine.broadcast.size", 8):
            rc = self._lib.RbtBroadcastEx(
                length.ctypes.data_as(ctypes.c_void_p), 8, root,
                self._cache_key(site + "/len", 8))
        self._check(rc, "broadcast(size)")
        n = int(length[0])
        payload = ctypes.create_string_buffer(n)
        if self.rank == root and n:
            payload.raw = data
        if n:
            with self._guard("engine.broadcast", n), \
                    telemetry.span("engine.broadcast", nbytes=n,
                                   method="native", root=root,
                                   round=telemetry.collective_round(
                                       "engine.broadcast")):
                rc = self._lib.RbtBroadcastEx(
                    ctypes.cast(payload, ctypes.c_void_p), n, root,
                    self._cache_key(site + "/payload", n))
            self._check(rc, "broadcast(payload)")
        self._drain_recovery_stats()
        return payload.raw[:n]

    def load_checkpoint(self, with_local: bool = False
                        ) -> Tuple[int, Optional[bytes], Optional[bytes]]:
        gptr = ctypes.POINTER(ctypes.c_char)()
        glen = ctypes.c_uint64()
        lptr = llen = None
        with self._guard("engine.load_checkpoint"):
            if with_local:
                lptr = ctypes.POINTER(ctypes.c_char)()
                llen = ctypes.c_uint64()
                version = self._lib.RbtLoadCheckpoint(
                    ctypes.byref(gptr), ctypes.byref(glen),
                    ctypes.byref(lptr), ctypes.byref(llen))
            else:
                version = self._lib.RbtLoadCheckpoint(
                    ctypes.byref(gptr), ctypes.byref(glen), None, None)
        if version < 0:
            self._check(-1, "load_checkpoint")
        gbytes = bytes(gptr[:glen.value]) if version > 0 else None
        lbytes = None
        if with_local and version > 0 and llen.value:
            lbytes = bytes(lptr[:llen.value])
        if self._store is not None:
            if version > 0 and gbytes is not None \
                    and ckpt_store.is_wrapped(gbytes):
                # durable-mode checkpoints carry the absolute version
                # inside the replicated payload (see checkpoint below);
                # recover the offset from it
                abs_v, gbytes, _ = ckpt_store.decode_record(gbytes)
                self._version_offset = abs_v - version
            elif version == 0:
                # _cold_restart returns the ABSOLUTE version (it set the
                # offset itself via _seed_native)
                abs_v, gbytes, lbytes = self._cold_restart(with_local)
                self._loaded = True
                return (abs_v, gbytes, lbytes)
        self._loaded = True
        shown = version + self._version_offset if version > 0 else version
        return (shown, gbytes, lbytes)

    def _cold_restart(self, with_local: bool
                      ) -> Tuple[int, Optional[bytes], Optional[bytes]]:
        """The whole world restarted (native version 0 everywhere) with
        a durable store configured: agree on the newest intact stored
        version across ranks (MAX allreduce), pick the lowest rank
        holding it, broadcast its payload, and seed the C++ plane so
        subsequent partial failures replay from this state. Runs before
        ``_loaded`` flips, so these collectives get bootstrap-cache keys
        and a worker dying mid-consensus replays them after respawn."""
        store = self._store
        mine = store.latest_version()
        if not self.is_distributed or self.world_size == 1:
            got = store.latest()
            if got is None:
                return (0, None, None)
            v, g, l = got
            self._seed_native(v, g, l or None)
            log.log_warn("cold restart: resumed at checkpoint version %d "
                         "from the durable store", v)
            return (v, g, (l or None) if with_local else None)
        word = np.array([mine], dtype=np.int64)
        self.allreduce(word, MAX, key="ckpt_store/max_version")
        maxv = int(word[0])
        if maxv <= 0:
            return (0, None, None)
        word[0] = self.rank if mine >= maxv else self.world_size
        self.allreduce(word, MIN, key="ckpt_store/holder")
        root = int(word[0])
        payload = None
        if self.rank == root:
            got = store.load(maxv)
            payload = got[0] if got is not None else b""
        g = self.broadcast(payload, root)
        local = None
        if with_local:
            got = store.load(maxv)  # local state never leaves the rank
            if got is not None and got[1]:
                local = got[1]
        self._seed_native(maxv, g, local)
        telemetry.count("recovery.cold_restart", nbytes=len(g),
                        provenance="recovery")
        events.emit("recovery.cold_restart",
                    f"resumed at checkpoint version {maxv} "
                    f"(holder rank {root})", rank=self.rank)
        log.log_warn("cold restart: resumed at checkpoint version %d "
                     "(holder rank %d)", maxv, root)
        return (maxv, g, local)

    def _seed_native(self, abs_v: int, global_bytes: bytes,
                     local_bytes: Optional[bytes]) -> None:
        payload = ckpt_store.encode_record(abs_v, global_bytes)
        rc = self._lib.RbtCheckpoint(
            payload, len(payload),
            local_bytes, 0 if local_bytes is None else len(local_bytes))
        self._check(rc, "checkpoint(cold-restart seed)")
        self._version_offset = abs_v - int(self._lib.RbtVersionNumber())

    def checkpoint(self, global_bytes: bytes,
                   local_bytes: Optional[bytes] = None) -> None:
        payload, abs_v = global_bytes, 0
        if self._store is not None:
            # wrap the absolute version INSIDE the replicated payload: it
            # then rides the ring's own replication/replay machinery
            abs_v = self.version_number + 1
            payload = ckpt_store.encode_record(abs_v, global_bytes)
        rc = self._lib.RbtCheckpoint(
            payload, len(payload),
            local_bytes, 0 if local_bytes is None else len(local_bytes))
        self._check(rc, "checkpoint")
        if self._store is not None:
            self._store.save(abs_v, global_bytes, local_bytes or b"")

    def lazy_checkpoint(self, make_global: Callable[[], bytes]) -> None:
        payload = make_global()  # Python can't defer across the ABI safely
        wrapped, abs_v = payload, 0
        if self._store is not None:
            abs_v = self.version_number + 1
            wrapped = ckpt_store.encode_record(abs_v, payload)
        rc = self._lib.RbtLazyCheckpoint(wrapped, len(wrapped))
        self._check(rc, "lazy_checkpoint")
        if self._store is not None:
            self._store.save(abs_v, payload)

    def tracker_print(self, msg: str) -> None:
        # one-shot control-plane command over a fresh tracker connection:
        # ride out a brief tracker outage; a duplicate line is harmless
        retry.retry_call(
            lambda: self._check(self._lib.RbtTrackerPrint(msg.encode()),
                                "tracker_print"),
            attempts=6, base_s=0.4, max_s=4.0,
            retry_on=(RuntimeError,), desc="tracker_print")

    def init_after_exception(self) -> None:
        try:
            self._check(self._lib.RbtInitAfterException(),
                        "init_after_exception")
        except RuntimeError as e:
            if "robust engine" in str(e):
                # same signal as the Python-side engines (base.py)
                raise NotImplementedError(str(e)) from None
            raise

    def resize(self, cmd: str = "recover") -> None:
        """In-process world resize: re-register with the tracker and
        rebuild the native link topology (``RbtResize`` ->
        ``ReconnectLinks``; the data plane drops its world at the new
        epoch and forms the next one at its first collective), then run
        :meth:`epoch_reset` -- so a shrink or a grow never spends a
        respawn. The rank and world size this engine reports may both
        change; recovery state keyed on the old world is reset in C++,
        while checkpoints and the version counter survive."""
        if cmd not in ("recover", "join"):
            raise ValueError(f"resize cmd must be 'recover' or 'join', "
                             f"got {cmd!r}")
        from ..telemetry import flight as _fl
        old_world = self.world_size
        with self._watchdog.guard("engine.resize",
                                  on_expire=self._rung_retry,
                                  on_reform=self._rung_reform), \
                telemetry.span("engine.resize", op=cmd,
                               provenance="membership"):
            self._check(self._lib.RbtResize(cmd.encode()), "resize")
        self._drain_recovery_stats()
        world = self.world_size
        log.set_identity(self.rank, world)
        if self.is_distributed:
            note_identity(self.rank)   # the new epoch may have renamed it
        self.epoch_reset(world)
        _fl.note("native_resize",
                 f"{cmd}: world {old_world} -> {world} "
                 f"(rank {self.rank}, epoch {self.world_epoch})")

    @property
    def rank(self) -> int:
        r = self._lib.RbtGetRank()
        if r < 0:
            self._check(-1, "get_rank")
        return r

    @property
    def world_size(self) -> int:
        w = self._lib.RbtGetWorldSize()
        if w < 0:
            self._check(-1, "get_world_size")
        return w

    @property
    def is_distributed(self) -> bool:
        return bool(self._lib.RbtIsDistributed())

    @property
    def version_number(self) -> int:
        v = self._lib.RbtVersionNumber()
        if v < 0:
            self._check(-1, "version_number")
        # absolute (durable) version: the native counter restarts at 0
        # on cold restart; the offset recovered in load_checkpoint keeps
        # the app-visible sequence monotonic across world restarts
        return v + self._version_offset if v > 0 else v
