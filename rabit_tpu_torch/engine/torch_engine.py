"""Torch engine — the port's data plane behind the rabit host API, the
counterpart of ``rabit_tpu/engine/xla.py::XlaEngine``.

Rank and world come from ``rabit_coordinator`` (``host:port``) with
``rabit_num_processes`` / ``rabit_process_id``, as in the XLA engine, or
from the usual ``torch.distributed`` environment (``MASTER_ADDR``,
``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); an already initialised
``torch.distributed`` is adopted. Each host buffer is staged onto this
rank's device, reduced over the process group (NCCL on the card, gloo on
the CPU), and copied back in place — the reference's in-place
``sendrecvbuf`` contract (engine.h:74-96).

``rabit_device`` picks the device: ``cuda`` unless told ``cpu`` (rank r
of a world it forms on card r % cards, as the data plane places them);
asking for the card where there is none raises. The schedule and the wire of
each allreduce follow ``XlaEngine``'s keys (``engine/xla.py:102-132``):

* ``rabit_reduce_method``: ``auto`` (the default) or one of
  ``dispatch.METHODS``; ``auto`` asks ``dispatch.resolve``, which reads
  the port's measured table, else the 32768-element crossover;
* ``rabit_reduce_ring_mincount``: when set, pins the legacy two-way
  crossover (ring at and above it, tree below) in place of the table;
* ``rabit_dataplane_wire`` (a ``parallel/wire.py`` spec) engages only
  for payloads of at least ``rabit_dataplane_wire_mincount`` elements;
* ``rabit_hier_group`` (else ``RABIT_HIER_GROUP``): the host grouping
  of the ``hier`` schedule, resolved once at init.

Each allreduce goes through ``collectives.allreduce_numpy``, the helper
the robust engine's data plane shares: ``rabit_reduce_method=hier`` runs
``hier_allreduce`` on the init grouping (as ``XlaEngine`` runs
``device_hier_allreduce``), every other method the dispatcher.

``reduce_scatter`` and ``allgather`` stage the buffer the same way and
run ``collectives.device_reduce_scatter`` / ``device_allgather`` (rank i
owns chunk i; the rank-order concatenation). ``allreduce_async`` runs
the allreduce on one worker thread, a FIFO, so that the async
collectives keep their issue order on every rank; every synchronous
collective and ``shutdown`` first waits out what that worker holds, so
the process issues one global order (``engine/xla.py``'s rule). At
world 1 the handle is complete at issue. ``init`` exports
``rabit_async_collectives`` and ``rabit_async_max_inflight`` to the
environment (``collectives.configure_async``) for the models' async
steps.

Checkpoints are kept in memory and, with ``rabit_ckpt_dir``, also in the
durable store (``engine/ckpt_store.py``, ``rabit_ckpt_keep`` versions a
rank), as ``XlaEngine`` keeps them (``engine/xla.py:555-623``): each
``checkpoint`` and each lazy checkpoint once materialised lands on disk,
and a fresh process's ``load_checkpoint`` at version 0 resumes the
newest stored version the world agrees on (``_cold_restart``).
``rabit_debug`` opens the debug log, as in the native engine.

Telemetry (``XlaEngine``'s wiring, ``engine/xla.py``): ``init`` applies
``rabit_telemetry``, ``rabit_profile`` and ``rabit_events``
(``telemetry.configure``, ``profile.configure``); each collective of a
world above 1 records its ``engine.*`` span with a round id (the async
allreduce: an ``engine.allreduce.issue`` span and an ``async.issued``
count at issue, the real span with its exposed/overlapped split at
``wait()``); a cold restart counts ``recovery.cold_restart``; ``shutdown``
stops the memory poller, writes this rank's summary and Chrome trace into
``RABIT_TELEMETRY_EXPORT`` and ships the summary to the tracker when one
is named (``RABIT_TRACKER_URI``).

The live plane and the skew plane (``XlaEngine``'s wiring,
``engine/xla.py:173-191``, ``:222-236``, ``:318-323``):
``rabit_metrics_port`` starts this rank's metrics endpoint
(``telemetry/live.py``: ``/metrics`` with ``slo.rank_gauges``,
``/healthz``, ``/summary``) and, at world > 1, announces it to the
tracker named by ``RABIT_TRACKER_URI`` (the ``endpoint`` command), whose
poll loop scrapes it; the ``rabit_skew_*`` knobs and, with
``rabit_skew_adapt``, the tracker's address (``RABIT_SKEW_TRACKER``) are
exported to the environment for the collectives (the native engine's
``_export_skew``) and undone at shutdown; every world (re)set calls
``skew.epoch_reset``; an allreduce's span carries the skew plan it ran
(``adapted``). Adapted schedules agree at boundaries that every rank
reaches in program order: the async worker is drained before each
synchronous collective, so both threads' collectives form one order.

The watchdog and the flight recorder (``XlaEngine``'s wiring,
``engine/xla.py:133-213``, ``:348-384``, ``:460-479``):
``rabit_deadline_ms`` (with ``rabit_deadline_ms_per_mb`` and
``rabit_watchdog_abort``, ``utils/watchdog.py``) guards ``allreduce``,
``reduce_scatter``, ``allgather`` and each phase of a ``hier`` allreduce
(its deadline scaled by ``rabit_hier_phase_deadline_scale``); an
``allreduce_async`` arms its guard at issue and the worker disarms it when
the op ends. As in ``XlaEngine`` the guards carry no hooks: a stall climbs
the ladder's counters, events and notes to the abort (exit 86), or, with
``rabit_watchdog_abort=0``, stops at the reform rung and drops the guard.
``rabit_flight_dir`` (``rabit_flight_keep`` bundles a rank,
``telemetry/flight.py``) installs the flight recorder with the live
plane; ``shutdown`` uninstalls it.

The hot standby (``RABIT_TRACKER_STANDBY``) is the launcher's and the
skew poller's, as in ``XlaEngine``: nothing here reads or refuses it.
"""

from __future__ import annotations

import os
import time
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from . import ckpt_store
from .base import (AllreduceHandle, Engine, EnvExports, export_skew,
                   note_identity, start_live_plane)
from .. import telemetry
from ..convert import numpy_from_tensor, tensor_from_numpy
from ..ops.reducers import MAX, MIN, OP_NAMES
from ..telemetry import events
from ..telemetry import profile as _profile
from ..telemetry import skew as _skew
from ..parallel import collectives as C
from ..parallel import dispatch, topology
from ..parallel import wire as wirespec
from ..parallel.mesh import make_group
from ..utils import log
from ..utils.config import Config
from ..utils.watchdog import Watchdog, scale_deadline_s


class TorchEngine(Engine):
    def __init__(self) -> None:
        self._rank = 0
        self._world = 1
        self._group: Optional[dist.ProcessGroup] = None
        self._device: Optional[torch.device] = None
        self._owns_group = False
        self._ring_mincount: Optional[int] = None
        self._method = "auto"
        self._wire: Optional[str] = None
        self._wire_mincount = dispatch.WIRE_MINCOUNT_DEFAULT
        self._groups = None
        self._global: Optional[bytes] = None
        self._local: Optional[bytes] = None
        self._lazy: Optional[Callable[[], bytes]] = None
        self._version = 0
        # durable cold-restart mirror (rabit_ckpt_dir); None = memory only
        self._store: Optional[ckpt_store.CheckpointStore] = None
        self._async_ex: Optional[ThreadPoolExecutor] = None
        self._async_pending: List[Future] = []
        # config params exported to the environment, undone at shutdown
        self._env = EnvExports()
        # the per-rank metrics endpoint (rabit_metrics_port), or None
        self._metrics_server = None
        self._watchdog = Watchdog()  # disabled until init reads config
        self._hier_scale = 1.0
        # the flight recorder (rabit_flight_dir), or None
        self._flight = None

    def init(self, args: List[str]) -> None:
        cfg = Config.from_args(args)
        telemetry.configure(cfg)
        _profile.configure(cfg)
        C.configure_async(cfg)
        try:
            self._init(cfg)
        except BaseException:
            # a failed init leaves no exported knob behind
            self._env.restore()
            raise

    def _init(self, cfg: Config) -> None:
        export_skew(self._env, cfg)
        device = cfg.get("rabit_device") or None
        coord = cfg.get("rabit_coordinator")
        nproc = cfg.get_int("rabit_num_processes", 0)
        if coord and nproc > 0:
            rank, world = cfg.get_int("rabit_process_id", 0), nproc
            init_method = f"tcp://{coord}"
        elif "WORLD_SIZE" in os.environ:
            rank = int(os.environ.get("RANK", "0"))
            world = int(os.environ["WORLD_SIZE"])
            init_method = "env://" if world > 1 else None
        else:
            rank, world, init_method = 0, 1, None
        # the schedule keys are checked before any group is set up
        # an explicit rabit_reduce_ring_mincount pins the legacy two-way
        # crossover; otherwise method="auto" consults the dispatch table
        mincount = cfg.get("rabit_reduce_ring_mincount")
        self._ring_mincount = None if mincount is None else int(mincount)
        self._method = cfg.get("rabit_reduce_method", "auto") or "auto"
        if self._method != "auto" and self._method not in dispatch.METHODS:
            raise ValueError(
                f"rabit_reduce_method must be one of "
                f"{('auto',) + dispatch.METHODS}, got {self._method!r}")
        wire = cfg.get("rabit_dataplane_wire", "") or None
        if wire is not None:
            try:
                wire = wirespec.canonical_wire(wire)
            except ValueError as e:
                raise ValueError(f"rabit_dataplane_wire: {e}") from None
        self._wire = wire
        self._wire_mincount = cfg.get_size(
            "rabit_dataplane_wire_mincount", dispatch.WIRE_MINCOUNT_DEFAULT)
        # each hier phase moves ~1/g (intra) or ~1/H (inter) of the flat
        # payload, so a deployment can tighten the phases' deadlines below
        # the whole collective's
        self._hier_scale = float(
            cfg.get("rabit_hier_phase_deadline_scale", 1.0) or 1.0)
        self._watchdog = Watchdog.from_config(cfg)
        self._owns_group = not dist.is_initialized()
        if device in (None, "cuda") and world > 1 and self._owns_group and \
                torch.cuda.is_available():
            # one rank a card, as the data plane places them: NCCL
            # refuses two ranks of a world on one device (a card named
            # without its index means the same as none named)
            device = f"cuda:{rank % torch.cuda.device_count()}"
        self._group, self._device = make_group(
            device, rank=rank, world_size=world, init_method=init_method)
        self._rank = dist.get_rank(self._group)
        self._world = dist.get_world_size(self._group)
        self._epoch_reset()
        self._groups = topology.resolve_groups(
            self._world, spec=cfg.get("rabit_hier_group"))
        log.set_debug(cfg.get_bool("rabit_debug"))
        log.set_identity(self._rank, self._world)
        ckpt_dir = cfg.get("rabit_ckpt_dir")
        if ckpt_dir:
            self._store = ckpt_store.CheckpointStore(
                ckpt_dir, rank=self._rank,
                keep=cfg.get_int("rabit_ckpt_keep", ckpt_store.DEFAULT_KEEP))
        from ..telemetry import flight
        self._flight = flight.FlightRecorder.from_config(cfg, rank=self._rank)
        self._metrics_server = start_live_plane(
            cfg, self._rank, self._world, self._live_gauges,
            announce=self._world > 1)
        if self._world > 1:
            note_identity(self._rank)

    def _live_gauges(self) -> list:
        """The watchdog's expiries and this rank's SLO burn on
        ``/metrics`` (``telemetry/slo.py``: its p99 collective latency
        against the fleet objective)."""
        from ..telemetry import slo as _slo
        return [("rabit_watchdog_expired_total",
                 "Watchdog deadline expiries in this process.", "counter",
                 [({}, self._watchdog.expired_total)]),
                *_slo.rank_gauges()]

    def _hier_phase_guard(self, name: str, nbytes: int):
        """A hier phase's guard: the usual payload-proportional deadline
        times ``rabit_hier_phase_deadline_scale`` (a disabled watchdog
        still hands back the shared no-op guard)."""
        d = scale_deadline_s(nbytes, self._watchdog.floor_ms,
                             self._watchdog.ms_per_mb) * self._hier_scale
        return self._watchdog.guard(name, nbytes=nbytes, deadline_s=d)

    def _epoch_reset(self) -> None:
        """Drop what the last world left behind: the parsed dispatch
        table, a grouping that does not describe this world, and the skew
        plane's agreed digest, applied tag and dispatch counter."""
        topology.epoch_reset(self._world)
        dispatch.epoch_reset(self._world)
        _skew.epoch_reset(self._world)

    def epoch_reset(self, world: int) -> None:
        """The elastic-membership epoch hook (``XlaEngine.epoch_reset``):
        adopt a resized world and drop every piece of state derived from
        the old one. For this engine a resize always arrives through a
        fresh process group (the group is bound to its members for its
        life), so the hook's job is the state that OUTLIVES the group:
        the host grouping, the skew plane's agreed digest and dispatch
        counter, the dispatch table cache, the membership monitor's
        formed baseline, and the checkpoint store -- whose newest
        old-world version is pinned against pruning until the new world
        commits its first checkpoint, and which a re-admitted joiner
        seeds from its siblings' durable shards. Counts
        ``membership.epoch_reset``, records a zero-length
        ``membership.transition`` span, leaves a flight note and emits
        the event."""
        from ..telemetry import flight as _fl
        from ..tracker import membership as _membership
        world = int(world)
        old, self._world = self._world, world
        self._epoch_reset()
        _membership.epoch_reset(world)
        self._groups = topology.resolve_groups(world)
        log.set_identity(self._rank, world)
        if self._store is not None:
            self._store.protect_current()
            self._store.adopt_latest_from_peers()
        telemetry.count("membership.epoch_reset", provenance="membership")
        telemetry.record_span("membership.transition", 0.0, op="resize",
                              provenance="membership", old_world=old,
                              world=world)
        _fl.note("member_resize", f"world {old} -> {world}")
        events.emit("membership.epoch_reset", f"world {old} -> {world}",
                    rank=self._rank)

    def shutdown(self) -> None:
        try:
            self._drain_async()
        finally:
            if self._async_ex is not None:
                self._async_ex.shutdown(wait=True)
                self._async_ex = None
        if self._metrics_server is not None:
            self._metrics_server.stop()
            self._metrics_server = None
        if self._flight is not None:
            self._flight.uninstall()
            self._flight = None
        self._watchdog.close()
        _profile.stop_poller()
        if telemetry.enabled():
            telemetry.export_at_shutdown(self._rank, self._world)
            if self._world > 1:
                telemetry.ship_to_tracker(self._rank, self._world)
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._group = None
        self._owns_group = False
        self._epoch_reset()
        self._env.restore()

    @property
    def device(self) -> torch.device:
        return self._device

    @property
    def group(self) -> Optional[dist.ProcessGroup]:
        return self._group

    # -- collectives ------------------------------------------------------
    def allreduce(self, buf: np.ndarray, op: int,
                  prepare_fun: Optional[Callable[[], None]] = None,
                  key: str = "") -> None:
        if prepare_fun is not None:
            prepare_fun()
        if self._world == 1:
            return
        self._drain_async()
        method, wire = self._resolve_method_wire(buf.size)
        sp = telemetry.span("engine.allreduce", nbytes=buf.nbytes,
                            op=OP_NAMES.get(op, str(op)), method=method,
                            wire=wire, round=telemetry.collective_round(
                                "engine.allreduce"))
        with self._watchdog.guard("engine.allreduce", nbytes=buf.nbytes), sp:
            self._allreduce_now(buf, op, method, wire)
            if sp.live:
                # the skew plan the device layer applied, for cross-rank
                # stitching (telemetry/crossrank.py)
                tag = _skew.last_applied()
                if tag:
                    sp.attrs["adapted"] = tag

    def _allreduce_now(self, buf: np.ndarray, op: int, method: str,
                       wire: Optional[str]) -> None:
        C.allreduce_numpy(buf, self._group, op, self._device, method=method,
                          wire=wire, groups=self._groups,
                          phase_guard=self._hier_phase_guard)

    def allreduce_async(self, buf: np.ndarray, op: int,
                        prepare_fun: Optional[Callable[[], None]] = None,
                        key: str = "") -> AllreduceHandle:
        """Issue the allreduce of ``buf`` (in place) on the engine's
        worker and return a handle; the caller's thread goes on while it
        runs. The watchdog's guard arms now and disarms when the op ends,
        so every op in flight keeps its deadline. ``buf`` must be left
        alone until ``wait()`` returns it."""
        if prepare_fun is not None:
            prepare_fun()
        if self._world == 1:
            return AllreduceHandle(value=buf)
        method, wire = self._resolve_method_wire(buf.size)
        opname, nbytes = OP_NAMES.get(op, str(op)), buf.nbytes
        rnd = telemetry.collective_round("engine.allreduce")
        telemetry.count("async.issued", nbytes=nbytes, op=opname,
                        method=method, wire=wire, provenance="engine")
        guard = self._watchdog.guard("engine.allreduce", nbytes=nbytes)
        guard.__enter__()
        t_issue = time.perf_counter()

        def task():
            try:
                self._allreduce_now(buf, op, method, wire)
            finally:
                guard.__exit__(None, None, None)

        with telemetry.span("engine.allreduce.issue", nbytes=nbytes,
                            op=opname, method=method, wire=wire, round=rnd):
            fut = self._async_executor().submit(task)
        self._async_pending.append(fut)

        def wait_fn():
            t_wait = time.perf_counter()
            try:
                fut.result()
            finally:
                self._forget(fut)
            t_done = time.perf_counter()
            exposed = t_done - t_wait
            overlapped = max(0.0, (t_done - t_issue) - exposed)
            telemetry.record_span(
                "engine.allreduce", t_done - t_issue, nbytes=nbytes,
                op=opname, method=method, wire=wire, provenance="engine",
                **{"round": rnd, "async": 1,
                   "wire_exposed_ms": exposed * 1e3,
                   "wire_overlapped_ms": overlapped * 1e3})
            _profile.record_overlap("engine.allreduce", method, exposed,
                                    overlapped)
            return buf

        return AllreduceHandle(wait_fn=wait_fn, ready_fn=fut.done)

    def _async_executor(self) -> ThreadPoolExecutor:
        """One worker on purpose: a FIFO keeps the async collectives in
        issue order in every process; several workers could order them
        differently on two ranks and hang the world."""
        if self._async_ex is None:
            device = self._device
            init = (lambda: torch.cuda.set_device(device)) \
                if device.type == "cuda" else None
            self._async_ex = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="rabit-async",
                initializer=init)
        return self._async_ex

    def _forget(self, fut: Future) -> None:
        try:
            self._async_pending.remove(fut)
        except ValueError:
            pass

    def _drain_async(self) -> None:
        """The fence before a synchronous collective: wait out the async
        queue, so every process issues one global order. A failure raises
        here, and again from the failed handle's ``wait()``."""
        while self._async_pending:
            fut = self._async_pending[0]
            try:
                fut.result()
            finally:
                self._forget(fut)

    def reduce_scatter(self, buf: np.ndarray, op: int) -> np.ndarray:
        """This rank's chunk of the reduction (``n/p`` elements from
        ``rank*n/p``), by the ring reduce-scatter on the device, which
        ships 1/p of the allreduce's bytes. ``buf`` is left as it is."""
        if self._world == 1:
            return buf.copy()
        self._drain_async()
        if buf.size % self._world:
            raise ValueError(
                f"reduce_scatter payload of {buf.size} elements must "
                f"divide by the world size {self._world}")
        with telemetry.span("engine.reduce_scatter", nbytes=buf.nbytes,
                            op=OP_NAMES.get(op, str(op)), method="ring",
                            round=telemetry.collective_round(
                                "engine.reduce_scatter")), \
                self._watchdog.guard("engine.reduce_scatter",
                                     nbytes=buf.nbytes):
            return self._device_collective(
                buf, lambda x: C.device_reduce_scatter(x, self._group, op))

    def allgather(self, buf: np.ndarray) -> np.ndarray:
        """The rank-order concatenation of every rank's ``buf``, by the
        ring all-gather on the device."""
        if self._world == 1:
            return buf.reshape(-1).copy()
        self._drain_async()
        nbytes = buf.nbytes * self._world
        with telemetry.span("engine.allgather", nbytes=nbytes, method="ring",
                            round=telemetry.collective_round(
                                "engine.allgather")), \
                self._watchdog.guard("engine.allgather", nbytes=nbytes):
            return self._device_collective(
                buf, lambda x: C.device_allgather(x, self._group))

    def _device_collective(self, buf: np.ndarray, fn) -> np.ndarray:
        """``fn`` on ``buf`` staged onto the device as
        ``allreduce_numpy`` stages it; the result back on the host."""
        x = tensor_from_numpy(buf.reshape(-1)).to(self._device)
        return numpy_from_tensor(fn(x), buf.dtype).copy()

    def _resolve_method_wire(self, n: int) -> Tuple[str, Optional[str]]:
        """``XlaEngine._resolve_method_wire``: the pinned crossover where
        one is set, and the configured wire only above its size gate
        (below it the payload runs unquantized)."""
        method = self._method
        if method == "auto" and self._ring_mincount is not None:
            method = "ring" if n >= self._ring_mincount else "tree"
        wire = self._wire if (self._wire and n >= self._wire_mincount) \
            else None
        return method, wire

    def broadcast(self, data: Optional[bytes], root: int) -> bytes:
        if self._world == 1:
            if data is None:
                raise ValueError(
                    "single-process broadcast must originate data")
            return data
        # Two phases like the reference binding (rabit.py:171-206) and
        # XlaEngine: the length by a MAX allreduce, then the payload.
        is_root = self._rank == root
        nlen = np.array([len(data) if is_root else 0], dtype=np.int64)
        self.allreduce(nlen, MAX)
        size = int(nlen[0])
        payload = (torch.frombuffer(bytearray(data), dtype=torch.uint8)
                   if is_root and size else
                   torch.zeros(size, dtype=torch.uint8))
        with telemetry.span("engine.broadcast", nbytes=size, root=root,
                            round=telemetry.collective_round(
                                "engine.broadcast")):
            out = C.device_broadcast(payload.to(self._device), self._group,
                                     root)
        return numpy_from_tensor(out, np.dtype(np.uint8)).tobytes()

    # -- checkpointing ----------------------------------------------------
    # In memory, like the reference's global_checkpoint string
    # (allreduce_robust.cc:443-451), and mirrored to the durable store when
    # rabit_ckpt_dir is set.
    def load_checkpoint(self, with_local: bool = False
                        ) -> Tuple[int, Optional[bytes], Optional[bytes]]:
        self._materialize_lazy()
        if self._version == 0 and self._store is not None:
            self._cold_restart(with_local)
        return (self._version, self._global, self._local)

    def _cold_restart(self, with_local: bool) -> None:
        """A fresh process with a durable store resumes the newest stored
        version the world agrees on (``XlaEngine._cold_restart``): at
        world 1 its own newest; else the allreduce MAX of each rank's
        newest version, the MIN of the ranks that hold it, and a
        broadcast of that rank's global bytes, so every rank resumes the
        same version even where some disks lag. Local state never leaves
        its rank."""
        store = self._store
        if self._world == 1:
            got = store.latest()
            if got is not None:
                self._version, self._global = got[0], got[1]
                self._local = got[2] or None
            return
        mine = store.latest_version()
        word = np.array([mine], dtype=np.int64)
        self.allreduce(word, MAX)
        maxv = int(word[0])
        if maxv <= 0:
            return
        word[0] = self._rank if mine >= maxv else self._world
        self.allreduce(word, MIN)
        root = int(word[0])
        payload = None
        if self._rank == root:
            got = store.load(maxv)
            payload = got[0] if got is not None else b""
        self._global = self.broadcast(payload, root)
        self._version = maxv
        if with_local:
            got = store.load(maxv)
            self._local = (got[1] or None) if got is not None else None
        log.log_info("cold restart: resumed at checkpoint version %d "
                     "(holder rank %d)", maxv, root)
        telemetry.count("recovery.cold_restart",
                        nbytes=len(self._global), provenance="recovery")
        events.emit("recovery.cold_restart",
                    f"resumed at checkpoint version {maxv} "
                    f"(holder rank {root})", rank=self._rank)

    def checkpoint(self, global_bytes: bytes,
                   local_bytes: Optional[bytes] = None) -> None:
        self._global = global_bytes
        self._local = local_bytes
        self._lazy = None
        self._version += 1
        if self._store is not None:
            self._store.save(self._version, global_bytes,
                             local_bytes or b"")

    def lazy_checkpoint(self, make_global: Callable[[], bytes]) -> None:
        self._lazy = make_global
        self._local = None
        self._version += 1

    def _materialize_lazy(self) -> None:
        if self._lazy is not None:
            self._global, self._lazy = self._lazy(), None
            if self._store is not None:
                self._store.save(self._version, self._global)

    def restore_checkpoint(self, version: int, global_bytes: Optional[bytes],
                           local_bytes: Optional[bytes] = None) -> None:
        super().restore_checkpoint(version, global_bytes, local_bytes)
        self._lazy = None

    # -- properties -------------------------------------------------------
    @property
    def rank(self) -> int:
        return self._rank

    @property
    def world_size(self) -> int:
        return self._world
