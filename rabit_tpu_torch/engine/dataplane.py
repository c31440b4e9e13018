"""Torch data plane behind the robust native engine: the port of
``rabit_tpu/engine/dataplane.py`` (``XlaDataPlane``). Collectives run
over a ``torch.distributed`` world (NCCL on the card, gloo with
``rabit_device=cpu``) while the C++ host control plane keeps consensus,
result replay, prepare-skip and checkpoint recovery (the wrapper
structure of the reference's AllreduceRobust around its TryAllreduce
data plane, allreduce_robust.cc:159-219).

Lifecycle: a process group has fixed membership — a dead participant
hangs or fails its collectives. The tracker therefore stamps every
link-(re)registration batch with an ``epoch`` and, when a worker's
registration asks for it, hosts one ``TCPStore`` per epoch (the port's
tracker, ``tracker/tracker.py``); the C++ engine passes the current
epoch into every data-plane call. When the epoch has advanced past the
world this process last formed, the callback aborts the old group and
forms a new one in that epoch's store. Because the robust protocol only
executes a collective when every rank is aligned at the same op, all
live ranks enter the formation together. Each formation keys its
rendezvous by values every rank agrees on — the epoch, the round within
the epoch and the attempt — so a re-formation at the same epoch (the
retry rung) never meets the first formation's keys (NCCL's unique id
among them).

Failure mapping: any exception here returns nonzero to C++, which treats
it like a link reset — reconnect (advancing the epoch), replay, retry.
Nothing unwinds into C.

A dead peer on NCCL: a collective whose peer died does not fail, it
waits. The data plane forms NCCL groups with blocking waits
(``TORCH_NCCL_BLOCKING_WAIT=1``) and a timeout (``TIMEOUT_S``): the wait
raises into ``_invoke`` once the timeout passes and the communicator is
aborted. The watchdog is told to clean up only
(``TORCH_NCCL_ASYNC_ERROR_HANDLING=2``), so it aborts the communicator
but does not end the process — PyTorch's default ends it, which would
take the survivors with the dead peer (the NCCL analogue of jaxlib's
``LOG(FATAL)``). gloo raises at once when a peer's socket closes.

Telemetry (``rabit_tpu_torch.telemetry``, configured by the engine): each
allreduce records a ``dataplane.allreduce`` span with its round id and
the requested wire (``wire_requested``); each formation records a
``recovery.world_reform`` span (its seconds, the epoch, whether the
process had a world before), and a formation at a new epoch in a process
that had one counts ``recovery.epoch_advance``; a retry counts
``recovery.retry`` and an exhausted one ``recovery.link_reset``, each
with a fleet event when ``rabit_events`` is on (the JAX data plane's
records, ``engine/dataplane.py:237``, ``:288``, ``:369``, ``:402``); the
same three recovery steps go to the flight recorder's ring
(``telemetry/flight.py``: ``recovery.retry`` at each failed attempt and
after a round recovered in place, with the result's CRC; ``link_reset``
when the retries are spent).

The watchdog's retry rung (``engine/native.py::_rung_retry``) calls
:meth:`TorchDataPlane.abort` from its monitor thread while this process's
thread may be blocked inside ``_invoke``'s collective. It only marks the
world aborted: ``_invoke``'s thread fails the round in flight once its
collective ends, however it ends (the stalled peer arrives; NCCL's
blocking wait times out at ``TIMEOUT_S``; a dead peer's socket closes),
or the next round, and tears the group down itself, so no teardown races
a blocked wait. Every rank whose rung fired fails the same round, and the
round replays (a link reset, or an in-place retry with
``RABIT_COLLECTIVE_RETRIES``). The communicators are not aborted from the
monitor thread: gloo's abort wakes no blocked wait and may close the
pairs under it, and over NCCL on four H100s an abort there ended the wait
at once but the processes' next NCCL world then failed its first
collective (``ncclProxyClientGetFd`` ... failed).

APPLICATION STATE CONTRACT: unlike the XLA data plane, whose re-formation
drops the backend client and invalidates every live ``jax.Array``,
re-forming a process group leaves CUDA tensors valid: only the
communicator goes. The ``on_world_reformed`` hook still fires with the
new epoch after each formation. The data plane owns the process's
default process group: the application must not create its own.
"""

from __future__ import annotations

import contextlib
import ctypes
import datetime
import os
import sys
import time
import zlib
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from .native import DATAPLANE_CB
from .. import telemetry
from ..ops.reducers import DTYPE_ENUM, OP_NAMES
from ..telemetry import events, flight
from ..telemetry import skew as _skew
from ..parallel import collectives as C
from ..parallel import dispatch, topology
from ..parallel import wire as wirespec
from ..parallel.mesh import resolve_device
from ..utils.retry import backoff_delay

_ENUM_DTYPE = {v: k for k, v in DTYPE_ENUM.items()}

# the process-group settings under which a failed NCCL collective raises
# into the caller and the process lives on (see the module docstring)
_NCCL_ENV = {"TORCH_NCCL_BLOCKING_WAIT": "1",
             "TORCH_NCCL_ASYNC_ERROR_HANDLING": "2"}
# how long a formation or a collective may take before it is taken for
# failed: the price of a peer that died inside a collective (failure
# detection is the engine's; a formation of four H100s takes 1-2 s)
TIMEOUT_S = 30


@contextlib.contextmanager
def _nccl_env():
    """Set ``_NCCL_ENV`` while a group is constructed (ProcessGroupNCCL
    reads it then), and put the environment back after."""
    saved = {k: os.environ.get(k) for k in _NCCL_ENV}
    os.environ.update(_NCCL_ENV)
    try:
        yield
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _abort_default_group() -> None:
    """Abort the default group's communicators, then destroy the group:
    a peer of that world may be dead, and an orderly destroy would wait
    for it."""
    if not dist.is_initialized():
        return
    try:
        dist.group.WORLD.abort()
    except (AttributeError, RuntimeError) as e:
        print(f"[dataplane] abort: {type(e).__name__}: {e}",
              file=sys.stderr, flush=True)
    dist.destroy_process_group()


class TorchDataPlane:
    """Callable registered through RbtSetDataPlane. One instance per
    NativeEngine; owns the torch world's lifecycle."""

    def __init__(self, lib: ctypes.CDLL, device=None) -> None:
        self._lib = lib
        # no fallback: "cuda" (the default) raises where there is no card
        self._device_spec = resolve_device(device)
        self._timeout = datetime.timedelta(seconds=TIMEOUT_S)
        self._formed_epoch: Optional[int] = None
        self._group: Optional[dist.ProcessGroup] = None
        self._device: Optional[torch.device] = None
        self._groups = None
        self._rank = 0
        self._world = 1
        self.backend: Optional[str] = None
        # fires with the epoch after each formation (see the state
        # contract above)
        self.on_world_reformed: Optional[Callable[[int], None]] = None
        # test hook: script one callback failure on a healthy world
        # (RABIT_DATAPLANE_FAIL_AT=<invocation index>) to exercise the
        # data-plane-only failure -> kReset -> epoch re-formation path
        fail_at = os.environ.get("RABIT_DATAPLANE_FAIL_AT")
        self._fail_at: Optional[int] = int(fail_at) if fail_at else None
        self._invocations = 0
        # the round within the epoch (a formation's rendezvous key): every
        # member of an epoch makes the same data-plane calls from its start
        self._round_epoch: Optional[int] = None
        self._epoch_round = 0
        # retry rung: with RABIT_COLLECTIVE_RETRIES=N > 0 a failed
        # collective is re-run in place up to N times from a cached copy
        # of its input — the world is re-formed at the SAME epoch, C++
        # never sees the failure. 0 (the default): the first failure
        # returns nonzero and becomes a link reset.
        retries = os.environ.get("RABIT_COLLECTIVE_RETRIES", "0")
        try:
            self._retries = max(0, int(retries))
        except ValueError as e:
            raise ValueError(
                f"RABIT_COLLECTIVE_RETRIES must be an integer, "
                f"got {retries!r}") from e
        self.retries_total = 0
        # formations made, the seconds the last one took, and the wall
        # clock (time.time) at its end and at the end of its first
        # collective: the recovery's timeline
        self.formations = 0
        self.form_seconds = 0.0
        self.formed_at: Optional[float] = None
        self.first_collective_at: Optional[float] = None
        # the epoch of the last formation, kept through teardowns
        self._last_epoch: Optional[int] = None
        # the watchdog's retry rung aborted this world (see abort)
        self._aborted = False
        # the wire (rabit_dataplane_wire) is validated here even though
        # dispatch reads the env itself: a typo must not silently run
        # unquantized while the user believes the wire is on
        wire = os.environ.get("RABIT_DATAPLANE_WIRE", "")
        if wire:
            try:
                wire = wirespec.canonical_wire(wire)
            except ValueError as e:
                raise ValueError(f"rabit_dataplane_wire: {e}") from None
        self._wire: Optional[str] = wire or None
        method = os.environ.get("RABIT_REDUCE_METHOD", "") or "auto"
        if method != "auto" and method not in dispatch.METHODS:
            raise ValueError(
                f"rabit_reduce_method must be one of "
                f"{('auto',) + dispatch.METHODS}, got {method!r}")
        self._method = method
        # the skew-adaptation knobs: validated here for the same reason
        # as the wire -- a garbage value must fail at init, not silently
        # disable adaptation mid-training; dispatch reads them live
        _skew.preagg_ms_per_mib()   # each raises ValueError on garbage
        _skew.poll_interval_s()
        _skew.sync_rounds()
        # keep the ctypes callback object alive for the C side
        self.c_callback = DATAPLANE_CB(self._invoke)

    # -- world lifecycle --------------------------------------------------
    def _coord_addr(self) -> str:
        buf = ctypes.create_string_buffer(256)
        ln = ctypes.c_size_t()
        rc = self._lib.RbtCoordAddr(buf, ctypes.byref(ln), 256)
        if rc != 0:
            raise RuntimeError("RbtCoordAddr failed")
        return buf.value.decode()

    def _teardown(self) -> None:
        self._group = None
        self._formed_epoch = None
        self._aborted = False
        _abort_default_group()

    def _form_world(self, epoch: int, round_id: int, attempt: int) -> None:
        t0 = time.perf_counter()
        reformed = self.formations > 0
        if self._last_epoch is not None and epoch != self._last_epoch:
            # the epoch advanced under this process: a peer died and the
            # fleet rewired
            telemetry.count("recovery.epoch_advance", provenance="recovery")
            events.emit("recovery.epoch_advance",
                        f"rank {self._rank} re-forming at epoch {epoch}",
                        rank=self._rank)
        self._teardown()
        self._rank = int(self._lib.RbtGetRank())
        self._world = int(self._lib.RbtGetWorldSize())
        host, _, port = self._coord_addr().rpartition(":")
        if port in ("", "0"):
            raise RuntimeError(
                "the tracker hosts no rendezvous store for this epoch "
                "(launch with rabit_dataplane=torch in the worker command "
                "or RABIT_DATAPLANE=torch in the environment, under "
                "rabit_tpu_torch.tracker)")
        dev = self._device_spec
        if dev.type == "cuda":
            # one rank a card (NCCL refuses two on one device); ranks are
            # stable across respawns, so is the card
            dev = torch.device("cuda", self._rank % torch.cuda.device_count())
            torch.cuda.set_device(dev)
            backend, kwargs = "nccl", {"device_id": dev}
        else:
            backend, kwargs = "gloo", {}
        store = dist.TCPStore(host, int(port), is_master=False,
                              timeout=self._timeout)
        key = f"rabit/e{epoch}/r{round_id}/a{attempt}"
        # torch names the default group by a counter that only a destroy
        # resets: a formation that failed on this rank alone (a store
        # timeout) would leave it ahead of the other ranks', and the next
        # formation's keys would never meet theirs
        dist.distributed_c10d._world.group_count = 0
        with _nccl_env():
            dist.init_process_group(
                backend, store=dist.PrefixStore(key, store), rank=self._rank,
                world_size=self._world, timeout=self._timeout, **kwargs)
        self._group = dist.group.WORLD
        self._device = dev
        self.backend = backend
        self._groups = topology.resolve_groups(self._world)
        self._formed_epoch = self._last_epoch = epoch
        # re-arm the skew agreement boundary: every process of the new
        # world passes here before its first collective, so the dispatch
        # counters restart together and the first dispatch re-agrees
        # before anything adapts (ranks may have been reassigned)
        _skew.reset_sync()
        self.formations += 1
        self.form_seconds = time.perf_counter() - t0
        self.formed_at, self.first_collective_at = time.time(), None
        telemetry.record_span("recovery.world_reform", self.form_seconds,
                              provenance="recovery", epoch=epoch,
                              reformed=reformed)
        if self.on_world_reformed is not None:
            self.on_world_reformed(epoch)

    def shutdown(self) -> None:
        if self._formed_epoch is None:
            return
        self._teardown()

    def abort(self) -> None:
        """The watchdog's retry rung, from its monitor thread: mark the
        world aborted; ``_invoke`` fails the round in flight once its
        collective ends (or the next round) and tears the group down on
        its own thread (see the module docstring)."""
        if self._formed_epoch is not None:
            self._aborted = True

    def _check_aborted(self) -> None:
        if self._aborted:
            # the round fails however its collective ended, so that every
            # rank whose rung fired replays it
            raise RuntimeError("the world was aborted by the watchdog's "
                               "retry rung")

    @property
    def formed(self) -> bool:
        return self._formed_epoch is not None

    @property
    def device(self) -> Optional[torch.device]:
        """The device of the formed world (None before the first)."""
        return self._device

    # -- the hook ---------------------------------------------------------
    def _invoke(self, buf_p, count, dtype, op, epoch, _ctx) -> int:
        if int(count) == 0 and int(op) < 0:
            # teardown sentinel from ReconnectLinks: the epoch advanced;
            # drop the old world NOW — before the ready ack — so the
            # tracker can reap old stores with no live client on them
            try:
                if self.formed:
                    self._teardown()
            except Exception as e:  # noqa: BLE001 - must not unwind into C
                print(f"[dataplane] teardown sentinel failed: {e}",
                      file=sys.stderr, flush=True)
            return 0
        epoch = int(epoch)
        if self._round_epoch != epoch:
            self._round_epoch, self._epoch_round = epoch, 0
        # round ids are globally aligned across ranks (the C++ robust
        # layer drives every rank through the same op sequence), which
        # makes a retry idempotent: every attempt of a round re-runs the
        # same reduction over the same cached inputs
        round_id = self._invocations
        pristine: Optional[np.ndarray] = None
        buf: Optional[np.ndarray] = None
        attempt = 0
        while True:
            try:
                if self._fail_at is not None and \
                        round_id == self._fail_at:
                    self._fail_at = None  # fire exactly once
                    raise RuntimeError("scripted dataplane failure "
                                       "(RABIT_DATAPLANE_FAIL_AT)")
                if buf is None:
                    self._invocations += 1
                    dt = _ENUM_DTYPE[int(dtype)]
                    nbytes = int(count) * dt.itemsize
                    raw = np.ctypeslib.as_array(
                        ctypes.cast(buf_p, ctypes.POINTER(ctypes.c_uint8)),
                        shape=(nbytes,))
                    buf = raw.view(dt)
                    if self._retries > 0:
                        # cache the round's input so a retry reduces the
                        # SAME operands (buf is reduced in place)
                        pristine = buf.copy()
                self._check_aborted()
                if self._formed_epoch != epoch:
                    self._form_world(epoch, self._epoch_round, attempt)
                self._allreduce(buf, int(op))
                self._check_aborted()
                self._epoch_round += 1
                if self.first_collective_at is None:
                    self.first_collective_at = time.time()
                if attempt > 0:
                    flight.note(
                        "recovery.retry",
                        f"rank {self._rank} round {round_id} recovered "
                        f"in-collective after {attempt} retr"
                        f"{'y' if attempt == 1 else 'ies'} "
                        f"crc={zlib.crc32(buf.tobytes()):08x}")
                return 0
            except Exception as e:  # noqa: BLE001 — must not unwind into C
                if attempt < self._retries:
                    # retry rung: restore the cached inputs, re-form the
                    # world at the SAME epoch (no membership change, no
                    # eviction), back off, re-run the round
                    attempt += 1
                    self.retries_total += 1
                    telemetry.count("recovery.retry", op="dataplane",
                                    provenance="recovery")
                    flight.note(
                        "recovery.retry",
                        f"rank {self._rank} round {round_id} attempt "
                        f"{attempt}/{self._retries}: "
                        f"{type(e).__name__}: {e}")
                    events.emit("recovery.retry",
                                f"rank {self._rank} round {round_id} attempt "
                                f"{attempt}/{self._retries}: "
                                f"{type(e).__name__}", rank=self._rank)
                    print(f"[dataplane] rank {self._rank} round {round_id} "
                          f"retry {attempt}/{self._retries} after "
                          f"{type(e).__name__}: {e}",
                          file=sys.stderr, flush=True)
                    if pristine is not None and buf is not None:
                        np.copyto(buf, pristine)
                    try:
                        self._teardown()
                    except Exception:  # noqa: BLE001 - best-effort
                        pass
                    time.sleep(backoff_delay(attempt - 1))
                    continue
                print(f"[dataplane] rank {self._rank} epoch {epoch} failed: "
                      f"{type(e).__name__}: {e}", file=sys.stderr,
                      flush=True)
                # retries exhausted (or disabled): the nonzero return
                # becomes a link reset on the C++ side
                telemetry.count("recovery.link_reset", op="dataplane",
                                provenance="recovery")
                flight.note("link_reset",
                            f"rank {self._rank} epoch {epoch}: "
                            f"{type(e).__name__}: {e}")
                events.emit("recovery.link_reset",
                            f"rank {self._rank} epoch {epoch}: "
                            f"{type(e).__name__}", rank=self._rank)
                try:
                    self._teardown()
                except Exception:  # noqa: BLE001 - best-effort
                    pass
                return 1

    def _allreduce(self, buf: np.ndarray, op: int) -> None:
        if self._world == 1:
            return
        if self._method == "hier":
            # the two-level schedule over RABIT_HIER_GROUP (exported by
            # the engine from the tracker's topology, or set explicitly)
            wire = self._wire if (self._wire and
                                  buf.size >= dispatch.wire_mincount()) \
                else None
        else:
            # "auto": the env-requested wire engages only at sizes where
            # the table or the mincount says it pays
            wire = "auto"
        # the span records the wire REQUEST and, once the call is done,
        # the OUTCOME: the wire dispatch resolved and the skew plan applied
        with telemetry.span(
                "dataplane.allreduce", nbytes=buf.nbytes,
                op=OP_NAMES.get(op, str(op)), method=self._method,
                wire_requested=os.environ.get("RABIT_DATAPLANE_WIRE", "")
                or "off",
                round=telemetry.collective_round("dataplane.allreduce")
        ) as sp:
            C.allreduce_numpy(buf, self._group, op, self._device,
                              method=self._method, wire=wire,
                              groups=self._groups)
            if sp.live:
                # label adapted rounds for cross-rank stitching
                tag = _skew.last_applied()
                if tag:
                    sp.attrs["adapted"] = tag
                sp.attrs["wire_applied"] = dispatch.last_wire() or "off"
