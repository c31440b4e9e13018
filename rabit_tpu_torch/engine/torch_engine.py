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

``rabit_device`` picks the device: ``cuda`` unless told ``cpu``; asking
for the card where there is none raises. The schedule and the wire of
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

Checkpoints are kept in memory.

Not ported yet: telemetry, the watchdog, async dispatch, the durable
checkpoint store.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .base import Engine
from ..convert import numpy_from_tensor
from ..parallel import collectives as C
from ..parallel import dispatch, topology
from ..parallel import wire as wirespec
from ..parallel.mesh import make_group
from ..utils.config import Config


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

    def init(self, args: List[str]) -> None:
        cfg = Config.from_args(args)
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
        self._owns_group = not dist.is_initialized()
        self._group, self._device = make_group(
            device, rank=rank, world_size=world, init_method=init_method)
        self._rank = dist.get_rank(self._group)
        self._world = dist.get_world_size(self._group)
        self._epoch_reset()
        self._groups = topology.resolve_groups(
            self._world, spec=cfg.get("rabit_hier_group"))

    def _epoch_reset(self) -> None:
        """Drop what the last world left behind: the parsed dispatch
        table and a grouping that does not describe this world."""
        topology.epoch_reset(self._world)
        dispatch.epoch_reset(self._world)

    def shutdown(self) -> None:
        if self._owns_group and dist.is_initialized():
            dist.destroy_process_group()
        self._group = None
        self._owns_group = False
        self._epoch_reset()

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
        method, wire = self._resolve_method_wire(buf.size)
        C.allreduce_numpy(buf, self._group, op, self._device, method=method,
                          wire=wire, groups=self._groups)

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
        # Two phases like the reference binding (rabit.py:171-206):
        # the length, then the payload.
        is_root = self._rank == root
        nlen = torch.tensor([len(data) if is_root else 0],
                            dtype=torch.int64, device=self._device)
        size = int(C.bcast_from_root(nlen, self._group, root).item())
        payload = (torch.frombuffer(bytearray(data), dtype=torch.uint8)
                   if is_root and size else
                   torch.zeros(size, dtype=torch.uint8))
        out = C.bcast_from_root(payload.to(self._device), self._group, root)
        return numpy_from_tensor(out, np.dtype(np.uint8)).tobytes()

    # -- checkpointing ----------------------------------------------------
    # In memory, like the reference's global_checkpoint string
    # (allreduce_robust.cc:443-451).
    def load_checkpoint(self, with_local: bool = False
                        ) -> Tuple[int, Optional[bytes], Optional[bytes]]:
        if self._lazy is not None:
            self._global, self._lazy = self._lazy(), None
        return (self._version, self._global, self._local)

    def checkpoint(self, global_bytes: bytes,
                   local_bytes: Optional[bytes] = None) -> None:
        self._global = global_bytes
        self._local = local_bytes
        self._lazy = None
        self._version += 1

    def lazy_checkpoint(self, make_global: Callable[[], bytes]) -> None:
        self._lazy = make_global
        self._local = None
        self._version += 1

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
