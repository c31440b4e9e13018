"""Single-process engine: rank 0, world 1, collectives are identity but
``prepare_fun`` still runs — exact semantics of the reference EmptyEngine
(src/engine_empty.cc:23-133) plus the world_size==1 fast path of the
robust engine (allreduce_robust.cc:169-172). Unlike the reference's empty
engine, checkpointing here is functional (kept in memory) so single-node
programs exercise the full LoadCheckPoint/CheckPoint loop."""

from __future__ import annotations

from typing import Callable, List, Optional, Tuple

import numpy as np

from .base import Engine


class EmptyEngine(Engine):
    def __init__(self) -> None:
        self._global: Optional[bytes] = None
        self._local: Optional[bytes] = None
        self._version = 0

    def init(self, args: List[str]) -> None:
        pass

    def shutdown(self) -> None:
        pass

    def allreduce(self, buf: np.ndarray, op: int,
                  prepare_fun: Optional[Callable[[], None]] = None,
                  key: str = "") -> None:
        if prepare_fun is not None:
            prepare_fun()

    def broadcast(self, data: Optional[bytes], root: int) -> bytes:
        if data is None:
            raise ValueError("single-process broadcast must originate data")
        return data

    def load_checkpoint(self, with_local: bool = False
                        ) -> Tuple[int, Optional[bytes], Optional[bytes]]:
        return (self._version, self._global, self._local)

    def checkpoint(self, global_bytes: bytes,
                   local_bytes: Optional[bytes] = None) -> None:
        self._global = global_bytes
        self._local = local_bytes
        self._version += 1

    def lazy_checkpoint(self, make_global: Callable[[], bytes]) -> None:
        self._global = make_global()
        self._local = None
        self._version += 1

    @property
    def rank(self) -> int:
        return 0

    @property
    def world_size(self) -> int:
        return 1
