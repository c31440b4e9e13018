"""rabit_tpu_torch — the PyTorch/CUDA port of rabit_tpu.

A second package beside ``rabit_tpu`` (the JAX reference, which stays as
it is). It runs the gradient-histogram allreduce — each worker's
per-bin (sum grad, sum hess) built by a hand-written CUDA kernel, then
reduced over a ``torch.distributed`` process group — and the rabit host
API on top of it. It imports neither JAX nor anything of ``rabit_tpu``.

Entry points run on the card (``cuda``) unless the caller passes CPU
tensors or asks for ``device="cpu"`` / ``rabit_device=cpu``; asking for
the card where there is none raises.

Public API (the reference binding, python/rabit.py:88-364):
    init/finalize, get_rank/get_world_size, is_distributed, tracker_print,
    allreduce, broadcast, load_checkpoint, checkpoint, lazy_checkpoint,
    version_number, and the ops MAX/MIN/SUM/BITOR.
"""

from __future__ import annotations

import atexit
import pickle
import sys
from typing import Any, Callable, Optional

import numpy as np

from .engine.base import Engine
from .ops.reducers import (
    BITOR, DTYPE_ENUM, MAX, MIN, OP_NAMES, SUM, is_valid_op_dtype)
from .utils.config import Config

__version__ = "0.1.0"

_engine: Optional[Engine] = None


def _require_engine() -> Engine:
    if _engine is None:
        raise RuntimeError(
            "rabit_tpu_torch is not initialized; call "
            "rabit_tpu_torch.init() first")
    return _engine


def init(args: Optional[list] = None, engine: str = "auto", **kwargs) -> None:
    """Initialize the library. Call once before anything else.

    ``args`` are ``key=value`` strings (default: those in ``sys.argv``).
    ``engine``:
      - ``"auto"``: ``rabit_engine`` from the configuration; without a
        tracker it defaults to ``"empty"`` (as ``rabit_tpu.init``);
      - ``"empty"``: single-process engine, collectives are identity;
      - ``"torch"``: collectives over ``torch.distributed`` on this
        rank's device (the counterpart of ``rabit_tpu``'s ``"xla"``).
    The ctypes engines over ``native/`` are not ported yet."""
    global _engine
    if _engine is not None:
        import warnings
        warnings.warn("rabit_tpu_torch.init called twice; ignored",
                      stacklevel=2)
        return
    if args is None:
        args = [a for a in sys.argv[1:] if "=" in a]
    args = [a.decode() if isinstance(a, bytes) else str(a) for a in args]
    cfg = Config.from_args(args, **kwargs)
    args = cfg.as_args()

    if engine == "auto":
        if cfg.get("rabit_tracker_uri") or cfg.get("dmlc_tracker_uri"):
            engine = cfg.get("rabit_engine", "robust")
        else:
            engine = cfg.get("rabit_engine", "empty")

    if engine == "empty":
        from .engine.empty import EmptyEngine
        eng: Engine = EmptyEngine()
    elif engine == "torch":
        from .engine.torch_engine import TorchEngine
        eng = TorchEngine()
    else:
        raise ValueError(f"unknown or not yet ported engine {engine!r} "
                         f"(rabit_tpu_torch has 'empty' and 'torch')")
    eng.init(args)
    _engine = eng


def finalize() -> None:
    """Shut the engine down. Mirrors rabit.finalize (rabit.py:115-120)."""
    global _engine
    if _engine is not None:
        _engine.shutdown()
        _engine = None


@atexit.register
def _atexit_finalize() -> None:  # best-effort cleanup at exit
    global _engine
    if _engine is not None:
        try:
            _engine.shutdown()
        except Exception:
            pass
        _engine = None


def get_rank() -> int:
    """Rank of this worker (rabit.py:122-130, rabit.h:102-103)."""
    return _require_engine().rank


def get_world_size() -> int:
    """Total number of workers (rabit.py:132-140, rabit.h:106-107)."""
    return _require_engine().world_size


def is_distributed() -> bool:
    """Whether running in distributed mode (rabit.h:108-109)."""
    return _require_engine().is_distributed


def tracker_print(msg: str) -> None:
    """Print a message from rank 0 (rabit.py:142-150)."""
    _require_engine().tracker_print(str(msg))


def allreduce(data: np.ndarray, op: int,
              prepare_fun: Optional[Callable[[np.ndarray], None]] = None,
              ) -> np.ndarray:
    """Allreduce a numpy array across all workers; returns the result.

    Mirrors rabit.allreduce (rabit.py:229-263): the input is flattened,
    reduced elementwise with ``op`` across ranks, and returned with the
    input's shape. ``prepare_fun`` is the lazy initializer (rabit.h:222-231):
    it is invoked on ``data`` right before the reduction runs."""
    if not isinstance(data, np.ndarray):
        raise TypeError("allreduce only takes numpy.ndarray")
    if np.dtype(data.dtype) not in DTYPE_ENUM:
        raise TypeError(f"dtype {data.dtype} not supported")
    if op not in OP_NAMES:
        raise ValueError(f"unknown op {op}")
    if not is_valid_op_dtype(op, data.dtype):
        raise TypeError(
            f"op {OP_NAMES[op]} is not defined for dtype {data.dtype} "
            "(reference rejects BitOR on floats, c_api.cc:26-35)")
    eng = _require_engine()
    shape = data.shape
    buf = data.flatten()  # always a contiguous 1-D copy, never aliases data
    if prepare_fun is None:
        pf = None
    else:
        def pf(b=buf, d=data, f=prepare_fun):
            f(d)
            b[:] = np.ascontiguousarray(d).reshape(-1)
    eng.allreduce(buf, op, prepare_fun=pf)
    return buf.reshape(shape)


def broadcast(data: Any, root: int) -> Any:
    """Broadcast a picklable object from ``root`` to every worker
    (rabit.py:171-206: two-phase length-then-payload broadcast)."""
    eng = _require_engine()
    rank = eng.rank
    if not 0 <= root < eng.world_size:
        raise ValueError(
            f"broadcast root {root} out of range for world_size "
            f"{eng.world_size}")
    payload = pickle.dumps(data, protocol=pickle.HIGHEST_PROTOCOL) \
        if rank == root else None
    out = eng.broadcast(payload, root)
    return data if rank == root else pickle.loads(out)


def load_checkpoint(with_local: bool = False):
    """Load the latest checkpoint (rabit.py:283-316, rabit.h:267-287).

    Returns ``(version, global_model)`` or
    ``(version, global_model, local_model)``; version 0 means nothing was
    checkpointed yet."""
    eng = _require_engine()
    version, gbytes, lbytes = eng.load_checkpoint(with_local)
    gmodel = pickle.loads(gbytes) if version > 0 and gbytes else None
    if with_local:
        lmodel = pickle.loads(lbytes) if version > 0 and lbytes else None
        return (version, gmodel, lmodel)
    return (version, gmodel)


def checkpoint(global_model: Any, local_model: Any = None) -> None:
    """Checkpoint the model; bumps the version number by one
    (rabit.py:318-351, rabit.h:288-300)."""
    eng = _require_engine()
    gbytes = pickle.dumps(global_model, protocol=pickle.HIGHEST_PROTOCOL)
    lbytes = None if local_model is None else pickle.dumps(
        local_model, protocol=pickle.HIGHEST_PROTOCOL)
    eng.checkpoint(gbytes, lbytes)


def lazy_checkpoint(global_model: Any) -> None:
    """Lazy checkpoint: serialization is deferred until the checkpoint is
    read (rabit.h:301-305)."""
    eng = _require_engine()
    eng.lazy_checkpoint(
        lambda m=global_model: pickle.dumps(m,
                                            protocol=pickle.HIGHEST_PROTOCOL))


def version_number() -> int:
    """Number of CheckPoint calls so far (rabit.py:353-364)."""
    return _require_engine().version_number


__all__ = [
    "init", "finalize", "get_rank", "get_world_size", "is_distributed",
    "tracker_print", "allreduce", "broadcast",
    "load_checkpoint", "checkpoint", "lazy_checkpoint", "version_number",
    "MAX", "MIN", "SUM", "BITOR",
]
