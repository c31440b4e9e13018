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
    init/finalize, get_rank/get_world_size, is_distributed,
    get_processor_name, tracker_print, allreduce, allreduce_async,
    reduce_scatter, allgather, broadcast, load_checkpoint, checkpoint,
    lazy_checkpoint, version_number, init_after_exception, resize, and the
    ops
    MAX/MIN/SUM/BITOR.
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

ENGINES = ("empty", "torch", "native", "base", "robust", "mock", "mpi",
           "robust_torch")


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
      - ``"auto"``: ``rabit_engine`` from the configuration; with a
        tracker it defaults to ``"robust"``, without one to ``"empty"``
        (as ``rabit_tpu.init``);
      - ``"empty"``: single-process engine, collectives are identity;
      - ``"torch"``: collectives over ``torch.distributed`` on this
        rank's device (the counterpart of ``rabit_tpu``'s ``"xla"``);
      - ``"native"``/``"base"``, ``"robust"``, ``"mock"``: the native
        core's socket engine, its fault-tolerant engine, and the latter
        with scripted kills (``engine/native.py``);
      - ``"mpi"``: collectives on ``MPI_COMM_WORLD`` (the native core's
        ``MpiComm``), the independent second implementation, not fault
        tolerant: checkpoints only count versions. Run under ``mpirun``
        (``tools/mpi_launch.py``); it loads the core's MPI build, which
        needs an MPI runtime on the machine and raises where there is
        none;
      - ``"robust_torch"``: the fault-tolerant engine with its
        allreduces on a torch data plane (``rabit_dataplane=torch``,
        ``engine/dataplane.py``), the counterpart of ``"robust_xla"``."""
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
    # the engine gets the arguments as given (a repeated key such as
    # mock=... stays one argument an occurrence), and the keywords
    args = args + [f"{k}={v}" for k, v in kwargs.items()]

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
    elif engine in ("native", "base", "robust", "mock", "mpi"):
        from .engine.native import NativeEngine
        eng = NativeEngine(variant=engine)
    elif engine == "robust_torch":
        from .engine.native import NativeEngine
        eng = NativeEngine(variant="robust", dataplane="torch")
    else:
        raise ValueError(f"unknown engine {engine!r} "
                         f"(rabit_tpu_torch has {ENGINES})")
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


def get_processor_name() -> str:
    """Host identifier of this worker (rabit.py:152-169)."""
    return _require_engine().host


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
    _check_payload(data, op, "allreduce")
    eng = _require_engine()
    buf, pf = _host_buffer(data, prepare_fun)
    eng.allreduce(buf, op, prepare_fun=pf)
    return buf.reshape(data.shape)


def _check_payload(data: np.ndarray, op: Optional[int], what: str) -> None:
    if not isinstance(data, np.ndarray):
        raise TypeError(f"{what} only takes numpy.ndarray")
    if np.dtype(data.dtype) not in DTYPE_ENUM:
        raise TypeError(f"dtype {data.dtype} not supported")
    if op is None:
        return
    if op not in OP_NAMES:
        raise ValueError(f"unknown op {op}")
    if not is_valid_op_dtype(op, data.dtype):
        raise TypeError(
            f"op {OP_NAMES[op]} is not defined for dtype {data.dtype} "
            "(reference rejects BitOR on floats, c_api.cc:26-35)")


def _host_buffer(data: np.ndarray, prepare_fun):
    """A contiguous 1-D copy of ``data`` (never aliasing it) and the
    engine-side prepare hook: the user's ``prepare_fun`` runs on ``data``
    and its result is copied into the buffer."""
    buf = data.flatten()
    if prepare_fun is None:
        return buf, None

    def pf(b=buf, d=data, f=prepare_fun):
        f(d)
        b[:] = np.ascontiguousarray(d).reshape(-1)
    return buf, pf


def allreduce_async(data: np.ndarray, op: int,
                    prepare_fun: Optional[Callable[[np.ndarray], None]]
                    = None):
    """Issue an allreduce; returns a handle whose ``wait()`` yields the
    reduced array (input shape kept). Same validation and semantics as
    :func:`allreduce`, ``prepare_fun`` included, which runs at issue (the
    buffer is a copy, so the caller may overwrite ``data`` at once). The
    torch engine runs it on its worker thread while the caller goes on;
    the other engines complete it before returning (the base engine's
    composition: correct, with no overlap)."""
    _check_payload(data, op, "allreduce_async")
    from .engine.base import AllreduceHandle
    eng = _require_engine()
    buf, pf = _host_buffer(data, prepare_fun)
    h = eng.allreduce_async(buf, op, prepare_fun=pf)
    return AllreduceHandle(wait_fn=lambda: h.wait().reshape(data.shape),
                           ready_fn=h.ready)


def reduce_scatter(data: np.ndarray, op: int) -> np.ndarray:
    """Reduce ``data`` elementwise across ranks and return only this
    rank's chunk: a 1-D array of ``data.size / world_size`` elements
    starting at ``rank * data.size / world_size`` (rank i owns chunk i,
    allreduce_base.cc:829-918). ``data.size`` must divide by the world
    size."""
    _check_payload(data, op, "reduce_scatter")
    eng = _require_engine()
    if data.size % eng.world_size:
        raise ValueError(
            f"reduce_scatter payload of {data.size} elements must divide "
            f"by the world size {eng.world_size} (rank i owns chunk i)")
    return eng.reduce_scatter(data.flatten(), op)


def allgather(data: np.ndarray) -> np.ndarray:
    """Concatenate every rank's ``data`` (flattened, the same size on
    every rank) in rank order; every rank returns the full 1-D result
    (TryAllgatherRing, allreduce_base.cc:751-815)."""
    _check_payload(data, None, "allgather")
    return _require_engine().allgather(data.flatten())


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


def init_after_exception() -> None:
    """Reset engine state after catching an exception mid-collective so
    the next collective starts clean (IEngine::InitAfterException,
    allreduce_robust.h:163-169). Robust engine only."""
    _require_engine().init_after_exception()


def resize(cmd: str = "recover") -> None:
    """In-process world resize (elastic membership): tear down and
    rebuild the link topology from a fresh tracker assignment WITHOUT
    process exit -- ``get_rank()``/``get_world_size()`` may both change
    across the call, while checkpoints and the version counter survive.
    ``cmd`` is ``"recover"`` (a survivor re-forming after an eviction) or
    ``"join"`` (an evicted rank rejoining at the next epoch boundary;
    blocks until admitted). Call it at a collective boundary when the
    membership monitor reports a reformation due. The engines over the
    native core (``native``, ``base``, ``robust``, ``mock``,
    ``robust_torch``) honour it; ``empty`` and ``torch`` raise."""
    _require_engine().resize(cmd)


__all__ = [
    "init", "finalize", "get_rank", "get_world_size", "is_distributed",
    "get_processor_name", "tracker_print", "allreduce", "allreduce_async",
    "reduce_scatter", "allgather", "broadcast",
    "load_checkpoint", "checkpoint", "lazy_checkpoint", "version_number",
    "init_after_exception", "resize", "MAX", "MIN", "SUM", "BITOR",
]
