"""From the JAX package's host arrays to the port's tensors.

* ``inputs_from_numpy`` takes the [p, n] (grad, hess, bins) arrays that
  ``make_inputs`` and ``bench.py`` make and returns this rank's row as
  tensors on the device — the data counterpart of ``shard_over``.
* ``tensor_from_numpy`` / ``numpy_from_tensor`` move host buffers,
  bfloat16 ones (numpy's ``ml_dtypes`` type) included.
* ``adopt_checkpoint`` hands checkpoint bytes written by ``rabit_tpu`` to
  the port's engine. Both packages pickle Python and numpy objects, so the
  bytes load unchanged.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from .parallel.mesh import DeviceLike, resolve_device


def tensor_from_numpy(a: np.ndarray) -> torch.Tensor:
    """A CPU tensor with ``a``'s dtype and values (a copy)."""
    a = np.array(a, order="C")
    if a.dtype.name == "bfloat16":  # ml_dtypes: numpy has no bf16 of its own
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def numpy_from_tensor(t: torch.Tensor, dtype: np.dtype) -> np.ndarray:
    """``t`` on the host as a numpy array of ``dtype``, bits unchanged."""
    t = t.detach().cpu().contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(dtype)
    out = t.numpy()
    if out.dtype != dtype:
        raise TypeError(f"tensor dtype {t.dtype} is not {dtype}")
    return out


def inputs_from_numpy(grad: np.ndarray, hess: np.ndarray, bins: np.ndarray,
                      *, rank: int, device: DeviceLike = None
                      ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """This rank's (grad f32, hess f32, bins int32) on ``device`` (the
    card unless told otherwise) from [p, n] host arrays."""
    for name, a, want in (("grad", grad, np.float32),
                          ("hess", hess, np.float32),
                          ("bins", bins, np.int32)):
        if a.dtype != want:
            raise TypeError(f"{name} must be {np.dtype(want)}, got {a.dtype}")
        if a.ndim != 2 or a.shape != grad.shape:
            raise ValueError(f"{name} must be [p, n] like grad "
                             f"{grad.shape}, got {a.shape}")
    if not 0 <= rank < grad.shape[0]:
        raise ValueError(f"rank {rank} out of range for {grad.shape[0]} "
                         f"workers")
    dev = resolve_device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a[rank])).to(dev)
                 for a in (grad, hess, bins))


def adopt_checkpoint(version: int, global_bytes: Optional[bytes],
                     local_bytes: Optional[bytes] = None) -> None:
    """Install a checkpoint that ``rabit_tpu`` wrote (its engine's
    ``load_checkpoint()`` triple) into the port's running engine, so that
    ``rabit_tpu_torch.load_checkpoint()`` returns it."""
    from . import _require_engine
    _require_engine().restore_checkpoint(version, global_bytes, local_bytes)
