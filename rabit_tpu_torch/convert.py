"""From the JAX package's host arrays to the port's tensors.

* ``inputs_from_numpy`` takes the [p, n] (grad, hess, bins) arrays that
  ``make_inputs`` and ``bench.py`` make and returns this rank's row as
  tensors on the device — the data counterpart of ``shard_over``.
* ``tensor_from_numpy`` / ``numpy_from_tensor`` move host buffers,
  bfloat16 ones (numpy's ``ml_dtypes`` type) included.
* ``transformer_params_from_jax`` / ``transformer_params_to_jax`` turn
  the JAX transformer's parameter dict (numpy) into the port's module
  state for a tensor-parallel rank, and back; ``mlp_params_from_jax`` /
  ``mlp_params_to_jax`` do the same for the MLP.
* ``adopt_checkpoint`` hands checkpoint bytes written by ``rabit_tpu`` to
  the port's engine. Both packages pickle Python and numpy objects, so the
  bytes load unchanged.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Sequence, Tuple

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


def _shard_params(params: Mapping[str, np.ndarray], specs, tp_rank: int,
                  tp: int, device: DeviceLike) -> Dict[str, torch.Tensor]:
    """Each parameter of a JAX-layout dict cut along its tp axis
    (``specs``: name -> axis or None) for rank ``tp_rank`` of ``tp``."""
    if not 0 <= tp_rank < tp:
        raise ValueError(f"tp_rank {tp_rank} out of range for tp={tp}")
    dev = resolve_device(device)
    out = {}
    for name, axis in specs.items():
        a = np.asarray(params[name])
        if axis is not None:
            n = a.shape[axis]
            if n % tp:
                raise ValueError(f"{name}: axis {axis} of size {n} does not "
                                 f"divide over tp={tp}")
            a = np.take(a, np.arange(tp_rank * n // tp,
                                     (tp_rank + 1) * n // tp), axis=axis)
        out[name] = tensor_from_numpy(a).to(dev)
    return out


def _join_params(states: Sequence[Mapping[str, torch.Tensor]], specs
                 ) -> Dict[str, np.ndarray]:
    """The way back: tp ranks' states joined along each parameter's
    axis."""
    out = {}
    for name, axis in specs.items():
        parts = [s[name].detach().cpu().numpy() for s in states]
        out[name] = parts[0] if axis is None else \
            np.concatenate(parts, axis=axis)
    return out


def transformer_params_from_jax(params: Mapping[str, np.ndarray],
                                tp_rank: int = 0, tp: int = 1,
                                device: DeviceLike = None
                                ) -> Dict[str, torch.Tensor]:
    """The JAX package's transformer parameter dict (numpy arrays, JAX
    layouts) as the port's module state for tensor-parallel rank
    ``tp_rank`` of ``tp``: each sharded parameter cut along its axis as
    ``param_specs`` cuts it, on ``device`` (the card by default)."""
    from .models.transformer import param_specs  # that module imports this
    return _shard_params(params, param_specs(params), tp_rank, tp, device)


def transformer_params_to_jax(states: Sequence[Mapping[str, torch.Tensor]]
                              ) -> Dict[str, np.ndarray]:
    """The way back: the module states of tp ranks 0..tp-1 (one state for
    tp = 1) joined into the JAX package's full parameter dict."""
    from .models.transformer import param_specs
    return _join_params(states, param_specs(states[0]))


def mlp_params_from_jax(params: Mapping[str, np.ndarray], tp_rank: int = 0,
                        tp: int = 1, device: DeviceLike = None
                        ) -> Dict[str, torch.Tensor]:
    """The JAX MLP's parameter dict (w1 [in, hidden], b1 [hidden], w2
    [hidden, out], b2 [out], numpy) as the port's state for tp rank
    ``tp_rank`` of ``tp``: the hidden axis cut as ``mlp.param_specs``
    cuts it, on ``device`` (the card by default)."""
    from .models.mlp import param_specs
    return _shard_params(params, param_specs(), tp_rank, tp, device)


def mlp_params_to_jax(states: Sequence[Mapping[str, torch.Tensor]]
                      ) -> Dict[str, np.ndarray]:
    """The way back: the MLP states of tp ranks 0..tp-1 joined into the
    JAX package's full parameter dict."""
    from .models.mlp import param_specs
    return _join_params(states, param_specs())
