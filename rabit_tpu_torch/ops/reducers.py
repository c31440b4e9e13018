"""Reduction operators and dtype enumeration for the PyTorch port.

Own copy of ``rabit_tpu/ops/reducers.py``: the op enums
(kMax=0, kMin=1, kSum=2, kBitwiseOR=3, reference engine.h:195-200), the
dtype enum table (reference rabit.py:209-218) and the host-side numpy
reduction. ``torch_reduce_fn`` takes the place of ``jax_reduce_fn``.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

# Op enums — wire-compatible with the reference (engine.h:195-200).
MAX = 0
MIN = 1
SUM = 2
BITOR = 3

OP_NAMES = {MAX: "max", MIN: "min", SUM: "sum", BITOR: "bitor"}

# Dtype enums — wire-compatible with the reference C ABI dispatch
# (c_api.cc:37-122) / python table (rabit.py:209-218).
DTYPE_ENUM = {
    np.dtype("int8"): 0,
    np.dtype("uint8"): 1,
    np.dtype("int32"): 2,
    np.dtype("uint32"): 3,
    np.dtype("int64"): 4,
    np.dtype("uint64"): 5,
    np.dtype("float32"): 6,
    np.dtype("float64"): 7,
    np.dtype("float16"): 8,
}
ENUM_DTYPE = {v: k for k, v in DTYPE_ENUM.items()}

try:  # numpy has no bfloat16 of its own; ml_dtypes adds it where installed
    import ml_dtypes
    DTYPE_ENUM[np.dtype(ml_dtypes.bfloat16)] = 9
    ENUM_DTYPE[9] = np.dtype(ml_dtypes.bfloat16)
except ImportError:
    pass

_FLOAT_ENUMS = frozenset(e for d, e in DTYPE_ENUM.items() if d.kind == "f"
                         or d.name == "bfloat16")


def is_valid_op_dtype(op: int, dtype: np.dtype) -> bool:
    """BitOR on floating types is rejected, like the reference C ABI's
    FHelper specialization (c_api.cc:26-35)."""
    if op == BITOR and DTYPE_ENUM[np.dtype(dtype)] in _FLOAT_ENUMS:
        return False
    return True


def numpy_reduce(dst: np.ndarray, src: np.ndarray, op: int) -> None:
    """In-place elementwise ``dst = op(dst, src)`` — host-side equivalent of
    op::Reducer (rabit-inl.h:95-102)."""
    if op == SUM:
        np.add(dst, src, out=dst)
    elif op == MAX:
        np.maximum(dst, src, out=dst)
    elif op == MIN:
        np.minimum(dst, src, out=dst)
    elif op == BITOR:
        np.bitwise_or(dst, src, out=dst)
    else:
        raise ValueError(f"unknown op {op}")


def torch_reduce_fn(op: int) -> Callable[[torch.Tensor, torch.Tensor],
                                         torch.Tensor]:
    """Binary elementwise combiner on tensors, used by the ring schedules
    (the counterpart of ``jax_reduce_fn``)."""
    if op == SUM:
        return torch.add
    if op == MAX:
        return torch.maximum
    if op == MIN:
        return torch.minimum
    if op == BITOR:
        return torch.bitwise_or
    raise ValueError(f"unknown op {op}")
