"""XGBoost-style gradient-histogram workload on PyTorch — the port of
``rabit_tpu/models/histogram.py`` and the main path of the port.

In distributed tree boosting each worker bucketizes its rows into feature
bins, accumulates per-bin (grad, hess) sums, and allreduces the histogram
across workers (the reference's motivating use case,
doc/guide.md:137-143). Here each rank builds its local histogram on its
device — through the hand-written CUDA kernel on the card — and the ranks
reduce it over a ``torch.distributed`` process group.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..ops import histogram as _hist
from ..ops.reducers import SUM
from ..parallel.collectives import ring_allreduce, tree_allreduce
from ..parallel.dispatch import RING_MINCOUNT_DEFAULT

METHODS = ("auto", "cuda", "matmul", "scatter")
_MATMUL_CHUNK = 32768


def _matmul_histogram(grad, hess, bins, nbins: int) -> torch.Tensor:
    """One-hot x gradient products over row chunks: bf16 values, exact 0/1
    one-hot, f32 accumulation (the JAX ``"matmul"`` method's
    ``preferred_element_type=float32`` dot). A row whose id lies outside
    [0, nbins) has an all-zero one-hot row."""
    gh = torch.stack([grad, hess], dim=1).to(torch.bfloat16).to(torch.float32)
    ids = torch.arange(nbins, dtype=bins.dtype, device=bins.device)
    out = torch.zeros((nbins, 2), dtype=torch.float32, device=bins.device)
    for s in range(0, bins.shape[0], _MATMUL_CHUNK):
        onehot = (bins[s:s + _MATMUL_CHUNK, None] == ids).to(torch.float32)
        out += onehot.T @ gh[s:s + _MATMUL_CHUNK]
    return out


def local_histogram(grad: torch.Tensor, hess: torch.Tensor,
                    bins: torch.Tensor, nbins: int, method: str = "auto",
                    precision: str = "high") -> torch.Tensor:
    """Per-worker histogram: [nbins, 2] with (sum_g, sum_h) per bin.

    ``bins`` is int32 [n] of flattened (feature, bucket) ids; rows with
    an id outside [0, nbins) contribute nothing. Methods:

    * ``"cuda"`` — the hand-written kernel (``ops/histogram.py``); CUDA
      tensors only, raises for CPU tensors;
    * ``"matmul"`` — chunked one-hot matmuls (bf16 values, f32 sums);
    * ``"scatter"`` — ``index_add_`` in f32;
    * ``"auto"`` — the kernel for CUDA tensors, its plain version for CPU
      tensors.

    ``precision`` applies to ``"cuda"`` and ``"auto"``: ``"high"`` (f32
    values) or ``"fast"`` (values rounded to bf16)."""
    if method not in METHODS:
        raise ValueError(f"unknown method {method!r}")
    if method == "cuda" and bins.device.type != "cuda":
        raise ValueError(f"method='cuda' needs CUDA tensors, got "
                         f"{bins.device}")
    if method in ("cuda", "auto"):
        return _hist.histogram(bins, grad, hess, nbins, precision)
    if method == "matmul":
        return _matmul_histogram(grad, hess, bins, nbins)
    return _hist.histogram_reference(bins, grad, hess, nbins, "high")


def distributed_histogram(grad: torch.Tensor, hess: torch.Tensor,
                          bins: torch.Tensor, nbins: int,
                          group: Optional[dist.ProcessGroup] = None,
                          method: str = "auto",
                          precision: str = "high") -> torch.Tensor:
    """Build this rank's histogram and allreduce it over ``group``.

    Takes this rank's [n_local] rows (not the [p, n_local] mesh-sharded
    arrays of the JAX version: each process holds only its own shard).
    Returns the [nbins, 2] histogram, the same on every rank — what every
    worker needs to find the best split. Payloads of at least
    ``RING_MINCOUNT_DEFAULT`` floats take the ring, smaller ones the tree,
    as in the JAX version."""
    use_ring = nbins * 2 >= RING_MINCOUNT_DEFAULT
    hist = local_histogram(grad, hess, bins, nbins, method, precision)
    red = (ring_allreduce if use_ring else tree_allreduce)(
        hist.reshape(-1), group, SUM)
    return red.reshape(hist.shape)


def host_histogram(grad: np.ndarray, hess: np.ndarray, bins: np.ndarray,
                   nbins: int) -> np.ndarray:
    """Numpy reference, summed in f64: [nbins, 2] f32."""
    out = np.zeros((nbins, 2), dtype=np.float64)
    np.add.at(out[:, 0], bins, grad.astype(np.float64))
    np.add.at(out[:, 1], bins, hess.astype(np.float64))
    return out.astype(np.float32)


def make_inputs(n: int, nbins: int, p: int = 1, seed: int = 0):
    """Synthetic (grad, hess, bins) numpy arrays for p workers × n rows
    each; the same generator and draws as the JAX package's."""
    rng = np.random.default_rng(seed)
    grad = rng.standard_normal((p, n)).astype(np.float32)
    hess = rng.random((p, n)).astype(np.float32)
    bins = rng.integers(0, nbins, size=(p, n)).astype(np.int32)
    return grad, hess, bins
