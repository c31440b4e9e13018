"""Gradient histogram: the CUDA kernel's wrapper and its plain version.

``histogram`` computes per-bin (sum grad, sum hess), an f32 [nbins, 2],
over int32 bin ids and f32 values. Rows whose bin id lies outside
[0, nbins) contribute nothing: the padding id ``nbins`` and negative ids
alike. It is the port of ``rabit_tpu/ops/pallas_kernels.py::histogram_tpu``
(``_histogram_tpu_impl``); the kernel is ``csrc/histogram.cu``.

``precision``:
  * ``"high"`` accumulates the f32 values as they are. The TPU kernel's
    hi/lo bf16 split reaches ~2e-6 relative; f32 sums are closer.
  * ``"fast"`` rounds each value to bf16 (round to nearest even) and
    accumulates in f32, like the TPU kernel's fast path.

For a CUDA tensor ``histogram`` launches the kernel; for a CPU tensor it
takes the plain version, ``histogram_reference``. Unlike the TPU kernel it
takes any row count: there is no 16384-row padding rule.

``mask_only`` counts the rows of each bin, an f32 [nbins], with the same
rule for ids outside [0, nbins). It is the port of the TPU kernel
``mask_only`` of ``tools/histogram_sweep.py`` (the histogram kernel's
value-free floor); the kernel is ``csrc/mask_only.cu`` and its plain
version ``mask_only_reference``. Its counts are exact (integer atomics),
so the kernel and the plain version agree bit for bit.
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

PRECISIONS = ("fast", "high")


def _check_bins(bins: torch.Tensor, nbins: int) -> None:
    if int(nbins) <= 0:
        raise ValueError(f"nbins must be positive, got {nbins}")
    if bins.dtype != torch.int32:
        raise TypeError(f"bins must be int32, got {bins.dtype}")
    if bins.dim() != 1:
        raise ValueError(f"bins must be 1-D, got {tuple(bins.shape)}")


def _check(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
           nbins: int, precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be 'fast' or 'high', "
                         f"got {precision!r}")
    _check_bins(bins, nbins)
    if grad.dtype != torch.float32 or hess.dtype != torch.float32:
        raise TypeError(f"grad/hess must be float32, got "
                        f"{grad.dtype}/{hess.dtype}")
    if grad.shape != bins.shape or hess.shape != bins.shape:
        raise ValueError(
            f"bins, grad and hess must be of one length, got "
            f"{tuple(bins.shape)}, {tuple(grad.shape)}, {tuple(hess.shape)}")
    if not (bins.device == grad.device == hess.device):
        raise ValueError(f"inputs on different devices: {bins.device}, "
                         f"{grad.device}, {hess.device}")


def histogram_reference(bins: torch.Tensor, grad: torch.Tensor,
                        hess: torch.Tensor, nbins: int,
                        precision: str = "high") -> torch.Tensor:
    """The plain PyTorch version: round to bf16 for ``"fast"``,
    ``index_add_`` into an f32 [nbins, 2]."""
    _check(bins, grad, hess, nbins, precision)
    gh = torch.stack([grad, hess], dim=1)
    if precision == "fast":
        gh = gh.to(torch.bfloat16).to(torch.float32)
    out = torch.zeros((nbins + 1, 2), dtype=torch.float32, device=bins.device)
    return out.index_add_(0, _valid_or_spill(bins, nbins), gh)[:nbins]


def _valid_or_spill(bins: torch.Tensor, nbins: int) -> torch.Tensor:
    """The ids as int64, those outside [0, nbins) sent to a spill bin
    ``nbins`` that the caller drops. Unlike ``bins[valid]`` it leaves the
    shape alone, so the host need not wait for the device."""
    valid = (bins >= 0) & (bins < nbins)
    return torch.where(valid, bins, nbins).long()


_P, _I, _N = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong


def histogram(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              nbins: int, precision: str = "high") -> torch.Tensor:
    """Per-bin (sum grad, sum hess) as f32 [nbins, 2]. Launches the CUDA
    kernel for CUDA tensors (counted in ``histogram.launches``) and takes
    the plain version for CPU tensors; raises for any other device."""
    _check(bins, grad, hess, nbins, precision)
    if bins.device.type == "cpu":
        return histogram_reference(bins, grad, hess, nbins, precision)
    if bins.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {bins.device}")
    if not (bins.is_contiguous() and grad.is_contiguous()
            and hess.is_contiguous()):
        raise ValueError("histogram kernel needs contiguous inputs")
    fn = _build.entry("histogram", "rabit_histogram_f32",
                      [_P, _P, _P, _N, _I, _I, _P, _P])
    with torch.cuda.device(bins.device):
        out = torch.zeros((nbins, 2), dtype=torch.float32,
                          device=bins.device)
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        err = fn(bins.data_ptr(), grad.data_ptr(), hess.data_ptr(),
                 bins.numel(), int(nbins), int(precision == "fast"),
                 out.data_ptr(), stream)
    _build.check(err, "histogram")
    if bins.numel():  # the C entry point launches nothing for no rows
        histogram.launches += 1
    return out


histogram.launches = 0


def mask_only_reference(bins: torch.Tensor, nbins: int) -> torch.Tensor:
    """The plain PyTorch version: mask the valid ids, ``index_add_`` ones
    into an f32 [nbins]."""
    _check_bins(bins, nbins)
    out = torch.zeros(nbins + 1, dtype=torch.float32, device=bins.device)
    ones = torch.ones(bins.shape, dtype=torch.float32, device=bins.device)
    return out.index_add_(0, _valid_or_spill(bins, nbins), ones)[:nbins]


def mask_only(bins: torch.Tensor, nbins: int) -> torch.Tensor:
    """Rows a bin as f32 [nbins]. Launches ``csrc/mask_only.cu`` for a CUDA
    tensor (counted in ``mask_only.launches``) and takes the plain version
    for a CPU tensor; raises for any other device."""
    _check_bins(bins, nbins)
    if bins.device.type == "cpu":
        return mask_only_reference(bins, nbins)
    if bins.device.type != "cuda":
        raise ValueError(f"no mask_only kernel for device {bins.device}")
    if not bins.is_contiguous():
        raise ValueError("mask_only kernel needs a contiguous input")
    fn = _build.entry("mask_only", "rabit_mask_only_f32",
                      [_P, _N, _I, _P, _P, _P])
    with torch.cuda.device(bins.device):
        counts = torch.empty(nbins, dtype=torch.int32, device=bins.device)
        out = torch.empty(nbins, dtype=torch.float32, device=bins.device)
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        err = fn(bins.data_ptr(), bins.numel(), int(nbins),
                 counts.data_ptr(), out.data_ptr(), stream)
    _build.check(err, "mask_only")
    mask_only.launches += 1
    return out


mask_only.launches = 0
