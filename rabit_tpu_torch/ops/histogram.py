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
"""

from __future__ import annotations

import ctypes

import torch

from . import _build

PRECISIONS = ("fast", "high")


def _check(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
           nbins: int, precision: str) -> None:
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be 'fast' or 'high', "
                         f"got {precision!r}")
    if int(nbins) <= 0:
        raise ValueError(f"nbins must be positive, got {nbins}")
    if bins.dtype != torch.int32:
        raise TypeError(f"bins must be int32, got {bins.dtype}")
    if grad.dtype != torch.float32 or hess.dtype != torch.float32:
        raise TypeError(f"grad/hess must be float32, got "
                        f"{grad.dtype}/{hess.dtype}")
    if bins.dim() != 1 or grad.shape != bins.shape or \
            hess.shape != bins.shape:
        raise ValueError(
            f"bins, grad and hess must be 1-D of one length, got "
            f"{tuple(bins.shape)}, {tuple(grad.shape)}, {tuple(hess.shape)}")
    if not (bins.device == grad.device == hess.device):
        raise ValueError(f"inputs on different devices: {bins.device}, "
                         f"{grad.device}, {hess.device}")


def histogram_reference(bins: torch.Tensor, grad: torch.Tensor,
                        hess: torch.Tensor, nbins: int,
                        precision: str = "high") -> torch.Tensor:
    """The plain PyTorch version: mask the valid rows, round to bf16 for
    ``"fast"``, ``index_add_`` into an f32 [nbins, 2]."""
    _check(bins, grad, hess, nbins, precision)
    gh = torch.stack([grad, hess], dim=1)
    if precision == "fast":
        gh = gh.to(torch.bfloat16).to(torch.float32)
    valid = (bins >= 0) & (bins < nbins)
    out = torch.zeros((nbins, 2), dtype=torch.float32, device=bins.device)
    return out.index_add_(0, bins[valid].long(), gh[valid])


def _lib() -> ctypes.CDLL:
    lib = _build.load("histogram")
    fn = lib.rabit_histogram_f32
    if not fn.argtypes:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        lib.rabit_cuda_error_string.argtypes = [ctypes.c_int]
        lib.rabit_cuda_error_string.restype = ctypes.c_char_p
    return lib


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
    lib = _lib()
    with torch.cuda.device(bins.device):
        out = torch.zeros((nbins, 2), dtype=torch.float32,
                          device=bins.device)
        stream = torch.cuda.current_stream(bins.device).cuda_stream
        err = lib.rabit_histogram_f32(
            bins.data_ptr(), grad.data_ptr(), hess.data_ptr(),
            bins.numel(), int(nbins), int(precision == "fast"),
            out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(
            f"histogram kernel launch failed: cuda error {err} "
            f"({lib.rabit_cuda_error_string(err).decode()})")
    if bins.numel():  # the C entry point launches nothing for no rows
        histogram.launches += 1
    return out


histogram.launches = 0
