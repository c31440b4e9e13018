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

Both kernels run as thread-block clusters (``csrc/cluster_bins.cuh``), one
launch a call: the wrapper allocates the output with ``torch.empty`` and
zero-fills nothing (the call's first block zeroes it). ``plan`` is the grid
the C entry points take; it is plain Python so that the CPU tests hold its
rules.
"""

from __future__ import annotations

import ctypes
from typing import Dict, NamedTuple

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


_P, _I, _N, _U = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                  ctypes.c_ulonglong)


class Shape(NamedTuple):
    """What a binning kernel's library reports once per device and bin
    count (``rabit_<name>_info``): threads a block, blocks a cluster, the
    blocks an SM that the plan allows, the SM count, the clusters the
    device holds at once with that bin count's tile, and the largest tile
    (bins) that one block's shared memory holds."""
    threads: int
    cluster: int
    blocks_per_sm: int
    sms: int
    max_clusters: int
    max_tile: int


class Plan(NamedTuple):
    """The launch of one call: bins a tile, tiles (``blockIdx.y``),
    clusters along x, and groups of four rows read as 16-byte vectors."""
    tile: int
    tiles: int
    clusters: int
    groups: int


def plan(n: int, nbins: int, aligned: bool, shape: Shape) -> Plan:
    """The grid of one call, as ``csrc/cluster_bins.cuh`` takes it. Bins
    tile by the largest tile; rows go four to a 16-byte group where all
    the pointers are 16-byte aligned, one by one after the last group (and
    all of them when not aligned). The clusters along x: enough for the
    rows (a block a ``threads`` items, rounded up to whole clusters), at
    most ``blocks_per_sm`` blocks an SM and what the device holds at once,
    shared by the tiles, and at least one."""
    tile = min(nbins, shape.max_tile)
    tiles = -(-nbins // tile)
    groups = n // 4 if aligned else 0
    items = groups + n - 4 * groups
    blocks = -(-items // shape.threads)
    cap = min(shape.max_clusters,
              shape.sms * shape.blocks_per_sm // shape.cluster) // tiles
    clusters = max(1, min(cap, -(-blocks // shape.cluster)))
    return Plan(tile, tiles, clusters, groups)


_shapes: Dict[tuple, Shape] = {}
# per device: the state words of the binning kernels (a "started" and a
# "zeroed" word a bin tile, u64), and the generation of the last call
_state: Dict[torch.device, torch.Tensor] = {}
_generation: Dict[torch.device, int] = {}


def _shape(name: str, device: torch.device, nbins: int) -> Shape:
    """The kernel's ``Shape`` on ``device`` for ``nbins`` bins, asked of
    its library once (it also opts the kernel into its shared memory)."""
    fn = _build.entry(name, f"rabit_{name}_info", [_I, _P])
    key = (id(fn), device, nbins)   # per library: kernel_variants.py swaps
    shape = _shapes.get(key)
    if shape is None:
        info = (ctypes.c_int * len(Shape._fields))()
        with torch.cuda.device(device):
            err = fn(int(nbins), info)
        _build.check(err, name)
        shape = _shapes[key] = Shape(*info)
    return shape


def _next_call(device: torch.device, tiles: int):
    """(state words, generation) of the next call on ``device``: the
    words zero-filled once, here, and only raised by the calls; the
    generation one higher than the last call's. Calls must be ordered on
    one stream, as every caller of the port is."""
    state = _state.get(device)
    if state is None or state.numel() < 2 * tiles:
        # a new buffer starts the count again: its words are all zero
        state = _state[device] = torch.zeros(max(2 * tiles, 256),
                                             dtype=torch.int64, device=device)
        _generation[device] = 0
    _generation[device] += 1
    return state, _generation[device]


def histogram(bins: torch.Tensor, grad: torch.Tensor, hess: torch.Tensor,
              nbins: int, precision: str = "high") -> torch.Tensor:
    """Per-bin (sum grad, sum hess) as f32 [nbins, 2]. Launches the CUDA
    kernel for CUDA tensors, one device operation a call (counted in
    ``histogram.launches``), and takes the plain version for CPU tensors;
    raises for any other device."""
    _check(bins, grad, hess, nbins, precision)
    if bins.device.type == "cpu":
        return histogram_reference(bins, grad, hess, nbins, precision)
    if bins.device.type != "cuda":
        raise ValueError(f"no histogram kernel for device {bins.device}")
    if not (bins.is_contiguous() and grad.is_contiguous()
            and hess.is_contiguous()):
        raise ValueError("histogram kernel needs contiguous inputs")
    dev = bins.device
    fn = _build.entry("histogram", "rabit_histogram_f32",
                      [_P, _P, _P, _N, _I, _I, _I, _I, _P, _U, _P, _P])
    ptrs = (bins.data_ptr(), grad.data_ptr(), hess.data_ptr())
    p = plan(bins.numel(), nbins, (ptrs[0] | ptrs[1] | ptrs[2]) % 16 == 0,
             _shape("histogram", dev, nbins))
    with torch.cuda.device(dev):
        out = torch.empty((nbins, 2), dtype=torch.float32, device=dev)
        state, gen = _next_call(dev, p.tiles)
        err = fn(*ptrs, bins.numel(), int(nbins), int(precision == "fast"),
                 p.tile, p.clusters, state.data_ptr(), gen, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "histogram")
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
    tensor, one device operation a call (counted in
    ``mask_only.launches``), and takes the plain version for a CPU
    tensor; raises for any other device."""
    _check_bins(bins, nbins)
    if bins.device.type == "cpu":
        return mask_only_reference(bins, nbins)
    if bins.device.type != "cuda":
        raise ValueError(f"no mask_only kernel for device {bins.device}")
    if not bins.is_contiguous():
        raise ValueError("mask_only kernel needs a contiguous input")
    dev = bins.device
    fn = _build.entry("mask_only", "rabit_mask_only_f32",
                      [_P, _N, _I, _I, _I, _P, _U, _P, _P])
    p = plan(bins.numel(), nbins, bins.data_ptr() % 16 == 0,
             _shape("mask_only", dev, nbins))
    with torch.cuda.device(dev):
        out = torch.empty(nbins, dtype=torch.float32, device=dev)
        state, gen = _next_call(dev, p.tiles)
        err = fn(bins.data_ptr(), bins.numel(), int(nbins), p.tile,
                 p.clusters, state.data_ptr(), gen, out.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
    _build.check(err, "mask_only")
    mask_only.launches += 1
    return out


mask_only.launches = 0
