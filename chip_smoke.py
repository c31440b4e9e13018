"""Chip smoke test of rabit_tpu_torch: builds the CUDA kernels and drives
the port's paths on one NVIDIA GPU -- the gradient-histogram allreduce,
the flagship transformer's training step, and the histogram measurement
path (the sweep, the bench and the kernel proof).

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):

1. build        nvcc every ``rabit_tpu_torch/csrc/*.cu`` into
                ``build/rabit_tpu_torch/`` (one nvcc a source, all
                started together); ptxas's registers and spills of every
                kernel (a flash or binning kernel may spill none); the
                tensor-core instructions (``HMMA``) of each flash forward
                and backward kernel in its SASS (``cuobjdump -sass``),
                which must be above 0.
1b. tile        the 3xTF32 score-tile function alone
                (``csrc/flash_mma.cuh``): one [64, DP] x [64, DP]^T tile
                against a torch f64 product at each DP, before the
                kernels built on it run; the forward's m' on the same
                tiles equal to the tile's row max, bit for bit.
2. kernel       each kernel against its plain PyTorch version on the card:
                the histogram at the main path's shapes and an edge case;
                the bin count (mask_only) exactly equal at the sweep's six
                shapes and at two edge cases (ragged rows in an unaligned
                view, ids -1, nbins, nbins + 40 and 2^30; 1000 bins, and
                120,000 bins over three shared-memory tiles); then
                torch.profiler counts the device operations of one window
                of five calls of each binning kernel at its main shapes,
                each call on inputs of its own: one kind of kernel, no
                memset or second kernel, the wrapper's launch count equal
                to the calls and each call's output agreeing with its
                plain version;
                the flash block forward and backward at the training shape
                (B*H 64, T = S 512, D 32, causal), the ring chain's block
                (H 8, T = S 1024, D 128, no mask), a causal mask whose
                first row is fully masked at m = NEG_INF (where masked
                tiles may not be skipped), the fully masked first-step row
                with an exact tie, a ragged case (T 100, S 72, D 16), a
                causal case at D 64, and a wide-range case (q and k x 4,
                so that s spans about +-100) at D 128.
3. main path    ``distributed_histogram`` through a world-1 NCCL group at
                the two full-width shapes, against the f64 host histogram.
4. rounds       ``init(engine="torch")`` on the card, then three boosting
                rounds at each boosted-round shape, each histogram against
                numpy ``bincount`` in f64; ``load_checkpoint`` ends at
                version 3.
5. transformer  ``train_flagship``: the full-width flagship (vocab 256, 2 x
                d_model 256, 8 x 32 heads, d_ff 1024, seq 512, batch 8)
                takes 16 SGD steps on a world-1 NCCL mesh and its loss
                falls; then one step through the kernels against the same
                step through the plain block update (loss and parameters
                within 5e-4), and a profile of three steps.
6. sweep        ``tools.histogram_sweep`` at its full grid (rows 2^20, 2^21
                x bins 256, 1024, 4096; mask_only, fast, high), no
                artifact: its six rows and its exact count check.
7. bench        ``rabit_tpu_torch.bench`` at full size (2^21 x 1024): its
                JSON line, which must say correct, no artifact.
8. proof        ``tools.kernel_hw_proof`` at full size, no artifact, and
                the flash kernels' launches on its chains.
9. timing       CUDA-event medians of each kernel, its plain version and
                one PyTorch call that computes the same function, beside
                the least time the card could take; for mask_only also
                the sweep's slope; for the flash backward also SDPA's
                backward alone (one ``autograd.grad`` over a retained
                graph a call, from saved forward outputs); the training
                step.
10. collectives the collective layer (``parallel/``) on the card: the wire
                codec (bf16 and int8, blocks 1024 and 512) against its
                plain CPU version bit for bit at the histogram payloads
                and 2^21 floats; every method through the dispatcher
                ``allreduce`` in an NCCL world of 1 (which returns x);
                ``dispatch.resolve`` over a table in a temporary file;
                with two cards or more, ``tools.collective_sweep
                --smoke`` at world min(4, cards) over NCCL, its rows.
11. robust      the robust engine under the port: the native core's build
                (g++, beside the nvccs of phase 1); ``tools.boosted_trees``
                at the headline shape (64 features x 16 buckets x 32,768
                rows: 2^21 entries into 1024 bins a rank), six rounds,
                under the port's launcher at world 1 (mock engine,
                ``rabit_ckpt_dir``): a kill at round 3, the respawn's cold
                restart from the durable store at version 3, trees equal to
                the run without a kill bit for bit, the histogram kernel
                launched every round; the histogram payload through
                ``TorchEngine`` at world 1; with two cards or more, at world
                min(4, cards) with the torch data plane over NCCL
                (``rabit_dataplane_minbytes=0``): a run without a kill, a
                kill of rank 1 at round 3 and a scripted data-plane failure
                end with the same trees on every rank, the epoch advanced;
                the allreduce's host-paced ms through the robust engine and
                through ``TorchEngine``, the seconds from the kill to the
                first collective of the re-formed world and to form the
                NCCL world.
12. kernels     one JSON line of every kernel with its main-path launches.

Launch counters are set to 0 just before each path (phases 3-4, phase 5,
phase 6) and read just after it, so a kernel's count is its own path's
alone: mask_only's is the sweep's. Phase 11's histogram launches are
counted in its workers, each a fresh process (so from 0), and printed
there. The last line is the device JSON.
Without CUDA, or without the package beside this file, the script exits
non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12        # f32 outside the tensor cores, same source
# f32 accuracy on the tensor cores: 495 TFLOP/s of TF32 (same source) over
# the three products of the 3xTF32 split
TF32X3_OPS_PER_S = 495e12 / 3
REPLACES = {"histogram": "rabit_tpu/ops/pallas_kernels.py:133",
            "flash_block": "rabit_tpu/ops/pallas_kernels.py:398",
            "flash_block_bwd": "rabit_tpu/ops/pallas_kernels.py:345",
            "mask_only": "tools/histogram_sweep.py:79"}
SOURCES = {"histogram": "rabit_tpu_torch/csrc/histogram.cu",
           "flash_block": "rabit_tpu_torch/csrc/flash_block.cu",
           "flash_block_bwd": "rabit_tpu_torch/csrc/flash_block_bwd.cu",
           "mask_only": "rabit_tpu_torch/csrc/mask_only.cu"}

# (rows, nbins): bench.py's headline, and the HIGGS gpu_hist contribution
# count (131,072 rows x 28 features) over 28 x 256 bins
FULL_WIDTH = [(1 << 21, 1024), (3_670_016, 7168)]
# the JAX tests' widest histogram, one bin tile of 133,120 B of shared memory
WIDE = (100_000, 16_640)
# the sweep's grid (tools/histogram_sweep.py:126-127), and the bin count's
# edge cases: ragged rows (no multiple of 4 or 16384) in an unaligned view,
# with 1000 bins (no multiple of 128) and with 120,000 (three tiles of
# 57,344 bins of shared memory)
SWEEP_GRID = [(n, nb) for n in (1 << 20, 1 << 21) for nb in (256, 1024, 4096)]
MASK_EDGES = [(1_000_003, 1000), (1_000_003, 120_000)]
# mask_only's timing rows: the sweep's headline and its most contended
MASK_TIMING = [(1 << 21, 1024), (1 << 20, 256)]
# boosted_round_worker.py: rows, features, buckets
ROUND_SHAPES = [(131_072, 16, 64), (131_072, 28, 256)]
N_ROUNDS = 3
# kernel vs plain version: f32 sums of the same (bf16-rounded for "fast")
# values in two atomic orders, which change from run to run. The rounding
# error grows like sqrt(rows per bin) ulps of the partial sums: rtol covers
# the large hess sums (~1e3 at 2^21 rows over 1024 bins), atol the grad
# sums near zero.
KERNEL_TOL = dict(rtol=1e-5, atol=1e-3)
TIMING_REPS = 20
# flash block shapes (B*H, T, S, D, causal): the training step's (batch 8
# x 8 heads, seq 512, d_head 32) and the ring chain's block of
# tools/kernel_hw_proof.py:156 (8 heads, 1024, d_head 128)
FLASH_MAIN = (64, 512, 512, 32, True)
FLASH_CHAIN = (8, 1024, 1024, 128, False)
# the forward against its plain version (tests/test_ring_attention.py's
# tolerance); each backward gradient within max|diff| / max|ref| (the
# bound tools/kernel_hw_proof.py:131-135 holds the TPU kernel to)
FLASH_FWD_TOL = dict(rtol=1e-4, atol=1e-4)
FLASH_BWD_REL = 1e-3
# the 3xTF32 tile product against f64, max|diff| / max|ref| (the split
# keeps about 2^-22 of each operand; 1xTF32 gives about 3e-4)
MMA_TILE_REL = 1e-5
# one training step through the kernels vs through the plain block update
# (tests/test_transformer.py:69-73)
STEP_TOL = 5e-4
FLAGSHIP_STEPS = 16
# kernels that may not spill registers
NO_SPILL = ("flash_bwd_", "flash_fwd_", "histogram_kernel", "mask_only_kernel")


def phase(name: str, msg: str) -> None:
    print(f"[{name}] {msg}", flush=True)


def bench_tol(rows_total: int, nbins: int) -> dict:
    """bench.py's spot-check tolerance against the f64 host histogram."""
    return dict(rtol=1e-3, atol=4e-3 * math.sqrt(rows_total / nbins))


def assert_close(got, want, what: str, rtol: float, atol: float) -> float:
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        raise AssertionError(f"{what}: shape {got.shape} != {want.shape}")
    if not np.isfinite(got).all():
        raise AssertionError(f"{what}: non-finite values")
    err = np.abs(got - want)
    bad = err > atol + rtol * np.abs(want)
    if bad.any():
        i = int(np.argmax(err - rtol * np.abs(want)))
        raise AssertionError(
            f"{what}: {int(bad.sum())} of {bad.size} values off; worst "
            f"at {np.unravel_index(i, got.shape)}: {got.flat[i]} vs "
            f"{want.flat[i]} (rtol {rtol}, atol {atol})")
    return float(err.max())


def phase_build() -> None:
    from concurrent.futures import ThreadPoolExecutor
    from rabit_tpu_torch.engine import _native_build
    from rabit_tpu_torch.ops import _build
    t0 = time.perf_counter()
    # the native core (one g++) compiles while the kernels' nvccs run
    with ThreadPoolExecutor(1) as pool:
        native = pool.submit(_native_build.build)
        built = _build.build()
        native_s = native.result()
    phase("build", f"{sorted(_build.sources())} ready in "
          f"{time.perf_counter() - t0:.2f} s (per kernel, s: "
          f"{ {k: round(v, 2) for k, v in built.items()} })")
    phase("build", f"native core {_native_build.library_path().name}: "
          f"g++ {native_s:.2f} s (0 = already built), beside the nvccs")
    for name in sorted(_build.sources()):
        summary = ptxas_summary(_build.ptxas_log(name).read_text())
        phase("build", f"ptxas {name}: " + "; ".join(summary))
        spilled = [s for s in summary if s.startswith(NO_SPILL)
                   and not s.endswith(" 0 B spilled")]
        if spilled:
            raise AssertionError(f"kernels spill registers: {spilled}")
    # every instantiation: 4 DP x mask / no mask; the backward has two
    # kernels of each
    for name, prefix, expect in (("flash_block", "flash_fwd_", 8),
                                 ("flash_block_bwd", "flash_bwd_", 16)):
        hmma = {k: n for k, n in sass_counts(
            _build.library_path(name), "HMMA").items()
            if k.startswith(prefix)}
        phase("build", f"HMMA instructions in the SASS of {name}: {hmma}")
        if len(hmma) != expect or min(hmma.values()) == 0:
            raise AssertionError(f"a {prefix}* kernel runs no tensor-core "
                                 f"product (HMMA counts {hmma}; {expect} "
                                 f"kernels expected)")


def sass_counts(library: Path, opcode: str) -> dict:
    """Kernel -> its count of ``opcode`` instructions, from the SASS that
    ``cuobjdump -sass`` (beside nvcc) prints of the library."""
    from rabit_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, kernel = {}, None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            kernel = demangled(fn.group(1))
            counts[kernel] = 0
        elif kernel and re.search(rf"\b{opcode}\b", line):
            counts[kernel] += 1
    return counts


def phase_tile(dev) -> None:
    """The backward's score-tile function alone (``csrc/flash_mma.cuh``
    through the library's check entry ``rabit_flash_mma_tile_f32``): a
    [64, d] x [64, d]^T tile of normals against a torch f64 product, at
    d = DP = 16, 32, 64, 128 and at d = 99 (4-byte copies). Beside it,
    what 1xTF32 (each operand rounded to TF32 once) gives on the same
    tile. Then the forward's s is the backward's s: a first-step forward
    (m = NEG_INF, l = o = 0, no mask, scale 1) on the same tiles gives an
    m' equal to the tile's row max, bit for bit."""
    from rabit_tpu_torch.ops import _build
    from rabit_tpu_torch.ops import flash as F
    p = ctypes.c_void_p
    fn = _build.entry("flash_block_bwd", "rabit_flash_mma_tile_f32",
                      [p, p, ctypes.c_int, p, p])
    gen = torch.Generator(device=dev).manual_seed(30)

    def tf32(x):   # to nearest, ties away, 10 mantissa bits
        return ((x.view(torch.int32) + 0x1000) & ~0x1FFF).view(torch.float32)

    for d in (16, 32, 64, 128, 99):
        a, b = (torch.randn((64, d), generator=gen, device=dev)
                for _ in range(2))
        got = torch.empty((64, 64), device=dev)
        err = fn(a.data_ptr(), b.data_ptr(), d, got.data_ptr(),
                 torch.cuda.current_stream(dev).cuda_stream)
        _build.check(err, "flash_block_bwd")
        torch.cuda.synchronize()
        ref = a.double() @ b.double().T
        rel = float((got.double() - ref).abs().max() / ref.abs().max())
        one = tf32(a).double() @ tf32(b).double().T
        rel1 = float((one - ref).abs().max() / ref.abs().max())
        mo, _, _ = F.flash_block(
            a[None], b[None], torch.randn((1, 64, d), generator=gen,
                                          device=dev),
            torch.full((1, 64), F.NEG_INF, device=dev),
            torch.zeros((1, 64), device=dev),
            torch.zeros((1, 64, d), device=dev), None, 1.0)
        torch.cuda.synchronize()
        same = torch.equal(mo[0], got.amax(dim=1))
        phase("tile", f"3xTF32 score tile [64, {d}] x [64, {d}]^T: "
              f"max|diff|/max|ref| {rel:.3g} against f64 (limit "
              f"{MMA_TILE_REL}; 1xTF32 on the same tile {rel1:.3g}); the "
              f"forward's m' equals its row max bit for bit: {same}")
        if not rel <= MMA_TILE_REL:
            raise AssertionError(f"score tile d={d}: {rel:.3g} > "
                                 f"{MMA_TILE_REL}")
        if not same:
            raise AssertionError(
                f"d={d}: the forward's m' differs from the tile function's "
                f"row max in {int((mo[0] != got.amax(dim=1)).sum())} of 64 "
                f"rows")


def demangled(symbol: str) -> str:
    """'name<args>' of a kernel template's mangled symbol (integer and
    bool arguments): the identifier whose length prefix ends where its
    template arguments begin; 'name' of a plain function in a namespace
    (the last of its length-prefixed names)."""
    args = re.search(r"I((?:L[a-z]\d+E)+)E", symbol)
    if not args:
        names, i = [], 3
        while symbol.startswith("_ZN") and i < len(symbol) \
                and symbol[i].isdigit():
            digits = re.match(r"\d+", symbol[i:]).group()
            i += len(digits)
            names.append(symbol[i:i + int(digits)])
            i += int(digits)
        return names[-1] if names else symbol
    values = ", ".join(re.findall(r"L[a-z](\d+)E", args.group(1)))
    end = args.start()
    for start in range(end - 1, 0, -1):
        if symbol[:start].endswith(str(end - start)):
            return f"{symbol[start:end]}<{values}>"
    return symbol


def ptxas_summary(log: str) -> list:
    """'kernel<D>: N registers, B B spilled' for each kernel in ptxas's
    -v output."""
    out, kernel = [], None
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            kernel = demangled(entry.group(1))
        spill = re.search(r"(\d+) bytes spill stores", line)
        if spill and kernel:
            spilled = spill.group(1)
        regs = re.search(r"Used (\d+) registers", line)
        if regs and kernel:
            out.append(f"{kernel} {regs.group(1)} registers, "
                       f"{spilled} B spilled")
            kernel = None
    return out


def _hist_case(n: int, nbins: int, seed: int, dev, edge: bool = False):
    from rabit_tpu_torch import convert
    from rabit_tpu_torch.models.histogram import make_inputs
    g, h, b = make_inputs(n + 1 if edge else n, nbins, p=1, seed=seed)
    if edge:
        b = b.copy()
        b[0, ::7] = nbins                        # the padding id
        b[0, 3::11] = -1
        b[0, 5::13] = np.iinfo(np.int32).min
    g, h, b = convert.inputs_from_numpy(g, h, b, rank=0, device=dev)
    if edge:  # one element in: pointers off 16-byte alignment
        g, h, b = g[1:], h[1:], b[1:]
    return b, g, h


def phase_kernel(dev) -> float:
    """Kernel vs plain version; returns the largest absolute difference."""
    from rabit_tpu_torch.ops import histogram as K
    cases = [(n, nb, False) for n, nb in FULL_WIDTH + [WIDE]]
    cases.append((1_000_003, 1024, True))
    worst = 0.0
    for i, (n, nbins, edge) in enumerate(cases):
        bins, grad, hess = _hist_case(n, nbins, 10 + i, dev, edge)
        for precision in ("high", "fast"):
            got = K.histogram(bins, grad, hess, nbins, precision)
            want = K.histogram_reference(bins, grad, hess, nbins, precision)
            torch.cuda.synchronize()
            err = assert_close(got.cpu(), want.cpu(),
                               f"histogram {n}x{nbins} {precision}",
                               **KERNEL_TOL)
            worst = max(worst, err)
            phase("kernel", f"histogram rows={n} nbins={nbins} "
                  f"{'edge ' if edge else ''}{precision}: max |diff| "
                  f"{err:.3g} (rtol {KERNEL_TOL['rtol']}, atol "
                  f"{KERNEL_TOL['atol']})")
    return worst


def _ids_case(n: int, nbins: int, seed: int, dev, edge: bool = False):
    """Bin ids on the card from a seed: all in [0, nbins), or for an edge
    case from -3 to nbins + 40 with -1, nbins, nbins + 40, 2^30 and the
    int32 minimum among them, in a view one element in (off 16-byte
    alignment)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lo, hi = (-3, nbins + 41) if edge else (0, nbins)
    b = torch.randint(lo, hi, (n + int(edge),), generator=gen,
                      dtype=torch.int32, device=dev)
    if edge:
        b[1:6] = torch.tensor([-1, nbins, nbins + 40, 1 << 30,
                               np.iinfo(np.int32).min], dtype=torch.int32)
        b = b[1:]
    return b


def phase_mask_kernel(dev) -> float:
    """The bin count against its plain version, bit for bit: both count
    exactly (integers below 2^24 in f32). Returns the largest difference,
    0."""
    from rabit_tpu_torch.ops import histogram as K
    cases = [(n, nb, False) for n, nb in SWEEP_GRID]
    cases += [(n, nb, True) for n, nb in MASK_EDGES]
    for i, (n, nbins, edge) in enumerate(cases):
        bins = _ids_case(n, nbins, 40 + i, dev, edge)
        got = K.mask_only(bins, nbins)
        want = K.mask_only_reference(bins, nbins)
        torch.cuda.synchronize()
        valid = int(((bins >= 0) & (bins < nbins)).sum())
        if got.shape != want.shape or not torch.equal(got, want):
            off = int((got != want).sum()) if got.shape == want.shape else -1
            raise AssertionError(f"mask_only {n}x{nbins}: {off} of {nbins} "
                                 f"counts differ from the plain version")
        if int(want.sum()) != valid:
            raise AssertionError(f"mask_only {n}x{nbins}: counted "
                                 f"{int(want.sum())} of {valid} valid ids")
        phase("kernel", f"mask_only rows={n} nbins={nbins} "
              f"{'edge (unaligned, out-of-range ids) ' if edge else ''}"
              f"exactly equal to the plain version ({valid} ids counted)")
    return 0.0


def phase_device_ops(dev) -> None:
    """One device operation a call: ``torch.profiler`` over one window of
    a few calls of ``histogram`` (both precisions, the main path's two
    shapes) and of ``mask_only`` (its two timing shapes) sees one kind of
    kernel, one a call, and nothing else (no memset, no fill, no second
    pass). Each call of a window has inputs of its own, and two witnesses
    stand beside the profiler: the wrapper's launch count over the window
    must equal the calls, and each call's output must agree with the
    plain version on its own inputs (a call whose kernel did not run
    leaves whatever its buffer held: every output of this phase is
    poisoned with NaN before it is freed, so no buffer holds an earlier
    call's result). A window in which the profiler recorded fewer kernels
    than that, all of the one kind, passes on those witnesses and says so
    (see PERF.md §7); more operations than calls, or a second kind,
    fail."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rabit_tpu_torch.ops import histogram as K
    calls = 5
    runs = []
    for n, nbins in FULL_WIDTH:
        cases = [_hist_case(n, nbins, 2 + i, dev) for i in range(calls)]
        for precision in ("high", "fast"):
            runs.append((f"histogram {n}x{nbins} {precision}", K.histogram,
                         [c + (nbins, precision) for c in cases],
                         lambda b, g, h, nb, p: K.histogram_reference(
                             b, g, h, nb, p).cpu(), KERNEL_TOL))
    for n, nbins in MASK_TIMING:
        runs.append((f"mask_only {n}x{nbins}", K.mask_only,
                     [(_ids_case(n, nbins, 2 + i, dev), nbins)
                      for i in range(calls)],
                     lambda b, nb: K.mask_only_reference(b, nb).cpu(),
                     dict(rtol=0.0, atol=0.0)))
    for label, wrapper, arg_sets, plain, tol in runs:
        # the first call of a shape asks the library once
        warm = wrapper(*arg_sets[0])
        torch.cuda.synchronize()
        launched = wrapper.launches
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            outs = [wrapper(*args) for args in arg_sets]
            torch.cuda.synchronize()
        launched = wrapper.launches - launched
        ops = {e.key: e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA}
        seen = sum(ops.values())
        if seen == 0:
            raise AssertionError(f"{label}: torch.profiler saw no device "
                                 f"operation")
        if len(ops) != 1 or seen > calls:
            raise AssertionError(f"{label}: {calls} calls made the device "
                                 f"operations {ops}, not one kernel a call")
        if launched != calls:
            raise AssertionError(f"{label}: the wrapper counted {launched} "
                                 f"launches for {calls} calls")
        for i, (out, args) in enumerate(zip(outs, arg_sets)):
            assert_close(out.cpu(), plain(*args), f"{label} call {i}", **tol)
        for out in outs + [warm]:
            out.fill_(float("nan"))
        witness = (f"the wrapper counted {launched} launches and each "
                   f"call's output agreed with the plain version")
        if seen < calls:
            witness = (f"torch.profiler recorded {seen} of the {calls} "
                       f"kernels; {witness}")
        phase("ops", f"{label}: {calls} calls, device operations {ops}; "
              f"{witness}")


def flash_case(bh: int, t: int, s: int, d: int, mask_kind, seed: int, dev,
               first_step: bool = False, spread: float = 1.0):
    """Inputs (q, k, v, m, l, o, mask) and cotangents (cm, cl, co) of one
    block step, from a seed; q and k are normals times ``spread``.
    ``first_step``: the ring's first step (m = NEG_INF, l = o = 0);
    otherwise a running state. ``mask_kind`` is None,
    "causal", "causal, row 0 masked" (the kernels skip the tiles above the
    diagonal, but not for the first row block, whose row 0 keeps m =
    NEG_INF) or "tie": a random mask whose row 0 is fully masked with m =
    NEG_INF (both max ops tie exactly there), and an exact tie across two
    unmasked lanes of row 1."""
    from rabit_tpu_torch.ops.flash import NEG_INF
    gen = torch.Generator(device=dev).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    q, k, v = normal(bh, t, d), normal(bh, s, d), normal(bh, s, d)
    q, k = q * spread, k * spread
    if first_step:
        m = torch.full((bh, t), NEG_INF, device=dev)
        l, o = torch.zeros(bh, t, device=dev), torch.zeros(bh, t, d,
                                                           device=dev)
    else:
        m, o = normal(bh, t), normal(bh, t, d)
        l = torch.rand((bh, t), generator=gen, device=dev) + 0.5
    mask = None
    if mask_kind == "causal":
        mask = torch.ones(t, s, dtype=torch.bool, device=dev).triu(1)
    elif mask_kind == "causal, row 0 masked":
        mask = torch.ones(t, s, dtype=torch.bool, device=dev).triu(1)
        mask[0] = True
    elif mask_kind == "tie":
        mask = torch.rand((t, s), generator=gen, device=dev) < 0.3
        mask[0] = True
        m[:, 0] = NEG_INF
        k[:, 5] = k[:, 3]
        mask[1, 3] = mask[1, 5] = False
    return (q, k, v, m, l, o, mask), (normal(bh, t), normal(bh, t),
                                      normal(bh, t, d))


# (label, (B*H, T, S, D), mask, first step, spread of q and k)
FLASH_CASES = [
    ("training shape", FLASH_MAIN[:4], "causal", True, 1.0),
    ("chain block", FLASH_CHAIN[:4], None, False, 1.0),
    ("fully masked first row", (4, 192, 192, 32), "causal, row 0 masked",
     True, 1.0),
    ("tie row", (2, 64, 64, 32), "tie", False, 1.0),
    ("ragged", (3, 100, 72, 16), "tie", False, 1.0),
    ("D 64", (4, 256, 320, 64), "causal", True, 1.0),
    # s = q.k / sqrt(D) with a spread of about 16 (|s| up to about 100),
    # where a split's error grows with |s|
    ("wide range", (2, 256, 256, 128), None, False, 4.0),
]


def phase_flash_kernel(dev) -> dict:
    """Both flash kernels against their plain versions; returns the
    largest absolute difference of each."""
    from rabit_tpu_torch.ops import flash as F
    worst = {"flash_block": 0.0, "flash_block_bwd": 0.0}
    for i, (label, (bh, t, s, d), mask_kind, first, spread) in \
            enumerate(FLASH_CASES):
        ins, cts = flash_case(bh, t, s, d, mask_kind, 20 + i, dev, first,
                              spread)
        sm = d ** -0.5
        got = F.flash_block(*ins, sm)
        want = F.block_update_reference(*ins, sm)
        torch.cuda.synchronize()
        for name, g, w in zip(("m'", "l'", "o'"), got, want):
            err = assert_close(g.cpu(), w.cpu(), f"flash_block {label} {name}",
                               **FLASH_FWD_TOL)
            worst["flash_block"] = max(worst["flash_block"], err)
        got = F.flash_block_bwd(*ins, sm, *cts)
        want = F.block_update_bwd_reference(*ins, sm, *cts)
        torch.cuda.synchronize()
        rels = {}
        for name, g, w in zip(("dq", "dk", "dv", "dm", "dl", "do"), got,
                              want):
            if not torch.isfinite(g).all():
                raise AssertionError(f"flash_block_bwd {label} {name}: "
                                     f"non-finite values")
            diff = float((g - w).abs().max())
            rels[name] = diff / max(float(w.abs().max()), 1e-30)
            worst["flash_block_bwd"] = max(worst["flash_block_bwd"], diff)
            if rels[name] > FLASH_BWD_REL:
                raise AssertionError(
                    f"flash_block_bwd {label} {name}: max|diff|/max|ref| "
                    f"{rels[name]:.3g} > {FLASH_BWD_REL}")
        phase("kernel", f"flash {label} (B*H {bh}, T {t}, S {s}, D {d}, "
              f"mask {mask_kind}, q k x {spread}): forward within rtol/atol "
              f"{FLASH_FWD_TOL['rtol']}; backward max|diff|/max|ref| "
              + ", ".join(f"{n} {r:.2g}" for n, r in rels.items()))
    return worst


def reset_launches() -> None:
    from rabit_tpu_torch.ops import flash as F
    from rabit_tpu_torch.ops import histogram as K
    K.histogram.launches = 0
    K.mask_only.launches = 0
    F.flash_block.launches = 0
    F.flash_block_bwd.launches = 0


def read_launches() -> dict:
    from rabit_tpu_torch.ops import flash as F
    from rabit_tpu_torch.ops import histogram as K
    return {"histogram": K.histogram.launches,
            "mask_only": K.mask_only.launches,
            "flash_block": F.flash_block.launches,
            "flash_block_bwd": F.flash_block_bwd.launches}


def phase_sweep(dev) -> dict:
    """The histogram measurement path: the sweep at its full grid, no
    artifact. Returns its rows and the launches of the run."""
    from rabit_tpu_torch.tools import histogram_sweep
    reset_launches()
    t0 = time.perf_counter()
    out = histogram_sweep.sweep(dev, emit=lambda line: phase("sweep", line))
    wall = time.perf_counter() - t0
    launches = read_launches()
    if launches["mask_only"] < 1:
        raise AssertionError("kernel mask_only was not launched on the "
                             "sweep path")
    phase("sweep", f"{len(out['table'])} rows in {wall:.1f} s wall, slopes "
          f"K={out['k'][0]}->{out['k'][1]} on {out['clock']}, pools "
          f"{out['pool_datasets']} (rows -> datasets); launches {launches}")
    return {"table": out["table"], "launches": launches}


def phase_bench(dev) -> dict:
    """The bench twin at full size, no artifact: its JSON line, which must
    say correct."""
    from rabit_tpu_torch import bench
    out = bench.bench(dev)
    line, doc = out["line"], out["artifact"]
    phase("bench", json.dumps(line))
    phase("bench", f"headline {doc['headline']}; host-paced "
          f"{doc['host_paced']['value']:.3f} GB/s (vs_baseline "
          f"{doc['host_paced']['vs_baseline']:.3f}); ms a call "
          f"{doc['t_ms']}; GB/s by rows {doc['bandwidth_vs_rows']} "
          f"(host-paced {doc['bandwidth_vs_rows_host_paced']}); numpy "
          f"host {doc['t_host_ms']:.2f} ms")
    if line["correct"] is not True:
        raise AssertionError(f"bench: the histogram allreduce is not "
                             f"correct: {line}")
    return doc


def phase_proof(dev) -> dict:
    """``kernel_hw_proof`` at full size, no artifact, with the flash
    kernels' launches on its chains (the chain block's launch counts)."""
    from rabit_tpu_torch.tools import kernel_hw_proof
    reset_launches()
    t0 = time.perf_counter()
    evidence = kernel_hw_proof.prove(dev)
    if not evidence["complete"]:
        raise AssertionError("kernel_hw_proof did not complete")
    launches = read_launches()
    phase("proof", f"every stage passed in {time.perf_counter() - t0:.1f} "
          f"s; launches {launches}")
    evidence["launches"] = launches
    return evidence


def phase_transformer(dev) -> dict:
    """The flagship training run (the main path), then the checks and the
    profile. Returns the launches of the run and the step times."""
    from rabit_tpu_torch import entry as E
    from rabit_tpu_torch.models import transformer as tf
    from rabit_tpu_torch.ops import flash as F
    from rabit_tpu_torch.parallel.mesh import make_mesh
    import torch.distributed as dist
    reset_launches()
    t0 = time.perf_counter()
    out = E.train_flagship(FLAGSHIP_STEPS, dev)
    wall = time.perf_counter() - t0
    launches = read_launches()
    n_layers = E.FLAGSHIP_SIZES["n_layers"]
    for name in ("flash_block", "flash_block_bwd"):
        if launches[name] != FLAGSHIP_STEPS * n_layers:
            raise AssertionError(
                f"{name} launched {launches[name]} times in "
                f"{FLAGSHIP_STEPS} steps of {n_layers} layers")
    losses = out["losses"]
    step_ms = float(np.median(out["step_ms"][1:]))
    phase("transformer", f"train_flagship {FLAGSHIP_STEPS} steps on "
          f"{out['device']}: loss {losses[0]:.4f} -> {losses[-1]:.4f} (tail "
          f"mean {np.mean(losses[-4:]):.4f}, must be < {losses[0] - 0.8:.4f})"
          f"; step {step_ms:.3f} ms median on CUDA events (first "
          f"{out['step_ms'][0]:.1f} ms, build included); {wall:.1f} s wall; "
          f"launches {launches}")

    # one step through the kernels against the same step through the
    # plain block update, on the card
    params = tf.init_params(1, **E.FLAGSHIP_SIZES)
    x, y = (torch.from_numpy(a).to(dev) for a in E.flagship_data(1))
    mesh = make_mesh((1, 1, 1), dev)
    try:
        if dist.get_backend() != "nccl":
            raise AssertionError(f"expected an NCCL group, got "
                                 f"{dist.get_backend()}")
        models, step_losses = [], []
        for plain in (False, True):
            model = tf.model_on(params, dev)
            step = tf.make_train_step(mesh, lr=E.FLAGSHIP_LR)
            with F.plain_block_step() if plain else contextlib.nullcontext():
                step_losses.append(float(step(model, x, y)))
            models.append(model.params())
        dloss = abs(step_losses[0] - step_losses[1])
        if dloss >= STEP_TOL:
            raise AssertionError(f"step loss kernel {step_losses[0]} vs "
                                 f"plain {step_losses[1]}")
        worst = 0.0
        for name, w in models[1].items():
            worst = max(worst, assert_close(
                models[0][name].detach().cpu(), w.detach().cpu(),
                f"step parameter {name}", STEP_TOL, STEP_TOL))
        phase("transformer", f"one step, kernels vs plain block update: "
              f"|d loss| {dloss:.3g}, parameters max |diff| {worst:.3g} "
              f"(within {STEP_TOL})")
        model = tf.model_on(params, dev)
        step = tf.make_train_step(mesh, lr=E.FLAGSHIP_LR)
        profile = phase_profile(lambda: step(model, x, y))
    finally:
        dist.destroy_process_group()
    return {"launches": launches, "step_ms": step_ms,
            "first_step_ms": out["step_ms"][0], "losses": losses,
            "profile": profile}


def phase_profile(run_step, steps: int = 3) -> dict:
    """``torch.profiler`` over a few training steps: device time by kernel
    and the device's busy share of the window."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run_step()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(steps):
            run_step()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # the device's own events (kernels, copies), not the host ops that
    # launched them
    rows = sorted(((float(evt.self_device_time_total), evt.key,
                    int(evt.count)) for evt in prof.key_averages()
                   if evt.device_type == DeviceType.CUDA
                   and evt.self_device_time_total > 0), reverse=True)
    total = sum(r[0] for r in rows)
    if total == 0:
        phase("profile", "torch.profiler saw no device time: not measured")
        return {"device_us_per_step": None}
    flash = sum(r[0] for r in rows if "flash_" in r[1])
    phase("profile", f"{steps} steps: device busy {total / steps:.1f} us a "
          f"step of {wall_us / steps:.1f} us host wall under the profiler "
          f"({total / wall_us:.1%}); flash kernels {flash / steps:.1f} us "
          f"({flash / total:.1%} of the device time)")
    for dev_us, key, count in rows[:12]:
        phase("profile", f"  {dev_us / steps:9.1f} us/step "
              f"{dev_us / total:6.1%}  x{count // steps:<4d} {key[:90]}")
    return {"device_us_per_step": total / steps,
            "flash_us_per_step": flash / steps,
            "wall_us_per_step": wall_us / steps,
            "top": [{"us_per_step": d / steps, "kernel": k[:120],
                     "calls_per_step": c // steps} for d, k, c in rows[:12]]}


def phase_main_path(dev) -> None:
    import torch.distributed as dist
    from rabit_tpu_torch import convert
    from rabit_tpu_torch.models.histogram import (
        distributed_histogram, host_histogram, make_inputs)
    from rabit_tpu_torch.parallel.mesh import make_group
    group, dev = make_group(dev)
    try:
        if dist.get_backend(group) != "nccl":
            raise AssertionError(f"expected an NCCL group, got "
                                 f"{dist.get_backend(group)}")
        for n, nbins in FULL_WIDTH:
            g, h, b = make_inputs(n, nbins, p=1, seed=1)
            tg, th, tb = convert.inputs_from_numpy(g, h, b, rank=0,
                                                   device=dev)
            t0 = time.perf_counter()
            got = distributed_histogram(tg, th, tb, nbins, group)
            got = got.cpu().numpy()
            wall = time.perf_counter() - t0
            want = host_histogram(g[0], h[0], b[0], nbins).astype(np.float64)
            err = assert_close(got, want, f"distributed_histogram {n}x{nbins}",
                               **bench_tol(n, nbins))
            phase("main path", f"distributed_histogram rows={n} "
                  f"nbins={nbins} world={dist.get_world_size(group)} "
                  f"nccl: max |err| vs f64 host {err:.3g}, {wall * 1e3:.1f} "
                  f"ms host wall incl. copy back")
    finally:
        dist.destroy_process_group()


def phase_rounds(dev) -> None:
    import rabit_tpu_torch as rabit
    from rabit_tpu_torch.models.histogram import local_histogram
    for rows, n_feat, n_buckets in ROUND_SHAPES:
        nbins = n_feat * n_buckets
        rabit.init([], engine="torch")   # the card by default
        try:
            gen = torch.Generator(device=dev).manual_seed(100 + nbins)
            x = torch.rand((rows, n_feat), generator=gen, device=dev)
            y = (torch.rand(rows, generator=gen, device=dev) < 0.5).float()
            buckets = (x * n_buckets).long().clamp_(max=n_buckets - 1)
            flat = (buckets + torch.arange(n_feat, device=dev) * n_buckets
                    ).reshape(-1).to(torch.int32)
            flat_np = flat.cpu().numpy()
            margin = torch.zeros(rows, device=dev)
            for rnd in range(N_ROUNDS):
                p = torch.sigmoid(margin)
                g, h = p - y, p * (1.0 - p)
                gw = g.repeat_interleave(n_feat)
                hw = h.repeat_interleave(n_feat)
                t0 = time.perf_counter()
                hist = local_histogram(gw, hw, flat, nbins)
                hist = rabit.allreduce(hist.cpu().numpy(), rabit.SUM)
                wall = time.perf_counter() - t0
                want = np.stack([
                    np.bincount(flat_np, weights=gw.double().cpu().numpy(),
                                minlength=nbins),
                    np.bincount(flat_np, weights=hw.double().cpu().numpy(),
                                minlength=nbins)], axis=1)
                err = assert_close(hist, want,
                                   f"round {rnd} {rows}x{n_feat}x{n_buckets}",
                                   **bench_tol(rows * n_feat, nbins))
                hd = torch.from_numpy(hist).to(dev)
                best = int(torch.argmax(hd[:, 0] ** 2 / (hd[:, 1] + 1.0)))
                f, bk = divmod(best, n_buckets)
                margin += 0.3 * torch.where(buckets[:, f] <= bk, -0.1, 0.1)
                rabit.checkpoint({"round": rnd, "split": (f, bk)})
                phase("rounds", f"{rows}x{n_feat}x{n_buckets} round {rnd}: "
                      f"split ({f}, {bk}), max |err| vs bincount f64 "
                      f"{err:.3g}, histogram+allreduce {wall * 1e3:.2f} ms "
                      f"host wall")
            version, model = rabit.load_checkpoint()
            if version != N_ROUNDS or model["round"] != N_ROUNDS - 1:
                raise AssertionError(f"checkpoint at version {version}, "
                                     f"model {model}")
            if not torch.isfinite(margin).all():
                raise AssertionError("margin went non-finite")
            phase("rounds", f"{rows}x{n_feat}x{n_buckets}: load_checkpoint "
                  f"-> version {version}")
        finally:
            rabit.finalize()


def time_ms(fn, args_sets) -> float:
    """Median device ms of ``fn(*args)`` over TIMING_REPS runs, cycling
    through copies of the inputs (together larger than the 50 MB L2, so
    each run reads from device memory). A sleep kernel ahead of each start
    event keeps the host's launch work off the measured interval."""
    for a in args_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    times = []
    for i in range(TIMING_REPS):
        a = args_sets[i % len(args_sets)]
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn(*a)
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_timing(dev, power: str):
    from rabit_tpu_torch.ops import histogram as K
    rows = []
    for n, nbins in FULL_WIDTH:
        bins, grad, hess = _hist_case(n, nbins, 3, dev)
        copies = max(4, math.ceil(150e6 / (12 * n)))
        sets = [(bins.clone(), grad.clone(), hess.clone())
                for _ in range(copies)]
        kernel = time_ms(lambda b, g, h: K.histogram(b, g, h, nbins), sets)
        plain = time_ms(
            lambda b, g, h: K.histogram_reference(b, g, h, nbins), sets)
        lib_sets = [(b, torch.stack([g, h], dim=1)) for b, g, h in sets]
        library = time_ms(
            lambda b, gh: torch.zeros((nbins, 2), device=dev).index_add_(
                0, b.long(), gh), lib_sets)
        nbytes = 12 * n + 8 * nbins   # each input read once, output once
        ops = 2 * n                   # one f32 add per value
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= ops / F32_OPS_PER_S else "operations")
        rows.append(dict(rows=n, nbins=nbins, ms=kernel, plain_ms=plain,
                         library_ms=library, bound_ms=bound,
                         bound_by=bound_by, bytes=nbytes))
        phase("timing", f"histogram rows={n} nbins={nbins}: kernel "
              f"{kernel:.4f} ms, bound {bound:.4f} ms ({bound_by}, "
              f"{nbytes} B; {bound / kernel:.1%} of it), plain "
              f"{plain:.4f} ms, library index_add_ {library:.4f} ms "
              f"[{power}]")
    return rows


def phase_mask_timing(dev, power: str, sweep_rows) -> list:
    """The bin count, its plain version and ``torch.bincount`` (the
    yardstick; the port never calls it), per launch, beside the bound and
    the sweep's slope at the same shape (the bound lies below one launch's
    latency)."""
    from rabit_tpu_torch.ops import histogram as K
    rows = []
    for n, nbins in MASK_TIMING:
        bins = _ids_case(n, nbins, 5, dev)
        sets = [(bins.clone(),) for _ in range(math.ceil(150e6 / (4 * n)))]
        kernel = time_ms(lambda b: K.mask_only(b, nbins), sets)
        plain = time_ms(lambda b: K.mask_only_reference(b, nbins), sets)
        library = time_ms(lambda b: torch.bincount(b, minlength=nbins), sets)
        nbytes = 4 * n + 4 * nbins    # each id read once, each count written
        # one integer add a row, at the f32 rate outside the tensor cores
        # (the data sheet gives no int32 rate); the bytes bound it ~40x over
        ops = n
        bound = max(nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S
                    >= ops / F32_OPS_PER_S else "operations")
        slope = next(r["mask_only_ms"] for r in sweep_rows
                     if (r["rows"], r["nbins"]) == (n, nbins))
        rows.append(dict(rows=n, nbins=nbins, ms=kernel, slope_ms=slope,
                         plain_ms=plain, library_ms=library, bound_ms=bound,
                         bound_by=bound_by, bytes=nbytes))
        phase("timing", f"mask_only rows={n} nbins={nbins}: kernel "
              f"{kernel:.4f} ms a launch, {slope:.4f} ms a call by the "
              f"sweep's slope, bound {bound:.4f} ms ({bound_by}, {nbytes} B;"
              f" {bound / kernel:.1%} of the launch, {bound / slope:.1%} of "
              f"the slope), plain {plain:.4f} ms, library bincount "
              f"{library:.4f} ms [{power}]")
    return rows


def flash_bound(bh: int, t: int, s: int, d: int, mask, backward: bool):
    """(bound ms, what bounds it, flops, bytes) of one call: 4 D flops
    forward and 10 D backward (two and five products) for each (query,
    key) pair that the mask leaves (about half of T S under a causal mask:
    a masked pair adds exactly 0 once its row's max is finite), against
    each input read once and each output written once at the memory rate.
    The flops are reckoned at the 3xTF32 tensor-core rate, not at the f32
    rate of the CUDA cores: the card can do this work at f32 accuracy on
    its tensor cores (each product as three TF32 products of split
    operands), so that is the least time it could take."""
    pairs = bh * (t * s if mask is None else int((~mask).sum()))
    rows, keys = bh * t * (2 + d), bh * s * 2 * d   # m, l, o; k, v
    nbytes = 4 * (bh * t * d + keys + rows) + (0 if mask is None else t * s)
    if backward:
        nbytes += 4 * (bh * t * (2 + d)        # cm, cl, co
                       + bh * t * d + keys + rows)  # dq; dk, dv; dm, dl, do
        flops = 10 * pairs * d
    else:
        nbytes += 4 * rows                     # m', l', o'
        flops = 4 * pairs * d
    by_ops, by_bytes = flops / TF32X3_OPS_PER_S, nbytes / HBM_BYTES_PER_S
    return (max(by_ops, by_bytes) * 1e3,
            "operations" if by_ops >= by_bytes else "bytes", flops, nbytes)


def phase_flash_timing(dev, power: str) -> dict:
    """Each flash kernel, its plain version and a PyTorch yardstick the
    port never calls (``scaled_dot_product_attention`` forward, forward +
    backward, and the backward alone from saved forward outputs, on the
    same q/k/v and mask in f32) at the training shape and the chain
    block."""
    import torch.nn.functional as TF
    from rabit_tpu_torch.ops import flash as F
    out = {"flash_block": [], "flash_block_bwd": []}
    for bh, t, s, d, causal in (FLASH_MAIN, FLASH_CHAIN):
        ins, cts = flash_case(bh, t, s, d, "causal" if causal else None, 3,
                              dev, first_step=True)
        per_set = sum(x.numel() * 4 for x in (*ins[:6], *cts))
        copies = max(2, math.ceil(150e6 / per_set))
        sets = [tuple(None if x is None else x.clone()
                      for x in (*ins, *cts)) for _ in range(copies)]
        sm = d ** -0.5
        fwd = time_ms(lambda *a: F.flash_block(*a[:7], sm), sets)
        fwd_plain = time_ms(lambda *a: F.block_update_reference(*a[:7], sm),
                            sets)
        bwd = time_ms(lambda *a: F.flash_block_bwd(*a[:7], sm, *a[7:]),
                      sets)
        bwd_plain = time_ms(
            lambda *a: F.block_update_bwd_reference(*a[:7], sm, *a[7:]),
            sets)
        lib_sets = [(q.clone().requires_grad_(), k.clone().requires_grad_(),
                     v.clone().requires_grad_(),
                     None if mask is None else ~mask, co)
                    for q, k, v, m, l, o, mask, cm, cl, co in sets]

        def sdpa(q, k, v, keep, co):
            return TF.scaled_dot_product_attention(q, k, v, attn_mask=keep,
                                                   scale=sm)

        def sdpa_fwd_bwd(q, k, v, keep, co):
            sdpa(q, k, v, keep, co).backward(co)

        with torch.no_grad():
            lib_fwd = time_ms(sdpa, lib_sets)
        lib_bwd = time_ms(sdpa_fwd_bwd, lib_sets)
        # SDPA's backward alone, on its own: the forward runs once a set,
        # untimed, and each timed call is one autograd.grad over its
        # retained graph
        bwd_sets = [(sdpa(q, k, v, keep, co), (q, k, v), co)
                    for q, k, v, keep, co in lib_sets]

        def sdpa_bwd(out, inputs, co):
            torch.autograd.grad(out, inputs, co, retain_graph=True)

        lib_bwd_alone = time_ms(sdpa_bwd, bwd_sets)
        del bwd_sets
        for name, ms, plain, lib, backward in (
                ("flash_block", fwd, fwd_plain, lib_fwd, False),
                ("flash_block_bwd", bwd, bwd_plain, lib_bwd, True)):
            bound, bound_by, flops, nbytes = flash_bound(bh, t, s, d, ins[6],
                                                         backward)
            row = dict(shape=[bh, t, s, d], causal=causal, ms=ms,
                       plain_ms=plain, library_ms=lib, bound_ms=bound,
                       bound_by=bound_by, flops=flops, bytes=nbytes)
            lib_note = f"sdpa {'fwd+bwd' if backward else 'fwd'} {lib:.4f} ms"
            if backward:
                row["library_bwd_ms"] = lib_bwd_alone
                lib_note += (f", sdpa bwd alone {lib_bwd_alone:.4f} ms "
                             f"(fwd+bwd - fwd {lib - lib_fwd:.4f} ms)")
            out[name].append(row)
            phase("timing", f"{name} B*H {bh} T {t} S {s} D {d} "
                  f"{'causal' if causal else 'no mask'}: kernel {ms:.4f} ms,"
                  f" bound {bound:.4f} ms ({bound_by}; {bound / ms:.1%} of "
                  f"it), plain {plain:.4f} ms, {lib_note} [{power}]")
    return out


CODEC_CASES = [("bf16", 1024), ("bf16", 512), ("int8", 1024), ("int8", 512)]
CODEC_SIZES = (2048, 14336, 1 << 21)   # the headline payloads, 8 MB


def _bits(t: torch.Tensor) -> torch.Tensor:
    """``t``'s bits on the CPU, as integers (so -0.0 differs from 0.0)."""
    t = t.detach().cpu()
    if t.dtype.is_floating_point:
        return t.view({2: torch.int16, 4: torch.int32}[t.element_size()])
    return t


def phase_collectives(dev) -> None:
    """The collective layer on the card (see the module's phase 10)."""
    import os
    import tempfile
    import torch.distributed as dist
    from rabit_tpu_torch.ops.reducers import SUM
    from rabit_tpu_torch.parallel import collectives as C
    from rabit_tpu_torch.parallel import dispatch, wire
    from rabit_tpu_torch.parallel.mesh import make_group
    gen = torch.Generator().manual_seed(8)
    for n in CODEC_SIZES:
        # blocks of every magnitude from 2^-30 to 2^29, a zero block, and
        # quotients that fall on .5 (round half to even)
        x = torch.randn(n, generator=gen)
        x = x * torch.exp2(torch.arange(n) // 512 % 60 - 30.0)
        x[:512] = 0.0
        x[512:1024] = torch.arange(512) * 0.5
        for codec, block in CODEC_CASES:
            plain = wire.encode(x, codec, block)
            card = wire.encode(x.to(dev), codec, block)
            for a, b in zip(plain, card):
                if not torch.equal(_bits(a), _bits(b)):
                    raise AssertionError(f"wire {codec}@{block} n={n}: the "
                                         f"card's encoding differs")
            got = wire.decode(card, codec, x.shape)
            if not torch.equal(_bits(wire.decode(plain, codec, x.shape)),
                               _bits(got)):
                raise AssertionError(f"wire {codec}@{block} n={n}: the "
                                     f"card's decoding differs")
        phase("collectives", f"wire codec n={n}: {CODEC_CASES} on the card "
              f"equal to the CPU bit for bit")
    group, dev = make_group(dev)
    try:
        x = torch.randn(40_000, generator=gen).to(dev)
        for method in dispatch.EXPLICIT_METHODS:
            for w in (None, "int8:bf16@512"):
                out = C.allreduce(x, group, SUM, method=method, wire=w)
                if not torch.equal(out, x):
                    raise AssertionError(f"allreduce {method} wire={w} at "
                                         f"world 1 changed x")
        phase("collectives", f"allreduce at world 1 over "
              f"{dist.get_backend(group)}: {dispatch.EXPLICIT_METHODS} "
              f"return x")
    finally:
        dist.destroy_process_group()
    table = {"float_sum": [
        {"max_n": 10_000, "method": "tree", "wire": None},
        {"max_n": 1_000_000, "method": "swing", "wire": "int8"},
        {"max_n": None, "method": "hier", "wire": None, "flat": "bidir"}],
        "other": [{"max_n": None, "method": "ring", "wire": None}]}
    hier = ((0, 1), (2, 3))
    cases = [((2048, torch.float32, 4, None), ("tree", None)),
             ((500_000, torch.float32, 4, None), ("swing", "int8")),
             ((500_000, torch.float32, 3, None), ("ring", "int8")),
             ((4_000_000, torch.float32, 4, hier), ("hier", None)),
             ((4_000_000, torch.float32, 4, None), ("bidir", None)),
             ((100, torch.int32, 4, None), ("ring", None))]
    env = {"RABIT_DISPATCH_TABLE": None, "RABIT_DATAPLANE_WIRE": "int8"}
    saved = {k: os.environ.get(k) for k in env}
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "COLLECTIVE_SWEEP_table.json")
        with open(path, "w") as f:
            json.dump({"schema": dispatch.SCHEMA, "table": table}, f)
        env["RABIT_DISPATCH_TABLE"] = path
        os.environ.update(env)
        try:
            for (n, dtype, p, groups), want in cases:
                got = dispatch.resolve(n, dtype, SUM, p, groups=groups)
                if got != want:
                    raise AssertionError(f"resolve({n}, {dtype}, p={p}, "
                                         f"{groups}) = {got}, want {want}")
        finally:
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
            dispatch.clear_cache()
    phase("collectives", f"dispatch.resolve over a table file: {len(cases)} "
          f"cases as expected")
    count = torch.cuda.device_count()
    if count < 2:
        phase("collectives", "one card: the NCCL sweep needs two or more")
        return
    world = min(4, count)
    t0 = time.perf_counter()
    res = subprocess.run(
        [sys.executable, "-m", "rabit_tpu_torch.tools.collective_sweep",
         "--smoke", "--world", str(world)], capture_output=True, text=True,
        timeout=600, cwd=Path(__file__).resolve().parent)
    for line in res.stdout.splitlines():
        phase("collectives", line)
    if res.returncode != 0 or "smoke ok" not in res.stdout:
        raise AssertionError(f"collective_sweep --smoke --world {world} "
                             f"failed (rc {res.returncode}):\n"
                             f"{res.stderr[-4000:]}")
    phase("collectives", f"collective_sweep --smoke --world {world} over "
          f"NCCL in {time.perf_counter() - t0:.1f} s")


# the robust phase: tools/boosted_trees.py at the headline shape (64
# features x 16 buckets x 32,768 rows a rank: 2^21 entries into 1024 bins),
# six rounds, a kill at round 3
BOOST_SHAPE = ("--features", "64", "--rows", "32768", "--bins", "16")
BOOST_ROUNDS = 6
BOOST_KILL = 3
BOOST_TIMEOUT_S = 300


def _launch_boost(n: int, args, env: dict) -> tuple:
    """``tools.boosted_trees`` as ``n`` workers under the port's launcher:
    each rank's ``BOOST-JSON`` document (a respawned rank's last) and the
    wall clock of every worker death the launcher saw."""
    import os
    import signal
    cmd = [sys.executable, "-m", "rabit_tpu_torch.tracker.launch", "-n",
           str(n), "--timeout", str(BOOST_TIMEOUT_S - 30), sys.executable,
           "-m", "rabit_tpu_torch.tools.boosted_trees", *BOOST_SHAPE, *args]
    full_env = dict(os.environ, N_ROUNDS=str(BOOST_ROUNDS), **env)
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=full_env,
                            cwd=Path(__file__).resolve().parent,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=BOOST_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)   # the launcher and its workers
        proc.communicate()
        raise AssertionError(f"boosted_trees {args} at world {n} outlasted "
                             f"{BOOST_TIMEOUT_S} s")
    if proc.returncode != 0:
        raise AssertionError(f"boosted_trees {args} at world {n} failed "
                             f"(rc {proc.returncode}):\n{err[-4000:]}")
    docs = {}
    for line in out.splitlines():
        if line.startswith("BOOST-JSON "):
            doc = json.loads(line[len("BOOST-JSON "):])
            docs[doc["rank"]] = doc
    if sorted(docs) != list(range(n)):
        raise AssertionError(f"boosted_trees {args}: documents of ranks "
                             f"{sorted(docs)} of {n}")
    deaths = [float(t) for t in re.findall(r"died rc=\S+ at ([0-9.]+)",
                                           err)]
    return docs, deaths


def _same_model(docs: dict, want: dict, what: str) -> None:
    for r, d in docs.items():
        if d["trees"] != want["trees"] or d["digest"] != want["digest"]:
            raise AssertionError(f"{what}: rank {r}'s trees differ from the "
                                 f"run without a kill:\n{d['trees']}\n"
                                 f"{want['trees']}")


def phase_robust(dev, power: str) -> None:
    """The robust engine under the port (see the module's phase 11)."""
    import tempfile
    import torch.distributed as dist
    import rabit_tpu_torch as rabit
    from rabit_tpu_torch.engine import _native_build
    t0 = time.perf_counter()
    built = _native_build.build()
    phase("robust", f"native core {_native_build.library_path().name} "
          f"ready in {time.perf_counter() - t0:.2f} s (g++ {built:.2f} s "
          f"in this phase; 0 = built in phase 1)")
    with tempfile.TemporaryDirectory() as tmp:
        clean, _ = _launch_boost(1, ["rabit_engine=mock",
                                     f"rabit_ckpt_dir={tmp}/clean"], {})
        kill, deaths = _launch_boost(
            1, ["rabit_engine=mock", f"rabit_ckpt_dir={tmp}/kill",
                f"mock=0,{BOOST_KILL},0,0"], {})
    c, k = clean[0], kill[0]
    if c["device"] != "cuda:0" or k["device"] != "cuda:0":
        raise AssertionError(f"histograms built on {c['device']}, "
                             f"{k['device']}, not the card")
    if len(deaths) != 1 or k["version"] != BOOST_KILL:
        raise AssertionError(f"the kill: {len(deaths)} deaths, respawn "
                             f"resumed at version {k['version']}, want 1 "
                             f"and {BOOST_KILL}")
    if c["launches"] < BOOST_ROUNDS or \
            k["launches"] < BOOST_ROUNDS - BOOST_KILL:
        raise AssertionError(f"histogram launches {c['launches']} and "
                             f"{k['launches']} for {BOOST_ROUNDS} and "
                             f"{BOOST_ROUNDS - BOOST_KILL} rounds")
    _same_model(kill, c, "world 1, cold restart")
    phase("robust", f"world 1 (mock engine, rabit_ckpt_dir): killed at "
          f"round {BOOST_KILL}, respawned, cold-restarted from the durable "
          f"store at version {k['version']}, {BOOST_ROUNDS} trees equal to "
          f"the run without a kill bit for bit (digest {c['digest']}); "
          f"histogram kernel launches {c['launches']} (clean) and "
          f"{k['launches']} (after the respawn); death to the respawned "
          f"worker's first round {k['first_round_at'] - deaths[0]:.2f} s; "
          f"robust allreduce of the {2048 * 4} B histogram at world 1 "
          f"{float(np.median(c['allreduce_ms'])):.4f} ms a round "
          f"host-paced (local: no peer) [{power}]")
    # the histogram payload through TorchEngine at world 1, and the
    # formation of an NCCL world of 1
    t0 = time.perf_counter()
    rabit.init([], engine="torch")
    form_s = time.perf_counter() - t0
    try:
        hist = np.zeros(2048, np.float32)
        rabit.allreduce(hist, rabit.SUM)
        t0 = time.perf_counter()
        for _ in range(20):
            rabit.allreduce(hist, rabit.SUM)
        te_ms = (time.perf_counter() - t0) * 1e3 / 20
        backend = dist.get_backend()
    finally:
        rabit.finalize()
    phase("robust", f"TorchEngine at world 1 ({backend}): the histogram "
          f"payload {te_ms:.4f} ms a call host-paced (returns at world 1); "
          f"init with its NCCL world of 1 {form_s:.3f} s [{power}]")

    count = torch.cuda.device_count()
    if count < 2:
        phase("robust", "one card: the torch data plane's NCCL world "
              "(rabit_dataplane=torch) needs two or more")
        return
    phase_robust_world(min(4, count), power)


def phase_robust_world(p: int, power: str) -> None:
    """The torch data plane over NCCL at world ``p``, one rank a card."""
    args = ["rabit_engine=robust_torch", "rabit_dataplane_minbytes=0"]
    clean, _ = _launch_boost(p, args, {})
    kill, deaths = _launch_boost(p, args + [f"mock=1,{BOOST_KILL},0,0"], {})
    fail, _ = _launch_boost(p, args, {"RABIT_DATAPLANE_FAIL_AT": "5"})
    ref = clean[0]
    for what, docs in (("clean", clean), ("kill", kill), ("fail", fail)):
        _same_model(docs, ref, f"world {p}, {what}")
        backends = {d["dataplane"]["backend"] for d in docs.values()}
        if backends != {"nccl"}:
            raise AssertionError(f"world {p} {what}: backends {backends}")
    for what, docs in (("kill", kill), ("fail", fail)):
        epochs = {d["epoch"] for d in docs.values()}
        if min(epochs) < 2 or len(epochs) != 1:
            raise AssertionError(f"world {p} {what}: epochs {epochs} "
                                 f"(want one, advanced past 1)")
    if len(deaths) != 1 or min(d["launches"] for d in clean.values()) \
            < BOOST_ROUNDS:
        raise AssertionError(f"world {p}: {len(deaths)} deaths, launches "
                             f"{[d['launches'] for d in clean.values()]}")
    robust_ms = float(np.median([np.median(d["allreduce_ms"])
                                 for d in clean.values()]))
    direct = [d["timing"] for d in clean.values()]
    recover_s = max(d["dataplane"]["first_collective_at"]
                    for d in kill.values()) - deaths[0]
    form_s = max(d["dataplane"]["form_seconds"] for d in clean.values())
    phase("robust", f"world {p} (robust_torch, rabit_dataplane_minbytes=0, "
          f"NCCL, one rank a card): the run without a kill, a kill of rank "
          f"1 at round {BOOST_KILL} and RABIT_DATAPLANE_FAIL_AT=5 end with "
          f"the same trees bit for bit on every rank (digest "
          f"{ref['digest']}); epochs {kill[0]['epoch']} and "
          f"{fail[0]['epoch']}")
    phase("robust", f"world {p}: histogram allreduce ({2048 * 4} B) "
          f"{robust_ms:.4f} ms a round host-paced through the robust "
          f"engine (median of ranks' medians over {BOOST_ROUNDS} rounds); "
          f"20 calls each: robust "
          f"{max(t['robust_ms'] for t in direct):.4f} ms, TorchEngine on "
          f"the same world {max(t['torch_engine_ms'] for t in direct):.4f} "
          f"ms, the same on a group without blocking waits "
          f"{max(t['no_blocking_wait_ms'] for t in direct):.4f} ms a call "
          f"(slowest rank); kill to the first collective of the "
          f"re-formed world {recover_s:.2f} s; NCCL world formed in "
          f"{form_s:.3f} s (slowest rank) [{power}]")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    phase("device", f"{torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    torch.backends.cudnn.allow_tf32 = False
    phase_build()
    phase_tile(dev)
    max_err = {"histogram": phase_kernel(dev),
               "mask_only": phase_mask_kernel(dev)}
    phase_device_ops(dev)
    max_err.update(phase_flash_kernel(dev))

    reset_launches()
    phase_main_path(dev)
    phase_rounds(dev)
    hist_launches = read_launches()
    if hist_launches["histogram"] < 1:
        raise AssertionError("kernel histogram was not launched on the "
                             "histogram path")
    phase("main path", f"kernel launches on the histogram path: "
          f"{hist_launches}")
    tf_run = phase_transformer(dev)
    sweep = phase_sweep(dev)
    launches = {"histogram": hist_launches["histogram"],
                "flash_block": tf_run["launches"]["flash_block"],
                "flash_block_bwd": tf_run["launches"]["flash_block_bwd"],
                "mask_only": sweep["launches"]["mask_only"]}
    phase("main path", f"kernel launches, each on its own path: {launches}")
    phase_bench(dev)
    proof = phase_proof(dev)

    timing = {"histogram": phase_timing(dev, power),
              "mask_only": phase_mask_timing(dev, power, sweep["table"])}
    timing.update(phase_flash_timing(dev, power))
    phase("timing", f"training step (flagship, batch 8 x seq 512): "
          f"{tf_run['step_ms']:.3f} ms median of steps 2-"
          f"{FLAGSHIP_STEPS} on CUDA events [{power}]")
    phase_collectives(dev)
    phase_robust(dev, power)
    kernels = []
    for name in ("histogram", "flash_block", "flash_block_bwd", "mask_only"):
        head = timing[name][0]
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCES[name],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max_err[name], "ms": head["ms"],
            "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "by_shape": timing[name]})
    for k in kernels:
        head = k["by_shape"][0]
        k["shape"] = head.get("shape", [head.get("rows"), head.get("nbins")])
    kernels[3]["slope_ms"] = timing["mask_only"][0]["slope_ms"]
    kernels[2]["library_bwd_ms"] = timing["flash_block_bwd"][0][
        "library_bwd_ms"]
    for k in kernels[1:3]:   # the chain block's row: the proof's chains
        k["by_shape"][1]["launches"] = proof["launches"][k["name"]]
    print(json.dumps({"train_step": {
        "step_ms": tf_run["step_ms"], "first_step_ms": tf_run["first_step_ms"],
        "losses": tf_run["losses"], "profile": tf_run["profile"]}}),
        flush=True)
    print(power, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
