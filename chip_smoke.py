"""Chip smoke test of rabit_tpu_torch: builds the CUDA kernels and drives the
port's main path -- the gradient-histogram allreduce -- on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each prints a line; any failure exits non-zero):

1. build      nvcc every ``rabit_tpu_torch/csrc/*.cu`` into
              ``build/rabit_tpu_torch/`` (all sources at once).
2. kernel     each kernel against its plain PyTorch version on the card, at
              the main path's shapes and an edge case of padding ids,
              negative ids, a ragged row count and unaligned pointers.
3. main path  ``distributed_histogram`` through a world-1 NCCL group at the
              two full-width shapes, against the f64 host histogram.
4. rounds     ``init(engine="torch")`` on the card, then three boosting
              rounds at each boosted-round shape (g/h, histogram, allreduce,
              split, margin update, checkpoint), each histogram against numpy
              ``bincount`` in f64; ``load_checkpoint`` ends at version 3.
5. timing     CUDA-event medians of the kernel, its plain version and the
              PyTorch library call that computes the same function, beside
              the least time the card could take (bytes over 3.35 TB/s).
6. kernels    one JSON line of every kernel with its main-path launches.

Launch counters are set to 0 just before phase 3 and read just after
phase 4, so the counts are the main path's alone. The last line is the
device JSON. Without CUDA, or without the package beside this file, the
script exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12    # H100 SXM, NVIDIA's data sheet
F32_OPS_PER_S = 67e12        # f32 outside the tensor cores, same source
REPLACES = {"histogram": "rabit_tpu/ops/pallas_kernels.py:133"}
SOURCES = {"histogram": "rabit_tpu_torch/csrc/histogram.cu"}

# (rows, nbins): bench.py's headline, and the HIGGS gpu_hist contribution
# count (131,072 rows x 28 features) over 28 x 256 bins
FULL_WIDTH = [(1 << 21, 1024), (3_670_016, 7168)]
# the JAX tests' widest histogram, one bin tile of 133,120 B of shared memory
WIDE = (100_000, 16_640)
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
    from rabit_tpu_torch.ops import _build
    t0 = time.perf_counter()
    built = _build.build()
    phase("build", f"{sorted(_build.sources())} ready in "
          f"{time.perf_counter() - t0:.2f} s (per kernel, s: "
          f"{ {k: round(v, 2) for k, v in built.items()} })")


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "test needs an NVIDIA GPU", file=sys.stderr)
        return 1
    from rabit_tpu_torch.ops import histogram as K

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    phase("device", f"{torch.cuda.get_device_name(0)} x "
          f"{torch.cuda.device_count()}, torch {torch.__version__}, cuda "
          f"{torch.version.cuda}")

    phase_build()
    max_err = phase_kernel(dev)

    K.histogram.launches = 0
    phase_main_path(dev)
    phase_rounds(dev)
    launches = {"histogram": K.histogram.launches}
    for name, count in launches.items():
        if count < 1:
            raise AssertionError(f"kernel {name} was not launched on the "
                                 f"main path")
    phase("main path", f"kernel launches on the main path: {launches}")

    timing = phase_timing(dev, power)
    head = timing[0]
    kernels = [{
        "name": "histogram", "route": "cuda", "source": SOURCES["histogram"],
        "replaces": REPLACES["histogram"], "launches": launches["histogram"],
        "max_abs_err": max_err, "ms": head["ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"],
        "shape": [head["rows"], head["nbins"]], "by_shape": timing}]
    print(power, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
