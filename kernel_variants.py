"""Variants of a kernel side by side on one card.

    python3 kernel_variants.py DIR [DIR ...]
        [--kernel {bwd,fwd,hist,mask}] [--sass KERNEL]

With ``--kernel bwd`` (the default) each DIR holds an edited copy of
``rabit_tpu_torch/csrc/flash_block_bwd.cu`` and of the headers it
includes; with ``--kernel fwd`` a copy of ``flash_block.cu`` and its
headers; with ``--kernel hist`` a copy of ``histogram.cu``, with ``--kernel
mask`` of ``mask_only.cu``, each with its headers. The script builds every
variant with the package's nvcc flags (one nvcc each, all at once) into
its DIR and prints ptxas's registers and spills of its kernels (and, with
``--sass``, the opcode counts of one kernel's SASS, atomics and
reductions with their modifiers, e.g. ``--sass 'flash_bwd_rows<32, 1>'``,
``--sass 'histogram_kernel<0>'`` or ``--sass mask_only_kernel``).

Flash kernels: it holds each variant against the plain version at
``chip_smoke.py``'s ``FLASH_CASES`` (backward: the worst gradient's
max|diff| / max|ref|, limit ``FLASH_BWD_REL``; forward: m', l', o' within
``FLASH_FWD_TOL``), then times all of them at the training shape and the
chain block: CUDA-event medians of ``chip_smoke.time_ms``, in the order
A B ... B A, twice, and the device time of each kernel by
``torch.profiler``.

Binning kernels: a variant goes through the package's wrapper
(``ops/histogram.py``) with its library in place of the package's; a
copy of a source from before the cluster design (no ``rabit_<name>_info``
entry point) goes through that design's wrapper instead (a zero-filled
output, or for the bin count a count buffer, then the call). Each is held
against the plain version at ``chip_smoke.py``'s cases (the histogram
within ``KERNEL_TOL`` at its four cases in both precisions, the bin count
bit for bit at its eight), then timed at ``FULL_WIDTH`` (both precisions)
or ``MASK_TIMING``, and at 2^20 x 1024 (``MARGIN``, half the headline's
rows): CUDA-event medians in the order A B ... B A, twice; the
host's time a call (wrapper, ctypes and launch, with the device held busy
by a sleep kernel), in the same order; and by ``torch.profiler`` the
device operations a call and the device time a launch.

To compare a change with the tree, give a copy of the unchanged sources as
one DIR: versions are compared only within one run. Keep the copies
under ``build/``, which git ignores. It needs one card, and exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import math
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as C


def build(dirs, source: str):
    """Builds each DIR's ``source`` into DIR/lib.so; returns the loaded
    libraries and ptxas's output of each."""
    from rabit_tpu_torch.ops import _build
    procs = {d: subprocess.Popen(
        [_build.nvcc(), *_build.NVCC_FLAGS, "-o", str(d / "lib.so"),
         str(d / source)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT) for d in dirs}
    libs, logs = {}, {}
    for d, proc in procs.items():
        out, _ = proc.communicate(timeout=_build.BUILD_TIMEOUT_S)
        logs[d] = out.decode(errors="replace")
        if proc.returncode != 0:
            raise RuntimeError(f"{d}: nvcc exit {proc.returncode}\n"
                               f"{logs[d]}")
        libs[d] = ctypes.CDLL(str(d / "lib.so"))
    return libs, logs


def sass_opcodes(library: Path, kernel: str) -> collections.Counter:
    """Opcode (without modifiers) -> count in one kernel's SASS."""
    from rabit_tpu_torch.ops import _build
    tool = shutil.which("cuobjdump") or str(
        Path(_build.nvcc()).parent / "cuobjdump")
    sass = subprocess.run([tool, "-sass", str(library)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, current = collections.Counter(), None
    for line in sass.splitlines():
        fn = re.search(r"Function : (\S+)", line)
        if fn:
            current = C.demangled(fn.group(1))
            continue
        op = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]+)",
                       line)
        if current == kernel and op:
            name = op.group(1)   # atomics and reductions keep their kind
            counts[name if name.startswith(("ATOM", "RED"))
                   else name.split(".")[0]] += 1
    return counts


def backward(lib, q, k, v, m, l, o, mask, scale, cm, cl, co):
    """One call of the variant's rabit_flash_block_bwd_f32, on the current
    stream; returns (dq, dk, dv, dm, dl, do)."""
    fn = lib.rabit_flash_block_bwd_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 10 + [i, i, i, i, ctypes.c_float] + [p] * 8
    h, t, d = q.shape
    outs = [torch.empty_like(x) for x in (q, k, v, m, l, o)]
    scratch = torch.empty((3, h, t), device=q.device)
    err = fn(*(x.data_ptr() for x in (q, k, v, m, l, o)),
             None if mask is None else mask.data_ptr(), cm.data_ptr(),
             cl.data_ptr(), co.data_ptr(), h, t, k.shape[1], d, scale,
             *(x.data_ptr() for x in outs), scratch.data_ptr(),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cuda error {err}")
    return outs


def forward(lib, q, k, v, m, l, o, mask, scale, *_):
    """One call of the variant's rabit_flash_block_f32, on the current
    stream; returns (m', l', o'). Cotangents, if given, are ignored."""
    fn = lib.rabit_flash_block_f32
    p, i = ctypes.c_void_p, ctypes.c_int
    fn.argtypes = [p] * 7 + [i, i, i, i, ctypes.c_float] + [p] * 4
    h, t, d = q.shape
    outs = [torch.empty_like(x) for x in (m, l, o)]
    err = fn(*(x.data_ptr() for x in (q, k, v, m, l, o)),
             None if mask is None else mask.data_ptr(), h, t, k.shape[1], d,
             scale, *(x.data_ptr() for x in outs),
             torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"launch failed: cuda error {err}")
    return outs


def check_bwd(label, name, got, want) -> bool:
    rel = max(float((g - w).abs().max() / w.abs().max().clamp_min(1e-30))
              for g, w in zip(got, want))
    ok = rel <= C.FLASH_BWD_REL
    print(f"check {label}: {name} worst gradient {rel:.2g}"
          f"{'' if ok else ' FAILED'}")
    return ok


def check_fwd(label, name, got, want) -> bool:
    try:
        err = max(C.assert_close(g.cpu(), w.cpu(), f"{label} {name}",
                                 **C.FLASH_FWD_TOL)
                  for g, w in zip(got, want))
    except AssertionError as e:
        print(f"check {label}: {name} FAILED: {e}")
        return False
    print(f"check {label}: {name} max|diff| of m', l', o' {err:.2g} (rtol "
          f"= atol = {C.FLASH_FWD_TOL['rtol']})")
    return True


# half the rows of the headline shape (2^21 x 1024): the two give the
# cost of the rows at the margin, apart from what does not grow with them
MARGIN = (1 << 20, 1024)


def bins_caller(lib, kernel: str):
    """f(bins, [grad, hess,] nbins[, precision]) -> output of one call of
    the variant. A library with ``rabit_<name>_info`` goes through the
    package's wrapper with the library in its place; an older one through
    the wrapper of its own design (zero fill, or a count buffer, then the
    call), as that design's ``ops/histogram.py`` made it."""
    from rabit_tpu_torch.ops import _build
    from rabit_tpu_torch.ops import histogram as K
    name = {"hist": "histogram", "mask": "mask_only"}[kernel]
    p, i, n = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.rabit_cuda_error_string.argtypes = [i]
    lib.rabit_cuda_error_string.restype = ctypes.c_char_p
    if hasattr(lib, f"rabit_{name}_info"):
        wrapper = getattr(K, name)

        def call(*a):
            _build._loaded[name] = lib
            return wrapper(*a)
        return call
    if kernel == "hist":
        fn = lib.rabit_histogram_f32
        fn.argtypes, fn.restype = [p, p, p, n, i, i, p, p], ctypes.c_int

        def call(b, g, h, nbins, precision="high"):
            K._check(b, g, h, nbins, precision)
            with torch.cuda.device(b.device):
                out = torch.zeros((nbins, 2), device=b.device)
                err = fn(b.data_ptr(), g.data_ptr(), h.data_ptr(), b.numel(),
                         nbins, int(precision == "fast"), out.data_ptr(),
                         torch.cuda.current_stream(b.device).cuda_stream)
            if err != 0:
                raise RuntimeError(f"launch failed: cuda error {err}")
            return out
        return call
    fn = lib.rabit_mask_only_f32
    fn.argtypes, fn.restype = [p, n, i, p, p, p], ctypes.c_int

    def call(b, nbins):
        K._check_bins(b, nbins)
        with torch.cuda.device(b.device):
            counts = torch.empty(nbins, dtype=torch.int32, device=b.device)
            out = torch.empty(nbins, device=b.device)
            err = fn(b.data_ptr(), b.numel(), nbins, counts.data_ptr(),
                     out.data_ptr(),
                     torch.cuda.current_stream(b.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"launch failed: cuda error {err}")
        return out
    return call


def host_us(fn, args_sets, calls: int = 200) -> float:
    """The host's time of one call (wrapper, ctypes, launch) in µs: calls
    enqueued behind a sleep kernel that keeps the device busy throughout,
    on the host clock."""
    for a in args_sets[:2]:
        fn(*a)
    torch.cuda.synchronize()
    torch.cuda._sleep(100_000_000)
    t0 = time.perf_counter()
    for j in range(calls):
        fn(*args_sets[j % len(args_sets)])
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / calls * 1e6


def device_ops(fn, args_sets, calls: int = 10):
    """(device operations a call, device µs a kernel launch) by
    torch.profiler over ``calls`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn(*args_sets[0])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for j in range(calls):
            fn(*args_sets[j % len(args_sets)])
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    ops = sum(e.count for e in events) / calls
    kernels = {re.sub(r"^void |\(anonymous namespace\)::|\(.*$", "",
                      e.key): round(e.self_device_time_total / e.count, 2)
               for e in events}
    return ops, kernels


def run_bins(args) -> int:
    """--kernel hist / mask: check, then time, every variant."""
    from rabit_tpu_torch.ops import _build
    from rabit_tpu_torch.ops import histogram as K
    dev = torch.device("cuda", 0)
    name = {"hist": "histogram", "mask": "mask_only"}[args.kernel]
    libs, logs = build(args.dirs, f"{name}.cu")
    calls = {d: bins_caller(lib, args.kernel) for d, lib in libs.items()}
    for d, lib in libs.items():
        if hasattr(lib, f"rabit_{name}_info"):   # the plan at each width
            _build._loaded[name] = lib
            for nbins in (1024, 7168, 16_640, 120_000):
                shape = K._shape(name, dev, nbins)
                print(f"{d} plan at 2^21 rows x {nbins} bins: {shape}, "
                      f"{K.plan(1 << 21, nbins, True, shape)}")
    for d in libs:
        print(f"{d} ptxas: " + "; ".join(C.ptxas_summary(logs[d])))
        if args.sass:
            ops = sass_opcodes(d / "lib.so", args.sass)
            print(f"{d} {args.sass} SASS: {sum(ops.values())} instructions, "
                  f"{dict(ops.most_common(24))}; atomics and reductions "
                  f"{ {k: v for k, v in ops.items() if k.startswith(('ATOM', 'RED'))} }")
    ok = True
    if args.kernel == "hist":
        cases = [(n, nb, False) for n, nb in C.FULL_WIDTH + [C.WIDE]]
        cases.append((1_000_003, 1024, True))
        for j, (n, nbins, edge) in enumerate(cases):
            b, g, h = C._hist_case(n, nbins, 10 + j, dev, edge)
            for precision in ("high", "fast"):
                want = K.histogram_reference(b, g, h, nbins, precision).cpu()
                for d, call in calls.items():
                    try:
                        err = C.assert_close(
                            call(b, g, h, nbins, precision).cpu(), want,
                            f"{d}", **C.KERNEL_TOL)
                        print(f"check {n}x{nbins}{' edge' if edge else ''} "
                              f"{precision}: {d} max|diff| {err:.3g}")
                    except AssertionError as e:
                        print(f"check {n}x{nbins} {precision}: {d} FAILED: "
                              f"{e}")
                        ok = False
        timed = [(n, nb, prec) for n, nb in C.FULL_WIDTH + [MARGIN]
                 for prec in ("high", "fast")]
    else:
        cases = [(n, nb, False) for n, nb in C.SWEEP_GRID]
        cases += [(n, nb, True) for n, nb in C.MASK_EDGES]
        for j, (n, nbins, edge) in enumerate(cases):
            b = C._ids_case(n, nbins, 40 + j, dev, edge)
            want = K.mask_only_reference(b, nbins)
            for d, call in calls.items():
                same = torch.equal(call(b, nbins), want)
                ok = ok and same
                print(f"check {n}x{nbins}{' edge' if edge else ''}: {d} "
                      f"{'bit for bit' if same else 'FAILED: counts differ'}")
        timed = [(n, nb, None) for n, nb in C.MASK_TIMING + [MARGIN]]
    for n, nbins, precision in timed:
        if args.kernel == "hist":
            b, g, h = C._hist_case(n, nbins, 3, dev)
            sets = [(b.clone(), g.clone(), h.clone())
                    for _ in range(max(4, math.ceil(150e6 / (12 * n))))]
            fns = {d: (lambda *a, c=c: c(*a, nbins, precision))
                   for d, c in calls.items()}
        else:
            b = C._ids_case(n, nbins, 5, dev)
            sets = [(b.clone(),) for _ in range(math.ceil(150e6 / (4 * n)))]
            fns = {d: (lambda *a, c=c: c(*a, nbins))
                   for d, c in calls.items()}
        order = (list(fns) + list(fns)[::-1]) * 2
        ms, us = {d: [] for d in fns}, {d: [] for d in fns}
        for d in order:
            ms[d].append(C.time_ms(fns[d], sets))
        for d in order:
            us[d].append(host_us(fns[d], sets))
        label = f"rows {n} nbins {nbins}" + (f" {precision}" if precision
                                              else "")
        for d, fn in fns.items():
            ops, kernels = device_ops(fn, sets)
            print(f"time {label} {d}: ms {[round(x, 4) for x in ms[d]]}, "
                  f"median {np.median(ms[d]):.4f}; host us a call "
                  f"{[round(x, 1) for x in us[d]]}, median "
                  f"{np.median(us[d]):.1f}; device ops a call {ops:g}, us a "
                  f"launch {kernels}")
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--kernel", choices=("bwd", "fwd", "hist", "mask"),
                    default="bwd")
    ap.add_argument("--sass", help="a kernel, as 'flash_bwd_rows<32, 1>'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
    if args.kernel in ("hist", "mask"):
        ok = run_bins(args)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True,
                             text=True, check=True, timeout=60).stdout.strip())
        return ok
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from rabit_tpu_torch.ops import flash as F
    dev = torch.device("cuda", 0)
    source, prefix, call, reference, check = {
        "bwd": ("flash_block_bwd.cu", "flash_bwd", backward,
                F.block_update_bwd_reference, check_bwd),
        "fwd": ("flash_block.cu", "flash_fwd", forward,
                lambda *a: F.block_update_reference(*a[:8]),
                check_fwd)}[args.kernel]
    libs, logs = build(args.dirs, source)
    for d in libs:
        print(f"{d} ptxas: " + "; ".join(
            s for s in C.ptxas_summary(logs[d]) if s.startswith(prefix)))
        if args.sass:
            ops = sass_opcodes(d / "lib.so", args.sass)
            print(f"{d} {args.sass} SASS: {sum(ops.values())} instructions, "
                  f"{dict(ops.most_common(16))}")
    ok = True
    for label, (bh, t, s, d), mask_kind, first, spread in C.FLASH_CASES:
        ins, cts = C.flash_case(bh, t, s, d, mask_kind, 7, dev, first, spread)
        args_ = (*ins, d ** -0.5, *cts)
        want = reference(*args_)
        for name, lib in libs.items():
            ok = check(label, name, call(lib, *args_), want) and ok
    for bh, t, s, d, causal in (C.FLASH_MAIN, C.FLASH_CHAIN):
        ins, cts = C.flash_case(bh, t, s, d, "causal" if causal else None, 3,
                                dev, first_step=True)
        per_set = sum(x.numel() * 4 for x in (*ins[:6], *cts))
        sets = [tuple(None if x is None else x.clone() for x in (*ins, *cts))
                for _ in range(max(2, int(150e6 / per_set) + 1))]
        sm = d ** -0.5
        ms = {name: [] for name in libs}
        for name in (list(libs) + list(libs)[::-1]) * 2:
            ms[name].append(C.time_ms(lambda *a, lib=libs[name]: call(
                lib, *a[:7], sm, *a[7:]), sets))
        for name, lib in libs.items():
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for j in range(10):
                    a = sets[j % len(sets)]
                    call(lib, *a[:7], sm, *a[7:])
                torch.cuda.synchronize()
            by_kernel = {e.key.split("<")[0].split("::")[-1]:
                         round(e.self_device_time_total / e.count, 1)
                         for e in prof.key_averages()
                         if e.device_type == DeviceType.CUDA
                         and prefix in e.key}
            print(f"time B*H {bh} T {t} D {d} "
                  f"{'causal' if causal else 'no mask'} {name}: ms "
                  f"{[round(x, 4) for x in ms[name]]}, median "
                  f"{np.median(ms[name]):.4f}; us a launch {by_kernel}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
