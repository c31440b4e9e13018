"""Variants of a kernel side by side on one card.

    python3 kernel_variants.py DIR [DIR ...]
        [--kernel {bwd,bwd_bf16,fwd,fwd_bf16,hist,mask}] [--sass KERNEL]

With ``--kernel bwd`` (the default) each DIR holds an edited copy of
``rabit_tpu_torch/csrc/flash_block_bwd.cu`` and of the headers it
includes, whose f32 entry ``rabit_flash_block_bwd_f32`` is called; with
``--kernel bwd_bf16`` the same copy, through its bf16 entry
``rabit_flash_block_bwd_bf16``; with ``--kernel fwd`` a copy of
``flash_block.cu`` and its headers, whose f32 entry
``rabit_flash_block_f32`` is called; with ``--kernel fwd_bf16`` the same
copy, through its bf16 entry ``rabit_flash_block_bf16``; with ``--kernel
hist`` a copy of ``histogram.cu``, with ``--kernel mask`` of
``mask_only.cu``, each with its headers. The script builds every
variant with the package's nvcc flags (one nvcc each, all at once) into
its DIR and prints ptxas's registers and spills of its kernels (and, with
``--sass``, the opcode counts of one kernel's SASS, atomics and
reductions and tensor-core products with their modifiers, e.g. ``--sass
'flash_bwd_rows<32, 1>'``, ``--sass 'flash_bwd_bf16_cols<32, 1>'``,
``--sass 'histogram_kernel<0>'`` or ``--sass mask_only_kernel``, and the
whole SASS of the variant's library in ``DIR/lib.sass``). The forward's
copies also print the blocks an SM of each bf16 kernel, from
``rabit_flash_block_bf16_occupancy`` where the copy exports it.

Flash kernels: it holds each variant against the plain version at
``chip_smoke.py``'s ``FLASH_CASES`` (backward: the worst gradient's
max|diff| / max|ref|, limit ``FLASH_BWD_REL``; forward: m', l', o' within
``FLASH_FWD_TOL``), then times all of them at the training shape and the
chain block: CUDA-event medians of ``chip_smoke.time_ms``, in the order
A B ... B A, twice, and the device time of each kernel by
``torch.profiler``. The bf16 backward is held against the plain bf16
backward at ``chip_smoke.py``'s ``BF16_CASES`` and tolerances (dq, dk, dv
within ``BF16_GRAD_REL`` of their largest plus a bf16 step, dm, dl, do
within ``BF16_GRAD_REL``) and timed on bf16 q/k/v (``bf16_case``) at the
same two shapes. The bf16 forward is held against the plain step at
``BF16_CASES`` with phase 23 (a)'s limits (m' and l' within
``FLASH_FWD_TOL``, o' within ``BF16_O_REL`` of max|o'|); beside that each
variant's m' is compared with the first DIR's at every case (the value,
as ``torch.equal``: the score tile's bits decide it), and the variants
are timed on bf16 q/k/v at the same two shapes against
``flash_bf16_bound``.

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
    """Opcode (without modifiers, but for atomics, reductions and
    tensor-core products) -> count in one kernel's SASS. Writes the
    library's whole SASS beside it (``lib.sass``), to read by hand."""
    library.with_suffix(".sass").write_text(C.sass_listing(library))
    counts = collections.Counter()
    for name, n in C.sass_ops(library).get(kernel, {}).items():
        counts[name if name.startswith(("ATOM", "RED", "HMMA"))
               else name.split(".")[0]] += n
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


def backward_bf16(lib, q, k, v, m, l, o, mask, scale, cm, cl, co):
    """One call of the variant's rabit_flash_block_bwd_bf16 (bf16 q/k/v),
    on the current stream; returns (dq, dk, dv) in bf16, (dm, dl, do) in
    f32."""
    fn = lib.rabit_flash_block_bwd_bf16
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


def forward_bf16(lib, q, k, v, m, l, o, mask, scale, *_):
    """One call of the variant's rabit_flash_block_bf16 (bf16 q/k/v), on
    the current stream; returns (m', l', o') in f32."""
    fn = lib.rabit_flash_block_bf16
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


def check_bwd_bf16(label, name, got, want) -> bool:
    torch.cuda.synchronize()
    try:
        _, rels = C.bf16_grads_check(got, want, f"{label} {name}")
    except AssertionError as e:
        print(f"check {label}: {name} FAILED: {e}")
        return False
    print(f"check {label}: {name} max|diff|/max|ref| " + ", ".join(
        f"{n} {r:.2g}" for n, r in rels.items()) + f" (limit "
        f"{C.BF16_GRAD_REL}, dq dk dv plus a bf16 step)")
    return True


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


def check_fwd_bf16(label, name, got, want) -> bool:
    torch.cuda.synchronize()
    try:
        errs, rel = C.bf16_fwd_check(got, want, f"{label} {name}")
    except AssertionError as e:
        print(f"check {label}: {name} FAILED: {e}")
        return False
    print(f"check {label}: {name} max|diff| " + ", ".join(
        f"{n} {x:.3g}" for n, x in errs.items()) + f"; o' {rel:.3g} of "
        f"max|o'| (limit {C.BF16_O_REL:.3g})")
    return True


def blocks_an_sm(lib) -> str:
    """The bf16 forward kernels' blocks an SM at each D bucket, masked /
    unmasked, where the copy exports rabit_flash_block_bf16_occupancy."""
    if not hasattr(lib, "rabit_flash_block_bf16_occupancy"):
        return "not exported"
    fn = lib.rabit_flash_block_bf16_occupancy
    fn.argtypes = [ctypes.c_int] * 2
    return ", ".join(f"D {d}: {fn(d, 1)} / {fn(d, 0)}"
                     for d in (16, 32, 64, 128))


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
    ap.add_argument("--kernel",
                    choices=("bwd", "bwd_bf16", "fwd", "fwd_bf16", "hist",
                             "mask"),
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
    from rabit_tpu_torch.ops import flash as F
    dev = torch.device("cuda", 0)
    source, prefix, call, reference, check = {
        "bwd": ("flash_block_bwd.cu", "flash_bwd", backward,
                F.block_update_bwd_reference, check_bwd),
        "bwd_bf16": ("flash_block_bwd.cu", "flash_bwd_bf16", backward_bf16,
                     F.block_update_bwd_reference, check_bwd_bf16),
        "fwd": ("flash_block.cu", "flash_fwd", forward,
                lambda *a: F.block_update_reference(*a[:8]),
                check_fwd),
        "fwd_bf16": ("flash_block.cu", "flash_fwd_bf16", forward_bf16,
                     lambda *a: F.block_update_reference(*a[:8]),
                     check_fwd_bf16)}[args.kernel]
    bf16 = args.kernel in ("bwd_bf16", "fwd_bf16")
    # (label, shape, mask, first step, wide range) as FLASH_CASES
    cases = [(*c, False) for c in C.BF16_CASES] if bf16 else C.FLASH_CASES

    def make(bh, t, s, d, kind, seed, first, spread=False):
        if bf16:
            return C.bf16_case(bh, t, s, d, kind, seed, dev, first)
        return C.flash_case(bh, t, s, d, kind, seed, dev, first, spread)
    libs, logs = build(args.dirs, source)
    for d in libs:
        print(f"{d} ptxas: " + "; ".join(
            s for s in C.ptxas_summary(logs[d]) if s.startswith("flash_")))
        print(f"{d} HMMA: " + ", ".join(
            f"{k} {n}" for k, n in sorted(C.sass_counts(
                d / "lib.so", "HMMA").items()) if k.startswith("flash_")))
        if args.sass:
            ops = sass_opcodes(d / "lib.so", args.sass)
            print(f"{d} {args.sass} SASS: {sum(ops.values())} instructions, "
                  f"{dict(ops.most_common(16))}")
        if args.kernel == "fwd_bf16":
            print(f"{d} blocks an SM (masked / unmasked): "
                  f"{blocks_an_sm(libs[d])}")
    ok = True
    for label, (bh, t, s, d), mask_kind, first, spread in cases:
        ins, cts = make(bh, t, s, d, mask_kind, 7, first, spread)
        args_ = (*ins, d ** -0.5, *cts)
        want = reference(*args_)
        m_first = None
        for name, lib in libs.items():
            try:
                got = call(lib, *args_)
            except RuntimeError as e:  # e.g. more shared memory than it has
                print(f"check {label}: {name} FAILED: {e}")
                ok = False
                continue
            ok = check(label, name, got, want) and ok
            if args.kernel == "fwd_bf16":
                if m_first is None:
                    m_first = got[0]
                    continue
                same = torch.equal(got[0], m_first)
                ok = ok and same
                print(f"check {label}: {name} m' "
                      f"{'equals' if same else 'DIFFERS from'} "
                      f"{next(iter(libs))}'s at every row")
    for bh, t, s, d, causal in (C.FLASH_MAIN, C.FLASH_CHAIN):
        ins, cts = make(bh, t, s, d, "causal" if causal else None, 3, True)
        per_set = sum(x.numel() * x.element_size() for x in (*ins[:6], *cts))
        sets = [tuple(None if x is None else x.clone() for x in (*ins, *cts))
                for _ in range(max(2, int(150e6 / per_set) + 1))]
        sm = d ** -0.5
        runs = {}   # the variants that launch at this shape
        for name, lib in libs.items():
            try:
                call(lib, *sets[0][:7], sm, *sets[0][7:])
                runs[name] = lib
            except RuntimeError as e:
                print(f"time B*H {bh} T {t} D {d}: {name} does not run: {e}")
        ms = {name: [] for name in runs}
        for name in (list(runs) + list(runs)[::-1]) * 2:
            ms[name].append(C.time_ms(lambda *a, lib=runs[name]: call(
                lib, *a[:7], sm, *a[7:]), sets))
        if bf16:
            bound, bound_by = C.flash_bf16_bound(
                bh, t, s, d, ins[6], args.kernel == "bwd_bf16")[:2]
        else:
            bound, bound_by = C.flash_bound(bh, t, s, d, ins[6],
                                            args.kernel == "bwd")[:2]
        for name, lib in runs.items():
            by_kernel = C.kernel_us(lambda *a, lib=lib: call(
                lib, *a[:7], sm, *a[7:]), sets, prefix)
            med = float(np.median(ms[name]))
            print(f"time B*H {bh} T {t} D {d} "
                  f"{'causal' if causal else 'no mask'} {name}: ms "
                  f"{[round(x, 4) for x in ms[name]]}, median {med:.4f} "
                  f"(bound {bound:.4f} ms, {bound_by}: {bound / med:.1%}); "
                  f"us a launch {by_kernel}")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip())
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
