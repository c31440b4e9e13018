"""Variants of a flash kernel side by side on one card.

    python3 kernel_variants.py DIR [DIR ...] [--kernel {bwd,fwd}]
                               [--sass KERNEL]

With ``--kernel bwd`` (the default) each DIR holds an edited copy of
``rabit_tpu_torch/csrc/flash_block_bwd.cu`` and of the headers it
includes; with ``--kernel fwd`` a copy of ``flash_block.cu`` and its
headers. The script builds every variant with the package's nvcc flags
(one nvcc each, all at once) into its DIR and prints ptxas's registers
and spills of its ``flash_bwd_*`` (or ``flash_fwd_*``) kernels (and, with
``--sass``, the opcode counts of one kernel's SASS, e.g. ``--sass
'flash_bwd_rows<32, 1>'`` or ``--sass 'flash_fwd_kernel<32, 1>'``). It
holds each variant against the plain version at ``chip_smoke.py``'s
``FLASH_CASES`` (backward: the worst gradient's max|diff| / max|ref|,
limit ``FLASH_BWD_REL``; forward: m', l', o' within ``FLASH_FWD_TOL``),
then times all of them at the training shape and the chain block:
CUDA-event medians of ``chip_smoke.time_ms``, in the order A B ... B A,
twice, and the device time of each kernel by ``torch.profiler``. To
compare a change with the tree, give a copy of the unchanged sources as
one DIR: versions are compared only within one run. Keep the copies
under ``build/``, which git ignores. It needs one card, and exits
non-zero without one.
"""

from __future__ import annotations

import argparse
import collections
import ctypes
import re
import shutil
import subprocess
import sys
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
            counts[op.group(1).split(".")[0]] += 1
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("dirs", nargs="+", type=Path)
    ap.add_argument("--kernel", choices=("bwd", "fwd"), default="bwd")
    ap.add_argument("--sass", help="a kernel, as 'flash_bwd_rows<32, 1>'")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_variants: no CUDA device", file=sys.stderr)
        return 1
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
