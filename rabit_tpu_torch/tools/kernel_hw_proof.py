"""Every kernel of the port against its plain version on the card, with
evidence written after each stage: the port of ``tools/kernel_hw_proof.py``.

    python -m rabit_tpu_torch.tools.kernel_hw_proof [--device cpu] [--smoke]
        [--out DIR]

Stages, with the JAX tool's sizes and tolerances (smoke: smaller sizes,
noisy slopes allowed, no artifact):

1. the histogram kernel, ``high`` and ``fast``, at 2^20 rows x 1024 and
   16,640 bins, against the f64 host histogram (rtol 2e-2; atol 2e-3 for
   ``high``, 8 * 2^-9 * sqrt(rows / bins) for ``fast``);
2. ``FlashBlock`` forward and backward at (H 8, T 256, D 128), causal, on
   the loss sum((o / l)^2), against the plain block update under autograd:
   the loss within rtol 1e-4, each gradient within max|diff| / max|ref|
   1e-3;
3. the ring-attention inner loop on one card: a chain of 8 block steps of
   1024 keys at D 128 (a sequence of 8192 keys), through the kernels and
   through the plain block update, forward and then forward + backward,
   each chain within 1e-3 of the plain one, and their times as slopes
   between K = 8 and 64 chains (``utils/slope.py``, CUDA events on the
   card). The plain version fills the JAX tool's "xla" column; PyTorch's
   ``scaled_dot_product_attention`` over the whole 8192-key sequence (the
   same function) is the library column, a yardstick the port never
   calls.

A full run writes ``KERNEL_HW_TORCH_<ts>.json`` into ``--out`` (by default
``build/artifacts/``) after every stage; a smoke run ends with ``smoke ok``.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as TF

from ..models import histogram as H
from ..ops import flash as F
from ..utils.slope import slope_time
from . import ARTIFACTS, card, device_from_arg, timestamp, write_json

NBINS = (1024, 16640)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.detach().double().cpu(), want.detach().double().cpu()
    return float((got - want).abs().max() / (want.abs().max() + 1e-9))


def prove(device: torch.device, smoke: bool = False,
          flush: Callable[[dict], None] = lambda evidence: None) -> dict:
    """Runs every stage on ``device``; ``flush(evidence)`` after each.
    Raises at the first stage that is wrong."""
    cuda = device.type == "cuda"
    evidence = {"device": card(device), "torch": torch.__version__,
                "complete": False}

    # --- histogram kernel: both precisions, two widths ---------------------
    method = "cuda" if cuda else "auto"
    n = 1 << 17 if smoke else 1 << 20
    for nbins in NBINS:
        grad, hess, bins = H.make_inputs(n, nbins, p=1, seed=3)
        g, h, b = grad[0], hess[0], bins[0]
        tg, th, tb = (torch.from_numpy(a).to(device) for a in (g, h, b))
        for precision in ("high", "fast"):
            t0 = time.perf_counter()
            out = H.local_histogram(tg, th, tb, nbins, method=method,
                                    precision=precision).cpu().numpy()
            dt = time.perf_counter() - t0
            want = H.host_histogram(g, h, b, nbins)
            atol = (2e-3 if precision == "high"
                    else 8 * 2.0 ** -9 * float(np.sqrt(n / nbins)))
            ok = bool(np.allclose(out, want, rtol=2e-2, atol=atol))
            err = float(np.abs(out - want).max())
            key = (f"histogram_{precision}" if nbins == 1024
                   else f"histogram_{precision}_nbins{nbins}")
            evidence[key] = {"rows": n, "nbins": nbins,
                             "build+run_s": round(dt, 3),
                             "max_abs_err": err, "correct": ok}
            flush(evidence)
            print(f"histogram[{precision}, nbins={nbins}]: correct={ok} "
                  f"max_err={err:.5f}", flush=True)
            if not ok:
                raise AssertionError(f"histogram {precision}/{nbins} wrong "
                                     f"on {device}")

    # --- flash block: forward + backward (autograd Function) --------------
    rng = np.random.default_rng(0)
    Hh, T, D = (2, 64, 32) if smoke else (8, 256, 128)

    def normal(*shape):
        return torch.from_numpy(
            rng.standard_normal(shape).astype(np.float32)).to(device)

    q, k, v = normal(Hh, T, D), normal(Hh, T, D), normal(Hh, T, D)
    m0 = torch.full((Hh, T), F.NEG_INF, device=device)
    l0 = torch.zeros((Hh, T), device=device)
    o0 = torch.zeros((Hh, T, D), device=device)
    mask = torch.ones(T, T, dtype=torch.bool, device=device).triu(1)
    sm = 1.0 / float(np.sqrt(D))

    def loss_and_grads(step):
        qkv = [x.clone().requires_grad_() for x in (q, k, v)]
        _, l, o = step(*qkv, m0, l0, o0, mask, sm)
        loss = ((o / l[..., None]) ** 2).sum()
        return float(loss.detach()), torch.autograd.grad(loss, qkv)

    t0 = time.perf_counter()
    fk, gk = loss_and_grads(F.block_update)
    dt = time.perf_counter() - t0
    fp, gp = loss_and_grads(F.block_update_reference)
    fwd_ok = bool(np.isclose(fk, fp, rtol=1e-4))
    grad_err = max(_rel(a, b) for a, b in zip(gk, gp))
    bwd_ok = grad_err < 1e-3
    evidence["flash_block"] = {
        "shape": [Hh, T, D], "causal_mask": True, "build+run_s": round(dt, 3),
        "forward_matches_plain": fwd_ok,
        "grad_max_rel_err_vs_plain": grad_err,
        "backward_matches_plain": bwd_ok}
    flush(evidence)
    print(f"flash_block: fwd={fwd_ok} bwd={bwd_ok} "
          f"grad_rel_err={grad_err:.2e}", flush=True)
    if not (fwd_ok and bwd_ok):
        raise AssertionError(f"flash_block wrong on {device}")

    # --- the chain: kernels vs plain block update vs SDPA ------------------
    NBLK, T_BLK = (3, 64) if smoke else (8, 1024)   # a sequence of 8192
    q8 = normal(Hh, T_BLK, D)
    kcat, vcat = normal(NBLK, Hh, T_BLK, D), normal(NBLK, Hh, T_BLK, D)

    def chain(step, salt, qq, kc, vc):
        m = torch.full((Hh, T_BLK), F.NEG_INF, device=device) + salt * 1e-30
        l = torch.zeros((Hh, T_BLK), device=device)
        o = torch.zeros((Hh, T_BLK, D), device=device)
        for s in range(NBLK):
            m, l, o = step(qq, kc[s], vc[s], m, l, o, None, sm)
        return o / l[..., None]

    def sdpa(salt, qq, kc, vc):
        # the same function in one call: every query over all NBLK blocks
        kk, vv = (x.transpose(0, 1).reshape(Hh, NBLK * T_BLK, D)
                  for x in (kc, vc))
        return TF.scaled_dot_product_attention(qq + salt * 1e-30, kk, vv,
                                               scale=sm)

    steps = {"kernel": lambda s, a, b, c: chain(F.block_update, s, a, b, c),
             "plain": lambda s, a, b, c: chain(F.block_update_reference, s,
                                               a, b, c),
             "sdpa": sdpa}
    k1, k2 = (2, 8) if smoke else (8, 64)

    def slope(fn) -> float:
        return slope_time(fn, k1, k2, allow_noisy=smoke, cuda_events=cuda)

    def run_fwd(which, salt, k):
        acc = torch.zeros((), device=device)
        with torch.no_grad():
            for i in range(k):
                acc = acc + steps[which](salt + i, q8, kcat, vcat).sum()
        return acc

    # parity first: a noisy slope must not cost the parity evidence
    with torch.no_grad():
        outs = {w: steps[w](0, q8, kcat, vcat) for w in steps}
    chain_rel = _rel(outs["kernel"], outs["plain"])
    sdpa_rel = _rel(outs["sdpa"], outs["plain"])
    fwd = {"chain_max_rel_err": chain_rel, "sdpa_max_rel_err": sdpa_rel}
    ms = {w: slope(lambda kk, s, w=w: run_fwd(w, s, kk)) * 1e3
          for w in steps}
    fwd.update(kernel_ms_per_seq=ms["kernel"], plain_ms_per_seq=ms["plain"],
               sdpa_ms_per_seq=ms["sdpa"],
               kernel_over_plain=ms["plain"] / ms["kernel"])
    print(f"flash chain {NBLK}x{T_BLK}: kernel {ms['kernel']:.3f} ms vs "
          f"plain {ms['plain']:.3f} ms (x{ms['plain'] / ms['kernel']:.2f}), "
          f"sdpa {ms['sdpa']:.3f} ms; rel_err={chain_rel:.2e} (sdpa "
          f"{sdpa_rel:.2e})", flush=True)
    evidence["flash_vs_plain_blockwise"] = dict(
        fwd, shape=[Hh, NBLK * T_BLK, D], blocks=NBLK)
    flush(evidence)
    if chain_rel >= 1e-3:
        raise AssertionError(f"chained flash_block wrong on {device}")

    # --- the chain's backward: fused kernels vs autograd of the plain -----
    def grads(which, salt):
        qkv = [x.clone().requires_grad_() for x in (q8, kcat, vcat)]
        loss = (steps[which](salt, *qkv) ** 2).sum()
        return torch.autograd.grad(loss, qkv)

    def run_bwd(which, salt, k):
        acc = torch.zeros((), device=device)
        for i in range(k):
            gq, gk_, gv = grads(which, salt + i)
            acc = acc + gq.sum() + gk_.sum() + gv.sum()
        return acc

    gs = {w: grads(w, 0) for w in steps}
    bwd_rel = max(_rel(a, b) for a, b in zip(gs["kernel"], gs["plain"]))
    sdpa_bwd_rel = max(_rel(a, b) for a, b in zip(gs["sdpa"], gs["plain"]))
    bwd = {"grad_max_rel_err": bwd_rel, "sdpa_grad_max_rel_err": sdpa_bwd_rel}
    ms = {w: slope(lambda kk, s, w=w: run_bwd(w, s, kk)) * 1e3
          for w in steps}
    bwd.update(fused_fwdbwd_ms_per_seq=ms["kernel"],
               plain_fwdbwd_ms_per_seq=ms["plain"],
               sdpa_fwdbwd_ms_per_seq=ms["sdpa"],
               fused_over_plain=ms["plain"] / ms["kernel"])
    print(f"flash fwd+bwd chain {NBLK}x{T_BLK}: fused {ms['kernel']:.3f} ms "
          f"vs plain {ms['plain']:.3f} ms "
          f"(x{ms['plain'] / ms['kernel']:.2f}), sdpa {ms['sdpa']:.3f} ms; "
          f"rel_err={bwd_rel:.2e} (sdpa {sdpa_bwd_rel:.2e})", flush=True)
    evidence["flash_bwd_fused_vs_plain"] = dict(
        bwd, shape=[Hh, NBLK * T_BLK, D], blocks=NBLK)
    flush(evidence)
    if bwd_rel >= 1e-3:
        raise AssertionError(f"fused flash backward wrong on {device}")

    evidence["complete"] = True
    flush(evidence)
    return evidence


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device; the card by default")
    ap.add_argument("--smoke", action="store_true",
                    help="small sizes, noisy slopes allowed, no artifact")
    ap.add_argument("--out", default=str(ARTIFACTS),
                    help="directory of the artifact")
    args = ap.parse_args(argv)
    device = device_from_arg(args.device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    path: Optional[Path] = None
    if not args.smoke:
        ts = timestamp()
        path = Path(args.out) / f"KERNEL_HW_TORCH_{ts}.json"

    def flush(evidence: dict) -> None:
        if path is not None:
            write_json(path, dict(evidence,
                                  kind="rabit_tpu_torch.kernel_hw_proof/v1",
                                  timestamp_utc=ts))

    prove(device, args.smoke, flush)
    if args.smoke:
        print("smoke ok")
    else:
        print(f"wrote {path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
