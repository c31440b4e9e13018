"""Distributed gradient-boosted decision stumps through rabit_tpu_torch:
the port of ``examples/py/boosted_trees.py`` (the reference library's
motivating workload, distributed XGBoost: per-worker histogram build,
allreduce, identical split finding everywhere, doc/guide.md:137-143).

Every boosting round:
  1. each worker computes gradients/hessians of its data shard,
  2. builds its per-(feature, bucket) histogram on its device with
     ``ops.histogram.histogram`` (the CUDA kernel ``csrc/histogram.cu`` on
     the card, its plain version on the CPU): entry (row, feature) goes to
     bin ``feature * bins + bucket``, with the row's grad and hess,
  3. ``rabit.allreduce`` sums the histograms across workers (under the
     robust engine: through its data plane, or its sockets below the
     payload floor),
  4. every worker finds the SAME best split from the global histogram,
  5. the model is checkpointed; killed workers respawn, reload, and catch
     up through result replay (or, at world 1 with ``rabit_ckpt_dir``, a
     cold restart from the durable store).

The shards are the example's (the same numpy seed and draws). The
gradients and hessians are rounded to a multiple of a power of two,
``step``, chosen from the shard so that every partial sum of a bin is
exact in f32: each bin sums at most ``max_count`` values of magnitude at
most 1, so with ``step = 2**(ceil(log2(max_count)) - 23)`` every partial
sum is an integer multiple of ``step`` below 2**24 steps. The kernel's
atomics add in an order that changes from run to run; with exact sums the
order cannot show, so a run is bit for bit reproducible, and the final
model of a run with kills equals that of a run without (the digest check
of the example). Against the example, which sums unrounded f64 values,
the splits agree and the leaf weights agree to about the rounding.

    python -m rabit_tpu_torch.tracker.launch -n 4 python -m \\
        rabit_tpu_torch.tools.boosted_trees rabit_engine=robust_torch \\
        [--features 8 --rows 2000 --bins 16] [key=value ...]

``N_ROUNDS`` (default 10) is the number of rounds. The histogram is built
on the card ``cuda:{rank % device_count}`` unless ``rabit_device=cpu``.
Each worker's result is a JSON document: its trees, digest, kernel
launches, the host-paced ms of each round's histogram allreduce, the wall
clock at the end of its first round, and the data plane's formations;
where a data plane formed a world, also the histogram payload's allreduce
timed through the robust engine and through ``TorchEngine`` on that
world. With ``RABIT_RESULT_DIR`` set, the worker writes it to
``rank<r>.json`` there (a respawned rank's replaces its predecessor's):
the ranks share the launcher's stdout, where another process's output can
break into a line. The last line of its output is ``BOOST-JSON`` and the
same document, for people reading it.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys
import time
from pathlib import Path
from typing import List, Tuple

import numpy as np
import torch

import rabit_tpu_torch as rabit
from rabit_tpu_torch.ops import histogram as K
from rabit_tpu_torch.parallel.mesh import resolve_device
from rabit_tpu_torch.tools import write_json
from rabit_tpu_torch.utils.config import Config

LR = 0.4
RESULT_DIR_ENV = "RABIT_RESULT_DIR"


def make_shard(rank: int, n: int, n_feat: int, n_bins: int, seed: int = 7):
    """Synthetic binary-classification shard (deterministic per rank),
    drawn as the example draws it."""
    rng = np.random.default_rng(seed + rank)
    x = rng.random((n, n_feat), dtype=np.float32)
    logit = 3.0 * (x[:, 0] - 0.5) - 2.0 * (x[:, 1] - 0.5) + \
        1.0 * (x[:, 2] > 0.7)
    y = (rng.random(n) < 1.0 / (1.0 + np.exp(-logit))).astype(np.float32)
    buckets = np.minimum((x * n_bins).astype(np.int64), n_bins - 1)
    return x, y, buckets


def exact_step(buckets: np.ndarray, n_bins: int) -> float:
    """The rounding step under which every bin's f32 sums are exact."""
    n_feat = buckets.shape[1]
    flat = (buckets + np.arange(n_feat) * n_bins).reshape(-1)
    max_count = int(np.bincount(flat, minlength=n_feat * n_bins).max())
    return 2.0 ** (math.ceil(math.log2(max(max_count, 1))) - 23)


def local_histogram(g: np.ndarray, h: np.ndarray, bins: torch.Tensor,
                    n_feat: int, n_bins: int) -> np.ndarray:
    """[n_feat * n_bins, 2] f32 of (sum g, sum h), built on ``bins``'s
    device: grad and hess repeated for each feature of a row."""
    dev = bins.device
    gt = torch.from_numpy(g.astype(np.float32)).to(dev)
    ht = torch.from_numpy(h.astype(np.float32)).to(dev)
    out = K.histogram(bins, gt.repeat_interleave(n_feat),
                      ht.repeat_interleave(n_feat), n_feat * n_bins,
                      precision="high")
    return out.cpu().numpy()


def best_split(hist, reg_lambda=1.0, min_hess=1e-3):
    """Deterministic best (feature, bucket, w_left, w_right) by gain."""
    n_feat = hist.shape[0]
    best = (-np.inf, 0, 0, 0.0, 0.0)
    for f in range(n_feat):
        gsum = hist[f, :, 0].sum()
        hsum = hist[f, :, 1].sum()
        gl = np.cumsum(hist[f, :, 0])[:-1]
        hl = np.cumsum(hist[f, :, 1])[:-1]
        gr, hr = gsum - gl, hsum - hl
        ok = (hl > min_hess) & (hr > min_hess)
        gain = np.where(
            ok,
            gl ** 2 / (hl + reg_lambda) + gr ** 2 / (hr + reg_lambda)
            - gsum ** 2 / (hsum + reg_lambda), -np.inf)
        b = int(np.argmax(gain))
        if gain[b] > best[0]:
            best = (float(gain[b]), f, b,
                    float(-gl[b] / (hl[b] + reg_lambda)),
                    float(-gr[b] / (hr[b] + reg_lambda)))
    return best[1:]


def predict_tree(buckets, tree):
    f, b, wl, wr = tree
    return np.where(buckets[:, f] <= b, wl, wr).astype(np.float64)


def digest_of(model: List[Tuple]) -> float:
    """The example's model digest."""
    return float(abs(hash(tuple(map(tuple, model)))) % (2 << 40))


def _device(rank: int) -> torch.device:
    dev = resolve_device(Config.from_args(
        [a for a in sys.argv[1:] if "=" in a]).get("rabit_device") or None)
    if dev.type == "cuda":
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    return dev


def _time_direct(hist: np.ndarray, reps: int = 20) -> dict:
    """The histogram payload's allreduce, host-paced ms a call, through the
    robust engine and through ``TorchEngine`` on the data plane's formed
    world (the same process group, without the engine's consensus); on
    the card also on a group without blocking waits."""
    from rabit_tpu_torch.engine.torch_engine import TorchEngine
    out = {}
    t0 = time.perf_counter()
    for _ in range(reps):
        rabit.allreduce(hist, rabit.SUM)
    out["robust_ms"] = (time.perf_counter() - t0) * 1e3 / reps
    dp = rabit._engine.dataplane
    te = TorchEngine()
    te.init([f"rabit_device={dp.device.type}"])   # adopts the formed world
    try:
        out["torch_engine_ms"] = _ms_a_call(
            lambda buf: te.allreduce(buf, rabit.SUM), hist, reps)
    finally:
        te.shutdown()
    if dp.device.type == "cuda":
        # the same call on a group of the same ranks formed without the
        # data plane's blocking waits: what those waits cost a call
        import torch.distributed as dist
        from rabit_tpu_torch.parallel.collectives import allreduce_numpy
        saved = os.environ.get("TORCH_NCCL_BLOCKING_WAIT")
        os.environ["TORCH_NCCL_BLOCKING_WAIT"] = "0"
        try:
            group = dist.new_group(list(range(dist.get_world_size())))
        finally:
            if saved is None:
                os.environ.pop("TORCH_NCCL_BLOCKING_WAIT")
            else:
                os.environ["TORCH_NCCL_BLOCKING_WAIT"] = saved
        out["no_blocking_wait_ms"] = _ms_a_call(
            lambda buf: allreduce_numpy(buf, group, rabit.SUM, dp.device),
            hist, reps)
        dist.destroy_process_group(group)
    return out


def _ms_a_call(fn, hist: np.ndarray, reps: int) -> float:
    """Host-paced ms a call of ``fn`` on a fresh copy of ``hist``, after
    one warm-up call."""
    fn(hist.copy())
    t0 = time.perf_counter()
    for _ in range(reps):
        fn(hist.copy())
    return (time.perf_counter() - t0) * 1e3 / reps


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--features", type=int, default=8)
    ap.add_argument("--rows", type=int, default=2000)
    ap.add_argument("--bins", type=int, default=16)
    opts, _ = ap.parse_known_args(argv)
    if opts.features < 3:
        raise ValueError("--features must be at least 3 (the label reads "
                         "features 0-2)")
    rabit.init()
    rank, world = rabit.get_rank(), rabit.get_world_size()
    n_rounds = int(os.environ.get("N_ROUNDS", "10"))
    n_feat, n_bins = opts.features, opts.bins
    dev = _device(rank)
    x, y, buckets = make_shard(rank, opts.rows, n_feat, n_bins)
    step = exact_step(buckets, n_bins)
    bins = torch.from_numpy(
        (buckets + np.arange(n_feat) * n_bins).reshape(-1).astype(np.int32)
    ).to(dev)

    # resume: the model is the list of stumps built so far
    version, model = rabit.load_checkpoint()
    model = model or []
    margin = np.zeros(len(y), np.float64)
    for tree in model:
        margin += LR * predict_tree(buckets, tree)

    allreduce_ms = []
    first_round_at = None
    for rnd in range(version, n_rounds):
        p = 1.0 / (1.0 + np.exp(-margin))
        g = np.round((p - y) / step) * step
        h = np.round(p * (1.0 - p) / step) * step
        hist = local_histogram(g, h, bins, n_feat, n_bins).reshape(-1)
        t0 = time.perf_counter()
        hist = rabit.allreduce(hist, rabit.SUM)  # the hot collective
        allreduce_ms.append((time.perf_counter() - t0) * 1e3)
        tree = best_split(hist.reshape(n_feat, n_bins, 2).astype(np.float64))
        model.append(tree)
        margin += LR * predict_tree(buckets, tree)
        # global logloss (for the humans watching)
        p = np.clip(1.0 / (1.0 + np.exp(-margin)), 1e-9, 1 - 1e-9)
        part = np.array([-(y * np.log(p) + (1 - y) * np.log(1 - p)).sum(),
                         float(len(y))])
        tot = rabit.allreduce(part, rabit.SUM)
        if rank == 0:
            rabit.tracker_print(
                f"round {rnd}: global logloss {tot[0] / tot[1]:.5f}")
        rabit.checkpoint(model)
        if first_round_at is None:
            first_round_at = time.time()

    # bit-identical everywhere: hash the model and verify via MAX==MIN
    digest = digest_of(model)
    hi = rabit.allreduce(np.array([digest]), rabit.MAX)
    lo = rabit.allreduce(np.array([digest]), rabit.MIN)
    assert hi[0] == lo[0] == digest, "model diverged across ranks"
    if rank == 0:
        rabit.tracker_print(f"final model digest {int(digest)}")
    eng = rabit._engine
    dp = getattr(eng, "dataplane", None)
    doc = {"rank": rank, "world": world, "device": str(dev),
           "trees": [list(t) for t in model], "digest": int(digest),
           "version": version, "step": step,
           "launches": K.histogram.launches, "allreduce_ms": allreduce_ms,
           "first_round_at": first_round_at,
           "epoch": getattr(eng, "world_epoch", 0)}
    if dp is not None and dp.formed:
        doc["timing"] = _time_direct(np.zeros(n_feat * n_bins * 2,
                                              np.float32))
        doc["dataplane"] = {"backend": dp.backend,
                            "formations": dp.formations,
                            "form_seconds": dp.form_seconds,
                            "formed_at": dp.formed_at,
                            "first_collective_at": dp.first_collective_at}
    rabit.finalize()
    out_dir = os.environ.get(RESULT_DIR_ENV)
    if out_dir:
        write_json(Path(out_dir) / f"rank{rank}.json", doc)
    # one write a line: the ranks share the launcher's stdout, and under
    # unbuffered output print() writes the text and its newline apart
    sys.stdout.write(f"BOOST-OK rank={rank} world={world} trees={len(model)}"
                     f" digest={int(digest)}\n")
    sys.stdout.write("BOOST-JSON " + json.dumps(doc) + "\n")
    sys.stdout.flush()


if __name__ == "__main__":
    main()
