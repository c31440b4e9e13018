"""Bucketed gradient-sync steps, sequential against overlapped: the port
of ``benchmarks/overlap_round_worker.py``, one process a rank under
``tools.run_world`` (``tools/overlap_bench.py`` starts the world).

One "step" is ``N_BUCKETS`` buckets, each a backward-compute slice (a
deterministic matmul chain standing in for the next bucket's autodiff
work) followed by that bucket's gradient allreduce. The sync series runs
them DDP-naive: compute bucket b, then the blocking allreduce before
bucket b+1's compute; the overlap series issues each allreduce without
blocking and waits once every bucket is in flight, so bucket b's wire
time can hide behind bucket b+1's compute. Two paths, each a sync series
then an overlap series on the same fabric and the same inputs:

* ``host`` -- the host API, as the JAX worker runs it:
  ``rabit_tpu_torch.allreduce`` against ``allreduce_async`` through
  ``TorchEngine``'s FIFO worker (numpy -> card -> allreduce -> numpy on
  its own thread), the compute a numpy matmul chain (which releases the
  GIL);
* ``device`` -- the same buckets as tensors on the rank's device:
  ``device_allreduce_tree`` (stream-ordered: bucket b+1's compute waits
  for bucket b's allreduce on the device) against
  ``bucket_allreduce_async`` (issued on the device's side stream), the
  compute the same chain as f32 ``torch.matmul`` with TF32 off.

A step's wall time ends only after its device work is done (a
``torch.cuda.synchronize`` before the clock is read), and its cost is the
fleet MAX of the ranks' wall times; each series' mean leaves out
``N_WARMUP`` steps. The payloads are integers in f32, so every sum is
exact: the sync and overlap series' reduced buckets must be equal bit for
bit on every rank, and equal to the integer sum. Each path also reports
the recorder's split of its async ops (``wire_exposed_ms`` and
``wire_overlapped_ms`` a step, telemetry on in both series), and one
bucket's compute and allreduce alone (median ms, fleet MAX), the two
sides of what the overlap can hide.

env: N_BUCKETS (4), BUCKET_ELEMS (1000000 float32 per bucket),
COMPUTE_DIM (384), COMPUTE_REPS (8), N_ROUNDS (5), N_WARMUP (2), PATHS
(``host,device``: the paths to run; a compute dim that suits one path's
compute, numpy on the host or the card, need not suit the other's).
"""

from __future__ import annotations

import os
import time
from typing import Callable, List

import numpy as np
import torch
import torch.distributed as dist

DEFAULTS = {"N_BUCKETS": 4, "BUCKET_ELEMS": 1000000, "COMPUTE_DIM": 384,
            "COMPUTE_REPS": 8, "N_ROUNDS": 5, "N_WARMUP": 2}
SOLO_REPS = 5   # repetitions of one bucket's compute and allreduce alone


PATHS = ("host", "device")


def config(env=None) -> dict:
    """The worker's knobs from ``env`` (by default the environment)."""
    env = os.environ if env is None else env
    cfg = {k: int(env.get(k, v)) for k, v in DEFAULTS.items()}
    cfg["PATHS"] = tuple(env.get("PATHS", ",".join(PATHS)).split(","))
    bad = set(cfg["PATHS"]) - set(PATHS)
    if bad:
        raise ValueError(f"PATHS: unknown {sorted(bad)}, not in {PATHS}")
    return cfg


def make_buckets(rank: int, nb: int, elems: int) -> List[np.ndarray]:
    """Rank-varying integer payloads in f32 (the JAX worker's), so each
    reduction is a real cross-rank merge and every sum is exact."""
    return [((np.arange(elems) % 251).astype(np.float32) + rank + b)
            for b in range(nb)]


def expected_sum(world: int, nb: int, elems: int) -> List[np.ndarray]:
    base = (np.arange(elems) % 251).astype(np.float64) * world
    return [(base + world * (world - 1) / 2 + world * b).astype(np.float32)
            for b in range(nb)]


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _fleet_max(t: float) -> float:
    import rabit_tpu_torch as rabit
    return float(rabit.allreduce(np.array([t], np.float64), rabit.MAX)[0])


def _align() -> None:
    import rabit_tpu_torch as rabit
    rabit.allreduce(np.zeros(1, np.int32), rabit.SUM)


def _split(name: str) -> tuple:
    """The recorder's exposed/overlapped ms summed over the async spans
    ``name`` recorded since the last reset."""
    from rabit_tpu_torch import telemetry
    spans = [s for s in telemetry.snapshot()["spans"]
             if s["name"] == name and s["attrs"].get("async") == 1]
    return (sum(s["attrs"]["wire_exposed_ms"] for s in spans),
            sum(s["attrs"]["wire_overlapped_ms"] for s in spans), len(spans))


def _series(step: Callable[[bool], tuple], overlapped: bool, cfg: dict,
            device: torch.device, span: str) -> dict:
    """``N_WARMUP + N_ROUNDS`` steps; the fleet-MAX ms of the timed ones,
    the last step's reduced buckets (host arrays) and, for the overlap
    series, the recorder's split a step."""
    from rabit_tpu_torch import telemetry
    times, outs = [], None
    for i in range(cfg["N_WARMUP"] + cfg["N_ROUNDS"]):
        if i == cfg["N_WARMUP"]:
            telemetry.reset(enabled=True)
        _align()
        dt, outs = step(overlapped)
        if i >= cfg["N_WARMUP"]:
            times.append(_fleet_max(dt) * 1e3)
    exposed, overlapped_ms, n_async = _split(span)
    rounds = cfg["N_ROUNDS"]
    return {"step_ms": times, "mean_ms": sum(times) / len(times),
            "wire_exposed_ms": exposed / rounds,
            "wire_overlapped_ms": overlapped_ms / rounds,
            "async_ops": n_async, "outs": outs}


def _solo_ms(fn: Callable[[], None], device: torch.device) -> float:
    """Median wall ms of ``fn`` alone, synchronised, fleet MAX."""
    times = []
    for _ in range(SOLO_REPS):
        _align()
        _sync(device)
        t0 = time.perf_counter()
        fn()
        _sync(device)
        times.append(time.perf_counter() - t0)
    return _fleet_max(float(np.median(times))) * 1e3


def _host_path(rank: int, cfg: dict, device: torch.device) -> dict:
    import rabit_tpu_torch as rabit
    nb, dim, reps = cfg["N_BUCKETS"], cfg["COMPUTE_DIM"], cfg["COMPUTE_REPS"]
    a = np.full((dim, dim), 1.0 / dim, np.float32)

    def compute() -> None:
        acc = a
        for _ in range(reps):
            acc = acc @ a
        assert np.isfinite(acc[0, 0])

    def step(overlapped: bool) -> tuple:
        bufs = make_buckets(rank, nb, cfg["BUCKET_ELEMS"])
        t0 = time.perf_counter()
        if overlapped:
            handles = []
            for buf in bufs:
                compute()
                handles.append(rabit.allreduce_async(buf, rabit.SUM))
            outs = [h.wait() for h in handles]
        else:
            outs = []
            for buf in bufs:
                compute()
                outs.append(rabit.allreduce(buf, rabit.SUM))
        _sync(device)
        return time.perf_counter() - t0, outs

    out = {"sync": _series(step, False, cfg, device, "engine.allreduce"),
           "overlap": _series(step, True, cfg, device, "engine.allreduce")}
    one = make_buckets(rank, 1, cfg["BUCKET_ELEMS"])[0]
    out["compute_ms"] = _solo_ms(compute, device)
    out["allreduce_ms"] = _solo_ms(lambda: rabit.allreduce(one, rabit.SUM),
                                   device)
    return out


def _device_path(rank: int, cfg: dict, device: torch.device) -> dict:
    from rabit_tpu_torch.ops.reducers import SUM
    from rabit_tpu_torch.parallel import collectives as C
    nb, dim, reps = cfg["N_BUCKETS"], cfg["COMPUTE_DIM"], cfg["COMPUTE_REPS"]
    a = torch.full((dim, dim), 1.0 / dim, dtype=torch.float32, device=device)
    accs: List[torch.Tensor] = []

    def compute() -> None:
        acc = a
        for _ in range(reps):
            acc = torch.matmul(acc, a)
        accs.append(acc[0, 0])  # checked after the step: no host sync here

    def step(overlapped: bool) -> tuple:
        bufs = [torch.from_numpy(b).to(device)
                for b in make_buckets(rank, nb, cfg["BUCKET_ELEMS"])]
        accs.clear()
        _sync(device)
        t0 = time.perf_counter()
        if overlapped:
            handles = []
            for buf in bufs:
                compute()
                handles.append(C.bucket_allreduce_async([buf], None, SUM))
            outs = [h.wait()[0] for h in handles]
        else:
            outs = []
            for buf in bufs:
                compute()
                outs.append(C.device_allreduce_tree([buf], None, SUM)[0])
        _sync(device)
        dt = time.perf_counter() - t0
        assert bool(torch.isfinite(torch.stack(accs)).all())
        return dt, [o.cpu().numpy() for o in outs]

    out = {"sync": _series(step, False, cfg, device, "bucket_allreduce"),
           "overlap": _series(step, True, cfg, device, "bucket_allreduce")}
    one = torch.from_numpy(make_buckets(rank, 1, cfg["BUCKET_ELEMS"])[0]
                           ).to(device)
    out["compute_ms"] = _solo_ms(compute, device)
    out["allreduce_ms"] = _solo_ms(
        lambda: C.device_allreduce_tree([one], None, SUM), device)
    return out


def run_rank(rank: int, world: int, device: torch.device, cfg: dict) -> dict:
    """Both paths on this rank (a ``tools.run_world`` target: the default
    group is formed); returns the series' numbers and whether the sync
    and overlap buckets were equal bit for bit and exact."""
    import rabit_tpu_torch as rabit
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 stays f32
    rabit.init(["rabit_engine=torch", f"rabit_device={device.type}",
                "rabit_telemetry=1"])
    try:
        want = expected_sum(world, cfg["N_BUCKETS"], cfg["BUCKET_ELEMS"])
        doc = {"rank": rank, "world": world,
               "backend": dist.get_backend(), "paths": {}}
        runs = {"host": _host_path, "device": _device_path}
        for name in cfg["PATHS"]:
            res = runs[name](rank, cfg, device)
            sync, over = res["sync"].pop("outs"), res["overlap"].pop("outs")
            res["equal"] = all(np.array_equal(s, o)
                               for s, o in zip(sync, over))
            res["exact"] = all(np.array_equal(s, w)
                               for s, w in zip(sync, want))
            doc["paths"][name] = res
        return doc
    finally:
        rabit.finalize()
