"""Async-overlap benchmark: bucketed gradient sync, sequential against
overlapped, the port of ``tools/overlap_bench.py``.

Starts a world of ``tools/overlap_round_worker.py`` ranks through
``tools.run_world``: ``min(4, cards)`` over NCCL, one card a rank, or a
gloo world of ``--world`` (4) with ``--device cpu``. Each step is N
buckets of compute, each followed by that bucket's allreduce; the sync
series blocks on every allreduce, the overlap series issues it async and
computes the next bucket while it rides the wire. Two paths (the host
API through ``TorchEngine``'s FIFO worker; device tensors through
``bucket_allreduce_async``), each with its two fleet-mean step times
(``bucket_step_ms_sync``, ``bucket_step_ms_overlap``), their ratio, the
recorder's exposed/overlapped split of the async ops, and one bucket's
compute and allreduce alone. The two series must reduce bit for bit
alike on every rank.

    python -m rabit_tpu_torch.tools.overlap_bench [--device cpu]
        [--world N] [--compute-dim D] [--out DIR]
    python -m rabit_tpu_torch.tools.overlap_bench --smoke [--device cpu]

A full run writes ``OVERLAP_BENCH_<ts>.json`` into ``--out``, by default
the port's ``build/artifacts/`` (never ``benchmarks/``), with the card's
name and power limit, and appends both series of both paths to
``history.jsonl`` there (``telemetry/history.py``). The worker's env
knobs (``N_BUCKETS``, ``BUCKET_ELEMS``, ``COMPUTE_DIM``, ...) apply;
``--compute-dim`` sets ``COMPUTE_DIM``.

``--smoke`` runs no bench and writes nothing: the issue/await round trip
in a world of ``--world`` ranks (4 on the CPU, ``min(4, cards)`` on the
card): the async allreduce equals the sync one bit for bit, a second
``wait()`` returns the same, a live watchdog guard (``floor_ms`` 60000,
no abort) rides the op in flight without tripping, the in-flight window
is empty at the end, and the async hier allreduce equals the sync hier
allreduce (groups of two). Without a card and without ``--device cpu``
it exits non-zero and prints no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from pathlib import Path

import numpy as np
import torch

from . import ARTIFACTS, card, device_from_arg, run_world, timestamp, \
    write_json
from . import overlap_round_worker as W

DEFAULT_WORLD = 4
SMOKE_ELEMS = 4096
_CONFIG_KEYS = ("world", "n_buckets", "bucket_elems", "dtype", "compute_dim",
                "compute_reps")


def smoke_rank(rank: int, world: int, device: torch.device) -> dict:
    """The smoke's checks on one rank (a ``run_world`` target)."""
    from ..ops.reducers import SUM
    from ..parallel import collectives as C
    from ..utils.watchdog import Watchdog
    rng = np.random.default_rng(7)
    xs = rng.standard_normal((world, SMOKE_ELEMS)).astype(np.float32)
    x = torch.from_numpy(xs[rank]).to(device)

    ref = C.allreduce(x, None, SUM, method="ring").cpu()
    wd = Watchdog(floor_ms=60000, abort=False)
    guard = wd.guard("allreduce", nbytes=x.numel() * x.element_size())
    h = C.device_allreduce_async(x, None, SUM, method="ring", guard=guard)
    assert isinstance(h.ready(), bool)
    out = h.wait().cpu()
    assert torch.equal(ref, out), "async result diverged from sync"
    assert torch.equal(ref, h.wait().cpu()), "double wait() not idempotent"
    assert wd.expired_total == 0, "watchdog tripped on a healthy op"
    assert C.inflight_count() == 0, "in-flight window not drained"

    # hier: three phases enqueued back to back, one awaitable
    groups = tuple(tuple(range(g, g + 2)) for g in range(0, world, 2)) \
        if world % 2 == 0 and world > 2 else None
    ref2 = C.device_hier_allreduce(x, None, SUM, groups=groups).cpu()
    h2 = C.device_hier_allreduce_async(x, None, SUM, groups=groups)
    assert torch.equal(ref2, h2.wait().cpu()), \
        "async hier diverged from sync hier"
    assert C.inflight_count() == 0
    wd.close()
    return {"rank": rank, "ok": True, "groups": groups}


def default_world(device: torch.device) -> int:
    return (min(DEFAULT_WORLD, torch.cuda.device_count())
            if device.type == "cuda" else DEFAULT_WORLD)


def smoke(device: torch.device, world: int) -> int:
    ranks = run_world(smoke_rank, world, device.type, timeout_s=300)
    assert all(r["ok"] for r in ranks)
    print(f"overlap smoke ok (world {world}, {device.type}, hier groups "
          f"{ranks[0]['groups']})", flush=True)
    return 0


def summary(ranks: list, cfg: dict) -> dict:
    """The artifact's fields from the ranks' documents: rank 0's series
    (every rank computed the same fleet maxima) and every rank's checks."""
    r0 = ranks[0]
    out = {"world": r0["world"], "backend": r0["backend"],
           "n_buckets": cfg["N_BUCKETS"], "bucket_elems": cfg["BUCKET_ELEMS"],
           "dtype": "float32", "compute_dim": cfg["COMPUTE_DIM"],
           "compute_reps": cfg["COMPUTE_REPS"], "rounds": cfg["N_ROUNDS"],
           "warmup": cfg["N_WARMUP"], "paths": {}}
    for name, p in r0["paths"].items():
        sync, over = p["sync"], p["overlap"]
        out["paths"][name] = {
            "bucket_step_ms_sync": sync["mean_ms"],
            "bucket_step_ms_overlap": over["mean_ms"],
            "overlap_over_sync": over["mean_ms"] / sync["mean_ms"],
            "step_ms_sync": sync["step_ms"],
            "step_ms_overlap": over["step_ms"],
            "wire_exposed_ms": over["wire_exposed_ms"],
            "wire_overlapped_ms": over["wire_overlapped_ms"],
            "async_ops": over["async_ops"],
            "compute_ms": p["compute_ms"], "allreduce_ms": p["allreduce_ms"],
            "equal": all(r["paths"][name]["equal"] for r in ranks),
            "exact": all(r["paths"][name]["exact"] for r in ranks)}
    out["correct"] = all(p["equal"] and p["exact"]
                         for p in out["paths"].values())
    return out


def run(device: torch.device, world: int, cfg: dict) -> dict:
    """One bench run: the world's summary."""
    return summary(run_world(W.run_rank, world, device.type, args=(cfg,),
                             timeout_s=900), cfg)


def ingest(result: dict, source: str, ts: str, path: str) -> int:
    """Both series of both paths into the history, each path's config
    fields in its fingerprint, so each trends against its own past."""
    from ..telemetry import history
    added = 0
    for name, p in result["paths"].items():
        config = {k: result[k] for k in _CONFIG_KEYS}
        config.update(path=name, backend=result["backend"])
        for metric in ("bucket_step_ms_sync", "bucket_step_ms_overlap"):
            doc = dict(config, metric=metric, value=p[metric], unit="ms",
                       timestamp_utc=ts)
            added += history.append(path, history.records_from_artifact(
                doc, source=source))
    return added


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="sequential vs overlapped bucketed gradient sync")
    ap.add_argument("--device", default=None,
                    help="cuda (default: NCCL, a card a rank) or cpu (gloo)")
    ap.add_argument("--world", type=int, default=None,
                    help="ranks (default: min(4, cards), or 4 on the CPU)")
    ap.add_argument("--compute-dim", type=int, default=None,
                    help="COMPUTE_DIM for the worker (default 384)")
    ap.add_argument("--smoke", action="store_true",
                    help="the issue/await round trip only; no artifact")
    ap.add_argument("--out", default=str(ARTIFACTS))
    args = ap.parse_args(argv)
    device = device_from_arg(args.device)
    world = args.world or default_world(device)
    if args.smoke:
        return smoke(device, world)
    env = dict(os.environ)
    if args.compute_dim is not None:
        env["COMPUTE_DIM"] = str(args.compute_dim)
    cfg = W.config(env)
    result = run(device, world, cfg)
    result["card"] = card(torch.device(device.type, 0)
                          if device.type == "cuda" else device)
    print(json.dumps(result), flush=True)
    for name, p in result["paths"].items():
        print(f"{name}: overlap/sync = {p['overlap_over_sync']:.3f}",
              flush=True)
    if not result["correct"]:
        print("overlap_bench: the sync and overlap series' buckets were not "
              "equal bit for bit, or not the exact sum", file=sys.stderr)
        return 1
    ts = timestamp()
    name = f"OVERLAP_BENCH_{ts}.json"
    path = Path(args.out) / name
    write_json(path, {"benchmark": f"bucketed gradient sync over a "
                                   f"{world}-process {result['backend']} "
                                   f"world, sequential blocking vs "
                                   f"async-overlapped (compute hides wire)",
                      "timestamp_utc": ts, **result})
    added = ingest(result, name, ts, str(Path(args.out) / "history.jsonl"))
    print(f"wrote {path} ({added} history records)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
