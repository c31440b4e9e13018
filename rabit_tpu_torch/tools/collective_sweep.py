"""Measured crossover sweep for the port's collective dispatch table: the
port of ``tools/collective_sweep.py``.

    python -m rabit_tpu_torch.tools.collective_sweep [--smoke] [--world N]
        [--ranks-per-host G] [--lag-rank R] [--lag-ms M] [--wire-block B]
        [--device cpu] [--out PATH]

Times {tree, ring, bidir, swing, hier} x {wire none/bf16/int8/int8:bf16}
x payload sizes over a world of ``--world`` processes, one a card over
NCCL (``--device cpu``: gloo on the CPU), and derives the per-size-bucket
table that ``allreduce(method="auto")`` loads (``parallel/dispatch.py``).
A world larger than the machine's cards raises; nothing drops to gloo or
the CPU. The ``hier`` column runs the two-level schedule under a forced
``--ranks-per-host`` grouping (the cards of one machine have no host
boundary); when a hier bucket wins, the row carries a ``flat`` field
naming the best flat method.

Each (method, wire) is first checked against the dense sum
(``_check_correct``), so a broken schedule cannot win. Each size is timed
by the slope between k = 2 and 8 chained calls (``utils/slope.py``): on
the card on CUDA events behind a ``torch.cuda._sleep`` (device time)
with the host-paced slope beside it; on the CPU on the host clock. Every
rank measures and the world takes the maximum, so every rank decides
alike (``tools.agree_max``). A point is timed ``REPEATS`` times (once in
a smoke run) and its row holds the median of the readings
(``s_per_op``, ``host_paced_s_per_op``) beside the readings themselves,
so that one noisy reading cannot move a bucket of the table. Each row
has its bus bandwidth, 2(p-1)/p bytes over ``s_per_op``, the convention
of NCCL's tests. Wire modes are timed only on ring-family methods and
only for float SUM payloads.

``--lag-rank R --lag-ms M`` lags one rank before every collective in the
chain: only that rank sleeps (``torch.cuda._sleep`` on its stream on the
card, ``time.sleep`` on the CPU), the others wait for it inside the
collective. ``--wire-block B`` pins the int8 scaling block into the swept
specs.

A full run writes ``build/artifacts/COLLECTIVE_SWEEP_<ts>.json`` (schema
``rabit_tpu.collective_sweep/v3``, with the card's name and power limit),
where dispatch finds the newest one. ``--smoke`` sweeps one small size
with noisy slopes allowed and writes only to ``--out`` when given.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time
from pathlib import Path

import numpy as np
import torch

from ..ops.reducers import SUM
from ..parallel import collectives as C
from ..parallel import dispatch, topology
from ..parallel.wire import WIRE_BLOCK_DEFAULT
from ..utils.slope import _sleep_cycles_per_s, slope_time, slope_times
from . import ARTIFACTS, agree_max, card, run_world, timestamp, write_json

FULL_SIZES = [4096, 32768, 262144, 2097152]
SMOKE_SIZES = [4096]
# readings a point in a full run; its row holds their median
REPEATS = 3
# quantized wire columns: the symmetric modes plus the EQuARX asymmetric
# phase split (int8 RS / bf16 AG); --wire-block pins "@B" onto the
# int8-bearing specs
WIRES = (None, "bf16", "int8", "int8:bf16")
SECTIONS = ((torch.float32, "float_sum"), (torch.int32, "other"))


def _wire_columns(wire_block: int):
    if wire_block == WIRE_BLOCK_DEFAULT:
        return WIRES
    return tuple(w if w is None or "int8" not in w
                 else f"{w}@{wire_block}" for w in WIRES)


def _lag_fn(device: torch.device, lag_ms: float):
    """What the lagging rank runs before each collective."""
    if device.type == "cuda":
        cycles = int(lag_ms * 1e-3 * _sleep_cycles_per_s())
        return lambda: torch.cuda._sleep(cycles)
    return lambda: time.sleep(lag_ms * 1e-3)


def _make_run(x: torch.Tensor, p: int, op: int, method: str, wire,
              groups=None, lag=None):
    """``run(k, salt)``: k allreduces chained through their results (the
    next input depends on the last output, so none can be skipped)."""
    floating = x.dtype.is_floating_point

    def run(k: int, salt: int) -> torch.Tensor:
        acc = x
        for _ in range(k):
            if lag is not None:
                lag()
            r = C._per_shard_allreduce(acc + salt, None, op, method, wire,
                                       groups)
            acc = (0.5 * r / p + 0.5 * acc if floating
                   else torch.clamp(r // p, 0, 1 << 20) + salt)
        return acc
    return run


def _base(dtype: torch.dtype, p: int, n: int, rank: int,
          device: torch.device) -> torch.Tensor:
    if dtype.is_floating_point:
        base = torch.linspace(-1.0, 1.0, p * n, dtype=dtype, device=device)
    else:
        base = (torch.arange(p * n, device=device) % 997).to(dtype)
    return base.reshape(p, n)[rank].contiguous()


def _check_correct(rank: int, p: int, device: torch.device, method: str,
                   wire, dtype: torch.dtype, op: int, groups=None) -> None:
    """A broken schedule must not win a timing race: the method against
    the dense reduction once per (method, wire), the JAX tool's
    tolerances."""
    n = 2048
    rng = np.random.default_rng(11)
    if dtype.is_floating_point:
        xs = rng.standard_normal((p, n)).astype(np.float32)
        want = xs.sum(0)
        atol = 5e-2 * np.abs(want).max() if wire else 1e-4
    else:
        xs = rng.integers(0, 1 << 16, (p, n)).astype(np.int32)
        want, atol = xs.sum(0), 0
    got = C.allreduce(torch.from_numpy(xs[rank]).to(device), None, op,
                      method=method, wire=wire, groups=groups)
    np.testing.assert_allclose(got.cpu().numpy(), want, atol=atol,
                               rtol=5e-2 if wire else 1e-5,
                               err_msg=f"{method} wire={wire}")


def _reading(run, device: torch.device, k_small: int, k_big: int,
             smoke: bool, agree) -> tuple:
    """One (host-paced, device) slope of ``run``, each the world's
    (``agree``); on the CPU both are the host clock's."""
    if device.type == "cuda":
        return slope_times(run, k_small, k_big, allow_noisy=smoke,
                           agree=agree)
    s = slope_time(run, k_small, k_big, allow_noisy=smoke, agree=agree)
    return s, s


def _timed(run, device: torch.device, k_small: int, k_big: int,
           smoke: bool, agree, repeats: int) -> dict:
    """A point's timing fields: ``repeats`` readings and their medians."""
    readings = [_reading(run, device, k_small, k_big, smoke, agree)
                for _ in range(repeats)]
    host = [r[0] for r in readings]
    dev = [r[1] for r in readings]
    return {"s_per_op": float(np.median(dev)),
            "host_paced_s_per_op": float(np.median(host)),
            "s_per_op_readings": dev, "host_paced_readings": host}


def sweep(rank: int, world: int, device: torch.device, sizes, smoke: bool,
          ranks_per_host: int = 2, lag_rank=None, lag_ms: float = 0.0,
          wire_block: int = 0) -> dict:
    """One rank's part of the sweep (every rank runs it; rank 0 prints the
    rows). Returns the artifact's body without its table."""
    groups = (topology.parse_groups(str(ranks_per_host), world)
              if ranks_per_host > 1 and world % ranks_per_host == 0
              else None)
    if not topology.is_hierarchical(groups, world):
        groups = None
    if wire_block <= 0:
        wire_block = WIRE_BLOCK_DEFAULT
    wire_cols = _wire_columns(wire_block)
    k_small, k_big = (2, 4) if smoke else (2, 8)
    repeats = 1 if smoke else REPEATS
    lagging = lag_rank is not None and lag_ms > 0
    if lagging and not 0 <= lag_rank < world:
        raise ValueError(f"--lag-rank {lag_rank} outside world {world}")
    lag = _lag_fn(device, lag_ms) if lagging and rank == lag_rank else None
    agree = agree_max(device)
    rows = []
    for dtype, section in SECTIONS:
        itemsize = torch.empty((), dtype=dtype).element_size()
        for method in dispatch.METHODS:
            if method == "hier" and groups is None:
                continue
            g = groups if method == "hier" else None
            wires = (wire_cols if section == "float_sum" and method != "tree"
                     else (None,))
            for wire in wires:
                _check_correct(rank, world, device, method, wire, dtype, SUM,
                               groups=g)
                for n in sizes:
                    run = _make_run(_base(dtype, world, n, rank, device),
                                    world, SUM, method, wire, groups=g,
                                    lag=lag)
                    timed = _timed(run, device, k_small, k_big, smoke,
                                   agree, repeats)
                    row = {"section": section, "method": method,
                           "wire": wire, "n": n, **timed,
                           "bus_gbps": (2 * (world - 1) / world * n
                                        * itemsize / timed["s_per_op"]
                                        / 1e9),
                           "wire_block": (wire_block if wire
                                          and "int8" in wire else None),
                           "lag_rank": lag_rank if lagging else None,
                           "lag_ms": lag_ms if lagging else 0.0}
                    rows.append(row)
                    if rank == 0:
                        print(json.dumps(row), flush=True)
    return {"world": world,
            "backend": "nccl" if device.type == "cuda" else "gloo",
            "device": card(device) if rank == 0 else None,
            "torch": torch.__version__,
            "timing": ("CUDA events behind a sleep kernel (s_per_op); host "
                       "clock (host_paced_s_per_op)"
                       if device.type == "cuda" else "host clock"),
            "k": [k_small, k_big], "repeats": repeats,
            "wire_block": wire_block,
            "ranks_per_host": ranks_per_host if groups else 1,
            "lag": ({"rank": lag_rank, "ms": lag_ms} if lagging else None),
            "rows": rows}


def derive_table(rows, sizes) -> dict:
    """Per-size winners -> bucket rows. ``max_n`` boundaries are the
    geometric midpoints between adjacent swept sizes (a payload between
    two measurements follows its nearer neighbor); the last bucket is
    open-ended (max_n null, required by the schema). The JAX tool's
    rule, unchanged."""
    table = {}
    for section in ("float_sum", "other"):
        out = []
        for i, n in enumerate(sizes):
            cell = {(r["method"], r["wire"]): r["s_per_op"]
                    for r in rows
                    if r["section"] == section and r["n"] == n}
            best_method = min(
                (m for (m, w) in cell if w is None),
                key=lambda m: cell[(m, None)])
            wire = None
            quantized = {w: t for (m, w), t in cell.items()
                         if m == best_method and w is not None}
            if quantized:
                w_best = min(quantized, key=quantized.get)
                if quantized[w_best] < cell[(best_method, None)]:
                    wire = w_best
            max_n = (None if i == len(sizes) - 1 else
                     int(math.sqrt(n * sizes[i + 1])))
            row = {"max_n": max_n, "method": best_method, "wire": wire}
            if best_method == "hier":
                # the schedule auto-dispatch degrades to on a world whose
                # grouping is not genuinely two-level -- the best FLAT
                # method at this size (dispatch._valid_rows)
                row["flat"] = min(
                    (m for (m, w) in cell if w is None and m != "hier"),
                    key=lambda m: cell[(m, None)])
            out.append(row)
        table[section] = out
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--smoke", action="store_true",
                    help="one small size, noisy timing ok, writes only to "
                         "--out")
    ap.add_argument("--world", type=int, default=None,
                    help="processes, one a card (default: every card; 2 "
                         "on the CPU)")
    ap.add_argument("--ranks-per-host", type=int, default=2,
                    help="simulated ranks per host for the hier column "
                         "(<=1 or non-divisor drops hier from the sweep)")
    ap.add_argument("--lag-rank", type=int, default=None,
                    help="rank that sleeps --lag-ms before every "
                         "collective (skew-crossover measurement)")
    ap.add_argument("--lag-ms", type=float, default=0.0,
                    help="the lagging rank's sleep before each collective")
    ap.add_argument("--wire-block", type=int, default=0,
                    help="int8 scaling-block size pinned into the swept "
                         "wire specs (0: parallel/wire.py default)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo on the CPU; the cards by default")
    ap.add_argument("--out", default=None,
                    help="artifact path (default: build/artifacts/, "
                         "timestamped)")
    args = ap.parse_args(argv)
    device_type = torch.device(args.device or "cuda").type
    if device_type == "cuda" and not torch.cuda.is_available():
        print(json.dumps({"status": "no_cuda"}), flush=True)
        print("collective_sweep: no CUDA device; pass --device cpu to run "
              "on the CPU", file=sys.stderr)
        return 1
    world = args.world or (torch.cuda.device_count()
                           if device_type == "cuda" else 2)
    if world < 2:
        raise SystemExit(f"collective_sweep needs a world of at least 2, "
                         f"got {world}")
    sizes = SMOKE_SIZES if args.smoke else FULL_SIZES
    result = run_world(sweep, world, device_type, args=(
        sizes, args.smoke, args.ranks_per_host, args.lag_rank, args.lag_ms,
        args.wire_block))[0]
    result["schema"] = dispatch.SCHEMA
    result["table"] = derive_table(result["rows"], sizes)
    ts = timestamp()
    result["timestamp_utc"] = ts
    if args.smoke:
        result["smoke"] = True  # noisy timings: never a table to keep
    if not (dispatch._valid_rows(result["table"]["float_sum"])
            and dispatch._valid_rows(result["table"]["other"])):
        raise AssertionError("derived table failed validation")
    print(json.dumps({"table": result["table"]}), flush=True)
    path = args.out or (None if args.smoke else
                        str(ARTIFACTS / f"COLLECTIVE_SWEEP_{ts}.json"))
    if path:
        write_json(Path(path), result)
        # the artifact must round-trip through the loader it feeds
        if dispatch.load_table(path) is None:
            raise AssertionError(f"{path}: emitted table failed validation")
        print(f"wrote {path}", flush=True)
    if args.smoke:
        print("smoke ok", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
