"""The port's measurement entry points, twins of the JAX package's tools:

* ``python -m rabit_tpu_torch.tools.histogram_sweep`` -- the histogram
  kernel's cost split: the bin count (``mask_only``) against the full
  kernel (``fast``, ``high``) over rows x bins;
* ``python -m rabit_tpu_torch.tools.kernel_hw_proof`` -- every kernel
  against its plain version on the card, and the flash chain's times;
* ``python -m rabit_tpu_torch.tools.collective_sweep`` -- every
  allreduce schedule and wire over NCCL at world p, and the dispatch
  table derived from it;
* ``python -m rabit_tpu_torch.bench`` (beside this package) -- the
  histogram allreduce's throughput, at world 1 or, with ``--world p``,
  one process a card.

Each runs on the card unless given ``--device cpu``, and raises where
there is none. ``--smoke`` shrinks every size and writes nothing; a full
run writes its JSON artifact into ``--out``, by default ``build/artifacts/``
beside the package (never ``benchmarks/``). This module holds what they
share, among it ``run_world``, which starts a world of processes.
"""

from __future__ import annotations

import json
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..telemetry.schema import timestamp_utc as timestamp  # noqa: F401

ARTIFACTS = Path(__file__).resolve().parents[2] / "build" / "artifacts"


def card(device: torch.device) -> dict:
    """The device a result was measured on: the card's name and power
    limit as ``nvidia-smi`` gives them, or the CPU."""
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None, "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={device.index or 0}"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip()
    return {"name": torch.cuda.get_device_name(device),
            "power_limit": smi.rsplit(",", 1)[-1].strip(), "nvidia_smi": smi}


def write_json(path: Path, doc: dict) -> None:
    """``doc`` to ``path`` through a temporary file, so a reader never sees
    half of it."""
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1)
        f.write("\n")
    os.replace(tmp, path)


def gen_pool(seed: int, size: int, nrows: int, nbins: int,
             device: torch.device):
    """``size`` datasets (bins i32, grad f32, hess f32) of ``nrows`` rows,
    made on the device from ``seed``: bin ids uniform in [0, nbins),
    normal gradients, uniform hessians (the JAX tools' draws, from
    another generator)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    b = torch.randint(0, nbins, (size, nrows), generator=gen,
                      dtype=torch.int32, device=device)
    g = torch.randn((size, nrows), generator=gen, device=device)
    h = torch.rand((size, nrows), generator=gen, device=device)
    return b, g, h


def device_from_arg(name: Optional[str]) -> torch.device:
    """``--device``: the card by default. Raises ``SystemExit`` with a
    message (and prints no result) where CUDA is asked for and missing."""
    from ..parallel.mesh import resolve_device
    try:
        return resolve_device(name)
    except RuntimeError as e:
        raise SystemExit(str(e)) from None


WORLD_TIMEOUT_S = 1800


def _world_entry(rank: int, world: int, tmp: str, device_type: str,
                 fn: Callable, args: tuple, arrays: bool) -> None:
    kwargs = {}
    if device_type == "cuda":
        device = torch.device("cuda", rank)
        torch.cuda.set_device(device)
        backend, kwargs["device_id"] = "nccl", device
    else:
        device, backend = torch.device("cpu"), "gloo"
    dist.init_process_group(backend, store=dist.FileStore(f"{tmp}/store",
                                                          world),
                            rank=rank, world_size=world, **kwargs)
    try:
        # a communicator's first operation must include every rank: warm
        # it before schedules whose exchanges leave ranks out
        dist.all_reduce(torch.zeros(1, device=device))
        out = fn(rank, world, device, *args)
    finally:
        dist.destroy_process_group()
    if arrays:
        np.savez(Path(tmp) / f"rank{rank}.npz", **out)
    else:
        write_json(Path(tmp) / f"rank{rank}.json", out)


def run_world(fn: Callable, world: int, device_type: str,
              args: tuple = (), timeout_s: float = WORLD_TIMEOUT_S,
              arrays: bool = False, tmp: Optional[str] = None) -> list:
    """Run ``fn(rank, world, device, *args)`` in ``world`` spawned
    processes that meet in a ``FileStore`` under ``tmp`` (by default a
    temporary directory): rank r on card r over NCCL for
    ``device_type="cuda"``, or on the CPU over gloo. Returns each rank's
    result in rank order: JSON-able, or with ``arrays`` a dict of numpy
    arrays (saved as an ``.npz``). A world larger than the machine's
    cards raises; nothing falls back to the CPU. A rank that fails, or a
    world that outlasts ``timeout_s``, stops every rank and raises."""
    if device_type == "cuda" and world > torch.cuda.device_count():
        raise RuntimeError(
            f"a world of {world} needs {world} CUDA devices, this machine "
            f"has {torch.cuda.device_count()}")
    if tmp is None:
        with tempfile.TemporaryDirectory() as tmp:
            return run_world(fn, world, device_type, args, timeout_s,
                             arrays, tmp)
    import torch.multiprocessing as mp
    ctx = mp.start_processes(
        _world_entry, args=(world, tmp, device_type, fn, args, arrays),
        nprocs=world, join=False, start_method="spawn")
    deadline = time.monotonic() + timeout_s
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            raise RuntimeError(f"world {world} did not finish in "
                               f"{timeout_s:.0f} s")
    if arrays:
        return [dict(np.load(Path(tmp) / f"rank{r}.npz"))
                for r in range(world)]
    out = []
    for r in range(world):
        with open(Path(tmp) / f"rank{r}.json") as f:
            out.append(json.load(f))
    return out


def agree_max(device: torch.device) -> Callable[[float], float]:
    """A time's maximum over the ranks of the default group: each rank's
    measurement becomes the world's (``utils/slope.py``'s ``agree``)."""
    def agree(t: float) -> float:
        v = torch.tensor([t], dtype=torch.float64, device=device)
        dist.all_reduce(v, op=dist.ReduceOp.MAX)
        return float(v.item())
    return agree
