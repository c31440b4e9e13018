"""Spawn a world of the port for a test: ``p`` processes meet in a
``FileStore`` under a temporary directory (gloo on the CPU, or NCCL with
rank r on card r), each runs ``fn(rank, p, *args)`` and saves an ``.npz``
of the arrays it returns; the parent returns them in rank order. Imports
neither JAX nor ``rabit_tpu``."""

import time

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

SPAWN_TIMEOUT_S = 240


def _rank_entry(rank: int, p: int, store_path: str, out_dir: str,
                backend: str, fn, args: tuple) -> None:
    kwargs = {}
    if backend == "nccl":
        torch.cuda.set_device(rank)
        kwargs["device_id"] = torch.device("cuda", rank)
    dist.init_process_group(backend, store=dist.FileStore(store_path, p),
                            rank=rank, world_size=p, **kwargs)
    try:
        got = fn(rank, p, *args)
    finally:
        dist.destroy_process_group()
    np.savez(f"{out_dir}/rank{rank}.npz", **got)


def spawn_world(fn, p: int, tmp_path, *args, backend: str = "gloo") -> list:
    """Run ``fn(rank, p, *args) -> dict of arrays`` in a world of ``p``
    and return each rank's dict."""
    ctx = mp.start_processes(
        _rank_entry, args=(p, str(tmp_path / "store"), str(tmp_path),
                           backend, fn, args),
        nprocs=p, join=False, start_method="spawn")
    deadline = time.monotonic() + SPAWN_TIMEOUT_S
    while not ctx.join(timeout=1):
        if time.monotonic() > deadline:
            for proc in ctx.processes:
                proc.kill()
            pytest.fail(f"world {p} did not finish in {SPAWN_TIMEOUT_S} s")
    return [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(p)]
