"""The port's measurement entry points, twins of the JAX package's tools:

* ``python -m rabit_tpu_torch.tools.histogram_sweep`` -- the histogram
  kernel's cost split: the bin count (``mask_only``) against the full
  kernel (``fast``, ``high``) over rows x bins;
* ``python -m rabit_tpu_torch.tools.kernel_hw_proof`` -- every kernel
  against its plain version on the card, and the flash chain's times;
* ``python -m rabit_tpu_torch.bench`` (beside this package) -- the
  histogram allreduce's throughput.

Each runs on the card unless given ``--device cpu``, and raises where
there is none. ``--smoke`` shrinks every size and writes nothing; a full
run writes its JSON artifact into ``--out``, by default ``build/artifacts/``
beside the package (never ``benchmarks/``). This module holds what they
share.
"""

from __future__ import annotations

import datetime
import json
import os
import subprocess
from pathlib import Path
from typing import Optional

import torch

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


def timestamp() -> str:
    return datetime.datetime.now(datetime.timezone.utc).strftime(
        "%Y%m%dT%H%M%SZ")


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
