"""The flagship's train step under each grad sync, timed on one card for
several checkouts in turns.

    python3 train_step_timing.py DIR [DIR ...] [--steps 12] [--rounds 2]

Each DIR is the root of a checkout of this repository (a parent commit
unpacked with ``git archive`` under ``build/``, which git ignores, and
``.``). In each round every DIR runs in the order A B ... B A, each in a
fresh process that imports that DIR's ``rabit_tpu_torch`` and trains the
full-width flagship (``entry.FLAGSHIP_SIZES``, batch 8 x seq 512, SGD
0.1, a world-1 NCCL mesh, TF32 off) for ``--steps`` steps from the same
weights and data under each grad sync that checkout has: ``psum``,
``ring``, ``bucket`` and, with ``RABIT_ASYNC_COLLECTIVES=1``, the async
bucket step. Each step is timed on CUDA events; a JSON line per (DIR,
round) gives every step's ms, and the last lines the median of steps 2
onwards, per DIR and sync, over all rounds, with the card's name and
power limit. Host-side time moves with the load on the host, so versions
are compared only within one run. It needs one card, and exits non-zero
without one.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
from pathlib import Path

SYNCS = ("psum", "ring", "bucket", "async")


def child(root: str, steps: int) -> dict:
    sys.path.insert(0, root)
    import numpy as np
    import torch
    import torch.distributed as dist
    import rabit_tpu_torch
    if not Path(rabit_tpu_torch.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {rabit_tpu_torch.__file__}, not the "
                           f"checkout {root}")
    from rabit_tpu_torch import entry as E
    from rabit_tpu_torch.models import transformer as tf
    from rabit_tpu_torch.parallel import collectives as C
    from rabit_tpu_torch.parallel.mesh import make_mesh
    torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_mesh((1, 1, 1), "cuda")
    dev = mesh.device
    have = [s for s in SYNCS if s in tf.GRAD_SYNCS
            or (s == "async" and hasattr(C, "async_enabled"))]
    params = tf.init_params(0, **E.FLAGSHIP_SIZES)
    x, y = (torch.from_numpy(a).to(dev) for a in E.flagship_data(
        0, E.FLAGSHIP_BATCH, E.FLAGSHIP_SEQ, E.FLAGSHIP_SIZES["vocab"]))
    out = {"root": root, "torch": torch.__version__}
    try:
        for sync in have:
            os.environ.pop("RABIT_ASYNC_COLLECTIVES", None)
            if sync == "async":
                os.environ["RABIT_ASYNC_COLLECTIVES"] = "1"
            step = tf.make_train_step(mesh, E.FLAGSHIP_LR,
                                      "bucket" if sync == "async" else sync)
            model = tf.model_on(params, dev)
            ms, losses = [], []
            for _ in range(steps):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss = step(model, x, y)
                end.record()
                losses.append(float(loss))
                end.synchronize()
                ms.append(start.elapsed_time(end))
            out[sync] = {"ms": ms, "median_ms": float(np.median(ms[1:])),
                         "last_loss": losses[-1]}
    finally:
        os.environ.pop("RABIT_ASYNC_COLLECTIVES", None)
        dist.destroy_process_group()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("dirs", nargs="*")
    ap.add_argument("--steps", type=int, default=12)
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.child:
        print("STEP-JSON " + json.dumps(child(args.child, args.steps)),
              flush=True)
        return 0
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("train_step_timing: no CUDA device", file=sys.stderr)
        return 1
    if not args.dirs:
        ap.error("give at least one checkout DIR")
    power = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]
    order = list(args.dirs) + list(reversed(args.dirs))
    runs = []
    for rnd in range(args.rounds):
        for d in order:
            root = Path(d).resolve()
            res = subprocess.run(
                [sys.executable, str(Path(__file__).resolve()), "--child",
                 str(root), "--steps", str(args.steps)],
                capture_output=True, text=True, timeout=900, cwd=root)
            line = next((ln for ln in res.stdout.splitlines()
                         if ln.startswith("STEP-JSON ")), None)
            if res.returncode != 0 or line is None:
                print(res.stdout[-2000:], res.stderr[-4000:], file=sys.stderr)
                return 1
            doc = json.loads(line[len("STEP-JSON "):])
            doc.update(root=d, round=rnd)
            print(json.dumps(doc), flush=True)
            runs.append(doc)
    print(power, flush=True)
    for d in args.dirs:
        for sync in SYNCS:
            meds = [r[sync]["median_ms"] for r in runs
                    if r["root"] == d and sync in r]
            if meds:
                print(f"{d} {sync}: median of steps 2-{args.steps} "
                      f"{', '.join(f'{m:.3f}' for m in meds)} ms "
                      f"(runs in order); median {float(np.median(meds)):.3f}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
