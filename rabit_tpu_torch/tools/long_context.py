"""Long-context sequence parallelism over a world of processes, one a card:
the port of ``examples/py/long_context.py``.

Causal ring attention over a sequence of 512 positions a rank (H 8, D 32)
through ``sequence_parallel_attention``, held against the dense oracle
(max error below 1e-4), then five SGD steps of the (dp, tp, sp)
transformer at the example's shapes, whose loss must fall.

    python -m rabit_tpu_torch.tools.long_context            # every card
    python -m rabit_tpu_torch.tools.long_context --world 4 --device cpu

On the cards by default (NCCL, rank r on card r); ``--device cpu`` runs a
gloo world. A world larger than the cards raises.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from . import device_from_arg, run_world

T_RANK, HEADS, HEAD_DIM = 512, 8, 32
ORACLE_TOL = 1e-4
STEPS, LR = 5, 0.3


def _rank(rank: int, p: int, device) -> Dict:
    from ..models import transformer as tf
    from ..parallel.mesh import make_mesh
    from ..parallel.ring_attention import (reference_attention,
                                           sequence_parallel_attention)
    mesh = make_mesh((p,), device, axes=("sp",))
    t = T_RANK * p
    rng = np.random.default_rng(0)
    q, k, v = (torch.from_numpy(rng.standard_normal(
        (t, HEADS, HEAD_DIM)).astype(np.float32)).to(device)
        for _ in range(3))
    out = sequence_parallel_attention(q, k, v, mesh, causal=True)
    want = reference_attention(q, k, v, causal=True)
    err = float((out - want).abs().max())
    # a few steps of the (dp, tp, sp) transformer
    dp = 2 if p % 2 == 0 else 1
    sp = 2 if p % 4 == 0 else 1
    tp = p // (dp * sp)
    mesh3 = make_mesh((dp, tp, sp), device)
    model, x, y = tf.make_sharded_inputs(
        mesh3, batch=2 * dp, seq=32 * sp, vocab=64, n_layers=2, d_model=32,
        n_heads=max(2, tp), d_head=8, d_ff=64)
    step = tf.make_train_step(mesh3, lr=LR)
    losses = [float(step(model, x, y)) for _ in range(STEPS)]
    return {"err": err, "seq": t, "mesh": [dp, tp, sp], "losses": losses}


def run(world: int, device: torch.device) -> Dict:
    """Both parts over ``world`` processes; raises unless the attention is
    within ``ORACLE_TOL`` of the dense oracle on every rank and the loss
    falls. Returns rank 0's result."""
    ranks = run_world(_rank, world, device.type)
    got = ranks[0]
    print(f"ring attention: seq={got['seq']} over {world} ranks "
          f"({got['seq'] // world} K/V rows a rank), max err vs dense = "
          f"{max(r['err'] for r in ranks):.2e}", flush=True)
    dp, tp, sp = got["mesh"]
    print(f"transformer (dp={dp}, tp={tp}, sp={sp}): "
          + " -> ".join(f"{l:.3f}" for l in got["losses"]), flush=True)
    for r, res in enumerate(ranks):
        if not res["err"] < ORACLE_TOL:
            raise RuntimeError(f"rank {r}: ring attention {res['err']} from "
                               f"the dense oracle")
        losses = res["losses"]
        if not (np.isfinite(losses).all() and losses[-1] < losses[0]):
            raise RuntimeError(f"rank {r}: the loss did not fall: {losses}")
    return got


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--world", type=int, default=None,
                    help="processes, one a card (default: every card; 4 "
                         "with --device cpu)")
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo on the CPU; the cards by default")
    args = ap.parse_args(argv)
    device = device_from_arg(args.device)
    world = args.world or (torch.cuda.device_count()
                           if device.type == "cuda" else 4)
    run(world, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
