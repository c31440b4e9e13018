"""Entry points of the port on the flagship transformer.

``entry()``          the forward of the flagship model at the
                     configuration of ``__graft_entry__.py:36-49`` (the
                     JAX package's entry): returns (fn, example_args).
``train_flagship()`` the flagship training loop of
                     ``tools/flagship_hw_proof.py``: the full-width model
                     (vocab 256, 2 layers, d_model 256, 8 heads x 32,
                     d_ff 1024, sequence 512, batch 8) learns
                     next token = (token + 1) % 256 with SGD at lr 0.1 on a
                     world-1 mesh (NCCL on the card), and the mean loss of
                     the last four steps must end below the first loss
                     minus 0.8.

``dryrun_multichip(n)`` the counterpart of
                     ``__graft_entry__.py::dryrun_multichip``: one
                     training step (two for the transformer) of each
                     parallelism family over n processes, one a card
                     (``tools.run_world``): the transformer over
                     (dp, tp, sp), the MLP over (dp, tp), the pipeline over
                     pp = n, the switch MoE over ep = n, and the
                     quantized-wire ring allreduce (bf16 and int8) over
                     the world.

Each runs on the card unless ``device="cpu"`` is asked for.

    python -m rabit_tpu_torch.entry        # train_flagship on the card
    python -m rabit_tpu_torch.entry --dryrun 4   # dryrun_multichip(4)
"""

from __future__ import annotations

import sys
import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .models import transformer as tf
from .parallel.mesh import DeviceLike, make_mesh, refuse_tf32, resolve_device

ENTRY_SIZES = dict(vocab=256, n_layers=2, d_model=128, n_heads=8, d_head=16,
                   d_ff=512, max_t=256)
ENTRY_BATCH, ENTRY_SEQ = 4, 256
FLAGSHIP_SIZES = dict(vocab=256, n_layers=2, d_model=256, n_heads=8,
                      d_head=32, d_ff=1024, max_t=512)
FLAGSHIP_BATCH, FLAGSHIP_SEQ, FLAGSHIP_LR = 8, 512, 0.1
LOSS_DROP = 0.8  # flagship_hw_proof.py:66-68


def entry(device: DeviceLike = None):
    """(fn, (model, tokens)): the flagship forward through the flash block
    step at the entry configuration, tokens [4, 256] from seed 0."""
    dev = resolve_device(device)
    model = tf.model_on(tf.init_params(0, **ENTRY_SIZES), dev)
    tokens = np.random.default_rng(0).integers(
        0, ENTRY_SIZES["vocab"], size=(ENTRY_BATCH, ENTRY_SEQ))
    return tf.forward, (model, torch.from_numpy(tokens).to(dev))


def flagship_data(seed: int = 0, batch: int = FLAGSHIP_BATCH,
                  seq: int = FLAGSHIP_SEQ, vocab: int = 256
                  ) -> Tuple[np.ndarray, np.ndarray]:
    """(tokens, targets) [batch, seq]: the sequence 0, 1, ..., vocab-1, 0,
    ... at a random phase per row, so the next token is (token + 1) %
    vocab (``flagship_hw_proof.py:41-47``)."""
    rng = np.random.default_rng(seed)
    base = np.arange(seq + 1 + vocab, dtype=np.int64) % vocab
    rows = np.stack([np.roll(base, -int(s))[:seq + 1]
                     for s in rng.integers(0, vocab, size=batch)])
    return rows[:, :seq], rows[:, 1:]


def train_flagship(steps: int = 16, device: DeviceLike = None) -> Dict:
    """Train the flagship (weights and data from seed 0) for ``steps`` SGD
    steps on a world-1 (dp, tp, sp) = (1, 1, 1) mesh and return
    ``{"losses", "step_ms", "device"}``. ``step_ms`` is each
    step's time, on CUDA events on the card (host clock on the CPU). It
    raises unless the mean of the last four losses is below the first
    loss minus 0.8. A process group that exists is adopted; one this
    function creates it destroys."""
    refuse_tf32("train_flagship")
    sizes = FLAGSHIP_SIZES
    owns_group = not dist.is_initialized()
    mesh = make_mesh((1, 1, 1), device)
    try:
        dev = mesh.device
        model = tf.model_on(tf.init_params(0, **sizes), dev)
        x, y = (torch.from_numpy(a).to(dev) for a in flagship_data(
            0, FLAGSHIP_BATCH, FLAGSHIP_SEQ, sizes["vocab"]))
        step = tf.make_train_step(mesh, lr=FLAGSHIP_LR)
        losses: List[float] = []
        step_ms: List[float] = []
        for _ in range(steps):
            if dev.type == "cuda":
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                loss = step(model, x, y)
                end.record()
                losses.append(float(loss))
                end.synchronize()
                step_ms.append(start.elapsed_time(end))
            else:
                t0 = time.perf_counter()
                losses.append(float(step(model, x, y)))
                step_ms.append((time.perf_counter() - t0) * 1e3)
    finally:
        if owns_group:
            dist.destroy_process_group()
    if not np.isfinite(losses).all():
        raise RuntimeError(f"flagship loss went non-finite: {losses}")
    tail = float(np.mean(losses[-4:]))
    if not tail < losses[0] - LOSS_DROP:
        raise RuntimeError(f"flagship loss did not decrease: {losses[0]} "
                           f"-> tail mean {tail}")
    name = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    return {"losses": losses, "step_ms": step_ms, "device": name}


def _axis_factors(n: int) -> Tuple[int, int, int]:
    """n processes as (dp, tp, sp), every axis real where n allows (n = 8:
    2 x 2 x 2; 4: 2 x 2 x 1, sp degrading last; 2: 2 x 1 x 1), the odd
    factor left riding dp (``__graft_entry__.py:52-64``)."""
    dp = tp = sp = 1
    for axis in ("dp", "tp", "sp"):
        if n % 2 == 0:
            n //= 2
            dp, tp, sp = (dp * 2 if axis == "dp" else dp,
                          tp * 2 if axis == "tp" else tp,
                          sp * 2 if axis == "sp" else sp)
    return dp * n, tp, sp


DRYRUN_D = 16            # the pipeline's and the MoE's width
DRYRUN_WIRE_N = 64 * 1024


def _finite(*losses: float) -> None:
    if not np.isfinite(losses).all():
        raise RuntimeError(f"loss went non-finite: {losses}")


def _dryrun_rank(rank: int, n: int, device) -> Dict:
    """One rank of ``dryrun_multichip``: each family in turn, its losses
    (and the wire's results) for the parent to print and compare."""
    from .models import mlp
    from .ops.reducers import SUM
    from .parallel import collectives as C
    from .parallel import moe, pipeline
    out: Dict = {}
    # the flagship: the transformer over (dp, tp, sp), two steps
    dp, tp, sp = _axis_factors(n)
    mesh3 = make_mesh((dp, tp, sp), device)
    model, x, y = tf.make_sharded_inputs(
        mesh3, batch=dp * 2, seq=sp * 8, vocab=64, n_layers=2, d_model=32,
        n_heads=max(2, tp), d_head=8, d_ff=64)
    step = tf.make_train_step(mesh3, lr=0.1)
    out["transformer"] = [float(step(model, x, y)) for _ in range(2)]
    _finite(*out["transformer"])
    # the MLP over (dp, tp), two steps
    tp2 = 2 if n % 2 == 0 else 1
    dp2 = n // tp2
    mesh2 = make_mesh((dp2, tp2, 1), device)
    mmodel, mx, my = mlp.make_sharded_inputs(
        mesh2, batch=max(dp2 * 4, 8), in_dim=32, hidden=16 * tp2, out_dim=8)
    mstep = mlp.make_train_step(mesh2, lr=0.1)
    out["mlp"] = [float(mstep(mmodel, mx, my)) for _ in range(2)]
    _finite(*out["mlp"])
    # the pipeline over pp = n: one SGD step through the reverse pipeline
    d = DRYRUN_D
    rng = np.random.default_rng(0)
    meshp = make_mesh((n,), device, axes=("pp",))
    stages = [{"w": (rng.standard_normal((d, d)) / 4).astype(np.float32)}
              for _ in range(n)]
    xp = torch.from_numpy(rng.standard_normal((6, 4, d)).astype(
        np.float32)).to(device)
    placed = pipeline.place_pipeline_params(meshp, stages)
    pfn = pipeline.make_pipeline_fn(
        meshp, lambda prm, h: torch.tanh(h @ prm["w"]))
    yp = pfn(placed, xp)
    ploss = (yp * yp).mean()
    ploss.backward()
    with torch.no_grad():
        for v in placed.values():
            v -= 0.1 * v.grad
    out["pipeline"] = [float(ploss.detach())]
    _finite(*out["pipeline"])
    # the switch MoE over ep = n: one SGD step through router and experts
    meshe = make_mesh((n,), device, axes=("ep",))
    group = meshe.group("ep")
    eparams = moe.place_moe_params(meshe, moe.init_moe_params(
        7, d_model=d, d_ff=32, n_experts=n))
    xe = np.random.default_rng(8).standard_normal((8 * n, d)).astype(
        np.float32)
    xe = torch.from_numpy(xe[rank * 8:(rank + 1) * 8]).to(device)
    ye, aux = moe.make_moe_fn(meshe, capacity_factor=4.0)(eparams, xe)
    eloss = C.psum_identity_grad((ye * ye).sum(), group) / ye.numel() / n \
        + 0.01 * aux
    eloss.backward()
    with torch.no_grad():
        for v in eparams.values():
            v -= 0.1 * v.grad
    out["moe"] = [float(eloss.detach())]
    _finite(*out["moe"])
    # the quantized-wire ring allreduce over the world
    xs = np.random.default_rng(3).standard_normal(
        (n, DRYRUN_WIRE_N)).astype(np.float32)
    mine = torch.from_numpy(xs[rank]).to(device)
    for wire in ("bf16", "int8"):
        got = C.allreduce(mine, None, SUM, method="ring", wire=wire)
        out[f"wire_{wire}"] = got.cpu().numpy().tobytes().hex()
    return out


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> None:
    """One training step of each parallelism family over ``n_devices``
    processes, one a card (``device="cpu"``: gloo on the CPU), tiny
    shapes, in ``__graft_entry__.py``'s order: the transformer over (dp,
    tp, sp) (two steps), the MLP over (dp, tp), the pipeline over pp, the
    switch MoE over ep, and the ring allreduce through the bf16 and int8
    wires, within 2e-2 * sqrt(p) of the dense sum and the same bits on
    every rank. Prints a line a family; raises if any fails."""
    from .tools import run_world
    dev_type = resolve_device(device).type
    ranks = run_world(_dryrun_rank, n_devices, dev_type)
    lead = ranks[0]
    for r, got in enumerate(ranks):
        for fam in ("transformer", "mlp", "pipeline", "moe"):
            if not np.allclose(got[fam], lead[fam], rtol=1e-6, atol=1e-6):
                raise RuntimeError(f"dryrun {fam}: rank {r} loss {got[fam]} "
                                   f"!= rank 0 {lead[fam]}")
    dp, tp, sp = _axis_factors(n_devices)
    t0, t1 = lead["transformer"]
    print(f"dryrun transformer ok: mesh=({dp}x{tp}x{sp}) loss {t0:.4f} -> "
          f"{t1:.4f}")
    tp2 = 2 if n_devices % 2 == 0 else 1
    m0, m1 = lead["mlp"]
    print(f"dryrun mlp ok: mesh=({n_devices // tp2}x{tp2}) loss {m0:.4f} -> "
          f"{m1:.4f}")
    print(f"dryrun pipeline ok: pp={n_devices} loss "
          f"{lead['pipeline'][0]:.4f}")
    print(f"dryrun moe ok: ep={n_devices} loss {lead['moe'][0]:.4f}")
    xs = np.random.default_rng(3).standard_normal(
        (n_devices, DRYRUN_WIRE_N)).astype(np.float32)
    want = xs.sum(axis=0)
    for wire in ("bf16", "int8"):
        got = np.frombuffer(bytes.fromhex(lead[f"wire_{wire}"]), np.float32)
        rel = float(np.abs(got - want).max() / np.abs(want).max())
        # quantization error grows about as sqrt(p) over the p - 1 hops
        if not rel < 2e-2 * np.sqrt(n_devices):
            raise RuntimeError(f"dryrun wire {wire}: relative error {rel}")
        for r, other in enumerate(ranks[1:], 1):
            if other[f"wire_{wire}"] != lead[f"wire_{wire}"]:
                raise RuntimeError(f"dryrun wire {wire}: rank {r} differs "
                                   f"from rank 0")
    print(f"dryrun quantized wire ok: bf16+int8 over {n_devices} devices")


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--dryrun", type=int, default=None, metavar="N",
                    help="dryrun_multichip over N processes, one a card")
    ap.add_argument("--device", default=None,
                    help="'cpu' for gloo on the CPU; the card by default")
    args = ap.parse_args(argv)
    if args.dryrun is not None:
        dryrun_multichip(args.dryrun, args.device)
        return 0
    out = train_flagship(device=args.device)
    print(f"{out['device']}: loss {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f}; median step "
          f"{float(np.median(out['step_ms'][1:])):.3f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
