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

Both run on the card unless ``device="cpu"`` is asked for.

    python -m rabit_tpu_torch.entry        # train_flagship on the card
"""

from __future__ import annotations

import time
from typing import Dict, List, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .models import transformer as tf
from .parallel.mesh import DeviceLike, make_mesh, resolve_device

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
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("train_flagship holds its f32 projections to "
                           "f32: set torch.backends.cuda.matmul.allow_tf32 "
                           "= False")
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


if __name__ == "__main__":
    out = train_flagship()
    print(f"{out['device']}: loss {out['losses'][0]:.4f} -> "
          f"{out['losses'][-1]:.4f}; median step "
          f"{float(np.median(out['step_ms'][1:])):.3f} ms")
