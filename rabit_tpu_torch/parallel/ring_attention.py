"""Sequence parallelism: ring attention over a process group.

The port of ``rabit_tpu/parallel/ring_attention.py``. Each rank of the
sequence group holds its shard of the sequence; K/V blocks rotate around
the ring, one point-to-point exchange per step (``ring_shift``), and each
rank's queries accumulate an online softmax over every block through the
flash block step (``ops/flash.py::block_update``: the CUDA kernels for
CUDA tensors, the plain versions for CPU tensors).

Layouts are the JAX package's: q/k/v are [T, H, D], with any leading batch
dimensions. JAX ``vmap``s over the batch; the port folds the batch into
the heads, so [B, T, H, D] runs as one [B*H, T, D] block step under one
mask.

Not ported yet: ``ulysses_attention`` and ``sequence_parallel_attention``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.flash import NEG_INF, block_update
from .collectives import ring_shift

Tensor = torch.Tensor


def reference_attention(q: Tensor, k: Tensor, v: Tensor,
                        causal: bool = False,
                        sm_scale: Optional[float] = None) -> Tensor:
    """Dense attention, the oracle: q [..., T, H, D], k/v [..., S, H, D]
    -> [..., T, H, D], softmax in f32."""
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    scores = torch.einsum("...thd,...shd->...hts", q.float(),
                          k.float()) * sm_scale
    if causal:
        t, s = q.shape[-3], k.shape[-3]
        pos_q = torch.arange(t, device=q.device)
        pos_k = torch.arange(s, device=q.device)
        scores = scores.masked_fill(pos_k[None, :] > pos_q[:, None], NEG_INF)
    w = torch.softmax(scores, dim=-1)
    out = torch.einsum("...hts,...shd->...thd", w.to(v.dtype), v).float()
    return out.to(q.dtype)


def _heads_first(x: Tensor) -> Tensor:
    """[..., T, H, D] -> [prod(...) * H, T, D]."""
    t, h, d = x.shape[-3:]
    return x.movedim(-2, -3).reshape(-1, t, d)


def ring_attention(q: Tensor, k: Tensor, v: Tensor,
                   group: Optional[dist.ProcessGroup] = None,
                   causal: bool = False, sm_scale: Optional[float] = None
                   ) -> Tensor:
    """Blockwise ring attention over the sequence shards of ``group``.

    q/k/v are this rank's shard, [..., T_local, H, D], of a sequence of
    p * T_local laid out in rank order over ``group`` (``None``: one
    shard, no process group). Returns the local output [..., T_local, H,
    D]. Step 0 reduces the resident (diagonal) block; then p - 1 times
    K/V rotate to the next rank and the block that came from rank
    (idx - s) mod p is reduced, with the causal mask taken from global
    positions (``ring_attention.py:99-183``)."""
    p = 1 if group is None else dist.get_world_size(group)
    idx = 0 if group is None else dist.get_rank(group)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    lead, t = q.shape[:-3], q.shape[-3]
    h, d = q.shape[-2:]
    qh, kb, vb = _heads_first(q), _heads_first(k), _heads_first(v)
    pos = torch.arange(t, device=q.device)
    q_pos = idx * t + pos

    m = torch.full(qh.shape[:2], NEG_INF, dtype=torch.float32,
                   device=q.device)
    l = torch.zeros(qh.shape[:2], dtype=torch.float32, device=q.device)
    o = torch.zeros(qh.shape, dtype=torch.float32, device=q.device)

    def block(m, l, o, kb, vb, src):
        mask = None
        if causal:
            mask = (src * t + pos)[None, :] > q_pos[:, None]
        return block_update(qh, kb, vb, m, l, o, mask, sm_scale)

    # the resident block first: keeps causal accumulators finite
    m, l, o = block(m, l, o, kb, vb, idx)
    kv = torch.stack([kb, vb]) if p > 1 else None
    for s in range(1, p):
        # K and V travel as one tensor: one exchange a step, and one
        # autograd node, so every rank runs the backward exchanges in the
        # same order
        kv = ring_shift(kv, group)
        m, l, o = block(m, l, o, kv[0], kv[1], (idx - s) % p)
    out = o / l[..., None]
    return out.reshape(*lead, h, t, d).movedim(-3, -2).to(q.dtype)
