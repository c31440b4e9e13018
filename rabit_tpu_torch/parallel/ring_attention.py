"""Sequence parallelism: ring attention over a process group.

The port of ``rabit_tpu/parallel/ring_attention.py``. Each rank of the
sequence group holds its shard of the sequence; K/V blocks rotate around
the ring, one point-to-point exchange per step (``ring_shift``), and each
rank's queries accumulate an online softmax over every block through the
flash block step (``ops/flash.py::block_update``: the CUDA kernels for
CUDA tensors, the plain versions for CPU tensors).

``ulysses_attention`` re-shards from sequence- to head-parallel with the
tiled all-to-all (``collectives.all_to_all``), runs dense attention over
the whole sequence for H/p heads, and scatters back; the JAX version has
no Pallas kernel there, so its products stay torch products.
``sequence_parallel_attention`` is the wrapper over global [T, H, D]
arrays: each rank takes its block of the sequence, runs either scheme over
the axis's group and gathers the whole result, so every rank holds what
JAX's wrapper returns.

Layouts are the JAX package's: q/k/v are [T, H, D], with any leading batch
dimensions. JAX ``vmap``s over the batch; the port folds the batch into
the heads, so [B, T, H, D] runs as one [B*H, T, D] block step under one
mask.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..ops.flash import NEG_INF, block_update
from .collectives import all_to_all, gather_along, ring_shift, shard_along
from .mesh import Mesh, refuse_tf32

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
    # w rounds to v's dtype, the product sums in f32, one cast at the end
    out = torch.einsum("...hts,...shd->...thd", w.to(v.dtype).float(),
                       v.float())
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


def ulysses_attention(q: Tensor, k: Tensor, v: Tensor,
                      group: Optional[dist.ProcessGroup] = None,
                      causal: bool = False, sm_scale: Optional[float] = None
                      ) -> Tensor:
    """All-to-all (DeepSpeed-Ulysses) sequence parallelism over ``group``
    (``ring_attention.py:186-214``): this rank's [..., T_local, H, D] with
    H divisible by p becomes [..., p * T_local, H/p, D] by one tiled
    all-to-all each, dense ``reference_attention`` runs over the whole
    sequence for its H/p heads, and one all-to-all scatters the result
    back to [..., T_local, H, D]. At p = 1 it is ``reference_attention``.
    """
    p = 1 if group is None else dist.get_world_size(group)
    if p == 1:
        return reference_attention(q, k, v, causal, sm_scale)
    h = q.shape[-2]
    if h % p:
        raise ValueError(f"heads {h} not divisible by axis size {p}")

    def to_headpar(x):   # [..., T, H, D] -> [..., p*T, H/p, D]
        return all_to_all(x, group, split_axis=-2, concat_axis=-3)

    out = reference_attention(to_headpar(q), to_headpar(k), to_headpar(v),
                              causal, sm_scale)
    return all_to_all(out, group, split_axis=-3, concat_axis=-2)


IMPLS = ("ring", "ulysses")


def sequence_parallel_attention(q: Tensor, k: Tensor, v: Tensor, mesh: Mesh,
                                causal: bool = False,
                                axis: Optional[str] = None,
                                impl: str = "ring",
                                use_pallas: bool = False) -> Tensor:
    """Attention over global [T, H, D] arrays (any leading batch
    dimensions), the sequence sharded over ``axis`` of ``mesh`` (by
    default its first axis; T divisible by the axis size): the port of
    ``ring_attention.py:236-262``. Every rank passes the same global q, k,
    v, computes its block of the sequence by ``impl`` (``"ring"``, the
    K/V rotation through the flash block step, or ``"ulysses"``, the
    all-to-all head scatter; H divisible by the axis size) and returns the
    whole [T, H, D] result, the same on every rank. Gradients reach the
    global inputs whole on every rank.

    ``use_pallas`` is kept for JAX's signature and its refusal: in the
    port the ring's block step always runs ``ops/flash.py::block_update``
    (the CUDA kernels on CUDA tensors, their plain versions on CPU
    tensors), so it changes nothing there; with ``"ulysses"`` it raises
    as in JAX. TF32 products raise (``refuse_tf32``)."""
    if impl not in IMPLS:
        raise ValueError(f"impl must be 'ring' or 'ulysses', got {impl!r}")
    if use_pallas and impl != "ring":
        raise ValueError(
            "use_pallas applies only to impl='ring' (the Ulysses path has "
            "no Pallas kernel); drop use_pallas or use impl='ring'")
    if axis is None:
        axis = mesh.axes[0]
    psize = mesh.size(axis)
    t = q.shape[-3]
    if t % psize:
        raise ValueError(
            f"sequence length {t} not divisible by axis '{axis}' size "
            f"{psize}")
    refuse_tf32("sequence_parallel_attention")
    group = mesh.group(axis)
    q, k, v = (shard_along(x, group, -3) for x in (q, k, v))
    per_shard = ring_attention if impl == "ring" else ulysses_attention
    return gather_along(per_shard(q, k, v, group, causal), group, -3)
