"""Collectives over a ``torch.distributed`` process group.

The port of the unquantized, ungrouped schedules of
``rabit_tpu/parallel/collectives.py``. Each function runs in every rank of
``group`` (``None`` is the default group) on this rank's own tensor, where
the JAX versions run per shard inside ``shard_map`` over a mesh axis:

* ``tree_allreduce`` — the library's reduction (``dist.all_reduce``), the
  latency-optimal schedule; BITOR, which NCCL lacks, is an all-gather and
  a local fold, as in the JAX version.
* ``ring_reduce_scatter`` / ``ring_all_gather`` / ``ring_allreduce`` —
  the bandwidth-optimal ring as explicit point-to-point exchanges
  (``dist.batch_isend_irecv``) with the JAX ring's chunk offsets, so rank
  i owns chunk i and float sums are taken in the JAX ring's order.
* ``bcast_from_root`` and ``shard_over``.
* ``psum_identity_grad`` / ``ident_psum_grad`` (Megatron's conjugate
  pair) and ``ring_shift`` (one differentiable ring rotation): autograd
  Functions for the transformer's tensor- and sequence-parallel regions.

Unsigned payloads: PyTorch's uint16/32/64 support few operations and no
backend reduces them, so they travel as the signed type of the same
width. SUM and BITOR give the same bits that way; for MAX and MIN the sign
bit is flipped first (which maps unsigned order onto signed order) and
flipped back after.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..convert import tensor_from_numpy
from ..ops.reducers import BITOR, MAX, MIN, OP_NAMES, SUM, torch_reduce_fn

_REDUCE_OPS = {SUM: dist.ReduceOp.SUM, MAX: dist.ReduceOp.MAX,
               MIN: dist.ReduceOp.MIN}
_SIGNED_OF = {torch.uint16: torch.int16, torch.uint32: torch.int32,
              torch.uint64: torch.int64}


def _as_reducible(x: torch.Tensor, op: int
                  ) -> Tuple[torch.Tensor, Callable[[torch.Tensor],
                                                    torch.Tensor]]:
    """``x`` in a dtype every backend reduces, and the map back."""
    signed = _SIGNED_OF.get(x.dtype)
    if signed is None:
        return x, lambda y: y
    unsigned = x.dtype
    if op in (MAX, MIN):
        flip = torch.iinfo(signed).min
        return (x.view(signed) ^ flip,
                lambda y: (y ^ flip).view(unsigned))
    return x.view(signed), lambda y: y.view(unsigned)


def _ring_peers(group) -> Tuple[int, int, int, int]:
    """(p, this rank's index, global rank of next, global rank of prev)."""
    p = dist.get_world_size(group)
    idx = dist.get_rank(group)
    g = group if group is not None else dist.group.WORLD
    return (p, idx, dist.get_global_rank(g, (idx + 1) % p),
            dist.get_global_rank(g, (idx - 1) % p))


def _exchange(send: torch.Tensor, recv: torch.Tensor, to: int, frm: int,
              group) -> None:
    """Send ``send`` to the next rank while receiving into ``recv`` from
    the previous one (one ppermute step of the JAX ring)."""
    reqs = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, send, to, group),
        dist.P2POp(dist.irecv, recv, frm, group)])
    for r in reqs:
        r.wait()


def tree_allreduce(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
                   op: int = SUM) -> torch.Tensor:
    """Latency-optimal allreduce: the backend's own reduction
    (TryAllreduceTree equivalent, allreduce_base.cc:475-640). Returns a
    new tensor; ``x`` is left as it was."""
    if op not in OP_NAMES:
        raise ValueError(f"unknown op {op}")
    y, back = _as_reducible(x.contiguous(), op)
    if op == BITOR:
        parts = [torch.empty_like(y)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, y, group=group)
        return back(functools.reduce(torch.bitwise_or, parts))
    y = y.clone()
    dist.all_reduce(y, op=_REDUCE_OPS[op], group=group)
    return back(y)


def _ring_rs(x: torch.Tensor, group, op: int) -> torch.Tensor:
    p, idx, nxt, prv = _ring_peers(group)
    combine = torch_reduce_fn(op)
    chunks = x.reshape(p, -1).clone()
    got = torch.empty_like(chunks[0])
    # Schedule: at step s, send chunk (idx-s-1) mod p (accumulated so
    # far), receive into chunk (idx-s-2) mod p; after p-1 steps rank i
    # owns chunk i (collectives.py:268-281 of the JAX package).
    for step in range(p - 1):
        send_i = (idx - step - 1) % p
        recv_i = (idx - step - 2) % p
        _exchange(chunks[send_i], got, nxt, prv, group)
        chunks[recv_i] = combine(chunks[recv_i], got)
    return chunks[idx].clone()


def _ring_ag(x: torch.Tensor, group) -> torch.Tensor:
    p, idx, nxt, prv = _ring_peers(group)
    out = torch.empty((p,) + tuple(x.shape), dtype=x.dtype, device=x.device)
    out[idx] = x
    for step in range(p - 1):
        send_i = (idx - step) % p
        recv_i = (idx - step - 1) % p
        _exchange(out[send_i], out[recv_i], nxt, prv, group)
    return out.reshape((p * x.shape[0],) + tuple(x.shape[1:]))


def ring_reduce_scatter(x: torch.Tensor,
                        group: Optional[dist.ProcessGroup] = None,
                        op: int = SUM) -> torch.Tensor:
    """Ring reduce-scatter: every rank contributes ``x`` (length n,
    divisible by the group size p) and ends owning chunk ``rank`` (length
    n/p) fully reduced, after p-1 exchanges of n/p elements each
    (allreduce_base.cc:829-918)."""
    if x.dim() != 1:
        raise ValueError(f"ring_reduce_scatter takes a 1-D tensor, got "
                         f"shape {tuple(x.shape)}; flatten first")
    if op not in OP_NAMES:
        raise ValueError(f"unknown op {op}")
    p = dist.get_world_size(group)
    if x.shape[0] % p:
        raise ValueError(f"ring_reduce_scatter length {x.shape[0]} does "
                         f"not divide by the group size {p}")
    if p == 1:
        return x
    y, back = _as_reducible(x.contiguous(), op)
    return back(_ring_rs(y, group, op))


def ring_all_gather(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None
                    ) -> torch.Tensor:
    """Ring all-gather: rank i contributes chunk ``x`` (length m) and all
    ranks end with the concatenation [p*m] in rank order
    (TryAllgatherRing, allreduce_base.cc:751-815)."""
    if dist.get_world_size(group) == 1:
        return x
    y, back = _as_reducible(x.contiguous(), SUM)
    return back(_ring_ag(y, group))


def _pad_to_multiple(x: torch.Tensor, p: int) -> Tuple[torch.Tensor, int]:
    n = x.shape[0]
    rem = (-n) % p
    if rem:
        x = torch.cat([x, x.new_zeros((rem,) + tuple(x.shape[1:]))])
    return x, n


def ring_allreduce(x: torch.Tensor, group: Optional[dist.ProcessGroup] = None,
                   op: int = SUM) -> torch.Tensor:
    """Ring allreduce = reduce-scatter + all-gather (TryAllreduceRing,
    allreduce_base.cc:930-949). A length not divisible by p is padded with
    zeros, which are sliced off again (for MAX/MIN the padding is reduced
    but never returned)."""
    if x.dim() != 1:
        raise ValueError(
            f"ring_allreduce takes a 1-D tensor, got shape "
            f"{tuple(x.shape)}; flatten first")
    if op not in OP_NAMES:
        raise ValueError(f"unknown op {op}")
    p = dist.get_world_size(group)
    if p == 1:
        return x
    y, back = _as_reducible(x.contiguous(), op)
    yp, n = _pad_to_multiple(y, p)
    return back(_ring_ag(_ring_rs(yp, group, op), group)[:n])


def bcast_from_root(x: torch.Tensor,
                    group: Optional[dist.ProcessGroup] = None,
                    root: int = 0) -> torch.Tensor:
    """Every rank gets rank ``root``'s ``x`` (TryBroadcast,
    allreduce_base.cc:649-737). ``root`` is a rank of ``group``."""
    g = group if group is not None else dist.group.WORLD
    y, back = _as_reducible(x.contiguous(), SUM)
    y = y.clone()
    dist.broadcast(y, src=dist.get_global_rank(g, root), group=group)
    return back(y)


def shard_over(xs: np.ndarray, rank: int,
               device: torch.device) -> torch.Tensor:
    """Row ``rank`` of a host array [p, ...] as this rank's tensor on
    ``device`` — the 'each rank contributes a slice' layout (what
    ``shard_over`` places across a mesh in the JAX package)."""
    if not 0 <= rank < xs.shape[0]:
        raise ValueError(f"rank {rank} out of range for {xs.shape[0]} rows")
    return tensor_from_numpy(xs[rank]).to(device)


# ---------------------------------------------------------------------------
# Differentiable pieces for the model-parallel regions of the transformer.
# torch tracks no varying-manual axes, so the port always uses the explicit
# conjugate pair (the formulation of JAX's unchecked shard_map): each
# function's backward is written out, not derived.
# ---------------------------------------------------------------------------

class _PsumIdentityGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return tree_allreduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _IdentPsumGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return tree_allreduce(g, ctx.group), None


def psum_identity_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Sum over ``group`` whose backward is the identity: where partial
    results leave a tensor-parallel region (Megatron's g). The port of
    ``rabit_tpu/parallel/collectives.py::psum_identity_grad``."""
    if dist.get_world_size(group) == 1:
        return x
    return _PsumIdentityGrad.apply(x, group)


def ident_psum_grad(x: torch.Tensor, group) -> torch.Tensor:
    """Identity whose backward sums the gradient over ``group``: where a
    replicated activation enters a tensor-parallel region (Megatron's f),
    so every shard's upstream gradient comes out complete. The port of
    ``ident_psum_grad``."""
    if dist.get_world_size(group) == 1:
        return x
    return _IdentPsumGrad.apply(x, group)


class _RingShift(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        _, _, nxt, prv = _ring_peers(group)
        x = x.contiguous()
        out = torch.empty_like(x)
        _exchange(x, out, nxt, prv, group)
        return out

    @staticmethod
    def backward(ctx, g):
        # the transpose of a rotation to the next rank: to the previous one
        _, _, nxt, prv = _ring_peers(ctx.group)
        g = g.contiguous()
        out = torch.empty_like(g)
        _exchange(g, out, prv, nxt, ctx.group)
        return out, None


def ring_shift(x: torch.Tensor, group) -> torch.Tensor:
    """Rank i's ``x`` to rank i+1 (mod p) of ``group``: one ``ppermute``
    step of the JAX ring, differentiable. The backward rotates the
    gradient to the previous rank; ``batch_isend_irecv`` alone has no
    autograd and would leave K/V without gradients across ranks."""
    if dist.get_world_size(group) == 1:
        return x
    return _RingShift.apply(x, group)
