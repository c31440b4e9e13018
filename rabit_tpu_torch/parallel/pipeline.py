"""Pipeline parallelism over a ``pp`` axis: the port of
``rabit_tpu/parallel/pipeline.py``.

GPipe-style microbatch pipelining. Each rank holds one stage's parameters
and runs the JAX schedule tick by tick: ``n_micro + p - 1`` ticks, at
tick t rank r computes microbatch ``t - r`` and hands its activation to
rank r + 1 with ``ring_shift``. Every rank computes and exchanges at every
tick, bubbles included, so every rank posts the same exchanges in the
same order; what a bubble computes is masked out of the result as in JAX,
by selections that keep every rank's autograd graph the same.
The last stage's outputs are replicated with ``psum_identity_grad``
(every rank then computes the same loss from them, so the backward is the
identity), and autograd through ``ring_shift`` runs the reverse pipeline.

The stage parameters keep JAX's host layout: ``stack_stage_params``
stacks per-stage dicts into leaves of [n_stages, ...], and
``place_pipeline_params`` gives this rank its rows (one stage: leaves of
[1, ...]) on the mesh's device.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from ..convert import pipeline_params_from_jax
from .collectives import psum_identity_grad, ring_shift
from .mesh import Mesh, refuse_tf32

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def pipeline_apply(stage_fn: Callable, stage_params, x_micro: Tensor,
                   group: Optional[dist.ProcessGroup] = None) -> Tensor:
    """Run microbatches through a p-stage pipeline over ``group`` (one
    stage a rank; ``None``: one stage, no process group).

    ``stage_fn(params, x) -> y`` is one stage (the activation's shape is
    the same at every stage); ``stage_params`` is this rank's stage;
    ``x_micro`` is [n_micro, mb, ...], the same on every rank (only rank 0
    reads it). Returns [n_micro, mb, ...], the last stage's outputs on
    every rank (``pipeline.py:33-78``)."""
    p = 1 if group is None else dist.get_world_size(group)
    n_micro = x_micro.shape[0]
    if p == 1:
        return torch.stack([stage_fn(stage_params, x) for x in x_micro])
    idx = dist.get_rank(group)
    # the masks are selections, not branches: every rank's graph has the
    # same nodes, so the backward runs the same exchanges in the same order
    # on every rank (the zero cotangents of the bubbles included)
    first = torch.tensor(idx == 0, device=x_micro.device)
    last = torch.tensor(idx == p - 1, device=x_micro.device)
    recv = torch.zeros_like(x_micro[0])
    outs = []
    for t in range(n_micro + p - 1):
        # stage 0 injects a fresh microbatch; the others take the hop
        inp = torch.where(first, x_micro[min(t, n_micro - 1)], recv)
        y = stage_fn(stage_params, inp)
        if t >= p - 1:   # microbatch t - (p - 1), if this is the last stage
            outs.append(y)
        recv = ring_shift(y, group)
    out = torch.stack(outs)
    # replicate the last stage's outputs to every rank
    return psum_identity_grad(torch.where(last, out, torch.zeros_like(out)),
                              group)


def stack_stage_params(params_list: Sequence[Mapping[str, np.ndarray]]
                       ) -> Dict[str, np.ndarray]:
    """Stack per-stage parameter dicts into [n_stages, ...] leaves (the
    host layout that ``place_pipeline_params`` shards one stage a
    rank)."""
    return {k: np.stack([np.asarray(prm[k]) for prm in params_list])
            for k in params_list[0]}


def make_pipeline_fn(mesh: Mesh, stage_fn: Callable,
                     axis: Optional[str] = None):
    """``fn(stage_params, x_micro) -> y_micro`` over ``axis`` of ``mesh``
    (by default its first axis): ``stage_params`` this rank's rows of the
    stacked parameters ([1, ...] leaves, as ``place_pipeline_params``
    gives them), ``x_micro`` [n_micro, mb, ...] the same on every rank.
    More than one stage a rank raises: a divisible mismatch would
    otherwise apply only some of the stages. TF32 products raise
    (``refuse_tf32``)."""
    if axis is None:
        axis = mesh.axes[0]
    pp, group = mesh.size(axis), mesh.group(axis)
    refuse_tf32("the pipeline")

    def fn(stage_params: Mapping[str, Tensor], x_micro: Tensor) -> Tensor:
        local = next(iter(stage_params.values())).shape[0]
        if local != 1:
            raise ValueError(
                f"one stage per rank: {local * pp} stages != axis "
                f"'{axis}' size {pp}")
        params = {k: a[0] for k, a in stage_params.items()}
        return pipeline_apply(stage_fn, params, x_micro, group)

    return fn


def place_pipeline_params(mesh: Mesh,
                          params_list: Sequence[Mapping[str, np.ndarray]],
                          axis: Optional[str] = None) -> Params:
    """Stack the per-stage parameters (numpy) and give this rank its rows
    over ``axis`` on the mesh's device, as leaf tensors that take
    gradients."""
    if axis is None:
        axis = mesh.axes[0]
    local = pipeline_params_from_jax(stack_stage_params(params_list),
                                     mesh.index(axis), mesh.size(axis),
                                     mesh.device)
    return {k: v.requires_grad_() for k, v in local.items()}
