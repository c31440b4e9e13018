"""Expert parallelism over an ``ep`` axis: the port of
``rabit_tpu/parallel/moe.py``.

Switch-style (top-1) mixture of experts with one expert a rank. Routing
is JAX's dense formulation: one-hot dispatch and weighted combine tensors
with a fixed per-expert capacity, and the only traffic between ranks is
two tiled all-to-alls (``collectives.all_to_all``): tokens out to their
expert, results back. Gradients flow through the combine weights, the
experts and the router.

Replicated pieces keep JAX's gradient: ``aux`` (a ``pmean``) is summed
with an identity backward (every rank computes the same loss from it),
and the router, a replicated parameter, enters with ``ident_psum_grad``,
so its gradient is summed over the group as JAX sums a ``P()`` input's.
``init_moe_params`` draws from a numpy seed (it cannot reproduce
``jax.random``); the JAX package's parameters reach a rank through
``convert.moe_params_from_jax``.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..convert import moe_params_from_jax
from .collectives import all_to_all, ident_psum_grad, psum_identity_grad
from .mesh import Mesh, refuse_tf32

Tensor = torch.Tensor
Params = Dict[str, Tensor]


def init_moe_params(seed: int, d_model: int, d_ff: int, n_experts: int,
                    dtype=np.float32) -> Dict[str, np.ndarray]:
    """Router [d_model, e] and the experts' FFN weights, stacked
    [e, d_model, d_ff] and [e, d_ff, d_model], in numpy from
    ``default_rng(seed)`` at JAX's scales (normal / sqrt(fan in))."""
    rng = np.random.default_rng(seed)
    s1, s2 = 1.0 / np.sqrt(d_model), 1.0 / np.sqrt(d_ff)
    return {
        "router": (rng.standard_normal((d_model, n_experts)) * s1
                   ).astype(dtype),
        "w_in": (rng.standard_normal((n_experts, d_model, d_ff)) * s1
                 ).astype(dtype),
        "w_out": (rng.standard_normal((n_experts, d_ff, d_model)) * s2
                  ).astype(dtype),
    }


def moe_param_specs(axis: str) -> Dict[str, Optional[str]]:
    """The axis each parameter's first dimension is sharded over (None:
    replicated), JAX's ``{"router": P(), "w_in": P(axis), "w_out":
    P(axis)}``."""
    return {"router": None, "w_in": axis, "w_out": axis}


def _dispatch_combine(gates: Tensor, capacity: int
                      ) -> Tuple[Tensor, Tensor]:
    """One-hot dispatch and weighted combine, [n, e, c] each
    (``moe.py:55-76``): token i goes to expert argmax(gates[i]) (a tie to
    the first) at the slot of its order of arrival among that expert's
    tokens; tokens beyond ``capacity`` are dropped."""
    n, e = gates.shape
    onehot = F.one_hot(gates.argmax(dim=-1), e).to(gates.dtype)   # [n, e]
    pos = torch.cumsum(onehot, dim=0) * onehot - 1.0         # slot a token
    keep = (pos >= 0) & (pos < capacity)
    slot = pos.clamp(0, capacity - 1).long()
    dispatch = (F.one_hot(slot, capacity).to(gates.dtype)
                * keep[..., None].to(gates.dtype))           # [n, e, c]
    gate = (gates * onehot).sum(dim=-1, keepdim=True)        # [n, 1]
    return dispatch, dispatch * gate[..., None]


def moe_ffn(params: Mapping[str, Tensor], x: Tensor,
            group: Optional[dist.ProcessGroup] = None,
            capacity_factor: float = 2.0) -> Tuple[Tensor, Tensor]:
    """The per-shard switch-MoE FFN over ``group`` (one expert a rank):
    this rank's tokens x [n_loc, d] -> (y [n_loc, d], aux). ``params``
    holds the whole router and this rank's expert at index 0 of
    ``w_in``/``w_out``. ``aux`` is the Switch load-balancing loss (the
    group's mean of e * sum(fraction routed x mean gate)), the same on
    every rank (``moe.py:79-128``)."""
    p = 1 if group is None else dist.get_world_size(group)
    n_loc = x.shape[0]
    router = params["router"]
    if router.shape[-1] != p:
        raise ValueError(
            f"moe_ffn requires one expert per rank: n_experts "
            f"{router.shape[-1]} != axis size {p} (the tiled all_to_all "
            f"layout interleaves expert slots otherwise)")
    if p > 1:
        router = ident_psum_grad(router, group)
    gates = torch.softmax((x @ router).float(), dim=-1)     # [n, e]
    capacity = int(np.ceil(n_loc * capacity_factor / max(p, 1)))
    dispatch, combine = _dispatch_combine(gates, capacity)

    # Switch eq. 4: e * sum_e(fraction of tokens x mean gate mass)
    e = gates.shape[-1]
    frac_tokens = F.one_hot(gates.argmax(dim=-1), e).to(gates.dtype).mean(0)
    aux = e * (frac_tokens * gates.mean(dim=0)).sum()
    if p > 1:
        aux = psum_identity_grad(aux, group) / p

    # tokens -> their expert's slots [e, c, d]; the exchange leaves this
    # rank its expert's slots from every source rank, [p, c, d]
    expert_in = torch.einsum("nec,nd->ecd", dispatch, x.float())
    if p > 1:
        expert_in = all_to_all(expert_in, group, 0, 0)
    # jax.nn.gelu is the tanh approximation by default
    h = F.gelu(expert_in.to(x.dtype) @ params["w_in"][0],
               approximate="tanh")
    y = h @ params["w_out"][0]
    if p > 1:
        y = all_to_all(y, group, 0, 0)   # dim 0 the expert axis again
    out = torch.einsum("nec,ecd->nd", combine, y.float())
    return out.to(x.dtype), aux


def moe_reference(params: Mapping[str, Tensor], x: Tensor) -> Tensor:
    """The dense single-device oracle: every token through its argmax
    expert, weighted by its gate, nothing dropped (``params`` whole)."""
    gates = torch.softmax((x @ params["router"]).float(), dim=-1)
    expert = gates.argmax(dim=-1)
    gate = gates.gather(1, expert[:, None])
    h = F.gelu(torch.einsum("nd,ndf->nf", x, params["w_in"][expert]),
               approximate="tanh")
    y = torch.einsum("nf,nfd->nd", h, params["w_out"][expert])
    return (y * gate).to(x.dtype)


def make_moe_fn(mesh: Mesh, axis: Optional[str] = None,
                capacity_factor: float = 2.0):
    """``fn(params, x) -> (y, aux)`` over ``axis`` of ``mesh`` (by default
    its first axis): ``params`` this rank's shard (``place_moe_params``),
    ``x`` this rank's [n_loc, d] block of the tokens, ``y`` its block of
    the result, ``aux`` the same on every rank. TF32 products raise
    (``refuse_tf32``)."""
    if axis is None:
        axis = mesh.axes[0]
    group = mesh.group(axis)
    refuse_tf32("the MoE")

    def fn(params: Mapping[str, Tensor], x: Tensor) -> Tuple[Tensor, Tensor]:
        return moe_ffn(params, x, group, capacity_factor)

    return fn


def place_moe_params(mesh: Mesh, params: Mapping[str, np.ndarray],
                     axis: Optional[str] = None) -> Params:
    """This rank's shard of the whole parameters (numpy, JAX's layout) on
    the mesh's device, as leaf tensors that take gradients: the router
    whole, its rows of the experts."""
    if axis is None:
        axis = mesh.axes[0]
    local = moe_params_from_jax(params, mesh.index(axis), mesh.size(axis),
                                mesh.device)
    return {k: v.requires_grad_() for k, v in local.items()}
