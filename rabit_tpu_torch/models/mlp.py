"""An MLP classifier trained with a hand-sharded step over a (dp, tp)
mesh: the port of ``rabit_tpu/models/mlp.py``.

- **tp**: the hidden axis is sharded (w1 and b1 by column, w2 by row);
  the partial products of the output layer are summed with
  ``psum_identity_grad``.
- **dp**: the batch is sharded; the gradients are summed over the dp
  group and divided by dp: leaf by leaf with ``tree_allreduce``
  (``"psum"``) or the ported ``ring_allreduce`` (``"ring"``), or as one
  flat buffer a dtype through ``bucket_allreduce`` (``"bucket"``), and
  with ``RABIT_ASYNC_COLLECTIVES`` on, the overlapped bucket step.

It runs on the port's (dp, tp, sp) ``Mesh`` with sp = 1.

The products keep the JAX package's contract, bf16 in and f32
accumulation: ``x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()``.
A product of two bf16 values is exact in f32 and the sum runs in f32, as
``jnp.dot(..., preferred_element_type=jnp.float32)`` does; ``torch.matmul``
of bf16 tensors would round its output to bf16. Autograd through the two
casts rounds each operand's cotangent to bf16 where JAX's dot transpose
does (its ``preferred_element_type`` is the operand's dtype). On the card
TF32 would run those f32 products on the tensor cores in another order
and precision than the contract's, so the train step refuses to run with
``torch.backends.cuda.matmul.allow_tf32`` on, as
``entry.train_flagship`` does. The products are ``torch.matmul``: the JAX MLP
computes them outside any Pallas kernel.

Parameters live in an ``MLP`` module whose parameter names are the JAX
dict's keys (``w1``, ``b1``, ``w2``, ``b2``) with the JAX layouts;
``init_params`` draws the full dict in numpy from a seed (it cannot
reproduce ``jax.random``), so a test can hand the same weights to both
packages.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import mlp_params_from_jax
from ..ops.reducers import SUM
from ..parallel.collectives import (
    async_enabled, bucket_allreduce, grad_buckets_async, psum_identity_grad,
    ring_allreduce, tree_allreduce)
from ..parallel.mesh import DeviceLike, Mesh

Tensor = torch.Tensor
Params = Mapping[str, Tensor]
GRAD_SYNCS = ("psum", "ring", "bucket")


def init_params(seed: int = 0, in_dim: int = 256, hidden: int = 512,
                out_dim: int = 128) -> Dict[str, np.ndarray]:
    """The full f32 parameter dict in the JAX layout, drawn from
    ``numpy.random.default_rng(seed)``: He-normal weights, zero biases."""
    rng = np.random.default_rng(seed)
    s1, s2 = (2.0 / in_dim) ** 0.5, (2.0 / hidden) ** 0.5
    return {
        "w1": (rng.standard_normal((in_dim, hidden)) * s1).astype(np.float32),
        "b1": np.zeros((hidden,), np.float32),
        "w2": (rng.standard_normal((hidden, out_dim)) * s2).astype(
            np.float32),
        "b2": np.zeros((out_dim,), np.float32),
    }


def param_specs() -> Dict[str, Optional[int]]:
    """The axis each parameter is sharded on over tp (None: replicated):
    the hidden axis of w1, b1 and w2."""
    return {"w1": 1, "b1": 0, "w2": 0, "b2": None}


class MLP(nn.Module):
    """The parameters, one ``nn.Parameter`` per JAX key."""

    def __init__(self, state: Mapping[str, Tensor]):
        super().__init__()
        for name, value in state.items():
            self.register_parameter(name, nn.Parameter(value))

    def params(self) -> Dict[str, Tensor]:
        return dict(self.named_parameters())


ParamsLike = Union[MLP, Params]


def _as_params(params: ParamsLike) -> Params:
    return params.params() if isinstance(params, MLP) else params


def _dot(x: Tensor, w: Tensor) -> Tensor:
    """bf16 in, f32 out: exact products of the bf16-rounded operands,
    summed in f32."""
    return x.to(torch.bfloat16).float() @ w.to(torch.bfloat16).float()


def forward(params: ParamsLike, x: Tensor) -> Tensor:
    """The plain (unsharded) forward: [B, in] -> logits [B, out]."""
    p = _as_params(params)
    h = F.relu(_dot(x, p["w1"]) + p["b1"])
    return _dot(h, p["w2"]) + p["b2"]


def _nll(logits: Tensor, y: Tensor) -> Tensor:
    logp = F.log_softmax(logits, dim=-1)
    return -logp.gather(1, y[:, None]).mean()


def _local_loss(params: ParamsLike, x: Tensor, y: Tensor, tp_group
                ) -> Tensor:
    """This rank's loss: ``x`` its dp shard of the batch, the parameters
    its tp shards; the output layer's partial products are summed over
    tp with an identity backward."""
    p = _as_params(params)
    h = F.relu(_dot(x, p["w1"]) + p["b1"])
    logits = psum_identity_grad(_dot(h, p["w2"]), tp_group) + p["b2"]
    return _nll(logits, y)


def _sum_over(x: Tensor, group) -> Tensor:
    return x if torch.distributed.get_world_size(group) == 1 \
        else tree_allreduce(x, group)


def _check_mesh(mesh: Mesh) -> None:
    if mesh.size("sp") != 1:
        raise ValueError(f"the MLP runs on a (dp, tp) mesh: sp must be 1, "
                         f"the mesh is {mesh.shape}")
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("the MLP holds its products to bf16 operands "
                           "summed in f32: set "
                           "torch.backends.cuda.matmul.allow_tf32 = False")


def make_train_step(mesh: Mesh, lr: float = 0.1, grad_sync: str = "psum"):
    """The SGD step over the (dp, tp) mesh: ``step(model, x, y) -> loss``,
    ``x`` [B_loc, in] and ``y`` [B_loc] this rank's shard of the batch. It
    updates ``model`` in place (JAX's step returns new params) and returns
    the mean of the dp shards' losses. The gradients are summed over dp
    and divided by dp (``"psum"``, ``"ring"``, ``"bucket"``: see the
    module); with ``async_enabled()``, ``"bucket"`` gives the overlapped
    step, equal to the sync bucket step bit for bit."""
    if grad_sync not in GRAD_SYNCS:
        raise ValueError(f"grad_sync must be one of {GRAD_SYNCS}, got "
                         f"{grad_sync!r}")
    _check_mesh(mesh)
    if grad_sync == "bucket" and async_enabled():
        return _make_async_bucket_step(mesh, lr)
    dp_group, tp_group = mesh.group("dp"), mesh.group("tp")
    dp = mesh.size("dp")

    def sync(g: Tensor) -> Tensor:
        if grad_sync == "ring":
            return ring_allreduce(g.reshape(-1), dp_group).reshape(
                g.shape) / dp
        return _sum_over(g, dp_group) / dp

    def step(model: MLP, x: Tensor, y: Tensor) -> Tensor:
        model.zero_grad(set_to_none=True)
        loss = _local_loss(model, x, y, tp_group)
        loss.backward()
        with torch.no_grad():
            params = model.params()
            if grad_sync == "bucket":
                red = bucket_allreduce({k: p.grad for k, p in params.items()},
                                       dp_group, SUM, method="ring")
                grads = {k: g / dp for k, g in red.items()}
            else:
                grads = {k: sync(p.grad) for k, p in params.items()}
            for k, p in params.items():
                p.sub_(lr * grads[k])
        model.zero_grad(set_to_none=True)
        return _sum_over(loss.detach().reshape(1), dp_group)[0] / dp

    return step


def _make_async_bucket_step(mesh: Mesh, lr: float):
    """The overlapped bucketed step (``mlp.py:139`` of the JAX package):
    the gradients in one flat buffer a dtype in sorted-key order, each
    buffer's dp ring issued in reverse bucket order
    (``grad_buckets_async``), the parameters updated in place from the
    handles' values, then every handle waited on. Same order, ring and
    division as the sync ``"bucket"`` step, so the same bits."""
    dp_group, tp_group = mesh.group("dp"), mesh.group("tp")
    dp = mesh.size("dp")

    def step(model: MLP, x: Tensor, y: Tensor) -> Tensor:
        model.zero_grad(set_to_none=True)
        loss = _local_loss(model, x, y, tp_group)
        loss.backward()
        loss = _sum_over(loss.detach().reshape(1), dp_group)[0] / dp
        with torch.no_grad():
            params = model.params()
            issued = grad_buckets_async(
                {k: p.grad for k, p in params.items()}, dp_group)
            for names, h in issued:
                flat, off = h.value, 0
                for k in names:
                    p = params[k]
                    g = flat[off:off + p.numel()].view_as(p) / dp
                    p.sub_(lr * g)
                    off += p.numel()
            for _, h in issued:
                h.wait()
        model.zero_grad(set_to_none=True)
        return loss

    return step


def model_on(params: Mapping[str, np.ndarray], device: DeviceLike = None,
             tp_rank: int = 0, tp: int = 1) -> MLP:
    """An ``MLP`` of the JAX-layout numpy ``params`` (its tp shard) on
    ``device`` (the card by default)."""
    return MLP(mlp_params_from_jax(params, tp_rank, tp, device))


def make_sharded_inputs(mesh: Mesh, batch: int = 64, in_dim: int = 256,
                        hidden: int = 512, out_dim: int = 128, seed: int = 0
                        ) -> Tuple[MLP, Tensor, Tensor]:
    """This rank's model (its tp shards of ``init_params(seed)``) and its
    dp shard of a random batch, on the mesh's device. The batch is drawn
    as the JAX package's ``make_sharded_inputs`` draws it (x standard
    normal [batch, in_dim], y integers below out_dim, from
    ``default_rng(seed)``)."""
    _check_mesh(mesh)
    dp = mesh.size("dp")
    if batch % dp:
        raise ValueError(f"batch {batch} does not divide over dp={dp}")
    model = model_on(init_params(seed, in_dim, hidden, out_dim), mesh.device,
                     mesh.index("tp"), mesh.size("tp"))
    npr = np.random.default_rng(seed)
    x = npr.standard_normal((batch, in_dim)).astype(np.float32)
    y = npr.integers(0, out_dim, size=(batch,)).astype(np.int64)
    rows = slice(mesh.index("dp") * batch // dp,
                 (mesh.index("dp") + 1) * batch // dp)
    return (model, torch.from_numpy(x[rows].copy()).to(mesh.device),
            torch.from_numpy(y[rows].copy()).to(mesh.device))


def reference_train_step(params: ParamsLike, x: Tensor, y: Tensor,
                         lr: float = 0.1) -> Tuple[Dict[str, Tensor], Tensor]:
    """The single-device step the sharded step is checked against:
    ``(new params, loss)`` from the full parameters and batch."""
    p = {k: v.detach().clone().requires_grad_(True)
         for k, v in _as_params(params).items()}
    loss = _nll(forward(p, x), y)
    loss.backward()
    with torch.no_grad():
        return {k: v - lr * v.grad for k, v in p.items()}, loss.detach()
