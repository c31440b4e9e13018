"""The flagship long-context transformer LM, trained with a hand-sharded
step over a (dp, tp, sp) mesh: the port of
``rabit_tpu/models/transformer.py``.

- **dp**: the batch is sharded; gradients are summed over the dp group
  (``"psum"``: ``tree_allreduce``; ``"ring"``: the ported
  ``ring_allreduce``; ``"bucket"``: ``bucket_allreduce``, the whole
  gradient tree in one ring a dtype, and with ``RABIT_ASYNC_COLLECTIVES``
  on, the overlapped step that issues each bucket's ring with
  ``grad_bucket_allreduce_async``).
- **tp**: Megatron-style tensor parallelism. wq/wk/wv and w1 are
  column-sharded, wo and w2 row-sharded; partial results are combined
  with ``psum_identity_grad`` and replicated activations enter with
  ``ident_psum_grad`` (the conjugate pair, always: torch tracks no
  varying-manual axes, so this is JAX's unchecked formulation).
- **sp**: the sequence is sharded; attention runs as ring attention over
  the sp group, its block step through the flash kernels on the card.

Parameters live in a ``TransformerLM`` module whose parameter names are
the JAX dict's keys (``emb``, ``pos``, ``l0.wq``, ..., ``lnf``, ``head``)
with the JAX layouts: wq/wk/wv [E, H, D], wo [H, D, E], w1 [E, F],
w2 [F, E]. ``init_params`` makes the full parameter dict in numpy from a
seed (it cannot reproduce ``jax.random``), so a test can hand the same
weights to both packages. Its ``dtype`` knob (float32 or bfloat16, as
the JAX package's) rounds the f32 draw to bf16 to nearest even; a bf16
dict holds CPU ``torch.bfloat16`` tensors (numpy has no bf16 without
``ml_dtypes``). A bf16 model runs through the bf16 paths of both flash
kernels on the card, its forward and its train step alike; the step's
gradients come back bf16 and its SGD update stays in the parameters'
dtype.
"""

from __future__ import annotations

from typing import Callable, Dict, Mapping, Optional, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..convert import transformer_params_from_jax
from ..ops.reducers import SUM
from ..parallel.collectives import (
    async_enabled, bucket_allreduce, grad_buckets_async, ident_psum_grad,
    psum_identity_grad, ring_allreduce, tree_allreduce)
from ..parallel.mesh import DeviceLike, Mesh, refuse_tf32
from ..parallel.ring_attention import reference_attention, ring_attention

Tensor = torch.Tensor
Params = Mapping[str, Tensor]
GRAD_SYNCS = ("psum", "ring", "bucket")


_DTYPES = ("float32", "bfloat16")


def _dtype_name(dtype) -> str:
    """'float32' or 'bfloat16' for a torch dtype, a numpy (or
    ``ml_dtypes``) dtype or its name; anything else raises."""
    if isinstance(dtype, torch.dtype):
        name = str(dtype).rsplit(".", 1)[-1]
    elif isinstance(dtype, str):
        name = dtype
    else:
        name = np.dtype(dtype).name
    if name not in _DTYPES:
        raise ValueError(f"dtype must be one of {_DTYPES}, got {dtype!r}")
    return name


def init_params(seed: int = 0, vocab: int = 64, n_layers: int = 2,
                d_model: int = 32, n_heads: int = 4, d_head: int = 8,
                d_ff: int = 64, max_t: int = 128, dtype=np.float32
                ) -> Dict[str, Union[np.ndarray, Tensor]]:
    """The full (unsharded) parameter dict in the JAX layout, drawn in f32
    from ``numpy.random.default_rng(seed)``: normal / sqrt(fan in) for the
    matrices, ones for the layernorm scales. ``dtype`` float32 gives numpy
    arrays; bfloat16 gives the same draw rounded to nearest even (what
    ``.astype(bfloat16)`` does) as CPU ``torch.bfloat16`` tensors."""
    bf16 = _dtype_name(dtype) == "bfloat16"
    rng = np.random.default_rng(seed)

    def norm(shape, fan):
        return (rng.standard_normal(shape) / np.sqrt(fan)).astype(np.float32)

    p = {"emb": norm((vocab, d_model), d_model),
         "pos": norm((max_t, d_model), d_model)}
    for i in range(n_layers):
        p[f"l{i}.wq"] = norm((d_model, n_heads, d_head), d_model)
        p[f"l{i}.wk"] = norm((d_model, n_heads, d_head), d_model)
        p[f"l{i}.wv"] = norm((d_model, n_heads, d_head), d_model)
        p[f"l{i}.wo"] = norm((n_heads, d_head, d_model), n_heads * d_head)
        p[f"l{i}.w1"] = norm((d_model, d_ff), d_model)
        p[f"l{i}.w2"] = norm((d_ff, d_model), d_ff)
        p[f"l{i}.ln1"] = np.ones((d_model,), np.float32)
        p[f"l{i}.ln2"] = np.ones((d_model,), np.float32)
    p["lnf"] = np.ones((d_model,), np.float32)
    p["head"] = norm((d_model, vocab), d_model)
    if bf16:
        return {k: torch.from_numpy(a).to(torch.bfloat16)
                for k, a in p.items()}
    return p


def param_specs(names) -> Dict[str, Optional[int]]:
    """The axis each parameter is sharded on over tp (None: replicated):
    ``param_specs`` of the JAX package (heads of wq/wk/wv and wo, the
    d_ff axis of w1 and w2)."""
    specs: Dict[str, Optional[int]] = {}
    for name in names:
        if name.endswith((".wq", ".wk", ".wv", ".w1")):
            specs[name] = 1
        elif name.endswith((".wo", ".w2")):
            specs[name] = 0
        else:
            specs[name] = None
    return specs


class TransformerLM(nn.Module):
    """The parameters, one ``nn.Parameter`` per JAX key: ``l{i}.wq`` is
    the parameter ``wq`` of the submodule ``l{i}``."""

    def __init__(self, state: Mapping[str, Tensor]):
        super().__init__()
        for name, value in state.items():
            owner: nn.Module = self
            *path, leaf = name.split(".")
            for part in path:
                if not hasattr(owner, part):
                    owner.add_module(part, nn.Module())
                owner = getattr(owner, part)
            owner.register_parameter(leaf, nn.Parameter(value))

    def params(self) -> Dict[str, Tensor]:
        return dict(self.named_parameters())


ParamsLike = Union[TransformerLM, Params]


def _as_params(params: ParamsLike) -> Params:
    return params.params() if isinstance(params, TransformerLM) else params


def n_layers_of(params: Params) -> int:
    return 1 + max(int(k[1:k.index(".")]) for k in params
                   if k[0] == "l" and "." in k)


def _ln(x: Tensor, scale: Tensor) -> Tensor:
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + 1e-6) * scale


def _forward(params: Params, tokens: Tensor, pos_ids: Tensor,
             attn_fn: Callable, enter: Callable, combine: Callable
             ) -> Tensor:
    """``attn_fn`` maps q/k/v [B, T, H_loc, D] -> [B, T, H_loc, D];
    ``enter``/``combine`` bracket each tensor-parallel region. The sharded
    path and the dense oracle run this same code."""
    x = params["emb"][tokens] + params["pos"][pos_ids]
    for i in range(n_layers_of(params)):
        h = enter(_ln(x, params[f"l{i}.ln1"]))
        q = torch.einsum("bte,ehd->bthd", h, params[f"l{i}.wq"])
        k = torch.einsum("bte,ehd->bthd", h, params[f"l{i}.wk"])
        v = torch.einsum("bte,ehd->bthd", h, params[f"l{i}.wv"])
        a = attn_fn(q, k, v)
        x = x + combine(torch.einsum("bthd,hde->bte", a,
                                     params[f"l{i}.wo"]))
        h = enter(_ln(x, params[f"l{i}.ln2"]))
        # jax.nn.gelu is the tanh approximation by default
        up = F.gelu(torch.einsum("bte,ef->btf", h, params[f"l{i}.w1"]),
                    approximate="tanh")
        x = x + combine(torch.einsum("btf,fe->bte", up, params[f"l{i}.w2"]))
    return torch.einsum("bte,ev->btv", _ln(x, params["lnf"]), params["head"])


def _ident(x: Tensor) -> Tensor:
    return x


def forward_reference(params: ParamsLike, tokens: Tensor) -> Tensor:
    """Dense single-device forward, the oracle: [B, T] -> logits."""
    pos_ids = torch.arange(tokens.shape[1], device=tokens.device)
    return _forward(_as_params(params), tokens, pos_ids,
                    lambda q, k, v: reference_attention(q, k, v, True),
                    _ident, _ident)


def forward(params: ParamsLike, tokens: Tensor) -> Tensor:
    """Single-device forward through the flash block step (one shard, no
    process group): [B, T] -> logits."""
    pos_ids = torch.arange(tokens.shape[1], device=tokens.device)
    return _forward(_as_params(params), tokens, pos_ids,
                    lambda q, k, v: ring_attention(q, k, v, None, True),
                    _ident, _ident)


def _shard_forward(params: ParamsLike, tokens: Tensor, mesh: Mesh
                   ) -> Tensor:
    """Per-shard forward: tokens [B_loc, T_loc], params this rank's tp
    shards."""
    t_loc = tokens.shape[1]
    pos_ids = mesh.index("sp") * t_loc + torch.arange(t_loc,
                                                      device=tokens.device)
    sp, tp = mesh.group("sp"), mesh.group("tp")
    return _forward(
        _as_params(params), tokens, pos_ids,
        lambda q, k, v: ring_attention(q, k, v, sp, True),
        lambda x: ident_psum_grad(x, tp),
        lambda x: psum_identity_grad(x, tp))


def _local_loss(params: ParamsLike, tokens: Tensor, targets: Tensor,
                mesh: Mesh) -> Tensor:
    """This rank's part of the global mean NLL: the local NLL sum over the
    global token count, so that its gradient is this rank's contribution
    (``transformer.py:175-189``)."""
    logits = _shard_forward(params, tokens, mesh)
    logp = F.log_softmax(logits.float(), dim=-1)
    nll = -logp.gather(-1, targets[..., None]).sum()
    count = tokens.numel() * mesh.size("dp") * mesh.size("sp")
    return nll / count


def _sum_over(x: Tensor, group) -> Tensor:
    return x if torch.distributed.get_world_size(group) == 1 \
        else tree_allreduce(x, group)


def make_train_step(mesh: Mesh, lr: float = 0.1, grad_sync: str = "psum"):
    """The SGD step over the mesh: ``step(model, tokens, targets) ->
    loss``, tokens/targets this rank's [B_loc, T_loc] shard. It updates
    ``model`` in place (JAX's step returns new params) and returns the
    global mean loss. Gradients are summed over sp, then over dp: leaf by
    leaf with ``tree_allreduce`` (``"psum"``) or the ported
    ``ring_allreduce`` (``"ring"``), or as one flat buffer a dtype through
    ``bucket_allreduce`` with the ring (``"bucket"``, leaves in sorted-key
    order). With ``async_enabled()``, ``"bucket"`` gives the overlapped
    step of ``_make_async_bucket_step``, equal to the sync bucket step bit
    for bit. TF32 products raise (``refuse_tf32``), as in the MLP."""
    if grad_sync not in GRAD_SYNCS:
        raise ValueError(f"grad_sync must be one of {GRAD_SYNCS}, got "
                         f"{grad_sync!r}")
    refuse_tf32("the transformer's train step")
    if grad_sync == "bucket" and async_enabled():
        return _make_async_bucket_step(mesh, lr)
    dp, sp = mesh.group("dp"), mesh.group("sp")

    def sync(g: Tensor) -> Tensor:
        g = _sum_over(g, sp)
        if grad_sync == "ring":
            return ring_allreduce(g.reshape(-1), dp).reshape(g.shape)
        return _sum_over(g, dp)

    def step(model: TransformerLM, tokens: Tensor, targets: Tensor
             ) -> Tensor:
        model.zero_grad(set_to_none=True)
        partial = _local_loss(model, tokens, targets, mesh)
        partial.backward()
        with torch.no_grad():
            params = model.params()
            if grad_sync == "bucket":
                grads = bucket_allreduce(
                    {k: p.grad for k, p in params.items()}, dp, SUM,
                    method="ring", presum_group=sp)
            else:
                grads = {k: sync(p.grad) for k, p in params.items()}
            for k, p in params.items():
                p.sub_(lr * grads[k])
        model.zero_grad(set_to_none=True)
        return _global_loss(partial, mesh)

    return step


def _global_loss(partial: Tensor, mesh: Mesh) -> Tensor:
    """The global mean loss from this rank's part: summed over sp, then
    dp."""
    return _sum_over(_sum_over(partial.detach().reshape(1),
                               mesh.group("sp")), mesh.group("dp"))[0]


def _make_async_bucket_step(mesh: Mesh, lr: float):
    """The overlapped bucketed step (``transformer.py:263-338`` of the JAX
    package): after the backward pass, the sp partials are folded, the
    gradients go into one flat buffer a dtype in sorted-key order, each
    buffer's dp ring is issued in reverse bucket order
    (``grad_buckets_async``), the parameters are updated in place from
    the handles' values (on the card the update waits on the device, not
    the host), and then every handle is waited on. Same folds, order and
    ring as the sync ``"bucket"`` step, so the same bits."""
    dp, sp = mesh.group("dp"), mesh.group("sp")

    def step(model: TransformerLM, tokens: Tensor, targets: Tensor
             ) -> Tensor:
        model.zero_grad(set_to_none=True)
        partial = _local_loss(model, tokens, targets, mesh)
        partial.backward()
        loss = _global_loss(partial, mesh)
        with torch.no_grad():
            params = model.params()
            issued = grad_buckets_async(
                {k: _sum_over(p.grad, sp) for k, p in params.items()}, dp)
            for names, h in issued:
                flat, off = h.value, 0
                for k in names:
                    p = params[k]
                    p.sub_(lr * flat[off:off + p.numel()].view_as(p))
                    off += p.numel()
            for _, h in issued:
                h.wait()
        model.zero_grad(set_to_none=True)
        return loss

    return step


def make_forward(mesh: Mesh):
    """The sharded forward: ``fwd(model, tokens) -> logits`` [B_loc,
    T_loc, V] of this rank's shard, without autograd."""
    def fwd(model: ParamsLike, tokens: Tensor) -> Tensor:
        with torch.no_grad():
            return _shard_forward(model, tokens, mesh)

    return fwd


def shard_tokens(toks: np.ndarray, mesh: Mesh, device) -> Tensor:
    """This rank's [B/dp, T/sp] block of a host [B, T] token array."""
    b, t = toks.shape
    dp, sp = mesh.size("dp"), mesh.size("sp")
    if b % dp or t % sp:
        raise ValueError(f"tokens {toks.shape} do not divide over "
                         f"(dp, sp) = ({dp}, {sp})")
    bl, tl = b // dp, t // sp
    d, s = mesh.index("dp"), mesh.index("sp")
    block = toks[d * bl:(d + 1) * bl, s * tl:(s + 1) * tl]
    return torch.from_numpy(np.ascontiguousarray(block, np.int64)).to(device)


def make_sharded_inputs(mesh: Mesh, batch: int, seq: int, vocab: int = 64,
                        seed: int = 0, **sizes
                        ) -> Tuple[TransformerLM, Tensor, Tensor]:
    """This rank's model (its tp shards of ``init_params(seed)``) and its
    (tokens, targets) shard of random [batch, seq] data, on the mesh's
    device: ready for ``make_train_step``."""
    params = init_params(seed, vocab=vocab, max_t=max(seq, 128), **sizes)
    model = model_on(params, mesh.device, mesh.index("tp"), mesh.size("tp"))
    toks = np.random.default_rng(seed).integers(0, vocab,
                                                size=(batch, seq + 1))
    return (model, shard_tokens(toks[:, :-1], mesh, mesh.device),
            shard_tokens(toks[:, 1:], mesh, mesh.device))


def model_on(params: Mapping[str, Union[np.ndarray, Tensor]],
             device: DeviceLike = None, tp_rank: int = 0, tp: int = 1
             ) -> TransformerLM:
    """A ``TransformerLM`` of the JAX-layout ``params`` (numpy arrays, or
    CPU tensors as a bf16 ``init_params`` gives them; its tp shard) on
    ``device`` (the card by default), in the parameters' dtype."""
    return TransformerLM(transformer_params_from_jax(params, tp_rank, tp,
                                                     device))
