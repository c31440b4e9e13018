"""Flash-attention block step: the CUDA kernels' wrappers, their plain
versions and the autograd Function around them.

One online-softmax step over a block of keys, per head (the per-step
compute of ring attention)::

    s  = q k^T * sm_scale, masked lanes set to NEG_INF
    m' = max(m, rowmax s);  alpha = exp(m - m');  p = exp(s - m')
    l' = l alpha + sum_j p;  o' = o alpha + p v

q is [H, T, D]; k and v are [H, S, D]; m and l are f32 [H, T]; o is f32
[H, T, D]; mask is bool [T, S] (True = masked) or None. The port of the
flash part of ``rabit_tpu/ops/pallas_kernels.py`` and of
``rabit_tpu/parallel/ring_attention.py::_block_update``:

* ``block_update_reference`` / ``block_update_bwd_reference`` — the plain
  PyTorch versions of the step and of its backward, the latter written out
  with JAX's tie rules (``maximum`` splits a tie 0.5/0.5, ``reduce_max``
  splits its cotangent evenly among the tied lanes);
* ``flash_block`` / ``flash_block_bwd`` — launch ``csrc/flash_block.cu``
  and ``csrc/flash_block_bwd.cu`` for CUDA tensors (counted in
  ``.launches``; their bf16 paths in ``.bf16_launches``) and take the
  plain versions for CPU tensors;
* ``FlashBlock`` — the ``torch.autograd.Function`` over the pair; its
  forward saves the inputs and its backward recomputes (nothing of size
  [T, S] is kept). ``block_update`` applies it; ``plain_block_step`` makes
  it run the plain versions for a while.

Both kernels take q/k/v all f32 or all bf16, D <= 128. At bf16 the
forward runs s and p v on the bf16 tensor cores with f32 sums (p rounded
to bf16 to nearest even after l' has summed it in f32). Its own design
(``flash_fwd_bf16``): a max pre-pass, then a pass at the final max; a
warp owns 16 query rows by all 64 keys of a tile and all D columns of o,
so p goes from the score's C fragments into the A fragments of p v
without leaving the registers; two groups of 4 warps split a 64-row query
tile's key tiles and meet once a pass, each streaming its tiles through
three ``cp.async`` stages of its own. The backward keeps
q/k/v in bf16, forms s from them, splits its f32 operands co and ds into
two bf16 halves (hi + lo, within 2^-16) so that every other product is two
bf16 products with f32 sums, rounds p to bf16 for dv alone and dq/dk/dv to
bf16 at the store. Anything else on a CUDA tensor raises (there is no
quiet fallback).
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Optional, Tuple

import torch

from . import _build

# large-negative instead of -inf: exp() of a masked lane is an exact 0
# without inf - inf = nan in a fully masked row
NEG_INF = -1e30
MAX_HEAD_DIM = 128

Tensor = torch.Tensor


def _check(q: Tensor, k: Tensor, v: Tensor, m: Tensor, l: Tensor, o: Tensor,
           mask: Optional[Tensor]) -> None:
    if q.dim() != 3 or k.dim() != 3 or v.dim() != 3:
        raise ValueError(f"q, k, v must be [H, T, D], [H, S, D], [H, S, D]; "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    h, t, d = q.shape
    s = k.shape[1]
    if k.shape != (h, s, d) or v.shape != (h, s, d):
        raise ValueError(f"k and v must be [{h}, S, {d}], got "
                         f"{tuple(k.shape)} and {tuple(v.shape)}")
    if m.shape != (h, t) or l.shape != (h, t) or o.shape != (h, t, d):
        raise ValueError(f"m, l must be [{h}, {t}] and o [{h}, {t}, {d}], "
                         f"got {tuple(m.shape)}, {tuple(l.shape)}, "
                         f"{tuple(o.shape)}")
    for name, x in (("m", m), ("l", l), ("o", o)):
        if x.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {x.dtype}")
    if mask is not None:
        if mask.dtype != torch.bool or mask.shape != (t, s):
            raise ValueError(f"mask must be bool [{t}, {s}], got "
                             f"{mask.dtype} {tuple(mask.shape)}")
    devices = {x.device for x in (q, k, v, m, l, o)}
    if mask is not None:
        devices.add(mask.device)
    if len(devices) != 1:
        raise ValueError(f"inputs on different devices: {devices}")


def _scores(q: Tensor, k: Tensor, mask: Optional[Tensor],
            sm_scale: float) -> Tensor:
    s = torch.einsum("htd,hsd->hts", q.float(), k.float()) * sm_scale
    if mask is not None:
        s = s.masked_fill(mask, NEG_INF)
    return s


def block_update_reference(q: Tensor, k: Tensor, v: Tensor, m: Tensor,
                           l: Tensor, o: Tensor, mask: Optional[Tensor],
                           sm_scale: float
                           ) -> Tuple[Tensor, Tensor, Tensor]:
    """The plain version of the step: returns (m', l', o'), all f32. p is
    cast to v's dtype before the p v product, which sums in f32, as in
    the JAX twin."""
    _check(q, k, v, m, l, o, mask)
    s = _scores(q, k, mask, sm_scale)
    m_new = torch.maximum(m, s.amax(dim=-1))
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    l_new = l * alpha + p.sum(dim=-1)
    # p rounds to v's dtype; the product itself runs in f32 (a product of
    # two bf16 values is exact in f32), as JAX's preferred_element_type
    pv = torch.einsum("hts,hsd->htd", p.to(v.dtype).float(), v.float())
    return m_new, l_new, o * alpha[..., None] + pv


def block_update_bwd_reference(q: Tensor, k: Tensor, v: Tensor, m: Tensor,
                               l: Tensor, o: Tensor, mask: Optional[Tensor],
                               sm_scale: float, cm: Tensor, cl: Tensor,
                               co: Tensor) -> Tuple[Tensor, ...]:
    """The plain version of the backward: (dq, dk, dv, dm, dl, do) for the
    cotangents (cm, cl, co) of (m', l', o'), by the explicit formulas of
    ``_flash_bwd_body`` (``pallas_kernels.py:256-318``)."""
    _check(q, k, v, m, l, o, mask)
    s = _scores(q, k, mask, sm_scale)
    t_row = s.amax(dim=-1)
    m_new = torch.maximum(m, t_row)
    alpha = torch.exp(m - m_new)
    p = torch.exp(s - m_new[..., None])
    do = co * alpha[..., None]
    dl = cl * alpha
    dv = torch.einsum("hts,htd->hsd", p.to(v.dtype).float(), co)
    dalpha = cl * l + (co * o).sum(dim=-1)
    dp = torch.einsum("htd,hsd->hts", co, v.float()) + cl[..., None]
    dm_new = cm - dalpha * alpha - (dp * p).sum(dim=-1)
    ds = dp * p
    # m' = maximum(m, t): a tie splits the cotangent 0.5/0.5
    sel = torch.where(m > t_row, 1.0,
                      torch.where(m < t_row, 0.0, 0.5)).to(torch.float32)
    dm = dalpha * alpha + dm_new * sel
    # t = reduce_max(s): the cotangent splits evenly among the tied lanes
    eq = (s == t_row[..., None]).to(torch.float32)
    ds = ds + (dm_new * (1.0 - sel) / eq.sum(dim=-1))[..., None] * eq
    if mask is not None:
        ds = ds.masked_fill(mask, 0.0)
    ds = ds * sm_scale
    dq = torch.einsum("hts,hsd->htd", ds, k.float()).to(q.dtype)
    dk = torch.einsum("hts,htd->hsd", ds, q.float()).to(k.dtype)
    return dq, dk, dv.to(v.dtype), dm, dl, do


def _entry(name: str, symbol: str, n_ptr_before: int, n_ptr_after: int):
    p, i = ctypes.c_void_p, ctypes.c_int
    return _build.entry(name, symbol, [p] * n_ptr_before
                        + [i, i, i, i, ctypes.c_float] + [p] * n_ptr_after)


KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _kernel_inputs(q, k, v, m, l, o, mask):
    """Checks what the kernels take and returns contiguous inputs."""
    if q.device.type != "cuda":
        raise ValueError(f"no flash kernel for device {q.device}")
    if q.dtype not in KERNEL_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"the flash kernels take q, k, v all float32 or all "
                        f"bfloat16, got {q.dtype}, {k.dtype}, {v.dtype}")
    d = q.shape[-1]
    if not 1 <= d <= MAX_HEAD_DIM:
        raise ValueError(f"the flash kernels take a head dim of 1 to "
                         f"{MAX_HEAD_DIM}, got {d}")
    h, t, s = q.shape[0], q.shape[1], k.shape[1]
    if not (1 <= h <= 65535 and t >= 1 and s >= 1):
        raise ValueError(f"the flash kernels take 1 to 65535 heads and "
                         f"non-empty T, S; got H={h}, T={t}, S={s}")
    ins = [x.contiguous() for x in (q, k, v, m, l, o)]
    ins.append(None if mask is None else mask.contiguous())
    return ins


def _ptr(x: Optional[Tensor]) -> Optional[int]:
    return None if x is None else x.data_ptr()


def flash_block(q: Tensor, k: Tensor, v: Tensor, m: Tensor, l: Tensor,
                o: Tensor, mask: Optional[Tensor], sm_scale: float
                ) -> Tuple[Tensor, Tensor, Tensor]:
    """The step (m', l', o'): ``csrc/flash_block.cu`` for CUDA tensors
    (f32 q/k/v counted in ``flash_block.launches``, bf16 in
    ``flash_block.bf16_launches``), the plain version for CPU tensors.
    Not differentiable by itself: see ``FlashBlock``."""
    _check(q, k, v, m, l, o, mask)
    if q.device.type == "cpu":
        return block_update_reference(q, k, v, m, l, o, mask, sm_scale)
    q, k, v, m, l, o, mask = _kernel_inputs(q, k, v, m, l, o, mask)
    h, t, d = q.shape
    s = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    fn = _entry("flash_block", "rabit_flash_block_bf16" if bf16
                else "rabit_flash_block_f32", 7, 4)
    with torch.cuda.device(q.device):
        mo, lo, oo = torch.empty_like(m), torch.empty_like(l), \
            torch.empty_like(o)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
            l.data_ptr(), o.data_ptr(), _ptr(mask), h, t, s, d,
            float(sm_scale), mo.data_ptr(), lo.data_ptr(), oo.data_ptr(),
            stream)
    _build.check(err, "flash_block")
    if bf16:
        flash_block.bf16_launches += 1
    else:
        flash_block.launches += 1
    return mo, lo, oo


flash_block.launches = 0
flash_block.bf16_launches = 0


def flash_block_bwd(q: Tensor, k: Tensor, v: Tensor, m: Tensor, l: Tensor,
                    o: Tensor, mask: Optional[Tensor], sm_scale: float,
                    cm: Tensor, cl: Tensor, co: Tensor
                    ) -> Tuple[Tensor, ...]:
    """The fused backward (dq, dk, dv, dm, dl, do):
    ``csrc/flash_block_bwd.cu`` for CUDA tensors (its row and column
    kernels, counted once: f32 q/k/v in ``flash_block_bwd.launches``,
    bf16 in ``flash_block_bwd.bf16_launches``), the plain version for CPU
    tensors. dq, dk and dv come in q/k/v's dtype; dm, dl and do in
    f32."""
    _check(q, k, v, m, l, o, mask)
    h, t, d = q.shape
    if cm.shape != (h, t) or cl.shape != (h, t) or co.shape != (h, t, d):
        raise ValueError(f"cotangents must be [{h}, {t}], [{h}, {t}], "
                         f"[{h}, {t}, {d}]; got {tuple(cm.shape)}, "
                         f"{tuple(cl.shape)}, {tuple(co.shape)}")
    if q.device.type == "cpu":
        return block_update_bwd_reference(q, k, v, m, l, o, mask, sm_scale,
                                          cm, cl, co)
    q, k, v, m, l, o, mask = _kernel_inputs(q, k, v, m, l, o, mask)
    cm, cl, co = (x.float().contiguous() for x in (cm, cl, co))
    s = k.shape[1]
    bf16 = q.dtype == torch.bfloat16
    fn = _entry("flash_block_bwd", "rabit_flash_block_bwd_bf16" if bf16
                else "rabit_flash_block_bwd_f32", 10, 8)
    with torch.cuda.device(q.device):
        dq, dk, dv = (torch.empty_like(x) for x in (q, k, v))
        dm, dl, do = (torch.empty_like(x) for x in (m, l, o))
        scratch = torch.empty((3, h, t), dtype=torch.float32,
                              device=q.device)
        stream = torch.cuda.current_stream(q.device).cuda_stream
        err = fn(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), m.data_ptr(),
            l.data_ptr(), o.data_ptr(), _ptr(mask), cm.data_ptr(),
            cl.data_ptr(), co.data_ptr(), h, t, s, d, float(sm_scale),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), dm.data_ptr(),
            dl.data_ptr(), do.data_ptr(), scratch.data_ptr(), stream)
    _build.check(err, "flash_block_bwd")
    if bf16:
        flash_block_bwd.bf16_launches += 1
    else:
        flash_block_bwd.launches += 1
    return dq, dk, dv, dm, dl, do


flash_block_bwd.launches = 0
flash_block_bwd.bf16_launches = 0


# the pair FlashBlock runs: the kernels' wrappers (which take the plain
# versions for CPU tensors), or, inside ``plain_block_step``, the plain
# versions on every device
_KERNELS = (flash_block, flash_block_bwd)
_PLAIN = (block_update_reference, block_update_bwd_reference)
_step = _KERNELS


@contextlib.contextmanager
def plain_block_step():
    """Within it, ``FlashBlock`` runs the plain versions on every device
    (to hold a step through the kernels against the same step without
    them). A forward run inside it also runs its backward plain."""
    global _step
    before, _step = _step, _PLAIN
    try:
        yield
    finally:
        _step = before


class FlashBlock(torch.autograd.Function):
    """The differentiable step. Forward: ``flash_block``; it saves the
    inputs, not p. Backward: ``flash_block_bwd`` recomputes. The mask gets
    no gradient."""

    @staticmethod
    def forward(ctx, q, k, v, m, l, o, mask, sm_scale):
        ctx.save_for_backward(q, k, v, m, l, o)
        ctx.mask, ctx.sm_scale = mask, sm_scale
        fwd, ctx.bwd = _step
        return fwd(q, k, v, m, l, o, mask, sm_scale)

    @staticmethod
    def backward(ctx, cm, cl, co):
        # unused outputs arrive as zeros (materialized cotangents)
        q, k, v, m, l, o = ctx.saved_tensors
        grads = ctx.bwd(q, k, v, m, l, o, ctx.mask, ctx.sm_scale, cm, cl, co)
        return (*grads, None, None)


def block_update(q: Tensor, k: Tensor, v: Tensor, m: Tensor, l: Tensor,
                 o: Tensor, mask: Optional[Tensor], sm_scale: float
                 ) -> Tuple[Tensor, Tensor, Tensor]:
    """The differentiable step through ``FlashBlock``: the kernels for
    CUDA tensors, the plain versions for CPU tensors."""
    return FlashBlock.apply(q, k, v, m, l, o, mask, float(sm_scale))
