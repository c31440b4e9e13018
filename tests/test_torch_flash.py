"""The port's flash block step (``rabit_tpu_torch/ops/flash.py``) against
the JAX package: the plain forward against ``_block_update``, the plain
backward against ``jax.vjp(_block_update)`` and against the fused Pallas
backward in interpret mode (the tie row included), ``FlashBlock``'s
gradients on the CPU against the plain backward, and JAX's split of an
exact tie. Inputs are made with numpy from a seed and handed to both.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rabit_tpu.ops import pallas_kernels as PK
from rabit_tpu.parallel.ring_attention import _block_update
from rabit_tpu_torch.ops import flash as F

H, T, S, D = 2, 64, 48, 32
# f32 on both sides; the two frameworks sum the q.k and p.v products in
# other orders, a few ulps of values of order 1 to 10
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(seed, mask_kind=None, t=T, s=S, d=D, h=H):
    """(q, k, v, m, l, o, mask, cm, cl, co) as numpy. ``"tie"``: a random
    mask with row 0 fully masked and m = NEG_INF there (the ring's first
    step, where both max ops tie exactly), and lanes 3 and 5 of row 1 equal
    and unmasked."""
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa
    q, k, v = f(h, t, d), f(h, s, d), f(h, s, d)
    m, o = f(h, t), f(h, t, d)
    l = (rng.random((h, t)) + 0.5).astype(np.float32)
    mask = None
    if mask_kind is not None:
        mask = rng.random((t, s)) < 0.3
        mask[0] = True
        m[:, 0] = F.NEG_INF
        k[:, 5] = k[:, 3]
        mask[1, [3, 5]] = False
    return q, k, v, m, l, o, mask, f(h, t), f(h, t), f(h, t, d)


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(np.array(a))
            for a in arrays]


def _scale(d=D):
    return float(d) ** -0.5


def test_neg_inf_is_the_jax_constant():
    assert F.NEG_INF == PK.NEG_INF == -1e30


@pytest.mark.parametrize("mask_kind", [None, "tie"])
def test_plain_forward_matches_block_update(mask_kind):
    q, k, v, m, l, o, mask, *_ = _inputs(1, mask_kind)
    jmask = None if mask is None else jnp.asarray(mask)
    want = _block_update(*map(jnp.asarray, (q, k, v, m, l, o)), jmask,
                         _scale())
    got = F.block_update_reference(*_torch(q, k, v, m, l, o, mask),
                                   _scale())
    for name, g, w in zip(("m", "l", "o"), got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


def test_fully_masked_first_step_row():
    """m = NEG_INF with a fully masked row: p = 1 on every lane, l' = l +
    S, o' = o + sum v (what the TPU kernel gives, not 0 or nan)."""
    q, k, v, m, l, o, mask, *_ = _inputs(2, "tie")
    mo, lo, oo = F.block_update_reference(*_torch(q, k, v, m, l, o, mask),
                                          _scale())
    assert (mo[:, 0] == F.NEG_INF).all()
    np.testing.assert_allclose(lo[:, 0].numpy(), l[:, 0] + S, rtol=1e-6)
    np.testing.assert_allclose(oo[:, 0].numpy(), o[:, 0] + v.sum(axis=1),
                               rtol=1e-5, atol=1e-5)


def _jax_vjp(q, k, v, m, l, o, mask, cm, cl, co):
    jmask = None if mask is None else jnp.asarray(mask)
    _, vjp = jax.vjp(lambda *a: _block_update(*a, jmask, _scale(q.shape[-1])),
                     *map(jnp.asarray, (q, k, v, m, l, o)))
    return vjp(tuple(map(jnp.asarray, (cm, cl, co))))


NAMES = ("dq", "dk", "dv", "dm", "dl", "do")


@pytest.mark.parametrize("mask_kind", [None, "tie"])
def test_plain_backward_matches_jax_vjp(mask_kind):
    arrays = _inputs(3, mask_kind)
    want = _jax_vjp(*arrays)
    q, k, v, m, l, o, mask, cm, cl, co = _torch(*arrays)
    got = F.block_update_bwd_reference(q, k, v, m, l, o, mask, _scale(), cm,
                                       cl, co)
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("mask_kind", [None, "tie"])
def test_plain_backward_matches_fused_pallas_backward(monkeypatch,
                                                      mask_kind):
    monkeypatch.setenv("RABIT_PALLAS_INTERPRET", "1")
    arrays = _inputs(4, mask_kind, t=64, s=64)
    q, k, v, m, l, o, mask, cm, cl, co = arrays
    want = PK.flash_block_bwd(
        *map(jnp.asarray, (q, k, v, m, l, o)),
        None if mask is None else jnp.asarray(mask.astype(np.int8)),
        _scale(), *map(jnp.asarray, (cm, cl, co)))
    got = F.block_update_bwd_reference(*_torch(q, k, v, m, l, o, mask),
                                       _scale(), *_torch(cm, cl, co))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("mask_kind", [None, "tie"])
def test_flash_block_autograd_is_the_plain_backward(mask_kind):
    """On CPU tensors ``block_update`` runs ``FlashBlock`` over the plain
    versions: its gradients are the plain backward's, bit for bit, and the
    mask gets none."""
    q, k, v, m, l, o, mask, cm, cl, co = _torch(*_inputs(5, mask_kind))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, m, l, o)]
    outs = F.block_update(*leaves, mask, _scale())
    for g, w in zip(outs, F.block_update_reference(q, k, v, m, l, o, mask,
                                                   _scale())):
        assert torch.equal(g.detach(), w)
    grads = torch.autograd.grad(outs, leaves, (cm, cl, co))
    want = F.block_update_bwd_reference(q, k, v, m, l, o, mask, _scale(),
                                        cm, cl, co)
    for name, g, w in zip(NAMES, grads, want):
        assert torch.equal(g, w), name


def test_unused_outputs_get_zero_cotangents():
    q, k, v, m, l, o, mask, cm, cl, co = _torch(*_inputs(6, "tie"))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, m, l, o)]
    _, _, o_new = F.block_update(*leaves, mask, _scale())
    grads = torch.autograd.grad(o_new, leaves, co)
    want = F.block_update_bwd_reference(q, k, v, m, l, o, mask, _scale(),
                                        torch.zeros_like(cm),
                                        torch.zeros_like(cl), co)
    for name, g, w in zip(NAMES, grads, want):
        assert torch.equal(g, w), name


def test_exact_tie_splits_as_jax_splits_it():
    """A row whose score maximum is taken by two lanes and equals the
    running max: ``maximum`` gives each side half of dm', ``reduce_max``
    gives each tied lane half of the rest. Scores are small integers, so
    both frameworks see the same exact tie."""
    h, t, s, d = 1, 2, 6, 4
    q = np.zeros((h, t, d), np.float32)
    q[..., 0] = 1.0
    k = np.zeros((h, s, d), np.float32)
    k[0, :, 0] = [1.0, 0.0, 2.0, -1.0, 2.0, 1.0]    # lanes 2 and 4 tie
    rng = np.random.default_rng(7)
    v = rng.standard_normal((h, s, d)).astype(np.float32)
    v[0, 4] = v[0, 2]             # the tied lanes alike: equal shares
    m = np.array([[2.0, 0.5]], np.float32)           # row 0: m ties t
    l = np.array([[1.0, 2.0]], np.float32)
    o = rng.standard_normal((h, t, d)).astype(np.float32)
    cm, cl = np.array([[0.7, -0.3]], np.float32), np.array([[0.2, 0.4]],
                                                           np.float32)
    co = rng.standard_normal((h, t, d)).astype(np.float32)
    want = jax.vjp(lambda *a: _block_update(*a, None, 1.0),
                   *map(jnp.asarray, (q, k, v, m, l, o)))[1](
        tuple(map(jnp.asarray, (cm, cl, co))))
    got = F.block_update_bwd_reference(*_torch(q, k, v, m, l, o), None, 1.0,
                                       *_torch(cm, cl, co))
    for name, g, w in zip(NAMES, got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    dk, dm = got[1].numpy(), got[3].numpy()
    assert dk[0, 2, 0] == dk[0, 4, 0] != 0.0
    # without the ties, the same lanes would not share: lane 2 alone
    k1 = k.copy()
    k1[0, 4, 0] = 1.5
    alone = F.block_update_bwd_reference(*_torch(q, k1, v, m, l, o), None,
                                         1.0, *_torch(cm, cl, co))
    assert alone[1][0, 2, 0] != dk[0, 2, 0]
    assert alone[3][0, 0] != dm[0, 0]
    # torch's Tensor.max(dim) would give the whole cotangent to one lane
    s_row = torch.tensor(k[0, :, 0], requires_grad=True)
    s_row.max(dim=0).values.backward()
    assert s_row.grad[2] != s_row.grad[4]


def test_wrappers_take_the_plain_version_on_cpu_and_count_nothing():
    arrays = _torch(*_inputs(8, "tie"))
    before = (F.flash_block.launches, F.flash_block_bwd.launches)
    got = F.flash_block(*arrays[:7], _scale())
    want = F.block_update_reference(*arrays[:7], _scale())
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = F.flash_block_bwd(*arrays[:7], _scale(), *arrays[7:])
    want = F.block_update_bwd_reference(*arrays[:7], _scale(), *arrays[7:])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (F.flash_block.launches, F.flash_block_bwd.launches) == before


def test_wrappers_raise_on_what_the_kernels_do_not_take():
    q, k, v, m, l, o, mask, cm, cl, co = _torch(*_inputs(9, "tie"))
    with pytest.raises(ValueError, match="bool"):
        F.flash_block(q, k, v, m, l, o, mask.to(torch.uint8), _scale())
    with pytest.raises(TypeError, match="float32"):
        F.flash_block(q, k, v, m.double(), l, o, mask, _scale())
    with pytest.raises(ValueError, match="k and v"):
        F.flash_block(q, k[:, :, :8], v, m, l, o, mask, _scale())
    with pytest.raises(ValueError, match="cotangents"):
        F.flash_block_bwd(q, k, v, m, l, o, mask, _scale(), cm[:, :3], cl,
                          co)
    meta = [x.to("meta") for x in (q, k, v, m, l, o)]
    with pytest.raises(ValueError, match="no flash kernel"):
        F.flash_block(*meta, None, _scale())


def test_plain_block_step_runs_the_plain_pair_forward_and_backward(
        monkeypatch):
    """Inside ``plain_block_step`` ``FlashBlock`` takes the plain pair; a
    forward run inside it runs its backward plain too, even after the
    block has ended, and the kernels' pair is back afterwards, also after
    an error."""
    calls = []

    def fwd(*a):
        calls.append("forward")
        return F.block_update_reference(*a)

    def bwd(*a):
        calls.append("backward")
        return F.block_update_bwd_reference(*a)

    monkeypatch.setattr(F, "_PLAIN", (fwd, bwd))
    q, k, v, m, l, o, mask, cm, cl, co = _torch(*_inputs(10, "tie"))
    leaves = [x.clone().requires_grad_() for x in (q, k, v, m, l, o)]
    with F.plain_block_step():
        outs = F.block_update(*leaves, mask, _scale())
    assert F._step is F._KERNELS
    grads = torch.autograd.grad(outs, leaves, (cm, cl, co))
    assert calls == ["forward", "backward"]
    want = F.block_update_bwd_reference(q, k, v, m, l, o, mask, _scale(),
                                        cm, cl, co)
    for name, g, w in zip(NAMES, grads, want):
        assert torch.equal(g, w), name
    with pytest.raises(RuntimeError, match="inside"):
        with F.plain_block_step():
            raise RuntimeError("inside")
    assert F._step is F._KERNELS
