"""The port's flash block step (``rabit_tpu_torch/ops/flash.py``) against
the JAX package: the plain forward against ``_block_update``, the plain
backward against ``jax.vjp(_block_update)`` and against the fused Pallas
backward in interpret mode (the tie row included), ``FlashBlock``'s
gradients on the CPU against the plain backward, and JAX's split of an
exact tie. Inputs are made with numpy from a seed and handed to both.

The CUDA kernels themselves run only on the card: ``chip_smoke.py`` holds
them against these plain versions there."""

import functools

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
    def counts():
        return tuple((f.launches, f.bf16_launches)
                     for f in (F.flash_block, F.flash_block_bwd))

    before = counts()
    got = F.flash_block(*arrays[:7], _scale())
    want = F.block_update_reference(*arrays[:7], _scale())
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    got = F.flash_block_bwd(*arrays[:7], _scale(), *arrays[7:])
    want = F.block_update_bwd_reference(*arrays[:7], _scale(), *arrays[7:])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    bf16 = [x.to(BF16) for x in arrays[:3]] + arrays[3:]
    got = F.flash_block_bwd(*bf16[:7], _scale(), *bf16[7:])
    want = F.block_update_bwd_reference(*bf16[:7], _scale(), *bf16[7:])
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert counts() == before


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


# -- csrc/flash_block_bwd.cu's tile schedule, modelled in plain torch --

TILE = 64
NEG_INF = F.NEG_INF


def _tile_masked(mask, rows, cols):
    return mask is not None and bool(mask[rows][:, cols].all())


def _schedule(tiles, skip, skipped):
    """The tiles a pass visits; skip(i) is asked with the state before the
    tile in hand (the kernels pick the next tile before they multiply the
    current one). Adds the count of tiles skipped to skipped[0]."""
    i = 0
    while i < len(tiles) and skip(i):
        skipped[0], i = skipped[0] + 1, i + 1
    while i < len(tiles):
        j = i + 1
        while j < len(tiles) and skip(j):
            skipped[0], j = skipped[0] + 1, j + 1
        yield tiles[i]
        i = j


def _tile_schedule_bwd(q, k, v, m, l, o, mask, scale, cm, cl, co):
    """The backward as the CUDA kernels schedule it, head by head. A row
    block of 64 queries makes pass 1 over the 64-key tiles (s and dp a
    tile; the running max t, its tie count and sum_j (dp + cl) exp(s - m'),
    rescaled whenever m' = max(m, t) rises) and pass 2 (ds, dq += ds k). A
    column block of 64 keys streams the query tiles (dv += p^T co, dk +=
    ds^T q). A pass skips a fully masked tile where the kernels do: pass 1
    once every row of the block had a score above NEG_INF before the tile
    in hand (the kernels pick the next tile before they multiply the
    current one), pass 2 always (ds = 0 there), the column pass once every
    row of the query tile has m' above NEG_INF. Returns the six gradients
    and the count of tiles skipped."""
    h_n, t_n, _ = q.shape
    s_n = k.shape[1]
    dq, dk, dv, dm, dl, do = (torch.zeros_like(x) for x in (q, k, v, m, l, o))
    mnew, trow, tie = (torch.zeros_like(m) for _ in range(3))
    skipped = [0]
    key_tiles = [slice(c, min(c + TILE, s_n)) for c in range(0, s_n, TILE)]
    row_tiles = [slice(r, min(r + TILE, t_n)) for r in range(0, t_n, TILE)]

    def scores(h, rows, cols):
        s = (q[h, rows] @ k[h, cols].T) * scale
        return s if mask is None else s.masked_fill(mask[rows][:, cols],
                                                    NEG_INF)

    def ds(h, rows, cols):
        s = scores(h, rows, cols)
        dp = co[h, rows] @ v[h, cols].T + cl[h, rows, None]
        g = dp * torch.exp(s - mnew[h, rows, None]) + tie[h, rows, None] * (
            s == trow[h, rows, None])
        if mask is not None:
            g = g.masked_fill(mask[rows][:, cols], 0.0)
        return g * scale

    def schedule(tiles, skip):
        return _schedule(tiles, skip, skipped)

    for h in range(h_n):
        for rows in row_tiles:
            m_in, cl_r = m[h, rows], cl[h, rows]
            t_run = torch.full_like(m_in, -float("inf"))
            n_run, sum_run, m_run = (torch.zeros_like(m_in),
                                     torch.zeros_like(m_in), m_in.clone())

            def seen(i, rows=rows):
                return _tile_masked(mask, rows, key_tiles[i]) and bool(
                    (t_run > NEG_INF).all())

            for cols in schedule(key_tiles, seen):
                s = scores(h, rows, cols)
                dp = co[h, rows] @ v[h, cols].T + cl_r[:, None]
                tmax = s.amax(dim=1)
                cnt = (s == tmax[:, None]).sum(dim=1).to(m.dtype)
                n_run = torch.where(t_run > tmax, n_run, torch.where(
                    t_run < tmax, cnt, n_run + cnt))
                t_run = torch.maximum(t_run, tmax)
                m_new = torch.maximum(m_in, t_run)
                sum_run = sum_run * torch.exp(m_run - m_new) + (
                    dp * torch.exp(s - m_new[:, None])).sum(dim=1)
                m_run = m_new
            alpha = torch.exp(m_in - m_run)
            dalpha = cl_r * l[h, rows] + (co[h, rows] * o[h, rows]).sum(1)
            dm_new = cm[h, rows] - dalpha * alpha - sum_run
            sel = torch.where(m_in > t_run, 1.0,
                              torch.where(m_in < t_run, 0.0, 0.5))
            dm[h, rows] = dalpha * alpha + dm_new * sel
            dl[h, rows] = cl_r * alpha
            do[h, rows] = co[h, rows] * alpha[:, None]
            mnew[h, rows], trow[h, rows] = m_run, t_run
            tie[h, rows] = dm_new * (1.0 - sel) / n_run
            for cols in schedule(key_tiles, lambda i, rows=rows: _tile_masked(
                    mask, rows, key_tiles[i])):
                dq[h, rows] += ds(h, rows, cols) @ k[h, cols]
        for cols in key_tiles:
            def finite(i, cols=cols):
                return _tile_masked(mask, row_tiles[i], cols) and bool(
                    (mnew[h, row_tiles[i]] > NEG_INF).all())

            for rows in schedule(row_tiles, finite):
                p = torch.exp(scores(h, rows, cols) - mnew[h, rows, None])
                dv[h, cols] += p.T @ co[h, rows]
                dk[h, cols] += ds(h, rows, cols).T @ q[h, rows]
    return (dq, dk, dv, dm, dl, do), skipped[0]


def _tile_schedule_fwd(q, k, v, m, l, o, mask, scale):
    """The forward as ``csrc/flash_block.cu`` schedules it, head by head.
    With a mask a block takes query tiles i and n - 1 - i of the n tiles
    of 64 rows (the middle one alone when n is odd), without one a block
    a tile. A query tile streams the 64-key tiles with the online rescale
    (m' = max(m, rowmax s), and l and o times alpha = exp(m - m') a tile),
    and skips a tile whose every pair is masked once every row of the
    query tile had a max above NEG_INF before the tile in hand. Returns
    (m', l', o'), the count of tiles skipped, and the blocks of a head
    with the key tiles each visits."""
    h_n, t_n, _ = q.shape
    s_n = k.shape[1]
    key_tiles = [slice(c, min(c + TILE, s_n)) for c in range(0, s_n, TILE)]
    row_tiles = [slice(r, min(r + TILE, t_n)) for r in range(0, t_n, TILE)]
    n = len(row_tiles)
    blocks = ([sorted({i, n - 1 - i}) for i in range((n + 1) // 2)]
              if mask is not None else [[i] for i in range(n)])
    mo, lo, oo = m.clone(), l.clone(), o.clone()
    skipped, visits = [0], []
    for h in range(h_n):
        for block in blocks:
            visits.append((block, 0))
            for rows in (row_tiles[i] for i in block):
                m_run, l_run, o_run = m[h, rows], l[h, rows], o[h, rows]

                def skip(i, rows=rows):
                    return _tile_masked(mask, rows, key_tiles[i]) and bool(
                        (m_run > NEG_INF).all())

                for cols in _schedule(key_tiles, skip, skipped):
                    s = (q[h, rows] @ k[h, cols].T) * scale
                    if mask is not None:
                        s = s.masked_fill(mask[rows][:, cols], NEG_INF)
                    m_new = torch.maximum(m_run, s.amax(dim=1))
                    alpha = torch.exp(m_run - m_new)
                    p = torch.exp(s - m_new[:, None])
                    l_run = l_run * alpha + p.sum(dim=1)
                    o_run = o_run * alpha[:, None] + p @ v[h, cols]
                    m_run = m_new
                    visits[-1] = (block, visits[-1][1] + 1)
                mo[h, rows], lo[h, rows], oo[h, rows] = m_run, l_run, o_run
    return (mo, lo, oo), skipped[0], visits[:len(blocks)]


def _masked_inputs(seed, kind):
    """numpy inputs as ``_inputs`` gives them, for the four cases of the
    schedule: "causal" (a running state, T 192, S 192), "causal, row 0
    masked" (the ring's first step, m = NEG_INF and l = o = 0, with row 0
    fully masked, so the first row block may skip nothing; T 192, S 200,
    D 16), "tie" and "ragged" (T 100, S 72, D 16, the tie mask)."""
    if kind == "tie":
        return _inputs(seed, "tie")
    if kind == "ragged":
        return _inputs(seed, "tie", t=100, s=72, d=16)
    t, s, d = (192, 192, D) if kind == "causal" else (192, 200, 16)
    q, k, v, m, l, o, _, cm, cl, co = _inputs(seed, None, t=t, s=s, d=d)
    mask = np.triu(np.ones((t, s), bool), 1)
    if kind == "causal, row 0 masked":
        mask[0] = True
        m = np.full_like(m, F.NEG_INF)
        l, o = np.zeros_like(l), np.zeros_like(o)
    return q, k, v, m, l, o, mask, cm, cl, co



@pytest.mark.parametrize("kind", ["causal", "causal, row 0 masked", "tie",
                                  "ragged"])
def test_tile_schedule_matches_plain_backward_and_jax_vjp(kind):
    """The kernels' algorithm (fused pass 1 with a rescaled running sum,
    64-key tiles, the skip rules) before it reaches the card: the same
    gradients as the plain backward and JAX's VJP within 1e-5."""
    arrays = _masked_inputs(11, kind)
    q, k, v, m, l, o, mask, cm, cl, co = _torch(*arrays)
    scale = _scale(q.shape[-1])
    got, skipped = _tile_schedule_bwd(q, k, v, m, l, o, mask, scale, cm, cl,
                                      co)
    plain = F.block_update_bwd_reference(q, k, v, m, l, o, mask, scale, cm,
                                         cl, co)
    jax_grads = _jax_vjp(*arrays)
    for name, g, p, j in zip(NAMES, got, plain, jax_grads):
        np.testing.assert_allclose(g.numpy(), p.numpy(), err_msg=name, **TOL)
        np.testing.assert_allclose(g.numpy(), np.asarray(j), err_msg=name,
                                   **TOL)
    # tiles skipped a head by pass 1, pass 2 and the column pass. Causal,
    # 3 x 3 tiles, 3 of them above the diagonal: pass 1 picks tile 1 of
    # row block 0 before any score is seen, so it skips 2. Row 0 masked,
    # 3 x 4 tiles, 6 above the diagonal: row 0 stays at NEG_INF, so pass 1
    # and the column pass skip nothing that holds row 0.
    assert skipped == {"causal": 2 * (2 + 3 + 3),
                       "causal, row 0 masked": 2 * (3 + 6 + 3),
                       "tie": 0, "ragged": 0}[kind]


@pytest.mark.parametrize("kind", ["causal", "causal, row 0 masked", "tie",
                                  "ragged"])
def test_forward_tile_schedule_matches_plain_jax_and_pallas(monkeypatch,
                                                            kind):
    """The forward kernel's algorithm (query tiles i and n - 1 - i in one
    block, 64-key tiles, the online rescale, the skip rule) before it
    reaches the card: the same (m', l', o') as the plain forward, JAX's
    ``_block_update`` and the Pallas ``flash_block`` in interpret mode,
    within 1e-5."""
    monkeypatch.setenv("RABIT_PALLAS_INTERPRET", "1")
    q, k, v, m, l, o, mask, *_ = _masked_inputs(14, kind)
    tq, tk, tv, tm, tl, to, tmask = _torch(q, k, v, m, l, o, mask)
    scale = _scale(q.shape[-1])
    got, skipped, visits = _tile_schedule_fwd(tq, tk, tv, tm, tl, to, tmask,
                                              scale)
    jq = list(map(jnp.asarray, (q, k, v, m, l, o)))
    jmask = None if mask is None else jnp.asarray(mask)
    refs = {"plain": F.block_update_reference(tq, tk, tv, tm, tl, to, tmask,
                                              scale),
            "jax": _block_update(*jq, jmask, scale),
            "pallas": PK.flash_block(*jq, jmask, scale)}
    for ref, want in refs.items():
        for name, g, w in zip(("m'", "l'", "o'"), got, want):
            np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                       err_msg=f"{name} vs {ref}", **TOL)
    # tiles skipped a head. Causal, 3 x 3 tiles: the lookahead skips 2
    # after row tile 0 and 1 after row tile 1. Row 0 masked (the first
    # step, m = NEG_INF), 3 x 4 tiles: row tile 0 skips nothing; row tiles
    # 1 and 2 may skip only once their rows have a finite max, from their
    # third tile on: 2 and 1.
    assert skipped == {"causal": 2 * (2 + 1), "causal, row 0 masked":
                       2 * (2 + 1), "tie": 0, "ragged": 0}[kind]
    # the causal balance: the block of row tiles 0 and 2 streams n + 1 = 4
    # key tiles, the middle tile's block 2
    if kind == "causal":
        assert visits == [([0, 2], 4), ([1], 2)]


def _tf32(x):
    """numpy float32 to TF32 (10 mantissa bits), to nearest with ties away
    from zero, as cvt.rna.tf32.f32."""
    u = np.asarray(x, np.float32).view(np.uint32)
    return ((u + np.uint32(0x1000)) & np.uint32(0xFFFFE000)).view(np.float32)


def _split_tf32(x):
    big = _tf32(x)
    return big, _tf32(np.asarray(x, np.float32) - big)


def test_split_tf32_rounds_to_nearest_ties_away_and_reconstructs():
    one = np.float32(1.0)
    assert _tf32(one + np.float32(2.0 ** -11)) == one + np.float32(2.0 ** -10)
    assert _tf32(-(one + np.float32(2.0 ** -11))) == -(one + 2.0 ** -10)
    assert _tf32(one + np.float32(2.0 ** -12)) == one
    x = np.random.default_rng(12).standard_normal(100_000).astype(np.float32)
    x *= np.float32(10.0) ** np.random.default_rng(13).integers(-6, 6, x.size)
    big, small = _split_tf32(x)
    for part in (big, small):
        assert not (part.view(np.uint32) & np.uint32(0x1FFF)).any()
    rel = np.abs(big.astype(np.float64) + small - x) / np.abs(x)
    assert rel.max() <= 2.0 ** -22
    assert np.abs(big.astype(np.float64) - x).max() / np.abs(x).max() > 1e-5


def _dot_3xtf32(a, b):
    """a b^T as the kernels form it: k in steps of 8, each step three
    TF32 products (small x big, big x small, big x big) summed into an f32
    accumulator; each TF32 product is exact in f32."""
    (ab, as_), (bb, bs) = _split_tf32(a), _split_tf32(b)
    acc = np.zeros((a.shape[0], b.shape[0]), np.float32)
    for k0 in range(0, a.shape[1], 8):
        ks = slice(k0, k0 + 8)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            acc = (acc + x[:, ks].astype(np.float64) @ y[:, ks].T.astype(
                np.float64)).astype(np.float32)
    return acc


@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_3xtf32_dot_is_within_1e6_of_f64(width):
    """The tolerance of the kernels' note: a 3xTF32 tile product of
    seeded normals within 1e-6 of f64 (max|diff| / max|ref|), where one
    TF32 product is off by about 3e-4."""
    rng = np.random.default_rng(width)
    a = rng.standard_normal((64, width)).astype(np.float32)
    b = rng.standard_normal((64, width)).astype(np.float32)
    ref = a.astype(np.float64) @ b.T.astype(np.float64)
    rel = np.abs(_dot_3xtf32(a, b) - ref).max() / np.abs(ref).max()
    one = _tf32(a).astype(np.float64) @ _tf32(b).T.astype(np.float64)
    assert rel <= 1e-6
    assert np.abs(one - ref).max() / np.abs(ref).max() > 1e-5


# -- bf16 q/k/v: the plain step against JAX, and the forward kernel's
# -- bf16 schedule (csrc/flash_block.cu's pre-pass) in plain torch --

BF16 = torch.bfloat16
# m' and l' within 1e-6 of their largest value (f32 sums in other
# orders); o' within 1e-4 of max|o'| (the same p, rounded to bf16 alike,
# times bf16 v summed in f32; the old bf16 product read 2.7e-3)
BF16_ML_REL, BF16_O_REL, BF16_GRAD_REL = 1e-6, 1e-4, 1e-3


def _bf16_inputs(seed, mask_kind=None, t=T, s=S, d=D, h=H):
    """``_inputs`` for bf16 q/k/v, with q and k on a grid of 1/16 in
    [-4, 4]: every q . k is then exact in f32 in any order of summation,
    so both frameworks form the same scores bit for bit. (With general
    bf16 q and k the scores differ in their last bit from one order of
    summation to another, and p's rounding to bf16 then flips at a few
    lanes, by up to 2e-4 of max|o'| at these sizes: a difference of the
    frameworks, not of the step.) ``"causal"``: a causal mask."""
    q, k, v, m, l, o, mask, cm, cl, co = _inputs(
        seed, "tie" if mask_kind == "tie" else None, t=t, s=s, d=d, h=h)
    q, k = (np.clip(np.round(x * 16) / 16, -4, 4).astype(np.float32)
            for x in (q, k))
    if mask_kind == "causal":
        mask = np.triu(np.ones((t, s), bool), 1)
    return q, k, v, m, l, o, mask, cm, cl, co


def _bf16_torch(q, k, v):
    return [torch.from_numpy(np.array(x)).to(BF16) for x in (q, k, v)]


def _bf16_jax(q, k, v):
    return [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]


def _assert_rel(got, want, rel, what):
    """|got - want| <= rel * max|want| over the entries above NEG_INF's
    magnitude; entries at +-NEG_INF (a fully masked row's m') equal."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, what
    huge = np.abs(want) >= 1e29
    np.testing.assert_array_equal(got[huge], want[huge], err_msg=what)
    scale = np.abs(want[~huge]).max()
    err = np.abs(got - want)[~huge].max()
    assert err <= rel * scale, f"{what}: {err / scale:.3g} of max > {rel}"


def _bf16_steps(n):
    """One step of bf16 (2^-7 of the leading power of two) at |n|."""
    a = np.maximum(np.abs(np.asarray(n, np.float64)), 1e-38)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("mask_kind", [None, "causal", "tie"])
def test_plain_forward_bf16_matches_block_update_and_pallas(monkeypatch,
                                                           mask_kind):
    """bf16 q/k/v: the plain step against ``_block_update`` and the
    Pallas ``flash_block`` in interpret mode. p rounds to bf16 and the
    p v product sums in f32 (``preferred_element_type``), m', l' and o'
    stay f32."""
    monkeypatch.setenv("RABIT_PALLAS_INTERPRET", "1")
    q, k, v, m, l, o, mask, *_ = _bf16_inputs(21, mask_kind)
    jq = _bf16_jax(q, k, v) + list(map(jnp.asarray, (m, l, o)))
    jmask = None if mask is None else jnp.asarray(mask)
    got = F.block_update_reference(*_bf16_torch(q, k, v),
                                   *_torch(m, l, o, mask), _scale())
    for ref, want in (("_block_update", _block_update(*jq, jmask, _scale())),
                      ("pallas", PK.flash_block(*jq, jmask, _scale()))):
        for name, g, w, rel in zip(("m'", "l'", "o'"), got, want,
                                   (BF16_ML_REL, BF16_ML_REL, BF16_O_REL)):
            assert g.dtype == torch.float32
            _assert_rel(g.numpy(), w, rel, f"{name} vs {ref}")
    if mask_kind == "tie":   # the fully masked first-step row: p = 1
        np.testing.assert_allclose(got[1][:, 0].numpy(), l[:, 0] + S,
                                   rtol=1e-6)


def test_plain_forward_bf16_keeps_f32_bits_for_f32_inputs():
    """The f32 step is the f32 step it was: p.to(f32) and the upcasts
    are no-ops, the same einsum runs."""
    q, k, v, m, l, o, mask = _torch(*_inputs(22, "tie"))[:7]
    s = F._scores(q, k, mask, _scale())
    m_new = torch.maximum(m, s.amax(dim=-1))
    p = torch.exp(s - m_new[..., None])
    want = o * torch.exp(m - m_new)[..., None] + torch.einsum(
        "hts,hsd->htd", p, v)
    got = F.block_update_reference(q, k, v, m, l, o, mask, _scale())
    assert torch.equal(got[2], want)


@pytest.mark.parametrize("mask_kind", [None, "causal", "tie"])
def test_plain_backward_bf16_matches_fused_pallas_backward(monkeypatch,
                                                           mask_kind):
    """bf16 q/k/v: the plain backward against ``PK.flash_block_bwd`` in
    interpret mode. dq, dk and dv keep q/k/v's dtype and lie within 1e-3
    of the largest gradient, or one bf16 step of the value: each is an f32
    sum that the frameworks form in other orders, cast to bf16 at the end,
    and a cast that flips moves it by one step. dm, dl and do are f32
    within 1e-3 of their largest."""
    monkeypatch.setenv("RABIT_PALLAS_INTERPRET", "1")
    q, k, v, m, l, o, mask, cm, cl, co = _bf16_inputs(23, mask_kind, t=64,
                                                      s=64)
    want = PK.flash_block_bwd(
        *_bf16_jax(q, k, v), *map(jnp.asarray, (m, l, o)),
        None if mask is None else jnp.asarray(mask.astype(np.int8)),
        _scale(), *map(jnp.asarray, (cm, cl, co)))
    got = F.block_update_bwd_reference(*_bf16_torch(q, k, v),
                                       *_torch(m, l, o, mask), _scale(),
                                       *_torch(cm, cl, co))
    for name, g, w in zip(NAMES, got, want):
        w = np.asarray(w.astype(jnp.float32), np.float64)
        assert g.dtype == (BF16 if name in ("dq", "dk", "dv")
                           else torch.float32), name
        err = np.abs(g.float().numpy() - w)
        bound = BF16_GRAD_REL * np.abs(w).max()
        if g.dtype == BF16:
            bound = bound + _bf16_steps(w)
        assert (err <= bound).all(), f"{name}: {err.max():.3g}"


def test_flash_block_autograd_keeps_bf16_gradients_on_cpu():
    """``block_update`` at bf16 q/k/v on CPU tensors: f32 (m', l', o'),
    bf16 gradients of q/k/v, the plain backward's bit for bit."""
    q, k, v, m, l, o, mask, cm, cl, co = _bf16_inputs(24, "tie")
    tq, tk, tv = _bf16_torch(q, k, v)
    m, l, o, mask, cm, cl, co = _torch(m, l, o, mask, cm, cl, co)
    leaves = [x.clone().requires_grad_() for x in (tq, tk, tv, m, l, o)]
    outs = F.block_update(*leaves, mask, _scale())
    assert [x.dtype for x in outs] == [torch.float32] * 3
    grads = torch.autograd.grad(outs, leaves, (cm, cl, co))
    want = F.block_update_bwd_reference(tq, tk, tv, m, l, o, mask, _scale(),
                                        cm, cl, co)
    for name, g, w in zip(NAMES, grads, want):
        assert g.dtype == w.dtype and torch.equal(g, w), name
    assert [g.dtype for g in grads[:3]] == [BF16] * 3


# key tiles whose mask bits the bf16 forward reads at once (flash_common.cuh)
CHUNK = 64


def _tile_schedule_fwd_bf16(q, k, v, m, l, o, mask, scale, groups=2,
                            chunk=CHUNK):
    """The forward's bf16 path as ``csrc/flash_block.cu`` schedules it, a
    query tile of 64 rows at a time with ``groups`` warp groups. Each pass
    lists the 64-key tiles it visits, a chunk of ``chunk`` tiles at a time
    (the kernel's CHUNK; a smaller one here crosses chunks at a test's
    size, as the kernel does past CHUNK x 64 keys), and
    deals them out, the chunk's v-th visited tile to group v % groups.
    Pass 0 skips a tile with no unmasked pair where every row has m at or
    above NEG_INF (its lanes add exactly NEG_INF to a max that starts at
    m); each group takes the max of m and its tiles' scores, and m' is the
    max of the groups'. Pass 1 skips such a tile where every row's m' is
    above NEG_INF (p = 0 on it); each group sums p = exp(s - m') in f32
    into its l and bf16(p) v in f32 into its o, group 0 from l and o
    scaled by exp(m - m'); l' and o' are the groups' parts added in group
    order. Returns (m', l', o') and the count of tiles skipped."""
    h_n, t_n, _ = q.shape
    s_n = k.shape[1]
    key_tiles = [slice(c, min(c + TILE, s_n)) for c in range(0, s_n, TILE)]
    mo, lo, oo = m.clone(), l.clone(), o.clone()
    skipped = 0
    for h in range(h_n):
        for r in range(0, t_n, TILE):
            rows = slice(r, min(r + TILE, t_n))
            m_in = m[h, rows]

            def scores(cols, rows=rows):
                s = (q[h, rows].float() @ k[h, cols].float().T) * scale
                return s if mask is None else s.masked_fill(
                    mask[rows][:, cols], NEG_INF)

            def dealt(rows_ok, rows=rows):
                """Each group's tiles of the pass, in the order it takes
                them."""
                nonlocal skipped
                out = [[] for _ in range(groups)]
                for c0 in range(0, len(key_tiles), chunk):
                    visit = [cols for cols in key_tiles[c0:c0 + chunk]
                             if not (rows_ok and _tile_masked(mask, rows,
                                                              cols))]
                    skipped += min(chunk, len(key_tiles) - c0) - len(visit)
                    for g in range(groups):
                        out[g] += visit[g::groups]
                return out

            parts = []
            for mine in dealt(bool((m_in >= NEG_INF).all())):
                m_g = m_in
                for cols in mine:
                    m_g = torch.maximum(m_g, scores(cols).amax(dim=1))
                parts.append(m_g)
            m_new = functools.reduce(torch.maximum, parts)
            alpha = torch.exp(m_in - m_new)
            l_sum = o_sum = 0
            for g, mine in enumerate(dealt(bool((m_new > NEG_INF).all()))):
                l_g = l[h, rows] * alpha if g == 0 else torch.zeros_like(m_in)
                o_g = (o[h, rows] * alpha[:, None] if g == 0
                       else torch.zeros_like(o[h, rows]))
                for cols in mine:
                    p = torch.exp(scores(cols) - m_new[:, None])
                    l_g = l_g + p.sum(dim=1)
                    o_g = o_g + p.to(BF16).float() @ v[h, cols].float()
                l_sum, o_sum = l_sum + l_g, o_sum + o_g
            mo[h, rows], lo[h, rows], oo[h, rows] = m_new, l_sum, o_sum
    return (mo, lo, oo), skipped


_PALLAS_FWD_BF16 = {}


def _pallas_fwd_bf16(key, q, k, v, m, l, o, mask, scale):
    """The Pallas ``flash_block`` in interpret mode on bf16 q/k/v, once
    for each case (it does not depend on the schedule's groups)."""
    if key not in _PALLAS_FWD_BF16:
        _PALLAS_FWD_BF16[key] = PK.flash_block(
            *_bf16_jax(q, k, v), *map(jnp.asarray, (m, l, o)),
            None if mask is None else jnp.asarray(mask), scale)
    return _PALLAS_FWD_BF16[key]


BF16_SCHEDULE_KINDS = [("causal", D), ("causal, row 0 masked", 16),
                       ("tie", D), ("ragged", 16), ("ragged", 13),
                       ("ragged", 1)]


@pytest.mark.parametrize("groups", [1, 2, 4])
@pytest.mark.parametrize("kind,d", BF16_SCHEDULE_KINDS)
def test_forward_bf16_tile_schedule_matches_plain_and_jax(monkeypatch, kind,
                                                          d, groups):
    """The bf16 path's algorithm (the max pre-pass, the key tiles dealt to
    warp groups and their parts combined once a pass, p rounded to bf16
    against the final max, f32 sums, the skip rule, odd D) before it
    reaches the card: the plain bf16 step's, JAX's and the Pallas
    kernel's (interpret mode) (m', l', o') within the tolerances above."""
    _check_fwd_bf16_schedule(monkeypatch, kind, d, groups, CHUNK)


@pytest.mark.parametrize("chunk", [1, 2, 3])
@pytest.mark.parametrize("kind,d", BF16_SCHEDULE_KINDS)
def test_forward_bf16_tile_schedule_across_mask_chunks(monkeypatch, kind, d,
                                                       chunk):
    """As above with two groups, and the key tiles listed and dealt a
    chunk of 1, 2 or 3 tiles at a time, so that a pass crosses chunks (the
    kernel's branch for more than CHUNK key tiles): each chunk's tiles
    are dealt from group 0 again, and the skip rule and the sums hold."""
    _check_fwd_bf16_schedule(monkeypatch, kind, d, 2, chunk)


def _check_fwd_bf16_schedule(monkeypatch, kind, d, groups, chunk):
    """``_tile_schedule_fwd_bf16`` with ``groups`` and ``chunk`` against the
    plain bf16 step, JAX and the Pallas kernel in interpret mode, and its
    count of skipped tiles."""
    monkeypatch.setenv("RABIT_PALLAS_INTERPRET", "1")
    q, k, v, m, l, o, mask, *_ = _masked_inputs(25, kind)
    q, k, v, o = (x[..., :d] for x in (q, k, v, o))
    q, k = (np.clip(np.round(x * 16) / 16, -4, 4).astype(np.float32)
            for x in (q, k))
    tq, tk, tv = _bf16_torch(q, k, v)
    tm, tl, to, tmask = _torch(m, l, o, mask)
    scale = _scale(d)
    got, skipped = _tile_schedule_fwd_bf16(tq, tk, tv, tm, tl, to, tmask,
                                           scale, groups, chunk)
    jmask = None if mask is None else jnp.asarray(mask)
    refs = {"plain": F.block_update_reference(tq, tk, tv, tm, tl, to, tmask,
                                              scale),
            "jax": _block_update(*_bf16_jax(q, k, v),
                                 *map(jnp.asarray, (m, l, o)), jmask, scale),
            "pallas": _pallas_fwd_bf16((kind, d), q, k, v, m, l, o, mask,
                                       scale)}
    for ref, want in refs.items():
        for name, g, w, rel in zip(("m'", "l'", "o'"), got, want,
                                   (BF16_ML_REL, BF16_ML_REL, BF16_O_REL)):
            _assert_rel(g.numpy(), w, rel, f"{name} vs {ref}")
    # tiles skipped a head in both passes. Causal (a running state), 3 x 3
    # tiles: the 3 above the diagonal in each pass. Row 0 masked (the first
    # step, m = NEG_INF), 3 x 4 tiles, 6 above the diagonal: pass 0 skips
    # them all, pass 1 none of row tile 0's, where row 0 keeps m' = NEG_INF.
    assert skipped == {"causal": 2 * (3 + 3), "causal, row 0 masked":
                       2 * (6 + 3), "tie": 0, "ragged": 0}[kind]


def _c_frag(lane, n, e):
    """(row, column) of element e of the 16 x 8 C tile n that a lane of
    mma.m16n8k16 holds."""
    g, t = divmod(lane, 4)
    return g + 8 * (e // 2), 8 * n + 2 * t + e % 2


def _a_frag(lane, r, half):
    """(row, k) of the low (0) or high (1) bf16 half of register r of the
    16 x 16 A fragment that a lane of mma.m16n8k16 holds."""
    g, t = divmod(lane, 4)
    return g + 8 * (r % 2), 2 * t + 8 * (r // 2) + half


@pytest.mark.parametrize("d", [13, 1])
def test_forward_bf16_p_stays_in_registers(d):
    """The bf16 forward's p from its C fragments straight into A
    fragments: for the 16-key k-step kk, A register 2 j + h of a lane packs
    elements 2 h (low half) and 2 h + 1 of C tile 2 kk + j, rounded to
    bf16. That puts each p of the warp's 16 rows x 64 keys where the A
    layout wants it, so the product over the four k-steps (bf16 mma, f32
    sums) is p.to(bf16) @ v in f32, here at odd D (V padded to 16
    columns with zeros)."""
    rng = np.random.default_rng(d)
    p = torch.from_numpy(rng.random((16, TILE)).astype(np.float32))
    v = torch.from_numpy(rng.standard_normal((TILE, d)).astype(
        np.float32)).to(BF16).float()
    a = torch.full((16, TILE), float("nan"))
    for kk in range(TILE // 16):
        for lane in range(32):
            for j in range(2):
                for h in range(2):
                    for half in range(2):
                        row, col = _c_frag(lane, 2 * kk + j, 2 * h + half)
                        a_row, a_k = _a_frag(lane, 2 * j + h, half)
                        a[a_row, 16 * kk + a_k] = p[row, col].to(BF16).float()
    assert torch.equal(a, p.to(BF16).float())
    v16 = torch.zeros(TILE, 16)
    v16[:, :d] = v
    pv = _mma16(torch.zeros(16, 16), [(a, v16)])
    np.testing.assert_array_equal(pv[:, d:].numpy(), 0)
    np.testing.assert_allclose(pv[:, :d].numpy(),
                               (p.to(BF16).float() @ v).numpy(), rtol=1e-6,
                               atol=1e-6)


def _split_bf16(x):
    """x (f32 torch) -> (hi, lo) as the bf16 kernels split an f32 operand:
    hi = bf16_rn(x), lo = bf16_rn(x - hi), both as f32."""
    hi = x.to(BF16).float()
    return hi, (x - hi).to(BF16).float()


def _mma16(acc, terms):
    """acc (f32) += the sum of the products a @ b in ``terms``, as the
    kernels' bf16 ``mma.sync.m16n8k16`` form it: k in steps of 16, each
    step's product of bf16 values exact (f64 here) and added to the f32
    sums, one term after another in the order given (a split operand's lo
    half first)."""
    k_n = terms[0][0].shape[1]
    for k0 in range(0, k_n, 16):
        for a, b in terms:
            acc = (acc.double() + a[:, k0:k0 + 16].double()
                   @ b[k0:k0 + 16].double()).float()
    return acc


def _mask_bits(mask, rows, cols):
    """The kernels' flags of a tile: 1 if a pair of it is unmasked, 2 if a
    pair is masked (no mask: every pair unmasked)."""
    if mask is None:
        return 1
    tile = mask[rows][:, cols]
    return (1 if not bool(tile.all()) else 0) | (2 if bool(tile.any())
                                                 else 0)


def _tile_schedule_bwd_bf16(q, k, v, m, l, o, mask, scale, cm, cl, co):
    """The backward's bf16 path as ``csrc/flash_block_bwd.cu`` computes it,
    head by head, with bf16 q, k and v. s = q k^T from the bf16 operands;
    co and ds split into bf16 halves (hi + lo); every product a bf16 one
    in k-steps of 16 with f32 sums, the small term first: dp = co_lo v^T +
    co_hi v^T, dq = ds_lo k + ds_hi k, dv = bf16(p)^T co_lo + bf16(p)^T
    co_hi (p rounded to bf16 against the scratch m'), dk = ds_lo^T q +
    ds_hi^T q; dq, dk and dv cast to bf16 at the stores. The tiles each
    pass visits are read from the mask's bits a tile (``mask_bits``, and
    for the column pass the m' of the scratch), by the f32 kernels' rules:
    pass 1 skips a tile with no unmasked pair once every row had a score
    above NEG_INF before the tile in hand, pass 2 every such tile, the
    column pass every such tile whose rows all have m' above NEG_INF.
    Returns the six gradients and the count of tiles skipped."""
    h_n, t_n, d_n = q.shape
    s_n = k.shape[1]
    q, k, v = (x.float() for x in (q, k, v))
    dq, dk, dv = (torch.zeros_like(x) for x in (q, k, v))
    dm, dl, do = (torch.zeros_like(x) for x in (m, l, o))
    mnew, trow, tie = (torch.zeros_like(m) for _ in range(3))
    skipped = [0]
    key_tiles = [slice(c, min(c + TILE, s_n)) for c in range(0, s_n, TILE)]
    row_tiles = [slice(r, min(r + TILE, t_n)) for r in range(0, t_n, TILE)]
    co_hi, co_lo = _split_bf16(co)

    def scores(h, rows, cols):
        s = _mma16(torch.zeros(rows.stop - rows.start, cols.stop - cols.start),
                   [(q[h, rows], k[h, cols].T)]) * scale
        return s if mask is None else s.masked_fill(mask[rows][:, cols],
                                                    NEG_INF)

    def dprod(h, rows, cols):
        zero = torch.zeros(rows.stop - rows.start, cols.stop - cols.start)
        return _mma16(zero, [(co_lo[h, rows], v[h, cols].T),
                             (co_hi[h, rows], v[h, cols].T)]) \
            + cl[h, rows, None]

    def ds(h, rows, cols):
        s = scores(h, rows, cols)
        g = dprod(h, rows, cols) * torch.exp(s - mnew[h, rows, None]) + \
            tie[h, rows, None] * (s == trow[h, rows, None])
        if mask is not None:
            g = g.masked_fill(mask[rows][:, cols], 0.0)
        return g * scale

    for h in range(h_n):
        for rows in row_tiles:
            bits = [_mask_bits(mask, rows, cols) for cols in key_tiles]
            m_in, cl_r = m[h, rows], cl[h, rows]
            t_run = torch.full_like(m_in, -float("inf"))
            n_run, sum_run, m_run = (torch.zeros_like(m_in),
                                     torch.zeros_like(m_in), m_in.clone())

            def seen(i, bits=bits):
                return not bits[i] & 1 and bool((t_run > NEG_INF).all())

            for cols in _schedule(key_tiles, seen, skipped):
                s = scores(h, rows, cols)
                dp = dprod(h, rows, cols)
                tmax = s.amax(dim=1)
                cnt = (s == tmax[:, None]).sum(dim=1).to(m.dtype)
                n_run = torch.where(t_run > tmax, n_run, torch.where(
                    t_run < tmax, cnt, n_run + cnt))
                t_run = torch.maximum(t_run, tmax)
                m_new = torch.maximum(m_in, t_run)
                sum_run = sum_run * torch.exp(m_run - m_new) + (
                    dp * torch.exp(s - m_new[:, None])).sum(dim=1)
                m_run = m_new
            alpha = torch.exp(m_in - m_run)
            dalpha = cl_r * l[h, rows] + (co[h, rows] * o[h, rows]).sum(1)
            dm_new = cm[h, rows] - dalpha * alpha - sum_run
            sel = torch.where(m_in > t_run, 1.0,
                              torch.where(m_in < t_run, 0.0, 0.5))
            dm[h, rows] = dalpha * alpha + dm_new * sel
            dl[h, rows] = cl_r * alpha
            do[h, rows] = co[h, rows] * alpha[:, None]
            mnew[h, rows], trow[h, rows] = m_run, t_run
            tie[h, rows] = dm_new * (1.0 - sel) / n_run
            acc = torch.zeros(rows.stop - rows.start, d_n)
            for cols in _schedule(key_tiles, lambda i, bits=bits:
                                  not bits[i] & 1, skipped):
                ds_hi, ds_lo = _split_bf16(ds(h, rows, cols))
                acc = _mma16(acc, [(ds_lo, k[h, cols]), (ds_hi, k[h, cols])])
            dq[h, rows] = acc
        for cols in key_tiles:
            bits = [_mask_bits(mask, rows, cols)
                    | (4 if bool((mnew[h, rows] <= NEG_INF).any()) else 0)
                    for rows in row_tiles]
            acc_k = torch.zeros(cols.stop - cols.start, d_n)
            acc_v = torch.zeros(cols.stop - cols.start, d_n)
            for rows in _schedule(row_tiles, lambda i, bits=bits:
                                  not bits[i] & 5, skipped):
                p = torch.exp(scores(h, rows, cols) - mnew[h, rows, None])
                acc_v = _mma16(acc_v, [(p.to(BF16).float().T, co_lo[h, rows]),
                                       (p.to(BF16).float().T, co_hi[h, rows])])
                ds_hi, ds_lo = _split_bf16(ds(h, rows, cols))
                acc_k = _mma16(acc_k, [(ds_lo.T, q[h, rows]),
                                       (ds_hi.T, q[h, rows])])
            dk[h, cols], dv[h, cols] = acc_k, acc_v
    return ((dq.to(BF16), dk.to(BF16), dv.to(BF16), dm, dl, do),
            skipped[0])


@pytest.mark.parametrize("kind,d", [("causal", D),
                                    ("causal, row 0 masked", 16),
                                    ("tie", D), ("ragged", 16),
                                    ("ragged", 13), ("ragged", 1)])
def test_backward_bf16_tile_schedule_matches_plain_and_pallas(monkeypatch,
                                                              kind, d):
    """The bf16 backward's algorithm (bf16 products of k 16 with co and ds
    split into bf16 halves, p rounded to bf16 for dv alone against the
    scratch m', f32 sums, bf16 casts at the stores, the skip rules read
    from the mask's bits, odd D) before it reaches the card: against the
    plain bf16 backward and ``PK.flash_block_bwd`` in interpret mode.
    dq, dk and dv within 1e-3 of their largest plus one bf16 step of the
    value (an f32 sum cast to bf16 flips where two orders of summation
    differ in the last bit); dm, dl and do within 1e-5 of their largest
    against the plain backward, 1e-3 against Pallas (the frameworks' f32
    sums in other orders)."""
    monkeypatch.setenv("RABIT_PALLAS_INTERPRET", "1")
    q, k, v, m, l, o, mask, cm, cl, co = _masked_inputs(26, kind)
    q, k, v, o, co = (x[..., :d] for x in (q, k, v, o, co))
    q, k = (np.clip(np.round(x * 16) / 16, -4, 4).astype(np.float32)
            for x in (q, k))
    tq, tk, tv = _bf16_torch(q, k, v)
    tm, tl, to, tmask, tcm, tcl, tco = _torch(m, l, o, mask, cm, cl, co)
    scale = _scale(d)
    got, skipped = _tile_schedule_bwd_bf16(tq, tk, tv, tm, tl, to, tmask,
                                           scale, tcm, tcl, tco)
    # the mask's bits pick the tiles the f32 kernels' rules pick
    assert skipped == _tile_schedule_bwd(
        tq.float(), tk.float(), tv.float(), tm, tl, to, tmask, scale, tcm,
        tcl, tco)[1]
    plain = F.block_update_bwd_reference(tq, tk, tv, tm, tl, to, tmask,
                                         scale, tcm, tcl, tco)
    pallas = PK.flash_block_bwd(
        *_bf16_jax(q, k, v), *map(jnp.asarray, (m, l, o)),
        None if mask is None else jnp.asarray(mask.astype(np.int8)), scale,
        *map(jnp.asarray, (cm, cl, co)))
    for ref, want, f32_rel in (("plain", plain, 1e-5),
                               ("pallas", pallas, BF16_GRAD_REL)):
        for name, g, w in zip(NAMES, got, want):
            w = np.asarray(w.float() if isinstance(w, torch.Tensor)
                           else w.astype(jnp.float32), np.float64)
            bf16 = name in ("dq", "dk", "dv")
            assert g.dtype == (BF16 if bf16 else torch.float32), name
            err = np.abs(g.float().numpy() - w)
            bound = (BF16_GRAD_REL if bf16 else f32_rel) * np.abs(w).max()
            if bf16:
                bound = bound + _bf16_steps(w)
            assert (err <= bound).all(), \
                f"{name} vs {ref}: {err.max():.3g} of max {np.abs(w).max():.3g}"


def test_split_tf32_keeps_every_bf16_value_whole():
    """Every finite bf16 value, widened to f32, splits by the f32
    kernels' TF32 rule (to nearest, ties away, 10 mantissa bits) into
    itself and 0, so the 3xTF32 products take a bf16 operand exactly. All
    65536 bit patterns less the 256 inf and NaN."""
    bits = np.arange(1 << 16, dtype=np.uint32) << np.uint32(16)
    x = bits.view(np.float32)
    x = x[np.isfinite(x)]
    assert x.size == (1 << 16) - 256
    big, small = _split_tf32(x)
    np.testing.assert_array_equal(big.view(np.uint32), x.view(np.uint32))
    assert not small.view(np.uint32).any()


def test_bf16_split_reconstructs_within_2_to_minus_16():
    """The bf16 backward's split of an f32 operand (co, ds): hi and lo are
    bf16 values, hi + lo holds x within 2^-16 |x| over f32 values spread
    across 1e-30 to 1e30, and every finite bf16 value splits into itself
    and 0."""
    rng = np.random.default_rng(14)
    n = 200_000
    x = (rng.choice([-1.0, 1.0], n)
         * 10.0 ** rng.uniform(-30, 30, n)).astype(np.float32)
    hi, lo = (t.numpy() for t in _split_bf16(torch.from_numpy(x)))
    for part in (hi, lo):
        assert not (part.view(np.uint32) & np.uint32(0xFFFF)).any()
    err = np.abs(x.astype(np.float64) - hi.astype(np.float64) - lo)
    assert (err <= 2.0 ** -16 * np.abs(x.astype(np.float64))).all()
    bits = np.arange(1 << 16, dtype=np.uint32) << np.uint32(16)
    y = bits.view(np.float32)
    y = y[np.isfinite(y)]
    hi, lo = (t.numpy() for t in _split_bf16(torch.from_numpy(y)))
    np.testing.assert_array_equal(hi.view(np.uint32), y.view(np.uint32))
    assert not lo.view(np.uint32).any()


@pytest.mark.parametrize("width", [16, 32, 64, 128])
def test_bf16_split_dot_is_within_1e5_of_f64(width):
    """The tolerance of the split: a 64 x 64 tile product of a split f32
    operand and a bf16 operand, k in steps of 16 (lo then hi), within
    1e-5 of f64 (max|diff| / max|ref|), where rounding the f32 operand
    once to bf16 is off by about 2e-3."""
    rng = np.random.default_rng(width)
    a = torch.from_numpy(rng.standard_normal((64, width)).astype(np.float32))
    b = torch.from_numpy(rng.standard_normal((64, width)).astype(
        np.float32)).to(BF16).float()
    ref = a.double() @ b.double().T
    hi, lo = _split_bf16(a)
    got = _mma16(torch.zeros(64, 64), [(lo, b.T), (hi, b.T)])
    rel = float((got.double() - ref).abs().max() / ref.abs().max())
    one = a.to(BF16).double() @ b.double().T
    assert rel <= 1e-5
    assert float((one - ref).abs().max() / ref.abs().max()) > 1e-3
