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
