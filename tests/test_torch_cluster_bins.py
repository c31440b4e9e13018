"""The binning kernels' schedule (``csrc/cluster_bins.cuh``, under
``csrc/histogram.cu`` and ``csrc/mask_only.cu``), modelled in numpy and
held against the plain versions and the JAX package.

The CUDA kernels run only on the card. Here a model walks the same
decomposition: the host's ``plan`` (the grid the C entry points take),
the rows each block reads (16-byte groups of four, then the rest one by
one), the blocks starting in an order drawn from a seed (the first of a
bin tile zeroes the tile's output and publishes the call's generation),
each block's shared copy of its bin tile (the histogram's grad sums,
then its hess sums), the cluster flush (block r of a cluster sums slice
r of the cluster's copies, its own first) and the reductions into the
output, in an order drawn from the seed. The model's histogram is held
to ``histogram_reference`` and to the TPU kernel in interpret mode; its
bin count to the JAX tool's ``mask_only`` and the plain version, bit for
bit."""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rabit_tpu_torch.ops import histogram as K

CSRC = Path(K.__file__).resolve().parent.parent / "csrc"


def _const(source, name):
    """An ``int`` constant of a kernel source, as the library reports it."""
    text = (CSRC / source).read_text()
    return int(re.search(rf"constexpr int {name} = (\d+);", text).group(1))


MAX_TILE = {name: _const(f"{name}.cu", "kMaxTile")
            for name in ("histogram", "mask_only")}
# the card the kernels run on: 132 SMs, which hold 30 clusters of 8 at
# two blocks an SM (15 at one), as the library reported on an H100
H100 = K.Shape(threads=_const("cluster_bins.cuh", "kThreads"),
               cluster=_const("cluster_bins.cuh", "kCluster"),
               blocks_per_sm=_const("cluster_bins.cuh", "kMaxBlocksPerSm"),
               sms=132, max_clusters=30, max_tile=MAX_TILE["histogram"])
# a small device, so that small inputs take many clusters and tiles
TOY = K.Shape(threads=32, cluster=4, blocks_per_sm=2, sms=16,
              max_clusters=8, max_tile=96)


def _blocks_of_rows(n, p, shape):
    """The block (x) that reads each row: of the first 4 * groups rows,
    group row // 4 goes to thread (row // 4) mod (grid x * threads); a
    later row to thread (row - 4 * groups) mod (grid x * threads)."""
    r = np.arange(n)
    item = np.where(r < 4 * p.groups, r // 4, r - 4 * p.groups)
    return (item % (p.clusters * shape.cluster * shape.threads)) \
        // shape.threads


def model(bins, values, nbins, shape, aligned, state, gen, out=None,
          seed=0):
    """One call as the kernels run it; returns (out, zeroings): the output
    (values None: the bin count, u32 copies summed as u32, added as f32;
    else the (grad, hess) sums in f32 of values already rounded for
    "fast"), and how often each output word was zeroed. ``state`` holds
    the (started, zeroed) words of each tile and is updated; ``out`` is
    what the output held before (garbage: NaN by default). Blocks start,
    and clusters reduce, in orders drawn from ``seed``."""
    n = bins.shape[0]
    words = 1 if values is None else 2
    p = K.plan(n, nbins, aligned, shape)
    c_n = shape.cluster
    acc_t = np.uint32 if values is None else np.float32
    out = np.full(nbins * words, np.nan, np.float32) if out is None \
        else out.reshape(-1).copy()
    zeroings = np.zeros(nbins * words, np.int64)
    block = _blocks_of_rows(n, p, shape)
    rng = np.random.default_rng(seed)
    for y in range(p.tiles):
        lo = y * p.tile
        width = min(p.tile, nbins - lo)
        v1 = -(-width // 4)   # vectors of one word of the bins
        # the blocks of the tile start; the first to lift "started" to gen
        # zeroes the tile's output and publishes gen in "zeroed"
        for _ in rng.permutation(p.clusters * c_n):
            first = state[y, 0] < gen
            state[y, 0] = max(state[y, 0], gen)
            if first:
                out[words * lo:words * (lo + width)] = 0.0
                zeroings[words * lo:words * (lo + width)] += 1
                state[y, 1] = gen
        # one unsigned compare: ids below lo wrap past every tile
        rel = (bins.astype(np.int64) - lo) & 0xFFFFFFFF
        keep = rel < width
        # each block's shared copy: word k of bin b at k * 4 v1 + b
        copies = np.zeros((p.clusters * c_n, words * 4 * v1), acc_t)
        for k in range(words):
            add = np.ones(int(keep.sum()), acc_t) if values is None \
                else values[keep, k]
            np.add.at(copies, (block[keep], k * 4 * v1 + rel[keep]), add)
        copies = copies.reshape(p.clusters, c_n, words, v1, 4)
        per = -(-v1 // c_n)
        assert state[y, 1] >= gen   # every block's wait passes
        # block r of each cluster: slice r of the quads (four bins, every
        # word) summed over the cluster's copies, its own first, then
        # added into the output (zeros skipped), the blocks in an order
        # drawn from the seed
        for slot in rng.permutation(p.clusters * c_n):
            c, r = divmod(int(slot), c_n)
            s0, s1 = min(v1, r * per), min(v1, r * per + per)
            acc = copies[c, r, :, s0:s1].copy()
            for k in range(1, c_n):
                acc += copies[c, (r + k) % c_n, :, s0:s1]
            b = 4 * np.arange(s0, s1)
            for word in range(words):
                for j in range(4):
                    ok = (b + j < width) & (acc[word, :, j] != 0)
                    at = words * (lo + b[ok] + j) + word
                    out[at] += acc[word, ok, j].astype(np.float32)
    if values is None:
        return out, zeroings
    return out.reshape(nbins, 2), zeroings.reshape(nbins, 2)


def _rows(n, nbins, seed, lo=0, hi=None, edge=False):
    rng = np.random.default_rng(seed)
    b = rng.integers(lo, nbins if hi is None else hi, n).astype(np.int32)
    if edge:
        b[::7] = nbins
        b[3::11] = -1
        b[5::13] = np.iinfo(np.int32).min
        b[6::17] = 1 << 30
    g = rng.standard_normal(n).astype(np.float32)
    h = rng.random(n).astype(np.float32)
    return b, g, h


def _values(g, h, precision):
    gh = torch.from_numpy(np.stack([g, h], axis=1))
    if precision == "fast":
        gh = gh.to(torch.bfloat16).to(torch.float32)
    return gh.numpy()


# -- the plan ---------------------------------------------------------------

@pytest.mark.parametrize("case", [
    # rows, bins, aligned, the clusters the card holds at once (two blocks
    # an SM up to 113 KB of shared memory, one above) -> tile, tiles,
    # clusters, groups
    ((1 << 21, 1024, True, 30), (1024, 1, 30, 1 << 19)),
    ((3_670_016, 7168, True, 30), (7168, 1, 30, 917_504)),
    # the widest tile of the histogram's tests, and three tiles of the
    # bin count sharing the clusters
    ((100_000, 16_640, True, 15), (16_640, 1, 7, 25_000)),
    ((1_000_003, 120_000, False, 15), (57_344, 3, 5, 0)),
    # 25 blocks of rows: not a whole number of clusters, rounded up to 4
    ((4 * 512 * 24 + 8, 1000, True, 30), (1000, 1, 4, 512 * 24 + 2)),
    # 3 blocks; no rows at all: one cluster still zeroes the output
    ((3 * 2048, 64, True, 30), (64, 1, 1, 3 * 512)),
    ((0, 64, True, 30), (64, 1, 1, 0)),
])
def test_plan_rules(case):
    (n, nbins, aligned, held), want = case
    kernel = "mask_only" if nbins == 120_000 else "histogram"
    shape = H100._replace(max_clusters=held, max_tile=MAX_TILE[kernel])
    p = K.plan(n, nbins, aligned, shape)
    assert tuple(p) == want
    assert p.tiles == 1 or p.tile == shape.max_tile   # plan_ok's rule
    assert p.clusters * p.tiles <= held
    assert p.clusters * shape.cluster <= shape.sms * shape.blocks_per_sm


def test_kernel_constants_fit_the_plan():
    """The sources' constants that the plan and the tests rely on: the
    card's configuration above, tiles that fit one block's shared memory
    beside the static words and start output tiles on 16-byte
    boundaries, both kernels on the one skeleton."""
    assert (H100.threads, H100.cluster, H100.blocks_per_sm) == (512, 8, 2)
    for name, words in (("histogram", 2), ("mask_only", 1)):
        tile = MAX_TILE[name]
        assert words * 4 * tile <= 232_448 - 16
        assert tile % 4 == 0
        assert '#include "cluster_bins.cuh"' in (CSRC / f"{name}.cu"
                                                  ).read_text()


def _fresh_state(nbins, shape):
    return np.zeros((K.plan(0, nbins, True, shape).tiles, 2), np.uint64)


# -- the histogram ----------------------------------------------------------

HIST_CASES = {
    # ragged rows in an unaligned view: no 16-byte groups, all rows single
    "ragged unaligned": (TOY, 3001, 50, False, False),
    "out-of-range ids": (TOY, 4099, 90, True, True),
    # 300 bins over four tiles of 96 (the last one 12 wide)
    "four tiles": (TOY, 2500, 300, True, True),
    # the card's constants; 25 blocks of rows round up to 4 clusters
    "grid rounded to clusters": (H100, 4 * 512 * 24 + 8, 1000, True, False),
}


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("case", sorted(HIST_CASES))
def test_histogram_schedule_matches_reference(case, precision):
    """f32 sums of the same values in another order: within the CPU
    tests' tolerance of the plain version (rtol 1e-5, atol 1e-4 at
    these small row counts); every output word is zeroed once, by the
    first block of its tile."""
    shape, n, nbins, aligned, edge = HIST_CASES[case]
    b, g, h = _rows(n, nbins, seed=n, edge=edge)
    state = _fresh_state(nbins, shape)
    got, zeroings = model(b, _values(g, h, precision), nbins, shape,
                          aligned, state, gen=1, seed=1)
    want = K.histogram_reference(*(torch.from_numpy(a) for a in (b, g, h)),
                                 nbins, precision).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)
    assert (zeroings == 1).all()
    assert (state == 1).all()


@pytest.mark.parametrize("precision", ["fast", "high"])
def test_histogram_schedule_matches_jax_kernel(monkeypatch, precision):
    """16384 rows (one TPU-kernel chunk) over 200 bins on the small
    device (three tiles, two clusters each): the TPU kernel in interpret
    mode, within tests/test_torch_histogram.py's tolerance."""
    monkeypatch.setenv("RABIT_PALLAS_INTERPRET", "1")
    from rabit_tpu.ops.pallas_kernels import histogram_tpu
    nbins = 200
    b, g, h = _rows(16384, nbins, seed=3)
    assert K.plan(16384, nbins, True, TOY)[1:3] == (3, 2)
    got, _ = model(b, _values(g, h, precision), nbins, TOY, True,
                   _fresh_state(nbins, TOY), gen=1)
    want = np.asarray(histogram_tpu(jnp.asarray(b), jnp.asarray(g),
                                    jnp.asarray(h), nbins,
                                    precision=precision))
    tol = dict(rtol=1e-5, atol=1e-4 if precision == "fast" else 1e-3)
    np.testing.assert_allclose(got, want, **tol)


def test_calls_in_sequence_share_the_state_words():
    """Calls of both kernels in turn on one state buffer, each into the
    last one's output (not zero), with the generations the wrapper gives
    them (one count for both kernels): each zeroes its output once; a
    generation that never ran (a refused launch) is skipped without harm;
    the words end at the last generation."""
    nbins = 300
    b, g, h = _rows(2500, nbins, seed=7, edge=True)
    gh = _values(g, h, "high")
    state = _fresh_state(nbins, TOY)
    hist = K.histogram_reference(*(torch.from_numpy(a) for a in (b, g, h)),
                                 nbins, "high").numpy()
    count = K.mask_only_reference(torch.from_numpy(b), nbins).numpy()
    out_h, out_c = None, None
    for gen in (1, 3, 6):   # 5: a launch that never ran
        out_h, zh = model(b, gh, nbins, TOY, True, state, gen, out_h,
                          seed=gen)
        out_c, zc = model(b, None, nbins, TOY, False, state, gen + 1,
                          out_c, seed=gen)
        np.testing.assert_allclose(out_h, hist, rtol=1e-5, atol=1e-4)
        assert np.array_equal(out_c, count)
        assert (zh == 1).all() and (zc == 1).all()
    assert (state == 7).all()


# -- the bin count ----------------------------------------------------------

@pytest.mark.parametrize("shape_name", ["toy", "h100"])
def test_count_schedule_equals_jax_tool(monkeypatch, shape_name):
    """The bin count's schedule against the JAX tool's own ``mask_only``
    (taken out of tools/histogram_sweep.py, interpret mode), bit for bit:
    2^15 rows (two TPU chunks) over 1000 bins, ids from -3 to nbins + 39
    (the small device with tiles of 400 bins: three tiles, two clusters
    each)."""
    from tests.test_torch_mask_only import _jax_mask_only
    monkeypatch.setenv("RABIT_PALLAS_INTERPRET", "1")
    shape = TOY._replace(max_tile=400) if shape_name == "toy" else \
        H100._replace(max_tile=MAX_TILE["mask_only"])
    nbins = 1000
    b = _rows(1 << 15, nbins, seed=5, lo=-3, hi=nbins + 40)[0]
    got, zeroings = model(b, None, nbins, shape, True,
                          _fresh_state(nbins, shape), gen=1, seed=2)
    want = np.asarray(_jax_mask_only()(jnp.asarray(b), nbins))
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert (zeroings == 1).all()


@pytest.mark.parametrize("case", [
    # ragged and unaligned; four tiles; the card's constants with three
    # tiles of 57,344 bins, unaligned
    (TOY, 5003, 77, False), (TOY, 4097, 333, True),
    (H100, 70_001, 120_000, False)])
def test_count_schedule_equals_plain_version(case):
    """Exact counts in any order: bit for bit the plain version's, for
    every order of starts and reductions."""
    shape, n, nbins, aligned = case
    if shape is H100:
        shape = H100._replace(max_tile=MAX_TILE["mask_only"])
    b = _rows(n, nbins, seed=n, lo=-3, hi=nbins + 41, edge=True)[0]
    want = K.mask_only_reference(torch.from_numpy(b), nbins).numpy()
    for seed in range(2):
        got, zeroings = model(b, None, nbins, shape, aligned,
                              _fresh_state(nbins, shape), gen=1, seed=seed)
        assert np.array_equal(got, want)
        assert (zeroings == 1).all()
