"""The port's collectives, histogram allreduce and torch engine against
numpy and the JAX package, in real gloo worlds of 2 and 4 processes.

One spawn per world size (``tests/torch_world.py``) runs every check of
that world (the ranks meet in a ``FileStore`` under ``tmp_path``, so no
port can race); each rank saves its results and the tests below compare
them with numpy and with the JAX functions on the same inputs (a p-device
slice of the 8-device virtual CPU mesh). This module imports neither JAX
nor ``rabit_tpu`` at its top: the spawned ranks import it.

``test_nccl_world_on_the_cards`` runs the same world over NCCL, one rank
per card (up to 4), with the histogram built by the CUDA kernel. It is
marked ``cuda`` and skips without two cards. On a machine with cards and
no JAX (so without ``tests/conftest.py``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_collectives.py
"""

import pickle

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rabit_tpu_torch.ops.reducers import BITOR, MAX, MIN, SUM, numpy_reduce
from torch_world import spawn_world
N_TREE = 37            # tree payload length
N_RING = 1003          # ring payload: divides by neither 2 nor 4
ROWS = 2048            # histogram rows per rank
NBINS_TREE = 64        # 64*2 < 32768 floats: the tree
NBINS_RING = 16384     # 16384*2 >= 32768 floats: the ring
DTYPES = ("int32", "int64", "uint32", "uint64", "float32")
OPS = (SUM, MAX, MIN, BITOR)
CASES = [(d, op) for d in DTYPES for op in OPS
         if not (op == BITOR and d == "float32")]


def _case_inputs(p: int) -> dict:
    """Every rank's inputs, [p, ...] numpy arrays made from one seed."""
    rng = np.random.default_rng(100 + p)
    inputs = {}
    for d, op in CASES:
        dt = np.dtype(d)
        if dt.kind == "f":
            a = rng.standard_normal((p, N_TREE)).astype(dt)
        else:  # full range: unsigned values with the top bit set included
            info = np.iinfo(dt)
            a = rng.integers(info.min, info.max, size=(p, N_TREE),
                             dtype=dt, endpoint=True)
        inputs[f"tree_{d}_{op}"] = a
    inputs["ring_f32"] = rng.standard_normal((p, N_RING)).astype(np.float32)
    inputs["ring_u32_max"] = rng.integers(0, 2**32, size=(p, N_RING),
                                          dtype=np.uint32)
    inputs["rs"] = rng.standard_normal((p, 8 * p)).astype(np.float32)
    inputs["ag"] = rng.integers(-1000, 1000, size=(p, 5)).astype(np.int64)
    inputs["bcast"] = rng.standard_normal((p, 9)).astype(np.float32)
    for name, nbins in (("dh_tree", NBINS_TREE), ("dh_ring", NBINS_RING)):
        rng_h = np.random.default_rng(7 + nbins)
        inputs[f"{name}_grad"] = rng_h.standard_normal(
            (p, ROWS)).astype(np.float32)
        inputs[f"{name}_hess"] = rng_h.random((p, ROWS)).astype(np.float32)
        inputs[f"{name}_bins"] = rng_h.integers(
            0, nbins, size=(p, ROWS)).astype(np.int32)
    inputs["engine_sum"] = rng.standard_normal(
        (p, 40000)).astype(np.float32)                    # ring in engine
    inputs["engine_u32"] = rng.integers(0, 2**32, size=(p, 6),
                                        dtype=np.uint32)
    return inputs


def _rank_main(rank: int, p: int, inputs: dict, backend: str) -> dict:
    """One rank of the world: run every check, return what it got. gloo
    runs on the CPU with the ``"scatter"`` histogram (what the JAX
    comparison uses); NCCL on card ``rank`` with the CUDA kernel."""
    import rabit_tpu_torch as rabit
    from rabit_tpu_torch.models.histogram import distributed_histogram
    from rabit_tpu_torch.parallel import collectives as C

    if backend == "nccl":
        dev, method = torch.device("cuda", rank), "auto"
    else:
        dev, method = torch.device("cpu"), "scatter"
    got = {}

    def mine(key):
        return torch.from_numpy(inputs[key][rank].copy()).to(dev)

    def host(t):
        return t.cpu().numpy()

    for d, op in CASES:
        key = f"tree_{d}_{op}"
        x = mine(key)
        got[key] = host(C.tree_allreduce(x, None, op))
        got[f"ring_{d}_{op}"] = host(C.ring_allreduce(x, None, op))
        assert host(x).tobytes() == inputs[key][rank].tobytes(), \
            "input was modified"
    got["ring_f32"] = host(C.ring_allreduce(mine("ring_f32")))
    got["ring_u32_max"] = host(C.ring_allreduce(
        mine("ring_u32_max"), None, MAX))
    got["rs"] = host(C.ring_reduce_scatter(mine("rs")))
    got["ag"] = host(C.ring_all_gather(mine("ag")))
    got["bcast"] = host(C.bcast_from_root(mine("bcast"), None,
                                          root=p - 1))
    for name, nbins in (("dh_tree", NBINS_TREE),
                        ("dh_ring", NBINS_RING)):
        got[name] = host(distributed_histogram(
            mine(f"{name}_grad"), mine(f"{name}_hess"),
            mine(f"{name}_bins"), nbins, method=method))

    # the host API on the torch engine, which adopts this group
    rabit.init([f"rabit_device={dev.type}"], engine="torch")
    got["engine_rank_world"] = np.array(
        [rabit.get_rank(), rabit.get_world_size(),
         rabit.is_distributed()])
    prepared = []
    got["engine_sum"] = rabit.allreduce(
        inputs["engine_sum"][rank].copy(), rabit.SUM,
        prepare_fun=lambda a: prepared.append(a.size))
    got["engine_prepared"] = np.array(prepared)
    got["engine_u32"] = rabit.allreduce(
        inputs["engine_u32"][rank].copy(), rabit.MAX)
    got["engine_bitor"] = rabit.allreduce(
        np.array([1 << rank, 3], np.int64), rabit.BITOR)
    eng = rabit._engine
    got["engine_rs"] = eng.reduce_scatter(inputs["rs"][rank].copy(),
                                          rabit.SUM)
    got["engine_ag"] = eng.allgather(inputs["ag"][rank].copy())
    got["engine_async"] = eng.allreduce_async(
        inputs["engine_u32"][rank].copy(), rabit.MAX).wait()
    obj = rabit.broadcast({"from": rank, "arr": np.arange(3)}
                          if rank == 1 else None, 1)
    got["engine_bcast"] = np.frombuffer(pickle.dumps(obj), np.uint8)
    rabit.checkpoint({"round": 1})
    rabit.checkpoint({"round": 2})
    version, model = rabit.load_checkpoint()
    got["engine_ckpt"] = np.array([version, model["round"]])
    rabit.finalize()
    assert dist.is_initialized(), "engine destroyed a group it adopted"
    return got


def _spawn_world(p: int, tmp_path, backend: str = "gloo") -> list:
    return spawn_world(_rank_main, p, tmp_path, _case_inputs(p), backend,
                       backend=backend)


@pytest.fixture(scope="module", params=[2, 4], ids=["p2", "p4"])
def world(request, tmp_path_factory):
    p = request.param
    ranks = _spawn_world(p, tmp_path_factory.mktemp(f"world{p}"))
    return p, _case_inputs(p), ranks


def _np_fold(a: np.ndarray, op: int) -> np.ndarray:
    acc = a[0].copy()
    for r in range(1, a.shape[0]):
        numpy_reduce(acc, a[r], op)
    return acc


def _ring_sum_in_schedule_order(xs: np.ndarray) -> np.ndarray:
    """The f32 SUM ring of [p, n] inputs emulated in numpy, in the JAX
    ring's order: zero-pad to a multiple of p; at step s rank r adds
    chunk (r-s-2) mod p received from rank r-1 into its own; rank c ends
    owning chunk c."""
    p, n = xs.shape
    x = np.concatenate([xs, np.zeros((p, (-n) % p), xs.dtype)], axis=1)
    x = x.reshape(p, p, -1).copy()            # [rank, chunk, m]
    for step in range(p - 1):
        sent = [x[r, (r - step - 1) % p].copy() for r in range(p)]
        for r in range(p):
            x[r, (r - step - 2) % p] += sent[(r - 1) % p]
    return np.concatenate([x[c, c] for c in range(p)])[:n]


def test_every_rank_ends_with_the_same_bits(world):
    p, _, ranks = world
    for key in ranks[0]:
        if key in ("rs", "engine_rs", "engine_rank_world"):
            continue  # rank-specific by design
        for r in range(1, p):
            assert ranks[r][key].tobytes() == ranks[0][key].tobytes(), \
                f"{key}: rank {r} differs from rank 0"


@pytest.mark.parametrize("dtype,op", CASES,
                         ids=[f"{d}-{op}" for d, op in CASES])
def test_tree_and_ring_allreduce_match_numpy(world, dtype, op):
    p, inputs, ranks = world
    want = _np_fold(inputs[f"tree_{dtype}_{op}"], op)
    for kind in ("tree", "ring"):
        got = ranks[0][f"{kind}_{dtype}_{op}"]
        assert got.dtype == want.dtype
        if dtype == "float32" and op == SUM:
            # gloo's tree sums in another order than numpy: f32 rounding
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
        else:
            np.testing.assert_array_equal(got, want)


def test_ring_allreduce_bit_identical_to_jax_ring(world):
    """f32 SUM over a length that divides by neither 2 nor 4: the port's
    ring takes the JAX ring's chunk offsets, so every sum is taken in the
    same order and the bits agree."""
    from rabit_tpu.parallel import make_mesh
    from rabit_tpu.parallel.collectives import device_allreduce, shard_over
    p, inputs, ranks = world
    mesh = make_mesh(p)
    want = np.asarray(device_allreduce(
        shard_over(mesh, inputs["ring_f32"]), mesh, SUM, method="ring",
        wire=None))
    assert ranks[0]["ring_f32"].tobytes() == want.tobytes()
    emulated = _ring_sum_in_schedule_order(inputs["ring_f32"])
    assert emulated.tobytes() == want.tobytes()
    np.testing.assert_array_equal(ranks[0]["ring_u32_max"],
                                  inputs["ring_u32_max"].max(axis=0))


def test_ring_reduce_scatter_rank_i_owns_chunk_i(world):
    p, inputs, ranks = world
    total = _np_fold(inputs["rs"], SUM).reshape(p, -1)
    for r in range(p):
        for key in ("rs", "engine_rs"):  # the collective, the engine's
            np.testing.assert_allclose(ranks[r][key], total[r], rtol=1e-6,
                                       atol=1e-6)


def test_ring_all_gather_and_bcast_from_root(world):
    p, inputs, ranks = world
    np.testing.assert_array_equal(ranks[0]["ag"], inputs["ag"].reshape(-1))
    np.testing.assert_array_equal(ranks[0]["engine_ag"],
                                  inputs["ag"].reshape(-1))
    np.testing.assert_array_equal(ranks[0]["bcast"], inputs["bcast"][p - 1])


@pytest.mark.parametrize("name,nbins", [("dh_tree", NBINS_TREE),
                                        ("dh_ring", NBINS_RING)])
def test_distributed_histogram_matches_jax(world, name, nbins):
    """Same per-rank rows through the JAX ``distributed_histogram`` on a
    p-device mesh (scatter method; the ring above 32768 floats) and the
    port's over gloo. Both sum f32 per bin; the per-rank sums can differ in
    their last bit, hence the tolerance."""
    from rabit_tpu.models import histogram as JH
    from rabit_tpu.parallel import make_mesh
    from rabit_tpu.parallel.collectives import shard_over
    p, inputs, ranks = world
    arrs = [inputs[f"{name}_{k}"] for k in ("grad", "hess", "bins")]
    mesh = make_mesh(p)
    want = np.asarray(JH.distributed_histogram(
        *(shard_over(mesh, a) for a in arrs), nbins, mesh, "workers",
        "scatter"))
    np.testing.assert_allclose(ranks[0][name], want, rtol=1e-6, atol=1e-5)
    oracle = sum(JH.host_histogram(arrs[0][r], arrs[1][r], arrs[2][r], nbins)
                 .astype(np.float64) for r in range(p))
    np.testing.assert_allclose(ranks[0][name], oracle, rtol=1e-5, atol=1e-4)


def test_torch_engine_host_api_in_a_world(world):
    p, inputs, ranks = world
    for r in range(p):
        np.testing.assert_array_equal(ranks[r]["engine_rank_world"],
                                      [r, p, 1])
        np.testing.assert_array_equal(ranks[r]["engine_prepared"], [40000])
        np.testing.assert_array_equal(ranks[r]["engine_ckpt"], [2, 2])
    np.testing.assert_allclose(ranks[0]["engine_sum"],
                               _np_fold(inputs["engine_sum"], SUM),
                               rtol=1e-5, atol=1e-5)
    for key in ("engine_u32", "engine_async"):
        np.testing.assert_array_equal(ranks[0][key],
                                      inputs["engine_u32"].max(axis=0))
    np.testing.assert_array_equal(ranks[0]["engine_bitor"],
                                  [(1 << p) - 1, 3])
    obj = pickle.loads(ranks[0]["engine_bcast"].tobytes())
    assert obj["from"] == 1
    np.testing.assert_array_equal(obj["arr"], np.arange(3))


@pytest.fixture(scope="module")
def nccl_world(tmp_path_factory):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs at least two CUDA devices")
    from rabit_tpu_torch.ops import _build
    _build.build()  # once here, not in every rank
    p = min(4, torch.cuda.device_count())
    ranks = _spawn_world(p, tmp_path_factory.mktemp(f"nccl{p}"), "nccl")
    return p, _case_inputs(p), ranks


@pytest.mark.cuda
def test_nccl_world_on_the_cards(nccl_world):
    """The gloo world's numpy checks, run on the NCCL world: same bits on
    every rank, tree/ring/RS/AG/bcast and the torch engine; the f32 ring in
    the JAX ring's order bit for bit; the histogram allreduce (CUDA kernel,
    atomic order) against the f64 oracle."""
    from rabit_tpu_torch.models.histogram import host_histogram
    p, inputs, ranks = nccl_world
    test_every_rank_ends_with_the_same_bits(nccl_world)
    for dtype, op in CASES:
        test_tree_and_ring_allreduce_match_numpy(nccl_world, dtype, op)
    assert ranks[0]["ring_f32"].tobytes() == \
        _ring_sum_in_schedule_order(inputs["ring_f32"]).tobytes()
    test_ring_reduce_scatter_rank_i_owns_chunk_i(nccl_world)
    test_ring_all_gather_and_bcast_from_root(nccl_world)
    test_torch_engine_host_api_in_a_world(nccl_world)
    for name, nbins in (("dh_tree", NBINS_TREE), ("dh_ring", NBINS_RING)):
        arrs = [inputs[f"{name}_{k}"] for k in ("grad", "hess", "bins")]
        oracle = sum(host_histogram(arrs[0][r], arrs[1][r], arrs[2][r],
                                    nbins).astype(np.float64)
                     for r in range(p))
        np.testing.assert_allclose(ranks[0][name], oracle, rtol=1e-5,
                                   atol=1e-4)
