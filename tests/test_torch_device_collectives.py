"""The port's device entry points (``rabit_tpu_torch/parallel/collectives.py``:
``device_reduce_scatter``, ``device_allgather``, ``device_hier_allreduce``,
``bucket_allreduce``, ``device_allreduce_tree``, ``device_broadcast``)
against their JAX twins of the same names.

One spawned gloo world of 4 (``tests/torch_world.py``) runs every case;
each rank saves what it holds, and the tests run the JAX function on a
4-device slice of the 8-device virtual CPU mesh, on the same numpy
inputs (rank r's tensor is row r of the global [4, ...] array):

* unquantized f32 results equal JAX's bit for bit, integers exactly;
* wired results (``parallel/wire.py``) equal JAX's bit for bit with the
  JAX call compiled under ``_NO_REWRITE``: XLA's algebraic simplifier
  and the CPU backend's fused multiply-adds move JAX's int8 codec by an
  ulp (``tests/test_torch_schedules.py``);
* ``method="auto"`` resolves on both sides from the JAX package's
  committed dispatch table (the ranks read it through
  ``RABIT_DISPATCH_TABLE``); a bucket that the table sends to the tree
  schedule sums in the library's order on each side (gloo's, XLA's),
  which need not be the same: within 1e-6 of the largest sum.

``device_reduce_scatter`` gives rank i chunk i (JAX's output sharding);
every other entry point the replicated result. This module imports
neither JAX nor ``rabit_tpu`` at its top: the spawned ranks import it.
"""

import contextlib

import numpy as np
import pytest
import torch

from rabit_tpu_torch.ops.reducers import MAX, SUM
from torch_world import spawn_world

P = 4
N = 4096        # a multiple of p times the int8 block (1024)
H22 = ((0, 1), (2, 3))
TREE_TOL = 1e-6
_NO_REWRITE = {"xla_disable_hlo_passes": "algsimp",
               "xla_backend_optimization_level": 0}


def _inputs() -> dict:
    rng = np.random.default_rng(410)
    return {
        "f32": rng.standard_normal((P, N)).astype(np.float32),
        "i32": rng.integers(-1 << 20, 1 << 20, (P, N)).astype(np.int32),
        "ag": rng.standard_normal((P, 1024)).astype(np.float32),
        # test_bucketing.py's mixed tree: two f32 leaves, two i32 leaves
        "w": rng.standard_normal((P, 33, 5)).astype(np.float32),
        "b": rng.standard_normal((P, 17)).astype(np.float32),
        "steps": rng.integers(0, 1000, (P, 9)).astype(np.int32),
        "flags": rng.integers(0, 100, (P, 3)).astype(np.int32),
        "big": rng.standard_normal((P, 40000)).astype(np.float32),
    }


MIXED = ("w", "b", "steps", "flags")


def _cases() -> dict:
    """name -> (function, input keys (one: a tensor; several: a dict
    tree), kwargs, kind). Both packages' functions take these keywords.
    Kinds: "bits", "exact", "wired" (bits against JAX under
    ``_NO_REWRITE``), "tree" (f32 leaves close, integer leaves exact)."""
    c = {
        "rs_f32": ("device_reduce_scatter", ("f32",), {"op": SUM}, "bits"),
        "rs_i32_max": ("device_reduce_scatter", ("i32",), {"op": MAX},
                       "exact"),
        "rs_int8": ("device_reduce_scatter", ("f32",),
                    {"op": SUM, "wire": "int8"}, "wired"),
        "ag_f32": ("device_allgather", ("ag",), {}, "bits"),
        "ag_i32": ("device_allgather", ("i32",), {}, "exact"),
        "ag_bf16": ("device_allgather", ("ag",), {"wire": "bf16"}, "wired"),
        "hier_f32": ("device_hier_allreduce", ("f32",),
                     {"op": SUM, "groups": H22}, "bits"),
        "hier_swing": ("device_hier_allreduce", ("f32",),
                       {"op": SUM, "groups": H22, "inter_method": "swing"},
                       "bits"),
        "hier_i32_max": ("device_hier_allreduce", ("i32",),
                         {"op": MAX, "groups": H22}, "exact"),
        "hier_int8": ("device_hier_allreduce", ("f32",),
                      {"op": SUM, "groups": H22, "wire": "int8"}, "wired"),
        "hier_one_group": ("device_hier_allreduce", ("f32",),
                           {"op": SUM, "groups": ((0, 1, 2, 3),),
                            "wire": "int8"}, "bits"),
        "tree_mixed_auto": ("device_allreduce_tree", MIXED, {"op": SUM},
                            "tree"),
        "tree_mixed_ring": ("device_allreduce_tree", MIXED,
                            {"op": SUM, "method": "ring"}, "bits"),
        "tree_big_auto": ("device_allreduce_tree", ("big", "b"),
                          {"op": SUM}, "tree"),
        "tree_int8": ("device_allreduce_tree", ("big", "w"),
                      {"op": SUM, "method": "ring", "wire": "int8"},
                      "wired"),
        "bcast_f32": ("device_broadcast", ("f32",), {"root": 2}, "bits"),
        "bcast_i32": ("device_broadcast", ("i32",), {"root": 0}, "exact"),
    }
    for method in ("tree", "ring", "bidir", "swing"):
        c[f"tree_method_{method}"] = ("device_allreduce_tree", ("i32",),
                                      {"op": SUM, "method": method},
                                      "exact")
    return c


def _arg(keys, rows: dict):
    return rows[keys[0]] if len(keys) == 1 else {k: rows[k] for k in keys}


def _leaves(name: str, keys, out) -> dict:
    if len(keys) == 1:
        return {name: out}
    return {f"{name}|{k}": out[k] for k in keys}


def _rank_main(rank: int, p: int, table: str) -> dict:
    import os
    os.environ["RABIT_DISPATCH_TABLE"] = table
    from rabit_tpu_torch.parallel import collectives as C
    from rabit_tpu_torch.parallel.mesh import make_mesh
    inputs = _inputs()
    rows = {k: torch.from_numpy(v[rank].copy()) for k, v in inputs.items()}
    got = {}
    for name, (fn, keys, kw, _) in _cases().items():
        out = getattr(C, fn)(_arg(keys, rows), None, **kw)
        got.update({k: v.numpy() for k, v in _leaves(name, keys, out).items()})
    for k, v in inputs.items():
        assert rows[k].numpy().tobytes() == v[rank].tobytes(), k
    # the per-shard bucket function, flat and with the sp partials folded
    tree = {k: rows[k] for k in MIXED}
    out = C.bucket_allreduce(tree, None, SUM, method="ring")
    got.update({f"bucket_ring|{k}": v.numpy() for k, v in out.items()})
    mesh = make_mesh((2, 1, 2), "cpu")
    out = C.bucket_allreduce(tree, mesh.group("dp"), SUM, method="ring",
                             presum_group=mesh.group("sp"))
    got.update({f"bucket_presum|{k}": v.numpy() for k, v in out.items()})
    # hier against the port's own hier_allreduce; the phase guard's calls
    entered = []

    def guard(phase, nbytes):
        entered.append(f"{phase}:{nbytes}")
        return contextlib.nullcontext()

    got["hier_guarded"] = C.device_hier_allreduce(
        rows["f32"], None, SUM, groups=H22, phase_guard=guard).numpy()
    got["hier_guard_calls"] = np.array(entered)
    got["hier_port"] = C.hier_allreduce(rows["f32"], None, SUM,
                                        groups=H22).numpy()
    # the n % p error, the empty tree, a list tree
    try:
        C.device_reduce_scatter(rows["f32"][:N - 1], None)
        got["rs_error"] = np.array("")
    except ValueError as e:
        got["rs_error"] = np.array(str(e))
    got["empty_tree"] = np.array(C.device_allreduce_tree({}, None) == {})
    ones = C.device_allreduce_tree([torch.ones(4)], None)
    got["list_tree"] = np.array(isinstance(ones, list) and len(ones) == 1)
    got["list_tree_0"] = ones[0].numpy()
    return got


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from rabit_tpu.parallel import dispatch
    table = dispatch._newest_sweep()
    assert table is not None
    return spawn_world(_rank_main, P, tmp_path_factory.mktemp("devcoll"),
                       table)


def _jax(fn: str, keys, kw: dict, wired: bool):
    """The JAX function of the same name on a 4-device mesh, on the global
    inputs; a wired case compiled under ``_NO_REWRITE``."""
    import jax
    from rabit_tpu.parallel import collectives as JC
    from rabit_tpu.parallel import make_mesh
    from rabit_tpu.parallel.collectives import shard_over
    mesh = make_mesh(P)
    inputs = _inputs()
    arg = _arg(keys, {k: shard_over(mesh, v) for k, v in inputs.items()})

    def call(a):
        return getattr(JC, fn)(a, mesh, **kw)
    if not wired:
        out = call(arg)
    else:
        out = jax.jit(call).lower(arg).compile(
            compiler_options=_NO_REWRITE)(arg)
    return jax.tree_util.tree_map(np.asarray, out)


CASES = sorted(_cases())


@pytest.mark.parametrize("name", CASES)
def test_entry_point_matches_jax(world, name):
    fn, keys, kw, kind = _cases()[name]
    want = _leaves(name, keys, _jax(fn, keys, kw, kind == "wired"))
    inputs = _inputs()
    for key, w in want.items():
        got = [r[key] for r in world]
        if fn == "device_reduce_scatter":   # rank i holds chunk i
            got = [np.concatenate(got)]
        for g in got:
            assert g.shape == w.shape and g.dtype == w.dtype, key
            if kind == "tree" and g.dtype == np.float32:
                leaf = inputs[key.split("|")[1]]
                scale = np.abs(leaf.astype(np.float64).sum(0)).max()
                np.testing.assert_allclose(g, w, rtol=0,
                                           atol=TREE_TOL * scale)
            else:
                assert g.tobytes() == w.tobytes(), \
                    (key, np.abs(g.astype(np.float64) - w).max())


@pytest.mark.parametrize("variant", ["bucket_ring", "bucket_presum"])
def test_bucket_allreduce_matches_jax(world, variant):
    """JAX's per-shard ``bucket_allreduce`` inside ``shard_map``: over the
    four ranks, and over dp of a (dp, sp) = (2, 2) mesh with the sp
    partials folded first (``presum_axis``)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as PS
    from rabit_tpu.parallel import collectives as JC
    from rabit_tpu.parallel import make_mesh
    inputs = _inputs()
    if variant == "bucket_ring":
        mesh, axes, kw = make_mesh(P), ("workers",), {}
    else:
        mesh = make_mesh(P, ("dp", "sp"), (2, 2))
        axes, kw = ("dp", "sp"), {"presum_axis": "sp"}

    def per_shard(tree):
        tree = {k: v[0] for k, v in tree.items()}
        out = JC.bucket_allreduce(tree, axes[0], SUM, method="ring", **kw)
        return {k: v[None] for k, v in out.items()}
    spec = PS(axes)
    f = JC.unchecked_shard_map(per_shard, mesh=mesh, in_specs=(spec,),
                               out_specs=spec)
    tree = {k: jax.device_put(inputs[k], NamedSharding(mesh, spec))
            for k in MIXED}
    want = {k: np.asarray(v) for k, v in jax.jit(f)(tree).items()}
    for r, got in enumerate(world):
        for k in MIXED:
            assert got[f"{variant}|{k}"].tobytes() == want[k][r].tobytes(), \
                (variant, k, r)


def test_hier_equals_hier_allreduce_with_one_guard_a_phase(world):
    n_bytes = N * 4
    for got in world:
        assert got["hier_guarded"].tobytes() == got["hier_port"].tobytes()
        assert got["hier_guarded"].tobytes() == world[0]["hier_f32"].tobytes()
        assert list(got["hier_guard_calls"]) == [
            f"hier.reduce_scatter:{n_bytes}", f"hier.inter:{n_bytes // 2}",
            f"hier.allgather:{n_bytes}"]


def test_reduce_scatter_refuses_a_payload_that_does_not_divide(world):
    for got in world:
        assert "must divide by the axis size 4" in str(got["rs_error"])


def test_empty_tree_and_a_list_tree(world):
    for got in world:
        assert bool(got["empty_tree"]) and bool(got["list_tree"])
        np.testing.assert_array_equal(got["list_tree_0"], np.full(4, 4.0))
