"""Every allreduce schedule of the port against the JAX package's, in real
gloo worlds of 2 and 4 processes.

One spawn per world size (``tests/torch_world.py``) runs every case of
that world; each rank saves what it got, and the tests below run the JAX
function of the same name on a p-device slice of the 8-device virtual
CPU mesh, on the same inputs:

* unquantized float results equal the JAX schedules' bit for bit (the
  port keeps their hop order and their ``combine(cur, got)`` order);
* integer results are exact;
* wired results (``parallel/wire.py``) equal the JAX schedules bit for
  bit, stay within the JAX tests' own bound of the f64 sum
  (``tests/test_wire_quantization.py``: 2e-2 sqrt(p) of the largest
  sum), the codec engages, and every rank ends bit-identical. Under
  ``jax.jit`` XLA rewrites two roundings that the JAX source writes and
  the port keeps: the algebraic simplifier turns the scale's
  ``amax / 127.0`` into a product with the reciprocal of 127, and the
  CPU backend contracts the decode's product and the fold's sum
  (``cur + q * scale``) into one fused multiply-add. The int8 results
  then differ by an ulp or two (and a bf16 all-gather half can round
  that ulp to another bf16 value). So the JAX side of a wired case is
  compiled with that pass off and LLVM's optimizations at level 0
  (``_NO_REWRITE``), which gives the bits JAX gives op by op, without
  jit, some 15x faster;
* ``preagg``'s float sums are close, not equal: its first phase is a
  ring over the early ranks in the port and XLA's grouped psum in JAX,
  two association orders.

This module imports neither JAX nor ``rabit_tpu`` at its top: the spawned
ranks import it, and so does ``test_torch_collectives.py``'s NCCL test on
a machine without JAX, which runs ``run_cases`` on the cards and holds
the results against the same cases run here over gloo.
"""

import numpy as np
import pytest
import torch

from rabit_tpu_torch.ops.reducers import MAX, MIN, SUM
from torch_world import spawn_world

N = 1003          # divides by neither 2 nor 4: the padding is exercised
N_WIRE = 4099     # every int8 block size below needs padding
BOUND_PER_SQRT_P = 2e-2
H22 = ((0, 1), (2, 3))          # hier at 2 x 2
SUBRINGS = ((0, 2), (1, 3))     # interleaved sub-rings
WIRES = ("bf16", "int8", "int8:bf16", "int8@256", "none:int8@512")


def _cases(p: int) -> dict:
    """name -> (input, function, op or None, kwargs, kind). ``kind``:
    "bits" (equal to JAX bit for bit), "exact" (integers), "wired"
    (within the bound), "close" (float, another association order).
    Functions share their names in both packages."""
    c = {}
    for rev in (False, True):
        t = "rev" if rev else "fwd"
        c[f"ring_{t}"] = ("f32", "ring_allreduce", SUM,
                          {"reverse": rev}, "bits")
        c[f"rs_{t}"] = ("rs", "ring_reduce_scatter", SUM,
                        {"reverse": rev}, "bits")
        c[f"ag_{t}"] = ("ag", "ring_all_gather", None,
                        {"reverse": rev}, "bits")
        for w in WIRES:
            c[f"ring_{t}_{w}"] = ("wire", "ring_allreduce", SUM,
                                  {"reverse": rev, "wire": w}, "wired")
        c[f"rs_{t}_int8@256"] = ("rs", "ring_reduce_scatter", SUM,
                                 {"reverse": rev, "wire": "int8@256"},
                                 "wired")
        c[f"ag_{t}_int8@256"] = ("ag", "ring_all_gather", None,
                                 {"reverse": rev, "wire": "int8@256"},
                                 "wired")
        c[f"ag_{t}_bf16"] = ("ag", "ring_all_gather", None,
                             {"reverse": rev, "wire": "bf16"}, "wired")
    for fn in ("ring_allreduce", "bidir_ring_allreduce", "swing_allreduce"):
        short = fn.split("_")[0]
        c[f"{short}_f32"] = ("f32", fn, SUM, {}, "bits")
        for w in ("bf16", "int8:bf16"):
            c[f"{short}_{w}"] = ("wire", fn, SUM, {"wire": w}, "wired")
        for op, name in ((SUM, "sum"), (MAX, "max"), (MIN, "min")):
            c[f"{short}_i32_{name}"] = ("i32", fn, op, {}, "exact")
        c[f"{short}_u32_max"] = ("u32", fn, MAX, {}, "exact")
    c["bidir_short"] = ("short", "bidir_ring_allreduce", SUM, {}, "bits")
    early_last = (tuple(range(p - 1)), (p - 1,))
    early_first = (tuple(range(1, p)), (0,))
    for name, groups in (("lag_last", early_last), ("lag_first",
                                                    early_first)):
        c[f"preagg_{name}_f32"] = ("f32", "preagg_allreduce", SUM,
                                   {"groups": groups}, "close")
        for op, oname in ((SUM, "sum"), (MAX, "max"), (MIN, "min")):
            c[f"preagg_{name}_i32_{oname}"] = (
                "i32", "preagg_allreduce", op, {"groups": groups}, "exact")
    # hier's degenerate worlds: one group (a flat unquantized ring), and
    # one rank a group (the flat schedule with the wire)
    c["hier_one_group"] = ("f32", "hier_allreduce", SUM,
                           {"groups": (tuple(range(p)),)}, "bits")
    c["hier_flat_int8"] = ("wire", "hier_allreduce", SUM,
                           {"groups": tuple((r,) for r in range(p)),
                            "wire": "int8"}, "wired")
    if p == 4:
        for fn in ("ring_allreduce", "bidir_ring_allreduce",
                   "swing_allreduce"):
            short = fn.split("_")[0]
            c[f"{short}_groups"] = ("f32", fn, SUM, {"groups": SUBRINGS},
                                    "bits")
            c[f"{short}_groups_int8"] = ("wire", fn, SUM,
                                         {"groups": SUBRINGS,
                                          "wire": "int8"}, "wired")
        c["ring_groups_rev"] = ("f32", "ring_allreduce", SUM,
                                {"groups": H22, "reverse": True}, "bits")
        c["rs_groups"] = ("rs", "ring_reduce_scatter", SUM,
                          {"groups": SUBRINGS}, "bits")
        c["ag_groups_int8@256"] = ("ag", "ring_all_gather", None,
                                   {"groups": H22, "wire": "int8@256"},
                                   "wired")
        for inter in ("ring", "swing"):
            c[f"hier_{inter}"] = ("f32", "hier_allreduce", SUM,
                                  {"groups": H22, "inter_method": inter},
                                  "bits")
            c[f"hier_{inter}_int8"] = ("wire", "hier_allreduce", SUM,
                                       {"groups": H22, "wire": "int8",
                                        "inter_method": inter}, "wired")
        for op, name in ((SUM, "sum"), (MAX, "max")):
            c[f"hier_i32_{name}"] = ("i32", "hier_allreduce", op,
                                     {"groups": H22}, "exact")
    return c


def _inputs(p: int) -> dict:
    rng = np.random.default_rng(300 + p)
    return {
        "f32": rng.standard_normal((p, N)).astype(np.float32),
        "wire": rng.standard_normal((p, N_WIRE)).astype(np.float32),
        "short": rng.standard_normal((p, 2 * p - 1)).astype(np.float32),
        "rs": rng.standard_normal((p, 512 * p)).astype(np.float32),
        "ag": rng.standard_normal((p, 512)).astype(np.float32),
        "i32": rng.integers(-1 << 20, 1 << 20, (p, N)).astype(np.int32),
        "u32": rng.integers(0, 2**32, (p, N), dtype=np.uint32),
    }


def run_cases(rank: int, p: int, dev: torch.device) -> dict:
    """Every case of this world on this rank's tensors (on ``dev``)."""
    from rabit_tpu_torch.parallel import collectives as C
    inputs = _inputs(p)
    got = {}
    for name, (key, fn, op, kw, _) in _cases(p).items():
        x = torch.from_numpy(inputs[key][rank].copy()).to(dev)
        args = (x, None) if op is None else (x, None, op)
        got[name] = getattr(C, fn)(*args, **kw).cpu().numpy()
        assert x.cpu().numpy().tobytes() == inputs[key][rank].tobytes(), \
            f"{name}: the input was modified"
    return got


def _rank_main(rank: int, p: int) -> dict:
    import rabit_tpu_torch as rabit
    from rabit_tpu_torch.parallel import collectives as C
    got = run_cases(rank, p, torch.device("cpu"))
    rng = np.random.default_rng(7)
    small = torch.from_numpy(rng.standard_normal((p, 2048)).astype(
        np.float32)[rank].copy())
    big = torch.from_numpy(rng.standard_normal((p, 40000)).astype(
        np.float32)[rank].copy())
    # the dispatcher with no table: the tree below 32768 floats, the ring
    # at and above
    got["auto_small"] = C.allreduce(small).numpy()
    got["auto_small_tree"] = C.tree_allreduce(small).numpy()
    got["auto_big"] = C.allreduce(big).numpy()
    got["auto_big_ring"] = C.ring_allreduce(big).numpy()
    # the engine with the schedule and wire keys
    spec = "0,1|2,3" if p == 4 else "0,1"
    rabit.init(["rabit_device=cpu", "rabit_reduce_method=hier",
                f"rabit_hier_group={spec}", "rabit_dataplane_wire=int8",
                "rabit_dataplane_wire_mincount=4096"], engine="torch")
    buf = big.numpy().copy()
    got["engine_hier_int8"] = rabit.allreduce(buf, rabit.SUM)
    groups = ((0, 1), (2, 3)) if p == 4 else ((0, 1),)
    got["engine_hier_int8_want"] = C.hier_allreduce(
        big, None, SUM, groups=groups, wire="int8").numpy()
    got["engine_small"] = rabit.allreduce(small.numpy().copy(), rabit.SUM)
    got["engine_small_want"] = C.hier_allreduce(
        small, None, SUM, groups=groups).numpy()
    rabit.finalize()
    return got


PARAMS = [(p, name) for p in (2, 4) for name in _cases(p)]


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world spawned once, on first use."""
    cache = {}

    def get(p):
        if p not in cache:
            cache[p] = spawn_world(_rank_main, p,
                                   tmp_path_factory.mktemp(f"sched{p}"))
        return cache[p]
    return get


# XLA compile options under which a jitted JAX schedule rounds as its
# source reads (see the module's docstring)
_NO_REWRITE = {"xla_disable_hlo_passes": "algsimp",
               "xla_backend_optimization_level": 0}


def _jax_run(p: int, xs: np.ndarray, fn: str, op, kw: dict,
             rewrite: bool = True) -> np.ndarray:
    """The JAX function on a p-device mesh: [p, ...], row r rank r's;
    ``rewrite=False`` compiles it with ``_NO_REWRITE``."""
    import jax
    from jax.sharding import PartitionSpec as P
    from rabit_tpu.parallel import collectives as JC
    from rabit_tpu.parallel import make_mesh
    from rabit_tpu.parallel.collectives import shard_over
    mesh = make_mesh(p)
    f = getattr(JC, fn)

    def per_shard(a):
        a = a.reshape(-1)
        out = f(a, "workers", **kw) if op is None else \
            f(a, "workers", op, **kw)
        return out[None]
    g = JC.unchecked_shard_map(per_shard, mesh=mesh, in_specs=P("workers"),
                               out_specs=P("workers"))
    x = shard_over(mesh, xs)
    opts = {} if rewrite else _NO_REWRITE
    return np.asarray(jax.jit(g).lower(x).compile(compiler_options=opts)(x))


def _uniform(name: str, kw: dict) -> bool:
    """Whether every rank should end with the same result."""
    return not name.startswith("rs_") and "groups" not in kw or \
        name.startswith(("hier", "preagg"))


@pytest.mark.parametrize("p,name", PARAMS,
                         ids=[f"p{p}-{n}" for p, n in PARAMS])
def test_schedule_matches_jax(worlds, p, name):
    ranks = worlds(p)
    key, fn, op, kw, kind = _cases(p)[name]
    xs = _inputs(p)[key]
    want = _jax_run(p, xs, fn, op, kw, rewrite=kind != "wired")
    got = np.stack([r[name] for r in ranks])
    assert got.shape == want.shape and got.dtype == want.dtype, name
    if _uniform(name, kw):
        for r in range(1, p):
            assert got[r].tobytes() == got[0].tobytes(), \
                f"{name}: rank {r} differs from rank 0"
    if kind in ("bits", "exact"):
        assert got.tobytes() == want.tobytes(), \
            f"{name}: max |diff| {np.abs(got - want).max()}"
        return
    exact = _exact(p, xs, fn, op, kw)
    scale = np.abs(exact).max()
    if kind == "close":
        # another association order: a few f32 roundings of the sum
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * p * scale)
        return
    bound = BOUND_PER_SQRT_P * np.sqrt(p)
    rel = np.abs(got - exact).max() / scale
    assert 1e-7 < rel < bound, (name, rel)   # engaged, and inside
    assert got.tobytes() == want.tobytes(), \
        f"{name}: max |diff| {np.abs(got - want).max()} (scale {scale})"


def _exact(p, xs, fn, op, kw) -> np.ndarray:
    """The f64 result each rank should approximate, [p, ...]."""
    x = xs.astype(np.float64)
    if fn == "ring_all_gather":
        groups = kw.get("groups") or (tuple(range(p)),)
        out = [None] * p
        for grp in groups:
            for r in grp:
                out[r] = np.concatenate([x[q] for q in grp])
        return np.stack(out)
    groups = kw.get("groups")
    if groups is None or fn in ("hier_allreduce", "preagg_allreduce"):
        groups = (tuple(range(p)),)
    out = [None] * p
    for grp in groups:
        total = sum(x[q] for q in grp)
        for j, r in enumerate(grp):
            if fn == "ring_reduce_scatter":
                out[r] = total.reshape(len(grp), -1)[j]
            else:
                out[r] = total
    return np.stack(out)


@pytest.mark.parametrize("p", [2, 4])
def test_dispatcher_picks_tree_then_ring_without_a_table(worlds, p):
    ranks = worlds(p)
    for r in ranks:
        assert r["auto_small"].tobytes() == r["auto_small_tree"].tobytes()
        assert r["auto_big"].tobytes() == r["auto_big_ring"].tobytes()


@pytest.mark.parametrize("p", [2, 4])
def test_engine_runs_the_configured_schedule_and_wire(worlds, p):
    """``rabit_reduce_method=hier`` with an int8 wire from 4096 elements:
    the 40000-float payload takes the wire, the 2048-float one does not;
    each equal to the schedule called directly, every rank alike. (At
    world 2 the grouping is one group: hier's flat unquantized ring.)"""
    ranks = worlds(p)
    for r in ranks:
        for k in ("engine_hier_int8", "engine_small"):
            assert r[k].tobytes() == r[f"{k}_want"].tobytes(), k
        assert r["engine_hier_int8"].tobytes() == \
            ranks[0]["engine_hier_int8"].tobytes()


@pytest.mark.parametrize("p", [2, 4, 8])
def test_swing_tables_match_jax(p):
    from rabit_tpu.parallel.collectives import _swing_tables as jax_tables
    from rabit_tpu_torch.parallel.collectives import _swing_tables
    ours, theirs = _swing_tables(p), jax_tables(p)
    assert ours[0] == theirs[0]
    for a, b in zip(ours[1:], theirs[1:]):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


def test_swing_tables_refuse_a_world_that_is_not_a_power_of_two():
    from rabit_tpu_torch.parallel.collectives import _swing_tables
    for p in (1, 3, 6):
        with pytest.raises(ValueError, match="power-of-two"):
            _swing_tables(p)
