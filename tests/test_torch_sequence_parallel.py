"""The port's sequence parallelism beyond the ring against the JAX package:

* ``collectives.all_to_all`` bit for bit against ``lax.all_to_all(...,
  tiled=True)`` at p = 2 and 4, for the axis pairs of Ulysses ((1, 0) and
  (0, 1)) and of the MoE ((0, 0)), with H != p;
* ``ulysses_attention`` and ``sequence_parallel_attention`` (both impls)
  in spawned gloo worlds of 2 and 4, causal and not, against JAX's
  ``sequence_parallel_attention`` on a virtual mesh: values and the
  gradients of sum(out^2) with respect to the global q, k, v, the same on
  every rank; and every refusal with JAX's message;
* ``mesh.best_mesh_axis`` against JAX's on the same shapes.

The port runs on the CPU, so the ring's block step takes the plain
versions of the flash kernels."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax import lax
from jax.sharding import PartitionSpec as P

from rabit_tpu.parallel import make_mesh as jax_make_mesh
from rabit_tpu.parallel import sequence_parallel_attention as jax_spa
from rabit_tpu.parallel.collectives import unchecked_shard_map
from rabit_tpu.parallel.mesh import best_mesh_axis as jax_best_mesh_axis
from rabit_tpu_torch.parallel import ring_attention as R
from rabit_tpu_torch.parallel.mesh import Mesh, best_mesh_axis, make_mesh
from torch_world import spawn_world

T, H, D = 32, 8, 16           # global sequence, heads (8 != p), head dim
VAL_TOL = dict(rtol=2e-5, atol=2e-5)   # test_torch_ring_attention.py:31
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
# the all-to-all cases: (split_axis, concat_axis, per-shard shape)
A2A_CASES = {"ulysses_in": (1, 0, (4, H, 3)), "ulysses_out": (0, 1, None),
             "moe": (0, 0, None)}


def _a2a_shape(name, p):
    """Per-shard input shape of a case: Ulysses' way back takes [p*T, H/p,
    D]; the MoE's exchange takes [e = p, c, d]."""
    if name == "ulysses_out":
        return (4 * p, H // p, 3)
    if name == "moe":
        return (p, 5, 3)
    return A2A_CASES[name][2]


def _a2a_inputs(p):
    rng = np.random.default_rng(p)
    return {name: rng.standard_normal((p,) + _a2a_shape(name, p)).astype(
        np.float32) for name in A2A_CASES}


def _qkv(seed=0, h=H):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((T, h, D)).astype(np.float32)
            for _ in range(3)]


def _message(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return "no error"


def _sp_rank(rank, p):
    from rabit_tpu_torch.parallel import collectives as C
    got = {}
    world = dist.group.WORLD
    for name, x in _a2a_inputs(p).items():
        split, concat, _ = A2A_CASES[name]
        got[f"a2a_{name}"] = C.all_to_all(torch.from_numpy(x[rank]), world,
                                          split, concat).numpy()
    mesh = make_mesh((p,), "cpu", axes=("sp",))
    q, k, v = _qkv()
    for impl in R.IMPLS:
        for causal in (False, True):
            leaves = [torch.from_numpy(a.copy()).requires_grad_()
                      for a in (q, k, v)]
            out = R.sequence_parallel_attention(*leaves, mesh, causal,
                                                impl=impl)
            (out ** 2).sum().backward()
            got[f"{impl}_{causal}"] = out.detach().numpy()
            for n, leaf in zip("qkv", leaves):
                got[f"{impl}_{causal}_d{n}"] = leaf.grad.numpy()
    # the per-shard Ulysses with a leading batch dimension: [B, T_loc, H, D]
    xb = [torch.from_numpy(np.stack([a, a[::-1]])[:, rank * (T // p):
                                                   (rank + 1) * (T // p)]
                           .copy()) for a in (q, k, v)]
    got["ulysses_batched"] = R.ulysses_attention(*xb, world, True).numpy()
    t = torch.from_numpy(q)
    got["err_seq"] = np.array(_message(lambda: R.sequence_parallel_attention(
        t[:T - 1], t[:T - 1], t[:T - 1], mesh)))
    h6 = torch.from_numpy(_qkv(1, h=6)[0])
    got["err_heads"] = np.array(_message(
        lambda: R.sequence_parallel_attention(h6, h6, h6, mesh,
                                              impl="ulysses")))
    return got


@pytest.fixture(scope="module", params=[2, 4])
def sp_world(request, tmp_path_factory):
    p = request.param
    ranks = spawn_world(_sp_rank, p, tmp_path_factory.mktemp(f"sp{p}"))
    return p, ranks


def test_all_to_all_is_lax_all_to_all_tiled_bit_for_bit(sp_world):
    p, ranks = sp_world
    mesh = jax_make_mesh(p, ("x",))
    for name, x in _a2a_inputs(p).items():
        split, concat, _ = A2A_CASES[name]
        f = unchecked_shard_map(
            lambda a, s=split, c=concat: lax.all_to_all(
                a[0], "x", split_axis=s, concat_axis=c, tiled=True)[None],
            mesh=mesh, in_specs=P("x"), out_specs=P("x"))
        want = np.asarray(jax.jit(f)(x))
        for r, got in enumerate(ranks):
            assert got[f"a2a_{name}"].shape == want[r].shape, name
            assert got[f"a2a_{name}"].tobytes() == want[r].tobytes(), \
                (name, r)


@pytest.mark.parametrize("impl", ["ring", "ulysses"])
@pytest.mark.parametrize("causal", [False, True])
def test_sequence_parallel_attention_matches_jax(sp_world, impl, causal):
    """Values within 2e-5 and gradients of the global sum(out^2) within
    1e-4 of JAX's wrapper, whole and the same bits on every rank."""
    p, ranks = sp_world
    q, k, v = map(jnp.asarray, _qkv())
    mesh = jax_make_mesh(p, ("sp",))
    want = jax_spa(q, k, v, mesh, causal=causal, impl=impl)
    want_g = jax.grad(
        lambda *a: (jax_spa(*a, mesh, causal=causal, impl=impl) ** 2).sum(),
        argnums=(0, 1, 2))(q, k, v)
    key = f"{impl}_{causal}"
    np.testing.assert_allclose(ranks[0][key], np.asarray(want), **VAL_TOL)
    for n, g in zip("qkv", want_g):
        np.testing.assert_allclose(ranks[0][f"{key}_d{n}"], np.asarray(g),
                                   **GRAD_TOL, err_msg=n)
    for r in ranks[1:]:
        for suffix in ("", "_dq", "_dk", "_dv"):
            assert r[key + suffix].tobytes() == \
                ranks[0][key + suffix].tobytes()


def test_ring_and_ulysses_agree(sp_world):
    _, ranks = sp_world
    for causal in (False, True):
        np.testing.assert_allclose(ranks[0][f"ring_{causal}"],
                                   ranks[0][f"ulysses_{causal}"], **VAL_TOL)


def test_per_shard_ulysses_with_a_batch_matches_jax(sp_world):
    """The per-shard function on [B, T_loc, H, D] (the batch rides along,
    as JAX's ``vmap`` would carry it) against JAX's wrapper per row."""
    p, ranks = sp_world
    q, k, v = _qkv()
    got = np.concatenate([r["ulysses_batched"] for r in ranks], axis=1)
    mesh = jax_make_mesh(p, ("sp",))
    for b, flip in enumerate((lambda a: a, lambda a: a[::-1])):
        want = jax_spa(*(jnp.asarray(flip(a).copy()) for a in (q, k, v)),
                       mesh, causal=True, impl="ulysses")
        np.testing.assert_allclose(got[b], np.asarray(want), **VAL_TOL)


def test_refusals_in_a_world_carry_jax_messages(sp_world):
    p, ranks = sp_world
    mesh = jax_make_mesh(p, ("sp",))
    t = jnp.zeros((T - 1, H, D))
    with pytest.raises(ValueError) as e:
        jax_spa(t, t, t, mesh)
    h6 = jnp.zeros((T, 6, D))
    for r in ranks:
        assert str(r["err_seq"]) == str(e.value)
    if 6 % p:
        with pytest.raises(ValueError) as eh:
            jax_spa(h6, h6, h6, mesh, impl="ulysses")
        for r in ranks:
            assert str(r["err_heads"]) == str(eh.value)
    else:
        for r in ranks:
            assert str(r["err_heads"]) == "no error"


@pytest.fixture
def world_of_one():
    mesh = make_mesh((1,), "cpu", axes=("sp",))
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_world_of_one_is_the_dense_oracle(world_of_one):
    """p = 1: both impls are ``reference_attention`` (Ulysses) and one
    flash block step (the ring), as in JAX."""
    q, k, v = map(torch.from_numpy, _qkv(2))
    want = R.reference_attention(q, k, v, True)
    for impl in R.IMPLS:
        got = R.sequence_parallel_attention(q, k, v, world_of_one, True,
                                            impl=impl)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **VAL_TOL)
    assert torch.equal(R.ulysses_attention(q, k, v, None, True), want)


def test_bad_impl_and_use_pallas_raise_as_in_jax(world_of_one):
    q = torch.zeros(T, H, D)
    jmesh = jax_make_mesh(1, ("sp",))
    jq = jnp.zeros((T, H, D))
    for kwargs in (dict(impl="flash"), dict(impl="ulysses",
                                            use_pallas=True)):
        with pytest.raises(ValueError) as want:
            jax_spa(jq, jq, jq, jmesh, **kwargs)
        with pytest.raises(ValueError) as got:
            R.sequence_parallel_attention(q, q, q, world_of_one, **kwargs)
        assert str(got.value) == str(want.value)


def test_tf32_is_refused(world_of_one):
    q = torch.zeros(T, H, D)
    saved = torch.backends.cuda.matmul.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            R.sequence_parallel_attention(q, q, q, world_of_one)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved


@pytest.mark.parametrize("axes,shape", [
    (("dp", "tp", "sp"), (2, 4, 1)), (("dp", "tp", "sp"), (2, 2, 2)),
    (("dp", "tp", "sp"), (1, 1, 8)), (("dp", "tp"), (4, 2)),
    (("pp",), (8,)), (("ep",), (1,))])
def test_best_mesh_axis_matches_jax(axes, shape):
    """The largest axis; a tie goes to the first in axis order."""
    n = int(np.prod(shape))
    want = jax_best_mesh_axis(jax_make_mesh(n, axes, shape))
    mesh = Mesh(shape, (0,) * len(shape), (None,) * len(shape),
                torch.device("cpu"), axes)
    assert best_mesh_axis(mesh) == want
