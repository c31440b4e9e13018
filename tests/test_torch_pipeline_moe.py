"""The port's pipeline (``parallel/pipeline.py``) and switch MoE
(``parallel/moe.py``) against the JAX package's, the same parameters
(drawn by ``jax.random`` as tests/test_pipeline_moe.py draws them, carried
across as numpy by ``convert``) and inputs:

* the pipeline in a spawned gloo world of 4 with 8 and with 3 microbatches
  (the short schedule), forward within 1e-5 and the gradient of
  sum(y^2) within 1e-4 of ``jax.grad`` (JAX's own bounds,
  tests/test_pipeline_moe.py:54, :84); more stages than ranks raises; p =
  1 is a plain map;
* the MoE in the same world: the forward without drops within 2e-5
  (JAX's bound) and the dense oracle, exactly JAX's dropped tokens at
  capacity factor 0.25, the gradients of router, w_in, w_out and x within
  1e-4 of ``jax.grad`` of the same global loss (JAX's own test holds only
  their finiteness), both refusals of a wrong expert count, and JAX's
  10-step training loop with the port's loss within 1e-4 of JAX's at every
  step."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import NamedSharding, PartitionSpec as P

from rabit_tpu.parallel import (
    make_mesh as jax_make_mesh, make_pipeline_fn as jax_pipeline_fn,
    place_pipeline_params as jax_place_pipeline, make_moe_fn as jax_moe_fn,
    init_moe_params as jax_init_moe, place_moe_params as jax_place_moe,
    moe_reference as jax_moe_reference)
from rabit_tpu_torch.parallel import moe as M
from rabit_tpu_torch.parallel import pipeline as PL
from torch_world import spawn_world

D = 16
P_WORLD = 4
FWD_TOL = dict(rtol=1e-5, atol=1e-5)
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)
MOE_TOL = dict(rtol=2e-5, atol=2e-5)
MICRO = (8, 3)
TRAIN_STEPS, TRAIN_LR = 10, 0.3


def _stage_params(seed, n_stages):
    """tests/test_pipeline_moe.py's stages, as numpy."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for i in range(n_stages):
        k = jax.random.fold_in(rng, i)
        out.append({"w": np.asarray(jax.random.normal(k, (D, D))
                                    * (1.0 / np.sqrt(D))),
                    "b": np.zeros((D,), np.float32)})
    return out


def _jax_stage(prm, x):
    return jnp.tanh(x @ prm["w"] + prm["b"])


def _torch_stage(prm, x):
    return torch.tanh(x @ prm["w"] + prm["b"])


def _micro(seed, n_micro):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed),
                                      (n_micro, 4, D)))


def _moe_params(seed, n_experts):
    return {k: np.asarray(v) for k, v in jax_init_moe(
        jax.random.PRNGKey(seed), d_model=D, d_ff=32,
        n_experts=n_experts).items()}


def _moe_x(seed, n):
    return np.array(jax.random.normal(jax.random.PRNGKey(seed), (n, D)))


def _train_data():
    """tests/test_pipeline_moe.py:196's clusterable inputs and targets."""
    rng = np.random.default_rng(0)
    centers = rng.standard_normal((P_WORLD, D)).astype(np.float32) * 2
    xs = (centers[rng.integers(0, P_WORLD, 128)] +
          rng.standard_normal((128, D)).astype(np.float32) * 0.1)
    return xs, np.roll(xs, 1, axis=1)


def _error(fn):
    try:
        fn()
    except ValueError as e:
        return np.array(str(e))
    return np.array("no error")


def _inputs(p):
    """Every input of the world, drawn here: the ranks run no JAX."""
    return {"stages": _stage_params(0, p), "stages8": _stage_params(8, 2 * p),
            "micro": {n: _micro(1, n) for n in MICRO}, "micro9": _micro(9, 4),
            "moe": {seed: _moe_params(seed, p) for seed in (0, 2, 4, 7)},
            "moe8": _moe_params(6, 2 * p),
            "x": {seed: _moe_x(seed + 1, 64) for seed in (0, 2, 4)}}


def _rank(rank, p, inputs):
    from rabit_tpu_torch.parallel.collectives import psum_identity_grad
    from rabit_tpu_torch.parallel.mesh import make_mesh
    got = {}
    meshp = make_mesh((p,), "cpu", axes=("pp",))
    fn = PL.make_pipeline_fn(meshp, _torch_stage)
    for n_micro in MICRO:
        placed = PL.place_pipeline_params(meshp, inputs["stages"])
        y = fn(placed, torch.from_numpy(inputs["micro"][n_micro]))
        (y * y).sum().backward()
        got[f"pp{n_micro}_y"] = y.detach().numpy()
        for k, v in placed.items():
            got[f"pp{n_micro}_d{k}"] = v.grad.numpy()
    got["pp_mismatch"] = _error(lambda: fn(PL.place_pipeline_params(
        meshp, inputs["stages8"]), torch.from_numpy(inputs["micro9"])))

    meshe = make_mesh((p,), "cpu", axes=("ep",))
    n_loc = 64 // p
    rows = slice(rank * n_loc, (rank + 1) * n_loc)
    for name, seed, cf in (("nodrop", 0, float(p)), ("drop", 2, 0.25),
                           ("grad", 4, 4.0)):
        params = M.place_moe_params(meshe, inputs["moe"][seed])
        x = torch.from_numpy(inputs["x"][seed][rows].copy())
        x.requires_grad_()
        y, aux = M.make_moe_fn(meshe, capacity_factor=cf)(params, x)
        got[f"{name}_y"], got[f"{name}_aux"] = y.detach().numpy(), \
            aux.detach().numpy()
        if name == "grad":
            loss = psum_identity_grad((y * y).sum(), meshe.group("ep")) \
                + 0.01 * aux
            loss.backward()
            for k, v in params.items():
                got[f"grad_d{k}"] = v.grad.numpy()
            got["grad_dx"] = x.grad.numpy()
    eight = M.place_moe_params(meshe, inputs["moe8"])
    x0 = torch.zeros(16 // p, D)
    got["moe_mismatch_fn"] = _error(lambda: M.make_moe_fn(meshe)(eight, x0))
    got["moe_mismatch_ffn"] = _error(lambda: M.moe_ffn(
        eight, x0, meshe.group("ep")))

    # tests/test_pipeline_moe.py:196's loop: 10 SGD steps at lr 0.3
    xs, target = _train_data()
    n_tr = 128 // p
    part = slice(rank * n_tr, (rank + 1) * n_tr)
    xt, tt = (torch.from_numpy(a[part].copy()) for a in (xs, target))
    params = M.place_moe_params(meshe, inputs["moe"][7])
    efn = M.make_moe_fn(meshe, capacity_factor=4.0)
    losses = []
    for _ in range(TRAIN_STEPS):
        y, aux = efn(params, xt)
        loss = psum_identity_grad(((y - tt) ** 2).sum(), meshe.group("ep")) \
            / (128 * D) + 0.01 * aux
        loss.backward()
        with torch.no_grad():
            for v in params.values():
                v -= TRAIN_LR * v.grad
                v.grad = None
        losses.append(float(loss))
    got["train_losses"] = np.array(losses)
    return got


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(_rank, P_WORLD, tmp_path_factory.mktemp("ppmoe"),
                       _inputs(P_WORLD))


# ------------------------------------------------------------- pipeline

@pytest.mark.parametrize("n_micro", MICRO)
def test_pipeline_matches_jax_forward_and_gradient(world, n_micro):
    mesh = jax_make_mesh(P_WORLD, ("pp",))
    stages = _stage_params(0, P_WORLD)
    x = _micro(1, n_micro)
    fn = jax_pipeline_fn(mesh, _jax_stage)
    placed = jax_place_pipeline(mesh, stages)
    want = fn(placed, x)
    want_g = jax.grad(lambda s: (fn(s, x) ** 2).sum())(placed)
    for r, got in enumerate(world):
        np.testing.assert_allclose(got[f"pp{n_micro}_y"], np.asarray(want),
                                   **FWD_TOL)
        for k in ("w", "b"):
            np.testing.assert_allclose(got[f"pp{n_micro}_d{k}"][0],
                                       np.asarray(want_g[k])[r], **GRAD_TOL,
                                       err_msg=f"d{k} stage {r}")


def test_pipeline_gradient_is_the_dense_stage_by_stage_one(world):
    """Independent of JAX's sharded program: autograd through the stages
    composed on one device."""
    stages = _stage_params(0, P_WORLD)
    for n_micro in MICRO:
        leaves = [{k: torch.from_numpy(v.copy()).requires_grad_()
                   for k, v in s.items()} for s in stages]
        h = torch.from_numpy(_micro(1, n_micro))
        for prm in leaves:
            h = _torch_stage(prm, h)
        (h * h).sum().backward()
        for r, got in enumerate(world):
            np.testing.assert_allclose(got[f"pp{n_micro}_y"],
                                       h.detach().numpy(), **FWD_TOL)
            for k in ("w", "b"):
                np.testing.assert_allclose(got[f"pp{n_micro}_d{k}"][0],
                                           leaves[r][k].grad.numpy(),
                                           **GRAD_TOL)


def test_pipeline_stage_count_mismatch_raises(world):
    mesh = jax_make_mesh(P_WORLD, ("pp",))
    with pytest.raises(ValueError) as want:
        jax_pipeline_fn(mesh, _jax_stage)(
            jax_place_pipeline(mesh, _stage_params(8, 2 * P_WORLD)),
            _micro(9, 4))
    for got in world:
        assert "one stage per rank" in str(got["pp_mismatch"])
        assert str(got["pp_mismatch"]) == str(want.value)


def test_pipeline_single_stage_is_a_plain_map():
    stages = _stage_params(4, 1)
    x = _micro(5, 3)
    mesh = jax_make_mesh(1, ("pp",))
    want = jax_pipeline_fn(mesh, _jax_stage)(
        jax_place_pipeline(mesh, stages), x)
    prm = {k: torch.from_numpy(v) for k, v in stages[0].items()}
    got = PL.pipeline_apply(_torch_stage, prm, torch.from_numpy(x), None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)
    stacked = PL.stack_stage_params(_stage_params(0, 3))
    assert stacked["w"].shape == (3, D, D)


# ------------------------------------------------------------------ MoE

def _jax_moe(seed, cf, x):
    mesh = jax_make_mesh(P_WORLD, ("ep",))
    params = jax_init_moe(jax.random.PRNGKey(seed), d_model=D, d_ff=32,
                          n_experts=P_WORLD)
    xs = jax.device_put(jnp.asarray(x), NamedSharding(mesh, P("ep")))
    fn = jax_moe_fn(mesh, capacity_factor=cf)
    return mesh, params, jax_place_moe(mesh, params), xs, fn


def _gathered(world, key):
    return np.concatenate([g[key] for g in world])


def test_moe_without_drops_matches_jax_and_the_oracle(world):
    x = _moe_x(1, 64)
    _, params, placed, xs, fn = _jax_moe(0, float(P_WORLD), x)
    y, aux = fn(placed, xs)
    np.testing.assert_allclose(_gathered(world, "nodrop_y"), np.asarray(y),
                               **MOE_TOL)
    oracle = M.moe_reference({k: torch.from_numpy(np.asarray(v))
                              for k, v in params.items()},
                             torch.from_numpy(x))
    np.testing.assert_allclose(_gathered(world, "nodrop_y"), oracle.numpy(),
                               **MOE_TOL)
    np.testing.assert_allclose(np.asarray(jax_moe_reference(params, x)),
                               oracle.numpy(), **MOE_TOL)
    for g in world:
        np.testing.assert_allclose(g["nodrop_aux"], float(aux), **MOE_TOL)
        assert g["nodrop_aux"].tobytes() == world[0]["nodrop_aux"].tobytes()


def test_moe_drops_exactly_jaxs_tokens(world):
    """Capacity ceil(16 * 0.25 / 4) = 1 slot an expert a source rank: a
    token's slot is its order of arrival on its own rank; beyond it, 0."""
    _, _, placed, xs, fn = _jax_moe(2, 0.25, _moe_x(3, 64))
    y, _ = fn(placed, xs)
    want = np.all(np.asarray(y) == 0.0, axis=-1)
    got_y = _gathered(world, "drop_y")
    got = np.all(got_y == 0.0, axis=-1)
    assert want.any() and not want.all()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_allclose(got_y, np.asarray(y), **MOE_TOL)


def test_moe_gradients_match_jax_grad(world):
    """Router (summed over the ranks, as JAX sums a replicated input's),
    w_in, w_out and x against ``jax.grad`` of sum(y^2) + 0.01 aux."""
    _, _, placed, xs, fn = _jax_moe(4, 4.0, _moe_x(5, 64))

    def loss(params, x):
        y, aux = fn(params, x)
        return (y * y).sum() + 0.01 * aux

    g_params, g_x = jax.grad(loss, argnums=(0, 1))(placed, xs)
    for r, got in enumerate(world):
        np.testing.assert_allclose(got["grad_drouter"],
                                   np.asarray(g_params["router"]),
                                   **GRAD_TOL, err_msg=f"router rank {r}")
        for k in ("w_in", "w_out"):
            np.testing.assert_allclose(got[f"grad_d{k}"][0],
                                       np.asarray(g_params[k])[r],
                                       **GRAD_TOL, err_msg=f"{k} rank {r}")
    np.testing.assert_allclose(_gathered(world, "grad_dx"), np.asarray(g_x),
                               **GRAD_TOL)


def test_moe_expert_count_mismatch_raises(world):
    for got in world:
        for key in ("moe_mismatch_fn", "moe_mismatch_ffn"):
            assert "one expert per rank" in str(got[key]), key


def test_moe_training_loop_follows_jax(world):
    mesh = jax_make_mesh(P_WORLD, ("ep",))
    xs_np, target = _train_data()
    fn = jax_moe_fn(mesh, capacity_factor=4.0)
    placed = jax_place_moe(mesh, jax_init_moe(
        jax.random.PRNGKey(7), d_model=D, d_ff=32, n_experts=P_WORLD))
    sh = NamedSharding(mesh, P("ep"))
    xj, tj = (jax.device_put(jnp.asarray(a), sh) for a in (xs_np, target))

    @jax.jit
    def step(params):
        def loss(params):
            y, aux = fn(params, xj)
            return ((y - tj) ** 2).mean() + 0.01 * aux
        l, g = jax.value_and_grad(loss)(params)
        return jax.tree.map(lambda a, b: a - TRAIN_LR * b, params, g), l

    want = []
    for _ in range(TRAIN_STEPS):
        placed, l = step(placed)
        want.append(float(l))
    assert want[-1] < want[0] * 0.8, want
    for got in world:
        np.testing.assert_allclose(got["train_losses"], want, rtol=0,
                                   atol=1e-4)


def test_moe_dispatch_follows_switch_semantics():
    """Ties go to the first expert; slots are the order of arrival; past
    capacity a token has no slot."""
    gates = torch.tensor([[0.5, 0.5], [0.2, 0.8], [0.6, 0.4], [0.9, 0.1]])
    dispatch, combine = M._dispatch_combine(gates, capacity=2)
    assert dispatch.shape == (4, 2, 2)
    np.testing.assert_array_equal(dispatch.sum(dim=(1, 2)).numpy(),
                                  [1, 1, 1, 0])
    assert dispatch[0, 0, 0] == 1 and dispatch[2, 0, 1] == 1
    assert dispatch[1, 1, 0] == 1
    np.testing.assert_allclose(combine.sum(dim=(1, 2)).numpy(),
                               [0.5, 0.8, 0.6, 0.0])


def test_moe_and_pipeline_refuse_tf32():
    from rabit_tpu_torch.parallel.mesh import make_mesh
    saved = torch.backends.cuda.matmul.allow_tf32
    mesh = make_mesh((1,), "cpu", axes=("ep",))
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        with pytest.raises(RuntimeError, match="allow_tf32"):
            M.make_moe_fn(mesh)
        with pytest.raises(RuntimeError, match="allow_tf32"):
            PL.make_pipeline_fn(mesh, _torch_stage)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
        dist.destroy_process_group()


def test_converters_hand_each_rank_its_rows():
    from rabit_tpu_torch import convert
    params = _moe_params(0, 4)
    for r in range(4):
        got = convert.moe_params_from_jax(params, r, 4, "cpu")
        np.testing.assert_array_equal(got["router"].numpy(),
                                      params["router"])
        for k in ("w_in", "w_out"):
            np.testing.assert_array_equal(got[k].numpy(), params[k][r:r + 1])
    stacked = PL.stack_stage_params(_stage_params(0, 4))
    got = convert.pipeline_params_from_jax(stacked, 2, 4, "cpu")
    np.testing.assert_array_equal(got["w"].numpy(), stacked["w"][2:3])
    with pytest.raises(ValueError, match="does not divide"):
        convert.moe_params_from_jax(_moe_params(0, 3), 0, 2, "cpu")


def test_moe_at_one_rank_matches_jax_and_the_oracle():
    """The per-shard function at p = 1 (no group) is the dense oracle
    without drops, as JAX's at one device."""
    params = _moe_params(9, 1)
    x = _moe_x(10, 8)
    tp = {k: torch.from_numpy(v) for k, v in params.items()}
    y, aux = M.moe_ffn(tp, torch.from_numpy(x), None, capacity_factor=1.0)
    np.testing.assert_allclose(y.numpy(), M.moe_reference(tp, torch.from_numpy(
        x)).numpy(), **MOE_TOL)
    mesh = jax_make_mesh(1, ("ep",))
    jy, jaux = jax_moe_fn(mesh, capacity_factor=1.0)(
        jax_place_moe(mesh, params), jnp.asarray(x))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **MOE_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), **MOE_TOL)
