"""The port's MLP (``rabit_tpu_torch/models/mlp.py``) against the JAX
package's ``rabit_tpu/models/mlp.py``, at the JAX tests' small size
(tests/test_models.py: in 12, hidden 8, out 4, batch 16), on the same
numpy parameters (``convert.mlp_params_from_jax``) and batch:

* the forward against JAX's ``forward`` (both take bf16 operands and sum
  their exact products in f32; only the order of the sums can differ);
* the gradients: each weight's cotangent is rounded to bf16 on both sides
  (autograd through the casts, JAX's dot transpose), the biases' are not,
  and they agree bit for bit at this size;
* one step at (dp, tp) = (2, 2) in a spawned gloo world of 4, for
  ``"psum"``, ``"ring"`` and ``"bucket"``, against JAX's
  ``make_train_step`` on a (2, 2) mesh: ``"ring"`` and ``"bucket"``
  within ``STEP_TOL``, tighter than tests/test_models.py:96-100 (loss
  rtol 2e-2, atol 1e-3; parameters rtol 5e-2, atol 5e-3); ``"psum"``
  within those bounds (``PSUM_TOL``): JAX's checked step sums a weight's
  cotangent over dp on the bf16 operand (the replicated-to-varying cast
  sits after ``astype(bfloat16)``), so its sum is rounded to bf16, where
  the port sums the bf16 cotangents in f32, as JAX's unchecked ``"ring"``
  step does. The steps are also held to each other: ``"bucket"``
  equals ``"ring"`` bit for bit (at dp 2 every element's sum is one
  addition either way), the async bucket step equals ``"bucket"`` bit for
  bit;
* the loss falling over 5 steps, ``reference_train_step`` against JAX's,
  the converter's round trip, and the mesh and TF32 checks.
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rabit_tpu_torch import convert
from rabit_tpu_torch.models import mlp
from rabit_tpu_torch.parallel.mesh import make_mesh
from torch_world import spawn_world

SIZES = dict(in_dim=12, hidden=8, out_dim=4)
BATCH, LR = 16, 0.5
FWD_TOL = dict(rtol=1e-6, atol=1e-6)
# one sharded step against JAX's: the same bf16 products, f32 sums in
# another order; a bf16 cotangent can round the other way, moving its
# weight by lr * 2^-8 of the gradient
STEP_TOL = dict(rtol=1e-3, atol=1e-4)
PSUM_TOL = dict(rtol=5e-2, atol=5e-3)       # tests/test_models.py:98-100
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
SYNCS = ("psum", "ring", "bucket", "async")


def _data(seed: int = 7):
    params = mlp.init_params(seed, **SIZES)
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((BATCH, SIZES["in_dim"])).astype(np.float32)
    y = rng.integers(0, SIZES["out_dim"], size=(BATCH,))
    return params, x, y


@pytest.fixture
def world_of_one():
    mesh = make_mesh((1, 1, 1), "cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_forward_matches_jax_forward():
    import jax.numpy as jnp
    from rabit_tpu.models import mlp as jmlp
    params, x, _ = _data(1)
    want = jmlp.forward({k: jnp.asarray(v) for k, v in params.items()},
                        jnp.asarray(x))
    with torch.no_grad():
        got = mlp.forward(mlp.model_on(params, "cpu"), torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


def test_weight_cotangents_are_rounded_to_bf16_as_jax_rounds_them():
    import jax
    import jax.numpy as jnp
    from rabit_tpu.models import mlp as jmlp
    params, x, y = _data(3)

    def jloss(p):
        logp = jax.nn.log_softmax(jmlp.forward(p, jnp.asarray(x)))
        return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None],
                                             axis=1))
    want = jax.grad(jloss)({k: jnp.asarray(v) for k, v in params.items()})
    model = mlp.model_on(params, "cpu")
    mlp._nll(mlp.forward(model, torch.from_numpy(x)),
             torch.from_numpy(y)).backward()

    def in_bf16(a):
        return np.array_equal(torch.from_numpy(np.array(a)).to(
            torch.bfloat16).float().numpy(), a)
    for k, p in model.named_parameters():
        got, w = p.grad.numpy(), np.asarray(want[k])
        # weights: rounded to bf16 on both sides; biases: f32 sums
        assert in_bf16(got) == in_bf16(w) == k.startswith("w"), k
        np.testing.assert_allclose(got, w, rtol=1e-6, atol=1e-7, err_msg=k)


def test_reference_step_matches_jax_reference_step():
    import jax.numpy as jnp
    from rabit_tpu.models import mlp as jmlp
    params, x, y = _data(5)
    want, want_loss = jmlp.reference_train_step(
        {k: jnp.asarray(v) for k, v in params.items()}, jnp.asarray(x),
        jnp.asarray(y), lr=LR)
    got, loss = mlp.reference_train_step(
        {k: torch.from_numpy(v) for k, v in params.items()},
        torch.from_numpy(x), torch.from_numpy(y), lr=LR)
    np.testing.assert_allclose(float(loss), float(want_loss), **LOSS_TOL)
    for k in params:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   **STEP_TOL, err_msg=k)


def test_loss_falls_over_five_steps(world_of_one):
    model, x, y = mlp.make_sharded_inputs(world_of_one, batch=32, in_dim=16,
                                          hidden=16, out_dim=4, seed=0)
    step = mlp.make_train_step(world_of_one, lr=0.2)
    losses = [float(step(model, x, y)) for _ in range(5)]
    assert np.isfinite(losses).all() and losses[-1] < losses[0], losses


def test_make_sharded_inputs_draws_the_jax_batch(world_of_one):
    """x and y as ``rabit_tpu.models.mlp.make_sharded_inputs`` draws
    them."""
    _, x, y = mlp.make_sharded_inputs(world_of_one, batch=BATCH, seed=4,
                                      **SIZES)
    rng = np.random.default_rng(4)
    np.testing.assert_array_equal(
        x.numpy(), rng.standard_normal((BATCH, 12)).astype(np.float32))
    np.testing.assert_array_equal(y.numpy(),
                                  rng.integers(0, 4, size=(BATCH,)))


def test_mesh_with_sp_and_tf32_are_refused(world_of_one):
    with pytest.raises(ValueError, match="grad_sync"):
        mlp.make_train_step(world_of_one, grad_sync="allgather")
    saved = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            mlp.make_train_step(world_of_one)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved
    sp2 = world_of_one.__class__((1, 1, 2), (0, 0, 0), world_of_one.groups,
                                 world_of_one.device)
    with pytest.raises(ValueError, match="sp must be 1"):
        mlp.make_train_step(sp2)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_weight_converter_round_trips(tp):
    params, _, _ = _data(9)
    states = [convert.mlp_params_from_jax(params, r, tp, "cpu")
              for r in range(tp)]
    assert states[0]["w1"].shape == (12, 8 // tp)
    assert states[0]["b1"].shape == (8 // tp,)
    assert states[0]["w2"].shape == (8 // tp, 4)
    assert states[0]["b2"].shape == (4,)
    back = convert.mlp_params_to_jax(states)
    for k in params:
        np.testing.assert_array_equal(back[k], params[k], err_msg=k)
    with pytest.raises(ValueError, match="divide"):
        convert.mlp_params_from_jax(params, 0, 3, "cpu")


def _step_rank(rank: int, p: int, params, x, y) -> dict:
    """One rank at (dp, tp, sp) = (2, 2, 1): one step of each sync from the
    same parameters; saves the loss and this rank's parameter shards."""
    mesh = make_mesh((2, 2, 1), "cpu")
    dp, tp = mesh.index("dp"), mesh.index("tp")
    rows = slice(dp * BATCH // 2, (dp + 1) * BATCH // 2)
    xs = torch.from_numpy(x[rows].copy())
    ys = torch.from_numpy(y[rows].copy())
    got = {"coords": np.array(mesh.coords)}
    for sync in SYNCS:
        os.environ.pop("RABIT_ASYNC_COLLECTIVES", None)
        if sync == "async":
            os.environ["RABIT_ASYNC_COLLECTIVES"] = "1"
        model = mlp.model_on(params, "cpu", tp, 2)
        step = mlp.make_train_step(mesh, lr=LR,
                                   grad_sync="bucket" if sync == "async"
                                   else sync)
        got[f"{sync}|loss"] = np.array(float(step(model, xs, ys)))
        for k, t in model.state_dict().items():
            got[f"{sync}|{k}"] = t.numpy()
    os.environ.pop("RABIT_ASYNC_COLLECTIVES", None)
    return got


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    params, x, y = _data(7)
    return spawn_world(_step_rank, 4, tmp_path_factory.mktemp("mlp4"),
                       params, x, y)


def _gather(ranks, sync):
    """The full parameters from the tp shards of dp 0, after checking that
    the dp replicas hold the same bits."""
    layout = np.arange(4).reshape(2, 2)
    states = []
    for t in range(2):
        reps = [ranks[r] for r in layout[:, t]]
        for k in mlp.param_specs():
            assert reps[0][f"{sync}|{k}"].tobytes() == \
                reps[1][f"{sync}|{k}"].tobytes(), (sync, k)
        states.append({k: torch.from_numpy(reps[0][f"{sync}|{k}"])
                       for k in mlp.param_specs()})
    losses = {float(r[f"{sync}|loss"]) for r in ranks}
    assert len(losses) == 1, losses
    return losses.pop(), convert.mlp_params_to_jax(states)


def _jax_step(sync):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as PS
    from rabit_tpu.models import mlp as jmlp
    from rabit_tpu.parallel import make_mesh as jax_mesh
    params, x, y = _data(7)
    mesh = jax_mesh(4, ("dp", "tp"), (2, 2))
    specs = jmlp.param_specs()
    jp = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
          for k, v in params.items()}
    jx = jax.device_put(x, NamedSharding(mesh, PS("dp", None)))
    jy = jax.device_put(y.astype(np.int32), NamedSharding(mesh, PS("dp")))
    new, loss = jmlp.make_train_step(mesh, lr=LR, grad_sync=sync)(jp, jx, jy)
    return float(loss), {k: np.asarray(v) for k, v in new.items()}


@pytest.mark.parametrize("sync", ["psum", "ring", "bucket"])
def test_step_at_dp2_tp2_matches_jax(gloo_world, sync):
    loss, got = _gather(gloo_world, sync)
    want_loss, want = _jax_step(sync)
    np.testing.assert_allclose(loss, want_loss, **LOSS_TOL)
    tol = PSUM_TOL if sync == "psum" else STEP_TOL
    for k in want:
        np.testing.assert_allclose(got[k], want[k], **tol, err_msg=k)


@pytest.mark.parametrize("a,b", [("bucket", "ring"), ("async", "bucket")])
def test_steps_equal_bit_for_bit(gloo_world, a, b):
    for r, got in enumerate(gloo_world):
        for k in ["loss", *mlp.param_specs()]:
            assert got[f"{a}|{k}"].tobytes() == got[f"{b}|{k}"].tobytes(), \
                (a, b, k, r)


def test_mesh_rank_layout_is_the_jax_meshs(gloo_world):
    from rabit_tpu.parallel import make_mesh as jax_mesh
    ids = np.vectorize(lambda d: d.id)(
        jax_mesh(4, ("dp", "tp"), (2, 2)).devices)
    for r, got in enumerate(gloo_world):
        assert ids[tuple(got["coords"][:2])] == r
