"""The port's flagship transformer (``rabit_tpu_torch/models/transformer.py``)
against the JAX package, at the JAX tests' small size
(tests/test_transformer.py: 2 layers, d_model 32, 4 heads x 8, d_ff 64,
vocab 64, batch 4, seq 32). The same numpy parameters and tokens go to
both: the forward against JAX ``forward_reference``; one SGD step on a
world of one, and in one spawned gloo world of 4 with layouts (dp, tp,
sp) = (2, 1, 2) and (1, 2, 2) under both grad syncs, against JAX's dense
SGD step; the loss falling; the weight converter; the entry points.

``test_nccl_step_on_the_cards`` runs the (1, 2, 2) step on an NCCL world
of up to 4 cards through the CUDA kernels, against the same step computed
densely on the CPU by the port's oracle. It is marked ``cuda`` and skips
without two cards. This module imports JAX only inside the tests that use
it, so on a machine with cards and no JAX:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_transformer.py
"""

import os

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rabit_tpu_torch import convert
from rabit_tpu_torch import entry as E
from rabit_tpu_torch.models import transformer as tf
from rabit_tpu_torch.parallel.mesh import make_mesh
from torch_world import spawn_world

SIZES = dict(n_layers=2, d_model=32, n_heads=4, d_head=8, d_ff=64)
VOCAB, BATCH, SEQ = 64, 4, 32
# tests/test_transformer.py:69-73 (one sharded step vs the dense step)
LOSS_TOL, PARAM_TOL = 1e-4, 5e-4
# the forward against JAX: f32 through 2 layers (test_transformer.py:30)
FWD_TOL = dict(rtol=2e-4, atol=2e-4)
LAYOUTS = [((2, 1, 2), "psum"), ((2, 1, 2), "ring"), ((1, 2, 2), "psum"),
           ((1, 2, 2), "ring"), ((2, 1, 2), "bucket"), ((1, 2, 2), "bucket")]
# the async bucket step, run beside the layouts in the same world
ASYNC = [((2, 1, 2), "async"), ((1, 2, 2), "async")]
# bf16 logits against JAX's bf16 forward: within 2e-2 of max|logit| (the
# two frameworks round bf16 activations at other places: XLA keeps a
# fused chain of elementwise ops in f32, torch rounds after each op)
BF16_LOGIT_REL = 2e-2
# the bf16 forward run in the gloo world of 4, one sp shard a rank
BF16_SHAPE, BF16_SEED = (1, 1, 4), 9
# the bf16 train step against JAX's: the loss within 1e-3 relative, every
# updated parameter within two bf16 steps of its tensor's largest |value|
# (the frameworks round bf16 at other places: one step read at most)
BF16_LOSS_REL, BF16_PARAM_STEPS = 1e-3, 2


def _data(seed: int):
    params = tf.init_params(seed, vocab=VOCAB, max_t=128, **SIZES)
    toks = np.random.default_rng(seed).integers(0, VOCAB,
                                                size=(BATCH, SEQ + 1))
    return params, toks[:, :-1], toks[:, 1:]


def _jax_dense_step(params, x, y, lr):
    """JAX's dense single-device SGD step (test_transformer.py:56-67)."""
    import jax
    import jax.numpy as jnp
    from rabit_tpu.models import transformer as jtf
    dense = {k: jnp.asarray(v) for k, v in params.items()}

    def loss(p):
        logits = jtf.forward_reference(p, jnp.asarray(x, jnp.int32))
        logp = jax.nn.log_softmax(logits.astype(jnp.float32), axis=-1)
        return -jnp.take_along_axis(
            logp, jnp.asarray(y, jnp.int32)[..., None], axis=-1).mean()

    value, grads = jax.value_and_grad(loss)(dense)
    return float(value), {k: np.asarray(dense[k] - lr * grads[k])
                          for k in dense}


def _torch_dense_step(params, x, y, lr):
    """The same step through the port's dense oracle, on the CPU."""
    model = tf.model_on(params, "cpu")
    logits = tf.forward_reference(model, torch.from_numpy(x))
    loss = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), torch.from_numpy(y).reshape(-1))
    loss.backward()
    return float(loss.detach()), {
        k: (p - lr * p.grad).detach().numpy()
        for k, p in model.named_parameters()}


def _assert_step(loss, params, want_loss, want):
    assert abs(loss - want_loss) < LOSS_TOL, (loss, want_loss)
    assert params.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(params[k], want[k], rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=k)


@pytest.fixture
def world_of_one():
    mesh = make_mesh((1, 1, 1), "cpu")
    try:
        yield mesh
    finally:
        dist.destroy_process_group()


def test_parameter_names_and_layouts_are_the_jax_ones():
    import jax
    from rabit_tpu.models import transformer as jtf
    want = jtf.init_params(jax.random.PRNGKey(0), vocab=VOCAB, max_t=128,
                           **SIZES)
    got = tf.model_on(tf.init_params(0, vocab=VOCAB, max_t=128, **SIZES),
                      "cpu").state_dict()
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    jspecs = jtf.param_specs(want)
    for name, axis in tf.param_specs(got).items():
        spec = tuple(jspecs[name])
        assert axis == (spec.index("tp") if "tp" in spec else None), name


@pytest.mark.parametrize("flash", [False, True])
def test_forward_matches_jax_forward_reference(flash):
    from rabit_tpu.models import transformer as jtf
    params, x, _ = _data(1)
    model = tf.model_on(params, "cpu")
    tokens = torch.from_numpy(x)
    with torch.no_grad():
        got = (tf.forward(model, tokens) if flash
               else tf.forward_reference(model, tokens))
    want = jtf.forward_reference(params, x.astype(np.int32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **FWD_TOL)


@pytest.mark.parametrize("grad_sync", ["psum", "ring"])
def test_world_of_one_step_matches_jax_dense_sgd(world_of_one, grad_sync):
    params, x, y = _data(3)
    lr = 0.2
    model = tf.model_on(params, "cpu")
    step = tf.make_train_step(world_of_one, lr=lr, grad_sync=grad_sync)
    loss = float(step(model, torch.from_numpy(x), torch.from_numpy(y)))
    got = convert.transformer_params_to_jax([model.state_dict()])
    _assert_step(loss, got, *_jax_dense_step(params, x, y, lr))


def test_loss_falls_over_eight_steps(world_of_one):
    model, x, y = tf.make_sharded_inputs(world_of_one, batch=BATCH, seq=SEQ,
                                         vocab=VOCAB, **SIZES)
    step = tf.make_train_step(world_of_one, lr=0.5)
    losses = [float(step(model, x, y)) for _ in range(8)]
    assert np.isfinite(losses).all(), losses
    assert losses[-1] < losses[0] * 0.9, losses


def test_sharded_forward_of_a_world_of_one_is_the_dense_forward(
        world_of_one):
    model, x, _ = tf.make_sharded_inputs(world_of_one, batch=BATCH, seq=SEQ,
                                         vocab=VOCAB, seed=2, **SIZES)
    got = tf.make_forward(world_of_one)(model, x)
    assert not got.requires_grad
    with torch.no_grad():
        want = tf.forward_reference(model, x)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)


def test_unported_grad_sync_raises(world_of_one):
    with pytest.raises(ValueError, match="grad_sync must be one of"):
        tf.make_train_step(world_of_one, grad_sync="allgather")


@pytest.mark.parametrize("grad_sync", ["bucket", "async"])
def test_world_of_one_bucket_steps_equal_the_psum_step(
        world_of_one, grad_sync, monkeypatch):
    """At world 1 every sum is the identity: the bucketed steps' bits are
    the psum step's."""
    params, x, y = _data(4)
    got = {}
    for sync in ("psum", grad_sync):
        if sync == "async":
            monkeypatch.setenv("RABIT_ASYNC_COLLECTIVES", "1")
        model = tf.model_on(params, "cpu")
        step = tf.make_train_step(world_of_one, lr=0.2, grad_sync="bucket"
                                  if sync == "async" else sync)
        for _ in range(2):
            loss = step(model, torch.from_numpy(x), torch.from_numpy(y))
        got[sync] = (float(loss), model.state_dict())
    assert got["psum"][0] == got[grad_sync][0]
    for k, t in got["psum"][1].items():
        assert torch.equal(t, got[grad_sync][1][k]), k


def _layout_rank(rank, p, params, x, y, lr, layouts, device,
                 bf16_seed=None):
    """One rank: for each layout, a mesh over the world, this rank's model
    shard and token block, one step; saves the loss and its parameters.
    With ``bf16_seed``, then the bf16 forward (``init_params(bf16_seed,
    dtype=bfloat16)``) at ``BF16_SHAPE``: this rank's logits, as f32; and
    one bf16 train step of that model on the same mesh: its loss, and its
    parameters' dtypes and values, as f32."""
    got = {}
    dev = torch.device(device, rank) if device == "cuda" else \
        torch.device(device)
    for shape, sync in layouts:
        mesh = make_mesh(shape, dev)
        model = tf.model_on(params, dev, mesh.index("tp"), mesh.size("tp"))
        if sync == "async":
            os.environ["RABIT_ASYNC_COLLECTIVES"] = "1"
        step = tf.make_train_step(mesh, lr=lr, grad_sync="bucket"
                                  if sync == "async" else sync)
        os.environ.pop("RABIT_ASYNC_COLLECTIVES", None)
        loss = step(model, tf.shard_tokens(x, mesh, dev),
                    tf.shard_tokens(y, mesh, dev))
        key = f"{'x'.join(map(str, shape))}-{sync}"
        got[f"{key}|loss"] = np.array(float(loss))
        got[f"{key}|coords"] = np.array(mesh.coords)
        for name, t in model.state_dict().items():
            got[f"{key}|{name}"] = t.cpu().numpy()
    if bf16_seed is not None:
        mesh = make_mesh(BF16_SHAPE, dev)
        model = tf.model_on(tf.init_params(bf16_seed, vocab=VOCAB, max_t=128,
                                           dtype="bfloat16", **SIZES), dev)
        logits = tf.make_forward(mesh)(model, tf.shard_tokens(x, mesh, dev))
        got["bf16|logits"] = logits.float().cpu().numpy()
        got["bf16|dtype"] = np.array(str(logits.dtype))
        loss = tf.make_train_step(mesh, lr=lr)(
            model, tf.shard_tokens(x, mesh, dev), tf.shard_tokens(y, mesh, dev))
        got["bf16-step|loss"] = np.array(float(loss))
        got["bf16-step|dtypes"] = np.array(sorted(
            {str(t.dtype) for t in model.state_dict().values()}))
        for name, t in model.state_dict().items():
            got[f"bf16-step|{name}"] = t.float().cpu().numpy()
    return got


def _gather(ranks, shape, sync):
    """The full parameters from the tp shards of (dp, sp) = (0, 0), after
    checking that every replica of a shard holds the same bits."""
    key = f"{'x'.join(map(str, shape))}-{sync}"
    layout = np.arange(int(np.prod(shape))).reshape(shape)
    states = []
    for t in range(shape[1]):
        replicas = [ranks[r] for r in layout[:, t, :].reshape(-1)]
        state = {n.split("|", 1)[1]: a for n, a in replicas[0].items()
                 if n.startswith(key + "|")
                 and not n.endswith(("|loss", "|coords"))}
        for other in replicas[1:]:
            for name, a in state.items():
                np.testing.assert_array_equal(other[f"{key}|{name}"], a,
                                              err_msg=name)
        states.append({n: torch.from_numpy(a) for n, a in state.items()})
    losses = [float(r[f"{key}|loss"]) for r in ranks]
    assert len(set(losses)) == 1, losses
    return losses[0], convert.transformer_params_to_jax(states)


@pytest.fixture(scope="module")
def gloo_world(tmp_path_factory):
    params, x, y = _data(5)
    lr = 0.2
    ranks = spawn_world(_layout_rank, 4, tmp_path_factory.mktemp("tf4"),
                        params, x, y, lr, LAYOUTS + ASYNC, "cpu", BF16_SEED)
    return ranks, _jax_dense_step(params, x, y, lr)


@pytest.mark.parametrize("shape,sync", LAYOUTS,
                         ids=[f"{'x'.join(map(str, s))}-{g}"
                              for s, g in LAYOUTS])
def test_world_of_four_step_matches_jax_dense_sgd(gloo_world, shape, sync):
    ranks, want = gloo_world
    _assert_step(*_gather(ranks, shape, sync), *want)


@pytest.mark.parametrize("shape", [s for s, _ in ASYNC])
def test_async_bucket_step_equals_the_bucket_step_bit_for_bit(gloo_world,
                                                              shape):
    ranks, _ = gloo_world
    tag = "x".join(map(str, shape))
    for r, got in enumerate(ranks):
        names = [n.split("|", 1)[1] for n in got
                 if n.startswith(f"{tag}-bucket|")]
        assert "loss" in names and len(names) > 3
        for name in names:
            assert got[f"{tag}-async|{name}"].tobytes() == \
                got[f"{tag}-bucket|{name}"].tobytes(), (r, name)


@pytest.mark.parametrize("shape", sorted({s for s, _ in LAYOUTS}))
def test_mesh_rank_layout_is_the_jax_meshs(gloo_world, shape):
    """Rank r sits where device r sits in JAX's (dp, tp, sp) mesh of the
    same shape (row-major)."""
    from rabit_tpu.parallel import make_mesh as jax_make_mesh
    ranks, _ = gloo_world
    ids = np.vectorize(lambda d: d.id)(
        jax_make_mesh(4, ("dp", "tp", "sp"), shape).devices)
    key = f"{'x'.join(map(str, shape))}-psum"
    for r, got in enumerate(ranks):
        assert ids[tuple(got[f"{key}|coords"])] == r


def test_world_of_four_bf16_forward_matches_jax(gloo_world):
    """The bf16 forward at (dp, tp, sp) = (1, 1, 4), the ring over four
    gloo ranks (each a quarter of the sequence), against JAX's bf16
    ``make_forward`` on a mesh of the same shape and the same weights."""
    import jax.numpy as jnp
    from rabit_tpu.models import transformer as jtf
    from rabit_tpu.parallel import make_mesh as jax_make_mesh
    ranks, _ = gloo_world
    assert all(str(r["bf16|dtype"]) == "torch.bfloat16" for r in ranks)
    got = np.concatenate([r["bf16|logits"] for r in ranks], axis=1)
    params = tf.init_params(BF16_SEED, vocab=VOCAB, max_t=128, **SIZES)
    _, x, _ = _data(5)
    mesh = jax_make_mesh(4, ("dp", "tp", "sp"), BF16_SHAPE)
    want = np.asarray(jtf.make_forward(mesh)(
        {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in params.items()},
        jnp.asarray(x, jnp.int32)).astype(jnp.float32))
    assert got.shape == want.shape == (BATCH, SEQ, VOCAB)
    err = np.abs(got - want).max()
    assert err <= BF16_LOGIT_REL * np.abs(want).max(), err


def _jax_bf16_step(jparams, mesh, x, y, lr):
    """JAX's bf16 ``make_train_step`` on ``mesh``: (loss, the updated
    parameters as f32 numpy)."""
    import jax.numpy as jnp
    from rabit_tpu.models import transformer as jtf
    new, loss = jtf.make_train_step(mesh, lr=lr)(
        jparams, jnp.asarray(x, jnp.int32), jnp.asarray(y, jnp.int32))
    assert {str(v.dtype) for v in new.values()} == {"bfloat16"}
    return float(loss), {k: np.asarray(v.astype(jnp.float32))
                         for k, v in new.items()}


def _assert_bf16_step(loss, params, want_loss, want, before):
    """The loss within ``BF16_LOSS_REL``; each parameter within
    ``BF16_PARAM_STEPS`` bf16 steps of its tensor's largest |value|; and
    the step moved the parameters that JAX's step moved."""
    assert abs(loss - want_loss) <= BF16_LOSS_REL * abs(want_loss), \
        (loss, want_loss)
    assert params.keys() == want.keys()
    for k, w in want.items():
        top = np.abs(w).max()
        step = 2.0 ** (np.floor(np.log2(top)) - 7)
        err = np.abs(params[k] - w).max()
        assert err <= BF16_PARAM_STEPS * step, (k, err, step)
        if (w != before[k]).any():
            assert (params[k] != before[k]).any(), k


def test_world_of_four_bf16_step_matches_jax(gloo_world):
    """One bf16 train step at (dp, tp, sp) = (1, 1, 4), the ring's
    backward exchanging bf16 K/V over four gloo ranks and the bf16
    gradients summed over sp, against JAX's bf16 step on a mesh of the
    same shape and the same weights: the same loss and bf16 parameters
    on every rank."""
    import jax.numpy as jnp
    from rabit_tpu.parallel import make_mesh as jax_make_mesh
    ranks, _ = gloo_world
    params = tf.init_params(BF16_SEED, vocab=VOCAB, max_t=128, **SIZES)
    _, x, y = _data(5)
    jparams = {k: jnp.asarray(v).astype(jnp.bfloat16)
               for k, v in params.items()}
    want_loss, want = _jax_bf16_step(
        jparams, jax_make_mesh(4, ("dp", "tp", "sp"), BF16_SHAPE), x, y, 0.2)
    before = {k: np.asarray(v.astype(jnp.float32))
              for k, v in jparams.items()}
    for r, got in enumerate(ranks):
        assert list(got["bf16-step|dtypes"]) == ["torch.bfloat16"], r
        state = {n.split("|", 1)[1]: a for n, a in got.items()
                 if n.startswith("bf16-step|")
                 and not n.endswith(("|loss", "|dtypes"))}
        _assert_bf16_step(float(got["bf16-step|loss"]), state, want_loss,
                          want, before)


def test_bf16_step_matches_jax_bf16_step(world_of_one):
    """At the entry's widths (vocab 256, 2 layers, d_model 128, 8 heads x
    16, 2 x 128 tokens), JAX's bf16 weights carried across by
    ``transformer_params_from_jax``: the port's bf16 train step on a
    (1, 1, 1) mesh against JAX's on a (1, 1, 1) mesh. The gradients come
    back bf16 and the parameters stay bf16."""
    import jax
    import jax.numpy as jnp
    from rabit_tpu.models import transformer as jtf
    from rabit_tpu.parallel import make_mesh as jax_make_mesh
    sizes = dict(E.ENTRY_SIZES)
    jparams = jtf.init_params(jax.random.PRNGKey(0), dtype=jnp.bfloat16,
                              **sizes)
    toks = np.random.default_rng(0).integers(0, sizes["vocab"],
                                             size=(2, 129))
    x, y = toks[:, :-1], toks[:, 1:]
    lr = E.FLAGSHIP_LR
    want_loss, want = _jax_bf16_step(
        jparams, jax_make_mesh(1, ("dp", "tp", "sp"), (1, 1, 1)), x, y, lr)
    model = tf.model_on({k: np.asarray(v) for k, v in jparams.items()},
                        "cpu")
    grads = {}
    for name, p in model.named_parameters():
        p.register_hook(lambda g, name=name: grads.update({name: g.dtype}))
    loss = tf.make_train_step(world_of_one, lr=lr)(
        model, torch.from_numpy(x), torch.from_numpy(y))
    assert set(grads.values()) == {torch.bfloat16}
    state = model.state_dict()
    assert {t.dtype for t in state.values()} == {torch.bfloat16}
    before = {k: np.asarray(v.astype(jnp.float32))
              for k, v in jparams.items()}
    _assert_bf16_step(float(loss), {k: t.float().numpy()
                                    for k, t in state.items()},
                      want_loss, want, before)


@pytest.mark.parametrize("tp", [1, 2, 4])
def test_weight_converter_round_trips(tp):
    params, _, _ = _data(7)
    states = [convert.transformer_params_from_jax(params, r, tp, "cpu")
              for r in range(tp)]
    assert states[0]["l0.wq"].shape == (32, 4 // tp, 8)
    assert states[0]["l1.w2"].shape == (64 // tp, 32)
    back = convert.transformer_params_to_jax(states)
    assert back.keys() == params.keys()
    for k in params:
        np.testing.assert_array_equal(back[k], params[k], err_msg=k)
    with pytest.raises(ValueError, match="divide"):
        convert.transformer_params_from_jax(params, 0, 3, "cpu")


@pytest.mark.parametrize("spelling", ["name", "torch", "ml_dtypes"])
def test_init_params_bf16_is_the_f32_draw_rounded_to_nearest_even(
        spelling):
    """``dtype`` bfloat16, however spelt: CPU bf16 tensors holding the f32
    draw rounded to nearest even, bit for bit what torch's cast and JAX's
    ``.astype(bfloat16)`` give; float32 stays the numpy draw."""
    import jax.numpy as jnp
    dtype = {"name": "bfloat16", "torch": torch.bfloat16,
             "ml_dtypes": jnp.bfloat16}[spelling]
    f32 = tf.init_params(3, vocab=VOCAB, max_t=128, **SIZES)
    got = tf.init_params(3, vocab=VOCAB, max_t=128, dtype=dtype, **SIZES)
    assert got.keys() == f32.keys()
    for name, a in f32.items():
        t = got[name]
        assert isinstance(t, torch.Tensor) and t.dtype == torch.bfloat16
        assert t.device.type == "cpu" and tuple(t.shape) == a.shape
        assert torch.equal(t, torch.from_numpy(a).to(torch.bfloat16)), name
        jax_bits = np.asarray(jnp.asarray(a).astype(jnp.bfloat16)).view(
            np.int16)
        np.testing.assert_array_equal(t.view(torch.int16).numpy(), jax_bits,
                                      err_msg=name)
    same = tf.init_params(3, vocab=VOCAB, max_t=128, dtype=np.float32,
                          **SIZES)
    for name, a in f32.items():
        np.testing.assert_array_equal(same[name], a)
    with pytest.raises(ValueError, match="dtype must be one of"):
        tf.init_params(3, dtype=torch.float16)


def test_bf16_model_needs_no_ml_dtypes():
    """The card's machine has no ``ml_dtypes``: a bf16 draw, its model and
    a forward run in a fresh interpreter where importing it fails."""
    import subprocess
    import sys
    code = ("import sys; sys.modules['ml_dtypes'] = None\n"
            "import torch\n"
            "from rabit_tpu_torch.models import transformer as tf\n"
            "p = tf.init_params(0, dtype='bfloat16')\n"
            "m = tf.model_on(p, 'cpu')\n"
            "assert {x.dtype for x in m.parameters()} == {torch.bfloat16}\n"
            "out = tf.forward(m, torch.zeros((1, 8), dtype=torch.long))\n"
            "assert out.dtype == torch.bfloat16\n"
            "assert 'ml_dtypes' not in sys.modules or "
            "sys.modules['ml_dtypes'] is None\n"
            "print('ok')\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_bf16_forward_and_make_forward_match_jax_make_forward(
        world_of_one):
    """At the entry's widths (vocab 256, 2 layers, d_model 128, 8 heads x
    16, 2 x 128 tokens), JAX's bf16 weights carried across
    (``transformer_params_from_jax`` takes ml_dtypes bf16): the port's
    ``forward`` and its (1, 1, 1) ``make_forward`` against JAX's bf16
    ``make_forward``, within 2e-2 of max|logit|; the two port paths alike
    bit for bit."""
    import jax
    import jax.numpy as jnp
    from rabit_tpu.models import transformer as jtf
    from rabit_tpu.parallel import make_mesh as jax_make_mesh
    sizes = dict(E.ENTRY_SIZES)
    jparams = jtf.init_params(jax.random.PRNGKey(0), dtype=jnp.bfloat16,
                              **sizes)
    toks = np.random.default_rng(0).integers(0, sizes["vocab"],
                                             size=(2, 128))
    mesh = jax_make_mesh(1, ("dp", "tp", "sp"), (1, 1, 1))
    want = np.asarray(jtf.make_forward(mesh)(
        jparams, jnp.asarray(toks, jnp.int32)).astype(jnp.float32))
    model = tf.model_on({k: np.asarray(v) for k, v in jparams.items()},
                        "cpu")
    assert {p.dtype for p in model.parameters()} == {torch.bfloat16}
    tokens = torch.from_numpy(toks)
    with torch.no_grad():
        got = tf.forward(model, tokens)
    sharded = tf.make_forward(world_of_one)(model, tokens)
    assert got.dtype == torch.bfloat16 and torch.equal(sharded, got)
    err = np.abs(got.float().numpy() - want).max()
    assert err <= BF16_LOGIT_REL * np.abs(want).max(), err


def test_entry_forward_matches_the_dense_oracle():
    fn, (model, tokens) = E.entry("cpu")
    assert tokens.shape == (E.ENTRY_BATCH, E.ENTRY_SEQ)
    with torch.no_grad():
        got = fn(model, tokens)
        want = tf.forward_reference(model, tokens)
    assert got.shape == (4, 256, 256)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **FWD_TOL)


def test_flagship_data_is_the_tpu_proofs():
    """(tokens, targets) as tools/flagship_hw_proof.py:41-47 makes them."""
    x, y = E.flagship_data()
    rng = np.random.default_rng(0)
    seq = np.arange(768, dtype=np.int64) % 256
    rows = np.stack([np.roll(seq, -int(s))[:513]
                     for s in rng.integers(0, 256, size=8)])
    np.testing.assert_array_equal(x, rows[:, :512])
    np.testing.assert_array_equal(y, rows[:, 1:513])
    assert ((x + 1) % 256 == y).all()


def test_train_flagship_loop_on_cpu_learns_and_checks(monkeypatch):
    """The loop at the test size: the flagship's configuration is read
    from the module when it is called."""
    monkeypatch.setattr(E, "FLAGSHIP_SIZES", dict(vocab=64, max_t=128,
                                                  **SIZES))
    monkeypatch.setattr(E, "FLAGSHIP_BATCH", 4)
    monkeypatch.setattr(E, "FLAGSHIP_SEQ", 32)
    monkeypatch.setattr(E, "FLAGSHIP_LR", 0.5)
    out = E.train_flagship(8, "cpu")
    assert out["device"] == "cpu" and len(out["step_ms"]) == 8
    assert np.mean(out["losses"][-4:]) < out["losses"][0] - 0.8
    assert not dist.is_initialized()
    monkeypatch.setattr(E, "FLAGSHIP_LR", 0.0)
    with pytest.raises(RuntimeError, match="did not decrease"):
        E.train_flagship(4, "cpu")
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def nccl_world(tmp_path_factory):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs at least two CUDA devices")
    from rabit_tpu_torch.ops import _build
    _build.build(["flash_block", "flash_block_bwd"])  # once, not per rank
    p = 4 if torch.cuda.device_count() >= 4 else 2
    shape = (1, 2, 2) if p == 4 else (1, 2, 1)
    params, x, y = _data(5)
    lr = 0.2
    ranks = spawn_world(_layout_rank, p, tmp_path_factory.mktemp("nccl"),
                        params, x, y, lr, [(shape, "ring"), (shape, "bucket")],
                        "cuda", backend="nccl")
    return shape, ranks, _torch_dense_step(params, x, y, lr)


@pytest.mark.cuda
def test_nccl_step_on_the_cards(nccl_world):
    """The (1, 2, 2) step (tp 2 x sp 2; (1, 2, 1) on two cards) through
    the flash kernels on an NCCL world, under ``"ring"`` and ``"bucket"``,
    against the dense step of the port's oracle on the CPU."""
    shape, ranks, want = nccl_world
    for sync in ("ring", "bucket"):
        _assert_step(*_gather(ranks, shape, sync), *want)
