"""The port's ring attention (``rabit_tpu_torch/parallel/ring_attention.py``)
against the JAX package: at p = 1 against JAX ``ring_attention`` with the
Pallas flash kernels (interpret mode) and ``reference_attention``, values
and gradients of q, k and v; in one spawned gloo world of 4, causal and
not, against JAX ``sequence_parallel_attention`` on a 4-device mesh and
its gradients. The port runs on the CPU, so its block step takes the
plain versions of the flash kernels."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from rabit_tpu.parallel import make_mesh, sequence_parallel_attention
from rabit_tpu.parallel.ring_attention import (
    reference_attention as jax_reference_attention,
    ring_attention as jax_ring_attention)
from rabit_tpu.parallel.collectives import unchecked_shard_map
from rabit_tpu_torch.parallel import ring_attention as R
from torch_world import spawn_world

B, T, H, D = 2, 64, 4, 16     # batch, global sequence, heads, head dim
P_RING = 4
# values: f32 attention in two frameworks (tests/test_ring_attention.py's
# 2e-5); gradients of sum(out^2) over 64 positions, values up to ~10:
# 1e-4 relative to the largest
VAL_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_RTOL_OF_MAX = 1e-4


def _qkv(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal((B, T, H, D)).astype(np.float32)
            for _ in range(3)]


def _assert_grads(got, want):
    for name, g, w in zip("qkv", got, want):
        w = np.asarray(w)
        err = np.abs(np.asarray(g) - w).max() / np.abs(w).max()
        assert err <= GRAD_RTOL_OF_MAX, (name, err)


def _port(q, k, v, causal, group=None):
    """Port output and grads of sum(out^2), on CPU tensors."""
    leaves = [torch.from_numpy(x.copy()).requires_grad_() for x in (q, k, v)]
    out = R.ring_attention(*leaves, group, causal)
    (out ** 2).sum().backward()
    return out.detach().numpy(), [x.grad.numpy() for x in leaves]


def _jax_ring_p1(q, k, v, causal):
    mesh1 = make_mesh(1, ("sp",))
    f = unchecked_shard_map(
        functools.partial(jax_ring_attention, axis_name="sp", causal=causal,
                          use_pallas=True),
        mesh=mesh1, in_specs=(P("sp"),) * 3, out_specs=P("sp"))
    out = jax.jit(f)(q, k, v)
    grads = jax.grad(lambda *a: (f(*a) ** 2).sum(), argnums=(0, 1, 2))(
        q, k, v)
    return np.asarray(out), grads


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_matches_jax(causal):
    q, k, v = _qkv(1)
    got = R.reference_attention(*map(torch.from_numpy, (q, k, v)), causal)
    for b in range(B):
        want = jax_reference_attention(q[b], k[b], v[b], causal=causal)
        np.testing.assert_allclose(got[b].numpy(), np.asarray(want),
                                   **VAL_TOL)


def _steps_bf16(x):
    """One step of bf16 (2^-7 of the leading power of two) at |x|."""
    a = np.maximum(np.abs(np.asarray(x, np.float64)), 1e-38)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


@pytest.mark.parametrize("causal", [False, True])
def test_reference_attention_bf16_matches_jax(causal):
    """bf16 q/k/v: softmax in f32, the weights rounded to bf16, their
    product with v summed in f32, one cast to bf16 at the end, as JAX's
    ``reference_attention``. q and k lie on a grid of 1/16 (every score
    exact in f32 in any order of summation); the bf16 outputs then agree
    within 1e-4 of the largest, or one bf16 step of the value where the
    final cast of two f32 sums formed in other orders flips."""
    q, k, v = _qkv(2)
    q, k = (np.clip(np.round(x * 16) / 16, -4, 4).astype(np.float32)
            for x in (q, k))
    got = R.reference_attention(*(torch.from_numpy(x).to(torch.bfloat16)
                                  for x in (q, k, v)), causal)
    assert got.dtype == torch.bfloat16
    for b in range(B):
        want = np.asarray(jax_reference_attention(
            *(jnp.asarray(x[b]).astype(jnp.bfloat16) for x in (q, k, v)),
            causal=causal).astype(jnp.float32), np.float64)
        err = np.abs(got[b].float().numpy() - want)
        assert (err <= 1e-4 * np.abs(want).max() + _steps_bf16(want)).all()


@pytest.mark.parametrize("causal", [False, True])
def test_single_shard_matches_jax_flash_path_and_oracle(monkeypatch,
                                                        causal):
    """p = 1: one flash block step over the whole sequence, then o / l; the
    batch folds into the heads of one step."""
    monkeypatch.setenv("RABIT_PALLAS_INTERPRET", "1")
    q, k, v = _qkv(2)
    out, grads = _port(q, k, v, causal)
    for b in range(B):
        want, want_g = _jax_ring_p1(q[b], k[b], v[b], causal)
        np.testing.assert_allclose(out[b], want, **VAL_TOL)
        _assert_grads([g[b] for g in grads], want_g)
        oracle = jax_reference_attention(q[b], k[b], v[b], causal=causal)
        np.testing.assert_allclose(out[b], np.asarray(oracle), **VAL_TOL)
        oracle_g = jax.grad(
            lambda *a: (jax_reference_attention(*a, causal=causal) ** 2
                        ).sum(), argnums=(0, 1, 2))(q[b], k[b], v[b])
        _assert_grads([g[b] for g in grads], oracle_g)


def _ring_rank(rank, p, q, k, v):
    """One rank: its sequence shard through ring attention over the world,
    causal and not; saves outputs and gradients of its local sum(out^2)
    (their sum over ranks is the global loss)."""
    import torch.distributed as dist
    t_loc = q.shape[1] // p
    part = slice(rank * t_loc, (rank + 1) * t_loc)
    from rabit_tpu_torch.parallel import collectives as C
    got = {}
    # the differentiable pieces: rank r holds r + [0, 1, 2]; the
    # cotangent of each output is 10 * (this rank + 1)
    x = (torch.arange(3.0) + rank).requires_grad_()
    ct = torch.full((3,), 10.0 * (rank + 1))
    for name, fn in (("shift", C.ring_shift),
                     ("psum_ident", C.psum_identity_grad),
                     ("ident_psum", C.ident_psum_grad)):
        out = fn(x, dist.group.WORLD)
        (grad,) = torch.autograd.grad(out, x, ct)
        got[f"{name}_out"], got[f"{name}_grad"] = out.detach().numpy(), \
            grad.numpy()
    for causal in (False, True):
        out, grads = _port(q[:, part], k[:, part], v[:, part], causal,
                           dist.group.WORLD)
        got[f"out_{causal}"] = out
        for name, g in zip("qkv", grads):
            got[f"d{name}_{causal}"] = g
    return got


@pytest.fixture(scope="module")
def ring_world(tmp_path_factory):
    q, k, v = _qkv(3)
    ranks = spawn_world(_ring_rank, P_RING, tmp_path_factory.mktemp("ring"),
                        q, k, v)
    return (q, k, v), ranks


@pytest.mark.parametrize("causal", [False, True])
def test_world_of_four_matches_sequence_parallel_attention(ring_world,
                                                           causal):
    (q, k, v), ranks = ring_world
    got = np.concatenate([r[f"out_{causal}"] for r in ranks], axis=1)
    got_g = [np.concatenate([r[f"d{n}_{causal}"] for r in ranks], axis=1)
             for n in "qkv"]
    mesh = make_mesh(P_RING, ("sp",))
    for b in range(B):
        want = sequence_parallel_attention(q[b], k[b], v[b], mesh,
                                           causal=causal)
        np.testing.assert_allclose(got[b], np.asarray(want), **VAL_TOL)
        want_g = jax.grad(
            lambda *a: (sequence_parallel_attention(*a, mesh, causal=causal)
                        ** 2).sum(), argnums=(0, 1, 2))(
            jnp.asarray(q[b]), jnp.asarray(k[b]), jnp.asarray(v[b]))
        _assert_grads([g[b] for g in got_g], want_g)


def test_ring_shift_and_the_tp_pair_in_a_world_of_four(ring_world):
    """``ring_shift`` moves rank r's tensor to rank r+1 and its gradient
    back to rank r-1 (the transpose of the rotation);
    ``psum_identity_grad`` sums forward and passes the gradient through;
    ``ident_psum_grad`` passes forward and sums the gradient."""
    _, ranks = ring_world
    p = len(ranks)
    total = sum(np.arange(3.0) + r for r in range(p))
    ct_sum = sum(10.0 * (r + 1) for r in range(p))
    for r, got in enumerate(ranks):
        np.testing.assert_array_equal(got["shift_out"],
                                      np.arange(3.0) + (r - 1) % p)
        np.testing.assert_array_equal(got["shift_grad"],
                                      np.full(3, 10.0 * ((r + 1) % p + 1)))
        np.testing.assert_array_equal(got["psum_ident_out"], total)
        np.testing.assert_array_equal(got["psum_ident_grad"],
                                      np.full(3, 10.0 * (r + 1)))
        np.testing.assert_array_equal(got["ident_psum_out"],
                                      np.arange(3.0) + r)
        np.testing.assert_array_equal(got["ident_psum_grad"],
                                      np.full(3, ct_sum))
