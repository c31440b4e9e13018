"""CPU readings of the port's bf16 path against the JAX package, printed
for PERF.md (the tests assert the bounds; this prints the values):

    JAX_PLATFORMS=cpu python tests/torch_bf16_readings.py

1. The plain block step at bf16 (``block_update_reference``) against
   ``_block_update``: max|diff| / max of m', l', o' at H 4, T = S 64,
   D 32, causal, and at the card's two shapes (B*H 64, T = S 512, D 32,
   causal; H 8, T = S 1024, D 128), q/k/v normals from seed 0 and a
   running state, and at ``tests/test_torch_flash.py``'s exact-score
   inputs.
2. The flagship forward at bf16 at the entry's widths, JAX-drawn bf16
   weights carried across: the port's ``forward`` against JAX's
   ``make_forward`` at (1, 1, 1), and the same at f32."""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from rabit_tpu.models import transformer as jtf  # noqa: E402
from rabit_tpu.parallel import make_mesh  # noqa: E402
from rabit_tpu.parallel.ring_attention import _block_update  # noqa: E402
from rabit_tpu_torch import entry as E  # noqa: E402
from rabit_tpu_torch.models import transformer as tf  # noqa: E402
from rabit_tpu_torch.ops import flash as F  # noqa: E402


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.abs(np.asarray(got, np.float64) - want).max()
                 / np.abs(want).max())


def step_readings(h, t, s, d, causal, exact, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.standard_normal(sh).astype(np.float32)  # noqa
    q, k, v, m, o = f(h, t, d), f(h, s, d), f(h, s, d), f(h, t), f(h, t, d)
    l = (rng.random((h, t)) + 0.5).astype(np.float32)
    if exact:   # the tests' grid of 1/16: every q . k exact in f32
        q, k = (np.clip(np.round(x * 16) / 16, -4, 4).astype(np.float32)
                for x in (q, k))
    mask = np.triu(np.ones((t, s), bool), 1) if causal else None
    jq = [jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v)]
    want = _block_update(*jq, *map(jnp.asarray, (m, l, o)),
                         None if mask is None else jnp.asarray(mask),
                         d ** -0.5)
    got = F.block_update_reference(
        *(torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v)),
        *map(torch.from_numpy, (m, l, o)),
        None if mask is None else torch.from_numpy(mask), d ** -0.5)
    return [_rel(g.numpy(), w) for g, w in zip(got, want)]


def model_readings(dtype):
    sizes = dict(E.ENTRY_SIZES)
    jp = jtf.init_params(jax.random.PRNGKey(0), dtype=dtype, **sizes)
    toks = np.random.default_rng(0).integers(0, sizes["vocab"],
                                             size=(2, 128))
    mesh = make_mesh(1, ("dp", "tp", "sp"), (1, 1, 1))
    want = np.asarray(jtf.make_forward(mesh)(
        jp, jnp.asarray(toks, jnp.int32)).astype(jnp.float32))
    model = tf.model_on({k: np.asarray(a) for k, a in jp.items()}, "cpu")
    with torch.no_grad():
        got = tf.forward(model, torch.from_numpy(toks)).float().numpy()
    return float(np.abs(got - want).max()), float(np.abs(want).max())


def main():
    for shape in ((4, 64, 64, 32, True), (64, 512, 512, 32, True),
                  (8, 1024, 1024, 128, False)):
        for exact in (False, True):
            rel = step_readings(*shape, exact)
            print(f"plain step bf16 {shape} exact scores {exact}: m' "
                  f"{rel[0]:.3g}, l' {rel[1]:.3g}, o' {rel[2]:.3g} of max")
    for dtype in (jnp.float32, jnp.bfloat16):
        err, top = model_readings(dtype)
        print(f"flagship forward at the entry widths, "
              f"{jnp.dtype(dtype).name}: max|diff| {err:.4g} of "
              f"max|logit| {top:.4g} ({err / top:.3g})")


if __name__ == "__main__":
    main()
