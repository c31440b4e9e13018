"""The port's gradient histogram against the JAX package on the same
seeded numpy inputs.

The CUDA kernel itself runs only on the card (``chip_smoke.py`` holds it
against ``histogram_reference`` there). Here the plain version — what the
wrapper takes for CPU tensors — is held against the TPU kernel
``histogram_tpu`` run in interpret mode, as ``tests/test_models.py`` runs
it, and the port's other methods against their JAX counterparts."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from rabit_tpu.models import histogram as JH
from rabit_tpu_torch.models import histogram as H
from rabit_tpu_torch.ops import _build
from rabit_tpu_torch.ops import histogram as K

N_KERNEL = 16384   # one TPU-kernel chunk: no padding on the JAX side


def _inputs(n, nbins, seed):
    g, h, b = (a[0] for a in H.make_inputs(n, nbins, p=1, seed=seed))
    return g, h, b


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _jax_kernel(monkeypatch, b, g, h, nbins, precision):
    monkeypatch.setenv("RABIT_PALLAS_INTERPRET", "1")
    from rabit_tpu.ops.pallas_kernels import histogram_tpu
    return np.asarray(histogram_tpu(jnp.asarray(b), jnp.asarray(g),
                                    jnp.asarray(h), nbins,
                                    precision=precision))


# fast: both round the values to bf16 (nearest even) and sum in f32.
# high: the TPU kernel's hi/lo bf16 split is ~2e-6 relative per value;
# the port sums the f32 values themselves.
TOL = {"fast": dict(rtol=1e-5, atol=1e-4), "high": dict(rtol=1e-5, atol=1e-3)}


@pytest.mark.parametrize("precision", ["fast", "high"])
@pytest.mark.parametrize("nbins", [64, 1024])
def test_reference_matches_jax_kernel(monkeypatch, nbins, precision):
    g, h, b = _inputs(N_KERNEL, nbins, seed=5)
    want = _jax_kernel(monkeypatch, b, g, h, nbins, precision)
    got = K.histogram_reference(*_t(b, g, h), nbins, precision).numpy()
    np.testing.assert_allclose(got, want, **TOL[precision])


@pytest.mark.parametrize("precision", ["fast", "high"])
def test_padding_and_negative_ids_drop_like_jax_kernel(monkeypatch,
                                                       precision):
    """Ids ``nbins`` and ``-1`` contribute nothing, in the port and in the
    TPU kernel (whose logical shift makes negative ids miss)."""
    nbins = 64
    g, h, b = _inputs(N_KERNEL, nbins, seed=6)
    b = b.copy()
    b[::7] = nbins
    b[3::11] = -1
    b[5::13] = np.iinfo(np.int32).min
    want = _jax_kernel(monkeypatch, b, g, h, nbins, precision)
    got = K.histogram_reference(*_t(b, g, h), nbins, precision).numpy()
    np.testing.assert_allclose(got, want, **TOL[precision])
    keep = (b >= 0) & (b < nbins)
    oracle = H.host_histogram(g[keep], h[keep], b[keep], nbins)
    np.testing.assert_allclose(
        got, oracle, **(TOL[precision] if precision == "high"
                        else dict(rtol=2e-2, atol=0.5)))


def test_wide_histogram_matches_jax_scatter_and_oracle():
    """16,640 bins (the JAX test's lo-side branch width): the port against
    JAX ``local_histogram(method="scatter")`` and the f64 oracle, and the
    fast path against the oracle of the bf16-rounded values."""
    nbins, n = 16640, 20000
    g, h, b = _inputs(n, nbins, seed=8)
    want = np.asarray(JH.local_histogram(jnp.asarray(g), jnp.asarray(h),
                                         jnp.asarray(b), nbins,
                                         method="scatter"))
    got = K.histogram_reference(*_t(b, g, h), nbins, "high").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, H.host_histogram(g, h, b, nbins),
                               rtol=1e-6, atol=1e-6)
    bf = torch.from_numpy(np.stack([g, h])).to(torch.bfloat16).float()
    g16, h16 = bf.numpy()
    fast = K.histogram_reference(*_t(b, g, h), nbins, "fast").numpy()
    np.testing.assert_allclose(fast, H.host_histogram(g16, h16, b, nbins),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("method", ["matmul", "scatter"])
def test_methods_match_their_jax_counterparts(method):
    # 40,000 rows: more than one matmul chunk and a ragged last one
    nbins, n = 64, 40000
    g, h, b = _inputs(n, nbins, seed=9)
    b = b.copy()
    b[::17] = nbins  # padding ids inside the data
    want = np.asarray(JH.local_histogram(jnp.asarray(g), jnp.asarray(h),
                                         jnp.asarray(b), nbins,
                                         method=method))
    got = H.local_histogram(*_t(g, h, b), nbins, method=method).numpy()
    # both: bf16 (matmul) or f32 (scatter) values, f32 sums in
    # another order
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("precision", ["fast", "high"])
def test_auto_and_wrapper_take_plain_version_on_cpu(precision):
    nbins = 128
    g, h, b = _inputs(3001, nbins, seed=10)  # no multiple of 4 or 16384
    before = K.histogram.launches
    want = K.histogram_reference(*_t(b, g, h), nbins, precision)
    assert torch.equal(K.histogram(*_t(b, g, h), nbins, precision), want)
    assert torch.equal(H.local_histogram(*_t(g, h, b), nbins, "auto",
                                         precision), want)
    assert K.histogram.launches == before  # no kernel on the CPU


def test_cuda_method_refuses_cpu_tensors():
    g, h, b = _inputs(100, 16, seed=1)
    with pytest.raises(ValueError, match="cuda"):
        H.local_histogram(*_t(g, h, b), 16, method="cuda")
    with pytest.raises(ValueError, match="unknown method"):
        H.local_histogram(*_t(g, h, b), 16, method="pallas")


@pytest.mark.parametrize("bad", ["bins_i64", "grad_f64", "shape",
                                 "precision", "nbins"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    g, h, b = _t(*_inputs(100, 16, seed=2))
    nbins, precision = 16, "high"
    if bad == "bins_i64":
        b = b.long()
    elif bad == "grad_f64":
        g = g.double()
    elif bad == "shape":
        h = h[:50]
    elif bad == "precision":
        precision = "exact"
    else:
        nbins = 0
    with pytest.raises((TypeError, ValueError)):
        K.histogram(b, g, h, nbins, precision)


def test_kernel_build_needs_nvcc(monkeypatch):
    """The kernel source ships in the package; without the CUDA toolkit
    the build says so rather than falling back to anything."""
    assert "histogram" in _build.sources()
    assert _build.library_path("histogram").parent == _build.BUILD_DIR
    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "/nonexistent")
    monkeypatch.setattr(_build.os, "access", lambda *a: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.nvcc()
