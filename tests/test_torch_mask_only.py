"""The port's bin count (``rabit_tpu_torch/ops/histogram.py::mask_only``)
against the TPU kernel it replaces, ``mask_only`` of
``tools/histogram_sweep.py``, on the same seeded numpy ids.

The JAX tool defines its kernel inside ``main``; the test takes the two
nested functions ``_mask_only_body`` and ``mask_only`` out of the tool's
source with ``ast`` (the tool is not edited and not copied) and runs them
in interpret mode, as the JAX package's own tests run its Pallas kernels
on the CPU. Counts are integers, so the comparison is exact.

The CUDA kernel itself runs only on the card: ``chip_smoke.py`` holds it
against ``mask_only_reference`` there, bit for bit."""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from rabit_tpu.ops import pallas_kernels as PK
from rabit_tpu_torch.ops import _build
from rabit_tpu_torch.ops import histogram as K

SWEEP = Path(__file__).resolve().parents[1] / "tools" / "histogram_sweep.py"
CHUNK = 16384   # the TPU kernel's row chunk: it drops the rows after the
                # last whole chunk


def _jax_mask_only():
    """The tool's own ``mask_only`` (jitted, ``nbins`` static)."""
    tree = ast.parse(SWEEP.read_text(), str(SWEEP))
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    wanted = ("_mask_only_body", "mask_only")
    defs = {n.name: n for n in main.body
            if isinstance(n, ast.FunctionDef) and n.name in wanted}
    assert set(defs) == set(wanted), f"found only {sorted(defs)} in {SWEEP}"
    module = ast.Module(body=[defs[n] for n in wanted], type_ignores=[])
    ns = dict(jax=jax, jnp=jnp, pl=pl, functools=functools,
              _ATILE=PK._ATILE, _CHUNK=PK._CHUNK,
              _hist_compiler_params=PK._hist_compiler_params,
              _interpret=PK._interpret, _out_struct=PK._out_struct)
    exec(compile(module, str(SWEEP), "exec"), ns)
    return ns["mask_only"]


def _ids(n, lo, hi, seed):
    return np.random.default_rng(seed).integers(lo, hi, n).astype(np.int32)


def _bincount(b, nbins):
    keep = b[(b >= 0) & (b < nbins)]
    return np.bincount(keep, minlength=nbins).astype(np.float32)


def test_chunk_is_the_tools():
    assert PK._CHUNK == CHUNK


@pytest.mark.parametrize("n, nbins", [(1 << 16, 256), (1 << 15, 1000),
                                      (CHUNK, 4096)])
def test_reference_equals_jax_tool_kernel(monkeypatch, n, nbins):
    """Ids from -3 to nbins + 39: the out-of-range ones count nothing in
    either; 1000 bins are no multiple of the TPU's 128 lanes."""
    monkeypatch.setenv("RABIT_PALLAS_INTERPRET", "1")
    b = _ids(n, -3, nbins + 40, seed=n + nbins)
    want = np.asarray(_jax_mask_only()(jnp.asarray(b), nbins))
    got = K.mask_only_reference(torch.from_numpy(b), nbins).numpy()
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)
    assert np.array_equal(got, _bincount(b, nbins))


def test_reference_takes_a_ragged_tail_the_tool_drops(monkeypatch):
    """A row count that is no multiple of 4 or 16384: the port counts
    every row; the TPU kernel counts the whole chunks only."""
    monkeypatch.setenv("RABIT_PALLAS_INTERPRET", "1")
    nbins, n = 300, CHUNK + 4099
    b = _ids(n, -2, nbins + 3, seed=11)
    b[:7] = [-1, nbins, nbins + 40, 1 << 30, np.iinfo(np.int32).min, 0,
             nbins - 1]
    got = K.mask_only_reference(torch.from_numpy(b), nbins).numpy()
    assert np.array_equal(got, _bincount(b, nbins))
    tool = np.asarray(_jax_mask_only()(jnp.asarray(b), nbins))
    assert np.array_equal(tool, _bincount(b[:CHUNK], nbins))


def test_wrapper_takes_plain_version_on_cpu():
    b = torch.from_numpy(_ids(5003, -1, 70, seed=3))
    before = K.mask_only.launches
    assert torch.equal(K.mask_only(b, 64), K.mask_only_reference(b, 64))
    assert torch.equal(K.mask_only(b[1:], 64),
                       K.mask_only_reference(b[1:], 64))   # unaligned view
    assert K.mask_only.launches == before   # no kernel on the CPU
    assert torch.equal(K.mask_only(b[:0], 8), torch.zeros(8))


@pytest.mark.parametrize("bad", ["int64", "float", "2d", "nbins0",
                                 "nbins_negative"])
def test_wrapper_rejects_what_the_kernel_does_not_take(bad):
    b, nbins = torch.arange(64, dtype=torch.int32), 16
    if bad == "int64":
        b = b.long()
    elif bad == "float":
        b = b.float()
    elif bad == "2d":
        b = b.reshape(8, 8)
    elif bad == "nbins0":
        nbins = 0
    else:
        nbins = -4
    with pytest.raises((TypeError, ValueError)):
        K.mask_only(b, nbins)
    with pytest.raises((TypeError, ValueError)):
        K.mask_only_reference(b, nbins)


def test_kernel_source_ships_beside_the_others():
    src = _build.sources()
    assert {"histogram", "mask_only"} <= set(src)
    text = src["mask_only"].read_text()
    assert "tools/histogram_sweep.py:79" in text
    assert "rabit_mask_only_f32" in text
