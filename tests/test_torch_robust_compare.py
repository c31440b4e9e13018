"""One collective stream through both packages' robust engines, bit for
bit: ``tests/workers/torch_compare_worker.py`` under ``rabit_tpu`` (XLA
data plane, its own tracker) and under ``rabit_tpu_torch`` (torch data
plane over gloo, the port's tracker), both with
``rabit_reduce_method=ring`` (the port's ring folds in the JAX ring's
order) and a kill. Every round's f32 and f64 SUM, int32 MAX and broadcast
must be equal, rank by rank.

``test_nccl_worlds_on_the_cards`` runs the port's side over NCCL at worlds
2 and 4 (one rank a card), through a kill inside the data-plane
collective and a scripted data-plane failure, and holds it to the gloo
world bit for bit. It is marked ``cuda`` and skips without two cards. On a
machine with cards and no JAX (so without ``tests/conftest.py``):

    python -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_robust_compare.py

This module imports neither JAX nor ``rabit_tpu`` at its top."""

import os
import pickle
import sys

import pytest
import torch

from rabit_tpu_torch.engine import _native_build
from rabit_tpu_torch.tracker import launch as port_launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "workers", "torch_compare_worker.py")
COMMON = ["rabit_dataplane_minbytes=0", "rabit_reduce_method=ring"]
N_ITER = "5"


@pytest.fixture(scope="module", autouse=True)
def native_core():
    _native_build.build()


def _results(out_dir, world):
    docs = []
    for r in range(world):
        with open(os.path.join(out_dir, f"r{r}.pkl"), "rb") as f:
            docs.append(pickle.load(f))
    for r, d in enumerate(docs):
        assert d["results"] == docs[0]["results"], f"rank {r} differs"
    return docs


def run_port(world, out_dir, args=(), env=None, device="cpu"):
    os.makedirs(out_dir, exist_ok=True)
    cmd = [sys.executable, WORKER, "rabit_dataplane=torch",
           f"rabit_device={device}", *COMMON, *args]
    full = {"COMPARE_PKG": "rabit_tpu_torch", "COMPARE_OUT": str(out_dir),
            "N_ITER": N_ITER, **(env or {})}
    stats = {}
    assert port_launch.launch(world, cmd, timeout=240, quiet=True,
                              env=full, stats=stats) == 0
    return _results(out_dir, world), stats


def test_port_equals_rabit_tpu_bit_for_bit_through_a_kill(tmp_path):
    from rabit_tpu.tracker.launch import launch as jax_launch
    kill = ["mock=1,2,1,0"]
    ours, stats = run_port(4, tmp_path / "port", kill)
    assert stats["total_attempts"] == 1
    assert {d["backend"] for d in ours} == {"gloo"}
    assert min(d["epoch"] for d in ours) >= 2
    jax_dir = tmp_path / "jax"
    jax_dir.mkdir()
    env = {"COMPARE_PKG": "rabit_tpu", "COMPARE_OUT": str(jax_dir),
           "N_ITER": N_ITER, "RABIT_DATAPLANE": "xla"}
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update(env)
    try:
        assert jax_launch(4, [sys.executable, WORKER,
                              "rabit_dataplane=xla", *COMMON, *kill],
                          timeout=240, quiet=True) == 0
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v
    theirs = _results(jax_dir, 4)
    assert len(ours[0]["results"]) == int(N_ITER)
    for it, (a, b) in enumerate(zip(ours[0]["results"],
                                    theirs[0]["results"])):
        for what, x, y in zip(("f32 SUM", "f64 SUM", "i32 MAX", "bcast"),
                              a, b):
            assert x == y, f"round {it} {what}"


@pytest.fixture(scope="module")
def cards():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs at least two CUDA devices")
    return torch.cuda.device_count()


@pytest.fixture(scope="module")
def gloo_reference(cards, tmp_path_factory):
    """The port's stream over gloo at worlds 2 and 4, no failure."""
    out = {}
    for world in (2, 4):
        d = tmp_path_factory.mktemp(f"gloo{world}")
        out[world] = run_port(world, d)[0][0]["results"]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("world", [2, 4])
def test_nccl_worlds_on_the_cards(world, cards, gloo_reference, tmp_path):
    if cards < world:
        pytest.skip(f"needs {world} CUDA devices")
    want = gloo_reference[world]
    for name, args, env in (
            ("kill", [], {"KILL_IN_DATAPLANE": "1,2"}),
            ("fail", [], {"RABIT_DATAPLANE_FAIL_AT": "4"})):
        docs, stats = run_port(world, tmp_path / name, args, env,
                               device="cuda")
        assert {d["backend"] for d in docs} == {"nccl"}, name
        assert min(d["epoch"] for d in docs) >= 2, name
        assert docs[0]["results"] == want, f"{name}: NCCL differs from gloo"
        if name == "kill":
            assert stats["total_attempts"] == 1
