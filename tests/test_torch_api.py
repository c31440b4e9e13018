"""The port's host API against ``rabit_tpu``'s, its framework-neutral
copies against the originals, the checkpoint interchange, and its import
hygiene (no JAX, nothing of ``rabit_tpu``).

``engine="torch"`` in a world of 2 and 4 runs inside the spawned worlds of
``tests/test_torch_collectives.py``."""

import ast
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import rabit_tpu
import rabit_tpu_torch
import rabit_tpu_torch.models.histogram  # noqa: F401 (used by its path)
from rabit_tpu.engine.empty import EmptyEngine as JaxSideEmptyEngine
from rabit_tpu.ops import reducers as jax_reducers
from rabit_tpu.utils import config as jax_config
from rabit_tpu_torch import convert
from rabit_tpu_torch.ops import reducers
from rabit_tpu_torch.utils import config

PKG = Path(rabit_tpu_torch.__file__).resolve().parent
ROOT = PKG.parent


@pytest.fixture
def both_empty():
    """Both packages on their single-process empty engine."""
    for lib in (rabit_tpu, rabit_tpu_torch):
        lib.finalize()
        lib.init([], engine="empty")
    yield
    for lib in (rabit_tpu, rabit_tpu_torch):
        lib.finalize()


def _drive(lib):
    """The same user program through either package's host API."""
    out = {"rank": lib.get_rank(), "world": lib.get_world_size(),
           "dist": lib.is_distributed(), "v0": lib.version_number(),
           "fresh": lib.load_checkpoint()}
    seen = []
    data = np.arange(6, dtype=np.float32).reshape(2, 3)
    out["sum"] = lib.allreduce(data, lib.SUM,
                               prepare_fun=lambda a: seen.append(a.shape))
    out["prepared"] = seen
    out["max_u64"] = lib.allreduce(np.array([2**63 + 5], np.uint64), lib.MAX)
    out["bitor"] = lib.allreduce(np.array([5, 8], np.int32), lib.BITOR)
    with pytest.raises(TypeError):
        lib.allreduce(np.ones(3, np.float32), lib.BITOR)
    with pytest.raises(ValueError):
        lib.allreduce(np.ones(3, np.float32), 7)
    with pytest.raises(TypeError):
        lib.allreduce([1, 2], lib.SUM)
    with pytest.raises(ValueError):
        lib.broadcast(1, root=1)
    out["bcast"] = lib.broadcast({"k": [1, 2]}, 0)
    lib.checkpoint({"round": 1}, local_model=[1])
    lib.lazy_checkpoint({"round": 2})
    out["v2"] = lib.version_number()
    out["ckpt"] = lib.load_checkpoint(with_local=True)
    return out


def test_host_api_matches_rabit_tpu_under_empty_engine(both_empty):
    want, got = _drive(rabit_tpu), _drive(rabit_tpu_torch)
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_equal(got[k], want[k], err_msg=k)
    assert got["v2"] == 2 and got["prepared"] == [(2, 3)]


def test_engine_base_compositions_match_rabit_tpu(both_empty):
    """The copied ``Engine`` defaults (async handle, reduce-scatter,
    all-gather) give what ``rabit_tpu``'s give on the empty engine."""
    out = []
    for lib in (rabit_tpu, rabit_tpu_torch):
        eng = lib._engine
        handle = eng.allreduce_async(np.arange(4, dtype=np.int32), lib.SUM)
        out.append((handle.ready(), handle.wait(),
                    eng.reduce_scatter(np.arange(6.0), lib.SUM),
                    eng.allgather(np.array([7, 8], np.int64))))
    np.testing.assert_equal(out[1], out[0])
    assert out[1][0] is True


def test_checkpoint_bytes_from_rabit_tpu_load_unchanged(both_empty):
    model = {"trees": [np.arange(5, dtype=np.float32)], "round": 3}
    src = JaxSideEmptyEngine()
    src.checkpoint(pickle.dumps(model), pickle.dumps({"local": 1}))
    src.checkpoint(pickle.dumps(model))
    convert.adopt_checkpoint(*src.load_checkpoint())
    version, got = rabit_tpu_torch.load_checkpoint()
    assert version == 2
    np.testing.assert_equal(got, model)
    rabit_tpu_torch.checkpoint(got)
    assert rabit_tpu_torch.version_number() == 3


def test_uninitialized_and_unknown_engines_raise():
    """``mpi`` is not ported: asked for by name, or by ``rabit_engine``
    under ``auto`` with a tracker URI, init raises before it dials any
    tracker (none listens at the URI below)."""
    rabit_tpu_torch.finalize()
    with pytest.raises(RuntimeError, match="not initialized"):
        rabit_tpu_torch.get_rank()
    with pytest.raises(ValueError, match="engine"):
        rabit_tpu_torch.init([], engine="mpi")
    with pytest.raises(ValueError, match="engine"):
        rabit_tpu_torch.init(["rabit_tracker_uri=127.0.0.1",
                              "rabit_tracker_port=9", "rabit_engine=mpi"],
                             engine="auto")
    assert rabit_tpu_torch._engine is None


def test_torch_engine_without_cuda_raises_rather_than_use_the_cpu(
        monkeypatch):
    rabit_tpu_torch.finalize()
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("RABIT_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="CUDA"):
        rabit_tpu_torch.init([], engine="torch")
    with pytest.raises(RuntimeError, match="CUDA"):
        convert.inputs_from_numpy(*(np.zeros((1, 4), dt) for dt in
                                    (np.float32, np.float32, np.int32)),
                                  rank=0)
    assert rabit_tpu_torch._engine is None
    assert not torch.distributed.is_initialized()


def test_torch_engine_world_of_one_on_cpu():
    rabit_tpu_torch.finalize()
    rabit_tpu_torch.init(["rabit_device=cpu"], engine="torch")
    try:
        assert (rabit_tpu_torch.get_rank(),
                rabit_tpu_torch.get_world_size()) == (0, 1)
        seen = []
        out = rabit_tpu_torch.allreduce(np.arange(3, dtype=np.int64),
                                        rabit_tpu_torch.SUM,
                                        prepare_fun=lambda a: seen.append(1))
        np.testing.assert_array_equal(out, [0, 1, 2])
        assert seen == [1]
        assert rabit_tpu_torch.broadcast("x", 0) == "x"
    finally:
        rabit_tpu_torch.finalize()
    assert not torch.distributed.is_initialized()


def test_inputs_from_numpy_hands_rank_its_row():
    grad, hess, bins = rabit_tpu_torch.models.histogram.make_inputs(
        10, 4, p=3, seed=2)
    g, h, b = convert.inputs_from_numpy(grad, hess, bins, rank=2,
                                        device="cpu")
    np.testing.assert_array_equal(g.numpy(), grad[2])
    np.testing.assert_array_equal(b.numpy(), bins[2])
    assert (g.dtype, h.dtype, b.dtype) == (torch.float32, torch.float32,
                                           torch.int32)
    with pytest.raises(TypeError):
        convert.inputs_from_numpy(grad, hess, bins.astype(np.int64), rank=0,
                                  device="cpu")
    with pytest.raises(ValueError):
        convert.inputs_from_numpy(grad, hess, bins, rank=3, device="cpu")


def test_tensor_numpy_round_trip_keeps_bits():
    import ml_dtypes
    for a in (np.array([1.5, -2.25], ml_dtypes.bfloat16),
              np.array([2**32 - 1, 7], np.uint32),
              np.array([-3, 4], np.int8)):
        t = convert.tensor_from_numpy(a)
        back = convert.numpy_from_tensor(t, a.dtype)
        assert back.dtype == a.dtype and back.tobytes() == a.tobytes()


def test_reducers_copy_matches_rabit_tpu():
    assert reducers.OP_NAMES == jax_reducers.OP_NAMES
    assert reducers.DTYPE_ENUM == jax_reducers.DTYPE_ENUM
    rng = np.random.default_rng(0)
    for dt in reducers.DTYPE_ENUM:
        for op in reducers.OP_NAMES:
            assert reducers.is_valid_op_dtype(op, dt) == \
                jax_reducers.is_valid_op_dtype(op, dt)
    for op in reducers.OP_NAMES:
        a = rng.integers(-50, 50, 8).astype(np.int64)
        b = rng.integers(-50, 50, 8).astype(np.int64)
        want = a.copy()
        jax_reducers.numpy_reduce(want, b, op)
        got = a.copy()
        reducers.numpy_reduce(got, b, op)
        np.testing.assert_array_equal(got, want)
        t = reducers.torch_reduce_fn(op)(torch.from_numpy(a),
                                         torch.from_numpy(b))
        np.testing.assert_array_equal(t.numpy(), want)


@pytest.mark.parametrize("value", ["256MB", "1G", "1024", "2k", "1.5M"])
def test_config_copy_matches_rabit_tpu(value):
    assert config.parse_size(value) == jax_config.parse_size(value)
    args = [f"rabit_reduce_buffer={value}", "DMLC_TASK_ID=3",
            "rabit_mock=0,1,1,0", "rabit_mock=1,1,1,0"]
    ours, theirs = (m.Config.from_args(args) for m in (config, jax_config))
    assert ours.get_size("rabit_reduce_buffer") == \
        theirs.get_size("rabit_reduce_buffer")
    assert ours.get("rabit_task_id") == theirs.get("rabit_task_id") == "3"
    assert ours.get_all("rabit_mock") == theirs.get_all("rabit_mock")


def test_import_leaves_out_jax_and_rabit_tpu():
    """A fresh interpreter imports the package and every submodule without
    loading JAX or any module of ``rabit_tpu``."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import rabit_tpu_torch as R\n"
        "names = [m.name for m in pkgutil.walk_packages(R.__path__, "
        "'rabit_tpu_torch.')]\n"
        "for n in names: importlib.import_module(n)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'rabit_tpu')]\n"
        "need = {'rabit_tpu_torch.ops.flash', 'rabit_tpu_torch.entry', "
        "'rabit_tpu_torch.models.transformer', "
        "'rabit_tpu_torch.parallel.ring_attention', "
        "'rabit_tpu_torch.bench', 'rabit_tpu_torch.utils.slope', "
        "'rabit_tpu_torch.tools.histogram_sweep', "
        "'rabit_tpu_torch.tools.kernel_hw_proof', "
        "'rabit_tpu_torch.tools.collective_sweep', "
        "'rabit_tpu_torch.parallel.topology', "
        "'rabit_tpu_torch.parallel.wire', "
        "'rabit_tpu_torch.parallel.dispatch', "
        "'rabit_tpu_torch.parallel.collectives', "
        "'rabit_tpu_torch.utils.log', 'rabit_tpu_torch.utils.retry', "
        "'rabit_tpu_torch.engine.ckpt_store', "
        "'rabit_tpu_torch.engine._native_build', "
        "'rabit_tpu_torch.engine.native', "
        "'rabit_tpu_torch.engine.dataplane', "
        "'rabit_tpu_torch.tracker.tracker', "
        "'rabit_tpu_torch.tracker.launch', "
        "'rabit_tpu_torch.tools.boosted_trees', "
        "'rabit_tpu_torch.models.mlp', "
        "'rabit_tpu_torch.telemetry', 'rabit_tpu_torch.telemetry.schema', "
        "'rabit_tpu_torch.telemetry.clock', "
        "'rabit_tpu_torch.telemetry.events', "
        "'rabit_tpu_torch.telemetry.recorder', "
        "'rabit_tpu_torch.telemetry.profile', "
        "'rabit_tpu_torch.telemetry.export', "
        "'rabit_tpu_torch.telemetry.aggregate', "
        "'rabit_tpu_torch.tools.histogram_rounds', "
        "'rabit_tpu_torch.telemetry.prom', 'rabit_tpu_torch.telemetry.slo', "
        "'rabit_tpu_torch.telemetry.live', "
        "'rabit_tpu_torch.telemetry.crossrank', "
        "'rabit_tpu_torch.telemetry.skew', "
        "'rabit_tpu_torch.tools.skew_bench', "
        "'rabit_tpu_torch.tools.skew_round_worker', "
        "'rabit_tpu_torch.utils.watchdog', "
        "'rabit_tpu_torch.telemetry.flight', "
        "'rabit_tpu_torch.telemetry.history', "
        "'rabit_tpu_torch.telemetry.__main__', "
        "'rabit_tpu_torch.tools.overlap_bench', "
        "'rabit_tpu_torch.tools.overlap_round_worker', "
        "'rabit_tpu_torch.tracker.membership', "
        "'rabit_tpu_torch.tracker.wal', "
        "'rabit_tpu_torch.tools.store_loss', "
        "'rabit_tpu_torch.tracker.standby', 'rabit_tpu_torch.chaos', "
        "'rabit_tpu_torch.chaos.schedule', 'rabit_tpu_torch.chaos.proxy'}\n"
        "print(len(names), bad, need - set(names))\n"
        "sys.exit(1 if bad or need - set(names) else 0)\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


def _jax_imports(paths):
    found = []
    for path in paths:
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                      for n in names
                      if n.split(".")[0] in ("jax", "jaxlib", "rabit_tpu")]
    return found


def test_no_jax_or_rabit_tpu_import_in_the_package_source():
    assert _jax_imports(sorted(PKG.rglob("*.py"))) == []


def test_no_jax_or_rabit_tpu_import_in_the_chip_smoke_script():
    assert _jax_imports([ROOT / "chip_smoke.py"]) == []


def test_no_jax_or_rabit_tpu_import_in_the_kernel_variants_script():
    assert _jax_imports([ROOT / "kernel_variants.py"]) == []


def test_no_jax_or_rabit_tpu_import_in_the_new_modules_and_workers():
    """The modules of the robust engine's slice, of the bucketed steps'
    (the MLP, the step timing script) and of the telemetry plane
    (``telemetry/*``, the histogram rounds' worker), of the watchdog's
    (``utils/watchdog.py``, ``telemetry/flight.py``, ``history.py``,
    ``__main__.py``, the overlap bench and its worker) and of the
    tracker's journal (``tracker/wal.py``, ``tools/store_loss.py``) and
    of the hot standby and the chaos plane (``tracker/standby.py``,
    ``chaos/*``), by name (the package scan above covers the package
    too), and the port's own test workers."""
    new = [PKG / "utils" / "log.py", PKG / "utils" / "retry.py",
           PKG / "engine" / "ckpt_store.py", PKG / "engine" / "_native_build.py",
           PKG / "engine" / "native.py", PKG / "engine" / "dataplane.py",
           PKG / "tracker" / "tracker.py", PKG / "tracker" / "launch.py",
           PKG / "tools" / "boosted_trees.py",
           ROOT / "tests" / "workers" / "torch_recover_worker.py",
           ROOT / "tests" / "workers" / "torch_dataplane_fail_worker.py",
           PKG / "models" / "mlp.py", ROOT / "train_step_timing.py"]
    new += [PKG / "telemetry" / f"{m}.py"
            for m in ("__init__", "schema", "clock", "events", "recorder",
                      "profile", "export", "aggregate")]
    new += [PKG / "tools" / "histogram_rounds.py"]
    new += [PKG / "utils" / "watchdog.py", PKG / "telemetry" / "flight.py",
            PKG / "telemetry" / "history.py", PKG / "telemetry" / "__main__.py",
            PKG / "tools" / "overlap_bench.py",
            PKG / "tools" / "overlap_round_worker.py",
            ROOT / "tests" / "workers" / "torch_stall_worker.py"]
    new += [PKG / "tracker" / "wal.py", PKG / "tools" / "store_loss.py",
            ROOT / "tests" / "workers" / "torch_resume_worker.py"]
    new += [PKG / "tracker" / "standby.py"]
    new += [PKG / "chaos" / f"{m}.py" for m in ("__init__", "schedule",
                                                "proxy")]
    assert all(p.is_file() for p in new)
    assert _jax_imports(new) == []
