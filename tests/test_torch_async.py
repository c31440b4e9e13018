"""The port's async collectives (``rabit_tpu_torch/parallel/collectives.py``)
and ``TorchEngine``'s ``allreduce_async``, ``reduce_scatter`` and
``allgather``, as ``tests/test_async_collectives.py`` tests the JAX
package's (without its telemetry):

* the handle's lifecycle, in a gloo world of one: ``wait()`` is
  idempotent, ``ready()`` settles, a dropped handle warns and leaves the
  window, the guard is armed at issue and disarmed by ``wait()`` or the
  drop, admitting past ``RABIT_ASYNC_MAX_INFLIGHT`` waits on the oldest
  handle, the knobs parse as the JAX package parses them;
* in one spawned gloo world of 4: each async entry point equal to its
  sync twin bit for bit (allreduce, hier, the bucket tree, a gradient
  bucket), and the engine's collectives equal to numpy's sums and to the
  base engine's compositions (integer-valued payloads, so every order of
  summation gives the same bits).

On the CPU a collective blocks the calling thread, so an async handle is
complete at issue; on the card it is not (``chip_smoke.py`` phase 12
shows an issue that returns before the device has run it).
"""

import contextlib
import gc
import os
import warnings

import numpy as np
import pytest
import torch
import torch.distributed as dist

from rabit_tpu_torch.ops.reducers import MAX, SUM
from rabit_tpu_torch.parallel import collectives as C
from torch_world import spawn_world

P = 4
H22 = ((0, 1), (2, 3))
ASYNC_ENV_VARS = ("RABIT_ASYNC_COLLECTIVES", "RABIT_ASYNC_MAX_INFLIGHT")


@pytest.fixture(autouse=True)
def _clean_async_env():
    saved = {v: os.environ.pop(v, None) for v in ASYNC_ENV_VARS}
    yield
    for v, val in saved.items():
        if val is None:
            os.environ.pop(v, None)
        else:
            os.environ[v] = val


@pytest.fixture
def world_of_one():
    from rabit_tpu_torch.parallel.mesh import make_group
    group, _ = make_group("cpu")
    try:
        yield group
    finally:
        dist.destroy_process_group()


def _payload(n=512, seed=0):
    return torch.from_numpy(
        np.random.default_rng(seed).standard_normal(n).astype(np.float32))


class Guard:
    """A context manager that records its entries and exits."""

    def __init__(self, log, name):
        self.log, self.name = log, name

    def __enter__(self):
        self.log.append(f"enter {self.name}")

    def __exit__(self, *exc):
        self.log.append(f"exit {self.name}")


# ------------------------------------------------- the handle's lifecycle


def test_double_wait_is_idempotent(world_of_one):
    h = C.device_allreduce_async(_payload(), None, SUM, method="ring")
    first = h.wait()
    assert h.wait() is first
    assert C.inflight_count() == 0


def test_ready_probe_is_boolean_and_settles(world_of_one):
    h = C.device_allreduce_async(_payload(), None, SUM, method="ring")
    assert isinstance(h.ready(), bool)
    h.wait()
    assert h.ready() is True


def test_drop_without_wait_warns_and_disarms_the_guard(world_of_one):
    log = []
    h = C.device_allreduce_async(_payload(), None, SUM, method="ring",
                                 guard=Guard(log, "g"))
    assert log == ["enter g"] and C.inflight_count() == 1
    with pytest.warns(RuntimeWarning, match="dropped"):
        del h
        gc.collect()
    assert log == ["enter g", "exit g"]
    assert C.inflight_count() == 0


def test_no_drop_warning_after_wait(world_of_one):
    h = C.device_allreduce_async(_payload(), None, SUM, method="ring")
    h.wait()
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        del h
        gc.collect()


def test_guard_is_armed_at_issue_and_disarmed_by_wait(world_of_one):
    log = []
    h = C.device_hier_allreduce_async(_payload(), None, SUM,
                                      guard=Guard(log, "hier"))
    assert log == ["enter hier"]
    h.wait()
    h.wait()
    assert log == ["enter hier", "exit hier"]


def test_max_inflight_admission_window(world_of_one):
    os.environ["RABIT_ASYNC_MAX_INFLIGHT"] = "2"
    assert C.async_max_inflight() == 2
    log = []
    handles = [C.device_allreduce_async(_payload(seed=i), None, SUM,
                                        method="ring", guard=Guard(log, i))
               for i in range(4)]
    # the window never exceeds the cap: admitting #2 waited on #0, #3 on #1
    assert C.inflight_count() == 2
    assert log == ["enter 0", "enter 1", "enter 2", "exit 0", "enter 3",
                   "exit 1"]
    for h in handles:
        h.wait()
    assert C.inflight_count() == 0


def test_tree_handle_waits_oldest_first_and_assembles_once(world_of_one):
    tree = {"b": torch.arange(6, dtype=torch.int32),
            "a": _payload(8), "c": _payload(3, seed=1)}
    ht = C.bucket_allreduce_async(tree, None, SUM)
    # reverse bucket order: the i32 bucket (second seen, by sorted keys)
    # is issued first
    assert [h.value.dtype for h in ht.handles] == [torch.int32,
                                                   torch.float32]
    out = ht.wait()
    assert ht.wait() is out and ht.ready()
    assert sorted(out) == ["a", "b", "c"]
    for k in tree:
        assert torch.equal(out[k], tree[k])
    empty = C.bucket_allreduce_async({}, None, SUM)
    assert empty.wait() == {} and empty.ready()


def test_async_enabled_env_parsing():
    assert not C.async_enabled()
    for val in ("1", "true", "yes", "on"):
        os.environ["RABIT_ASYNC_COLLECTIVES"] = val
        assert C.async_enabled()
    os.environ["RABIT_ASYNC_COLLECTIVES"] = "0"
    assert not C.async_enabled()
    os.environ["RABIT_ASYNC_MAX_INFLIGHT"] = "bogus"
    assert C.async_max_inflight() == C.ASYNC_MAX_INFLIGHT_DEFAULT
    os.environ["RABIT_ASYNC_MAX_INFLIGHT"] = "0"
    assert C.async_max_inflight() == 1


def test_configure_async_exports_the_config_and_keeps_the_env():
    from rabit_tpu_torch.utils.config import Config
    os.environ["RABIT_ASYNC_MAX_INFLIGHT"] = "7"
    C.configure_async(Config.from_args(["rabit_async_collectives=1"]))
    assert C.async_enabled() and C.async_max_inflight() == 7
    C.configure_async(Config.from_args(["rabit_async_collectives=0",
                                        "rabit_async_max_inflight=3"]))
    assert not C.async_enabled() and C.async_max_inflight() == 3


def test_knobs_match_rabit_tpu():
    from rabit_tpu.parallel import collectives as JC
    assert C.ASYNC_MAX_INFLIGHT_DEFAULT == JC.ASYNC_MAX_INFLIGHT_DEFAULT
    assert (C._ASYNC_ENV, C._ASYNC_INFLIGHT_ENV) == \
        (JC._ASYNC_ENV, JC._ASYNC_INFLIGHT_ENV)


# ------------------------------------------------- a world of four


def _inputs() -> dict:
    rng = np.random.default_rng(77)
    return {
        "f32": rng.standard_normal((P, 4096)).astype(np.float32),
        "w": rng.standard_normal((P, 33, 5)).astype(np.float32),
        "big": rng.standard_normal((P, 40000)).astype(np.float32),
        "steps": rng.integers(0, 1000, (P, 9)).astype(np.int32),
        "i32": rng.integers(-1000, 1000, (P, 4096)).astype(np.int32),
        "f32int": rng.integers(-1000, 1000, (P, 1000)).astype(np.float32),
    }


def _rank_main(rank: int, p: int) -> dict:
    import rabit_tpu_torch as rabit
    from rabit_tpu_torch.engine.base import Engine
    inputs = _inputs()
    rows = {k: torch.from_numpy(v[rank].copy()) for k, v in inputs.items()}
    got = {}

    def pair(name, sync, handle):
        got[f"{name}|async"] = handle.wait().numpy()
        got[f"{name}|sync"] = sync.numpy()

    x = rows["f32"]
    pair("allreduce_ring", C.allreduce(x, None, SUM, method="ring"),
         C.device_allreduce_async(x, None, SUM, method="ring"))
    pair("allreduce_int8", C.allreduce(x, None, SUM, method="ring",
                                       wire="int8"),
         C.device_allreduce_async(x, None, SUM, method="ring", wire="int8"))
    pair("hier", C.device_hier_allreduce(x, None, SUM, groups=H22),
         C.device_hier_allreduce_async(x, None, SUM, groups=H22))
    pair("hier_int8", C.device_hier_allreduce(x, None, SUM, groups=H22,
                                              wire="int8"),
         C.device_hier_allreduce_async(x, None, SUM, groups=H22,
                                       wire="int8"))
    pair("hier_flat", C.device_hier_allreduce(x, None, SUM,
                                              groups=((0, 1, 2, 3),)),
         C.device_hier_allreduce_async(x, None, SUM,
                                       groups=((0, 1, 2, 3),)))
    pair("grad_bucket", C.bucket_allreduce([x], None, SUM)[0],
         C.grad_bucket_allreduce_async(x, None, SUM))
    tree = {k: rows[k] for k in ("w", "big", "steps")}
    for method in ("auto", "ring"):
        sync = C.device_allreduce_tree(tree, None, SUM, method=method)
        out = C.bucket_allreduce_async(tree, None, SUM, method=method).wait()
        for k in tree:
            got[f"tree_{method}_{k}|sync"] = sync[k].numpy()
            got[f"tree_{method}_{k}|async"] = out[k].numpy()

    rabit.init(["rabit_device=cpu", "rabit_async_collectives=1",
                "rabit_async_max_inflight=3"], engine="torch")
    try:
        eng = rabit._engine
        got["configured"] = np.array([C.async_enabled(),
                                      C.async_max_inflight() == 3])
        bufs = [inputs[k][rank].copy() for k in ("i32", "f32int", "i32")]
        handles = [eng.allreduce_async(bufs[0], SUM),
                   eng.allreduce_async(bufs[1], MAX),
                   eng.allreduce_async(bufs[2], SUM)]
        # a synchronous collective first waits out the worker's queue
        got["sync_after_async"] = rabit.allreduce(rows["steps"].numpy(), SUM)
        got["drained"] = np.array([h.ready() for h in handles])
        for i, h in reversed(list(enumerate(handles))):
            assert h.wait() is bufs[i]
            got[f"engine_async_{i}"] = bufs[i]
        got["host_async"] = rabit.allreduce_async(inputs["i32"][rank],
                                                  SUM).wait()
        for k, op in (("i32", SUM), ("f32int", MAX)):
            buf = inputs[k][rank].copy()
            got[f"engine_rs_{k}"] = eng.reduce_scatter(buf, op)
            got[f"engine_rs_{k}_unchanged"] = np.array(
                buf.tobytes() == inputs[k][rank].tobytes())
            got[f"engine_rs_{k}_base"] = Engine.reduce_scatter(
                eng, inputs[k][rank].copy(), op)
            got[f"engine_ag_{k}"] = eng.allgather(inputs[k][rank])
            got[f"engine_ag_{k}_base"] = Engine.allgather(eng,
                                                          inputs[k][rank])
        got["host_rs"] = rabit.reduce_scatter(inputs["i32"][rank], SUM)
        got["host_ag"] = rabit.allgather(inputs["steps"][rank])
    finally:
        rabit.finalize()
    return got


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return spawn_world(_rank_main, P, tmp_path_factory.mktemp("async4"))


PAIRS = ["allreduce_ring", "allreduce_int8", "hier", "hier_int8",
         "hier_flat", "grad_bucket"] + [
    f"tree_{m}_{k}" for m in ("auto", "ring") for k in ("w", "big", "steps")]


@pytest.mark.parametrize("name", PAIRS)
def test_async_equals_sync_bit_for_bit(world, name):
    for r, got in enumerate(world):
        a, s = got[f"{name}|async"], got[f"{name}|sync"]
        assert a.dtype == s.dtype and a.tobytes() == s.tobytes(), (name, r)
        assert a.tobytes() == world[0][f"{name}|async"].tobytes(), (name, r)


def test_engine_init_exports_the_async_knobs(world):
    for got in world:
        assert got["configured"].all()


def test_engine_allreduce_async_runs_in_order_and_sync_drains(world):
    inputs = _inputs()
    isum = inputs["i32"].sum(0, dtype=np.int32)
    want = [isum, inputs["f32int"].max(0), isum]
    for got in world:
        assert got["drained"].all()
        np.testing.assert_array_equal(got["sync_after_async"],
                                      inputs["steps"].sum(0))
        for i, w in enumerate(want):
            assert got[f"engine_async_{i}"].tobytes() == w.tobytes()
        np.testing.assert_array_equal(got["host_async"], want[0])


@pytest.mark.parametrize("key,reduce", [("i32", np.sum), ("f32int", np.max)])
def test_engine_reduce_scatter_and_allgather_match_numpy_and_the_base(
        world, key, reduce):
    xs = _inputs()[key]
    total = reduce(xs, axis=0).astype(xs.dtype)
    m = xs.shape[1] // P
    for r, got in enumerate(world):
        chunk = got[f"engine_rs_{key}"]
        assert chunk.dtype == xs.dtype
        assert chunk.tobytes() == total[r * m:(r + 1) * m].tobytes()
        assert chunk.tobytes() == got[f"engine_rs_{key}_base"].tobytes()
        assert bool(got[f"engine_rs_{key}_unchanged"])
        gathered = got[f"engine_ag_{key}"]
        assert gathered.tobytes() == xs.reshape(-1).tobytes()
        assert gathered.tobytes() == got[f"engine_ag_{key}_base"].tobytes()


def test_host_api_reduce_scatter_and_allgather_on_the_torch_engine(world):
    xs, steps = _inputs()["i32"], _inputs()["steps"]
    m = xs.shape[1] // P
    for r, got in enumerate(world):
        np.testing.assert_array_equal(got["host_rs"],
                                      xs.sum(0)[r * m:(r + 1) * m])
        np.testing.assert_array_equal(got["host_ag"], steps.reshape(-1))


def test_engine_world_of_one_completes_async_at_issue():
    import rabit_tpu_torch as rabit
    rabit.init(["rabit_device=cpu"], engine="torch")
    try:
        buf = np.arange(6, dtype=np.float32)
        h = rabit._engine.allreduce_async(buf, SUM)
        assert h.ready() and h.wait() is buf
        np.testing.assert_array_equal(rabit._engine.reduce_scatter(buf, SUM),
                                      buf)
        np.testing.assert_array_equal(rabit._engine.allgather(buf), buf)
    finally:
        rabit.finalize()
    with contextlib.suppress(Exception):
        dist.destroy_process_group()
