"""The port's telemetry wired into its paths, against the JAX package's on
the same calls:

* the entry points' span sets: at p = 2 and 4, every host-level entry
  point of ``rabit_tpu_torch.parallel.collectives`` in a gloo world and
  its JAX twin on the virtual CPU mesh give equal counter keys, equal
  spans (names, bytes, op, method, wire, round, phase and ``cost_*``
  attributes; durations and the exposed/overlapped split aside) and
  equal cost and overlap rows: each rank's recorder against the one JAX
  recorder (one row a rank against one a call); the hier phases share a
  round;
* both engines honour ``rabit_telemetry``, ``rabit_profile`` and
  ``rabit_events``: ``TorchEngine`` at world 2 over gloo and ``XlaEngine``
  at world 2 over JAX's gloo record equal spans, counter keys and costs
  for the same host API calls;
* no effect when off, no compute change when on: a ``TorchDispatchMode``
  records the same operators for the transformer's ``"psum"`` and async
  ``"bucket"`` steps and the MLP's at world 2 with the planes off and on,
  and the results are equal bit for bit (the port's counterpart of
  ``test_telemetry_keeps_bucketed_step_jaxpr_pure``);
* the end of a run: histogram rounds under the port's launcher and
  tracker with ``TorchEngine`` write both files a rank, ship one summary
  a rank, and the tracker prints the fleet table, with the histograms of
  a run with the planes off; the robust engine through a ``rabit_mock``
  kill leaves ``recovery.*`` rows in the fleet document."""

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import rabit_tpu.parallel.collectives as JC
import rabit_tpu.telemetry as jt
import rabit_tpu.telemetry.profile as jprofile
import rabit_tpu_torch.telemetry as pt
from rabit_tpu.ops.reducers import MAX, SUM
from rabit_tpu_torch.telemetry import profile as pprofile
from rabit_tpu_torch.tools import run_world
from rabit_tpu_torch.tracker.launch import launch

ROOT = Path(__file__).resolve().parents[1]
N = 4096
H22 = ((0, 1), (2, 3))
# attributes that carry time, not structure
TIMED = ("wire_exposed_ms", "wire_overlapped_ms", "hlc")


@pytest.fixture(autouse=True)
def _planes_off():
    yield
    for tel, prof in ((jt, jprofile), (pt, pprofile)):
        tel.reset(enabled=False)
        prof.reset(enabled=False)


def _rows(p: int) -> dict:
    rng = np.random.default_rng(11 + p)
    return {"f32": rng.standard_normal((p, 2 * N)).astype(np.float32),
            "i32": rng.integers(-99, 99, (p, N)).astype(np.int32)}


def _structure(snap: dict, prof: dict) -> dict:
    """What a run recorded, its timings left out."""
    spans = [{**{k: s[k] for k in ("name", "bytes", "op", "method", "wire")},
              "provenance": s.get("provenance", ""),
              "attrs": {k: v for k, v in s.get("attrs", {}).items()
                        if k not in TIMED}} for s in snap["spans"]]
    counters = [{k: c[k] for k in ("name", "op", "method", "wire", "bucket",
                                   "count", "bytes")}
                | {"provenance": c.get("provenance", "")}
                for c in snap["counters"]]
    overlap = [{k: o[k] for k in ("name", "method", "count")}
               for o in prof["overlap"]]
    return {"spans": spans, "counters": counters, "cost": prof["cost"],
            "overlap": overlap}


def _port_entry_rank(rank: int, p: int, device, rows: dict) -> dict:
    from rabit_tpu_torch.parallel import collectives as C
    pt.reset(capacity=1024, enabled=True)
    pprofile.reset(enabled=True)
    x = torch.from_numpy(rows["f32"][rank])
    xi = torch.from_numpy(rows["i32"][rank])
    tree = {"a": x[:64], "b": x[64:192].reshape(32, 4), "c": xi[:16]}
    hier = H22 if p == 4 else None
    C.allreduce(x[:N], None, SUM)
    C.allreduce(x[:N], None, SUM, method="ring")
    C.allreduce(x, None, SUM, method="ring", wire="bf16")
    C.allreduce(xi, None, MAX, method="tree")
    C.device_reduce_scatter(x[:N], None, SUM)
    C.device_reduce_scatter(x[:N], None, SUM, wire="int8")
    C.device_allgather(x[:1024], None)
    C.device_allreduce_tree(tree, None, SUM)
    C.device_broadcast(x[:100], None, root=1)
    C.device_hier_allreduce(x[:N], None, SUM, groups=hier)
    C.device_allreduce_async(x[:N], None, SUM).wait()
    C.bucket_allreduce_async(tree, None, SUM).wait()
    C.grad_bucket_allreduce_async(x[:N], None, SUM, method="ring").wait()
    C.device_hier_allreduce_async(x[:N], None, SUM, groups=hier).wait()
    return _structure(pt.snapshot(), pprofile.snapshot())


def _jax_entry(p: int, rows: dict) -> dict:
    from jax.sharding import Mesh
    mesh = Mesh(np.array(jax.devices()[:p]), ("proc",))
    mesh2 = Mesh(np.array(jax.devices()[:p]).reshape(p, 1), ("dp", "tp"))
    jt.reset(capacity=1024, enabled=True)
    jprofile.reset(enabled=True)
    xs = JC.shard_over(mesh, rows["f32"])
    xi = JC.shard_over(mesh, rows["i32"])
    x4 = JC.shard_over(mesh, rows["f32"][:, :N])
    tree = {"a": JC.shard_over(mesh, rows["f32"][:, :64]),
            "b": JC.shard_over(mesh, rows["f32"][:, 64:192].reshape(p, 32, 4)),
            "c": JC.shard_over(mesh, rows["i32"][:, :16])}
    hier = H22 if p == 4 else None
    JC.device_allreduce(x4, mesh, SUM)
    JC.device_allreduce(x4, mesh, SUM, method="ring")
    JC.device_allreduce(xs, mesh, SUM, method="ring", wire="bf16")
    JC.device_allreduce(xi, mesh, MAX, method="tree")
    JC.device_reduce_scatter(x4, mesh, SUM)
    JC.device_reduce_scatter(x4, mesh, SUM, wire="int8")
    JC.device_allgather(JC.shard_over(mesh, rows["f32"][:, :1024]), mesh)
    JC.device_allreduce_tree(tree, mesh, SUM)
    JC.device_broadcast(JC.shard_over(mesh, rows["f32"][:, :100]), mesh,
                        root=1)
    JC.device_hier_allreduce(x4, mesh, SUM, groups=hier)
    JC.device_allreduce_async(x4, mesh, SUM).wait()
    JC.bucket_allreduce_async(tree, mesh, SUM).wait()
    bucket = jax.device_put(rows["f32"][:, None, :N], jax.sharding.NamedSharding(
        mesh2, jax.sharding.PartitionSpec("dp", "tp", None)))
    JC.grad_bucket_allreduce_async(bucket, mesh2, "dp", "tp", SUM,
                                   method="ring").wait()
    JC.device_hier_allreduce_async(x4, mesh, SUM, groups=hier).wait()
    return _structure(jt.snapshot(), jprofile.snapshot())


@pytest.mark.parametrize("p", [2, 4])
def test_entry_points_record_the_spans_of_rabit_tpu(p, tmp_path,
                                                    monkeypatch):
    # both dispatchers on their fallback constants ("auto" resolves alike)
    monkeypatch.setenv("RABIT_DISPATCH_TABLE", "none")
    rows = _rows(p)
    want = _jax_entry(p, rows)
    ranks = run_world(_port_entry_rank, p, "cpu", args=(rows,),
                      tmp=str(tmp_path))
    names = [s["name"] for s in want["spans"]]
    assert "bucket_allreduce.issue" in names and "broadcast" in names
    if p == 4:
        phases = [s for s in want["spans"] if s["name"] == "hier.inter"]
        assert phases and "cost_flops" in phases[0]["attrs"]
    for r, got in enumerate(ranks):
        for k in want:
            assert got[k] == want[k], (r, k)
        if p == 4:
            rounds = {s["attrs"]["round"] for s in got["spans"]
                      if s["name"].startswith("hier.")
                      and "issue" not in s["name"]}
            assert rounds == {1}


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# one worker of a world of 2 through the host API of either package:
# argv package rank port out-file
_ENGINE_WORKER = r'''
import json, sys
import numpy as np
pkg, rank, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
if pkg == "jax":
    import jax
    jax.config.update("jax_platforms", "cpu")
    import rabit_tpu as R
    from rabit_tpu import telemetry as T
    from rabit_tpu.telemetry import events as E, profile as P
    engine, extra = "xla", []
else:
    import rabit_tpu_torch as R
    from rabit_tpu_torch import telemetry as T
    from rabit_tpu_torch.telemetry import events as E, profile as P
    engine, extra = "torch", ["rabit_device=cpu"]
R.init([f"rabit_coordinator=127.0.0.1:{port}", "rabit_num_processes=2",
        f"rabit_process_id={rank}", "rabit_telemetry=1", "rabit_profile=1",
        "rabit_events=1"] + extra, engine=engine)
on = [T.enabled(), P.enabled(), E.enabled()]
x = np.arange(4096, dtype=np.float32) * (rank + 1)
R.allreduce(x, R.SUM)
R.allreduce(np.arange(8, dtype=np.int32) + rank, R.MAX)
R.reduce_scatter(x.copy(), R.SUM)
R.allgather(x[:256].copy())
R.broadcast({"model": list(range(50))} if rank == 0 else None, 0)
R.allreduce_async(x.copy(), R.SUM).wait()
doc = {"on": on, "snap": T.snapshot(), "prof": P.snapshot(),
       "events": [r["kind"] for r in E.snapshot()["records"]]}
R.finalize()
with open(out, "w") as f:
    json.dump(doc, f)
'''


def _engine_world(pkg: str, tmp: Path) -> list:
    port = str(_free_port())
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    env.update(JAX_PLATFORMS="cpu", RABIT_DISPATCH_TABLE="none",
               PYTHONPATH=str(ROOT))
    outs = [tmp / f"{pkg}{r}.json" for r in range(2)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _ENGINE_WORKER, pkg, str(r), port,
         str(outs[r])], env=env, cwd=ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(2)]
    logs = [p.communicate(timeout=240)[0] for p in procs]
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log
    return [json.loads(o.read_text()) for o in outs]


def _sorted_structure(doc: dict) -> dict:
    got = _structure(doc["snap"], doc["prof"])
    # the async worker's inner span may close before or after its issue
    # span: compare the spans as a set
    got["spans"] = sorted(got["spans"], key=json.dumps)
    return got


def test_both_engines_honour_the_knobs_and_record_alike(tmp_path):
    want = _engine_world("jax", tmp_path)
    got = _engine_world("port", tmp_path)
    for r in range(2):
        assert got[r]["on"] == want[r]["on"] == [True, True, True]
        g, w = _sorted_structure(got[r]), _sorted_structure(want[r])
        for k in w:
            assert g[k] == w[k], (r, k)
        names = {s["name"] for s in g["spans"]}
        assert {"engine.allreduce", "engine.reduce_scatter",
                "engine.allgather", "engine.broadcast",
                "engine.allreduce.issue", "reduce_scatter", "allgather",
                "broadcast", "allreduce"} <= names
        rounds = [s["attrs"].get("hlc") for s in got[r]["snap"]["spans"]
                  if "round" in s.get("attrs", {})]
        assert rounds and all(rounds)     # rabit_events stamps the rounds


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.append(str(func))
        return func(*args, **(kwargs or {}))


def _steps_rank(rank: int, p: int, device) -> dict:
    """Each step once with the planes off and once on, from the same
    weights, under a dispatch mode: the operators and the bits."""
    from rabit_tpu_torch.models import mlp, transformer as tf
    from rabit_tpu_torch.parallel.mesh import make_mesh
    mesh = make_mesh((2, 1, 1), "cpu")
    sizes = dict(n_layers=2, d_model=32, n_heads=4, d_head=8, d_ff=64)
    toks = np.random.default_rng(3).integers(0, 64, size=(4, 33))
    x = np.random.default_rng(5).standard_normal((16, 12)).astype(np.float32)
    y = np.random.default_rng(5).integers(0, 4, size=(16,))
    rows = slice(rank * 8, rank * 8 + 8)

    def run(kind, sync):
        if kind == "transformer":
            model = tf.model_on(tf.init_params(0, vocab=64, max_t=64,
                                               **sizes), "cpu")
            step = tf.make_train_step(mesh, lr=0.2, grad_sync=sync)
            args = (tf.shard_tokens(toks[:, :-1], mesh, "cpu"),
                    tf.shard_tokens(toks[:, 1:], mesh, "cpu"))
        else:
            model = mlp.model_on(mlp.init_params(7, 12, 8, 4), "cpu")
            step = mlp.make_train_step(mesh, lr=0.5, grad_sync=sync)
            args = (torch.from_numpy(x[rows].copy()),
                    torch.from_numpy(y[rows].copy()))
        with _Ops() as mode:
            loss = step(model, *args)
        state = {k: v.numpy().tobytes().hex()
                 for k, v in model.state_dict().items()}
        return mode.ops, float(loss), state

    out = {}
    for kind, sync in (("transformer", "psum"), ("transformer", "async"),
                       ("mlp", "psum"), ("mlp", "async")):
        if sync == "async":
            os.environ["RABIT_ASYNC_COLLECTIVES"] = "1"
        got = {}
        for on in (False, True):
            pt.reset(enabled=on)
            pprofile.reset(enabled=on)
            got[on] = run(kind, "bucket" if sync == "async" else sync)
        os.environ.pop("RABIT_ASYNC_COLLECTIVES", None)
        out[f"{kind}-{sync}"] = {
            "ops_equal": got[False][0] == got[True][0],
            "n_ops": len(got[False][0]),
            "collectives": sum("c10d" in o for o in got[True][0]),
            "bits_equal": got[False][1:] == got[True][1:],
            "recorded": pt.stats()["recorded"]}
    return out


def test_steps_run_the_same_operators_and_bits_with_the_planes_on(tmp_path):
    ranks = run_world(_steps_rank, 2, "cpu", tmp=str(tmp_path))
    for r, got in enumerate(ranks):
        for case, g in got.items():
            assert g["ops_equal"] and g["bits_equal"], (r, case)
            assert g["n_ops"] > 50 and g["collectives"] > 0, (r, case)
        # the async bucket steps' handles record their spans when on
        assert got["mlp-async"]["recorded"] > 0


def _rounds(tmp: Path, tel: str, stats: dict) -> list:
    res, exp = tmp / f"res{tel}", tmp / f"exp{tel}"
    rc = launch(2, [sys.executable, "-m",
                    "rabit_tpu_torch.tools.histogram_rounds", "--rows",
                    "4096", "--features", "4", "--buckets", "16",
                    "--rounds", "3", "rabit_engine=torch",
                    "rabit_device=cpu",
                    f"rabit_coordinator=127.0.0.1:{_free_port()}",
                    "rabit_num_processes=2", f"rabit_telemetry={tel}",
                    f"rabit_profile={tel}"],
                env={"RABIT_RESULT_DIR": str(res),
                     "RABIT_TELEMETRY_EXPORT": str(exp)},
                stats=stats, timeout=180, quiet=True)
    assert rc == 0
    return [json.loads((res / f"rank{r}.json").read_text())
            for r in range(2)]


def test_histogram_rounds_under_the_tracker_end_in_the_fleet_table(
        tmp_path):
    off, on = {}, {}
    want = _rounds(tmp_path, "0", off)
    got = _rounds(tmp_path, "1", on)
    assert [g["hist_sha256"] for g in got] == [w["hist_sha256"]
                                               for w in want]
    assert off["fleet"] is None and not (tmp_path / "exp0").exists()
    for r in range(2):
        for kind in ("summary", "trace"):
            doc = json.loads((tmp_path / "exp1" /
                              f"telemetry_{kind}_rank{r}.json").read_text())
            assert jt.matches(doc, f"telemetry_{kind}")
    fleet = on["fleet"]
    assert fleet["num_ranks"] == 2 and sorted(fleet["ranks"]) == [0, 1]
    rows = {c["name"]: c for c in fleet["counters"]}
    assert rows["engine.allreduce"]["count"] == 3 * 2
    tables = [m for m in on["messages"] if m.startswith("telemetry:")]
    assert len(tables) == 1 and "engine.allreduce" in tables[0]


def test_robust_engine_kill_leaves_recovery_rows_in_the_fleet_doc(tmp_path):
    stats = {}
    rc = launch(2, [sys.executable, "-m",
                    "rabit_tpu_torch.tools.boosted_trees",
                    "rabit_engine=robust_torch", "rabit_device=cpu",
                    "rabit_dataplane_minbytes=0", "mock=1,3,0,0",
                    "rabit_telemetry=1", "rabit_events=1"],
                env={"N_ROUNDS": "5", "RABIT_RESULT_DIR": str(tmp_path),
                     "RABIT_TELEMETRY_EXPORT": str(tmp_path / "exp")},
                stats=stats, timeout=180, quiet=True)
    assert rc == 0 and stats["total_attempts"] == 1   # the one kill
    fleet = stats["fleet"]
    assert fleet["num_ranks"] == 2
    names = {c["name"] for c in fleet["counters"]}
    assert {"engine.allreduce", "dataplane.allreduce",
            "recovery.world_reform"} <= names
    recovery = [c for c in fleet["counters"]
                if c["name"].startswith("recovery.")]
    assert {c["provenance"] for c in recovery} == {"recovery"}
    assert names & {"recovery.link_reset", "recovery.epoch_advance",
                    "recovery.retry", "recovery.link_resurrect"}
    assert any(m.startswith("telemetry:") for m in stats["messages"])
