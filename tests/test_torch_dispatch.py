"""The port's dispatch table, host topology and engine policy against the
JAX package's:

* ``rabit_tpu_torch/parallel/topology.py`` (a copy: the port imports
  nothing of ``rabit_tpu``) against ``rabit_tpu.parallel.topology`` on the
  same specs and environment, and ``fetch_topo`` against the JAX
  package's tracker;
* ``load_table`` / ``resolve`` against ``rabit_tpu.parallel.dispatch`` on
  the same table files: well-formed (schemas v1-v3), malformed and
  foreign-schema files, the hier row with its ``flat`` column, the BITOR
  override and the wire gate's precedence; and the port's refusal to read
  ``benchmarks/artifacts/`` (tables the JAX package measured on a TPU and
  a virtual CPU mesh);
* ``TorchEngine``'s method and wire against ``XlaEngine``'s on the same
  configuration;
* ``tools.collective_sweep --smoke --world 2`` over gloo, whose artifact
  the port's loader accepts.
"""

import json
import shutil
from pathlib import Path

import numpy as np
import pytest
import torch

from rabit_tpu.parallel import dispatch as jd
from rabit_tpu.parallel import topology as jt
from rabit_tpu_torch.ops.reducers import BITOR, MAX, SUM
from rabit_tpu_torch.parallel import dispatch as td
from rabit_tpu_torch.parallel import topology as tt

ROOT = Path(__file__).resolve().parents[1]
ENV = ("RABIT_DISPATCH_TABLE", "RABIT_DATAPLANE_WIRE",
       "RABIT_DATAPLANE_WIRE_MINCOUNT", "RABIT_WIRE_ADAPTIVE",
       "RABIT_SKEW_ADAPT", "RABIT_WIRE_BLOCK", "RABIT_WIRE_RS",
       "RABIT_WIRE_AG", "RABIT_HIER", "RABIT_HIER_GROUP")


@pytest.fixture
def clean(monkeypatch, tmp_path):
    """No dispatch or topology knob set, no table of the port's own, and
    both packages' table caches empty."""
    for k in ENV:
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(td, "ARTIFACTS", tmp_path / "no_artifacts")
    td.clear_cache()
    jd.clear_cache()
    yield monkeypatch
    td.clear_cache()
    jd.clear_cache()


# ---------------------------------------------------------------- topology

GROUP_SPECS = [None, "", "auto", "off", "0", "1", "2", "4", 2, "0,1|2,3",
               "0,2|1,3", "0,1,2|3", "3|2|1|0", " 0, 1 | 2 ,3 "]
BAD_SPECS = ["3", "0,1|1,2", "0,1|2,9", "a,b"]


@pytest.mark.parametrize("spec", GROUP_SPECS)
def test_topology_copy_matches_rabit_tpu(clean, spec):
    want = jt.parse_groups(spec, 4)
    assert tt.parse_groups(spec, 4) == want
    assert tt.resolve_groups(4, spec=spec) == jt.resolve_groups(4,
                                                                spec=spec)
    assert tt.is_hierarchical(want, 4) == jt.is_hierarchical(want, 4)
    if want:
        assert tt.delegates(want) == jt.delegates(want)
        assert tt.groups_spec(want) == jt.groups_spec(want)
        if jt.is_hierarchical(want, 4):
            assert tt.slot_rings(want) == jt.slot_rings(want)
    if spec is not None:
        clean.setenv("RABIT_HIER_GROUP", str(spec))
        assert tt.resolve_groups(4) == jt.resolve_groups(4)
        clean.setenv("RABIT_HIER", "0")
        assert tt.hier_enabled() is jt.hier_enabled() is False
        assert tt.resolve_groups(4) is jt.resolve_groups(4) is None


@pytest.mark.parametrize("spec", BAD_SPECS)
def test_topology_refuses_what_rabit_tpu_refuses(spec):
    for mod in (tt, jt):
        with pytest.raises(ValueError):
            mod.parse_groups(spec, 4)


def test_topology_explicit_groups_fingerprints_and_epoch_reset(clean):
    explicit = [[2, 3], [0, 1]]
    assert tt.resolve_groups(4, explicit=explicit) == \
        jt.resolve_groups(4, explicit=explicit)
    for mod in (tt, jt):
        with pytest.raises(ValueError):
            mod.resolve_groups(4, explicit=[[0, 1], [1, 2]])
    fps = ["a", "b", "a", "c", "b"]
    assert tt.group_by_fingerprint(fps) == jt.group_by_fingerprint(fps)
    import os
    for spec, world in (("0,1|2,3", 4), ("0,1|2,3", 2), ("2", 3)):
        for mod in (tt, jt):
            clean.setenv("RABIT_HIER_GROUP", spec)
            mod.epoch_reset(world)
            kept = os.environ.get("RABIT_HIER_GROUP")
            assert kept == (spec if spec == "0,1|2,3" and world == 4
                            else None), (mod.__name__, spec, world)


def test_fetch_topo_reads_the_tracker():
    """The copy speaks the JAX package's tracker wire: nothing before
    assignment, the grouping after (both fake workers announce from
    127.0.0.1, so one group)."""
    from rabit_tpu.tracker.tracker import Tracker
    from test_tracker import FakeWorker
    tr = Tracker(2, ready_timeout=5.0).start()
    try:
        assert tt.fetch_topo(tr.host, tr.port, timeout=5.0) is None
        a, b = FakeWorker(tr, "a"), FakeWorker(tr, "b")
        a.read_assignment()
        b.read_assignment()
        a.ack()
        b.ack()
        assert tt.fetch_topo(tr.host, tr.port, timeout=5.0) == \
            jt.fetch_topo(tr.host, tr.port, timeout=5.0) == ((0, 1),)
        a.close()
        b.close()
    finally:
        tr.stop()
    assert tt.fetch_topo("127.0.0.1", 9, timeout=0.5) is None


# ---------------------------------------------------------------- tables

def _table(float_sum, other=None):
    return {"float_sum": float_sum,
            "other": other or [{"max_n": None, "method": "ring",
                                "wire": None}]}


TABLES = {
    "v3": ("rabit_tpu.collective_sweep/v3", _table([
        {"max_n": 10000, "method": "tree", "wire": None},
        {"max_n": 300000, "method": "swing", "wire": "int8:bf16@512"},
        {"max_n": 3000000, "method": "hier", "wire": None, "flat": "bidir"},
        {"max_n": None, "method": "hier", "wire": "bf16"}],
        [{"max_n": 5000, "method": "tree", "wire": None},
         {"max_n": None, "method": "bidir", "wire": None}])),
    "v2": ("rabit_tpu.collective_sweep/v2", _table([
        {"max_n": 50000, "method": "tree", "wire": None},
        {"max_n": None, "method": "ring", "wire": "int8"}])),
    "v1": ("rabit_tpu.collective_sweep/v1", _table([
        {"max_n": None, "method": "bidir", "wire": None}])),
    "foreign_schema": ("rabit_tpu.collective_sweep/v9", _table([
        {"max_n": None, "method": "ring", "wire": None}])),
    "open_ended_missing": ("rabit_tpu.collective_sweep/v3", _table([
        {"max_n": 10, "method": "ring", "wire": None}])),
    "bad_method": ("rabit_tpu.collective_sweep/v3", _table([
        {"max_n": None, "method": "preagg", "wire": None}])),
    "bad_wire": ("rabit_tpu.collective_sweep/v3", _table([
        {"max_n": None, "method": "ring", "wire": "fp8"}])),
    "bad_flat": ("rabit_tpu.collective_sweep/v3", _table([
        {"max_n": None, "method": "hier", "wire": None, "flat": "hier"}])),
    "no_other": ("rabit_tpu.collective_sweep/v3",
                 {"float_sum": [{"max_n": None, "method": "ring",
                                 "wire": None}]}),
}


def _write(tmp_path, name):
    path = tmp_path / f"COLLECTIVE_SWEEP_{name}.json"
    schema, table = TABLES[name]
    path.write_text(json.dumps({"schema": schema, "table": table}))
    return str(path)


@pytest.mark.parametrize("name", sorted(TABLES) + ["not_json", "missing"])
def test_load_table_matches_rabit_tpu(clean, tmp_path, name):
    if name == "not_json":
        path = tmp_path / "COLLECTIVE_SWEEP_x.json"
        path.write_text("{not json")
        path = str(path)
    elif name == "missing":
        path = str(tmp_path / "COLLECTIVE_SWEEP_none.json")
    else:
        path = _write(tmp_path, name)
    got, want = td.load_table(path), jd.load_table(path)
    assert got == want
    assert (got is not None) == (name in ("v1", "v2", "v3"))


def test_load_table_cache_follows_the_file(clean, tmp_path):
    path = _write(tmp_path, "v1")
    assert td.load_table(path)["float_sum"][0]["method"] == "bidir"
    schema, table = TABLES["v2"]
    Path(path).write_text(json.dumps({"schema": schema, "table": table}))
    import os
    os.utime(path, (1, 1))  # a new mtime, whatever the clock's grain
    assert td.load_table(path) == table
    td.epoch_reset(4)
    assert td._cache == {}


SIZES = [1, 100, 1023, 1024, 5000, 10000, 10001, 32767, 32768, 300000,
         300001, 3000001]
GROUPINGS = [None, ((0, 1), (2, 3)), ((0, 1, 2, 3),), ((0,), (1,), (2,),
                                                        (3,))]


def _resolve_both(n, dtype, op, world, **kw):
    return (td.resolve(n, torch.from_numpy(np.zeros(1, dtype)).dtype, op,
                       world, **kw),
            jd.resolve(n, dtype, op, world, **kw))


@pytest.mark.parametrize("table", ["v3", "v2", "v1", None])
@pytest.mark.parametrize("env_wire,mincount", [
    (None, None), ("int8", None), ("int8:bf16", "0"), ("bf16", "400000")])
def test_resolve_matches_rabit_tpu(clean, tmp_path, table, env_wire,
                                   mincount):
    """Every size x grouping x world x op x dtype, auto and explicit
    methods and wires, with the table in force (``None``: no table) and
    the env wire and its gate set or not."""
    clean.setenv("RABIT_DISPATCH_TABLE",
                 _write(tmp_path, table) if table else "none")
    if env_wire:
        clean.setenv("RABIT_DATAPLANE_WIRE", env_wire)
    if mincount is not None:
        clean.setenv("RABIT_DATAPLANE_WIRE_MINCOUNT", mincount)
    checked = 0
    for world in (2, 3, 4):
        for groups in GROUPINGS if world == 4 else [None]:
            for n in SIZES:
                for dtype, op in ((np.float32, SUM), (np.float32, MAX),
                                  (np.int32, SUM), (np.int32, BITOR)):
                    for method, wire in (("auto", "auto"), ("auto", None),
                                         ("auto", "int8"), ("swing", "auto"),
                                         ("hier", "bf16@256"),
                                         ("preagg", "auto")):
                        got, want = _resolve_both(n, dtype, op, world,
                                                  method=method, wire=wire,
                                                  groups=groups)
                        assert got == want, (n, dtype, op, world, groups,
                                             method, wire)
                        assert td.last_wire() == jd.last_wire()
                        assert td.last_wire_provenance() == \
                            jd.last_wire_provenance()
                        checked += 1
    assert checked == 12 * 4 * 6 * (1 + 1 + 4)


def test_resolve_hier_row_flat_column_bitor_and_gate(clean, tmp_path):
    """The hier row with its flat column, the BITOR override and the
    wire gate's precedence, spelled out."""
    clean.setenv("RABIT_DISPATCH_TABLE", _write(tmp_path, "v3"))
    h = ((0, 1), (2, 3))
    f32 = torch.float32
    # hier row: hierarchical grouping -> hier; none -> the flat column
    assert td.resolve(500000, f32, SUM, 4, groups=h) == ("hier", None)
    assert td.resolve(500000, f32, SUM, 4) == ("bidir", None)
    # open-ended hier row without a flat column -> the fallback constants
    assert td.resolve(5000000, f32, SUM, 4) == ("ring", None)
    # BITOR: the tree all-gathers, so from 1024 elements the ring
    assert td.resolve(100, torch.int32, BITOR, 4) == ("tree", None)
    assert td.resolve(1024, torch.int32, BITOR, 4) == ("ring", None)
    assert td.resolve(6000, torch.int32, BITOR, 4) == ("bidir", None)
    clean.setenv("RABIT_DISPATCH_TABLE", "none")
    assert td.resolve(1024, torch.int32, BITOR, 4) == ("ring", None)
    # the wire gate: the table's column, unless a mincount is pinned
    clean.setenv("RABIT_DISPATCH_TABLE", _write(tmp_path, "v3"))
    clean.setenv("RABIT_DATAPLANE_WIRE", "int8")
    assert td.resolve(200000, f32, SUM, 4) == ("swing", "int8")
    assert td.resolve(500000, f32, SUM, 4, groups=h) == ("hier", None)
    clean.setenv("RABIT_DATAPLANE_WIRE_MINCOUNT", "0")
    assert td.resolve(500000, f32, SUM, 4, groups=h) == ("hier", "int8")
    # a per-call spec beats both, and "none" turns the wire off
    assert td.resolve(200000, f32, SUM, 4, wire="bf16") == ("swing", "bf16")
    assert td.resolve(200000, f32, SUM, 4, wire="none") == ("swing", None)
    assert td.last_wire_provenance() == "explicit"


def test_the_port_never_reads_benchmarks_artifacts(clean, tmp_path):
    """The JAX package's newest table under ``benchmarks/artifacts/``
    steers its dispatch; the port, with no table of its own, keeps the
    fallback crossover (2048 floats by the tree, 32768 by the ring). A
    table in the port's own directory is read."""
    jax_tables = sorted((ROOT / "benchmarks" / "artifacts").glob(
        "COLLECTIVE_SWEEP_*.json"))
    assert jax_tables, "the JAX package's tables are gone"
    assert jd.load_table() is not None
    assert td.load_table() is None
    assert td.resolve(2048, torch.float32, SUM, 4) == ("tree", None)
    assert td.resolve(32768, torch.float32, SUM, 4) == ("ring", None)
    own = tmp_path / "no_artifacts"
    own.mkdir()
    shutil.copy(jax_tables[-1], own / jax_tables[-1].name)
    assert td.load_table() == jd.load_table(str(jax_tables[-1]))


@pytest.mark.parametrize("knob", ["RABIT_SKEW_ADAPT", "RABIT_WIRE_ADAPTIVE"])
def test_knobs_that_read_telemetry_raise(clean, knob):
    clean.setenv(knob, "1")
    with pytest.raises(NotImplementedError, match=knob.lower()):
        td.resolve(2048, torch.float32, SUM, 4)


def test_unknown_method_raises(clean):
    for mod, dt in ((td, torch.float32), (jd, np.float32)):
        with pytest.raises(ValueError, match="method must be one of"):
            mod.resolve(2048, dt, SUM, 4, method="butterfly")


# ---------------------------------------------------------------- engine

ENGINE_CONFIGS = [
    [],
    ["rabit_reduce_ring_mincount=1000"],
    ["rabit_reduce_method=swing"],
    ["rabit_dataplane_wire=int8:bf16", "rabit_dataplane_wire_mincount=4096"],
    ["rabit_dataplane_wire=int8", "rabit_reduce_ring_mincount=100",
     "rabit_reduce_method=bidir"],
    ["rabit_dataplane_wire=bf16@512"],
    ["rabit_dataplane_wire=none", "rabit_reduce_method=hier"],
    ["rabit_dataplane_wire_mincount=1k", "rabit_dataplane_wire=int8@256"],
]


@pytest.mark.parametrize("args", ENGINE_CONFIGS,
                         ids=["-".join(a) or "defaults"
                              for a in ENGINE_CONFIGS])
def test_torch_engine_resolves_like_the_xla_engine(clean, args):
    from rabit_tpu.engine.xla import XlaEngine
    from rabit_tpu_torch.engine.torch_engine import TorchEngine
    ours, theirs = TorchEngine(), XlaEngine()
    ours.init(["rabit_device=cpu"] + args)
    theirs.init(args)
    try:
        for n in (100, 999, 1000, 2048, 4096, 32767, 32768, 1 << 18,
                  1 << 20):
            assert ours._resolve_method_wire(n) == \
                theirs._resolve_method_wire(n), (args, n)
    finally:
        ours.shutdown()
        theirs.shutdown()


@pytest.mark.parametrize("bad", ["rabit_reduce_method=butterfly",
                                 "rabit_dataplane_wire=fp8"])
def test_torch_engine_refuses_what_the_xla_engine_refuses(clean, bad):
    import torch.distributed as dist
    from rabit_tpu.engine.xla import XlaEngine
    from rabit_tpu_torch.engine.torch_engine import TorchEngine
    with pytest.raises(ValueError):
        XlaEngine().init([bad])
    with pytest.raises(ValueError):
        TorchEngine().init(["rabit_device=cpu", bad])
    assert not dist.is_initialized()   # refused before any group


def test_torch_engine_without_a_table_keeps_the_crossover(clean):
    """No table of the port's own: auto reduces 2048 floats by the tree
    and 32768 by the ring (the engine leaves auto to the dispatcher)."""
    from rabit_tpu_torch.engine.torch_engine import TorchEngine
    eng = TorchEngine()
    eng.init(["rabit_device=cpu"])
    try:
        for n, method in ((2048, "tree"), (32768, "ring")):
            m, w = eng._resolve_method_wire(n)
            assert (m, w) == ("auto", None)
            assert td.resolve(n, torch.float32, SUM, 4, method=m,
                              wire=w) == (method, None)
    finally:
        eng.shutdown()


# ---------------------------------------------------------------- sweep

def test_collective_sweep_smoke_over_gloo_writes_a_loadable_table(
        clean, tmp_path, capsys):
    from rabit_tpu_torch.tools import collective_sweep
    out = tmp_path / "COLLECTIVE_SWEEP_smoke.json"
    assert collective_sweep.main(["--smoke", "--world", "2", "--device",
                                  "cpu", "--out", str(out)]) == 0
    doc = json.loads(out.read_text())
    assert doc["schema"] == td.SCHEMA and doc["smoke"] is True
    assert doc["world"] == 2 and doc["backend"] == "gloo"
    assert doc["device"]["name"] == "cpu"
    seen = {(r["section"], r["method"], r["wire"]) for r in doc["rows"]}
    # world 2 has no two-level grouping: no hier column
    assert len(seen) == len(doc["rows"]) == 1 + 3 * 4 + 4
    assert doc["repeats"] == 1
    for r in doc["rows"]:
        assert r["s_per_op"] > 0 and r["bus_gbps"] > 0
        assert r["s_per_op_readings"] == [r["s_per_op"]]
    assert td.load_table(str(out)) == doc["table"]
    assert jd.load_table(str(out)) == doc["table"]
    assert "smoke ok" in capsys.readouterr().out


def test_collective_sweep_point_is_the_median_of_its_readings(monkeypatch):
    """One slow reading among three moves neither time of a point."""
    from rabit_tpu_torch.tools import collective_sweep
    readings = iter([(1e-4, 2e-5), (9e-4, 9e-5), (2e-4, 1e-5)])
    monkeypatch.setattr(collective_sweep, "_reading",
                        lambda *args: next(readings))
    got = collective_sweep._timed(None, torch.device("cpu"), 2, 8, False,
                                  None, 3)
    assert got == {"s_per_op": 2e-5, "host_paced_s_per_op": 2e-4,
                   "s_per_op_readings": [2e-5, 9e-5, 1e-5],
                   "host_paced_readings": [1e-4, 9e-4, 2e-4]}
    assert collective_sweep.REPEATS >= 3


def test_collective_sweep_refuses_more_cards_than_there_are(clean):
    from rabit_tpu_torch.tools import run_world
    with pytest.raises(RuntimeError, match="CUDA devices"):
        run_world(print, torch.cuda.device_count() + 1, "cuda")
