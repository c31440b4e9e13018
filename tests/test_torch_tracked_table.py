"""The dispatch table committed under ``rabit_tpu_torch/parallel/tables/``
(a ``tools.collective_sweep`` run at world 4 over NCCL on four H100s):

* it names the card and its power limit, and both packages' loaders
  accept it;
* ``load_table`` reads it after ``RABIT_DISPATCH_TABLE`` and the port's
  ``build/artifacts/``, and only where the default group is NCCL's, so a
  gloo world and a process without a group keep the fallback constants
  that tests/test_torch_dispatch.py holds against JAX's;
* on it, ``resolve`` picks NCCL's ``"tree"`` for the flagship's gradient
  tree (1,836,288 f32 elements) at world 4, where the fallback picks the
  ring."""

import json

import pytest
import torch
import torch.distributed as dist

from rabit_tpu.parallel import dispatch as jd
from rabit_tpu_torch.ops.reducers import SUM
from rabit_tpu_torch.parallel import dispatch as td

FLAGSHIP_GRADS = 1_836_288


@pytest.fixture
def clean(monkeypatch, tmp_path):
    for k in ("RABIT_DISPATCH_TABLE", "RABIT_DATAPLANE_WIRE",
              "RABIT_DATAPLANE_WIRE_MINCOUNT", "RABIT_WIRE_ADAPTIVE",
              "RABIT_SKEW_ADAPT", "RABIT_HIER", "RABIT_HIER_GROUP"):
        monkeypatch.delenv(k, raising=False)
    monkeypatch.setattr(td, "ARTIFACTS", tmp_path / "no_artifacts")
    td.clear_cache()
    yield monkeypatch
    td.clear_cache()


def _tracked():
    found = sorted(td.TABLES.glob("COLLECTIVE_SWEEP_*.json"))
    assert found, "no committed table"
    return found[-1]


def test_the_committed_table_names_its_card_and_loads():
    path = _tracked()
    doc = json.loads(path.read_text())
    assert doc["world"] == 4
    smi = doc["device"]["nvidia_smi"]
    assert "H100" in smi and smi.rstrip().endswith("W"), smi
    assert td.load_table(str(path)) == doc["table"]
    assert jd.load_table(str(path)) == doc["table"]


def test_without_nccl_the_fallback_stands(clean):
    assert not dist.is_initialized()
    assert td.load_table() is None
    assert td.resolve(FLAGSHIP_GRADS, torch.float32, SUM, 4) == ("ring", None)


def test_in_an_nccl_world_resolve_picks_the_tree(clean):
    clean.setattr(td, "_nccl_world", lambda: True)
    assert td.load_table() == td.load_table(str(_tracked()))
    assert td.resolve(FLAGSHIP_GRADS, torch.float32, SUM, 4) == ("tree", None)
    # the environment and the port's own artifacts come first
    clean.setenv("RABIT_DISPATCH_TABLE", "none")
    assert td.load_table() is None


def test_a_gloo_world_keeps_the_fallback(clean):
    from rabit_tpu_torch.parallel.mesh import make_group
    make_group("cpu")
    try:
        assert dist.get_backend() == "gloo"
        assert td.load_table() is None
    finally:
        dist.destroy_process_group()
