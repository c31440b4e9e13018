"""``TorchEngine``'s durable checkpoint store and its refusals, against
``rabit_tpu``'s ``XlaEngine``:

* the two single-process round trips of tests/test_ckpt_store.py (a cold
  restart from ``rabit_ckpt_dir``; a lazy checkpoint that lands on disk
  once materialised), each program run under both engines with the same
  versions, bytes and files;
* a spawned gloo world of 3 whose disks lag (rank 0 at version 3, rank 1
  a version behind, rank 2 empty): every rank resumes version 3 with rank
  0's global bytes, and local state stays on its rank;
* the knobs the port lacks raise ``NotImplementedError`` at init, one
  family a case (the set ``engine/native.py`` refuses too), while the
  telemetry plane's (``rabit_telemetry``, ``rabit_profile``,
  ``rabit_events``) are honoured, and ``rabit_debug`` opens the debug
  log."""

import numpy as np
import pytest
import torch.distributed as dist

from rabit_tpu.engine.xla import XlaEngine
from rabit_tpu_torch import telemetry
from rabit_tpu_torch.telemetry import events, profile
from rabit_tpu_torch.engine.ckpt_store import CheckpointStore
from rabit_tpu_torch.engine.torch_engine import TorchEngine
from rabit_tpu_torch.utils import log
from torch_world import spawn_world

CPU = "rabit_device=cpu"


def _engines(kind, args):
    """A fresh engine of ``kind`` (a new process, as far as the store can
    tell) and its init."""
    e = XlaEngine() if kind == "xla" else TorchEngine()
    e.init(args + ([CPU] if kind == "torch" else []))
    return e


def _shutdown(e):
    if isinstance(e, TorchEngine):
        e.shutdown()


def _cold_restart(kind, root):
    args = [f"rabit_ckpt_dir={root}"]
    seen = []
    e = _engines(kind, args)
    seen.append(e.load_checkpoint())           # empty store
    e.checkpoint(b"m1")
    e.checkpoint(b"m2", b"loc2")
    _shutdown(e)
    e2 = _engines(kind, args)                   # a fresh process
    seen.append(e2.load_checkpoint(with_local=True))
    e2.checkpoint(b"m3")
    _shutdown(e2)
    return seen, CheckpointStore(str(root)).versions()


def test_cold_restart_resumes_as_xla_engine_does(tmp_path):
    got = _cold_restart("torch", tmp_path / "torch")
    want = _cold_restart("xla", tmp_path / "xla")
    assert got == want
    assert got == ([(0, None, None), (2, b"m2", b"loc2")], [2, 3])
    for v in (2, 3):
        assert (tmp_path / "torch" / "r0" / f"ckpt_v{v}.rbt").read_bytes() == \
            (tmp_path / "xla" / "r0" / f"ckpt_v{v}.rbt").read_bytes()


def _lazy(kind, root):
    args = [f"rabit_ckpt_dir={root}"]
    e = _engines(kind, args)
    e.lazy_checkpoint(lambda: b"lazy-model")
    first = e.load_checkpoint()                 # materialised and stored
    _shutdown(e)
    e2 = _engines(kind, args)
    second = e2.load_checkpoint()
    _shutdown(e2)
    return first, second


def test_lazy_checkpoint_lands_on_disk_as_in_xla_engine(tmp_path):
    got = _lazy("torch", tmp_path / "torch")
    assert got == _lazy("xla", tmp_path / "xla")
    assert got == ((1, b"lazy-model", None), (1, b"lazy-model", None))


def test_without_a_store_a_restart_begins_at_version_zero(tmp_path):
    e = _engines("torch", [])
    e.checkpoint(b"m1")
    _shutdown(e)
    e2 = _engines("torch", [])
    assert e2.load_checkpoint() == (0, None, None)
    _shutdown(e2)


def _lagging_rank(rank, p, root):
    e = TorchEngine()
    e.init([f"rabit_ckpt_dir={root}", CPU])
    version, glob, loc = e.load_checkpoint(with_local=True)
    e.checkpoint(b"next-" + bytes([rank]))
    e.shutdown()
    return {"version": np.array(version),
            "global": np.frombuffer(glob or b"", np.uint8),
            "local": np.frombuffer(loc or b"", np.uint8),
            "stored": np.array(CheckpointStore(root, rank).versions())}


def test_lagging_disks_resume_one_version_in_a_world_of_three(tmp_path):
    root = tmp_path / "ckpt"
    for v in (1, 2, 3):
        CheckpointStore(str(root), 0, keep=8).save(
            v, f"model-{v}".encode(), f"loc0-{v}".encode())
    for v in (1, 2):
        CheckpointStore(str(root), 1, keep=8).save(
            v, f"stale-{v}".encode(), f"loc1-{v}".encode())
    (tmp_path / "world").mkdir()
    ranks = spawn_world(_lagging_rank, 3, tmp_path / "world", str(root))
    for r, got in enumerate(ranks):
        assert int(got["version"]) == 3, r
        assert got["global"].tobytes() == b"model-3", r
        assert got["local"].tobytes() == (b"loc0-3" if r == 0 else b""), r
        # the next checkpoint is version 4 on every disk, the empty one too
        assert 4 in got["stored"].tolist(), r


# the telemetry plane's knobs and the live plane's metrics port are
# ported: those cases hold that init honours them (each knob's module, or
# the engine's metrics endpoint, reports it on), the rest that init
# refuses
_HONOURED = {"rabit_telemetry": lambda e: telemetry.enabled(),
             "rabit_profile": lambda e: profile.enabled(),
             "rabit_events": lambda e: events.enabled(),
             "rabit_metrics_port": lambda e: e._metrics_server is not None}


@pytest.mark.parametrize("args", [
    ["rabit_telemetry=1"], ["rabit_profile=1"], ["rabit_events=1"],
    ["rabit_metrics_port=0"], ["rabit_deadline_ms=500"],
    ["rabit_deadline_ms_per_mb=10"],
    ["rabit_hier_phase_deadline_scale=0.5"]],
    ids=["telemetry", "profile", "events", "metrics_port", "deadline",
         "deadline_per_mb", "hier_phase_deadline_scale"])
def test_unported_knobs_raise_rather_than_be_ignored(args):
    e = TorchEngine()
    knob = args[0].split("=")[0]
    if knob in _HONOURED:
        try:
            e.init(args + [CPU])
            assert _HONOURED[knob](e)
        finally:
            e.shutdown()
            # port 0 picks a free port: that knob's off is its absence
            e.init([CPU] if knob == "rabit_metrics_port"
                   else [CPU, f"{knob}=0"])
            e.shutdown()
        assert not _HONOURED[knob](e)
        return
    with pytest.raises(NotImplementedError, match="not ported"):
        e.init(args + [CPU])
    assert not dist.is_initialized()


def test_rabit_debug_opens_the_debug_log(capsys):
    e = TorchEngine()
    e.init(["rabit_debug=1", CPU])
    try:
        log.log_debug("probe %d", 7)
        assert "probe 7" in capsys.readouterr().err
    finally:
        e.shutdown()
        log.set_debug(False)
        log.clear_identity()
    log.log_debug("probe %d", 8)
    assert "probe 8" not in capsys.readouterr().err


class _Placed(Exception):
    pass


@pytest.mark.parametrize("spec,want", [(None, "cuda:2"), ("cuda", "cuda:2"),
                                       ("cuda:1", "cuda:1"), ("cpu", "cpu")])
def test_a_world_it_forms_puts_rank_r_on_card_r(monkeypatch, spec, want):
    """``TorchEngine`` forming a world of 4 on a machine of 4 cards places
    rank 2 on card 2 whether the card is named without an index
    (``rabit_device=cuda``) or not at all; NCCL refuses two ranks on one
    device. An explicit index or the CPU is kept."""
    import torch
    from rabit_tpu_torch.engine import torch_engine

    def placed(device, **kw):
        raise _Placed(device)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch_engine, "make_group", placed)
    args = ["rabit_coordinator=127.0.0.1:1", "rabit_num_processes=4",
            "rabit_process_id=2"] + ([] if spec is None
                                     else [f"rabit_device={spec}"])
    with pytest.raises(_Placed) as got:
        TorchEngine().init(args)
    assert got.value.args[0] == want
