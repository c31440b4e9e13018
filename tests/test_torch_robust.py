"""Fault-injection recovery with the port's torch data plane: the robust
native engine under ``rabit_tpu_torch`` keeps consensus, result replay and
checkpoint recovery while every allreduce runs over a gloo world of
``torch.distributed`` (``rabit_dataplane=torch``,
``rabit_device=cpu``), under the port's tracker and launcher. The
scenarios of ``tests/test_recovery_xla.py``; ``rabit_dataplane_minbytes=0``
sends every payload through the data plane. Workers:
``tests/workers/torch_recover_worker.py`` and
``torch_dataplane_fail_worker.py``."""

import os
import sys

import pytest

from rabit_tpu_torch.engine import _native_build
from rabit_tpu_torch.tracker.launch import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKERS = os.path.join(ROOT, "tests", "workers")
ARGS = ["rabit_dataplane=torch", "rabit_dataplane_minbytes=0",
        "rabit_device=cpu"]


@pytest.fixture(scope="module", autouse=True)
def native_core():
    _native_build.build()


def run_torch(nworkers, worker, extra_args=(), env=None, stats=None):
    cmd = [sys.executable, os.path.join(WORKERS, worker), *ARGS,
           *extra_args]
    return launch(nworkers, cmd, timeout=150, quiet=True, env=env,
                  stats=stats)


def test_no_failure_checkpoint_loop():
    stats = {}
    assert run_torch(4, "torch_recover_worker.py", stats=stats) == 0
    assert stats["total_attempts"] == 0 and stats["epoch"] == 1


def test_single_death_mid_training():
    stats = {}
    assert run_torch(4, "torch_recover_worker.py", ["mock=1,2,1,0"],
                     stats=stats) == 0
    assert stats["total_attempts"] == 1 and stats["epoch"] >= 2
    # the store of the dead epoch was reaped once the new one was acked
    assert stats["stores_retained"] == 1


def test_multiple_simultaneous_deaths():
    assert run_torch(4, "torch_recover_worker.py",
                     ["mock=0,1,0,0", "mock=2,1,1,0"]) == 0


def test_die_hard_same_rank_twice():
    stats = {}
    assert run_torch(4, "torch_recover_worker.py",
                     ["mock=1,1,1,0", "mock=1,1,1,1"], stats=stats) == 0
    assert stats["total_attempts"] == 2


def test_death_at_load_checkpoint():
    assert run_torch(4, "torch_recover_worker.py",
                     ["mock=3,0,0,0", "mock=3,0,0,1"]) == 0


def test_local_checkpoint_recovery():
    assert run_torch(4, "torch_recover_worker.py", ["mock=2,2,0,0"],
                     env={"WITH_LOCAL": "1"}) == 0


def test_lazy_checkpoint_recovery():
    assert run_torch(4, "torch_recover_worker.py", ["mock=1,2,1,0"],
                     env={"LAZY": "1"}) == 0


def test_death_inside_the_dataplane_collective():
    """Rank 2 ends after the engine's consensus, inside the window of the
    data-plane collective: its peers are in a gloo allreduce with a dead
    rank, which raises; they return nonzero to the engine, re-register,
    and replay with the respawned rank."""
    stats = {}
    assert run_torch(4, "torch_recover_worker.py",
                     env={"KILL_IN_DATAPLANE": "2,3"}, stats=stats) == 0
    assert stats["total_attempts"] == 1 and stats["epoch"] >= 2


def test_dataplane_failure_on_healthy_world():
    """No process dies: the data-plane callback raises once on every rank
    (RABIT_DATAPLANE_FAIL_AT). The engine maps it to kReset, rewires its
    links (the epoch advances) and the world re-forms; asserted inside the
    worker by the epoch and the on_world_reformed hook (two formations at
    least)."""
    stats = {}
    assert run_torch(4, "torch_dataplane_fail_worker.py",
                     env={"RABIT_DATAPLANE_FAIL_AT": "3"}, stats=stats) == 0
    assert stats["total_attempts"] == 0 and stats["epoch"] >= 2


def test_retry_rung_reforms_at_the_same_epoch():
    """RABIT_COLLECTIVE_RETRIES: the failed round re-runs in place on a
    world re-formed at the same epoch (its rendezvous keyed by the round
    and the attempt), and the engine never sees the failure."""
    stats = {}
    assert run_torch(4, "torch_dataplane_fail_worker.py",
                     env={"RABIT_DATAPLANE_FAIL_AT": "3",
                          "RABIT_COLLECTIVE_RETRIES": "2"},
                     stats=stats) == 0
    assert stats["epoch"] == 1


def test_dataplane_healthy_baseline():
    # the same worker with no scripted failure: one formation, one epoch
    assert run_torch(3, "torch_dataplane_fail_worker.py") == 0
