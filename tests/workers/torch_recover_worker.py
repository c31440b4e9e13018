"""The port's self-verifying fault-tolerance worker: ``recover_worker.py``
through ``rabit_tpu_torch`` (reference test/model_recover.cc +
local_recover.cc). It iterates versioned checkpoints, verifies every
collective analytically each iteration, and survives scripted kills
(mock=rank,version,seqno,ntrial argv params) through tracker respawn,
result replay and checkpoint recovery.

argv: key=value params forwarded to the engine (mock=..., etc.)
env:  N_ITER (default 6), WITH_LOCAL=1 for local-checkpoint mode,
      LAZY=1 for LazyCheckPoint, KILL_IN_DATAPLANE=rank,iter to end that
      rank's first attempt inside the MAX allreduce of that iteration,
      after the engine's consensus and before its data-plane collective
      (the peers are then in the collective with a dead rank)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import rabit_tpu_torch as rabit  # noqa: E402


def _kill_point():
    spec = os.environ.get("KILL_IN_DATAPLANE")
    if not spec or os.environ.get("RABIT_NUM_TRIAL", "0") != "0":
        return None
    r, it = (int(v) for v in spec.split(","))
    return r, it


def verify_iteration(rank: int, world: int, it: int) -> None:
    n = 97
    kill = _kill_point()

    def prep(d):
        if kill == (rank, it):
            os._exit(254)
        d[:] = np.arange(n, dtype=np.float32) + rank + it

    a = np.zeros(n, dtype=np.float32)
    out = rabit.allreduce(a, rabit.MAX, prepare_fun=prep)
    np.testing.assert_allclose(out, np.arange(n) + (world - 1) + it,
                               err_msg=f"MAX wrong at iter {it}")

    s = rabit.allreduce(np.full(n, float(rank + 1), np.float64), rabit.SUM)
    np.testing.assert_allclose(s, np.full(n, world * (world + 1) / 2),
                               err_msg=f"SUM wrong at iter {it}")

    obj = rabit.broadcast({"it": it, "payload": list(range(it * 3))},
                          it % world)
    assert obj["it"] == it and len(obj["payload"]) == it * 3


def main() -> None:
    rabit.init()  # mock entries in argv auto-select the mock engine
    rank = rabit.get_rank()
    world = rabit.get_world_size()
    n_iter = int(os.environ.get("N_ITER", "6"))
    with_local = os.environ.get("WITH_LOCAL") == "1"
    lazy = os.environ.get("LAZY") == "1"

    if with_local:
        version, model, local = rabit.load_checkpoint(with_local=True)
        if version == 0:
            model, local = {"iter": 0}, {"rank_data": rank * 1000}
        assert local["rank_data"] == rank * 1000, \
            f"local checkpoint corrupt: {local}"
    else:
        version, model = rabit.load_checkpoint()
        if version == 0:
            model = {"iter": 0}
        local = None
    assert model["iter"] == version, (model, version)

    for it in range(model["iter"], n_iter):
        verify_iteration(rank, world, it)
        model["iter"] = it + 1
        if lazy:
            rabit.lazy_checkpoint(model)
        elif with_local:
            local["rank_data"] = rank * 1000
            rabit.checkpoint(model, local_model=local)
        else:
            rabit.checkpoint(model)
        assert rabit.version_number() == it + 1

    rabit.tracker_print(f"torch_recover_worker rank {rank}/{world} "
                        f"finished {n_iter} iters OK")
    rabit.finalize()


if __name__ == "__main__":
    main()
