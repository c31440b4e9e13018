"""Data-plane-only failure worker for the port (``dataplane_fail_worker.py``
through ``rabit_tpu_torch``): the world stays healthy (no process dies)
but the data-plane callback raises once on every rank
(RABIT_DATAPLANE_FAIL_AT). Without the retry rung that maps to kReset ->
reconnect -> epoch advance -> a new torch world; with
RABIT_COLLECTIVE_RETRIES > 0 the round re-runs in place on a world
re-formed at the SAME epoch. Asserts the collective stream stays correct
through it, and which of the two happened.

argv: key=value params forwarded to the engine (rabit_device=cpu, ...)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import rabit_tpu_torch as rabit  # noqa: E402


def main() -> None:
    reformed = []
    rabit.init(engine="robust_torch")
    engine = rabit._engine  # test-only peek at the active engine
    engine.set_world_reformed_callback(lambda e: reformed.append(e))
    rank = rabit.get_rank()
    world = rabit.get_world_size()
    epoch0 = engine.world_epoch

    for it in range(6):
        out = rabit.allreduce(np.full(31, float(rank + it), np.float32),
                              rabit.SUM)
        want = sum(float(r + it) for r in range(world))
        np.testing.assert_allclose(out, np.full(31, want),
                                   err_msg=f"SUM wrong at iter {it}")

    dp = engine.dataplane
    retries = int(os.environ.get("RABIT_COLLECTIVE_RETRIES", "0"))
    if os.environ.get("RABIT_DATAPLANE_FAIL_AT"):
        assert len(reformed) >= 2, f"re-formations seen: {reformed}"
        if retries > 0:
            # the retry rung: same epoch, no link reset
            assert engine.world_epoch == epoch0, \
                f"epoch moved: {epoch0} -> {engine.world_epoch}"
            assert dp.retries_total == 1, dp.retries_total
        else:
            assert engine.world_epoch > epoch0, \
                f"epoch did not advance: {epoch0} -> {engine.world_epoch}"
    else:
        assert reformed == [epoch0], reformed
    backend, epoch = dp.backend, engine.world_epoch
    rabit.finalize()
    print(f"DATAPLANE-FAIL-OK rank={rank} reformed={len(reformed)} "
          f"backend={backend} epochs={epoch0}->{epoch}")


if __name__ == "__main__":
    main()
