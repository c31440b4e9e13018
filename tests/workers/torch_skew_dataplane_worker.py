"""Skew adaptation on the robust engine's torch data plane
(``engine="robust_torch"``): a forced digest names rank 1, the engine's
``rabit_skew_*`` arguments are exported for the data plane, and one
scripted data-plane failure (RABIT_DATAPLANE_FAIL_AT) re-forms the world,
which re-arms the agreement boundary (``skew.reset_sync``) on every rank
before its first collective. Every round's sum must stay exact (integer
values), every round ran the rotated ring around rank 1, and the data
plane's spans carry the plan (``adapted``) and the applied wire.

argv: key=value params forwarded to the engine (rabit_device=cpu, ...)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "..", ".."))

import numpy as np  # noqa: E402
import rabit_tpu_torch as rabit  # noqa: E402
from rabit_tpu_torch import telemetry  # noqa: E402
from rabit_tpu_torch.telemetry import skew  # noqa: E402


def main() -> None:
    rabit.init(engine="robust_torch")
    engine = rabit._engine  # test-only peek at the active engine
    reformed = []
    engine.set_world_reformed_callback(lambda e: reformed.append(e))
    rank, world = rabit.get_rank(), rabit.get_world_size()
    assert os.environ["RABIT_SKEW_ADAPT"] == "1"
    assert skew.sync_rounds() == 2
    base = (np.arange(40000) % 97).astype(np.float32)
    tags = []
    for it in range(6):
        out = rabit.allreduce(base + rank + it, rabit.SUM)
        want = base * world + sum(r + it for r in range(world))
        assert np.array_equal(out, want), f"SUM wrong at iter {it}"
        tags.append(skew.last_applied())
    assert len(reformed) >= 2, f"re-formations seen: {reformed}"
    assert tags == ["rotate@1"] * 6, tags
    spans = [s for s in telemetry.snapshot()["spans"]
             if s["name"] == "dataplane.allreduce"]
    assert spans and all(s["attrs"].get("adapted") == "rotate@1"
                         and s["attrs"].get("wire_applied") == "off"
                         for s in spans), spans
    counts = {c["name"]: c["count"] for c in telemetry.snapshot()["counters"]
              if c["name"].startswith("dispatch.skew")}
    rabit.finalize()
    assert "RABIT_SKEW_ADAPT" not in os.environ   # the export is undone
    print(f"SKEW-DATAPLANE-OK rank={rank} reformed={len(reformed)} "
          f"counts={counts}")


if __name__ == "__main__":
    main()
