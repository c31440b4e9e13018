"""The readings the limit of ``check.py`` is set from, at a cell's own size.

    python3 -m perfbench.control --workload <cell> --seeds 11,12,... \\
        --control-seeds 21,22,23 [--seconds 2]

In one world of the cell's ranks (one set-up for all of them), each seed
runs a short window of the cell's traffic and the check of a full run:
with ``--seeds`` through the port as it ships (``precision="high"``),
with ``--control-seeds`` through the port's own bf16 path
(``precision="fast"``), the precision below the f32 that the
configurations state, which has to come out not correct. One line a seed:
``reading <cell> <seed> <precision> hist_rel_err <value>``.
"""

from __future__ import annotations

import argparse
import sys
from typing import List, Tuple

from . import run
from .rank import Job


def readings(spec: run.Spec, seeds: List[int], control_seeds: List[int],
             seconds: float, device_type: str = "cuda"
             ) -> List[Tuple[int, str, float]]:
    """(seed, precision, hist_rel_err) of every seed, the program's first."""
    jobs = ([Job(s, seconds, False, "high") for s in seeds]
            + [Job(s, seconds, False, "fast") for s in control_seeds])
    results = run.run_world(spec, jobs, device_type)
    return [(job.seed, job.precision,
             max(rank[j]["hist_rel_err"] for rank in results))
            for j, job in enumerate(jobs)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="")
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    spec = run.load_spec(run.ROOT, args.workload, False)
    if not run.has_cards(int(spec.cell["chips"])):
        print(f"{args.workload} needs {spec.cell['chips']} CUDA device(s)",
              file=sys.stderr)
        return 2
    run.clear_port_settings()

    def ints(text: str) -> List[int]:
        return [int(x) for x in text.split(",") if x]

    for seed, precision, err in readings(spec, ints(args.seeds),
                                         ints(args.control_seeds),
                                         args.seconds):
        print(f"reading {args.workload} {seed} {precision} hist_rel_err "
              f"{err!r}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
