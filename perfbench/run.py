"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 -m perfbench.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks
for (one process a card). With ``--trace 0`` the result holds the cell's
end-to-end metrics; with ``--trace 1`` its per-layer metrics, where the
first half of the window runs untraced (the host-clock metrics) and the
second under ``torch.profiler`` (the device metrics).

The last line of standard output is one JSON object: ``correct``,
``attempted`` (histogram calls in the window), ``failed`` (checked calls
over the limit), ``metrics``, ``device``, with ``--trace 1`` a
``breakdown``, and last ``check``, each number compared beside its limit.
The same numbers end standard error. A run prints no result and exits
with another code than 0 where it finds no card or too few, where the port
is missing, or where JAX or the JAX package is loaded once the window has
closed.
"""

import time

T_START = time.time()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import multiprocessing  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from dataclasses import dataclass  # noqa: E402
from pathlib import Path  # noqa: E402
from typing import Callable, List, Optional  # noqa: E402

from . import check, rank  # noqa: E402
from .reading import Reading, Trace  # noqa: E402
from .trace import top  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
WORLD_TIMEOUT_S = 1150


@dataclass
class Spec:
    root: Path
    cell: dict
    config: dict
    mix: dict
    metrics: List[dict]         # the cell's, end-to-end or per-layer


def applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_spec(root: Path, workload: str, traced: bool) -> Spec:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {c["name"]: c for c in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json: "
                         f"{sorted(cells)}")
    cell = cells[workload]
    entry = next(c for c in bench["configs"] if c["name"] == cell["config"])
    config = json.loads((root / entry["file"]).read_text())
    kind = "per_layer" if traced else "end_to_end"
    return Spec(root, cell, config,
                json.loads((root / "perfbench" / "traffic"
                            / f"{cell['traffic']}.json").read_text()),
                [m for m in bench[kind] if applies(m, workload)])


def read_metric(root: Path, name: str, reading: Reading):
    """``metrics/<name>.py``'s ``read(reading)``: a number, or None."""
    path = root / "perfbench" / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        "perfbench_metric_" + name.replace(".", "_").replace("-", "_"), path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read(reading)


def run_world(spec: Spec, jobs: List[rank.Job], device_type: str,
              prelude: Optional[Callable[[], None]] = None,
              timeout_s: float = WORLD_TIMEOUT_S) -> List[List[dict]]:
    """Each rank's results, a list a job. One rank runs in this process;
    more are spawned, one a card, and all are stopped if one fails."""
    ranks = int(spec.cell["chips"])
    with tempfile.TemporaryDirectory() as tmp:
        if ranks == 1:
            world = rank.World(spec.config, spec.mix, 1, device_type, tmp,
                               T_START, [-1] * 2 * len(jobs), jobs, prelude)
            return [rank.run_rank(0, world)]
        ctx = multiprocessing.get_context("spawn")
        flags = ctx.RawArray("q", [-1] * 2 * len(jobs))
        world = rank.World(spec.config, spec.mix, ranks, device_type, tmp,
                           T_START, flags, jobs, prelude)
        procs = [ctx.Process(target=rank.entry, args=(r, world))
                 for r in range(ranks)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.is_alive() for p in procs):
                if any(p.exitcode not in (None, 0) for p in procs):
                    raise RuntimeError("a rank failed: " + ", ".join(
                        f"rank {r} exit {p.exitcode}"
                        for r, p in enumerate(procs)))
                if time.monotonic() > deadline:
                    raise RuntimeError(f"the ranks ran past {timeout_s} s")
                procs[0].join(timeout=0.5)
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
            for p in procs:
                p.join()
        if any(p.exitcode != 0 for p in procs):
            raise RuntimeError("a rank failed: " + ", ".join(
                f"rank {r} exit {p.exitcode}" for r, p in enumerate(procs)))
        return [json.loads((Path(tmp) / f"rank{r}.json").read_text())
                for r in range(ranks)]


def reading_of(results: List[dict]) -> Reading:
    """One job's results of every rank, as the metric readers take them."""
    r0 = results[0]
    trace = None
    if r0["trace"] is not None:
        t = r0["trace"]
        trace = Trace(
            window_s=t["window_s"], busy_s=t["busy_s"], device_s=t["device_s"], idle_s=t["idle_s"],
            calls=r0["traced_calls"], entries=r0["traced_entries"],
            trees=r0["traced_calls"] / r0["calls_per_tree"])
    return Reading(
        ranks=len(results), nbins=r0["nbins"],
        calls_per_tree=r0["calls_per_tree"], setup_s=r0["setup_s"],
        window_s=r0["window_s"], calls=r0["calls"], level_ms=r0["level_ms"],
        issue_s=r0["issue_s"], issue_calls=r0["issue_calls"],
        peak_window_bytes=max(r["peak_window_bytes"] for r in results),
        trace=trace)


def device_of(device_type: str, ranks: int, results: List[dict]) -> dict:
    peak = max(r["peak_bytes"] for r in results)
    if device_type != "cuda":
        dev = {"platform": "cpu", "kind": "cpu", "count": ranks,
               "memory_peak_bytes": peak}
    else:
        import torch
        try:
            limit = subprocess.run(
                ["nvidia-smi", "--query-gpu=power.limit",
                 "--format=csv,noheader", "--id=0"], capture_output=True,
                text=True, timeout=60).stdout.strip() or None
        except (OSError, subprocess.TimeoutExpired):
            limit = None
        dev = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
               "count": ranks, "memory_peak_bytes": peak,
               "power_limit": limit}
    trace = results[0]["trace"]
    if trace is not None:
        dev["busy_s"] = sum(r["trace"]["busy_s"] for r in results) / ranks
        dev["window_s"] = trace["window_s"]
    return dev


def result_line(spec: Spec, device_type: str, results: List[dict]) -> dict:
    reading = reading_of(results)
    metrics = {}
    for m in spec.metrics:
        value = read_metric(spec.root, m["name"], reading)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    err = max(r["hist_rel_err"] for r in results)
    failed = sum(r["failed"] for r in results)
    line = {"correct": failed == 0, "attempted": results[0]["calls"],
            "failed": failed, "metrics": metrics,
            "device": device_of(device_type, len(results), results)}
    trace = results[0]["trace"]
    if trace is not None:
        line["breakdown"] = {"device_ops": top(trace["device_s"]),
                             "idle_gaps": top(trace["idle_s"])}
    line["check"] = {"hist_rel_err": {"value": err,
                                      "limit": check.HIST_REL_ERR_LIMIT}}
    return line


def parse(argv: Optional[List[str]]) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def clear_port_settings() -> None:
    """The port runs as it ships: none of its settings (``RABIT_*``, its
    telemetry among them) from the environment."""
    for key in [k for k in os.environ if k.startswith("RABIT_")]:
        del os.environ[key]


def has_cards(ranks: int) -> bool:
    import torch
    return torch.cuda.is_available() and torch.cuda.device_count() >= ranks


def main(argv: Optional[List[str]] = None, root: Path = ROOT,
         device_type: str = "cuda",
         prelude: Optional[Callable[[], None]] = None) -> int:
    """A run; ``device_type="cpu"`` and ``prelude`` serve the tests alone,
    which rehearse it over gloo and plant faults under it."""
    args = parse(argv)
    spec = load_spec(root, args.workload, bool(args.trace))
    ranks = int(spec.cell["chips"])
    if device_type == "cuda" and not has_cards(ranks):
        print(f"{args.workload} needs {ranks} CUDA device(s); this machine "
              f"has none or too few", file=sys.stderr)
        return 2
    clear_port_settings()
    jobs = [rank.Job(args.seed, args.seconds, bool(args.trace))]
    results = [r[0] for r in run_world(spec, jobs, device_type, prelude)]
    found = sorted(set(rank.forbidden_modules()).union(
        *(r["forbidden"] for r in results)))
    if found:
        print(f"JAX or the JAX package was loaded: {found}", file=sys.stderr)
        return 3
    line = result_line(spec, device_type, results)
    r0 = results[0]
    issue = r0["issue_s"] / max(r0["issue_calls"], 1) * 1e6
    print(f"setup {r0['setup_s']:.3f} s, window {r0['window_s']:.3f} s, "
          f"{r0['trees']} trees, {issue:.1f} us a call in the entry "
          f"untraced, check {r0['checked']} calls in "
          f"{max(r['check_s'] for r in results):.3f} s", file=sys.stderr)
    if r0["trace"] is not None:
        n = r0["trace"]["device_n"]
        print(f"traced {r0['traced_calls']} calls: device operations "
              f"{sorted(n.items(), key=lambda kv: -kv[1])[:6]}",
              file=sys.stderr)
    for name, c in line["check"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
