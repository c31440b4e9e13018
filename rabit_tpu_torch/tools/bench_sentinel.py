"""Performance-regression sentinel over the port's artifact history: the
port's copy of ``tools/bench_sentinel.py``, over the port's
``telemetry/history.py``, with the same gate, knobs and exit codes, so it
runs where JAX is absent (the card's machine).

Ingests every recognized perf artifact of a directory (default:
``build/artifacts/``, where the port's tools write) into the normalized
append-only history (default: ``build/artifacts/history.jsonl``), then
judges the newest sample of every (metric, config-fingerprint) series
against a rolling median-absolute-deviation baseline and prints one
``rabit_tpu.bench_sentinel/v1`` verdict artifact on stdout. Exit 1 when
any series regressed, 0 when clean -- so a merge can be gated on "no
metric fell more than ``--mad-k`` MADs below its own recent history".

    python -m rabit_tpu_torch.tools.bench_sentinel             # ingest + gate
    python -m rabit_tpu_torch.tools.bench_sentinel --out VERDICT.json
    python -m rabit_tpu_torch.tools.bench_sentinel --smoke     # self-test

``--smoke`` builds a synthetic history in a temporary directory, checks
that a clean series passes (zero regressions) AND that an injected
3x-MAD drop is flagged (nonzero), through the same code paths as the
real run.

Knobs (flags beat env): ``--window``/``RABIT_SENTINEL_WINDOW`` baseline
size (8), ``--mad-k``/``RABIT_SENTINEL_MAD_K`` gate width (3.0),
``--min-samples``/``RABIT_SENTINEL_MIN_SAMPLES`` history floor below
which a series is reported but not judged (4).
"""

import argparse
import glob
import json
import os
import sys
import tempfile

from . import ARTIFACTS
from ..telemetry import history


def ingest_dir(path: str, hist_path: str) -> int:
    """Append every recognized artifact under ``path``; returns the
    number of new records written."""
    added = 0
    for p in sorted(glob.glob(os.path.join(path, "*.json"))):
        try:
            with open(p) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if not isinstance(doc, dict):
            continue
        recs = history.records_from_artifact(
            doc, source=os.path.basename(p))
        added += history.append(hist_path, recs)
    return added


def run_gate(hist_path: str, window: int, mad_k: float,
             min_samples: int) -> dict:
    records = history.load(hist_path)
    verdicts = history.gate(records, window=window, mad_k=mad_k,
                            min_samples=min_samples)
    return history.verdict_doc(verdicts, window=window, mad_k=mad_k)


def smoke() -> int:
    """Self-test: clean synthetic history gates to zero regressions;
    the same history plus one injected 3x-MAD drop gates nonzero."""
    with tempfile.TemporaryDirectory() as td:
        hist = os.path.join(td, "history.jsonl")
        # deterministic jittered series around 100 GB/s (MAD = 1.0)
        values = [100.0, 101.0, 99.0, 100.5, 99.5, 101.5, 98.5, 100.0]
        recs = [{"metric": "smoke_throughput", "value": v, "unit": "GB/s",
                 "direction": "higher", "fingerprint": "smokecfg00000",
                 "timestamp_utc": f"20260801T0000{i:02d}Z",
                 "source": "smoke"} for i, v in enumerate(values)]
        assert history.append(hist, recs) == len(values)
        # re-append must dedupe to zero (append-only log stays canonical)
        assert history.append(hist, recs) == 0
        doc = run_gate(hist, window=8, mad_k=3.0, min_samples=4)
        assert doc["regressions"] == 0, doc
        judged = [v for v in doc["verdicts"]
                  if v["metric"] == "smoke_throughput"]
        assert judged and judged[0]["regressed"] is False, judged
        # inject a drop well past median - 3*MAD (100 - 3*1.25 ≈ 96)
        history.append(hist, [{
            "metric": "smoke_throughput", "value": 80.0, "unit": "GB/s",
            "direction": "higher", "fingerprint": "smokecfg00000",
            "timestamp_utc": "20260801T000099Z", "source": "smoke"}])
        doc = run_gate(hist, window=8, mad_k=3.0, min_samples=4)
        assert doc["regressions"] == 1, doc
        bad = [v for v in doc["verdicts"] if v["regressed"]]
        assert bad[0]["value"] == 80.0 and bad[0]["threshold"] > 80.0
        # the CLI contract itself: regressions -> nonzero exit code
        assert exit_code(doc) != 0
        clean = run_gate(os.devnull, window=8, mad_k=3.0, min_samples=4)
        assert exit_code(clean) == 0
    print("bench sentinel smoke ok")
    return 0


def exit_code(doc: dict) -> int:
    return 1 if doc.get("regressions", 0) else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="perf-history regression gate (MAD-based)")
    ap.add_argument("--ingest", action="append", default=None,
                    metavar="DIR",
                    help="artifact dir(s) to ingest before gating "
                         "(default: build/artifacts)")
    ap.add_argument("--history", default=history.history_path(),
                    help="history JSONL path")
    ap.add_argument("--no-ingest", action="store_true",
                    help="gate the existing history without ingesting")
    ap.add_argument("--window", type=int, default=history.WINDOW_DEFAULT)
    ap.add_argument("--mad-k", type=float, default=history.MAD_K_DEFAULT)
    ap.add_argument("--min-samples", type=int,
                    default=history.MIN_SAMPLES_DEFAULT)
    ap.add_argument("--out", default=None,
                    help="also write the verdict artifact here")
    ap.add_argument("--smoke", action="store_true",
                    help="synthetic self-test; exits 0 only "
                         "when the gate catches the injected regression")
    args = ap.parse_args(argv)
    if args.smoke:
        return smoke()
    if not args.no_ingest:
        dirs = args.ingest or [str(ARTIFACTS)]
        added = sum(ingest_dir(d, args.history) for d in dirs)
        print(f"[sentinel] ingested {added} new records into "
              f"{args.history}", file=sys.stderr)
    doc = run_gate(args.history, args.window, args.mad_k,
                   args.min_samples)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=2, sort_keys=True)
            f.write("\n")
    print(json.dumps(doc, sort_keys=True))
    for v in doc["verdicts"]:
        if v["regressed"]:
            print(f"[sentinel] REGRESSION {v['metric']} "
                  f"(cfg {v['fingerprint']}): {v['value']:g} "
                  f"{v['unit']} vs baseline median "
                  f"{v['baseline_median']:g} (threshold "
                  f"{v['threshold']:g})", file=sys.stderr)
    return exit_code(doc)


if __name__ == "__main__":
    sys.exit(main())
