"""The port's overlap benchmark (``rabit_tpu_torch/tools/overlap_bench.py``
and its worker, twins of ``tools/overlap_bench.py`` and
``benchmarks/overlap_round_worker.py``) on the CPU: the smoke's checks
over a gloo world of 4, the bench at world 2 over gloo at a small size
(both paths' sync and overlap series equal bit for bit and exact, the
recorder's split, the artifact and the history records), and the refusal
to run without a card unless ``--device cpu`` is given."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import rabit_tpu.telemetry.history as jax_history

from rabit_tpu_torch.telemetry import history
from rabit_tpu_torch.tools import overlap_bench as B
from rabit_tpu_torch.tools import overlap_round_worker as W

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _env() -> dict:
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    return env


def test_worker_defaults_are_the_jax_workers():
    assert W.config({}) == {"N_BUCKETS": 4, "BUCKET_ELEMS": 1000000,
                            "COMPUTE_DIM": 384, "COMPUTE_REPS": 8,
                            "N_ROUNDS": 5, "N_WARMUP": 2,
                            "PATHS": ("host", "device")}
    assert W.config({"COMPUTE_DIM": "640"})["COMPUTE_DIM"] == 640
    assert W.config({"PATHS": "device"})["PATHS"] == ("device",)
    with pytest.raises(ValueError, match="PATHS"):
        W.config({"PATHS": "host,gpu"})


def test_buckets_are_the_jax_workers_and_sum_exactly():
    got = W.make_buckets(3, 4, 1000)
    for b, buf in enumerate(got):
        want = (np.arange(1000) % 251).astype(np.float32) + 3 + b
        np.testing.assert_array_equal(buf, want)
    sums = W.expected_sum(4, 4, 1000)
    for b in range(4):
        total = sum(W.make_buckets(r, 4, 1000)[b].astype(np.float64)
                    for r in range(4))
        np.testing.assert_array_equal(sums[b], total.astype(np.float32))


def test_smoke_over_gloo():
    r = subprocess.run([sys.executable, "-m",
                        "rabit_tpu_torch.tools.overlap_bench", "--smoke",
                        "--device", "cpu"], capture_output=True, text=True,
                       timeout=120, cwd=ROOT, env=_env())
    assert r.returncode == 0, r.stdout + r.stderr
    assert "overlap smoke ok (world 4, cpu, hier groups [[0, 1], [2, 3]])" \
        in r.stdout


def test_refuses_without_a_card_unless_told_cpu():
    r = subprocess.run([sys.executable, "-m",
                        "rabit_tpu_torch.tools.overlap_bench", "--smoke"],
                       capture_output=True, text=True, timeout=120, cwd=ROOT,
                       env=_env())
    assert r.returncode != 0
    assert "CUDA" in r.stderr and "ok" not in r.stdout


def test_bench_at_world_2_over_gloo(tmp_path, monkeypatch, capsys):
    """Both paths at a small size: sync and overlap equal bit for bit on
    both ranks and equal to the integer sum, the recorder's split of the
    async ops a step, the artifact and both series of both paths in the
    history (the JAX package's records for the same documents)."""
    for k, v in {"N_BUCKETS": "3", "BUCKET_ELEMS": "20000", "N_ROUNDS": "2",
                 "N_WARMUP": "1"}.items():
        monkeypatch.setenv(k, v)
    assert B.main(["--device", "cpu", "--world", "2", "--compute-dim", "64",
                   "--out", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    result = json.loads(next(ln for ln in out.splitlines()
                             if ln.startswith("{")))
    assert result["correct"] and result["world"] == 2
    assert result["backend"] == "gloo" and result["compute_dim"] == 64
    assert result["card"]["name"] == "cpu"
    for name in ("host", "device"):
        p = result["paths"][name]
        assert p["equal"] and p["exact"], name
        assert len(p["step_ms_sync"]) == len(p["step_ms_overlap"]) == 2
        assert p["bucket_step_ms_sync"] == np.mean(p["step_ms_sync"])
        assert p["async_ops"] == 3 * 2   # buckets x timed steps
        assert p["wire_exposed_ms"] >= 0 and p["wire_overlapped_ms"] >= 0
        assert p["compute_ms"] > 0 and p["allreduce_ms"] > 0
    (artifact,) = tmp_path.glob("OVERLAP_BENCH_*.json")
    doc = json.loads(artifact.read_text())
    assert doc["paths"] == result["paths"]
    recs = history.load(str(tmp_path / "history.jsonl"))
    assert len(recs) == 4
    assert {r["metric"] for r in recs} == {"bucket_step_ms_sync",
                                           "bucket_step_ms_overlap"}
    assert all(r["source"] == artifact.name for r in recs)
    # the same series as the JAX package's history would record them
    for r in recs:
        assert r["direction"] == "lower" and r["unit"] == "ms"
    for name, p in result["paths"].items():
        cfg = {k: result[k] for k in B._CONFIG_KEYS}
        cfg.update(path=name, backend="gloo")
        doc = dict(cfg, metric="bucket_step_ms_sync",
                   value=p["bucket_step_ms_sync"], unit="ms",
                   timestamp_utc=doc["timestamp_utc"])
        theirs = jax_history.records_from_artifact(doc, artifact.name)
        assert theirs[0] in recs
    # a second ingest of the same run adds nothing
    assert B.ingest(result, artifact.name, doc["timestamp_utc"],
                    str(tmp_path / "history.jsonl")) == 0
