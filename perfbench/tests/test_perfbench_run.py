"""Rehearsals of whole runs on the CPU over gloo: the contract's last line,
a configuration, mix and metric added as new files, and the runs that must
print no result."""

import json
import os
import subprocess
import sys
import types

import pytest

from perfbench import run

from perfbench_testroot import ROOT, last_line

KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def _run(root, capsys, workload, trace, seed=2 ** 31 + 11, seconds=0.5):
    rc = run.main(["--workload", workload, "--seed", str(seed), "--seconds",
                   str(seconds), "--trace", str(trace)], root=root,
                  device_type="cpu")
    out = capsys.readouterr()
    return rc, out


@pytest.mark.parametrize("workload", ["tiny.tree", "tiny.stumps"])
def test_last_line_of_one_rank(root, capsys, workload):
    bench = json.loads((root / "BENCHMARK.json").read_text())
    for trace in (0, 1):
        rc, out = _run(root, capsys, workload, trace)
        assert rc == 0
        line = last_line(out.out)
        assert list(line)[:5] == KEYS and list(line)[-1] == "check"
        assert line["correct"] is True and line["failed"] == 0
        assert line["attempted"] > 0
        kind = "per_layer" if trace else "end_to_end"
        names = {m["name"] for m in bench[kind]
                 if workload in m.get("workloads", [workload])}
        # the CPU has no device trace: those readers find nothing
        cpu_only = {"tree_ms", "level_p95_ms", "setup_s",
                    "issue_us_per_call"}
        assert set(line["metrics"]) == names & cpu_only
        for m in line["metrics"].values():
            assert m["value"] > 0 and m["unit"]
        dev = line["device"]
        assert dev["count"] == 1 and "memory_peak_bytes" in dev
        assert ("busy_s" in dev) == bool(trace)
        assert ("breakdown" in line) == bool(trace)
        c = line["check"]["hist_rel_err"]
        assert 0 <= c["value"] <= c["limit"]
        tail = out.err.strip().splitlines()[-1]
        assert tail == f"check hist_rel_err {c['value']!r} limit " \
                       f"{c['limit']!r}"


def test_last_line_of_two_ranks_through_the_ring(root, capsys):
    rc, out = _run(root, capsys, "wide.tree.w2", 1, seconds=1.0)
    assert rc == 0
    line = last_line(out.out)
    assert line["correct"] is True and line["device"]["count"] == 2
    assert line["breakdown"]["idle_gaps"]
    assert "issue_us_per_call" in line["metrics"]


def test_a_configuration_mix_and_metric_added_as_files(root, capsys):
    pb = root / "perfbench"
    (pb / "configs" / "dummy.json").write_text(json.dumps(
        {"name": "dummy", "rows": 4096, "features": 8, "max_bin": 4}))
    (pb / "traffic" / "tree_depth3.json").write_text(json.dumps(
        {"max_depth": 3, "child_fraction": [0.25, 0.5], "shape_seed": 5,
         "shapes": 2, "grad_sets": 2}))
    (pb / "metrics" / "calls_per_s.py").write_text(
        "def read(r):\n    return r.calls / r.window_s\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "dummy", "source": "test",
                             "file": "perfbench/configs/dummy.json",
                             "reduced": [], "why": "test"})
    bench["workloads"].append({"name": "dummy.depth3", "config": "dummy",
                               "traffic": "tree_depth3", "chips": 1,
                               "why": "test"})
    bench["end_to_end"].append({"name": "calls_per_s", "unit": "1/s",
                                "better": "higher", "bound": 0.05,
                                "source": "host_clock",
                                "workloads": ["dummy.depth3"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    rc, out = _run(root, capsys, "dummy.depth3", 0)
    assert rc == 0
    line = last_line(out.out)
    assert line["correct"] is True
    assert line["metrics"]["calls_per_s"]["unit"] == "1/s"
    assert line["metrics"]["calls_per_s"]["value"] > 0
    # 1 + 1 + 2 calls a tree
    assert line["attempted"] % 4 == 0


def test_too_few_cards_print_no_result(root, capsys):
    rc = run.main(["--workload", "tiny.tree.w64", "--seed", "1",
                   "--seconds", "1"], root=root)
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA device" in out.err


def test_jax_loaded_in_the_run_prints_no_result(root, capsys, monkeypatch):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, out = _run(root, capsys, "tiny.stumps", 0)
    assert rc != 0 and out.out == ""
    assert "'jax'" in out.err


def test_a_checkout_of_the_benchmark_alone_fails(root):
    """BENCHMARK.json and perfbench/ without the port: no result."""
    bare = root
    for sub in ("rank.py", "run.py", "check.py", "data.py", "nodes.py",
                "floors.py", "reference.py", "reading.py", "trace.py",
                "control.py", "__init__.py"):
        (bare / "perfbench" / sub).write_bytes(
            (ROOT / "perfbench" / sub).read_bytes())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    code = ("import sys; from perfbench import run; sys.exit(run.main("
            "['--workload', 'tiny.stumps', '--seed', '3', '--seconds', "
            "'0.5'], device_type='cpu'))")
    done = subprocess.run([sys.executable, "-c", code], cwd=bare, env=env,
                          capture_output=True, text=True, timeout=300)
    assert done.returncode != 0
    assert done.stdout.strip() == ""
    assert "rabit_tpu_torch" in done.stderr
