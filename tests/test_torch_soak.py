"""The port's soak (``rabit_tpu_torch/tools/soak.py``) against the JAX
package's ``tools/soak.py``: the same scenario table, job kinds and chaos
schedule, every scenario a registered chaos kind of the port (and lint
T004 over the port's file), the SLO gate's exit on an injected violation,
``--strict-attribution``'s exit on an unattributed incident, and no JAX
in a fresh interpreter that runs the tool. (``tests/test_slo_soak.py``
holds the JAX tool.)"""

import json
import os
import subprocess
import sys

import pytest

from rabit_tpu_torch.chaos import schedule as port_schedule
from rabit_tpu_torch.tools import soak as port_soak

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT_SOAK = os.path.join(ROOT, "rabit_tpu_torch", "tools", "soak.py")


@pytest.fixture(scope="module")
def jax_soak():
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import soak
    finally:
        sys.path.pop(0)
    return soak


def test_tables_equal_jax(jax_soak):
    assert port_soak.SCENARIOS == jax_soak.SCENARIOS
    assert port_soak._JOB_KINDS == jax_soak._JOB_KINDS
    assert port_soak.SOAK_KIND == jax_soak.SOAK_KIND


@pytest.mark.parametrize("duration,seed", [(8, 7), (20, 7), (45, 1),
                                           (300, 7), (61.5, 23)])
def test_chaos_spec_equals_jax(jax_soak, duration, seed):
    spec = port_soak.chaos_spec(duration, seed)
    assert spec == jax_soak.chaos_spec(duration, seed)
    # and it builds the same schedule in both packages
    from rabit_tpu.chaos.schedule import Schedule as JaxSchedule
    assert port_schedule.Schedule.from_spec(spec).to_json() == \
        JaxSchedule.from_spec(spec).to_json()


def test_scenarios_are_registered_port_kinds():
    for name, spec in port_soak.SCENARIOS.items():
        assert spec["kind"] in port_schedule.KINDS, name
        assert spec["target"] in port_schedule.TARGETS, name
    sched = port_schedule.Schedule.from_spec(port_soak.chaos_spec(60.0, 1))
    assert {r.kind for r in sched.rules} == \
        {s["kind"] for s in port_soak.SCENARIOS.values()}
    assert sched.for_target("tracker").rules
    assert sched.for_target("link").rules


def _t004(monkeypatch, path, src=None):
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    try:
        import analysis  # noqa: F401
        from analysis import rules_telemetry
        from analysis.core import FileContext
    finally:
        sys.path.pop(0)
    rel = os.path.relpath(path, ROOT)
    monkeypatch.setattr(rules_telemetry, "T004_SCENARIO_TABLES",
                        {rel: "SCENARIOS"})
    if src is None:
        with open(path) as f:
            src = f.read()
    return rules_telemetry.check_soak_scenarios(FileContext(path, src))


def test_t004_clean_on_port_soak(monkeypatch):
    assert _t004(monkeypatch, PORT_SOAK) == []


def test_t004_flags_unregistered_kind_in_port_soak(monkeypatch):
    src = ('SCENARIOS = {"bad": {"kind": "tracker_kil", '
           '"target": "tracker"}}\n')
    out = _t004(monkeypatch, PORT_SOAK, src)
    assert len(out) == 1 and "tracker_kil" in out[0][3]


# -- the gate, in a fresh interpreter ----------------------------------------

_RUN = ("import json, runpy, sys\n"
        "sys.argv = ['soak'] + json.loads(sys.argv[1])\n"
        "code = 0\n"
        "try:\n"
        "    runpy.run_module('rabit_tpu_torch.tools.soak', "
        "run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    code = e.code\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'rabit_tpu'))\n"
        "print('RESULT ' + json.dumps({'code': code, 'bad': bad}))\n")


@pytest.fixture(scope="module")
def violation(tmp_path_factory):
    """``--duration 8 --qps 0.8 --objective p99_ms=0.0001`` in a fresh
    interpreter: any measured p99 is at least 1 us, so the objective
    must violate."""
    out = str(tmp_path_factory.mktemp("soak") / "soak.json")
    args = ["--duration", "8", "--qps", "0.8", "--quiet", "--no-history",
            "--objective", "p99_ms=0.0001", "--out", out]
    r = subprocess.run([sys.executable, "-c", _RUN, json.dumps(args)],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
    line = [ln for ln in r.stdout.splitlines() if ln.startswith("RESULT ")]
    assert r.returncode == 0 and line, r.stderr[-2000:]
    with open(out) as f:
        return json.loads(line[-1][7:]), json.load(f)


def test_injected_violation_exits_1(violation):
    res, doc = violation
    assert res["code"] == 1
    assert doc["schema"] == "rabit_tpu.soak/v1"
    assert doc["gate"]["pass"] is False
    assert "p99_ms" in doc["gate"]["violating"]
    by = {v["slo"]: v for v in doc["slos"]}
    assert by["p99_ms"]["state"] == "violating"
    assert by["p99_ms"]["burn"] >= 1.0
    # the verdict carries its incident, attributed or marked
    assert by["p99_ms"]["incident"] == "soak-p99_ms"
    assert "unattributed" in by["p99_ms"]


def test_fresh_interpreter_imports_no_jax(violation):
    assert violation[0]["bad"] == []


@pytest.mark.parametrize("strict,unattributed,want", [
    (True, ["soak-p99_ms"], 1), (False, ["soak-p99_ms"], 0),
    (True, [], 0), (False, [], 0)])
def test_strict_attribution(monkeypatch, capsys, strict, unattributed, want):
    def fake_run_soak(*a, **kw):
        return {"schema": "rabit_tpu.soak/v1", "slos": [],
                "gate": {"pass": True, "violating": [], "no_data": [],
                         "unattributed": list(unattributed)}}

    monkeypatch.setattr(port_soak, "run_soak", fake_run_soak)
    argv = ["--duration", "1", "--quiet", "--no-history"]
    if strict:
        argv.append("--strict-attribution")
    assert port_soak.main(argv) == want
    err = capsys.readouterr().err
    assert ("strict attribution" in err) == bool(want)
