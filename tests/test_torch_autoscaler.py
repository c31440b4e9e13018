"""The port's autoscaler (``rabit_tpu_torch/tracker/autoscaler.py``)
against the JAX package's: ``fair_shares`` on hypothesis-drawn fleets,
the straggler ``sweep`` and the fairness ``fleet_sweep`` deciding alike
on the JAX smoke's scripted documents, ``request_evict`` against the
port's multi-job tracker, and the ``--smoke`` in a fresh interpreter.
Exact: shares and decisions are integers and job ids."""

import os
import subprocess
import sys
from pathlib import Path

import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from rabit_tpu.tracker import autoscaler as jax_auto
from rabit_tpu_torch.tracker import autoscaler as port_auto
from rabit_tpu_torch.tracker import jobs as port_jobs
from rabit_tpu_torch.tracker import tracker as port_tracker

ROOT = Path(__file__).resolve().parent.parent


def test_knobs_and_defaults_are_the_jax_packages(monkeypatch):
    for name in ("INTERVAL_ENV", "LAG_ENV", "STRIKES_ENV", "MIN_WORLD_ENV",
                 "INTERVAL_MS_DEFAULT", "LAG_DEFAULT", "STRIKES_DEFAULT",
                 "MIN_WORLD_DEFAULT"):
        assert getattr(port_auto, name) == getattr(jax_auto, name), name
    for value in (None, "0", "1", "250", "-4", "junk"):
        for env in (port_auto.INTERVAL_ENV, port_auto.LAG_ENV,
                    port_auto.STRIKES_ENV, port_auto.MIN_WORLD_ENV):
            if value is None:
                monkeypatch.delenv(env, raising=False)
            else:
                monkeypatch.setenv(env, value)
        for k in ("autoscale_interval_ms", "autoscale_lag",
                  "autoscale_strikes", "autoscale_min_world"):
            assert getattr(port_auto, k)() == getattr(jax_auto, k)(), \
                (k, value)


_jobs = st.lists(
    st.fixed_dictionaries({
        "job": st.text(alphabet="abcdefgh", min_size=1, max_size=3),
        "weight": st.one_of(st.just(1.0), st.sampled_from([0.0, 0.5, 2.0]),
                            st.floats(min_value=0.01, max_value=50))}),
    max_size=8)


@settings(max_examples=200, deadline=None)
@given(jobs=_jobs, cap=st.integers(min_value=-2, max_value=200))
def test_fair_shares_equal_the_jax_function(jobs, cap):
    got = port_auto.fair_shares(jobs, cap)
    assert got == jax_auto.fair_shares(jobs, cap)
    if got and len({j["job"] for j in jobs}) == len(jobs):
        assert sum(got.values()) == cap   # distinct jobs share it all


def test_fair_shares_largest_remainder_ties_lexicographic():
    for mod in (port_auto, jax_auto):
        assert mod.fair_shares([{"job": "jobA", "weight": 1.0},
                                {"job": "jobB", "weight": 3.0}], 8) == \
            {"jobA": 2, "jobB": 6}
        assert mod.fair_shares([{"job": "a"}, {"job": "b"}, {"job": "c"}],
                               8) == {"a": 3, "b": 3, "c": 2}


_LAG = {"signal": True, "lagging_rank": 2, "lag_collectives": 40,
        "busy_skew_s": 1.0}

# the JAX smoke's scripted documents: (straggler doc, jobs doc) a sweep
_SWEEPS = [
    ({"signal": False, "jobs": {"jobA": _LAG}},
     {"jobs": [{"job": "jobA", "world": 4, "elastic": True},
               {"job": "jobB", "world": 4, "elastic": True}]}),
    ({"signal": False, "jobs": {"jobA": _LAG}}, None),
    ({"signal": False, "jobs": {}}, None),
    ({"signal": False, "jobs": {"jobA": _LAG}}, None),
    (None, {"jobs": [{"job": "jobA", "world": 2, "elastic": True}]}),
    (None, None),
    ({"signal": False, "jobs": {"jobB": dict(_LAG, lag_collectives=3)}},
     {"jobs": [{"job": "jobB", "world": 4, "elastic": True}]}),
    (None, None), (None, None),
    ({"signal": False, "jobs": {"jobB": _LAG}},
     {"jobs": [{"job": "jobB", "world": 4, "elastic": False}]}),
    (None, None),
    # an aggregate doc (no ``jobs`` map): the default job's
    (dict(_LAG, lagging_rank=1), {"jobs": [
        {"job": "default", "world": 3, "elastic": True}]}),
    (None, None), (None, None),
    ("unreachable", None),
]

_FLEET = [
    {"max_fleet_ranks": 8, "queue": [{"job": "jobC"}], "jobs": [
        {"job": "jobA", "world": 4, "elastic": True, "weight": 1.0,
         "status": "live", "live": [0, 1, 2, 3]},
        {"job": "jobB", "world": 4, "elastic": True, "weight": 3.0,
         "status": "live", "live": [0, 1, 2, 3]}]},
    None,
    {"max_fleet_ranks": 8, "queue": [], "jobs": [
        {"job": "jobA", "world": 4, "elastic": True, "weight": 1.0,
         "status": "live", "live": [0, 1, 2, 3]}]},
    {"max_fleet_ranks": 4, "queue": [{"job": "jobC"}], "jobs": [
        {"job": "jobA", "world": 2, "elastic": True, "weight": 1.0,
         "status": "live", "live": [0, 1]},
        {"job": "jobB", "world": 2, "elastic": True, "weight": 9.0,
         "status": "live", "live": [0, 1]}]},
    None,
    {"max_fleet_ranks": 6, "queue": [{"job": "x"}], "jobs": [
        {"job": "big", "world": 5, "elastic": True, "weight": 1.0,
         "status": "live", "live": [0, 2, 3, 6, 7]},
        {"job": "fixed", "world": 4, "elastic": False, "weight": 1.0,
         "status": "live"},
        {"job": "gone", "world": 4, "elastic": True, "status": "closed"}]},
    None, None,
    {},
]


def _decisions(mod, monkeypatch):
    monkeypatch.setenv(mod.STRIKES_ENV, "2")
    monkeypatch.setenv(mod.LAG_ENV, "10")
    monkeypatch.setenv(mod.MIN_WORLD_ENV, "2")
    state = {"strag": None, "jobs": None}
    evicted = []

    def scrape(path):
        doc = state["strag"] if path == "/straggler" else state["jobs"]
        return None if doc == "unreachable" else doc

    sc = mod.Autoscaler("127.0.0.1", 1, "127.0.0.1", 1, scrape_fn=scrape,
                        evict_fn=lambda j, r, why: evicted.append(
                            (j, r, why)) or True)
    out = []
    for strag, jobs in _SWEEPS:
        if strag is not None:
            state["strag"] = strag
        if jobs is not None:
            state["jobs"] = jobs
        out.append(sc.sweep())
        out.append(sorted(sc._strikes.items()))
    for jobs in _FLEET:
        if jobs is not None:
            state["jobs"] = jobs
        out.append(sc.fleet_sweep())
        out.append(sorted(sc._fleet_strikes.items()))
    return out, evicted, (sc.evicted_total, sc.rebalanced_total, sc.sweeps)


def test_sweep_and_fleet_sweep_decide_as_the_jax_autoscaler(monkeypatch):
    port = _decisions(port_auto, monkeypatch)
    jax = _decisions(jax_auto, monkeypatch)
    assert port == jax
    out, evicted, totals = port
    assert [(j, r) for j, r, _ in evicted] == \
        [("jobA", 2), ("default", 1), ("jobA", 3), ("big", 7)]
    assert totals == (2, 2, len(_SWEEPS))


def test_request_evict_drives_the_port_trackers_job(monkeypatch):
    monkeypatch.setenv("RABIT_MULTI_JOB", "1")
    tr = port_tracker.Tracker(2, elastic=True).start()
    try:
        assert port_jobs.submit(tr.host, tr.port, "A", 2,
                                elastic=True)["ok"] == 1
        conns = [port_jobs.wire_register(tr.host, tr.port, f"A/{i}")
                 for i in range(2)]
        for c in conns:
            port_jobs.wire_read_assignment(c)
        assert port_auto.request_evict(tr.host, tr.port, 1, "slow",
                                       job_id="A")
        assert not port_auto.request_evict(tr.host, tr.port, 1, "again",
                                           job_id="A")
        assert sorted(tr.job("A")._member.live) == [0]
        # a rank outside the default job's world is refused
        assert not port_auto.request_evict(tr.host, tr.port, 5, "range")
    finally:
        tr.stop()


@pytest.mark.parametrize("module, marker", [
    ("rabit_tpu_torch.tracker.autoscaler", "autoscaler smoke ok"),
    ("rabit_tpu_torch.tracker.jobs", "multi-job smoke ok")])
def test_smoke_runs_without_jax(module, marker):
    code = ("import runpy, sys\n"
            "sys.argv = ['smoke', '--smoke']\n"
            "try:\n"
            f"    runpy.run_module({module!r}, run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = [m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'rabit_tpu')]\n"
            "assert not bad, bad\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("RABIT_") and k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert marker in r.stdout
