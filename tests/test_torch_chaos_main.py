"""``python -m rabit_tpu_torch.chaos --smoke`` (``rabit_tpu_torch/chaos/__main__.py``)
against the JAX package's ``python -m rabit_tpu.chaos --smoke``: the port's
smoke passes in a fresh interpreter without JAX; both smokes, run in one
process, inject the same kinds and counts round by round (each proxy's
events read as it stops); and a schedule whose rule of one round never
fires fails that round's assertion with the same message in both."""

import collections
import json
import os
import subprocess
import sys

import pytest

import rabit_tpu.chaos.__main__ as jax_main
import rabit_tpu.chaos.proxy as jax_proxy
import rabit_tpu_torch.chaos.__main__ as port_main
import rabit_tpu_torch.chaos.proxy as port_proxy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the proxies of the five rounds, in order, and what each injects
ROUNDS = [{"reset": 1, "tracker_kill": 1}, {"tracker_partition": 1},
          {"bitflip": 1}, {"job_storm": 1}]
# each round's failure message (before its colon) when its rule never fires
FAILS = {"reset": "expected 1 injected reset",
         "tracker_kill": "expected 1 tracker_kill event",
         "tracker_partition": "expected 1 tracker_partition event",
         "bitflip": "expected 1 bitflip event",
         "job_storm": "storm thread never fired"}
STORM_KEYS = ("RABIT_MULTI_JOB", "RABIT_MAX_JOBS", "RABIT_ADMISSION_QUEUE")


def test_smoke_in_fresh_interpreter_without_jax():
    code = ("import runpy, sys\n"
            "sys.argv = ['chaos', '--smoke']\n"
            "try:\n"
            "    runpy.run_module('rabit_tpu_torch.chaos', "
            "run_name='__main__')\n"
            "except SystemExit as e:\n"
            "    assert not e.code, e.code\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'rabit_tpu'))\n"
            "print('BAD ' + repr(bad))\n")
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=ROOT,
                       env={**os.environ, "PYTHONPATH": ROOT})
    assert r.returncode == 0, r.stderr[-2000:]
    assert "chaos smoke ok (1 reset + 1 tracker_kill" in r.stdout
    assert "BAD []" in r.stdout


def _record_stops(monkeypatch, proxy_mod):
    """Each proxy's injected kinds, in the order the proxies stop."""
    seen = []
    real = proxy_mod.ChaosProxy.stop

    def stop(self, *a, **kw):
        if not getattr(self, "_recorded", False):
            self._recorded = True
            seen.append(dict(collections.Counter(e[1] for e in self.events)))
        return real(self, *a, **kw)

    monkeypatch.setattr(proxy_mod.ChaosProxy, "stop", stop)
    return seen


def test_same_injected_kinds_and_counts_per_round(monkeypatch, capsys):
    env = {k: os.environ.get(k) for k in STORM_KEYS}
    jax_seen = _record_stops(monkeypatch, jax_proxy)
    port_seen = _record_stops(monkeypatch, port_proxy)
    assert jax_main.smoke() == 0
    assert port_main.smoke() == 0
    assert jax_seen == port_seen == ROUNDS
    out = capsys.readouterr().out.splitlines()
    oks = [ln for ln in out if ln.startswith("chaos smoke ok")]
    assert len(oks) == 2 and oks[0] == oks[1]
    # the storm round's knobs are restored
    assert {k: os.environ.get(k) for k in STORM_KEYS} == env


def _without(monkeypatch, module, kind):
    """``module``'s rules of ``kind`` made with ``max_times=0``: present in
    the schedule, never fired."""
    real = module.Rule

    def rule(k, **kw):
        if k == kind:
            kw["max_times"] = 0
        return real(k, **kw)

    monkeypatch.setattr(module, "Rule", rule)


@pytest.mark.parametrize("kind", list(FAILS))
def test_round_fails_without_its_rule(monkeypatch, kind):
    env = {k: os.environ.get(k) for k in STORM_KEYS}
    msgs = []
    for module in (jax_main, port_main):
        _without(monkeypatch, module, kind)
        with pytest.raises(AssertionError) as e:
            module.smoke()
        msgs.append(str(e.value).split(":")[0])
    assert msgs == [FAILS[kind]] * 2, json.dumps(msgs)
    assert {k: os.environ.get(k) for k in STORM_KEYS} == env
