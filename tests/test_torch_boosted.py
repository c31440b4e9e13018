"""The port's ``tools/boosted_trees.py`` at world 4 on the robust engine
with the torch data plane (gloo here): a run with kills ends with the
digest of the run without (training is deterministic and the histograms'
sums exact), and its trees are those of ``examples/py/boosted_trees.py``
under ``rabit_tpu``: the same (feature, bucket) every round, and leaf
weights within ``WEIGHT_ATOL``. The example sums unrounded f64 gradients;
the port rounds each gradient and hessian to ``step`` = 2^-15 at this
shape (so that f32 sums are exact) and sums in f32: each leaf weight
-G/(H + 1) moves by at most (1 + |w|) * step / 2 / mean(h), about 2e-4 a
round with h above 0.15, and the ten rounds' margins carry it on.

Each worker writes its result document to a file of its own in a
directory the test passes it (``RABIT_RESULT_DIR``): the four ranks share
the launcher's stdout, where under load another process's output can
break into a result line."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from rabit_tpu_torch.engine import _native_build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WEIGHT_ATOL = 5e-4


@pytest.fixture(scope="module", autouse=True)
def native_core():
    _native_build.build()


def _launch(package, prog, args, out_dir, prefix, timeout=200):
    """Four workers under ``package``'s launcher; each rank's document,
    read from ``<out_dir>/<prefix><rank>.json``."""
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["RABIT_RESULT_DIR"] = str(out_dir)
    out = subprocess.run(
        [sys.executable, "-m", f"{package}.tracker.launch", "-n", "4",
         "--timeout", str(timeout - 30), sys.executable, *prog, *args],
        env=env, capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, (out.stdout[-2000:], out.stderr[-2000:])
    docs = []
    for path in sorted(out_dir.glob(f"{prefix}*.json")):
        with open(path) as f:
            docs.append(json.load(f))
    return docs


def run_port(out_dir, args=()):
    docs = _launch("rabit_tpu_torch",
                   ["-m", "rabit_tpu_torch.tools.boosted_trees"],
                   ["rabit_engine=robust_torch", "rabit_device=cpu",
                    "rabit_dataplane_minbytes=0", *args], out_dir, "rank")
    assert sorted(d["rank"] for d in docs) == [0, 1, 2, 3]
    assert {d["dataplane"]["backend"] for d in docs} == {"gloo"}
    return docs


@pytest.fixture(scope="module")
def clean(tmp_path_factory):
    return run_port(tmp_path_factory.mktemp("boost_clean"))


def test_boosting_with_kills_equals_the_run_without(clean, tmp_path):
    # rank 1 dies twice at round 3, rank 2 once at round 7: respawns
    # reload the checkpointed model and catch up through replay
    faulty = run_port(tmp_path, ["mock=1,3,0,0", "mock=1,3,0,1",
                                 "mock=2,7,1,0"])
    digests = {d["digest"] for d in clean + faulty}
    assert len(digests) == 1, digests
    assert min(d["epoch"] for d in faulty) >= 3
    for d in faulty:
        assert d["trees"] == clean[0]["trees"]


def test_trees_match_the_example_under_rabit_tpu(clean, tmp_path):
    if not os.path.isfile(os.path.join(ROOT, "native", "build",
                                       "librabit_tpu_core.so")):
        pytest.skip("the JAX package's native core is not built")
    refs = _launch("rabit_tpu",
                   [os.path.join(ROOT, "tests", "workers",
                                 "torch_boost_reference_worker.py")], [],
                   tmp_path, "ref-rank")
    assert len(refs) == 4 and all(r["trees"] == refs[0]["trees"]
                                  for r in refs)
    want, got = refs[0]["trees"], clean[0]["trees"]
    assert len(want) == len(got) == 10
    assert [t[:2] for t in got] == [t[:2] for t in want]
    np.testing.assert_allclose([t[2:] for t in got], [t[2:] for t in want],
                               rtol=0, atol=WEIGHT_ATOL)
