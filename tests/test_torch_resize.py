"""In-process resize through the port, cluster level: a world of 3 under
the port's launcher with ``elastic=True`` goes 3 -> 2 -> 3 and no worker
process ever exits (``tests/test_native_resize_cluster.py``'s verdicts):

* the port's worker (``tests/workers/torch_resize_worker.py``) on the
  robust engine with the torch data plane over gloo: one rank evicts
  itself, the survivors run ``rabit_tpu_torch.resize("recover")`` and
  stream MID rounds at world 2, the same process comes back with
  ``resize("join")`` and every rank streams POST rounds at world 3. Each
  round's int64 sum and histogram (the kernel's plain version on the
  CPU) are exact, POST is CRC-identical to a fixed-world run,
  ``total_attempts == 0``, and the data plane formed again at every new
  epoch on the same device;
* the JAX package's own ``tests/workers/resize_worker.py`` (rabit_tpu on
  its native engine) served by the port's launcher and tracker, with the
  same verdicts and the same CRCs;
* the port's ``tests/workers/torch_elastic_worker.py``: a control-plane
  kill and re-admit with checkpoints bit-exact across ranks and the
  resize, the joiner seeded by ``adopt_latest_from_peers``.
"""

import ast
import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest

from rabit_tpu_torch.engine import _native_build
from rabit_tpu_torch.tracker.launch import launch

ROOT = Path(__file__).resolve().parents[1]
WORKERS = ROOT / "tests" / "workers"
JAX_LIB = ROOT / "native" / "build" / "librabit_tpu_core.so"
N = 3
HIST = {"RESIZE_HIST_ROWS": "4096", "RESIZE_HIST_BINS": "64"}
# the port's launcher gives the port's workers an ephemeral link listener
# (RABIT_SLAVE_PORT=0), which the JAX package's engine does not read: its
# worker takes the argument, or workers started together could bind one
# default port twice, and a relaunch would break ``total_attempts == 0``
JAX_PORT0 = "rabit_slave_port=0"


@pytest.fixture(scope="module", autouse=True)
def native_core():
    _native_build.build()


def _run(worker, out_dir, env_extra, args=()):
    cmd = [sys.executable, str(WORKERS / worker), *args]
    stats = {}
    env = {"RESIZE_OUT": str(out_dir), "KILL_TASK": "1",
           "RESIZE_DEADLINE": "60", **env_extra}
    rc = launch(N, cmd, max_attempts=0, timeout=90, quiet=True,
                stats=stats, env=env, elastic=True)
    return rc, stats


def _rounds(out_dir, task, tag):
    lines = (out_dir / f"r{task}.log").read_text().splitlines()
    out = []
    for ln in lines:
        m = re.match(rf"{tag} round=(\d+) world=(\d+) crc=([0-9a-f]{{8}})$",
                     ln)
        if m:
            out.append((int(m.group(1)), int(m.group(2)), m.group(3)))
    return lines, out


def _check_resize(base, rsz, stats):
    """The verdicts of tests/test_native_resize_cluster.py at world N."""
    assert stats["total_attempts"] == 0, stats
    assert stats["readmissions"] == 0, stats
    doc = stats["membership"]
    assert doc["world"] == N and doc["elastic"], doc
    assert doc["evicted"] == [] and doc["joining"] == [], doc
    assert doc["epoch"] == 3, doc         # formed -> shrunk -> regrown
    mids = 0
    for t in range(N):
        lines, pre = _rounds(rsz, t, "pre")
        _, post = _rounds(rsz, t, "post")
        assert [(n, w) for n, w, _ in pre] == [(n, N) for n in range(5)]
        assert [(n, w) for n, w, _ in post] == \
            [(n, N) for n in range(10, 15)], (t, lines)
        assert pre == _rounds(base, t, "pre")[1], f"task {t} pre diverged"
        assert post == _rounds(base, t, "post")[1], \
            f"task {t} post diverged"
        assert "done" in lines, (t, lines)
        _, mid = _rounds(rsz, t, "mid")
        if mid:
            assert [(n, w) for n, w, _ in mid] == \
                [(n, N - 1) for n in range(5, 8)], (t, mid)
            mids += 1
    assert mids == N - 1, "every survivor must stream the shrunk world"
    victim = (rsz / "r1.log").read_text().splitlines()
    assert "evicted self (process alive)" in victim
    assert any(re.match(rf"rejoined rank=\d+ world={N}$", ln)
               for ln in victim), victim
    return {t: _rounds(rsz, t, "post")[1] for t in range(N)}


def test_port_worker_resizes_in_process_over_the_torch_dataplane(tmp_path):
    base, rsz = tmp_path / "base", tmp_path / "resize"
    base.mkdir()
    rsz.mkdir()
    args = ["rabit_device=cpu", "rabit_dataplane_minbytes=0",
            "rabit_telemetry=1"]
    rc, stats = _run("torch_resize_worker.py", base, HIST, args)
    assert rc == 0 and stats["total_attempts"] == 0, stats
    rc, stats = _run("torch_resize_worker.py", rsz,
                     dict(HIST, RESIZE_ENABLE="1"), args)
    assert rc == 0
    _check_resize(base, rsz, stats)
    # every rank kept the same device; a new world at every new epoch,
    # each world's formation recorded as a recovery.world_reform span
    for t in range(N):
        doc = json.loads((rsz / f"r{t}.json").read_text())
        b = json.loads((base / f"r{t}.json").read_text())
        assert doc["backend"] == "gloo" and doc["epoch"] == 3
        assert {d["dataplane"] for d in doc["devices"]} == {"cpu"}
        epochs = [s["epoch"] for s in doc["world_reform"]]
        assert epochs == ([1, 3] if t == 1 else [1, 2, 3]), (t, doc)
        assert doc["formations"] == len(epochs)
        hist = [(r["tag"], r["round"], r["hist_crc"]) for r in doc["rounds"]]
        assert len(hist) == (10 if t == 1 else 13)
        post = [r for r in hist if r[0] == "post"]
        assert post == [(r["tag"], r["round"], r["hist_crc"])
                        for r in b["rounds"] if r["tag"] == "post"]
        assert None not in {r[2] for r in hist}


def test_port_launcher_and_tracker_serve_the_jax_resize_worker(tmp_path):
    if not JAX_LIB.is_file():
        pytest.skip("the JAX package's native core is not built")
    base, rsz = tmp_path / "base", tmp_path / "resize"
    base.mkdir()
    rsz.mkdir()
    rc, stats = _run("resize_worker.py", base, {}, [JAX_PORT0])
    assert rc == 0 and stats["total_attempts"] == 0, stats
    rc, stats = _run("resize_worker.py", rsz, {"RESIZE_ENABLE": "1"},
                     [JAX_PORT0])
    assert rc == 0
    post = _check_resize(base, rsz, stats)
    # the JAX worker's rounds are the port worker's: the same CRCs
    assert {p[2] for p in post[0]} == {"552fe2a2", "73cc91b0", "d5a6cf9b",
                                       "1da329c8", "73d8c936"}


def test_kill_and_readmit_keeps_checkpoints_bit_exact(tmp_path,
                                                      monkeypatch):
    from rabit_tpu_torch.engine.ckpt_store import CheckpointStore
    out = tmp_path
    for k, v in {"ELASTIC_OUT": str(out), "KILL_TASK": "1",
                 "ELASTIC_TARGET": "4", "ELASTIC_DEADLINE": "60"}.items():
        monkeypatch.setenv(k, v)
    stats = {}
    rc = launch(4, [sys.executable, str(WORKERS / "torch_elastic_worker.py")],
                max_attempts=0, timeout=90, quiet=True, stats=stats,
                elastic=True)
    assert rc == 0
    # the launcher saw the death as a re-admission, not a fault
    assert stats["readmissions"] == 1, stats
    doc = stats["membership"]
    assert doc["elastic"] and doc["world"] == 4, doc
    assert doc["evicted"] == [] and doc["joining"] == [], doc
    for t in (0, 2, 3):
        lines = (out / f"r{t}.log").read_text().splitlines()
        worlds = [(int(ln.split("world=")[1].split()[0]),
                   int(ln.split("epoch=")[1].split()[0]))
                  for ln in lines if "world=" in ln]
        assert worlds == [(4, 1), (3, 2), (4, 3)], (t, lines)
    victim = (out / "r1.log").read_text().splitlines()
    assert "dying" in victim
    assert any("rejoined" in ln and "world=4" in ln and "epoch=3" in ln
               for ln in victim), victim
    assert "adopted v1" in victim, victim
    v1 = json.dumps({"epoch": 2, "world": 3}, sort_keys=True).encode()
    v2 = json.dumps({"epoch": 3, "world": 4}, sort_keys=True).encode()
    for r in range(4):
        st = CheckpointStore(str(out / "ckpt"), rank=r, keep=2)
        assert st.load(1) == (v1, b""), f"rank {r} v1 differs"
        assert st.load(2) == (v2, b""), f"rank {r} v2 differs"


def test_new_module_and_workers_import_neither_jax_nor_rabit_tpu():
    """The membership module in a fresh interpreter where ``jax`` and
    ``rabit_tpu`` cannot be imported, and the new workers' imports."""
    code = ("import sys\n"
            "class Block:\n"
            "    def find_spec(self, name, path, target=None):\n"
            "        if name.split('.')[0] in ('jax', 'jaxlib', "
            "'rabit_tpu'):\n"
            "            raise ImportError(name)\n"
            "sys.meta_path.insert(0, Block())\n"
            "import rabit_tpu_torch.tracker.membership\n"
            "import rabit_tpu_torch.tracker.launch\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = str(ROOT)
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    for worker in ("torch_resize_worker.py", "torch_elastic_worker.py"):
        tree = ast.parse((WORKERS / worker).read_text())
        names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
                 for a in n.names]
        names += [n.module or "" for n in ast.walk(tree)
                  if isinstance(n, ast.ImportFrom)]
        assert not [n for n in names
                    if n.split(".")[0] in ("jax", "jaxlib", "rabit_tpu")]
