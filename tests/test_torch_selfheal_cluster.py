"""The self-healing data plane under the port's launcher: the five
scenarios of ``tests/test_selfheal_cluster.py`` with
``tests/workers/torch_selfheal_worker.py``, 4 native-engine processes of
``rabit_tpu_torch`` with CRC-framed collectives (``rabit_frame_crc=1``)
behind the launcher's chaos link proxies, each rank's histogram by the
port's wrapper on the CPU (``rabit_device=cpu``, 2^14 rows x 256 bins).

Seeded ``bitflip`` corruption is rejected hop-local and retransmitted, a
link RST is repaired in place by resurrection, and each run proves it the
strong way: ``total_attempts == 0`` (no process exited), no eviction, the
fault-free run's epoch, and every rank's sum, bcast and hist streams bit
for bit the fault-free framed run's. The sum and bcast CRCs are also held
to the JAX worker's formulas, computed here in numpy, and the hist CRCs to
numpy's exact histogram."""

import os
import re
import sys
import zlib

import numpy as np
import pytest

from rabit_tpu_torch.tracker.launch import launch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "workers", "torch_selfheal_worker.py")

N = 4
N_SUM, N_BCAST, SUM_COUNT = 6, 2, 65536       # the JAX worker's rounds
HIST_ROUNDS, HIST_ROWS, HIST_BINS = 2, 1 << 14, 256
HIST_SEED = 17                                  # the worker's
FRAMED = ["rabit_frame_crc=1"]
LINK = {"bitflip": {"kind": "bitflip", "after_bytes": 65536,
                    "max_times": 2, "target": "link"},
        "reset": {"kind": "reset", "after_bytes": 65536, "max_times": 1,
                  "target": "link"}}
# tests/test_selfheal_cluster.py's schedules and the counters each needs
SCENARIOS = {
    "bitflip": ({"seed": 13, "rules": [LINK["bitflip"]]},
                {"recovery.frame_reject"}),
    "reset": ({"seed": 17, "rules": [LINK["reset"]]},
              {"recovery.link_resurrect"}),
    "combined": ({"seed": 23, "rules": [
        LINK["bitflip"], dict(LINK["reset"], after_bytes=131072)]},
        {"recovery.frame_reject", "recovery.link_resurrect"}),
}


def _run(out_dir, args, chaos=None):
    os.makedirs(out_dir, exist_ok=True)
    env = {"SELFHEAL_OUT": out_dir, "RABIT_TELEMETRY": "1",
           "HIST_ROUNDS": str(HIST_ROUNDS), "HIST_ROWS": str(HIST_ROWS),
           "HIST_BINS": str(HIST_BINS)}
    stats = {}
    rc = launch(N, [sys.executable, WORKER, "rabit_device=cpu"] + args,
                max_attempts=3, timeout=180, quiet=True, stats=stats,
                env=env, chaos=chaos)
    return rc, stats


def _rounds(out_dir, task, tag):
    with open(os.path.join(out_dir, f"r{task}.log")) as f:
        lines = f.read().splitlines()
    out = []
    for ln in lines:
        m = re.match(rf"{tag} round=(\d+) world=(\d+) "
                     r"crc=([0-9a-f]{8})$", ln)
        if m:
            out.append((int(m.group(1)), int(m.group(2)), m.group(3)))
    return lines, out


def _counter_names(stats):
    fleet = stats.get("fleet")
    if not fleet:
        return set()
    return {(c["name"], c.get("provenance", ""))
            for c in fleet.get("counters", [])}


def _want_streams():
    """Every rank's streams from the JAX worker's formulas (sum, bcast)
    and numpy's exact histogram (hist)."""
    sums = []
    for rnd in range(N_SUM):
        v = (np.arange(SUM_COUNT, dtype=np.int64) * (N * (N + 1) // 2)
             + rnd * N)
        sums.append((rnd, N, f"{zlib.crc32(v.tobytes()):08x}"))
    bcasts = []
    for rnd in range(N_BCAST):
        blob = (np.arange(32768, dtype=np.int64) + rnd).tobytes()
        bcasts.append((rnd, N, f"{zlib.crc32(blob):08x}"))
    hist = np.zeros((HIST_BINS, 2))
    for r in range(N):
        rng = np.random.default_rng([HIST_SEED, r])
        bins = rng.integers(0, HIST_BINS, HIST_ROWS, dtype=np.int32)
        grad = rng.integers(-8, 9, HIST_ROWS).astype(np.float64)
        hess = rng.integers(-8, 9, HIST_ROWS).astype(np.float64)
        hist += np.stack([np.bincount(bins, grad, HIST_BINS),
                          np.bincount(bins, hess, HIST_BINS)], 1)
    crc = f"{zlib.crc32(hist.astype(np.float32).tobytes()):08x}"
    hists = [(rnd, N, crc) for rnd in range(HIST_ROUNDS)]
    return {"sum": sums, "bcast": bcasts, "hist": hists}


WANT = _want_streams()


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """One fault-free framed run shared by every scenario: the bit-exact
    and epoch reference. Returns (log_dir, epoch)."""
    out = str(tmp_path_factory.mktemp("selfheal-baseline"))
    rc, stats = _run(out, FRAMED)
    assert rc == 0
    assert stats["total_attempts"] == 0, stats
    assert stats["membership"]["evicted"] == [], stats["membership"]
    return out, stats["membership"]["epoch"]


def _assert_streams_match(fault_dir, baseline_dir):
    """Every rank's every collective bit for bit the baseline's, and the
    formulas'."""
    for t in range(N):
        lines, _ = _rounds(fault_dir, t, "sum")
        for tag, want in WANT.items():
            _, got = _rounds(fault_dir, t, tag)
            _, base = _rounds(baseline_dir, t, tag)
            assert got == base == want, (t, tag, got, base, want)
        assert lines[-1] == "done", (t, lines)


def test_framed_baseline_streams_equal_the_formulas(baseline):
    _assert_streams_match(baseline[0], baseline[0])


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_faults_heal_in_process(tmp_path, baseline, scenario):
    """Corruption, tears or both on every link proxy: nothing exits,
    nobody is evicted, the epoch stays, and the run is indistinguishable
    from the baseline; the frame CRC's rejects or the resurrections show
    in the fleet's recovery counters."""
    chaos, needs = SCENARIOS[scenario]
    out = str(tmp_path / scenario)
    rc, stats = _run(out, FRAMED, chaos=chaos)
    assert rc == 0
    assert stats["total_attempts"] == 0, stats
    doc = stats["membership"]
    assert doc["evicted"] == [], doc
    assert doc["epoch"] == baseline[1], doc
    assert stats["chaos"]["events"] >= 1, "no fault ever fired"
    _assert_streams_match(out, baseline[0])
    names = {n for n, p in _counter_names(stats) if p == "recovery"}
    if scenario == "combined":
        assert needs & names, names
    else:
        assert needs <= names, names


def test_knobs_unset_streams_equal_the_framed_run(tmp_path, baseline):
    """With rabit_frame_crc unset the engine keeps the unframed wire (no
    frames, no CRC, no resurrection); its streams equal the framed run's:
    the frame layer changes how bytes travel, never what they compute."""
    out = str(tmp_path / "unframed")
    rc, stats = _run(out, [])
    assert rc == 0
    assert stats["total_attempts"] == 0, stats
    _assert_streams_match(out, baseline[0])
