"""The comparison fails what it must: the control (the port's own bf16
path, the precision below the f32 the configurations state) and each fault
a histogram allreduce can have, planted under a whole run on the CPU."""

import pytest

from perfbench import control, run
from perfbench.rank import Job


def _port():
    from rabit_tpu_torch.models import histogram
    return histogram


def stale_answer():
    """A call that returns the previous call's histogram: the state left
    unchanged."""
    h = _port()
    real, last = h.distributed_histogram, []

    def fake(*args, **kw):
        out = real(*args, **kw)
        last.append(out)
        return last[-2] if len(last) > 1 else out
    h.distributed_histogram = fake


def half_the_rows():
    """Half of each call's entries left out, the rest counted twice."""
    h = _port()
    real = h.distributed_histogram

    def fake(grad, hess, bins, nbins, *args, **kw):
        n = bins.numel() // 2
        return 2 * real(grad[:n], hess[:n], bins[:n], nbins, *args, **kw)
    h.distributed_histogram = fake


def no_exchange():
    """The allreduce between the ranks left out."""
    h = _port()
    h.ring_allreduce = h.tree_allreduce = lambda x, *a, **k: x.clone()


def altered_bin():
    """One bin of each answer altered where it is produced."""
    h = _port()
    real = h.distributed_histogram

    def fake(*args, **kw):
        out = real(*args, **kw).clone()
        out[0] *= 2
        return out
    h.distributed_histogram = fake


def _line(root, workload, jobs, prelude=None):
    spec = run.load_spec(root, workload, False)
    results = [r[0] for r in run.run_world(spec, jobs, "cpu", prelude)]
    return run.result_line(spec, "cpu", results)


@pytest.mark.parametrize("workload", ["tiny.tree", "wide.tree.w2"])
def test_sound_runs_are_correct(root, workload):
    line = _line(root, workload, [Job(2 ** 31 + 3, 0.5, False)])
    assert line["correct"] is True


@pytest.mark.parametrize("workload", ["tiny.tree", "tiny.stumps",
                                      "wide.tree.w2"])
def test_the_control_is_not_correct(root, workload):
    line = _line(root, workload, [Job(2 ** 31 + 5, 0.5, False, "fast")])
    assert line["correct"] is False
    c = line["check"]["hist_rel_err"]
    assert c["value"] > c["limit"]


def test_control_readings_separate(root):
    spec = run.load_spec(root, "tiny.tree", False)
    got = control.readings(spec, [1, 2], [3, 4], 0.3, "cpu")
    assert [(s, p) for s, p, _ in got] == [(1, "high"), (2, "high"),
                                            (3, "fast"), (4, "fast")]
    program = max(e for _, p, e in got if p == "high")
    ctl = min(e for _, p, e in got if p == "fast")
    assert program < 3 * program < ctl


@pytest.mark.parametrize("fault", [stale_answer, half_the_rows, no_exchange,
                                   altered_bin])
def test_a_planted_fault_is_not_correct(root, fault):
    line = _line(root, "wide.tree.w2", [Job(2 ** 31 + 7, 0.5, False)],
                 prelude=fault)
    assert line["correct"] is False
    assert line["failed"] > 0


@pytest.mark.cuda
def test_the_control_fails_on_the_card(tmp_path):
    """The control at test size on the card (the cell-size readings are
    ``python3 -m perfbench.control``'s)."""
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from perfbench_testroot import make_root
    root = make_root(tmp_path / "checkout")
    spec = run.load_spec(root, "tiny.tree", False)
    got = control.readings(spec, [11, 12, 13], [21, 22, 23], 0.3, "cuda")
    program = max(e for _, p, e in got if p == "high")
    ctl = min(e for _, p, e in got if p == "fast")
    assert program <= run.check.HIST_REL_ERR_LIMIT < ctl
