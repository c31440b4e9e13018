"""The benchmark's arithmetic on the CPU: the tree mix's node sequence,
the bytes floors and shares, the plain reference and the comparison."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from perfbench import check, data, floors, nodes, reference, trace
from perfbench.reading import Reading, Trace
from perfbench.run import read_metric

ROOT = Path(__file__).resolve().parents[2]
TRAFFIC = ROOT / "perfbench" / "traffic"
CONFIGS = ROOT / "perfbench" / "configs"


def _mix(name):
    return json.loads((TRAFFIC / f"{name}.json").read_text())


def _config(name):
    return json.loads((CONFIGS / f"{name}.json").read_text())


@pytest.mark.parametrize("config,ranks", [("higgs", 1), ("epsilon", 1),
                                          ("epsilon", 4), ("higgs", 4)])
def test_tree_mix_makes_32_contiguous_aligned_calls(config, ranks):
    cfg = _config(config)
    rows = data.rows_per_rank(cfg, ranks)
    shapes = nodes.tree_shapes(_mix("tree_depthwise"), rows)
    assert nodes.calls_per_tree(shapes) == 32
    for tree in shapes:
        assert [len(level) for level in tree] == [1, 1, 2, 4, 8, 16]
        assert tree[0] == [(0, rows)]
        for s, e in (c for level in tree for c in level):
            assert 0 <= s < e <= rows
            # 4-byte items from a whole row of F entries, F % 4 == 0
            assert (s * cfg["features"] * 4) % 16 == 0
        # each level's calls are disjoint slices
        for level in tree:
            spans = sorted(level)
            assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))


def test_tree_mix_children_partition_and_smaller():
    mix = _mix("tree_depthwise")
    lo, hi = mix["child_fraction"]
    rows = 400_000
    for tree in nodes.tree_shapes(mix, rows):
        # each call of level d+1 lies inside one node of level d's
        # partition and takes at most half of it
        parents = [(0, rows)]
        for level in tree[1:]:
            children = []
            for call in level:
                p = next(p for p in parents if p[0] <= call[0]
                         and call[1] <= p[1])
                n, k = p[1] - p[0], call[1] - call[0]
                assert k <= n / 2 + 1
                assert k >= min(lo * n - 1, n / 2)
                assert call[0] == p[0] or call[1] == p[1]
                other = ((call[1], p[1]) if call[0] == p[0]
                         else (p[0], call[0]))
                children += [call, other]
            spans = sorted(children)    # a partition of the rows
            assert spans[0][0] == 0 and spans[-1][1] == rows
            assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
            parents = children


def test_tree_shape_is_the_same_for_every_seed():
    mix = _mix("tree_depthwise")
    a = nodes.tree_shapes(mix, 10_500_000)
    b = nodes.tree_shapes(dict(mix), 10_500_000)
    assert a == b
    # the seed only makes data; the shape takes none
    assert "seed" not in nodes.tree_shapes.__code__.co_varnames


def test_stumps_make_one_root_call():
    shapes = nodes.tree_shapes(_mix("stumps"), 1000)
    assert shapes == [[[(0, 1000)]]]
    assert nodes.calls_per_tree(shapes) == 1


def test_tree_mix_refuses_nodes_too_small_to_split():
    with pytest.raises(ValueError):
        nodes.tree_shapes(_mix("tree_depthwise"), 20)


def test_floors_of_a_hand_worked_call():
    # one HIGGS root call: 10.5M rows x 28 features into 7,168 bins
    entries, nbins = 10_500_000 * 28, 28 * 256
    assert floors.hist_bytes(entries, 1, nbins) == 12 * entries + 8 * nbins
    assert floors.hist_bytes(entries, 1, nbins) == 3_528_057_344
    floor = floors.hist_floor_s(entries, 1, nbins)
    assert floor == pytest.approx(3_528_057_344 / 3.35e12)
    # Epsilon's call on four ranks: 2 * 3/4 of 512,000 bins x 8 B
    assert floors.allreduce_bytes(1, 512_000, 4) == 6_144_000
    assert floors.allreduce_bytes(32, 512_000, 1) == 0
    assert floors.tree_floor_s(100, 2, 512_000, 4) == pytest.approx(
        floors.hist_floor_s(100, 2, 512_000) + 2 * 6_144_000 / 450e9)
    assert floors.share_pct(floor, floor) == pytest.approx(100.0)
    assert floors.share_pct(floor, 0.0) is None


def _reading(kernel_s, window_s, ranks=1, busy_s=None):
    entries, calls, nbins = 5_000_000, 32, 7168
    trace = Trace(window_s=window_s, busy_s=busy_s or window_s,
                  device_s={"void (anonymous namespace)::histogram_kernel"
                            "<false>(int const*, float const*)": kernel_s,
                            "ncclDevKernel_SendRecv(x)": 0.001},
                  idle_s={}, calls=calls, entries=entries, trees=1.0)
    return Reading(ranks=ranks, nbins=nbins, calls_per_tree=32, setup_s=1.0,
                   window_s=window_s, calls=calls, level_ms=[1.0, 2.0],
                   issue_s=0.0032, issue_calls=32, peak_window_bytes=2 ** 30,
                   trace=trace)


def test_shares_reach_100_at_the_floor_and_never_pass_it():
    entries, calls, nbins = 5_000_000, 32, 7168
    kfloor = floors.hist_floor_s(entries, calls, nbins)
    for ranks in (1, 4):
        tfloor = floors.tree_floor_s(entries, calls, nbins, ranks)
        at = _reading(kfloor, tfloor, ranks)
        assert read_metric(ROOT, "histogram_roofline", at) == \
            pytest.approx(100.0)
        assert read_metric(ROOT, "tree_mfu_pct", at) == pytest.approx(100.0)
        for slower in (1.0001, 2.0, 37.0):
            r = _reading(kfloor * slower, tfloor * slower, ranks)
            assert read_metric(ROOT, "histogram_roofline", r) < 100.0
            assert read_metric(ROOT, "tree_mfu_pct", r) < 100.0


def test_metric_readers_on_a_hand_made_reading():
    r = _reading(0.002, 0.010, ranks=4, busy_s=0.004)
    assert read_metric(ROOT, "tree_ms", r) == pytest.approx(10.0)
    assert read_metric(ROOT, "level_p95_ms", r) == pytest.approx(1.95)
    assert read_metric(ROOT, "peak_mem_gib", r) == pytest.approx(1.0)
    assert read_metric(ROOT, "issue_us_per_call", r) == pytest.approx(100.0)
    assert read_metric(ROOT, "device_idle_pct", r) == pytest.approx(60.0)
    r.trace = None
    for name in ("histogram_roofline", "tree_mfu_pct", "device_idle_pct"):
        assert read_metric(ROOT, name, r) is None


def test_reference_matches_a_hand_summed_histogram():
    bins = torch.tensor([0, 2, 2, 3, 0, 5, -1, 4], dtype=torch.int32)
    grad = torch.tensor([1.0, -2.0, 0.5, 4.0, -1.0, 9.0, 7.0, 0.25])
    hess = torch.tensor([0.5, 0.25, 0.25, 1.0, 0.5, 2.0, 3.0, 0.125])
    sums, mags = reference.node_histogram(bins, grad, hess, 5)
    assert sums.dtype == torch.float64
    # bin 5 and bin -1 are outside [0, 5): dropped
    np.testing.assert_array_equal(sums.numpy(), [[0.0, 1.0], [0.0, 0.0],
                                                 [-1.5, 0.5], [4.0, 1.0],
                                                 [0.25, 0.125]])
    np.testing.assert_array_equal(mags[:, 0].numpy(),
                                  [2.0, 0.0, 2.5, 4.0, 0.25])
    np.testing.assert_array_equal(mags[:, 1].numpy(), sums[:, 1].numpy())


def test_rel_err_is_a_share_of_the_magnitudes():
    sums = torch.tensor([[1.0, 2.0], [0.0, 0.0]], dtype=torch.float64)
    mags = torch.tensor([[4.0, 2.0], [0.0, 0.0]], dtype=torch.float64)
    exact = torch.tensor([[1.0, 2.0], [0.0, 0.0]])
    assert check.rel_err(exact, sums, mags) == 0.0
    off = torch.tensor([[1.5, 2.0], [0.0, 0.0]])
    assert check.rel_err(off, sums, mags) == pytest.approx(0.125)
    # a bin that nothing went into must read exactly 0
    most = torch.finfo(torch.float64).max
    stray = torch.tensor([[1.0, 2.0], [0.0, 1e-30]])
    assert check.rel_err(stray, sums, mags) > 1e200
    assert check.rel_err(torch.tensor([[1.0, 2.0], [0.0, float("inf")]]),
                         sums, mags) == most
    assert check.rel_err(torch.tensor([[float("nan"), 2.0], [0.0, 0.0]]),
                         sums, mags) == most


def test_shards_are_the_seeds_and_differ_by_rank():
    cfg = {"rows": 64, "features": 4, "max_bin": 8}
    cpu = torch.device("cpu")
    a = data.make_shard(cfg, 2 ** 31 + 5, 1, 2, 2, cpu)
    b = data.make_shard(cfg, 2 ** 31 + 5, 1, 2, 2, cpu)
    c = data.make_shard(cfg, 2 ** 31 + 5, 0, 2, 2, cpu)
    assert a.rows == 32 and a.nbins == 32
    assert torch.equal(a.bins, b.bins) and torch.equal(a.grad[1], b.grad[1])
    assert not torch.equal(a.bins, c.bins)
    feature = torch.arange(a.bins.numel()) % 4
    assert torch.equal(a.bins // 8, feature.int())
    # a row's gradient pair over its features
    assert torch.equal(a.grad[0].view(32, 4), a.grad[0].view(32, 4)[:, :1]
                       .expand(32, 4))
    assert not torch.equal(a.grad[0], a.grad[1])


class _Event:
    def __init__(self, name, annotation=False):
        self._name, self._annotation = name, annotation

    def name(self):
        return self._name

    def is_user_annotation(self):
        return self._annotation


def test_only_device_work_counts_as_busy():
    for name in ("void (anonymous namespace)::histogram_kernel<false>(int)",
                 "ncclDevKernel_SendRecv(ncclDevKernelArgsStorage<4096ul>)",
                 "Memcpy DtoH (Device -> Pinned)"):
        assert trace.device_work(_Event(name))
    for name in ("nccl:coalesced", "nccl:all_reduce", "window", "issue.L3",
                 "copy_out.L0", "sync.L5"):
        assert not trace.device_work(_Event(name))
    assert not trace.device_work(_Event("anything", annotation=True))
