"""The comparison that decides ``correct``.

After the window has closed, each rank holds the host copies of the
histograms it received for the calls of two whole trees, drawn from the
seed: every depth, the root included, one tree a gradient set. The
reference (``reference.py``) works each of those nodes' global histogram
out again in float64 from the benchmark's own inputs: this rank's shard,
and every other rank's shard made again from the seed.

The number compared, ``hist_rel_err``, is the widest gap over those calls,
their bins and both sums, between the port's value and the reference's,
as a share of the sum of the magnitudes that went into that bin. A bin
that nothing went into must read exactly 0. The limit sits between what
sound runs of the port read and what its bf16 path reads (the control):
PERF.md gives both readings.
"""

from __future__ import annotations

from typing import Callable, Dict, Hashable, List, Tuple

import torch

from . import reference
from .data import Shard

HIST_REL_ERR_LIMIT = 6e-6

BLOCK_ENTRIES = 1 << 26         # entries a block of the reference

Node = Tuple[Hashable, int, int, int]   # (key, first row, end row, set)


def rel_err(out: torch.Tensor, sums: torch.Tensor, mags: torch.Tensor
            ) -> float:
    """The widest gap between ``out`` and ``sums`` as a share of ``mags``.
    A gap where ``mags`` is 0, and a NaN, read as the largest float, so
    that the result line stays plain JSON."""
    most = torch.finfo(torch.float64).max
    gap = (out.double() - sums).abs()
    share = gap / mags.clamp_min(torch.finfo(torch.float64).tiny)
    share = torch.where(gap == 0, torch.zeros_like(share), share)
    return float(torch.nan_to_num(share, nan=most, posinf=most).max())


def node_references(nodes: List[Node], shard_of: Callable[[int], Shard],
                    ranks: int) -> Dict[Hashable, Tuple[torch.Tensor,
                                                         torch.Tensor]]:
    """Each node's global (sums, magnitudes) over the shards of all
    ``ranks``, taken one shard at a time and in blocks of entries."""
    acc: Dict[Hashable, Tuple[torch.Tensor, torch.Tensor]] = {}
    for r in range(ranks):
        shard = shard_of(r)
        f, nbins = shard.features, shard.nbins
        for key, s, e, gset in nodes:
            for lo in range(s * f, e * f, BLOCK_ENTRIES):
                hi = min(lo + BLOCK_ENTRIES, e * f)
                sums, mags = reference.node_histogram(
                    shard.bins[lo:hi], shard.grad[gset][lo:hi],
                    shard.hess[gset][lo:hi], nbins)
                if key in acc:
                    acc[key][0].add_(sums)
                    acc[key][1].add_(mags)
                else:
                    acc[key] = (sums, mags)
        del shard
    return acc


def compare(kept: Dict[Hashable, torch.Tensor], nodes: List[Node],
            shard_of: Callable[[int], Shard], ranks: int,
            device: torch.device) -> Tuple[float, int]:
    """(hist_rel_err over the nodes, nodes over the limit)."""
    refs = node_references(nodes, shard_of, ranks)
    worst, failed = 0.0, 0
    for key, *_ in nodes:
        if key not in kept:
            raise RuntimeError(f"no output was kept for node {key}")
        err = rel_err(kept[key].to(device), *refs[key])
        worst = max(worst, err)
        failed += not err <= HIST_REL_ERR_LIMIT
    return worst, failed
