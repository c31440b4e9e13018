"""A rank's shard of a dataset, made on the device from the run's seed.

A dataset is dense: ``rows`` rows of ``features`` features, each quantized
into ``max_bin`` buckets, as XGBoost's ``hist`` method does. One entry is
one (row, feature), at index ``row * features + feature``, and goes into
bin ``feature * max_bin + bucket``. The port takes a gradient pair an
entry, so a row's pair is repeated over its features.

Buckets are uniform in [0, max_bin), gradients normal and hessians uniform
in [0, 1): the draws of the port's ``tools/__init__.py::gen_pool``. Each
gradient set is one boosting round's; trees take the sets in turn.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List

import torch


@dataclass
class Shard:
    bins: torch.Tensor          # int32 [rows * features]
    grad: List[torch.Tensor]    # f32 [rows * features], one a gradient set
    hess: List[torch.Tensor]
    rows: int
    features: int
    nbins: int


def rows_per_rank(config: dict, ranks: int) -> int:
    """Rows are sharded evenly over the ranks, as distributed XGBoost
    shards them."""
    rows = int(config["rows"])
    if rows % ranks:
        raise ValueError(f"{rows} rows do not shard evenly over {ranks} ranks")
    return rows // ranks


def shard_seed(seed: int, rank: int) -> int:
    """The generator's seed of one rank's shard: distinct for every (seed,
    rank) with rank < 1024, whatever the size of the run's seed."""
    return (int(seed) * 1024 + rank) % (1 << 63)


def make_shard(config: dict, seed: int, rank: int, ranks: int,
               grad_sets: int, device: torch.device) -> Shard:
    """Rank ``rank``'s shard of ``ranks``: the same tensors for the same
    arguments, on any card of one model (the generator is the device's)."""
    rows = rows_per_rank(config, ranks)
    feats, max_bin = int(config["features"]), int(config["max_bin"])
    gen = torch.Generator(device=device).manual_seed(shard_seed(seed, rank))
    bins = torch.randint(0, max_bin, (rows, feats), generator=gen,
                         dtype=torch.int32, device=device)
    bins += torch.arange(0, feats * max_bin, max_bin, dtype=torch.int32,
                         device=device)
    grad, hess = [], []
    for _ in range(grad_sets):
        g = torch.randn(rows, generator=gen, device=device)
        h = torch.rand(rows, generator=gen, device=device)
        grad.append(g.repeat_interleave(feats))
        hess.append(h.repeat_interleave(feats))
    return Shard(bins.reshape(-1), grad, hess, rows, feats, feats * max_bin)
