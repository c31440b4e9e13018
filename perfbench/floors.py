"""The card's peaks and the least time each piece of a tree's work needs.

Peaks of one NVIDIA H100 SXM5 80GB, from NVIDIA's H100 Tensor Core GPU
data sheet, at its full power limit of 700 W: HBM3 at 3.35 TB/s, and
NVLink 4 at 900 GB/s a card, 450 GB/s each way. A card set below 700 W
runs slower under load, so every result carries the card's power limit
(``device.power_limit``) beside the shares taken against these peaks.

The work is bytes-bound: a histogram call does two additions an entry
for 12 bytes read, far below the card's operations a byte. So the floors
are bytes over bandwidth.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
NVLINK_BYTES_PER_S = 450e9      # one direction of one card's NVLink

ENTRY_BYTES = 12                # int32 bin, f32 grad, f32 hess
BIN_BYTES = 8                   # f32 (sum grad, sum hess)


def hist_bytes(entries: int, calls: int, nbins: int) -> int:
    """Bytes the histogram calls must move: each entry's input read once,
    as the port's API takes it, and each call's output written once."""
    return ENTRY_BYTES * entries + BIN_BYTES * nbins * calls


def hist_floor_s(entries: int, calls: int, nbins: int) -> float:
    """Least device time of those calls at the HBM peak."""
    return hist_bytes(entries, calls, nbins) / HBM_BYTES_PER_S


def allreduce_bytes(calls: int, nbins: int, ranks: int) -> float:
    """Bytes each card sends over its links to allreduce ``calls``
    histograms: 2 (p - 1) / p of the payload, the least any schedule
    moves; none at one rank."""
    return 2.0 * (ranks - 1) / ranks * BIN_BYTES * nbins * calls


def allreduce_floor_s(calls: int, nbins: int, ranks: int) -> float:
    """Least link time of those allreduces at NVLink's peak."""
    return allreduce_bytes(calls, nbins, ranks) / NVLINK_BYTES_PER_S


def tree_floor_s(entries: int, calls: int, nbins: int, ranks: int) -> float:
    """Least time of the whole work: the calls' builds, then their
    allreduces."""
    return (hist_floor_s(entries, calls, nbins)
            + allreduce_floor_s(calls, nbins, ranks))


def share_pct(floor_s: float, seconds: float):
    """``floor_s`` as a percentage of the time taken; None where no time
    was measured."""
    return 100.0 * floor_s / seconds if seconds > 0 else None
