"""The plain reference of a node histogram, summed in float64.

It takes the entries the benchmark made (bins, grad, hess), never anything
the port made, and returns each bin's sums and the sums of the magnitudes
that went into them, which scale the comparison in ``check.py``. Plain
PyTorch on whatever device the tensors are on; it imports nothing of the
port.
"""

from __future__ import annotations

from typing import Tuple

import torch


def node_histogram(bins: torch.Tensor, grad: torch.Tensor,
                   hess: torch.Tensor, nbins: int
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(sums, magnitudes), both float64 [nbins, 2]: column 0 the
    gradients, column 1 the hessians, over the entries whose bin lies in
    [0, nbins)."""
    keep = (bins >= 0) & (bins < nbins)
    idx = bins[keep].long()
    g = grad[keep].double()
    h = hess[keep].double()

    def total(w: torch.Tensor) -> torch.Tensor:
        return torch.bincount(idx, weights=w, minlength=nbins)

    sums = torch.stack([total(g), total(h)], dim=1)
    mags = torch.stack([total(g.abs()), total(h.abs())], dim=1)
    return sums, mags
