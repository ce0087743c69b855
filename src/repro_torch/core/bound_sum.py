"""BoundSum range selection (paper §3 "Range Selection"), on tensors.

For query q and ranges 1..R, score(r) = sum_{t in q} U[t, r]; ranges are
processed in decreasing score order. The whole computation is an R-vector
gather-sum per term plus one sort — cheap enough to run inline at query
time, and its cost is included in every measurement, as in the paper.

The counterpart of the JAX package's jitted ``core/bound_sum.py``: int32
sums (wrapping as the reference's int32 sum does) and a stable sort, so
tied ranges keep ascending range id. Runs on the tensors' device.
"""

from __future__ import annotations

import torch

__all__ = ["bound_sums", "range_order"]


def bound_sums(bounds_dense: torch.Tensor, q_terms: torch.Tensor) -> torch.Tensor:
    """Sum of per-range upper bounds over query terms. q_terms -1-padded."""
    q_terms = torch.as_tensor(q_terms, device=bounds_dense.device)
    valid = (q_terms >= 0)[:, None]
    rows = bounds_dense[q_terms.clamp(0, bounds_dense.shape[0] - 1)]
    return torch.where(valid, rows, 0).sum(dim=0).to(torch.int32)


def range_order(bsums: torch.Tensor, descending: bool = True):
    """Sorted range ids and their bounds (ties broken by range id)."""
    key = -bsums if descending else bsums
    order = torch.sort(key, stable=True).indices.to(torch.int32)
    return order, bsums[order]
