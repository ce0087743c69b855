"""Exhaustive scoring oracle.

Ground truth for rank-safety tests and for the paper's RBO-vs-exhaustive
effectiveness surrogate (§5.4). Pure numpy on the host — deliberately
independent of the device engine so it can falsify it.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.clustered_index import ClusteredIndex

__all__ = ["exhaustive_scores", "exhaustive_topk"]


def exhaustive_scores(index: ClusteredIndex, q_terms: np.ndarray) -> np.ndarray:
    """Integer score of every document for the query (quantized impacts)."""
    acc = np.zeros(index.n_docs, dtype=np.int64)
    for t in np.asarray(q_terms).reshape(-1):
        if t < 0:
            continue
        s, e = index.ptr[int(t)], index.ptr[int(t) + 1]
        np.add.at(acc, index.docs[s:e], index.impacts[s:e])
    return acc


def exhaustive_topk(
    index: ClusteredIndex, q_terms: np.ndarray, k: int
) -> tuple[np.ndarray, np.ndarray]:
    """Top-k (docids, scores), ties broken by ascending docid."""
    acc = exhaustive_scores(index, q_terms)
    k = min(k, acc.shape[0])
    # Full lexsort: boundary ties must resolve by ascending docid (argpartition
    # would pick an arbitrary subset of tied docs).
    order = np.lexsort((np.arange(acc.shape[0]), -acc))[:k]
    keep = acc[order] > 0
    return order[keep].astype(np.int64), acc[order][keep]
