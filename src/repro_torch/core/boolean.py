"""Boolean conjunction over the clustered index (paper §3, closing remark).

"The modified index structure can still support traditional querying modes,
such as efficient Boolean conjunction." — the cluster-skipping structure
helps conjunctions directly: a range where ANY query term has no postings
(U[t, r] == 0) cannot contain a conjunctive match and is skipped without
touching postings; within surviving ranges, sorted-docid intersection runs
per-range (cache-local, like the scorer).

The counterpart of the JAX package's ``core/boolean.py`` (numpy, copied).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.clustered_index import ClusteredIndex

__all__ = ["conjunctive_query"]


@dataclasses.dataclass
class BooleanResult:
    doc_ids: np.ndarray
    ranges_skipped: int
    ranges_visited: int
    postings_touched: int


def conjunctive_query(index: ClusteredIndex, q_terms) -> BooleanResult:
    """Docids containing ALL query terms, via range-skipped intersection."""
    terms = [int(t) for t in np.asarray(q_terms).reshape(-1) if t >= 0]
    if not terms:
        return BooleanResult(np.empty(0, np.int64), 0, 0, 0)

    # Range skip: conjunctions need every term present in the range.
    present = index.bounds_dense[terms] > 0  # [|q|, R]
    survivors = np.nonzero(present.all(axis=0))[0]
    skipped = index.n_ranges - survivors.size

    out: list[np.ndarray] = []
    touched = 0
    range_of = None
    for r in survivors:
        lo, hi = int(index.range_starts[r]), int(index.range_ends[r])
        cur: np.ndarray | None = None
        for t in terms:
            s, e = index.ptr[t], index.ptr[t + 1]
            d = index.docs[s:e]
            # SeekGEQ both ways: binary search the range's docid window.
            a = np.searchsorted(d, lo, side="left")
            b = np.searchsorted(d, hi, side="left")
            seg = d[a:b]
            touched += seg.shape[0]
            cur = seg if cur is None else np.intersect1d(cur, seg, assume_unique=True)
            if cur.size == 0:
                break
        if cur is not None and cur.size:
            out.append(cur.astype(np.int64))
    del range_of
    ids = np.concatenate(out) if out else np.empty(0, np.int64)
    return BooleanResult(
        doc_ids=np.sort(ids),
        ranges_skipped=int(skipped),
        ranges_visited=int(survivors.size),
        postings_touched=int(touched),
    )
