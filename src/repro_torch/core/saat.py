"""Impact-ordered index + score-at-a-time traversal (JASS baseline, §2.1).

Postings per term are sorted by decreasing impact into *segments* (one per
distinct impact value); query processing walks segments across all query
terms in globally non-increasing impact order, adding each segment's impact
into a document accumulator. JASS-E processes everything; JASS-A stops after
a postings budget rho, checked at segment boundaries (paper §6.1).

The counterpart of the JAX package's ``core/saat.py`` (numpy, copied: the
port keeps its own copy of what it needs). Includes the
accumulator-locality instrumentation used to explain Table 3:
the number of distinct accumulator rows (2-D accumulator of Jia et al. [27])
touched by the processed postings — reordering shrinks it, which is the
paper's stated mechanism for the SAAT speedup.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bm25 import checked_int32
from repro_torch.core.clustered_index import ClusteredIndex

__all__ = ["ImpactIndex", "build_impact_index", "saat_query"]

ACC_ROW = 512  # accumulator row (page) width for the locality metric
CACHE_LINE = 8  # int64 accumulator slots per 64-byte cache line


@dataclasses.dataclass
class ImpactIndex:
    n_docs: int
    n_terms: int
    docs: np.ndarray  # [nnz] int32 — sorted by (term, -impact, docid)
    imps: np.ndarray  # [nnz] int32
    seg_term: np.ndarray  # [S] int32
    seg_impact: np.ndarray  # [S] int32
    seg_start: np.ndarray  # [S] int64 — into docs/imps
    seg_end: np.ndarray  # [S] int64
    term_seg_ptr: np.ndarray  # [V+1] int64 — segments per term

    def space_gib(self, bits: int) -> float:
        imp_bytes = (bits + 7) // 8
        postings = self.docs.shape[0] * 4
        segs = self.seg_term.shape[0] * (4 + imp_bytes + 8)
        return (postings + segs) / 1024**3


def build_impact_index(index: ClusteredIndex) -> ImpactIndex:
    """Impact-ordered view of the same postings/quantization as ``index``."""
    V = index.n_terms
    term_of = np.repeat(np.arange(V), np.diff(index.ptr)).astype(np.int64)
    order = np.lexsort((index.docs, -index.impacts, term_of))
    docs = index.docs[order]
    imps = index.impacts[order]
    terms = term_of[order]

    # Segment boundaries where (term, impact) changes.
    change = np.ones(docs.shape[0], dtype=bool)
    if docs.shape[0] > 1:
        change[1:] = (terms[1:] != terms[:-1]) | (imps[1:] != imps[:-1])
    seg_start = np.nonzero(change)[0].astype(np.int64)
    seg_end = np.concatenate([seg_start[1:], [docs.shape[0]]]).astype(np.int64)
    seg_term = terms[seg_start].astype(np.int32)
    seg_impact = imps[seg_start].astype(np.int32)

    term_seg_ptr = np.zeros(V + 1, dtype=np.int64)
    counts = np.bincount(seg_term, minlength=V)
    term_seg_ptr[1:] = np.cumsum(counts)
    return ImpactIndex(
        n_docs=index.n_docs,
        n_terms=V,
        docs=checked_int32(docs, "impact-index docids"),
        imps=imps.astype(np.int32),
        seg_term=seg_term,
        seg_impact=seg_impact,
        seg_start=seg_start,
        seg_end=seg_end,
        term_seg_ptr=term_seg_ptr,
    )


@dataclasses.dataclass
class SaatResult:
    doc_ids: np.ndarray
    scores: np.ndarray
    postings_processed: int
    segments_processed: int
    rows_touched: int  # accumulator pages touched (ACC_ROW-wide)
    lines_touched: int  # accumulator cache lines touched (64 B)


def saat_query(
    impact_index: ImpactIndex,
    q_terms: np.ndarray,
    k: int = 10,
    rho: int | None = None,
) -> SaatResult:
    """SAAT traversal; rho = postings budget (None = exhaustive JASS-E)."""
    ii = impact_index
    segs: list[int] = []
    for t in np.asarray(q_terms).reshape(-1):
        if t < 0:
            continue
        s, e = ii.term_seg_ptr[int(t)], ii.term_seg_ptr[int(t) + 1]
        segs.extend(range(int(s), int(e)))
    if not segs:
        return SaatResult(np.empty(0, np.int64), np.empty(0, np.int64), 0, 0, 0, 0)
    segs_arr = np.asarray(segs)
    # Strictly non-increasing impact order across all query terms.
    order = segs_arr[np.argsort(-ii.seg_impact[segs_arr], kind="stable")]

    lens = (ii.seg_end[order] - ii.seg_start[order]).astype(np.int64)
    cum = np.cumsum(lens)
    if rho is None:
        n_seg = order.shape[0]
    else:
        # Process whole segments until the budget is crossed (>= 1 segment).
        n_seg = int(np.searchsorted(cum, rho, side="left") + 1)
        n_seg = min(n_seg, order.shape[0])

    acc = np.zeros(ii.n_docs, dtype=np.int64)
    touched: set[int] = set()
    lines: set[int] = set()
    postings = 0
    for s in order[:n_seg]:
        lo, hi = int(ii.seg_start[s]), int(ii.seg_end[s])
        d = ii.docs[lo:hi]
        acc[d] += int(ii.seg_impact[s])
        postings += hi - lo
        # host numpy arrays (SAAT's counters run on the host), no device
        # analysis: allow[HOSTSYNC]
        touched.update(np.unique(d // ACC_ROW).tolist())
        lines.update(np.unique(d // CACHE_LINE).tolist())  # analysis: allow[HOSTSYNC]

    kk = min(k, ii.n_docs)
    part = np.argpartition(-acc, kk - 1)[:kk]
    top = part[np.lexsort((part, -acc[part]))]
    keep = acc[top] > 0
    return SaatResult(
        doc_ids=top[keep].astype(np.int64),
        scores=acc[top][keep],
        postings_processed=postings,
        segments_processed=n_seg,
        rows_touched=len(touched),
        lines_touched=len(lines),
    )
