"""BM25 term-document contributions (paper §4.3: k1=0.4, b=0.9).

The first-stage ranker is additive over query terms:
    S(Q, d) = sum_t C(t, d)
with the BM25 contribution
    C(t, d) = idf(t) * tf * (k1 + 1) / (tf + k1 * (1 - b + b * len_d / avg_len))

All contributions are computed once at index-build time (numpy, host side)
and quantized to b-bit integer *impacts* (see quantize.py) — the engine then
works in integer space end-to-end, exactly like the paper's JASS arm, and the
PISA arm's float scores are a monotone rescaling of the same values.

Collection statistics (df, N, average document length) may be *frozen* as a
``CollectionStats`` and passed back in: incremental index extension
(DESIGN.md §10) scores appended documents against the statistics of the base
build, so existing postings keep bit-identical impacts — the classic
stale-statistics convention of updatable inverted indexes, refreshed only by
a full rebuild.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.data.synth import Corpus

__all__ = [
    "BM25Params",
    "CollectionStats",
    "bm25_contributions",
    "checked_int32",
    "collection_stats",
    "invert",
]

_INT32_MAX = np.iinfo(np.int32).max


def checked_int32(arr: np.ndarray, what: str = "values") -> np.ndarray:
    """Narrow to int32, raising instead of wrapping past 2^31-1.

    Build-time counterpart of ``serving.bucketing.saturate_bounds``: a
    docid or bound that silently wraps negative disables the engine's
    safe-termination test (``bound <= theta`` holds everywhere), so a
    corpus past the int32 docid space must fail the build loudly, not
    corrupt the index.
    """
    a = np.asarray(arr)
    if a.size and (int(a.max()) > _INT32_MAX or int(a.min()) < 0):
        raise OverflowError(
            f"{what} outside the int32 range [0, {_INT32_MAX}] "
            f"(min {int(a.min())}, max {int(a.max())}) — the document-"
            f"ordered index addresses docids/bounds in int32"
        )
    return a.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class BM25Params:
    k1: float = 0.4
    b: float = 0.9


@dataclasses.dataclass(frozen=True)
class CollectionStats:
    """Frozen collection-level BM25 statistics.

    Captured at base-build time and carried through every incremental
    extension: idf and the length normalization of appended postings use
    *these* values, never the extended collection's, which is what keeps a
    compacted chain bitwise-equal to one fresh build at the same stats
    (DESIGN.md §10).
    """

    n_docs: int
    avg_doc_len: float
    df: np.ndarray  # [n_terms] int64 document frequency per term


def collection_stats(corpus: Corpus) -> CollectionStats:
    """Compute ``CollectionStats`` from a corpus (the base-build path)."""
    df = np.zeros(corpus.n_terms, dtype=np.int64)
    np.add.at(df, corpus.doc_terms, 1)
    return CollectionStats(
        n_docs=int(corpus.n_docs),
        avg_doc_len=(
            float(max(corpus.doc_lens.astype(np.float64).mean(), 1.0))
            if corpus.n_docs
            else 1.0
        ),
        df=df,
    )


@dataclasses.dataclass(frozen=True)
class Postings:
    """Document-ordered postings in CSR-by-term layout."""

    n_terms: int
    n_docs: int
    ptr: np.ndarray  # [n_terms+1] int64
    docs: np.ndarray  # [nnz] int32, ascending within each term
    scores: np.ndarray  # [nnz] float32, BM25 contribution C(t, d)

    @property
    def nnz(self) -> int:
        return int(self.docs.shape[0])

    def term_slice(self, t: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.ptr[t], self.ptr[t + 1]
        return self.docs[s:e], self.scores[s:e]


def bm25_contributions(
    corpus: Corpus,
    params: BM25Params = BM25Params(),
    stats: CollectionStats | None = None,
) -> np.ndarray:
    """Per-posting BM25 contribution aligned with corpus CSR order.

    ``stats`` substitutes frozen collection statistics (df, N, avg length)
    for the ones this corpus would yield — document lengths still come from
    the corpus itself. Incremental extension scores a delta corpus this way.
    """
    doc_lens = corpus.doc_lens.astype(np.float64)
    if stats is None:
        stats = collection_stats(corpus)
    avg_len = stats.avg_doc_len
    df = np.asarray(stats.df, dtype=np.int64)
    if df.shape != (corpus.n_terms,):
        raise ValueError(
            f"stats.df has shape {df.shape}, corpus has {corpus.n_terms} terms"
        )
    # Lucene/Anserini-style non-negative idf.
    idf = np.log(1.0 + (stats.n_docs - df + 0.5) / (df + 0.5))

    doc_of_posting = np.repeat(np.arange(corpus.n_docs), np.diff(corpus.doc_ptr))
    tf = corpus.doc_tfs.astype(np.float64)
    norm = params.k1 * (1.0 - params.b + params.b * doc_lens[doc_of_posting] / avg_len)
    contrib = idf[corpus.doc_terms] * tf * (params.k1 + 1.0) / (tf + norm)
    return contrib.astype(np.float32)


def invert(
    corpus: Corpus,
    doc_order: np.ndarray | None = None,
    params: BM25Params = BM25Params(),
    stats: CollectionStats | None = None,
) -> Postings:
    """Build document-ordered postings under a docid permutation.

    ``doc_order[new_id] = old_id`` — i.e. the permutation produced by the
    reordering stage. Postings come out sorted by (term, new docid).
    ``stats`` scores against frozen collection statistics (see
    :func:`bm25_contributions`).
    """
    contrib = bm25_contributions(corpus, params, stats=stats)
    doc_of_posting = np.repeat(
        np.arange(corpus.n_docs), np.diff(corpus.doc_ptr)
    ).astype(np.int64)
    if doc_order is None:
        new_ids = doc_of_posting
    else:
        inv = np.empty(corpus.n_docs, dtype=np.int64)
        inv[doc_order] = np.arange(corpus.n_docs)
        new_ids = inv[doc_of_posting]

    terms = corpus.doc_terms.astype(np.int64)
    key = terms * corpus.n_docs + new_ids
    order = np.argsort(key, kind="stable")
    sorted_terms = terms[order]
    ptr = np.zeros(corpus.n_terms + 1, dtype=np.int64)
    counts = np.bincount(sorted_terms, minlength=corpus.n_terms)
    ptr[1:] = np.cumsum(counts)
    return Postings(
        n_terms=corpus.n_terms,
        n_docs=corpus.n_docs,
        ptr=ptr,
        docs=checked_int32(new_ids[order], "postings docids"),
        scores=contrib[order],
    )
