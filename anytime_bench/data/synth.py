"""The benchmark's collection generator: a frozen copy of the port's
``repro_torch/data/synth.py`` (``make_corpus``, ``make_query_log``).

Planted-topic Zipf corpora: each topic owns a permuted Zipf distribution over
the vocabulary, so documents of one topic share vocabulary mass, and a query
drawn from a topic's informative terms concentrates its high-scoring documents
in that topic's docid range. The generator draws exactly the random numbers of
the original in the same order and returns the same arrays; the per-document
loops are replaced by sorts over whole topics, so a collection of a million
documents is made in about a minute. ``tests/test_harness.py`` holds the copy
equal to the original at a small size.

This module imports nothing of the program: the benchmark makes the
collection and hands the same arrays to the program and to the reference.
"""

from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["Corpus", "QueryLog", "make_corpus", "make_query_log", "topic_partition"]


@dataclasses.dataclass(frozen=True)
class Corpus:
    """Bag-of-words corpus in CSR layout (doc -> (term, tf))."""

    n_docs: int
    n_terms: int
    doc_ptr: np.ndarray  # [n_docs+1] int64
    doc_terms: np.ndarray  # [nnz] int32, term ids, sorted within doc
    doc_tfs: np.ndarray  # [nnz] int32
    doc_topic: np.ndarray  # [n_docs] int32, planted topic
    n_topics: int

    @property
    def nnz(self) -> int:
        return int(self.doc_terms.shape[0])


@dataclasses.dataclass(frozen=True)
class QueryLog:
    """Fixed-width padded queries (term id -1 = padding)."""

    terms: np.ndarray  # [n_queries, max_len] int32, -1 padded
    lengths: np.ndarray  # [n_queries] int32
    topic: np.ndarray  # [n_queries] int32, generating topic


def _topic_term_dists(rng, n_topics: int, n_terms: int, zipf_s: float):
    ranks = np.arange(1, n_terms + 1, dtype=np.float64)
    pmf = ranks ** (-zipf_s)
    pmf /= pmf.sum()
    n_common = max(8, n_terms // 200)  # a small shared head of function words
    perms = np.empty((n_topics, n_terms), dtype=np.int64)
    base = np.arange(n_terms)
    for t in range(n_topics):
        perm = base.copy()
        tail = perm[n_common:]
        rng.shuffle(tail)
        perm[n_common:] = tail
        perms[t] = perm
    return pmf, perms


def make_corpus(
    n_docs: int,
    n_terms: int,
    n_topics: int,
    mean_doc_len: int,
    zipf_s: float = 1.1,
    seed: int = 0,
) -> Corpus:
    """Planted-topic Zipf corpus, deterministic in all arguments."""
    rng = np.random.default_rng(seed)
    pmf, perms = _topic_term_dists(rng, n_topics, n_terms, zipf_s)
    topic_weights = rng.dirichlet(np.full(n_topics, 4.0))
    doc_topic = rng.choice(n_topics, size=n_docs, p=topic_weights).astype(np.int32)
    lens = np.maximum(
        8, rng.lognormal(np.log(mean_doc_len), 0.45, size=n_docs)
    ).astype(np.int64)

    # Per topic: the distinct (doc, term) pairs of its draws with their
    # counts, sorted by doc then term -- each doc's np.unique in the original.
    parts = []
    for t in range(n_topics):
        docs_t = np.nonzero(doc_topic == t)[0]
        if docs_t.size == 0:
            continue
        total = int(lens[docs_t].sum())
        draws = perms[t][rng.choice(n_terms, size=total, p=pmf)]
        key = np.repeat(docs_t.astype(np.int64), lens[docs_t]) * n_terms + draws
        del draws
        uniq, counts = np.unique(key, return_counts=True)
        del key
        parts.append((uniq // n_terms, (uniq % n_terms).astype(np.int32),
                      counts.astype(np.int32)))
        del uniq, counts
    doc_ptr = np.zeros(n_docs + 1, dtype=np.int64)
    for doc, _, _ in parts:
        doc_ptr[1:] += np.bincount(doc, minlength=n_docs)
    np.cumsum(doc_ptr, out=doc_ptr)
    nnz = int(doc_ptr[-1])
    doc_terms = np.empty(nnz, np.int32)
    doc_tfs = np.empty(nnz, np.int32)
    for doc, terms, tfs in parts:
        heads = np.concatenate([[0], np.nonzero(np.diff(doc))[0] + 1])
        within = np.arange(doc.shape[0]) - np.repeat(heads, np.diff(np.r_[heads, doc.shape[0]]))
        dest = doc_ptr[doc] + within
        doc_terms[dest] = terms
        doc_tfs[dest] = tfs
    return Corpus(n_docs=n_docs, n_terms=n_terms, doc_ptr=doc_ptr, doc_terms=doc_terms,
                  doc_tfs=doc_tfs, doc_topic=doc_topic, n_topics=n_topics)


def make_query_log(
    corpus: Corpus,
    n_queries: int,
    max_len: int = 8,
    seed: int = 1,
    length_dist: tuple[float, ...] = (0.2, 0.2, 0.2, 0.2, 0.2),
    df_max_frac: float = 0.05,
    df_min: int = 20,
) -> QueryLog:
    """Queries biased by length like the paper's Million Query sample.

    ``length_dist[i]`` is the probability of length ``i+1``; the last bucket
    means ">= len(length_dist)" up to ``max_len``. Terms come from the query
    topic's top tf-idf vocabulary among content words (df in [df_min,
    df_max_frac * N]).
    """
    rng = np.random.default_rng(seed)
    n_topics, n_terms = corpus.n_topics, corpus.n_terms
    doc_topic_rep = np.repeat(corpus.doc_topic.astype(np.int64), np.diff(corpus.doc_ptr))
    # Sums of integer tfs in float64 are exact, so bincount equals add.at.
    topic_term_mass = np.bincount(
        doc_topic_rep * n_terms + corpus.doc_terms, weights=corpus.doc_tfs,
        minlength=n_topics * n_terms,
    ).reshape(n_topics, n_terms)
    del doc_topic_rep
    df = np.bincount(corpus.doc_terms, minlength=n_terms).astype(np.int64)
    idf = np.log(1.0 + corpus.n_docs / np.maximum(df, 1))
    informative = topic_term_mass * idf[None, :]
    content = (df >= df_min) & (df <= max(df_min + 1, int(df_max_frac * corpus.n_docs)))
    if content.sum() >= 64:
        informative = informative * content[None, :]

    probs = np.asarray(length_dist, dtype=np.float64)
    probs /= probs.sum()
    lengths = np.empty(n_queries, dtype=np.int32)
    for i in range(n_queries):
        bucket = rng.choice(probs.size, p=probs)
        if bucket == probs.size - 1:
            lengths[i] = rng.integers(probs.size, max_len + 1)
        else:
            lengths[i] = bucket + 1

    terms = np.full((n_queries, max_len), -1, dtype=np.int32)
    topics = rng.integers(0, n_topics, size=n_queries).astype(np.int32)
    # The original sorts a topic's row once per query; the sort is the same
    # every time, so it is made once per topic.
    tops = {}
    for i in range(n_queries):
        t = int(topics[i])
        if t not in tops:
            top = np.argsort(-informative[t])[:256]
            w = informative[t][top]
            w = w / w.sum() if w.sum() > 0 else np.full(top.size, 1.0 / top.size)
            tops[t] = (top, w)
        top, w = tops[t]
        take = rng.choice(top, size=lengths[i], replace=False, p=w)
        terms[i, : lengths[i]] = np.sort(take)
    return QueryLog(terms=terms, lengths=lengths, topic=topics)


def topic_partition(corpus: Corpus) -> tuple[np.ndarray, np.ndarray]:
    """The collection's topical partition as data: ``doc_order[new_id] =
    old_id`` with documents grouped by planted topic (stable within a
    topic), and ``range_ends``, one past each topic's last new docid."""
    sizes = np.bincount(corpus.doc_topic, minlength=corpus.n_topics)
    if (sizes == 0).any():
        raise ValueError(f"topics {np.nonzero(sizes == 0)[0].tolist()} hold no document")
    doc_order = np.argsort(corpus.doc_topic, kind="stable").astype(np.int64)
    return doc_order, np.cumsum(sizes).astype(np.int64)
