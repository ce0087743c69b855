"""Deterministic synthetic corpora with planted topical structure.

The paper evaluates on Gov2 / ClueWeb09B, neither of which is available in
this container. We instead generate Zipf-distributed corpora with *planted
topics*: each topic owns a permuted Zipf distribution over the vocabulary, so
documents drawn from the same topic share vocabulary mass and are clusterable
by construction. This preserves the structural property the paper relies on —
that a topical clustering of the collection concentrates each query's
high-scoring documents into a small number of docid ranges — while remaining
laptop-scale and fully deterministic.

Planted relevance: a query is generated from a topic's high-mass terms, and
documents of that topic that contain the most query mass are "relevant". This
gives graded qrels for the Table-4-style effectiveness experiments without
human judgments.
"""

from __future__ import annotations

import dataclasses
import hashlib

import numpy as np

__all__ = [
    "concat_corpora",
    "Corpus",
    "QueryLog",
    "make_corpus",
    "make_query_log",
    "planted_qrels",
]


@dataclasses.dataclass(frozen=True)
class Corpus:
    """Bag-of-words corpus in CSR layout (doc -> (term, tf))."""

    n_docs: int
    n_terms: int
    doc_ptr: np.ndarray  # [n_docs+1] int64
    doc_terms: np.ndarray  # [nnz] int32, term ids, sorted within doc
    doc_tfs: np.ndarray  # [nnz] int32
    doc_topic: np.ndarray  # [n_docs] int32 — planted topic (hidden label)
    n_topics: int

    @property
    def nnz(self) -> int:
        return int(self.doc_terms.shape[0])

    @property
    def doc_lens(self) -> np.ndarray:
        """Token count per document (sum of tfs)."""
        out = np.zeros(self.n_docs, np.int64)
        np.add.at(
            out,
            np.repeat(np.arange(self.n_docs), np.diff(self.doc_ptr)),
            self.doc_tfs,
        )
        return out

    def doc_slice(self, d: int) -> tuple[np.ndarray, np.ndarray]:
        s, e = self.doc_ptr[d], self.doc_ptr[d + 1]
        return self.doc_terms[s:e], self.doc_tfs[s:e]

    def fingerprint(self) -> str:
        h = hashlib.sha1()
        for a in (self.doc_ptr, self.doc_terms, self.doc_tfs):
            h.update(np.ascontiguousarray(a).tobytes())
        return h.hexdigest()[:16]


@dataclasses.dataclass(frozen=True)
class QueryLog:
    """Fixed-width padded query batch (term id -1 = padding)."""

    terms: np.ndarray  # [n_queries, max_len] int32, -1 padded
    lengths: np.ndarray  # [n_queries] int32
    topic: np.ndarray  # [n_queries] int32 — generating topic

    @property
    def n_queries(self) -> int:
        return int(self.terms.shape[0])

    @property
    def max_len(self) -> int:
        return int(self.terms.shape[1])


def concat_corpora(base: Corpus, delta: Corpus) -> Corpus:
    """Concatenate two corpora over one vocabulary (delta docs at the tail).

    The old-docid space of the result is ``base`` followed by ``delta``
    shifted by ``base.n_docs`` — the corpus a from-scratch build sees when
    verifying an incremental extension (DESIGN.md §10).
    """
    if base.n_terms != delta.n_terms:
        raise ValueError(
            f"corpora share one vocabulary: base has {base.n_terms} terms, "
            f"delta {delta.n_terms}"
        )
    return Corpus(
        n_docs=base.n_docs + delta.n_docs,
        n_terms=base.n_terms,
        doc_ptr=np.concatenate([base.doc_ptr, delta.doc_ptr[1:] + base.nnz]),
        doc_terms=np.concatenate([base.doc_terms, delta.doc_terms]),
        doc_tfs=np.concatenate([base.doc_tfs, delta.doc_tfs]),
        doc_topic=np.concatenate(
            [base.doc_topic, delta.doc_topic + base.n_topics]
        ).astype(np.int32),
        n_topics=base.n_topics + delta.n_topics,
    )


def _topic_term_dists(
    rng: np.random.Generator, n_topics: int, n_terms: int, zipf_s: float
) -> tuple[np.ndarray, np.ndarray]:
    """Per-topic permutation of a shared Zipf pmf over terms.

    A fraction of the vocabulary ("common" head) keeps its global rank in all
    topics, modelling stopword-ish terms that appear everywhere; the rest is
    permuted per topic so topics own distinct content vocabulary.
    """
    ranks = np.arange(1, n_terms + 1, dtype=np.float64)
    pmf = ranks ** (-zipf_s)
    pmf /= pmf.sum()
    # Small shared head (function words). Kept small: the paper's pipeline
    # stems AND stops, so stopword mass never reaches its indexes at all.
    n_common = max(8, n_terms // 200)
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
    n_docs: int = 20_000,
    n_terms: int = 20_000,
    n_topics: int = 32,
    mean_doc_len: int = 120,
    zipf_s: float = 1.1,
    seed: int = 0,
) -> Corpus:
    """Generate a planted-topic Zipf corpus. Deterministic in all arguments."""
    rng = np.random.default_rng(seed)
    pmf, perms = _topic_term_dists(rng, n_topics, n_terms, zipf_s)

    # Document topic assignment: mildly imbalanced (Dirichlet) like real shards.
    topic_weights = rng.dirichlet(np.full(n_topics, 4.0))
    doc_topic = rng.choice(n_topics, size=n_docs, p=topic_weights).astype(np.int32)

    # Document lengths: lognormal around the mean, >= 8 tokens.
    lens = np.maximum(
        8, rng.lognormal(np.log(mean_doc_len), 0.45, size=n_docs)
    ).astype(np.int64)

    # Draw terms per doc from its topic's distribution.  Vectorized per topic.
    doc_ptr = np.zeros(n_docs + 1, dtype=np.int64)
    terms_out: list[np.ndarray] = [np.empty(0, np.int32)] * n_docs
    tfs_out: list[np.ndarray] = [np.empty(0, np.int32)] * n_docs
    for t in range(n_topics):
        docs_t = np.nonzero(doc_topic == t)[0]
        if docs_t.size == 0:
            continue
        total = int(lens[docs_t].sum())
        draws = rng.choice(n_terms, size=total, p=pmf)  # ranks in topic order
        draws = perms[t][draws]  # map rank -> actual term id
        off = 0
        for d in docs_t:
            chunk = draws[off : off + lens[d]]
            off += lens[d]
            uniq, counts = np.unique(chunk, return_counts=True)
            terms_out[d] = uniq.astype(np.int32)
            tfs_out[d] = counts.astype(np.int32)
    for d in range(n_docs):
        doc_ptr[d + 1] = doc_ptr[d] + terms_out[d].shape[0]
    return Corpus(
        n_docs=n_docs,
        n_terms=n_terms,
        doc_ptr=doc_ptr,
        doc_terms=np.concatenate(terms_out) if n_docs else np.empty(0, np.int32),
        doc_tfs=np.concatenate(tfs_out) if n_docs else np.empty(0, np.int32),
        doc_topic=doc_topic,
        n_topics=n_topics,
    )


def make_query_log(
    corpus: Corpus,
    n_queries: int = 1000,
    max_len: int = 8,
    seed: int = 1,
    length_dist: tuple[float, ...] = (0.2, 0.2, 0.2, 0.2, 0.2),
    df_max_frac: float = 0.05,
    df_min: int = 20,
) -> QueryLog:
    """Sample queries biased by length like the paper's Million Query sample.

    ``length_dist[i]`` is the probability of length ``i+1``; the final bucket
    means ">= len(length_dist)" and is filled up to ``max_len``. Terms are
    drawn from the query topic's high tf-idf vocabulary, restricted to
    *content-word* document frequencies (df in [df_min, df_max_frac*N]) —
    real query logs are content terms, not stopwords, and the paper's range
    structure presumes exactly that.
    """
    rng = np.random.default_rng(seed)

    # Recover topic vocab empirically (top tf-idf mass per planted topic).
    n_topics = corpus.n_topics
    topic_term_mass = np.zeros((n_topics, corpus.n_terms), dtype=np.float64)
    doc_topic_rep = np.repeat(corpus.doc_topic, np.diff(corpus.doc_ptr))
    np.add.at(topic_term_mass, (doc_topic_rep, corpus.doc_terms), corpus.doc_tfs)
    df = np.zeros(corpus.n_terms, dtype=np.int64)
    np.add.at(df, corpus.doc_terms, 1)
    idf = np.log(1.0 + corpus.n_docs / np.maximum(df, 1))
    informative = topic_term_mass * idf[None, :]
    content = (df >= df_min) & (df <= max(df_min + 1, int(df_max_frac * corpus.n_docs)))
    if content.sum() >= 64:  # keep a usable pool on tiny corpora
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
    for i in range(n_queries):
        t = topics[i]
        top = np.argsort(-informative[t])[:256]
        w = informative[t][top]
        w = w / w.sum() if w.sum() > 0 else np.full(top.size, 1.0 / top.size)
        take = rng.choice(top, size=lengths[i], replace=False, p=w)
        terms[i, : lengths[i]] = np.sort(take)
    return QueryLog(terms=terms, lengths=lengths, topic=topics)


def planted_qrels(
    corpus: Corpus, qlog: QueryLog, n_rel: int = 20
) -> list[dict[int, float]]:
    """Graded relevance from the generative structure (for RBP/AP).

    A document is relevant to a query iff it shares the query's planted
    topic AND carries high query-term mass; the top n_rel such docs get
    graded gains (1.0 for the top half, 0.5 below). Computed from corpus
    structure only, independent of any index or traversal code.
    """
    df = np.zeros(corpus.n_terms, dtype=np.int64)
    np.add.at(df, corpus.doc_terms, 1)
    idf = np.log(1.0 + corpus.n_docs / np.maximum(df, 1))
    doc_of = np.repeat(np.arange(corpus.n_docs), np.diff(corpus.doc_ptr))

    out: list[dict[int, float]] = []
    for qi in range(qlog.n_queries):
        terms = set(int(t) for t in qlog.terms[qi] if t >= 0)
        mask = np.isin(corpus.doc_terms, list(terms))
        mass = np.zeros(corpus.n_docs)
        np.add.at(
            mass, doc_of[mask],
            corpus.doc_tfs[mask] * idf[corpus.doc_terms[mask]],
        )
        mass[corpus.doc_topic != qlog.topic[qi]] = 0.0  # same-topic constraint
        top = np.argsort(-mass)[:n_rel]
        top = top[mass[top] > 0]
        grades = {}
        for r, d in enumerate(top):
            grades[int(d)] = 1.0 if r < max(1, len(top) // 2) else 0.5
        out.append(grades)
    return out
