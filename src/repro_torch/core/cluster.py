"""Topical clustering of documents (paper §3 "Document Arrangement").

The paper uses the QKLD-QInit clusters of Dai et al. [17]. We implement the
same *shape* of pipeline at index-build time: tf-idf document vectors,
dimensionality reduction by signed feature hashing (deterministic), spherical
k-means with kmeans++-style sampled init. Output is a cluster id per document;
the index builder turns clusters into contiguous docid ranges.

Runs in numpy on the host — clustering is an offline index-construction step,
not a query-time component, exactly as in the paper.
"""

from __future__ import annotations

import numpy as np

from repro_torch.data.synth import Corpus

__all__ = ["hashed_tfidf", "spherical_kmeans", "topical_clusters"]


def hashed_tfidf(
    corpus: Corpus, dim: int = 256, seed: int = 7, stop_df_frac: float = 0.10
) -> np.ndarray:
    """Dense Gaussian random projection of tf-idf vectors, L2-normed.

    Terms appearing in more than ``stop_df_frac`` of documents are dropped
    (stopping — the paper's corpora are stemmed *and stopped*, so stopword
    mass never reaches clustering features there either). A dense Gaussian
    projection preserves cosine structure far better than single-slot
    feature hashing (collisions destroy the weak per-term signal); the
    per-posting accumulation uses reduceat over the CSR layout, chunked
    over feature dims to bound memory.
    """
    rng = np.random.default_rng(seed)
    proj = rng.standard_normal((corpus.n_terms, dim)).astype(np.float32)
    proj /= np.sqrt(dim)

    df = np.zeros(corpus.n_terms, dtype=np.int64)
    np.add.at(df, corpus.doc_terms, 1)
    idf = np.log(1.0 + corpus.n_docs / np.maximum(df, 1)).astype(np.float32)
    stopped = df > stop_df_frac * corpus.n_docs

    w = (1.0 + np.log(np.maximum(corpus.doc_tfs, 1))).astype(np.float32)
    w *= idf[corpus.doc_terms]
    w *= ~stopped[corpus.doc_terms]

    out = np.zeros((corpus.n_docs, dim), dtype=np.float32)
    starts = corpus.doc_ptr[:-1]
    nonempty = np.diff(corpus.doc_ptr) > 0
    chunk = max(32, min(dim, (1 << 27) // max(corpus.nnz, 1)))  # ~512MB cap
    for lo in range(0, dim, chunk):
        hi = min(lo + chunk, dim)
        vals = w[:, None] * proj[corpus.doc_terms, lo:hi]
        acc = np.add.reduceat(vals, starts.clip(max=max(corpus.nnz - 1, 0)), axis=0)
        out[nonempty, lo:hi] = acc[nonempty]
    norms = np.linalg.norm(out, axis=1, keepdims=True)
    return out / np.maximum(norms, 1e-9)


def spherical_kmeans(
    x: np.ndarray, k: int, iters: int = 25, seed: int = 11
) -> np.ndarray:
    """Spherical k-means; returns cluster id per row. Deterministic."""
    rng = np.random.default_rng(seed)
    n = x.shape[0]
    k = min(k, n)
    # kmeans++-ish init on a sample.
    sample = rng.choice(n, size=min(n, 4096), replace=False)
    centers = [x[sample[rng.integers(sample.size)]]]
    for _ in range(k - 1):
        sims = np.max(np.stack([x[sample] @ c for c in centers], 0), 0)
        d2 = np.maximum(1.0 - sims, 1e-9)
        p = d2 / d2.sum()
        centers.append(x[sample[rng.choice(sample.size, p=p)]])
    c = np.stack(centers, 0)  # [k, dim]

    assign = np.zeros(n, dtype=np.int32)
    for _ in range(iters):
        sims = x @ c.T  # [n, k]
        new_assign = np.argmax(sims, axis=1).astype(np.int32)
        if np.array_equal(new_assign, assign):
            assign = new_assign
            break
        assign = new_assign
        for j in range(k):
            rows = x[assign == j]
            if rows.shape[0] == 0:
                # Re-seed empty cluster at the point farthest from its center.
                worst = np.argmin(np.max(sims, axis=1))
                c[j] = x[worst]
            else:
                m = rows.sum(0)
                c[j] = m / max(np.linalg.norm(m), 1e-9)
    return assign


def topical_clusters(
    corpus: Corpus, n_clusters: int, dim: int = 256, iters: int = 25, seed: int = 7
) -> np.ndarray:
    """Cluster id per document via hashed tf-idf + spherical k-means."""
    x = hashed_tfidf(corpus, dim=dim, seed=seed)
    return spherical_kmeans(x, n_clusters, iters=iters, seed=seed + 1)
