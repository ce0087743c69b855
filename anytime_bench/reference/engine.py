"""The plain reference: the paper's retrieval worked out again from the collection.

Plain numpy, written from the method's definition and importing nothing of the
program: BM25 contributions (k1, b of the configuration) quantized to b-bit
impacts by one global linear map, postings in docid order under the
benchmark's topical partition, blocks of 128 postings that never cross a range
boundary with their largest impact, and the per-(term, range) bounds U[t, r].

A query's traversal is a prefix of one fixed trajectory: the ranges in
BoundSum order (sum over the query's terms of U[t, r], largest first, ties by
range number), and before range i the threshold theta_i (the k-th best score
so far, 0 while fewer than k documents have a score). A block of term t in
range r is scored when its largest impact plus the other terms' bounds in r
beats theta_i; the heap keeps the k best documents by (score descending,
docid ascending) among those with a positive score. The traversal may stop
before range i when ``bound_i <= theta_i`` and ``theta_i > 0`` (safe), or when
its budget is spent. So a served query that scored n ranges must equal the
trajectory's state after n ranges, with its postings and blocks counters, and
its exit must be the first safe point, or a budget stop before it, or the end
of the order. ``trajectories`` works that state out for every prefix up to the
first safe point: no served query may go past it.
"""

from __future__ import annotations

import dataclasses
import os

import numpy as np

from anytime_bench.yardstick import step_bytes

__all__ = [
    "BLOCK",
    "PACK_WIDTHS",
    "RefIndex",
    "build_reference_index",
    "load_reference_index",
    "save_reference_index",
    "trajectories",
    "trajectory",
]

BLOCK = 128
# Bits per docid delta of a packed block: the smallest of these that holds the
# block's largest delta (delta 0 is the block's first posting).
PACK_WIDTHS = (0, 4, 8, 16, 32)
_LOW = (1 << 32) - 1

_ARRAYS = ("ptr", "docs", "imps", "blk_start", "blk_len", "blk_maximp", "blk_width",
           "run_b0", "run_b1", "U", "range_starts", "range_sizes")


@dataclasses.dataclass
class RefIndex:
    ptr: np.ndarray  # [V+1] int64, postings of term t at ptr[t]:ptr[t+1]
    docs: np.ndarray  # [nnz] int32 new docids, ascending within a term
    imps: np.ndarray  # [nnz] int32 quantized impacts
    blk_start: np.ndarray  # [NB] int64 first posting of the block
    blk_len: np.ndarray  # [NB] int32
    blk_maximp: np.ndarray  # [NB] int32
    blk_width: np.ndarray  # [NB] int32 bits per delta of the block packed
    run_b0: np.ndarray  # [V, R] int64 first block of (t, r)
    run_b1: np.ndarray  # [V, R] int64 one past its last block
    U: np.ndarray  # [V, R] int32 largest impact of t in r (0: absent)
    range_starts: np.ndarray  # [R] int64
    range_sizes: np.ndarray  # [R] int64

    @property
    def n_ranges(self) -> int:
        return int(self.range_starts.shape[0])


def _impacts(corpus, bits: int, k1: float, b: float) -> np.ndarray:
    """Quantized BM25 impact of every posting, in the corpus's CSR order."""
    n_docs = corpus.n_docs
    doc_of = np.repeat(np.arange(n_docs), np.diff(corpus.doc_ptr))
    tf = corpus.doc_tfs.astype(np.float64)
    lens = np.bincount(doc_of, weights=tf, minlength=n_docs)  # exact: integer sums
    avg = float(max(lens.mean(), 1.0)) if n_docs else 1.0
    df = np.bincount(corpus.doc_terms, minlength=corpus.n_terms).astype(np.int64)
    idf = np.log(1.0 + (n_docs - df + 0.5) / (df + 0.5))
    norm = k1 * (1.0 - b + b * lens[doc_of] / avg)
    del doc_of, lens
    score = (idf[corpus.doc_terms] * tf * (k1 + 1.0) / (tf + norm)).astype(np.float32)
    del norm, tf
    top = max(float(score.max()) if score.size else 1.0, 1e-9)
    scale = ((1 << bits) - 1) / top
    q = np.ceil(score.astype(np.float64) * scale)
    return np.clip(q, 1, (1 << bits) - 1).astype(np.int32)


def build_reference_index(corpus, doc_order, range_ends, bits: int, k1: float,
                          b: float) -> RefIndex:
    """The reference's own index of ``corpus`` under the partition."""
    n_docs, V = corpus.n_docs, corpus.n_terms
    range_ends = np.asarray(range_ends, np.int64)
    R = int(range_ends.shape[0])
    sizes = np.diff(np.concatenate([[0], range_ends]))
    imp = _impacts(corpus, bits, k1, b)
    new_of_old = np.empty(n_docs, np.int64)
    new_of_old[np.asarray(doc_order, np.int64)] = np.arange(n_docs)
    new_ids = new_of_old[np.repeat(np.arange(n_docs), np.diff(corpus.doc_ptr))]
    terms = corpus.doc_terms.astype(np.int64)
    order = np.argsort(terms * n_docs + new_ids)
    docs = new_ids[order].astype(np.int32)
    del new_ids
    imps = imp[order]
    terms = terms[order]
    del order, imp
    ptr = np.zeros(V + 1, np.int64)
    ptr[1:] = np.cumsum(np.bincount(terms, minlength=V))
    nnz = int(docs.shape[0])

    # Runs of one (term, range), then blocks of BLOCK postings within a run.
    rng_of_new = np.repeat(np.arange(R, dtype=np.int64), sizes)
    run_key = terms * R + rng_of_new[docs]
    del terms, rng_of_new
    run_head = np.ones(nnz, bool)
    run_head[1:] = run_key[1:] != run_key[:-1]
    run_starts = np.nonzero(run_head)[0]
    run_key = run_key[run_starts]
    run_lens = np.diff(np.r_[run_starts, nnz])
    pos = np.arange(nnz) - np.repeat(run_starts, run_lens)
    blk_start = np.nonzero(pos % BLOCK == 0)[0]
    del pos, run_head
    blk_len = np.diff(np.r_[blk_start, nnz]).astype(np.int32)
    blk_maximp = np.maximum.reduceat(imps, blk_start) if nnz else np.zeros(0, np.int32)
    prev = np.empty_like(docs)
    prev[1:] = docs[:-1]
    prev[blk_start] = docs[blk_start]
    delta = (docs - prev).astype(np.int64)
    del prev
    maxd = np.maximum.reduceat(delta, blk_start) if nnz else np.zeros(0, np.int64)
    del delta
    width = np.select([maxd < (1 << w) for w in PACK_WIDTHS[:-1]], list(PACK_WIDTHS[:-1]),
                      default=PACK_WIDTHS[-1]).astype(np.int32)
    run_b0 = np.searchsorted(blk_start, run_starts)
    run_b1 = np.r_[run_b0[1:], blk_start.shape[0]]
    run_U = np.maximum.reduceat(imps, run_starts) if nnz else np.zeros(0, np.int32)
    t_of, r_of = run_key // R, run_key % R
    dense = np.zeros((V, R), np.int64)
    U = np.zeros((V, R), np.int32)
    b0, b1 = dense.copy(), dense.copy()
    b0[t_of, r_of], b1[t_of, r_of], U[t_of, r_of] = run_b0, run_b1, run_U
    return RefIndex(ptr=ptr, docs=docs, imps=imps, blk_start=blk_start.astype(np.int64),
                    blk_len=blk_len, blk_maximp=blk_maximp.astype(np.int32),
                    blk_width=width, run_b0=b0, run_b1=b1, U=U,
                    range_starts=np.concatenate([[0], range_ends[:-1]]).astype(np.int64),
                    range_sizes=sizes.astype(np.int64))


def save_reference_index(ix: RefIndex, path: str) -> None:
    os.makedirs(path, exist_ok=True)
    for name in _ARRAYS:
        np.save(os.path.join(path, f"{name}.npy"), getattr(ix, name))


def load_reference_index(path: str) -> RefIndex:
    return RefIndex(**{n: np.load(os.path.join(path, f"{n}.npy"), mmap_mode="r")
                       for n in _ARRAYS})


def _segments(starts: np.ndarray, lens: np.ndarray) -> np.ndarray:
    """Indices starts[0]..+lens[0], starts[1]..+lens[1], ... as one array."""
    lens = lens.astype(np.int64)
    ends = np.cumsum(lens)
    return np.arange(int(ends[-1]) if lens.size else 0) - np.repeat(ends - lens - starts, lens)


def _best(vals: np.ndarray, ids: np.ndarray, k: int):
    """The k best (value, id) pairs by value descending, id ascending."""
    key = (vals.astype(np.int64) << 32) | (_LOW - ids.astype(np.int64))
    if key.shape[0] > k:
        key = key[np.argpartition(-key, k - 1)[:k]]
    key = -np.sort(-key)
    return key >> 32, _LOW - (key & _LOW)


def trajectory(ix: RefIndex, q_terms, k: int, imp_size: int, packed: bool) -> dict:
    """Every prefix of one query's traversal up to its first safe point (see
    the module's docstring).

    Returns ``vals``/``ids`` [R+1, k] (state after i ranges, for i up to
    ``first_safe``; 0 and -1 pad), ``postings``/``blocks`` [R+1],
    ``bound``/``theta`` [R] (before range i), ``first_safe`` (the first i at
    which the traversal may stop safely, R if none), and ``bytes`` [R], what
    scoring range i reads by the byte model
    (``yardstick.step_bytes``: every listed block's id, rest bound and
    largest impact, and a kept block's row and postings).
    """
    q = np.asarray([int(t) for t in np.asarray(q_terms).reshape(-1) if t >= 0], np.int64)
    R = ix.n_ranges
    U = np.asarray(ix.U[q], np.int64) if q.size else np.zeros((0, R), np.int64)
    bsum = U.sum(axis=0)
    order = np.argsort(-bsum, kind="stable")
    vals = np.zeros((R + 1, k), np.int32)
    ids = np.full((R + 1, k), -1, np.int32)
    postings = np.zeros(R + 1, np.int64)
    blocks = np.zeros(R + 1, np.int64)
    bound = bsum[order]
    theta = np.zeros(R, np.int64)
    nbytes = np.zeros(R, np.int64)
    hv = np.zeros(0, np.int64)
    hi = np.zeros(0, np.int64)
    first_safe = R
    for i, r in enumerate(order):
        th = int(hv[k - 1]) if hv.shape[0] >= k else 0
        theta[i] = th
        if bound[i] <= th and th > 0:
            first_safe = i
            break
        blk, rest = [], []
        for j, t in enumerate(q):
            b0, b1 = int(ix.run_b0[t, r]), int(ix.run_b1[t, r])
            blk.append(np.arange(b0, b1))
            rest.append(np.full(max(b1 - b0, 0), int(bsum[r]) - int(U[j, r])))
        blk = np.concatenate(blk) if blk else np.zeros(0, np.int64)
        rest = np.concatenate(rest) if rest else np.zeros(0, np.int64)
        nbytes[i] = step_bytes(blk, rest, th, ix.blk_len, ix.blk_maximp, ix.blk_width,
                               imp_size, packed)
        kept = blk[np.asarray(ix.blk_maximp[blk], np.int64) + rest > th]
        lens = np.asarray(ix.blk_len[kept], np.int64)
        n_post = int(lens.sum())
        if n_post:
            idx = _segments(np.asarray(ix.blk_start[kept], np.int64), lens)
            start = int(ix.range_starts[r])
            acc = np.bincount(np.asarray(ix.docs[idx], np.int64) - start,
                              weights=np.asarray(ix.imps[idx], np.float64),
                              minlength=int(ix.range_sizes[r]))
            cand = np.nonzero(acc > 0)[0]
            hv, hi = _best(np.r_[hv, acc[cand].astype(np.int64)], np.r_[hi, cand + start], k)
        postings[i + 1] = postings[i] + n_post
        blocks[i + 1] = blocks[i] + kept.shape[0]
        vals[i + 1, : hv.shape[0]] = hv
        ids[i + 1, : hi.shape[0]] = hi
    return dict(vals=vals, ids=ids, postings=postings, blocks=blocks, bound=bound,
                theta=theta, first_safe=first_safe, bytes=nbytes)


def trajectories(ix: RefIndex, pool_terms: np.ndarray, k: int, imp_size: int,
                 packed: bool) -> dict:
    """``trajectory`` of every query of the pool, stacked on a leading axis."""
    rows = [trajectory(ix, q, k, imp_size, packed) for q in pool_terms]
    return {key: np.stack([np.asarray(r[key]) for r in rows]) for key in rows[0]}
