"""Document identifier reassignment (paper §3 "Document Arrangement").

Implements the paper's composition: topical clustering (cluster.py) followed
by *recursive graph bisection* (Dhulipala et al. [21]) applied within each
cluster, with clusters concatenated into contiguous docid ranges. Also
provides the Random and global-BP ("Reordered") baselines used throughout the
paper's tables.

BP here is the standard log-gap-cost bisection on the document-term bipartite
graph, vectorized in numpy: at each recursion node the document set is split
in half and refined by gain-sorted pair swaps for a bounded number of rounds.
This is an offline index-build step (the paper uses the same algorithm via an
external tool); results are cached by the index builder.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.cluster import topical_clusters
from repro_torch.data.synth import Corpus

__all__ = ["Arrangement", "arrange", "graph_bisection_order"]


@dataclasses.dataclass(frozen=True)
class Arrangement:
    """A docid assignment plus range structure.

    ``doc_order[new_id] = old_id``; ``range_ends[i]`` is one past the last
    new docid of range i (the paper's cluster map C, with c_0 = 0 implicit).
    """

    doc_order: np.ndarray  # [n_docs] int64 permutation
    range_ends: np.ndarray  # [n_ranges] int64, increasing, last == n_docs
    strategy: str

    @property
    def n_ranges(self) -> int:
        return int(self.range_ends.shape[0])

    @property
    def range_starts(self) -> np.ndarray:
        return np.concatenate([[0], self.range_ends[:-1]])

    @property
    def range_sizes(self) -> np.ndarray:
        return np.diff(np.concatenate([[0], self.range_ends]))

    def range_of_newdoc(self) -> np.ndarray:
        """Range id for every new docid — the Range(d) function of Eq. (2)."""
        n_docs = int(self.range_ends[-1])
        # analysis: allow[NARROW] values are range ids, bounded by n_ranges
        return np.searchsorted(self.range_ends, np.arange(n_docs), side="right").astype(
            np.int32
        )


def _gain(deg: np.ndarray, n: int) -> np.ndarray:
    """Log-gap cost model term: deg * log2(n / (deg + 1)).

    Entries at deg = -1 (a hypothetical move out of an empty side) are never
    gathered by the caller; compute them as 0 to keep the math finite.
    """
    n = max(n, 1)
    safe = np.maximum(deg + 1.0, 1e-9)
    with np.errstate(divide="ignore", invalid="ignore"):
        out = deg * np.log2(n / safe)
    return np.nan_to_num(out, nan=0.0, posinf=0.0, neginf=0.0)


def _bisect_once(
    docs: np.ndarray,
    doc_ptr: np.ndarray,
    doc_terms: np.ndarray,
    rounds: int,
    rng: np.random.Generator,
) -> tuple[np.ndarray, np.ndarray]:
    """One bisection of ``docs`` (old ids) into two halves, refined by swaps."""
    n = docs.shape[0]
    half = n // 2
    order = docs.copy()
    rng.shuffle(order)
    left, right = order[:half], order[half:]

    def postings_of(ds: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        # Concatenated term ids for a doc set + posting->position map.
        counts = doc_ptr[ds + 1] - doc_ptr[ds]
        idx = np.repeat(doc_ptr[ds], counts) + (
            np.arange(counts.sum()) - np.repeat(np.cumsum(counts) - counts, counts)
        )
        return doc_terms[idx], np.repeat(np.arange(ds.shape[0]), counts)

    for _ in range(rounds):
        lt, lpos = postings_of(left)
        rt, rpos = postings_of(right)
        n_terms = int(max(lt.max(initial=-1), rt.max(initial=-1))) + 1
        if n_terms == 0:
            break
        degl = np.bincount(lt, minlength=n_terms).astype(np.float64)
        degr = np.bincount(rt, minlength=n_terms).astype(np.float64)

        cur = _gain(degl, left.shape[0]) + _gain(degr, right.shape[0])
        move_lr = _gain(degl - 1, left.shape[0]) + _gain(degr + 1, right.shape[0])
        move_rl = _gain(degl + 1, left.shape[0]) + _gain(degr - 1, right.shape[0])
        gain_l_term = cur - move_lr  # gain contribution if a left doc leaves
        gain_r_term = cur - move_rl

        gains_l = np.zeros(left.shape[0])
        np.add.at(gains_l, lpos, gain_l_term[lt])
        gains_r = np.zeros(right.shape[0])
        np.add.at(gains_r, rpos, gain_r_term[rt])

        ol = np.argsort(-gains_l, kind="stable")
        orr = np.argsort(-gains_r, kind="stable")
        m = min(ol.shape[0], orr.shape[0])
        pair_gain = gains_l[ol[:m]] + gains_r[orr[:m]]
        n_swap = int(np.searchsorted(-pair_gain, 0.0))  # pair_gain > 0 prefix
        if n_swap == 0:
            break
        li, ri = ol[:n_swap], orr[:n_swap]
        left[li], right[ri] = right[ri].copy(), left[li].copy()
    return left, right


def graph_bisection_order(
    corpus: Corpus,
    docs: np.ndarray | None = None,
    leaf_size: int = 32,
    rounds: int = 8,
    seed: int = 3,
) -> np.ndarray:
    """Recursive graph bisection ordering of ``docs`` (default: all docs)."""
    if docs is None:
        docs = np.arange(corpus.n_docs, dtype=np.int64)
    rng = np.random.default_rng(seed)
    out: list[np.ndarray] = []
    stack: list[np.ndarray] = [docs.astype(np.int64)]
    # Iterative DFS preserving left-to-right order.
    result: list[np.ndarray] = []

    def rec(ds: np.ndarray, depth: int) -> None:
        if ds.shape[0] <= leaf_size or depth > 40:
            result.append(ds)
            return
        left, right = _bisect_once(ds, corpus.doc_ptr, corpus.doc_terms, rounds, rng)
        rec(left, depth + 1)
        rec(right, depth + 1)

    rec(docs.astype(np.int64), 0)
    del out, stack
    return np.concatenate(result) if result else np.empty(0, np.int64)


def arrange(
    corpus: Corpus,
    n_ranges: int = 32,
    strategy: str = "clustered_bp",
    seed: int = 0,
    bp_rounds: int = 8,
    kmeans_iters: int = 25,
) -> Arrangement:
    """Produce a docid arrangement.

    Strategies (paper terminology):
      - ``random``        Random baseline; single range.
      - ``bp``            global recursive graph bisection ("Reordered"
                          Default index); single range.
      - ``clustered``     topical clusters concatenated, natural order inside.
      - ``clustered_bp``  the paper's proposal: clusters, BP inside each,
                          concatenated (Clustered "Reordered" index).
      - ``clustered_random`` clusters concatenated, shuffled inside — isolates
                          the range structure from within-range locality.
    """
    rng = np.random.default_rng(seed)
    if strategy == "random":
        order = rng.permutation(corpus.n_docs).astype(np.int64)
        ends = np.array([corpus.n_docs], dtype=np.int64)
        return Arrangement(order, ends, strategy)
    if strategy == "bp":
        order = graph_bisection_order(corpus, rounds=bp_rounds, seed=seed)
        ends = np.array([corpus.n_docs], dtype=np.int64)
        return Arrangement(order, ends, strategy)
    if strategy not in ("clustered", "clustered_bp", "clustered_random"):
        raise ValueError(f"unknown strategy {strategy!r}")

    assign = topical_clusters(corpus, n_ranges, iters=kmeans_iters, seed=seed + 7)
    pieces: list[np.ndarray] = []
    ends_list: list[int] = []
    total = 0
    for c in range(int(assign.max()) + 1 if assign.size else 0):
        members = np.nonzero(assign == c)[0].astype(np.int64)
        if members.size == 0:
            continue
        if strategy == "clustered_bp":
            members = graph_bisection_order(
                corpus, docs=members, rounds=bp_rounds, seed=seed + 13 + c
            )
        elif strategy == "clustered_random":
            rng.shuffle(members)
        pieces.append(members)
        total += members.size
        ends_list.append(total)
    order = np.concatenate(pieces) if pieces else np.empty(0, np.int64)
    return Arrangement(order, np.asarray(ends_list, dtype=np.int64), strategy)
