"""Effectiveness metrics: RBO, RBP, AP (paper §5.4).

RBO (Webber et al. [72]) is the paper's qrel-free surrogate for comparing an
early-terminated ranking against exhaustive evaluation; RBP [53] and AP are
used with (here: planted) relevance judgments.
"""

from __future__ import annotations

import numpy as np

__all__ = ["rbo", "rbp", "average_precision"]


def rbo(list_a, list_b, phi: float = 0.99, extrapolate: bool = True) -> float:
    """Rank-biased overlap of two ranked lists (higher = more similar).

    Uses the truncated form with the standard extrapolation term at the
    evaluation depth. Identical lists -> 1.0; disjoint -> 0.0.
    """
    a = list(map(int, list_a))
    b = list(map(int, list_b))
    depth = min(len(a), len(b))
    if depth == 0:
        return 1.0 if len(a) == len(b) else 0.0
    seen_a: set[int] = set()
    seen_b: set[int] = set()
    overlap = 0
    score = 0.0
    agreement = 0.0
    for d in range(depth):
        x, y = a[d], b[d]
        if x == y:
            overlap += 1
        else:
            if x in seen_b:
                overlap += 1
            if y in seen_a:
                overlap += 1
            seen_a.add(x)
            seen_b.add(y)
        agreement = overlap / (d + 1)
        score += (phi**d) * agreement
    out = (1 - phi) * score
    if extrapolate:
        out += agreement * (phi**depth)
    return float(min(out, 1.0))


def rbp(ranking, relevant, phi: float = 0.8) -> float:
    """Rank-biased precision with binary or graded (0..1) relevance."""
    if isinstance(relevant, dict):
        gains = [float(relevant.get(int(d), 0.0)) for d in ranking]
    else:
        rel = set(map(int, relevant))
        gains = [1.0 if int(d) in rel else 0.0 for d in ranking]
    return float((1 - phi) * sum(g * phi**i for i, g in enumerate(gains)))


def average_precision(ranking, relevant, k: int | None = None) -> float:
    """AP@k against a binary relevant set."""
    rel = set(map(int, relevant))
    if not rel:
        return 0.0
    ranking = list(ranking)[: k or len(ranking)]
    hits = 0
    total = 0.0
    for i, d in enumerate(ranking):
        if int(d) in rel:
            hits += 1
            total += hits / (i + 1)
    return float(total / min(len(rel), k or len(rel)))
