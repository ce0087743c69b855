"""Anytime top-k candidate retrieval — the paper's technique beyond text.

The recsys ``retrieval_cand`` shape (score one user against 1M items) is
exactly the paper's problem in dense-embedding form. This module applies the
full §3 recipe to maximum-inner-product retrieval:

  * candidate embeddings are k-means clustered into *ranges* (topical
    clustering — here literal vector clustering);
  * each range stores per-dimension extrema (lo[r, d], hi[r, d]); for a
    query q the range score bound is  sum_d max(q_d*lo, q_d*hi)  — the
    dense analogue of BoundSum's U[t, r] (exact for any q, cheap: one
    [R, D] pass);
  * ranges are scored in decreasing bound order (q @ E_r^T), a running
    top-k threshold theta enables the same safe early termination, and the
    §6 anytime policies cap work for SLA serving (budget in candidates
    scored).

The port's counterpart of the reference's plain-XLA module, in plain
torch on the candidates' device (the card unless they were built with
``device="cpu"``). float32 throughout, with TF32 off for the products.
The reference's ``lax.while_loop`` is a host loop here: the ranges' bounds
and order are read once, and theta once per range under ``safe_stop``.
Ties keep the lower index first, as ``lax.top_k`` and the stable
``argsort`` do (``torch.topk`` does not promise an order among ties).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.cluster import spherical_kmeans
from repro_torch.core.range_daat import resolve_device
from repro_torch.models.layers import topk_first

__all__ = ["ClusteredCandidates", "MIPSResult", "anytime_mips", "build_clustered_candidates"]

_NEG = -3.0e38  # float32 "minus infinity" of the reference (an empty slot's score)
_INT32_MAX = 2**31 - 1


@dataclasses.dataclass(frozen=True)
class ClusteredCandidates:
    emb: torch.Tensor  # [R, C, D] float32 padded cluster members
    ids: torch.Tensor  # [R, C] int32 original ids (-1 pad)
    lo: torch.Tensor  # [R, D] float32 per-dim minima
    hi: torch.Tensor  # [R, D] float32 per-dim maxima

    @property
    def n_ranges(self) -> int:
        return int(self.emb.shape[0])

    @property
    def capacity(self) -> int:
        return int(self.emb.shape[1])

    @functools.cached_property
    def members(self) -> list[int]:
        """Real (unpadded) candidates per range, read once to the host."""
        return (self.ids >= 0).sum(dim=1).tolist()


def build_clustered_candidates(
    embeddings: np.ndarray, n_clusters: int = 64, seed: int = 0, iters: int = 12,
    device=None,
) -> ClusteredCandidates:
    """Offline build: cluster + pad + per-dim extrema (index-build stage).

    The host arrays are the reference's, array for array; they are
    uploaded to ``device`` (None: the card; ``"cpu"`` for the plain path
    on the CPU).
    """
    dev = resolve_device(device)
    x = np.asarray(embeddings, np.float32)
    n, d = x.shape
    norms = np.linalg.norm(x, axis=1, keepdims=True)
    assign = spherical_kmeans(x / np.maximum(norms, 1e-9), n_clusters, iters=iters, seed=seed)
    order = np.argsort(assign, kind="stable")
    counts = np.bincount(assign, minlength=n_clusters)
    cap = int(counts.max())
    R = n_clusters
    emb = np.zeros((R, cap, d), np.float32)
    ids = np.full((R, cap), -1, np.int32)
    lo = np.zeros((R, d), np.float32)
    hi = np.zeros((R, d), np.float32)
    off = 0
    for r in range(R):
        c = int(counts[r])
        members = order[off : off + c]
        off += c
        if c:
            emb[r, :c] = x[members]
            ids[r, :c] = members
            lo[r] = x[members].min(0)
            hi[r] = x[members].max(0)
    return ClusteredCandidates(
        emb=torch.from_numpy(emb).to(dev), ids=torch.from_numpy(ids).to(dev),
        lo=torch.from_numpy(lo).to(dev), hi=torch.from_numpy(hi).to(dev),
    )


class MIPSResult(NamedTuple):
    ids: torch.Tensor  # [k] int32 on the candidates' device
    scores: torch.Tensor  # [k] float32
    ranges_processed: int
    candidates_scored: int
    exit_safe: bool


@contextlib.contextmanager
def _full_fp32():
    """Products in full float32: TF32 off on the card for the block."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def anytime_mips(
    cc: ClusteredCandidates,
    q,  # [D] (or [J, D] multi-interest: max over J)
    *,
    k: int = 10,
    budget_candidates: int = _INT32_MAX,
    max_ranges: int = _INT32_MAX,
    safe_stop: bool = True,
) -> MIPSResult:
    """Score ranges in decreasing bound order to an exit: safe (the next
    bound cannot beat the full top-k's k-th score), budget (candidates
    scored reached ``budget_candidates``, or ``max_ranges`` ranges run), or
    every range done; the reference's loop, decision for decision."""
    dev = cc.emb.device
    q = torch.as_tensor(q, dtype=torch.float32, device=dev)
    q2 = q if q.dim() == 2 else q[None]
    # BoundSum analogue: max over interests of the per-dim extrema bound.
    bound = torch.amax(
        torch.sum(torch.maximum(q2[:, None] * cc.lo[None], q2[:, None] * cc.hi[None]), -1),
        dim=0,
    )  # [R]
    R, C, _ = cc.emb.shape
    order_t = topk_first(bound, R)[1]
    order = order_t.tolist()
    sorted_bound = bound[order_t].tolist()
    members = cc.members
    budget, maxr = int(budget_candidates), int(max_ranges)
    kk = min(k, C)

    vals = torch.full((k,), _NEG, dtype=torch.float32, device=dev)
    ids = torch.full((k,), -1, dtype=torch.int32, device=dev)
    i, scored, s_safe, s_budget = 0, 0, False, False
    with _full_fp32():
        while i < R and not (s_safe or s_budget):
            if safe_stop:
                theta, last_id = torch.stack([vals[-1], ids[-1].to(torch.float32)]).tolist()
                # filled: the k-th slot is occupied, so theta is real.
                s_safe = last_id >= 0 and sorted_bound[i] <= theta
            s_budget = scored >= budget or i >= maxr
            if s_safe or s_budget:
                break
            r = order[i]
            scores = torch.amax(q2 @ cc.emb[r].T, dim=0)  # [C]
            valid = cc.ids[r] >= 0
            scores = torch.where(valid, scores, torch.full_like(scores, _NEG))
            ci = topk_first(scores, kk)[1]
            cv = scores[ci]
            cand_ids = torch.where(cv > _NEG, cc.ids[r][ci], -1)
            mv = torch.cat([vals, cv])
            mi = torch.cat([ids, cand_ids])
            sel = topk_first(mv, k)[1]
            vals, ids = mv[sel], mi[sel]
            scored += members[r]
            i += 1
    return MIPSResult(ids=ids, scores=vals, ranges_processed=i,
                      candidates_scored=scored, exit_safe=bool(s_safe))
