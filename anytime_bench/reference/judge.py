"""The comparison that decides ``correct``.

Every served query is judged against the reference's trajectory of its query
(``engine.trajectory``): after the n ranges it scored, its doc ids, scores,
postings and blocks counters must equal the trajectory's, bitwise, and its
exit must be one the method allows: the first safe point (``exit_safe``), a
budget stop before it (``exit_budget``; never under an unbounded budget), or
the end of the processing order with no safe point before it. The reference
works no state out past the first safe point, so a query served past it counts
as mismatched as well as a bad exit. A query due in
the window that never got an answer counts as ``unanswered``. Each count has
the limit 0: the comparison is exact.
"""

from __future__ import annotations

import numpy as np

__all__ = ["LIMITS", "judge"]

LIMITS = {"mismatched": 0, "bad_exit": 0, "unanswered": 0}


def judge(pool_idx, results, traj: dict, bounded: bool) -> dict:
    """Counts of ``LIMITS``' faults over the window's queries, and ``failed``,
    the queries with any fault.

    ``pool_idx[j]`` is query j's row of the pool, ``results[j]`` its served
    result (None if it never came), ``traj`` the pool's stacked trajectories
    and ``bounded`` whether the traffic gives the server a postings budget.
    """
    R = traj["bound"].shape[1]
    out = dict.fromkeys((*LIMITS, "failed"), 0)
    for p, res in zip(pool_idx, results):
        if res is None:
            out["unanswered"] += 1
            out["failed"] += 1
            continue
        n = int(res.ranges_processed)
        if not 0 <= n <= R:
            out["mismatched"] += 1
            out["failed"] += 1
            continue
        ids, vals = traj["ids"][p, n], traj["vals"][p, n]
        keep = ids >= 0
        same = (np.array_equal(np.asarray(res.doc_ids, np.int64), ids[keep])
                and np.array_equal(np.asarray(res.scores, np.int64), vals[keep])
                and int(res.postings) == int(traj["postings"][p, n])
                and int(res.blocks) == int(traj["blocks"][p, n]))
        first_safe = int(traj["first_safe"][p])
        if res.exit_safe:
            exit_ok = n == first_safe < R
        elif res.exit_budget:
            exit_ok = bounded and n < min(first_safe, R)
        else:
            exit_ok = n == R == first_safe
        out["mismatched"] += not same
        out["bad_exit"] += not exit_ok
        out["failed"] += not (same and exit_ok)
    return out
