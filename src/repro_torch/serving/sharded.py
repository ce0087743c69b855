"""Range-sharded anytime retrieval on one card (DESIGN.md §4).

The cluster-skipping index is separable at range boundaries (blocks never
straddle them and every (term, range) bound is self-contained), so the
natural distribution unit is a contiguous band of ranges, not a random
document split. ``core.clustered_index.shard_device_index`` carves the
built index into postings-mass-balanced bands; this module traverses
every band for every query and merges the per-shard heaps into a global
top-k under the heap's total order (score desc, docid asc), which makes
the merged list *bitwise identical* to the single-device traversal
whenever every shard runs its ranges to completion.

The port's path is the reference's single-device one: the shards are
stacked row by row into one ``DeviceIndex`` on the engine's card, and
one launch of the ``traverse`` kernel serves every (query, shard) pair
(lane n reads shard n % S, the reference's double vmap), followed by the
local->global docid lift and the broker merge in plain torch on the
device. The mesh path (one shard per card) is not ported yet.

Budgets are per (query, shard): a global postings budget is split
proportionally to each shard's postings mass (``split_postings_budget``),
so the anytime knob degrades all shards evenly instead of truncating
whichever shard happens to be slow. Fidelity accounting: a shard that
exits on budget reports the max BoundSum of its unprocessed ranges; the
merged result carries ``fidelity_bound`` = max over shards, and any
document missing from the merged list scores at most that bound.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from repro_torch.core.clustered_index import (
    BLOCK,
    IndexShard,
    pack_dir_entries,
    pack_docs,
    shard_cuts,
    shard_device_index,
)
from repro_torch.core.range_daat import (
    DeviceIndex,
    Engine,
    QueryPlan,
    batched_init_carry,
    carry_buffer,
    lane_caps,
    pack_impacts,
    traverse_lanes,
    upload_int32,
)
from repro_torch.serving.bucketing import (
    BucketSpec,
    batch_ladder,
    dummy_plan,
    iter_bucket_chunks,
)

__all__ = [
    "INT32_MAX",
    "ShardedEngine",
    "ShardedBatchEngine",
    "ShardedResult",
    "apply_down_mask",
    "sharded_batched_traverse",
    "shard_exit_reason",
    "split_outputs",
]

INT32_MAX = 2**31 - 1
# Low half of a packed (score, docid) merge key: ranking by ``LOW - docid``
# puts the smaller docid first among equal scores.
_LOW = 2**32 - 1


# --------------------------------------------------------------------------
# Device dispatch
# --------------------------------------------------------------------------


def _merge_gathered(vals: torch.Tensor, gids: torch.Tensor, k: int):
    """[N, S, k] per-shard heaps -> ([N, k], [N, k]) merged global top-k.

    The reference's ``merge_topk`` per query: score descending, docid
    ascending, empty slots (id < 0) last, through one int64 key
    ``score * 2^32 + (2^32 - 1 - id')`` (id' = id, or 2^31 - 1 when
    empty). Scores are never negative and the shards' docids are
    disjoint, so only empty slots, all (0, -1), share a key.
    """
    n = vals.shape[0]
    v, i = vals.reshape(n, -1), gids.reshape(n, -1)
    i_key = torch.where(i >= 0, i, INT32_MAX).to(torch.int64)
    key = (v.to(torch.int64) << 32) | (_LOW - i_key)
    sel = torch.topk(key, k, dim=1).indices
    return torch.gather(v, 1, sel), torch.gather(i, 1, sel)


def sharded_batched_traverse(
    dix: DeviceIndex,  # stacked shard-major leaves [S, ...]
    doc_base: torch.Tensor,  # [S] int32 global docid offset per shard
    blk,  # [N, S, R, B] int32, -1 padded
    rest,  # [N, S, R, B] int32
    order,  # [N, S, R] int32 (shard-local range ids)
    bounds,  # [N, S, R] int32
    budgets,  # [N, S] int32 per-(query, shard) postings budget
    maxr,  # [N, S] int32 per-(query, shard) range budget
    *,
    s_pad: int,
    k: int,
    safe_stop: bool = True,
    prune_blocks: bool = True,
    impl: str = "torch",
    docs_format: str = "int32",
) -> torch.Tensor:
    """(batch x shard) traversal on one device.

    The host tables (numpy) go up in one copy with the fresh carries
    (``upload_int32``); ``traverse_lanes`` runs the N*S (query, shard)
    lanes, one ``traverse`` launch under ``impl="cuda"``; then the
    local->global docid lift and the broker merge run on the device.
    Returns one int32 [N, 2k + 5S] tensor on the device, per query
    ``vals[k] | ids[k] | postings[S] | blocks[S] | ranges[S] |
    exit_safe[S] | exit_budget[S]`` (ids GLOBAL): ``split_outputs`` views
    it as the reference's seven outputs, and a caller reads them all in
    one copy.
    """
    N, S, R, B = blk.shape
    lanes = upload_int32(
        (blk.reshape(N * S, R, B), rest.reshape(N * S, R, B), order.reshape(N * S, R),
         bounds.reshape(N * S, R), lane_caps(budgets.reshape(-1)),
         lane_caps(maxr.reshape(-1)), carry_buffer(batched_init_carry(N * S, k))),
        dix.blk_start.device,
    )
    out = traverse_lanes(
        dix, *lanes, s_pad=s_pad, k=k, safe_stop=safe_stop, prune_blocks=prune_blocks,
        impl=impl, docs_format=docs_format,
    ).view(N, S, 2 * k + 5)
    # Lift local docids to global, then broker-merge.
    ids = out[:, :, k + 2:2 * k + 2]
    gids = torch.where(ids >= 0, ids + doc_base[None, :, None], -1)
    out_v, out_i = _merge_gathered(out[:, :, :k], gids, k)
    return torch.cat([out_v, out_i] + [out[:, :, c] for c in (
        k, k + 1, 2 * k + 2, 2 * k + 3, 2 * k + 4)], dim=1)


def split_outputs(buf, k: int, n_shards: int) -> tuple:
    """``sharded_batched_traverse``'s [N, 2k + 5S] buffer (a tensor or its
    host copy) as the reference's seven outputs ``(vals [N, k], ids
    [N, k], postings [N, S], blocks [N, S], ranges [N, S], exit_safe
    [N, S] bool, exit_budget [N, S] bool)``."""
    S = n_shards
    cols = [buf[:, :k], buf[:, k:2 * k]] + [
        buf[:, 2 * k + j * S:2 * k + (j + 1) * S] for j in range(5)]
    return (*cols[:5], cols[5] != 0, cols[6] != 0)


# --------------------------------------------------------------------------
# Host-facing results
# --------------------------------------------------------------------------


def apply_down_mask(
    budgets: np.ndarray, maxr: np.ndarray, down_mask
) -> tuple[np.ndarray, np.ndarray]:
    """Zero dead shards' budget columns so they exit before any work.

    A down shard (health ledger, DESIGN.md §9) is given ``budget = 0`` and
    ``max_ranges = 0``: its lanes exit at i=0 having processed nothing,
    and every one of its ranges lands in the skipped-bounds accounting,
    which is exactly the "unprocessed BoundSum mass" the degraded fidelity
    bound must carry.
    """
    if down_mask is None:
        return budgets, maxr
    down = np.asarray(down_mask, bool)
    if down.shape != (budgets.shape[-1],):
        raise ValueError(
            f"down_mask shape {down.shape} != ({budgets.shape[-1]},)"
        )
    if not down.any():
        return budgets, maxr
    budgets = np.array(budgets, copy=True)
    maxr = np.array(maxr, copy=True)
    budgets[..., down] = 0
    maxr[..., down] = 0
    return budgets, maxr


def shard_exit_reason(safe: bool, budget: bool, rp: int, r_loc: int) -> str:
    """Per-shard exit reason with structural padding folded away.

    Shards are stacked to a common range count R_max; a shard with fewer
    ranges runs inert padded slots past ``r_loc``, whose zero bounds can
    trip the device safe/budget flags. Having processed all ``r_loc`` real
    ranges IS exhaustion, whatever flag fired at the padding.
    """
    if rp >= r_loc:
        return "exhausted"
    if safe:
        return "safe"
    if budget:
        return "budget"
    return "exhausted"


class ShardedResult(NamedTuple):
    """Merged global top-k plus per-shard diagnostics for one query."""

    doc_ids: np.ndarray  # [<=k] int32 GLOBAL docids, score-desc / docid-asc
    scores: np.ndarray  # [<=k] int32
    shard_postings: np.ndarray  # [S] int64
    shard_blocks: np.ndarray  # [S] int64
    shard_ranges: np.ndarray  # [S] int64 ranges processed (<= r_loc)
    shard_exit_reasons: tuple  # [S] of "safe" | "budget" | "exhausted" | "down"
    fidelity_bound: int  # max BoundSum over all unprocessed ranges (0 if none)
    exact: bool  # merged list provably equals the exhaustive top-k (see below)

    @property
    def postings(self) -> int:
        return int(self.shard_postings.sum())

    @property
    def blocks(self) -> int:
        return int(self.shard_blocks.sum())

    @property
    def exit_budget(self) -> bool:
        return "budget" in self.shard_exit_reasons


# --------------------------------------------------------------------------
# Engines
# --------------------------------------------------------------------------


class ShardedEngine:
    """Range-sharded executor over a single built ``ClusteredIndex``.

    Wraps a single-device ``Engine`` (whose ``plan`` stays the global
    planner) with ``n_shards`` shard-local indexes stacked on the engine's
    device, at its impact dtype and docid format. ``use_mesh``: None or
    False run every shard on that one device; True (one shard per card)
    raises ``NotImplementedError`` until the mesh path is ported.
    ``shards`` is a preloaded shard list to use instead of re-partitioning.
    The positional order is the reference's: ``mesh_axis`` names the mesh
    axis of the unported mesh path and is ignored; ``obs`` takes only None
    until the telemetry is ported (ROADMAP A2).
    """

    def __init__(
        self,
        engine: Engine,
        n_shards: int,
        use_mesh: bool | None = None,
        mesh_axis: str = "shard",
        shards: list[IndexShard] | None = None,
        obs=None,
    ):
        if obs is not None:
            raise NotImplementedError(
                "obs= (the reference's telemetry hooks) is not ported yet, ROADMAP A2; "
                "pass obs=None"
            )
        if use_mesh:
            raise NotImplementedError(
                "use_mesh=True (one shard per card: make_mesh_dispatch and "
                "distributed/sharding.py) is not ported yet, ROADMAP A7's mesh item; "
                "use_mesh=None or False runs every shard on the engine's device"
            )
        self.engine = engine
        self.k = engine.k
        self.s_pad = engine.s_pad
        self.impl = engine.impl
        self.device = engine.device
        self.impact_dtype = engine.impact_dtype
        self.docs_format = engine.docs_format
        if shards is None:
            shards = shard_device_index(engine.index, n_shards)
        elif len(shards) != n_shards:
            raise ValueError(
                f"preloaded shard count {len(shards)} != n_shards {n_shards}"
            )
        self.shards: list[IndexShard] = shards
        self.n_shards = len(self.shards)
        self.cuts = shard_cuts(self.shards)
        self.r_loc = np.asarray([sh.n_ranges for sh in self.shards], np.int64)
        self.r_max = int(self.r_loc.max())
        self.mass = np.asarray([sh.postings for sh in self.shards], np.int64)
        self.doc_base_host = np.asarray(
            [sh.doc_base for sh in self.shards], np.int64
        )

        def stack(field, pad=0, arrs=None):
            if arrs is None:
                arrs = [
                    np.asarray(getattr(sh, field), np.int32) for sh in self.shards
                ]
            w = max((a.shape[0] for a in arrs), default=1) or 1
            out = np.full((self.n_shards, w), pad, arrs[0].dtype if arrs else np.int32)
            for s, a in enumerate(arrs):
                out[s, : a.shape[0]] = a
            return torch.from_numpy(out).to(self.device)

        # bounds_dense is a planning-time structure; traversal reads bounds
        # via the plan tables, so the device mirror carries a placeholder
        # (the real shard-local bounds live on IndexShard.bounds_dense).
        # Impacts upload at the engine's impact dtype (int8 keeps shard
        # postings at 1 B each, DESIGN.md §8); padding lanes are never
        # gathered (blocks only address real offsets), so the pad value is
        # inert at either dtype.
        if self.docs_format == "packed":
            # Pack each shard's local docid stream against its own block
            # geometry (deltas are shard-local, DESIGN.md §12); the stacked
            # [S, W] leaves pad with zero words / zero directory rows, which
            # decode to nothing because padded blocks are never addressed.
            # The words are the uint32 stream's bits held as int32.
            packed = [
                pack_docs(sh.docs, sh.blk_start, sh.blk_len)
                for sh in self.shards
            ]
            docs_dev = torch.zeros((self.n_shards, 1), dtype=torch.int32,
                                   device=self.device)
            pack_dev = dict(
                pack_words=stack(
                    "words",
                    arrs=[np.asarray(p.words, np.uint32).view(np.int32) for p in packed],
                ),
                pack_dir=stack(
                    "pack_dir", arrs=[pack_dir_entries(p) for p in packed]
                ),
                pack_first=stack(
                    "pack_first", arrs=[p.blk_first for p in packed]
                ),
            )
        else:
            docs_dev = stack("docs")
            pack_dev = {}
        self.dix = DeviceIndex(
            docs=docs_dev,
            impacts=stack(
                "impacts",
                arrs=[
                    pack_impacts(sh.impacts, self.impact_dtype)
                    for sh in self.shards
                ],
            ),
            blk_start=stack("blk_start"),
            blk_len=stack("blk_len"),
            blk_maximp=stack("blk_maximp"),
            bounds_dense=torch.zeros((self.n_shards, 1, 1), dtype=torch.int32,
                                     device=self.device),
            range_starts=stack("range_starts"),
            range_sizes=stack("range_sizes"),
            **pack_dev,
        )
        self.doc_base = torch.from_numpy(self.doc_base_host.astype(np.int32)).to(
            self.device)

    # ------------------------------------------------------------- planning
    def plan(self, q_terms: np.ndarray) -> QueryPlan:
        return self.engine.plan(q_terms)

    def shard_plan(self, plan: QueryPlan, width: int | None = None):
        """Slice a global plan into stacked shard-local tables.

        Returns numpy ``(blk [S, R_max, B], rest, order, bounds)`` with
        block ids remapped through each shard's ``blk_map``, range rows in
        shard-local coordinates, and the global processing order restricted
        per shard (relative order preserved, so BoundSum-descending stays
        descending within every shard). Shards with fewer than R_max ranges
        point their padded order slots at an all--1 row, a no-op range.
        """
        g_blk = plan.blk_tab_host
        g_rest = plan.rest_tab_host
        w = g_blk.shape[1]
        B = width or w
        S, Rm = self.n_shards, self.r_max
        blk = np.full((S, Rm, B), -1, np.int32)
        rest = np.zeros((S, Rm, B), np.int32)
        order = np.zeros((S, Rm), np.int32)
        bounds = np.zeros((S, Rm), np.int32)
        for s, sh in enumerate(self.shards):
            rl = sh.n_ranges
            rows = g_blk[sh.range_lo : sh.range_hi]
            blk[s, :rl, :w] = np.where(rows >= 0, sh.blk_map[rows.clip(0)], -1)
            rest[s, :rl, :w] = g_rest[sh.range_lo : sh.range_hi]
            sel = (plan.order_host >= sh.range_lo) & (plan.order_host < sh.range_hi)
            order[s, :rl] = plan.order_host[sel] - sh.range_lo
            bounds[s, :rl] = np.clip(plan.bounds_host[sel], 0, INT32_MAX)
            if rl < Rm:
                order[s, rl:] = rl  # row rl is all -1: inert padding
        return blk, rest, order, bounds

    def query_shard_mass(self, plan: QueryPlan) -> np.ndarray:
        """[S] int64 per-shard BoundSum mass for this query's terms.

        Sum of the plan's per-range BoundSums over each shard's range band:
        the quantity shard-aware budget allocation splits postings budgets
        by (DESIGN.md §9); a shard whose ranges cannot score for this query
        carries zero mass and deserves none of its budget.
        """
        per_range = np.zeros(int(self.cuts[-1]), np.int64)
        per_range[plan.order_host] = plan.bounds_host
        return np.add.reduceat(per_range, self.cuts[:-1]).astype(np.int64)

    # -------------------------------------------------------------- budgets
    def split_postings_budget(self, budgets) -> np.ndarray:
        """[N] global postings budgets -> [N, S] proportional to shard mass.

        Ceil so shard slices never sum below the global budget; a *positive*
        budget is floored at one block per shard (mirror of
        ``SlaBudgeter.floor``: a meaningful global budget must not starve a
        small shard below one block), while budget <= 0 stays 0 on every
        shard, the unsharded engine's "no work, exit on budget". Unbounded
        stays unbounded.
        """
        b = np.asarray(budgets, np.int64).reshape(-1)
        shares = self.mass / max(int(self.mass.sum()), 1)
        out = np.ceil(b[:, None] * shares[None, :])
        out = np.where(b[:, None] > 0, np.maximum(out, BLOCK), 0)
        out = np.where(b[:, None] >= INT32_MAX, INT32_MAX, out)
        return np.clip(out, 0, INT32_MAX).astype(np.int32)

    def split_range_budget(self, maxr) -> np.ndarray:
        """[N] global range caps -> [N, S] proportional to shard range counts."""
        m = np.asarray(maxr, np.int64).reshape(-1)
        shares = self.r_loc / max(int(self.r_loc.sum()), 1)
        out = np.maximum(np.ceil(m[:, None] * shares[None, :]), 1)
        out = np.where(m[:, None] >= INT32_MAX, INT32_MAX, out)
        out = np.where(m[:, None] <= 0, 0, out)
        return np.clip(out, 0, INT32_MAX).astype(np.int32)

    # ------------------------------------------------------------- dispatch
    def dispatch(
        self, blk, rest, order, bounds, budgets, maxr,
        safe_stop: bool = True, prune_blocks: bool = True,
    ) -> torch.Tensor:
        """Run one (batch x shard) step on stacked host tables (one upload,
        one ``traverse`` launch under ``impl="cuda"``); the packed outputs
        of ``sharded_batched_traverse``, on the device."""
        return sharded_batched_traverse(
            self.dix, self.doc_base, blk, rest, order, bounds,
            np.asarray(budgets, np.int64), np.asarray(maxr, np.int64),
            s_pad=self.s_pad, k=self.k, safe_stop=safe_stop,
            prune_blocks=prune_blocks, impl=self.impl, docs_format=self.docs_format,
        )

    # ------------------------------------------------------------ execution
    def traverse(
        self,
        plan: QueryPlan,
        budget_postings=INT32_MAX,
        max_ranges=INT32_MAX,
        safe_stop: bool = True,
        prune_blocks: bool = True,
        down_mask: np.ndarray | None = None,
    ) -> ShardedResult:
        """Single-query sharded traversal (a batch of one).

        Scalar budgets are split across shards proportionally; a length-S
        sequence assigns per-shard budgets directly. ``down_mask`` ([S]
        bool) marks dead shards: they are assigned zero work and the result
        degrades through the fidelity bound (DESIGN.md §9).
        """
        blk, rest, order, bounds = self.shard_plan(plan)
        bud = self._one_query_budget(budget_postings, self.split_postings_budget)
        mr = self._one_query_budget(max_ranges, self.split_range_budget)
        bud, mr = apply_down_mask(bud, mr, down_mask)
        out = self.dispatch(
            blk[None], rest[None], order[None], bounds[None], bud, mr,
            safe_stop=safe_stop, prune_blocks=prune_blocks,
        )
        return self._to_results(out, bounds[None], down_mask=down_mask)[0]

    def _one_query_budget(self, value, split_fn) -> np.ndarray:
        arr = np.asarray(value, np.int64)
        if arr.ndim == 0:
            return split_fn([int(arr)])
        if arr.shape != (self.n_shards,):
            raise ValueError(f"per-shard budget shape {arr.shape} != ({self.n_shards},)")
        return np.clip(arr, 0, INT32_MAX).astype(np.int32)[None]

    # --------------------------------------------------------------- unpack
    def _to_results(
        self, out, bounds: np.ndarray, down_mask: np.ndarray | None = None
    ) -> list[ShardedResult]:
        """Packed device outputs (read in one copy) + host bounds tables
        [N, S, R_max] -> results."""
        host = out.cpu().numpy() if isinstance(out, torch.Tensor) else np.asarray(out)
        vals, ids, post, blocks, ranges, safe, budget = split_outputs(
            host, self.k, self.n_shards)
        down = (
            np.zeros(self.n_shards, bool)
            if down_mask is None
            else np.asarray(down_mask, bool)
        )
        results = []
        for n in range(vals.shape[0]):
            keep = ids[n] >= 0
            reasons = tuple(
                "down"
                if down[s]
                else shard_exit_reason(
                    bool(safe[n, s]), bool(budget[n, s]),
                    int(ranges[n, s]), int(self.r_loc[s]),
                )
                for s in range(self.n_shards)
            )
            # fb: fidelity loss attributable to the anytime knob or to a
            # dead shard (budget/down exits, the §4/§9 bound surfaced to
            # callers). resid: max BoundSum over ALL skipped ranges, safe
            # exits included, used for the exactness certificate below.
            # down_resid: the dead shards' share of resid; degraded
            # results are never certified exact while it is nonzero.
            fb = 0
            resid = 0
            down_resid = 0
            for s in range(self.n_shards):
                rp, rl = int(ranges[n, s]), int(self.r_loc[s])
                if rp < rl:
                    r_bound = int(bounds[n, s, rp:rl].max())
                    resid = max(resid, r_bound)
                    if reasons[s] in ("budget", "down"):
                        fb = max(fb, r_bound)
                    if reasons[s] == "down":
                        down_resid = max(down_resid, r_bound)
            # Exactness certificate, strict about tie-breaks: a doc in a
            # skipped range can score up to that range's BoundSum, and at
            # equal score a smaller docid displaces the k-th entry under the
            # heap's total order, so the device's non-strict safe condition
            # (bound <= theta) is not enough by itself. Exact iff no skipped
            # range could hold a scoring doc (resid == 0; covers exhausted
            # shards and empty-for-query skipped ranges), or the list is
            # FULL and every skipped range is strictly below the k-th score.
            # With an under-filled list any unprocessed scoring doc belongs
            # in the top-k, so fullness is required. A down shard that could
            # have scored (down_resid > 0) always degrades to exact=False:
            # the deliberately conservative §9 contract, so operators can
            # alarm on inexact answers during an outage.
            n_found = int(keep.sum())
            exact = down_resid == 0 and (
                resid == 0
                or (n_found == self.k and resid < int(vals[n][keep][-1]))
            )
            results.append(
                ShardedResult(
                    doc_ids=ids[n][keep],
                    scores=vals[n][keep],
                    shard_postings=post[n].astype(np.int64),
                    shard_blocks=blocks[n].astype(np.int64),
                    shard_ranges=np.minimum(
                        ranges[n].astype(np.int64), self.r_loc
                    ),
                    shard_exit_reasons=reasons,
                    fidelity_bound=fb,
                    exact=exact,
                )
            )
        return results


class ShardedBatchEngine:
    """Shape-bucketed (batch x shard) executor, the sharded ``BatchEngine``.

    Same shape discipline as ``BatchEngine``: plans snap to the
    ``BucketSpec`` width/batch ladder, as in the reference. A chunk is one
    upload, one ``traverse`` launch over every (lane, shard) pair and one
    read. ``compiled_shapes`` records the (batch, width) shapes that ran
    (the reference's compiled programs).
    """

    def __init__(self, sengine: ShardedEngine, spec: BucketSpec | None = None):
        self.sengine = sengine
        self.engine = sengine.engine
        self.spec = spec or BucketSpec()
        self.compiled_shapes: set[tuple[int, int]] = set()
        self.batches_run = 0

    # ------------------------------------------------------------- planning
    def plan(self, q_terms: np.ndarray) -> QueryPlan:
        return self.engine.plan(q_terms)

    def plan_many(self, queries: Sequence[np.ndarray]) -> list[QueryPlan]:
        return [self.engine.plan(q) for q in queries]

    # ------------------------------------------------------------ execution
    def run_batch(
        self,
        plans: Sequence[QueryPlan],
        budget_postings=None,
        max_ranges=None,
        safe_stop: bool = True,
        prune_blocks: bool = True,
        down_mask: np.ndarray | None = None,
    ) -> list[ShardedResult]:
        """Traverse ``plans`` on all shards; results keep input order.

        Budgets may be None (unbounded), a scalar, an [n] per-query vector
        (split across shards proportionally), or an [n, S] matrix of
        explicit per-(query, shard) caps. ``down_mask`` ([S] bool) marks
        dead shards; their queries degrade through ``fidelity_bound`` and
        ``exact=False`` instead of failing (DESIGN.md §9).
        """
        n = len(plans)
        if n == 0:
            return []
        budgets = self._per_query_shard(
            budget_postings, n, self.sengine.split_postings_budget
        )
        maxr = self._per_query_shard(
            max_ranges, n, self.sengine.split_range_budget
        )
        budgets, maxr = apply_down_mask(budgets, maxr, down_mask)

        results: list[ShardedResult | None] = [None] * n
        for width, chunk in iter_bucket_chunks(plans, self.spec):
            self._run_chunk(
                [plans[i] for i in chunk], chunk, width, budgets, maxr,
                safe_stop, prune_blocks, results, down_mask,
            )
        return results  # type: ignore[return-value]

    def _per_query_shard(self, value, n: int, split_fn) -> np.ndarray:
        S = self.sengine.n_shards
        if value is None:
            return np.full((n, S), INT32_MAX, np.int32)
        arr = np.asarray(value, np.int64)
        if arr.ndim == 0:
            arr = np.full(n, int(arr), np.int64)
        if arr.shape == (n,):
            return split_fn(arr)
        if arr.shape == (n, S):
            return np.clip(arr, 0, INT32_MAX).astype(np.int32)
        raise ValueError(f"budget shape {arr.shape} not in {{({n},), ({n}, {S})}}")

    def _run_chunk(
        self, chunk_plans, chunk_idx, width, budgets, maxr,
        safe_stop, prune_blocks, results, down_mask=None,
    ) -> None:
        se = self.sengine
        batch = self.spec.batch_bucket(len(chunk_plans))
        S, Rm = se.n_shards, se.r_max
        blk = np.full((batch, S, Rm, width), -1, np.int32)
        rest = np.zeros((batch, S, Rm, width), np.int32)
        order = np.zeros((batch, S, Rm), np.int32)
        bounds = np.zeros((batch, S, Rm), np.int32)
        b = np.zeros((batch, S), np.int32)  # dummy lanes: zero budgets
        m = np.zeros((batch, S), np.int32)
        for lane, (qi, plan) in enumerate(zip(chunk_idx, chunk_plans)):
            blk[lane], rest[lane], order[lane], bounds[lane] = se.shard_plan(
                plan, width
            )
            b[lane] = budgets[qi]
            m[lane] = maxr[qi]

        out = se.dispatch(
            blk, rest, order, bounds, b, m,
            safe_stop=safe_stop, prune_blocks=prune_blocks,
        )
        self.compiled_shapes.add((batch, width))
        self.batches_run += 1
        unpacked = se._to_results(out, bounds, down_mask=down_mask)
        for lane, qi in enumerate(chunk_idx):
            results[qi] = unpacked[lane]

    # ---------------------------------------------------------------- misc
    def warmup(self, widths: Sequence[int] | None = None) -> None:
        """Run every (batch_bucket, width) shape once for the given widths."""
        R = self.engine.index.n_ranges
        for w in widths or (self.spec.min_width,):
            dummy = dummy_plan(R, self.spec.width_bucket(w), self.engine.device)
            for nb in batch_ladder(self.spec):
                self.run_batch([dummy] * nb)
