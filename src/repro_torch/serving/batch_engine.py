"""Batched anytime query engine: one ``traverse`` launch per chunk of plans.

``BatchEngine`` wraps the single-query ``core.range_daat.Engine`` with a
batch execution path: plans are snapped to a small ladder of shapes (see
``bucketing``), staged on the host with their caps and fresh carries,
uploaded in one copy per chunk, and traversed by a single
``traverse_lanes`` call per chunk (one launch of the ``traverse`` kernel
under ``impl="cuda"``, its plain version under ``impl="torch"``), whose
carry is read back in one copy. An ``obs`` handle (``repro_torch.obs``)
counts each chunk's lanes and exit reasons from that host copy, and its
profiler splits a chunk's time into host staging, dispatch, the launch's
device time (CUDA events around it, read after the copy) and the copy
itself. Budgets are **per
query**: the postings/range caps travel down the lane with the plan, so a
heavy query exhausts *its* budget while light lanes in the same batch run
to safe or exhaustive completion. Results are bitwise identical to looping
``Engine.traverse`` over the same plans, and to the reference's
``BatchEngine``.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np

from repro_torch.core.range_daat import (
    DeviceTimer,
    Engine,
    QueryPlan,
    batched_init_carry,
    carry_buffer,
    exit_reason,
    traverse_lanes,
    upload_int32,
)
from repro_torch.kernels.range_scorer import kernel as scorer_kernel
from repro_torch.obs import NOOP
from repro_torch.obs.profiler import jit_cache_size
from repro_torch.serving.bucketing import (
    BucketSpec,
    batch_ladder,
    dummy_plan,
    iter_bucket_chunks,
    stack_table,
)

__all__ = ["BatchResult", "BatchEngine", "INT32_MAX", "lane_result"]

INT32_MAX = 2**31 - 1


class BatchResult(NamedTuple):
    """Host-side per-query outcome of a batched traversal."""

    doc_ids: np.ndarray  # [<=k] int32, score-desc / docid-asc
    scores: np.ndarray  # [<=k] int32
    ranges_processed: int
    postings: int
    blocks: int
    exit_safe: bool
    exit_budget: bool

    @property
    def exit_reason(self) -> str:
        return exit_reason(self.exit_safe, self.exit_budget)


def lane_result(
    vals: np.ndarray,
    ids: np.ndarray,
    postings: np.ndarray,
    blocks: np.ndarray,
    ranges: np.ndarray,
    safe: np.ndarray,
    budg: np.ndarray,
    lane: int,
) -> BatchResult:
    """Unpack one lane of host-side batched traversal state."""
    keep = ids[lane] >= 0
    return BatchResult(
        doc_ids=ids[lane][keep],
        scores=vals[lane][keep],
        ranges_processed=int(ranges[lane]),
        postings=int(postings[lane]),
        blocks=int(blocks[lane]),
        exit_safe=bool(safe[lane]),
        exit_budget=bool(budg[lane]),
    )


def _per_query(value, n: int, default: int) -> np.ndarray:
    """Broadcast a scalar-or-sequence budget to an [n] int32 array."""
    if value is None:
        return np.full(n, default, dtype=np.int32)
    arr = np.asarray(value, dtype=np.int64)
    if arr.ndim == 0:
        arr = np.full(n, int(arr), dtype=np.int64)
    if arr.shape != (n,):
        raise ValueError(f"budget shape {arr.shape} != ({n},)")
    return np.clip(arr, 0, INT32_MAX).astype(np.int32)


class BatchEngine:
    """Micro-batch executor over a cluster-skipping index.

    Every dispatch has shape (batch_bucket, R, width_bucket) with R and
    s_pad fixed by the index, as in the reference, so the set of shapes is
    bounded by ``len(width buckets) x len(batch buckets)``.
    ``compiled_shapes`` records which (batch, width) shapes have run (the
    reference's compiled programs; the ``traverse`` kernel takes any
    shape), and ``batches_run`` counts dispatches.
    """

    def __init__(
        self, engine: Engine, spec: BucketSpec | None = None, obs=None
    ):
        self.engine = engine
        self.spec = spec or BucketSpec()
        self.obs = obs if obs is not None else NOOP
        self.compiled_shapes: set[tuple[int, int]] = set()
        self.batches_run = 0

    @classmethod
    def from_artifact(
        cls, path: str, spec: BucketSpec | None = None, **engine_kwargs
    ) -> "BatchEngine":
        """Serve a saved index artifact (DESIGN.md §8).

        ``engine_kwargs`` pass through to ``core.range_daat.Engine``;
        ``impact_dtype`` defaults to the artifact's stored dtype, so an
        int8 artifact serves with int8 postings impacts on the device.
        """
        return cls(Engine.from_artifact(path, **engine_kwargs), spec)

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
    ) -> list[BatchResult]:
        """Traverse ``plans`` in groups, one dispatch each; results keep
        input order.

        ``budget_postings`` / ``max_ranges`` may be None (unbounded), a
        scalar applied to every query, or a length-len(plans) sequence of
        per-query caps.
        """
        n = len(plans)
        if n == 0:
            return []
        budgets = _per_query(budget_postings, n, INT32_MAX)
        maxr = _per_query(max_ranges, n, INT32_MAX)

        results: list[BatchResult | None] = [None] * n
        for width, chunk in iter_bucket_chunks(plans, self.spec):
            self._run_chunk(
                [plans[i] for i in chunk],
                chunk,
                width,
                budgets,
                maxr,
                safe_stop,
                prune_blocks,
                results,
            )
        return results  # type: ignore[return-value]

    def _run_chunk(
        self,
        chunk_plans: list[QueryPlan],
        chunk_idx: list[int],
        width: int,
        budgets: np.ndarray,
        maxr: np.ndarray,
        safe_stop: bool,
        prune_blocks: bool,
        results: list,
    ) -> None:
        batch = self.spec.batch_bucket(len(chunk_plans))
        prof = self.obs.profiler if self.obs.enabled else None
        if prof is not None:
            clk = self.obs.clock
            t_plan0 = clk()
        # Dummy lanes get zero budgets -> they exit at i=0 having done no work.
        table = stack_table(chunk_plans, width, batch, budgets[chunk_idx],
                            maxr[chunk_idx])

        eng = self.engine
        k = eng.k
        timer = None
        if prof is not None:
            cache0 = jit_cache_size(scorer_kernel.traverse)
            t_disp0 = clk()
            timer = DeviceTimer(eng.device)
        # The chunk's one upload: tables, caps and fresh carries together.
        lanes = upload_int32(
            (table.blk, table.rest, table.order, table.bounds, table.budget,
             table.maxr, carry_buffer(batched_init_carry(batch, k))),
            eng.device,
        )
        out = traverse_lanes(
            eng.dix, *lanes, s_pad=eng.s_pad, k=k, safe_stop=safe_stop,
            prune_blocks=prune_blocks, impl=eng.impl, docs_format=eng.docs_format,
            timer=timer,
        )
        self.compiled_shapes.add((batch, width))
        self.batches_run += 1
        if prof is not None:
            t_dev0 = clk()

        # The chunk's one device->host copy: every lane is finished.
        host = out.cpu().numpy()
        vals, ids = host[:, :k], host[:, k + 2:2 * k + 2]
        postings, blocks = host[:, k], host[:, k + 1]
        ranges, safe, budg = (host[:, 2 * k + 2], host[:, 2 * k + 3] != 0,
                              host[:, 2 * k + 4] != 0)
        if prof is not None:
            # No sync of its own: the device time is read from events that
            # the copy above has already waited for, and the transfer is
            # that copy (the wait for the launch included).
            t_xfer1 = clk()
            prof.record_dispatch(
                "batch_engine",
                (batch, width),
                cache_before=cache0,
                cache_after=jit_cache_size(scorer_kernel.traverse),
                plan_ms=(t_disp0 - t_plan0) * 1e3,
                dispatch_ms=(t_dev0 - t_disp0) * 1e3,
                device_ms=timer.ms(),
                transfer_ms=(t_xfer1 - t_dev0) * 1e3,
            )
            prof.record_hbm_once("batch_engine", eng.dix._asdict())
        for lane, qi in enumerate(chunk_idx):
            results[qi] = lane_result(
                vals, ids, postings, blocks, ranges, safe, budg, lane
            )
        if self.obs.enabled:
            self.obs.observe("batch_engine_chunk_lanes", len(chunk_idx))
            for lane in range(len(chunk_idx)):
                self.obs.count(
                    "batch_engine_queries",
                    reason=exit_reason(bool(safe[lane]), bool(budg[lane])),
                )

    # ---------------------------------------------------------------- misc
    def warmup(self, widths: Sequence[int] | None = None) -> None:
        """Run every (batch_bucket, width) shape once for the given widths."""
        R = self.engine.index.n_ranges
        for w in widths or (self.spec.min_width,):
            dummy = dummy_plan(R, self.spec.width_bucket(w), self.engine.device)
            for nb in batch_ladder(self.spec):
                self.run_batch([dummy] * nb)
