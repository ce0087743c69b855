"""Continuous in-flight batching: a slot-based anytime serving loop.

``MicroBatchServer`` serves stop-and-go: collect a batch, pad, dispatch,
drain, so one straggler query holds its whole micro-batch hostage (the
``traverse`` launch ends with its slowest lane). That convoy effect is
exactly the P99 behaviour the anytime machinery exists to kill.

``InflightServer`` instead treats each lane of one ``traverse`` launch as
a *slot* holding one query's traversal state (top-k heap, range cursor,
cumulative work counters, exit flags), stepped a fixed range *quantum*
at a time via ``range_daat.batched_traverse_resume``. A query that exits
(safe, budget, or exhausted) frees its slot mid-flight; an admitted query
from the queue swaps in on the next quantum without waiting for its
former batchmates. Vacant slots ride along parked (``exit_budget``
raised), so their lanes stop before any work.

Correctness contract: the carry round-trips host<->device bitwise, so a
query served across N quanta is *identical* (doc ids, scores, work
counters, exit reason) to the same query served by one
``Engine.traverse`` call, and every ``ServedQuery`` equals the
reference's ``InflightServer``'s under the same clock.

Staging is double-buffered (``bucketing.DoubleBuffer``): the front
``SlotTable`` is what a step launches on, lane writes (clears for exits,
admissions from the queue) land in the back table, and the buffers swap
between steps. A step is one upload (the front table's host arrays, the
caps and the host carry, staged together by ``batched_traverse_resume``),
one ``traverse`` launch and one read of the ``[n_slots, 2k+5]`` carry;
host planning of the next admissions (``_plan_lookahead``) runs between
the launch and the read, so it overlaps the kernel.

Budgets are fixed at *admission time* from the shared ``SlaBudgeter``
machinery: the rate EWMA learns postings/ms/lane from per-step time,
while Reactive Eq. (7) judges each query's end-to-end latency (queue wait
included) at completion.
"""

from __future__ import annotations

import time
from collections import deque
from typing import Sequence

import numpy as np

from repro_torch.core.range_daat import (
    QueryPlan,
    batched_init_carry,
    batched_traverse_resume,
    carry_done,
    carry_to_host,
)
from repro_torch.serving.batch_engine import INT32_MAX, BatchEngine, lane_result
from repro_torch.serving.bucketing import DoubleBuffer
from repro_torch.serving.microbatch import ServedQuery, SlaBudgeter

__all__ = ["InflightServer"]


class InflightServer:
    """Slot-swapping continuous serving loop over one launch shape.

    Parameters
    ----------
    bengine: planning + engine access (``BatchEngine``); the in-flight path
        calls ``batched_traverse_resume`` itself rather than going through
        ``run_batch``.
    budgeter: ``SlaBudgeter`` (or subclass): admission-time postings
        budgets plus the Eq. (7) feedback loop.
    n_slots: lanes of every launch. Unlike micro-batching there is no
        batch-size ladder: one shape per (n_slots, width).
    quantum: ranges traversed per step per lane. Small quanta swap slots
        promptly (better P99 under skew) at more launches; large quanta
        amortise the launch but re-introduce convoy time up to
        ``quantum - 1`` ranges.
    clock: read once per submitted query and twice per step (around the
        launch and the read), the reference's sequence, so a deterministic
        clock replays its budgets and latencies exactly (default
        ``time.perf_counter``).
    """

    def __init__(
        self,
        bengine: BatchEngine,
        budgeter: SlaBudgeter,
        n_slots: int = 8,
        quantum: int = 1,
        clock=None,
    ):
        if n_slots < 1:
            raise ValueError(f"n_slots must be >= 1, got {n_slots}")
        if quantum < 1:
            raise ValueError(f"quantum must be >= 1, got {quantum}")
        self.bengine = bengine
        self.engine = bengine.engine
        self.budgeter = budgeter
        self.n_slots = int(n_slots)
        self.quantum = int(quantum)
        self.clock = clock if clock is not None else time.perf_counter
        self.n_ranges = int(self.engine.index.n_ranges)

        self.buffers = DoubleBuffer(
            self.n_slots, self.n_ranges, bengine.spec.min_width
        )
        # Host-resident carry: every lane starts parked (vacant).
        self.carry = batched_init_carry(self.n_slots, self.engine.k, parked=True)

        self.slot_rid = np.full(self.n_slots, -1, dtype=np.int64)
        self.slot_t_enq = np.zeros(self.n_slots, dtype=np.float64)
        self.slot_quanta = np.zeros(self.n_slots, dtype=np.int64)
        self._prev_postings = np.zeros(self.n_slots, dtype=np.int64)

        self._queue: deque[tuple[int, np.ndarray, float]] = deque()
        self._planned: deque[tuple[int, QueryPlan, float]] = deque()
        self._next_rid = 0

        self.compiled_shapes: set[tuple[int, int]] = set()
        self.steps_run = 0
        self.admissions = 0

    # ------------------------------------------------------------- ingress
    def submit(self, q_terms: np.ndarray) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, np.asarray(q_terms), self.clock()))
        return rid

    @property
    def pending(self) -> int:
        """Queued + planned, not yet holding a slot."""
        return len(self._queue) + len(self._planned)

    @property
    def active(self) -> int:
        """Slots currently occupied by an in-flight query."""
        return int((self.slot_rid >= 0).sum())

    # ----------------------------------------------------------- admission
    def _plan_lookahead(self, limit: int) -> None:
        """Plan up to ``limit`` queued queries ahead of slot availability.

        Called right after a launch: the planning work (term lookup,
        block-table build, range ordering) runs on the host while the
        device is still scoring the quantum.
        """
        while self._queue and len(self._planned) < limit:
            rid, q_terms, t_enq = self._queue.popleft()
            self._planned.append((rid, self.bengine.plan(q_terms), t_enq))

    def _admission_budget(self, plan: QueryPlan) -> int:
        b = np.asarray(self.budgeter.budgets(1, plans=[plan]), dtype=np.int64)
        if b.ndim == 2:  # sharded budgeter: one engine serves the sum
            b = b.sum(axis=1)
        return int(min(int(b[0]), INT32_MAX))

    def _reset_carry_lane(self, lane: int, parked: bool) -> None:
        self.carry.i[lane] = 0
        self.carry.state.vals[lane] = 0
        self.carry.state.ids[lane] = -1
        self.carry.state.postings[lane] = 0
        self.carry.state.blocks[lane] = 0
        self.carry.exit_safe[lane] = False
        self.carry.exit_budget[lane] = parked

    def _admit(self, lane: int, rid: int, plan: QueryPlan, t_enq: float) -> None:
        width = self.bengine.spec.width_bucket(plan.blk_tab_host.shape[1])
        if width > self.buffers.back.width:
            # Width growth is the only launch-shape change; the pow2
            # ladder bounds how many (n_slots, width) shapes can occur.
            self.buffers.grow_width(width)
        budget = self._admission_budget(plan)
        self.buffers.back.write_lane(lane, plan, budget=budget)
        self._reset_carry_lane(lane, parked=False)
        self.slot_rid[lane] = rid
        self.slot_t_enq[lane] = t_enq
        self.slot_quanta[lane] = 0
        self._prev_postings[lane] = 0
        self.admissions += 1

    def _park(self, lane: int) -> None:
        self.buffers.back.clear_lane(lane)
        self._reset_carry_lane(lane, parked=True)
        self.slot_rid[lane] = -1
        self.slot_quanta[lane] = 0
        self._prev_postings[lane] = 0

    def _admit_vacant(self) -> None:
        for lane in np.nonzero(self.slot_rid < 0)[0]:
            if not self._planned:
                self._plan_lookahead(1)
                if not self._planned:
                    break
            rid, plan, t_enq = self._planned.popleft()
            self._admit(int(lane), rid, plan, t_enq)

    # ------------------------------------------------------------ stepping
    def step(self) -> list[ServedQuery]:
        """One quantum: admit, launch, read, retire exited slots."""
        self._admit_vacant()
        if self.active == 0:
            return []
        self.buffers.swap()  # pending lane writes go live
        front = self.buffers.front
        eng = self.engine

        t0 = self.clock()
        # One upload: the front table's host arrays, its caps and the host
        # carry, staged together; one traverse launch under impl="cuda".
        out = batched_traverse_resume(
            eng.dix,
            front.blk,
            front.rest,
            front.order,
            front.bounds,
            front.budget,
            front.maxr,
            self.carry,
            s_pad=eng.s_pad,
            k=eng.k,
            quantum=self.quantum,
            impl=eng.impl,
            docs_format=eng.docs_format,
        )
        self.compiled_shapes.add((self.n_slots, front.width))
        self.steps_run += 1

        # The device is scoring; overlap host-side planning for the
        # admissions this step's exits will make room for.
        self._plan_lookahead(self.n_slots)

        self.carry = carry_to_host(out)  # one read; waits for the quantum
        t1 = self.clock()
        step_ms = (t1 - t0) * 1e3

        active = self.slot_rid >= 0
        postings = np.asarray(self.carry.state.postings, dtype=np.int64)
        delta = int((postings[active] - self._prev_postings[active]).sum())
        self._prev_postings[active] = postings[active]
        self.slot_quanta[active] += 1

        served: list[ServedQuery] = []
        done = carry_done(self.carry, self.n_ranges) & active
        vals = self.carry.state.vals
        ids = self.carry.state.ids
        blocks = self.carry.state.blocks
        for lane in np.nonzero(done)[0]:
            lane = int(lane)
            served.append(ServedQuery(
                rid=int(self.slot_rid[lane]),
                result=lane_result(
                    vals,
                    ids,
                    postings,
                    blocks,
                    self.carry.i,
                    self.carry.exit_safe,
                    self.carry.exit_budget,
                    lane,
                ),
                latency_ms=(t1 - self.slot_t_enq[lane]) * 1e3,
                batch_size=self.n_slots,
                quanta=int(self.slot_quanta[lane]),
            ))
            self._park(lane)

        # Rate EWMA from the step's time; Eq. (7) from end-to-end latency
        # of the queries that completed this quantum (none: rate-only).
        self.budgeter.observe(
            step_ms,
            delta,
            int(active.sum()),
            latencies_ms=[s.latency_ms for s in served],
        )
        return served

    # -------------------------------------------------------------- loops
    def run_until_idle(self, max_steps: int = 1_000_000) -> list[ServedQuery]:
        out: list[ServedQuery] = []
        steps = 0
        while self.pending or self.active:
            out.extend(self.step())
            steps += 1
            if steps >= max_steps:
                raise RuntimeError(
                    f"in-flight loop still busy after {max_steps} steps "
                    f"(pending={self.pending} active={self.active})"
                )
        return out

    def replay(self, queries: Sequence[np.ndarray]) -> list[ServedQuery]:
        """Offline replay: enqueue everything, slot-swap until drained."""
        for q in queries:
            self.submit(q)
        return self.run_until_idle()
