"""Micro-batching request loop with SLA-derived device budgets.

The host-driven anytime executor (core.anytime) takes its go/no-go decision
between ranges from a wall clock. The batch path cannot (one ``traverse``
launch runs the whole batch), so the SLA is compiled *into* the dispatch
as per-query postings budgets (the paper's deterministic JASS-style proxy
for time). ``SlaBudgeter`` closes the loop:

  * an EWMA of observed postings scored per millisecond per lane converts
    the millisecond SLA into a postings cap;
  * a ``core.anytime.Reactive`` policy supplies Eq. (7) multiplicative
    feedback: its alpha divides the cap, so SLA misses shrink budgets and
    sustained compliance relaxes them, the paper's §6.4 control loop
    transplanted from time-space into postings-space.

``MicroBatchServer`` is the request loop: enqueue, cut a batch at
``max_batch`` (or whatever is pending), serve it through ``BatchEngine``,
attribute the batch wall time plus queue wait to every member. Every
budget and every latency equals the reference's under the same clock.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import numpy as np

from repro_torch.core.anytime import Reactive
from repro_torch.core.clustered_index import BLOCK
from repro_torch.serving.batch_engine import INT32_MAX, BatchEngine, BatchResult

__all__ = [
    "MicroBatchServer",
    "ServedQuery",
    "SlaBudgeter",
    "result_exit_reason",
]


@dataclasses.dataclass
class SlaBudgeter:
    """Convert a wall-clock SLA into per-query postings budgets."""

    sla_ms: float
    policy: Reactive = dataclasses.field(default_factory=lambda: Reactive())
    rate: float = 100.0  # postings / ms / lane — EWMA, seeded conservatively
    ema: float = 0.3
    floor: int = BLOCK  # always admit at least one block per query

    def budgets(self, n: int, plans=None) -> np.ndarray:
        """[n] int32 postings budgets for the next batch.

        ``plans`` is accepted (and ignored here) so callers can pass the
        micro-batch's query plans uniformly.
        """
        cap = max(float(self.floor), self.rate * self.sla_ms / self.policy.alpha)
        cap = min(cap, float(INT32_MAX))  # inf SLA -> unbounded traversal
        return np.full(n, int(cap), dtype=np.int32)

    def observe(
        self,
        elapsed_ms: float,
        total_postings: int,
        n: int,
        latencies_ms: Sequence[float] | None = None,
    ) -> None:
        """Feed back one served batch: throughput EWMA + Eq. (7) on alpha.

        ``elapsed_ms`` is the dispatch's time, the denominator of the
        postings/ms rate EWMA. ``latencies_ms`` is the per-query
        *end-to-end* latency (queue wait + planning + service); Eq. (7)
        judges SLA compliance against it, so queueing-induced misses
        tighten budgets too. Without it, the dispatch time stands in for
        both.
        """
        if elapsed_ms > 0 and n > 0:
            lane_rate = (total_postings / n) / elapsed_ms
            self.rate = (1 - self.ema) * self.rate + self.ema * max(lane_rate, 1e-6)
        if latencies_ms is None:
            self.policy.on_query_end(elapsed_ms, self.sla_ms)
        else:
            for t_ms in latencies_ms:
                self.policy.on_query_end(float(t_ms), self.sla_ms)


def result_exit_reason(res) -> str:
    """Merged exit reason for any result kind the serving stack produces.

    ``BatchResult`` carries its own reason; a sharded result merges its
    per-shard reasons with budget/down dominating (any shard cut short by
    the anytime knob or an outage makes the merged answer budget-limited).
    """
    reasons = getattr(res, "shard_exit_reasons", None)
    if reasons is None:
        return res.exit_reason
    if "budget" in reasons:
        return "budget"
    if "down" in reasons:
        return "down"
    if "safe" in reasons:
        return "safe"
    return "exhausted"


@dataclasses.dataclass
class ServedQuery:
    rid: int
    result: BatchResult
    latency_ms: float  # queue wait + batch service time
    batch_size: int


class MicroBatchServer:
    """Queue + cut + dispatch loop over a ``BatchEngine``.

    ``clock`` (default ``time.perf_counter``) is read once per submitted
    query and twice per batch (around the dispatch), the reference's
    sequence, so a deterministic clock replays its budgets exactly.
    """

    def __init__(
        self,
        bengine: BatchEngine,
        budgeter: SlaBudgeter,
        max_batch: int | None = None,
        clock=None,
    ):
        self.bengine = bengine
        self.budgeter = budgeter
        self.max_batch = max_batch or bengine.spec.max_batch
        self.clock = clock if clock is not None else time.perf_counter
        self._queue: list[tuple[int, np.ndarray, float]] = []
        self._next_rid = 0

    def submit(self, q_terms: np.ndarray) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, np.asarray(q_terms), self.clock()))
        return rid

    @property
    def pending(self) -> int:
        return len(self._queue)

    def _run_batch(self, plans, budgets):
        """One engine dispatch: the override point for a server that routes
        through another engine."""
        return self.bengine.run_batch(plans, budget_postings=budgets)

    def _observe(self, batch_ms: float, results, latencies_ms=None) -> None:
        """Feed one served batch back to the budgeter.

        ``batch_ms`` (the dispatch's time) drives the throughput EWMA;
        ``latencies_ms`` (per-query end-to-end, queue wait included) drives
        Eq. (7), so an overloaded queue tightens budgets even when each
        dispatch comfortably makes the SLA.
        """
        self.budgeter.observe(
            batch_ms,
            sum(r.postings for r in results),
            len(results),
            latencies_ms=latencies_ms,
        )

    def drain_once(self) -> list[ServedQuery]:
        """Serve one micro-batch from the head of the queue."""
        if not self._queue:
            return []
        cut, self._queue = self._queue[: self.max_batch], self._queue[self.max_batch :]
        rids = [c[0] for c in cut]
        enq = [c[2] for c in cut]
        plans = self.bengine.plan_many([c[1] for c in cut])
        budgets = self.budgeter.budgets(len(plans), plans=plans)

        t0 = self.clock()
        results = self._run_batch(plans, budgets)
        served_at = self.clock()
        batch_ms = (served_at - t0) * 1e3

        latencies_ms = [(served_at - t_enq) * 1e3 for t_enq in enq]
        self._observe(batch_ms, results, latencies_ms=latencies_ms)
        return [
            ServedQuery(rid=rid, result=res, latency_ms=lat, batch_size=len(cut))
            for rid, lat, res in zip(rids, latencies_ms, results)
        ]

    def replay(
        self, queries: Sequence[np.ndarray], batch_size: int | None = None
    ) -> list[ServedQuery]:
        """Offline replay of a query log in fixed-size micro-batches."""
        bs = max(1, min(batch_size or self.max_batch, self.max_batch))
        out: list[ServedQuery] = []
        for lo in range(0, len(queries), bs):
            for q in queries[lo : lo + bs]:
                self.submit(q)
            out.extend(self.drain_once())
        while self._queue:
            out.extend(self.drain_once())
        return out
