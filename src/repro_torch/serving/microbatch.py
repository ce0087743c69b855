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

``ShardedSlaBudgeter`` splits the SLA into per-shard budgets for the
range-sharded engines (``serving.sharded``). ``MicroBatchServer`` is the
request loop: enqueue, cut a batch at ``max_batch`` (or whatever is
pending), serve it through a ``BatchEngine`` or ``ShardedBatchEngine``,
attribute the batch wall time plus queue wait to every member. Every
budget and every latency equals the reference's under the same clock. An
``obs`` handle (``repro_torch.obs``) records the budgeters' trajectories,
and the server's batch metrics and per-query trace spans, at the
reference's places and only when it is enabled.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from repro_torch.core.anytime import Reactive
from repro_torch.core.clustered_index import BLOCK
from repro_torch.obs import NOOP
from repro_torch.serving.batch_engine import INT32_MAX, BatchEngine, BatchResult

__all__ = [
    "MicroBatchServer",
    "ServedQuery",
    "ShardedSlaBudgeter",
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
    obs: object = NOOP  # Instrumentation handle (alpha/rate/cap trajectories)

    def budgets(self, n: int, plans=None) -> np.ndarray:
        """[n] int32 postings budgets for the next batch.

        ``plans`` is accepted (and ignored here) so callers can pass the
        micro-batch's query plans uniformly.
        """
        cap = max(float(self.floor), self.rate * self.sla_ms / self.policy.alpha)
        cap = min(cap, float(INT32_MAX))  # inf SLA -> unbounded traversal
        if self.obs.enabled:
            self.obs.gauge("budgeter_alpha", float(self.policy.alpha))
            self.obs.gauge("budgeter_cap_postings", float(int(cap)))
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
            if self.obs.enabled:
                self.obs.gauge("budgeter_rate", float(self.rate))
        self._feed_policy(elapsed_ms, latencies_ms)

    def _feed_policy(
        self, elapsed_ms: float, latencies_ms: Sequence[float] | None
    ) -> None:
        """Eq. (7): every end-to-end latency, or the dispatch time alone.
        Each (latency, SLA) pair the policy judges is also recorded, so the
        alpha trajectory can be replayed against what drove it."""
        if latencies_ms is None:
            self.policy.on_query_end(elapsed_ms, self.sla_ms)
            if self.obs.enabled:
                self.obs.observe("budgeter_feedback_ms", float(elapsed_ms))
        else:
            for t_ms in latencies_ms:
                self.policy.on_query_end(float(t_ms), self.sla_ms)
                if self.obs.enabled:
                    self.obs.observe("budgeter_feedback_ms", float(t_ms))
        if self.obs.enabled:
            self.obs.gauge("budgeter_alpha", float(self.policy.alpha))


@dataclasses.dataclass
class ShardedSlaBudgeter(SlaBudgeter):
    """Split a millisecond SLA into per-shard postings budgets.

    Shards traverse concurrently, so each shard gets the *full* time
    budget converted at its *own* observed throughput: an independent
    postings/ms/lane EWMA per shard (a slow or overloaded shard
    self-reports a lower rate and receives a smaller cap). One shared
    Reactive alpha (Eq. 7) scales all shards from end-to-end SLA feedback:
    the SLA is on the merged result, not on any single shard.

    Two allocation modes (DESIGN.md §9):

      * ``mode="rate"``: every query in the batch gets the same per-shard
        caps, shaped only by the throughput EWMAs (the §4 behaviour);
      * ``mode="boundsum"``: each query's *total* postings budget (the sum
        of the rate-mode caps) is re-divided across shards proportionally
        to the per-shard BoundSum mass of that query's terms, obtained via
        ``shard_mass`` (``ShardedEngine.query_shard_mass``). A shard whose
        ranges cannot score for the query gets zero budget; the freed
        postings concentrate where the score mass actually lives, which
        tightens ``fidelity_bound`` under tight SLAs on skewed indexes.

    ``budgets(n, plans)`` returns [n, n_shards]; feed observations through
    ``observe_sharded`` (per-shard postings); ``MicroBatchServer`` does so
    automatically when results carry ``shard_postings``. The float64
    arithmetic is the reference's, expression for expression, so the
    int32 budgets are identical.
    """

    n_shards: int = 1
    mode: str = "rate"  # "rate" | "boundsum"
    shard_mass: object = None  # callable QueryPlan -> [n_shards] mass
    down_mask: object = None  # callable -> [n_shards] bool, True = shard down

    def __post_init__(self):
        if self.mode not in ("rate", "boundsum"):
            raise ValueError(f"mode {self.mode!r} not in ('rate', 'boundsum')")
        if self.mode == "boundsum" and self.shard_mass is None:
            raise ValueError(
                "mode='boundsum' needs shard_mass= "
                "(e.g. ShardedEngine.query_shard_mass)"
            )
        self.rates = np.full(self.n_shards, self.rate, dtype=np.float64)

    def _rate_caps(self) -> np.ndarray:
        cap = np.maximum(
            float(self.floor), self.rates * self.sla_ms / self.policy.alpha
        )
        return np.minimum(cap, float(INT32_MAX))

    def budgets(self, n: int, plans=None) -> np.ndarray:
        """[n, n_shards] int32 per-(query, shard) postings budgets."""
        caps = self._rate_caps()
        if self.obs.enabled:
            self.obs.gauge("budgeter_alpha", float(self.policy.alpha))
            for s in range(self.n_shards):
                self.obs.gauge(
                    "budgeter_shard_cap", float(int(caps[s])), shard=s
                )
        out = np.tile(caps.astype(np.int64), (n, 1))
        unbounded = float(caps.max()) >= float(INT32_MAX)
        if self.mode == "boundsum" and plans is not None and not unbounded:
            total = float(caps.sum())
            for i, plan in enumerate(plans):
                mass = np.asarray(self.shard_mass(plan), np.float64)
                if mass.sum() <= 0:
                    continue  # no scoring shard at all: keep rate shares
                split = np.ceil(total * mass / mass.sum())
                # Scoring shards keep the one-block floor; zero-mass shards
                # provably cannot contribute a document, so they get zero.
                split = np.where(mass > 0, np.maximum(split, self.floor), 0)
                out[i] = np.minimum(split, float(INT32_MAX)).astype(np.int64)
        return np.clip(out, 0, INT32_MAX).astype(np.int32)

    def observe_sharded(
        self,
        elapsed_ms: float,
        shard_postings: np.ndarray,
        n: int,
        active_mask: np.ndarray | None = None,
        latencies_ms: Sequence[float] | None = None,
    ) -> None:
        """Per-shard throughput EWMAs + shared Eq. (7) feedback on alpha.

        ``active_mask`` ([n_shards] bool) freezes the EWMA of shards that
        did no work for a structural reason (health-ledger down, DESIGN.md
        §9); otherwise an outage would drag the dead shard's rate to ~0
        and starve it for many rounds after recovery.
        """
        if elapsed_ms > 0 and n > 0:
            lane_rates = np.asarray(shard_postings, np.float64) / n / elapsed_ms
            new = (1 - self.ema) * self.rates + self.ema * np.maximum(
                lane_rates, 1e-6
            )
            if active_mask is not None:
                new = np.where(np.asarray(active_mask, bool), new, self.rates)
            self.rates = new
            if self.obs.enabled:
                for s in range(self.n_shards):
                    self.obs.gauge(
                        "budgeter_shard_rate", float(self.rates[s]), shard=s
                    )
        self._feed_policy(elapsed_ms, latencies_ms)

    def observe(
        self,
        elapsed_ms: float,
        total_postings: int,
        n: int,
        latencies_ms: Sequence[float] | None = None,
    ) -> None:
        """Base-interface feedback: only a total is known, so spread it
        evenly over the shards that could actually have done the work
        (the inherited version would update the unused scalar ``rate``
        and freeze the per-shard caps). ``down_mask``, when set, excludes
        dead shards from the spread and freezes their EWMAs.
        """
        down = (
            np.asarray(self.down_mask(), bool)
            if self.down_mask is not None
            else np.zeros(self.n_shards, bool)
        )
        active = ~down
        n_active = int(active.sum())
        if n_active == 0:
            # Whole fleet down: nothing did the work, nothing to learn.
            self._feed_policy(elapsed_ms, latencies_ms)
            return
        per_shard = np.where(active, total_postings / n_active, 0.0)
        self.observe_sharded(
            elapsed_ms, per_shard, n, active_mask=active, latencies_ms=latencies_ms
        )


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
    quanta: int | None = None  # in-flight path: device quanta the query spanned


class MicroBatchServer:
    """Queue + cut + dispatch loop over a ``BatchEngine`` or a
    ``ShardedBatchEngine``.

    ``clock`` is read once per submitted query and twice per batch (around
    the dispatch), and twice more per batch when ``obs`` is enabled: the
    reference's sequence, so a deterministic clock replays its budgets
    exactly. An explicit ``clock`` wins; otherwise the ``obs`` handle's
    (``NOOP`` carries ``time.perf_counter``), so trace timestamps and SLA
    feedback read one source.
    """

    def __init__(
        self,
        bengine: BatchEngine,
        budgeter: SlaBudgeter,
        max_batch: int | None = None,
        clock=None,
        obs=NOOP,
    ):
        self.bengine = bengine
        self.budgeter = budgeter
        self.max_batch = max_batch or bengine.spec.max_batch
        self.obs = obs
        self.clock = clock if clock is not None else obs.clock
        self._queue: list[tuple[int, np.ndarray, float]] = []
        self._next_rid = 0

    def submit(self, q_terms: np.ndarray) -> int:
        rid = self._next_rid
        self._next_rid += 1
        self._queue.append((rid, np.asarray(q_terms), self.clock()))
        if self.obs.enabled:
            self.obs.count("submitted", server="micro")
            self.obs.trace_begin(rid)
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
        dispatch comfortably makes the SLA. A sharded budgeter over sharded
        results learns each shard's rate from its own postings.
        """
        if hasattr(self.budgeter, "observe_sharded") and hasattr(
            results[0], "shard_postings"
        ):
            per_shard = np.sum([r.shard_postings for r in results], axis=0)
            self.budgeter.observe_sharded(
                batch_ms, per_shard, len(results), latencies_ms=latencies_ms
            )
        else:
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
        obs = self.obs
        cut, self._queue = self._queue[: self.max_batch], self._queue[self.max_batch :]
        rids = [c[0] for c in cut]
        enq = [c[2] for c in cut]
        # Stage timestamps are taken only when instrumented, so a FakeClock
        # run without obs sees the exact uninstrumented read sequence.
        t_cut = self.clock() if obs.enabled else 0.0
        plans = self.bengine.plan_many([c[1] for c in cut])
        t_planned = self.clock() if obs.enabled else 0.0
        budgets = self.budgeter.budgets(len(plans), plans=plans)

        t0 = self.clock()
        results = self._run_batch(plans, budgets)
        served_at = self.clock()
        batch_ms = (served_at - t0) * 1e3

        latencies_ms = [(served_at - t_enq) * 1e3 for t_enq in enq]
        self._observe(batch_ms, results, latencies_ms=latencies_ms)
        served = [
            ServedQuery(rid=rid, result=res, latency_ms=lat, batch_size=len(cut))
            for rid, lat, res in zip(rids, latencies_ms, results)
        ]
        if obs.enabled:
            self._record_batch(
                served, enq, budgets, t_cut, t_planned, t0, served_at, batch_ms
            )
        return served

    def _record_batch(
        self, served, enq, budgets, t_cut, t_planned, t0, served_at, batch_ms
    ) -> None:
        """Metrics + trace spans for one drained batch (obs-enabled only)."""
        obs = self.obs
        if not obs.enabled:
            # Self-protecting: drain_once gates the call, but a subclass
            # or another caller must not pay per-query span cost silently.
            return
        obs.observe("batch_size", len(served), server="micro")
        obs.observe("batch_ms", batch_ms, server="micro")
        obs.gauge("queue_depth", float(len(self._queue)), server="micro")
        per_q = np.asarray(budgets, np.int64)
        if per_q.ndim == 2:  # sharded budgeter: [n, S] -> per-query totals
            per_q = per_q.sum(axis=1)
        sla = getattr(self.budgeter, "sla_ms", None)
        for sq, t_enq, bq in zip(served, enq, per_q):
            reason = result_exit_reason(sq.result)
            obs.count("served_queries", server="micro", reason=reason)
            obs.observe("latency_ms", sq.latency_ms, server="micro")
            if int(bq) >= INT32_MAX:
                # Inf-SLA sentinel budgets stay out of the histogram (they
                # would pin p50 at ~1.6e9); count them instead.
                obs.count("unlimited_admissions", server="micro")
            else:
                obs.observe("budget_postings", int(bq), server="micro")
            obs.trace_span(sq.rid, "queue", t_enq, t_cut)
            obs.trace_span(sq.rid, "plan", t_cut, t_planned, batch=len(served))
            obs.trace_span(
                sq.rid, "budget", t_planned, t0, budget_postings=int(bq)
            )
            obs.trace_span(
                sq.rid, "service", t0, served_at, device_ms=round(batch_ms, 4)
            )
            attrs = dict(
                server="micro",
                latency_ms=round(sq.latency_ms, 4),
                exit_reason=reason,
                batch=len(served),
            )
            if sla is not None and sla != float("inf"):
                attrs["sla_ms"] = float(sla)
            fb = getattr(sq.result, "fidelity_bound", None)
            if fb is not None:
                attrs["fidelity_bound"] = int(fb)
                attrs["exact"] = bool(sq.result.exact)
            obs.trace_attr(sq.rid, **attrs)
            obs.trace_end(sq.rid)

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
